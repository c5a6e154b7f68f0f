"""Fault-tolerant checkpointing (PyTorch): async, atomic, keep-K, in the
reference's on-disk format.

Layout (one directory per step):
    <dir>/step_000000123.tmp/...      while writing
    <dir>/step_000000123/manifest.json + leaf_*.npy   after the rename

* atomic visibility: a checkpoint directory exists completely (rename is
  atomic on POSIX) or not at all; a killed writer leaves only a ``.tmp``
  that ``restore`` ignores and the next ``save`` removes;
* async: ``save`` copies the state to host memory at once and writes it
  from a daemon thread, so the train loop waits only for the copy;
* keep-K: at most ``keep`` checkpoints stay on disk;
* leaves are keyed by their tree path in the reference's form (a dict
  key as itself, a NamedTuple field as ``.name``, a sequence index as
  its number, joined by ``/``): a ``TrainState`` leaf is
  ``.params/blocks/attn/wq``, ``.opt/.m/...``, ``.opt/.v/...`` or
  ``.opt/.step``.  Each package restores the other's float32 checkpoint.

bfloat16 leaves are written as their raw 16-bit words (``uint16``) with
``"dtype": "bfloat16"`` in the manifest, and every leaf is read back by
the manifest's dtype: numpy has no bfloat16 of its own (the reference's
``np.save`` of one writes the opaque ``|V2``), and the port does not
depend on ``ml_dtypes``.  A ``|V2`` leaf of the reference's reads back
the same way.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree
from repro_torch.distributed.sharding import spec_leaves

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of a leaf in host memory (a numpy array to write; later
    writes to the leaf do not reach it), and its dtype's name: a
    bfloat16 leaf as its raw 16-bit words."""
    t = leaf if torch.is_tensor(leaf) else torch.as_tensor(np.asarray(leaf))
    if isinstance(t, DTensor):         # a sharded leaf: gather it whole
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A leaf read back by its manifest dtype (a bfloat16 leaf from the
    port's ``uint16`` words or the reference's ``|V2``)."""
    if dtype == "bfloat16":
        words = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, dtype=dtype, copy=True)).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Snapshot ``state`` to host memory now; write it to disk from a
        daemon thread (``blocking`` waits for the write)."""
        host = [(key,) + _to_host(leaf)
                for key, leaf in tree.leaves_with_keys(state)]
        if _rank() != 0:    # every rank gathers its shards; rank 0 writes
            return
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host) -> None:
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (key, arr, dtype) in enumerate(host):
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append(
                {"key": key, "file": fn, "shape": list(arr.shape),
                 "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                # stale partial write from a killed process
                full = os.path.join(self.dir, d)
                if os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> list:
        out = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.dir, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``target``: each leaf in the
        checkpoint's dtype, on the device of ``target``'s leaf (the CPU
        for a leaf that is no tensor).

        shardings: optional matching tree of ``(mesh, placements)``
        pairs (``sharding.sharding_tree``) — the elastic path: each leaf
        is read whole on every rank and placed onto its placements on
        the (possibly different) mesh, each rank keeping its own shard
        (no communication).
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        root = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(root, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
        flat = tree.leaves_with_keys(target)
        shards = (spec_leaves(shardings) if shardings is not None
                  else [None] * len(flat))
        if len(shards) != len(flat):
            raise ValueError(f"{len(shards)} shardings for {len(flat)} "
                             f"leaves")
        out = []
        for (key, leaf), shard in zip(flat, shards):
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key}")
            entry = by_key[key]
            arr = np.load(os.path.join(root, entry["file"]))
            if shard is not None:
                mesh, placements = shard
                full = _from_host(arr, entry["dtype"], _mesh_device(mesh))
                out.append(distribute_tensor(full, mesh, placements,
                                             src_data_rank=None))
                continue
            dev = leaf.device if torch.is_tensor(leaf) else "cpu"
            out.append(_from_host(arr, entry["dtype"], dev))
        return tree.unflatten(target, out)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
