"""Zero-downtime weight hot-swap: deep-net mode at the serving tier
(PyTorch).

The counterpart of ``repro.serve.hotswap``.  The paper hides a 250 ns
plane write under the 10 ns/pulse read stream by programming one plane
of a stacked pair while its twin serves reads (§III-B, §V).
``HotSwapper`` is that schedule applied to a serving deployment: while
the read-active planes keep producing decode tokens, a new checkpoint is
programmed onto the write-shadow planes in write-latency-costed chunks,
and an atomic flip promotes it with zero dropped requests — versus the
stop-the-world reprogram, which serializes write -> read like the 2-D
baseline the paper benchmarks against.

``overlap_report`` prices both policies in device time with the Table-I
constants (core/timing.py) and the deep-net schedule algebra
(core/pipeline.py):

  * read:  one decode step reads every resident tile grid once —
    ``n_grids * in_bits * t_read`` (bit-serial, grids serialized).
  * write: chunks share one write port — ``n_chunks * t_write`` total,
    fully overlapped with reads because the shadow planes are
    column-isolated (complementary RE).
"""
from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.core import pipeline, timing
from repro_torch.core.executor import flatten_with_path
from repro_torch.core.planes import SwapPlan


def _fold_in(seed: int, i: int) -> int:
    """A 32-bit generator seed for leaf ``i`` of ``seed`` (the CPU
    generator keeps only a seed's low 32 bits)."""
    h = hashlib.blake2b(f"{int(seed)}/{i}".encode(), digest_size=4)
    return int.from_bytes(h.digest(), "little")


def finetune_delta(params: Any, scale: float = 0.02, seed: int = 17) -> Any:
    """``params`` plus a small per-leaf Gaussian delta — the stand-in
    "fine-tuned checkpoint" of the hot-swap CLI (``--hot-swap
    ft:<scale>``).  Leaf ``i`` (in ``flatten_with_path`` order) draws
    from a ``torch.Generator`` on its device seeded with ``seed`` folded
    with ``i``; torch cannot replay ``jax.random``, so the values differ
    from the reference's (docs/PORT.md)."""
    out: Dict[str, Any] = {}
    with torch.no_grad():
        for i, (parts, w) in enumerate(flatten_with_path(params)):
            gen = torch.Generator(device=w.device)
            gen.manual_seed(_fold_in(seed, i))
            d = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                            device=w.device).to(w.dtype)
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = d.mul_(scale).add_(w)
    return out


def overlap_report(cfg, n_grids: int, n_chunks: int,
                   batch_size: int = 1,
                   decode_steps_during: Optional[int] = None,
                   wall_swap_s: Optional[float] = None) -> Dict[str, Any]:
    """Device-time accounting of one hot-swap: overlapped vs
    stop-the-world.

    ``cfg`` is the executor's EngineConfig (quant.in_bits sets the read
    pulse count; cfg.params the Table-I corner).  Throughput during the
    swap is tokens per modeled second inside the swap window: overlapped
    reads free-run (the window is write-paced), stop-the-world delivers
    its first batch only after the blocking reprogram plus one decode
    step.
    """
    p = cfg.params
    b = cfg.quant.in_bits
    t_read_grid = timing.read_time(b, p)          # one tile-grid read
    t_step = n_grids * t_read_grid                # one decode step
    t_write = n_chunks * p.t_write                # one write port
    thr_overlap = batch_size / t_step
    thr_stop_world = batch_size / (t_write + t_step)
    ratio = thr_overlap / thr_stop_world          # = 1 + t_write / t_step
    # per-beat overlap: the paper's read-subsumed-in-write figure (§V)
    steady = timing.deepnet_speedup(b, p=p)
    this_swap = pipeline.streaming_speedup(
        t_compute=t_read_grid, t_dma=p.t_write, n_tiles=max(n_chunks, 1))
    rep = {
        "n_grids": n_grids,
        "n_chunks": n_chunks,
        "in_bits": b,
        "device_decode_step_s": t_step,
        "device_write_total_s": t_write,
        "device_swap_window_overlapped_s": t_write,
        "device_swap_window_stop_world_s": t_write + t_step,
        "decode_steps_hidden_in_window": t_write / t_step,
        "tok_per_device_s_overlapped_during_swap": thr_overlap,
        "tok_per_device_s_stop_world_during_swap": thr_stop_world,
        "throughput_ratio_overlap_vs_stop_world": ratio,
        "sustains_2x_during_swap": bool(ratio >= 2.0),
        "overlap_frac_steady_state": steady,
        "overlap_frac_this_swap": this_swap,
        "paper_overlap_frac": 0.29,
        "within_2pts_of_paper": bool(abs(steady - 0.29) <= 0.02),
    }
    if decode_steps_during is not None:
        rep["decode_steps_during_swap"] = decode_steps_during
    if wall_swap_s is not None:
        rep["wall_swap_s"] = wall_swap_s
    return rep


class HotSwapper:
    """Drives one chunked swap of ``executor`` onto ``new_params``.

    Call :meth:`step` between decode steps (the BatchScheduler does this
    itself); once :attr:`done`, :meth:`promote` lands every plane
    atomically and returns the new params tree for the caller to serve
    embeddings and norms from.
    """

    def __init__(self, executor, new_params: Any, chunks_per_step: int = 8,
                 tenant: str = "A"):
        if chunks_per_step < 1:
            raise ValueError("chunks_per_step must be >= 1")
        self.executor = executor
        self.new_params = new_params
        self.chunks_per_step = chunks_per_step
        self.tenant = tenant
        self.plan: SwapPlan = executor.begin_swap(new_params, tenant=tenant)
        self.decode_steps_during = 0
        self.promoted = False
        self._wall_begin = time.perf_counter()
        self._wall_done: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.plan.done

    @property
    def remaining(self) -> int:
        return self.plan.remaining

    @property
    def leak_codes(self) -> torch.Tensor:
        """This window's write-plane leakage as a device scalar (0.0 when
        the config does not model it, or once promoted); see
        ``CrossbarExecutor.current_leak_codes``."""
        return self.executor.current_leak_codes()

    def step(self, n: Optional[int] = None) -> int:
        """Program up to ``n`` (default ``chunks_per_step``) chunks onto
        the shadow planes; returns chunks still unwritten."""
        if self.promoted or self.plan.done:
            return 0
        return self.executor.write_chunks(n or self.chunks_per_step)

    def note_decode_step(self) -> None:
        self.decode_steps_during += 1

    def promote(self) -> Any:
        """Atomic flip (the executor checks every staged fingerprint
        first)."""
        params = self.executor.promote()
        self.promoted = True
        self._wall_done = time.perf_counter()
        return params

    @property
    def wall_swap_s(self) -> Optional[float]:
        if self._wall_done is None:
            return None
        return self._wall_done - self._wall_begin

    def report(self, batch_size: int = 1) -> Dict[str, Any]:
        rep = overlap_report(
            self.executor.cfg, n_grids=self.executor.n_resident,
            n_chunks=self.plan.total_chunks, batch_size=batch_size,
            decode_steps_during=self.decode_steps_during,
            wall_swap_s=self.wall_swap_s)
        rep["policy"] = "overlapped"
        rep["tenant"] = self.tenant
        rep["swap_mode"] = "staged"
        rep["stack_planes"] = self.executor.stack_planes
        return rep
