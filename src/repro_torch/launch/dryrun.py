"""Multi-pod dry run (PyTorch): run every (architecture x input-shape)
cell once on the production meshes, with fake tensors, and record each
rank's memory, flops, bytes and collective traffic.

    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch

The reference (``repro/launch/dryrun.py``) lowers and compiles each cell
on 512 fake XLA host devices and reads XLA's memory and cost analyses.
The port starts a ``"fake"`` process group of the mesh's world size (16
x 16 = 256 or 2 x 16 x 16 = 512 ranks; this process is rank 0) and,
under ``FakeTensorMode``, builds the params and the cache or batch as
DTensors of fake local shards, placed by their logical axes
(``distributed/sharding.py``), then runs the step once, eagerly, inside
``hlo_analysis.OpRecord``: every op a rank runs, collectives included,
is counted on its local shapes.  No tensor is allocated, on the host or
the card.

Per cell the step is:
  train_4k     -> the train step (AdamW over float32 masters, bf16
                  compute, donated state, the policy's microbatches)
  prefill_32k  -> prefill (bf16 weights, cache write-out)
  decode_32k / long_500k -> one decode step against a seq_len-deep cache

and ``<out>/<arch>__<shape>__<mesh>.json`` holds the reference's keys:
``compile_s`` becomes ``run_s`` (the eager step's wall seconds) and
``hlo_chars`` is null (no HLO).  Eager execution counts every layer and
every microbatch, so ``cost_true`` is the direct count; only
``per_layer_flops`` comes from extra depth-1 and depth-2 runs.

The fake process group is global state: ``fake_world`` starts it for
one cell and destroys it after, and refuses to run in a process that
already holds a real group.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import (ALIASES, ARCH_IDS, SHAPES, ShapeSpec,
                                 get_config, shape_applicable)
from repro_torch.configs.inputs import abstract, input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.policy import (TRAIN_DTYPES, TRAIN_SEQ_PARALLEL,
                                       microbatches_for)
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _name(arch: str) -> str:
    return ALIASES.get(arch, arch).replace("-", "_")


# ---------------------------------------------------------------------------
# per-arch / per-shape sharding-rule construction (the reference's)
# ---------------------------------------------------------------------------

def rules_for(arch: str, shape_name: str, multi_pod: bool,
              overrides: Optional[Dict[str, Any]] = None
              ) -> shd.ShardingRules:
    shape = SHAPES[shape_name]
    seq_shard = (shape_name == "long_500k")
    base = dict(shd.fsdp_rules(multi_pod=multi_pod,
                               seq_shard=seq_shard).rules)
    a = _name(arch)
    if a in ("whisper_base", "minitron_4b"):
        # whisper: 8 heads of 64; minitron: 24 heads — neither divides the
        # 16-way TP axis.  Replicate attention, TP the FFN, and shard the
        # KV cache along the SEQUENCE dim instead (flash-decode style).
        for k in ("heads", "kv_heads", "act_heads", "act_kv_heads"):
            base[k] = None
        if shape.kind in ("decode", "prefill"):
            base["kv_seq"] = "model"
    if a == "rwkv6_3b":
        base["lin_heads"] = None      # 40 heads !| 16 -> shard dv instead
        base["lin_dv"] = "model"
    if a == "zamba2_1p2b":
        base["ssm_inner"] = "model"
        base["ssm_heads"] = "model"
        base["lin_heads"] = "model"   # 64 SSD heads | 16
        base["lin_dv"] = None
        base["act_ssm"] = "model"
    if shape.global_batch == 1:
        base["batch"] = None          # batch=1: nothing to shard over DP
    if shape_name == "train_4k" and a in TRAIN_SEQ_PARALLEL:
        base["seq"] = "model"         # SP on the residual stream
    if overrides:
        base.update(overrides)
    return shd.ShardingRules(rules=base)


def cfg_for_cell(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """The reference's shape-dependent tweaks: chunked attention for the
    long prefill and the train cells (bounds the scores working set),
    64-step GLA chunks, full remat for training.  The reference also sets
    ``chunk_unroll=False`` with each ``q_chunk``; the port has no such
    field (its chunk loop is a Python loop, which the record counts
    whole), so that override is dropped."""
    if shape_name == "prefill_32k" and cfg.family in (
            "dense", "moe", "vlm", "encdec", "zamba2"):
        cfg = dataclasses.replace(cfg, q_chunk=2048)
    if shape_name == "train_4k" and cfg.family in (
            "dense", "moe", "vlm", "encdec", "zamba2") and cfg.n_heads:
        cfg = dataclasses.replace(cfg, q_chunk=1024)
    if shape_name in ("prefill_32k", "train_4k") and cfg.family in (
            "rwkv6", "zamba2"):
        cfg = dataclasses.replace(cfg, lin_chunk=64)
    if shape_name == "train_4k":
        cfg = dataclasses.replace(cfg, remat="full")
    return cfg


# ---------------------------------------------------------------------------
# the fake world and fake DTensors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks (this process
    rank 0) for the duration of the block; its collectives return at
    once and move nothing."""
    if dist.is_initialized():
        raise RuntimeError(
            "the dry run's fake process group cannot share a process with "
            f"a running one (backend {dist.get_backend()!r})")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _dtensor_for_the_dry_run():
    """Three adjustments of DTensor for the block.

    (1) DTensor computes shard sizes and offsets (of a strided shard, a
    sharded dim merged with another by a reshape, and of an argmax's
    global indices) with small index tensors; under the dry run's
    ``FakeTensorMode`` they would be fake and their ``tolist()`` a
    data-dependent error, so that bookkeeping runs outside the fake mode
    (DTensor's arithmetic on shapes, not the rank's work).

    (2) On a CPU mesh DTensor turns a Shard(i) -> Shard(j) move into an
    all-gather and a chunk (gloo has no all-to-all); the production
    meshes are NCCL's, which run it as one all-to-all
    (``_dtensor.shard_dim_alltoall``), so the dry run does too.

    (3) Sharding propagation runs each op once more on global-shape fake
    tensors under the active fake mode; those runs are marked
    (``hlo_analysis.propagation``) so the record skips them."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import _utils, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    def unfaked(fn):
        def run(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return run

    def marked(fn):
        def run(*args, **kwargs):
            with hlo.propagation():
                return fn(*args, **kwargs)
        return run

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if hasattr(funcol, "_resolve_group"):
            name = funcol._group_or_group_name(
                funcol._resolve_group((mesh, mesh_dim)))
        else:                                 # older torch
            name = funcol._resolve_group_name((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, name)

    # the sites by name: the ones a torch version lacks are left alone
    sites = [(owner, name, vars(owner)[name]) for owner, name in (
        (_StridedShard, "local_shard_size_and_offset"),
        (_utils, "_compute_local_shape_and_global_offset"),
        (placement_types, "shard_dim_alltoall"),
        (ShardingPropagator, "_propagate_tensor_meta_non_cached"),
        (ShardingPropagator, "_propagate_tensor_meta"))
        if name in vars(owner)]
    wrap = {"shard_dim_alltoall": lambda fn: alltoall,
            "_propagate_tensor_meta_non_cached": marked,
            "_propagate_tensor_meta": marked}
    for owner, name, fn in sites:
        setattr(owner, name, wrap.get(name, unfaked)(fn))
    try:
        yield
    finally:
        for owner, name, fn in sites:
            setattr(owner, name, fn)


_FAKE = []


def _fake_mode():
    """The process's one ``FakeTensorMode`` (DTensor keeps fake tensors
    of a cell in its caches; a second mode meeting them would raise)."""
    if not _FAKE:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE.append(FakeTensorMode())
    return _FAKE[0]


@contextlib.contextmanager
def fake_tensors():
    """The dry run's tensors: every tensor made in the block is fake (the
    process's one ``FakeTensorMode``), with DTensor's adjustments."""
    with _fake_mode(), _dtensor_for_the_dry_run():
        yield


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def fake_dtensor(meta: torch.Tensor, mesh, placements, dtype=None):
    """A DTensor of ``meta``'s shape on ``placements`` whose local shard
    (this rank's) is a fresh fake tensor; call under FakeTensorMode.  A
    dim the placements do not divide raises, as the reference's
    ``NamedSharding`` does."""
    from torch.distributed.tensor import DTensor
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = [None] * meta.dim()
    for axis, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            d = p.dim
            spec[d] = (spec[d] or ()) + (axis,)
    local = shd.shard_shape(sizes, spec, meta.shape)
    dtype = dtype or meta.dtype
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh,
                              placements, run_check=False, shape=meta.shape,
                              stride=shd.contiguous_stride(meta.shape))


def _place(metas, specs, rules, mesh, dtype_of=lambda t: t.dtype):
    return shd.map_specs(
        lambda names, t: fake_dtensor(t, mesh, rules.placements(mesh, names),
                                      dtype_of(t)), specs, metas)


# ---------------------------------------------------------------------------
# step builders (what actually runs)
# ---------------------------------------------------------------------------

def build_step(model, kind: str, rules: shd.ShardingRules, mesh,
               opt_cfg: Optional[opt.AdamWConfig] = None,
               microbatches: int = 1, arch: str = "",
               unroll_accum: bool = False):
    """Returns (fn, state_specs, state_struct_fn); the state entries are
    None outside training.  The train step writes the new state into the
    old one's tensors (the reference's donated state)."""
    if kind == "train":
        opt_cfg = opt_cfg or opt.AdamWConfig()
        opt_dt, acc_dt = TRAIN_DTYPES.get(arch, ("float32", "float32"))
        step = trainer.make_train_step(
            model, opt_cfg, microbatches=microbatches,
            grad_accum_dtype=_DTYPES[acc_dt], unroll_accum=unroll_accum,
            donate=True)

        def structs():
            return abstract(lambda: trainer.init_state(
                model, 0, _DTYPES[opt_dt]))

        return step, trainer.state_specs(model), structs

    if kind == "prefill":
        def prefill_step(params, batch, cache):
            logits, cache = model.prefill(params, batch, cache)
            nxt = torch.argmax(_whole_vocab(logits[:, -1]), dim=-1)
            return nxt.to(torch.int32), cache

        return prefill_step, None, None

    def serve_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache)
        nxt = torch.argmax(_whole_vocab(logits[:, -1]), dim=-1)
        return nxt[:, None].to(torch.int32), cache

    return serve_step, None, None


def _whole_vocab(last):
    """The last position's logits in float32 with the vocab gathered on
    each rank (the batch keeps its split): DTensor's argmax over a split
    vocab fails on some meshes."""
    last = last.to(torch.float32)
    if not isinstance(last, shd.DTensor):
        return last
    keep = [p if p.is_shard(0) else shd.Replicate() for p in last.placements]
    return last.redistribute(last.device_mesh, keep)


def _bf16_params_struct(model):
    """The params as meta tensors, every float32 leaf of rank >= 2 in
    bfloat16 (the serve cells' weights)."""
    st = abstract(model.init, 0)
    return tree.map(
        lambda s: torch.empty(
            s.shape, dtype=(torch.bfloat16 if s.dtype == torch.float32
                            and s.dim() >= 2 else s.dtype), device="meta"),
        st)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _locals(x) -> list:
    """This rank's tensors of a tree: a DTensor's local shard."""
    return [t.to_local() if isinstance(t, shd.DTensor) else t
            for t in tree.leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               n_layers: Optional[int] = None,
               rule_overrides: Optional[Dict[str, Any]] = None,
               cfg_overrides: Optional[Dict[str, Any]] = None,
               microbatches: Optional[int] = None,
               unroll_accum: bool = False, mesh_shape=None,
               keep_buffers: Optional[float] = None,
               smoke: bool = False,
               shape: Optional[ShapeSpec] = None) -> Dict[str, Any]:
    """Run one cell once on the fake mesh (``mesh_shape``: a smaller
    ``(data, model)`` or ``(pod, data, model)`` mesh; default the
    production one) and return the reference's record.
    ``keep_buffers``: also list the live storages of at least that many
    bytes at the peak (``"peak_buffers"``, for ``forensics``).
    ``smoke`` takes the SMOKE config and ``shape`` a cut of the cell's
    shape (the same kind, a smaller batch or sequence): the tests'
    sizes."""
    shape = shape or SHAPES[shape_name]
    cfg = cfg_for_cell(get_config(arch, smoke=smoke), shape_name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    a = _name(arch)
    if microbatches is None:
        microbatches = microbatches_for(a, shape.kind, shape.global_batch,
                                        multi_pod)
    model = build_model(cfg, device="cpu")
    mshape, axes = production_shape(multi_pod)
    if mesh_shape is not None:
        mshape = tuple(mesh_shape)
    rules = rules_for(arch, shape_name, multi_pod, rule_overrides)
    kind, args, logical = input_specs(model, shape)

    t0 = time.time()
    with fake_world(math.prod(mshape)):
        mesh = make_mesh(mshape, axes)
        step, state_specs, structs = build_step(
            model, kind, rules, mesh, microbatches=microbatches, arch=a,
            unroll_accum=unroll_accum)
        keep = keep_buffers if keep_buffers is not None else float("inf")
        with fake_tensors():
            if kind == "train":
                state = _place(structs(), state_specs, rules, mesh)
                batch = _place(args[0], logical[0], rules, mesh)
                call = (state, batch)
            else:
                params = _place(_bf16_params_struct(model),
                                model.param_specs(), rules, mesh)
                call = (params,) + tuple(
                    _place(x, s, rules, mesh) if type(s) is not tuple
                    else fake_dtensor(x, mesh, rules.placements(mesh, s))
                    for x, s in zip(args, logical))
            arg_bytes = _nbytes(_locals(call))
            arg_storages = {t.untyped_storage()._cdata
                            for t in _locals(call)}
            t_lower = time.time() - t0
            rec = hlo.OpRecord(keep_buffers=keep)
            with shd.use_rules(rules, mesh), rec:
                rec.track(call)
                t0 = time.time()
                out = step(*call)
                t_run = time.time() - t0
            out_bytes = _nbytes(_locals(out))
            # the donated state or cache, written in place
            alias = _nbytes(t for t in _locals(out)
                            if t.untyped_storage()._cdata in arg_storages)
            del out, call
    colls = hlo.collective_bytes(rec)
    peak = rec.peak
    res = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mshape)),
        "kind": kind, "n_layers": cfg.n_layers,
        "microbatches": microbatches,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "lower_s": round(t_lower, 2), "run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": peak - arg_bytes,
            "alias_bytes": alias,
            "peak_bytes_per_device": peak,
        },
        "cost": {"flops": float(rec.flops),
                 "bytes_accessed": float(rec.bytes_accessed),
                 "transcendentals": float(rec.transcendentals)},
        "collectives": colls,
        "collective_bytes_total": hlo.total_collective_bytes(rec),
        "op_histogram": hlo.op_histogram(rec),
        "hlo_chars": None,
    }
    if keep_buffers is not None:
        res["peak_buffers"] = rec.peak_buffers
    return res


def probe_depths(cfg: ModelConfig) -> Tuple[int, int]:
    """The reference's probe depths: 1 and 2 layers, or one and two
    Zamba2 super-blocks."""
    if cfg.family == "zamba2":
        return cfg.attn_every, 2 * cfg.attn_every
    return 1, 2


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             extrapolate: bool = True, **kw) -> Dict[str, Any]:
    """One full-depth run (every cost counted directly: ``cost_true``)
    and, with ``extrapolate``, depth-1 and depth-2 runs for
    ``per_layer_flops``.  Writes and returns the cell's record."""
    res = lower_cell(arch, shape_name, multi_pod, **kw)
    cfg = get_config(arch, smoke=kw.get("smoke", False))
    shape = kw.get("shape") or SHAPES[shape_name]
    true_cost = {"flops": res["cost"]["flops"],
                 "bytes_accessed": res["cost"]["bytes_accessed"],
                 "collective_bytes": res["collective_bytes_total"],
                 "per_layer_flops": None, "probe_depths": None,
                 "microbatches": microbatches_for(
                     _name(arch), shape.kind, shape.global_batch, multi_pod)}
    if extrapolate:
        d1, d2 = probe_depths(cfg)
        shallow = {k: v for k, v in kw.items() if k != "n_layers"}
        ra = lower_cell(arch, shape_name, multi_pod, n_layers=d1,
                        **shallow)
        rb = lower_cell(arch, shape_name, multi_pod, n_layers=d2,
                        **shallow)
        true_cost["per_layer_flops"] = (
            (rb["cost"]["flops"] - ra["cost"]["flops"]) / (d2 - d1))
        true_cost["probe_depths"] = [d1, d2]
    res["cost_true"] = true_cost
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{res['mesh']}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                if shape_applicable(arch, shape):
                    cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(_name(args.arch), args.shape)]

    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            mesh_tag = "2x16x16" if mp else "16x16"
            tag = f"{arch} x {shape} x {mesh_tag}"
            if args.skip_existing and os.path.exists(os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_tag}.json")):
                print(f"[SKIP] {tag}", flush=True)
                continue
            try:
                t0 = time.time()
                res = run_cell(arch, shape, mp, args.out,
                               extrapolate=not args.no_extrapolate)
                peak = res["memory"]["peak_bytes_per_device"] / 2**30
                print(f"[OK]   {tag:55s} peak={peak:7.2f} GiB  "
                      f"flops={res['cost']['flops']:.3e}  "
                      f"coll={res['collective_bytes_total']/2**20:9.1f} MiB "
                      f"({time.time()-t0:.0f}s)", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag:55s} {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nALL CELLS RAN.")


if __name__ == "__main__":
    main()
