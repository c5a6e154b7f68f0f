"""Op-record analysis for the dry run: per-rank flops, bytes, memory and
collective traffic of one step, the port's analogue of the reference's
HLO-text parser (``repro/launch/hlo_analysis.py``).

The reference reads the partitioned HLO after XLA's SPMD pass, whose
shapes are per device.  The port has no compiled module: it runs the
step once, eagerly, on fake local shards (``FakeTensorMode`` under a
``"fake"`` process group, ``launch/dryrun.py``) inside :class:`OpRecord`,
a ``TorchDispatchMode`` that sees every op DTensor runs on a rank's
local tensors, the collectives of its redistributions included (the
``_c10d_functional`` ops).  So every count here is per rank, as the
reference's.

Loop caveat: the reference's counts see a while-loop body once and it
extrapolates from depth-1 and depth-2 compiles.  An eager run counts
every layer and every microbatch, so the record is the whole step and
needs no extrapolation; ``extrapolate`` is kept for the tools that
compare depths.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

#: the reference's collective names
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: each ``_c10d_functional`` op (by overload packet name) -> the
#: reference's collective it is.  A broadcast moves one rank's buffer to
#: the others, XLA's collective-permute class of traffic.
_COLLECTIVE_OF = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    "shard_dim_alltoall": "all-to-all",     # DTensor's own op
}

#: the matmul class (the reference's "dot") and convolutions
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "addbmm",
         "_scaled_mm", "linear"}
_CONVS = {"convolution", "_convolution", "conv1d", "conv2d",
          "convolution_backward"}
#: elementwise transcendentals (XLA's "transcendentals": one per element)
_TRANSCENDENTAL = {"exp", "exp_", "exp2", "expm1", "log", "log1p", "log2",
                   "tanh", "sin", "cos", "rsqrt", "sqrt", "sigmoid", "erf",
                   "pow", "_softmax", "_log_softmax", "silu", "gelu"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _active_fake_mode():
    from torch._guards import active_fake_mode
    return active_fake_mode()


_PROPAGATING = [0]


class propagation:
    """Marks DTensor's sharding propagation, which runs each op once more
    on fake tensors of the global shapes (under the active fake mode) to
    learn its output's shape: not the rank's work, so not recorded."""

    def __enter__(self):
        _PROPAGATING[0] += 1

    def __exit__(self, *exc):
        _PROPAGATING[0] -= 1
        return False


class OpRecord(TorchDispatchMode):
    """Records the ops one rank runs: per op name its count; flops (the
    ``FlopCounterMode`` registry); transcendentals (elements out of
    exp, log, tanh, softmax and the like); bytes accessed (each op's
    operand and result bytes, views excluded); per collective its count
    and operand bytes; and the live bytes of the rank's tensor storages,
    with their peak.  ``track(tree)`` registers tensors made before the
    record (the step's arguments) as live.

    DTensor calls are passed through (``NotImplemented``), so the record
    sees the local ops they run; ops that DTensor's sharding propagation
    runs under its own fake mode are not the rank's work and are
    skipped, as ``MemTracker`` skips them."""

    def __init__(self, keep_buffers: float = float("inf")):
        super().__init__()
        self.ops: Dict[str, int] = collections.Counter()
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}
        self._fake = None
        self._keep = keep_buffers
        #: at the peak: the live storages at least ``keep_buffers`` bytes,
        #: as (bytes, shape, dtype, op) (``forensics.big_buffers``)
        self.peak_buffers: list = []
        self._made: Dict[int, tuple] = {}

    def __enter__(self):
        self._fake = _active_fake_mode()
        return super().__enter__()

    # -- storages ------------------------------------------------------------
    def track(self, tensors, op: str = "argument") -> None:
        for t in _tensors(tensors):
            if isinstance(t, DTensor):
                t = t._local_tensor
            self._track(t, op)

    def _track(self, t: torch.Tensor, op: str) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        ref = self._refs.get(key)
        if ref is None:
            n = st.nbytes()
            self._refs[key] = [n, 1]
            self.live += n
            if n >= self._keep:
                self._made[key] = (n, tuple(t.shape), str(t.dtype), op)
            if self.live > self.peak:
                self.peak = self.live
                if self._keep != float("inf"):
                    self.peak_buffers = list(self._made.values())
        else:
            ref[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]
            self._made.pop(key, None)

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if (packet is torch.ops._c10d_functional.wait_tensor
                and _active_fake_mode() is not None):
            # the meta kernel returns a new tensor; eager waits in place
            out = args[0]
        else:
            out = func(*args, **kwargs)
        if _PROPAGATING[0] or _active_fake_mode() is not self._fake:
            return out        # sharding propagation's own shape work
        if ns_of(func) not in _COLLECTIVE_NS and not any(
                True for _ in _tensors(out)):
            return out        # no tensor made (``prim.device`` and such)
        self._record(func, packet, args, kwargs, out)
        return out

    def _record(self, func, packet, args, kwargs, out) -> None:
        name = packet.__name__
        self.ops[name] += 1
        if ns_of(func) in _COLLECTIVE_NS:
            kind = _COLLECTIVE_OF.get(name)
            if kind is not None:
                c = self.collectives.setdefault(kind, {"bytes": 0.0,
                                                       "count": 0})
                c["bytes"] += float(sum(_nbytes(t) for t in _tensors(args)))
                c["count"] += 1
        else:
            from torch.utils.flop_counter import flop_registry
            fn = flop_registry.get(packet)
            if fn is not None:
                self.flops += int(fn(*args, **kwargs, out_val=out))
            if name in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in _tensors(out))
            if not func.is_view:
                self.bytes_accessed += sum(
                    _nbytes(t) for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t, name)


_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")


def ns_of(func) -> str:
    return getattr(func, "namespace", "")


def collective_bytes(record: OpRecord) -> Dict[str, Dict[str, float]]:
    """Per-collective-type {bytes, count} of one rank (operand bytes)."""
    return {k: dict(v) for k, v in record.collectives.items()}


def total_collective_bytes(record: OpRecord) -> float:
    return sum(v["bytes"] for v in record.collectives.values())


def op_histogram(record: OpRecord) -> Dict[str, int]:
    """The reference's histogram keys that eager execution has: "dot"
    (the matmul class) and "convolution", each collective by count, and
    "ops", every op the rank ran."""
    hist = {"dot": sum(n for k, n in record.ops.items() if k in _DOTS),
            "convolution": sum(n for k, n in record.ops.items()
                               if k in _CONVS)}
    for kind in COLLECTIVES:
        hist[kind] = int(record.collectives.get(kind, {}).get("count", 0))
    hist["ops"] = sum(record.ops.values())
    return hist


def extrapolate(full: float, l1: float, l2: float, n_layers: int,
                depth1: int = 1, depth2: int = 2) -> float:
    """Correct loop-body single-counting: cost(L) ~ cost(l1) + (L - d1) * d,
    with d = (cost(l2) - cost(l1)) / (d2 - d1) measured from two shallow
    compiles.  ``full`` (the scanned compile) is returned unchanged when it
    already exceeds the extrapolation (no loop was present)."""
    delta = (l2 - l1) / max(depth2 - depth1, 1)
    est = l1 + (n_layers - depth1) * delta
    return max(full, est)
