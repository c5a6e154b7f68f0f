"""Logical-axis sharding on DTensor: one place where the DP/FSDP/TP/SP
policy lives, as in the reference's ``repro.distributed.sharding``.

Models annotate parameters and activations with *logical* axis names
("embed", "mlp", "heads", "vocab", "experts", "batch", "seq", ...).  A
``ShardingRules`` table maps logical names to the axes of a
``DeviceMesh``; the same model code then runs on one device (no rules:
everything a plain tensor), a 16 x 16 ``("data", "model")`` mesh, or the
2 x 16 x 16 ``("pod", "data", "model")`` one (``launch/mesh.py``).

``spec(names)`` is the reference's ``PartitionSpec`` as a tuple: one
entry per tensor dim, a mesh axis, a tuple of mesh axes (one tensor dim
split over several, major first), or None.  ``placements(mesh, names)``
turns it into DTensor placements: for each mesh dim, ``Shard(d)`` for
the tensor dim mapped to it, else ``Replicate()``.

Importing this module touches no process group and no device.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import tree


def _entry(v):
    """A spec entry as ``PartitionSpec`` normalises it: a one-axis tuple
    is the axis itself, an empty one None."""
    if isinstance(v, (tuple, list)):
        return None if not v else (v[0] if len(v) == 1 else tuple(v))
    return v


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, an axis, or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis, tuple of mesh axes, or None."""
    rules: Mapping[str, Optional[object]]

    def spec(self, names: Sequence[Optional[str]]) -> tuple:
        return tuple(_entry(None if n is None else self.rules.get(n))
                     for n in names)

    def placements(self, mesh, names: Sequence[Optional[str]]) -> tuple:
        return spec_placements(mesh.mesh_dim_names, self.spec(names))

    def sharding(self, mesh, names: Sequence[Optional[str]]):
        """(mesh, placements): the port's ``NamedSharding``."""
        return mesh, self.placements(mesh, names)


def spec_placements(mesh_axes: Sequence[str], spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on a mesh with axes ``mesh_axes``.
    A tensor dim split over several mesh axes takes them in the mesh's
    order (the first is the major split, as a PartitionSpec tuple); an
    axis the mesh lacks, an axis used twice, or a tuple out of the mesh's
    order raises, as ``NamedSharding`` refuses them."""
    out = [Replicate() for _ in mesh_axes]
    seen = set()
    for d, entry in enumerate(spec):
        idx = []
        for a in _axes(entry):
            if a not in mesh_axes:
                raise ValueError(f"mesh axis {a!r} of spec {tuple(spec)} "
                                 f"is not in the mesh {tuple(mesh_axes)}")
            if a in seen:
                raise ValueError(f"mesh axis {a!r} used twice in "
                                 f"{tuple(spec)}")
            seen.add(a)
            idx.append(list(mesh_axes).index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(mesh_axes)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_shape(axis_sizes: Mapping[str, int], spec: Sequence,
                shape: Sequence[int]) -> Tuple[int, ...]:
    """The local shape of a ``shape`` tensor under ``spec`` on a mesh of
    ``axis_sizes``: each dim divided by the product of its axes' sizes.
    A dim they do not divide raises, as ``NamedSharding.shard_shape``
    does (DTensor itself would chunk it unevenly)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} has more entries than "
                         f"shape {tuple(shape)} has dims")
    out = []
    for d, n in enumerate(shape):
        k = 1
        for a in _axes(spec[d] if d < len(spec) else None):
            k *= axis_sizes[a]
        if n % k:
            raise ValueError(f"dim {d} of shape {tuple(shape)} ({n}) is "
                             f"not divisible by {k}, the size of mesh "
                             f"axes {spec[d]!r}")
        out.append(n // k)
    return tuple(out)


# Baseline rule tables ------------------------------------------------------

def fsdp_rules(multi_pod: bool = False, fsdp: bool = True,
               seq_shard: bool = False) -> ShardingRules:
    """Default production table (the reference's, entry for entry).

    * batch over (pod, data) — pure DP.
    * weight "fsdp" dims over data (ZeRO-3) when ``fsdp``.
    * heads/mlp/vocab/experts over model — TP.
    * kv_seq over data for sequence-parallel long-context decode (SP).
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(rules={
        "batch": dp,
        "act_embed": None,
        "act_mlp": "model",
        "act_heads": "model",
        "act_kv_heads": "model",
        "seq": None,
        "seq_act": None,   # SP gather points (always gathered)
        "kv_seq": ("data" if seq_shard else None),
        "vocab": "model",
        "embed": ("data" if fsdp else None),
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "experts": None,
        "expert_mlp": "model",
        "layers": None,
        "conv": None,
        "ssm_state": None,
        "ssm_heads": "model",
    })


def single_device_rules() -> ShardingRules:
    return ShardingRules(rules={})


# Context registry -----------------------------------------------------------
# Models call logical_constraint() without threading a rules object
# through every layer; the launcher installs the active table here.

class _Ctx(threading.local):
    rules: Optional[ShardingRules] = None
    mesh: Any = None


_CTX = _Ctx()


class use_rules:
    """Context manager installing a rules table (and optionally a
    ``DeviceMesh``).  With a mesh, plain tensors that model code makes
    (positions, masks, zero states) count as replicated where they meet
    a DTensor (DTensor's ``implicit_replication``): every rank makes the
    same ones, as XLA's partitioner treats a constant."""

    def __init__(self, rules: Optional[ShardingRules], mesh=None):
        self.rules, self.mesh = rules, mesh

    def __enter__(self):
        self._old = (_CTX.rules, _CTX.mesh)
        _CTX.rules, _CTX.mesh = self.rules, self.mesh
        self._implicit = None
        if self.mesh is not None:
            _register_strategies()
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            self._implicit = implicit_replication()
            self._implicit.__enter__()
        return self

    def __exit__(self, *exc):
        if self._implicit is not None:
            self._implicit.__exit__(*exc)
        _CTX.rules, _CTX.mesh = self._old
        return False


_REGISTERED = []


def _register_strategies() -> None:
    """DTensor strategies for the scatters the models run and for
    ``flip`` (some DTensor versions have none): a scatter along ``dim``
    of tensors split along another dim is a scatter of each shard, so
    self, index and src may share any ``Shard(d)`` with ``d != dim``; a
    flip keeps any split off its flipped dims; else all replicated.
    Registered once, the first time rules are installed with a mesh."""
    if _REGISTERED:
        return
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    def strategies(self, dim, index, src, *rest):
        d0 = dim % self.ndim
        tail = [None] * len(rest)
        out = [([Replicate()], [Replicate(), None, Replicate(), Replicate()]
                + tail)]
        for d in range(self.ndim):
            if d != d0:
                out.append(([Shard(d)], [Shard(d), None, Shard(d), Shard(d)]
                            + tail))
        return out

    for op in (aten.scatter_add_.default, aten.scatter_add.default,
               aten.scatter_.src, aten.scatter.src):
        register_sharding(op)(strategies)

    def flip(self, dims):         # cumsum's backward flips its gradient
        flipped = {d % self.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(self.ndim)
            if d not in flipped]

    register_sharding(aten.flip.default)(flip)
    _REGISTERED.append(True)


def current_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def logical_constraint(x, names: Sequence[Optional[str]]):
    """Annotate an activation with logical axes: a DTensor is
    redistributed to the rules' placements (a Partial sum reduced, a
    dim gathered or split); ``x`` itself without rules, for a plain
    tensor, or when every name maps to None."""
    r = _CTX.rules
    if r is None or not isinstance(x, DTensor):
        return x
    spec = r.spec(names)
    if all(a is None for a in spec):
        return x
    mesh = x.device_mesh
    want = spec_placements(mesh.mesh_dim_names, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def gather_dim(x, dim: int):
    """``x`` with dim ``dim`` whole on every rank: a DTensor split on it
    (``Shard(dim)``) is redistributed to ``Replicate()`` on those mesh
    dims, whatever the rules map the other dims to; a plain tensor, or
    a DTensor not split on ``dim``, is returned as it is.  For a fold of
    ``dim`` into a neighbour, which some DTensor versions cannot do on a
    split dim (``logical_constraint`` leaves a DTensor alone where every
    name maps to None)."""
    if not isinstance(x, DTensor):
        return x
    d = dim % x.ndim
    want = tuple(Replicate() if p.is_shard(d) else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def zeros(shape, names: Sequence[Optional[str]], like, dtype=None):
    """``torch.zeros(shape)`` on ``like``'s device (in ``like``'s dtype
    unless given): a zero state made inside a step.  Under installed
    rules with ``like`` a DTensor, a DTensor on the rules' placements of
    ``names`` of which each rank makes only its shard (a plain zero
    tensor would count as replicated, whole on every rank)."""
    dtype = dtype or like.dtype
    r = _CTX.rules
    if r is None or not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import zeros as dzeros
    mesh = like.device_mesh
    return dzeros(shape, dtype=dtype, device_mesh=mesh,
                  placements=r.placements(mesh, names))


def einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)``, which it is for plain tensors.  With a
    DTensor among the operands, each rank runs the same einsum on its
    shards: for each mesh dim, the subscript the first operand split on
    it is split in every operand that has it (the others replicated
    there), and the result is split on it too, or a Partial sum when it
    is contracted.  DTensor's own einsum folds dims into a batched
    product by views that some DTensor versions cannot shard (a split
    dim merged with another); this never merges a split dim."""
    if not any(isinstance(o, DTensor) for o in ops):
        return torch.einsum(eq, *ops)
    return _sharded_einsum(eq, ops)


def embedding(table, tokens):
    """``table[tokens]`` for a plain table.  For a DTensor table, a
    vocab-parallel lookup on each rank's shards: the table's splits off
    its vocab dim are gathered (the FSDP gather), the tokens keep their
    own splits and are made whole on the vocab's mesh dims, each rank
    looks up the tokens that fall in its vocab rows (zero elsewhere),
    and the result is a Partial sum over the vocab's mesh dims.  The
    backward is each rank's own scatter into its rows; DTensor's
    indexing and embedding strategies fail on some versions' meshes."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    vocab = [p.is_shard(0) for p in table.placements]
    tp = [Shard(0) if v else Replicate() for v in vocab]
    kp = [Replicate() if v or not p.is_shard() else p
          for v, p in zip(vocab, tokens.placements)]
    table = table.redistribute(mesh, tp)
    tokens = tokens.redistribute(mesh, kp)
    # a rank's rows get a gradient from its own tokens only
    grad = [t if v else (Partial() if k.is_shard() else Replicate())
            for v, t, k in zip(vocab, tp, kp)]
    rows = table.to_local(grad_placements=grad)
    coord = mesh.get_coordinate()
    shard = 0
    for m, v in enumerate(vocab):
        if v:
            shard = shard * mesh.size(m) + coord[m]
    ids = tokens.to_local() - shard * rows.shape[0]
    inside = (ids >= 0) & (ids < rows.shape[0])
    local = torch.where(inside[..., None],
                        rows[ids.clamp(0, rows.shape[0] - 1)],
                        torch.zeros((), dtype=rows.dtype, device=rows.device))
    out_pl = [Partial() if v else k for v, k in zip(vocab, kp)]
    shape = torch.Size(tuple(tokens.shape) + (table.shape[1],))
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def logsumexp(x):
    """``torch.logsumexp(x, dim=-1)`` for a plain ``x``.  On a DTensor
    whose last dim is split, the distributed form: the max and the sum
    of the shifted exponentials reduced across the split (DTensor's own
    gathers the whole last dim on every rank)."""
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, dim=-1)
    m = torch.amax(x, dim=-1, keepdim=True).detach()
    return (m + torch.log(torch.sum(torch.exp(x - m), dim=-1,
                                    keepdim=True)))[..., 0]


def pick(x, idx):
    """``x[..., idx]`` per position: ``torch.gather(x, -1, idx[...,
    None])[..., 0]`` for a plain ``x``.  On a DTensor whose last dim is
    split, each rank picks the indices in its own columns (zero
    elsewhere) into a Partial sum over that split; its gradient stays a
    shard (DTensor's gather allocates the whole of ``x`` on every rank
    in the backward)."""
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    mesh = x.device_mesh
    last = x.dim() - 1
    split = [p.is_shard(last) for p in x.placements]
    xp = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(mesh, xp)
    ip = [Replicate() if s else p for s, p in zip(split, xp)]
    idx = _as_dtensor(idx, mesh).redistribute(mesh, ip)
    cols = x.to_local()
    coord = mesh.get_coordinate()
    shard = 0
    for m, s in enumerate(split):
        if s:
            shard = shard * mesh.size(m) + coord[m]
    ids = idx.to_local() - shard * cols.shape[-1]
    inside = (ids >= 0) & (ids < cols.shape[-1])
    got = torch.gather(cols, -1, ids.clamp(0, cols.shape[-1] - 1)[..., None])
    local = torch.where(inside, got[..., 0],
                        torch.zeros((), dtype=cols.dtype, device=cols.device))
    out_pl = [Partial() if s else p for s, p in zip(split, ip)]
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=idx.shape,
                              stride=contiguous_stride(idx.shape))


def matmul(x, w):
    """``x @ w`` for a plain ``x``; on DTensors the einsum of the same
    product (:func:`einsum`)."""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return x @ w
    lead = "abcdeghijk"[:x.dim() - 1]
    return _sharded_einsum(f"{lead}y,yz->{lead}z", (x, w))


def _sharded_einsum(eq: str, ops):
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    mesh = next(o for o in ops if isinstance(o, DTensor)).device_mesh
    ops = [_as_dtensor(o, mesh) for o in ops]
    want = [[] for _ in ops]
    grad = [[] for _ in ops]   # the layout of each operand's local grad
    out_pl = []
    for m in range(mesh.ndim):
        letter = None
        for sub, o in zip(subs, ops):
            p = o.placements[m]
            if p.is_shard():
                letter = sub[p.dim]
                break
        for i, sub in enumerate(subs):
            split = letter is not None and letter in sub
            want[i].append(Shard(sub.index(letter)) if split
                           else Replicate())
            # an operand whole on m while others split it there gets a
            # partial sum for a gradient on each rank
            grad[i].append(want[i][-1] if split or letter is None
                           else Partial())
        if letter is None:
            out_pl.append(Replicate())
        elif letter in out:
            out_pl.append(Shard(out.index(letter)))
        else:
            out_pl.append(Partial())
    ops = [o if tuple(o.placements) == tuple(w) else o.redistribute(mesh, w)
           for o, w in zip(ops, want)]
    size = {}
    for sub, o in zip(subs, ops):
        size.update(zip(sub, o.shape))
    # contiguous: DTensor's reshape of the result runs a local view
    local = torch.einsum(eq, *[o.to_local(grad_placements=g)
                               for o, g in zip(ops, grad)]).contiguous()
    shape = torch.Size([size[c] for c in out])
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (no tensor made:
    under a fake mode even a meta tensor would count as one)."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def _as_dtensor(t, mesh):
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def tp_bf16_matmul(h, w, dp_logical: str = "batch"):
    """Megatron-style low-precision tensor-parallel projection: ``y = h @
    w`` with the contraction dim sharded over "model" and each rank's
    float32 partial sum CAST TO ``h``'s dtype BEFORE the all-reduce
    (half the TP traffic at bf16; ``sum(cast(p_i)) != cast(sum(p_i))``,
    so it is an explicit opt-in, rule ``_tp_bf16_reduce``).

    Returns None, and the caller runs its plain einsum, in the
    reference's cases: no rules or no mesh installed, the rule off, "mlp"
    not mapped to "model", or a mesh without a "model" axis.

    h: (..., F) activations, F sharded over "model"; w: (F, D) weights
    (its FSDP dim gathered first).  A plain ``h``/``w`` counts as
    replicated, and the result is then a plain tensor too.
    """
    rules, mesh = _CTX.rules, _CTX.mesh
    if rules is None or mesh is None:
        return None
    if not rules.rules.get("_tp_bf16_reduce"):
        return None
    if rules.rules.get("mlp") != "model" or (
            "model" not in mesh.mesh_dim_names):
        return None
    plain = not isinstance(h, DTensor)
    axes = mesh.mesh_dim_names
    dp = rules.rules.get(dp_logical)
    lead = (dp,) + (None,) * (h.dim() - 2)
    hd = _as_dtensor(h, mesh).redistribute(
        mesh, spec_placements(axes, lead + ("model",)))
    wd = _as_dtensor(w, mesh).redistribute(
        mesh, spec_placements(axes, ("model", None)))
    part = torch.einsum("...f,fd->...d", hd.to_local().to(torch.float32),
                        wd.to_local().to(torch.float32)).to(h.dtype)
    out_pl = list(spec_placements(axes, lead + (None,)))
    out_pl[axes.index("model")] = Partial()
    y = DTensor.from_local(part, mesh, out_pl, run_check=False)
    out_pl[axes.index("model")] = Replicate()
    y = y.redistribute(mesh, out_pl)            # the all-reduce, in bf16
    return y.full_tensor() if plain else y


def spec_tree(param_specs, rules: ShardingRules):
    """A tree of logical-name tuples -> a tree of specs (tuples)."""
    return _map_specs(lambda names: rules.spec(names), param_specs)


def sharding_tree(param_specs, rules: ShardingRules, mesh):
    """A tree of logical-name tuples -> a tree of (mesh, placements)."""
    return _map_specs(lambda names: rules.sharding(mesh, names),
                      param_specs)


def _map_specs(fn, specs):
    """``fn`` over the spec leaves of ``specs``: plain tuples are leaves
    (NamedTuples, dicts and lists are containers), as the reference's
    ``is_leaf=lambda x: type(x) is tuple``."""
    if type(specs) is tuple:
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*[_map_specs(fn, v) for v in specs])
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def spec_leaves(specs) -> list:
    """The spec leaves of ``specs`` in ``jax.tree`` order (dict keys
    sorted), the order of ``tree.leaves`` over the matching tensors."""
    if type(specs) is tuple:
        return [specs]
    if isinstance(specs, dict):
        return [n for k in sorted(specs) for n in spec_leaves(specs[k])]
    if isinstance(specs, (tuple, list)):
        return [n for v in specs for n in spec_leaves(v)]
    return [specs]


def map_specs(fn, specs, *trees):
    """``fn(names, *leaves)`` over the spec leaves of ``specs`` and the
    matching leaves of ``trees`` (of one structure); a tree of
    ``trees[0]``'s structure."""
    flat = spec_leaves(specs)
    cols = [tree.leaves(t) for t in trees]
    if any(len(c) != len(flat) for c in cols):
        raise ValueError(f"{len(flat)} spec leaves against "
                         f"{[len(c) for c in cols]} tensor leaves")
    return tree.unflatten(trees[0],
                          [fn(n, *xs) for n, *xs in zip(flat, *cols)])
