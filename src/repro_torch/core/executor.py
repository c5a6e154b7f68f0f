"""Weight-resident crossbar execution: program at load, read at inference.

The counterpart of ``repro.core.executor`` for one tenant:

  * :meth:`CrossbarExecutor.program_params` walks a model's params tree
    once, classifies every eligible linear weight (attention projections,
    dense MLP mats, the LM head), and programs each onto a
    :class:`~repro_torch.core.planes.PlaneBank` slot — layer-stacked
    leaves are unstacked so each layer owns its tiles.  Re-walking the
    same tree is a cache hit, never a re-program (``stats``).
  * :func:`crossbar_linear` is the drop-in the models route through:
    inside an :meth:`~CrossbarExecutor.activate` region it executes
    ``x @ W`` on the resident tiles via ``engine.matmul``; outside (or
    for weights the executor does not hold) it runs the caller's digital
    formulation.

Weights are addressed by *name*: ``models/transformer.py`` pushes name
scopes (``blocks.3.attn``) around each sub-module, so the same layer
functions resolve their tiles.

This slice serves one tenant (``"A"``) with every weight read in the
engine config's mode.  Hot-swap, eviction, multi-tenant multiplexing and
the IR-drop-aware ``"auto"`` mode policy are later slices of the port
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import engine, planes, timing
from repro_torch.core.engine import EngineConfig
from repro_torch.core.planes import PlaneBank

# weight-leaf classification: final path key -> contracted input axes,
# in the context of its parent module key
_ATTN_KEYS = {"wq": 1, "wk": 1, "wv": 1, "wo": 2}
_MLP_KEYS = {"wi": 1, "wg": 1, "wo": 1}
# top-level param stacks whose leading axis is the layer index
_STACKED_ROOTS = ("blocks",)
#: the one tenant this slice serves
TENANT = "A"


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is a later slice of the PyTorch port (ROADMAP.md); this "
        f"slice serves one tenant in the engine config's read mode")


def flatten_with_path(tree: Any, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[List[str], torch.Tensor]]:
    """(path parts, leaf) for every tensor of a nested dict of params, in
    sorted-key order (the order ``jax.tree_util`` flattens dicts in)."""
    if not isinstance(tree, dict):
        return [(list(prefix), tree)]
    out = []
    for k in sorted(tree):
        out += flatten_with_path(tree[k], prefix + (str(k),))
    return out


def _classify(parts: List[str]) -> Optional[int]:
    """Return contracted-input-axis count for an eligible leaf, else None."""
    if parts == ["head"]:
        return 1
    if len(parts) >= 2:
        mod, leaf = parts[-2], parts[-1]
        if mod == "attn" and leaf in _ATTN_KEYS:
            return _ATTN_KEYS[leaf]
        if mod == "mlp" and leaf in _MLP_KEYS:
            return _MLP_KEYS[leaf]
    return None


class CrossbarExecutor:
    """Programs a model's linear weights onto crossbar tiles exactly once
    and serves all subsequent ``x @ W`` reads from the resident tiles."""

    def __init__(self, cfg: EngineConfig = EngineConfig(mode="deepnet")):
        self.cfg = cfg
        self._cache: Dict[str, PlaneBank] = {}
        self._n_in: Dict[str, int] = {}
        # per tenant, the leaf tensors its planes were programmed from:
        # serving a DIFFERENT tree through them must be an error
        self._programmed_leaves: Dict[str, Tuple[Any, ...]] = {}
        self._versions: Dict[str, int] = {}
        # ambient leak override: a serving step runs under
        # leak_scope(<device scalar>) so the kernel reads the leak from
        # device memory
        self._leak_override: Optional[Any] = None
        self._leak_zero: Optional[torch.Tensor] = None
        self._device: Optional[torch.device] = None
        self.stats = {"programmed": 0, "cache_hits": 0, "program_walks": 0}

    def _event(self, stat: str, metric: str, help: str, n: int = 1,
               **labels: Any) -> None:
        """Bump a ``stats`` entry and its registry counter."""
        self.stats[stat] += n
        obs.registry().counter(metric, help=help).inc(n, **labels)

    # -- tenant addressing ----------------------------------------------------

    @property
    def stack_planes(self) -> int:
        return self.cfg.stack_planes

    def _resolve_tenant(self, tenant: Optional[str]) -> str:
        if tenant not in (None, TENANT):
            raise _later(f"tenant {tenant!r} (multi-tenant multiplexing)")
        return TENANT

    @contextlib.contextmanager
    def read_tenant(self, tenant: str):
        """Ambient-tenant scope; this slice serves tenant "A" only."""
        self._resolve_tenant(tenant)
        yield self

    @property
    def tenants(self) -> List[str]:
        """Resident tenants (those with a programmed plane set)."""
        return sorted(self._programmed_leaves)

    def residency(self) -> Dict[str, Dict[str, Any]]:
        """For every resident tenant: the fingerprint its planes were
        programmed from, its deploy version, and its per-mode weight
        counts."""
        out: Dict[str, Dict[str, Any]] = {}
        for t in self.tenants:
            n_exp = sum(1 for b in self._cache.values()
                        if b.has_tenant(t) and b.is_fused(t))
            n_deep = sum(1 for b in self._cache.values()
                         if b.has_tenant(t)) - n_exp
            out[t] = {"fingerprint": self.fingerprint(tenant=t),
                      "version": self.version(t),
                      "modes": {"expansion": n_exp, "deepnet": n_deep}}
        return out

    # -- write-plane leakage ----------------------------------------------------

    @contextlib.contextmanager
    def leak_scope(self, leak_codes):
        """Reads inside the block carry ``leak_codes`` (a float or a 0-d
        device tensor) as their common-mode pre-ADC term."""
        prev, self._leak_override = self._leak_override, leak_codes
        try:
            yield self
        finally:
            self._leak_override = prev

    def current_leak_codes(self) -> torch.Tensor:
        """The leak value a read issued now carries, as a cached device
        scalar: 0.0, since no swap is ever in flight in this slice."""
        if self._leak_zero is None:
            self._leak_zero = torch.zeros((), dtype=torch.float32,
                                          device=self._device)
        return self._leak_zero

    def device_token_cost(self, tenant: Optional[str] = None,
                          ) -> Dict[str, Dict[str, float]]:
        """Modeled device cost of ONE full-model read (one token), split
        by read mode: per resident weight, one bit-serial MAC of read
        time and ``in_bits * S * T`` worst-case analog column reads of
        energy (doubled for the differential planes)."""
        tenant = self._resolve_tenant(tenant)
        q, p = self.cfg.quant, self.cfg.params
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(self._cache):
            bank = self._cache[name]
            if not bank.has_tenant(tenant):
                continue
            pw = bank.active_for(tenant)
            s, t, r, n_pad = (int(d) for d in pw.pos.shape)
            entry = out.setdefault(
                bank.mode_for(tenant),
                {"grids": 0.0, "read_s": 0.0, "energy_j": 0.0})
            entry["grids"] += 1
            entry["read_s"] += timing.read_time(q.in_bits, p)
            entry["energy_j"] += (q.in_bits * s * t * 2
                                  * timing.mac_energy(r, n_pad, p=p))
        return out

    # -- programming (the write path; once per deployment) -----------------

    @staticmethod
    def _eligible(leaves) -> List[Tuple[str, Any, int]]:
        """(name, weight, n_in) for every eligible linear leaf, with
        layer-stacked roots unstacked so each layer owns its tiles."""
        out = []
        for parts, w in leaves:
            n_in = _classify(parts)
            if n_in is None:
                continue
            if parts[0] in _STACKED_ROOTS:
                for layer in range(w.shape[0]):
                    name = ".".join([parts[0], str(layer)] + parts[1:])
                    out.append((name, w[layer], n_in))
            else:
                out.append((".".join(parts), w, n_in))
        return out

    def program_params(self, params: Any, tenant: Optional[str] = None,
                       mode_policy=None) -> int:
        """Program every eligible linear weight in ``params`` onto the
        tenant's planes, weight by weight (each weight's quantization
        temporaries are freed before the next); idempotent.  Returns the
        number of weights newly programmed."""
        tenant = self._resolve_tenant(tenant)
        if mode_policy is not None:
            raise _later(f"mode_policy={mode_policy!r} (per-weight read "
                         f"modes and the IR-drop-aware 'auto' policy)")
        leaves = flatten_with_path(params)
        tree = tuple(w for _, w in leaves)
        if tenant not in self._programmed_leaves:
            self._programmed_leaves[tenant] = tree
        elif not self._same_tree(tree, tenant):
            raise RuntimeError(
                f"tenant {tenant!r} planes are already programmed from a "
                f"different params tree; resident weights are physical "
                f"state (hot-swap is a later slice of the port)")
        self._event("program_walks", "crossstack_program_walks_total",
                    "program_params pytree walks", tenant=tenant)
        new = 0
        with torch.no_grad():
            for name, w, n_in in self._eligible(leaves):
                new += self._program_one(name, w, n_in, tenant)
        if new:
            self._versions[tenant] = self._versions.get(tenant, 0) + 1
        return new

    def _program_one(self, name: str, w: torch.Tensor, n_in: int,
                     tenant: str) -> int:
        bank = self._cache.get(name)
        if bank is not None and bank.has_tenant(tenant):
            self._event("cache_hits", "crossstack_program_cache_hits_total",
                        "re-walks that found the weight already resident",
                        tenant=tenant)
            return 0
        k = math.prod(w.shape[:n_in])
        w2d = w.to(torch.float32).reshape(k, -1)
        if bank is None:
            bank = self._cache[name] = PlaneBank(
                name, n_planes=self.stack_planes)
            self._n_in[name] = n_in
        if self._device is None:
            self._device = w2d.device
        pw = engine.program(w2d, self.cfg)
        fp = planes.fingerprint_weight(w2d)
        if self.cfg.mode == "expansion":
            bank.assign_fused(tenant, pw, fp)
        else:
            bank.assign(tenant, pw, fp)
        self._event("programmed", "crossstack_programmed_weights_total",
                    "weights programmed onto resident planes",
                    tenant=tenant, mode=self.cfg.mode)
        return 1

    def _same_tree(self, leaves: Tuple[Any, ...], tenant: str) -> bool:
        prog = self._programmed_leaves.get(tenant)
        return (prog is not None and len(prog) == len(leaves)
                and all(a is b for a, b in zip(prog, leaves)))

    def ensure_programmed(self, params: Any, tenant: Optional[str] = None,
                          mode_policy=None) -> None:
        """Program on the first call; afterwards verify the caller serves
        the SAME params tree the tiles were programmed from."""
        tenant = self._resolve_tenant(tenant)
        leaves = tuple(w for _, w in flatten_with_path(params))
        if self._same_tree(leaves, tenant):
            return
        self.program_params(params, tenant, mode_policy=mode_policy)

    # -- read path ----------------------------------------------------------

    def has(self, name: str) -> bool:
        return name in self._cache

    def linear(self, x: torch.Tensor, w: torch.Tensor, name: str,
               tenant: Optional[str] = None) -> torch.Tensor:
        """Resident-tile execution of ``x @ W`` for the named weight.

        ``w`` is consulted only for its shape; the arithmetic reads the
        tenant's plane.  An expansion-fused pair never hosts a write, so
        its reads carry no leak term; other reads carry the ambient
        :meth:`leak_scope` value (0.0 outside one)."""
        tenant = self._resolve_tenant(tenant)
        bank = self._cache[name]
        pw = bank.active_for(tenant)
        cfg = self.cfg
        n_in = self._n_in[name]
        lead = x.shape[:-n_in]
        k = math.prod(x.shape[-n_in:])
        if k != pw.k:
            raise ValueError(f"{name}: input dim {k} != programmed {pw.k}")
        if bank.is_fused(tenant) or self._leak_override is None:
            leak = 0.0
        else:
            leak = self._leak_override
        y = engine.matmul(x.reshape(*lead, k).to(torch.float32), pw, cfg,
                          leak_codes=leak)
        return y.reshape(*lead, *w.shape[n_in:]).to(x.dtype)

    # -- fingerprints / versioning -------------------------------------------

    def fingerprint(self, name: Optional[str] = None,
                    tenant: Optional[str] = None) -> str:
        """With ``name``: the digest of the source weight that weight's
        plane was programmed from.  Without: a combined digest over all
        resident tiles (sorted by name) — two executors serving identical
        weights agree."""
        tenant = self._resolve_tenant(tenant)
        if name is not None:
            return self._cache[name].fingerprint_for(tenant)
        h = hashlib.blake2b(digest_size=8)
        for n in sorted(self._cache):
            h.update(n.encode())
            h.update(self._cache[n].fingerprint_for(tenant).encode())
        return h.hexdigest()

    def fingerprints(self, tenant: Optional[str] = None) -> Dict[str, str]:
        """Per-weight fingerprints of the tenant's plane set."""
        tenant = self._resolve_tenant(tenant)
        return {n: p.fingerprint_for(tenant)
                for n, p in sorted(self._cache.items())}

    def version(self, tenant: str = TENANT) -> int:
        """Monotone deploy counter: 0 = unprogrammed; +1 per program walk
        that wrote tiles."""
        return self._versions.get(self._resolve_tenant(tenant), 0)

    # -- later slices ----------------------------------------------------------

    def begin_swap(self, params: Any, tenant: str = TENANT):
        raise _later("hot-swap (begin_swap / promote)")

    def swap(self, params: Any, chunk_burst: int = 64, tenant: str = TENANT):
        raise _later("hot-swap (swap)")

    def evict_tenant(self, tenant: str) -> None:
        raise _later("tenant eviction")

    # -- bookkeeping ---------------------------------------------------------

    @property
    def n_resident(self) -> int:
        return len(self._cache)

    @property
    def n_devices(self) -> int:
        """Programmed memristors serving reads (read-active planes)."""
        return sum(bank.n_devices for bank in self._cache.values())

    @property
    def n_devices_physical(self) -> int:
        """Total memristors in the stacks, all plane slots included."""
        return sum(bank.n_devices_physical
                   for bank in self._cache.values())

    @contextlib.contextmanager
    def activate(self):
        global _ACTIVE
        prev, _ACTIVE = _ACTIVE, self
        try:
            yield self
        finally:
            _ACTIVE = prev


# -- routing: active executor + name scopes (Python state) -----------------

_ACTIVE: Optional[CrossbarExecutor] = None
_SCOPE: List[str] = []


def active() -> Optional[CrossbarExecutor]:
    return _ACTIVE


@contextlib.contextmanager
def scope(name: Any):
    """Push a name-scope segment (layer index, module name) for routing."""
    _SCOPE.append(str(name))
    try:
        yield
    finally:
        _SCOPE.pop()


def scoped(name: str) -> str:
    return ".".join(_SCOPE + [name]) if _SCOPE else name


def crossbar_linear(x: torch.Tensor, w: torch.Tensor, name: str,
                    digital=None) -> torch.Tensor:
    """Drop-in linear: resident-crossbar read when an executor is active
    and holds the scoped weight, else the caller's digital formulation
    (``digital`` is a thunk)."""
    ex = _ACTIVE
    if ex is not None:
        full = scoped(name)
        if ex.has(full):
            return ex.linear(x, w, full)
    if digital is None:
        # only the executor knows how many input axes a named weight
        # contracts (attention wo contracts two)
        raise ValueError(
            f"no resident tiles for {scoped(name)!r} and no digital "
            f"fallback provided")
    return digital()
