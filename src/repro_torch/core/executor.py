"""Weight-resident crossbar execution: program at load, read at inference.

The counterpart of ``repro.core.executor``:

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

Each weight's read mode is a physical plane layout fixed at program time
by a *mode policy*: an expansion-fused plane pair (two row tiles summed
in analog before one ADC conversion) or a deep-net slot.  ``"auto"``
fuses the accuracy-critical weights (attention, the LM head) and keeps
the MLP in deep-net layout; :meth:`CrossbarExecutor.mode_report` scores
each choice with the exact nodal IR-drop solves of ``core/ir_drop.py``.

Every weight is a :class:`~repro_torch.core.planes.PlaneBank` of
``stack_planes`` role-tagged slots, and the executor keeps one residency
registry over the banks: ``program_params(params, tenant=...)`` deploys
up to ``stack_planes`` checkpoints (tenants "A", "B", ...; one plane
each), and ``linear(..., tenant=...)`` or the ambient :meth:`read_tenant`
scope selects the tenant's plane per bank — N models served from one
physical stack.  "A" anchors the banks: it is never evicted and its
reads never pause.

:meth:`CrossbarExecutor.begin_swap` is the paper's deep-net mode at the
serving tier.  With a free plane the swap is **staged**: a staging slot
is reserved per bank, the new checkpoint programs into it in
write-latency-costed chunks (:meth:`~CrossbarExecutor.write_chunks`,
meant to interleave with decode steps), each weight is write-verified
against a one-shot programming, and :meth:`~CrossbarExecutor.promote`
retargets the tenant's read-enable atomically — the tenant serves its
old planes through the whole window; a tenant not yet resident deploys
live the same way.  With a full bank a resident non-anchor tenant is
rewritten **in place**: its reads pause for the window while every other
tenant keeps serving.

Each tenant's plane set carries a generation (:meth:`plane_generation`)
that moves whenever its planes are programmed, promoted, rewritten or
evicted; a captured serving step records it and is dropped when it
moved, since a CUDA graph holds plane addresses, not planes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import obs
from repro_torch.core import engine, ir_drop, planes, timing
from repro_torch.core.engine import EngineConfig
from repro_torch.core.planes import ChunkedProgram, PlaneBank, SwapPlan

# weight-leaf classification: final path key -> contracted input axes,
# in the context of its parent module key
_ATTN_KEYS = {"wq": 1, "wk": 1, "wv": 1, "wo": 2}
_MLP_KEYS = {"wi": 1, "wg": 1, "wo": 1}
# top-level param stacks whose leading axis is the layer index
_STACKED_ROOTS = ("blocks",)

#: per-weight read modes a policy may assign ("auto" resolves to one)
READ_MODES = ("expansion", "deepnet")

#: a mode policy: None (= cfg.mode for every weight), a uniform mode,
#: "auto" (IR-drop-aware per-layer selection), or a mapping from weight
#: name / dotted name fragment to a mode (values may themselves be
#: "auto"; the special key "default" covers unmatched weights)
ModePolicy = Union[None, str, Dict[str, str]]


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
        self._swap: Optional[SwapPlan] = None
        self._versions: Dict[str, int] = {}
        # per tenant, moved whenever its plane set changes (programmed,
        # promoted, rewritten in place, evicted); see plane_generation
        self._generations: Dict[str, int] = {}
        # ambient tenant for linear()/fingerprint()/ensure_programmed()
        # when no tenant is passed; set by read_tenant()
        self._read_tenant: str = "A"
        # ambient leak override: a serving step runs under
        # leak_scope(<device scalar>) so the kernel reads the leak from
        # device memory
        self._leak_override: Optional[Any] = None
        # cached device scalars for current_leak_codes(): cfg is frozen,
        # so both values are constants — one host->device copy each
        self._leak_zero: Optional[torch.Tensor] = None
        self._leak_live: Optional[torch.Tensor] = None
        self._device: Optional[torch.device] = None
        # per-weight read mode: one cached EngineConfig per mode, plus the
        # resolved policy's reasons and the IR scores for mode_report
        self._mode_cfgs: Dict[str, EngineConfig] = {cfg.mode: cfg}
        self._mode_reasons: Dict[Tuple[str, str], str] = {}
        self._ir_scores: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self.stats = {"programmed": 0, "cache_hits": 0, "program_walks": 0,
                      "swaps": 0, "swap_chunks": 0}
        # wall-clock start of the in-flight swap window, for the
        # executor_swap span recorded at promote()
        self._swap_t0: Optional[float] = None

    def _event(self, stat: str, metric: str, help: str, n: int = 1,
               **labels: Any) -> None:
        """Bump a ``stats`` entry and its registry counter."""
        self.stats[stat] += n
        obs.registry().counter(metric, help=help).inc(n, **labels)

    # -- tenant addressing ----------------------------------------------------

    @property
    def stack_planes(self) -> int:
        return self.cfg.stack_planes

    @property
    def tenant_names(self) -> Tuple[str, ...]:
        """The addressable tenant population, one name per plane slot."""
        return self.cfg.device.tenant_names

    @property
    def anchor(self) -> str:
        """The anchor tenant (the first name, "A"): required by the
        serving tier, never evicted, and never paused by an in-place
        rewrite — its deploys go through staged swaps."""
        return self.tenant_names[0]

    def _check_tenant(self, tenant: str) -> str:
        if tenant not in self.tenant_names:
            raise ValueError(
                f"unknown tenant {tenant!r}: a {self.stack_planes}-plane "
                f"stack serves at most tenants {self.tenant_names}")
        return tenant

    def _resolve_tenant(self, tenant: Optional[str]) -> str:
        return self._check_tenant(tenant or self._read_tenant)

    @contextlib.contextmanager
    def read_tenant(self, tenant: str):
        """Ambient-tenant scope: reads (and programming checks) inside
        the block address ``tenant``'s plane set.  A serving lane enters
        it before its step runs or is captured, so the step reads that
        tenant's planes."""
        self._check_tenant(tenant)
        prev, self._read_tenant = self._read_tenant, tenant
        try:
            yield self
        finally:
            self._read_tenant = prev

    def plane_generation(self, tenant: str) -> int:
        """A counter that moves whenever ``tenant``'s plane set changes:
        programmed, promoted (staged or in place) or evicted.  A CUDA
        graph holds the device addresses of the planes it read, so a
        captured step records this at capture and must not replay once
        it moved."""
        return self._generations.get(self._check_tenant(tenant), 0)

    def _planes_changed(self, tenant: str) -> None:
        self._generations[tenant] = self._generations.get(tenant, 0) + 1

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
        scalar: the write plane's subthreshold leakage while a swap is in
        flight with ``cfg.swap_leakage`` set, else 0.0.  A serving step
        copies it into its own leak buffer each step."""
        if self._swap is not None and self.cfg.swap_leakage:
            if self._leak_live is None:
                self._leak_live = planes.write_leak_scalar(self.cfg,
                                                           self._device)
            return self._leak_live
        return self._zero_leak()

    def _zero_leak(self) -> torch.Tensor:
        if self._leak_zero is None:
            self._leak_zero = torch.zeros((), dtype=torch.float32,
                                          device=self._device)
        return self._leak_zero

    # -- per-weight read-mode policy ---------------------------------------

    def _read_cfg(self, mode: str) -> EngineConfig:
        """The engine config a read in ``mode`` uses: ``self.cfg`` when
        the mode matches, else a cached ``dataclasses.replace`` variant.
        Programming is mode-independent (one ``ProgrammedLinear`` serves
        both read paths), so the mode only decides the read-time ADC
        grouping (``rows_per_adc``)."""
        cfg = self._mode_cfgs.get(mode)
        if cfg is None:
            cfg = self._mode_cfgs[mode] = dataclasses.replace(
                self.cfg, mode=mode)
        return cfg

    def _row_tiles(self, k: int) -> int:
        return -(-k // self.cfg.tile_rows)

    def _auto_mode(self, name: str, k: int) -> Tuple[str, str]:
        """IR-drop-aware per-layer selection.

        Expansion mode cuts worst-case IR deviation (paper: 22%) but
        fuses both planes read-only — no write shadow, so no overlapped
        reprogramming.  The policy spends the fused pairs on
        accuracy-critical layers (attention projections and the LM head)
        and keeps the swap-heavy MLP mats in deep-net layout.  A layer
        only qualifies when its row tiles pair up evenly (an odd count
        would hit the per-plane ADC fallback and forfeit the benefit).
        """
        t = self._row_tiles(k)
        parts = name.split(".")
        critical = name == "head" or "attn" in parts or "xattn" in parts
        if not critical:
            return "deepnet", "auto: swap-heavy (mlp) — keep write shadow"
        if t < 2 or t % 2:
            return ("deepnet",
                    f"auto: {t} row-tile(s) cannot pair across planes")
        return "expansion", "auto: accuracy-critical (attention/head)"

    def _validate_policy(self, policy: ModePolicy) -> None:
        """Reject malformed policies before any residency state mutates:
        a refused ``program_params`` call leaves the executor as it was."""
        if policy is None:
            return
        valid = READ_MODES + ("auto",)
        if isinstance(policy, str):
            if policy not in valid:
                raise ValueError(
                    f"unknown mode policy {policy!r}: want one of "
                    f"{valid} or a name->mode mapping")
            return
        for pat, mode in policy.items():
            if mode not in valid:
                raise ValueError(
                    f"mode policy entry {pat!r} maps to {mode!r}; want "
                    f"one of {valid}")

    def _resolve_mode(self, policy: ModePolicy, name: str,
                      k: int) -> Tuple[str, str]:
        """(mode, reason) for one weight under ``policy``.

        Mapping keys match the full dotted name, any contiguous dotted
        fragment of it (``"attn"``, ``"attn.wq"``, ``"blocks.0"``; the
        most specific — most segments, then longest — wins), or
        ``"default"`` for the rest; values may be ``"auto"``.  Unmatched
        weights without a ``"default"`` entry read in deep-net layout.
        The policy has passed :meth:`_validate_policy`.
        """
        if isinstance(policy, str):
            if policy == "auto":
                return self._auto_mode(name, k)
            return policy, f"uniform policy {policy!r}"
        if name in policy:
            mode, why = policy[name], f"policy[{name!r}]"
        else:
            hay = f".{name}."
            best = None
            for pat in policy:
                if pat != "default" and f".{pat}." in hay:
                    if (best is None
                            or pat.count(".") > best.count(".")
                            or (pat.count(".") == best.count(".")
                                and len(pat) > len(best))):
                        best = pat
            if best is not None:
                mode, why = policy[best], f"policy[{best!r}]"
            else:
                mode, why = policy.get("default", "deepnet"), "policy default"
        if mode == "auto":
            return self._auto_mode(name, k)
        return mode, why

    def mode_for(self, name: str, tenant: Optional[str] = None) -> str:
        """The read mode the named weight is programmed in (ground truth
        is bank residency, not the requested policy)."""
        return self._cache[name].mode_for(self._resolve_tenant(tenant))

    def _tile_scores(self, k: int, n: int,
                     max_nodes: int = 1024) -> Dict[str, Any]:
        """Worst-case IR-deviation scores at a weight's tile geometry
        (nodal solves on the executor's device, cached per effective
        tile)."""
        key = (min(k, self.cfg.tile_rows), min(n, self.cfg.tile_cols))
        score = self._ir_scores.get(key)
        if score is None:
            score = self._ir_scores[key] = ir_drop.mode_ir_report(
                key[0], key[1], r_wire=self.cfg.params.r_wire,
                params=self.cfg.params, max_nodes=max_nodes,
                device=self._device)
        return score

    def mode_report(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Per-weight mode choices with their IR-drop economics.

        For every resident weight of the tenant: the programmed mode, why
        the policy chose it, and the worst-case IR deviation of a tile at
        its geometry under each layout (``ir_drop.mode_ir_report``: exact
        nodal solves at the all-SET/full-drive operating point, planar
        2n-row tile vs the CrossStack fused pair).  The aggregate carries
        the mean reduction over expansion-programmed layers — the paper's
        headline 22% figure.
        """
        tenant = self._resolve_tenant(tenant)
        layers: Dict[str, Any] = {}
        for name in sorted(self._cache):
            bank = self._cache[name]
            if not bank.has_tenant(tenant):
                continue
            pw = bank.active_for(tenant)
            score = self._tile_scores(pw.k, pw.n)
            layers[name] = {
                "mode": bank.mode_for(tenant),
                "fused": bank.is_fused(tenant),
                "row_tiles": int(pw.pos.shape[1]),
                "k": pw.k, "n": pw.n,
                "reason": self._mode_reasons.get((tenant, name), ""),
                "dev_deepnet": score["dev_deepnet"],
                "dev_expansion": score["dev_expansion"],
                "ir_drop_reduction": score["ir_drop_reduction"],
            }
        exp = [e for e in layers.values() if e["mode"] == "expansion"]
        agg = {
            "tenant": tenant,
            "n_expansion": len(exp),
            "n_deepnet": len(layers) - len(exp),
            "tile_rows": self.cfg.tile_rows,
            "tile_cols": self.cfg.tile_cols,
            "stack_planes": self.stack_planes,
            # mean worst-case IR-drop reduction the fused pairs buy, over
            # the layers actually programmed in expansion layout
            "ir_drop_reduction_expansion": (
                sum(e["ir_drop_reduction"] for e in exp) / len(exp)
                if exp else 0.0),
        }
        return {"layers": layers, "aggregate": agg}

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
        temporaries are freed before the next); idempotent.

        ``mode_policy`` decides each weight's plane layout: ``None``
        (every weight in ``cfg.mode``), a uniform ``"expansion"`` /
        ``"deepnet"``, ``"auto"``, or a name->mode mapping (see
        :meth:`_resolve_mode`).  Re-walking the same tree is a cache hit;
        asking a resident weight for the other layout is an error (modes
        are physical plane layout).  Returns the number of weights newly
        programmed."""
        tenant = self._resolve_tenant(tenant)
        self._validate_policy(mode_policy)
        if tenant not in self._programmed_leaves:
            self._require_free_plane(tenant)
        leaves = flatten_with_path(params)
        tree = tuple(w for _, w in leaves)
        if tenant not in self._programmed_leaves:
            self._programmed_leaves[tenant] = tree
        elif not self._same_tree(tree, tenant):
            raise RuntimeError(
                f"tenant {tenant!r} planes are already programmed from a "
                f"different params tree; resident weights are physical "
                f"state — use swap(params, tenant={tenant!r}) / "
                f"begin_swap(params, tenant={tenant!r}) for a "
                f"zero-downtime reprogram")
        self._event("program_walks", "crossstack_program_walks_total",
                    "program_params pytree walks", tenant=tenant)
        new = 0
        with torch.no_grad():
            for name, w, n_in in self._eligible(leaves):
                if mode_policy is None:
                    # no preference: resident weights keep their layout,
                    # new ones program in the engine's cfg.mode
                    mode, reason = None, "engine default (cfg.mode)"
                else:
                    k = math.prod(w.shape[:n_in])
                    mode, reason = self._resolve_mode(mode_policy, name, k)
                new += self._program_one(name, w, n_in, tenant, mode,
                                         reason)
        if new:
            self._versions[tenant] = self._versions.get(tenant, 0) + 1
            self._planes_changed(tenant)
        return new

    def _require_free_plane(self, tenant: str) -> None:
        """A first-time tenant needs one free slot per bank.  Resident
        tenants (an expansion-fused one holds two slots in its banks),
        an in-flight staged swap's reserved slot and fused companions
        all occupy planes; admitting a tenant past the bound would
        overflow the stack or take the plane an open swap lands on at
        promote().  Bank slot roles are the ground truth once banks
        exist; before any does, the tenant count is."""
        staging = self._swap is not None and not self._swap.in_place
        if self._cache:
            if min(b.n_free for b in self._cache.values()) > 0:
                return
        else:
            occupied = len(self._programmed_leaves) + (1 if staging else 0)
            if occupied < self.stack_planes:
                return
        if staging:
            raise RuntimeError(
                f"cannot deploy new tenant {tenant!r} while a hot-swap is "
                f"in flight (the staging plane is the swap's write "
                f"target); promote() or abort_swap() first")
        raise RuntimeError(
            f"stack is full: {self.stack_planes} planes hold resident "
            f"tenants {self.tenants}; evict_tenant() before deploying "
            f"{tenant!r}")

    def _program_one(self, name: str, w: torch.Tensor, n_in: int,
                     tenant: str, mode: Optional[str], reason: str) -> int:
        bank = self._cache.get(name)
        if bank is not None and bank.has_tenant(tenant):
            have = bank.mode_for(tenant)
            if mode is not None and have != mode:
                raise RuntimeError(
                    f"{name}: tenant {tenant!r} is already resident in "
                    f"{have} layout but the policy asks for {mode}; mode "
                    f"is physical plane layout — evict_tenant() and "
                    f"re-program to change it")
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
        else:
            ref = bank.any_plane
            if (w2d.shape[0], w2d.shape[1]) != (ref.k, ref.n):
                raise ValueError(
                    f"{name}: tenant {tenant!r} weight shape "
                    f"{tuple(w2d.shape)} != the bank's tile geometry "
                    f"{(ref.k, ref.n)}; tenants share physical stacks")
        if self._device is None:
            self._device = w2d.device
        # programming is mode-independent: the same ProgrammedLinear
        # serves both read paths; the mode decides slot layout (fused
        # pair vs single plane) and the read-time ADC grouping
        if mode is None:
            mode = self.cfg.mode
        pw = engine.program(w2d, self.cfg)
        fp = planes.fingerprint_weight(w2d)
        if mode == "expansion":
            bank.assign_fused(tenant, pw, fp)
        else:
            bank.assign(tenant, pw, fp)
        self._mode_reasons[(tenant, name)] = reason
        self._event("programmed", "crossstack_programmed_weights_total",
                    "weights programmed onto resident planes",
                    tenant=tenant, mode=mode)
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
        tenant's plane in the mode of its residency layout (an
        expansion-fused pair reads with doubled-input ADC grouping).  A
        fused pair never hosts a write, so its reads carry no leak term;
        other reads carry the ambient :meth:`leak_scope` value, or
        outside one :meth:`current_leak_codes` (the write plane's leakage
        while a swap is in flight with ``cfg.swap_leakage``, else 0.0).
        The leak always reaches the MAC as a device scalar, so a read
        makes no host value into a device operand, and a captured step
        reads its leak from device memory.  Reads of a tenant whose own
        planes are mid-write (an in-place swap) are refused: those
        wordlines drive write pulses, not read pulses."""
        tenant = self._resolve_tenant(tenant)
        if (self._swap is not None and self._swap.in_place
                and self._swap.tenant == tenant):
            raise RuntimeError(
                f"tenant {tenant!r} planes are mid-write (in-place swap "
                f"in flight); reads resume after promote()")
        bank = self._cache[name]
        pw = bank.active_for(tenant)
        cfg = self._read_cfg(bank.mode_for(tenant))
        n_in = self._n_in[name]
        lead = x.shape[:-n_in]
        k = math.prod(x.shape[-n_in:])
        if k != pw.k:
            raise ValueError(f"{name}: input dim {k} != programmed {pw.k}")
        if bank.is_fused(tenant):
            leak = self._zero_leak()
        elif self._leak_override is not None:
            leak = self._leak_override
        else:
            leak = self.current_leak_codes()
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

    def version(self, tenant: str = "A") -> int:
        """Per-tenant monotone deploy counter: 0 = unprogrammed; +1 per
        program walk that wrote tiles; +1 per promoted swap."""
        return self._versions.get(self._check_tenant(tenant), 0)

    @property
    def programmed_version(self) -> int:
        """Tenant A's deploy counter; see :meth:`version`."""
        return self.version("A")

    # -- deep-net hot-swap (write the shadow planes, then flip) --------------

    @property
    def swap_in_flight(self) -> bool:
        return self._swap is not None

    def begin_swap(self, params: Any, tenant: str = "A") -> SwapPlan:
        """Stage ``params`` for chunked programming of a tenant's plane
        set.

        With a free plane in every bank the swap is **staged**: a
        staging slot is reserved per bank, the new checkpoint programs
        into it chunk by chunk (:meth:`write_chunks`), and
        :meth:`promote` retargets the tenant's read-enable atomically —
        the tenant (resident, or a first-time live deploy) never stops
        serving.  With a full bank a resident non-anchor tenant is
        rewritten **in place**: its reads pause until :meth:`promote`
        while every other tenant keeps serving.  The anchor's reads never
        pause, so its swaps need a free plane.

        The incoming tree must carry exactly the resident tile set with
        matching shapes (a new checkpoint, a fine-tuned delta or
        recalibrated conductances — not a different architecture).

        Expansion-fused weights refuse overlap writes: a fused pair holds
        both of its planes RE-high for the tenant's reads, so there is no
        write shadow to stage into.  A tenant with any fused weight
        therefore always swaps in place, and the anchor cannot swap at
        all while fused.
        """
        self._check_tenant(tenant)
        if not self._cache:
            raise RuntimeError("nothing programmed; call program_params "
                               "before begin_swap")
        if self._swap is not None:
            raise RuntimeError("a hot-swap is already in flight; promote() "
                               "or abort_swap() first")
        resident = tenant in self._programmed_leaves
        fused = resident and any(
            bank.is_fused(tenant) for bank in self._cache.values()
            if bank.has_tenant(tenant))
        if fused and tenant == self.anchor:
            raise RuntimeError(
                f"tenant {tenant!r} holds expansion-fused planes (both "
                f"RE high — no write shadow) and anchors the stack, so "
                f"its reads cannot pause for an in-place rewrite; "
                f"expansion-mode anchor deploys are cold deploys "
                f"(evict/reprogram), or program the anchor in deep-net "
                f"layout to hot-swap it")
        n_free = min(bank.n_free for bank in self._cache.values())
        if fused:
            # overlap refused: rewrite the fused tenant's own pair with
            # reads paused, whatever free planes exist
            n_free = 0
        if n_free == 0 and not fused:
            others = sorted(t for t in self._programmed_leaves
                            if t != tenant)
            if not resident:
                raise RuntimeError(
                    f"cannot live-deploy tenant {tenant!r}: stack is full "
                    f"({self.stack_planes} planes hold tenant(s) "
                    f"{others}); evict_tenant() first")
            if tenant == self.anchor:
                raise RuntimeError(
                    f"tenant {tenant!r} has no free write plane: the "
                    f"{self.stack_planes}-plane stack also holds "
                    f"tenant(s) {others}, and the anchor tenant cannot "
                    f"pause for an in-place rewrite; swap or evict one "
                    f"of {others} first")
        in_place = resident and n_free == 0
        leaves = flatten_with_path(params)
        programs = []
        for name, w, n_in in self._eligible(leaves):
            if name not in self._cache:
                raise ValueError(
                    f"swap tree carries {name!r} which has no resident "
                    f"tiles; hot-swap reprograms existing planes only")
            pw = self._cache[name].any_plane
            k = math.prod(w.shape[:n_in])
            w2d = w.to(torch.float32).reshape(k, -1)
            if (k, w2d.shape[1]) != (pw.k, pw.n):
                raise ValueError(
                    f"{name}: swap shape {(k, w2d.shape[1])} != resident "
                    f"{(pw.k, pw.n)}")
            programs.append(ChunkedProgram(name, w2d, self.cfg))
        missing = set(self._cache) - {cp.name for cp in programs}
        if missing:
            raise ValueError(
                f"swap tree is missing resident tiles: {sorted(missing)}")
        if not in_place:
            # reserve the write target up front (all validation passed):
            # a concurrent new-tenant deploy cannot claim the plane this
            # swap lands on at promote()
            for bank in self._cache.values():
                bank.reserve_staging()
        self._swap = SwapPlan(programs, tuple(w for _, w in leaves), params,
                              tenant=tenant, in_place=in_place)
        self._swap_t0 = time.perf_counter()
        return self._swap

    def write_chunks(self, n: int = 1) -> int:
        """Program up to ``n`` write-latency-costed chunks of the staged
        swap (each is one t_write pulse in the device-time model); a
        weight whose last chunk lands is write-verified here, inside the
        overlap window.  Returns the number of chunks still unwritten."""
        if self._swap is None:
            raise RuntimeError("no hot-swap in flight")
        for _ in range(n):
            if self._swap.done:
                break
            finished = self._swap.write_chunk()
            self._event("swap_chunks", "crossstack_swap_chunks_total",
                        "write-latency-costed chunks programmed into "
                        "swap targets", tenant=self._swap.tenant)
            if finished is not None:
                staged = finished.finish()
                finished.verify(staged)
                self._swap.staged[finished.name] = (staged, finished.fp)
        return self._swap.remaining

    def promote(self) -> Any:
        """Atomically land the freshly written plane set.

        Every staged plane was write-verified when its last chunk landed;
        this gate checks completeness and ownership — every tile staged
        by THIS plan — before any bank changes, so a read can never
        observe a mixed-plane state.  Each bank's staging slot becomes
        the tenant's resident plane and the previous slot reverts to free
        (its plane tensors are released); an in-place plan rewrites the
        tenant's own slot and un-pauses its reads.  Either way the
        tenant's plane generation moves, so a captured step that read the
        old planes is dropped.  Returns the promoted params tree.
        """
        plan = self._swap
        if plan is None:
            raise RuntimeError("no hot-swap in flight")
        if not plan.done:
            raise RuntimeError(
                f"swap not complete: {plan.remaining} chunks unwritten")
        for name, fp in plan.expected_fingerprints.items():
            got = plan.staged.get(name)
            if got is None or got[1] != fp:
                raise RuntimeError(
                    f"{name}: staged plane fingerprint "
                    f"{got[1] if got else None} != checkpoint {fp}; "
                    f"refusing to promote")
        for cp in plan.programs:
            bank = self._cache[cp.name]
            pw, fp = plan.staged[cp.name]
            if plan.in_place:
                bank.assign(plan.tenant, pw, fp)
            else:
                bank.land_staged(plan.tenant, pw, fp)
        self._programmed_leaves[plan.tenant] = plan.leaves
        self._versions[plan.tenant] = self._versions.get(plan.tenant, 0) + 1
        self._planes_changed(plan.tenant)
        lifecycle = "in_place" if plan.in_place else "staged"
        self._event("swaps", "crossstack_swaps_total",
                    "promoted plane-set swaps, by lifecycle",
                    tenant=plan.tenant, lifecycle=lifecycle)
        obs.tracer().record(
            "executor_swap", self._swap_t0, time.perf_counter(),
            tenant=plan.tenant, lifecycle=lifecycle,
            chunks=plan.total_chunks,
            device_write_s=plan.device_write_time())
        self._swap = None
        self._swap_t0 = None
        return plan.params

    def abort_swap(self) -> None:
        """Drop an in-flight swap; every tenant's resident planes keep
        serving (written-and-verified planes are buffered in the plan and
        never touch a bank before promote, so abort is pure discard — a
        staged plan's reserved slots revert to free)."""
        if self._swap is not None:
            obs.registry().counter(
                "crossstack_swap_aborts_total",
                help="in-flight swaps discarded before promote").inc(
                    tenant=self._swap.tenant)
            if not self._swap.in_place:
                for bank in self._cache.values():
                    bank.release_staging()
        self._swap = None
        self._swap_t0 = None

    def swap(self, params: Any, chunk_burst: int = 64,
             tenant: str = "A") -> Dict[str, Any]:
        """Blocking swap: stage, write every chunk, promote — the
        stop-the-world comparison point and the API for offline reloads
        (the overlapped path interleaves ``write_chunks`` with decode
        steps instead)."""
        plan = self.begin_swap(params, tenant=tenant)
        while not plan.done:
            self.write_chunks(chunk_burst)
        self.promote()
        return {"n_tiles": len(plan.programs),
                "n_chunks": plan.total_chunks,
                "tenant": plan.tenant,
                "swap_mode": "in_place" if plan.in_place else "staged",
                "device_write_s": plan.device_write_time(),
                "programmed_version": self.version(plan.tenant)}

    def evict_tenant(self, tenant: str) -> None:
        """Evict a resident tenant: its slot in every bank (and a fused
        companion) reverts to free, and its plane generation moves.  The
        anchor cannot be evicted (reprogram it via swap), and nothing is
        evicted while a swap plan is in flight over the stack's weights:
        ``promote()`` or ``abort_swap()`` first."""
        self._check_tenant(tenant)
        if tenant == self.anchor:
            raise ValueError(
                f"tenant {tenant!r} anchors the plane banks; "
                f"swap(params) to replace its weights")
        if self._swap is not None:
            raise RuntimeError(
                f"cannot evict tenant {tenant!r}: a swap plan is in "
                f"flight over this stack's weights; promote() or "
                f"abort_swap() first")
        if tenant not in self._programmed_leaves:
            return
        for bank in self._cache.values():
            if bank.has_tenant(tenant):
                bank.evict(tenant)
        del self._programmed_leaves[tenant]
        self._planes_changed(tenant)

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
