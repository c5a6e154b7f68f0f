"""Plane banks: the executor's residency registry (PyTorch).

The counterpart of ``repro.core.planes``:

  * :class:`PlaneBank` — an ordered bank of ``stack_planes`` role-tagged
    plane slots per named weight.  Each slot is ``free``, ``staging``
    (the reserved write target of an in-flight swap), ``resident`` for a
    named tenant, or ``fused`` (the companion plane of an
    expansion-programmed weight).
  * :class:`ChunkedProgram` — incremental programming of one weight onto
    a staging plane, one row tile per chunk (one ``t_write`` pulse in
    the device-time model), bitwise equal to ``engine.program``.
  * :class:`SwapPlan` — the ordered chunk work-list for a whole params
    tree, consumed by ``CrossbarExecutor.write_chunks`` and promoted
    atomically by ``CrossbarExecutor.promote``.
  * :func:`write_leak_codes` — the N1 subthreshold leakage of an
    in-flight write, in pre-ADC code units.

The fingerprints are byte-for-byte those of the reference: the same
shapes and bytes go into the same blake2b digest, so a weight and its
programmed tiles carry the same identity in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine, quant
from repro_torch.core.engine import EngineConfig, ProgrammedLinear


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().cpu().numpy()


def fingerprint_weight(w2d: torch.Tensor) -> str:
    """Content digest of a (K, N) float32 weight — the identity of what a
    plane was programmed from."""
    arr = _host(w2d.to(torch.float32))
    h = hashlib.blake2b(digest_size=8)
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def fingerprint_tiles(pw: ProgrammedLinear) -> str:
    """Content digest of PROGRAMMED tile state (cell codes + scales)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(str((pw.k, pw.n, tuple(pw.pos.shape))).encode())
    for arr in (pw.pos, pw.neg, pw.w_scale):
        h.update(_host(arr).tobytes())
    return h.hexdigest()


#: slot lifecycle roles: free -> staging -> resident(tenant) -> free,
#: plus the fused companion of an expansion-programmed resident slot
ROLE_FREE = "free"
ROLE_STAGING = "staging"
ROLE_RESIDENT = "resident"
ROLE_FUSED = "fused"


@dataclasses.dataclass
class PlaneSlot:
    """One physical plane of a bank plus its role: a ``resident`` slot
    carries a programmed plane and its fingerprint; a ``staging`` slot is
    reserved (empty until promotion lands the write-verified plane on
    it); a ``free`` slot is dark silicon."""
    plane: Optional[ProgrammedLinear] = None
    fp: Optional[str] = None
    role: str = ROLE_FREE
    tenant: Optional[str] = None


@dataclasses.dataclass
class PlaneBank:
    """An ordered bank of N role-tagged tile-grid plane slots.

    Every resident tenant owns one slot (two for an expansion-fused
    weight: the resident slot holds the tiles, its ``fused`` companion is
    the second physical plane with RE permanently high); reads address
    the tenant, not a physical index.
    """
    name: str
    n_planes: int = 2
    slots: List[PlaneSlot] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.n_planes < 2:
            raise ValueError(f"{self.name}: a bank needs >= 2 planes")
        if not self.slots:
            self.slots = [PlaneSlot() for _ in range(self.n_planes)]

    # -- queries -------------------------------------------------------------

    def slot_of(self, tenant: str) -> Optional[PlaneSlot]:
        for s in self.slots:
            if s.role == ROLE_RESIDENT and s.tenant == tenant:
                return s
        return None

    @property
    def residents(self) -> List[str]:
        return [s.tenant for s in self.slots if s.role == ROLE_RESIDENT]

    def has_tenant(self, tenant: str) -> bool:
        return self.slot_of(tenant) is not None

    def fused_companion(self, tenant: str) -> Optional[PlaneSlot]:
        for s in self.slots:
            if s.role == ROLE_FUSED and s.tenant == tenant:
                return s
        return None

    def is_fused(self, tenant: str) -> bool:
        """True when the tenant's weight is expansion-programmed across a
        fused plane pair (read mode "expansion")."""
        return self.fused_companion(tenant) is not None

    def n_slots_of(self, tenant: str) -> int:
        """Plane slots the tenant occupies: 2 for a fused pair, else 1."""
        return 2 if self.is_fused(tenant) else 1

    def mode_for(self, tenant: str) -> str:
        """The read mode the tenant's residency implies."""
        self._resident_slot(tenant)
        return "expansion" if self.is_fused(tenant) else "deepnet"

    def _resident_slot(self, tenant: str) -> PlaneSlot:
        s = self.slot_of(tenant)
        if s is None:
            raise RuntimeError(
                f"{self.name}: tenant {tenant!r} is not resident in this "
                f"bank (residents: {sorted(self.residents)})")
        return s

    def active_for(self, tenant: str = "A") -> ProgrammedLinear:
        """The tenant's resident plane (the read path)."""
        s = self._resident_slot(tenant)
        if s.plane is None:
            raise RuntimeError(
                f"{self.name}: tenant {tenant!r} plane unprogrammed")
        return s.plane

    def fingerprint_for(self, tenant: str = "A") -> str:
        s = self._resident_slot(tenant)
        if s.fp is None:
            raise RuntimeError(
                f"{self.name}: tenant {tenant!r} plane unprogrammed")
        return s.fp

    def _first(self, role: str) -> Optional[PlaneSlot]:
        for s in self.slots:
            if s.role == role:
                return s
        return None

    @property
    def n_free(self) -> int:
        return sum(1 for s in self.slots if s.role == ROLE_FREE)

    @property
    def staging(self) -> Optional[PlaneSlot]:
        return self._first(ROLE_STAGING)

    # -- lifecycle: free -> staging -> resident -> free ----------------------

    def assign(self, tenant: str, pw: ProgrammedLinear, fp: str) -> None:
        """Program ``pw`` as the named tenant's resident plane: rewrite
        the tenant's own slot if resident, else claim a free slot in
        deep-net layout."""
        s = self.slot_of(tenant) or self._first(ROLE_FREE)
        if s is None:
            raise RuntimeError(
                f"{self.name}: bank is full — {self.n_planes} planes hold "
                f"{sorted(self.residents)}"
                + (" plus a staging slot" if self.staging else "")
                + f"; cannot deploy {tenant!r}")
        s.plane, s.fp = pw, fp
        s.role, s.tenant = ROLE_RESIDENT, tenant

    def assign_fused(self, tenant: str, pw: ProgrammedLinear,
                     fp: str) -> None:
        """Program ``pw`` as the tenant's expansion-fused plane pair: the
        resident slot carries the tiles and a second free slot becomes
        its fused companion (both RE high, never a write target)."""
        s = self.slot_of(tenant)
        if s is not None:
            if not self.is_fused(tenant):
                raise RuntimeError(
                    f"{self.name}: tenant {tenant!r} is resident in "
                    f"deep-net layout; a mode change reprograms physical "
                    f"planes")
            s.plane, s.fp = pw, fp
            return
        free = [sl for sl in self.slots if sl.role == ROLE_FREE]
        if len(free) < 2:
            raise RuntimeError(
                f"{self.name}: an expansion-fused weight needs TWO free "
                f"planes, found {len(free)} of {self.n_planes}")
        prim, comp = free[0], free[1]
        prim.plane, prim.fp = pw, fp
        prim.role, prim.tenant = ROLE_RESIDENT, tenant
        comp.role, comp.tenant = ROLE_FUSED, tenant

    def reserve_staging(self) -> PlaneSlot:
        """Mark a free slot as the write target of an in-flight swap (RE
        low: column-isolated while chunks program)."""
        if self.staging is not None:
            raise RuntimeError(f"{self.name}: a staging slot is already "
                               f"reserved (swap in flight)")
        s = self._first(ROLE_FREE)
        if s is None:
            raise RuntimeError(
                f"{self.name}: no free plane to stage into — "
                f"{self.n_planes} planes hold {sorted(self.residents)}")
        s.role = ROLE_STAGING
        return s

    def land_staged(self, tenant: str, pw: ProgrammedLinear,
                    fp: str) -> None:
        """Promote a write-verified plane onto the staging slot and
        retarget the tenant's read-enable to it (the RE flip); the
        tenant's previous slot — if any — reverts to free, and its plane
        tensors are released."""
        s = self.staging
        if s is None:
            raise RuntimeError(f"{self.name}: no staging slot reserved")
        old = self.slot_of(tenant)
        s.plane, s.fp = pw, fp
        s.role, s.tenant = ROLE_RESIDENT, tenant
        if old is not None:
            old.plane, old.fp = None, None
            old.role, old.tenant = ROLE_FREE, None

    def release_staging(self) -> None:
        """Abort: the reserved staging slot reverts to free (written
        chunks were buffered in the SwapPlan, never on the bank)."""
        s = self.staging
        if s is not None:
            s.plane, s.fp = None, None
            s.role, s.tenant = ROLE_FREE, None

    def evict(self, tenant: str) -> None:
        """Evict a resident tenant; its slot — and, for an
        expansion-fused pair, the companion plane — reverts to free."""
        s = self._resident_slot(tenant)
        comp = self.fused_companion(tenant)
        s.plane, s.fp = None, None
        s.role, s.tenant = ROLE_FREE, None
        if comp is not None:
            comp.plane, comp.fp = None, None
            comp.role, comp.tenant = ROLE_FREE, None

    # -- geometry ------------------------------------------------------------

    @property
    def any_plane(self) -> ProgrammedLinear:
        """Any programmed plane — the shape/tile-geometry reference."""
        for s in self.slots:
            if s.plane is not None:
                return s.plane
        raise RuntimeError(f"{self.name}: no plane programmed")

    @property
    def n_devices(self) -> int:
        """Memristors holding ONE plane's weights."""
        return self.any_plane.n_devices

    @property
    def n_devices_physical(self) -> int:
        """Total memristors in the stack: all ``n_planes`` planes."""
        return self.n_planes * self.any_plane.n_devices


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` with float32 values seen as their bit patterns, so equality
    is the byte equality a digest of the tensor sees."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_tiles(a: ProgrammedLinear, b: ProgrammedLinear) -> bool:
    """True exactly when ``fingerprint_tiles`` of the two agree (digest
    collisions aside), compared where the tiles live."""
    if (a.k, a.n, tuple(a.pos.shape)) != (b.k, b.n, tuple(b.pos.shape)):
        return False
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(_bits(x), _bits(y))
               for x, y in ((a.pos, b.pos), (a.neg, b.neg),
                            (a.w_scale, b.w_scale)))


class ChunkedProgram:
    """Incremental programming of one (K, N) weight onto a shadow plane.

    One chunk = one row tile (``cfg.tile_rows`` wordlines) quantized and
    written across all cell-bit slices — one ``t_write`` pulse in the
    device-time model (slices and column tiles program in parallel;
    row tiles share the write driver and serialize).  The per-chunk
    arithmetic repeats ``engine.program``'s, so ``finish()`` returns a
    bitwise-identical ``ProgrammedLinear``.

    Until its first chunk a program holds only the incoming weight (a
    view of the swap's params tree).  The first chunk takes the weight's
    digest (:attr:`fp`), its scales (from the unpadded matrix, as
    ``engine.program``) and the (S, T, R, n_pad) int8 planes every chunk
    writes its row tile into; rows past K are zero cells.
    """

    def __init__(self, name: str, w2d: torch.Tensor, cfg: EngineConfig):
        self.name, self.cfg = name, cfg
        self.k, self.n = w2d.shape
        self._w2d = w2d
        self.t = -(-self.k // cfg.tile_rows)
        self.n_pad = -(-self.n // cfg.tile_cols) * cfg.tile_cols
        self._fp: Optional[str] = None
        self._scale: Optional[torch.Tensor] = None
        self._pos: Optional[torch.Tensor] = None
        self._neg: Optional[torch.Tensor] = None
        self._chunks = 0

    @property
    def fp(self) -> str:
        """Digest of the source weight (``fingerprint_weight``)."""
        if self._fp is None:
            self._fp = fingerprint_weight(self._w2d)
        return self._fp

    @property
    def total_chunks(self) -> int:
        return self.t

    @property
    def chunks_done(self) -> int:
        return self._chunks

    @property
    def done(self) -> bool:
        return self.chunks_done >= self.total_chunks

    @torch.no_grad()
    def write_chunk(self) -> None:
        """Quantize and program the next row tile of the shadow plane."""
        if self.done:
            raise RuntimeError(f"{self.name}: all chunks already written")
        q = self.cfg.quant
        r = self.cfg.tile_rows
        i = self._chunks
        if i == 0:
            self.fp               # the source digest, read at promotion
            self._scale = quant.weight_scales(self._w2d, q)
            shape = (q.n_slices, self.t, r, self.n_pad)
            dev = self._w2d.device
            self._pos = torch.empty(shape, dtype=torch.int8, device=dev)
            self._neg = torch.empty(shape, dtype=torch.int8, device=dev)
        qmax = 2.0 ** q.w_bits - 1.0
        rows = self._w2d[i * r:(i + 1) * r]
        w_int = torch.clamp(
            quant.ste_round(quant.true_div(rows, self._scale)), -qmax, qmax)
        pos, neg = quant.to_slices(w_int, q, dtype=torch.int8,
                                   out_shape=(r, self.n_pad))
        self._pos[:, i] = pos
        self._neg[:, i] = neg
        self._chunks += 1

    def finish(self) -> ProgrammedLinear:
        """The fully written shadow plane (bitwise ``engine.program`` of
        the same weight)."""
        if not self.done:
            raise RuntimeError(
                f"{self.name}: {self.total_chunks - self.chunks_done} "
                f"chunks still unwritten")
        w_scale = self._scale
        if self.cfg.quant.per_channel:
            w_scale = engine._pad_to(w_scale, self.n_pad, axis=1)
        return ProgrammedLinear(self._pos, self._neg, w_scale, self.k,
                                self.n)

    @torch.no_grad()
    def verify(self, staged: ProgrammedLinear) -> None:
        """Write-verify: the chunk-assembled plane must equal an
        independent one-shot programming of the same weight (RRAM
        program-and-verify, at tile-grid scale) — the check that catches
        assembly bugs (chunk order, padding, scales) before a plane can
        be promoted into the read path.  The two programmings are
        compared on their device; the digests of both are taken only to
        name them in the failure."""
        ref = engine.program(self._w2d, self.cfg)
        if not _same_tiles(staged, ref):
            raise RuntimeError(
                f"{self.name}: write-verify failed — assembled shadow "
                f"tiles {fingerprint_tiles(staged)} != one-shot "
                f"programming {fingerprint_tiles(ref)}")


@dataclasses.dataclass
class SwapPlan:
    """Ordered chunk work-list for hot-swapping a whole params tree.

    One write port: chunks serialize across all tiles, so total device
    time is ``total_chunks * t_write`` — the quantity the overlapped
    schedule hides under the read stream.  A **staged** swap writes each
    bank's reserved staging slot and retargets the tenant's read-enable
    at promotion; the tenant keeps serving its old plane through the
    whole window.  Written-and-verified planes are buffered in
    ``staged`` and land on the banks only at promotion, so no read can
    observe a partially deployed checkpoint.  (The reference's in-place
    lifecycle, a rewrite of a non-anchor tenant's own slot, comes with
    multi-tenant serving.)
    """
    programs: List[ChunkedProgram]
    leaves: Tuple[Any, ...]        # incoming tree leaves (identity check)
    params: Any                    # the incoming tree itself
    cursor: int = 0
    chunks_done: int = 0
    tenant: str = "A"
    staged: Dict[str, Tuple[ProgrammedLinear, str]] = dataclasses.field(
        default_factory=dict)

    @property
    def total_chunks(self) -> int:
        return sum(cp.total_chunks for cp in self.programs)

    @property
    def remaining(self) -> int:
        return self.total_chunks - self.chunks_done

    @property
    def done(self) -> bool:
        return self.remaining == 0

    @property
    def expected_fingerprints(self) -> Dict[str, str]:
        return {cp.name: cp.fp for cp in self.programs}

    def write_chunk(self) -> Optional[ChunkedProgram]:
        """Advance one chunk; returns the program if this chunk finished
        its weight (the caller stages it onto the shadow plane)."""
        if self.done:
            return None
        cp = self.programs[self.cursor]
        cp.write_chunk()
        self.chunks_done += 1
        if cp.done:
            self.cursor += 1
            return cp
        return None

    def device_write_time(self) -> float:
        """Total modeled programming time [s]: one t_write per chunk."""
        return self.total_chunks * self.programs[0].cfg.params.t_write


def write_leak_codes(cfg: EngineConfig) -> float:
    """Worst-case common-mode leakage of an in-flight shadow write, in
    pre-ADC code units.

    While a shadow plane is programmed, its OFF N1 transistors leak
    ~``i_leak_0`` per cell into the shared column (paper Fig. 3c); a
    full column of ``tile_rows`` writing cells injects
    ``tile_rows * i_leak_0``.  One cell-code unit of column current is
    ``v_read`` across the conductance spacing, so the ratio is the leak
    in the accumulator units the ADC digitizes.  Differential columns
    cancel the term except through ADC quantization — the paper's
    "negligible" claim.
    """
    p = cfg.params
    base = 2 ** cfg.quant.bits_per_cell
    i_unit = p.v_read * (p.g_set - p.g_reset) / (base - 1)
    return cfg.tile_rows * p.i_leak_0 / i_unit


def write_leak_scalar(cfg: EngineConfig, device=None) -> torch.Tensor:
    """:func:`write_leak_codes` as a 0-d float32 tensor on ``device`` —
    the form a serving step reads from device memory, so a captured step
    serves 0.0 (steady state) and the leak (a swap window) from one
    graph."""
    return torch.full((), write_leak_codes(cfg), dtype=torch.float32,
                      device=device)
