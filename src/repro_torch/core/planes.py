"""Plane banks: the executor's residency registry (PyTorch).

The counterpart of ``repro.core.planes`` for this slice of the port: a
:class:`PlaneBank` is an ordered bank of ``stack_planes`` role-tagged
plane slots per named weight.  Each slot is ``free`` or ``resident`` for
a named tenant (``fused`` for the companion plane of an
expansion-programmed weight).  Staging slots, chunked programming
(``ChunkedProgram``), swap plans (``SwapPlan``) and the write-leak
helpers belong to the hot-swap slice and are not ported yet.

The fingerprints are byte-for-byte those of the reference: the same
shapes and bytes go into the same blake2b digest, so a weight and its
programmed tiles carry the same identity in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.engine import ProgrammedLinear


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


#: slot lifecycle roles, plus the fused companion of an expansion slot
ROLE_FREE = "free"
ROLE_RESIDENT = "resident"
ROLE_FUSED = "fused"


@dataclasses.dataclass
class PlaneSlot:
    """One physical plane of a bank plus its role: a ``resident`` slot
    carries a programmed plane and its fingerprint; a ``free`` slot is
    dark silicon."""
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

    def is_fused(self, tenant: str) -> bool:
        """True when the tenant's weight is expansion-programmed across a
        fused plane pair (read mode "expansion")."""
        return any(s.role == ROLE_FUSED and s.tenant == tenant
                   for s in self.slots)

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

    # -- assignment ------------------------------------------------------------

    def assign(self, tenant: str, pw: ProgrammedLinear, fp: str) -> None:
        """Program ``pw`` as the named tenant's resident plane: rewrite
        the tenant's own slot if resident, else claim a free slot in
        deep-net layout."""
        s = self.slot_of(tenant) or next(
            (sl for sl in self.slots if sl.role == ROLE_FREE), None)
        if s is None:
            raise RuntimeError(
                f"{self.name}: bank is full — {self.n_planes} planes hold "
                f"{sorted(self.residents)}; cannot deploy {tenant!r}")
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
