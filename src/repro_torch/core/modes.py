"""Array-level semantics of the two CrossStack operating modes (paper §III).

The counterpart of ``repro.core.modes``.  The read-enable (RE) signal
per cell decides where device current flows:

* RE high -> N1 on, N2 off: device couples to the shared column (read).
* RE low  -> N1 off, N2 on: device path to ground (write), isolated from
  the column except for N1 subthreshold leakage.

Expansion mode: both planes RE-high -> one logical crossbar with 2n rows
on an n-node shared column (Eq. 1 with doubled n).

Deep-net mode: complementary RE -> the read plane produces the MAC while
the write plane is programmed with the *next* layer's weights; its only
coupling into the read-out is the leakage term.

``read_top`` (a 0-d bool tensor) and ``read_idx`` (a 0-d int32 tensor)
stay on the planes' device: every selection is a ``torch.where`` or an
``index_select``, never a host read.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import crossbar, ir_drop
from repro_torch.core.crossbar import PlaneConfig
from repro_torch.core.timing import PAPER, CrossStackParams

Index = Union[torch.Tensor, int]


class StackState(NamedTuple):
    """A stacked pair of conductance planes plus which one is
    read-active: the N = 2 case of :class:`BankState`."""
    g_top: torch.Tensor      # (r, m)
    g_bot: torch.Tensor      # (r, m)
    read_top: torch.Tensor   # 0-d bool — deep-net ping-pong selector


class BankState(NamedTuple):
    """An N-high stack of conductance planes plus the read-active index:
    one plane serves reads while any of the other N-1 planes may be
    programmed."""
    g: torch.Tensor          # (N, r, m) conductance planes
    read_idx: torch.Tensor   # 0-d int32 — which plane is read-active


@dataclasses.dataclass(frozen=True)
class StackConfig:
    rows_per_plane: int
    n_cols: int
    params: CrossStackParams = PAPER

    @property
    def plane(self) -> PlaneConfig:
        return PlaneConfig(self.rows_per_plane, self.n_cols, self.params)


def _write_drive(cfg: StackConfig, v_write_other: Optional[torch.Tensor],
                 device) -> torch.Tensor:
    if v_write_other is not None:
        return v_write_other
    return torch.full((cfg.rows_per_plane,), cfg.params.v_write,
                      dtype=torch.float32, device=device)


def _take(g: torch.Tensor, idx: Index) -> torch.Tensor:
    """Plane ``idx`` of ``g`` (N, r, m); a tensor index stays on the
    device."""
    if torch.is_tensor(idx):
        return torch.index_select(g, 0, idx.reshape(1)).squeeze(0)
    return g[idx]


# -- expansion mode -----------------------------------------------------------

def expansion_mac(state: StackState, v_top: torch.Tensor,
                  v_bot: torch.Tensor, cfg: StackConfig) -> torch.Tensor:
    """i = [v_top; v_bot]^T [G_top; G_bot] — Eq. 1 with n doubled.

    Both planes' RE are identical (high): currents from above and below
    the shared electrode sum by KCL.
    """
    return (crossbar.mac(v_top, state.g_top, cfg.plane)
            + crossbar.mac(v_bot, state.g_bot, cfg.plane))


def expansion_mac_ir(state: StackState, v_top: torch.Tensor,
                     v_bot: torch.Tensor, cfg: StackConfig) -> torch.Tensor:
    """Expansion-mode MAC through the exact shared-column nodal solve."""
    i_out, _, _ = ir_drop.solve_crossstack(
        state.g_top, state.g_bot, v_top, v_bot, cfg.params.r_wire)
    return i_out


def expansion_program(state: StackState, g_top_new: torch.Tensor,
                      g_bot_new: torch.Tensor) -> StackState:
    """RE low on both planes: column isolated, both planes written."""
    return StackState(g_top_new, g_bot_new, state.read_top)


# -- deep-net mode -------------------------------------------------------------

def deepnet_read(state: StackState, v_in: torch.Tensor, cfg: StackConfig,
                 v_write_other: Optional[torch.Tensor] = None,
                 include_leakage: bool = True) -> torch.Tensor:
    """Read the active plane while the other is being programmed.

    The write plane contributes only N1 subthreshold leakage into the
    shared column (paper Fig. 3c: ~2.5 pA/cell, negligible vs the read
    current).
    """
    g_read = torch.where(state.read_top, state.g_top, state.g_bot)
    i = crossbar.mac(v_in, g_read, cfg.plane)
    if include_leakage:
        v_w = _write_drive(cfg, v_write_other, g_read.device)
        i = i + crossbar.write_plane_leakage(v_w, cfg.plane)
    return i


def deepnet_write_inactive(state: StackState, g_new: torch.Tensor
                           ) -> StackState:
    """Program the *inactive* plane with the next layer's weights."""
    g_top = torch.where(state.read_top, state.g_top, g_new)
    g_bot = torch.where(state.read_top, g_new, state.g_bot)
    return StackState(g_top, g_bot, state.read_top)


def deepnet_swap(state: StackState) -> StackState:
    """Flip roles once the concurrent read and write both complete."""
    return StackState(state.g_top, state.g_bot,
                      torch.logical_not(state.read_top))


def deepnet_layer(state: StackState, v_in: torch.Tensor,
                  g_next: torch.Tensor, cfg: StackConfig
                  ) -> Tuple[torch.Tensor, StackState]:
    """One full deep-net pipeline beat: read the active plane, write the
    next layer's weights into the inactive plane, swap.  Returns
    (currents, new state)."""
    i = deepnet_read(state, v_in, cfg)
    state = deepnet_write_inactive(state, g_next)
    return i, deepnet_swap(state)


# -- N-plane banks (DeviceConfig.stack_planes > 2) ----------------------------

def bank_from_pair(state: StackState) -> BankState:
    """Lift a 2-plane StackState into the bank representation (plane 0 =
    top, plane 1 = bottom; read_idx 0 <=> read_top)."""
    g = torch.stack([state.g_top, state.g_bot], dim=0)
    idx = torch.logical_not(state.read_top).to(torch.int32)
    return BankState(g, idx)


def bank_write_idx(state: BankState) -> torch.Tensor:
    """The ring's next write target: the plane after the read-active one
    (for N = 2 exactly the classic inactive/shadow plane)."""
    return (state.read_idx + 1) % state.g.shape[0]


def bank_read(state: BankState, v_in: torch.Tensor, cfg: StackConfig,
              n_writing: int = 1,
              v_write_other: Optional[torch.Tensor] = None,
              include_leakage: bool = True) -> torch.Tensor:
    """Read the active plane of an N-high bank while ``n_writing`` other
    planes are being programmed.

    Each concurrently writing plane contributes one N1 subthreshold
    leakage term into the shared column; planes that are merely resident
    contribute nothing.  ``bank_read(bank_from_pair(s), ...)`` is
    bit-exact with :func:`deepnet_read` on ``s``.
    """
    g_read = _take(state.g, state.read_idx)
    i = crossbar.mac(v_in, g_read, cfg.plane)
    if include_leakage and n_writing > 0:
        v_w = _write_drive(cfg, v_write_other, g_read.device)
        i = i + n_writing * crossbar.write_plane_leakage(v_w, cfg.plane)
    return i


def bank_write_plane(state: BankState, idx: Index, g_new: torch.Tensor
                     ) -> BankState:
    """Program plane ``idx`` of the bank (RE low on that plane only).
    ``idx`` may be a device tensor; writing the read-active plane is the
    caller's bug — the executor refuses it, the array-scale op does not
    police it."""
    n = state.g.shape[0]
    mask = (torch.arange(n, device=state.g.device) == idx)[:, None, None]
    return BankState(torch.where(mask, g_new[None], state.g),
                     state.read_idx)


def bank_set_read(state: BankState, idx: Index) -> BankState:
    """Point the read-enable at plane ``idx`` (the generalized RE flip:
    promotion retargets the read to whichever plane was just staged)."""
    return BankState(state.g, torch.as_tensor(idx, dtype=torch.int32,
                                              device=state.g.device))


def bank_advance(state: BankState) -> BankState:
    """Rotate the ring one position (N = 2: exactly ``deepnet_swap``)."""
    return bank_set_read(state, bank_write_idx(state))


def bank_fused_pair(state: BankState, idx_top: Index = 0,
                    idx_bot: Index = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two planes of an expansion-fused pair inside an N-high bank.

    Expansion mode fuses exactly two planes (they share one middle
    electrode); in a taller bank the other N-2 planes stay independent.
    Returns the (g_top, g_bot) conductance pair; indices may be device
    tensors.
    """
    return _take(state.g, idx_top), _take(state.g, idx_bot)


def bank_expansion_mac(state: BankState, v_top: torch.Tensor,
                       v_bot: torch.Tensor, cfg: StackConfig,
                       idx_top: Index = 0, idx_bot: Index = 1
                       ) -> torch.Tensor:
    """Expansion-mode MAC on a fused plane pair of an N-high bank:
    :func:`expansion_mac` lifted to the bank geometry, bit-exact with it
    at N = 2.  No leakage term applies: a fused pair never hosts an
    in-flight write."""
    g_top, g_bot = bank_fused_pair(state, idx_top, idx_bot)
    return (crossbar.mac(v_top, g_top, cfg.plane)
            + crossbar.mac(v_bot, g_bot, cfg.plane))


def bank_expansion_mac_ir(state: BankState, v_top: torch.Tensor,
                          v_bot: torch.Tensor, cfg: StackConfig,
                          idx_top: Index = 0, idx_bot: Index = 1
                          ) -> torch.Tensor:
    """Fused-pair MAC through the exact shared-column nodal solve."""
    g_top, g_bot = bank_fused_pair(state, idx_top, idx_bot)
    i_out, _, _ = ir_drop.solve_crossstack(
        g_top, g_bot, v_top, v_bot, cfg.params.r_wire)
    return i_out


def bank_layer(state: BankState, v_in: torch.Tensor, g_next: torch.Tensor,
               cfg: StackConfig) -> Tuple[torch.Tensor, BankState]:
    """One deep-net beat on an N-high bank: read the active plane, write
    the next-layer weights into the ring's next plane, advance."""
    i = bank_read(state, v_in, cfg)
    state = bank_write_plane(state, bank_write_idx(state), g_next)
    return i, bank_advance(state)
