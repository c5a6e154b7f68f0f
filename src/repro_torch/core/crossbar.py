"""Single-plane crossbar array model (analog MAC, Eq. 1 of the paper).

The counterpart of ``repro.core.crossbar``.  A plane is an
(n_rows, n_cols) conductance array.  ``mac`` is the ideal i = V^T G
read-out; the noisy / non-ideal variants layer in device variability
(Table I tolerances), access-transistor series resistance, deep-net-mode
leakage from the co-located write plane, and a first-order IR-drop
attenuation calibrated from the exact nodal solver.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import device as memristor
from repro_torch.core import ir_drop
from repro_torch.core.quant import true_div
from repro_torch.core.timing import PAPER, CrossStackParams


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    n_rows: int
    n_cols: int
    params: CrossStackParams = PAPER
    include_access_r: bool = True


def effective_conductance(g: torch.Tensor, cfg: PlaneConfig
                          ) -> torch.Tensor:
    if not cfg.include_access_r:
        return g
    return torch.reciprocal(
        torch.reciprocal(torch.clamp(g, min=1e-12))
        + cfg.params.r_on_transistor)


def mac(v_in: torch.Tensor, g: torch.Tensor, cfg: PlaneConfig
        ) -> torch.Tensor:
    """Ideal analog MAC: per-column currents i = v^T g_eff (KCL)."""
    return v_in @ effective_conductance(g, cfg)


def mac_noisy(generator: torch.Generator, v_in: torch.Tensor,
              g: torch.Tensor, cfg: PlaneConfig,
              rel_sigma: Optional[float] = None) -> torch.Tensor:
    """MAC with multiplicative conductance variability drawn from
    ``generator`` (on ``g``'s device).

    Default sigma interpolates the Table-I corners: 7 % near G_set,
    10 % near G_reset.
    """
    p = cfg.params
    if rel_sigma is None:
        frac = true_div(g - p.g_reset, p.g_set - p.g_reset)
        rel_sigma = p.r_reset_tol + (p.r_set_tol - p.r_reset_tol) * frac
    noise = 1.0 + rel_sigma * memristor._normal(generator, g.shape,
                                                g.device)
    return v_in @ effective_conductance(g * noise, cfg)


def write_plane_leakage(v_write_rows: torch.Tensor, cfg: PlaneConfig
                        ) -> torch.Tensor:
    """Column current leaked by a plane that is being *programmed* while
    the other plane reads (deep-net mode, paper Fig. 3c).

    Per cell, the OFF N1 transistor leaks ~2.5 pA at the worst-case bias;
    leakage scales with the write drive on each row and accumulates down
    each column (paper: 25 pA for a 10-cell column = 6.3e-2 % of the
    worst-case read current).
    """
    i_cell = memristor.transistor_leakage(
        v_write_rows, torch.zeros_like(v_write_rows), cfg.params)
    return torch.sum(i_cell).reshape(1).expand(cfg.n_cols)


def mac_with_ir(v_in: torch.Tensor, g: torch.Tensor, cfg: PlaneConfig,
                exact: bool = False) -> torch.Tensor:
    """MAC including line-resistance losses.

    exact=True: full nodal solve (small planes).  exact=False:
    first-order per-column attenuation map from the solver at the nominal
    operating point — itself a dense nodal solve of the whole plane, so
    small planes only, as in the reference.
    """
    if exact:
        i_out, _, _ = ir_drop.solve_planar(g, v_in, cfg.params.r_wire)
        return i_out
    v_nom = torch.full((cfg.n_rows,), cfg.params.v_read,
                       dtype=torch.float32, device=g.device)
    atten = ir_drop.attenuation_map(g, v_nom, cfg.params.r_wire)
    return (v_in @ effective_conductance(g, cfg)) * atten


def worst_case_power(cfg: PlaneConfig) -> float:
    """All cells SET, full read drive — compare against Table I
    P_critical."""
    p = cfg.params
    i_cell = p.v_read / (p.r_set + p.r_on_transistor)
    return float(i_cell * p.v_read * cfg.n_rows * cfg.n_cols)
