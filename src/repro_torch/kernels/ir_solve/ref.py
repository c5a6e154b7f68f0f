"""Plain PyTorch version of the IR-drop stencil kernel (the port of
``repro/kernels/ir_solve/ref.py``): one damped-Jacobi sweep of the planar
crossbar ladder network (``core/ir_drop.jacobi_planar`` is this update
run ``n_iter`` times)."""
from __future__ import annotations

import torch

#: calls of the plain version (a solve on the card makes none)
CALLS = {"jacobi_sweep_ref": 0}


def jacobi_sweep_ref(v_row, v_col, g, v_in, g_w: float, omega: float):
    """One sweep. v_row/v_col/g: (n, m) float32; v_in: (n,).  Returns
    the updated (v_row, v_col).

    Row nodes see their west neighbour (the source at j = 0), their east
    neighbour (none past the last column) and their device; column nodes
    see their north neighbour (none at i = 0), their south neighbour (the
    sense ground past the last row) and their device, through the row
    voltage of THIS sweep."""
    CALLS["jacobi_sweep_ref"] += 1
    n, m = g.shape
    f32 = dict(dtype=torch.float32, device=g.device)
    zcol = torch.zeros((n, 1), **f32)
    zrow = torch.zeros((1, m), **f32)
    west = torch.cat([v_in[:, None], v_row[:, :-1]], dim=1)
    east_g = torch.cat([torch.full((n, m - 1), g_w, **f32), zcol], dim=1)
    east_v = torch.cat([v_row[:, 1:], zcol], dim=1)
    num_r = g_w * west + east_g * east_v + g * v_col
    den_r = g_w + east_g + g
    v_row_new = v_row + omega * (num_r / den_r - v_row)

    north_g = torch.cat([zrow, torch.full((n - 1, m), g_w, **f32)], dim=0)
    north_v = torch.cat([zrow, v_col[:-1, :]], dim=0)
    south_v = torch.cat([v_col[1:, :], zrow], dim=0)
    num_c = north_g * north_v + g_w * south_v + g * v_row_new
    den_c = north_g + g_w + g
    v_col_new = v_col + omega * (num_c / den_c - v_col)
    return v_row_new, v_col_new
