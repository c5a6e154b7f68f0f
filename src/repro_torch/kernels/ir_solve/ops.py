"""IR-drop solve through the Jacobi kernel: the drop-in for
``core/ir_drop.jacobi_planar`` (the port of
``repro/kernels/ir_solve/ops.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ir_drop import _series
from repro_torch.core.timing import PAPER
from repro_torch.kernels.ir_solve.kernel import jacobi_sweeps


def solve(g_dev, v_in, r_wire: float = PAPER.r_wire,
          r_access: Optional[float] = None, n_iter: int = 2000,
          sweeps_per_call: int = 16, omega: float = 1.0):
    """Damped-Jacobi solve of the planar network on ``g_dev``'s device,
    ``sweeps_per_call`` sweeps per kernel call (``n_iter //
    sweeps_per_call`` calls, at least one).  Returns (i_out, v_row,
    v_col)."""
    if r_access is None:
        r_access = PAPER.r_on_transistor
    n, m = g_dev.shape
    g = _series(g_dev.to(torch.float32), r_access).contiguous()
    g_w = 1.0 / r_wire
    vin_col = v_in.to(torch.float32).reshape(n, 1).contiguous()
    v_row = vin_col.expand(n, m).contiguous()
    v_col = torch.zeros((n, m), dtype=torch.float32, device=g.device)
    for _ in range(max(1, n_iter // sweeps_per_call)):
        v_row, v_col = jacobi_sweeps(g, vin_col, v_row, v_col,
                                     g_w=float(g_w), omega=omega,
                                     sweeps=sweeps_per_call)
    i_out = g_w * v_col[n - 1, :]
    return i_out, v_row, v_col
