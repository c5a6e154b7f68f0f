"""Resistive-network (IR-drop) model of crossbar read-out (PyTorch).

The counterpart of ``repro.core.ir_drop``: full nodal analysis of the
row/column wire ladder network,

* ``solve_planar``      — conventional 2-D n x m crossbar,
* ``solve_crossstack``  — two stacked planes (r x m each) sharing the middle
                          column electrode (expansion mode, paper Fig. 1a/e),

plus the damped-Jacobi stencil solve (``jacobi_planar``, the oracle of
``kernels/ir_solve``) and the per-mode scoring the executor's ``"auto"``
policy reads (``capped_geometry``, ``mode_ir_report``).

Geometry and conventions
------------------------
Row wires are driven by ideal sources at the j = 0 end and have resistance
``r_wire`` per cell segment.  Column wires run along the row index and are
sensed by an ideal transimpedance stage (virtual ground) past the last row
node.  Every device sits between its row node and its column node, in series
with the access transistor ON resistance.

Everything is float32, as in the reference (which runs with x64 off).  The
dense solves go to ``torch.linalg.solve``, as the reference's go to
``jnp.linalg.solve`` outside any kernel.  The nodal matrix is badly
conditioned (wire conductance 1/r_wire ~ 0.3 S against device conductances
~1e-4 S), so two float32 LU solves of the same system differ well above
the unit roundoff: docs/PORT.md states the measured gap to the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.timing import PAPER
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ir_solve.ref import jacobi_sweep_ref


def _series(g_dev: torch.Tensor, r_access: float) -> torch.Tensor:
    """Device conductance in series with the access transistor."""
    return torch.reciprocal(
        torch.reciprocal(torch.clamp(g_dev, min=1e-12)) + r_access)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Dense direct solve
# ---------------------------------------------------------------------------

def _add(a: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
         vals: torch.Tensor) -> None:
    a.index_put_((rows, cols), vals, accumulate=True)


def _stamp_branch(a, i0, i1, g) -> None:
    """Stamp conductances ``g`` between node sets ``i0`` and ``i1``."""
    _add(a, i0, i0, g)
    _add(a, i1, i1, g)
    _add(a, i0, i1, -g)
    _add(a, i1, i0, -g)


def _grid(n: int, m: int, device):
    ii, jj = torch.meshgrid(torch.arange(n, device=device),
                            torch.arange(m, device=device), indexing="ij")
    return ii.reshape(-1), jj.reshape(-1)


def _assemble_planar(g: torch.Tensor, v_in: torch.Tensor, g_w):
    """Build the (2nm x 2nm) nodal matrix for a planar crossbar.

    Unknown ordering: row nodes (n*m) then column nodes (n*m), row-major.
    ``g_w`` is a 0-d float32 tensor.
    """
    n, m = g.shape
    nn = n * m
    dev = g.device
    size = 2 * nn
    a = torch.zeros((size, size), dtype=torch.float32, device=dev)
    b = torch.zeros((size,), dtype=torch.float32, device=dev)
    ii, jj = _grid(n, m, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def ridx(i, j):
        return i * m + j

    def cidx(i, j):
        return nn + i * m + j

    # device branches: row node <-> column node
    _stamp_branch(a, ridx(ii, jj), cidx(ii, jj), g.reshape(-1))

    # row wire segments: (i, j) <-> (i, j+1), plus source at j = 0
    r0 = ridx(ii, jj)
    r1 = ridx(ii, torch.clamp(jj + 1, max=m - 1))
    _stamp_branch(a, r0, r1, torch.where(jj < m - 1, g_w, zero))

    # source: node (i, 0) tied to V_in[i] through one wire segment
    src = jj == 0
    _add(a, r0, r0, torch.where(src, g_w, zero))
    b.index_put_((r0,), torch.where(src, g_w * v_in[ii], zero),
                 accumulate=True)

    # column wire segments: (i, j) <-> (i+1, j), sense ground past i = n-1
    c0 = cidx(ii, jj)
    c1 = cidx(torch.clamp(ii + 1, max=n - 1), jj)
    _stamp_branch(a, c0, c1, torch.where(ii < n - 1, g_w, zero))
    _add(a, c0, c0, torch.where(ii == n - 1, g_w, zero))  # tied to 0 V
    return a, b


def solve_planar(g_dev: torch.Tensor, v_in: torch.Tensor,
                 r_wire: float = PAPER.r_wire,
                 r_access: Optional[float] = None):
    """Exact nodal solve of an n x m planar crossbar, on ``g_dev``'s
    device.

    Returns (i_out, v_row, v_col): per-column sense currents (m,) and the
    node voltage fields (n, m).
    """
    if r_access is None:
        r_access = PAPER.r_on_transistor
    dev = g_dev.device
    n, m = g_dev.shape
    g = _series(g_dev.to(torch.float32), r_access)
    # the reference traces r_wire as a float32 operand: 1 / r_wire is a
    # float32 divide
    g_w = torch.reciprocal(_f32(r_wire, dev))
    a, b = _assemble_planar(g, v_in.to(torch.float32), g_w)
    v = torch.linalg.solve(a, b)
    v_row = v[: n * m].reshape(n, m)
    v_col = v[n * m:].reshape(n, m)
    i_out = g_w * v_col[n - 1, :]  # current into the virtual ground
    return i_out, v_row, v_col


def solve_crossstack(g_top: torch.Tensor, g_bot: torch.Tensor,
                     v_in_top: torch.Tensor, v_in_bot: torch.Tensor,
                     r_wire: float = PAPER.r_wire,
                     r_access: Optional[float] = None):
    """Exact nodal solve of a CrossStack pair (expansion mode).

    Two r x m planes share the column nodes: device (p, i, j) connects row
    node (p, i, j) to shared column node (i, j).  Unknowns: 2*r*m row nodes
    (top then bottom) + r*m column nodes.

    Returns (i_out, v_rows, v_col) with v_rows shaped (2, r, m).
    """
    if r_access is None:
        r_access = PAPER.r_on_transistor
    dev = g_top.device
    r, m = g_top.shape
    g_w = torch.reciprocal(_f32(r_wire, dev))
    nn = r * m
    size = 3 * nn
    a = torch.zeros((size, size), dtype=torch.float32, device=dev)
    b = torch.zeros((size,), dtype=torch.float32, device=dev)
    ii, jj = _grid(r, m, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def ridx(p, i, j):
        return p * nn + i * m + j

    def cidx(i, j):
        return 2 * nn + i * m + j

    for p, (gp, vp) in enumerate(((g_top, v_in_top), (g_bot, v_in_bot))):
        gp = _series(gp.to(torch.float32), r_access)
        vp = vp.to(torch.float32)
        r0 = ridx(p, ii, jj)
        _stamp_branch(a, r0, cidx(ii, jj), gp.reshape(-1))
        r1 = ridx(p, ii, torch.clamp(jj + 1, max=m - 1))
        _stamp_branch(a, r0, r1, torch.where(jj < m - 1, g_w, zero))
        src = jj == 0
        _add(a, r0, r0, torch.where(src, g_w, zero))
        b.index_put_((r0,), torch.where(src, g_w * vp[ii], zero),
                     accumulate=True)

    c0 = cidx(ii, jj)
    c1 = cidx(torch.clamp(ii + 1, max=r - 1), jj)
    _stamp_branch(a, c0, c1, torch.where(ii < r - 1, g_w, zero))
    _add(a, c0, c0, torch.where(ii == r - 1, g_w, zero))

    v = torch.linalg.solve(a, b)
    v_rows = v[: 2 * nn].reshape(2, r, m)
    v_col = v[2 * nn:].reshape(r, m)
    i_out = g_w * v_col[r - 1, :]
    return i_out, v_rows, v_col


# ---------------------------------------------------------------------------
# Iterative (Jacobi) solve for large arrays — stencil form
# ---------------------------------------------------------------------------

def jacobi_planar(g_dev: torch.Tensor, v_in: torch.Tensor,
                  r_wire: float = PAPER.r_wire,
                  r_access: Optional[float] = None,
                  n_iter: int = 2000, omega: float = 1.0):
    """Damped-Jacobi solve of the same planar network, O(n*m) per sweep.

    The sweep is ``kernels/ir_solve/ref.py:jacobi_sweep_ref``, the plain
    version of the CUDA Jacobi kernel; ``kernels/ir_solve/ops.solve`` is
    the drop-in that runs the sweeps through that kernel.
    """
    if r_access is None:
        r_access = PAPER.r_on_transistor
    n, m = g_dev.shape
    g = _series(g_dev.to(torch.float32), r_access)
    g_w = 1.0 / r_wire
    v_in = v_in.to(torch.float32)
    v_row = v_in[:, None].expand(n, m).clone()
    v_col = torch.zeros((n, m), dtype=torch.float32, device=g.device)
    for _ in range(n_iter):
        v_row, v_col = jacobi_sweep_ref(v_row, v_col, g, v_in, g_w, omega)
    i_out = g_w * v_col[n - 1, :]
    return i_out, v_row, v_col


# ---------------------------------------------------------------------------
# Mode scoring (per-layer expansion vs deep-net IR deviation)
# ---------------------------------------------------------------------------

def capped_geometry(r: int, m: int, max_nodes: int = 1024
                    ) -> tuple[int, int]:
    """Shrink a tile geometry until the dense nodal solves stay tractable.

    The expansion solve has ``3*r*m`` unknowns and the planar comparison
    ``4*r*m`` (2r rows).  The aspect ratio is preserved and both axes keep
    at least 2 nodes, so the *relative* expansion-vs-planar deviation —
    the quantity the policy ranks on — is scored on a faithful proxy of
    the tile.  Geometries already under the cap are returned unchanged.
    """
    while 3 * r * m > max_nodes and (r > 2 or m > 2):
        if r >= m and r > 2:
            r = -(-r // 2)
        else:
            m = -(-m // 2)
    return r, m


def mode_ir_report(r: int, m: int, r_wire: float = PAPER.r_wire,
                   params=PAPER, max_nodes: int = 1024,
                   device: DeviceLike = None) -> dict:
    """Worst-case IR deviation of one conversion group, per read mode.

    One expansion-mode conversion sums ``2r`` inputs split across the two
    stacked planes of an ``r x m`` tile (shared column passes r nodes);
    the deep-net layout of the *same* doubled-input read is a planar
    ``2r x m`` array whose column passes all 2r nodes.  Both are solved
    exactly on ``device`` (the card unless ``"cpu"`` is asked for) at the
    worst-case operating point (every cell SET, every row driven at
    V_read) and scored by the mean per-column relative current loss.

    Returns ``dev_deepnet``, ``dev_expansion`` (fractional losses),
    ``ir_drop_reduction`` (1 - expansion/deepnet), and the (possibly
    capped) geometry that was scored.
    """
    dev = resolve_device(device)
    r_s, m_s = capped_geometry(int(r), int(m), max_nodes)
    g_half = torch.full((r_s, m_s), params.g_set, device=dev)
    g_full = torch.full((2 * r_s, m_s), params.g_set, device=dev)
    v_half = torch.full((r_s,), params.v_read, device=dev)
    v_full = torch.full((2 * r_s,), params.v_read, device=dev)
    i_ideal = ideal_currents(
        _series(g_full, params.r_on_transistor), v_full)
    i_pl, _, _ = solve_planar(g_full, v_full, r_wire)
    i_cs, _, _ = solve_crossstack(g_half, g_half, v_half, v_half, r_wire)
    dev_pl = float(ir_drop_loss(i_pl, i_ideal).mean())
    dev_cs = float(ir_drop_loss(i_cs, i_ideal).mean())
    return {
        "tile_rows": r_s,
        "tile_cols": m_s,
        "dev_deepnet": dev_pl,
        "dev_expansion": dev_cs,
        "ir_drop_reduction": 1.0 - dev_cs / dev_pl if dev_pl else 0.0,
    }


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def ideal_currents(g_dev: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
    """Zero-wire-resistance column currents: i = v^T G (Eq. 1)."""
    return v_in @ g_dev


def ir_drop_loss(i_actual: torch.Tensor, i_ideal: torch.Tensor
                 ) -> torch.Tensor:
    """Per-column relative current loss due to line resistance."""
    return 1.0 - i_actual / i_ideal


def attenuation_map(g_dev: torch.Tensor, v_in: torch.Tensor,
                    r_wire: float = PAPER.r_wire) -> torch.Tensor:
    """First-order per-column attenuation: i_actual ~ attenuation *
    i_ideal for operating points near the calibration inputs."""
    i_act, _, _ = solve_planar(g_dev, v_in, r_wire)
    return i_act / ideal_currents(g_dev, v_in)
