"""Port parity: the IR-drop nodal model (``core/ir_drop.py``) against the
reference's.

Contract, all float32 as in the reference (x64 off), inputs made with
numpy and handed to both packages:
* ``capped_geometry`` is integer arithmetic: equal;
* the dense solves (``solve_planar``, ``solve_crossstack``) agree to
  1e-5 x max|value| for the currents and both voltage fields.  The nodal
  matrix is badly conditioned (wire 0.3125 S against devices near 1e-4
  S) and the two packages' LAPACK LU solves pivot and block differently:
  on these inputs the measured gap is at most 1.7e-6 (and at most 6.7e-6
  on a 32 x 16 array), about 3x the gap of either solve to a float64
  solve of the same float32 system;
* ``jacobi_planar`` (3000 sweeps of the port's loop against JAX's
  ``lax.scan``, at 12 x 8) agrees to 2e-5 x max|value|: measured 4.3e-6,
  the f32 roundings of 3000 sweeps in another evaluation order;
* ``mode_ir_report``: the geometry is equal, the deviations agree to
  1e-4 relative and the reduction to 1e-4 absolute.  The deviations are
  1 - i / i_ideal of currents within a few percent of ideal, so the
  solves' relative gap grows by ~1 / deviation: measured 1.6e-5 and
  1.1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax.numpy as jnp  # noqa: E402

from repro.core import ir_drop as jird  # noqa: E402
from repro.core.timing import PAPER  # noqa: E402
from repro_torch.core import ir_drop as tird  # noqa: E402

SOLVE_RTOL = 1e-5
JACOBI_RTOL = 2e-5
DEV_RTOL = 1e-4
REDUCTION_ATOL = 1e-4


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _network(seed, n, m):
    rng = np.random.default_rng(seed)
    g = rng.uniform(PAPER.g_reset, PAPER.g_set, (n, m)).astype(np.float32)
    v = rng.uniform(0.0, PAPER.v_read, (n,)).astype(np.float32)
    return g, v


@pytest.mark.parametrize("n,m", [(12, 8), (5, 9)])
def test_solve_planar_matches_the_reference(n, m):
    g, v = _network(n * m, n, m)
    want = jird.solve_planar(jnp.asarray(g), jnp.asarray(v))
    got = tird.solve_planar(torch.from_numpy(g), torch.from_numpy(v))
    for a, b in zip(got, want):
        _close(a, b, SOLVE_RTOL)
    # the metrics built on the solve
    att = tird.attenuation_map(torch.from_numpy(g), torch.from_numpy(v))
    _close(att, jird.attenuation_map(jnp.asarray(g), jnp.asarray(v)),
           SOLVE_RTOL)


def test_solve_crossstack_matches_the_reference():
    g, v = _network(3, 12, 8)
    parts = (g[:6], g[6:], v[:6], v[6:])
    want = jird.solve_crossstack(*map(jnp.asarray, parts))
    got = tird.solve_crossstack(*map(torch.from_numpy, parts))
    assert got[1].shape == (2, 6, 8)
    for a, b in zip(got, want):
        _close(a, b, SOLVE_RTOL)


def test_jacobi_planar_matches_the_reference_scan():
    g = np.full((12, 8), PAPER.g_set, np.float32)
    v = np.full((12,), PAPER.v_write, np.float32)
    want = jird.jacobi_planar(jnp.asarray(g), jnp.asarray(v), n_iter=3000)
    got = tird.jacobi_planar(torch.from_numpy(g), torch.from_numpy(v),
                             n_iter=3000)
    for a, b in zip(got, want):
        _close(a, b, JACOBI_RTOL)
    # and the iteration converges on the exact nodal solution
    i_d, _, _ = tird.solve_planar(torch.from_numpy(g), torch.from_numpy(v))
    assert float(((got[0] - i_d).abs() / i_d).max()) < 2e-3


def test_capped_geometry_matches_the_reference():
    for r in (1, 2, 3, 5, 10, 16, 33, 128, 512):
        for m in (1, 2, 7, 10, 64, 128, 300):
            for cap in (64, 1024):
                assert (tird.capped_geometry(r, m, cap)
                        == jird.capped_geometry(r, m, cap)), (r, m, cap)


@pytest.mark.parametrize("r,m", [(5, 4), (10, 10), (128, 128)])
def test_mode_ir_report_matches_the_reference(r, m):
    want = jird.mode_ir_report(r, m)
    got = tird.mode_ir_report(r, m, device="cpu")
    assert (got["tile_rows"], got["tile_cols"]) == (
        want["tile_rows"], want["tile_cols"])
    for key in ("dev_deepnet", "dev_expansion"):
        assert got[key] == pytest.approx(want[key], rel=DEV_RTOL), key
    assert abs(got["ir_drop_reduction"]
               - want["ir_drop_reduction"]) <= REDUCTION_ATOL
    # expansion's shorter shared column wins
    assert got["dev_expansion"] < got["dev_deepnet"]


def test_mode_ir_report_runs_on_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tird.mode_ir_report(5, 4)
