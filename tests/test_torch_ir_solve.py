"""Port parity: the IR-drop Jacobi kernel's plain version and its CPU
path against the reference's.

Contract: the port's ``jacobi_sweep_ref`` and the CPU path of
``jacobi_sweeps`` agree with JAX's ``jacobi_sweep_ref`` and with JAX's
Pallas ``jacobi_sweeps`` (interpret mode) to rtol 1e-5 / atol 1e-7 — the
reference test's own bound, for float32 sweeps evaluated in another
order.  ``ops.solve`` is the same sweep as ``ir_drop.jacobi_planar``
(bitwise on the CPU) and converges to the dense nodal solve within
2e-3.  The CUDA kernel is held against the plain version on the card
(test_torch_cuda_kernels.py); its launch plan, ``band_plan``, is pure
Python and is held here to the card's limits: every row in one band, at
most 132 bands, 232,448 bytes of shared memory a band, a cooperative
launch exactly when the plan has more than one band.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax.numpy as jnp  # noqa: E402

from repro.core.timing import PAPER  # noqa: E402
from repro.kernels.ir_solve import kernel as jkernel  # noqa: E402
from repro.kernels.ir_solve import ref as jref  # noqa: E402
from repro_torch.core import ir_drop as tird  # noqa: E402
from repro_torch.kernels.ir_solve import kernel as tkernel  # noqa: E402
from repro_torch.kernels.ir_solve import ops as tops  # noqa: E402
from repro_torch.kernels.ir_solve import ref as tref  # noqa: E402

G_W = 1.0 / PAPER.r_wire


def _state(n, m, seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform(PAPER.g_reset, PAPER.g_set, (n, m)).astype(np.float32)
    v_in = np.full((n,), PAPER.v_read, np.float32)
    vr = np.broadcast_to(v_in[:, None], (n, m)).astype(np.float32)
    vc = rng.uniform(0.0, 0.01, (n, m)).astype(np.float32)
    return g, v_in, vr, vc


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("sweeps", [1, 4])
def test_sweeps_match_the_reference_kernel(sweeps):
    g, v_in, vr, vc = _state(8, 8, sweeps)
    jr, jc = jkernel.jacobi_sweeps(
        jnp.asarray(g), jnp.asarray(v_in[:, None]), jnp.asarray(vr),
        jnp.asarray(vc), g_w=float(G_W), sweeps=sweeps, interpret=True)
    rr, rc = jnp.asarray(vr), jnp.asarray(vc)
    pr, pc = torch.from_numpy(vr), torch.from_numpy(vc)
    tg, tv = torch.from_numpy(g), torch.from_numpy(v_in)
    for _ in range(sweeps):
        rr, rc = jref.jacobi_sweep_ref(rr, rc, jnp.asarray(g),
                                       jnp.asarray(v_in), G_W, 1.0)
        pr, pc = tref.jacobi_sweep_ref(pr, pc, tg, tv, G_W, 1.0)
    _close(pr, rr)
    _close(pc, rc)
    before = dict(tkernel.LAUNCHES)
    kr, kc = tkernel.jacobi_sweeps(tg, tv[:, None], torch.from_numpy(vr),
                                   torch.from_numpy(vc), g_w=G_W,
                                   sweeps=sweeps)
    assert tkernel.LAUNCHES == before      # the CPU path launches nothing
    _close(kr, jr)
    _close(kc, jc)


def test_solve_is_jacobi_planar_and_converges():
    g = torch.full((12, 8), PAPER.g_set)
    v = torch.full((12,), PAPER.v_write)
    got = tops.solve(g, v, n_iter=96, sweeps_per_call=16)
    want = tird.jacobi_planar(g, v, n_iter=96)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    i_k, _, _ = tops.solve(g, v, n_iter=3000)
    i_d, _, _ = tird.solve_planar(g, v)
    assert float(((i_k - i_d).abs() / i_d).max()) < 2e-3


PLAN_SHAPES = [(2, 2), (2, 3), (3, 2), (10, 10), (12, 8), (37, 53),
               (64, 64), (128, 128), (130, 128), (3, 700), (700, 3),
               (255, 257), (256, 256), (511, 512), (512, 512), (2, 4000),
               (2, 8000), (17, 8000), (1000, 1000)]


def _bands(n, plan):
    # band b holds rows [b n // P, (b + 1) n // P) (csrc/ir_solve.cu)
    return [(b * n // plan.bands, (b + 1) * n // plan.bands)
            for b in range(plan.bands)]


@pytest.mark.parametrize("n,m", PLAN_SHAPES)
def test_band_plan_fits_the_card(n, m):
    plan = tkernel.band_plan(n, m)
    rows = [i for lo, hi in _bands(n, plan) for i in range(lo, hi)]
    assert rows == list(range(n))                  # each row in one band
    assert max(hi - lo for lo, hi in _bands(n, plan)) == plan.rows
    assert 1 <= plan.bands <= 132
    assert plan.smem_bytes <= 232_448
    assert plan.smem_bytes == tkernel.band_smem_bytes(plan.rows, m)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.per_thread in (1, 2, 4, 8)
    assert plan.threads * plan.per_thread >= plan.rows * m
    assert plan.cooperative == (plan.bands > 1)


@pytest.mark.parametrize("n,m", [(2, 20_000), (2, 8193), (16, 16_000),
                                 (4000, 4000), (1500, 1400)])
def test_band_plan_past_capacity_raises(n, m):
    with pytest.raises(ValueError, match="132 co-resident bands"):
        tkernel.band_plan(n, m)


def test_band_plan_picks_the_bands_by_size():
    assert tkernel.band_plan(10, 10).bands == 1
    assert not tkernel.band_plan(12, 8).cooperative   # ops.solve's shape
    assert tkernel.band_plan(64, 64).bands == 16
    assert tkernel.band_plan(128, 128) == tkernel.BandPlan(
        64, 2, 256, 1, 4 * (2 * 130 + 4 * 128))
    assert tkernel.band_plan(256, 256).bands == 128
    assert tkernel.band_plan(512, 512).bands == 128
    with pytest.raises(ValueError):
        tkernel.band_plan(1, 8)
