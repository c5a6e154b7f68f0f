"""Port parity: the device physics and the two array modes (quant's
conductance map and ADC, ``core/device.py``, ``crossbar.py``,
``modes.py``, ``pipeline.py``, ``engine.matmul_analog``) and the port's
quickstart, against the reference package on the CPU.

Contract (docs/PORT.md, "Device physics and the two array modes"):
* bitwise: cell-code conductance maps, the ADC, the cell conductance,
  the worst-case power, the static memristor I/V and its drift, the
  conductance samples (the reference's own normal draws injected), the
  plane selections and writes of every mode op, the schedules, and
  ``deepnet_mlp``'s MAC input codes (each layer's ints and scales);
* ulp-scale: every ``v @ G`` product (float32 in another order), 4 ulp;
  the leakage, whose ``exp`` and ``10 **`` are XLA's polynomials against
  torch's, 8 ulp (6 measured, in 1.5 % of 12,288 draws);
* the dense nodal solves, 1e-5 x max abs (as ``test_torch_ir_drop.py``);
* the Euler trajectories (``program``, ``program_verify``,
  ``hysteresis_loop``): XLA contracts ``w + dw * dt`` and the resistance
  into fused multiply-adds inside its fused loop, torch rounds every
  product, so the states part by an ulp or two per step: the bounds are
  in the tests, each a few times the gap measured;
* ``deepnet_mlp`` at qwen3-4b's SMOKE widths: 1e-5 x max|y|;
* ``matmul_analog``: 1e-6 x max|y|, except outputs that an ADC code on
  either side of a rounding midpoint moves (the currents' einsums sum in
  another order): at most ``FLIP_SHARE`` of the outputs, each by at most
  two codes of the heaviest (pulse, slice) weight; against the digital
  twin, ``ANALOG_TWIN_REL``.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import crossbar as jcb  # noqa: E402
from repro.core import device as jdev  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import modes as jmodes  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core.timing import PAPER  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import crossbar as tcb  # noqa: E402
from repro_torch.core import device as tdev  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import modes as tmodes  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAC_ULPS = 4           # v @ G: float32 sums in another order
LEAK_ULPS = 8          # exp and 10 ** x: XLA's against torch's
SOLVE_RTOL = 1e-5      # x max abs: the dense nodal solves
STATE_ATOL = 2.0 ** -20   # program / program_verify / hysteresis w
TRACE_RTOL = 2.0 ** -18   # program_verify's conductance trace
LOOP_RTOL = 2.0 ** -18    # hysteresis current, x max |i|
ANALOG_RTOL = 1e-6     # matmul_analog away from ADC midpoints
FLIP_SHARE = 0.02      # outputs an ADC midpoint may move
#: matmul_analog(noise=False) against engine.matmul on the same planes,
#: max |diff| / max |twin| at 128 rows per ADC; chip_smoke holds the card
#: to it at qwen3-4b's wq (measured 0.154-0.173 at K 256-1024 here)
ANALOG_TWIN_REL = 0.25


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return float(np.max(np.abs(got.astype(np.float64) - want) / scale))


def _equal(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), np.abs(
        got.astype(np.float64) - want).max()


def _within(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture
def draws(monkeypatch):
    """Replace the port's normal draws with the arrays the test queues
    here, in order (the reference's ``jax.random.normal`` on its split
    keys)."""
    queue = []

    def normal(generator, shape, device):
        z = queue.pop(0)
        assert tuple(z.shape) == tuple(shape)
        return _t(z).to(device)

    monkeypatch.setattr(tdev, "_normal", normal)
    return queue


def _split_normals(key, shape, n=2):
    return [np.asarray(jax.random.normal(k, shape))
            for k in jax.random.split(key, n)]


# -- quant ------------------------------------------------------------------

@pytest.mark.parametrize("bpc", [1, 2])
def test_slices_to_conductance_and_adc_bitwise(bpc):
    rng = np.random.default_rng(bpc)
    jcfg = jq.QuantConfig(w_bits=4, adc_bits=6, bits_per_cell=bpc)
    tcfg = tq.QuantConfig(w_bits=4, adc_bits=6, bits_per_cell=bpc)
    codes = rng.integers(0, 2 ** bpc, (jcfg.n_slices, 16, 12)).astype(np.int8)
    _equal(tq.slices_to_conductance(_t(codes), tcfg, PAPER.g_reset,
                                    PAPER.g_set),
           jq.slices_to_conductance(jnp.asarray(codes), jcfg,
                                    PAPER.g_reset, PAPER.g_set))
    i_fs = 16 * PAPER.v_read * PAPER.g_set
    # below zero, on and beside half-level points, past full scale
    levels = 2.0 ** 6 - 1.0
    half = (np.arange(64) + 0.5) / levels * i_fs
    i = np.concatenate([rng.uniform(-0.1, 1.2, 200) * i_fs, half,
                        np.nextafter(half, 0), [0.0, i_fs]]
                       ).astype(np.float32)
    _equal(tq.adc(_t(i), tcfg, i_fs), jq.adc(jnp.asarray(i), jcfg, i_fs))


# -- device -----------------------------------------------------------------

def test_cell_conductance_leakage_and_power():
    rng = np.random.default_rng(3)
    g = np.concatenate([rng.uniform(1e-5, 1e-4, 40), [0.0, 1e-13, 1e-12]]
                       ).astype(np.float32)
    for access in (True, False):
        jcfg = jcb.PlaneConfig(8, 6, include_access_r=access)
        tcfg = tcb.PlaneConfig(8, 6, include_access_r=access)
        _equal(tcb.effective_conductance(_t(g), tcfg),
               jcb.effective_conductance(jnp.asarray(g), jcfg))
        assert tcb.worst_case_power(tcfg) == jcb.worst_case_power(jcfg)
    # element 0: the paper's worst case (C3), V_ds = V_write, gate low
    v_ds = rng.uniform(-0.3, 1.5, 64).astype(np.float32)
    v_gs = rng.uniform(-0.2, 0.9, 64).astype(np.float32)
    v_ds[0], v_gs[0] = PAPER.v_write, 0.0
    got = tdev.transistor_leakage(_t(v_ds), _t(v_gs))
    want = jdev.transistor_leakage(jnp.asarray(v_ds), jnp.asarray(v_gs))
    assert _ulps(got, want) <= LEAK_ULPS
    _equal(got[0], np.asarray(want)[0])
    assert float(got[0]) == pytest.approx(2.5e-12, rel=0.05)
    jcfg, tcfg = jcb.PlaneConfig(64, 6), tcb.PlaneConfig(64, 6)
    for v in (np.full(64, PAPER.v_write, np.float32), v_ds):
        got = tcb.write_plane_leakage(_t(v), tcfg)
        assert got.shape == (6,)
        assert _ulps(got, jcb.write_plane_leakage(jnp.asarray(v), jcfg)) \
            <= LEAK_ULPS


@pytest.mark.parametrize("path", [
    "mac", "noisy_table", "noisy_sigma", "ir_exact", "ir_first_order"])
def test_plane_macs(path, draws):
    rng = np.random.default_rng(11)
    g = rng.uniform(PAPER.g_reset, PAPER.g_set, (8, 6)).astype(np.float32)
    v = rng.uniform(0.0, PAPER.v_read, 8).astype(np.float32)
    jcfg, tcfg = jcb.PlaneConfig(8, 6), tcb.PlaneConfig(8, 6)
    jv, jg, tv, tg = jnp.asarray(v), jnp.asarray(g), _t(v), _t(g)
    if path == "mac":
        got, want = tcb.mac(tv, tg, tcfg), jcb.mac(jv, jg, jcfg)
    elif path.startswith("noisy"):
        sigma = None if path == "noisy_table" else 0.05
        key = jax.random.PRNGKey(5)
        draws.append(np.asarray(jax.random.normal(key, g.shape)))
        got = tcb.mac_noisy(torch.Generator(), tv, tg, tcfg, sigma)
        want = jcb.mac_noisy(key, jv, jg, jcfg, sigma)
        assert not draws
    else:
        exact = path == "ir_exact"
        got = tcb.mac_with_ir(tv, tg, tcfg, exact=exact)
        want = jcb.mac_with_ir(jv, jg, jcfg, exact=exact)
        _within(got, want, SOLVE_RTOL)
        return
    assert _ulps(got, want) <= MAC_ULPS


def test_sample_conductances_with_the_reference_draws(draws):
    rng = np.random.default_rng(2)
    bits = (rng.uniform(size=(8, 6)) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(1)
    draws.extend(_split_normals(key, bits.shape))
    _equal(tdev.sample_conductances(torch.Generator(), _t(bits)),
           jdev.sample_conductances(key, jnp.asarray(bits)))
    assert not draws


def test_memristor_static_and_drift_bitwise():
    rng = np.random.default_rng(4)
    w = np.concatenate([rng.uniform(0, 1, 60), [0.0, 1.0, 0.5]]
                       ).astype(np.float32)
    v = np.concatenate([rng.uniform(-1.2, 1.2, 60), [0.0, 1.2, -1.2]]
                       ).astype(np.float32)
    jm, tm = jdev.MemristorModel(), tdev.MemristorModel()
    assert tm.k_drift == jm.k_drift
    tw, tv, jw, jv = _t(w), _t(v), jnp.asarray(w), jnp.asarray(v)
    _equal(tm.resistance(tw), jm.resistance(jw))
    _equal(tm.conductance(tw), jm.conductance(jw))
    _equal(tm.current(tv, tw), jm.current(jv, jw))
    _equal(tm.dw_dt(tv, tw), jm.dw_dt(jv, jw))
    # a thresholded, steeper-windowed device
    jm3 = jdev.MemristorModel(p_window=3, v_th_pos=0.3, v_th_neg=0.4)
    tm3 = tdev.MemristorModel(p_window=3, v_th_pos=0.3, v_th_neg=0.4)
    _equal(tm3.dw_dt(tv, tw), jm3.dw_dt(jv, jw))
    with pytest.raises(TypeError, match="tensor"):
        tm.program(0.5, PAPER.v_write)


def test_program_and_program_verify():
    rng = np.random.default_rng(6)
    w0 = rng.uniform(0, 1, (7, 5)).astype(np.float32)
    g_t = rng.uniform(PAPER.g_reset, PAPER.g_set, (7, 5)).astype(np.float32)
    jm, tm = jdev.MemristorModel(), tdev.MemristorModel()
    for v in (PAPER.v_write, -PAPER.v_write):
        _within(tm.program(_t(w0), v), jm.program(jnp.asarray(w0), v),
                STATE_ATOL)
    # the paper's write: 250 ns at V_write switches the device
    assert float(tm.program(torch.tensor(0.02), PAPER.v_write)) > 0.7
    assert float(tm.program(torch.tensor(0.98), -PAPER.v_write)) < 0.3
    w_t, g_tr = tm.program_verify(_t(w0), _t(g_t), n_pulses=48, n_steps=16)
    w_j, g_j = jm.program_verify(jnp.asarray(w0), jnp.asarray(g_t),
                                 n_pulses=48, n_steps=16)
    assert g_tr.shape == (48, 7, 5)
    assert np.abs(w_t.numpy() - np.asarray(w_j)).max() <= STATE_ATOL
    assert np.max(np.abs(g_tr.numpy() - np.asarray(g_j))
                  / np.asarray(g_j)) <= TRACE_RTOL
    # the reference test's convergence: 30 kOhm within 25 %
    w, _ = tm.program_verify(torch.tensor(0.1), torch.tensor(1.0 / 30e3),
                             n_pulses=48, n_steps=16)
    assert 1.0 / float(tm.conductance(w)) == pytest.approx(30e3, rel=0.25)


def test_hysteresis_loop_1024_samples_a_cycle():
    v_j, i_j, w_j = (np.asarray(a) for a in jdev.hysteresis_loop(
        n_cycles=2, samples_per_cycle=1024))
    v_t, i_t, w_t = (a.numpy() for a in tdev.hysteresis_loop(
        n_cycles=2, samples_per_cycle=1024, device="cpu"))
    assert v_t.shape == i_t.shape == w_t.shape == (2048,)
    assert np.abs(v_t - v_j).max() <= STATE_ATOL      # torch.sin vs XLA's
    assert np.abs(w_t - w_j).max() <= STATE_ATOL
    assert np.abs(i_t - i_j).max() <= LOOP_RTOL * np.abs(i_j).max()
    # the port's own loop is pinched with a nonzero area (paper Fig. 3a)
    near0 = np.abs(v_t) < 0.01
    assert np.abs(i_t[near0]).max() < 0.05 * np.abs(i_t).max()
    assert abs(np.trapezoid(i_t[1024:], v_t[1024:])) > 0.0


# -- modes ------------------------------------------------------------------

#: the reference's mode ops, jitted once each (eager JAX compiles every
#: primitive apart, seconds per new shape); jitting adds no arithmetic to
#: the selections, writes and products compared here
J = {name: jax.jit(getattr(jmodes, name), static_argnames=statics)
     for name, statics in (
         ("expansion_mac", ("cfg",)), ("expansion_mac_ir", ("cfg",)),
         ("deepnet_read", ("cfg", "include_leakage")),
         ("deepnet_layer", ("cfg",)), ("bank_read", (
             "cfg", "n_writing", "include_leakage")),
         ("bank_layer", ("cfg",)), ("bank_expansion_mac", ("cfg",)))}


def _planes(seed, n, r=8, m=6):
    rng = np.random.default_rng(seed)
    g = rng.uniform(1e-5, 1e-4, (n, r, m)).astype(np.float32)
    v = rng.uniform(0.0, PAPER.v_read, (2, r)).astype(np.float32)
    return jnp.asarray(g), (jnp.asarray(v[0]), jnp.asarray(v[1]))


def _mac_eq(got, want):
    assert _ulps(got, want) <= MAC_ULPS


def _state_eq(got, want):
    """A port state against a reference one: every field bitwise, the
    selectors 0-d tensors of the reference's dtype."""
    for name in want._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert torch.is_tensor(g) and g.dtype in (torch.float32,
                                                  torch.bool, torch.int32)
        _equal(g, w)


@pytest.mark.parametrize("read_top", [True, False])
def test_stack_state_ops(read_top):
    cfg, tcfg = jmodes.StackConfig(8, 6), tmodes.StackConfig(8, 6)
    g, (v_top, v_bot) = _planes(0, 3)
    pair = jmodes.StackState(g[0], g[1], jnp.bool_(read_top))
    tpair = bridge.mode_state_from_numpy(jax.device_get(pair), "cpu")
    _state_eq(tpair, pair)
    tv_top, tv_bot = _t(v_top), _t(v_bot)
    _mac_eq(tmodes.expansion_mac(tpair, tv_top, tv_bot, tcfg),
            J["expansion_mac"](pair, v_top, v_bot, cfg))
    _within(tmodes.expansion_mac_ir(tpair, tv_top, tv_bot, tcfg),
            J["expansion_mac_ir"](pair, v_top, v_bot, cfg), SOLVE_RTOL)
    _state_eq(tmodes.expansion_program(tpair, _t(g[2]), _t(g[0])),
              jmodes.expansion_program(pair, g[2], g[0]))
    v_w = jnp.linspace(0.2, 1.2, 8)
    for kw in ({}, {"include_leakage": False},
               {"v_write_other": v_w}):
        tkw = {k: (_t(x) if k == "v_write_other" else x)
               for k, x in kw.items()}
        _mac_eq(tmodes.deepnet_read(tpair, tv_top, tcfg, **tkw),
                J["deepnet_read"](pair, v_top, cfg=cfg, **kw))
    _state_eq(tmodes.deepnet_write_inactive(tpair, _t(g[2])),
              jmodes.deepnet_write_inactive(pair, g[2]))
    _state_eq(tmodes.deepnet_swap(tpair), jmodes.deepnet_swap(pair))
    i_t, s_t = tmodes.deepnet_layer(tpair, tv_top, _t(g[2]), tcfg)
    i_j, s_j = J["deepnet_layer"](pair, v_top, g[2], cfg)
    _mac_eq(i_t, i_j)
    _state_eq(s_t, s_j)
    _state_eq(tmodes.bank_from_pair(tpair), jmodes.bank_from_pair(pair))


@pytest.mark.parametrize("n", [2, 3])
def test_bank_ops(n):
    cfg, tcfg = jmodes.StackConfig(8, 6), tmodes.StackConfig(8, 6)
    g, (v_top, v_bot) = _planes(7 + n, n + 1)
    bank = jmodes.BankState(g[:n], jnp.int32(n - 1))
    tbank = bridge.mode_state_from_numpy(jax.device_get(bank), "cpu")
    _state_eq(tbank, bank)
    tv_top, tv_bot, g_new = _t(v_top), _t(v_bot), g[n]
    _equal(tmodes.bank_write_idx(tbank), jmodes.bank_write_idx(bank))
    for n_writing in (0, 1, 2):
        _mac_eq(tmodes.bank_read(tbank, tv_top, tcfg, n_writing=n_writing),
                J["bank_read"](bank, v_top, cfg=cfg, n_writing=n_writing))
    _mac_eq(tmodes.bank_read(tbank, tv_top, tcfg, include_leakage=False),
            J["bank_read"](bank, v_top, cfg=cfg, include_leakage=False))
    for idx in range(n):
        for t_idx in (idx, torch.tensor(idx, dtype=torch.int32)):
            _state_eq(tmodes.bank_write_plane(tbank, t_idx, _t(g_new)),
                      jmodes.bank_write_plane(bank, idx, g_new))
            _state_eq(tmodes.bank_set_read(tbank, t_idx),
                      jmodes.bank_set_read(bank, idx))
    _state_eq(tmodes.bank_advance(tbank), jmodes.bank_advance(bank))
    for it, ib in ((n - 1, 0), (0, n - 1)):
        for cast in (int, lambda i: torch.tensor(i, dtype=torch.int32)):
            for a, b in zip(tmodes.bank_fused_pair(tbank, cast(it),
                                                   cast(ib)),
                            jmodes.bank_fused_pair(bank, it, ib)):
                _equal(a, b)
            _mac_eq(tmodes.bank_expansion_mac(tbank, tv_top, tv_bot, tcfg,
                                              cast(it), cast(ib)),
                    J["bank_expansion_mac"](bank, v_top, v_bot, cfg,
                                            jnp.int32(it), jnp.int32(ib)))
        # the fused pair's nodal solve is the pair's (held against the
        # reference in test_stack_state_ops) on exactly those planes
        pair = tmodes.StackState(tbank.g[it], tbank.g[ib],
                                 torch.tensor(True))
        _equal(tmodes.bank_expansion_mac_ir(tbank, tv_top, tv_bot, tcfg,
                                            it, ib),
               tmodes.expansion_mac_ir(pair, tv_top, tv_bot, tcfg).numpy())
    i_t, b_t = tmodes.bank_layer(tbank, tv_top, _t(g_new), tcfg)
    i_j, b_j = J["bank_layer"](bank, v_top, g_new, cfg)
    _mac_eq(i_t, i_j)
    _state_eq(b_t, b_j)
    if n == 2:
        # the bank ops at N = 2 are the pair ops bit for bit
        pair = tmodes.StackState(tbank.g[0], tbank.g[1],
                                 tbank.read_idx == 0)
        _equal(tmodes.bank_read(tbank, tv_top, tcfg),
               tmodes.deepnet_read(pair, tv_top, tcfg).numpy())
        _equal(tmodes.bank_expansion_mac(tbank, tv_top, tv_bot, tcfg),
               tmodes.expansion_mac(pair, tv_top, tv_bot, tcfg).numpy())


# -- pipeline ---------------------------------------------------------------

def test_schedules_speedup_and_latency_report_equal():
    for n_layers in (1, 2, 3, 7, 32):
        for bits in (1, 4, 10, 16, 100):
            for build in ("serial_schedule", "deepnet_schedule"):
                t = getattr(tpipe, build)(n_layers, bits)
                j = getattr(jpipe, build)(n_layers, bits)
                assert [tuple(p) for p in t.phases] == [
                    tuple(p) for p in j.phases]
                assert t.total == j.total
                t.validate()
            assert tpipe.speedup(n_layers, bits) == jpipe.speedup(
                n_layers, bits)
            assert tpipe.latency_report(n_layers, bits) == \
                jpipe.latency_report(n_layers, bits)
    assert tpipe.speedup(200, 10) == jpipe.speedup(200, 10)
    assert tpipe.speedup(200, 10) == pytest.approx(0.29, abs=0.01)  # C2
    bad = tpipe.Schedule([tpipe.Phase(0, "write", 0.0, 1.0, 0),
                          tpipe.Phase(0, "read", 0.5, 1.5, 0)], 1.5)
    with pytest.raises(AssertionError, match="read before its write"):
        bad.validate()


SMOKE_MLP = (64, 256, 64, 256, 64)   # qwen3-4b SMOKE: d_model, d_ff


@pytest.fixture(scope="module")
def mlp_case():
    """The reference's ``deepnet_mlp`` at qwen3-4b's SMOKE widths, B 4,
    deep-net mode (128 rows per ADC), jitted once, and each layer's input
    as its ``engine.matmul`` received it."""
    rng = np.random.default_rng(9)
    ws = [(rng.standard_normal((a, b)) * 0.1).astype(np.float32)
          for a, b in zip(SMOKE_MLP[:-1], SMOKE_MLP[1:])]
    x = rng.standard_normal((4, SMOKE_MLP[0])).astype(np.float32)
    cfg = jeng.EngineConfig(mode="deepnet")
    inputs, matmul = [], jeng.matmul

    def recorded(h, pw, c):
        jax.debug.callback(lambda a: inputs.append(np.asarray(a)), h)
        return matmul(h, pw, c)

    jeng.matmul = recorded
    try:
        y = np.asarray(jax.jit(lambda x, ws: jpipe.deepnet_mlp(x, ws, cfg))(
            jnp.asarray(x), [jnp.asarray(w) for w in ws]))
    finally:
        jeng.matmul = matmul
    assert len(inputs) == len(ws)
    return cfg, ws, x, inputs, y


def test_deepnet_mlp_smoke_widths(mlp_case):
    """Through the MAC wrapper (``use_kernel=True``), the path the card
    runs: on CPU tensors the wrapper runs the MAC's plain version."""
    jcfg, ws, x, inputs, want = mlp_case
    cfg = teng.EngineConfig(mode="deepnet", use_kernel=True)
    got = tpipe.deepnet_mlp(_t(x), [_t(w) for w in ws], cfg)
    _within(got, want, 1e-5)
    # the MAC's input codes, layer by layer, against the eager reference
    # (under jit XLA turns a division by a constant into a product, which
    # moves a scale by an ulp): the ints and scales of the reference's
    # layer inputs; the cell planes are engine.program's, bitwise in
    # test_torch_crossbar_mac.py
    for h in inputs:
        for a, b in zip(tq.quantize_inputs(_t(h), cfg.quant),
                        jq.quantize_inputs(jnp.asarray(h), jcfg.quant)):
            _equal(a, b)
    with pytest.raises(AssertionError, match="deep-net"):
        tpipe.deepnet_mlp(_t(x), [_t(ws[0])], teng.EngineConfig())


def test_deepnet_mlp_refuses_expansion_mode_as_the_reference():
    """Outside deep-net mode both packages refuse with the same
    ``AssertionError`` and message."""
    x = np.zeros((2, 8), np.float32)
    w = np.zeros((8, 4), np.float32)
    with pytest.raises(AssertionError) as want:
        jpipe.deepnet_mlp(jnp.asarray(x), [jnp.asarray(w)],
                          jeng.EngineConfig(mode="expansion"))
    with pytest.raises(AssertionError) as got:
        tpipe.deepnet_mlp(_t(x), [_t(w)],
                          teng.EngineConfig(mode="expansion"))
    assert str(got.value) == str(want.value)


# -- engine.matmul_analog -----------------------------------------------------

#: the reference's matmul_analog, jitted once per configuration (eager, it
#: compiles each of its primitives apart); under jit XLA multiplies by
#: the reciprocal of the ADC's LSB where the eager reference divides,
#: one more ulp on either side of an ADC midpoint (``_analog_close``)
J_ANALOG = jax.jit(jeng.matmul_analog,
                   static_argnames=("cfg", "noise", "ir_comp"))


def _analog_close(got, want, x, pw, cfg):
    """``got`` within ANALOG_RTOL x max|want|, except at most FLIP_SHARE
    of the outputs, each within two ADC codes at the heaviest weight."""
    code = teng._analog_code_value(_t(x), pw, cfg).numpy()
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    moved = diff > ANALOG_RTOL * np.abs(want).max()
    assert moved.mean() <= FLIP_SHARE, moved.mean()
    assert np.all(diff[moved] <= 2 * code[moved])


@pytest.mark.parametrize("mode,bpc,noise,ir_comp", [
    ("deepnet", 2, False, False), ("expansion", 1, True, True)])
def test_matmul_analog(mode, bpc, noise, ir_comp, draws):
    rng = np.random.default_rng(bpc + 2 * noise + 4 * ir_comp)
    qk = dict(w_bits=4, in_bits=8, adc_bits=8, bits_per_cell=bpc)
    geo = dict(tile_rows=8, tile_cols=8, mode=mode)
    jcfg = jeng.EngineConfig(quant=jq.QuantConfig(**qk), **geo)
    tcfg = teng.EngineConfig(quant=tq.QuantConfig(**qk), **geo)
    w = (rng.standard_normal((32, 20)) * 0.3).astype(np.float32)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    # one set of planes for both (engine.program's, bitwise to the
    # reference's in test_torch_crossbar_mac.py)
    tpw = teng.program(_t(w), tcfg)
    jpw = jeng.ProgrammedLinear(*(jnp.asarray(getattr(tpw, f).numpy())
                                  for f in ("pos", "neg", "w_scale")),
                                tpw.k, tpw.n)
    key = jax.random.PRNGKey(5) if noise else None
    if noise:
        draws.extend(_split_normals(key, jpw.pos.shape))
    want = J_ANALOG(key, jnp.asarray(x), jpw, cfg=jcfg, noise=noise,
                    ir_comp=ir_comp)
    got = teng.matmul_analog(torch.Generator() if noise else None, _t(x),
                             tpw, tcfg, noise=noise, ir_comp=ir_comp)
    assert not draws
    _analog_close(got, want, x, tpw, tcfg)


def test_matmul_analog_against_the_digital_twin():
    rng = np.random.default_rng(12)
    cfg = teng.EngineConfig(mode="deepnet")
    w = _t((rng.standard_normal((512, 256)) * 0.02).astype(np.float32))
    x = _t(rng.standard_normal((8, 512)).astype(np.float32))
    pw = teng.program(w, cfg)
    twin = teng.matmul(x, pw, cfg)
    analog = teng.matmul_analog(None, x, pw, cfg, noise=False)
    rel = float((analog - twin).abs().max() / twin.abs().max())
    assert rel <= ANALOG_TWIN_REL, rel
    with pytest.raises(ValueError, match="generator"):
        teng.matmul_analog(None, x, pw, cfg)


# -- the quickstart ---------------------------------------------------------

def test_quickstart_body_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    out = qs.main("cpu")
    assert out["device"] == "cpu"
    for mode in ("expansion", "deepnet"):
        errs = [out["reads"][(mode, b)] for b in (8, 4, 2)]
        assert errs[0] < 0.02 and errs[0] < errs[1] < errs[2] < 1.0, errs
    assert out["executor_rel_err"] < 0.1
    assert out["speedups"][10] == pytest.approx(0.29, abs=0.01)
    assert out["latency_report"] == jpipe.latency_report(100, 10)
