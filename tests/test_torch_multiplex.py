"""Port parity: multi-tenant plane multiplexing and QoS against the
reference's, mirroring tests/test_multiplex.py.

Contract (docs/PORT.md, "Multiplexing"):
* integers are EQUAL to the reference's: each tenant's fingerprints,
  versions, residency and stats, for 2 and 3 planes; quotas and page
  budgets (``_split_slots``, ``set_weights``, ``kv_report``,
  ``qos_report``); swap reports;
* every refusal raises the reference's exception class and message;
* float reads of each tenant equal a dedicated port executor's BITWISE
  and the reference's within 1e-6 x max abs output (``engine.matmul``'s
  bound);
* greedy streams are EQUAL: the multiplexed scheduler against the
  reference's and against two dedicated port schedulers; an in-place
  swap of B under A's traffic (A's streams those of no swap, B paused
  and resumed, the swap's step, window and report the reference's);
  a live deploy of B into a free plane.
* a lane's window step follows its tenant's plane generation: its graph
  is dropped at an in-place promote, at an eviction made on the executor
  beside the scheduler (after which the lane raises) and at a redeploy;
  ``set_weights`` builds nothing;
* a step with an evicted tenant's lane raises before any lane runs, and
  the lane pauses while the scheduler deploys the tenant back.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.device import DeviceConfig as JaxDevice  # noqa: E402
from repro.core.executor import CrossbarExecutor as JaxExecutor  # noqa: E402
from repro.core.quant import QuantConfig as JaxQuant  # noqa: E402
from repro.models.model import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve import engine as jserve  # noqa: E402
from repro.serve import hotswap as jhotswap  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.device import DeviceConfig  # noqa: E402
from repro_torch.core.executor import CrossbarExecutor  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.model import ModelConfig, build_model  # noqa: E402
from repro_torch.serve import engine as tserve  # noqa: E402
from repro_torch.serve.hotswap import HotSwapper  # noqa: E402

QUANT = dict(w_bits=4, in_bits=8, adc_bits=10)
READ_TOL = 1e-6            # x max abs output: engine.matmul's bound
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=128,
            backend="crossbar")
#: (tenant, prompt length) of the served requests; B's 3-page budget
#: holds one of its requests at a time, A's 7 pages all of its own
REQUESTS = (("A", 5), ("B", 6), ("A", 9), ("B", 4), ("A", 3), ("B", 7))
MAX_NEW = 6
SCHED = dict(n_slots=3, max_len=24, kv_pages=5)
WEIGHTS = {"A": 2.0, "B": 1.0}


def _cfgs(planes=2):
    """The port's and the reference's engine configs, ``planes`` high."""
    t = teng.EngineConfig(tile_rows=32, tile_cols=32, mode="deepnet",
                          quant=QuantConfig(**QUANT),
                          device=DeviceConfig(stack_planes=planes))
    j = jeng.EngineConfig(tile_rows=32, tile_cols=32, mode="deepnet",
                          quant=JaxQuant(**QUANT),
                          device=JaxDevice(stack_planes=planes))
    return t, j


def _w(seed, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)) * 0.3).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _raises_as_reference(port_call, ref_call):
    """Both calls raise the same exception class with the same message."""
    with pytest.raises(Exception) as ref:
        ref_call()
    with pytest.raises(type(ref.value)) as got:
        port_call()
    assert str(got.value) == str(ref.value)


def _cold(w, cfg):
    ex = CrossbarExecutor(cfg)
    ex.program_params({"head": _t(w)})
    return ex


def _both(planes=2):
    cfg, jcfg = _cfgs(planes)
    return (CrossbarExecutor(cfg), _t), (JaxExecutor(jcfg), jnp.asarray)


def _program(pair, tenant, w, **kw):
    for e, a in pair:
        e.program_params({"head": a(w)}, tenant=tenant, **kw)


# -- the executor's tenant registry -------------------------------------------

@pytest.mark.parametrize("planes", [2, 3])
def test_each_tenant_reads_its_own_planes_as_the_reference(planes):
    pair = _both(planes)
    (ex, _), (jex, _) = pair
    names = ex.tenant_names
    assert names == jex.tenant_names and len(names) == planes
    ws = {t: _w(10 + i, 64, 48) for i, t in enumerate(names)}
    x = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32)
    for t in names:
        _program(pair, t, ws[t])
    assert ex.tenants == jex.tenants == list(names)
    assert ex.residency() == jex.residency()
    assert ex.stats == jex.stats
    # one stack for every tenant: one deployment's physical devices
    assert ex.n_devices_physical == jex.n_devices_physical
    for t in names:
        assert ex.fingerprints(tenant=t) == jex.fingerprints(tenant=t)
        assert ex.fingerprint(tenant=t) == jex.fingerprint(tenant=t)
        assert ex.version(t) == jex.version(t) == 1
        assert ex.plane_generation(t) == 1
        y = ex.linear(_t(x), _t(ws[t]), "head", tenant=t)
        assert torch.equal(y, _cold(ws[t], ex.cfg).linear(
            _t(x), _t(ws[t]), "head"))
        want = np.asarray(jex.linear(jnp.asarray(x), jnp.asarray(ws[t]),
                                     "head", tenant=t))
        assert np.abs(y.numpy() - want).max() <= READ_TOL * np.abs(
            want).max()
        with ex.read_tenant(t):
            assert torch.equal(ex.linear(_t(x), _t(ws[t]), "head"), y)
            assert ex.fingerprint() == jex.fingerprint(tenant=t)
    # the scope restores the anchor
    assert ex.fingerprint() == jex.fingerprint(tenant="A")
    assert ex.programmed_version == jex.programmed_version == 1


def _swap_in_flight(pair, tenant, w):
    for e, a in pair:
        e.begin_swap({"head": a(w)}, tenant=tenant)
        e.write_chunks(1)


def _setup(case, pair):
    """Bring both executors to the state of refusal ``case``; returns the
    refused call, taking (executor, array maker)."""
    w, w2 = _w(1, 64, 32), _w(2, 64, 32)
    if case == "unknown_tenant":
        _program(pair, "A", w)
        return lambda e, a: e.program_params({"head": a(w)}, tenant="C")
    if case == "unknown_read_scope":
        def call(e, a):
            with e.read_tenant("C"):
                pass
        return call
    if case == "tile_geometry":
        _program(pair, "A", w)
        return lambda e, a: e.program_params({"head": a(_w(3, 32, 32))},
                                             tenant="B")
    if case == "second_tree":
        _program(pair, "B", w)
        return lambda e, a: e.program_params({"head": a(w2)}, tenant="B")
    _program(pair, "A", w, **({"mode_policy": "expansion"}
                              if case.startswith("fused") else {}))
    if case == "fused_stack_full":
        return lambda e, a: e.program_params({"head": a(w2)}, tenant="B")
    if case == "fused_anchor_swap":
        return lambda e, a: e.begin_swap({"head": a(w2)})
    if case == "new_tenant_in_swap":
        _swap_in_flight(pair, "A", w + 0.1)
        return lambda e, a: e.program_params({"head": a(w2)}, tenant="B")
    _program(pair, "B", w2)
    if case == "anchor_no_free_plane":
        return lambda e, a: e.begin_swap({"head": a(w + 0.1)})
    if case == "anchor_eviction":
        return lambda e, a: e.evict_tenant("A")
    if case == "unknown_eviction":
        return lambda e, a: e.evict_tenant("C")
    if case == "evict_in_swap":
        _swap_in_flight(pair, "B", w2 + 0.1)
        return lambda e, a: e.evict_tenant("B")
    if case == "mid_write_read":
        _swap_in_flight(pair, "B", w2 + 0.1)
        return lambda e, a: e.linear(a(np.ones((2, 64), np.float32)),
                                     a(w2), "head", tenant="B")
    if case == "fingerprint_evicted":
        for e, _ in pair:
            e.evict_tenant("B")
        return lambda e, a: e.fingerprint(tenant="B")
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "unknown_tenant", "unknown_read_scope", "tile_geometry", "second_tree",
    "fused_stack_full", "fused_anchor_swap", "new_tenant_in_swap",
    "anchor_no_free_plane", "anchor_eviction", "unknown_eviction",
    "evict_in_swap", "mid_write_read", "fingerprint_evicted"])
def test_refusals_raise_as_the_reference(case):
    pair = _both()
    call = _setup(case, pair)
    (ex, t), (jex, j) = pair
    _raises_as_reference(lambda: call(ex, t), lambda: call(jex, j))


def test_live_deploy_into_a_full_stack_raises_as_the_reference():
    # three planes: A fused across two, B on the third; C has none
    pair = _both(3)
    _program(pair, "A", _w(1, 64, 32), mode_policy="expansion")
    _program(pair, "B", _w(2, 64, 32))
    (ex, t), (jex, j) = pair
    w = _w(4, 64, 32)
    _raises_as_reference(lambda: ex.begin_swap({"head": t(w)}, tenant="C"),
                         lambda: jex.begin_swap({"head": j(w)}, tenant="C"))


def test_in_place_swap_of_b_under_a_reads_equals_the_reference():
    pair = _both()
    (ex, _), (jex, _) = pair
    w_a, w_b, w_b2 = _w(13, 96, 48), _w(14, 96, 48), _w(15, 96, 48)
    x = _t(np.random.default_rng(16).standard_normal((3, 96))
           .astype(np.float32))
    _program(pair, "A", w_a)
    _program(pair, "B", w_b)
    fp_a, fp_b = ex.fingerprint(tenant="A"), ex.fingerprint(tenant="B")
    y_a = ex.linear(x, _t(w_a), "head", tenant="A")
    gen = {t: ex.plane_generation(t) for t in "AB"}
    plans = [e.begin_swap({"head": a(w_b2)}, tenant="B") for e, a in pair]
    assert [p.in_place for p in plans] == [True, True]
    assert plans[0].total_chunks == plans[1].total_chunks == 3
    for e, _ in pair:
        e.write_chunks(1)
    # mid-write: A serves untouched, B keeps its old identity
    assert torch.equal(ex.linear(x, _t(w_a), "head", tenant="A"), y_a)
    assert ex.fingerprint(tenant="B") == fp_b == jex.fingerprint(tenant="B")
    for e, _ in pair:
        e.write_chunks(8)
        e.promote()
    assert ex.fingerprint(tenant="A") == fp_a
    assert ex.fingerprint(tenant="B") == _cold(w_b2, ex.cfg).fingerprint()
    assert ex.residency() == jex.residency()
    assert ex.stats == jex.stats
    assert (ex.version("A"), ex.version("B")) == (
        jex.version("A"), jex.version("B")) == (1, 2)
    assert ex.plane_generation("A") == gen["A"]
    assert ex.plane_generation("B") == gen["B"] + 1
    assert torch.equal(ex.linear(x, _t(w_b2), "head", tenant="B"),
                       _cold(w_b2, ex.cfg).linear(x, _t(w_b2), "head"))
    assert torch.equal(ex.linear(x, _t(w_a), "head", tenant="A"), y_a)
    # a blocking swap reports the lifecycle as the reference does
    assert (ex.swap({"head": _t(w_b)}, chunk_burst=2, tenant="B")
            == jex.swap({"head": jnp.asarray(w_b)}, chunk_burst=2,
                        tenant="B"))
    # an aborted in-place swap keeps B's planes and version
    for e, a in pair:
        e.begin_swap({"head": a(w_b2)}, tenant="B")
        e.write_chunks(8)
        e.abort_swap()
    assert ex.fingerprints(tenant="B") == jex.fingerprints(tenant="B")
    assert ex.version("B") == jex.version("B") == 3
    assert torch.equal(ex.linear(x, _t(w_b), "head", tenant="B"),
                       _cold(w_b, ex.cfg).linear(x, _t(w_b), "head"))
    spans = obs.tracer().spans("executor_swap", tenant="B")
    assert spans[-1].attrs["lifecycle"] == "in_place"


def test_evict_and_live_deploy_equal_the_reference():
    pair = _both()
    (ex, _), (jex, _) = pair
    w_a, w_b = _w(20, 64, 32), _w(21, 64, 32)
    _program(pair, "A", w_a)
    _program(pair, "B", w_b)
    gen = ex.plane_generation("B")
    for e, _ in pair:
        e.evict_tenant("B")
        e.evict_tenant("B")                  # not resident: a no-op
    assert ex.tenants == jex.tenants == ["A"]
    assert ex.residency() == jex.residency()
    assert ex.plane_generation("B") == gen + 1
    reps = []
    for e, a in pair:
        hs = (HotSwapper if e is ex else jhotswap.HotSwapper)(
            e, {"head": a(w_b)}, chunks_per_step=1, tenant="B")
        assert not hs.plan.in_place             # the free plane: staged
        while not hs.done:
            hs.step()
        hs.promote()
        reps.append(hs.report())
    rep, jrep = reps
    assert rep.keys() == jrep.keys()
    for key in ("tenant", "swap_mode", "policy", "n_chunks",
                "stack_planes", "decode_steps_during_swap"):
        assert rep[key] == jrep[key], key
    assert (rep["tenant"], rep["swap_mode"]) == ("B", "staged")
    assert ex.residency() == jex.residency()
    assert ex.fingerprints(tenant="B") == jex.fingerprints(tenant="B")
    assert ex.version("B") == jex.version("B") == 2
    assert ex.plane_generation("B") == gen + 2


# -- QoS ---------------------------------------------------------------------

@pytest.mark.parametrize("n,weights", [
    (4, {"A": 2, "B": 1}), (16, {"A": 2, "B": 1}), (4, {"A": 1}),
    (3, {"A": 1, "B": 1, "C": 1}), (1, {"A": 5, "B": 1, "C": 1}),
    (2, {"A": 1, "B": 10}), (5, {"A": 0.3, "B": 0.7}),
    (7, {"A": 3, "B": 2, "C": 1})])
def test_split_slots_equals_the_reference(n, weights):
    got = tserve._split_slots(n, weights)
    assert got == jserve._split_slots(n, weights)
    assert all(v >= 1 for v in got.values())


# -- the scheduler ------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, TINY["vocab"] - 1, n).astype(np.int32)
            for _, n in REQUESTS]


def _requests(make_request, only=None):
    return [make_request(rid=i, prompt=p, max_new=MAX_NEW, model_id=t)
            for i, ((t, _), p) in enumerate(zip(REQUESTS, _prompts()))
            if only is None or t in only]


def _drain(sched, reqs, swap=None, at_step=3):
    """Serve ``reqs``; ``swap(sched)`` before step ``at_step``; step until
    every request finished and no swap is in flight.  The streams, the
    step after which the swap promoted, and whether B's lane was paused
    at each step."""
    for r in reqs:
        sched.submit(r)
    done, steps, flip, paused = [], 0, None, []
    while (len(done) < len(reqs) or sched.swap_in_flight) and steps < 300:
        if swap is not None and steps == at_step:
            swap(sched)
        was = sched.swap_in_flight
        lane_b = sched._lanes.get("B")
        paused.append(bool(lane_b is not None and lane_b.paused))
        done += sched.step()
        steps += 1
        if was and not sched.swap_in_flight:
            flip = steps
    assert len(done) == len(reqs)
    return {r.rid: list(r.out) for r in done}, flip, paused


def _jax_request(prompt, **kw):
    return jserve.Request(prompt=jnp.asarray(prompt), **kw)


@pytest.fixture(scope="module")
def tiny():
    """The reference tiny model's params and two fine-tuned checkpoints
    (numpy), and the reference's multiplexed serves."""
    jcfg = JaxModelConfig(dtype=jnp.float32, xbar=_cfgs()[1], **TINY)
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    a = jax.device_get(params)
    b = jax.device_get(jhotswap.finetune_delta(params, 0.05, seed=7))
    b2 = jax.device_get(jhotswap.finetune_delta(params, 0.09, seed=31))
    out = {"a": a, "b": b, "b2": b2}

    def mux(swap=None):
        model = jax_build(jcfg)
        sched = jserve.BatchScheduler(
            model, a, tenants={"A": (a, WEIGHTS["A"]),
                               "B": (b, WEIGHTS["B"])}, **SCHED)
        run = _drain(sched, _requests(_jax_request), swap)
        return sched, model, run

    sched, model, out["mux"] = mux()
    out["mux_kv"] = sched.kv_report()
    out["mux_qos"] = sched.qos_report()
    out["mux_modes"] = {t: sched.mode_report(t) for t in "AB"}
    sched.set_weights({"A": 1.0, "B": 3.0})
    out["reweighted_qos"] = sched.qos_report()
    out["reweighted_kv"] = sched.kv_report()
    sched, model, out["swap"] = mux(lambda s: s.begin_hot_swap(
        b2, chunks_per_step=2, tenant="B"))
    out["swap_history"] = sched.swap_history
    out["swap_fp"] = {t: model.executor.fingerprints(tenant=t)
                      for t in "AB"}
    out["swap_versions"] = {t: model.executor.version(t) for t in "AB"}
    # a live deploy of B into the free plane under A's traffic, then B's
    # requests
    model = jax_build(jcfg)
    sched = jserve.BatchScheduler(model, a, n_slots=2, max_len=24)
    run = _drain(sched, _requests(_jax_request, "A"),
                 lambda s: s.begin_hot_swap(b, chunks_per_step=2,
                                            tenant="B"))
    out["live"] = (run, _drain(sched, _requests(_jax_request, "B")))
    out["live_qos"] = sched.qos_report()
    out["live_kv"] = sched.kv_report()
    out["live_history"] = sched.swap_history
    return out


def _port_model():
    return build_model(ModelConfig(dtype=torch.float32, xbar=_cfgs()[0],
                                   **TINY), device="cpu")


def _port_mux(tiny, model=None):
    a = params_from_numpy(tiny["a"], "cpu")
    b = params_from_numpy(tiny["b"], "cpu")
    return tserve.BatchScheduler(
        model or _port_model(), a,
        tenants={"A": (a, WEIGHTS["A"]), "B": (b, WEIGHTS["B"])}, **SCHED)


def _history_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in ("tenant", "swap_mode", "policy", "n_chunks",
                    "stack_planes", "decode_steps_during_swap",
                    "n_grids"):
            assert g[key] == w[key], key


def test_multiplexed_streams_equal_the_reference_and_dedicated(tiny):
    sched = _port_mux(tiny)
    assert sched.tenants == ["A", "B"] and sched.params is not None
    run = _drain(sched, _requests(tserve.Request))
    streams = run[0]
    assert run == tiny["mux"]
    assert all(len(s) == MAX_NEW for s in streams.values())
    assert sched.kv_report() == tiny["mux_kv"]
    assert sched.qos_report() == tiny["mux_qos"]
    for t in "AB":
        rep, want = sched.mode_report(t), tiny["mux_modes"][t]
        assert rep["aggregate"]["tenant"] == t
        assert rep["traffic"]["tokens_served"] == want["traffic"][
            "tokens_served"]
        assert {n: (e["mode"], e["reason"]) for n, e in
                rep["layers"].items()} == {n: (e["mode"], e["reason"])
                                           for n, e in
                                           want["layers"].items()}
    with pytest.raises(KeyError, match="no lane for tenant 'C'"):
        sched.mode_report("C")
    # each tenant's streams are those of a dedicated scheduler
    for t, key in (("A", "a"), ("B", "b")):
        ded = tserve.BatchScheduler(
            _port_model(), params_from_numpy(tiny[key], "cpu"), n_slots=2,
            max_len=24)
        got, _, _ = _drain(ded, [dataclasses.replace(r, model_id="A")
                                 for r in _requests(tserve.Request, t)])
        assert got == {rid: s for rid, s in streams.items()
                       if REQUESTS[rid][0] == t}, t


def test_set_weights_equals_the_reference_and_captures_nothing(tiny):
    sched = _port_mux(tiny)
    _drain(sched, _requests(tserve.Request))
    steps = {t: lane.decode for t, lane in sched._lanes.items()}
    built = {t: s._leaves for t, s in steps.items()}
    reg = obs.registry()
    traces = reg.total("serve_jit_traces_total", closure="decode")
    sched.set_weights({"A": 1.0, "B": 3.0})
    assert sched.qos_report() == tiny["reweighted_qos"]
    assert sched.kv_report() == tiny["reweighted_kv"]
    assert [lane.width for lane in sched._lanes.values()] == [4, 2]
    assert sched.metrics.total("serve_qos_slot_quota", tenant="B") == 2
    assert sched.metrics.total("serve_qos_page_budget", tenant="A") == 3
    for t, s in steps.items():
        assert sched._lanes[t].decode is s and s._leaves is built[t]
    assert reg.total("serve_jit_traces_total", closure="decode") == traces
    with pytest.raises(KeyError, match="no lane for tenant 'C'"):
        sched.set_weights({"C": 1.0})
    with pytest.raises(ValueError, match="must be > 0"):
        sched.set_weights({"A": 0})


def test_in_place_swap_of_b_under_a_traffic_equals_the_reference(tiny):
    model = _port_model()
    sched = _port_mux(tiny, model)
    b2 = params_from_numpy(tiny["b2"], "cpu")
    run = _drain(sched, _requests(tserve.Request),
                 lambda s: s.begin_hot_swap(b2, chunks_per_step=2,
                                            tenant="B"))
    streams, flip, paused = run
    assert run == tiny["swap"]
    # B paused for exactly the window, then resumed on its new planes
    assert paused[3:flip] == [True] * (flip - 3) and not any(
        paused[:3] + paused[flip:])
    assert not sched._lanes["B"].paused
    # A's streams are those of the same serve without a swap
    assert {r: s for r, s in streams.items() if REQUESTS[r][0] == "A"} == {
        r: s for r, s in tiny["mux"][0].items() if REQUESTS[r][0] == "A"}
    _history_equal(sched.swap_history, tiny["swap_history"])
    assert sched.swap_history[0]["swap_mode"] == "in_place"
    ex = model.executor
    assert {t: ex.fingerprints(tenant=t) for t in "AB"} == tiny["swap_fp"]
    assert {t: ex.version(t) for t in "AB"} == tiny["swap_versions"]
    cold = CrossbarExecutor(ex.cfg)
    cold.program_params(params_from_numpy(tiny["b2"], "cpu"))
    assert ex.fingerprint(tenant="B") == cold.fingerprint()
    assert sched.metrics.total("serve_swap_windows_total",
                               lifecycle="in_place") == 1


def test_live_deploy_of_b_equals_the_reference(tiny):
    sched = tserve.BatchScheduler(
        _port_model(), params_from_numpy(tiny["a"], "cpu"), n_slots=2,
        max_len=24)
    b = params_from_numpy(tiny["b"], "cpu")
    with pytest.raises(ValueError, match="unknown tenant 'B'"):
        sched.submit(tserve.Request(rid=0, prompt=np.zeros(3, np.int32),
                                    max_new=2, model_id="B"))
    first = _drain(sched, _requests(tserve.Request, "A"),
                   lambda s: s.begin_hot_swap(b, chunks_per_step=2,
                                              tenant="B"))
    assert sched.tenants == ["A", "B"]
    second = _drain(sched, _requests(tserve.Request, "B"))
    assert (first, second) == tiny["live"]
    assert sched.qos_report() == tiny["live_qos"]
    assert sched.kv_report() == tiny["live_kv"]
    _history_equal(sched.swap_history, tiny["live_history"])
    assert sched.swap_history[0]["swap_mode"] == "staged"


class _Graph:
    """Stands in for a captured CUDA graph: records its release."""
    released = False

    def reset(self):
        self.released = True

    def replay(self):
        raise AssertionError("a dropped graph replayed")


class _Replaying(_Graph):
    """A stand-in graph that replays its lane's step body eagerly."""

    def __init__(self, lane):
        self.lane = lane

    def replay(self):
        step = self.lane.decode
        with step._reading():
            step._body(self.lane.params)


def test_a_lane_follows_its_tenant_planes(tiny):
    model = _port_model()
    ex = model.executor
    sched = _port_mux(tiny, model)
    b2 = params_from_numpy(tiny["b2"], "cpu")
    for r in _requests(tserve.Request):
        sched.submit(r)
    sched.step()
    lanes = sched._lanes
    graph_a = lanes["A"].decode.graph = _Replaying(lanes["A"])

    def mark_b():
        g = lanes["B"].decode.graph = _Graph()
        return g

    # an in-place promote drops B's graph at B's next step
    g = mark_b()
    sched.begin_hot_swap(b2, chunks_per_step=100, tenant="B")
    sched.step()
    assert g.released and lanes["B"].decode.graph is None
    # an eviction made on the executor beside the scheduler: B's next
    # step drops its graph and raises instead of reading freed planes
    g = mark_b()
    ex.evict_tenant("B")
    with pytest.raises(RuntimeError, match="'B' is not resident"):
        sched.step()
    assert g.released and lanes["B"].decode.graph is None
    # a live redeploy of the lane's checkpoint: B serves again, on the
    # new planes
    ex.swap(lanes["B"].params, tenant="B")
    assert ex.version("B") == 3
    g = mark_b()
    ex.evict_tenant("B")
    ex.swap(lanes["B"].params, tenant="B")
    done = []
    while len(done) < len(REQUESTS):
        done += sched.step()
    assert g.released
    # A's graph was never dropped: A's planes never changed
    assert not graph_a.released and ex.plane_generation("A") == 1


def _state(sched, reqs):
    return ({r.rid: (list(r.out), r.fed) for r in reqs},
            {t: lane.tokens_served for t, lane in sched._lanes.items()})


def test_an_evicted_lane_raises_before_any_lane_runs(tiny):
    model = _port_model()
    ex = model.executor
    sched = _port_mux(tiny, model)
    reqs = _requests(tserve.Request)
    for r in reqs:
        sched.submit(r)

    def a_finishes_next():
        # an A row decoding its last token, while B still has work
        lane_b = sched._lanes["B"]
        return any(r is not None and r.fed >= len(r.feed)
                   and len(r.out) == MAX_NEW - 1
                   for r in sched._lanes["A"].slots) and (
            lane_b.queue or any(r is not None for r in lane_b.slots))

    done = []
    while not a_finishes_next():
        done += sched.step()
    before = _state(sched, reqs)
    ex.evict_tenant("B")
    with pytest.raises(RuntimeError, match="'B' is not resident"):
        sched.step()
    # nothing ran: A's finishing request is still in flight, no token
    # was emitted or counted
    assert _state(sched, reqs) == before
    # the scheduler deploys B back: B's lane pauses, A's request
    # finishes in the next step, B resumes on the promoted planes
    sched.begin_hot_swap(sched._lanes["B"].params, chunks_per_step=2,
                         tenant="B")
    assert sched._lanes["B"].paused
    out = sched.step()
    assert any(r.model_id == "A" for r in out)
    done += out
    while len(done) < len(reqs) or sched.swap_in_flight:
        done += sched.step()
    assert not sched._lanes["B"].paused
    assert {r.rid: list(r.out) for r in done} == tiny["mux"][0]
    assert sched.swap_history[-1]["swap_mode"] == "staged"
    assert ex.tenants == ["A", "B"] and ex.version("B") == 2


# -- the CLI ---------------------------------------------------------------

def _cli(*extra):
    return serve_cli.main(["--smoke", "--backend", "crossbar", "--device",
                           "cpu", "--requests", "4", "--slots", "2",
                           "--prompt-len", "6", "--max-new", "3",
                           "--max-len", "32", *extra])


def test_cli_multiplex_swaps_the_last_tenant_in_place(capsys):
    rep = _cli("--multiplex", "init,seed:1", "--qos", "2,1", "--kv-pages",
               "4", "--hot-swap", "ft:0.02")
    assert rep["tokens"] == 12 and len(rep["requests"]) == 4
    assert sorted(r.model_id for r in rep["requests"]) == ["A", "A", "B",
                                                           "B"]
    (h,) = rep["swap_history"]
    assert (h["tenant"], h["swap_mode"]) == ("B", "in_place")
    assert rep["versions"] == {"A": 1, "B": 2}
    assert rep["qos"]["A"]["weight"] == 2.0
    assert rep["kv"]["A"]["budget"] == 5 and rep["kv"]["B"]["budget"] == 3
    out = capsys.readouterr().out
    assert "resident tenant B: v1" in out
    assert "hot-swap promoted [overlapped tenant B]: version=2" in out
    assert "swap_mode=in_place" in out
    assert "tenant A: 2 requests, 6 tokens; qos weight=2" in out
    assert "device [B/deepnet]" in out


@pytest.mark.parametrize("argv,message", [
    (["--multiplex", "init"], "--multiplex wants >= 2 comma-separated"),
    (["--multiplex", "init,init,init"],
     "--multiplex 3 tenants > 2 plane slots; raise --stack-planes to 3"),
    (["--qos", "2,1"], "--qos only applies under --multiplex"),
    (["--multiplex", "init,init", "--qos", "2,x"], "--qos: '2,x' wants"),
    (["--multiplex", "init,init", "--qos", "1,2,3"],
     "--qos wants one weight per --multiplex spec (2)")])
def test_cli_multiplex_refusals(argv, message):
    with pytest.raises(SystemExit, match=message.replace("(", r"\(")
                       .replace(")", r"\)")):
        _cli(*argv)
    with pytest.raises(SystemExit, match="--multiplex requires --backend"):
        serve_cli.main(["--smoke", "--device", "cpu", "--multiplex",
                        "init,init"])


def test_cli_three_planes_serve_three_tenants(capsys):
    rep = _cli("--multiplex", "init,seed:1,seed:2", "--stack-planes", "3",
               "--requests", "3")
    assert sorted(rep["versions"].items()) == [("A", 1), ("B", 1),
                                               ("C", 1)]
    assert {r.model_id for r in rep["requests"]} == {"A", "B", "C"}
    out = capsys.readouterr().out
    assert "3-plane banks" in out and "resident tenant C: v1" in out
