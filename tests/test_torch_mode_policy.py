"""Port parity: per-weight read-mode policies (the executor's ``mode_policy``
and ``mode_report``, the scheduler's ``mode_policy`` and ``mode_report``)
against the reference's, mirroring tests/test_expansion_modes.py.

Contract:
* resolved modes, reasons, residency and the per-mode device token cost
  are EQUAL to the reference's for the same params and policy;
* mode_report's IR scores agree to 1e-4 (relative for the deviations,
  absolute for the reductions; see test_torch_ir_drop.py for the
  measured float32 gap of the nodal solves);
* an expansion-fused weight's read equals ``engine.matmul`` under the
  expansion config bitwise, and a deep-net weight's read is untouched;
* greedy SMOKE streams under ``mode_policy="auto"`` with 16-row tiles
  (so that attention and the head really are fused) are IDENTICAL to the
  reference scheduler's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core.executor import CrossbarExecutor as JaxExecutor  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve.engine import BatchScheduler as JaxScheduler  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core.executor import CrossbarExecutor  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import BatchScheduler, Request  # noqa: E402

QK = dict(w_bits=4, in_bits=8, adc_bits=10)
SCORE_TOL = 1e-4


def _cfgs(**over):
    j = jeng.EngineConfig(tile_rows=16, tile_cols=16, mode="deepnet",
                          quant=jq.QuantConfig(**QK))
    t = teng.EngineConfig(tile_rows=16, tile_cols=16, mode="deepnet",
                          quant=tq.QuantConfig(**QK))
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _params(seed=0, d=32, d_ff=48):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    return {"blocks": {"attn": {"wq": w(2, d, d)},
                       "mlp": {"wi": w(2, d, d_ff), "wo": w(2, d_ff, d)}},
            "head": w(d, 2 * d)}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _both(policy, seed=0, d=32, d_ff=48, **over):
    """The same params programmed under ``policy`` in both packages."""
    jcfg, tcfg = _cfgs(**over)
    p = _params(seed, d, d_ff)
    jex, tex = JaxExecutor(jcfg), CrossbarExecutor(tcfg)
    jex.program_params(_jax_tree(p), mode_policy=policy)
    tex.program_params(params_from_numpy(p, "cpu"), mode_policy=policy)
    return jex, tex, p


def _assert_reports_agree(trep, jrep):
    assert trep["layers"].keys() == jrep["layers"].keys()
    for name, je in jrep["layers"].items():
        te = trep["layers"][name]
        for key in ("mode", "fused", "row_tiles", "k", "n", "reason"):
            assert te[key] == je[key], (name, key)
        for key in ("dev_deepnet", "dev_expansion"):
            assert te[key] == pytest.approx(je[key], rel=SCORE_TOL)
        assert abs(te["ir_drop_reduction"]
                   - je["ir_drop_reduction"]) <= SCORE_TOL
    ja, ta = jrep["aggregate"], trep["aggregate"]
    for key in ("tenant", "n_expansion", "n_deepnet", "tile_rows",
                "tile_cols", "stack_planes"):
        assert ta[key] == ja[key], key
    assert abs(ta["ir_drop_reduction_expansion"]
               - ja["ir_drop_reduction_expansion"]) <= SCORE_TOL


def test_auto_policy_fuses_attention_and_head_keeps_mlp_deepnet():
    jex, tex, _ = _both("auto")
    assert tex.mode_for("blocks.0.attn.wq") == "expansion"
    assert tex.mode_for("blocks.1.attn.wq") == "expansion"
    assert tex.mode_for("head") == "expansion"
    assert tex.mode_for("blocks.0.mlp.wi") == "deepnet"
    assert tex.mode_for("blocks.1.mlp.wo") == "deepnet"
    rep = tex.mode_report()
    assert rep["aggregate"]["n_expansion"] == 3
    assert rep["aggregate"]["n_deepnet"] == 4
    for name, entry in rep["layers"].items():
        assert entry["mode"] == tex.mode_for(name) == jex.mode_for(name)
        assert entry["fused"] == (entry["mode"] == "expansion")
        assert entry["reason"].startswith("auto:")
    assert tex.residency()["A"]["modes"] == {"expansion": 3, "deepnet": 4}
    assert tex.residency() == jex.residency()
    assert tex.fingerprints() == jex.fingerprints()
    assert tex.device_token_cost() == jex.device_token_cost()
    _assert_reports_agree(rep, jex.mode_report())


def test_auto_policy_on_paper_geometry_meets_22pct_claim():
    """On the paper's 10x10x2 prototype geometry the expansion layout
    cuts worst-case IR drop >= 20% (paper: 22%), as in the reference
    (whose 10 x 10 scores test_torch_ir_drop.py compares)."""
    _, tcfg = _cfgs(tile_rows=10, tile_cols=10)
    ex = CrossbarExecutor(tcfg)
    ex.program_params(params_from_numpy(_params(d=20, d_ff=60), "cpu"),
                      mode_policy="auto")
    agg = ex.mode_report()["aggregate"]
    assert agg["n_expansion"] > 0 and agg["n_deepnet"] > 0
    assert agg["ir_drop_reduction_expansion"] >= 0.20


def test_named_and_fragment_mode_policy_resolution():
    policy = {"blocks.0.attn.wq": "expansion",   # exact name
              "mlp.wi": "expansion",             # dotted fragment
              "default": "deepnet"}
    jex, tex, _ = _both(policy)
    assert tex.mode_for("blocks.0.attn.wq") == "expansion"
    assert tex.mode_for("blocks.0.mlp.wi") == "expansion"
    assert tex.mode_for("blocks.1.mlp.wi") == "expansion"
    assert tex.mode_for("blocks.1.attn.wq") == "deepnet"   # default
    assert tex.mode_for("head") == "deepnet"
    names = sorted(tex.fingerprints())
    assert ([tex.mode_for(n) for n in names]
            == [jex.mode_for(n) for n in names])
    assert ({n: e["reason"] for n, e in tex.mode_report()["layers"].items()}
            == {n: e["reason"] for n, e in jex.mode_report()["layers"]
                .items()})


def test_odd_row_tile_count_refuses_expansion_under_auto():
    # d=16 at tile_rows=16 -> a single row tile: nothing to pair across
    # the two planes, so auto keeps even attention in deep-net layout
    w = (np.random.default_rng(0).standard_normal((2, 16, 16)) * 0.3
         ).astype(np.float32)
    ex = CrossbarExecutor(_cfgs()[1])
    ex.program_params({"blocks": {"attn": {"wq": torch.from_numpy(w)}}},
                      mode_policy="auto")
    assert ex.mode_for("blocks.0.attn.wq") == "deepnet"
    reason = ex.mode_report()["layers"]["blocks.0.attn.wq"]["reason"]
    assert "row-tile" in reason


def test_fused_reads_bit_exact_vs_expansion_engine():
    """A fused weight's read equals engine.matmul under the expansion
    cfg; a deep-net weight's read is untouched — one executor, both
    modes — and both agree with the reference executor's reads."""
    jex, tex, p = _both("auto")
    _, xbar = _cfgs()
    exp_cfg = dataclasses.replace(xbar, mode="expansion")
    x = np.random.default_rng(9).standard_normal((3, 32)).astype(np.float32)
    tx = torch.from_numpy(x)
    for name, w, cfg in (
            ("blocks.0.attn.wq", p["blocks"]["attn"]["wq"][0], exp_cfg),
            ("blocks.0.mlp.wi", p["blocks"]["mlp"]["wi"][0], xbar)):
        tw = torch.from_numpy(w)
        y = tex.linear(tx, tw, name)
        assert torch.equal(y, teng.matmul(tx, teng.program(tw, cfg), cfg))
        want = np.asarray(jex.linear(jnp.asarray(x), jnp.asarray(w), name))
        np.testing.assert_allclose(y.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_mode_is_physical_layout_conflict_on_reprogram():
    _, tex, p = _both("auto")
    tp = params_from_numpy(p, "cpu")
    fresh = CrossbarExecutor(_cfgs()[1])
    fresh.program_params(tp, mode_policy="auto")
    # a policy-free re-walk expresses no preference: pure cache hit
    assert fresh.program_params(tp) == 0
    # demanding the opposite layout for a resident weight must refuse
    with pytest.raises(RuntimeError, match="physical plane layout"):
        fresh.program_params(tp, mode_policy={
            "default": "auto", "blocks.0.attn.wq": "deepnet"})


def test_fused_residency_consumes_both_planes():
    # stack_planes=2: one expansion-fused weight fills the whole bank, so
    # a second tenant cannot join on it, as the reference refuses it;
    # deep-net layout leaves the second plane to tenant B
    jcfg, tcfg = _cfgs()
    w = (np.random.default_rng(0).standard_normal((32, 16)) * 0.3
         ).astype(np.float32)
    jex, tex = JaxExecutor(jcfg), CrossbarExecutor(tcfg)
    jex.program_params({"head": jnp.asarray(w)}, mode_policy="expansion")
    tex.program_params({"head": torch.from_numpy(w)},
                       mode_policy="expansion")
    with pytest.raises(RuntimeError, match="stack is full") as ref:
        jex.program_params({"head": jnp.asarray(w)}, tenant="B")
    with pytest.raises(RuntimeError) as got:
        tex.program_params({"head": torch.from_numpy(w)}, tenant="B")
    assert str(got.value) == str(ref.value)
    assert tex.residency() == jex.residency()
    jex2, tex2 = JaxExecutor(jcfg), CrossbarExecutor(tcfg)
    for e, a in ((jex2, jnp.asarray), (tex2, torch.from_numpy)):
        e.program_params({"head": a(w)}, mode_policy="deepnet")
        e.program_params({"head": a(w)}, tenant="B")
    assert tex2.tenants == jex2.tenants == ["A", "B"]
    assert tex2.residency() == jex2.residency()


def test_invalid_policy_values_refused_and_leave_the_executor_untouched():
    ex = CrossbarExecutor(_cfgs()[1])
    tp = params_from_numpy(_params(), "cpu")
    with pytest.raises(ValueError, match="mode"):
        ex.program_params(tp, mode_policy="sideways")
    with pytest.raises(ValueError, match="mode"):
        ex.program_params(tp, mode_policy={"default": "sideways"})
    assert ex.n_resident == 0 and ex.stats["program_walks"] == 0
    assert ex.tenants == []


# -- the scheduler and the CLI ---------------------------------------------

PROMPT_LENS = (5, 11, 3)
MAX_NEW = 4


def _serve(sched, make_request):
    rng = np.random.default_rng(0)
    vocab = get_config("qwen3-4b", smoke=True).vocab
    for i, n in enumerate(PROMPT_LENS):
        sched.submit(make_request(
            rid=i, prompt=rng.integers(0, vocab - 1, n).astype(np.int32),
            max_new=MAX_NEW))
    done, steps = [], 0
    while len(done) < len(PROMPT_LENS) and steps < 100:
        done += sched.step()
        steps += 1
    return {r.rid: list(r.out) for r in done}


def test_auto_policy_streams_and_report_equal_the_reference():
    jcfg = jax_config("qwen3-4b", smoke=True)
    jcfg = dataclasses.replace(
        jcfg, backend="crossbar", dtype=jnp.float32,
        xbar=dataclasses.replace(jcfg.xbar, tile_rows=16))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jsched = JaxScheduler(jmodel, jparams, n_slots=2, max_len=32,
                          mode_policy="auto")
    want = _serve(jsched, lambda prompt, **kw: JaxRequest(
        prompt=jnp.asarray(prompt), **kw))

    tcfg = get_config("qwen3-4b", smoke=True)
    tcfg = dataclasses.replace(
        tcfg, backend="crossbar", dtype=torch.float32,
        xbar=dataclasses.replace(tcfg.xbar, tile_rows=16))
    model = build_model(tcfg, device="cpu")
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    sched = BatchScheduler(model, params, n_slots=2, max_len=32,
                           mode_policy="auto")
    got = _serve(sched, Request)
    assert got == want
    assert all(len(s) == MAX_NEW for s in got.values())

    rep, jrep = sched.mode_report(), jsched.mode_report()
    assert rep["aggregate"]["n_expansion"] == 9     # 4 attn x 2 + head
    assert rep["aggregate"]["n_deepnet"] == 6       # 3 mlp x 2
    _assert_reports_agree(rep, jrep)
    traffic, jtraffic = rep["traffic"], jrep["traffic"]
    assert traffic["tokens_served"] == jtraffic["tokens_served"] == 12
    assert traffic["modes"].keys() == jtraffic["modes"].keys() == {
        "deepnet", "expansion"}
    for mode, entry in jtraffic["modes"].items():
        for key, val in entry.items():
            assert traffic["modes"][mode][key] == pytest.approx(
                val, rel=1e-12), (mode, key)
    assert model.executor.residency() == jmodel.executor.residency()
    with pytest.raises(KeyError, match="no lane"):
        sched.mode_report("B")


def test_mode_policy_needs_the_crossbar_backend():
    model = build_model(get_config("qwen3-4b", smoke=True), device="cpu")
    with pytest.raises(RuntimeError, match="crossbar backend"):
        BatchScheduler(model, model.init(0), n_slots=2, max_len=32,
                       mode_policy="auto")
    with pytest.raises(SystemExit, match="requires --backend crossbar"):
        serve_cli.main(["--smoke", "--device", "cpu", "--mode-policy",
                        "auto"])
    with pytest.raises(SystemExit, match="bad entry"):
        serve_cli.parse_mode_policy("attn=sideways")
    assert serve_cli.parse_mode_policy("attn=expansion,default=auto") == {
        "attn": "expansion", "default": "auto"}
