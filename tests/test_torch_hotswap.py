"""Port parity: deep-net hot-swap against the reference's.

Contract (docs/PORT.md): ``ChunkedProgram`` writes, chunk by chunk, the
reference's chunk planes BITWISE, and ``finish()`` equals the
reference's assembly and the port's ``engine.program``; write-verify
fails where the reference's fails, naming the same digests.  The
executor's swap, abort and refusals raise the reference's errors; after
a swap its fingerprints, residency and version equal the reference
executor's, and its reads equal a cold executor's bitwise.  A scheduler
hot-swap (and a stop-the-world swap) on the same requests gives the
reference's greedy streams, decode steps inside the window, promotion
step and post-swap fingerprints.  The second checkpoint is the
reference's ``finetune_delta`` carried across as numpy (the port's draws
from torch generators and differs).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import planes as jplanes  # noqa: E402
from repro.core.executor import CrossbarExecutor as JaxExecutor  # noqa: E402
from repro.core.quant import QuantConfig as JaxQuant  # noqa: E402
from repro.models.model import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve import hotswap as jhotswap  # noqa: E402
from repro.serve.engine import BatchScheduler as JaxScheduler  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import planes as tplanes  # noqa: E402
from repro_torch.core.executor import CrossbarExecutor  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.model import ModelConfig, build_model  # noqa: E402
from repro_torch.serve import hotswap  # noqa: E402
from repro_torch.serve.engine import BatchScheduler, Request  # noqa: E402

QUANT = dict(w_bits=4, in_bits=8, adc_bits=10)
CFG = teng.EngineConfig(tile_rows=32, tile_cols=32, mode="deepnet",
                        quant=QuantConfig(**QUANT))
JCFG = jeng.EngineConfig(tile_rows=32, tile_cols=32, mode="deepnet",
                         quant=JaxQuant(**QUANT))
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=128,
            backend="crossbar")
PROMPT_LENS = (5, 9, 3, 6)
MAX_NEW = 6


def _w(seed, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)) * 0.3).astype(np.float32)


def _pair(per_channel=True):
    """The port's and the reference's engine configs."""
    return (dataclasses.replace(CFG, quant=dataclasses.replace(
                CFG.quant, per_channel=per_channel)),
            dataclasses.replace(JCFG, quant=dataclasses.replace(
                JCFG.quant, per_channel=per_channel)))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _raises_as_reference(port_call, ref_call):
    """Both calls raise the same exception class with the same message."""
    with pytest.raises(Exception) as ref:
        ref_call()
    with pytest.raises(type(ref.value)) as got:
        port_call()
    assert str(got.value) == str(ref.value)


# -- chunked shadow-plane programming ---------------------------------------

@pytest.mark.parametrize("k,n,per_channel", [
    (96, 80, True), (64, 33, True), (33, 17, False)])
def test_chunked_program_is_bitwise_the_reference(k, n, per_channel):
    cfg, jcfg = _pair(per_channel)
    w = _w(k + n, k, n)
    cp = tplanes.ChunkedProgram("tile", _t(w), cfg)
    jcp = jplanes.ChunkedProgram("tile", jnp.asarray(w), jcfg)
    assert cp.total_chunks == jcp.total_chunks == -(-k // cfg.tile_rows)
    with pytest.raises(RuntimeError, match="unwritten"):
        cp.finish()
    while not cp.done:
        i = cp.chunks_done
        cp.write_chunk()
        jcp.write_chunk()
        assert np.array_equal(cp._pos[:, i].numpy(), np.asarray(jcp._pos[i]))
        assert np.array_equal(cp._neg[:, i].numpy(), np.asarray(jcp._neg[i]))
    assert cp.fp == jcp.fp
    got, ref, one_shot = cp.finish(), jcp.finish(), teng.program(_t(w), cfg)
    for a in (ref, one_shot):
        assert np.array_equal(got.pos.numpy(), np.asarray(a.pos))
        assert np.array_equal(got.neg.numpy(), np.asarray(a.neg))
        assert np.array_equal(got.w_scale.numpy(), np.asarray(a.w_scale))
        assert (got.k, got.n) == (a.k, a.n)
    assert tplanes.fingerprint_tiles(got) == jplanes.fingerprint_tiles(ref)
    cp.verify(got)


def test_write_verify_catches_a_scrambled_chunk_order():
    w = _w(11, 96, 48)
    cp = tplanes.ChunkedProgram("tile", _t(w), CFG)
    jcp = jplanes.ChunkedProgram("tile", jnp.asarray(w), JCFG)
    while not cp.done:
        cp.write_chunk()
        jcp.write_chunk()
    staged = cp.finish()
    cp.verify(staged)                       # a clean assembly passes
    staged.pos[:, [0, 1]] = staged.pos[:, [1, 0]].clone()
    jcp._pos[0], jcp._pos[1] = jcp._pos[1], jcp._pos[0]
    _raises_as_reference(lambda: cp.verify(staged),
                         lambda: jcp.verify(jcp.finish()))


# -- the executor's swap ------------------------------------------------------

def test_swap_refusals_raise_as_the_reference():
    w, w2 = _w(4, 64, 32), _w(5, 64, 32)
    ex, jex = CrossbarExecutor(CFG), JaxExecutor(JCFG)
    both = ((ex, _t), (jex, jnp.asarray))

    def same(fn):
        _raises_as_reference(lambda: fn(*both[0]), lambda: fn(*both[1]))

    same(lambda e, a: e.begin_swap({"head": a(w)}))
    same(lambda e, a: e.write_chunks(1))
    same(lambda e, a: e.promote())
    tree = {"head": w, "blocks": {"mlp": {"wi": w2[None]}}}
    ex.program_params({"head": _t(w), "blocks": {"mlp": {"wi": _t(w2)[None]}}})
    jex.program_params(jax.tree_util.tree_map(jnp.asarray, tree))
    same(lambda e, a: e.program_params({"head": a(w)}))    # another tree
    same(lambda e, a: e.begin_swap({"head": a(_w(6, 32, 32)),
                                    "blocks": {"mlp": {"wi": a(w2)[None]}}}))
    same(lambda e, a: e.begin_swap(
        {"head": a(w), "blocks": {"mlp": {"wi": a(w2)[None],
                                          "wg": a(w2)[None]}}}))
    same(lambda e, a: e.begin_swap({"head": a(w)}))        # tile missing
    same(lambda e, a: e.evict_tenant("A"))
    for e, a in both:
        e.begin_swap({"head": a(w + 0.1),
                      "blocks": {"mlp": {"wi": a(w2)[None]}}})
        e.write_chunks(1)
    same(lambda e, a: e.begin_swap({"head": a(w)}))        # in flight
    same(lambda e, a: e.promote())                         # unwritten
    same(lambda e, a: e.evict_tenant("A"))
    x = np.random.default_rng(6).standard_normal((2, 64)).astype(np.float32)
    cold = CrossbarExecutor(CFG)
    cold.program_params({"head": _t(w)})
    want = cold.linear(_t(x), _t(w), "head")
    # mid-swap reads serve the old planes; abort keeps them serving
    assert torch.equal(ex.linear(_t(x), _t(w), "head"), want)
    for e, _ in both:
        e.abort_swap()
        assert not e.swap_in_flight
    assert torch.equal(ex.linear(_t(x), _t(w), "head"), want)
    assert ex.programmed_version == jex.programmed_version == 1
    # a fused anchor (mode_policy="auto": the 2-tile head pairs) refuses
    fused, jfused = CrossbarExecutor(CFG), JaxExecutor(JCFG)
    fused.program_params({"head": _t(w)}, mode_policy="auto")
    jfused.program_params({"head": jnp.asarray(w)}, mode_policy="auto")
    assert fused.mode_for("head") == jfused.mode_for("head") == "expansion"
    _raises_as_reference(lambda: fused.begin_swap({"head": _t(w2)}),
                         lambda: jfused.begin_swap({"head": jnp.asarray(w2)}))


def _tiny_params():
    """The reference tiny model's params and its ``finetune_delta``, as
    numpy trees."""
    jcfg = JaxModelConfig(dtype=jnp.float32, xbar=JCFG, **TINY)
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    return (jax.device_get(params),
            jax.device_get(jhotswap.finetune_delta(params)))


@pytest.fixture(scope="module")
def tiny():
    a, b = _tiny_params()
    return {"a": a, "b": b}


def test_swap_state_equals_the_reference_and_reads_a_cold_deploy(tiny):
    ex, jex = CrossbarExecutor(CFG), JaxExecutor(JCFG)
    ex.program_params(params_from_numpy(tiny["a"], "cpu"))
    jex.program_params(tiny["a"])
    b = params_from_numpy(tiny["b"], "cpu")
    stats, jstats = ex.swap(b, chunk_burst=5), jex.swap(tiny["b"],
                                                        chunk_burst=5)
    assert stats == jstats
    assert ex.fingerprints() == jex.fingerprints()
    assert ex.fingerprint() == jex.fingerprint()
    assert ex.residency() == jex.residency()
    assert ex.version() == jex.version() == 2
    assert ex.stats == jex.stats
    for name in jex.fingerprints():
        assert (tplanes.fingerprint_tiles(ex._cache[name].active_for("A"))
                == jplanes.fingerprint_tiles(
                    jex._cache[name].active_for("A"))), name
    # the promoted tree is the programmed one: no reprogram, no refusal
    ex.ensure_programmed(b)
    cold = CrossbarExecutor(CFG)
    cold.program_params(params_from_numpy(tiny["b"], "cpu"))
    x = _t(np.random.default_rng(3).standard_normal((4, 32))
           .astype(np.float32))
    for name in ("head", "blocks.1.mlp.wi"):
        w = cold._cache[name].active_for("A")
        assert torch.equal(ex.linear(x, torch.empty(32, w.n), name),
                           cold.linear(x, torch.empty(32, w.n), name))
    spans = obs.tracer().spans("executor_swap")
    assert spans and spans[-1].attrs["chunks"] == stats["n_chunks"] == 17


def test_write_leak_equals_the_reference_and_rounds_away():
    cfg = dataclasses.replace(CFG, swap_leakage=True)
    jcfg = dataclasses.replace(JCFG, swap_leakage=True)
    leak = tplanes.write_leak_codes(cfg)
    assert leak == jplanes.write_leak_codes(jcfg)
    assert 0.0 < leak < 1e-3
    assert (tplanes.write_leak_scalar(cfg).item()
            == float(jplanes.write_leak_scalar(jcfg)))
    w = _w(7, 64, 48)
    x = _t(np.random.default_rng(8).standard_normal((4, 64))
           .astype(np.float32))
    ex = CrossbarExecutor(cfg)
    ex.program_params({"head": _t(w)})
    y_clean = ex.linear(x, _t(w), "head")
    assert ex.current_leak_codes().item() == 0.0
    ex.begin_swap({"head": _t(w + 0.1)})      # the overlap window opens
    assert ex.current_leak_codes().item() == np.float32(leak)
    assert torch.equal(ex.linear(x, _t(w), "head"), y_clean)
    ex.abort_swap()
    assert ex.current_leak_codes().item() == 0.0


def test_overlap_report_equals_the_reference():
    hifi = dataclasses.replace(CFG, quant=QuantConfig(w_bits=8, in_bits=10,
                                                      adc_bits=14))
    jhifi = dataclasses.replace(JCFG, quant=JaxQuant(w_bits=8, in_bits=10,
                                                     adc_bits=14))
    for kw in (dict(n_grids=15, n_chunks=17, batch_size=2),
               dict(n_grids=113, n_chunks=3348, batch_size=4,
                    decode_steps_during=13, wall_swap_s=1.5)):
        for cfg, jcfg in ((CFG, JCFG), (hifi, jhifi)):
            got = hotswap.overlap_report(cfg, **kw)
            ref = jhotswap.overlap_report(jcfg, **kw)
            assert got.keys() == ref.keys()
            for key, v in ref.items():
                assert got[key] == pytest.approx(v, rel=1e-12), key


def test_finetune_delta_is_seeded_per_leaf():
    p = {"a": torch.zeros(3, 4), "b": {"c": torch.ones(5)}}
    d1, d2 = hotswap.finetune_delta(p), hotswap.finetune_delta(p)
    assert torch.equal(d1["a"], d2["a"]) and torch.equal(d1["b"]["c"],
                                                         d2["b"]["c"])
    assert not torch.equal(hotswap.finetune_delta(p, seed=3)["a"], d1["a"])
    assert 0 < float((d1["b"]["c"] - 1).abs().max()) < 0.2


# -- the scheduler ------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, TINY["vocab"] - 1, n).astype(np.int32)
            for n in PROMPT_LENS]


def _swap_serve(sched, make_request, swap, at_step=3):
    """Serve the prompts, call ``swap(sched)`` before step ``at_step``,
    and step until every request finished and the swap promoted; the
    streams, the step that promoted, and the swap report."""
    for i, p in enumerate(_prompts()):
        sched.submit(make_request(rid=i, prompt=p, max_new=MAX_NEW))
    done, steps, flip = [], 0, None
    while (len(done) < len(PROMPT_LENS) or sched.swap_in_flight) \
            and steps < 200:
        if steps == at_step:
            swap(sched)
        was = sched.swap_in_flight
        done += sched.step()
        steps += 1
        if was and not sched.swap_in_flight:
            flip = steps
    (rep,) = sched.swap_history
    return ({r.rid: list(r.out) for r in done}, flip,
            rep["decode_steps_during_swap"], rep["policy"])


@pytest.fixture(scope="module")
def reference_swaps(tiny):
    """The reference's overlapped and stop-the-world serves of the tiny
    model (one JAX run each per module)."""
    out = {}
    for policy in ("overlapped", "stop_the_world"):
        model = jax_build(JaxModelConfig(dtype=jnp.float32, xbar=JCFG,
                                         **TINY))
        sched = JaxScheduler(model, tiny["a"], n_slots=2, max_len=24)
        b = tiny["b"]
        swap = ((lambda s: s.begin_hot_swap(b, chunks_per_step=2))
                if policy == "overlapped"
                else (lambda s: s.stop_the_world_swap(b)))
        out[policy] = _swap_serve(sched, lambda prompt, **kw: JaxRequest(
            prompt=jnp.asarray(prompt), **kw), swap)
        out[policy + "_fp"] = model.executor.fingerprints()
    return out


@pytest.mark.parametrize("policy", ["overlapped", "stop_the_world"])
def test_scheduler_swap_equals_the_reference(tiny, reference_swaps, policy):
    model = build_model(ModelConfig(dtype=torch.float32, xbar=CFG, **TINY),
                        device="cpu")
    sched = BatchScheduler(model, params_from_numpy(tiny["a"], "cpu"),
                           n_slots=2, max_len=24)
    b = params_from_numpy(tiny["b"], "cpu")
    swap = ((lambda s: s.begin_hot_swap(b, chunks_per_step=2))
            if policy == "overlapped"
            else (lambda s: s.stop_the_world_swap(b)))
    before = obs.registry().total("serve_jit_traces_total",
                                  closure="decode")
    got = _swap_serve(sched, Request, swap)
    assert got == reference_swaps[policy]
    streams, flip, during, _ = got
    assert all(len(s) == MAX_NEW for s in streams.values())
    assert (flip is not None) == (policy == "overlapped")
    assert (during > 0) == (policy == "overlapped")
    assert model.executor.fingerprints() == reference_swaps[policy + "_fp"]
    assert model.executor.version() == 2
    # one closure before the flip, one after: two traces, no retrace
    assert obs.registry().total("serve_jit_traces_total",
                                closure="decode") - before == 2
    assert sched.metrics.total("serve_swap_windows_total",
                               policy=policy) == 1
    (span,) = sched.tracer.spans("swap_window")
    assert span.attrs["policy"] == policy


class _Graph:
    """Stands in for a captured CUDA graph: records its release."""
    released = False

    def reset(self):
        self.released = True

    def replay(self):
        raise AssertionError("a dropped graph replayed")


def test_promotion_drops_the_graph_even_for_the_same_tree(tiny):
    model = build_model(ModelConfig(dtype=torch.float32, xbar=CFG, **TINY),
                        device="cpu")
    params = params_from_numpy(tiny["a"], "cpu")
    sched = BatchScheduler(model, params, n_slots=2, max_len=24)
    sched.submit(Request(rid=0, prompt=_prompts()[0], max_new=MAX_NEW))
    sched.step()
    step = sched._lane.decode
    graph = step.graph = _Graph()             # as if captured
    sched.begin_hot_swap(params, chunks_per_step=100)   # an init swap
    sched.step()                              # promotes, then serves
    assert graph.released and step.graph is None
    assert sched._lane.params is params and model.executor.version() == 2


# -- the CLI ---------------------------------------------------------------

def _cli(*extra):
    return serve_cli.main(["--smoke", "--backend", "crossbar", "--device",
                           "cpu", "--requests", "3", "--slots", "2",
                           "--prompt-len", "6", "--max-new", "3",
                           "--max-len", "32", *extra])


def test_cli_init_swap_serves_the_no_swap_streams(capsys):
    plain = _cli()
    swapped = _cli("--hot-swap", "init", "--swap-after", "0",
                   "--swap-chunks", "4")
    assert ({r.rid: r.out for r in swapped["requests"]}
            == {r.rid: r.out for r in plain["requests"]})
    (rep,) = swapped["swap_history"]
    assert swapped["version"] == 2 and rep["decode_steps_during_swap"] > 0
    out = capsys.readouterr().out
    assert "hot-swap promoted [overlapped tenant A]: version=2" in out


def test_cli_metrics_out_holds_the_swap_spans_and_metrics(tmp_path, capsys):
    path = tmp_path / "metrics.jsonl"
    _cli("--hot-swap", "ft:0.02", "--swap-after", "1", "--swap-chunks", "8",
         "--tile-rows", "32", "--metrics-out", str(path))
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    spans = {r["span"] for r in rows if r["kind"] == "span"}
    assert {"request", "swap_window", "executor_swap"} <= spans
    names = {r["metric"] for r in rows if r["kind"] == "metric"}
    assert {"serve_swap_windows_total", "crossstack_swaps_total",
            "crossstack_swap_chunks_total", "serve_tokens_total"} <= names
    out = capsys.readouterr().out
    assert "telemetry: wrote" in out and "Prometheus snapshot" in out
    with pytest.raises(SystemExit, match="crossbar"):
        serve_cli.main(["--smoke", "--device", "cpu", "--hot-swap", "init"])
    with pytest.raises(SystemExit, match="checkpoint manager"):
        _cli("--hot-swap", str(tmp_path))
