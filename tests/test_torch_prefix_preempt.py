"""Port parity: prefix sharing and QoS preemption against the reference's,
mirroring tests/test_prefix_preempt.py.

Contract (docs/PORT.md, "Prefix sharing and preemption"):
* integers are EQUAL to the reference's after every step: each lane's
  page tables, free list, refcounts and prefix-index size, and the
  cache's page-table and fill-marker buffers (which the port writes in
  place); the counters ``serve_kv_pages_shared_total``,
  ``serve_kv_shared_tokens_total``, ``serve_kv_cow_total`` and
  ``serve_preemptions_total``, and each request's ``preemptions`` and
  ``shared_tokens``;
* greedy streams are EQUAL to the reference's (float32 on the SMOKE
  config, the reference's own sizes) and to the port's ``kv="dense"``
  oracle;
* the window step is traced once per lane and never again across
  sharing, copy-on-write, eviction and re-admission;
* refusals raise the reference's exception class and message, and the
  CLI's flags behave as the reference's.
The same params reach both packages through ``bridge.params_from_numpy``
and the same prompts through numpy.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.engine import EngineConfig as JaxEngine  # noqa: E402
from repro.core.quant import QuantConfig as JaxQuant  # noqa: E402
from repro.models.model import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve import engine as jserve  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.model import ModelConfig, build_model  # noqa: E402
from repro_torch.serve import engine as tserve  # noqa: E402

COUNTERS = ("serve_kv_pages_shared_total", "serve_kv_shared_tokens_total",
            "serve_kv_cow_total", "serve_preemptions_total")
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
            n_kv=2, head_dim=16, d_ff=64, vocab=128, backend="crossbar")
TINY_QUANT = dict(w_bits=4, in_bits=6, adc_bits=12)


@pytest.fixture(scope="module")
def smoke():
    """The SMOKE qwen3-4b at float32 in both packages, one set of
    params (the reference's test serves the digital backend)."""
    jcfg = dataclasses.replace(jax_config("qwen3_4b", smoke=True),
                               dtype=jnp.float32)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("qwen3-4b", smoke=True),
                               dtype=torch.float32)
    return {"ref": (jm, jp),
            "port": (build_model(tcfg, device="cpu"),
                     params_from_numpy(jax.device_get(jp), "cpu")),
            "vocab": tcfg.vocab}


def _prompt(seed, vocab, n):
    return np.random.default_rng(seed).integers(0, vocab - 1, n).astype(
        np.int32)


def _pool_state(sched, tenant="A"):
    """The lane's pool and the cache's page-table and fill-marker rows
    (layer 0; every layer holds the same)."""
    lane = sched._lanes[tenant]
    pool, layers = lane.pool, lane.cache["layers"]
    return {"table": pool.table().tolist(), "free": list(pool._free),
            "ref": dict(pool._ref), "prefix_entries": pool.prefix_entries,
            "index_ops": pool.index_ops,
            "pt": np.asarray(layers["pt"][0]).tolist(),
            "len": np.asarray(layers["len"][0]).tolist()}


def _counts(sched, tenant="A"):
    return {n: int(sched.metrics.total(n, tenant=tenant)) for n in COUNTERS}


def _requests(pkg, specs):
    """(rid, prompt, max_new, qos) specs -> each package's requests."""
    cls = jserve.Request if pkg == "ref" else tserve.Request
    return [cls(rid=rid, prompt=p, max_new=n, qos=q)
            for rid, p, n, q in specs]


def _lockstep(scheds, specs, stagger, max_steps=400):
    """Serve ``specs`` on the reference's and the port's scheduler in
    lockstep (request i submitted before step ``stagger[i]``); after
    every step the pools and cache buffers must be equal.  Returns the
    port's streams, its peak distinct pages and its finished requests,
    and the reference's finished requests."""
    reqs = {k: _requests(k, specs) for k in scheds}
    done = {k: {} for k in scheds}
    fin = {k: [] for k in scheds}
    pending = sorted(range(len(specs)), key=lambda i: stagger[i])
    peak = steps = 0
    while len(done["port"]) < len(specs) and steps < max_steps:
        while pending and stagger[pending[0]] <= steps:
            i = pending.pop(0)
            for k, s in scheds.items():
                s.submit(reqs[k][i])
        for k, s in scheds.items():
            for r in s.step():
                done[k][r.rid] = list(r.out)
                fin[k].append(r)
        assert _pool_state(scheds["port"]) == _pool_state(scheds["ref"]), \
            f"pools differ after step {steps}"
        pool = scheds["port"]._lanes["A"].pool
        assert pool.conservation_ok()
        peak = max(peak, pool.pages_in_use)
        steps += 1
    assert len(done["port"]) == len(specs), "stalled"
    assert done["port"] == done["ref"]
    assert _counts(scheds["port"]) == _counts(scheds["ref"])
    per_req = {k: sorted((r.rid, r.preemptions, r.shared_tokens)
                         for r in fin[k]) for k in fin}
    assert per_req["port"] == per_req["ref"]
    return done["port"], peak, fin["port"]


def _dense(smoke, specs, stagger, n_slots, max_len):
    """The port's dense-cache oracle on the same requests."""
    model, params = smoke["port"]
    sched = tserve.BatchScheduler(model, params, n_slots=n_slots,
                                  max_len=max_len, kv="dense")
    reqs = _requests("port", specs)
    done, steps = {}, 0
    pending = sorted(range(len(specs)), key=lambda i: stagger[i])
    while len(done) < len(specs) and steps < 400:
        while pending and stagger[pending[0]] <= steps:
            sched.submit(reqs[pending.pop(0)])
        done.update({r.rid: list(r.out) for r in sched.step()})
        steps += 1
    return done


def _pair(smoke, **kw):
    jm, jp = smoke["ref"]
    tm, tp = smoke["port"]
    return {"ref": jserve.BatchScheduler(jm, jp, **kw),
            "port": tserve.BatchScheduler(tm, tp, **kw)}


def _traced_once():
    reg = obs.registry()
    assert reg.total("serve_jit_traces_total", closure="decode",
                     tenant="A") == 1
    assert reg.total("serve_jit_retraces_total") == 0


# -- shared-prefix page savings, bit-exact ------------------------------------

def test_shared_prefix_uses_fewer_pages_with_bit_exact_streams(smoke):
    v = smoke["vocab"]
    head = _prompt(777, v, 16)
    specs = [(i, np.concatenate([head, _prompt(900 + i, v, 4 + 2 * i)]), 4,
              1.0) for i in range(4)]
    stagger = [0, 6, 6, 6]
    obs.reset()
    shared = _pair(smoke, n_slots=4, max_len=32, page_size=8,
                   prefix_share=True)
    streams, peak_shared, _ = _lockstep(shared, specs, stagger)
    _traced_once()
    counts = _counts(shared["port"])
    assert counts["serve_kv_pages_shared_total"] >= 2 * 3
    assert counts["serve_kv_shared_tokens_total"] >= 16 * 3
    pool = shared["port"]._lanes["A"].pool
    assert pool.pages_in_use == 0 and pool.prefix_entries == 0
    assert shared["port"].kv_report() == shared["ref"].kv_report()
    private = _pair(smoke, n_slots=4, max_len=32, page_size=8)
    private_streams, peak_private, _ = _lockstep(private, specs, stagger)
    assert streams == private_streams == _dense(smoke, specs, stagger, 4, 32)
    assert peak_shared < peak_private


def test_cow_protects_the_owner_on_sub_page_divergence(smoke):
    """Request 1 matches request 0 for 12 of 16 tokens: the aliased
    second page is privatized before request 1's own tokens (and the
    window's pads past them) land, so request 0 keeps its stream."""
    v = smoke["vocab"]
    p0 = _prompt(42, v, 16)
    p1 = np.concatenate([p0[:12], _prompt(43, v, 8)])
    specs = [(0, p0, 12, 1.0), (1, p1, 6, 1.0)]
    stagger = [0, 5]
    scheds = _pair(smoke, n_slots=2, max_len=32, page_size=8,
                   prefix_share=True)
    streams, _, _ = _lockstep(scheds, specs, stagger)
    counts = _counts(scheds["port"])
    assert counts["serve_kv_cow_total"] == 1
    assert counts["serve_kv_shared_tokens_total"] == 12
    assert streams == _dense(smoke, specs, stagger, 2, 32)


# -- preemption under saturation ----------------------------------------------

def test_preemption_admits_high_qos_and_drops_nothing(smoke):
    v = smoke["vocab"]
    specs = [(i, _prompt(500 + i, v, 20), 5, q)
             for i, q in enumerate((1.0, 1.0, 4.0, 4.0))]
    stagger = [0, 0, 8, 8]
    obs.reset()
    scheds = _pair(smoke, n_slots=4, max_len=32, page_size=8, kv_pages=8,
                   preemption=True)
    streams, _, finished = _lockstep(scheds, specs, stagger)
    _traced_once()
    assert streams == _dense(smoke, specs, stagger, 4, 32)
    preempted = [r for r in finished if r.preemptions]
    assert preempted and all(r.qos == 1.0 for r in preempted)
    assert _counts(scheds["port"])["serve_preemptions_total"] == sum(
        r.preemptions for r in finished)
    pool = scheds["port"]._lanes["A"].pool
    assert pool.pages_in_use == 0 and pool.conservation_ok()


def test_preemption_without_higher_qos_keeps_fifo(smoke):
    v = smoke["vocab"]
    specs = [(i, _prompt(520 + i, v, 20), 5, 1.0) for i in range(3)]
    scheds = _pair(smoke, n_slots=4, max_len=32, page_size=8, kv_pages=8,
                   preemption=True)
    _, _, finished = _lockstep(scheds, specs, [0, 0, 0])
    assert all(r.preemptions == 0 for r in finished)
    assert _counts(scheds["port"])["serve_preemptions_total"] == 0


def test_preempted_request_reshares_its_prefix_on_readmission(smoke):
    v = smoke["vocab"]
    head = _prompt(600, v, 16)
    specs = [(0, np.concatenate([head, _prompt(601, v, 4)]), 12, 1.0),
             (1, np.concatenate([head, _prompt(602, v, 4)]), 12, 1.0),
             (2, _prompt(603, v, 4), 5, 4.0)]
    stagger = [0, 6, 9]
    obs.reset()
    scheds = _pair(smoke, n_slots=3, max_len=32, page_size=8, kv_pages=6,
                   prefix_share=True, preemption=True)
    streams, _, finished = _lockstep(scheds, specs, stagger)
    _traced_once()
    assert streams == _dense(smoke, specs, stagger, 3, 32)
    counts = _counts(scheds["port"])
    assert counts["serve_preemptions_total"] >= 1
    assert counts["serve_kv_pages_shared_total"] >= 4
    victim = [r for r in finished if r.preemptions]
    assert victim and any(r.shared_tokens >= 32 for r in victim)


# -- set_weights x shared pages (multi-tenant) --------------------------------

def _tiny_pair():
    jcfg = JaxModelConfig(
        **TINY, dtype=jnp.float32,
        xbar=JaxEngine(tile_rows=32, tile_cols=32, mode="deepnet",
                       quant=JaxQuant(**TINY_QUANT)))
    tcfg = ModelConfig(
        **TINY, dtype=torch.float32,
        xbar=EngineConfig(tile_rows=32, tile_cols=32, mode="deepnet",
                          quant=QuantConfig(**TINY_QUANT)))
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    kw = dict(n_slots=2, max_len=16, page_size=4, kv_pages=8,
              prefix_share=True)
    return {"ref": jserve.BatchScheduler(jm, jp, tenants={"A": jp, "B": jp},
                                         **kw),
            "port": tserve.BatchScheduler(tm, tp, tenants={"A": tp, "B": tp},
                                          **kw)}


def test_set_weights_budget_shrink_below_shared_usage_gates_new_only():
    """Shrinking tenant B's page budget below its usage, some of it
    shared, evicts nothing: residents keep their pages and decode, only
    new admissions wait, and the reports split owned and shared pages —
    each step's pool equal to the reference's."""
    scheds = _tiny_pair()
    v = TINY["vocab"]
    head = _prompt(700, v, 8)
    made = {k: {} for k in scheds}

    def submit(rid, prompt, max_new):
        for k, s in scheds.items():
            cls = jserve.Request if k == "ref" else tserve.Request
            made[k][rid] = cls(rid=rid, prompt=prompt, max_new=max_new,
                               model_id="B")
            s.submit(made[k][rid])

    done = {k: {} for k in scheds}

    def step():
        for k, s in scheds.items():
            done[k].update({r.rid: list(r.out) for r in s.step()})
        assert _pool_state(scheds["port"], "B") == _pool_state(
            scheds["ref"], "B")

    submit(0, head, 6)
    for _ in range(3):                     # prefill (2 chunks) + register
        step()
    submit(1, np.concatenate([head, _prompt(701, v, 2)]), 6)
    step()
    sched = scheds["port"]
    pool = sched._lanes["B"].pool
    assert pool.pages_shared == 2          # rid 1 aliased rid 0's head
    used = pool.pages_in_use
    pages_before = {r: pool.row_pages(r) for r in range(2)}
    for s in scheds.values():
        s.set_weights({"A": 3.0, "B": 1.0})
    assert pool.budget < used
    b0, b1 = made["port"][0], made["port"][1]
    out0, out1 = len(b0.out), len(b1.out)
    step()
    assert {r: pool.row_pages(r) for r in range(2)} == pages_before
    assert len(b0.out) == out0 + 1 and len(b1.out) == out1 + 1
    assert sched.kv_report() == scheds["ref"].kv_report()
    assert sched.qos_report() == scheds["ref"].qos_report()
    rep, qrep = sched.kv_report()["B"], sched.qos_report()["B"]
    assert rep["pages_in_use"] == used and rep["pages_shared"] == 2
    assert rep["pages_owned"] == used - 2
    assert qrep["pages_shared"] == 2 and qrep["pages_owned"] == used - 2
    assert qrep["pages_in_use"] > qrep["page_budget"]
    submit(2, _prompt(702, v, 5), 2)
    step()
    assert made["port"][2] in sched._lanes["B"].queue   # queued, not dropped
    for _ in range(60):
        step()
        assert pool.conservation_ok()
        if len(done["port"]) == 3:
            break
    assert set(done["port"]) == {0, 1, 2}
    assert done["port"] == done["ref"]
    assert pool.pages_in_use == 0
    assert _counts(sched, "B") == _counts(scheds["ref"], "B")


def test_flags_require_paged_kv(smoke):
    jm, jp = smoke["ref"]
    tm, tp = smoke["port"]
    for kw in (dict(prefix_share=True), dict(preemption=True)):
        with pytest.raises(ValueError) as want:
            jserve.BatchScheduler(jm, jp, n_slots=2, max_len=32, kv="dense",
                                  **kw)
        with pytest.raises(ValueError) as got:
            tserve.BatchScheduler(tm, tp, n_slots=2, max_len=32, kv="dense",
                                  **kw)
        assert str(got.value) == str(want.value)


# -- the CLI ------------------------------------------------------------------

CLI = ["--smoke", "--device", "cpu", "--slots", "3", "--prompt-len", "5",
       "--max-new", "4", "--max-len", "32"]


def _cli(argv):
    rep = serve_cli.main(CLI + argv)
    return rep, {r.rid: list(r.out) for r in rep["requests"]}


def test_cli_prefix_share_streams_equal_the_unshared_serve(capsys):
    argv = ["--requests", "5", "--common-prefix", "12", "--stagger", "6"]
    rep, streams = _cli(argv + ["--prefix-share"])
    out = capsys.readouterr().out
    counts = rep["kv_counts"]
    assert counts["serve_kv_shared_tokens_total"] > 0
    assert (f"prefix sharing: {counts['serve_kv_pages_shared_total']} pages "
            f"aliased, {counts['serve_kv_shared_tokens_total']} prompt "
            f"tokens skipped, {counts['serve_kv_cow_total']} copy-on-write "
            f"page copies") in out
    _, plain = _cli(argv)
    assert "prefix sharing:" not in capsys.readouterr().out
    assert streams == plain and len(streams) == 5


def test_cli_preemption_streams_equal_a_serve_with_ample_pages(capsys):
    argv = ["--requests", "6", "--prompt-len", "12"]
    rep, streams = _cli(argv + ["--kv-pages", "4", "--preemption"])
    out = capsys.readouterr().out
    n = rep["kv_counts"]["serve_preemptions_total"]
    assert n > 0
    assert (f"preemption: {n} evictions, "
            f"{sum(r.preemptions for r in rep['requests'])} re-admissions, "
            f"zero dropped requests") in out
    assert all(r.qos == (2.0 if r.rid >= 3 else 1.0)
               for r in rep["requests"])
    _, ample = _cli(argv)
    assert streams == ample and len(streams) == 6


@pytest.mark.parametrize("flag", ["--prefix-share", "--preemption"])
def test_cli_policies_need_paged_kv(flag):
    with pytest.raises(SystemExit, match="--prefix-share/--preemption "
                       "operate on the page pool; they require --kv paged"):
        serve_cli.main(CLI + ["--kv", "dense", flag])
