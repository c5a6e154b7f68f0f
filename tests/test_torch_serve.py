"""The slice as a whole: the port's BatchScheduler against the reference's.

Contract: on the SMOKE config at float32 with the crossbar backend and a
paged KV cache, the same params (carried across by ``bridge``) and the
same prompts give IDENTICAL greedy token streams in both packages — and
in the port with and without its kernel path (on the CPU the wrappers
run their plain versions), paged or dense, and through the streamed
attention lane.  A divergence would be a fault unless shown to be a
logit near-tie.

The window step runs over static buffers (the protocol the card's CUDA
graph replays; on the CPU it runs eagerly, ``capture=False``): it counts
one trace per built closure, none per prompt mix, and a new one after a
new params tree.  Its dense K/V append has fixed shapes and equals the
boolean-mask append it replaced.

At bfloat16 (docs/PORT.md): the prefill logits within
``BF16_LOGIT_BOUND`` of the reference's run eagerly, each serve step's
logits within ``BF16_JIT_LOGIT_BOUND`` of the reference's jitted step
while the steps' inputs agree, and a greedy stream may leave the
reference's only where the reference's top-2 logit margin, in float32, is
below one bfloat16 ulp of its top logit, the port's token being the
runner-up.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve.engine import BatchScheduler as JaxScheduler  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.paged_attention import paged_path_calls  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import BatchScheduler, Request  # noqa: E402

PROMPT_LENS = (5, 11, 3)
MAX_NEW = 4
#: bf16 logits (|logit| < 5), port vs the reference run eagerly: measured
#: 0.0078 with SiLU rounded as the reference rounds it, 0.0625 without (the
#: 8-bit input quantizer turns a one-ulp activation difference into a code)
BF16_LOGIT_BOUND = 0.02
#: ... vs the reference's jitted serve step, where XLA keeps float32
#: intermediates inside fused bf16 ops: measured 0.109 over the 9 steps
BF16_JIT_LOGIT_BOUND = 0.25


def _prompts():
    rng = np.random.default_rng(0)
    vocab = get_config("qwen3-4b", smoke=True).vocab
    return [rng.integers(0, vocab - 1, n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(sched, make_request, prompts=None):
    prompts = _prompts() if prompts is None else prompts
    for i, p in enumerate(prompts):
        sched.submit(make_request(rid=i, prompt=p, max_new=MAX_NEW))
    done, steps = [], 0
    while len(done) < len(prompts) and steps < 100:
        done += sched.step()
        steps += 1
    return {r.rid: list(r.out) for r in done}


def _port_model(**over):
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True),
                              backend="crossbar", dtype=torch.float32,
                              **over)
    return build_model(cfg, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The reference's streams and params (one JAX run per module)."""
    cfg = dataclasses.replace(jax_config("qwen3-4b", smoke=True),
                              backend="crossbar", dtype=jnp.float32)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    streams = _serve(JaxScheduler(model, params, n_slots=2, max_len=32),
                     lambda prompt, **kw: JaxRequest(
                         prompt=jnp.asarray(prompt), **kw))
    return {"streams": streams, "params": jax.device_get(params),
            "fingerprint": model.executor.fingerprint()}


def _recording(model, store):
    """``model`` whose decode_step hands (tokens, float32 logits) of every
    step to ``store``."""
    inner = model.decode_step

    def decode_step(params, tokens, cache):
        logits, cache = inner(params, tokens, cache)
        store(tokens, logits)
        return logits, cache

    return dataclasses.replace(model, decode_step=decode_step)


@pytest.fixture(scope="module")
def reference_bf16():
    """The reference's bf16 crossbar serve: streams, each step's inputs
    and logits (a host callback inside its jitted step), params."""
    cfg = dataclasses.replace(jax_config("qwen3-4b", smoke=True),
                              backend="crossbar", dtype=jnp.bfloat16)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    steps = []

    def store(tokens, logits):
        jax.debug.callback(
            lambda t, lg: steps.append((np.asarray(t), np.asarray(lg))),
            tokens, logits.astype(jnp.float32), ordered=True)

    streams = _serve(JaxScheduler(_recording(model, store), params,
                                  n_slots=2, max_len=32),
                     lambda prompt, **kw: JaxRequest(
                         prompt=jnp.asarray(prompt), **kw))
    return {"streams": streams, "steps": steps, "model": model,
            "params": params}


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


def test_bf16_crossbar_serve_matches_the_reference(reference_bf16):
    ref = reference_bf16
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True),
                              backend="crossbar", dtype=torch.bfloat16)
    steps = []
    model = _recording(build_model(cfg, device="cpu"),
                       lambda t, lg: steps.append((t.numpy().copy(),
                                                   lg.float().numpy())))
    params = params_from_numpy(jax.device_get(ref["params"]), "cpu")
    streams = _serve(BatchScheduler(model, params, n_slots=2, max_len=32),
                     Request)
    compared = 0
    for (t_ref, lg_ref), (t_port, lg_port) in zip(ref["steps"], steps):
        if not np.array_equal(t_ref, t_port):
            break                 # a stream left the reference's
        assert np.abs(lg_port - lg_ref).max() <= BF16_JIT_LOGIT_BOUND
        compared += 1
    assert compared > 0
    jm = ref["model"]
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab - 1, (2, 8)).astype(np.int32)
    want, _ = jm.prefill(ref["params"], {"tokens": jnp.asarray(tokens)},
                         jm.init_cache(2, 32))
    got, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                           model.init_cache(2, 32))
    assert (np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
            <= BF16_LOGIT_BOUND)
    for rid, want in ref["streams"].items():
        got = streams[rid]
        assert len(got) == MAX_NEW
        t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                 None)
        if t is None:
            continue
        # a divergence: the reference's logits after the common prefix
        prefix = np.concatenate([_prompts()[rid], want[:t]]).astype(
            np.int32)
        lg, _ = jm.prefill(ref["params"],
                           {"tokens": jnp.asarray(prefix)[None]},
                           jm.init_cache(1, 32))
        lg = np.asarray(lg.astype(jnp.float32))[0, -1]
        top2 = np.argsort(lg)[-2:]
        margin = lg[top2[1]] - lg[top2[0]]
        assert got[t] in top2 and margin < _bf16_ulp(lg[top2[1]]), (
            f"request {rid} left the reference's stream at token {t} with "
            f"a top-2 margin of {margin:.3g}")


@pytest.mark.parametrize("use_kernel,stream_pages", [
    pytest.param(False, 0, id="False"), pytest.param(True, 0, id="True"),
    pytest.param(True, 1, id="streamed")])
def test_port_token_streams_equal_the_reference(reference, use_kernel,
                                                stream_pages):
    over = {}
    if use_kernel:
        over = dict(paged_kernel=True,
                    xbar=dataclasses.replace(
                        get_config("qwen3-4b", smoke=True).xbar,
                        use_kernel=True))
    if stream_pages:   # every decode step through the streamed lane
        over.update(paged_stream_pages=stream_pages, paged_block_pages=1)
    model = _port_model(**over)
    params = params_from_numpy(reference["params"], "cpu")
    streamed = paged_path_calls["paged_streamed"]
    streams = _serve(BatchScheduler(model, params, n_slots=2, max_len=32),
                     Request)
    assert streams == reference["streams"]
    assert (paged_path_calls["paged_streamed"] > streamed) == bool(
        stream_pages)
    assert all(len(s) == MAX_NEW for s in streams.values())
    assert model.executor.fingerprint() == reference["fingerprint"]


def test_port_paged_streams_equal_port_dense(reference):
    params = params_from_numpy(reference["params"], "cpu")
    paged = _serve(BatchScheduler(_port_model(), params, n_slots=2,
                                  max_len=32, kv="paged"), Request)
    dense = _serve(BatchScheduler(_port_model(), params, n_slots=2,
                                  max_len=32, kv="dense"), Request)
    assert paged == dense == reference["streams"]


def test_scheduler_reclaims_pages_and_reports_telemetry(reference):
    params = params_from_numpy(reference["params"], "cpu")
    sched = BatchScheduler(_port_model(), params, n_slots=2, max_len=32)
    _serve(sched, Request)
    rep = sched.kv_report()["A"]
    assert rep["conservation_ok"] and rep["pages_in_use"] == 0
    m = sched.metrics
    assert m.total("serve_requests_completed_total") == len(PROMPT_LENS)
    assert m.total("serve_tokens_total") == len(PROMPT_LENS) * MAX_NEW
    assert m.total("serve_device_read_seconds_total") > 0
    assert len(sched.tracer.spans("request")) == len(PROMPT_LENS)


def test_later_slices_raise_not_implemented(reference):
    params = params_from_numpy(reference["params"], "cpu")
    model = _port_model()
    # multiplexing (tenants=...) is ported: tests/test_torch_multiplex.py
    for kw in (dict(prefix_share=True), dict(preemption=True)):
        with pytest.raises(NotImplementedError, match="later slice"):
            BatchScheduler(model, params, n_slots=2, max_len=32, **kw)


@pytest.mark.parametrize("extra", [
    [], ["--use-kernel", "--stream-pages", "2", "--block-pages", "2"],
    ["--use-kernel", "--mode-policy", "auto"]])
def test_cli_serves_on_the_cpu(extra, capsys):
    rep = serve_cli.main(["--smoke", "--backend", "crossbar", "--device",
                          "cpu", "--requests", "3", "--slots", "2",
                          "--prompt-len", "6", "--max-new", "3",
                          "--max-len", "32", *extra])
    assert rep["tokens"] == 9 and len(rep["requests"]) == 3
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out
    if "--stream-pages" in extra:
        assert "streamed=" in out and "fallback=0" in out
    if "--mode-policy" in extra:
        # SMOKE widths are one 128-row tile: nothing pairs, all deep-net
        assert rep["mode_report"]["aggregate"]["n_deepnet"] == 15
        assert "mode policy: 0 expansion-fused / 15 deep-net" in out


def test_entry_points_without_cuda_raise_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-4b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--smoke", "--requests", "1"])
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_copy_paged_page_matches_reference():
    rng = np.random.default_rng(4)
    pools = {k: rng.standard_normal((2, 6, 4, 2, 8)).astype(np.float32)
             for k in ("k", "v")}
    ref = jax.device_get(jax_layers.paged_copy_page(
        {k: jnp.asarray(v) for k, v in pools.items()}, jnp.int32(2),
        jnp.int32(5)))
    port = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    out = port_layers.paged_copy_page(port, 2, 5)
    for k in ("k", "v"):
        assert np.array_equal(out[k].numpy(), np.asarray(ref[k]))


def _traces():
    reg = obs.registry()
    return (reg.total("serve_jit_traces_total", closure="decode"),
            reg.total("serve_jit_retraces_total", closure="decode"))


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_static_buffer_step_traces_once_and_equals_the_reference(
        reference, kv):
    params = params_from_numpy(reference["params"], "cpu")
    sched = BatchScheduler(_port_model(), params, n_slots=2, max_len=32,
                           kv=kv, capture=False)
    cache = sched._lanes["A"].cache["layers"]
    storage = {k: t.data_ptr() for k, t in cache.items()}
    before = _traces()
    assert _serve(sched, Request) == reference["streams"]
    # a second prompt mix: other lengths, the same compiled window
    rng = np.random.default_rng(7)
    mix = [rng.integers(0, 383, n).astype(np.int32) for n in (9, 2, 14, 6)]
    assert len(_serve(sched, Request, mix)) == len(mix)
    traces, retraces = _traces()
    assert (traces - before[0], retraces - before[1]) == (1, 0)
    assert sched.capture_report()["A"] == {
        "capture": False, "captures": 0, "replays": 0,
        "eager_steps": sched._lanes["A"].decode.stats["eager_steps"],
        "launches_per_replay": {}}
    # the cache is the step's static storage: written in place, never
    # replaced
    assert sched._lanes["A"].cache["layers"] is cache
    assert {k: t.data_ptr() for k, t in cache.items()} == storage


def test_new_params_tree_builds_a_new_closure(reference):
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True),
                              dtype=torch.float32)
    params = params_from_numpy(reference["params"], "cpu")
    sched = BatchScheduler(build_model(cfg, device="cpu"), params,
                           n_slots=2, max_len=32)
    before = _traces()
    first = _serve(sched, Request)
    # the same values in new tensors: a new tree, so a new closure
    sched._lanes["A"].params = params_from_numpy(reference["params"], "cpu")
    assert _serve(sched, Request) == first
    traces, retraces = _traces()
    assert (traces - before[0], retraces - before[1]) == (2, 0)
    # on the crossbar backend a new tree would re-program the tiles:
    # refused (a new tree goes through begin_hot_swap)
    xsched = BatchScheduler(_port_model(), params, n_slots=2, max_len=32)
    xsched._lanes["A"].params = params_from_numpy(reference["params"], "cpu")
    xsched.submit(Request(rid=0, prompt=_prompts()[0], max_new=1))
    with pytest.raises(RuntimeError, match="different params tree"):
        xsched.step()


def test_capture_needs_the_card():
    with pytest.raises(ValueError, match="CUDA graph"):
        BatchScheduler(_port_model(), None, n_slots=2, max_len=32,
                       capture=True)


def _mask_append(c, x, pos):
    """The boolean-mask append the fixed-shape one replaced."""
    b, sq = x.shape[:2]
    b_idx = torch.arange(b)[:, None].expand(b, sq)
    s_idx = pos[:, None].to(torch.int64) + torch.arange(sq)[None]
    keep = s_idx < c.shape[1]
    c[b_idx[keep], s_idx[keep]] = x[keep].to(c.dtype)


@pytest.mark.parametrize("depth,sq", [(8, 4), (8, 1), (5, 7)])
def test_dense_append_equals_the_mask_append(depth, sq):
    rng = np.random.default_rng(depth * 10 + sq)
    # fill positions: inside, ending on the last slot, running past the
    # depth, starting on the last slot, starting past it
    pos = torch.tensor([0, depth - sq, depth - 2, depth - 1, depth,
                        depth + 3], dtype=torch.int32).clamp(min=0)
    b = pos.shape[0]
    cache = torch.from_numpy(
        rng.standard_normal((b, depth, 2, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, sq, 2, 8))
                         .astype(np.float32))
    want = cache.clone()
    _mask_append(want, x, pos)
    for dtype in (torch.float32, torch.bfloat16):
        got = cache.to(dtype)
        port_layers.dense_append(got, x, pos)
        ref = cache.to(dtype)
        _mask_append(ref, x, pos)
        assert torch.equal(got, ref)
    got = cache.clone()
    port_layers.dense_append(got, x, pos)
    assert torch.equal(got, want)
