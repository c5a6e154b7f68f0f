"""Port parity: the fp8 KV cache (``ModelConfig(kv_dtype=float8_e4m3fn)``)
and the wider ``stream_linear`` codes against the reference.

Contract (docs/PORT.md, "fp8 KV cache"):
* the cache cast (``layers.cache_cast``) writes the BYTES
  ``jnp.astype(jnp.float8_e4m3fn)`` writes: every bf16 bit pattern, and
  float32 values at and around 448, 464 and 480, the subnormals, +-inf
  and NaN (JAX gives NaN past 464 where torch saturates);
* with the same fp8 bytes, ``_sdpa`` and both plain paged versions agree
  with the reference's ``_sdpa``, ``paged_attention_ref`` and streamed
  kernel (interpret mode) to 1e-5 x max|out| at float32 q (as
  tests/test_torch_paged_attention.py) and 2e-2 at bfloat16 q (the
  weights and outputs round to bf16, unit roundoff 3.9e-3);
* greedy streams of the port's ``BatchScheduler`` at ``dtype=float32,
  kv_dtype=float8_e4m3fn`` EQUAL the reference's, paged and dense; dense
  EQUALS paged at fp8 (as tests/test_paged_serving.py asserts for the
  reference); a prefix-sharing serve at fp8 keeps the reference's pool
  state and counters after every step, and its copy-on-write moves fp8
  pages byte for byte;
* ``stream_linear`` past 8 weight bits: code planes EQUAL the
  reference's, and the plain version within 4 float32 ulps of the
  largest output of the reference's ``deepnet_stream_ref``.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.kernels.deepnet_stream import ref as jds_ref  # noqa: E402
from repro.kernels.paged_attention import kernel as jkernel  # noqa: E402
from repro.kernels.paged_attention import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve import engine as jserve  # noqa: E402
from repro_torch.bridge import params_from_numpy, torch_dtype  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels.crossbar_mac import ref as tmac  # noqa: E402
from repro_torch.kernels.deepnet_stream import ops as tops  # noqa: E402
from repro_torch.kernels.deepnet_stream import ref as tds_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ref as tref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import engine as tserve  # noqa: E402

F8 = ml_dtypes.float8_e4m3fn
TF8 = torch.float8_e4m3fn
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _close(a, b, rtol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() <= rtol * max(np.abs(a).max(), 1e-30)


# -- the cache cast -----------------------------------------------------------

def test_torch_dtype_maps_the_reference_fp8():
    assert torch_dtype(jnp.float8_e4m3fn) == TF8
    assert torch_dtype(jnp.bfloat16) == torch.bfloat16


def test_cache_cast_equals_jax_on_every_bf16_pattern():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    want = np.asarray(jnp.asarray(bits.view(ml_dtypes.bfloat16)).astype(
        jnp.float8_e4m3fn)).view(np.uint8)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    got = tlayers.cache_cast(x, TF8).view(torch.uint8).numpy()
    # the trap the helper exists for: a plain cast saturates
    plain = x.to(TF8).view(torch.uint8).numpy()
    assert (plain != want).sum() > 30000
    assert np.array_equal(got, want), np.flatnonzero(got != want)[:8]


def test_cache_cast_equals_jax_at_float32_edges():
    f32 = np.float32
    near = [448, 464, 480, 240, 256, 2.0 ** -6, 2.0 ** -9, 2.0 ** -10]
    vals = [v for c in near for v in (
        f32(c), np.nextafter(f32(c), f32(0)), np.nextafter(f32(c), f32(1e9)))]
    vals += [470.0, 1e4, 3.4e38, 1e-30, 0.0, 3 * 2.0 ** -11,
             2.0 ** -10 * 1.0001, np.inf, np.nan]
    vals = np.array(vals, np.float32)
    vals = np.concatenate([vals, -vals])
    rng = np.random.default_rng(0)
    vals = np.concatenate([vals, rng.uniform(-600, 600, 4096).astype(f32),
                           (rng.standard_normal(4096) * 2.0 ** -8).astype(
                               f32)])
    want = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn)).view(
        np.uint8)
    got = tlayers.cache_cast(torch.from_numpy(vals), TF8).view(
        torch.uint8).numpy()
    assert np.array_equal(got, want), vals[got != want][:8]
    # the boundary: 464 rounds to 448, anything past it is NaN
    assert got[0:3].tolist() == [0x7E, 0x7E, 0x7E]         # 448 and around
    assert got[3:6].tolist() == [0x7E, 0x7E, 0x7F]         # 464 and around


# -- attention at fp8 ---------------------------------------------------------

def _fp8_case(seed, dtype, b=3, sq=2, hq=4, kv=2, hd=16, ps=4, p_seq=4,
              n_pages=9):
    """The paged case of tests/test_torch_paged_attention.py with fp8
    pools: q in numpy float32 (rounded to bf16 where asked) and the pools
    as fp8 bytes, which both packages take bit for bit."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    if dtype == torch.bfloat16:
        q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    kp = (rng.standard_normal((n_pages + 1, ps, kv, hd)) * 3).astype(F8)
    vp = (rng.standard_normal((n_pages + 1, ps, kv, hd)) * 3).astype(F8)
    kp[0] = vp[0] = 0
    pt = np.zeros((b, p_seq), np.int32)
    pt[0, :3] = [1, 2, 3]
    pt[1, :2] = [1, 4]
    pt[2, :4] = [5, 6, 7, 8]
    kv_len = np.array([9, 6, 16], np.int32)[:b]
    q_off = kv_len - sq
    q_off[1] = 2
    return q, kp, vp, pt, kv_len, q_off


def _t(case, dtype):
    q, kp, vp, pt, kv_len, q_off = case
    return [torch.from_numpy(q).to(dtype),
            torch.from_numpy(kp.view(np.uint8)).view(TF8),
            torch.from_numpy(vp.view(np.uint8)).view(TF8),
            torch.from_numpy(pt), torch.from_numpy(kv_len),
            torch.from_numpy(q_off)]


def _j(case, dtype):
    q, kp, vp, pt, kv_len, q_off = case
    return [jnp.asarray(q).astype(JDT[dtype]), jnp.asarray(kp),
            jnp.asarray(vp), jnp.asarray(pt), jnp.asarray(kv_len),
            jnp.asarray(q_off)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sdpa_at_fp8_matches_the_reference(dtype):
    rng = np.random.default_rng(3)
    b, sq, sk, hq, kv, hd = 2, 3, 12, 4, 2, 16
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k = (rng.standard_normal((b, sk, kv, hd)) * 3).astype(F8)
    v = (rng.standard_normal((b, sk, kv, hd)) * 3).astype(F8)
    kv_len = np.array([12, 7], np.int32)
    q_off = kv_len - sq
    tcfg = tlayers.AttnConfig(d_model=hq * hd, n_heads=hq, n_kv=kv,
                              head_dim=hd)
    jcfg = jlayers.AttnConfig(d_model=hq * hd, n_heads=hq, n_kv=kv,
                              head_dim=hd)
    want = jlayers._sdpa(jnp.asarray(q).astype(JDT[dtype]), jnp.asarray(k),
                         jnp.asarray(v), jcfg, jnp.asarray(q_off),
                         kv_len=jnp.asarray(kv_len))
    tk = torch.from_numpy(k.view(np.uint8)).view(TF8)
    tv = torch.from_numpy(v.view(np.uint8)).view(TF8)
    got = tlayers._sdpa(torch.from_numpy(q).to(dtype), tk, tv, tcfg,
                        torch.from_numpy(q_off),
                        kv_len=torch.from_numpy(kv_len))
    assert got.dtype == dtype
    assert _close(np.asarray(want.astype(jnp.float32)), got.float().numpy(),
                  RTOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_paged_versions_at_fp8_match_the_reference(dtype):
    case = _fp8_case(4, dtype)
    args_t, args_j = _t(case, dtype), _j(case, dtype)
    want = np.asarray(jref.paged_attention_ref(*args_j).astype(jnp.float32))
    got = tref.paged_attention_ref(*args_t)
    assert got.dtype == dtype
    assert _close(want, got.float().numpy(), RTOL[dtype])
    for bp in (1, 2):
        want = np.asarray(jkernel.paged_attention_streamed(
            *args_j, interpret=True, block_pages=bp).astype(jnp.float32))
        got = tref.paged_attention_streamed_ref(*args_t, block_pages=bp)
        assert _close(want, got.float().numpy(), RTOL[dtype])
        split = tref.paged_attention_split_ref(*args_t, block_pages=bp,
                                               n_split=2)
        assert _close(want, split.float().numpy(), RTOL[dtype])


def test_plain_paged_version_at_fp8_equals_it_on_upcast_pages():
    """Upcasting is exact, so the plain version at fp8 IS the plain
    version on the pages upcast to q's type (what the card holds each
    kernel to, bit for bit)."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _t(_fp8_case(5, dtype), dtype)
        up = [args[0], args[1].to(dtype), args[2].to(dtype), *args[3:]]
        assert torch.equal(tref.paged_attention_ref(*args),
                           tref.paged_attention_ref(*up))
        assert torch.equal(tref.paged_attention_streamed_ref(*args),
                           tref.paged_attention_streamed_ref(*up))


def test_cache_writes_cast_as_the_reference():
    """The paged write and the dense append store cache_cast's bytes (NaN
    past 464), and the COW copy moves fp8 pages byte for byte."""
    cfg = tlayers.AttnConfig(d_model=16, n_heads=2, n_kv=1, head_dim=8)
    x = torch.tensor([1.0, 470.0, -500.0, 464.0, -3.3, 1e-3, 0.0, 9.0])
    c = tlayers.init_cache(cfg, 2, 4, dtype=TF8)
    win = x.reshape(1, 1, 1, 8).expand(2, 3, 1, 8).contiguous()
    tlayers.dense_append(c["k"], win, torch.tensor([0, 2], dtype=torch.int32))
    want = tlayers.cache_cast(x, TF8).view(torch.uint8)
    kb = c["k"].view(torch.uint8)
    assert torch.equal(kb[0, 0, 0], want) and torch.equal(kb[1, 3, 0], want)
    assert kb[0, 3].eq(0).all()                # row 0 wrote positions 0-2
    layers = {k: tlayers.paged_init_cache(cfg, 1, 8, 3, 4,
                                          dtype=TF8)[k][None]
              for k in ("k", "v")}
    layers["k"].view(torch.uint8)[0, 1] = torch.arange(32,
                                                       dtype=torch.uint8
                                                       ).reshape(4, 1, 8)
    tlayers.paged_copy_page(layers, 1, 3)
    assert torch.equal(layers["k"].view(torch.uint8)[0, 3],
                       layers["k"].view(torch.uint8)[0, 1])


# -- serving at fp8 -----------------------------------------------------------

PROMPT_LENS = (5, 11, 3)
MAX_NEW = 4


def _prompts(vocab, lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab - 1, n).astype(np.int32) for n in lens]


def _serve(sched, make_request, prompts, max_new=MAX_NEW):
    for i, p in enumerate(prompts):
        sched.submit(make_request(rid=i, prompt=p, max_new=max_new))
    done, steps = [], 0
    while len(done) < len(prompts) and steps < 200:
        done += sched.step()
        steps += 1
    return {r.rid: list(r.out) for r in done}


@pytest.fixture(scope="module")
def fp8_reference():
    """The reference's crossbar serve at float32 with an fp8 cache."""
    cfg = dataclasses.replace(jax_config("qwen3-4b", smoke=True),
                              backend="crossbar", dtype=jnp.float32,
                              kv_dtype=jnp.float8_e4m3fn)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab)
    streams = _serve(jserve.BatchScheduler(model, params, n_slots=2,
                                           max_len=32),
                     lambda prompt, **kw: jserve.Request(
                         prompt=jnp.asarray(prompt), **kw), prompts)
    return {"streams": streams, "params": jax.device_get(params),
            "prompts": prompts}


def _port(**over):
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True),
                              dtype=torch.float32, kv_dtype=TF8, **over)
    return build_model(cfg, device="cpu")


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_fp8_cache_streams_equal_the_reference(fp8_reference, kv):
    model = _port(backend="crossbar")
    params = params_from_numpy(fp8_reference["params"], "cpu")
    sched = tserve.BatchScheduler(model, params, n_slots=2, max_len=32,
                                  kv=kv)
    cache = sched._lanes["A"].cache["layers"]
    assert cache["k"].dtype == cache["v"].dtype == TF8
    streams = _serve(sched, tserve.Request, fp8_reference["prompts"])
    assert streams == fp8_reference["streams"]
    assert all(len(s) == MAX_NEW for s in streams.values())


def test_fp8_dense_streams_equal_paged():
    """At equal cache dtype the paged pool and the dense cache hold the
    same bytes, so the streams are identical (the reference's
    test_cache_dtype_streams_identical_across_storage_layouts), here at
    the SMOKE config's bfloat16 compute."""
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True),
                              kv_dtype=TF8)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    prompts = _prompts(cfg.vocab, (6, 13, 25), seed=600)
    dense = _serve(tserve.BatchScheduler(model, params, n_slots=3,
                                         max_len=32, kv="dense"),
                   tserve.Request, prompts, max_new=8)
    paged = _serve(tserve.BatchScheduler(model, params, n_slots=3,
                                         max_len=32, kv="paged"),
                   tserve.Request, prompts, max_new=8)
    assert dense == paged
    assert all(len(s) == 8 for s in paged.values())


COUNTERS = ("serve_kv_pages_shared_total", "serve_kv_shared_tokens_total",
            "serve_kv_cow_total", "serve_preemptions_total")


def _pool_state(sched):
    lane = sched._lanes["A"]
    pool, layers = lane.pool, lane.cache["layers"]
    return {"table": pool.table().tolist(), "free": list(pool._free),
            "ref": dict(pool._ref), "prefix_entries": pool.prefix_entries,
            "pt": np.asarray(layers["pt"][0]).tolist(),
            "len": np.asarray(layers["len"][0]).tolist()}


def test_fp8_prefix_sharing_keeps_the_references_pool_and_counts():
    """A prefix-sharing serve at fp8 (float32 compute) in lockstep with
    the reference's: pools, page tables and fill markers equal after every
    step, the four counters and the streams equal, and every
    copy-on-write leaves the destination page's fp8 bytes equal to the
    source's in every layer."""
    jcfg = dataclasses.replace(jax_config("qwen3_4b", smoke=True),
                               dtype=jnp.float32, kv_dtype=jnp.float8_e4m3fn)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = _port()
    copies = []
    inner = tm.copy_paged_page

    def checked_copy(cache, src, dst):
        out = inner(cache, src, dst)
        for key in ("k", "v"):
            pool = cache["layers"][key].view(torch.uint8)
            copies.append(torch.equal(pool[:, dst], pool[:, src]))
        return out

    tm = dataclasses.replace(tm, copy_paged_page=checked_copy)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    kw = dict(n_slots=2, max_len=32, page_size=8, prefix_share=True)
    scheds = {"ref": jserve.BatchScheduler(jm, jp, **kw),
              "port": tserve.BatchScheduler(tm, tp, **kw)}
    v = jcfg.vocab
    p0 = np.random.default_rng(42).integers(0, v - 1, 16).astype(np.int32)
    p1 = np.concatenate([p0[:12], np.random.default_rng(43).integers(
        0, v - 1, 8).astype(np.int32)])
    specs = [(0, p0, 10), (1, p1, 6)]
    stagger = [0, 5]
    done = {k: {} for k in scheds}
    for step in range(200):
        for i, (rid, p, n) in enumerate(specs):
            if stagger[i] == step:
                scheds["ref"].submit(jserve.Request(rid=rid, prompt=p,
                                                    max_new=n))
                scheds["port"].submit(tserve.Request(rid=rid, prompt=p,
                                                     max_new=n))
        for k, s in scheds.items():
            done[k].update({r.rid: list(r.out) for r in s.step()})
        assert _pool_state(scheds["port"]) == _pool_state(scheds["ref"]), \
            f"pools differ after step {step}"
        if len(done["port"]) == len(specs):
            break
    assert done["port"] == done["ref"] and len(done["port"]) == 2
    counts = {k: {n: int(s.metrics.total(n, tenant="A")) for n in COUNTERS}
              for k, s in scheds.items()}
    assert counts["port"] == counts["ref"]
    assert counts["port"]["serve_kv_cow_total"] == 1
    assert copies and all(copies)


# -- stream_linear past 8 weight bits -----------------------------------------

@pytest.mark.parametrize("w_bits,bpc", [(12, 1), (16, 2), (24, 1)])
def test_stream_linear_at_wide_weight_bits_matches_the_reference(w_bits,
                                                                 bpc):
    rng = np.random.default_rng(w_bits)
    k, n, rows = 64, 48, 32
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, k)).astype(np.float32)
    qk = dict(w_bits=w_bits, in_bits=8, adc_bits=10, bits_per_cell=bpc)
    kw = dict(qk, rows_per_adc=rows)
    jqc, tqc = jq.QuantConfig(**qk), tq.QuantConfig(**qk)
    # the program step: the cell-code planes equal the reference's
    ws = np.array(jq.weight_scales(jnp.asarray(w), jqc))
    qmax = 2.0 ** w_bits - 1
    jpos, jneg = jq.to_slices(jnp.clip(jnp.round(jnp.asarray(w) / ws),
                                       -qmax, qmax), jqc)
    pos, neg = tds_ref.quantize_codes(torch.from_numpy(w),
                                      torch.from_numpy(ws), w_bits=w_bits,
                                      bits_per_cell=bpc)
    assert pos.shape[0] == -(-w_bits // bpc)
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert np.array_equal(neg.numpy(), np.asarray(jneg))
    # the read: plain version against the reference's plain version
    x_int, x_scale = jq.quantize_inputs(jnp.asarray(x), jqc)
    x_int = np.asarray(x_int).astype(np.int32)
    want = np.asarray(jds_ref.deepnet_stream_ref(
        jnp.asarray(x_int), jnp.asarray(w), jnp.asarray(ws), **kw))
    got = tds_ref.deepnet_stream_ref(torch.from_numpy(x_int),
                                     torch.from_numpy(w),
                                     torch.from_numpy(ws), **kw).numpy()
    bound = 4 * np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= bound
    # and the exact code sums, which the card's kernel equals bit for bit
    codes = tmac.crossbar_mac_codes_ref(
        torch.from_numpy(x_int), pos, neg, in_bits=8, adc_bits=10,
        bits_per_cell=bpc, rows_per_adc=rows).numpy()
    assert np.abs(codes).max() >= 2 ** (w_bits - 2)
    # the entry point: stream_linear on the CPU
    tcfg = teng.EngineConfig(tile_rows=rows, tile_cols=64, mode="deepnet",
                             quant=tqc)
    y = tops.stream_linear(torch.from_numpy(x), torch.from_numpy(w),
                           tcfg).numpy()
    want_y = want * np.asarray(x_scale) * ws
    assert np.abs(y - want_y).max() <= 4 * np.spacing(
        np.float32(np.abs(want_y).max()))
