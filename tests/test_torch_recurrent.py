"""Port parity: the recurrent families, RWKV6 and the Zamba2 hybrid.

Contract (docs/PORT.md, "VLM, encoder-decoder and recurrent families"):
* ``lin_attn.chunked_gla`` is within 2^-20 x max(1, max|y|) of the
  reference's ``chunked_gla`` and of ``naive_gla`` (outputs and final
  state, float32), with and without RWKV6's ``u`` bonus, with an incoming
  ``state0``, and with S not a multiple of ``chunk``: the inter-chunk
  combination is a loop where the reference runs an associative scan,
  so the two associate differently;
* at SMOKE and float32 the same params (carried across by ``bridge``) and
  prompts give IDENTICAL ``greedy_generate`` streams for rwkv6-3b and
  zamba2-1.2b, and prefill(S) + decode(1) gives the last-token logits of
  prefill(S + 1) within 2e-2 (the reference's own check, at bf16);
* ``layers.sigmoid`` and ``layers.softplus`` equal ``jax.nn.sigmoid`` and
  ``jax.nn.softplus`` BITWISE on every bfloat16 pattern but those whose
  result is subnormal (XLA flushes it to zero), and within 2^-21
  relative at float32 but where the same flush happens;
* the cache's dtypes follow the reference's: the token-shift and conv
  carries start bfloat16 and take the activations' dtype after a call,
  the GLA and SSM states are float32 throughout.
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
from repro.models import lin_attn as jax_lin  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve.engine import greedy_generate as jax_generate  # noqa: E402
from repro_torch.bridge import params_from_numpy, torch_dtype  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers, lin_attn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import greedy_generate  # noqa: E402

ARCHS = ["rwkv6-3b", "zamba2-1.2b"]
B, S, MAX_NEW = 2, 7, 5
GLA_BOUND = 2.0 ** -20


# -- chunked GLA --------------------------------------------------------------

def _gla_inputs(s, seed=0, b=2, h=3, dk=8, dv=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    k = (rng.standard_normal((b, s, h, dk)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    log_w = -np.exp(rng.standard_normal((b, s, h, dk)) - 1).astype(
        np.float32)
    u = (rng.standard_normal((h, dk)) * 0.3).astype(np.float32)
    state0 = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    return q, k, v, log_w, u, state0


@pytest.mark.parametrize("s,chunk", [(32, 8), (29, 8), (5, 8)])
@pytest.mark.parametrize("use_u", [False, True])
@pytest.mark.parametrize("use_state0", [False, True])
def test_chunked_gla_within_its_bound(s, chunk, use_u, use_state0):
    q, k, v, log_w, u, state0 = _gla_inputs(s)
    u = u if use_u else None
    state0 = state0 if use_state0 else None

    def jx(a):
        return None if a is None else jnp.asarray(a)

    def tx(a):
        return None if a is None else torch.from_numpy(a)

    ref_y, ref_st = jax_lin.chunked_gla(jx(q), jx(k), jx(v), jx(log_w),
                                        jx(u), chunk=chunk,
                                        state0=jx(state0))
    nai_y, nai_st = jax_lin.naive_gla(jx(q), jx(k), jx(v), jx(log_w), jx(u),
                                      state0=jx(state0))
    y, st = lin_attn.chunked_gla(tx(q), tx(k), tx(v), tx(log_w), tx(u),
                                 chunk=chunk, state0=tx(state0))
    p_nai_y, p_nai_st = lin_attn.naive_gla(tx(q), tx(k), tx(v), tx(log_w),
                                           tx(u), state0=tx(state0))
    assert y.shape == (2, s, 3, 8) and st.shape == (2, 3, 8, 8)
    for got, wants in ((y, (ref_y, nai_y, p_nai_y)),
                       (st, (ref_st, nai_st, p_nai_st))):
        for want in wants:
            want = np.asarray(want)
            scale = max(1.0, float(np.abs(want).max()))
            assert np.abs(got.numpy() - want).max() <= GLA_BOUND * scale


def test_decode_step_continues_the_chunked_state():
    """One ``gla_decode_step`` after ``chunked_gla`` over S equals the
    naive recurrence over S + 1, in both read orders."""
    q, k, v, log_w, u, _ = _gla_inputs(13, seed=4)
    t = [torch.from_numpy(a) for a in (q, k, v, log_w)]
    for bonus in (None, torch.from_numpy(u)):
        _, st = lin_attn.chunked_gla(*(a[:, :12] for a in t), bonus,
                                     chunk=4)
        y, st = lin_attn.gla_decode_step(*(a[:, 12] for a in t), st,
                                         bonus)
        ny, nst = lin_attn.naive_gla(*t, bonus)
        assert torch.allclose(y, ny[:, 12], atol=1e-5)
        assert torch.allclose(st, nst, atol=1e-5)


# -- the families against the reference ---------------------------------------

def _tokens(vocab, shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab - 1, shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    arch = request.param
    cfg = dataclasses.replace(jax_config(arch, smoke=True),
                              dtype=jnp.float32)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = _tokens(cfg.vocab, (B, S))
    streams = jax_generate(model, params, {"tokens": jnp.asarray(toks)},
                           MAX_NEW)
    return {"arch": arch, "tokens": toks, "streams": np.asarray(streams),
            "params": jax.device_get(params)}


def test_streams_equal_the_reference(reference):
    cfg = dataclasses.replace(get_config(reference["arch"], smoke=True),
                              dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(reference["params"], "cpu")
    got = greedy_generate(model, params,
                          {"tokens": torch.from_numpy(reference["tokens"])},
                          MAX_NEW)
    assert np.array_equal(got.numpy(), reference["streams"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Last-token logits of prefill(S + 1) == prefill(S) + decode(1), at
    the config's own dtype (bfloat16), as the reference checks."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(_tokens(cfg.vocab, (B, S + 1), seed=1))
    lg1, c1 = model.prefill(params, {"tokens": toks[:, :S]},
                            model.init_cache(B, S + 1))
    lg2, _ = model.decode_step(params, toks[:, S:], c1)
    lg_full, _ = model.prefill(params, {"tokens": toks},
                               model.init_cache(B, S + 1))
    assert lg2.shape == (B, 1, cfg.padded_vocab)
    assert torch.allclose(lg2.float(), lg_full.float(), atol=2e-2)


def _flat(tree, prefix=""):
    """Nested dicts -> {dotted path: leaf}."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cache_dtypes_follow_the_reference(arch, dtype):
    """Every cache leaf's dtype at init, after prefill and after a decode
    step is the reference's."""
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               dtype=getattr(jnp, dtype))
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=getattr(torch, dtype))
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.device_get(jp), "cpu")
    toks = _tokens(cfg.vocab, (B, S))
    j_cache = jm.init_cache(B, S + 1)
    cache = model.init_cache(B, S + 1)

    def same(jc, tc):
        want = {k: torch.int32 if np.dtype(a.dtype) == np.int32
                else torch_dtype(a.dtype)
                for k, a in _flat(jax.device_get(jc)).items()}
        assert {k: t.dtype for k, t in _flat(tc).items()} == want

    same(j_cache, cache)
    tok = jnp.asarray(toks[:, :1])
    _, j_cache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, j_cache)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                             cache)
    same(j_cache, cache)
    _, j_cache = jm.decode_step(jp, tok, j_cache)
    _, cache = model.decode_step(params, torch.from_numpy(toks[:, :1]),
                                 cache)
    same(j_cache, cache)


# -- the reference's activations ----------------------------------------------

def _bf16_patterns():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    return bits.view(ml_dtypes.bfloat16)


ACTS = {"sigmoid": (layers.sigmoid, jax.jit(jax.nn.sigmoid)),
        "softplus": (layers.softplus, jax.jit(jax.nn.softplus))}
#: finite bf16 patterns whose result is subnormal in the port (XLA
#: flushes it to zero): -87.5 to -88.5 for sigmoid, to -92.5 for softplus
N_FLUSHED = {"sigmoid": 3, "softplus": 11}


def _flushed(got, want):
    """Where XLA flushed a subnormal result to zero and torch kept it."""
    return (want == 0) & (np.abs(got) > 0) & (np.abs(got) < 2.0 ** -126)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_activation_bitwise_on_bf16_patterns(act):
    port, ref = ACTS[act]
    x = _bf16_patterns()
    want = np.asarray(ref(jnp.asarray(x)))
    got = port(torch.from_numpy(x.view(np.int16)).view(torch.bfloat16))
    got = got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    g32, w32 = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = ((got.view(np.uint16) == want.view(np.uint16))
            | (np.isnan(g32) & np.isnan(w32)))
    flushed = _flushed(g32, w32)
    assert np.all(same | flushed)
    assert flushed.sum() == N_FLUSHED[act]


@pytest.mark.parametrize("act", sorted(ACTS))
def test_activation_at_float32(act):
    port, ref = ACTS[act]
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(100_000) * 3,
                        np.linspace(-80, 80, 100_001),
                        rng.standard_normal(4000) * 1e4]).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(x)))
    got = port(torch.from_numpy(x)).numpy()
    assert np.all((np.abs(got - want) <= 2.0 ** -21 * np.abs(want))
                  | _flushed(got, want))
