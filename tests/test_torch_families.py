"""Port parity: the VLM and encoder-decoder families, ``tie_embeddings``,
and the fixed-batch ``greedy_generate`` entry point.

Contract (docs/PORT.md, "VLM, encoder-decoder and recurrent families"):
* at SMOKE and float32 on the crossbar backend, with the kernel path on
  and off (on the CPU the wrappers run their plain versions), the same
  params (carried across by ``bridge``) and inputs made from a numpy seed
  give IDENTICAL ``greedy_generate`` streams in the port and the
  reference for qwen2-vl-72b (patch embeddings on a (t, h, w) grid whose
  three ids differ), whisper-base (encoder frames) and qwen3-4b under
  ``tie_embeddings``, and equal ``executor.fingerprint()``s: the encoder
  stack and the cross-attention's q/o are programmed, its K/V weights
  (``xattn.wk``/``wv``, read digitally by ``_cross_kv``) are not, and a
  tied model programs no head;
* the port's own ``init`` draws the reference's params tree (paths and
  shapes) for the four families and under ``tie_embeddings``;
* ``layernorm`` is within 2^-20 x max|out| of the reference at float32
  and equal at bfloat16; ``apply_mrope`` is within 1e-6 at float32 and
  is ``apply_rope`` bit for bit when t == h == w;
* ``greedy_generate`` equals the port's own prefill and decode steps and
  its ``BatchScheduler``'s stream (qwen3-4b SMOKE), as the reference's
  ``tests/test_serving.py`` checks the reference;
* the refusals are the reference's: the crossbar backend for the
  recurrent families, the paged scheduler for a model without a paged
  cache, and encdec's paged cache.
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
from repro.serve.engine import greedy_generate as jax_generate  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import (BatchScheduler, Request,  # noqa: E402
                                      greedy_generate, make_decode_step,
                                      make_prefill_step)

B, S, MAX_NEW = 2, 5, 4
#: (arch, tie_embeddings) of each parity case
CASES = {"qwen2-vl": ("qwen2-vl-72b", False),
         "whisper": ("whisper-base", False),
         "qwen3-4b-tied": ("qwen3-4b", True)}
#: the VLM's patches: 2 frames of a 2 x 3 grid
GRID_T, GRID_H, GRID_W = 2, 2, 3
ENC_FRAMES = 7


def _inputs(family, d_model, vocab):
    """Tokens, and the family's extra inputs, from a numpy seed; and the
    cache depth (explicit for the VLM, whose patches take slots)."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, vocab - 1, (B, S)).astype(np.int32)}
    max_len = None
    if family == "encdec":
        batch["enc_emb"] = rng.standard_normal(
            (B, ENC_FRAMES, d_model)).astype(np.float32)
    if family == "vlm":
        t, h, w = np.meshgrid(np.arange(GRID_T), np.arange(GRID_H),
                              np.arange(GRID_W), indexing="ij")
        vis = np.stack([t.ravel(), h.ravel(), w.ravel()], -1)
        text = np.repeat((vis.max() + 1 + np.arange(S))[:, None], 3, 1)
        thw = np.concatenate([vis, text])
        batch["positions_thw"] = np.repeat(thw[None], B, 0).astype(np.int32)
        batch["vis_emb"] = rng.standard_normal(
            (B, len(vis), d_model)).astype(np.float32)
        max_len = len(vis) + S + MAX_NEW
    return batch, max_len


def _port_cfg(arch, tie, use_kernel=False):
    base = get_config(arch, smoke=True)
    return dataclasses.replace(
        base, backend="crossbar", dtype=torch.float32, tie_embeddings=tie,
        xbar=dataclasses.replace(base.xbar, use_kernel=use_kernel))


@pytest.fixture(scope="module", params=sorted(CASES))
def reference(request):
    """The reference's streams, params, inputs and fingerprint."""
    arch, tie = CASES[request.param]
    cfg = dataclasses.replace(jax_config(arch, smoke=True),
                              backend="crossbar", dtype=jnp.float32,
                              tie_embeddings=tie)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch, max_len = _inputs(cfg.family, cfg.d_model, cfg.vocab)
    streams = jax_generate(model, params,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           MAX_NEW, max_len=max_len)
    return {"arch": arch, "tie": tie, "streams": np.asarray(streams),
            "params": jax.device_get(params), "batch": batch,
            "max_len": max_len,
            "fingerprint": model.executor.fingerprint()}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_streams_and_fingerprints_equal_the_reference(reference, use_kernel):
    cfg = _port_cfg(reference["arch"], reference["tie"], use_kernel)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(reference["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    got = greedy_generate(model, params, batch, MAX_NEW,
                          max_len=reference["max_len"])
    assert got.shape == (B, MAX_NEW) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), reference["streams"])
    assert model.executor.fingerprint() == reference["fingerprint"]
    names = set(model.executor.fingerprints())
    assert ("head" in names) is not cfg.tie_embeddings
    if cfg.family == "encdec":
        assert any(n.startswith("enc_blocks.") for n in names)
        assert any(n.endswith("xattn.wq") for n in names)
        assert any(n.endswith("xattn.wo") for n in names)
        assert not any(n.endswith(("xattn.wk", "xattn.wv")) for n in names)


def test_encdec_cache_holds_the_cross_kv():
    """Prefill stores each layer's cross K/V (the encoder's length, not
    the init's ``src_len``) and decode reads them back unchanged."""
    cfg = dataclasses.replace(get_config("whisper-base", smoke=True),
                              dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    batch, _ = _inputs("encdec", cfg.d_model, cfg.vocab)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cache = model.init_cache(B, S + 2, src_len=S)
    assert cache["cross_kv"]["k"].shape[2] == S
    _, cache = model.prefill(params, batch, cache)
    kv = cache["cross_kv"]
    assert kv["k"].shape == (cfg.n_layers, B, ENC_FRAMES, cfg.n_kv,
                             cfg.head_dim)
    before = {k: v.clone() for k, v in kv.items()}
    _, cache = model.decode_step(params, batch["tokens"][:, :1], cache)
    assert all(torch.equal(cache["cross_kv"][k], before[k]) for k in kv)


def _shapes(tree, prefix=""):
    """{dotted path: shape} of a params tree."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_shapes(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("arch,tie", [
    ("qwen2-vl-72b", False), ("whisper-base", False), ("qwen3-4b", True),
    ("rwkv6-3b", False), ("zamba2-1.2b", False)])
def test_init_trees_match_the_reference(arch, tie):
    """The port's own ``init`` draws the reference's tree: the same
    paths and shapes (layer stacks, LayerNorm dicts, Zamba2's stacked
    super-blocks), so checkpoints cross in either direction."""
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               tie_embeddings=tie)
    want = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              tie_embeddings=tie)
    assert _shapes(build_model(cfg, device="cpu").init(0)) == _shapes(want)


# -- the layers ---------------------------------------------------------------

@pytest.mark.parametrize("scale,mean", [(1.0, 0.0), (30.0, 5.0)])
def test_layernorm_against_the_reference(scale, mean):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 9, 96)) * scale + mean).astype(np.float32)
    p = {k: rng.standard_normal(96).astype(np.float32) for k in "wb"}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = np.asarray(jax_layers.layernorm(jnp.asarray(x), jp))
    got = layers.layernorm(torch.from_numpy(x), tp).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -20 * np.abs(want).max()
    want16 = np.asarray(jax_layers.layernorm(
        jnp.asarray(x).astype(jnp.bfloat16), jp).astype(jnp.float32))
    got16 = layers.layernorm(torch.from_numpy(x).to(torch.bfloat16),
                             tp).float().numpy()
    assert np.array_equal(got16, want16)


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_mrope_against_the_reference(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 11, 3)).astype(np.int32)
    assert (pos[..., 0] != pos[..., 1]).any()
    want = np.asarray(jax_layers.apply_mrope(jnp.asarray(x),
                                             jnp.asarray(pos), theta))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta).numpy()
    assert np.abs(got - want).max() <= 1e-6
    # text tokens (t == h == w) rotate as plain RoPE
    flat = torch.from_numpy(np.repeat(pos[..., :1], 3, -1))
    assert torch.equal(
        layers.apply_mrope(torch.from_numpy(x), flat, theta),
        layers.apply_rope(torch.from_numpy(x), flat[..., 0], theta))
    assert layers.mrope_sections(64) == (16, 24, 24)


# -- greedy_generate against the port's own steps and scheduler ---------------

def _qwen3():
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True),
                              dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(0)


def _prompts(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab - 1, shape).astype(
        np.int32))


def test_greedy_generate_is_prefill_then_decode_steps():
    cfg, model, params = _qwen3()
    prompts = _prompts(cfg, (2, 8), 2)
    cache = model.init_cache(2, 32)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    tok, cache = prefill(params, {"tokens": prompts}, cache)
    toks = [tok]
    for _ in range(3):
        tok, cache = decode(params, tok, cache)
        toks.append(tok)
    want = greedy_generate(model, params, {"tokens": prompts}, max_new=4,
                           max_len=32)
    assert torch.equal(torch.cat(toks, dim=1), want)
    assert int(want.max()) < cfg.padded_vocab


def test_greedy_generate_matches_the_scheduler():
    """A request served through slot admission gives the tokens of a
    dedicated batch-of-1 generation."""
    cfg, model, params = _qwen3()
    p = _prompts(cfg, (6,), 9)
    want = greedy_generate(model, params, {"tokens": p[None]}, max_new=5,
                           max_len=32)[0]
    sched = BatchScheduler(model, params, n_slots=2, max_len=32)
    sched.submit(Request(rid=0, prompt=p.numpy(), max_new=5))
    done = []
    while not done:
        done += sched.step()
    assert done[0].out[:5] == want.tolist()


def test_temperature_sampling_draws_from_the_generator():
    cfg, model, params = _qwen3()
    prompts = _prompts(cfg, (2, 6), 3)
    cache = model.init_cache(2, 16)
    tok, cache = make_prefill_step(model)(params, {"tokens": prompts}, cache)
    step = make_decode_step(model, temperature=0.8)
    draws = []
    for _ in range(2):
        cache_i = {"layers": {k: v.clone() for k, v in
                              cache["layers"].items()}}
        gen = torch.Generator().manual_seed(5)
        draws.append(step(params, tok, cache_i, generator=gen)[0])
    assert torch.equal(draws[0], draws[1])
    assert draws[0].shape == (2, 1) and draws[0].dtype == torch.int32


# -- refusals as the reference makes them -------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_crossbar_backend_refuses_the_recurrent_families(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              backend="crossbar")
    with pytest.raises(ValueError, match="transformer families only"):
        build_model(cfg, device="cpu")


def test_paged_serving_refusals():
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True),
                              dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="has no paged cache"):
        BatchScheduler(model, model.init(0), n_slots=2, max_len=32,
                       kv="paged")
    enc = build_model(dataclasses.replace(
        get_config("whisper-base", smoke=True), dtype=torch.float32),
        device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        enc.init_paged_cache(2, 32, 8, 8)
