"""Port parity: the training path (``loss_fn``, the optimizer, the train
step, remat) against the reference.

Contract (docs/PORT.md, "Training and fault tolerance"), all on the CPU
at SMOKE widths and float32 compute, the same params in both packages
(the port's ``init``, carried to the reference as numpy arrays) and
inputs made from a numpy seed:
* ``transformer.xent_loss`` (padded vocab, mask) within 2^-20 x |loss|
  of the reference's, ``layers.moe_aux_loss`` within 2^-21;
* ``model.loss_fn`` for all six families (qwen3-4b, phi3.5-moe,
  qwen2-vl-72b, whisper-base, rwkv6-3b, zamba2-1.2b) within 2^-20 x
  |loss| of the reference's jitted ``loss_fn`` (measured 2^-22), the
  MoE's aux term within 2^-20; the gradients of qwen3-4b and phi3.5-moe
  within 2^-17 x max|grad| of each leaf of the jitted ``jax.grad``'s
  (measured 2^-19.4);
* ``quant.ste_round`` passes the gradient straight through, and the
  gradient of ``engine.linear`` through it equals the reference's
  (``_ste_bwd``) within 2^-20 x max|grad|;
* ``optimizer.update`` equals the reference's, run eagerly, BIT FOR BIT
  at float32 and bfloat16 ``state_dtype``, and donated (written into the
  old state's tensors) equals it undonated: unclipped on random grads,
  clipped on grads whose norm every summation order gets exactly;
  the bias corrections bitwise over steps 0..10,000; ``lr_at`` bitwise
  over a 50-step schedule and within 3 float32 ulps over a 10,000-step
  one (XLA's float32 cosine misses the correctly rounded value by an
  ulp at places, and ``1 + cos`` near the end cancels); ``global_norm``
  within 2^-21 relative (XLA's reduction order is not torch's); the
  int8 gradient codes bitwise;
* ``make_train_step`` against the reference's jitted step over 3 steps
  on the reference's batches, microbatches 1 and 2, and 2 with a
  bfloat16 gradient accumulator: each loss within 2^-20 (measured
  2^-21.6), each grad norm within 2^-16 (measured 2^-17.5), the params
  within 2^-10 x max|p| of each leaf (measured 2^-11.4: AdamW's
  m / sqrt(v) turns a last-bit difference of a gradient near zero into
  a step of up to lr);
* remat "none", "full" and "dots" give losses and gradients equal BIT
  FOR BIT.
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
from repro.core import quant as jquant  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

B, S = 2, 12
FAMILIES = ["qwen3-4b", "phi3.5-moe", "qwen2-vl-72b", "whisper-base",
            "rwkv6-3b", "zamba2-1.2b"]


def _within(got, want, tol, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= tol * scale, (what, err / scale, tol)


def _batch(cfg, rng, b=B, s=S):
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_emb"] = rng.standard_normal(
            (b, 7, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":   # 2 frames of a 2 x 3 patch grid
        t, h, w = np.meshgrid(np.arange(2), np.arange(2), np.arange(3),
                              indexing="ij")
        vis = np.stack([t.ravel(), h.ravel(), w.ravel()], -1)
        text = np.repeat((vis.max() + 1 + np.arange(s))[:, None], 3, 1)
        batch["positions_thw"] = np.repeat(
            np.concatenate([vis, text])[None], b, 0).astype(np.int32)
        batch["vis_emb"] = rng.standard_normal(
            (b, len(vis), cfg.d_model)).astype(np.float32)
    return batch


def _models(arch, **over):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32, **over)
    return jax_build(jcfg), build_model(tcfg, device="cpu")


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _params(tm):
    """The port's params from seed 0, and the same as numpy arrays (the
    reference's tree: the port's ``init`` draws its paths and shapes)."""
    params = tm.init(0)
    return params, tree.map(lambda p: p.numpy(), params)


# -- the loss -----------------------------------------------------------------

def test_xent_and_moe_aux_loss_match_the_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 512)) * 4).astype(np.float32)
    labels = rng.integers(0, 384, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.7).astype(np.float32)
    for m, vocab in ((None, None), (None, 384), (mask, 384)):
        want = jtransformer.xent_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m), vocab=vocab)
        got = ttransformer.xent_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m), vocab=vocab)
        _within(got, want, 2 ** -20, f"xent vocab={vocab}")
    gates = torch.softmax(torch.from_numpy(
        rng.standard_normal((2, 7, 4)).astype(np.float32)), -1)
    gates[0, 0] = torch.tensor([0.4, 0.1, 0.4, 0.1])   # a tie: lower wins
    want = jlayers.moe_aux_loss(jnp.asarray(gates.numpy()))
    _within(tlayers.moe_aux_loss(gates), want, 2 ** -21, "moe aux")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """The reference's loss (and, for qwen3-4b and phi3.5-moe, its
    gradients) on its own params and a numpy batch."""
    arch = request.param
    jm, tm = _models(arch)
    _, host = _params(tm)
    jp = jax.tree.map(jnp.asarray, host)
    batch = _batch(jm.cfg, np.random.default_rng(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"arch": arch, "model": tm, "params": host, "batch": batch}
    if arch in ("qwen3-4b", "phi3.5-moe"):
        (loss, met), grads = jax.jit(jax.value_and_grad(
            jm.loss_fn, has_aux=True))(jp, jb)
        out["grads"] = jax.device_get(grads)
    else:
        loss, met = jax.jit(jm.loss_fn)(jp, jb)
    out["loss"], out["aux"] = float(loss), met.get("aux")
    return out


def test_loss_fn_matches_the_reference(family):
    model = family["model"]
    params = tree.map(lambda p: p.requires_grad_(),
                      params_from_numpy(family["params"], "cpu"))
    loss, met = model.loss_fn(params, _tb(family["batch"]))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - family["loss"]) <= 2 ** -20 * abs(
        family["loss"]), (float(loss), family["loss"])
    if family["aux"] is not None:
        _within(met["aux"], family["aux"], 2 ** -20, "aux")
    if "grads" not in family:
        return
    leaves = tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree.leaves(family["grads"])
    assert len(want) == len(grads)
    for (key, _), g, w in zip(tree.leaves_with_keys(params), grads, want):
        _within(g, w, 2 ** -17, key)


def test_ste_round_gradient_through_engine_linear():
    x = torch.linspace(-3, 3, 13, requires_grad=True)
    (g,) = torch.autograd.grad((tquant.ste_round(x) * 3).sum(), x)
    assert torch.equal(g, torch.full_like(x, 3.0))
    jg = jax.grad(lambda v: (jquant.ste_round(v) * 3).sum())(
        jnp.linspace(-3, 3, 13))
    assert np.array_equal(g.numpy(), np.asarray(jg))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) * 0.3).astype(np.float32)
    for mode in ("expansion", "deepnet"):
        jcfg = jeng.EngineConfig(tile_rows=32, tile_cols=32, mode=mode)
        tcfg = teng.EngineConfig(tile_rows=32, tile_cols=32, mode=mode)
        want = jax.jit(jax.grad(
            lambda a, b: (jeng.linear(a, b, jcfg) ** 2).sum(),
            argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        got = torch.autograd.grad((teng.linear(tx, tw, tcfg) ** 2).sum(),
                                  (tx, tw))
        for a, b, name in zip(got, want, ("x", "w")):
            _within(a, b, 2 ** -20, f"{mode} d/d{name}")


# -- the optimizer ------------------------------------------------------------

SHAPES = {"a": (64, 32), "b": (32,), "c": {"w": (3, 16, 8), "z": (5,)}}


def _tree_np(shapes, draw):
    if isinstance(shapes, dict):
        return {k: _tree_np(v, draw) for k, v in shapes.items()}
    return draw(shapes)


def _opt_case(rng, dyadic):
    p = _tree_np(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    if dyadic:   # squares and their sums exact in any order
        g = _tree_np(SHAPES, lambda s: (rng.integers(-4, 5, s) / 8.0
                                        ).astype(np.float32))
    else:
        g = _tree_np(SHAPES, lambda s: (rng.standard_normal(s) * 1e-3
                                        ).astype(np.float32))
    m = _tree_np(SHAPES, lambda s: (rng.standard_normal(s) * 1e-3
                                    ).astype(np.float32))
    v = _tree_np(SHAPES, lambda s: (rng.random(s) * 1e-6
                                    ).astype(np.float32))
    return p, g, m, v


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_update_is_bitwise_the_reference(state_dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        state_dtype]
    rng = np.random.default_rng(3)
    for dyadic in (False, True):
        p, g, m, v = _opt_case(rng, dyadic)
        for step in (0, 1, 57, 100, 4321):
            jst = jopt.OptState(
                jax.tree.map(lambda a: jnp.asarray(a, state_dtype), m),
                jax.tree.map(lambda a: jnp.asarray(a, state_dtype), v),
                jnp.int32(step))
            jp, js, jstats = jopt.update(
                jopt.AdamWConfig(), jax.tree.map(jnp.asarray, p),
                jax.tree.map(jnp.asarray, g), jst)
            tst = topt.OptState(
                tree.map(lambda a: torch.from_numpy(a).to(tdt), m),
                tree.map(lambda a: torch.from_numpy(a).to(tdt), v),
                torch.tensor(step, dtype=torch.int32))
            tp, ts, tstats = topt.update(
                topt.AdamWConfig(), tree.map(torch.from_numpy, p),
                tree.map(torch.from_numpy, g), tst)
            donated = tree.map(lambda a: torch.from_numpy(a.copy()), p)
            dst = topt.OptState(tree.map(torch.clone, tst.m),
                                tree.map(torch.clone, tst.v), tst.step)
            dp, ds, _ = topt.update(
                topt.AdamWConfig(), donated, tree.map(torch.from_numpy, g),
                dst, donate=True)
            for a, b, c in zip(tree.leaves((dp, ds.m, ds.v)), tree.leaves(
                    (donated, dst.m, dst.v)), tree.leaves((tp, ts.m, ts.v))):
                assert a is b and torch.equal(a, c)   # in place, same bits
            assert torch.equal(ds.step, ts.step)
            assert float(tstats["grad_norm"] > 1.0) == float(dyadic)
            for key, want in (("lr", jstats["lr"]),
                              ("grad_norm", jstats["grad_norm"])):
                if key == "lr" or dyadic:
                    assert np.array_equal(tstats[key].numpy(),
                                          np.asarray(want)), key
            assert int(ts.step) == int(js.step) == step + 1
            for mine, theirs in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
                for a, b in zip(tree.leaves(mine), jax.tree.leaves(theirs)):
                    assert a.dtype == tdt or mine is tp
                    assert np.array_equal(
                        a.to(torch.float32).numpy(),
                        np.asarray(b).astype(np.float32)), (dyadic, step)


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_schedule_and_norms_within_their_bounds():
    for warmup, total, ulps in ((10, 50, 0), (100, 10_000, 3)):
        cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
        jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
        steps = np.arange(total + 1, dtype=np.int32)
        want = np.asarray(jopt.lr_at(jcfg, jnp.asarray(steps)))
        got = topt.lr_at(tcfg, torch.from_numpy(steps)).numpy()
        assert _ulps(got, want).max() <= ulps, (total, _ulps(got, want).max())
    sf = jnp.asarray(steps).astype(jnp.float32)
    b1, b2 = topt.bias_corrections(tcfg, torch.from_numpy(steps))
    for mine, theirs in ((b1, 1 - jcfg.b1 ** sf), (b2, 1 - jcfg.b2 ** sf)):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    rng = np.random.default_rng(4)
    g = _tree_np(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(topt.global_norm(tree.map(torch.from_numpy, g)))
    assert abs(got - want) <= 2 ** -21 * want
    x = (rng.standard_normal(1000) * 3).astype(np.float32)
    q, s = topt.quantize_grad_int8(torch.from_numpy(x))
    jq, js = jopt.quantize_grad_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(topt.dequantize_grad(q, s).numpy(),
                          np.asarray(jopt.dequantize_grad(jq, js)))


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("microbatches,accum", [
    (1, "float32"), (2, "float32"), (2, "bfloat16")])
def test_train_step_matches_the_reference_jit(microbatches, accum):
    jm, tm = _models("qwen3-4b")
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jtrainer.make_train_step(
        jm, jopt.AdamWConfig(**ocfg), microbatches=microbatches,
        compute_dtype=jnp.float32, grad_accum_dtype=jnp.dtype(accum)))
    tstep = ttrainer.make_train_step(
        tm, topt.AdamWConfig(**ocfg), microbatches=microbatches,
        compute_dtype=torch.float32,
        grad_accum_dtype=getattr(torch, accum))
    params, host = _params(tm)
    jparams = jax.tree.map(jnp.asarray, host)
    js = jtrainer.TrainState(jparams, jopt.init(jparams))
    ts = ttrainer.TrainState(params, topt.init(params))
    data = JaxSyntheticLM(JaxDataConfig(vocab=jm.cfg.vocab, seq_len=17,
                                        global_batch=4))
    for step in range(3):
        batch = jax.device_get(data.batch_at(step))
        js, jmet = jstep(js, batch)
        ts, tmet = tstep(ts, _tb(batch))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= (
            2 ** -20 * abs(float(jmet["loss"])))
        assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= (
            2 ** -16 * float(jmet["grad_norm"]))
    assert int(ts.opt.step) == 3
    for (key, a), b in zip(tree.leaves_with_keys(ts.params),
                           jax.tree.leaves(js.params)):
        _within(a, b, 2 ** -10, key)


@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3.5-moe", "whisper-base",
                                  "rwkv6-3b", "zamba2-1.2b"])
def test_remat_policies_are_bitwise_equal(arch):
    base = get_config(arch, smoke=True)
    out = {}
    for policy in ("none", "full", "dots"):
        model = build_model(dataclasses.replace(base, remat=policy),
                            device="cpu")
        params = tree.map(lambda p: p.requires_grad_(), model.init(0))
        loss, _ = model.loss_fn(params, _tb(_batch(
            base, np.random.default_rng(5))))
        out[policy] = [loss] + list(torch.autograd.grad(
            loss, tree.leaves(params), allow_unused=True))
    for policy in ("full", "dots"):
        for a, b in zip(out[policy], out["none"]):
            assert (a is None and b is None) or torch.equal(a, b), policy


def test_tree_map_frees_its_leaves_without_the_cycle_collector():
    """A mapped tree's leaves die with their last reference (no reference
    cycle keeps a train step's copies and gradients alive)."""
    import gc
    import weakref
    gc.disable()
    try:
        new = tree.map(lambda x: x + 1, {"a": torch.zeros(4),
                                         "b": [torch.ones(2)]})
        refs = [weakref.ref(x) for x in tree.leaves(new)]
        del new
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_init_state_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_config("qwen3-4b", smoke=True))
    state = ttrainer.init_state(build_model(
        get_config("qwen3-4b", smoke=True), device="cpu"), 0)
    assert all(p.dtype == torch.float32 and p.device.type == "cpu"
               for p in tree.leaves(state.params))
    assert int(state.opt.step) == 0 and state.opt.step.dtype == torch.int32
