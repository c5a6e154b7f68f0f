"""The captured train step: ``trainer.GraphTrainStep``, the reference's
``jax.jit(train_step, donate_argnums=(0,))`` as one CUDA graph over a
static state, a static batch buffer and static metrics.

Contracts (docs/PORT.md, "The captured train step"):
* on the CPU the step's body, run over its static buffers again and
  again as a replay runs it (``capture=False``; each batch copied into
  the static buffer), equals the plain ``make_train_step(donate=False)``
  BIT FOR BIT over 4 steps at SMOKE widths and float32 (loss, grad norm,
  lr, and every param, ``m`` and ``v`` after each step): qwen3-4b at
  microbatches 1 and 2, and 2 with a bfloat16 accumulator, phi3.5-moe
  under remat "dots", rwkv6-3b and zamba2-1.2b.  Every state leaf keeps
  its storage, ``opt.step`` is one tensor advanced in place, the lr moves
  with it, and a call returns the bound state and the same metrics;
* qwen3-4b at microbatches 2 stays within the reference's jitted step's
  bounds (``test_torch_train.py``: 2^-20 on the loss, 2^-16 on the grad
  norm, 2^-10 x max|p| of each leaf);
* a state that is not the bound storage raises, as does a batch of
  another shape; ``capture=True`` raises without CUDA for the step,
  ``launch/train.main`` and both training examples, before any step;
  capture without ``donate`` raises; the step is freed by reference
  counting, the cycle collector off;
* on the card (tests marked ``gpu``, which skip here) the captured step
  equals the eager one (``capture=False``) BIT FOR BIT under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``, for the
  same families at their own compute dtype: one capture, replays after,
  ``reset`` releasing the graph; and a resume through captured steps
  equals the uninterrupted captured run.  On a machine with a card run

      PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
          tests/test_torch_captured_train.py

  The card has no JAX: the reference is imported inside a CPU test.
"""
import dataclasses
import gc
import importlib.util
import pathlib
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, STEPS = 4, 12, 4
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
#: case -> (arch, layers, config changes, microbatches, accumulator)
CASES = {
    "qwen3-4b-mb1": ("qwen3-4b", 1, {}, 1, torch.float32),
    "qwen3-4b-mb2": ("qwen3-4b", 1, {}, 2, torch.float32),
    "qwen3-4b-mb2-bf16acc": ("qwen3-4b", 1, {}, 2, torch.bfloat16),
    "phi3.5-moe-dots": ("phi3.5-moe", 1, {"remat": "dots"}, 1,
                        torch.float32),
    "rwkv6-3b": ("rwkv6-3b", 1, {}, 1, torch.float32),
    "zamba2-1.2b": ("zamba2-1.2b", 3, {}, 1, torch.float32),  # 1 super
}


def _model(arch, layers, over, device="cpu", dtype=torch.float32):
    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=layers,
                              dtype=dtype, **over)
    return build_model(cfg, device=device)


def _batches(vocab, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(toks[:, :-1].copy()),
                    "labels": torch.from_numpy(toks[:, 1:].copy())})
    return out


def _state(params):
    return trainer.TrainState(params, opt.init(params))


def _clone(state):
    return tree.map(torch.clone, state)


def _static_step(model, mb, acc):
    """The donated step over static buffers, run eagerly as the CPU runs
    it: the body a replay runs."""
    fn = trainer.make_train_step(
        model, opt.AdamWConfig(**OPT), microbatches=mb,
        compute_dtype=torch.float32, grad_accum_dtype=acc, donate=True,
        capture=False)
    return trainer.GraphTrainStep(fn, model.device, capture=False)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    arch, layers, over, mb, acc = CASES[request.param]
    model = _model(arch, layers, over)
    return {"model": model, "params": model.init(0), "mb": mb, "acc": acc,
            "batches": _batches(model.cfg.vocab)}


def test_static_body_is_the_plain_step(case):
    model, mb, acc = case["model"], case["mb"], case["acc"]
    plain = trainer.make_train_step(
        model, opt.AdamWConfig(**OPT), microbatches=mb,
        compute_dtype=torch.float32, grad_accum_dtype=acc)
    step = _static_step(model, mb, acc)
    want = _state(tree.map(torch.clone, case["params"]))
    state = _state(tree.map(torch.clone, case["params"]))
    counter = state.opt.step
    ptrs = [t.data_ptr() for t in tree.leaves(state)]
    metrics0, lrs = None, []
    for i, batch in enumerate(case["batches"]):
        want, wmet = plain(want, batch)
        got, met = step(state, {k: v.clone() for k, v in batch.items()})
        assert got is state and step.batch["tokens"] is not batch["tokens"]
        metrics0 = metrics0 or met
        assert met is metrics0            # the static metrics, rewritten
        assert got.opt.step is counter and int(counter) == i + 1
        assert [t.data_ptr() for t in tree.leaves(got)] == ptrs
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(met[k], wmet[k]), (i, k)
        lrs.append(float(met["lr"]))
        for (key, a), b in zip(tree.leaves_with_keys(got),
                               tree.leaves(want)):
            assert torch.equal(a, b), (i, key)
    assert len(set(lrs)) == STEPS          # the counter moved the lr
    assert step.report()["eager_steps"] == STEPS
    assert step.report()["captures"] == 0


def test_static_body_against_the_reference_jit():
    """qwen3-4b at microbatches 2 within ``test_torch_train.py``'s
    bounds of the reference's jitted, donated step."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.model import build_model as jax_build
    from repro.train import optimizer as jopt
    from repro.train import trainer as jtrainer

    jm = jax_build(dataclasses.replace(jax_config("qwen3-4b", smoke=True),
                                       n_layers=1, dtype=jnp.float32))
    model = _model("qwen3-4b", 1, {})
    params = model.init(0)
    jparams = jax.tree.map(lambda p: jnp.asarray(p.numpy()), params)
    jstep = jax.jit(jtrainer.make_train_step(
        jm, jopt.AdamWConfig(**OPT), microbatches=2,
        compute_dtype=jnp.float32), donate_argnums=(0,))
    js = jtrainer.TrainState(jparams, jopt.init(jparams))
    step = _static_step(model, 2, torch.float32)
    state = _state(params)
    for batch in _batches(model.cfg.vocab, seed=3):
        js, jmet = jstep(js, {k: jnp.asarray(v.numpy())
                              for k, v in batch.items()})
        state, met = step(state, batch)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= (
            2 ** -20 * abs(float(jmet["loss"])))
        assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= (
            2 ** -16 * float(jmet["grad_norm"]))
    assert int(state.opt.step) == int(js.opt.step) == STEPS
    for (key, a), b in zip(tree.leaves_with_keys(state.params),
                           jax.tree.leaves(js.params)):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 2 ** -10 * max(float(np.abs(b).max()), 1e-30), key


def test_a_foreign_state_or_batch_raises():
    model = _model("qwen3-4b", 1, {})
    step = _static_step(model, 1, torch.float32)
    params = model.init(0)
    state = _state(params)
    batches = _batches(model.cfg.vocab, n=2)
    step(state, batches[0])
    restored = _clone(state)                  # same values, new storage
    with pytest.raises(ValueError, match="not its storage"):
        step(restored, batches[1])
    # the same tensors in a new tree are the bound storage
    step(trainer.TrainState(dict(state.params), state.opt), batches[1])
    short = {k: v[:, :-1] for k, v in batches[1].items()}
    with pytest.raises(ValueError, match="does not fit the static batch"):
        step(state, short)
    assert int(state.opt.step) == 2


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("entry", ["make_train_step", "launch_train",
                                   "train_lm", "crossstack_deploy"])
def test_capture_true_raises_without_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    calls = {
        "make_train_step": lambda: trainer.make_train_step(
            _model("qwen3-4b", 1, {}), opt.AdamWConfig(), donate=True,
            capture=True),
        "launch_train": lambda: train_cli.main(
            ["--smoke", "--device", "cpu", "--steps", "1"], capture=True),
        "train_lm": lambda: _example("train_lm").main(
            ["--device", "cpu", "--steps", "1", "--ckpt-dir",
             str(tmp_path)], capture=True),
        "crossstack_deploy": lambda: _example("crossstack_deploy").main(
            "cpu", capture=True)}
    with pytest.raises(RuntimeError, match="capture=True needs a CUDA"):
        calls[entry]()
    assert not any(tmp_path.iterdir())       # nothing ran, nothing saved


def test_capture_needs_donate():
    model = _model("qwen3-4b", 1, {})
    with pytest.raises(ValueError, match="needs donate=True"):
        trainer.make_train_step(model, opt.AdamWConfig(), capture=True)
    # the CPU's default is the eager step, donated or not
    assert not isinstance(trainer.make_train_step(
        model, opt.AdamWConfig()), trainer.GraphTrainStep)
    assert not isinstance(trainer.make_train_step(
        model, opt.AdamWConfig(), donate=True), trainer.GraphTrainStep)


def test_the_step_is_freed_without_the_cycle_collector():
    """A graph freed by the cycle collector while another capture is
    open invalidates that capture: the step and its buffers must die
    with their last reference."""
    model = _model("qwen3-4b", 1, {})
    step = _static_step(model, 1, torch.float32)
    step(_state(model.init(0)), _batches(model.cfg.vocab, n=1)[0])
    refs = [weakref.ref(step), weakref.ref(step.metrics["loss"]),
            weakref.ref(step.batch["tokens"])]
    enabled = gc.isenabled()
    gc.disable()
    try:
        del step
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _card_run(model, mb, acc, capture, steps=6):
    step = trainer.make_train_step(
        model, opt.AdamWConfig(**OPT), microbatches=mb,
        grad_accum_dtype=acc, donate=True, capture=capture)
    state = trainer.init_state(model, 0)
    rows = []
    for batch in _batches(model.cfg.vocab, n=steps):
        state, met = step(state, {k: v.to(model.device)
                                  for k, v in batch.items()})
        rows.append({k: met[k].clone() for k in ("loss", "grad_norm",
                                                  "lr")})
    return step, state, rows


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_captured_step_equals_eager(cuda, deterministic, name):
    arch, layers, over, mb, acc = CASES[name]
    model = _model(arch, layers, over, device=cuda,
                   dtype=get_config(arch, smoke=True).dtype)
    step, got, rows = _card_run(model, mb, acc, capture=None)
    assert isinstance(step, trainer.GraphTrainStep)
    assert (step.stats["eager_steps"], step.stats["captures"],
            step.stats["replays"]) == (1, 1, 5)
    step.reset()
    assert step.graph is None
    eager, want, wrows = _card_run(model, mb, acc, capture=False)
    assert not isinstance(eager, trainer.GraphTrainStep)
    for i, (a, b) in enumerate(zip(rows, wrows)):
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k)
    assert len({float(r["lr"]) for r in rows}) == len(rows)
    for (key, a), b in zip(tree.leaves_with_keys(got), tree.leaves(want)):
        assert torch.equal(a, b), key


@pytest.mark.gpu
def test_captured_resume_equals_the_uninterrupted_run(cuda, deterministic,
                                                      tmp_path):
    base = ["--smoke", "--seq-len", "32", "--batch", "8", "--ckpt-every",
            "1", "--log-every", "100"]
    whole = train_cli.main(base + ["--steps", "6"])
    ckpt = str(tmp_path / "ckpt")
    train_cli.main(base + ["--steps", "3", "--ckpt-dir", ckpt])
    resumed = train_cli.main(base + ["--steps", "6", "--ckpt-dir", ckpt])
    for (key, a), b in zip(tree.leaves_with_keys(resumed),
                           tree.leaves(whole)):
        assert torch.equal(a, b), key
