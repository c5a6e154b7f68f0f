"""The port's compiled loops: ``greedy_generate``'s decode loop and
``core/device.py``'s Euler time loops, run as one step over static
buffers that a CUDA graph replays on the card.

Contracts (docs/PORT.md, "The captured generate loop and time loops"):
* on the CPU, ``greedy_generate``'s decode step, built once as a
  zero-argument closure over its static buffers (the token and the cache
  the prefill returned) and called again and again as a graph replay
  calls it, gives the plain loop's streams and the reference's
  ``greedy_generate`` streams IDENTICALLY, at SMOKE widths and float32,
  for qwen3-4b (crossbar), phi3.5-moe, qwen2-vl-72b (crossbar),
  whisper-base (crossbar), rwkv6-3b and zamba2-1.2b: no value of a step
  is fixed when the closure is built, and the recurrent families' state
  leaves, returned in new storage, are written back into the static
  ones;
* ``transient``, ``program`` and ``program_verify`` run in fixed blocks
  of Euler steps with an eager tail: bitwise the unblocked step loop on
  the CPU, and within docs/PORT.md's bounds of the reference's
  ``MemristorModel`` (2^-20 on ``w``, 2^-18 of max on ``i``, 2^-18
  relative on the conductance trace), with a tail shorter than a block;
* ``capture=True`` raises without CUDA, before any work, and a
  scheduler's window step, which holds a graph on the card, is freed by
  reference counting, never by the cycle collector;
* on the card (tests marked ``gpu``, which skip here) the captured
  ``greedy_generate`` is bitwise the eager one (``capture=False``) for a
  dense crossbar model with the MAC kernel and the recurrent families,
  with one capture a call, and the captured ``hysteresis_loop`` and
  ``program_verify`` are bitwise the eager ones.  On a machine with a
  card run

      PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
          tests/test_torch_captured_generate.py

  The card has no JAX: the reference is imported inside the CPU tests.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import device as tdev  # noqa: E402
from repro_torch.core.timing import PAPER  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

B, S, MAX_NEW = 2, 5, 6
#: (arch, layers, backend) of each family's case
FAMILIES = {"qwen3-4b": ("qwen3-4b", 1, "crossbar"),
            "phi3.5-moe": ("phi3.5-moe", 2, "digital"),
            "qwen2-vl": ("qwen2-vl-72b", 1, "crossbar"),
            "whisper": ("whisper-base", 1, "crossbar"),
            "rwkv6": ("rwkv6-3b", 2, "digital"),
            "zamba2": ("zamba2-1.2b", 3, "digital")}   # 1 super + 1 tail
#: the VLM's patches: one frame of a 2 x 2 grid
GRID = 2
ENC_FRAMES = 7
STATE_ATOL = 2.0 ** -20   # w
LOOP_RTOL = 2.0 ** -18    # i, x max |i|; the conductance trace, relative


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.core import device as jdev
    from repro.models.model import build_model as jax_build
    from repro.serve.engine import greedy_generate as jax_generate
    return jax, jnp, jax_config, jdev, jax_build, jax_generate


def _inputs(family, d_model, vocab):
    """Tokens and the family's extra inputs from a numpy seed, and the
    cache depth (explicit for the VLM, whose patches take slots)."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, vocab - 1, (B, S)).astype(np.int32)}
    max_len = None
    if family == "encdec":
        batch["enc_emb"] = rng.standard_normal(
            (B, ENC_FRAMES, d_model)).astype(np.float32)
    if family == "vlm":
        h, w = np.meshgrid(np.arange(GRID), np.arange(GRID), indexing="ij")
        vis = np.stack([np.zeros_like(h.ravel()), h.ravel(), w.ravel()], -1)
        text = np.repeat((GRID + np.arange(S))[:, None], 3, 1)
        batch["positions_thw"] = np.repeat(
            np.concatenate([vis, text])[None], B, 0).astype(np.int32)
        batch["vis_emb"] = rng.standard_normal(
            (B, len(vis), d_model)).astype(np.float32)
        max_len = len(vis) + S + MAX_NEW
    return batch, max_len


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """The reference's streams, its params and the inputs of one case."""
    jax, jnp, jax_config, _, jax_build, jax_generate = _jax()
    arch, layers, backend = FAMILIES[request.param]
    cfg = dataclasses.replace(jax_config(arch, smoke=True), n_layers=layers,
                              backend=backend, dtype=jnp.float32)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch, max_len = _inputs(cfg.family, cfg.d_model, cfg.vocab)
    streams = jax_generate(model, params,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           MAX_NEW, max_len=max_len)
    return {"arch": arch, "layers": layers, "backend": backend,
            "streams": np.asarray(streams), "batch": batch,
            "max_len": max_len, "params": jax.device_get(params)}


def _port(case):
    cfg = dataclasses.replace(get_config(case["arch"], smoke=True),
                              n_layers=case["layers"],
                              backend=case["backend"], dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(case["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    return model, params, batch


def test_decode_body_replays_the_reference_streams(family):
    """The decode step as a graph holds it: one closure over the static
    token and cache, built once and called ``MAX_NEW - 1`` times inside
    one entry of its scope; its stream is the plain loop's and the
    reference's."""
    model, params, batch = _port(family)
    b, s = batch["tokens"].shape
    max_len = family["max_len"] or s + MAX_NEW
    cache = (model.init_cache(b, max_len, src_len=s)
             if model.cfg.family == "encdec" else
             model.init_cache(b, max_len))
    tok, cache = engine.make_prefill_step(model)(params, batch, cache)
    held = {tuple(p): leaf for p, leaf in engine.flatten_with_path(cache)}
    body = engine._decode_body(model, params, tok, cache)
    toks = [tok.clone()]
    with engine._decode_scope(model)():
        for _ in range(MAX_NEW - 1):
            body()
            toks.append(tok.clone())
    # the static buffers are still the cache's own leaves
    assert all(leaf is held[tuple(p)]
               for p, leaf in engine.flatten_with_path(cache))
    replayed = torch.cat(toks, dim=1).numpy()
    stats = {}
    plain = engine.greedy_generate(model, params, batch, MAX_NEW,
                                   max_len=family["max_len"], stats=stats)
    assert stats == {"captures": 0, "replays": 0,
                     "eager_steps": MAX_NEW - 1, "launches_per_replay": {}}
    assert plain.shape == (B, MAX_NEW) and plain.dtype == torch.int32
    assert np.array_equal(replayed, plain.numpy())
    assert np.array_equal(replayed, family["streams"])


def test_state_leaves_are_written_back():
    """RWKV6 returns freshly stacked states: the body copies them into
    the static leaves, which after a step hold the step's new state."""
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True),
                              dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab - 1, (B, S)).astype(np.int32))
    tok, cache = engine.make_prefill_step(model)(
        params, {"tokens": toks}, model.init_cache(B, S + 2))
    before = {k: v.clone() for k, v in cache["layers"].items()}
    want_tok, want = engine.make_decode_step(model)(
        params, tok.clone(), {"layers": dict(before)})
    engine._decode_body(model, params, tok, cache)()
    assert torch.equal(tok, want_tok)
    for k, leaf in cache["layers"].items():
        assert torch.equal(leaf, want["layers"][k])
        assert not torch.equal(leaf, before[k])


def test_a_window_step_is_freed_without_the_cycle_collector():
    """A graph destroyed by the cycle collector while another capture is
    open invalidates that capture, so a scheduler's window step (a
    ``GraphStep``) must be freed by reference counting alone."""
    import gc
    import weakref

    model = build_model(get_config("qwen3-4b", smoke=True), device="cpu")
    sched = engine.BatchScheduler(model, model.init(0), n_slots=2,
                                  max_len=16)
    step = weakref.ref(sched._lanes["A"].decode)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del sched
        assert step() is None
    finally:
        if enabled:
            gc.enable()


# -- the time loops ------------------------------------------------------------

def _unblocked_transient(m, v_t, w0, dt):
    """The Euler loop one step at a time, the block's ops in its order."""
    w = w0.clone()
    i_t = torch.empty((len(v_t),) + w.shape)
    w_t = torch.empty_like(i_t)
    for k in range(len(v_t)):
        i_t[k] = m.current(v_t[k], w)
        w = m._euler(v_t[k], w, dt)
        w_t[k] = w
    return i_t, w_t


def _unblocked_verify(m, w0, g_target, n_pulses, n_steps):
    w = w0.clone()
    dt = PAPER.t_write / (n_pulses * n_steps)
    v_set = torch.full((), PAPER.v_write)
    g = torch.empty((n_pulses,) + w.shape)
    for p in range(n_pulses):
        v = torch.where(g_target - m.conductance(w) > 0, v_set, -v_set)
        for _ in range(n_steps):
            w = m._euler(v, w, dt)
        g[p] = m.conductance(w)
    return w, g


def test_transient_blocks_with_a_tail():
    """3 blocks and a 7-step tail: bitwise the unblocked loop, within the
    bounds of the reference's transient; ``w0`` untouched."""
    _, jnp, _, jdev, _, _ = _jax()
    n = 3 * tdev._BLOCK + 7
    rng = np.random.default_rng(8)
    v = (1.2 * np.sin(np.linspace(0, 4 * np.pi, n))).astype(np.float32)
    w0 = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    dt = 1e-8
    m, jm = tdev.MemristorModel(), jdev.MemristorModel()
    w0_t = torch.from_numpy(w0.copy())
    i_t, w_t = m.transient(torch.from_numpy(v), w0_t, dt)
    assert torch.equal(w0_t, torch.from_numpy(w0))
    want_i, want_w = _unblocked_transient(m, torch.from_numpy(v),
                                          torch.from_numpy(w0), dt)
    assert torch.equal(i_t, want_i) and torch.equal(w_t, want_w)
    ji, jw = (np.asarray(a) for a in jm.transient(jnp.asarray(v),
                                                  jnp.asarray(w0), dt))
    assert i_t.shape == (n, 3, 4)
    assert np.abs(w_t.numpy() - jw).max() <= STATE_ATOL
    assert np.abs(i_t.numpy() - ji).max() <= LOOP_RTOL * np.abs(ji).max()


def test_program_and_program_verify_blocks_with_a_tail():
    """``program`` at 2 blocks and a 6-step tail; ``program_verify`` at 7
    pulses of 16 steps (3 blocks of 2 pulses and 1 pulse of tail) and at
    40 steps a pulse (a block of one pulse longer than ``_BLOCK``)."""
    _, jnp, _, jdev, _, _ = _jax()
    rng = np.random.default_rng(9)
    w0 = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    g_t = rng.uniform(PAPER.g_reset, PAPER.g_set, (5, 3)).astype(np.float32)
    m, jm = tdev.MemristorModel(), jdev.MemristorModel()
    n_steps = 2 * tdev._BLOCK + 6
    got = m.program(torch.from_numpy(w0), PAPER.v_write, n_steps=n_steps)
    want = m.program(torch.from_numpy(w0), PAPER.v_write, n_steps=n_steps,
                     capture=False)
    assert torch.equal(got, want)
    assert np.abs(got.numpy() - np.asarray(jm.program(
        jnp.asarray(w0), PAPER.v_write, n_steps))).max() <= STATE_ATOL
    for n_pulses, steps in ((7, 16), (3, 40)):
        w, g = m.program_verify(torch.from_numpy(w0), torch.from_numpy(g_t),
                                n_pulses=n_pulses, n_steps=steps)
        uw, ug = _unblocked_verify(m, torch.from_numpy(w0),
                                   torch.from_numpy(g_t), n_pulses, steps)
        assert torch.equal(w, uw) and torch.equal(g, ug)
        jw, jg = (np.asarray(a) for a in jm.program_verify(
            jnp.asarray(w0), jnp.asarray(g_t), n_pulses=n_pulses,
            n_steps=steps))
        assert g.shape == (n_pulses, 5, 3)
        assert np.abs(w.numpy() - jw).max() <= STATE_ATOL
        assert np.max(np.abs(g.numpy() - jg) / jg) <= LOOP_RTOL


@pytest.mark.parametrize("entry", ["greedy_generate", "hysteresis_loop",
                                   "transient", "program",
                                   "program_verify"])
def test_capture_true_raises_without_cuda(entry):
    m = tdev.MemristorModel()
    w = torch.full((2,), 0.5)
    calls = {
        "greedy_generate": lambda: engine.greedy_generate(
            *_qwen3_cpu(), MAX_NEW, capture=True),
        "hysteresis_loop": lambda: tdev.hysteresis_loop(
            samples_per_cycle=64, device="cpu", capture=True),
        "transient": lambda: m.transient(torch.zeros(40), w, 1e-9,
                                         capture=True),
        "program": lambda: m.program(w, PAPER.v_write, capture=True),
        "program_verify": lambda: m.program_verify(w, w, capture=True)}
    with pytest.raises(RuntimeError, match="capture=True needs a CUDA"):
        calls[entry]()


def _qwen3_cpu():
    cfg = get_config("qwen3-4b", smoke=True)
    model = build_model(cfg, device="cpu")
    toks = torch.zeros((B, S), dtype=torch.int32)
    return model, model.init(0), {"tokens": toks}


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,backend", [("qwen3-4b", "crossbar"),
                                          ("rwkv6-3b", "digital"),
                                          ("zamba2-1.2b", "digital")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_generate_equals_eager(cuda, arch, backend, dtype):
    base = get_config(arch, smoke=True)
    cfg = dataclasses.replace(base, backend=backend, dtype=dtype,
                              xbar=dataclasses.replace(base.xbar,
                                                       use_kernel=True))
    model = build_model(cfg, device=cuda)
    params = model.init(0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab - 1, (3, 9),
                                     generator=gen, device=cuda,
                                     dtype=torch.int32)}
    new = 8
    stats = {}
    captured = engine.greedy_generate(model, params, batch, new,
                                      stats=stats)
    eager_stats = {}
    eager = engine.greedy_generate(model, params, batch, new, capture=False,
                                   stats=eager_stats)
    assert torch.equal(captured, eager)
    assert (stats["captures"], stats["replays"], stats["eager_steps"]) == (
        1, new - 2, 1)
    assert eager_stats["captures"] == 0
    assert eager_stats["eager_steps"] == new - 1
    if backend == "crossbar":
        assert stats["launches_per_replay"].get("crossbar_mac", 0) > 0


@pytest.mark.gpu
def test_captured_time_loops_equal_eager(cuda):
    v, i, w = tdev.hysteresis_loop(samples_per_cycle=512)
    v_e, i_e, w_e = tdev.hysteresis_loop(samples_per_cycle=512,
                                         capture=False)
    assert torch.equal(v, v_e) and torch.equal(i, i_e)
    assert torch.equal(w, w_e)
    m = tdev.MemristorModel()
    gen = torch.Generator(device=cuda).manual_seed(2)
    w0 = torch.rand((64, 96), generator=gen, device=cuda)
    g_t = PAPER.g_reset + (PAPER.g_set - PAPER.g_reset) * torch.rand(
        (64, 96), generator=gen, device=cuda)
    got = m.program_verify(w0, g_t, n_pulses=9, n_steps=16)
    want = m.program_verify(w0, g_t, n_pulses=9, n_steps=16, capture=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(m.program(w0, -PAPER.v_write),
                       m.program(w0, -PAPER.v_write, capture=False))
