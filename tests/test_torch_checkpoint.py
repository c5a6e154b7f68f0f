"""Port parity: the checkpoint manager, the fault-tolerance pieces and
``launch/train.py``.

Contract (docs/PORT.md, "Training and fault tolerance"):
* ``CheckpointManager`` behaves as the reference's tests say
  (``tests/test_substrate.py::TestCheckpoint``): save/restore round trip,
  keep-K and ``latest_step``, a killed writer's ``.tmp`` invisible and
  collected, an async save visible after ``wait``;
* a SMOKE ``TrainState`` crosses both ways: the port restores the
  reference's float32 checkpoint and the reference the port's, bit for
  bit, with the same leaf keys (``.params/...``, ``.opt/.m/...``,
  ``.opt/.v/...``, ``.opt/.step``); bfloat16 leaves go to disk as raw
  words and come back bit for bit, from the port's checkpoint and from
  the reference's ``|V2`` leaves (which the reference itself cannot
  restore);
* ``restore_or_init``, ``PreemptionHandler`` and ``Heartbeat`` as the
  reference's;
* ``python -m repro_torch.launch.train --smoke --device cpu`` trains,
  checkpoints and resumes (``[resume] from step N``) to the state of an
  uninterrupted run, bit for bit; it refuses the pod meshes, the VLM
  and encoder-decoder families, and the card when there is none;
* the serve CLI's ``--hot-swap <dir>`` deploys a checkpoint written by
  either package: the streams of ``--hot-swap ft:0.02`` from a
  checkpoint of those params.
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import ft  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.hotswap import finetune_delta  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _state(x=1.0):
    return {"params": {"w": torch.full((4, 4), x)},
            "opt": {"m": torch.zeros((4, 4)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


# -- the manager, as the reference's tests hold the reference's ---------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state(3.0)
    mgr.save(10, state, blocking=True)
    restored = mgr.restore(_state(0.0))
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert int(restored["opt"]["step"]) == 7
    assert restored["opt"]["step"].dtype == torch.int32


def test_keep_k_latest_and_async_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, _state(float(s)), blocking=True)
    live = _state(4.0)
    mgr.save(4, live)                 # snapshot now, write in the back
    live["params"]["w"].fill_(-1.0)   # later writes do not reach it
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    r = mgr.restore(_state(0.0))
    assert float(r["params"]["w"][0, 0]) == 4.0
    assert float(mgr.restore(_state(0.0), step=3)["params"]["w"][0, 0]) == 3


def test_partial_write_ignored(tmp_path):
    """A .tmp dir from a killed writer must be invisible and collected."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "step_000000099.tmp")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        mgr.restore(_state())
    mgr.save(1, _state(), blocking=True)
    assert mgr.latest_step() == 1
    assert not (tmp_path / "step_000000099.tmp").exists()
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"other": torch.zeros(1)})


def test_restore_or_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state, step = ft.restore_or_init(mgr, lambda: _state(5.0))
    assert step == 0 and float(state["params"]["w"][0, 0]) == 5.0
    mgr.save(42, _state(9.0), blocking=True)
    state, step = ft.restore_or_init(mgr, lambda: _state(5.0))
    assert step == 42 and float(state["params"]["w"][0, 0]) == 9.0


# -- across the packages ------------------------------------------------------

def _train_states(state_dtype):
    """A SMOKE TrainState in each package, equal leaf for leaf (a step of
    training moved the moments and the step off their zeros)."""
    model = build_model(get_config("qwen3-4b", smoke=True), device="cpu")
    ts = ttrainer.init_state(model, 0, opt_state_dtype=state_dtype)
    rng = np.random.default_rng(0)
    grads = tree.map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32)), ts.params)
    params, opt_state, _ = topt.update(topt.AdamWConfig(), ts.params, grads,
                                       ts.opt)
    ts = ttrainer.TrainState(params, opt_state)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[
        state_dtype]

    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jdt)
        return jnp.asarray(t.numpy())

    js = jtrainer.TrainState(
        jax.tree.map(to_jax, tree.map(lambda t: t, ts.params)),
        jopt.OptState(tree.map(to_jax, ts.opt.m), tree.map(to_jax, ts.opt.v),
                      to_jax(ts.opt.step)))
    return ts, js


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind in (
        "V", "f") else a


def _zero_like(state):
    return tree.map(torch.zeros_like, state)


def test_each_package_restores_the_others_float32_checkpoint(tmp_path):
    ts, js = _train_states(torch.float32)
    CheckpointManager(str(tmp_path / "port")).save(3, ts, blocking=True)
    JaxManager(str(tmp_path / "ref")).save(3, js, blocking=True)
    keys = [k for k, _ in tree.leaves_with_keys(ts)]
    assert keys[0].startswith(".params/") and keys[-1] == ".opt/.step"
    for d in ("port", "ref"):
        import json
        with open(tmp_path / d / "step_000000003" / "manifest.json") as f:
            assert [leaf["key"] for leaf in json.load(f)["leaves"]] == keys
    got = CheckpointManager(str(tmp_path / "ref")).restore(_zero_like(ts))
    for (key, a), b in zip(tree.leaves_with_keys(got), tree.leaves(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b), key
    target = jax.tree.map(jnp.zeros_like, js)
    back = JaxManager(str(tmp_path / "port")).restore(target)
    for a, b in zip(jax.tree.leaves(back), tree.leaves(ts)):
        assert a.dtype == jnp.dtype(str(b.dtype).split(".")[-1])
        assert np.array_equal(np.asarray(a), b.numpy())


def test_bfloat16_state_round_trips_as_raw_words(tmp_path):
    ts, js = _train_states(torch.bfloat16)
    assert ts.opt.m["embed"]["tok"].dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(1, ts, blocking=True)
    for src in ("port", "ref"):
        if src == "ref":
            JaxManager(str(tmp_path / "ref")).save(1, js, blocking=True)
        got = CheckpointManager(str(tmp_path / src)).restore(_zero_like(ts))
        for (key, a), b in zip(tree.leaves_with_keys(got), tree.leaves(ts)):
            assert a.dtype == b.dtype, (src, key)
            assert np.array_equal(_bits(a), _bits(b)), (src, key)
    # the reference writes a bf16 leaf as numpy's opaque |V2 and cannot
    # read it back itself
    ref = JaxManager(str(tmp_path / "ref"))
    with pytest.raises(TypeError, match="V2"):
        ref.restore(jax.tree.map(jnp.zeros_like, js))


# -- fault tolerance ----------------------------------------------------------

def test_preemption_handler_and_heartbeat(tmp_path):
    handler = ft.PreemptionHandler()
    try:
        assert not handler.requested
        if signal.getsignal(signal.SIGTERM) == handler._on_signal:
            signal.raise_signal(signal.SIGTERM)   # our handler catches it
            assert handler.requested
    finally:
        handler.restore()
    assert signal.getsignal(signal.SIGTERM) != handler._on_signal
    hb = ft.Heartbeat(str(tmp_path), host_id=3, interval_s=60.0)
    hb.beat()
    first = Path(hb.path).read_text()
    hb.beat()                            # within the interval: no write
    assert Path(hb.path).read_text() == first
    assert ft.Heartbeat.stale_hosts(str(tmp_path), timeout_s=60.0) == []
    old = time.time() - 120
    os.utime(hb.path, (old, old))
    assert ft.Heartbeat.stale_hosts(str(tmp_path), timeout_s=60.0) == [
        "host_3.hb"]


# -- the train CLI ------------------------------------------------------------

TRAIN = ["--smoke", "--device", "cpu", "--seq-len", "16", "--batch", "4",
         "--ckpt-every", "2", "--log-every", "1"]


def test_train_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN,
         "--steps", "3", "--ckpt-dir", ckpt], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "step     2 loss" in res.stdout and "done." in res.stdout
    assert CheckpointManager(ckpt).all_steps() == [2, 3]
    resumed = train_cli.main([*TRAIN, "--steps", "5", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "[resume] from step 3" in out and "step     3 loss" in out
    assert "step     2 loss" not in out
    whole = train_cli.main([*TRAIN, "--steps", "5"])
    for a, b in zip(tree.leaves(resumed), tree.leaves(whole)):
        assert torch.equal(a, b)
    assert CheckpointManager(ckpt).all_steps() == [3, 4, 5]


def test_train_cli_refusals():
    with pytest.raises(ValueError, match="world of size 1"):
        train_cli.main(["--smoke", "--device", "cpu", "--mesh", "pod"])
    for arch in ("whisper-base", "qwen2-vl-72b"):
        with pytest.raises(SystemExit, match="LM families"):
            train_cli.main(["--arch", arch, "--smoke", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["--smoke", "--steps", "1"])


# -- the serve CLI's --hot-swap <dir> -----------------------------------------

def _serve(*extra):
    return serve_cli.main(["--smoke", "--backend", "crossbar", "--device",
                           "cpu", "--requests", "3", "--slots", "2",
                           "--prompt-len", "6", "--max-new", "3",
                           "--max-len", "32", "--swap-after", "0",
                           "--swap-chunks", "8", *extra])


def test_hot_swap_deploys_a_checkpoint_of_either_package(tmp_path, capsys):
    model = build_model(get_config("qwen3-4b", smoke=True), device="cpu")
    params = finetune_delta(model.init(0), scale=0.02)
    CheckpointManager(str(tmp_path / "port")).save(5, params, blocking=True)
    JaxManager(str(tmp_path / "ref")).save(
        5, tree.map(lambda t: jnp.asarray(t.numpy()), params), blocking=True)
    want = _serve("--hot-swap", "ft:0.02")
    streams = {r.rid: r.out for r in want["requests"]}
    for src in ("port", "ref"):
        got = _serve("--hot-swap", str(tmp_path / src))
        assert got["version"] == 2
        assert {r.rid: r.out for r in got["requests"]} == streams, src
    assert "hot-swap promoted" in capsys.readouterr().out
