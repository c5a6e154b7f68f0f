"""Port parity: the distribution slice across processes — four gloo
ranks on a (2, 2) ("data", "model") mesh, spawned once
(``tests/torch_dist_worker.py``; a FileStore under ``tmp_path``; the
ranks import only torch and the port, and read the reference's values
from files).

Contract (docs/PORT.md, "Distribution and the dry run"):
* ``optimizer.compressed_psum`` over "data" (2 ranks) is bitwise the
  reference's under ``jax.vmap(..., axis_name=...)`` on the same two
  gradients and errors (one addition: no order to differ);
* ``sharding.tp_bf16_matmul`` with "model" 2 is bitwise the sum, in
  bf16, of the two bf16-cast float32 partials of the reference's einsum
  (inputs on a 2^-4 grid, so every float32 partial is exact);
* the reference's checkpoint restored with ``shardings`` gives every
  rank the reference's array slice, bitwise;
* three train steps of qwen3-4b SMOKE under ``fsdp_rules`` (float32
  compute) against the single-process port step on the same data:
  each loss within 2^-16 x |loss| and each final param within 2^-8 x
  max|p| of its leaf (the card-against-CPU bounds of chip_smoke's
  ``train`` phase).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa
from repro.configs import get_config as jget  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_dist_worker.py")
WORLD = 4
JOIN_S = 240
LOSS_RTOL = 2.0 ** -16
PARAM_RTOL = 2.0 ** -8


def _grid(rng, shape, lo=-2.0, hi=2.0, step=2.0 ** -4):
    n = int((hi - lo) / step)
    return (lo + step * rng.integers(0, n + 1, shape)).astype(np.float32)


def _reference(tmp_path):
    """The inputs, and what the reference computes on them."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((2, 96)).astype(np.float32)
    err = (0.01 * rng.standard_normal((2, 96))).astype(np.float32)
    mean, new_err = jax.vmap(lambda gi, ei: jopt.compressed_psum(
        gi, "dp", ei), axis_name="dp")(jnp.asarray(g), jnp.asarray(err))
    h, w = _grid(rng, (4, 3, 32)), _grid(rng, (32, 8))
    hb, wb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (h, w))
    parts = [jnp.einsum("bsf,fd->bsd", hb[..., i * 16:(i + 1) * 16],
                        wb[i * 16:(i + 1) * 16],
                        preferred_element_type=jnp.float32
                        ).astype(jnp.bfloat16) for i in (0, 1)]
    tp = np.asarray((parts[0] + parts[1]).astype(jnp.float32))
    params = jbuild(jget("qwen3-4b", smoke=True)).init(jax.random.PRNGKey(3))
    JaxManager(str(tmp_path / "ref_ckpt")).save(1, params, blocking=True)
    np.savez(tmp_path / "inputs.npz", g=g, err=err, h=h, w=w)
    return {"mean": np.asarray(mean), "err": np.asarray(new_err), "tp": tp,
            "params": params}


def _spawn(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(WORLD):
        log = open(tmp_path / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(rank), str(WORLD),
             str(tmp_path / "store"), str(tmp_path)], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank hung past {JOIN_S} s: "
                    + (tmp_path / "rank0.log").read_text()[-2000:])
    finally:
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{rank}.log").read_text()
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]


def _slice(a, spec, coord):
    """The slice of ``a`` that mesh coordinate (data, model) holds."""
    sizes = {"data": 2, "model": 2}
    index = {"data": coord[0], "model": coord[1]}
    out = a
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            n = out.shape[d] // sizes[axis]
            out = np.take(out, range(index[axis] * n,
                                     (index[axis] + 1) * n), axis=d)
    return out


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    ref = _reference(tmp)
    return ref, _spawn(tmp)


def test_compressed_psum_and_tp_bf16_matmul_are_bitwise(world):
    ref, ranks = world
    for r in ranks:
        d = int(r["coord"][0])
        assert np.array_equal(_bits(r["psum_mean"]), _bits(ref["mean"][d]))
        assert np.array_equal(_bits(r["psum_err"]), _bits(ref["err"][d]))
        assert np.array_equal(_bits(r["tp_y"]), _bits(ref["tp"]))
    # the cast before the reduce is seen: it differs from a float32 sum
    assert not np.array_equal(ranks[0]["tp_y"], ranks[0]["tp_y"].round())


def test_sharded_restore_gives_each_rank_its_slice(world):
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    ref, ranks = world
    specs = build_model(get_config("qwen3-4b", smoke=True),
                        device="cpu").param_specs()
    rules = jshd.fsdp_rules()
    from repro_torch.distributed.sharding import spec_leaves
    keyed = list(zip([k for k, _ in tree.leaves_with_keys(
        jax.tree.map(np.asarray, ref["params"]))], spec_leaves(specs)))
    flat = dict(tree.leaves_with_keys(jax.tree.map(np.asarray,
                                                   ref["params"])))
    sharded = 0
    for r in ranks:
        coord = tuple(int(c) for c in r["coord"])
        for key, names in keyed:
            want = _slice(flat[key], tuple(rules.spec(names)), coord)
            got = r["restore/" + key]
            assert got.shape == want.shape, key
            assert np.array_equal(_bits(got), _bits(want)), key
            sharded += got.shape != flat[key].shape
    assert sharded > 0


def test_sharded_train_step_within_bounds(world):
    _, ranks = world
    r = ranks[0]
    lp, ls = r["loss_plain"], r["loss_sharded"]
    assert np.all(np.isfinite(ls)) and len(ls) == 3
    assert np.all(np.abs(ls - lp) <= LOSS_RTOL * np.abs(lp)), (ls, lp)
    keys = [k[len("param_plain/"):] for k in r.files
            if k.startswith("param_plain/")]
    assert keys
    for k in keys:
        a, b = r["param_sharded/" + k], r["param_plain/" + k]
        assert np.abs(a - b).max() <= PARAM_RTOL * np.abs(b).max(), k
    # fsdp_rules split the weights: the embedding over data and model
    assert any("embed/tok=(Shard(dim=1), Shard(dim=0))" in p
               for p in r["placements"])
