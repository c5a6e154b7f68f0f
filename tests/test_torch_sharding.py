"""Port parity: logical-axis sharding and every ``*_specs`` (no process
group).

Contract (docs/PORT.md, "Distribution and the dry run"): the rule
tables, ``spec`` and ``spec_tree`` equal the reference's; every spec
tree of all ten archs (FULL and SMOKE) equals the reference's leaf for
leaf; on the 16 x 16 and 2 x 16 x 16 meshes each FULL param's local
shard shape under the arch's train-cell rules equals the reference's
``NamedSharding(AbstractMesh(...), spec).shard_shape(shape)`` (and
raises where it raises), so the per-rank param bytes are equal; the
dry run's ``rules_for`` and ``cfg_for_cell``, the launch policy and
the shape cells are the reference's.  ``logical_constraint`` is the
identity without rules.
"""
import dataclasses
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import policy as jpolicy  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import rwkv as jR  # noqa: E402
from repro.models import ssm as jS  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.inputs import abstract  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import policy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("multi_pod,fsdp,seq_shard",
                         list(itertools.product([False, True], repeat=3)))
def test_rule_tables_and_specs_match(multi_pod, fsdp, seq_shard):
    mine = shd.fsdp_rules(multi_pod, fsdp, seq_shard)
    ref = jshd.fsdp_rules(multi_pod, fsdp, seq_shard)
    assert dict(mine.rules) == dict(ref.rules)
    names = list(ref.rules) + ["unknown"]
    for a, b in itertools.combinations([None] + names, 2):
        assert mine.spec((a, b)) == tuple(ref.spec((a, b)))
    assert shd.single_device_rules().rules == {}


def test_spec_tree_skips_namedtuples():
    state = ttrainer.TrainState(
        params={"w": ("embed", "mlp")},
        opt=topt.OptState(m={"w": ("embed", "mlp")},
                          v={"w": ("embed", "mlp")}, step=()))
    specs = shd.spec_tree(state, shd.fsdp_rules())
    assert specs.params["w"] == ("data", "model")
    assert isinstance(specs, ttrainer.TrainState) and specs.opt.step == ()


def test_constraint_noop_without_rules():
    x = torch.ones((2, 2))
    assert shd.logical_constraint(x, ("batch", None)) is x
    with shd.use_rules(shd.fsdp_rules()):      # rules, but no DTensor
        assert shd.logical_constraint(x, ("batch", None)) is x
    assert shd.tp_bf16_matmul(x, x) is None


def _pairs(arch, smoke):
    j = jbuild(jconfigs.get_config(arch, smoke=smoke))
    t = build_model(configs.get_config(arch, smoke=smoke), device="cpu")
    return j, t


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_spec_tree_matches(arch, smoke):
    j, t = _pairs(arch, smoke)
    assert t.param_specs() == j.param_specs()
    assert t.cache_specs() == j.cache_specs()
    if j.paged_cache_specs is not None:
        assert t.paged_cache_specs() == j.paged_cache_specs()
    cfg, jcfg = t.cfg, j.cfg
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        assert T.block_specs(cfg.block_cfg) == jT.block_specs(jcfg.block_cfg)
        assert T.stack_specs(cfg.block_cfg) == jT.stack_specs(jcfg.block_cfg)
        assert L.cache_specs(cfg.attn) == jL.cache_specs(jcfg.attn)
        assert L.paged_cache_specs(cfg.attn) == jL.paged_cache_specs(
            jcfg.attn)
    if cfg.family == "rwkv6":
        assert R.block_specs(cfg.rwkv) == jR.block_specs(jcfg.rwkv)
        assert R.state_specs(cfg.rwkv) == jR.state_specs(jcfg.rwkv)
    if cfg.family == "zamba2":
        assert S.mamba2_block_specs(cfg.mamba) == jS.mamba2_block_specs(
            jcfg.mamba)
        assert S.mamba2_state_specs(cfg.mamba) == jS.mamba2_state_specs(
            jcfg.mamba)


@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's ``rules_for`` (every cell, both meshes) and
    ``cfg_for_cell`` overrides, read in one subprocess: importing its
    dry run sets ``XLA_FLAGS`` for the whole process."""
    code = r"""
import dataclasses, json
from repro.configs import ARCH_IDS, SHAPES, get_config, all_cells
from repro.launch import dryrun
out = {"rules": {}, "cfg": {}}
for arch, shape in all_cells():
    for mp in (False, True):
        r = dryrun.rules_for(arch, shape, mp)
        out["rules"][f"{arch}/{shape}/{mp}"] = {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in r.rules.items()}
    base, cell = get_config(arch), dryrun.cfg_for_cell(get_config(arch),
                                                       shape)
    out["cfg"][f"{arch}/{shape}"] = {
        f.name: getattr(cell, f.name) for f in dataclasses.fields(cell)
        if f.name in ("q_chunk", "lin_chunk", "remat", "n_layers")}
print("JSON" + json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "JAX_PLATFORMS": "cpu",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("JSON")][-1]
    return json.loads(line[4:])


def _rules_json(r):
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in r.rules.items()}


def test_dryrun_rules_and_cell_configs_match(reference_dryrun):
    from repro_torch.launch import dryrun
    cells = list(configs.all_cells())
    assert cells == list(jconfigs.all_cells()) and len(cells) == 32
    for arch, shape in cells:
        for mp in (False, True):
            assert _rules_json(dryrun.rules_for(arch, shape, mp)) == \
                reference_dryrun["rules"][f"{arch}/{shape}/{mp}"], (
                    arch, shape, mp)
        cell = dryrun.cfg_for_cell(configs.get_config(arch), shape)
        want = reference_dryrun["cfg"][f"{arch}/{shape}"]
        assert {k: getattr(cell, k) for k in want} == want, (arch, shape)


def _jax_shard_shape(mesh, spec, shape):
    sizes, names = MESHES[mesh]
    am = AbstractMesh(sizes, names)
    return NamedSharding(am, P(*spec)).shard_shape(tuple(shape))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_full_param_shard_shapes_match(arch, reference_dryrun):
    """Each FULL param's local shape on both production meshes under the
    arch's train-cell rules, against jax's ``shard_shape``; a dim the
    mesh does not divide raises in both."""
    from repro_torch.launch import dryrun
    j, t = _pairs(arch, smoke=False)
    jshapes = jax.eval_shape(j.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    jflat = {k: tuple(s.shape) for k, s in tree.leaves_with_keys(jshapes)}
    tflat = tree.leaves_with_keys(abstract(t.init, 0))
    specs = shd.spec_leaves(t.param_specs())
    for mesh, mp in (("16x16", False), ("2x16x16", True)):
        rules = dryrun.rules_for(arch, "train_4k", mp)
        assert _rules_json(rules) == reference_dryrun["rules"][
            f"{arch}/train_4k/{mp}"]
        sizes = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
        mine_bytes = ref_bytes = 0
        for (key, leaf), names in zip(tflat, specs):
            shape = tuple(leaf.shape)
            assert jflat[key] == shape, key
            spec = rules.spec(names)
            try:
                want = _jax_shard_shape(mesh, spec, shape)
            except ValueError:
                with pytest.raises(ValueError):
                    shd.shard_shape(sizes, spec, shape)
                continue
            got = shd.shard_shape(sizes, spec, shape)
            assert got == tuple(want), (key, spec)
            mine_bytes += math.prod(got) * leaf.element_size()
            ref_bytes += math.prod(want) * 4
        assert mine_bytes == ref_bytes > 0


def test_policy_and_shapes_match():
    assert policy.MICROBATCHES == jpolicy.MICROBATCHES
    assert policy.TRAIN_DTYPES == jpolicy.TRAIN_DTYPES
    assert policy.TRAIN_SEQ_PARALLEL == jpolicy.TRAIN_SEQ_PARALLEL
    for arch in configs.ARCH_IDS:
        for kind in ("train", "prefill", "decode"):
            for gb in (1, 32, 128, 256):
                for mp in (False, True):
                    assert policy.microbatches_for(arch, kind, gb, mp) == \
                        jpolicy.microbatches_for(arch, kind, gb, mp)
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    for arch in configs.ARCH_IDS + ["zamba2-1.2b", "rwkv6-3b"]:
        for shape in configs.SHAPES:
            assert configs.shape_applicable(arch, shape) == \
                jconfigs.shape_applicable(arch, shape)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    axes = ("pod", "data", "model")
    assert shd.spec_placements(axes, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.spec_placements(axes[1:], (None, None)) == (Replicate(),
                                                           Replicate())
    for bad in ((("data", "pod"),), ("data", "data"), ("nope",)):
        with pytest.raises(ValueError):
            shd.spec_placements(axes, bad)
    with pytest.raises(ValueError, match="not divisible"):
        shd.shard_shape({"data": 16}, ("data",), (24,))
    assert np.prod(shd.shard_shape({"data": 16, "model": 16},
                                   ("data", "model"), (2560, 9728))) == \
        160 * 608
