"""Port: the dry run on a fake process group (``launch/dryrun.py``,
``launch/hlo_analysis.py``, ``launch/mesh.py``).

Contract (docs/PORT.md, "Distribution and the dry run"): the op record
counts a toy sharded product's one all-reduce at its operand's bytes;
``run_cell`` runs every arch's SMOKE config, a decode and a train cell
cut to a few tokens, on a fake (2, 2) ("data", "model") mesh, with
finite counts, a peak above zero and the reference's JSON keys (read
from its source: importing its dry run sets ``XLA_FLAGS``; the dense
archs here, the others in ``test_torch_dryrun_families.py`` and
``test_torch_dryrun_recurrent.py``, so that the suite's workers share
them: DTensor plans each new shape's redistributions once, up to ~15 s
a train cell); a dense
decode's flops (world total) are at least 2 x the projection and head
params x batch and at most that plus the attention's; the production
meshes build at fake worlds of 256 and 512 and refuse other sizes;
``launch/train.py --mesh pod`` refuses a world of one.  Each test
starts and destroys its own fake group: this file holds no real one.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as hlo  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from torch_dryrun_cells import check_cell  # noqa: E402

DENSE = ["qwen3_4b", "qwen3_8b", "minitron_4b", "nemotron4_340b"]


@pytest.mark.parametrize("kind", ["decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", DENSE)
def test_run_cell_on_every_smoke_arch(arch, kind, tmp_path):
    check_cell(arch, kind, tmp_path)


def test_the_record_counts_one_all_reduce():
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh((2, 2), ("data", "model"))
        with dryrun.fake_tensors():
            y, rec = _toy_product(mesh)
        assert tuple(y.to_local().shape) == (8, 4)
    assert hlo.collective_bytes(rec) == {
        "all-reduce": {"bytes": 8 * 4 * 4.0, "count": 1}}
    assert rec.flops == 2 * 8 * 8 * 4           # the local product
    hist = hlo.op_histogram(rec)
    assert hist["all-reduce"] == 1 and hist["dot"] == 1


def _toy_product(mesh):
    """(x @ w) with the contraction split over "model", all-reduced."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = DTensor.from_local(torch.empty(8, 8), mesh, [Replicate(), Shard(1)],
                           run_check=False, shape=(8, 16), stride=(16, 1))
    w = DTensor.from_local(torch.empty(8, 4), mesh, [Replicate(), Shard(0)],
                           run_check=False, shape=(16, 4), stride=(4, 1))
    rec = hlo.OpRecord()
    with rec:
        y = (x @ w).redistribute(mesh, [Replicate(), Replicate()])
    return y, rec


def test_dense_decode_flops_are_the_products():
    """World flops of a qwen3-4b SMOKE decode step (1 layer, 4 x 1 token
    against a 32-deep cache): at least 2 x the q/k/v/o, MLP and head
    params x batch; at most that plus the attention's two products."""
    cfg = get_config("qwen3-4b", smoke=True)
    shape = ShapeSpec("decode_32k", 32, 4, "decode")
    res = dryrun.lower_cell("qwen3-4b", "decode_32k", False,
                            mesh_shape=(2, 2), smoke=True, shape=shape,
                            n_layers=1)
    d, hd = cfg.d_model, cfg.head_dim
    proj = (d * cfg.n_heads * hd * 2 + d * cfg.n_kv * hd * 2
            + 3 * d * cfg.d_ff + d * cfg.padded_vocab)
    low = 2 * proj * shape.global_batch
    attn = 2 * 2 * shape.global_batch * cfg.n_heads * hd * shape.seq_len
    world = res["cost"]["flops"] * 4
    assert low <= world <= low + attn, (world, low, attn)


def test_production_meshes_build_at_fake_worlds():
    for multi_pod, world, shape in ((False, 256, (16, 16)),
                                    (True, 512, (2, 16, 16))):
        with dryrun.fake_world(world):
            mesh = make_production_mesh(multi_pod=multi_pod)
            assert tuple(mesh.shape) == shape
            with pytest.raises(ValueError, match=f"world of size {world}"):
                make_production_mesh(multi_pod=not multi_pod)


def test_train_pod_mesh_refuses_a_world_of_one():
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="world of size 1"):
        train.main(["--smoke", "--device", "cpu", "--mesh", "pod",
                    "--steps", "1"])
