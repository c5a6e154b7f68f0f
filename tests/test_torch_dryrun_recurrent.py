"""The dry run (``launch/dryrun.py``) on the recurrent archs'
(RWKV6 and the Zamba2 hybrid) SMOKE configs; the contract is
``test_torch_dryrun.py``'s (and its helper ``torch_dryrun_cells.py``)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

from torch_dryrun_cells import check_cell  # noqa: E402

ARCHS = ["rwkv6_3b", "zamba2_1p2b"]


@pytest.mark.parametrize("kind", ["decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_on_every_smoke_arch(arch, kind, tmp_path):
    check_cell(arch, kind, tmp_path)


def test_time_mix_folds_a_whole_dv_at_batch_1(tmp_path):
    """rwkv6-3b's long_500k cell decodes at batch 1: its rules map the
    batch to None, and with it every name of the ``(batch, seq,
    lin_heads, None)`` constraint on ``time_mix``'s output and gate, so
    the constraint leaves their dv split over "model".  Each fold of
    (B, S, H, dv) into (B, S, H * dv) in the step must see dv whole (some
    DTensor versions cannot fold a split dim; others fold it silently,
    so the placements are what shows the fault)."""
    from torch.distributed.tensor import DTensor
    from torch.overrides import TorchFunctionMode

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun

    folds = []

    class Folds(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            x = args[0] if args else None
            if func is torch.Tensor.reshape and isinstance(x, DTensor) \
                    and x.dim() == 4 and out.dim() == 3 \
                    and tuple(out.shape) == (*x.shape[:2],
                                             x.shape[2] * x.shape[3]):
                folds.append(tuple(x.placements))
            return out

    shape = ShapeSpec("long_500k", 32, 1, "decode")
    rules = dryrun.rules_for("rwkv6_3b", "long_500k", False)
    assert rules.rules["batch"] is None and rules.rules["lin_dv"]
    with Folds():
        res = dryrun.run_cell("rwkv6_3b", "long_500k", False,
                              str(tmp_path), extrapolate=False,
                              mesh_shape=(2, 2), smoke=True, shape=shape,
                              n_layers=1)
    assert res["global_batch"] == 1
    assert len(folds) >= 2                      # the output and the gate
    assert all(not p.is_shard(3) for ps in folds for p in ps), folds
