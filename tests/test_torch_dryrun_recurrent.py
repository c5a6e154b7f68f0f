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
