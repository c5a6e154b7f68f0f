"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/torch_*.py``) import neither JAX nor
anything of the reference package ``repro``, nor ``ml_dtypes`` (the card
machine has none: fp8 and bf16 arrays cross from numpy as raw bytes)."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


#: the training slice's modules (ROADMAP A.11): each stands alone too
TRAINING = ["train/optimizer.py", "train/trainer.py", "data/pipeline.py",
            "checkpoint/manager.py", "launch/ft.py", "launch/train.py",
            "tree.py"]


#: the distribution slice's modules (ROADMAP A.12): each stands alone too
DISTRIBUTION = ["distributed/sharding.py", "configs/inputs.py",
                "launch/mesh.py", "launch/dryrun.py", "launch/hillclimb.py",
                "launch/probe_costs.py", "launch/forensics.py",
                "launch/hlo_analysis.py", "launch/policy.py"]


def test_the_distribution_modules_are_checked():
    files = set(FILES)
    assert all(ROOT / "src" / "repro_torch" / m in files
               for m in DISTRIBUTION)


def test_the_training_modules_are_checked():
    files = set(FILES)
    assert all(ROOT / "src" / "repro_torch" / m in files for m in TRAINING)
    assert {ROOT / "examples" / f"torch_{e}.py" for e in (
        "train_lm", "crossstack_deploy", "serve_batch", "hotswap_deploy",
        "multiplex_serve", "planebank_serve")} <= files


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; sys.modules['ml_dtypes'] = None; "
            "import repro_torch, repro_torch.launch.serve, "
            "repro_torch.bridge, repro_torch.kernels.crossbar_mac.ops, "
            "repro_torch.kernels.paged_attention, "
            "repro_torch.train.optimizer, repro_torch.train.trainer, "
            "repro_torch.data.pipeline, repro_torch.checkpoint.manager, "
            "repro_torch.launch.ft, repro_torch.launch.train, "
            "repro_torch.distributed.sharding, repro_torch.configs.inputs, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.launch.hillclimb, repro_torch.launch.probe_costs, "
            "repro_torch.launch.forensics, repro_torch.launch.hlo_analysis, "
            "repro_torch.launch.policy; "
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
