"""Shared by the dry-run test files: one SMOKE cell of ``run_cell`` on
a fake (2, 2) ("data", "model") mesh, cut to a few tokens, checked
against the reference's record keys (read from its source: importing
its dry run sets ``XLA_FLAGS`` for the whole process)."""
import ast
import json
import math
from pathlib import Path

import torch

from repro_torch import tree
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]


def _reference_keys():
    """The keys of the reference's ``run_cell`` record, from its source."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    mod = ast.parse(src)
    fn = {n.name: n for n in mod.body if isinstance(n, ast.FunctionDef)}

    def keys(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}

    out = [n.value for n in ast.walk(fn["lower_cell"])
           if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
           and getattr(n.targets[0], "id", "") == "out"][0]
    top = keys(out)
    nested = {k.value: keys(v) for k, v in zip(out.keys, out.values)
              if isinstance(v, ast.Dict)}
    true_cost = set()
    for n in ast.walk(fn["run_cell"]):
        if isinstance(n, ast.Subscript) and getattr(
                n.value, "id", "") == "true_cost" and isinstance(
                n.slice, ast.Constant):
            true_cost.add(n.slice.value)
        if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple) and \
                getattr(n.target, "id", "") == "key":
            true_cost |= {e.value for e in n.iter.elts}
    return top | {"cost_true"}, nested, true_cost


def _cut(arch, kind):
    """A few tokens of the cell's kind (the VLM's patches come first)."""
    cfg = get_config(arch, smoke=True)
    seq = 32 + (256 if cfg.family == "vlm" and kind == "train_4k" else 0)
    return ShapeSpec(kind, seq, 4, SHAPES[kind].kind)


def _layers(arch):
    return dryrun.probe_depths(get_config(arch, smoke=True))[0]


def check_cell(arch, kind, tmp_path):
    before = torch.cuda.max_memory_allocated() if \
        torch.cuda.is_available() else 0
    res = dryrun.run_cell(arch, kind, False, str(tmp_path),
                          extrapolate=False, mesh_shape=(2, 2), smoke=True,
                          shape=_cut(arch, kind), n_layers=_layers(arch))
    top, nested, true_cost = _reference_keys()
    want = (top - {"compile_s"}) | {"run_s"}
    assert set(res) == want
    for k, sub in nested.items():
        assert set(res[k]) == sub, k
    assert set(res["cost_true"]) == true_cost
    on_disk = json.loads((tmp_path / f"{arch}__{kind}__2x2.json").read_text())
    assert set(on_disk) == want
    assert res["memory"]["peak_bytes_per_device"] > 0
    assert res["memory"]["argument_bytes"] > 0
    nums = [v for v in tree.leaves(res["cost"])] + [
        res["collective_bytes_total"]]
    assert all(math.isfinite(v) and v >= 0 for v in nums)
    assert res["cost"]["flops"] > 0 and res["collective_bytes_total"] > 0
    if torch.cuda.is_available():
        assert torch.cuda.max_memory_allocated() == before
