"""Patch existing dry-run JSONs with ``cost_true`` without redoing the
cells, as the reference's ``launch/probe_costs.py``.

    python -m repro_torch.launch.probe_costs [--mesh 16x16|2x16x16|both]

The reference extrapolates from unrolled depth-1 and depth-2 compiles
because XLA counts a scanned layer once.  The port's eager record counts
every layer and microbatch, so ``probe`` takes flops, bytes and
collective bytes directly from one full-depth fake run, and only
``per_layer_flops`` from depth-1 and depth-2 runs.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.policy import microbatches_for


def probe(arch, shape_name, multi_pod, cfg_overrides=None,
          rule_overrides=None, mb_override=None, full=None, **kw):
    """The keys ``hillclimb.measure`` reads: flops, bytes_accessed and
    collective_bytes of the whole step (``full``, a ``lower_cell``
    record, or one run here), per_layer_flops, probe_depths,
    microbatches, and the full run's peak bytes per rank."""
    from repro_torch.launch.dryrun import lower_cell, probe_depths
    cfg = get_config(arch, smoke=kw.get("smoke", False))
    shape = kw.get("shape") or SHAPES[shape_name]
    mb = (mb_override if mb_override is not None else
          microbatches_for(arch, shape.kind, shape.global_batch, multi_pod))
    args = dict(kw, cfg_overrides=cfg_overrides,
                rule_overrides=rule_overrides, microbatches=mb)
    if full is None:
        full = lower_cell(arch, shape_name, multi_pod, **args)
    d1, d2 = probe_depths(cfg)
    args.pop("n_layers", None)
    ra = lower_cell(arch, shape_name, multi_pod, n_layers=d1, **args)
    rb = lower_cell(arch, shape_name, multi_pod, n_layers=d2, **args)
    return {"flops": full["cost"]["flops"],
            "bytes_accessed": full["cost"]["bytes_accessed"],
            "collective_bytes": full["collective_bytes_total"],
            "per_layer_flops": (rb["cost"]["flops"] - ra["cost"]["flops"])
            / (d2 - d1),
            "probe_depths": [d1, d2], "microbatches": mb,
            "peak_bytes_per_device":
                full["memory"]["peak_bytes_per_device"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16", choices=["16x16", "2x16x16",
                                                        "both"])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    meshes = (["16x16", "2x16x16"] if args.mesh == "both"
              else [args.mesh])
    from repro_torch.configs import all_cells
    for arch, shape in all_cells():
        for mesh in meshes:
            path = os.path.join(args.dir, f"{arch}__{shape}__{mesh}.json")
            if not os.path.exists(path):
                print(f"[miss] {path}")
                continue
            with open(path) as f:
                cell = json.load(f)
            if (cell.get("cost_true") or {}).get("per_layer_flops") \
                    is not None:
                print(f"[skip] {arch} {shape} {mesh}", flush=True)
                continue
            t0 = time.time()
            try:
                cell["cost_true"] = probe(arch, shape, mesh == "2x16x16",
                                          n_layers=cell.get("n_layers"))
                with open(path, "w") as f:
                    json.dump(cell, f, indent=1)
                print(f"[ok]   {arch} {shape} {mesh} "
                      f"({time.time()-t0:.0f}s)", flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"[FAIL] {arch} {shape} {mesh}: {e!r}", flush=True)


if __name__ == "__main__":
    main()
