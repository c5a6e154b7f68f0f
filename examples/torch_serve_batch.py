"""Batched serving on the PyTorch port: fixed-batch greedy generation,
then the continuous-batching scheduler with slot admission.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import BatchScheduler, Request, greedy_generate


def main(device=None) -> dict:
    cfg = get_config("qwen3-4b", smoke=True)
    model = build_model(cfg, device=device)
    params = model.init(0)
    rng = np.random.default_rng(1)

    # ---- path 1: fixed-batch greedy generation ------------------------------
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab - 1, (4, 12),
                                            dtype=np.int32)).to(model.device)
    t0 = time.time()
    out = greedy_generate(model, params, {"tokens": prompts}, max_new=16)
    print(f"greedy_generate: {tuple(out.shape)} tokens in "
          f"{time.time()-t0:.2f}s")

    # ---- path 2: continuous batching with slot admission --------------------
    sched = BatchScheduler(model, params, n_slots=4, max_len=48)
    for rid in range(6):
        p = rng.integers(0, cfg.vocab - 1, (8,), dtype=np.int32)
        sched.submit(Request(rid=rid, prompt=p, max_new=10))
    t0, done = time.time(), []
    while len(done) < 6:
        done += sched.step()
    tok = sum(len(r.out) for r in done)
    print(f"scheduler: {len(done)} requests / {tok} tokens in "
          f"{time.time()-t0:.2f}s")
    for r in done[:2]:
        print(f"  req {r.rid}: {r.out}")
    return {"greedy": out, "requests": {r.rid: r.out for r in done}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    main(ap.parse_args().device)
