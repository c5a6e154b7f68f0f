"""Multi-tenant plane multiplexing on the PyTorch port: two checkpoints,
one crossbar.

Deploys qwen3-4b (smoke) TWICE onto one crossbar executor (checkpoint A
on the read-active planes, checkpoint B on the stacked twins) and serves
both tenants' request streams interleaved from the same physical stacks.
Mid-run, tenant B's checkpoint is hot-swapped: its planes reprogram in
t_write-costed chunks between tenant A's decode steps, A's traffic never
pauses, and B resumes on the new weights at the atomic promotion.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_multiplex_serve.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.models.model import build_model
from repro_torch.serve.engine import BatchScheduler, Request
from repro_torch.serve.hotswap import finetune_delta


def main(device=None) -> dict:
    cfg = dataclasses.replace(
        get_config("qwen3-4b", smoke=True), backend="crossbar",
        xbar=EngineConfig(tile_rows=64, tile_cols=128, mode="deepnet",
                          quant=QuantConfig(w_bits=4, in_bits=10,
                                            adc_bits=10)))
    model = build_model(cfg, device=device)
    params_a = model.init(0)
    # tenant B: a different checkpoint (on a fleet: checkpoint/manager.py)
    params_b = finetune_delta(params_a, scale=0.05, seed=3)

    sched = BatchScheduler(model, params_a, n_slots=2, max_len=48,
                           tenants={"A": params_a, "B": params_b})
    ex = model.executor
    print(f"multiplexed: tenants={ex.tenants} share {ex.n_resident} plane "
          f"pairs, {ex.n_devices_physical} physical devices (1.0x one "
          f"deployment's stacks; two dedicated arrays would burn 2.0x)")
    for t in ex.tenants:
        print(f"  tenant {t}: v{ex.version(t)} "
              f"fingerprint={ex.fingerprint(tenant=t)}")

    rng = np.random.default_rng(10)
    for rid in range(8):
        prompt = rng.integers(0, cfg.vocab - 1, (6,), dtype=np.int32)
        sched.submit(Request(rid=rid, prompt=prompt, max_new=10,
                             model_id="AB"[rid % 2]))

    params_b2 = finetune_delta(params_a, scale=0.08, seed=9)
    done, steps, swapped = [], 0, False
    while len(done) < 8 and steps < 400:
        if steps == 6 and not swapped:   # new B checkpoint lands mid-serving
            hs = sched.begin_hot_swap(params_b2, chunks_per_step=4,
                                      tenant="B")
            swapped = True
            print(f"step {steps}: tenant-B hot-swap begins "
                  f"({hs.plan.total_chunks} chunks program between tenant "
                  f"A's decode steps; B's lane pauses for the write window)")
        for r in sched.step():
            done.append(r)
            print(f"step {steps:3d}: req {r.rid} [tenant {r.model_id}] "
                  f"finished -> {r.out[:6]}...")
        steps += 1

    (rep,) = sched.swap_history
    print(f"\ntenant-B swap promoted at step boundary: "
          f"B now v{ex.version('B')} fingerprint={ex.fingerprint(tenant='B')} "
          f"(A untouched at v{ex.version('A')})")
    print(f"swap window: {rep['decode_steps_during_swap']} tenant-A decode "
          f"steps served during B's programming (wall "
          f"{rep['wall_swap_s']:.2f}s, zero dropped)")
    print(f"device-time: throughput during swap "
          f"{rep['throughput_ratio_overlap_vs_stop_world']:.2f}x "
          f"stop-the-world (>=2x: {rep['sustains_2x_during_swap']})")
    return {"requests": {r.rid: r.out for r in done}, "report": rep,
            "versions": {t: ex.version(t) for t in ex.tenants}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    main(ap.parse_args().device)
