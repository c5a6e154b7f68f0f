"""N-tenant plane banks on the PyTorch port: three checkpoints, one
crossbar, QoS weights.

Deploys qwen3-4b (smoke) THREE times onto one crossbar executor with
3-plane banks (``DeviceConfig(stack_planes=3)``), one resident
checkpoint per plane slot, and serves all three tenants' request
streams from the same physical stacks at 2:1:1 QoS weights (tenant A
gets twice the slot quota and admission priority).  Mid-run, tenant C's
checkpoint is hot-swapped in place: with all three planes resident the
bank has no free staging slot, so C's lane pauses for the write window
while A's and B's traffic flows on.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_planebank_serve.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.device import DeviceConfig
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
                                            adc_bits=10),
                          device=DeviceConfig(stack_planes=3)))
    model = build_model(cfg, device=device)
    params_a = model.init(0)
    # tenants B/C: distinct checkpoints (on a fleet: checkpoint/manager.py)
    params_b = finetune_delta(params_a, scale=0.05, seed=3)
    params_c = finetune_delta(params_a, scale=0.08, seed=5)

    sched = BatchScheduler(model, params_a, n_slots=2, max_len=48,
                           tenants={"A": (params_a, 2.0),
                                    "B": (params_b, 1.0),
                                    "C": (params_c, 1.0)})
    ex = model.executor
    print(f"plane banks: {ex.stack_planes} planes/bank, {ex.n_resident} "
          f"banks, {ex.n_devices_physical} physical devices (1.0x one "
          f"deployment's stacks; three dedicated arrays would burn 3.0x)")
    for t, entry in ex.residency().items():
        print(f"  tenant {t}: v{entry['version']} "
              f"fingerprint={entry['fingerprint']}")

    rng = np.random.default_rng(10)
    for rid in range(9):
        prompt = rng.integers(0, cfg.vocab - 1, (6,), dtype=np.int32)
        sched.submit(Request(rid=rid, prompt=prompt, max_new=8,
                             model_id="ABC"[rid % 3]))

    params_c2 = finetune_delta(params_a, scale=0.11, seed=9)
    done, steps, swapped = [], 0, False
    while len(done) < 9 and steps < 400:
        if steps == 4 and not swapped:   # new C checkpoint lands mid-serving
            hs = sched.begin_hot_swap(params_c2, chunks_per_step=6,
                                      tenant="C")
            swapped = True
            print(f"step {steps}: tenant-C hot-swap begins "
                  f"({hs.plan.total_chunks} chunks, mode="
                  f"{'in-place' if hs.plan.in_place else 'staged'}; C's "
                  f"lane pauses, A/B traffic flows through the window)")
        for r in sched.step():
            done.append(r)
            print(f"step {steps:3d}: req {r.rid} [tenant {r.model_id}] "
                  f"finished -> {r.out[:6]}...")
        steps += 1

    (rep,) = sched.swap_history
    print(f"\ntenant-C swap promoted at step boundary "
          f"[{rep['swap_mode']}]: C now v{ex.version('C')} "
          f"(A untouched at v{ex.version('A')}, B at v{ex.version('B')})")
    print(f"swap window: {rep['decode_steps_during_swap']} A/B decode steps "
          f"served during C's programming (wall {rep['wall_swap_s']:.2f}s, "
          f"zero dropped)")
    print("\nQoS (weights 2:1:1 -> slot quotas and served-token shares):")
    qos = sched.qos_report()
    for t, q in qos.items():
        print(f"  tenant {t}: weight={q['weight']:g} slots={q['slots']} "
              f"tokens={q['tokens_served']} "
              f"share={q['token_share'] * 100:.1f}%")
    return {"requests": {r.rid: r.out for r in done}, "report": rep,
            "qos": qos}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    main(ap.parse_args().device)
