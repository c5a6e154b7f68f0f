"""Zero-downtime weight hot-swap under a live generation loop, on the
PyTorch port.

Deploys qwen3-4b (smoke) on the crossbar backend, starts a greedy decode
loop, then swaps in fine-tuned params WHILE tokens keep streaming: the
new weights program onto the write-shadow planes between decode steps
(deep-net mode: reads never stop) and an atomic flip promotes them.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_hotswap_deploy.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.models.model import build_model
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.serve.hotswap import HotSwapper, finetune_delta


def main(device=None) -> dict:
    cfg = dataclasses.replace(
        get_config("qwen3-4b", smoke=True), backend="crossbar",
        xbar=EngineConfig(tile_rows=64, tile_cols=128, mode="deepnet",
                          quant=QuantConfig(w_bits=8, in_bits=10,
                                            adc_bits=14)))
    model = build_model(cfg, device=device)
    params = model.init(0)

    # "fine-tuned" checkpoint: the serving params plus a small delta (on
    # a fleet it would come from checkpoint/manager.py)
    params_ft = finetune_delta(params, scale=0.02, seed=7)

    ex = model.executor
    ex.program_params(params)
    print(f"programmed v{ex.programmed_version}: {ex.n_resident} plane "
          f"pairs, {ex.n_devices} devices, fingerprint={ex.fingerprint()}")

    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab - 1, (2, 8),
                                            dtype=np.int32)).to(model.device)
    cache = model.init_cache(2, 48)
    tok, cache = make_prefill_step(model)(params, {"tokens": prompts}, cache)
    decode = make_decode_step(model)

    hs, streams = None, []
    for step in range(24):
        if step == 8:   # new checkpoint lands mid-generation
            hs = HotSwapper(ex, params_ft, chunks_per_step=8)
            print(f"step {step}: hot-swap begins "
                  f"({hs.plan.total_chunks} shadow chunks)")
        if hs is not None and not hs.promoted:
            hs.step()   # shadow planes program BETWEEN decode steps
            if hs.done:
                params = hs.promote()   # atomic flip, zero dropped tokens
                print(f"step {step}: promoted -> v{ex.programmed_version}, "
                      f"fingerprint={ex.fingerprint()}")
        tok, cache = decode(params, tok, cache)
        if hs is not None and not hs.promoted:
            hs.note_decode_step()   # a token batch served DURING programming
        marker = "*" if hs is not None and hs.promoted else " "
        streams.append(tok[:, 0].tolist())
        print(f"step {step:2d}{marker} tokens={streams[-1]}")

    rep = hs.report(batch_size=prompts.shape[0])
    print(f"\nswap window: {rep['decode_steps_during_swap']} decode steps "
          f"served during programming (wall {rep['wall_swap_s']:.2f}s)")
    print(f"device-time: overlapped throughput during swap "
          f"{rep['throughput_ratio_overlap_vs_stop_world']:.2f}x "
          f"stop-the-world; steady-state read-under-write overlap "
          f"{rep['overlap_frac_steady_state'] * 100:.1f}% (paper ~29%)")
    return {"streams": streams, "report": rep,
            "version": ex.programmed_version}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    main(ap.parse_args().device)
