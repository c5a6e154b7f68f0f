"""Deploy a digitally trained model onto the CrossStack inference engine,
on the PyTorch port.

Trains a small LM (digital, bf16 over float32 masters), then replays its
MLP weights through the crossbar digital twin at several cell
precisions, reporting the loss penalty of analog deployment, then
programs the whole model onto resident tiles once and serves a prefill
from them, and ends with the deep-net-mode latency estimate: the
paper's reconfigurability story end to end.  Every crossbar read runs
through the crossbar-MAC wrapper (``use_kernel=True``): on the card that
launches the CUDA kernel, on the CPU its plain version.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_crossstack_deploy.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

import repro_torch.models.layers as L
from repro_torch import tree
from repro_torch.core import engine as eng
from repro_torch.core import pipeline as pipe
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.graphs import resolve_capture
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

CFG = ModelConfig(name="deploy-demo", family="dense", n_layers=2,
                  d_model=128, n_heads=2, n_kv=1, head_dim=64, d_ff=256,
                  vocab=512, act="swiglu")
#: the (w_bits, adc_bits) of the precision sweep, in both array modes
SWEEP = ((8, 12), (4, 10), (2, 8))


def train(device=None, steps: int = 60, capture=None):
    """1) Train the tiny LM digitally; returns (model, data, float32
    params, the last training loss).  The train step is one CUDA graph
    on the card (``capture=None``), as the reference jits it; ``False``
    runs it eagerly, ``True`` raises without CUDA."""
    resolve_capture(capture, torch.device(device or "cuda"))
    model = build_model(CFG, device=device)
    data = SyntheticLM(DataConfig(vocab=CFG.vocab, seq_len=65,
                                  global_batch=8), device=model.device)
    step_fn = trainer.make_train_step(
        model, opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps),
        donate=True, capture=capture)
    state = trainer.init_state(model, 0)
    for step in range(steps):
        state, metrics = step_fn(state, data.batch_at(step))
    digital_loss = float(metrics["loss"])
    print(f"digital training loss after {steps} steps: {digital_loss:.4f}")
    params = tree.map(lambda p: p.to(torch.float32), state.params)
    return model, data, params, digital_loss


def _loss_with_crossbar_mlp(model, params, batch, engine_cfg, reads):
    """The held-out loss with every MLP matmul on the crossbar digital
    twin (``layers.mlp`` patched, as the reference patches ``L.mlp``);
    each read's output is appended to ``reads``."""
    def xb(x, w):
        y = eng.linear(x, w.to(torch.float32), engine_cfg)
        reads.append(y)
        return y

    orig = L.mlp

    def crossbar_mlp(p, x, act):
        h = xb(x, p["wi"])
        if act == "swiglu":
            h = L.silu(xb(x, p["wg"])) * h
        h = h.to(x.dtype)
        return xb(h, p["wo"]).to(x.dtype)

    L.mlp = crossbar_mlp
    try:
        with torch.no_grad():
            loss, _ = model.loss_fn(params, batch)
    finally:
        L.mlp = orig
    return float(loss)


def deploy(model, data, params) -> dict:
    """2)-4) The precision sweep, the resident deployment and the
    latency estimate; returns every crossbar read's output and the
    figures."""
    batch = data.batch_at(999)
    out = {"reads": [], "sweep": {}}
    with torch.no_grad():
        base_loss = float(model.loss_fn(params, batch)[0])
    out["base_loss"] = base_loss
    print(f"\nheld-out digital loss: {base_loss:.4f}")
    print(f"{'mode':10s} {'w_bits':>6s} {'adc':>4s} {'loss':>8s} "
          f"{'penalty':>9s}")
    for mode in ("expansion", "deepnet"):
        for wb, ab in SWEEP:
            ecfg = eng.EngineConfig(
                tile_rows=64, tile_cols=64, mode=mode, use_kernel=True,
                quant=QuantConfig(w_bits=wb, in_bits=8, adc_bits=ab))
            loss = _loss_with_crossbar_mlp(model, params, batch, ecfg,
                                           out["reads"])
            out["sweep"][(mode, wb)] = loss
            print(f"{mode:10s} {wb:6d} {ab:4d} {loss:8.4f} "
                  f"{loss - base_loss:+9.4f}")

    # 3) production deployment: program-once weight residency.  The
    # sweep above programs every weight on every call (engine.linear),
    # useful for precision studies, wrong for serving; the crossbar
    # backend programs the whole params tree onto resident tiles ONCE
    # and serves reads only.
    xcfg = dataclasses.replace(
        CFG, backend="crossbar", dtype=torch.float32,
        xbar=eng.EngineConfig(tile_rows=64, tile_cols=64, mode="deepnet",
                              use_kernel=True,
                              quant=QuantConfig(w_bits=8, in_bits=8,
                                                adc_bits=12)))
    xmodel = build_model(xcfg, device=model.device)
    prompt = {"tokens": batch["tokens"]}
    logits_x, _ = xmodel.prefill(params, prompt, xmodel.init_cache(8, 65))
    ex = xmodel.executor
    logits_d, _ = model.prefill(params, prompt, model.init_cache(8, 65))
    dev = float((logits_x - logits_d).abs().max() / logits_d.abs().max())
    out.update(logits_x=logits_x, prefill_rel_dev=dev,
               n_resident=ex.n_resident)
    print(f"\nresident deployment: {ex.n_resident} weight grids programmed "
          f"once ({ex.n_devices} devices); prefill rel deviation {dev:.4f}")

    # 4) latency: deep-net mode hides reads inside writes (paper's 29 %)
    rep = pipe.latency_report(CFG.n_layers * 3, 8)  # 3 matmuls per block
    out["speedup_frac"] = rep["speedup_frac"]
    print(f"\ndeep-net pipeline estimate over {CFG.n_layers * 3} crossbar "
          f"layers (8-bit inputs): {rep['speedup_frac'] * 100:.1f}% faster "
          f"than serial")
    return out


def main(device=None, capture=None) -> dict:
    model, data, params, digital_loss = train(device, capture=capture)
    return dict(deploy(model, data, params), digital_loss=digital_loss)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    main(ap.parse_args().device)
