"""CrossStack quickstart on the PyTorch port: program a weight matrix onto
stacked crossbar pairs and run it in both operating modes.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Every read goes through the crossbar-MAC wrapper (``use_kernel=True``):
on the card that launches the CUDA kernel, on the CPU its plain version.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import engine as eng
from repro_torch.core import pipeline as pipe
from repro_torch.core.executor import CrossbarExecutor, crossbar_linear
from repro_torch.core.quant import QuantConfig
from repro_torch.core.timing import PAPER, deepnet_speedup
from repro_torch.device import DeviceLike, resolve_device


def _rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max() / ref.abs().max())


def main(device: DeviceLike = None) -> dict:
    """Run the quickstart on ``device`` (the card unless ``"cpu"``);
    returns each read's output and relative error and the deep-net
    figures."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((256, 128), generator=gen) * 0.3).to(dev)
    x = torch.randn((8, 256), generator=gen).to(dev)
    ref = x @ w
    out = {"device": str(dev), "reads": {}, "outputs": {}}

    print(f"=== CrossStack quickstart ({dev}) ===")
    print(f"device corners: R_set={PAPER.r_set/1e3:.0f}k  "
          f"R_reset={PAPER.r_reset/1e3:.0f}k  "
          f"t_read={PAPER.t_read*1e9:.0f}ns  "
          f"t_write={PAPER.t_write*1e9:.0f}ns")

    for mode in ("expansion", "deepnet"):
        for bits in (8, 4, 2):
            cfg = eng.EngineConfig(
                tile_rows=64, tile_cols=64, mode=mode, use_kernel=True,
                quant=QuantConfig(w_bits=bits, in_bits=8, adc_bits=12))
            pw = eng.program(w, cfg)       # "write" weights to the planes
            y = eng.matmul(x, pw, cfg)     # analog read-out (digital twin)
            err = _rel_err(y, ref)
            out["reads"][(mode, bits)] = err
            out["outputs"][(mode, bits)] = y
            print(f"mode={mode:9s} w_bits={bits}  rel err={err:.4f}  "
                  f"devices={pw.n_devices}")

    print("\n=== weight residency (program once, read forever) ===")
    # the deployment path: the executor programs a params tree onto
    # resident tiles once; every later call is a read-only bit-serial MAC
    ex = CrossbarExecutor(eng.EngineConfig(tile_rows=64, tile_cols=64,
                                           mode="deepnet", use_kernel=True))
    ex.program_params({"head": w})
    with ex.activate():
        y = crossbar_linear(x, w, "head")
    out["executor_rel_err"] = _rel_err(y, ref)
    out["outputs"]["executor"] = y
    print(f"resident grids={ex.n_resident}  devices={ex.n_devices}  "
          f"programmed={ex.stats['programmed']}  "
          f"rel err={out['executor_rel_err']:.4f}")
    print("(models route every linear this way with backend='crossbar'; "
          "see repro_torch.launch.serve --backend crossbar)")

    print("\ndeep-net pipeline (paper §V): read of layer l overlaps write "
          "of layer l+1")
    out["speedups"] = {b: deepnet_speedup(b) for b in (1, 4, 10, 16)}
    for b, s in out["speedups"].items():
        print(f"  {b:2d}-bit inputs: speedup {s*100:.1f}%"
              + ("   <- paper's 29% claim" if b == 10 else ""))

    rep = pipe.latency_report(100, 10)
    out["latency_report"] = rep
    print(f"\n100-layer, 10-bit conv: serial {rep['t_serial_us']:.2f}us vs "
          f"deep-net {rep['t_deepnet_us']:.2f}us "
          f"({rep['speedup_frac']*100:.1f}% faster)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    main(ap.parse_args().device)
