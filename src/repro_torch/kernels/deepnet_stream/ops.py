"""Deep-net streaming linear (the port of
``repro/kernels/deepnet_stream/ops.py``).

``stream_linear(x, w, cfg)`` is the deployment-shaped entry point: float
activations and float weights in, float activations out, with the program
step fused into the read (no cell planes in device memory).  The weight is
read in the dtype it is given (float32 or bfloat16) and never copied: the
kernel masks the ragged edges itself.  Its output equals
``engine.linear(x, w.float(), cfg)`` on the crossbar-MAC kernel bit for
bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.quant import true_div
from repro_torch.kernels.deepnet_stream.kernel import deepnet_stream


def weight_scales(w: torch.Tensor, q) -> torch.Tensor:
    """``quant.weight_scales(w.float(), q)`` as a (1, N) float32 row,
    without a float32 copy of ``w``: the column extremes are exact in any
    float dtype, so only they are widened."""
    qmax = 2.0 ** q.w_bits - 1.0
    if q.per_channel:
        lo, hi = torch.aminmax(w, dim=0, keepdim=True)
    else:
        lo, hi = torch.aminmax(w)
    amax = torch.maximum(-lo, hi).to(torch.float32)
    scale = true_div(torch.clamp(amax, min=1e-8), qmax)
    return scale.reshape(1, -1).expand(1, w.shape[1])


def stream_linear(x: torch.Tensor, w: torch.Tensor, cfg) -> torch.Tensor:
    """x (..., K) float, w (K, N) float32/bfloat16, cfg: EngineConfig ->
    (..., N) float32."""
    q = cfg.quant
    lead = x.shape[:-1]
    n = w.shape[1]
    xb = x.reshape(-1, x.shape[-1]).to(torch.float32)
    x_int, x_scale = quant.quantize_inputs(xb, q)
    w_scale = weight_scales(w, q)
    y = deepnet_stream(
        x_int.to(torch.int32).contiguous(), w.contiguous(),
        w_scale.contiguous(), w_bits=q.w_bits, in_bits=q.in_bits,
        adc_bits=q.adc_bits, bits_per_cell=q.bits_per_cell,
        rows_per_adc=cfg.rows_per_adc)
    y = y * x_scale * w_scale
    return y.reshape(*lead, n)
