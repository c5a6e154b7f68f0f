"""Engine-facing entry point for the crossbar MAC kernel.

Handles input quantization, row padding, the odd-row-tile grouping
fallback, scale application and un-padding, so
``engine.matmul(..., use_kernel=True)`` is a drop-in for the reference
path — including deep-net overlap reads, where the write plane's leakage
arrives as the ``leak_codes`` device scalar.  The kernel masks the
ragged batch and column edges itself, so nothing is padded to block
multiples here.
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels.crossbar_mac.kernel import crossbar_mac

# grouping-fallback warnings already emitted, keyed by tile geometry —
# warn once per geometry, not once per matmul
_FALLBACK_WARNED = set()


def crossbar_matmul(x, pw, cfg, leak_codes=0.0) -> torch.Tensor:
    """x (..., K) float, pw: ProgrammedLinear, cfg: EngineConfig -> (..., N).

    ``leak_codes`` (float or 0-d f32 tensor) is the in-flight shadow
    write's common-mode pre-ADC offset, applied in the kernel's ADC stage
    exactly as ``engine.matmul_reference`` applies it.
    """
    q = cfg.quant
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1])
    x_int, x_scale = quant.quantize_inputs(xb, q)

    s, t, r, n_pad = pw.pos.shape
    pos = pw.pos.reshape(s, t * r, n_pad)
    neg = pw.neg.reshape(s, t * r, n_pad)
    x_int = F.pad(x_int.to(torch.int32), (0, t * r - x_int.shape[-1]))

    rows_per_adc = cfg.rows_per_adc
    full_scale_rows = cfg.rows_per_adc
    if (t * r) % rows_per_adc != 0:
        # odd number of row tiles in expansion mode: the pairwise analog
        # sum has no partner tile, so conversions fall back to per-plane
        # groups.  The ADC keeps the mode's full scale (full_scale_rows),
        # matching the reference path.
        rows_per_adc = r
        key = (cfg.mode, t, r)
        if key not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(key)
            warnings.warn(
                f"crossbar_mac: {t} row tiles of {r} rows cannot pair for "
                f"{cfg.mode}-mode analog summation ({t * r} rows % "
                f"{cfg.rows_per_adc} rows/ADC != 0); falling back to "
                f"per-plane conversions ({r} rows/ADC at the mode's "
                f"{full_scale_rows}-row full scale). ADC grouping differs "
                f"from the even-tile layout — pad K to a multiple of "
                f"{cfg.rows_per_adc} rows to avoid this.",
                stacklevel=3)

    y = crossbar_mac(x_int, pos, neg, leak_codes, in_bits=q.in_bits,
                     adc_bits=q.adc_bits, bits_per_cell=q.bits_per_cell,
                     rows_per_adc=rows_per_adc,
                     full_scale_rows=full_scale_rows)
    y = y * x_scale * pw.w_scale[..., :n_pad]
    return y[:, : pw.n].reshape(*lead, pw.n)
