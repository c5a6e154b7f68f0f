"""Plain PyTorch version of the deep-net streaming kernel (the port of
``repro/kernels/deepnet_stream/ref.py``).

"Program" (quantize float weights to differential cell codes) immediately
followed by "read" (the bit-sliced crossbar MAC): the composition of the
reference's weight quantization and slicing with ``crossbar_mac_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.quant import QuantConfig, true_div
from repro_torch.kernels.crossbar_mac.ref import crossbar_mac_ref

#: calls of the plain version (the streamed read on the card makes none)
CALLS = {"deepnet_stream_ref": 0}


def quantize_codes(w, w_scale, *, w_bits: int, bits_per_cell: int):
    """The "program" step: float (K, N) weights and (1, N) scales ->
    (pos, neg) int8 cell-code planes (S, K, N)."""
    q = QuantConfig(w_bits=w_bits, bits_per_cell=bits_per_cell)
    qmax = 2.0 ** w_bits - 1.0
    w_int = torch.clamp(torch.round(true_div(w.to(torch.float32),
                                             w_scale)), -qmax, qmax)
    return quant.to_slices(w_int, q, dtype=torch.int8)


def deepnet_stream_ref(x_int, w, w_scale, *, w_bits: int, in_bits: int,
                       adc_bits: int, bits_per_cell: int, rows_per_adc: int):
    """x_int (B, K) int32, w (K, N) float, w_scale (1, N) -> (B, N) f32 in
    integer code units (the caller applies the input and weight scales).
    K need not be a multiple of ``rows_per_adc``: the last row group is
    zero-padded, which adds exact zeros."""
    CALLS["deepnet_stream_ref"] += 1
    pos, neg = quantize_codes(w, w_scale, w_bits=w_bits,
                              bits_per_cell=bits_per_cell)
    pad = (-x_int.shape[1]) % rows_per_adc
    if pad:
        x_int = torch.nn.functional.pad(x_int, (0, pad))
        pos = torch.nn.functional.pad(pos, (0, 0, 0, pad))
        neg = torch.nn.functional.pad(neg, (0, 0, 0, pad))
    return crossbar_mac_ref(x_int, pos, neg, in_bits=in_bits,
                            adc_bits=adc_bits, bits_per_cell=bits_per_cell,
                            rows_per_adc=rows_per_adc)
