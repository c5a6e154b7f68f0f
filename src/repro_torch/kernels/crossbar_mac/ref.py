"""Plain PyTorch version of the crossbar MAC kernel (the port of
``repro/kernels/crossbar_mac/ref.py``).

Computes the bit-exact digital twin of a CrossStack tile grid:

  y[b, n] = sum_t sum_s sum_p bitw[p] * slcw[s]
              * ( ADC( xbits[p, b, t, :] @ pos[s, t, :, n] + leak )
                - ADC( xbits[p, b, t, :] @ neg[s, t, :, n] + leak ) )

with xbits the two's-complement bit-serial planes of the int inputs, ADC
the saturating uniform quantizer over [0, full_scale_rows * (base - 1)],
and ``leak`` the common-mode pre-ADC code offset of an in-flight deep-net
shadow write (0.0 in steady state).

Shapes (code units, no scales — the caller applies them):
  x_int : (B, T * R) int32   — quantized inputs, row-tiled
  pos   : (S, T * R, N) int8 — differential cell codes
  neg   : (S, T * R, N) int8
Returns (B, N) float32 in integer code units.

``crossbar_mac_codes_ref`` is the same function in exact integers: the
int64 code sums sum_t sum_s sum_p bitw[p] * slcw[s] * (code_pos -
code_neg) that the CUDA kernel accumulates.  The kernel's output is
those sums times ``lsb`` (formed in double, rounded to f32 once), which
is what the tests and chip_smoke hold it to, bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import true_div

#: calls of the plain versions (the serving path on the card makes none)
CALLS = {"crossbar_mac_ref": 0, "crossbar_mac_codes_ref": 0}


def adc_lsb(adc_bits: int, full_scale: float) -> float:
    """The ADC's LSB as the kernel gets it: full scale / levels in double
    (rounded to f32 where a kernel or tensor takes it)."""
    return full_scale / (2.0 ** adc_bits - 1.0)


def adc_codes(acc: torch.Tensor, adc_bits: int, full_scale: float
              ) -> torch.Tensor:
    """The integer ADC codes of f32 pre-ADC sums ``acc`` (leak included):
    round half to even of ``acc / lsb`` (correctly rounded divide),
    clamped to [0, 2^adc_bits - 1], as int64."""
    levels = 2.0 ** adc_bits - 1.0
    code = torch.clamp(torch.round(true_div(acc, adc_lsb(adc_bits,
                                                         full_scale))),
                       0.0, levels)
    return code.to(torch.int64)


def adc(acc: torch.Tensor, adc_bits: int, full_scale: float) -> torch.Tensor:
    """Saturating ADC: round-half-even codes of ``acc / lsb`` clamped to
    [0, 2^adc_bits - 1], returned as ``code * lsb``; ``lsb`` is formed in
    double and applied in f32 (correctly rounded divide)."""
    code = adc_codes(acc, adc_bits, full_scale).to(acc.dtype)
    return code * torch.full((), adc_lsb(adc_bits, full_scale),
                             dtype=acc.dtype, device=acc.device)


def crossbar_mac_codes_ref(x_int, pos, neg, *, in_bits: int, adc_bits: int,
                           bits_per_cell: int, rows_per_adc: int,
                           full_scale_rows: Optional[int] = None,
                           leak_codes=0.0) -> torch.Tensor:
    """The crossbar MAC's exact int64 code sums (B, N): multiply by
    ``adc_lsb`` to get ``crossbar_mac_ref``'s code units."""
    CALLS["crossbar_mac_codes_ref"] += 1
    s, kr, n = pos.shape
    b = x_int.shape[0]
    if kr % rows_per_adc:
        raise ValueError(f"{kr} rows are not a multiple of rows_per_adc "
                         f"{rows_per_adc}")
    t = kr // rows_per_adc
    base = 2 ** bits_per_cell
    if full_scale_rows is None:
        full_scale_rows = rows_per_adc
    full_scale = float(full_scale_rows * (base - 1))
    dev = x_int.device
    leak = torch.as_tensor(leak_codes, dtype=torch.float32).to(dev)

    u = torch.remainder(x_int.to(torch.int32) + (1 << in_bits), 1 << in_bits)
    u = u.reshape(b, t, rows_per_adc)
    # pre-ADC sums are integers <= 256 * 3: exact in f32 in any order
    posf = pos.to(torch.float32).reshape(s, t, rows_per_adc, n)
    negf = neg.to(torch.float32).reshape(s, t, rows_per_adc, n)
    out = torch.zeros((b, n), dtype=torch.int64, device=dev)
    for p in range(in_bits):
        bitw = 2 ** p if p < in_bits - 1 else -(2 ** p)
        xb = ((u >> p) & 1).to(torch.float32)             # (B, T, R)
        for si in range(s):
            ap = torch.einsum("btr,trn->btn", xb, posf[si])
            an = torch.einsum("btr,trn->btn", xb, negf[si])
            d = (adc_codes(ap + leak, adc_bits, full_scale)
                 - adc_codes(an + leak, adc_bits, full_scale))
            out += (bitw * base ** si) * d.sum(dim=1)
    return out


def codes_to_float(codes: torch.Tensor, adc_bits: int, full_scale: float
                   ) -> torch.Tensor:
    """int64 code sums -> f32 code units as the kernel converts them:
    (double) codes * (double) (f32) lsb, rounded to f32 once."""
    lsb = float(torch.tensor(adc_lsb(adc_bits, full_scale),
                             dtype=torch.float32))
    return (codes.to(torch.float64) * lsb).to(torch.float32)


def crossbar_mac_ref(x_int, pos, neg, *, in_bits: int, adc_bits: int,
                     bits_per_cell: int, rows_per_adc: int,
                     full_scale_rows: Optional[int] = None,
                     leak_codes=0.0) -> torch.Tensor:
    CALLS["crossbar_mac_ref"] += 1
    s, kr, n = pos.shape
    b = x_int.shape[0]
    if kr % rows_per_adc:
        raise ValueError(f"{kr} rows are not a multiple of rows_per_adc "
                         f"{rows_per_adc}")
    t = kr // rows_per_adc
    base = 2 ** bits_per_cell
    if full_scale_rows is None:
        full_scale_rows = rows_per_adc
    full_scale = float(full_scale_rows * (base - 1))
    dev = x_int.device
    leak = torch.as_tensor(leak_codes, dtype=torch.float32).to(dev)

    u = torch.remainder(x_int.to(torch.int32) + (1 << in_bits), 1 << in_bits)
    u = u.reshape(b, t, rows_per_adc)
    posf = pos.to(torch.float32).reshape(s, t, rows_per_adc, n)
    negf = neg.to(torch.float32).reshape(s, t, rows_per_adc, n)

    out = torch.zeros((b, n), dtype=torch.float32, device=dev)
    for p in range(in_bits):
        bitw = float(2 ** p) if p < in_bits - 1 else -float(2 ** p)
        xb = ((u >> p) & 1).to(torch.float32)             # (B, T, R)
        for si in range(s):
            slcw = float(base ** si)
            ap = torch.einsum("btr,trn->btn", xb, posf[si])
            an = torch.einsum("btr,trn->btn", xb, negf[si])
            d = (adc(ap + leak, adc_bits, full_scale)
                 - adc(an + leak, adc_bits, full_scale))
            out = out + bitw * slcw * d.sum(dim=1)
    return out
