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


#: float32 bytes of one differential side's cell planes that a plain MAC
#: converts and reads at once: a pulse meets this many slices in one
#: product
PLANE_GROUP_BYTES = 1 << 28


def slice_group_sums(pulses: torch.Tensor, pos: torch.Tensor,
                     neg: torch.Tensor):
    """The pre-ADC column sums of every pulse against every cell plane,
    a group of slices at a time: the one product of both plain MACs.

    ``pulses`` (P, B, T, R) float32 0/1 bit-planes; ``pos``/``neg`` (S,
    T, R, N) cell codes.  Yields ``(s0, a, acc_p, acc_n)``: pulse ``a``
    against slices ``s0 .. s0 + G - 1``, each (G, B, T, N) float32.  A
    group holds as many slices as ``PLANE_GROUP_BYTES`` of float32 planes
    a side allows and is converted once; groups run outermost, so the
    caller reorders what the (pulse, slice) order needs.  The sums are
    integers <= R * (base - 1), exact in f32 in any order, so each
    slice's sums are those of one product per slice; and each slice's
    (B, T, N) block is laid out T-major, as a slice's einsum lays it
    out, so a float sum over T that follows runs in the same order."""
    s, t, r, n = pos.shape
    group = max(1, min(s, PLANE_GROUP_BYTES // (4 * t * r * n)))
    xs = pulses.transpose(1, 2)                          # (P, T, B, R)
    for s0 in range(0, s, group):
        posf = pos[s0:s0 + group].to(torch.float32)
        negf = neg[s0:s0 + group].to(torch.float32)
        for a in range(xs.shape[0]):
            yield (s0, a, torch.matmul(xs[a], posf).transpose(1, 2),
                   torch.matmul(xs[a], negf).transpose(1, 2))


def _bit_planes(x_int, pos, neg, in_bits: int, rows_per_adc: int):
    """``x_int``'s two's-complement bit-planes, LSB first, as (P, B, T,
    R) float32, with ``pos`` and ``neg`` viewed as (S, T, R, N)."""
    s, kr, n = pos.shape
    b, t = x_int.shape[0], kr // rows_per_adc
    u = torch.remainder(x_int.to(torch.int32) + (1 << in_bits), 1 << in_bits)
    u = u.reshape(b, t, rows_per_adc)
    pulses = torch.stack([((u >> p) & 1).to(torch.float32)
                          for p in range(in_bits)])
    return (pulses, pos.reshape(s, t, rows_per_adc, n),
            neg.reshape(s, t, rows_per_adc, n))


def _bit_weight(p: int, in_bits: int) -> int:
    return 2 ** p if p < in_bits - 1 else -(2 ** p)


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
    base = 2 ** bits_per_cell
    if full_scale_rows is None:
        full_scale_rows = rows_per_adc
    full_scale = float(full_scale_rows * (base - 1))
    dev = x_int.device
    leak = torch.as_tensor(leak_codes, dtype=torch.float32).to(dev)

    out = torch.zeros((b, n), dtype=torch.int64, device=dev)
    # exact integers: any order of the (pulse, slice) sum will do
    for s0, p, ap, an in slice_group_sums(
            *_bit_planes(x_int, pos, neg, in_bits, rows_per_adc)):
        d = (adc_codes(ap + leak, adc_bits, full_scale)
             - adc_codes(an + leak, adc_bits, full_scale))
        for j in range(d.shape[0]):
            out += (_bit_weight(p, in_bits) * base ** (s0 + j)
                    * d[j].sum(dim=1))
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
    base = 2 ** bits_per_cell
    if full_scale_rows is None:
        full_scale_rows = rows_per_adc
    full_scale = float(full_scale_rows * (base - 1))
    dev = x_int.device
    leak = torch.as_tensor(leak_codes, dtype=torch.float32).to(dev)

    sums = torch.empty((in_bits, s, b, n), dtype=torch.float32, device=dev)
    for s0, p, ap, an in slice_group_sums(
            *_bit_planes(x_int, pos, neg, in_bits, rows_per_adc)):
        d = (adc(ap + leak, adc_bits, full_scale)
             - adc(an + leak, adc_bits, full_scale))
        for j in range(d.shape[0]):
            sums[p, s0 + j] = d[j].sum(dim=1)
    # the float32 shift-add in the (pulse, slice) order of the scan
    out = torch.zeros((b, n), dtype=torch.float32, device=dev)
    for p in range(in_bits):
        for si in range(s):
            out = out + (float(_bit_weight(p, in_bits)) * float(base ** si)
                         * sums[p, si])
    return out
