"""Binding of the CUDA crossbar MAC (``csrc/crossbar_mac.cu``: the
pre-ADC sums on the int8 tensor cores, the ADC by a per-block table).

``crossbar_mac`` launches the kernel for CUDA tensors and runs the plain
version (``ref.crossbar_mac_ref``) for CPU tensors; a CUDA call the
kernel cannot take raises.  On the card its output is bitwise
``ref.codes_to_float(ref.crossbar_mac_codes_ref(...))``.
``LAUNCHES["crossbar_mac"]`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.crossbar_mac import ref

#: kernel launches since the count was last set to 0
LAUNCHES = {"crossbar_mac": 0}
#: the same launches by rows per ADC
LAUNCHES_BY_ROWS: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
             _P]
MAX_IN_BITS = 16
MAX_ADC_BITS = 15   # code sums x 2^(in_bits-1) must stay in int32


def _lib() -> ctypes.CDLL:
    lib = build.load("crossbar_mac")
    if lib.crossbar_mac_launch.argtypes is None:
        lib.crossbar_mac_launch.argtypes = _ARGTYPES
        lib.crossbar_mac_launch.restype = _I
        lib.crossbar_mac_adc_table.argtypes = [_P, _P, _I, _I, _F, _F, _P]
        lib.crossbar_mac_adc_table.restype = _I
    return lib


def adc_table(leak: torch.Tensor, *, adc_bits: int, bits_per_cell: int,
              rows_per_adc: int, full_scale_rows: Optional[int] = None
              ) -> torch.Tensor:
    """The ADC table the CUDA MAC builds in each block, copied out:
    (rows * (2^bpc - 1) + 1, 32) int32, row s holding the 32 per-lane
    copies of the code of pre-ADC sum s (``leak``, a 1-element f32 CUDA
    tensor, included).  Card only: there is no plain version of a table
    the kernel keeps in shared memory."""
    if leak.device.type != "cuda" or leak.dtype != torch.float32 \
            or leak.numel() != 1:
        raise TypeError("leak must be one f32 value on a CUDA device")
    if full_scale_rows is None:
        full_scale_rows = rows_per_adc
    levels = 2.0 ** adc_bits - 1.0
    lsb = float(full_scale_rows * (2 ** bits_per_cell - 1)) / levels
    maxsum = rows_per_adc * (2 ** bits_per_cell - 1)
    out = torch.empty((maxsum + 1, 32), dtype=torch.int32,
                      device=leak.device)
    leak = leak.reshape(1).contiguous()
    with torch.cuda.device(leak.device):
        stream = torch.cuda.current_stream(leak.device).cuda_stream
        err = _lib().crossbar_mac_adc_table(
            leak.data_ptr(), out.data_ptr(), rows_per_adc, bits_per_cell,
            lsb, levels, stream)
    build.check(err, "crossbar_mac_adc_table")
    return out


def max_rows(bits_per_cell: int) -> int:
    """Largest ``rows_per_adc`` the kernel build takes (0: unsupported);
    mirrors ``crossbar_mac_max_rows`` in the CUDA source."""
    return {1: 256, 2: 128}.get(bits_per_cell, 0)


def crossbar_mac(x_int: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                 leak, *, in_bits: int, adc_bits: int, bits_per_cell: int,
                 rows_per_adc: int, full_scale_rows: Optional[int] = None
                 ) -> torch.Tensor:
    """x_int (B, K) int32, pos/neg (S, K, N) int8, ``leak`` a 0-d or
    1-element f32 tensor (or a float) -> (B, N) f32 code units."""
    if full_scale_rows is None:
        full_scale_rows = rows_per_adc
    if x_int.device.type == "cpu":
        return ref.crossbar_mac_ref(
            x_int, pos, neg, in_bits=in_bits, adc_bits=adc_bits,
            bits_per_cell=bits_per_cell, rows_per_adc=rows_per_adc,
            full_scale_rows=full_scale_rows, leak_codes=leak)
    dev = x_int.device
    if x_int.dtype != torch.int32 or x_int.dim() != 2:
        raise TypeError(f"x_int must be (B, K) int32, got {x_int.dtype} "
                        f"{tuple(x_int.shape)}")
    b, k = x_int.shape
    if pos.shape != neg.shape or pos.dim() != 3 or pos.shape[1] != k:
        raise ValueError(f"pos/neg must be (S, {k}, N) and equal, got "
                         f"{tuple(pos.shape)} / {tuple(neg.shape)}")
    for name, t in (("pos", pos), ("neg", neg)):
        if t.dtype != torch.int8 or t.device != dev:
            raise TypeError(f"{name} must be int8 on {dev}, got {t.dtype} "
                            f"on {t.device}")
    if not (x_int.is_contiguous() and pos.is_contiguous()
            and neg.is_contiguous()):
        raise ValueError("crossbar_mac needs contiguous operands")
    if k % rows_per_adc:
        raise ValueError(f"K={k} is not a multiple of rows_per_adc "
                         f"{rows_per_adc}")
    if not 1 <= in_bits <= MAX_IN_BITS:
        raise ValueError(f"in_bits {in_bits} outside [1, {MAX_IN_BITS}]")
    if not 1 <= adc_bits <= MAX_ADC_BITS:
        raise ValueError(f"adc_bits {adc_bits} outside [1, {MAX_ADC_BITS}]")
    if rows_per_adc > max_rows(bits_per_cell):
        raise ValueError(
            f"no crossbar_mac kernel variant for {rows_per_adc} rows per "
            f"ADC at {bits_per_cell} bits per cell (this build takes up to "
            f"{max_rows(1)} rows at 1 bit, {max_rows(2)} at 2 bits)")
    if not torch.is_tensor(leak):
        leak = torch.full((1,), float(leak), dtype=torch.float32, device=dev)
    if leak.dtype != torch.float32 or leak.numel() != 1 or leak.device != dev:
        raise TypeError(f"leak must be one f32 value on {dev}")
    s, _, n = pos.shape
    levels = 2.0 ** adc_bits - 1.0
    lsb = float(full_scale_rows * (2 ** bits_per_cell - 1)) / levels
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    acc = torch.empty((b, n), dtype=torch.int64, device=dev)
    leak = leak.reshape(1).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().crossbar_mac_launch(
            x_int.data_ptr(), pos.data_ptr(), neg.data_ptr(),
            leak.data_ptr(), acc.data_ptr(), out.data_ptr(), b, k, n, s,
            in_bits, bits_per_cell, rows_per_adc, lsb, levels, stream)
    build.check(err, "crossbar_mac")
    LAUNCHES["crossbar_mac"] += 1
    LAUNCHES_BY_ROWS[rows_per_adc] += 1
    return out
