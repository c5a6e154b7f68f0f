"""Binding of the CUDA deep-net streaming kernels
(``csrc/deepnet_stream.cu``).

``deepnet_stream`` launches the tensor-core kernel for CUDA tensors and
runs the plain version (``ref.deepnet_stream_ref``) for CPU tensors; a
CUDA call the kernel cannot take raises.  ``deepnet_stream_popcount``
does the same on the popcount kernel, the tensor-core kernel's
independent integer witness: the tests and ``chip_smoke.py`` call it,
``deepnet_stream`` never does.  ``LAUNCHES`` counts each kernel's
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.crossbar_mac.kernel import MAX_ADC_BITS, MAX_IN_BITS
from repro_torch.kernels.crossbar_mac.kernel import max_rows
from repro_torch.kernels.deepnet_stream import ref

#: kernel launches since the count was last set to 0
LAUNCHES = {"deepnet_stream": 0, "deepnet_stream_popcount": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: round(w / scale) is an exact integer in float32 through 24 bits (the
#: reference's own code stops being one past that); the tensor-core kernel
#: takes the magnitudes a byte per pass, the popcount witness in a 16-bit
#: tile through 15 bits and a 32-bit one past that
MAX_W_BITS = 24


def _entry(name: str):
    lib = build.load("deepnet_stream")
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 8 + [_F, _F, _P]
        fn.restype = _I
    return fn


def deepnet_stream(x_int: torch.Tensor, w: torch.Tensor,
                   w_scale: torch.Tensor, *, w_bits: int, in_bits: int,
                   adc_bits: int, bits_per_cell: int, rows_per_adc: int
                   ) -> torch.Tensor:
    """x_int (B, K) int32, w (K, N) float32 or bfloat16, w_scale (1, N)
    float32 -> (B, N) f32 in code units."""
    return _run("deepnet_stream", x_int, w, w_scale, w_bits=w_bits,
                in_bits=in_bits, adc_bits=adc_bits,
                bits_per_cell=bits_per_cell, rows_per_adc=rows_per_adc)


def deepnet_stream_popcount(x_int: torch.Tensor, w: torch.Tensor,
                            w_scale: torch.Tensor, *, w_bits: int,
                            in_bits: int, adc_bits: int, bits_per_cell: int,
                            rows_per_adc: int) -> torch.Tensor:
    """``deepnet_stream`` on the popcount kernel (the witness)."""
    return _run("deepnet_stream_popcount", x_int, w, w_scale, w_bits=w_bits,
                in_bits=in_bits, adc_bits=adc_bits,
                bits_per_cell=bits_per_cell, rows_per_adc=rows_per_adc)


def _run(name, x_int, w, w_scale, *, w_bits, in_bits, adc_bits,
         bits_per_cell, rows_per_adc):
    if x_int.device.type == "cpu":
        return ref.deepnet_stream_ref(
            x_int, w, w_scale, w_bits=w_bits, in_bits=in_bits,
            adc_bits=adc_bits, bits_per_cell=bits_per_cell,
            rows_per_adc=rows_per_adc)
    dev = x_int.device
    if x_int.dtype != torch.int32 or x_int.dim() != 2:
        raise TypeError(f"x_int must be (B, K) int32, got {x_int.dtype} "
                        f"{tuple(x_int.shape)}")
    b, k = x_int.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w must be ({k}, N), got {tuple(w.shape)}")
    n = w.shape[1]
    if w.dtype not in _DTYPES or w.device != dev:
        raise TypeError(f"w must be float32 or bfloat16 on {dev}, got "
                        f"{w.dtype} on {w.device}")
    if (w_scale.dtype != torch.float32 or w_scale.device != dev
            or w_scale.numel() != n):
        raise TypeError(f"w_scale must hold {n} float32 values on {dev}")
    if not (x_int.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")
    if not 1 <= w_bits <= MAX_W_BITS:
        raise ValueError(f"w_bits {w_bits} outside [1, {MAX_W_BITS}]")
    if not 1 <= in_bits <= MAX_IN_BITS:
        raise ValueError(f"in_bits {in_bits} outside [1, {MAX_IN_BITS}]")
    if not 1 <= adc_bits <= MAX_ADC_BITS:
        raise ValueError(f"adc_bits {adc_bits} outside [1, {MAX_ADC_BITS}]")
    if rows_per_adc > max_rows(bits_per_cell):
        raise ValueError(
            f"no {name} kernel variant for {rows_per_adc} rows per "
            f"ADC at {bits_per_cell} bits per cell")
    levels = 2.0 ** adc_bits - 1.0
    lsb = float(rows_per_adc * (2 ** bits_per_cell - 1)) / levels
    scale = w_scale.reshape(n).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    acc = torch.empty((b, n), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(name)(
            x_int.data_ptr(), w.data_ptr(), scale.data_ptr(),
            acc.data_ptr(), out.data_ptr(), b, k, n, _DTYPES[w.dtype],
            w_bits, in_bits, bits_per_cell, rows_per_adc, lsb, levels,
            stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    return out
