"""Weight -> cell-code and activation -> pulse-train quantization.

The PyTorch counterpart of ``repro.core.quant``: the paper's
single-bit (or multi-bit) differential cells and two's-complement
bit-serial inputs, with the same arithmetic so the integer quantities
(weight ints, scales, cell planes, input ints, pulse trains) are bitwise
equal to the reference's on the same float inputs.

* weights  -> symmetric int, split into differential (+/-) cell planes,
* inputs   -> two's-complement bit-serial pulse trains,
* read-out -> per-column ADC with saturation, then signed shift-add,
* cell codes -> device conductances (``slices_to_conductance``) for the
  conductance-domain path.

Divisions by a Python number go through :func:`true_div`: on CUDA,
``tensor / python_float`` multiplies by the reciprocal, which is not the
correctly rounded quotient the reference computes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    w_bits: int = 4          # magnitude bits per differential side
    in_bits: int = 8         # input bits (two's complement, bit-serial)
    adc_bits: int = 8        # ADC resolution per column read
    bits_per_cell: int = 1   # conductance levels per device = 2**bits_per_cell
    per_channel: bool = True  # per-output-column weight scales

    @property
    def n_slices(self) -> int:
        """Cell planes per differential side: ceil(w_bits / bits_per_cell)."""
        return -(-self.w_bits // self.bits_per_cell)


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` with an IEEE-rounded divide for a Python-number ``d``
    (the divisor becomes a 0-d tensor on ``x``'s device, which CUDA
    divides elementwise instead of multiplying by ``1 / d``)."""
    if not torch.is_tensor(d):
        d = torch.full((), d, dtype=x.dtype, device=x.device)
    return torch.div(x, d)


# -- straight-through rounding ----------------------------------------------

class _SteRound(torch.autograd.Function):
    """Round half to even forward, identity gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return _SteRound.apply(x)


# -- weights -----------------------------------------------------------------

def weight_scales(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Symmetric quantization scale(s); per output column if per_channel."""
    qmax = 2.0 ** cfg.w_bits - 1.0
    if cfg.per_channel:
        amax = torch.amax(torch.abs(w), dim=0, keepdim=True)
    else:
        amax = torch.amax(torch.abs(w))
    return true_div(torch.clamp(amax, min=1e-8), qmax)


def quantize_weights(w: torch.Tensor, cfg: QuantConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float (K, N) -> signed int (as float) in [-qmax, qmax] plus
    scale(s)."""
    scale = weight_scales(w, cfg)
    qmax = 2.0 ** cfg.w_bits - 1.0
    w_int = torch.clamp(ste_round(w / scale), -qmax, qmax)
    return w_int, scale


def to_slices(w_int: torch.Tensor, cfg: QuantConfig,
              dtype: torch.dtype = torch.int32,
              out_shape: Optional[Tuple[int, int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split signed ints into differential cell planes.

    Returns (pos_slices, neg_slices), each (n_slices, K, N) holding cell
    codes in [0, 2**bits_per_cell - 1]; slice s carries digit s in base
    2**bits_per_cell, LSB first.  ``dtype`` is the planes' storage type
    and ``out_shape`` an optional zero-padded (K', N') >= (K, N): the
    engine writes int8 planes of the padded tile grid directly, without
    an int32 copy of the whole grid.
    """
    k, n = w_int.shape
    kp, np_ = out_shape if out_shape is not None else (k, n)
    s = cfg.n_slices
    bpc = cfg.bits_per_cell
    mask = 2 ** bpc - 1
    planes = []
    for side in (w_int, -w_int):
        x = torch.clamp(side, min=0.0).to(torch.int32)
        out = torch.zeros((s, kp, np_), dtype=dtype, device=w_int.device)
        for i in range(s):
            out[i, :k, :n] = ((x >> (bpc * i)) & mask).to(dtype)
        del x
        planes.append(out)
    return planes[0], planes[1]


def slices_to_conductance(slices: torch.Tensor, cfg: QuantConfig,
                          g_reset: float, g_set: float) -> torch.Tensor:
    """Map cell codes [0, levels-1] to device conductances [g_reset,
    g_set]: linear conductance spacing (single-bit cells hit exactly
    {g_reset, g_set})."""
    levels = 2 ** cfg.bits_per_cell
    frac = true_div(slices.to(torch.float32), levels - 1)
    return g_reset + frac * (g_set - g_reset)


# -- inputs -------------------------------------------------------------------

def quantize_inputs(x: torch.Tensor, cfg: QuantConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float (..., K) -> two's-complement ints (as float) in
    [-2^(b-1), 2^(b-1)-1], plus the per-row scale."""
    qmax = 2.0 ** (cfg.in_bits - 1) - 1.0
    amax = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                       min=1e-8)
    scale = true_div(amax, qmax)
    x_int = torch.clamp(ste_round(x / scale), -qmax - 1, qmax)
    return x_int, scale


def to_bit_serial(x_int: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Signed int -> (in_bits, ..., K) binary pulse train (two's
    complement, LSB first); the MSB recombines with weight -2^(b-1)."""
    b = cfg.in_bits
    u = torch.remainder(x_int.to(torch.int32) + (1 << b), 1 << b)
    bits = [(u >> s) & 1 for s in range(b)]
    return torch.stack(bits, dim=0).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _constant(values: Tuple[float, ...], device) -> torch.Tensor:
    """A float32 constant vector, copied to ``device`` once: a CUDA graph
    of a step that reads it may hold no host-to-device copy.  Callers
    only read it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def bit_weights(cfg: QuantConfig, device=None) -> torch.Tensor:
    """Signed positional weights of the bit-serial pulses, LSB first."""
    w = [2.0 ** s for s in range(cfg.in_bits - 1)]
    w.append(-(2.0 ** (cfg.in_bits - 1)))  # MSB of two's complement
    return _constant(tuple(w), torch.device(device or "cpu"))


def slice_weights(cfg: QuantConfig, device=None) -> torch.Tensor:
    """Positional weights of the cell planes, LSB first."""
    base = 2 ** cfg.bits_per_cell
    return _constant(tuple(float(base ** s) for s in range(cfg.n_slices)),
                     torch.device(device or "cpu"))


# -- ADC ----------------------------------------------------------------------

def adc(i_col: torch.Tensor, cfg: QuantConfig, i_full_scale: float
        ) -> torch.Tensor:
    """Uniform ADC with saturation: current -> dequantized level, STE
    gradient.  ``i_full_scale`` is the column full-scale current
    (tile_rows * max cell current); codes occupy [0, 2^adc_bits - 1]."""
    levels = 2.0 ** cfg.adc_bits - 1.0
    x = torch.clamp(true_div(i_col, i_full_scale), 0.0, 1.0) * levels
    return true_div(ste_round(x), levels) * i_full_scale
