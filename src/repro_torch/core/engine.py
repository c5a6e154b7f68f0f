"""CrossStackEngine — tiles matmuls onto stacked crossbar pairs (PyTorch).

The counterpart of ``repro.core.engine``: any linear layer ``y = x @ W``
is *programmed* onto a grid of CrossStack tiles and executed with
bit-exact crossbar arithmetic:

  * K (input/row) dimension   -> tiles of ``tile_rows`` rows per plane
    (expansion mode sums two row tiles in analog before one ADC
    conversion; deep-net mode converts per tile),
  * N (output/col) dimension  -> tiles of ``tile_cols`` columns,
  * weights -> differential cell-code planes (quant.py),
  * inputs  -> two's-complement bit-serial pulse trains,
  * each (tile, slice, pulse) read passes through a saturating ADC before
    the digital shift-add recombine.

``matmul`` dispatches to the CUDA crossbar-MAC kernel when
``cfg.use_kernel`` (``kernels/crossbar_mac``) and to the plain reference
otherwise.  The analog (conductance-domain) path of the reference is
not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import quant
from repro_torch.core.device import DeviceConfig
from repro_torch.core.quant import QuantConfig, true_div
from repro_torch.core.timing import PAPER, CrossStackParams


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    tile_rows: int = 128
    tile_cols: int = 128
    quant: QuantConfig = QuantConfig()
    mode: str = "expansion"            # "expansion" | "deepnet"
    params: CrossStackParams = PAPER
    use_kernel: bool = False           # route MAC through the CUDA kernel
    swap_leakage: bool = False         # perturb reads with write-plane
    # leakage while a hot-swap is in flight (fidelity studies; breaks
    # bit-exactness of mid-swap reads by at most the ADC residual)
    device: DeviceConfig = DeviceConfig()  # vertical stack geometry

    @property
    def rows_per_adc(self) -> int:
        """Rows summed in analog before one ADC conversion."""
        return 2 * self.tile_rows if self.mode == "expansion" else self.tile_rows

    @property
    def stack_planes(self) -> int:
        """Planes stacked per cell site (the bank height N)."""
        return self.device.stack_planes


@dataclasses.dataclass
class ProgrammedLinear:
    """Crossbar-resident weights: differential cell-code planes + scales."""
    pos: torch.Tensor      # (S, T, R, N_pad) int8 cell codes, T row-tiles
    neg: torch.Tensor      # (S, T, R, N_pad) int8
    w_scale: torch.Tensor  # (1, N_pad) or scalar
    k: int                 # logical input dim
    n: int                 # logical output dim

    @property
    def n_devices(self) -> int:
        return 2 * self.pos.numel()  # pos + neg planes


def _pad_to(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    axis %= x.dim()
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad
    return F.pad(x, widths)


def program(w: torch.Tensor, cfg: EngineConfig) -> ProgrammedLinear:
    """Quantize and map a float (K, N) weight matrix onto crossbar tiles.

    The planes are written as int8 straight from the quantized weight
    (no int32 copy of the padded grid)."""
    k, n = w.shape
    q = cfg.quant
    w_int, w_scale = quant.quantize_weights(w, q)
    r = cfg.tile_rows
    t = -(-k // r)
    n_pad = -(-n // cfg.tile_cols) * cfg.tile_cols
    if q.per_channel:
        w_scale = _pad_to(w_scale, n_pad, axis=1)
    pos, neg = quant.to_slices(w_int, q, dtype=torch.int8,
                               out_shape=(t * r, n_pad))
    s = q.n_slices
    return ProgrammedLinear(pos.reshape(s, t, r, n_pad),
                            neg.reshape(s, t, r, n_pad), w_scale, k, n)


# ---------------------------------------------------------------------------
# Digital-twin execution (integer-exact; oracle for kernels/crossbar_mac)
# ---------------------------------------------------------------------------

def _adc_codes(acc: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """Saturating ADC in code units: acc holds per-column analog sums in
    [0, rows_per_adc * (base-1)]; returns the dequantized value on the
    same scale so recombination is a pure shift-add."""
    q = cfg.quant
    base = 2 ** q.bits_per_cell
    full_scale = cfg.rows_per_adc * (base - 1)
    levels = 2.0 ** q.adc_bits - 1.0
    lsb = full_scale / levels
    code = torch.clamp(torch.round(true_div(acc, lsb)), 0.0, levels)
    return code * torch.full((), lsb, dtype=acc.dtype, device=acc.device)


# every matmul dispatch lands in the global telemetry registry as
# crossstack_dispatch_total{path, geometry}
_DISPATCH = "crossstack_dispatch_total"


def _count_dispatch(path: str, pw: ProgrammedLinear) -> None:
    obs.registry().counter(
        _DISPATCH,
        help="engine.matmul dispatches per execution path, labeled by KxN "
             "geometry",
    ).inc(path=path, geometry=f"{pw.k}x{pw.n}")


class _PathCallsView(Mapping):
    """Read-only view of the registry's dispatch counters, summed across
    geometries (``path_calls["kernel"]``)."""

    _PATHS = ("kernel", "reference")

    def __getitem__(self, key: str) -> int:
        if key not in self._PATHS:
            raise KeyError(key)
        return int(obs.registry().total(_DISPATCH, path=key))

    def __iter__(self):
        return iter(self._PATHS)

    def __len__(self) -> int:
        return len(self._PATHS)

    def __eq__(self, other) -> bool:
        if isinstance(other, (Mapping, dict)):
            return dict(self) == dict(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return f"path_calls({dict(self)})"


path_calls = _PathCallsView()


def matmul(x: torch.Tensor, pw: ProgrammedLinear, cfg: EngineConfig,
           leak_codes=0.0) -> torch.Tensor:
    """Bit-exact crossbar execution of ``x @ W`` for x of shape (..., K).

    ``leak_codes`` is the common-mode write-plane leakage in pre-ADC code
    units — a float or a 0-d device tensor, which the kernel reads from
    device memory.
    """
    if cfg.use_kernel:
        from repro_torch.kernels.crossbar_mac import ops as cb_ops
        _count_dispatch("kernel", pw)
        return cb_ops.crossbar_matmul(x, pw, cfg, leak_codes=leak_codes)
    return matmul_reference(x, pw, cfg, leak_codes=leak_codes)


def _pulse_trains(x: torch.Tensor, pw: ProgrammedLinear,
                  cfg: EngineConfig):
    """Quantized, row-padded inputs as (in_bits, B, T, R) pulse trains,
    plus the per-row input scale."""
    q = cfg.quant
    xb = x.reshape(-1, x.shape[-1])                     # (B, K)
    x_int, x_scale = quant.quantize_inputs(xb, q)
    s, t, r, n_pad = pw.pos.shape
    x_int = _pad_to(x_int, t * r, axis=-1).reshape(-1, t, r)
    bits = quant.to_bit_serial(x_int, q)                # (b, B, T, R)
    return bits, x_scale


def matmul_reference(x: torch.Tensor, pw: ProgrammedLinear,
                     cfg: EngineConfig, leak_codes=0.0) -> torch.Tensor:
    """Loop reference: one (pulse, slice) step at a time, ADC fused — the
    order of the reference's ``lax.scan``, so peak memory stays
    O(B * T * N).  ``leak_codes`` is added to BOTH differential columns
    before each ADC conversion."""
    _count_dispatch("reference", pw)
    q = cfg.quant
    lead = x.shape[:-1]
    dev = x.device
    bits, x_scale = _pulse_trains(x, pw, cfg)
    bitw = quant.bit_weights(q, dev)                    # (b,)
    slcw = quant.slice_weights(q, dev)                  # (S,)
    s, t, r, n_pad = pw.pos.shape
    bsz = bits.shape[1]
    pair = cfg.mode == "expansion" and t % 2 == 0 and t >= 2

    y_acc = torch.zeros((bsz, n_pad), dtype=torch.float32, device=dev)
    for idx in range(bits.shape[0] * s):
        a, sl = idx // s, idx % s
        xa = bits[a]
        p_s = pw.pos[sl].to(torch.float32)
        n_s = pw.neg[sl].to(torch.float32)
        # analog column sums of ONE pulse against ONE cell plane: (B, T, N)
        acc_p = torch.einsum("btr,trn->btn", xa, p_s)
        acc_n = torch.einsum("btr,trn->btn", xa, n_s)
        if pair:
            # adjacent row-tiles stacked on the two planes: analog sum first
            acc_p = acc_p.reshape(bsz, t // 2, 2, n_pad).sum(dim=2)
            acc_n = acc_n.reshape(bsz, t // 2, 2, n_pad).sum(dim=2)
        d = (_adc_codes(acc_p + leak_codes, cfg)
             - _adc_codes(acc_n + leak_codes, cfg))
        y_acc = y_acc + bitw[a] * slcw[sl] * d.sum(dim=1)
    y = y_acc * x_scale * pw.w_scale[..., :n_pad]
    return y[:, : pw.n].reshape(*lead, pw.n)


def _matmul_reference_einsum(x: torch.Tensor, pw: ProgrammedLinear,
                             cfg: EngineConfig) -> torch.Tensor:
    """All-at-once einsum formulation: O(in_bits * S * B * T * N) peak
    memory; the oracle the loop reference is held against."""
    q = cfg.quant
    lead = x.shape[:-1]
    dev = x.device
    bits, x_scale = _pulse_trains(x, pw, cfg)
    bitw = quant.bit_weights(q, dev)
    slcw = quant.slice_weights(q, dev)
    s, t, r, n_pad = pw.pos.shape
    pos = pw.pos.to(torch.float32)
    neg = pw.neg.to(torch.float32)

    # per (pulse b, slice s, row-tile t): analog column sums
    acc_p = torch.einsum("abtr,strn->asbtn", bits, pos)
    acc_n = torch.einsum("abtr,strn->asbtn", bits, neg)
    if cfg.mode == "expansion" and t % 2 == 0 and t >= 2:
        acc_p = acc_p.reshape(*acc_p.shape[:3], t // 2, 2, n_pad).sum(dim=4)
        acc_n = acc_n.reshape(*acc_n.shape[:3], t // 2, 2, n_pad).sum(dim=4)
    acc_p = _adc_codes(acc_p, cfg)
    acc_n = _adc_codes(acc_n, cfg)
    y_int = torch.einsum("asbtn,a,s->bn", acc_p - acc_n, bitw, slcw)
    y = y_int * x_scale * pw.w_scale[..., :n_pad]
    return y[:, : pw.n].reshape(*lead, pw.n)


def linear(x: torch.Tensor, w: torch.Tensor, cfg: EngineConfig
           ) -> torch.Tensor:
    """Program-and-run convenience op (QAT / fidelity studies);
    differentiable through the straight-through quantizers."""
    return matmul(x, program(w, cfg), cfg)
