"""Mamba2 (SSD) blocks (PyTorch), as the reference models them: in_proj
-> (z, x, B, C, dt); a short causal depthwise conv on (x, B, C); a
per-head scalar decay a_t = exp(-exp(A_log) * dt_t); the SSD recurrence
through the shared chunked GLA (the decay broadcast over the state dim);
the skip D*x; the SiLU(z) gate; out_proj.  Zamba2's layout of these
blocks around one shared attention block is in ``models/model.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.lin_attn import chunked_gla, gla_decode_step


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_init(gen, cfg: Mamba2Config, device):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    conv_ch = di + 2 * n
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), h,
                                  device=device))
    return {
        "w_in": L.normal(gen, (d, 2 * di + 2 * n + h), d ** -0.5, device),
        "conv_w": L.normal(gen, (cfg.conv_width, conv_ch), 0.5, device),
        "conv_b": torch.zeros((conv_ch,), device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "dt_bias": torch.log(torch.expm1(dt)),
        "d_skip": torch.ones((h,), device=device),
        "norm": torch.ones((di,), device=device),
        "w_out": L.normal(gen, (di, d), di ** -0.5, device),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv of width W as W shifted adds, summed in the
    reference's order.  x: (B, S, C); w: (W, C); conv_state: (B, W-1, C),
    the decode carry.  Returns (silu(y), new_conv_state)."""
    bsz, s, c = x.shape
    wd = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((bsz, wd - 1, c), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                    # (B, S+W-1, C)
    y = b.to(x.dtype)[None, None]
    y = y + sum(xp[:, i:i + s] * w[i].to(x.dtype)[None, None]
                for i in range(wd))
    return L.silu(y), xp[:, -(wd - 1):]


def mamba2(p, cfg: Mamba2Config, x, state: Dict[str, Any],
           decode: bool = False):
    """x: (B, S, d); state: {"conv": (B, W-1, d_inner+2N), "ssm": (B, H,
    N, hd)}.  Returns (y, new_state)."""
    b, s, d = x.shape
    di, n, h, hd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    f32 = torch.float32

    proj = x @ p["w_in"].to(x.dtype)
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state["conv"])
    xin, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)

    dt = L.softplus(dt_raw.to(f32) + p["dt_bias"][None, None])  # (B,S,H)
    log_a = -torch.exp(p["a_log"])[None, None] * dt             # <= 0

    # GLA form: q = C, k = B (shared across heads), v = dt * x per head
    xin = xin.reshape(b, s, h, hd)
    v = xin.to(f32) * dt[..., None]
    q = cmat[:, :, None, :].to(f32).expand(b, s, h, n)
    k = bmat[:, :, None, :].to(f32).expand(b, s, h, n)
    log_w = log_a[..., None].expand(b, s, h, n)

    if decode:
        y, ssm = gla_decode_step(q[:, 0], k[:, 0], v[:, 0], log_w[:, 0],
                                 state["ssm"])
        y = y[:, None]
    else:
        y, ssm = chunked_gla(q, k, v, log_w, None, chunk=min(cfg.chunk, s),
                             state0=state["ssm"])
    y = y + xin.to(f32) * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = L.rmsnorm(y * L.silu(z), p["norm"])
    return y @ p["w_out"].to(x.dtype), {"conv": conv_state, "ssm": ssm}


def mamba2_state(cfg: Mamba2Config, batch: int, dtype=torch.bfloat16,
                 device=None):
    """The conv carry in ``dtype`` (bfloat16 by default, as the
    reference; a call returns it in the activations' dtype); the SSM
    state in float32 (it accumulates)."""
    return {"conv": torch.zeros((batch, cfg.conv_width - 1,
                                 cfg.d_inner + 2 * cfg.d_state), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state,
                                cfg.head_dim), dtype=torch.float32,
                               device=device)}


def mamba2_block_init(gen, cfg: Mamba2Config, device):
    return {"ln": torch.ones((cfg.d_model,), device=device),
            "mixer": mamba2_init(gen, cfg, device)}


def mamba2_block(p, cfg: Mamba2Config, x, state, decode: bool = False):
    h, new_state = mamba2(p["mixer"], cfg, L.rmsnorm(x, p["ln"]), state,
                          decode=decode)
    return x + h, new_state
