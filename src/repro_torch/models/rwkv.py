"""RWKV6 "Finch" (PyTorch): an attention-free RNN with data-dependent
decay, as the reference models it.

Per layer: time-mix (the GLA recurrence with the low-rank
data-dependent decay, the Finch signature) and channel-mix (a
token-shifted squared-ReLU FFN).  The token-shift lerp coefficients of
r/k/v/w/g are static, the decay path keeps its dynamic low-rank form,
as in the reference.

Decode state per layer: the two token-shift carries (the activation
dtype) and the GLA state (float32).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models.lin_attn import chunked_gla, gla_decode_step


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    n_layers: int
    head_dim: int = 64
    decay_lora: int = 64
    ffn_mult: float = 3.5
    vocab: int = 65536
    chunk: int = 16

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim

    @property
    def d_ffn(self) -> int:
        return int(self.d_model * self.ffn_mult)


def time_mix_init(gen, cfg: RWKVConfig, device):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    n = lambda shape, scale: L.normal(gen, shape, scale, device)  # noqa: E731
    return {
        "mu": torch.full((5, d), 0.5, device=device),  # r, k, v, w, g
        "wr": n((d, h, hd), d ** -0.5),
        "wk": n((d, h, hd), d ** -0.5),
        "wv": n((d, h, hd), d ** -0.5),
        "wg": n((d, h, hd), d ** -0.5),
        "wo": n((h, hd, d), (h * hd) ** -0.5),
        "w0": -6.0 + 5.0 * torch.linspace(0.0, 1.0, h * hd,
                                          device=device).reshape(h, hd),
        "wd_a": n((d, cfg.decay_lora), d ** -0.5),
        "wd_b": n((cfg.decay_lora, h, hd), cfg.decay_lora ** -0.5),
        "u": n((h, hd), 0.3),
        "ln_x": torch.ones((h * hd,), device=device),
    }


def _shift(x, last):
    """Token shift: x_{t-1}; the first position sees ``last`` (the
    carry)."""
    return torch.cat([last.to(x.dtype)[:, None], x[:, :-1]], dim=1)


def _decay(p, xw):
    """Data-dependent decay (Finch): log w = -exp(w0 + lora(xw)) <= 0,
    the low-rank product in xw's dtype, the rest in float32."""
    t = xw @ p["wd_a"].to(xw.dtype)
    lora = torch.einsum("bsr,rhk->bshk", t, p["wd_b"].to(xw.dtype))
    return -torch.exp(p["w0"].to(torch.float32)
                      + torch.tanh(lora).to(torch.float32) * 0.5)


def time_mix(p, cfg: RWKVConfig, x, shift_last, gla_state=None,
             decode: bool = False):
    """x: (B, S, d).  Returns (y, (new_shift_last, new_gla_state))."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    xs = _shift(x, shift_last)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))

    def proj(xi, w):
        return torch.einsum("bsd,dhk->bshk", xi, w.to(x.dtype))

    r, k, v, g = (proj(xr, p["wr"]), proj(xk, p["wk"]), proj(xv, p["wv"]),
                  proj(xg, p["wg"]))
    log_w = _decay(p, xw)                                  # (B,S,H,hd) f32
    u = p["u"].to(f32)
    if decode:
        y, new_state = gla_decode_step(
            r[:, 0].to(f32), k[:, 0].to(f32), v[:, 0].to(f32), log_w[:, 0],
            gla_state, u)
        y = y[:, None]
    else:
        y, new_state = chunked_gla(r.to(f32), k.to(f32), v.to(f32), log_w,
                                   u, chunk=min(cfg.chunk, s),
                                   state0=gla_state)
    y = y.reshape(b, s, h * hd)
    y = L.rmsnorm(y, p["ln_x"])                            # group-norm-ish
    y = y.to(x.dtype) * L.silu(g.reshape(b, s, h * hd))
    out = torch.einsum("bshk,hkd->bsd", y.reshape(b, s, h, hd),
                       p["wo"].to(x.dtype))
    return out, (x[:, -1], new_state)


def channel_mix_init(gen, cfg: RWKVConfig, device):
    d, f = cfg.d_model, cfg.d_ffn
    return {"mu": torch.full((2, d), 0.5, device=device),
            "wk": L.normal(gen, (d, f), d ** -0.5, device),
            "wv": L.normal(gen, (f, d), f ** -0.5, device),
            "wr": L.normal(gen, (d, d), d ** -0.5, device)}


def channel_mix(p, x, shift_last):
    xs = _shift(x, shift_last)
    mu = p["mu"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = L.relu2(xk @ p["wk"].to(x.dtype))
    kv = k @ p["wv"].to(x.dtype)
    y = L.sigmoid(xr @ p["wr"].to(x.dtype)) * kv
    return y, x[:, -1]


def block_init(gen, cfg: RWKVConfig, device):
    return {"ln1": torch.ones((cfg.d_model,), device=device),
            "ln2": torch.ones((cfg.d_model,), device=device),
            "tm": time_mix_init(gen, cfg, device),
            "cm": channel_mix_init(gen, cfg, device)}


def block(p, cfg: RWKVConfig, x, state, decode: bool = False):
    """state: dict(tm_shift (B, d), cm_shift (B, d), gla (B, H, dk, dv)).
    Returns (x, new_state)."""
    h, st = time_mix(p["tm"], cfg, L.rmsnorm(x, p["ln1"]),
                     state["tm_shift"], state["gla"], decode=decode)
    x = x + h
    h, cm_shift = channel_mix(p["cm"], L.rmsnorm(x, p["ln2"]),
                              state["cm_shift"])
    x = x + h
    return x, {"tm_shift": st[0], "cm_shift": cm_shift, "gla": st[1]}


def init_state(cfg: RWKVConfig, batch: int, dtype=torch.bfloat16,
               device=None):
    """Decode state: the token-shift carries in ``dtype`` (bfloat16 by
    default, as the reference; a call returns them in the activations'
    dtype) and the GLA state, always float32 (the recurrence
    accumulates)."""
    h, hd = cfg.n_heads, cfg.head_dim
    return {"tm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device),
            "cm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device),
            "gla": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                               device=device)}
