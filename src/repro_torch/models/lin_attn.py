"""Chunk-parallel linear attention with per-channel data-dependent decay
(PyTorch), shared by RWKV6 (Finch) and Mamba2 (SSD): the diagonal-gated
state recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: H x dk x dv)
    y_t = q_t S_t  (+ the u bonus for RWKV6)

computed as the reference computes it, in three pieces:

  1. intra-chunk: a scan over the ``chunk`` positions, all chunks at once,
     giving per-position outputs and each chunk's local end state (every
     factor a product of decays <= 1);
  2. inter-chunk: the running combination of (total decay, local state)
     pairs, chunk by chunk.  The reference's ``jax.lax.associative_scan``
     applies the same ``combine`` in a log-depth tree; a loop associates
     the products differently, so the two agree to rounding, not bitwise;
  3. injection: y_i += (q_i * cumdecay_i) . S_prev(chunk(i)).

Decode is the plain O(1) recurrence on a carried state; ``naive_gla`` is
the sequential oracle the tests hold the chunked form against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def chunked_gla(q, k, v, log_w, u: Optional[torch.Tensor] = None,
                chunk: int = 16, state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_w: (B, S, H, dk); v: (B, S, H, dv); u: (H, dk) or None.

    Returns (y: (B, S, H, dv), final_state: (B, H, dk, dv)).  log_w must
    be <= 0 (decay in (0, 1]).  ``u`` selects RWKV6's order (read the
    state, with the bonus, before the update) over Mamba2's (update, then
    read); ``state0`` is the incoming state (zeros when None).
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    s_orig = s
    if s % chunk:
        # pad with zero k/v (no state contribution) and unit decay
        # (log_w = 0): the final state is unchanged by padded steps
        pad = chunk - s % chunk
        q, k, v, log_w = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (q, k, v, log_w))
        s += pad
    nc = s // chunk

    cq = q.reshape(b, nc, chunk, h, dk)
    ck = k.reshape(b, nc, chunk, h, dk)
    cv = v.reshape(b, nc, chunk, h, dv)
    clw = log_w.reshape(b, nc, chunk, h, dk)
    w = torch.exp(clw)

    # ---- 1. intra-chunk: a scan over positions, all chunks at once
    read_before = u is not None
    s_loc = torch.zeros((b, nc, h, dk, dv), dtype=q.dtype, device=q.device)
    ys = []
    for j in range(chunk):
        qj, kj, vj, wj = cq[:, :, j], ck[:, :, j], cv[:, :, j], w[:, :, j]
        if read_before:
            ys.append(torch.einsum("bnhk,bnhkv->bnhv", qj, s_loc))
            s_loc = wj[..., None] * s_loc + kj[..., None] * vj[..., None, :]
        else:
            s_loc = wj[..., None] * s_loc + kj[..., None] * vj[..., None, :]
            ys.append(torch.einsum("bnhk,bnhkv->bnhv", qj, s_loc))
    y_intra = torch.stack(ys, dim=2)                   # (B, nc, L, H, dv)

    # u bonus (RWKV6): the current token reads (u * k_t) v_t
    if u is not None:
        bonus = torch.einsum("bnlhk,hk,bnlhk->bnlh", cq, u, ck)
        y_intra = y_intra + bonus[..., None] * cv

    # ---- 2. inter-chunk: running (decay, state) combination
    total = torch.exp(clw.sum(dim=2))                  # (B, nc, H, dk)
    decs, states = [total[:, 0]], [s_loc[:, 0]]
    for n in range(1, nc):
        decs.append(decs[-1] * total[:, n])
        states.append(total[:, n][..., None] * states[-1] + s_loc[:, n])
    dec = torch.stack(decs, dim=1)                     # (B, nc, H, dk)
    # state BEFORE each chunk: chunk 0 sees state0 (or zeros)
    if state0 is None:
        state0 = torch.zeros((b, h, dk, dv), dtype=q.dtype, device=q.device)
    prev = torch.stack([state0] + states[:-1], dim=1)  # (B, nc, H, dk, dv)
    # an incoming state0 flows into the later chunks
    if nc > 1:
        prev = torch.cat([prev[:, :1], prev[:, 1:] + dec[:, :-1, ..., None]
                          * state0[:, None]], dim=1)

    # ---- 3. inject the inter-chunk history into per-position outputs
    cum = torch.cumsum(clw, dim=2)                     # (B, nc, L, H, dk)
    if read_before:
        # S_{t-1} saw decays w_1..w_{t-1} only: exclusive cumulative decay
        cum = cum - clw
    q_scaled = cq * torch.exp(cum)
    y_inter = torch.einsum("bnlhk,bnhkv->bnlhv", q_scaled, prev)

    y = (y_intra + y_inter).reshape(b, s, h, dv)[:, :s_orig]
    final = dec[:, -1, ..., None] * state0 + states[-1]
    return y, final


def gla_decode_step(q, k, v, log_w, state, u: Optional[torch.Tensor] = None):
    """One-token recurrence.  q/k/log_w: (B, H, dk); v: (B, H, dv);
    state: (B, H, dk, dv).  Returns (y: (B, H, dv), new_state)."""
    w = torch.exp(log_w)
    kv = k[..., None] * v[..., None, :]
    new_state = w[..., None] * state + kv
    if u is not None:   # RWKV6: read S_{t-1} + bonus, then update
        y = torch.einsum("bhk,bhkv->bhv", q, state + u[None, ..., None] * kv)
    else:               # Mamba2: update, then read
        y = torch.einsum("bhk,bhkv->bhv", q, new_state)
    return y, new_state


def naive_gla(q, k, v, log_w, u: Optional[torch.Tensor] = None,
              state0: Optional[torch.Tensor] = None):
    """The O(S) sequential recurrence in float32: the oracle."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    f32 = torch.float32
    st = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
          if state0 is None else state0.to(f32))
    ys = []
    for t in range(s):
        w = torch.exp(log_w[:, t].to(f32))
        kv = k[:, t, ..., None].to(f32) * v[:, t, :, None, :].to(f32)
        qt = q[:, t].to(f32)
        if u is not None:
            ys.append(torch.einsum("bhk,bhkv->bhv", qt,
                                   st + u[None, ..., None] * kv))
            st = w[..., None] * st + kv
        else:
            st = w[..., None] * st + kv
            ys.append(torch.einsum("bhk,bhkv->bhv", qt, st))
    return torch.stack(ys, dim=1), st
