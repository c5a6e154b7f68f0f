"""Model building blocks for the dense decoder family (PyTorch): RMSNorm,
RoPE, GQA attention (qk-norm, dense and paged KV caches, chunked and
causal) and the SwiGLU MLP.

Pure functions over explicit param dicts, as in ``repro.models.layers``;
initializers take an explicit ``torch.Generator`` and device.  The
reference's logical sharding constraints have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.core.executor import crossbar_linear

Params = Dict[str, Any]


# -- initializers -------------------------------------------------------------

def normal(gen: torch.Generator, shape, scale: float, device,
           dtype=torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * scale).to(
        dtype)


# -- norms --------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-6):
    """Statistics in f32; the normalized tensor is cast back before the
    weight multiply, as in the reference."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(dtype)
    return normed * w.to(dtype)


# -- rotary embeddings ---------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e6, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e6):
    """x: (B, S, H, D), positions: (B, S) int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                      # (D/2,)
    ang = positions[..., None].to(torch.float32) * inv        # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 1e6
    kv_repeat: int = 1          # Megatron-style KV replication
    causal: bool = True
    q_chunk: int = 0            # 0 = unchunked; else chunk the query axis
    paged_kernel: bool = False  # paged decode via the CUDA kernels
    paged_stream_pages: int = 0  # streamed lane when the page table is >=
    # this many pages; 0 = always the gather-scratch lane
    paged_block_pages: int = 16  # pages per streamed block

    @property
    def kv_eff(self) -> int:
        return self.n_kv * self.kv_repeat


def attn_init(gen, cfg: AttnConfig, device) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    p: Params = {
        "wq": normal(gen, (d, cfg.n_heads, hd), d ** -0.5, device),
        "wk": normal(gen, (d, cfg.kv_eff, hd), d ** -0.5, device),
        "wv": normal(gen, (d, cfg.kv_eff, hd), d ** -0.5, device),
        "wo": normal(gen, (cfg.n_heads, hd, d), (cfg.n_heads * hd) ** -0.5,
                     device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device)
        p["k_norm"] = torch.ones((hd,), device=device)
    return p


def _qkv_proj(x, w, name):
    """q/k/v projection, routable onto resident crossbar tiles."""
    return crossbar_linear(
        x, w, name,
        digital=lambda: torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype)))


def _project_qkv(p, cfg: AttnConfig, x, positions):
    q = _qkv_proj(x, p["wq"], "wq")
    k = _qkv_proj(x, p["wk"], "wk")
    v = _qkv_proj(x, p["wv"], "wv")
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, cfg: AttnConfig, q_offset, kv_len=None):
    """Grouped scaled-dot-product attention on (B, S, H, D) tensors.

    q_offset: absolute position of q[.., 0] for causal masking — an int,
              or (B,) when slots sit at different depths.
    kv_len:   (B,) valid KV lengths (decode), or None for full.
    Logits are f32 (bf16 operands upcast: their products are exact).
    """
    b, sq, hq, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = hq // kv
    dev = q.device
    qg = q.reshape(b, sq, kv, g, hd)
    scale = hd ** -0.5
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if cfg.causal:
        qpos = (torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
                + torch.arange(sq, device=dev)[None])         # (B or 1, sq)
        mask = qpos[:, :, None] >= torch.arange(sk, device=dev)[None, None]
        logits = torch.where(mask[:, None, None], logits, -1e30)
    if kv_len is not None:
        valid = torch.arange(sk, device=dev)[None, :] < kv_len[:, None]
        logits = torch.where(valid[:, None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(b, sq, hq, hd)


def _chunked_sdpa(q, k, v, cfg: AttnConfig, kv_len=None, q_offset=0):
    """Q-axis-chunked SDPA: bounds the scores working set to
    (B, H, q_chunk, S_k)."""
    b, sq = q.shape[:2]
    if not (cfg.q_chunk and sq > cfg.q_chunk and sq % cfg.q_chunk == 0):
        return _sdpa(q, k, v, cfg, q_offset, kv_len=kv_len)
    nq = sq // cfg.q_chunk
    qs = q.reshape(b, nq, cfg.q_chunk, *q.shape[2:])
    outs = [_sdpa(qs[:, i], k, v, cfg, q_offset + i * cfg.q_chunk,
                  kv_len=kv_len) for i in range(nq)]
    return torch.stack(outs, dim=1).reshape(b, sq, *q.shape[2:])


def attention(p, cfg: AttnConfig, x, positions, cache=None):
    """Returns (y, new_cache).

    cache: None (prefill-no-cache), a dense dict with k, v
    (B, S_max, kv_eff, hd) and "len" (B,) int32, or a paged dict that
    also carries "pt" (B, P_seq) and whose k/v are page pools
    (n_pages + 1, page_size, kv_eff, hd).

    The KV scatter and the fill marker update the cache's k/v and "len"
    tensors IN PLACE (the caller owns them; the reference returns updated
    copies), with shapes fixed by the window alone, so a CUDA graph can
    hold the step; the returned cache holds the same tensors.
    """
    b, sq, _ = x.shape
    if cache is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
        out = _chunked_sdpa(q, k, v, cfg)
        new_cache = None
    elif "pt" in cache:
        # paged decode: route this window's K/V writes through the page
        # table, then attend over the row's logical view.  Physical page
        # 0 is the reserved null page — unallocated entries point at it,
        # so out-of-range writes land there and gathers through it read
        # only masked positions.
        q, k, v = _project_qkv(p, cfg, x, positions)
        pos = cache["len"].clone()                        # (B,)
        pt = cache["pt"]                                  # (B, P_seq)
        ck, cv = cache["k"], cache["v"]
        ps = ck.shape[1]
        depth = pt.shape[1] * ps                          # == max_len
        s_idx = (pos[:, None].to(torch.int64)
                 + torch.arange(sq, device=x.device)[None])  # (B, sq)
        inb = s_idx < depth
        lpage = torch.clamp(s_idx // ps, max=pt.shape[1] - 1)
        phys = torch.where(inb, torch.gather(pt.to(torch.int64), 1, lpage),
                           0)
        slot = torch.where(inb, s_idx % ps, 0)
        ck[phys, slot] = k.to(ck.dtype)
        cv[phys, slot] = v.to(cv.dtype)
        new_len = cache["len"].add_(sq)
        if cfg.paged_kernel:
            from repro_torch.kernels.paged_attention import paged_attention
            out = paged_attention(q, ck, cv, pt, new_len, pos,
                                  causal=cfg.causal,
                                  stream_min_pages=cfg.paged_stream_pages,
                                  block_pages=cfg.paged_block_pages)
        else:
            # gather width is exactly max_len (page_size | max_len), so
            # the SDPA sees the dense branch's shapes
            ptl = pt.to(torch.int64)
            gk = ck[ptl].reshape(b, depth, *ck.shape[2:])
            gv = cv[ptl].reshape(b, depth, *cv.shape[2:])
            out = _chunked_sdpa(q, gk, gv, cfg, kv_len=new_len,
                                q_offset=pos)
        new_cache = cache
    else:
        # decode: append this step's K/V at each row's own fill position;
        # positions past the cache depth are dropped, as the reference's
        # out-of-bounds scatter drops them
        q, k, v = _project_qkv(p, cfg, x, positions)
        pos = cache["len"].clone()                        # (B,)
        ck, cv = cache["k"], cache["v"]
        dense_append(ck, k, pos)
        dense_append(cv, v, pos)
        new_len = cache["len"].add_(sq)
        out = _chunked_sdpa(q, ck, cv, cfg, kv_len=new_len, q_offset=pos)
        new_cache = cache
    y = crossbar_linear(
        out, p["wo"], "wo",
        digital=lambda: torch.einsum("bshk,hkd->bsd", out,
                                     p["wo"].to(x.dtype)))
    return y, new_cache


def dense_append(c: torch.Tensor, x: torch.Tensor, pos: torch.Tensor
                 ) -> None:
    """Write window ``x`` (B, sq, ...) into the dense cache ``c`` (B,
    S_max, ...) at row b's positions ``pos[b] + j``, in place; positions
    at or past ``S_max`` are dropped.  Every shape is fixed by the window
    (no mask indexing, no host sync): a dropped position is routed to
    ``S_max - 1`` and carries the value that slot ends with (the window's
    own entry for it, else the slot's old value), so every write to it is
    the same write."""
    b, sq = x.shape[:2]
    depth = c.shape[1]
    dev = x.device
    rows = torch.arange(b, device=dev)
    s_idx = pos[:, None].to(torch.int64) + torch.arange(sq, device=dev)[None]
    keep = s_idx < depth                                  # (B, sq)
    # the window position that lands on the last slot, if any
    j_last = depth - 1 - pos.to(torch.int64)              # (B,)
    hit = (j_last >= 0) & (j_last < sq)
    last = torch.where(hit.reshape(b, *[1] * (x.dim() - 2)),
                       x[rows, j_last.clamp(0, sq - 1)].to(c.dtype),
                       c[:, depth - 1])
    val = torch.where(keep.reshape(b, sq, *[1] * (x.dim() - 2)),
                      x.to(c.dtype), last[:, None])
    c[rows[:, None].expand(b, sq), s_idx.clamp(max=depth - 1)] = val


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    shape = (batch, max_len, cfg.kv_eff, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def paged_init_cache(cfg: AttnConfig, batch: int, max_len: int,
                     n_pages: int, page_size: int, dtype=torch.bfloat16,
                     device=None):
    """Paged KV cache for one layer: a physical page pool plus per-row
    page tables.  Page 0 is the reserved null page (serve/kv_pool.py);
    ``page_size`` must divide ``max_len``."""
    if max_len % page_size:
        raise ValueError(f"page_size {page_size} must divide max_len "
                         f"{max_len}")
    shape = (n_pages + 1, page_size, cfg.kv_eff, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "pt": torch.zeros((batch, max_len // page_size),
                              dtype=torch.int32, device=device)}


def paged_copy_page(layers, src: int, dst: int):
    """Duplicate physical page ``src`` into ``dst`` across every layer's
    K/V pool, in place — the device half of copy-on-write.  ``layers``
    holds ``k``/``v`` of shape (n_layers, n_pages + 1, page_size, kv_eff,
    head_dim); page tables and fill markers are untouched."""
    for key in ("k", "v"):
        layers[key][:, dst] = layers[key][:, src]
    return layers


# -- MLPs ----------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, act: str, device) -> Params:
    if act != "swiglu":
        raise NotImplementedError(
            f"mlp act {act!r} is a later slice of the PyTorch port (this "
            f"slice serves the swiglu dense family)")
    return {"wi": normal(gen, (d_model, d_ff), d_model ** -0.5, device),
            "wg": normal(gen, (d_model, d_ff), d_model ** -0.5, device),
            "wo": normal(gen, (d_ff, d_model), d_ff ** -0.5, device)}


def silu(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference rounds it: ``g * (1 / (1 +
    exp(-g)))`` with the exp, the add, the divide and the product each
    rounded to ``g``'s dtype.  ``F.silu`` rounds once, and at bfloat16
    differs from the reference in a third of the outputs or more."""
    t = torch.exp(-g)
    t = 1 + t
    t = 1 / t
    return g * t


def mlp(p, x, act: str = "swiglu"):
    if act != "swiglu":
        raise NotImplementedError(f"mlp act {act!r} is not ported yet")
    h = crossbar_linear(x, p["wi"], "wi",
                        digital=lambda: x @ p["wi"].to(x.dtype))
    g = crossbar_linear(x, p["wg"], "wg",
                        digital=lambda: x @ p["wg"].to(x.dtype))
    h = silu(g) * h
    return crossbar_linear(
        h, p["wo"], "wo",
        digital=lambda: torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype)))
