"""Model building blocks (PyTorch): RMSNorm and LayerNorm, RoPE and
Qwen2-VL's M-RoPE, GQA attention (qk-norm, dense and paged KV caches,
chunked, causal, bidirectional and cross), the SwiGLU, squared-ReLU and
GELU MLPs, the token-dropping MoE block and its load-balance loss, and
the reference's rounding of ``jax.nn.sigmoid``, ``jax.nn.silu`` and
``jax.nn.softplus``.

Pure functions over explicit param dicts, as in ``repro.models.layers``;
initializers take an explicit ``torch.Generator`` and device.
Activations carry the reference's logical sharding constraints
(``distributed/sharding.py``: the identity without installed rules), and
``cache_specs``/``paged_cache_specs`` give the caches' logical axes.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.executor import crossbar_linear
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import logical_constraint as lc
from repro_torch.distributed.sharding import tp_bf16_matmul
from repro_torch.kernels.paged_attention.ref import as_bytes, take_pages

Params = Dict[str, Any]


# -- initializers -------------------------------------------------------------

def normal(gen: torch.Generator, shape, scale: float, device,
           dtype=torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * scale).to(
        dtype)


# -- KV-cache storage ------------------------------------------------------------

#: the fp8 KV-cache type (``ModelConfig.kv_dtype``)
FP8 = torch.float8_e4m3fn
#: the largest magnitude that rounds to e4m3's 448 (the tie rounds to
#: even); past it ``jnp.astype(float8_e4m3fn)`` gives NaN
_E4M3_LIMIT = 464.0


def cache_cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in the cache's dtype with the reference's cast semantics
    (``x.astype(dtype)`` in JAX).  At float8_e4m3fn torch saturates where
    JAX gives NaN: every |x| past 464 (that is, rounding past 448) and
    +-inf becomes NaN, byte 0x7f or 0xff by the sign, as JAX writes it,
    and a NaN keeps its sign the same way.  Elementwise ops of fixed shape
    only (no host sync), the same on the CPU and on the card."""
    if dtype != FP8:
        return x.to(dtype)
    nan = ~(x.abs() <= _E4M3_LIMIT)                  # past 464, inf, NaN
    bits = x.clamp(-448.0, 448.0).to(FP8).view(torch.uint8)
    nan_bits = (torch.signbit(x).to(torch.uint8) << 7) | 0x7F
    return torch.where(nan, nan_bits, bits).view(FP8)


def cache_zeros(shape, dtype, device) -> torch.Tensor:
    """A zeroed cache tensor (an fp8 one zeroed as bytes)."""
    if dtype == FP8:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(FP8)
    return torch.zeros(shape, dtype=dtype, device=device)


# -- norms --------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-6):
    """Statistics in f32; the normalized tensor is cast back before the
    weight multiply, as in the reference."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(dtype)
    return normed * w.to(dtype)


def layernorm(x, p, eps: float = 1e-5):
    """LayerNorm with weight ``p["w"]`` and bias ``p["b"]``, all in f32
    and cast back at the end, as the reference; the variance is the
    population variance (``jnp.var``)."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["w"] + p["b"]).to(dtype)


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


def mrope_sections(n: int):
    """Qwen2-VL's default split of the ``n = head_dim / 2`` frequency
    slots into (temporal, height, width) sections, 1 : 1.5 : 1.5."""
    t = n // 4
    h = (n - t) // 2
    return (t, h, n - t - h)


def apply_mrope(x, positions_thw, theta: float = 1e6, sections=None):
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); positions_thw: (B, S,
    3) = (t, h, w) ids.  Frequency slot i rotates by the position stream
    of its section; text tokens carry t == h == w, which is plain RoPE."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                      # (D/2,)
    n = d // 2
    sections = sections or mrope_sections(n)
    assert sum(sections) == n, (sections, n)
    # slot i's section, made on the device (no host copy, so a captured
    # decode step can hold it): the count of section ends at or below i
    slot = torch.arange(n, device=x.device)
    sec_ids = torch.zeros_like(slot)
    for end in itertools.accumulate(sections[:-1]):
        sec_ids += slot >= end
    pos = positions_thw.to(torch.float32)[..., sec_ids]       # (B, S, D/2)
    ang = pos * inv
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
    mrope: bool = False         # Qwen2-VL: positions are (B, S, 3) ids
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
        digital=lambda: shd.einsum("bsd,dhk->bshk", x, w.to(x.dtype)))


def _project_qkv(p, cfg: AttnConfig, x, positions):
    q = _qkv_proj(x, p["wq"], "wq")
    k = _qkv_proj(x, p["wk"], "wk")
    v = _qkv_proj(x, p["wv"], "wv")
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = lc(q, ("batch", None, "act_heads", None))
    k = lc(k, ("batch", None, "act_kv_heads", None))
    v = lc(v, ("batch", None, "act_kv_heads", None))
    return q, k, v


def _sdpa(q, k, v, cfg: AttnConfig, q_offset, kv_len=None,
          cross: bool = False):
    """Grouped scaled-dot-product attention on (B, S, H, D) tensors.

    q_offset: absolute position of q[.., 0] for causal masking — an int,
              or (B,) when slots sit at different depths.
    kv_len:   (B,) valid KV lengths (decode), or None for full.
    cross:    cross-attention onto an encoder's K/V: no causal mask.
    Logits are f32 (bf16 operands upcast: their products are exact).  A
    low-precision (fp8) cache is upcast to q's dtype first, as the
    reference does, so the weights round to q's dtype before P.V.
    """
    b, sq, hq, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.dtype != q.dtype:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    g = hq // kv
    dev = q.device
    qg = q.reshape(b, sq, kv, g, hd)
    scale = hd ** -0.5
    logits = shd.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                        k.to(torch.float32)) * scale
    if cfg.causal and not cross:
        if isinstance(q_offset, int):   # no host value copied to the card
            qpos = torch.arange(q_offset, q_offset + sq, device=dev)[None]
        else:
            qpos = (q_offset.reshape(-1, 1)
                    + torch.arange(sq, device=dev)[None])     # (B, sq)
        mask = qpos[:, :, None] >= torch.arange(sk, device=dev)[None, None]
        logits = torch.where(mask[:, None, None], logits, -1e30)
    if kv_len is not None:
        valid = torch.arange(sk, device=dev)[None, :] < kv_len[:, None]
        logits = torch.where(valid[:, None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = shd.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(b, sq, hq, hd)


def _chunked_sdpa(q, k, v, cfg: AttnConfig, kv_len=None, q_offset=0,
                  cross: bool = False):
    """Q-axis-chunked SDPA: bounds the scores working set to
    (B, H, q_chunk, S_k)."""
    b, sq = q.shape[:2]
    if not (cfg.q_chunk and sq > cfg.q_chunk and sq % cfg.q_chunk == 0):
        return _sdpa(q, k, v, cfg, q_offset, kv_len=kv_len, cross=cross)
    nq = sq // cfg.q_chunk
    qs = q.reshape(b, nq, cfg.q_chunk, *q.shape[2:])
    outs = [_sdpa(qs[:, i], k, v, cfg, q_offset + i * cfg.q_chunk,
                  kv_len=kv_len, cross=cross) for i in range(nq)]
    return torch.stack(outs, dim=1).reshape(b, sq, *q.shape[2:])


def attention(p, cfg: AttnConfig, x, positions, cache=None, cross_kv=None,
              kv_len=None):
    """Returns (y, new_cache).

    cache: None (prefill-no-cache), a dense dict with k, v
    (B, S_max, kv_eff, hd) and "len" (B,) int32, or a paged dict that
    also carries "pt" (B, P_seq) and whose k/v are page pools
    (n_pages + 1, page_size, kv_eff, hd).
    cross_kv: (k, v) of an encoder's output for cross-attention: only q
    is projected (no rotary position), nothing is masked but past
    ``kv_len``, and ``cache`` passes through.

    The KV scatter and the fill marker update the cache's k/v and "len"
    tensors IN PLACE (the caller owns them; the reference returns updated
    copies), with shapes fixed by the window alone, so a CUDA graph can
    hold the step; the returned cache holds the same tensors.
    """
    b, sq, _ = x.shape
    if cross_kv is not None:
        q = _qkv_proj(x, p["wq"], "wq")
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"])
        k, v = cross_kv
        out = _chunked_sdpa(q, k, v, cfg, kv_len=kv_len, cross=True)
        new_cache = cache
    elif cache is None:
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
        as_bytes(ck)[phys, slot] = as_bytes(cache_cast(k, ck.dtype))
        as_bytes(cv)[phys, slot] = as_bytes(cache_cast(v, cv.dtype))
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
            gk = take_pages(ck, ptl).reshape(b, depth, *ck.shape[2:])
            gv = take_pages(cv, ptl).reshape(b, depth, *cv.shape[2:])
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
        if isinstance(ck, DTensor) and torch.is_grad_enabled():
            # a sharded cache under autograd (the dry run's training
            # cells): written out of place, so autograd sees the writes
            ck = cache["k"] = _sharded_append(ck, k, pos, in_place=False)
            cv = cache["v"] = _sharded_append(cv, v, pos, in_place=False)
        else:
            dense_append(ck, k, pos)
            dense_append(cv, v, pos)
        new_len = cache["len"].add_(sq)
        out = _chunked_sdpa(q, ck, cv, cfg, kv_len=new_len, q_offset=pos)
        new_cache = cache
    y = crossbar_linear(
        out, p["wo"], "wo",
        digital=lambda: shd.einsum("bshk,hkd->bsd", out,
                                   p["wo"].to(x.dtype)))
    return lc(y, ("batch", "seq", "act_embed")), new_cache


def dense_append(c: torch.Tensor, x: torch.Tensor, pos: torch.Tensor,
                 offset: int = 0) -> None:
    """Write window ``x`` (B, sq, ...) into the dense cache ``c`` (B,
    S_max, ...) at row b's positions ``pos[b] + j``, in place, cast as
    :func:`cache_cast` casts; positions at or past ``S_max`` are dropped.
    Every shape is fixed by the window (no mask indexing, no host sync): a
    dropped position is routed to ``S_max - 1`` and carries the value that
    slot ends with (the window's own entry for it, else the slot's old
    value), so every write to it is the same write.  An fp8 cache moves
    as bytes.  ``offset``: ``c`` holds the positions from ``offset`` on
    (a sequence shard), so positions before it are dropped too.  A
    DTensor cache is written shard by shard (:func:`_sharded_append`)."""
    if isinstance(c, DTensor):
        return _sharded_append(c, x, pos)
    b, sq = x.shape[:2]
    depth = c.shape[1]
    dev = x.device
    x = as_bytes(cache_cast(x, c.dtype))
    c = as_bytes(c)
    rows = torch.arange(b, device=dev)
    start = pos.to(torch.int64)
    if offset:
        start = start - offset
    s_idx = start[:, None] + torch.arange(sq, device=dev)[None]
    keep = s_idx < depth                                  # (B, sq)
    if offset:
        keep = keep & (s_idx >= 0)
    # the window position that lands on the last slot, if any
    j_last = depth - 1 - start                            # (B,)
    hit = (j_last >= 0) & (j_last < sq)
    last = torch.where(hit.reshape(b, *[1] * (x.dim() - 2)),
                       x[rows, j_last.clamp(0, sq - 1)], c[:, depth - 1])
    val = torch.where(keep.reshape(b, sq, *[1] * (x.dim() - 2)), x,
                      last[:, None])
    dest = (torch.where(keep, s_idx, depth - 1) if offset
            else s_idx.clamp(max=depth - 1))
    c[rows[:, None].expand(b, sq), dest] = val


def _sharded_append(c, x, pos, in_place: bool = True):
    """:func:`dense_append` on a DTensor cache: every rank writes the
    window into its own shard (DTensor has no sharding of an in-place
    ``index_put_`` that keeps the cache's placements).  The window is
    brought to the cache's placements with its sequence dim whole, the
    fill markers to the cache's batch split; a rank holding a sequence
    shard writes only the positions that fall in it.  ``in_place=False``
    writes a copy of each shard and returns the new cache (autograd
    cannot follow a write into a DTensor's shard in place)."""
    mesh = c.device_mesh
    cp = list(c.placements)
    xp = [Replicate() if (p.is_shard() and p.dim == 1) else p for p in cp]
    pp = [Shard(0) if (p.is_shard() and p.dim == 0) else Replicate()
          for p in cp]
    x = _on_mesh(x, mesh).redistribute(mesh, xp)
    pos = _on_mesh(pos, mesh).redistribute(mesh, pp)
    coord = mesh.get_coordinate()
    shard = 0
    for i, p in enumerate(cp):
        if p.is_shard() and p.dim == 1:
            shard = shard * mesh.size(i) + coord[i]
    local = c.to_local()
    if not in_place:
        local = local.clone()
    dense_append(local, x.to_local(), pos.to_local(),
                 offset=shard * local.shape[1])
    if in_place:
        return None
    return DTensor.from_local(local, mesh, cp, run_check=False,
                              shape=c.shape, stride=c.stride())


def _on_mesh(t, mesh):
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None, like=None):
    """A zero dense cache; ``like`` (an activation of the step) makes it
    on ``like``'s placements under installed rules (``sharding.zeros``:
    each rank makes only its shard)."""
    shape = (batch, max_len, cfg.kv_eff, cfg.head_dim)
    if isinstance(like, DTensor):
        specs = cache_specs(cfg)
        return {"k": shd.zeros(shape, specs["k"], like, dtype),
                "v": shd.zeros(shape, specs["v"], like, dtype),
                "len": shd.zeros((batch,), specs["len"], like, torch.int32)}
    return {"k": cache_zeros(shape, dtype, device),
            "v": cache_zeros(shape, dtype, device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_specs(cfg: AttnConfig):
    return {"k": ("batch", "kv_seq", "act_kv_heads", None),
            "v": ("batch", "kv_seq", "act_kv_heads", None),
            "len": ("batch",)}


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
    return {"k": cache_zeros(shape, dtype, device),
            "v": cache_zeros(shape, dtype, device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "pt": torch.zeros((batch, max_len // page_size),
                              dtype=torch.int32, device=device)}


def paged_cache_specs(cfg: AttnConfig):
    # the page axis is unsharded: pages are lane-local working state
    return {"k": (None, None, "act_kv_heads", None),
            "v": (None, None, "act_kv_heads", None),
            "len": ("batch",), "pt": ("batch", None)}


def paged_copy_page(layers, src: int, dst: int):
    """Duplicate physical page ``src`` into ``dst`` across every layer's
    K/V pool, in place — the device half of copy-on-write.  ``layers``
    holds ``k``/``v`` of shape (n_layers, n_pages + 1, page_size, kv_eff,
    head_dim); page tables and fill markers are untouched.  fp8 pages
    move byte for byte."""
    for key in ("k", "v"):
        pool = as_bytes(layers[key])
        pool[:, dst] = pool[:, src]
    return layers


# -- MLPs ----------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, act: str, device) -> Params:
    """``wi``, ``wg`` and ``wo`` for swiglu; ``wi`` and ``wo`` for any
    other act, as the reference draws them."""
    p = {"wi": normal(gen, (d_model, d_ff), d_model ** -0.5, device)}
    if act == "swiglu":
        p["wg"] = normal(gen, (d_model, d_ff), d_model ** -0.5, device)
    p["wo"] = normal(gen, (d_ff, d_model), d_ff ** -0.5, device)
    return p


def sigmoid(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference rounds it: ``1 / (1 +
    exp(-g))`` with the exp, the add and the divide each rounded to
    ``g``'s dtype (``torch.sigmoid`` rounds once)."""
    t = torch.exp(-g)
    t = 1 + t
    return 1 / t


def silu(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference rounds it: ``g * sigmoid(g)``
    with each step rounded to ``g``'s dtype.  ``F.silu`` rounds once, and
    at bfloat16 differs from the reference in a third of the outputs or
    more."""
    return g * sigmoid(g)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, that is ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))``.  ``F.softplus`` returns ``x`` itself past its
    threshold, another function."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _rounded(v: float, dtype) -> float:
    """``v`` rounded to ``dtype`` (a host value: no device work)."""
    return torch.tensor(v, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form) as the reference rounds it:
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))))`` with
    each step rounded to ``x``'s dtype and both constants rounded to it
    first.  ``F.gelu(approximate="tanh")`` rounds once, and at bfloat16
    differs from the reference in 1,518 of the 65,536 patterns."""
    t = x * x * x
    t = t * _rounded(0.044715, x.dtype)
    t = x + t
    t = t * _rounded(math.sqrt(2 / math.pi), x.dtype)
    t = torch.tanh(t)
    t = 1 + t
    t = 0.5 * t
    return x * t


def relu2(h: torch.Tensor) -> torch.Tensor:
    """The squared ReLU (nemotron), ``jnp.square(jax.nn.relu(h))``."""
    return torch.relu(h).square()


def _activate(h: torch.Tensor, act: str) -> torch.Tensor:
    """The non-gated activations."""
    if act == "relu2":
        return relu2(h)
    if act == "gelu":
        return gelu(h)
    raise ValueError(act)


def mlp(p, x, act: str = "swiglu"):
    h = crossbar_linear(x, p["wi"], "wi",
                        digital=lambda: shd.matmul(x, p["wi"].to(x.dtype)))
    if act == "swiglu":
        g = crossbar_linear(x, p["wg"], "wg",
                            digital=lambda: shd.matmul(x, p["wg"].to(x.dtype)))
        h = silu(g) * h
    else:
        h = _activate(h, act)
    h = lc(h, ("batch", None, "act_mlp"))

    def _wo_digital():
        y = tp_bf16_matmul(h, p["wo"].to(x.dtype))  # opt-in (a rule)
        if y is None:
            y = shd.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))
        return y

    y = crossbar_linear(h, p["wo"], "wo", digital=_wo_digital)
    return lc(y, ("batch", "seq", "act_embed"))


# -- Mixture of Experts --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    act: str = "swiglu"


def moe_init(gen, d_model: int, d_ff: int, cfg: MoEConfig, device
             ) -> Params:
    e = cfg.n_experts
    p = {"router": normal(gen, (d_model, e), d_model ** -0.5, device),
         "wi": normal(gen, (e, d_model, d_ff), d_model ** -0.5, device),
         "wo": normal(gen, (e, d_ff, d_model), d_ff ** -0.5, device)}
    if cfg.act == "swiglu":
        p["wg"] = normal(gen, (e, d_model, d_ff), d_model ** -0.5, device)
    return p


def moe_route(p, x, cfg: MoEConfig):
    """The router: f32 softmax gates over the router logits (computed in
    ``x``'s dtype), and each token's top-k experts, the lower expert
    index first among equal gates (as ``jax.lax.top_k`` breaks ties;
    ``torch.topk`` does not), with their gates renormalised.  Returns
    (gates (B, S, E), top_g (B, S, k), top_e (B, S, k))."""
    logits = shd.einsum("bsd,de->bse", x, p["router"].to(x.dtype))
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    top_g, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_e = top_g[..., :cfg.top_k], top_e[..., :cfg.top_k]
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    return gates, top_g, top_e


def moe_block(p, x, cfg: MoEConfig):
    """Token-dropping top-k MoE with group-local sort-based dispatch, as
    the reference's ``moe_block``: each batch row is a group, its
    (token, choice) assignments are stably sorted by expert, and an
    expert takes the first C of them,
      C = ceil(S * top_k * capacity_factor / n_experts),
    so a row's earlier tokens win its capacity; a dropped token's
    contribution is zero (the residual carries it).  Returns (y, gates).

    Every shape is fixed by ``x``'s (no host sync, no mask indexing), so
    a CUDA graph can hold the block.  The dispatch buffer receives one
    nonzero value per kept slot (a dropped assignment adds a zero), so
    its scatter-add is exact in any order.  The combine sums each token's
    ``top_k`` weighted outputs in a fixed order, the order in which the
    reference's scatter applies them (ascending position in the sorted
    list, from a zero start): the same bits on the CPU and the card for
    any ``top_k``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = max(1, int(-(-s * k * cfg.capacity_factor // e)))

    gates, top_g, top_e = moe_route(p, x, cfg)
    # flatten assignments within each group
    ids = top_e.reshape(b, s * k)                          # (B, S*k)
    gts = top_g.reshape(b, s * k)
    order = torch.argsort(ids, dim=-1, stable=True)        # group-local
    ids_s = torch.gather(ids, 1, order)
    gts_s = torch.gather(gts, 1, order)
    tok_s = order // k                                     # source token

    # position within expert via running count over the sorted list
    same = ids_s[:, :, None] == torch.arange(e, device=x.device)
    pos_all = torch.cumsum(same.to(torch.int64), dim=1) - 1  # (B, S*k, E)
    pos = torch.gather(pos_all, 2, ids_s[:, :, None])[..., 0]
    keep = pos < c
    dest = ids_s * c + torch.clamp(pos, max=c - 1)         # (B, S*k)

    xs = torch.gather(x, 1, tok_s[..., None].expand(b, s * k, d))
    xs = torch.where(keep[..., None], xs, 0.0)
    buf = shd.zeros((b, e * c, d), ("batch", None, "act_embed"), x)
    buf.scatter_add_(1, dest[..., None].expand(b, s * k, d), xs)
    buf = buf.reshape(b, e, c, d)
    buf = lc(buf, ("batch", None, None, "act_embed"))

    h = shd.einsum("becd,edf->becf", buf, p["wi"].to(x.dtype))
    if cfg.act == "swiglu":
        g = shd.einsum("becd,edf->becf", buf, p["wg"].to(x.dtype))
        h = silu(g) * h
    else:
        h = _activate(h, cfg.act)
    h = lc(h, ("batch", None, None, "act_mlp"))
    out = shd.einsum("becf,efd->becd", h, p["wo"].to(x.dtype))
    out = out.reshape(b, e * c, d)

    # gather back to sorted slots, weight by gates, unsort, combine
    ys = torch.gather(out, 1, dest[..., None].expand(b, s * k, d))
    ys = ys * (gts_s * keep)[..., None].to(x.dtype)
    y = moe_combine(ys, order, k)
    return lc(y, ("batch", "seq", "act_embed")), gates


def moe_combine(ys: torch.Tensor, order: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Each token's sum of its ``k`` rows of ``ys`` (B, S*k, d), the
    sorted list whose position j came from flat assignment ``order[:, j]``
    (token ``order // k``).  The rows are added from a zero start in
    ascending j, the order of the reference's scatter-add (so ``-0.0``
    comes out ``+0.0`` as there); a gather of (B, S, k, d) and k adds, in
    one fixed order on any device."""
    b, n, d = ys.shape
    j = torch.arange(n, device=ys.device).expand(b, n)
    at = torch.empty_like(order).scatter_(1, order, j)     # inverse perm
    at = torch.sort(at.reshape(b, n // k, k), dim=-1).values
    parts = torch.gather(ys, 1, at.reshape(b, n, 1).expand(b, n, d))
    parts = parts.reshape(b, n // k, k, d)
    y = shd.zeros((b, n // k, d), ("batch", "seq", "act_embed"), ys)
    for i in range(k):
        y = y + parts[:, :, i]
    return y


def moe_aux_loss(gates: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss, ``E * sum_e f_e * p_e``: ``p_e``
    the mean gate of expert e, ``f_e`` the share of tokens whose largest
    gate is e's (the lower index among equal gates, as ``jnp.argmax``)."""
    e = gates.shape[-1]
    lead = tuple(range(gates.dim() - 1))
    p_e = gates.mean(dim=lead)
    hard = torch.nn.functional.one_hot(torch.argmax(gates, dim=-1),
                                       e).to(gates.dtype)
    f_e = hard.mean(dim=lead)
    return e * torch.sum(f_e * p_e)
