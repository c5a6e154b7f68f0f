"""Plain PyTorch versions of the paged decode attention kernels (the port
of ``repro/kernels/paged_attention/ref.py``).

``paged_attention_ref`` is the **scratch-lane** oracle: the dense SDPA
decode path (f32 logits, -1e30 masks, softmax, P.V in the value type)
applied to the K/V view gathered through the page table.  Because
``page_size`` divides ``max_len``, the gathered view is exactly
``max_len`` deep.

``paged_attention_streamed_ref`` is the **streamed-lane** oracle: the
online-softmax block recursion, one page block at a time with f32 running
max / denominator / accumulator updates.

``paged_attention_split_ref`` is the CUDA streamed lane's algorithm in
plain PyTorch (split-KV partials, then their combine), for the tests:
the kernel itself is held to ``paged_attention_streamed_ref``.

A low-precision (float8_e4m3fn) pool is upcast to q's dtype after the
gather, as the reference upcasts it inside the dot, so the scratch
lane's weights round to q's dtype; fp8 pages are gathered as bytes.
"""
from __future__ import annotations

import torch

#: calls of the plain versions (the serving path on the card makes none)
CALLS = {"paged_attention_ref": 0, "paged_attention_streamed_ref": 0,
         "paged_attention_split_ref": 0}


def resolve_block_pages(pages_per_seq: int, block_pages: int) -> int:
    """Largest divisor of ``pages_per_seq`` that is <= ``block_pages``."""
    bp = max(1, min(block_pages, pages_per_seq))
    while pages_per_seq % bp:
        bp -= 1
    return bp


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its bytes (a view: reads and writes through it
    are bitwise), so that gathers, scatters and copies need no fp8
    kernel; any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def take_pages(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]`` along the page axis (an fp8 pool through its
    bytes)."""
    return as_bytes(pool)[idx].view(pool.dtype)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(P+1, ps, kv, hd) pages + (B, P_seq) table -> (B, depth, kv, hd)
    logical view, depth = P_seq * ps (== max_len)."""
    b, p_seq = page_table.shape
    ps = pages.shape[1]
    return take_pages(pages, page_table.long()).reshape(
        b, p_seq * ps, *pages.shape[2:])


def _as_rows(v, b: int, device) -> torch.Tensor:
    return torch.as_tensor(v).to(device=device, dtype=torch.int64).reshape(b)


def paged_attention_ref(q, k_pages, v_pages, page_table, kv_len, q_offset,
                        *, causal: bool = True) -> torch.Tensor:
    """q (B, sq, hq, hd); k/v pages (P+1, ps, kv, hd); page_table
    (B, P_seq) int32; kv_len/q_offset (B,) int32 -> (B, sq, hq, hd)."""
    CALLS["paged_attention_ref"] += 1
    b, sq, hq, hd = q.shape
    dev = q.device
    gk = gather_pages(k_pages, page_table).to(q.dtype)
    gv = gather_pages(v_pages, page_table).to(q.dtype)
    depth = gk.shape[1]
    kv = gk.shape[2]
    g = hq // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scale = hd ** -0.5
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                          gk.to(torch.float32)) * scale
    if causal:
        qpos = (_as_rows(q_offset, b, dev).reshape(-1, 1)
                + torch.arange(sq, device=dev)[None])
        mask = qpos[:, :, None] >= torch.arange(depth, device=dev)[None, None]
        logits = torch.where(mask[:, None, None], logits, -1e30)
    valid = (torch.arange(depth, device=dev)[None, :]
             < _as_rows(kv_len, b, dev)[:, None])
    logits = torch.where(valid[:, None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w.to(gv.dtype), gv)
    return out.reshape(b, sq, hq, hd)


def paged_attention_streamed_ref(q, k_pages, v_pages, page_table, kv_len,
                                 q_offset, *, causal: bool = True,
                                 block_pages: int = 16) -> torch.Tensor:
    """Block-order online-softmax oracle for the streamed lane: the flash
    recursion in plain PyTorch, same block schedule, same update order.
    ``block_pages`` is clamped to a divisor of the table width."""
    CALLS["paged_attention_streamed_ref"] += 1
    b, sq, hq, hd = q.shape
    dev = q.device
    ps = k_pages.shape[1]
    p_seq = page_table.shape[1]
    bp = resolve_block_pages(p_seq, block_pages)
    bt = bp * ps
    kv = k_pages.shape[2]
    g = hq // kv
    qg = q.reshape(b, sq, kv, g, hd).to(torch.float32)
    scale = hd ** -0.5
    kv_len = _as_rows(kv_len, b, dev)
    q_offset = _as_rows(q_offset, b, dev)
    f32 = torch.float32
    m = torch.full((b, kv, g, sq), -1e30, dtype=f32, device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=f32, device=dev)
    acc = torch.zeros((b, kv, g, sq, hd), dtype=f32, device=dev)
    pt = page_table.long()
    for j in range(p_seq // bp):
        ptj = pt[:, j * bp:(j + 1) * bp].reshape(-1)
        kk = take_pages(k_pages, ptj).reshape(b, bt, kv, hd).to(q.dtype)
        vv = take_pages(v_pages, ptj).reshape(b, bt, kv, hd).to(q.dtype)
        logits = torch.einsum("bskgh,btkh->bkgst", qg, kk.to(f32)) * scale
        tpos = j * bt + torch.arange(bt, device=dev)
        if causal:
            qpos = q_offset[:, None] + torch.arange(sq, device=dev)[None]
            mask = qpos[:, :, None] >= tpos[None, None, :]
            logits = torch.where(mask[:, None, None], logits, -1e30)
        valid = tpos[None, :] < kv_len[:, None]
        logits = torch.where(valid[:, None, None, None], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", p, vv.to(f32))
        m = m_new
    out = acc / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)


def split_bounds(n_blocks: int, n_split: int, split: int) -> tuple:
    """Page blocks [lo, hi) of ``split`` when ``n_blocks`` blocks are cut
    into ``n_split`` contiguous runs that differ by at most one block."""
    return split * n_blocks // n_split, (split + 1) * n_blocks // n_split


def paged_attention_split_ref(q, k_pages, v_pages, page_table, kv_len,
                              q_offset, *, causal: bool = True,
                              block_pages: int = 16, n_split: int = 1,
                              scale=None) -> torch.Tensor:
    """The streamed lane's split-KV algorithm: each of ``n_split`` runs of
    whole page blocks yields f32 partials (m, l, acc) over the tokens a
    row reads (its valid depth, or the whole table at kv_len 0); a run
    at or past that depth gives m = -1e30, l = 0, acc = 0.  The combine
    rescales by exp(m - max m) and divides.  ``n_split`` is clamped to
    [1, number of blocks].  ``scale`` defaults to hd^-0.5 (the CUDA lane
    keeps the true head dim's scale when it pads Q, K and V with zero
    columns to a compiled width)."""
    CALLS["paged_attention_split_ref"] += 1
    b, sq, hq, hd = q.shape
    dev = q.device
    f32 = torch.float32
    ps, kv = k_pages.shape[1], k_pages.shape[2]
    p_seq = page_table.shape[1]
    bp = resolve_block_pages(p_seq, block_pages)
    n_blocks = p_seq // bp
    n_split = max(1, min(n_split, n_blocks))
    g = hq // kv
    depth = p_seq * ps
    qg = q.reshape(b, sq, kv, g, hd).to(f32)
    kv_len = _as_rows(kv_len, b, dev)
    q_offset = _as_rows(q_offset, b, dev)
    n_read = torch.where(kv_len > 0, kv_len.clamp(max=depth), depth)
    pt = page_table.long()
    ms, ls, accs = [], [], []
    for s in range(n_split):
        lo, hi = split_bounds(n_blocks, n_split, s)
        t0, t1 = lo * bp * ps, hi * bp * ps
        pages = pt[:, lo * bp:hi * bp].reshape(-1)
        kk = take_pages(k_pages, pages).reshape(b, t1 - t0, kv, hd).to(
            q.dtype).to(f32)
        vv = take_pages(v_pages, pages).reshape(b, t1 - t0, kv, hd).to(
            q.dtype).to(f32)
        logits = torch.einsum("bskgh,btkh->bkgst", qg, kk) * (
            hd ** -0.5 if scale is None else scale)
        tpos = t0 + torch.arange(t1 - t0, device=dev)
        if causal:
            qpos = q_offset[:, None] + torch.arange(sq, device=dev)[None]
            mask = qpos[:, :, None] >= tpos[None, None, :]
            logits = torch.where(mask[:, None, None], logits, -1e30)
        valid = tpos[None, :] < kv_len[:, None]
        logits = torch.where(valid[:, None, None, None], logits, -1e30)
        read = (tpos[None, :] < n_read[:, None])[:, None, None, None]
        logits = torch.where(read, logits, -torch.inf)
        m = logits.amax(dim=-1).clamp(min=-1e30)
        p = torch.exp(logits - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgst,btkh->bkgsh", p, vv))
    m_all = torch.stack(ms)                      # (n_split, b, kv, g, sq)
    w = torch.exp(m_all - m_all.amax(dim=0))
    l_tot = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    out = acc / l_tot[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)
