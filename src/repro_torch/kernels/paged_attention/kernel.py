"""Bindings of the CUDA paged-attention lanes (``csrc/paged_attention.cu``).

``paged_attention_scratch`` and ``paged_attention_streamed`` launch their
kernel for CUDA tensors and run the plain version (``ref.py``) for CPU
tensors; a CUDA call the kernel cannot take raises.  ``LAUNCHES`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.ref import resolve_block_pages

#: kernel launches since the counts were last set to 0
LAUNCHES = {"paged_attention_scratch": 0, "paged_attention_streamed": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        lib.paged_attention_launch.argtypes = (
            [_P] * 7 + [_I] * 8 + [_F, _I, _I, _P])
        lib.paged_attention_launch.restype = _I
        for fn in (lib.paged_scratch_smem, lib.paged_streamed_smem):
            fn.argtypes = [_I] * 6
            fn.restype = ctypes.c_size_t
    return lib


def _launch(q, k_pages, v_pages, page_table, kv_len, q_offset, causal,
            block_pages: int, lane: str) -> torch.Tensor:
    dev = q.device
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"want q (B, sq, hq, hd) and equal (P+1, ps, kv, "
                         f"hd) pools, got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, sq, hq, hd = q.shape
    _, ps, kv, hd2 = k_pages.shape
    p_seq = page_table.shape[1]
    if hd2 != hd or hq % kv:
        raise ValueError(f"head shapes disagree: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged attention kernels take float32 or bfloat16 "
                        f"q/k/v of one type, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if (hd * q.element_size()) % 16:
        raise ValueError(f"head_dim {hd} is not a whole number of 16-byte "
                         f"chunks at {q.dtype}")
    for name, t in (("page_table", page_table), ("kv_len", kv_len),
                    ("q_offset", q_offset)):
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"{name} must be int32 on {dev}, got {t.dtype} "
                            f"on {t.device}")
    if page_table.shape != (b, p_seq) or kv_len.shape != (b,) \
            or q_offset.shape != (b,):
        raise ValueError("page_table (B, P_seq), kv_len and q_offset (B,) "
                         "must match the batch")
    tensors = (q, k_pages, v_pages, page_table, kv_len, q_offset)
    if any(t.device != dev for t in tensors):
        raise ValueError("paged attention operands must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention needs contiguous operands")
    lib = _lib()
    eb = q.element_size()
    if lane == "streamed":
        smem = lib.paged_streamed_smem(sq, hq, kv, hd, block_pages * ps, eb)
    else:
        smem = lib.paged_scratch_smem(sq, hq, kv, hd, p_seq * ps, eb)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"paged attention {lane} lane needs {smem} B of shared memory "
            f"per block (limit {SMEM_LIMIT}); use the streamed lane or a "
            f"smaller block_pages")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), q_offset.data_ptr(),
            out.data_ptr(), b, sq, hq, kv, hd, ps, p_seq, int(causal),
            hd ** -0.5, _DTYPES[q.dtype],
            block_pages if lane == "streamed" else 0, stream)
    build.check(err, f"paged_attention_{lane}")
    LAUNCHES[f"paged_attention_{lane}"] += 1
    return out


def paged_attention_scratch(q, k_pages, v_pages, page_table, kv_len,
                            q_offset, *, causal: bool = True
                            ) -> torch.Tensor:
    """Scratch lane: gather-then-SDPA with an exact softmax."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                       kv_len, q_offset, causal=causal)
    return _launch(q, k_pages, v_pages, page_table, kv_len, q_offset,
                   causal, 0, "scratch")


def paged_attention_streamed(q, k_pages, v_pages, page_table, kv_len,
                             q_offset, *, causal: bool = True,
                             block_pages: int = 16) -> torch.Tensor:
    """Streamed lane: online softmax over blocks of ``block_pages`` pages
    (clamped to a divisor of the table width)."""
    bp = resolve_block_pages(page_table.shape[1], block_pages)
    if q.device.type == "cpu":
        return ref.paged_attention_streamed_ref(
            q, k_pages, v_pages, page_table, kv_len, q_offset,
            causal=causal, block_pages=bp)
    return _launch(q, k_pages, v_pages, page_table, kv_len, q_offset,
                   causal, bp, "streamed")
