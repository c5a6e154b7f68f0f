"""Bindings of the CUDA paged-attention lanes (``csrc/paged_attention.cu``).

``paged_attention_scratch`` and ``paged_attention_streamed`` launch their
kernels for CUDA tensors and run the plain version (``ref.py``) for CPU
tensors; a CUDA call the kernels cannot take raises.  ``LAUNCHES`` counts
kernel launches and nothing else.  The streamed lane's partials live in
a float32 workspace the wrapper allocates; the kernels allocate nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.ref import resolve_block_pages

#: kernel launches since the counts were last set to 0; a streamed-lane
#: call launches the split kernel (``paged_attention_streamed``) and then
#: the combine kernel (``paged_attention_combine``)
LAUNCHES = {"paged_attention_scratch": 0, "paged_attention_streamed": 0,
            "paged_attention_combine": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
#: widths the streamed lane's split kernel is compiled for: a head dim
#: runs on the next width up, its extra columns zero in shared memory
STREAMED_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192, 256)
#: query rows (g * sq) one streamed block serves: the mma's M
GROUP_ROWS = 16
#: blocks of the split kernel aimed for, per SM: splits past a row's
#: valid depth exit at once, so ragged batches need more than one wave
SPLIT_WAVES = 4
#: fewest tokens worth a split of their own (two 64-token tiles)
MIN_SPLIT_TOKENS = 128
#: SM count per device index, and the streamed lane's split count per
#: call shape, so that a call's host path queries neither again
_SMS: dict = {}
_PLANS: dict = {}


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if lib.paged_scratch_launch.argtypes is None:
        lib.paged_scratch_launch.argtypes = (
            [_P] * 7 + [_I] * 8 + [_F, _I, _P])
        lib.paged_scratch_launch.restype = _I
        lib.paged_split_launch.argtypes = (
            [_P] * 8 + [_I] * 8 + [_F, _I, _I, _I, _P])
        lib.paged_split_launch.restype = _I
        lib.paged_combine_launch.argtypes = [_P] * 3 + [_I] * 7 + [_P]
        lib.paged_combine_launch.restype = _I
        lib.paged_scratch_smem.argtypes = [_I] * 7
        lib.paged_scratch_smem.restype = ctypes.c_size_t
        lib.paged_streamed_smem.argtypes = [_I] * 3
        lib.paged_streamed_smem.restype = ctypes.c_size_t
    return lib


def choose_n_split(b: int, kv: int, rows: int, p_seq: int, block_pages: int,
                   page_size: int, sms: int) -> int:
    """Splits of the KV axis for the streamed lane, from the grid's other
    extents (B, kv heads, row groups), the table width and the SM count
    alone: ``kv_len`` lives on the device.  At most one split per page
    block, none shorter than ``MIN_SPLIT_TOKENS`` of table, and a divisor
    of the block count."""
    n_blocks = p_seq // block_pages
    groups = -(-rows // GROUP_ROWS)
    want = -(-SPLIT_WAVES * sms // (b * kv * groups))
    cap = max(1, p_seq * page_size // MIN_SPLIT_TOKENS)
    n_split = max(1, min(n_blocks, want, cap))
    while n_blocks % n_split:   # equal splits: the longest sets the time
        n_split -= 1
    return n_split


def streamed_width(hd: int) -> int:
    """The compiled width the streamed lane runs head dim ``hd`` on."""
    return next(w for w in STREAMED_HEAD_DIMS if w >= hd)


def _check(q, k_pages, v_pages, page_table, kv_len, q_offset):
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
    return b, sq, hq, kv, hd, ps, p_seq


def scratch_capacity(sq: int, hq: int, kv: int, hd: int, page_size: int,
                     elem_bytes: int) -> int:
    """Most tokens of table depth (whole pages) the scratch lane holds at
    this shape: per page, its f32 logits take 4 * g * sq * page_size bytes
    of shared memory and the page-table entry 4."""
    lib = _lib()
    fixed = lib.paged_scratch_smem(sq, hq, kv, hd, 0, page_size, elem_bytes)
    pages = max(0, (SMEM_LIMIT - fixed)
                // (4 * (hq // kv) * sq * page_size + 4))
    while pages and lib.paged_scratch_smem(
            sq, hq, kv, hd, pages * page_size, page_size,
            elem_bytes) > SMEM_LIMIT:
        pages -= 1          # rows of logits are padded to 4 tokens
    return pages * page_size


def _scratch(q, k_pages, v_pages, page_table, kv_len, q_offset, causal):
    b, sq, hq, kv, hd, ps, p_seq = _check(q, k_pages, v_pages, page_table,
                                          kv_len, q_offset)
    lib = _lib()
    eb = q.element_size()
    depth = p_seq * ps
    if lib.paged_scratch_smem(sq, hq, kv, hd, depth, ps, eb) > SMEM_LIMIT:
        cap = scratch_capacity(sq, hq, kv, hd, ps, eb)
        raise ValueError(
            f"paged attention scratch lane holds at most {cap} tokens of "
            f"table at g*sq={hq // kv * sq}, head_dim {hd}, {q.dtype} "
            f"(227 KB of shared memory per block); this table is {depth} "
            f"deep: use the streamed lane")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_scratch_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), q_offset.data_ptr(),
            out.data_ptr(), b, sq, hq, kv, hd, ps, p_seq, int(causal),
            hd ** -0.5, _DTYPES[q.dtype], stream)
    build.check(err, "paged_attention_scratch")
    LAUNCHES["paged_attention_scratch"] += 1
    return out


def _split_plan(lib, dev, b, kv, rows, p_seq, block_pages, ps, hd, eb):
    """The streamed lane's split count at this call shape, its shared
    memory checked once per shape."""
    key = (dev.index, b, kv, rows, p_seq, block_pages, ps, hd, eb)
    n_split = _PLANS.get(key)
    if n_split is None:
        if dev.index not in _SMS:
            _SMS[dev.index] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        n_split = choose_n_split(b, kv, rows, p_seq, block_pages, ps,
                                 _SMS[dev.index])
        split_pages = -(-(p_seq // block_pages) // n_split) * block_pages
        smem = lib.paged_streamed_smem(hd, eb, split_pages)
        if smem > SMEM_LIMIT:
            raise ValueError(f"paged attention streamed lane needs {smem} B "
                             f"of shared memory per block (limit "
                             f"{SMEM_LIMIT}); use more splits")
        _PLANS[key] = n_split
    return n_split


def _streamed(q, k_pages, v_pages, page_table, kv_len, q_offset, causal,
              block_pages: int):
    b, sq, hq, kv, hd, ps, p_seq = _check(q, k_pages, v_pages, page_table,
                                          kv_len, q_offset)
    if hd > STREAMED_HEAD_DIMS[-1]:
        raise ValueError(f"the streamed lane takes head dims up to "
                         f"{STREAMED_HEAD_DIMS[-1]}, got {hd}")
    lib = _lib()
    rows = hq // kv * sq
    n_split = _split_plan(lib, q.device, b, kv, rows, p_seq, block_pages,
                          ps, hd, q.element_size())
    n_parts = b * kv * n_split * rows
    part = torch.empty(n_parts * (hd + 2), dtype=torch.float32,
                       device=q.device)
    part_ml, part_acc = part[:2 * n_parts], part[2 * n_parts:]
    out = torch.empty_like(q)
    dtype = _DTYPES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_split_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), q_offset.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(), b, sq, hq, kv, hd, ps,
            p_seq, int(causal), hd ** -0.5, dtype, block_pages, n_split,
            stream)
        build.check(err, "paged_attention_streamed")
        LAUNCHES["paged_attention_streamed"] += 1
        err = lib.paged_combine_launch(
            part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, sq,
            hq, kv, hd, dtype, n_split, stream)
    build.check(err, "paged_attention_combine")
    LAUNCHES["paged_attention_combine"] += 1
    return out


def paged_attention_scratch(q, k_pages, v_pages, page_table, kv_len,
                            q_offset, *, causal: bool = True
                            ) -> torch.Tensor:
    """Scratch lane: gather-then-SDPA with an exact softmax.  On the card
    it holds tables up to :func:`scratch_capacity` tokens deep and raises
    past that."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                       kv_len, q_offset, causal=causal)
    return _scratch(q, k_pages, v_pages, page_table, kv_len, q_offset,
                    causal)


def paged_attention_streamed(q, k_pages, v_pages, page_table, kv_len,
                             q_offset, *, causal: bool = True,
                             block_pages: int = 16) -> torch.Tensor:
    """Streamed lane: online softmax over blocks of ``block_pages`` pages
    (clamped to a divisor of the table width).  On the card the blocks
    are shared among :func:`choose_n_split` splits of the KV axis, whose
    partials a second kernel combines."""
    bp = resolve_block_pages(page_table.shape[1], block_pages)
    if q.device.type == "cpu":
        return ref.paged_attention_streamed_ref(
            q, k_pages, v_pages, page_table, kv_len, q_offset,
            causal=causal, block_pages=bp)
    return _streamed(q, k_pages, v_pages, page_table, kv_len, q_offset,
                     causal, bp)
