"""Port parity: the paged-attention oracles and lane dispatch against the
reference's Pallas kernels (interpret mode).

Contract: at float32 both port oracles agree with the reference kernels
to 1e-5 x max|out| — the same masks and softmax, with exp and the f32
sums evaluated by another library in another order.  So does the plain
version of the CUDA streamed lane's split-KV algorithm
(``paged_attention_split_ref``) at every split count.  The CUDA lanes are
held against these oracles on the card (test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import kernel as jkernel  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    kernel as tkernel, ops as tops, ref as tref)

RTOL = 1e-5


def _close(a, b, rtol=RTOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() <= rtol * max(np.abs(a).max(), 1e-30)


def _case(seed, b=3, sq=2, hq=4, kv=2, hd=16, ps=4, p_seq=4, n_pages=9):
    """Random pools and queries with ragged lengths, per-row offsets, a
    null-page tail, and an aliased table (rows 0 and 1 share page 1)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages + 1, ps, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, ps, kv, hd)).astype(np.float32)
    kp[0] = vp[0] = 0.0                         # the null page
    pt = np.zeros((b, p_seq), np.int32)
    pt[0, :3] = [1, 2, 3]
    pt[1, :2] = [1, 4]                          # aliases row 0's page 1
    pt[2, :4] = [5, 6, 7, 8]
    kv_len = np.array([9, 6, 16], np.int32)[:b]
    q_off = kv_len - sq                         # window ends at the fill
    q_off[1] = 2                                # a row mid-prefill
    return q, kp, vp, pt, kv_len, q_off


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("sq,causal", [(1, True), (3, True), (2, False)])
def test_scratch_oracle_matches_jax_kernel(sq, causal):
    args = _case(sq, sq=sq)
    out_j = jkernel.paged_attention_kernel(*_j(*args), causal=causal,
                                           interpret=True)
    out_t = tref.paged_attention_ref(*_t(*args), causal=causal)
    assert out_t.shape == tuple(out_j.shape)
    assert _close(out_j, out_t.numpy())


@pytest.mark.parametrize("block_pages", [1, 2, 3])
def test_streamed_oracle_matches_jax_kernel(block_pages):
    args = _case(10 + block_pages, sq=2)
    out_j = jkernel.paged_attention_streamed(
        *_j(*args), interpret=True, block_pages=block_pages)
    out_t = tref.paged_attention_streamed_ref(*_t(*args),
                                              block_pages=block_pages)
    assert _close(out_j, out_t.numpy())
    # and the two port lanes agree with each other (online vs one-shot)
    assert _close(tref.paged_attention_ref(*_t(*args)).numpy(),
                  out_t.numpy())


def _edit(args, kv_len=None, q_off=None, pt=None):
    q, kp, vp, pt0, kv_len0, q_off0 = (a.copy() for a in args)
    for arr, upd in ((kv_len0, kv_len), (q_off0, q_off), (pt0, pt)):
        for idx, val in (upd or {}).items():
            arr[idx] = val
    return q, kp, vp, pt0, kv_len0, q_off0


# (n_split, block_pages, causal, edits): the table is 4 pages of 4 tokens;
# row 1 (kv_len 6, queries at 2 and 3) has splits wholly past its depth at
# n_split 4, and its tokens 4-5 are causally masked for both queries
SPLIT_CASES = {
    "one_split": (1, 1, True, {}),
    "two_splits": (2, 1, True, {}),
    "three_splits_of_four_blocks": (3, 1, True, {}),
    "splits_past_kv_len": (4, 1, True, {}),
    "row_with_kv_len_0": (2, 1, True, {"kv_len": {1: 0}}),
    # row 2's queries at 3 and 4: tokens 4-7 are all masked for the first
    "split_masked_for_some_queries": (4, 1, True, {"q_off": {2: 3}}),
    "not_causal": (3, 1, False, {}),
    "aliased_table": (2, 2, True, {"pt": {(2, 0): 1, (2, 2): 2}}),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_ref_matches_jax_streamed_kernel(case):
    """The CUDA streamed lane's split/combine algorithm, in plain PyTorch,
    against the reference's streamed kernel and the port's oracle."""
    n_split, bp, causal, edits = SPLIT_CASES[case]
    args = _edit(_case(20, sq=2), **edits)
    out_j = jkernel.paged_attention_streamed(*_j(*args), causal=causal,
                                             interpret=True, block_pages=bp)
    out_s = tref.paged_attention_split_ref(*_t(*args), causal=causal,
                                           block_pages=bp, n_split=n_split)
    out_t = tref.paged_attention_streamed_ref(*_t(*args), causal=causal,
                                              block_pages=bp)
    assert out_s.shape == tuple(out_j.shape)
    assert np.isfinite(out_s.numpy()).all()
    assert _close(out_j, out_s.numpy())
    assert _close(out_t.numpy(), out_s.numpy())


@pytest.mark.parametrize("hd,wide", [(40, 48), (40, None), (112, None)])
def test_split_ref_padding_to_a_compiled_width(hd, wide):
    """The streamed lane runs head dim hd on the next compiled width up
    (None: ``streamed_width``, 64 for 40 and 128 for 112), its extra
    Q/K/V columns zero and the scale hd^-0.5: the zero columns add exact
    zeros to Q.K^T and the padded output columns are dropped, so the
    padded split-KV algorithm is the unpadded one at any width."""
    wide = wide or tkernel.streamed_width(hd)
    assert wide > hd
    args = _case(40 + hd, sq=2, hd=hd)
    pad = [np.pad(a, [(0, 0)] * 3 + [(0, wide - hd)]) for a in args[:3]]
    out = tref.paged_attention_split_ref(*_t(*args), block_pages=1,
                                         n_split=3)
    out_p = tref.paged_attention_split_ref(*_t(*pad, *args[3:]),
                                           block_pages=1, n_split=3,
                                           scale=hd ** -0.5)
    assert tuple(out_p.shape) == out.shape[:3] + (wide,)
    assert not out_p[..., hd:].any()
    assert _close(out.numpy(), out_p[..., :hd].numpy(), rtol=1e-6)
    if hd == 40 and wide == 48:
        out_j = jkernel.paged_attention_streamed(*_j(*args), interpret=True,
                                                 block_pages=1)
        assert _close(out_j, out_p[..., :hd].numpy())


def test_split_bounds_cover_the_blocks_in_order():
    for n_blocks in (1, 4, 7, 32):
        for n_split in range(1, n_blocks + 1):
            runs = [tref.split_bounds(n_blocks, n_split, s)
                    for s in range(n_split)]
            assert runs[0][0] == 0 and runs[-1][1] == n_blocks
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            assert {hi - lo for lo, hi in runs} <= {
                n_blocks // n_split, -(-n_blocks // n_split)}


def test_choose_n_split():
    # the long-context shape of chip_smoke: B 4, kv 16, 8 rows, 512
    # pages of 8 tokens in 16-page blocks, 132 SMs
    assert tkernel.choose_n_split(4, 16, 8, 512, 16, 8, 132) == 8
    # chip_smoke's streamed serving shape: at most one split per 128
    # tokens of table
    assert tkernel.choose_n_split(4, 16, 8, 64, 4, 8, 132) == 4
    # a tiny table or a wide grid keeps one split
    assert tkernel.choose_n_split(3, 2, 4, 4, 2, 4, 132) == 1
    assert tkernel.choose_n_split(64, 16, 32, 512, 16, 8, 132) == 1


def test_resolve_block_pages_clamps_to_a_divisor():
    assert tref.resolve_block_pages(8, 16) == 8
    assert tref.resolve_block_pages(12, 5) == 4
    assert tref.resolve_block_pages(7, 3) == 1
    assert tref.resolve_block_pages(
        4, 3) == jkernel.resolve_block_pages(4, 3)


def test_lane_dispatch_counters():
    obs.reset()
    args = _t(*_case(5))
    before = dict(tkernel.LAUNCHES)
    tops.paged_attention(*args)                             # auto: scratch
    tops.paged_attention(*args, stream_min_pages=4, block_pages=2)
    tops.paged_attention(*args, stream_min_pages=5)         # table too narrow
    tops.paged_attention(*args, lane="streamed")
    assert dict(tops.paged_path_calls) == {
        "paged_scratch": 2, "paged_streamed": 2, "paged_fallback": 0}
    # CPU tensors take the plain versions: no kernel launch is counted
    assert tkernel.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown lane"):
        tops.paged_attention(*args, lane="bogus")
