"""Port parity: the paged-attention oracles and lane dispatch against the
reference's Pallas kernels (interpret mode).

Contract: at float32 both port oracles agree with the reference kernels
to 1e-5 x max|out| — the same masks and softmax, with exp and the f32
sums evaluated by another library in another order.  The CUDA lanes are
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
