"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without CUDA (the
kernels have no CPU mode); on a machine with a card run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

This file imports neither JAX nor the reference package, so it runs where
only the port is installed.

Contracts:
* crossbar MAC: BITWISE equal to the exact int64 code sums
  (``crossbar_mac_codes_ref``) times the LSB; 1e-6 x max|y| against the
  plain version, which shift-adds the codes in f32; its ADC table equals
  the plain ADC's code of every pre-ADC sum;
* paged attention: 1e-5 x max|out| at float32 (exp and f32 sums in
  another order), 2e-2 at bfloat16 (the value type rounds the scratch
  lane's weights and both lanes' outputs; its unit roundoff is 3.9e-3);
  the streamed lane at any split count against the one-pass oracle;
* deep-net streaming: 1e-6 x max|y| against its plain version (as the
  MAC), and BITWISE equal both to the popcount kernel (an independent
  integer MAC) and to ``engine.program`` + the crossbar-MAC kernel (the
  same integer codes and the same final conversion);
* Jacobi sweeps: BITWISE equal to the plain sweep (the kernel repeats
  its float32 operations in order with explicitly rounded intrinsics,
  without FMA contraction), with one band and with many; one call is
  one device kernel; the full solve is bitwise ``jacobi_planar`` (the
  plain sweep, as many times) and within 2e-3 of the dense nodal solve.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine, ir_drop  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.core.timing import PAPER  # noqa: E402
from repro_torch.kernels.crossbar_mac import kernel as mac  # noqa: E402
from repro_torch.kernels.deepnet_stream import kernel as ds  # noqa: E402
from repro_torch.kernels.deepnet_stream import ops as ds_ops  # noqa: E402
from repro_torch.kernels.ir_solve import kernel as ir  # noqa: E402
from repro_torch.kernels.ir_solve import ops as ir_ops  # noqa: E402
from repro_torch.kernels.ir_solve.ref import jacobi_sweep_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel_err(ref, got):
    ref = ref.double().cpu()
    return float((got.double().cpu() - ref).abs().max()
                 / max(float(ref.abs().max()), 1e-30))


def _operands(seed, b, k, n, s, bpc, in_bits=8):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2 ** (in_bits - 1), 2 ** (in_bits - 1), (b, k),
                     dtype=np.int32)
    pos = rng.integers(0, 2 ** bpc, (s, k, n)).astype(np.int8)
    neg = rng.integers(0, 2 ** bpc, (s, k, n)).astype(np.int8)
    return x, pos, neg


@pytest.mark.parametrize("b,k,n,s,bpc,rows,leak", [
    (16, 256, 384, 4, 1, 128, 0.0), (5, 512, 200, 4, 1, 256, 0.37),
    (33, 96, 130, 2, 2, 32, 0.0), (1, 160, 64, 3, 2, 80, 1.1),
    (17, 2560, 4096, 4, 1, 128, 0.0), (16, 2560, 4096, 4, 1, 256, 0.0)])
def test_crossbar_mac_matches_plain(cuda, b, k, n, s, bpc, rows, leak):
    x, pos, neg = (torch.from_numpy(a).to(cuda)
                   for a in _operands(b + k, b, k, n, s, bpc))
    kw = dict(in_bits=8, adc_bits=7, bits_per_cell=bpc, rows_per_adc=rows)
    before = mac.LAUNCHES["crossbar_mac"]
    y = mac.crossbar_mac(x, pos, neg, leak, **kw)
    torch.cuda.synchronize()
    assert mac.LAUNCHES["crossbar_mac"] == before + 1
    y_ref = mac.ref.crossbar_mac_ref(x, pos, neg, leak_codes=leak, **kw)
    assert _rel_err(y_ref, y) <= 1e-6


@pytest.mark.parametrize("b,k,n,s,bpc,rows,in_bits,adc_bits,leak", [
    (1, 256, 384, 4, 1, 128, 8, 8, 0.0),
    (5, 512, 200, 4, 1, 256, 8, 7, 0.37),        # ragged N, 256 rows
    (16, 2560, 4096, 4, 1, 128, 8, 8, 0.0),
    (16, 2560, 2048, 4, 1, 256, 8, 8, 0.37),
    (64, 1024, 1000, 4, 1, 128, 8, 8, 0.37),     # B 64, ragged N
    (17, 384, 130, 2, 2, 128, 8, 12, 1.1),       # 2 bits per cell
    (3, 256, 256, 3, 1, 64, 16, 15, 0.37),       # in_bits 16
    (64, 512, 512, 4, 1, 256, 7, 10, 0.0),       # odd in_bits
    (2, 160, 64, 3, 2, 80, 5, 6, 1.1)])          # rows not a multiple of 32
def test_crossbar_mac_bitwise_equals_code_sums(cuda, b, k, n, s, bpc, rows,
                                               in_bits, adc_bits, leak):
    """The kernel's output is the exact int64 code sums times the LSB,
    bit for bit, and within 1e-6 of the f32 plain version."""
    x, pos, neg = (torch.from_numpy(a).to(cuda) for a in
                   _operands(b * k + n, b, k, n, s, bpc, in_bits))
    kw = dict(in_bits=in_bits, adc_bits=adc_bits, bits_per_cell=bpc,
              rows_per_adc=rows)
    y = mac.crossbar_mac(x, pos, neg, leak, **kw)
    codes = mac.ref.crossbar_mac_codes_ref(x, pos, neg, leak_codes=leak,
                                           **kw)
    full_scale = float(rows * (2 ** bpc - 1))
    want = mac.ref.codes_to_float(codes, adc_bits, full_scale)
    assert torch.equal(y, want)
    y_ref = mac.ref.crossbar_mac_ref(x, pos, neg, leak_codes=leak, **kw)
    assert _rel_err(y_ref, y) <= 1e-6


@pytest.mark.parametrize("rows,bpc,adc_bits", [
    (128, 1, 8), (256, 1, 8), (128, 2, 12), (80, 2, 6), (256, 1, 15)])
def test_crossbar_mac_adc_table_equals_plain_adc(cuda, rows, bpc, adc_bits):
    """Every per-lane copy of the kernel's ADC table equals the plain
    ADC's code of every pre-ADC sum, at leaks on and off half-LSB
    points."""
    full_scale = float(rows * (2 ** bpc - 1))
    lsb = mac.ref.adc_lsb(adc_bits, full_scale)
    sums = torch.arange(0, rows * (2 ** bpc - 1) + 1, device=cuda,
                        dtype=torch.float32)
    for leak in (0.0, 0.37, lsb / 2, 1.5 * lsb, 3.0):
        lk = torch.full((1,), leak, dtype=torch.float32, device=cuda)
        table = mac.adc_table(lk, adc_bits=adc_bits, bits_per_cell=bpc,
                              rows_per_adc=rows)
        want = mac.ref.adc_codes(sums + lk, adc_bits, full_scale)
        assert table.shape == (sums.numel(), 32)
        assert torch.equal(table.long(), want[:, None].expand(-1, 32))


def test_crossbar_mac_refuses_what_it_cannot_take(cuda):
    x, pos, neg = (torch.from_numpy(a).to(cuda)
                   for a in _operands(0, 4, 512, 16, 2, 1))
    with pytest.raises(ValueError, match="no crossbar_mac kernel variant"):
        mac.crossbar_mac(x, pos, neg, 0.0, in_bits=8, adc_bits=8,
                         bits_per_cell=1, rows_per_adc=512)
    with pytest.raises(TypeError, match="int32"):
        mac.crossbar_mac(x.float(), pos, neg, 0.0, in_bits=8, adc_bits=8,
                         bits_per_cell=1, rows_per_adc=128)


@pytest.mark.parametrize("mode,k", [("deepnet", 96), ("expansion", 256),
                                    ("expansion", 96)])
def test_engine_kernel_path_matches_reference_path(cuda, mode, k):
    cfg = engine.EngineConfig(tile_rows=32, tile_cols=32, mode=mode,
                              quant=QuantConfig(w_bits=8, in_bits=10,
                                                adc_bits=12))
    rng = np.random.default_rng(k)
    w = torch.from_numpy((rng.standard_normal((k, 70)) * 0.3).astype(
        np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((2, 3, k)).astype(
        np.float32)).to(cuda)
    pw = engine.program(w, cfg)
    y_ref = engine.matmul_reference(x, pw, cfg)
    y = engine.matmul(x, pw, dataclasses.replace(cfg, use_kernel=True))
    assert y.shape == y_ref.shape == (2, 3, 70)
    assert _rel_err(y_ref, y) <= 1e-6


def _case(seed, b=3, sq=2, hq=4, kv=2, hd=16, ps=4, p_seq=4, n_pages=9):
    """Ragged lengths, per-row offsets, a null-page tail and an aliased
    table (rows 0 and 1 share physical page 1)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages + 1, ps, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, ps, kv, hd)).astype(np.float32)
    kp[0] = vp[0] = 0.0
    pt = np.zeros((b, p_seq), np.int32)
    pt[0, :3] = [1, 2, 3]
    pt[1, :2] = [1, 4]
    pt[2, :4] = [5, 6, 7, 8]
    kv_len = np.array([9, 6, 16], np.int32)
    q_off = np.maximum(kv_len - sq, 0).astype(np.int32)
    q_off[1] = 2
    return q, kp, vp, pt, kv_len, q_off


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("sq,hd,causal", [(1, 16, True), (4, 128, True),
                                          (3, 64, False)])
def test_paged_attention_lanes_match_plain(cuda, dtype, rtol, sq, hd,
                                           causal):
    args = [torch.from_numpy(a).to(cuda) for a in _case(sq, sq=sq, hd=hd)]
    args[:3] = [t.to(dtype) for t in args[:3]]
    for lane, fn, plain, kw in (
            ("scratch", pa.paged_attention_scratch,
             pa_ref.paged_attention_ref, {}),
            ("streamed", pa.paged_attention_streamed,
             pa_ref.paged_attention_streamed_ref, {"block_pages": 2})):
        before = pa.LAUNCHES[f"paged_attention_{lane}"]
        out = fn(*args, causal=causal, **kw)
        torch.cuda.synchronize()
        assert pa.LAUNCHES[f"paged_attention_{lane}"] == before + 1
        ref = plain(*args, causal=causal, **kw)
        assert out.dtype == dtype and out.shape == ref.shape
        assert _rel_err(ref.float(), out.float()) <= rtol, lane


def test_paged_attention_row_without_valid_positions(cuda):
    """kv_len = 0: every position is masked, so the softmax is uniform over
    the whole table in both lanes and both versions."""
    args = [torch.from_numpy(a).to(cuda) for a in _case(3)]
    args[4] = torch.zeros_like(args[4])
    for fn, plain in ((pa.paged_attention_scratch,
                       pa_ref.paged_attention_ref),
                      (pa.paged_attention_streamed,
                       pa_ref.paged_attention_streamed_ref)):
        assert _rel_err(plain(*args), fn(*args)) <= 1e-5


def _long_case(seed, dtype, kv_len, max_len=2048, b=4, sq=4, hq=8, kv=4,
               hd=128, ps=8):
    """Long windows: each row's valid pages in order from a shared pool,
    the rest of its table random pages of the pool (read only at kv_len
    0), row 1's first page aliased to row 0's, the window at the end of
    the fill."""
    rng = np.random.default_rng(seed)
    p_seq = max_len // ps
    n_pages = b * p_seq
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages + 1, ps, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, ps, kv, hd)).astype(np.float32)
    kp[0] = vp[0] = 0.0
    pt = rng.integers(1, n_pages + 1, (b, p_seq)).astype(np.int32)
    nxt = 1
    for r, n in enumerate(kv_len):
        pages = -(-n // ps)
        pt[r, :pages] = np.arange(nxt, nxt + pages)
        nxt += pages
    pt[1, 0] = pt[0, 0]
    lens = np.array(kv_len, np.int32)
    q_off = np.maximum(lens - sq, 0).astype(np.int32)
    args = [torch.from_numpy(a).cuda() for a in
            (q, kp, vp, pt, lens, q_off)]
    args[:3] = [t.to(dtype) for t in args[:3]]
    return args


def _force_n_split(monkeypatch, n_split):
    """Make the streamed wrapper plan ``n_split`` splits (with an empty
    plan cache, restored afterwards)."""
    monkeypatch.setattr(pa, "_PLANS", {})
    monkeypatch.setattr(pa, "choose_n_split", lambda *a: n_split)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n_split", [None, 3, 16])
def test_streamed_lane_long_depth_split(cuda, monkeypatch, dtype, rtol,
                                        n_split):
    """Depth 2048 in blocks of 16 pages (16 blocks): the wrapper's own
    split count, one that does not divide the blocks, one per block."""
    if n_split is not None:
        _force_n_split(monkeypatch, n_split)
    args = _long_case(11, dtype, [2048, 1500, 300, 17])
    before = dict(pa.LAUNCHES)
    out = pa.paged_attention_streamed(*args, block_pages=16)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention_streamed"] == \
        before["paged_attention_streamed"] + 1
    assert pa.LAUNCHES["paged_attention_combine"] == \
        before["paged_attention_combine"] + 1
    ref = pa_ref.paged_attention_streamed_ref(*args, block_pages=16)
    assert out.dtype == dtype and out.shape == ref.shape
    assert _rel_err(ref.float(), out.float()) <= rtol


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n_split", [None, 3])
def test_streamed_lane_several_row_groups(cuda, monkeypatch, dtype, rtol,
                                          n_split):
    """g * sq = 3 * 8 = 24 query rows per KV head: a full 16-row group
    and a partial one, whose rows take their query position from
    (16 + row) % sq."""
    if n_split is not None:
        _force_n_split(monkeypatch, n_split)
    args = _long_case(15, dtype, [1024, 700, 33, 9], max_len=1024, sq=8,
                      hq=6, kv=2)
    out = pa.paged_attention_streamed(*args, block_pages=16)
    ref = pa_ref.paged_attention_streamed_ref(*args, block_pages=16)
    assert out.dtype == dtype and out.shape == ref.shape
    assert _rel_err(ref.float(), out.float()) <= rtol


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [80, 96, 192, 256])
def test_paged_lanes_wide_head_dims(cuda, dtype, rtol, hd):
    """Head dims that do not divide the 128-thread block (the scratch
    lane's P.V then loads V per output) and the streamed lane's wider
    instantiations (float32 at 256 runs a one-stage ring)."""
    args = _long_case(16 + hd, dtype, [512, 300, 40, 3], max_len=512,
                      hd=hd)
    for fn, plain, kw in (
            (pa.paged_attention_scratch, pa_ref.paged_attention_ref, {}),
            (pa.paged_attention_streamed,
             pa_ref.paged_attention_streamed_ref, {"block_pages": 4})):
        out = fn(*args, **kw)
        ref = plain(*args, **kw)
        assert _rel_err(ref.float(), out.float()) <= rtol, fn.__name__


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_lanes_are_deterministic(cuda, dtype):
    """Repeated calls on the same inputs are bitwise equal, in both
    lanes: no race in the rings, the merges or the combine."""
    short = _long_case(17, dtype, [64, 37, 12, 5], max_len=64, hq=32,
                       kv=16)
    long = _long_case(18, dtype, [2048, 1500, 300, 0], hq=32, kv=16)
    padded = _long_case(19, dtype, [512, 300, 0, 9], max_len=512, hd=40)
    for fn, args in ((pa.paged_attention_scratch, short),
                     (pa.paged_attention_scratch, long),
                     (pa.paged_attention_scratch, padded),
                     (pa.paged_attention_streamed, short),
                     (pa.paged_attention_streamed, long),
                     (pa.paged_attention_streamed, padded)):
        first = fn(*args)
        for _ in range(20):
            assert torch.equal(fn(*args), first), fn.__name__


@pytest.mark.parametrize("max_len,kv_len,causal,sq,hq,kv", [
    (64, [64, 37, 0, 5], True, 4, 32, 16),
    (2048, [2048, 1500, 0, 17], True, 4, 32, 16),
    (2048, [2048, 1500, 0, 17], False, 4, 32, 16),
    (4096, [4096, 3000, 0, 40], True, 4, 32, 16),
    (1024, [1024, 700, 0, 9], True, 8, 6, 2),       # 24 rows: two m16 tiles
    # batches that fill the card take smaller clusters: B 16 x kv 16 two
    # CTAs per window, B 40 x kv 16 one
    (4096, [4096, 3000, 0, 40] * 4, True, 4, 32, 16),
    (4096, [4096, 3000, 0, 40] * 10, True, 4, 32, 16)])
def test_bf16_scratch_lane_on_tensor_cores(cuda, max_len, kv_len, causal,
                                           sq, hq, kv):
    """The bf16 scratch lane (mma.sync) against the plain version, with a
    kv_len 0 row and an aliased page, causal and not, at every cluster
    size (8, 4, 2 and 1 CTAs per window)."""
    args = _long_case(20 + max_len, torch.bfloat16, kv_len, max_len=max_len,
                      b=len(kv_len), sq=sq, hq=hq, kv=kv)
    before = pa.LAUNCHES["paged_attention_scratch"]
    out = pa.paged_attention_scratch(*args, causal=causal)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention_scratch"] == before + 1
    ref = pa_ref.paged_attention_ref(*args, causal=causal)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert _rel_err(ref.float(), out.float()) <= 2e-2


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [40, 112])
def test_paged_lanes_padded_head_dims(cuda, dtype, rtol, hd):
    """Head dims off the streamed lane's compiled widths run on the next
    width up (40 on 64, 112 on 128); the scratch lane pads bf16 to 16."""
    assert pa.streamed_width(hd) > hd
    args = _long_case(30 + hd, dtype, [512, 300, 40, 3], max_len=512,
                      hd=hd)
    for fn, plain, kw in (
            (pa.paged_attention_streamed,
             pa_ref.paged_attention_streamed_ref, {"block_pages": 4}),
            (pa.paged_attention_scratch, pa_ref.paged_attention_ref, {})):
        out = fn(*args, **kw)
        ref = plain(*args, **kw)
        assert out.shape == ref.shape
        assert _rel_err(ref.float(), out.float()) <= rtol, fn.__name__


def test_streamed_lane_picks_several_splits_at_depth(cuda):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert pa.choose_n_split(4, 4, 16, 256, 16, 8, sms) > 1


@pytest.mark.parametrize("lane", ["scratch", "streamed"])
def test_long_depth_row_without_valid_positions(cuda, monkeypatch, lane):
    """kv_len = 0 at depth 2048: the uniform average over the whole
    table, every split of the streamed lane reading its tokens."""
    args = _long_case(12, torch.float32, [2048, 0, 700, 5], sq=1)
    if lane == "scratch":
        out = pa.paged_attention_scratch(*args)
        ref = pa_ref.paged_attention_ref(*args)
    else:
        _force_n_split(monkeypatch, 5)
        out = pa.paged_attention_streamed(*args, block_pages=16)
        ref = pa_ref.paged_attention_streamed_ref(*args, block_pages=16)
    assert _rel_err(ref, out) <= 1e-5


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_scratch_lane_long_depth(cuda, dtype, rtol):
    args = _long_case(13, dtype, [2048, 1999, 64, 1])
    before = pa.LAUNCHES["paged_attention_scratch"]
    out = pa.paged_attention_scratch(*args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention_scratch"] == before + 1
    assert _rel_err(pa_ref.paged_attention_ref(*args).float(),
                    out.float()) <= rtol


def test_scratch_lane_raises_past_its_capacity(cuda):
    cap = pa.scratch_capacity(4, 8, 4, 128, 8, 2)
    assert 4096 < cap < 8192          # 8 rows at bf16: about 6,100 tokens
    args = _long_case(14, torch.bfloat16, [8192, 100, 10, 1],
                      max_len=8192)
    before = pa.LAUNCHES["paged_attention_scratch"]
    with pytest.raises(ValueError, match=f"at most {cap} tokens"):
        pa.paged_attention_scratch(*args)
    assert pa.LAUNCHES["paged_attention_scratch"] == before


@pytest.mark.parametrize("b,k,n,w_bits,bpc,rows,dtype", [
    (16, 256, 384, 4, 1, 128, torch.float32),
    (5, 300, 200, 4, 1, 128, torch.bfloat16),      # ragged K, N and B
    (17, 512, 130, 4, 1, 256, torch.float32),
    (3, 96, 70, 5, 2, 32, torch.float32),
    (16, 2560, 4096, 4, 1, 128, torch.bfloat16),
    (16, 384, 256, 7, 1, 128, torch.float32),       # w_bits 7: S 7
    (9, 640, 264, 6, 2, 128, torch.bfloat16),       # bpc 2, 128 rows
    (4, 1000, 136, 4, 1, 128, torch.float32),       # K % 32 != 0
    (33, 512, 300, 4, 1, 128, torch.float32),       # three batch tiles
    (33, 200, 98, 7, 2, 64, torch.bfloat16)])      # ragged N, bf16
def test_deepnet_stream_matches_plain_and_programmed_mac(
        cuda, b, k, n, w_bits, bpc, rows, dtype):
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.integers(-128, 128, (b, k),
                                      dtype=np.int32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.4).astype(
        np.float32)).to(cuda).to(dtype)
    q = QuantConfig(w_bits=w_bits, in_bits=8, adc_bits=10,
                    bits_per_cell=bpc)
    scale = ds_ops.weight_scales(w, q)
    kw = dict(w_bits=w_bits, in_bits=8, adc_bits=10, bits_per_cell=bpc,
              rows_per_adc=rows)
    before = ds.LAUNCHES["deepnet_stream"]
    y = ds.deepnet_stream(x, w, scale, **kw)
    torch.cuda.synchronize()
    assert ds.LAUNCHES["deepnet_stream"] == before + 1
    y_ref = ds.ref.deepnet_stream_ref(x, w, scale, **kw)
    assert _rel_err(y_ref, y) <= 1e-6
    # the popcount kernel: an independent integer MAC of the same codes
    before = ds.LAUNCHES["deepnet_stream_popcount"]
    y_pop = ds.deepnet_stream_popcount(x, w, scale, **kw)
    assert ds.LAUNCHES["deepnet_stream_popcount"] == before + 1
    assert torch.equal(y, y_pop)
    # program + read through the crossbar-MAC kernel: the same codes
    pos, neg = ds.ref.quantize_codes(w, scale, w_bits=w_bits,
                                     bits_per_cell=bpc)
    pad = (-k) % rows
    xp = torch.nn.functional.pad(x, (0, pad))
    pos = torch.nn.functional.pad(pos, (0, 0, 0, pad)).contiguous()
    neg = torch.nn.functional.pad(neg, (0, 0, 0, pad)).contiguous()
    y_mac = mac.crossbar_mac(xp, pos, neg, 0.0, in_bits=8, adc_bits=10,
                             bits_per_cell=bpc, rows_per_adc=rows)
    assert torch.equal(y, y_mac)


@pytest.mark.parametrize("mode", ["deepnet", "expansion"])
def test_stream_linear_equals_the_programmed_read(cuda, mode):
    cfg = engine.EngineConfig(tile_rows=32, tile_cols=64, mode=mode,
                              use_kernel=True,
                              quant=QuantConfig(w_bits=4, in_bits=8,
                                                adc_bits=10))
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.standard_normal((128, 80)) * 0.3).astype(
        np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((2, 8, 128)).astype(
        np.float32)).to(cuda)
    y = ds_ops.stream_linear(x, w, cfg)
    assert y.shape == (2, 8, 80)
    assert torch.equal(y, engine.linear(x, w, cfg))
    assert torch.equal(ds_ops.stream_linear(x, w.bfloat16(), cfg),
                       engine.linear(x, w.bfloat16().float(), cfg))


# one band (2 x 2, 10 x 10, 12 x 8: ops.solve's shape) and many (the rest,
# a band remainder at 130 x 128)
JACOBI_SHAPES = [(2, 2), (10, 10), (12, 8), (37, 53), (128, 128),
                 (130, 128), (3, 700), (700, 3), (256, 256), (512, 512)]


def _jacobi_case(cuda, n, m):
    rng = np.random.default_rng(n * m)
    g = torch.from_numpy(rng.uniform(PAPER.g_reset, PAPER.g_set, (n, m))
                         .astype(np.float32)).to(cuda)
    v_in = torch.from_numpy(rng.uniform(0, PAPER.v_read, (n,)).astype(
        np.float32)).to(cuda)
    vr = v_in[:, None].expand(n, m).contiguous()
    vc = torch.from_numpy(rng.uniform(0, 0.01, (n, m)).astype(
        np.float32)).to(cuda)
    return g, v_in, vr, vc


@pytest.mark.parametrize("sweeps,omega", [(1, 1.0), (16, 1.0), (17, 1.0),
                                          (16, 0.8), (17, 0.8)])
@pytest.mark.parametrize("n,m", JACOBI_SHAPES)
def test_jacobi_sweeps_match_plain(cuda, n, m, sweeps, omega):
    """Bitwise against the plain sweep."""
    g, v_in, vr, vc = _jacobi_case(cuda, n, m)
    g_w = 1.0 / PAPER.r_wire
    before = ir.LAUNCHES["jacobi_sweeps"]
    kr, kc = ir.jacobi_sweeps(g, v_in[:, None].contiguous(), vr, vc,
                              g_w=g_w, omega=omega, sweeps=sweeps)
    torch.cuda.synchronize()
    assert ir.LAUNCHES["jacobi_sweeps"] == before + 1
    rr, rc = vr, vc
    for _ in range(sweeps):
        rr, rc = jacobi_sweep_ref(rr, rc, g, v_in, g_w, omega)
    assert torch.equal(kr, rr)
    assert torch.equal(kc, rc)


@pytest.mark.parametrize("n", [10, 64, 512])
def test_jacobi_sweeps_one_kernel_per_call_and_deterministic(cuda, n,
                                                             tmp_path):
    """One call is one device kernel (10: one band, a plain launch; 64 and
    512: 16 and 128 bands, a cooperative launch after the memset of its
    halo buffer); two calls give identical results."""
    import json

    from torch.profiler import ProfilerActivity, profile

    g, v_in, vr, vc = _jacobi_case(cuda, n, n)
    vin_col = v_in[:, None].contiguous()

    def run():
        return ir.jacobi_sweeps(g, vin_col, vr, vc, g_w=1.0 / PAPER.r_wire,
                                sweeps=16)

    first = run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = run()
        torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    kernels = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
               if e.get("ph") == "X"
               and str(e.get("cat", "")).lower() == "kernel"]
    assert len(kernels) == 1 and "jacobi_band_kernel" in kernels[0], kernels
    assert ir.band_plan(n, n).cooperative == (n > 10)


def test_jacobi_sweeps_past_capacity_raise_before_a_launch(cuda):
    n, m = 2, 20_000             # one row a band, more nodes than a CTA holds
    g = torch.full((n, m), PAPER.g_set, device=cuda)
    before = ir.LAUNCHES["jacobi_sweeps"]
    with pytest.raises(ValueError, match="132 co-resident bands"):
        ir.jacobi_sweeps(g, torch.zeros((n, 1), device=cuda), g,
                         torch.zeros_like(g), g_w=1.0, sweeps=4)
    assert ir.LAUNCHES["jacobi_sweeps"] == before


def test_ir_solve_matches_dense_nodal_solve(cuda):
    g = torch.full((12, 8), PAPER.g_set, device=cuda)
    v = torch.full((12,), PAPER.v_write, device=cuda)
    i_k, r_k, c_k = ir_ops.solve(g, v, n_iter=3000)
    # the kernel's 187 calls of 16 sweeps are the plain sweep 2,992 times
    i_p, r_p, c_p = ir_drop.jacobi_planar(g, v, n_iter=3000 // 16 * 16)
    assert torch.equal(r_k, r_p) and torch.equal(c_k, c_p)
    assert torch.equal(i_k, i_p)
    i_d, _, _ = ir_drop.solve_planar(g, v)
    assert float(((i_k - i_d).abs() / i_d).max()) < 2e-3
