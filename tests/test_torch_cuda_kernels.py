"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without CUDA (the
kernels have no CPU mode); on a machine with a card run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

This file imports neither JAX nor the reference package, so it runs where
only the port is installed.

Contracts:
* crossbar MAC: 1e-6 x max|y| — the kernel accumulates the integer ADC
  codes exactly (int64), the plain version shift-adds them in f32;
* paged attention: 1e-5 x max|out| at float32 (exp and f32 sums in
  another order), 2e-2 at bfloat16 (the value type rounds the scratch
  lane's weights and both lanes' outputs; its unit roundoff is 3.9e-3);
* deep-net streaming: 1e-6 x max|y| against its plain version (as the
  MAC), and BITWISE equal to ``engine.program`` + the crossbar-MAC kernel
  (the same integer codes and the same final conversion);
* Jacobi sweeps: rtol 1e-5 / atol 1e-7 against the plain sweep (the
  kernel repeats its float32 operations in order, without FMA
  contraction); the full solve within 2e-3 of the dense nodal solve.
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


@pytest.mark.parametrize("b,k,n,w_bits,bpc,rows,dtype", [
    (16, 256, 384, 4, 1, 128, torch.float32),
    (5, 300, 200, 4, 1, 128, torch.bfloat16),      # ragged K, N and B
    (17, 512, 130, 4, 1, 256, torch.float32),
    (3, 96, 70, 5, 2, 32, torch.float32),
    (16, 2560, 4096, 4, 1, 128, torch.bfloat16)])
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


@pytest.mark.parametrize("n,m,sweeps,omega", [
    (10, 10, 1, 1.0), (10, 10, 16, 1.0), (37, 53, 5, 0.8),
    (128, 128, 16, 1.0), (512, 512, 4, 1.0)])
def test_jacobi_sweeps_match_plain(cuda, n, m, sweeps, omega):
    rng = np.random.default_rng(n * m)
    g = torch.from_numpy(rng.uniform(PAPER.g_reset, PAPER.g_set, (n, m))
                         .astype(np.float32)).to(cuda)
    v_in = torch.from_numpy(rng.uniform(0, PAPER.v_read, (n,)).astype(
        np.float32)).to(cuda)
    g_w = 1.0 / PAPER.r_wire
    vr = v_in[:, None].expand(n, m).contiguous()
    vc = torch.from_numpy(rng.uniform(0, 0.01, (n, m)).astype(
        np.float32)).to(cuda)
    before = ir.LAUNCHES["jacobi_sweeps"]
    kr, kc = ir.jacobi_sweeps(g, v_in[:, None].contiguous(), vr, vc,
                              g_w=g_w, omega=omega, sweeps=sweeps)
    torch.cuda.synchronize()
    assert ir.LAUNCHES["jacobi_sweeps"] == before + 1
    rr, rc = vr, vc
    for _ in range(sweeps):
        rr, rc = jacobi_sweep_ref(rr, rc, g, v_in, g_w, omega)
    assert torch.allclose(kr, rr, rtol=1e-5, atol=1e-7)
    assert torch.allclose(kc, rc, rtol=1e-5, atol=1e-7)


def test_ir_solve_matches_dense_nodal_solve(cuda):
    g = torch.full((12, 8), PAPER.g_set, device=cuda)
    v = torch.full((12,), PAPER.v_write, device=cuda)
    i_k, _, _ = ir_ops.solve(g, v, n_iter=3000)
    i_d, _, _ = ir_drop.solve_planar(g, v)
    assert float(((i_k - i_d).abs() / i_d).max()) < 2e-3
