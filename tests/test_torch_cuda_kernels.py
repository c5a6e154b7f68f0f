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
  lane's weights and both lanes' outputs; its unit roundoff is 3.9e-3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.kernels.crossbar_mac import kernel as mac  # noqa: E402
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
    (17, 2560, 4096, 4, 1, 128, 0.0)])
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
