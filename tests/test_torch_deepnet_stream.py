"""Port parity: the deep-net streaming kernel's plain version and
``stream_linear`` against the reference's.

Contract:
* ``deepnet_stream_ref`` against JAX's Pallas ``deepnet_stream``
  (interpret mode) at (8, 64, 32): the integer code sums (output / LSB)
  are EQUAL — quantization, cell digits and ADC codes are exact in both
  packages — and every output is within the reference test's 0.05 (the
  f32 shift-add runs in another order);
* ``stream_linear`` against JAX's ``stream_linear`` and against the
  port's programmed read ``engine.linear`` at (16, 96) x (96, 80): atol
  1e-4, as the reference's kernel-path test;
* the scales ``stream_linear`` forms without a float32 copy of the
  weight equal ``quant.weight_scales`` of that copy, bitwise;
* at ``w_bits`` 8 (the kernels' widest) the cell-code planes are EQUAL
  to the reference's, and both packages' outputs lie within 4 float32
  ulps of the exact code sums x LSB.
The CUDA kernel is held against the plain version, and bitwise against
the programmed crossbar-MAC read, on the card
(test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.kernels.deepnet_stream import kernel as jkernel  # noqa: E402
from repro.kernels.deepnet_stream import ops as jops  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels.crossbar_mac import ref as tmac  # noqa: E402
from repro_torch.kernels.deepnet_stream import kernel as tkernel  # noqa: E402
from repro_torch.kernels.deepnet_stream import ops as tops  # noqa: E402
from repro_torch.kernels.deepnet_stream import ref as tref  # noqa: E402

KW = dict(w_bits=4, in_bits=8, adc_bits=10, bits_per_cell=1,
          rows_per_adc=32)


def _operands(b, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x_int = rng.integers(-128, 128, (b, k), dtype=np.int32)
    w = (rng.standard_normal((k, n)) * 0.4).astype(np.float32)
    return x_int, w


def test_plain_version_matches_the_reference_kernel():
    x_int, w = _operands(8, 64, 32)
    q = jq.QuantConfig(w_bits=4, in_bits=8, adc_bits=10)
    ws = np.array(jq.weight_scales(jnp.asarray(w), q))
    want = np.asarray(jkernel.deepnet_stream(
        jnp.asarray(x_int), jnp.asarray(w), jnp.asarray(ws), block_b=8,
        block_n=32, interpret=True, **KW))
    got = tref.deepnet_stream_ref(torch.from_numpy(x_int),
                                  torch.from_numpy(w), torch.from_numpy(ws),
                                  **KW).numpy()
    lsb = np.float32(KW["rows_per_adc"] / (2.0 ** KW["adc_bits"] - 1.0))
    codes_got = np.rint(got.astype(np.float64) / lsb)
    codes_want = np.rint(want.astype(np.float64) / lsb)
    # both are integer code sums times the LSB, to well under half a code
    assert np.abs(got / lsb - codes_got).max() < 0.05
    assert np.array_equal(codes_got, codes_want)
    assert np.abs(got - want).max() <= 0.05
    # the CPU wrapper is the plain version
    before = dict(tkernel.LAUNCHES)
    via = tkernel.deepnet_stream(torch.from_numpy(x_int),
                                 torch.from_numpy(w), torch.from_numpy(ws),
                                 **KW).numpy()
    assert np.array_equal(via, got)
    # so is the popcount witness's
    via = tkernel.deepnet_stream_popcount(
        torch.from_numpy(x_int), torch.from_numpy(w), torch.from_numpy(ws),
        **KW).numpy()
    assert tkernel.LAUNCHES == before
    assert np.array_equal(via, got)


def test_plain_version_pads_a_ragged_last_row_group():
    x_int, w = _operands(3, 80, 16, seed=1)
    ws = tops.weight_scales(torch.from_numpy(w), tq.QuantConfig(w_bits=4))
    got = tref.deepnet_stream_ref(torch.from_numpy(x_int),
                                  torch.from_numpy(w), ws, **KW)
    pad = (-80) % 32
    want = tref.deepnet_stream_ref(
        torch.from_numpy(np.pad(x_int, ((0, 0), (0, pad)))),
        torch.from_numpy(np.pad(w, ((0, pad), (0, 0)))), ws, **KW)
    assert torch.equal(got, want)


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scales_equal_the_quantizer_on_a_float_copy(dtype, per_channel):
    _, w = _operands(1, 96, 80, seed=2)
    w = torch.from_numpy(w).to(dtype)
    q = tq.QuantConfig(w_bits=4, per_channel=per_channel)
    got = tops.weight_scales(w, q)
    want = tq.weight_scales(w.float(), q)
    assert got.shape == (1, 80)
    assert torch.equal(got, want.expand(1, 80))


@pytest.mark.parametrize("mode", ["deepnet", "expansion"])
def test_stream_linear_matches_the_reference_and_the_programmed_read(mode):
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((96, 80)) * 0.3).astype(np.float32)
    x = rng.standard_normal((16, 96)).astype(np.float32)
    qk = dict(w_bits=4, in_bits=8, adc_bits=10)
    jcfg = jeng.EngineConfig(tile_rows=32, tile_cols=64, mode=mode,
                             quant=jq.QuantConfig(**qk))
    tcfg = teng.EngineConfig(tile_rows=32, tile_cols=64, mode=mode,
                             quant=tq.QuantConfig(**qk))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tops.stream_linear(tx, tw, tcfg).numpy()
    assert got.shape == (16, 80)
    if mode == "deepnet":
        # the reference's interpret-mode kernel takes ~4 s a call on the
        # CPU, so it is run once, in the layout stream_linear is for
        want = np.asarray(jops.stream_linear(jnp.asarray(x),
                                             jnp.asarray(w), jcfg))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    prog = teng.linear(tx, tw, tcfg).numpy()
    np.testing.assert_allclose(got, prog, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bpc", [1, 2])
def test_stream_linear_at_8_weight_bits_matches_the_reference(bpc):
    """``w_bits`` 8 (codes up to +-255, the widest the card's kernels
    take): the cell-code planes EQUAL the reference's; code sums reach
    ~6e6 here, past float32's exact integers, so the plain version's and
    the reference kernel's outputs are each held within 4 float32 ulps
    of the largest output to the exact code sums x LSB; ``stream_linear``
    agrees with the reference's and with the programmed read within
    1e-4."""
    kw = dict(KW, w_bits=8, bits_per_cell=bpc)
    x_int, w = _operands(8, 64, 32, seed=8)
    q = jq.QuantConfig(w_bits=8, in_bits=8, adc_bits=10, bits_per_cell=bpc)
    ws = np.array(jq.weight_scales(jnp.asarray(w), q))
    pos, neg = tref.quantize_codes(torch.from_numpy(w), torch.from_numpy(ws),
                                   w_bits=8, bits_per_cell=bpc)
    w_int = jnp.clip(jnp.round(jnp.asarray(w) / ws), -255.0, 255.0)
    jpos, jneg = jq.to_slices(w_int, q)
    assert pos.shape[0] == -(-8 // bpc)
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert np.array_equal(neg.numpy(), np.asarray(jneg))
    want = np.asarray(jkernel.deepnet_stream(
        jnp.asarray(x_int), jnp.asarray(w), jnp.asarray(ws), block_b=8,
        block_n=32, interpret=True, **kw))
    got = tref.deepnet_stream_ref(torch.from_numpy(x_int),
                                  torch.from_numpy(w), torch.from_numpy(ws),
                                  **kw).numpy()
    codes = tmac.crossbar_mac_codes_ref(
        torch.from_numpy(x_int), pos, neg, in_bits=8, adc_bits=10,
        bits_per_cell=bpc, rows_per_adc=32).numpy()
    exact = codes * np.float64(np.float32(32 * (2 ** bpc - 1) / 1023.0))
    bound = 4 * np.spacing(np.float32(np.abs(exact).max()))
    assert np.abs(got - exact).max() <= bound
    assert np.abs(want - exact).max() <= bound
    rng = np.random.default_rng(9)
    wl = (rng.standard_normal((96, 80)) * 0.3).astype(np.float32)
    x = rng.standard_normal((16, 96)).astype(np.float32)
    qk = dict(w_bits=8, in_bits=8, adc_bits=10, bits_per_cell=bpc)
    jcfg = jeng.EngineConfig(tile_rows=32, tile_cols=64, mode="deepnet",
                             quant=jq.QuantConfig(**qk))
    tcfg = teng.EngineConfig(tile_rows=32, tile_cols=64, mode="deepnet",
                             quant=tq.QuantConfig(**qk))
    tx, tw = torch.from_numpy(x), torch.from_numpy(wl)
    y = tops.stream_linear(tx, tw, tcfg).numpy()
    np.testing.assert_allclose(
        y, np.asarray(jops.stream_linear(jnp.asarray(x), jnp.asarray(wl),
                                         jcfg)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(y, teng.linear(tx, tw, tcfg).numpy(), rtol=0,
                               atol=1e-4)
