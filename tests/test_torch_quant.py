"""Port parity: ``repro_torch.core.quant`` against ``repro.core.quant``.

Contract: the integer quantities — quantized weights and their scales,
cell planes, quantized inputs and their scales, pulse trains, positional
weights — are BITWISE equal on the same float inputs (both packages
divide correctly rounded and round half to even)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402

CFGS = [(4, 1), (4, 2), (8, 1), (8, 2)]


def _cfgs(w_bits, bpc, per_channel=True):
    kw = dict(w_bits=w_bits, bits_per_cell=bpc, in_bits=8, adc_bits=8,
              per_channel=per_channel)
    return jq.QuantConfig(**kw), tq.QuantConfig(**kw)


def _bitwise(a, b):
    a = np.asarray(a)
    b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _weight(seed, w_bits):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((96, 40)) * 0.3).astype(np.float32)
    # a column with amax = qmax (scale exactly 1): exact half-integers
    # exercise round-half-to-even
    qmax = 2.0 ** w_bits - 1.0
    w[:8, 0] = [qmax, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 6.5]
    w[8:, 0] = 0.0
    return w


@pytest.mark.parametrize("w_bits,bpc", CFGS)
def test_quantize_weights_and_slices_bitwise(w_bits, bpc):
    jc, tc = _cfgs(w_bits, bpc)
    w = _weight(w_bits * 10 + bpc, w_bits)
    jw, js = jq.quantize_weights(jnp.asarray(w), jc)
    tw, ts = tq.quantize_weights(torch.from_numpy(w), tc)
    assert _bitwise(jw, tw) and _bitwise(js, ts)
    assert float(tw[1, 0]) == 2.0 and float(tw[2, 0]) == -4.0  # half-even
    jp, jn = jq.to_slices(jw, jc)
    tp, tn = tq.to_slices(tw, tc)
    assert _bitwise(jp, tp) and _bitwise(jn, tn)
    assert tp.shape[0] == tc.n_slices == jc.n_slices


@pytest.mark.parametrize("w_bits,bpc", [(4, 1), (8, 2)])
def test_per_tensor_scale_bitwise(w_bits, bpc):
    jc, tc = _cfgs(w_bits, bpc, per_channel=False)
    w = _weight(3, w_bits)
    jw, js = jq.quantize_weights(jnp.asarray(w), jc)
    tw, ts = tq.quantize_weights(torch.from_numpy(w), tc)
    assert _bitwise(jw, tw) and _bitwise(js, ts)


@pytest.mark.parametrize("in_bits", [8, 10])
def test_quantize_inputs_and_pulse_trains_bitwise(in_bits):
    kw = dict(w_bits=4, in_bits=in_bits)
    jc, tc = jq.QuantConfig(**kw), tq.QuantConfig(**kw)
    rng = np.random.default_rng(in_bits)
    x = rng.standard_normal((5, 7, 33)).astype(np.float32)
    # a row with amax = qmax: exact half-integer quotients
    qmax = 2.0 ** (in_bits - 1) - 1.0
    x[0, 0, :6] = [qmax, 0.5, 1.5, -2.5, -0.5, 3.5]
    x[0, 0, 6:] = 0.0
    jx, js = jq.quantize_inputs(jnp.asarray(x), jc)
    tx, ts = tq.quantize_inputs(torch.from_numpy(x), tc)
    assert _bitwise(jx, tx) and _bitwise(js, ts)
    assert _bitwise(jq.to_bit_serial(jx, jc), tq.to_bit_serial(tx, tc))
    assert _bitwise(jq.bit_weights(jc), tq.bit_weights(tc))
    assert _bitwise(jq.slice_weights(jc), tq.slice_weights(tc))


def test_ste_round_passes_gradient_straight_through():
    x = torch.tensor([0.4, 1.5, 2.5, -0.6], requires_grad=True)
    y = tq.ste_round(x)
    assert y.tolist() == [0.0, 2.0, 2.0, -1.0]
    (y * torch.tensor([1.0, 2.0, 3.0, 4.0])).sum().backward()
    assert x.grad.tolist() == [1.0, 2.0, 3.0, 4.0]
