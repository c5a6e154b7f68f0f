"""Port parity: the MLP gate of ``repro_torch.models.layers``.

Contract: ``layers.silu(g) * h``, the gate ``layers.mlp`` computes, equals
the reference's ``jax.nn.silu(g) * h`` BITWISE at bfloat16 (the exp, the
add, the divide and the product each rounded to bfloat16, as the
reference rounds them), and within 2^-21 of it, relative, at float32 (two
of the four steps may land one ulp apart).  ``F.silu`` rounds once and
differs from the reference in a third of the bfloat16 outputs or more.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.models import layers  # noqa: E402

N = 8192


def _gate_inputs(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(N) * 4).astype(np.float32)
    g[:64] = np.linspace(-90, 90, 64)        # both saturated tails
    h = rng.standard_normal(N).astype(np.float32)
    return g, h


@pytest.mark.parametrize("dtype,jdtype,rtol", [
    (torch.bfloat16, jnp.bfloat16, 0.0),
    (torch.float32, jnp.float32, 2.0 ** -21)])
def test_mlp_gate_rounds_as_the_reference(dtype, jdtype, rtol):
    g, h = _gate_inputs(0)
    got = (layers.silu(torch.from_numpy(g).to(dtype))
           * torch.from_numpy(h).to(dtype)).float().numpy()
    want = np.asarray((jax.nn.silu(jnp.asarray(g).astype(jdtype))
                       * jnp.asarray(h).astype(jdtype)).astype(jnp.float32))
    if rtol == 0.0:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def test_mlp_uses_the_reference_rounding():
    """``mlp``'s digital path computes the gate with ``layers.silu``."""
    rng = np.random.default_rng(1)
    p = {k: torch.from_numpy(
        (rng.standard_normal(s) * 0.3).astype(np.float32))
        for k, s in (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(
        np.float32)).to(torch.bfloat16)
    got = layers.mlp(p, x)
    h = x @ p["wi"].to(x.dtype)
    g = x @ p["wg"].to(x.dtype)
    want = torch.einsum("bsf,fd->bsd", layers.silu(g) * h,
                        p["wo"].to(x.dtype))
    assert torch.equal(got, want)
