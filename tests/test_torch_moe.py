"""Port parity: the token-dropping MoE block (``layers.moe_block``).

Contract (docs/PORT.md, "Other dense configs and the MoE family"): on
the same params and inputs at float32, ``moe_block`` picks the
reference's experts for every token (``top_e`` EQUAL to
``jax.lax.top_k`` of the reference's gates), its gates agree to 1e-6 and
its output to 1e-5 x max|y|; among equal gates the lower expert index
wins (three identical router columns: experts 0 and 1), and when the
router sends more tokens to an expert than its capacity the port drops
the tokens the reference drops (a row's later tokens), so their outputs
are what the reference's are.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers  # noqa: E402

B, S, D, F, E = 3, 8, 16, 24, 4
RTOL = 1e-5


def _params(rng, act, e=E):
    p = {"router": rng.standard_normal((D, e)) * D ** -0.5,
         "wi": rng.standard_normal((e, D, F)) * D ** -0.5,
         "wo": rng.standard_normal((e, F, D)) * F ** -0.5}
    if act == "swiglu":
        p["wg"] = rng.standard_normal((e, D, F)) * D ** -0.5
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p, x, cfg):
    """(the port's y, gates, top_e), (the reference's y, gates, top_e)."""
    jcfg = jlayers.MoEConfig(cfg.n_experts, cfg.top_k, cfg.capacity_factor,
                             cfg.act)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y, gates = jlayers.moe_block(jp, jnp.asarray(x), jcfg)
    want = (np.asarray(y), np.asarray(gates),
            np.asarray(jax.lax.top_k(gates, cfg.top_k)[1]))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    y, gates = layers.moe_block(tp, tx, cfg)
    _, _, top_e = layers.moe_route(tp, tx, cfg)
    return (y.numpy(), gates.numpy(), top_e.numpy()), want


def _close(got, want):
    (y, gates, top_e), (wy, wgates, wtop_e) = got, want
    assert np.array_equal(top_e, wtop_e)
    np.testing.assert_allclose(gates, wgates, rtol=0, atol=1e-6)
    assert np.abs(y - wy).max() <= RTOL * np.abs(wy).max()


def _capacity(cfg, s=S):
    return max(1, int(-(-s * cfg.top_k * cfg.capacity_factor
                        // cfg.n_experts)))


@pytest.mark.parametrize("top_k", [2, 3, 4])
@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_moe_block_matches_the_reference(act, top_k):
    rng = np.random.default_rng(0)
    cfg = layers.MoEConfig(E, top_k, 1.25, act)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    _close(*_both(_params(rng, act), x, cfg))


def _sorted_rows(rng, k, dtype, b=B, s=S, d=D):
    """Weighted rows ``ys`` of a sorted assignment list and its ``order``
    (each token's k experts distinct, as top-k's are)."""
    ids = np.stack([rng.permutation(E)[:k] for _ in range(b * s)])
    order = torch.argsort(torch.from_numpy(ids.reshape(b, s * k)), dim=-1,
                          stable=True)
    ys = torch.from_numpy(
        rng.standard_normal((b, s * k, d)).astype(np.float32)).to(dtype)
    ys[0, 0, :2] = -0.0                 # a zero start turns -0.0 to +0.0
    return ys, order


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("top_k", [3, 4])
def test_combine_is_bitwise_the_scatter_add(top_k):
    """The fixed-order combine gives, at float32, the bits of the CPU
    ``scatter_add_`` it replaced; at bfloat16 those of the reference's
    scatter (each add rounded to bf16, where the CPU ``scatter_add_``
    accumulated in float32 and rounded once)."""
    rng = np.random.default_rng(3)
    ys, order = _sorted_rows(rng, top_k, torch.float32)
    tok = (order // top_k)[..., None].expand(ys.shape)
    old = torch.zeros((B, S, D)).scatter_add_(1, tok, ys)
    assert torch.equal(_bits(layers.moe_combine(ys, order, top_k)),
                       _bits(old))
    yb = ys.to(torch.bfloat16)
    ref = jax.vmap(lambda acc, t, v: acc.at[t].add(v))(
        jnp.zeros((B, S, D), jnp.bfloat16), jnp.asarray(order.numpy()
                                                       // top_k),
        jnp.asarray(yb.float().numpy()).astype(jnp.bfloat16))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(
        torch.bfloat16)
    assert torch.equal(_bits(layers.moe_combine(yb, order, top_k)),
                       _bits(ref))


def test_equal_gates_pick_the_lower_experts():
    rng = np.random.default_rng(1)
    cfg = layers.MoEConfig(E, 2, 1.25, "swiglu")
    p = _params(rng, "swiglu")
    p["router"][:, 1] = p["router"][:, 2] = p["router"][:, 0]
    p["router"][:, 3] = 0.0
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    got, want = _both(p, x, cfg)
    _close(got, want)
    top_e = got[2]
    lead = (x @ p["router"][:, 0]) > 0          # the three tie at the top
    assert lead.any() and (~lead).any()
    assert (top_e[lead] == [0, 1]).all()
    assert (top_e[~lead] == [3, 0]).all()       # expert 0 wins the tie


def test_over_capacity_drops_the_tokens_the_reference_drops():
    rng = np.random.default_rng(2)
    cfg = layers.MoEConfig(E, 2, 1.25, "gelu")
    p = _params(rng, "gelu")
    p["router"][:, 0] = 4.0 / D                 # expert 0 first for all
    x = (rng.standard_normal((B, S, D)) + 2.0).astype(np.float32)
    got, want = _both(p, x, cfg)
    _close(got, want)
    c = _capacity(cfg)
    assert (got[2][..., 0] == 0).all() and c < S
    # with room for every assignment (C = S * top_k) nothing drops: each
    # token past expert 0's first C lost its first expert's share
    roomy = layers.MoEConfig(E, 2, float(E), "gelu")
    assert _capacity(roomy) == S * 2
    full, want_full = _both(p, x, roomy)
    _close(full, want_full)
    lost = np.abs(got[0] - full[0]).max(axis=-1)            # (B, S)
    assert (lost[:, c:] > 0).all()
