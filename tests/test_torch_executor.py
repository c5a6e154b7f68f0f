"""Port parity: the weight-resident executor against the reference's.

Contract: programming the same params (carried across by ``bridge``)
gives the same resident weight set, BITWISE-equal tile fingerprints
(``planes.fingerprint_tiles``: cell codes and scales) and weight
fingerprints, and the same ``residency()`` report; ``crossbar_linear``
routes by scoped name exactly as the reference does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import planes as jplanes  # noqa: E402
from repro.core.executor import CrossbarExecutor as JaxExecutor  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import planes as tplanes  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    CrossbarExecutor, crossbar_linear, scope)
from repro_torch.core.quant import QuantConfig  # noqa: E402


@pytest.fixture(scope="module")
def jax_params():
    cfg = dataclasses.replace(jax_config("qwen3-4b", smoke=True),
                              dtype=jnp.float32)
    return jax.device_get(jax_build(cfg).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mode", ["deepnet", "expansion"])
def test_program_params_matches_the_reference(jax_params, mode):
    jex = JaxExecutor(jeng.EngineConfig(mode=mode, tile_rows=32))
    tex = CrossbarExecutor(teng.EngineConfig(mode=mode, tile_rows=32))
    n_j = jex.program_params(jax_params)
    tparams = params_from_numpy(jax_params, "cpu")
    n_t = tex.program_params(tparams)
    # 7 linears per block x 2 layers + the head
    assert n_t == n_j == 15
    assert tex.residency() == jex.residency()
    assert tex.fingerprints() == jex.fingerprints()
    for name in jex.fingerprints():
        jpw = jex._cache[name].active_for("A")
        tpw = tex._cache[name].active_for("A")
        assert (tplanes.fingerprint_tiles(tpw)
                == jplanes.fingerprint_tiles(jpw)), name
    assert tex.n_devices == jex.n_devices
    assert tex.n_devices_physical == jex.n_devices_physical
    assert tex.device_token_cost() == jex.device_token_cost()
    # a second walk of the same tree is all cache hits
    assert tex.program_params(tparams) == 0
    assert tex.stats["cache_hits"] == 15 and tex.stats["programmed"] == 15
    with pytest.raises(RuntimeError, match="different params tree"):
        tex.ensure_programmed(params_from_numpy(jax_params, "cpu"))


def test_crossbar_linear_routes_by_scoped_name():
    cfg = teng.EngineConfig(tile_rows=32, tile_cols=32,
                            quant=QuantConfig(w_bits=8, in_bits=10,
                                              adc_bits=14))
    ex = CrossbarExecutor(cfg)
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((64, 32)) * 0.3).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    ex.program_params({"blocks": {"attn": {"wq": w[None]}}, "head": w})
    digital = x @ w
    # no active executor -> the digital thunk runs
    assert torch.equal(crossbar_linear(x, w, "head",
                                       digital=lambda: x @ w), digital)
    with ex.activate():
        y = crossbar_linear(x, w, "head", digital=lambda: x @ w)
        pw = ex._cache["head"].active_for("A")
        assert torch.equal(y, teng.matmul(x, pw, ex.cfg))
        assert not torch.equal(y, digital)
        assert torch.allclose(y, digital, rtol=0.05, atol=0.05)
        with scope("blocks"), scope(0), scope("attn"):
            y0 = crossbar_linear(x, w, "wq")
            assert torch.equal(y0, y)          # same weight, same tiles
            z = crossbar_linear(x, w, "nonexistent", digital=lambda: x @ w)
            assert torch.equal(z, digital)
            with pytest.raises(ValueError, match="no resident tiles"):
                crossbar_linear(x, w, "nonexistent")


def test_single_tenant_slice_refuses_later_features():
    ex = CrossbarExecutor()
    w = torch.ones((8, 8))
    ex.program_params({"head": w})
    for call in (lambda: ex.program_params({"head": w}, tenant="B"),
                 lambda: ex.evict_tenant("B")):
        with pytest.raises(NotImplementedError, match="later slice"):
            call()
