"""Port parity: the reference's other decoder LMs and their activations.

Contract (docs/PORT.md, "Other dense configs and the MoE family"):
* every FULL and SMOKE config of qwen3-8b, minitron-4b, nemotron-4-340b,
  phi3.5-moe and grok-1-314b carries the reference's value in every field
  the port's ``ModelConfig`` has, and the reference's aliases resolve;
* on each SMOKE config at float32 with the crossbar backend and a paged
  KV cache, the same params (carried across by ``bridge``) and prompts
  give IDENTICAL greedy streams in the port's ``BatchScheduler`` and the
  reference's, with the kernel path on and off (on the CPU the wrappers
  run their plain versions), and equal ``executor.fingerprint()``s;
* ``layers.gelu`` and ``layers.relu2`` equal ``jax.nn.gelu`` and
  ``jnp.square(jax.nn.relu(.))`` BITWISE on every bfloat16 pattern whose
  input and output (also the output in float32, before its rounding to
  bf16) are normal or zero: XLA's CPU flushes subnormals to zero, torch
  does not (508 gelu and 511 relu2 patterns differ); at float32 relu2 is
  bitwise and gelu within 2^-21 x max(|x|, 1) (XLA's float32 tanh is not
  torch's).
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve.engine import BatchScheduler as JaxScheduler  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ALIASES, get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import ModelConfig, build_model  # noqa: E402
from repro_torch.serve.engine import BatchScheduler, Request  # noqa: E402

ARCHS = ["qwen3-8b", "minitron-4b", "nemotron-4-340b", "phi3.5-moe",
         "grok-1-314b"]
PROMPT_LENS = (5, 11, 3)
MAX_NEW = 4
#: ModelConfig fields that are no configuration of the architecture
NOT_ARCH = {"dtype", "kv_dtype", "xbar", "backend", "paged_kernel",
            "paged_stream_pages", "paged_block_pages"}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab - 1, n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(sched, make_request, vocab):
    prompts = _prompts(vocab)
    for i, p in enumerate(prompts):
        sched.submit(make_request(rid=i, prompt=p, max_new=MAX_NEW))
    done, steps = [], 0
    while len(done) < len(prompts) and steps < 100:
        done += sched.step()
        steps += 1
    return {r.rid: list(r.out) for r in done}


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's streams, params and fingerprint for one arch."""
    arch = request.param
    cfg = dataclasses.replace(jax_config(arch, smoke=True),
                              backend="crossbar", dtype=jnp.float32)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    streams = _serve(JaxScheduler(model, params, n_slots=2, max_len=32),
                     lambda prompt, **kw: JaxRequest(
                         prompt=jnp.asarray(prompt), **kw), cfg.vocab)
    return {"arch": arch, "streams": streams,
            "params": jax.device_get(params),
            "fingerprint": model.executor.fingerprint()}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_smoke_streams_equal_the_reference(reference, use_kernel):
    base = get_config(reference["arch"], smoke=True)
    cfg = dataclasses.replace(
        base, backend="crossbar", dtype=torch.float32,
        paged_kernel=use_kernel,
        xbar=dataclasses.replace(base.xbar, use_kernel=use_kernel))
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(reference["params"], "cpu")
    streams = _serve(BatchScheduler(model, params, n_slots=2, max_len=32,
                                    kv="paged"), Request, cfg.vocab)
    assert streams == reference["streams"]
    assert all(len(s) == MAX_NEW for s in streams.values())
    assert model.executor.fingerprint() == reference["fingerprint"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_carry_the_reference_fields(arch, smoke):
    port, ref = get_config(arch, smoke=smoke), jax_config(arch, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        if f.name not in NOT_ARCH:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.moe == (None if ref.moe is None else layers.MoEConfig(
        *dataclasses.astuple(ref.moe)))


def test_aliases_and_the_cli_refusal():
    assert get_config("phi3.5-moe-42b-a6.6b") is get_config("phi3.5-moe")
    assert {ALIASES[a] for a in ARCHS} | {"qwen3_4b"} == set(
        ALIASES.values())
    with pytest.raises(SystemExit, match="later slice"):
        serve_cli.main(["--arch", "whisper-base", "--smoke", "--device",
                        "cpu"])


# -- the activations ---------------------------------------------------------

def _bf16_patterns():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    return bits.view(ml_dtypes.bfloat16)


def _normal_or_zero(a):
    a = np.asarray(a, np.float32)   # bf16 has float32's exponent range
    return np.isfinite(a) & ((a == 0) | (np.abs(a) >= 2.0 ** -126))


#: bf16 patterns compared: finite, and no subnormal input or result
N_COMPARED = {"gelu": 64770, "relu2": 55299}
ACTS = {"gelu": (layers.gelu, jax.jit(jax.nn.gelu)),
        "relu2": (layers.relu2,
                  jax.jit(lambda h: jnp.square(jax.nn.relu(h))))}


@pytest.mark.parametrize("act", sorted(ACTS))
def test_activation_bitwise_on_normal_bf16_patterns(act):
    port, ref = ACTS[act]
    x = _bf16_patterns()
    want = np.asarray(ref(jnp.asarray(x)))
    got = port(torch.from_numpy(x.view(np.int16)).view(torch.bfloat16))
    got = got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    # XLA flushes a subnormal input or result to zero, torch keeps it;
    # the result before its rounding to bf16 is the float32 one
    out32 = port(torch.from_numpy(x.astype(np.float32))).numpy()
    keep = (_normal_or_zero(x) & _normal_or_zero(out32)
            & _normal_or_zero(want) & _normal_or_zero(got))
    assert keep.sum() == N_COMPARED[act]
    assert np.array_equal(got[keep].view(np.uint16),
                          want[keep].view(np.uint16))


@pytest.mark.parametrize("act", sorted(ACTS))
def test_activation_at_float32(act):
    port, ref = ACTS[act]
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(100_000) * 3,
                        np.linspace(-40, 40, 100_001),
                        rng.standard_normal(4000) * 1e4]).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(x)))
    got = port(torch.from_numpy(x)).numpy()
    if act == "relu2":
        assert np.array_equal(got, want)
    else:
        assert np.all(np.abs(got - want)
                      <= 2.0 ** -21 * np.maximum(np.abs(x), 1))


def test_mlp_applies_the_act_and_draws_no_gate():
    gen = torch.Generator().manual_seed(0)
    for act in ("relu2", "gelu"):
        p = layers.mlp_init(gen, 16, 24, act, "cpu")
        assert sorted(p) == ["wi", "wo"]
        x = torch.randn((2, 3, 16), generator=gen)
        want = torch.einsum("bsf,fd->bsd", ACTS[act][0](x @ p["wi"]),
                            p["wo"])
        assert torch.equal(layers.mlp(p, x, act), want)
