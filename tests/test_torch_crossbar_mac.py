"""Port parity: the crossbar MAC (plain version, engine dispatch, the
odd-row-tile fallback) against the reference package.

Contract:
* cell planes, weight scales and ADC codes are BITWISE equal;
* float outputs agree to 1e-6 x max|y|: the pre-ADC sums and the codes
  are exact integers in both packages, but the f32 shift-add over
  (bit, slice, row group) and the final scaling sum in different orders
  (the reference's own scan and einsum forms differ by ~1e-7 relative).
The CUDA kernel is held against the plain version on the card
(test_torch_cuda_kernels.py).
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.kernels.crossbar_mac import kernel as jkernel  # noqa: E402
from repro.kernels.crossbar_mac import ref as jref  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels.crossbar_mac import kernel as tkernel  # noqa: E402
from repro_torch.kernels.crossbar_mac import ops as tops  # noqa: E402

RTOL = 1e-6   # x max|y|; f32 shift-add order (module docstring)


def _close(a, b, rtol=RTOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() <= rtol * max(np.abs(a).max(), 1e-30)


def _operands(seed, b, k, n, s, bpc, in_bits=8):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2 ** (in_bits - 1), 2 ** (in_bits - 1), (b, k),
                     dtype=np.int32)
    pos = rng.integers(0, 2 ** bpc, (s, k, n)).astype(np.int8)
    neg = rng.integers(0, 2 ** bpc, (s, k, n)).astype(np.int8)
    return x, pos, neg


@pytest.mark.parametrize("mode,leak,bpc,s", [
    ("deepnet", 0.0, 1, 4), ("deepnet", 0.37, 2, 2),
    ("expansion", 0.0, 2, 2), ("expansion", 0.37, 1, 4)])
def test_plain_mac_matches_jax_kernel_and_ref(mode, leak, bpc, s):
    tile_rows = 16
    rows = tile_rows if mode == "deepnet" else 2 * tile_rows
    x, pos, neg = _operands(7, 8, 64, 48, s, bpc)
    kw = dict(in_bits=8, adc_bits=6, bits_per_cell=bpc, rows_per_adc=rows,
              full_scale_rows=rows)
    y_t = tkernel.crossbar_mac(torch.from_numpy(x), torch.from_numpy(pos),
                               torch.from_numpy(neg), leak, **kw)
    y_jk = jkernel.crossbar_mac(jnp.asarray(x), jnp.asarray(pos),
                                jnp.asarray(neg), leak, block_b=8,
                                block_n=48, interpret=True, **kw)
    y_jr = jref.crossbar_mac_ref(jnp.asarray(x), jnp.asarray(pos),
                                 jnp.asarray(neg), leak_codes=leak, **kw)
    assert y_t.dtype == torch.float32 and tuple(y_t.shape) == (8, 48)
    assert _close(y_jk, y_t.numpy()) and _close(y_jr, y_t.numpy())


@pytest.mark.parametrize("rows,bpc,leak,in_bits,k,n", [
    (128, 1, 0.0, 8, 256, 96), (128, 1, 0.37, 4, 256, 64),
    (256, 1, 0.0, 4, 512, 32), (256, 1, 0.37, 8, 256, 48),
    (128, 2, 0.0, 8, 128, 40), (128, 2, 0.37, 4, 256, 96)])
def test_code_sums_ref_matches_jax_kernel(rows, bpc, leak, in_bits, k, n):
    """``crossbar_mac_codes_ref`` gives the exact int64 code sums the CUDA
    kernel accumulates: equal to the JAX kernel's output / lsb (rounded),
    and times lsb within 1e-6 of the plain f32 version."""
    s = 2
    x, pos, neg = _operands(rows + k + n, 4, k, n, s, bpc, in_bits)
    kw = dict(in_bits=in_bits, adc_bits=8, bits_per_cell=bpc,
              rows_per_adc=rows, full_scale_rows=rows)
    codes = tkernel.ref.crossbar_mac_codes_ref(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(neg),
        leak_codes=leak, **kw)
    assert codes.dtype == torch.int64 and tuple(codes.shape) == (4, n)
    y_jk = np.asarray(jkernel.crossbar_mac(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(neg), leak,
        block_b=4, block_n=n, interpret=True, **kw), np.float64)
    full_scale = float(rows * (2 ** bpc - 1))
    lsb = tkernel.ref.adc_lsb(8, full_scale)
    assert np.array_equal(np.rint(y_jk / lsb).astype(np.int64),
                          codes.numpy())
    y_t = tkernel.ref.crossbar_mac_ref(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(neg),
        leak_codes=leak, **kw)
    y_c = tkernel.ref.codes_to_float(codes, 8, full_scale)
    assert _close(y_t.numpy(), y_c.numpy())


@pytest.mark.parametrize("mode,bpc,adc_bits", [
    ("deepnet", 1, 8), ("expansion", 1, 8), ("deepnet", 2, 6),
    ("expansion", 2, 10)])
def test_adc_codes_bitwise(mode, bpc, adc_bits):
    q = dict(w_bits=4, in_bits=8, adc_bits=adc_bits, bits_per_cell=bpc)
    jc = jeng.EngineConfig(tile_rows=32, mode=mode, quant=jq.QuantConfig(**q))
    tc = teng.EngineConfig(tile_rows=32, mode=mode, quant=tq.QuantConfig(**q))
    full = tc.rows_per_adc * (2 ** bpc - 1)
    lsb = full / (2.0 ** adc_bits - 1.0)
    acc = np.arange(0, full + 1, dtype=np.float32)
    # leaks that land sums on and around half-LSB points, and past full scale
    leaks = np.array([0.0, 0.25, lsb / 2, 1.5 * lsb, 0.37, 3.0], np.float32)
    grid = (acc[None, :] + leaks[:, None]).astype(np.float32)
    j = np.asarray(jeng._adc_codes(jnp.asarray(grid), jc))
    t = teng._adc_codes(torch.from_numpy(grid), tc).numpy()
    assert j.tobytes() == t.tobytes()


def _engine_cfgs(mode, tile_rows=16, bpc=1, **qkw):
    q = dict(w_bits=4, in_bits=8, adc_bits=8, bits_per_cell=bpc, **qkw)
    return (jeng.EngineConfig(tile_rows=tile_rows, tile_cols=16, mode=mode,
                              quant=jq.QuantConfig(**q)),
            teng.EngineConfig(tile_rows=tile_rows, tile_cols=16, mode=mode,
                              quant=tq.QuantConfig(**q)))


@pytest.mark.parametrize("mode,k,n,bpc", [
    ("deepnet", 64, 40, 1), ("expansion", 64, 40, 1),
    ("expansion", 96, 33, 2)])
def test_program_planes_bitwise_and_matmul_matches_reference(mode, k, n,
                                                             bpc):
    jc, tc = _engine_cfgs(mode, bpc=bpc)
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    x = rng.standard_normal((3, 5, k)).astype(np.float32)
    jpw = jeng.program(jnp.asarray(w), jc)
    tpw = teng.program(torch.from_numpy(w), tc)
    for a, b in ((jpw.pos, tpw.pos), (jpw.neg, tpw.neg),
                 (jpw.w_scale, tpw.w_scale)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert tuple(tpw.pos.shape) == tuple(jpw.pos.shape)
    y_j = np.asarray(jeng.matmul_reference(jnp.asarray(x), jpw, jc))
    for use_kernel in (False, True):
        cfg = dataclasses.replace(tc, use_kernel=use_kernel)
        y_t = teng.matmul(torch.from_numpy(x), tpw, cfg).numpy()
        assert y_t.shape == (3, 5, n)
        assert _close(y_j, y_t)
    y_e = teng._matmul_reference_einsum(torch.from_numpy(x), tpw, tc)
    assert _close(y_j, y_e.numpy())


def test_leak_rides_both_paths_like_the_reference():
    jc, tc = _engine_cfgs("deepnet")
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((64, 32)) * 0.3).astype(np.float32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    jpw = jeng.program(jnp.asarray(w), jc)
    tpw = teng.program(torch.from_numpy(w), tc)
    leak = 0.61
    y_j = np.asarray(jeng.matmul_reference(jnp.asarray(x), jpw, jc,
                                           leak_codes=leak))
    y_0 = np.asarray(jeng.matmul_reference(jnp.asarray(x), jpw, jc))
    assert not np.array_equal(y_j, y_0)   # the leak reaches the codes
    kcfg = dataclasses.replace(tc, use_kernel=True)
    for cfg in (tc, kcfg):
        y_t = teng.matmul(torch.from_numpy(x), tpw, cfg,
                          leak_codes=torch.tensor(leak))
        assert _close(y_j, y_t.numpy())


def test_odd_row_tile_fallback_warns_once_and_matches_reference():
    # expansion mode, 3 row tiles of 16: no partner for the third tile
    jc, tc = _engine_cfgs("expansion")
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((48, 24)) * 0.3).astype(np.float32)
    x = rng.standard_normal((6, 48)).astype(np.float32)
    tpw = teng.program(torch.from_numpy(w), tc)
    jpw = jeng.program(jnp.asarray(w), jc)
    kcfg = dataclasses.replace(tc, use_kernel=True)
    tops._FALLBACK_WARNED.discard(("expansion", 3, 16))
    with pytest.warns(UserWarning, match="falling back to per-plane"):
        y1 = teng.matmul(torch.from_numpy(x), tpw, kcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y2 = teng.matmul(torch.from_numpy(x), tpw, kcfg)
    assert torch.equal(y1, y2)
    y_ref = teng.matmul_reference(torch.from_numpy(x), tpw, tc)
    y_j = np.asarray(jeng.matmul_reference(jnp.asarray(x), jpw, jc))
    assert _close(y_ref.numpy(), y1.numpy()) and _close(y_j, y1.numpy())


def test_kernel_wrapper_counts_only_kernel_launches():
    x, pos, neg = _operands(1, 4, 32, 16, 2, 1)
    before = tkernel.LAUNCHES["crossbar_mac"]
    tkernel.crossbar_mac(torch.from_numpy(x), torch.from_numpy(pos),
                         torch.from_numpy(neg), 0.0, in_bits=8, adc_bits=8,
                         bits_per_cell=1, rows_per_adc=16)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert tkernel.LAUNCHES["crossbar_mac"] == before


def _slice_loop_matmul(x, pw, cfg, leak_codes):
    """``engine.matmul_reference`` as one (pulse, slice) product at a
    time, the reference scan's own step: the oracle of the grouped
    reads."""
    q = cfg.quant
    bits, x_scale = teng._pulse_trains(x, pw, cfg)
    bitw, slcw = tq.bit_weights(q, x.device), tq.slice_weights(q, x.device)
    s, t, r, n_pad = pw.pos.shape
    bsz = bits.shape[1]
    pair = cfg.mode == "expansion" and t % 2 == 0 and t >= 2
    y_acc = torch.zeros((bsz, n_pad), dtype=torch.float32)
    for idx in range(bits.shape[0] * s):
        a, sl = idx // s, idx % s
        acc_p = torch.einsum("btr,trn->btn", bits[a],
                             pw.pos[sl].to(torch.float32))
        acc_n = torch.einsum("btr,trn->btn", bits[a],
                             pw.neg[sl].to(torch.float32))
        if pair:
            acc_p = acc_p.reshape(bsz, t // 2, 2, n_pad).sum(dim=2)
            acc_n = acc_n.reshape(bsz, t // 2, 2, n_pad).sum(dim=2)
        d = (teng._adc_codes(acc_p + leak_codes, cfg)
             - teng._adc_codes(acc_n + leak_codes, cfg))
        y_acc = y_acc + bitw[a] * slcw[sl] * d.sum(dim=1)
    y = y_acc * x_scale * pw.w_scale[..., :n_pad]
    return y[:, : pw.n]


def _slice_loop_mac(x_int, pos, neg, *, in_bits, adc_bits, bits_per_cell,
                    rows_per_adc, leak_codes, codes):
    """``crossbar_mac_ref`` (or, with ``codes``, ``crossbar_mac_codes_ref``)
    as one (bit, slice) product at a time: the oracle of the grouped
    reads."""
    cref = tkernel.ref
    s, kr, n = pos.shape
    b, t = x_int.shape[0], kr // rows_per_adc
    base = 2 ** bits_per_cell
    full_scale = float(rows_per_adc * (base - 1))
    leak = torch.as_tensor(leak_codes, dtype=torch.float32)
    u = torch.remainder(x_int + (1 << in_bits), 1 << in_bits)
    u = u.reshape(b, t, rows_per_adc)
    posf = pos.to(torch.float32).reshape(s, t, rows_per_adc, n)
    negf = neg.to(torch.float32).reshape(s, t, rows_per_adc, n)
    out = torch.zeros((b, n), dtype=torch.int64 if codes else torch.float32)
    conv = cref.adc_codes if codes else cref.adc
    for p in range(in_bits):
        bitw = 2 ** p if p < in_bits - 1 else -(2 ** p)
        xb = ((u >> p) & 1).to(torch.float32)
        for si in range(s):
            ap = torch.einsum("btr,trn->btn", xb, posf[si])
            an = torch.einsum("btr,trn->btn", xb, negf[si])
            d = (conv(ap + leak, adc_bits, full_scale)
                 - conv(an + leak, adc_bits, full_scale))
            if codes:
                out += (bitw * base ** si) * d.sum(dim=1)
            else:
                out = out + float(bitw) * float(base ** si) * d.sum(dim=1)
    return out


@pytest.mark.parametrize("group", [1, 2, None])
@pytest.mark.parametrize("mode,k,n,tile_rows,w_bits,bpc", [
    ("deepnet", 80, 40, 16, 5, 2), ("expansion", 80, 40, 16, 7, 2),
    ("expansion", 48, 70, 16, 4, 1), ("deepnet", 100, 24, 32, 8, 2)])
def test_plain_mac_reads_slice_groups_bit_for_bit(mode, k, n, tile_rows,
                                                  w_bits, bpc, group,
                                                  monkeypatch):
    """``matmul_reference`` reads a pulse against a group of slices at
    once (``ref.slice_group_sums``, ``group`` slices a product, None for
    all); one slice per product, the reference scan's own step, gives the
    same bits.  The (48, 16) case has three row tiles: no pairs."""
    rng = np.random.default_rng(21 + k + n)
    cfg = teng.EngineConfig(tile_rows=tile_rows, tile_cols=32, mode=mode,
                            quant=tq.QuantConfig(w_bits=w_bits, adc_bits=6,
                                                 bits_per_cell=bpc))
    pw = teng.program(torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.3).astype(np.float32)), cfg)
    x = torch.from_numpy(rng.standard_normal((3, k)).astype(np.float32))
    s, t, r, n_pad = pw.pos.shape
    if group is not None:
        assert s > group
        monkeypatch.setattr(tkernel.ref, "PLANE_GROUP_BYTES",
                            group * 4 * t * r * n_pad)
    assert torch.equal(teng.matmul_reference(x, pw, cfg, leak_codes=0.37),
                       _slice_loop_matmul(x, pw, cfg, 0.37))


@pytest.mark.parametrize("group", [1, 3, None])
@pytest.mark.parametrize("codes", [False, True])
def test_plain_mac_ref_reads_slice_groups_bit_for_bit(codes, group,
                                                      monkeypatch):
    """``crossbar_mac_ref`` and ``crossbar_mac_codes_ref`` read a bit
    against a group of slices at once; one slice per product gives the
    same bits (S 4, in groups of 1, of 3 and 1, and all at once)."""
    x, pos, neg = (torch.from_numpy(a) for a in _operands(5, 6, 96, 40, 4,
                                                          2))
    kw = dict(in_bits=8, adc_bits=6, bits_per_cell=2, rows_per_adc=32)
    if group is not None:
        monkeypatch.setattr(tkernel.ref, "PLANE_GROUP_BYTES",
                            group * 4 * 96 * 40)
    fn = (tkernel.ref.crossbar_mac_codes_ref if codes
          else tkernel.ref.crossbar_mac_ref)
    assert torch.equal(fn(x, pos, neg, leak_codes=0.37, **kw),
                       _slice_loop_mac(x, pos, neg, leak_codes=0.37,
                                       codes=codes, **kw))
