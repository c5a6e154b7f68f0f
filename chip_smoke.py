#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (exit code 1, no result line):

1. build   — compile every CUDA source of ``src/repro_torch/csrc`` with
             nvcc for sm_90a (one nvcc per source, all started together);
2. kernels — hold each kernel against its plain PyTorch version on the
             card at the main path's shapes, and time kernel, plain
             version and (for paged attention) one PyTorch SDPA call as
             a yardstick; the bound is the larger of bytes / 3.35 TB/s
             and operations / the type's peak rate (H100 SXM data sheet).
             The crossbar MAC runs at every qwen3-4b projection, at 128
             and 256 rows per ADC, leak 0 and 0.37, B 16 and 64, and must
             equal the exact int64 code sums (``crossbar_mac_codes_ref``)
             times the LSB bit for bit; each timed row carries call and
             device ms.  The streamed lane also runs at head dim 40.
             Both paged lanes run again at a long-context shape (windows
             up to 4096 tokens), the streamed lane also at the
             long-context serve's shape (32 query rows per KV head), and
             each carries, beside the call time, the device time of its
             kernels alone (``torch.profiler``).
             The deep-net streaming kernel is driven through its entry
             point ``stream_linear`` at every qwen3-4b projection and
             held bitwise against the programmed read (``engine.linear``
             on the crossbar-MAC kernel) and against the popcount kernel
             (its independent integer witness), float32 and bfloat16
             weights, both kernels timed (call and device ms); the
             Jacobi kernel is held bitwise against its plain version at
             10, 64, 128, 256 and 512 squared, traced (one device kernel
             per call), timed (call and device ms, device µs per sweep),
             and driven through ``ir_solve.solve`` at 12 x 8, bitwise
             against the plain solve and against the dense nodal solve;
3. parity  — full-width qwen3-4b, 2 layers, float32, crossbar backend:
             greedy streams with the plain versions and with the CUDA
             kernels, the window step captured in a CUDA graph (the
             default on the card) and eager (``capture=False``, the
             witness), paged and dense KV, must all be identical, with
             every weight in deep-net layout and under
             ``--mode-policy auto``;
4. serve   — ``repro_torch.launch.serve.main`` at full width (36 layers)
             with ``--backend crossbar --use-kernel --kv paged``, captured
             (its step time: the warm-up, the capture and the replays),
             the same under ``--mode-policy auto`` (attention and head
             read as expansion-fused pairs, 256 rows per ADC), then two
             4-layer serves through the streamed attention lane (the
             second with 1024-token prompts in a 2048-token window), each
             captured and eager with identical streams; last the 36-layer
             serve on one programmed model: eager (its step time, streams
             equal to the captured serve's), then captured and eager with
             steps 4 on in a ``torch.profiler`` trace of the card (step
             3 is the profiler's warm-up; a serve whose trace lost device
             records is served and traced again, at most three times) (the MAC's device ms per step and the device's
             idle share), then one eager step in a trace with CPU
             activity (the host ops that cost most).  Every serve traces
             its window step once (``serve_jit_traces_total``) and never
             again; every kernel of each path must have run (a captured
             serve runs the launches its capture recorded at each
             replay), and no plain version may have run.

The line before the last holds the card's name and power limit as
``nvidia-smi`` reports them; the line before that the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``.  A full report and the
compiler's register report go to ``--out`` (default
``build/chip_smoke/``).  Exits non-zero without CUDA, and when run from
a directory without the repository beside it.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}
ARCH = "qwen3-4b"
L2_FLUSH_BYTES = 64 << 20            # > the H100's 50 MB L2
# serves traced before the trace check gives up: the profiler sometimes
# loses device records (MAC kernels and their conversions alike), which a
# second serve does not repeat; a wrong launch count repeats every time
TRACE_ATTEMPTS = 3


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(torch, fn, reps: int, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls
    after one warm-up; ``flush`` (a large buffer) is overwritten before
    each call so the L2 cache starts cold, as a decode step finds it."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps: int, flush=None, names=None):
    """Device milliseconds per call of ``fn``: the summed CUDA time of the
    kernels whose names contain one of ``names`` (every kernel but the L2
    flush when ``names`` is None) in a ``torch.profiler`` trace of
    ``reps`` calls.  Before each call the flush buffer is READ, which
    evicts the L2 without leaving dirty lines to write back during the
    timed kernel.  Where the trace shows no device time, CUDA events
    around ``reps`` back-to-back calls.  Returns (ms, source)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernel_times(prof):
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            yield evt.key, us

    def cool():
        if flush is not None:
            flush.view(torch.int32).max()

    fn()
    skip = set()
    if flush is not None:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cool()
            torch.cuda.synchronize()
        skip = {k for k, _ in kernel_times(prof)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cool()
            fn()
        torch.cuda.synchronize()
    total = sum(us for key, us in kernel_times(prof)
                if (any(n in key for n in names) if names
                    else key not in skip))
    if total > 0:
        return total / reps / 1e3, "torch.profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / reps,
            f"cuda events over {reps} back-to-back calls")


def rel_err(torch, got, want):
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


# -- phase 2: kernels against their plain versions -----------------------------

# (name, K, N): every projection geometry of a qwen3-4b decode step
GEOMS = [("wq", 2560, 4096), ("wk/wv", 2560, 2048), ("attn wo", 4096, 2560),
         ("wi/wg", 2560, 9728), ("mlp wo", 9728, 2560),
         ("head", 2560, 152064)]
# the projections of one layer, then the head (wk/wv and wi/wg twice)
LAYER_PATH = ["wq", "wk/wv", "wk/wv", "attn wo", "wi/wg", "wi/wg", "mlp wo",
              "head"]


def phase_crossbar_mac(torch, dev, flush):
    """The MAC at every qwen3-4b projection (B 16, 128 rows per ADC, leak
    0 and 0.37), at the auto policy's 256-row reads, and at B 64 (the
    long-context serve's batch): BITWISE equal to the exact int64 code
    sums of ``crossbar_mac_codes_ref`` times the LSB, and within 1e-5 of
    the f32 plain version.  Runs at leak 0 are timed: call ms (CUDA
    events, the wrapper included) and device ms (the zeroing, MAC and
    conversion kernels in a ``torch.profiler`` trace)."""
    from repro_torch.kernels.crossbar_mac import kernel, ref

    geoms = GEOMS
    s, in_bits, adc_bits = 4, 8, 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows_out, max_abs = [], 0.0
    runs = [(g, "deepnet", 128, leak, 16) for g in geoms
            for leak in (0.0, 0.37)]
    # the expansion-fused reads of the auto policy: 256 rows per ADC
    runs += [(geoms[0], "expansion", 256, 0.0, 16),
             (geoms[-1], "expansion", 256, 0.0, 16),
             (geoms[-1], "expansion", 256, 0.37, 16)]
    # the long-context serve's 64 rows (4 slots x chunk 16)
    runs += [(geoms[-1], "deepnet", 128, 0.0, 64),
             (geoms[2], "deepnet", 128, 0.37, 64)]
    for (name, k, n), mode, rows, leak, b in runs:
        x = torch.randint(-128, 128, (b, k), generator=gen, device=dev,
                          dtype=torch.int32)
        pos = torch.randint(0, 2, (s, k, n), generator=gen, device=dev,
                            dtype=torch.int8)
        neg = torch.randint(0, 2, (s, k, n), generator=gen, device=dev,
                            dtype=torch.int8)
        lk = torch.full((1,), leak, device=dev)
        kw = dict(in_bits=in_bits, adc_bits=adc_bits, bits_per_cell=1,
                  rows_per_adc=rows)
        y = kernel.crossbar_mac(x, pos, neg, lk, **kw)
        codes = ref.crossbar_mac_codes_ref(x, pos, neg, leak_codes=lk, **kw)
        want = ref.codes_to_float(codes, adc_bits, float(rows))
        y_ref = ref.crossbar_mac_ref(x, pos, neg, leak_codes=lk, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), f"crossbar_mac {name}: "
              f"non-finite output")
        check(torch.equal(y, want), f"crossbar_mac {name} {mode} B={b} "
              f"leak={leak}: not bitwise equal to the exact code sums x lsb "
              f"(max|diff| {(y - want).abs().max().item():.3e})")
        err, rel = rel_err(torch, y, y_ref)
        # the kernel sums integer codes exactly (int64); the plain version
        # shift-adds in f32, in another order
        tol = 1e-5
        check(rel <= tol, f"crossbar_mac {name} {mode} leak={leak}: "
              f"max rel err {rel:.3e} > {tol:g}")
        max_abs = max(max_abs, err)
        row = {"geometry": name, "k": k, "n": n, "b": b, "mode": mode,
               "rows": rows, "leak": leak, "bitwise_codes": True,
               "max_abs_err": err, "max_rel_err": rel, "tol": tol}
        if leak == 0.0:
            def run():
                return kernel.crossbar_mac(x, pos, neg, lk, **kw)
            row["ms"] = timed(torch, run, 10, flush)
            row["device_ms"], row["device_ms_source"] = device_ms(
                torch, run, 10, flush)
            row["plain_ms"] = timed(torch, lambda: ref.crossbar_mac_ref(
                x, pos, neg, leak_codes=lk, **kw), 2, flush)
            nbytes = x.numel() * 4 + 2 * pos.numel() + b * n * 4 + 4
            ops = 2 * 2 * b * in_bits * s * k * n    # AND-accumulate, +/-
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops, "int8")
            row["library_ms"] = None
        rows_out.append(row)
        log(f"  crossbar_mac {name:8s} K={k:5d} N={n:6d} B={b:2d} {mode:9s} "
            f"leak={leak:4.2f}: bitwise = code sums x lsb; vs plain max|err| "
            f"{err:.3e} (rel {rel:.2e} <= {tol:g})" + (
                f"; call {row['ms']:.4f} ms, device {row['device_ms']:.4f} "
                f"ms, plain {row['plain_ms']:.3f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                if "ms" in row else ""))
        del x, pos, neg, y, y_ref, codes, want
        torch.cuda.empty_cache()
    return rows_out, max_abs


def mac_step_ms(mac_rows):
    """An estimate, for the log beside the serve trace's measurement:
    device ms of the MAC launches of one 36-layer decode step at B 16,
    128 rows per ADC, as 36 x the layer's seven projections plus the head,
    each at its geometry's device time from phase 2."""
    per = {r["geometry"]: r["device_ms"] for r in mac_rows
           if r["b"] == 16 and r["rows"] == 128 and "device_ms" in r}
    layer = sum(per[g] for g in LAYER_PATH[:-1])
    return 36 * layer + per["head"], 36 * (len(LAYER_PATH) - 1) + 1


#: kernel names of each paged lane, as the profiler reports them
PAGED_KERNELS = {"scratch": ("paged_scratch_kernel",
                             "paged_scratch_mma_kernel"),
                 "streamed": ("paged_split_kernel", "paged_combine_kernel")}
#: the long-context shape: windows up to 4096 tokens, 8,336 attended
LONG_CASE = dict(max_len=4096, kv_len=[4096, 3000, 1200, 40],
                 block_pages=16)
#: the long-context serve's attention shape (phase 4): chunk 16, so each
#: KV head serves g * sq = 32 query rows, two 16-row groups of the split
#: kernel; windows up to its 2048-token table
SERVE_LONG_CASE = dict(sq=16, max_len=2048, kv_len=[2048, 1500, 1030, 17],
                       block_pages=16)


def _paged_case(torch, dev, gen, b, sq, max_len, ps, hq, kv, hd, kv_len,
                dtype):
    p_seq = max_len // ps
    n_pages = b * p_seq
    q = torch.randn((b, sq, hq, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_pages + 1, ps, kv, hd), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((n_pages + 1, ps, kv, hd), generator=gen,
                     device=dev).to(dtype)
    kp[0] = 0
    vp[0] = 0
    pt = torch.zeros((b, p_seq), dtype=torch.int32)
    nxt = 1
    for r, length in enumerate(kv_len):
        for i in range(-(-length // ps)):
            pt[r, i] = nxt
            nxt += 1
    pt[1, 0] = pt[0, 0]                       # an aliased first page
    kv_len_t = torch.tensor(kv_len, dtype=torch.int32)
    q_off = torch.clamp(kv_len_t - sq, min=0)
    q_off[-1] = 0                             # a row at the start of prefill
    return (q, kp, vp, pt.to(dev), kv_len_t.to(dev), q_off.to(dev))


def _sdpa_yardstick(torch, args, causal=True):
    """One scaled_dot_product_attention call over the gathered view — a
    yardstick timed beside the kernels, never called by the port."""
    import torch.nn.functional as F
    q, kp, vp, pt, kv_len, q_off = args
    b, sq, hq, hd = q.shape
    ps, kv = kp.shape[1], kp.shape[2]
    depth = pt.shape[1] * ps
    gk = kp[pt.long()].reshape(b, depth, kv, hd).transpose(1, 2)
    gv = vp[pt.long()].reshape(b, depth, kv, hd).transpose(1, 2)
    gk = gk.repeat_interleave(hq // kv, dim=1).contiguous()
    gv = gv.repeat_interleave(hq // kv, dim=1).contiguous()
    qq = q.transpose(1, 2).contiguous()
    t = torch.arange(depth, device=q.device)
    qpos = q_off[:, None] + torch.arange(sq, device=q.device)[None]
    mask = (t[None, None, :] < kv_len[:, None, None])
    if causal:
        mask = mask & (qpos[:, :, None] >= t[None, None, :])
    mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qq, gk, gv,
                                                  attn_mask=mask)


def _paged_run(kernel, ref, lane, args, bp):
    if lane == "scratch":
        return (lambda: kernel.paged_attention_scratch(*args),
                lambda: ref.paged_attention_ref(*args))
    return (lambda: kernel.paged_attention_streamed(*args, block_pages=bp),
            lambda: ref.paged_attention_streamed_ref(*args, block_pages=bp))


def _paged_measure(torch, kernel, ref, lane, args, bp, max_len, kv_len,
                   flush):
    """Hold one lane against its plain version and time it: the call
    (wrapper and launches, CUDA events), the kernels' device time alone,
    the plain version and one SDPA call over the gathered view."""
    run, plain = _paged_run(kernel, ref, lane, args, bp)
    y = run()
    y_ref = plain()
    torch.cuda.synchronize()
    err, rel = rel_err(torch, y, y_ref)
    # bf16 values: the weights (scratch) and outputs round to bf16,
    # whose unit roundoff is 2^-8 = 3.9e-3
    tol = 1e-2
    check(bool(torch.isfinite(y.float()).all()),
          f"paged_attention_{lane} max_len={max_len}: non-finite output")
    check(rel <= tol, f"paged_attention_{lane} max_len={max_len}: max rel "
          f"err {rel:.3e} > {tol:g}")
    q = args[0]
    b, sq, hq, hd = q.shape
    kv = args[1].shape[2]
    attended = sum(min(n, max_len) for n in kv_len)
    nbytes = (2 * attended * kv * hd * 2 + 2 * y.numel() * 2
              + args[3].numel() * 4 + 2 * b * 4)
    ops = 4 * sq * hq * hd * attended
    bnd, by = bound(nbytes, ops, "bf16")
    dms, src = device_ms(torch, run, 20, flush, PAGED_KERNELS[lane])
    sdpa = _sdpa_yardstick(torch, args)
    lib_dms, _ = device_ms(torch, sdpa, 20, flush)
    r = {"max_len": max_len, "kv_len": kv_len, "block_pages": bp,
         "b": b, "sq": sq, "hq": hq, "kv": kv, "hd": hd,
         "page_size": args[1].shape[1], "max_abs_err": err,
         "max_rel_err": rel, "tol": tol, "ms": timed(torch, run, 20, flush),
         "device_ms": dms, "device_ms_source": src,
         "plain_ms": timed(torch, plain, 5, flush),
         "library_ms": timed(torch, sdpa, 20, flush),
         "library_device_ms": lib_dms,
         "bound_ms": bnd, "bound_by": by}
    log(f"  paged_attention_{lane:8s} max_len={max_len} kv_len={kv_len}: "
        f"max|err| {err:.3e} (rel {rel:.2e} <= {tol:g}); call "
        f"{r['ms']:.4f} ms, device {dms:.4f} ms ({src}), plain "
        f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms (device "
        f"{lib_dms:.4f}), bound {bnd:.5f} ms ({by})")
    return r


def phase_paged_attention(torch, dev, flush):
    """Both lanes at their serving shapes (a 64-token table for the
    scratch lane, 512 tokens in 4-page blocks for the streamed lane), then
    both at the long-context shape (``LONG_CASE``), then the streamed lane
    at the long-context serve's shape (``SERVE_LONG_CASE``), past the
    scratch lane's capacity."""
    from repro_torch.kernels.paged_attention import kernel, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    hq, kv, hd, ps, b, sq = 32, 16, 128, 8, 4, 4
    out = {}
    for lane, max_len, kv_len, bp in (
            ("scratch", 64, [64, 37, 12, 5], 0),
            ("streamed", 512, [512, 300, 77, 9], 4)):
        args = _paged_case(torch, dev, gen, b, sq, max_len, ps, hq, kv, hd,
                           kv_len, torch.bfloat16)
        out[lane] = _paged_measure(torch, kernel, ref, lane, args, bp,
                                   max_len, kv_len, flush)
    long_args = _paged_case(torch, dev, gen, b, sq, LONG_CASE["max_len"], ps,
                            hq, kv, hd, LONG_CASE["kv_len"], torch.bfloat16)
    for lane in ("scratch", "streamed"):
        out[lane]["long"] = _paged_measure(
            torch, kernel, ref, lane, long_args, LONG_CASE["block_pages"],
            LONG_CASE["max_len"], LONG_CASE["kv_len"], flush)
    c = SERVE_LONG_CASE
    serve_args = _paged_case(torch, dev, gen, b, c["sq"], c["max_len"], ps,
                             hq, kv, hd, c["kv_len"], torch.bfloat16)
    out["streamed"]["serve_long"] = _paged_measure(
        torch, kernel, ref, "streamed", serve_args, c["block_pages"],
        c["max_len"], c["kv_len"], flush)
    # a head dim off the streamed lane's compiled widths: 40 runs on
    # kernel.streamed_width(40) = 64, its extra columns zero
    kv_len = [512, 300, 77, 9]
    args = _paged_case(torch, dev, gen, b, sq, 512, ps, hq, kv, 40, kv_len,
                       torch.bfloat16)
    y = kernel.paged_attention_streamed(*args, block_pages=4)
    y_ref = ref.paged_attention_streamed_ref(*args, block_pages=4)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, y, y_ref)
    check(bool(torch.isfinite(y.float()).all()) and rel <= 1e-2,
          f"paged_attention_streamed at head dim 40: max rel err {rel:.3e}")
    out["streamed"]["hd40"] = {"hd": 40, "width": kernel.streamed_width(40),
                               "kv_len": kv_len, "max_abs_err": err,
                               "max_rel_err": rel, "tol": 1e-2}
    log(f"  paged_attention_streamed head dim 40 (on width "
        f"{kernel.streamed_width(40)}), max_len=512: max|err| {err:.3e} "
        f"(rel {rel:.2e} <= 0.01)")
    return out


def phase_deepnet_stream(torch, dev, flush):
    """``stream_linear`` (the entry point) at every qwen3-4b projection,
    B 16, float32 weights: its launches are counted over that run alone,
    and it must reach neither the popcount kernel nor the plain version.
    Then each output is held BITWISE against ``engine.linear`` on the
    crossbar-MAC kernel (program, then read: the same integer codes and
    the same final conversion), for float32 and bfloat16 weights; the
    tensor-core kernel BITWISE against the popcount kernel (an independent
    integer MAC) on the same operands, for both weight types; and against
    its plain version (1e-5 x max|y|: the plain version shift-adds in
    f32).  Both kernels are timed at every projection, call ms (CUDA
    events) and device ms (``torch.profiler``: the zeroing, the kernel and
    the conversion), for both weight types."""
    import dataclasses

    from repro_torch.core import engine
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.deepnet_stream import kernel, ops, ref

    b = 16
    cfg = engine.EngineConfig(mode="deepnet", quant=QuantConfig())
    q = cfg.quant
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    geoms = {name: (k, n) for name, k, n in GEOMS}
    xs = {name: torch.randn((b, k), generator=gen, device=dev)
          for name, (k, n) in geoms.items()}
    ws = {name: torch.randn((k, n), generator=gen, device=dev) * 0.05
          for name, (k, n) in geoms.items()}

    # the entry point's own path: counts from this loop alone
    kernel.LAUNCHES["deepnet_stream"] = 0
    kernel.LAUNCHES["deepnet_stream_popcount"] = 0
    ref.CALLS["deepnet_stream_ref"] = 0
    outs = {name: ops.stream_linear(xs[name], ws[name], cfg)
            for name in LAYER_PATH}
    torch.cuda.synchronize()
    launches = kernel.LAUNCHES["deepnet_stream"]
    check(launches == len(LAYER_PATH),
          f"stream_linear launched deepnet_stream {launches} times for "
          f"{len(LAYER_PATH)} calls")
    check(kernel.LAUNCHES["deepnet_stream_popcount"] == 0
          and ref.CALLS["deepnet_stream_ref"] == 0,
          "stream_linear reached the popcount kernel or the plain version")

    rows, max_abs = [], 0.0
    kcfg = dataclasses.replace(cfg, use_kernel=True)
    kw = dict(w_bits=q.w_bits, in_bits=q.in_bits, adc_bits=q.adc_bits,
              bits_per_cell=q.bits_per_cell, rows_per_adc=cfg.rows_per_adc)
    ops_n = 2 * 2 * b * q.in_bits * q.n_slices   # x K x N: AND-accumulate
    for name, (k, n) in geoms.items():
        x, w = xs[name], ws[name]
        wb = w.to(torch.bfloat16)
        prog = engine.linear(x, w, kcfg)
        prog_b = engine.linear(x, wb.float(), kcfg)
        y = outs[name]
        y_b = ops.stream_linear(x, wb, cfg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()) and y.shape == (b, n),
              f"stream_linear {name}: bad output")
        prog_err = max((y - prog).abs().max().item(),
                       (y_b - prog_b).abs().max().item())
        check(prog_err == 0.0, f"stream_linear {name} differs from the "
              f"programmed read by {prog_err:.3e}")
        del prog, prog_b, y_b
        x_int = torch.randint(-128, 128, (b, k), generator=gen, device=dev,
                              dtype=torch.int32)
        row = {"geometry": name, "k": k, "n": n, "b": b,
               "prog_max_abs_err": prog_err, "popcount_bitwise": True}
        for tag, wt in (("", w), ("_bf16", wb)):
            scale = ops.weight_scales(wt, q)
            yk = kernel.deepnet_stream(x_int, wt, scale, **kw)
            yp = kernel.deepnet_stream_popcount(x_int, wt, scale, **kw)
            torch.cuda.synchronize()
            check(torch.equal(yk, yp), f"deepnet_stream {name}{tag}: not "
                  f"bitwise equal to the popcount kernel (max|diff| "
                  f"{(yk - yp).abs().max().item():.3e})")
            if not tag:
                yr = ref.deepnet_stream_ref(x_int, wt, scale, **kw)
                torch.cuda.synchronize()
                err, rel = rel_err(torch, yk, yr)
                tol = 1e-5
                check(rel <= tol, f"deepnet_stream {name}: max rel err "
                      f"{rel:.3e} > {tol:g}")
                max_abs = max(max_abs, err)
                row.update(max_abs_err=err, max_rel_err=rel, tol=tol)
                del yr
            del yk, yp

            def run(wt=wt, scale=scale):
                return kernel.deepnet_stream(x_int, wt, scale, **kw)

            def pop(wt=wt, scale=scale):
                return kernel.deepnet_stream_popcount(x_int, wt, scale, **kw)

            row["ms" + tag] = timed(torch, run, 10, flush)
            row["device_ms" + tag], _ = device_ms(torch, run, 10, flush)
            row["popcount_ms" + tag] = timed(torch, pop, 10, flush)
            row["popcount_device_ms" + tag], _ = device_ms(torch, pop, 10,
                                                           flush)
            small = x_int.numel() * 4 + scale.numel() * 4 + b * n * 4
            row["bound_ms" + tag], row["bound_by" + tag] = bound(
                small + wt.numel() * wt.element_size(), ops_n * k * n,
                "int8")
        if name == "head":
            scale = ops.weight_scales(w, q)
            row["plain_ms"] = timed(torch, lambda: ref.deepnet_stream_ref(
                x_int, w, scale, **kw), 2, flush)
            row["library_ms"] = None
        rows.append(row)
        log(f"  deepnet_stream {name:8s} K={k:5d} N={n:6d}: programmed "
            f"read max|diff| {prog_err:.1e}; bitwise = popcount kernel; vs "
            f"plain max|err| {row['max_abs_err']:.3e} (rel "
            f"{row['max_rel_err']:.2e} <= {row['tol']:g}); f32 call "
            f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms "
            f"(popcount {row['popcount_ms']:.4f}, "
            f"{row['popcount_device_ms']:.4f}); bf16 call "
            f"{row['ms_bf16']:.4f}, device {row['device_ms_bf16']:.4f} "
            f"(popcount {row['popcount_ms_bf16']:.4f}, "
            f"{row['popcount_device_ms_bf16']:.4f}); bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}; bf16 "
            f"{row['bound_ms_bf16']:.4f})" + (
                f"; plain {row['plain_ms']:.3f} ms" if "plain_ms" in row
                else ""))
        del x_int, w, wb
        ws[name] = None
        torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "max_abs_err": max_abs}


def _jacobi_trace(torch, fn, reps, out_dir):
    """The device kernels' names and the memsets of ``reps`` calls of
    ``fn`` in a ``torch.profiler`` trace of the card; a trace that lost
    device records is taken again, at most ``TRACE_ATTEMPTS`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = _device_events(torch, prof, out_dir)
        kernels = [e["name"] for e in evs
                   if str(e.get("cat", "")).lower() == "kernel"]
        memsets = sum("memset" in str(e.get("cat", "")).lower()
                      for e in evs)
        if len(kernels) >= reps:
            break
        log(f"    the trace lost device records ({len(kernels)} kernels in "
            f"{reps} calls); tracing again")
    return kernels, memsets


def phase_ir_solve(torch, dev, flush, out_dir):
    """``jacobi_sweeps`` against ``jacobi_sweep_ref`` at 10 x 10 (the
    paper's array, one band), 64 x 64 (16 bands), 128 x 128 (the engine
    tile), 256 x 256 and 512 x 512 (the reference's largest tile), 16
    sweeps, BITWISE (max error 0); a profiler trace of 5 calls must hold 5
    device kernels, all the Jacobi kernel (a plan of more than one band
    adds one memset of its halo buffer a call); each timed (call ms,
    device ms, device µs per sweep).  Then ``ir_solve.solve`` (the entry
    point, its launches counted over that run alone) at 12 x 8, one band:
    bitwise against ``ir_drop.jacobi_planar`` (the plain sweep as many
    times) and within 2e-3 of the dense nodal solve."""
    from repro_torch.core import ir_drop
    from repro_torch.core.timing import PAPER
    from repro_torch.kernels.ir_solve import kernel, ops
    from repro_torch.kernels.ir_solve.ref import jacobi_sweep_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    g_w, sweeps, traced = 1.0 / PAPER.r_wire, 16, 5
    rows = []
    for n in (10, 64, 128, 256, 512):
        g = (PAPER.g_reset + (PAPER.g_set - PAPER.g_reset)
             * torch.rand((n, n), generator=gen, device=dev))
        v_in = PAPER.v_read * torch.rand((n,), generator=gen, device=dev)
        vr = v_in[:, None].expand(n, n).contiguous()
        vc = torch.zeros((n, n), device=dev)
        vin_col = v_in[:, None].contiguous()

        def run():
            return kernel.jacobi_sweeps(g, vin_col, vr, vc, g_w=g_w,
                                        sweeps=sweeps)

        def plain():
            r, c = vr, vc
            for _ in range(sweeps):
                r, c = jacobi_sweep_ref(r, c, g, v_in, g_w, 1.0)
            return r, c

        pr, pc = plain()
        plan = kernel.band_plan(n, n)
        kr, kc = run()
        torch.cuda.synchronize()
        err = max((kr - pr).abs().max().item(), (kc - pc).abs().max().item())
        check(torch.equal(kr, pr) and torch.equal(kc, pc),
              f"jacobi_sweeps {n}x{n}: max|err| {err:.3e}, not bitwise")
        names, memsets = _jacobi_trace(torch, run, traced, out_dir)
        check(len(names) == traced
              and all("jacobi_band_kernel" in k for k in names),
              f"jacobi_sweeps {n}x{n}: {traced} calls ran {len(names)} "
              f"device kernels: {sorted(set(names))}")
        dms, _ = device_ms(torch, run, 20, flush)
        nodes = n * n
        nbytes = (3 * nodes + n) * 4 + 2 * nodes * 4
        flops = (18 * sweeps + 4) * nodes
        bnd, by = bound(nbytes, flops, "fp32")
        row = {"n": n, "m": n, "sweeps": sweeps, "bands": plan.bands,
               "threads": plan.threads, "per_thread": plan.per_thread,
               "smem_bytes": plan.smem_bytes, "max_abs_err": err,
               "bitwise": True, "kernels_per_call": len(names) / traced,
               "memsets_per_call": memsets / traced,
               "ms": timed(torch, run, 20, flush), "device_ms": dms,
               "us_per_sweep": dms * 1e3 / sweeps,
               "plain_ms": timed(torch, plain, 5, flush),
               "bound_ms": bnd, "bound_by": by, "library_ms": None}
        rows.append(row)
        log(f"  jacobi_sweeps {n:3d}x{n:<3d} {sweeps} sweeps, {plan.bands} "
            f"bands ({plan.threads} threads x {plan.per_thread}): bitwise; 1 "
            f"kernel per call ({row['memsets_per_call']:g} memsets); call "
            f"{row['ms']:.4f} ms, device {dms:.4f} ms, "
            f"{row['us_per_sweep']:.3f} us per sweep; plain "
            f"{row['plain_ms']:.4f} ms, bound {bnd:.5f} ms ({by})")

    g = torch.full((12, 8), PAPER.g_set, device=dev)
    v = torch.full((12,), PAPER.v_write, device=dev)
    kernel.LAUNCHES["jacobi_sweeps"] = 0
    i_k, r_k, c_k = ops.solve(g, v, n_iter=3000)
    torch.cuda.synchronize()
    launches = kernel.LAUNCHES["jacobi_sweeps"]
    # the same 187 x 16 sweeps, each the plain sweep
    i_p, r_p, c_p = ir_drop.jacobi_planar(g, v, n_iter=launches * 16)
    i_d, _, _ = ir_drop.solve_planar(g, v)
    rel = ((i_k - i_d).abs() / i_d).max().item()
    check(launches == 3000 // 16, f"solve launched jacobi_sweeps "
          f"{launches} times")
    check(torch.equal(i_k, i_p) and torch.equal(r_k, r_p)
          and torch.equal(c_k, c_p),
          "ir_solve.solve 12x8 is not bitwise the plain solve "
          f"(max|err| {(c_k - c_p).abs().max().item():.3e})")
    check(rel < 2e-3, f"ir_solve.solve vs dense solve: rel err {rel:.3e}")
    log(f"  ir_solve.solve 12x8, 3000 sweeps: {launches} kernel calls; "
        f"bitwise the plain solve; max rel err vs the dense nodal solve "
        f"{rel:.3e} (< 2e-3)")
    return {"rows": rows, "launches": launches, "solve_rel_err": rel,
            "solve_bitwise": True}


# -- phase 3: token parity with and without the kernels -------------------------

def phase_parity(torch, dev, mode_policy=None):
    """Greedy streams at full width, 2 layers, float32, crossbar backend:
    the plain versions (captured), and the CUDA kernels captured and
    eager (``capture=False``, the witness), paged and dense, must all be
    identical; each serve must trace its window step once."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import BatchScheduler, Request

    base = dataclasses.replace(get_config(ARCH), n_layers=2,
                               backend="crossbar", dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(2)
    prompts = [torch.randint(0, base.vocab - 1, (n,), generator=gen,
                             dtype=torch.int32) for n in (5, 11, 3)]
    params = None
    streams = {}
    for use_kernel in (False, True):
        cfg = dataclasses.replace(
            base, paged_kernel=use_kernel,
            xbar=dataclasses.replace(base.xbar, use_kernel=use_kernel))
        model = build_model(cfg, device=dev)
        if params is None:
            params = model.init(0)
        runs = ([("paged", True), ("paged", False), ("dense", True),
                 ("dense", False)] if use_kernel else [("paged", True)])
        for kv, capture in runs:
            _reset_counts()
            sched = BatchScheduler(model, params, n_slots=2, max_len=64,
                                   kv=kv, mode_policy=mode_policy,
                                   capture=capture)
            for i, p in enumerate(prompts):
                sched.submit(Request(rid=i, prompt=p, max_new=4))
            done, steps = [], 0
            while len(done) < len(prompts) and steps < 100:
                done += sched.step()
                steps += 1
            check(len(done) == len(prompts), "parity run did not finish")
            cap = sched.capture_report()["A"]
            counted, _, by_rows = _read_counts()
            ran = _executed(counted, cap)
            n_mac = ran["crossbar_mac"]
            n_pa = ran["paged_attention_scratch"]
            _check_traced_once(cap, capture)
            run = (use_kernel, kv, capture)
            streams[run] = {r.rid: r.out for r in done}
            check((n_mac > 0 and (n_pa > 0) == (kv == "paged"))
                  if use_kernel else (n_mac == 0 and n_pa == 0),
                  f"use_kernel={use_kernel} kv={kv}: launches mac={n_mac} "
                  f"paged={n_pa}")
            if use_kernel and mode_policy == "auto":
                check(by_rows.get(256, 0) > 0 and by_rows.get(128, 0) > 0,
                      f"auto policy: crossbar_mac launches by rows "
                      f"{by_rows}")
            log(f"  policy={mode_policy} use_kernel={use_kernel} kv={kv} "
                f"{'captured' if capture else 'eager'}: streams "
                f"{streams[run]} (kernel launches run: crossbar_mac {n_mac}"
                f" {by_rows}, paged scratch {n_pa}; {cap['captures']} "
                f"capture, {cap['replays']} replays)")
            del sched
        del model
        gc.collect()
        torch.cuda.empty_cache()
    first = next(iter(streams.values()))
    check(all(v == first for v in streams.values()),
          f"greedy streams differ across plain/kernel, paged/dense, "
          f"captured/eager (mode_policy={mode_policy}): {streams}")
    return {"streams": {str(k): v for k, v in first.items()},
            "identical": True, "layers": 2, "dtype": "float32",
            "mode_policy": mode_policy,
            "runs": [f"use_kernel={k} kv={kv} capture={c}"
                     for k, kv, c in streams]}


# -- phase 4: serve through the port's CLI ---------------------------------------

def _counters():
    from repro_torch.kernels.crossbar_mac import kernel as mac
    from repro_torch.kernels.crossbar_mac import ref as mac_ref
    from repro_torch.kernels.deepnet_stream import kernel as ds
    from repro_torch.kernels.deepnet_stream import ref as ds_ref
    from repro_torch.kernels.ir_solve import kernel as ir
    from repro_torch.kernels.ir_solve import ref as ir_ref
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.paged_attention import ref as pa_ref
    return ((mac.LAUNCHES, pa.LAUNCHES, ds.LAUNCHES, ir.LAUNCHES),
            (mac_ref.CALLS, pa_ref.CALLS, ds_ref.CALLS, ir_ref.CALLS),
            mac.LAUNCHES_BY_ROWS)


def _reset_counts():
    from repro_torch import obs
    launches, calls, by_rows = _counters()
    for counts in launches + calls:
        for key in counts:
            counts[key] = 0
    by_rows.clear()
    obs.reset()


def _read_counts():
    from repro_torch.core import engine
    launches, calls, by_rows = _counters()
    kernels = {k: v for counts in launches for k, v in counts.items()}
    plain = {k: v for counts in calls for k, v in counts.items()}
    plain["engine.matmul_reference"] = engine.path_calls["reference"]
    return kernels, plain, dict(by_rows)


def _executed(counted, cap):
    """The kernel launches a serve ran: the wrappers count the eager
    steps' launches and, once, the launches a capture records; each
    replay runs the recorded launches again, so the replays beyond the
    first add ``launches_per_replay`` each."""
    lpr = cap["launches_per_replay"]
    return {k: n + lpr.get(k, 0) * (cap["replays"] - 1)
            for k, n in counted.items()}


def _check_traced_once(cap, capture):
    """One trace of the lane's window step (its capture; its first call
    when eager), no retrace, since the counts were last set to 0."""
    from repro_torch import obs

    reg = obs.registry()
    traces = reg.total("serve_jit_traces_total", closure="decode")
    retraces = reg.total("serve_jit_retraces_total", closure="decode")
    check(traces == 1 and retraces == 0,
          f"window step traced {traces} times, {retraces} retraces "
          f"(want 1, 0)")
    want = (capture is not False)
    check(cap["capture"] == want and cap["captures"] == int(want)
          and (cap["replays"] > 0) == want,
          f"capture report {cap} (capture={capture})")


def _step_stats(step_s):
    """Per-step wall ms: the mean, the first two steps (the warm-up and,
    captured, the capture) and the median of the rest."""
    ms = [t * 1e3 for t in step_s]
    return {"step_ms": sum(ms) / len(ms), "first_steps_ms": ms[:2],
            "later_step_ms": statistics.median(ms[2:])}


def phase_serve(torch, dev, argv, must_launch, rows_per_adc=(),
                capture=None):
    """``launch/serve.main(argv)``, its window step captured (the default)
    or eager (``capture=False``); every kernel of ``must_launch`` must have
    run and no plain version."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    vocab = get_config(ARCH).vocab
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    check(held < 1 << 30, f"{held / 2**30:.2f} GiB still allocated before "
          f"the serve")
    _reset_counts()
    rep = serve.main(argv, capture=capture)
    torch.cuda.synchronize()
    counted, plain, by_rows = _read_counts()
    cap = rep["capture"]
    kernels = _executed(counted, cap)
    _check_traced_once(cap, capture)
    peak = torch.cuda.max_memory_allocated(dev)
    toks = [t for r in rep["requests"] for t in r.out]
    stats = _step_stats(rep["step_s"])
    log(f"  {'captured' if cap['capture'] else 'eager'}: tokens/s "
        f"{rep['tok_per_s']:.2f} ({rep['tokens']} tokens, {rep['steps']} "
        f"steps, {rep['seconds']:.2f} s; step {stats['step_ms']:.2f} ms, "
        f"first two {stats['first_steps_ms'][0]:.2f} / "
        f"{stats['first_steps_ms'][1]:.2f} ms, then median "
        f"{stats['later_step_ms']:.2f} ms); programming "
        f"{rep['program_s']:.2f} s; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    log(f"  kernel launches run {kernels} (counted by the wrappers "
        f"{counted}; {cap['captures']} capture, {cap['replays']} replays "
        f"of {cap['launches_per_replay']}; crossbar_mac by rows per ADC "
        f"{by_rows}); plain-version calls {plain}")
    n_req = int(argv[argv.index("--requests") + 1])
    max_new = int(argv[argv.index("--max-new") + 1])
    check(len(rep["requests"]) == n_req
          and all(len(r.out) == max_new for r in rep["requests"]),
          "serve did not complete every request")
    check(all(0 <= t < vocab for t in toks), "token outside the vocab")
    for name in must_launch:
        check(kernels[name] > 0, f"{name} never launched on this path")
    for rows in rows_per_adc:
        check(by_rows.get(rows, 0) > 0,
              f"crossbar_mac never read {rows} rows per ADC on this path")
    check(all(v == 0 for v in plain.values()),
          f"plain versions ran on the serving path: {plain}")
    return {"argv": argv, "tok_per_s": rep["tok_per_s"],
            "tokens": rep["tokens"], "steps": rep["steps"],
            "seconds": rep["seconds"], "program_s": rep["program_s"],
            **stats, "capture": cap,
            "streams": {r.rid: list(r.out) for r in rep["requests"]},
            "max_memory_allocated": peak, "memory_before": held,
            "launches": kernels, "launches_counted": counted,
            "launches_by_rows": by_rows,
            "plain_calls": plain, "mode_report": rep.get("mode_report")}


def _device_events(torch, prof, out_dir):
    """The card's events of a ``torch.profiler`` trace, in time order."""
    path = out_dir / "serve_trace.json"
    prof.export_chrome_trace(str(path))
    evs = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and str(e.get("cat", "")).lower()
                  in ("kernel", "gpu_memset", "gpu_memcpy")),
                 key=lambda e: float(e["ts"]))
    path.unlink()
    return evs


def _trace_stats(evs, steps):
    """From the card's events, between the start of the first MAC kernel
    and the end of the last MAC launch: the MAC's device ms per step (its
    kernel, the memset that zeroes its code buffer just before it, and
    its conversion kernel), every device event's ms per step, and the
    device's idle share (the window less the union of those events)."""
    mac_us, mac_n, spans = 0.0, 0, []
    for i, e in enumerate(evs):
        t0, dur = float(e["ts"]), float(e["dur"])
        if "crossbar_mac_tc_kernel" in e["name"]:
            mac_n += 1
            mac_us += dur
            spans.append(t0)
            prev = evs[i - 1] if i else None
            # a graph's memset node may be traced as a kernel "memset32"
            if prev is not None and "memset" in (
                    str(prev["cat"]) + str(prev["name"])).lower():
                mac_us += float(prev["dur"])
        elif "codes_to_float_kernel" in e["name"]:
            mac_us += dur
            spans.append(t0 + dur)
    check(mac_n > 0, "the trace holds no MAC kernel")
    lo, hi = min(spans), max(spans)
    busy, end, n_dev = 0.0, lo, 0
    for e in evs:
        a = max(float(e["ts"]), end)
        b = min(float(e["ts"]) + float(e["dur"]), hi)
        if float(e["ts"]) + float(e["dur"]) > lo and float(e["ts"]) < hi:
            n_dev += 1
        if b > a:
            busy += b - a
            end = b
    return {"mac_device_ms_per_step": mac_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "window_ms_per_step": (hi - lo) / steps / 1e3,
            "device_idle_share": 1.0 - busy / (hi - lo),
            "device_events_per_step": n_dev / steps, "mac_launches": mac_n}


def _traced_serve(torch, st, capture, out_dir, untraced=2):
    """A serve of ``st`` (launch/serve's setup): its first ``untraced``
    steps (the warm-up and, captured, the capture) outside the trace, the
    next one the profiler's warm-up (traced, its records dropped), the
    rest in a ``torch.profiler`` trace of the card.  Returns the trace's
    stats and the MAC launches the counted steps ran."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import launch_counts

    _reset_counts()
    sched = st.scheduler(capture=capture)
    reqs = st.requests()
    for r in reqs:
        sched.submit(r)
    done = []
    for _ in range(untraced):
        done += sched.step()
    steps = 0
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=10_000)) as prof:
        done += sched.step()
        prof.step()
        cap0 = dict(sched.capture_report()["A"])
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while len(done) < len(reqs) and steps < 10_000:
            done += sched.step()
            steps += 1
            prof.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = {k: n - before.get(k, 0) for k, n in launch_counts().items()}
    cap = sched.capture_report()["A"]
    _check_traced_once(cap, capture)
    if capture:
        check(cap["captures"] == cap0["captures"] == 1
              and cap["replays"] - cap0["replays"] == steps,
              f"traced steps were not all replays: {cap0} -> {cap}")
        check(not any(counted.values()), f"a replay counted {counted}")
        ran = {k: n * steps for k, n in cap["launches_per_replay"].items()}
    else:
        ran = counted
    evs = _device_events(torch, prof, out_dir)
    out = _trace_stats(evs, steps)
    # MAC records per step: each step ends with the head's MAC, the one
    # MAC kernel that runs longer than a millisecond
    per_step, n = [], 0
    for e in evs:
        if "crossbar_mac_tc_kernel" in e["name"]:
            n += 1
            if float(e["dur"]) > 1e3:
                per_step.append(n)
                n = 0
    out.update(steps=steps, traced_step_ms=wall / steps * 1e3,
               mac_ran=ran.get("crossbar_mac", 0),
               conversions=sum("codes_to_float_kernel" in e["name"]
                               for e in evs),
               mac_per_step=per_step + ([n] if n else []),
               streams={r.rid: list(r.out) for r in done})
    return out


def _serve_in_trace(torch, st, capture, out_dir):
    """``_traced_serve`` until its trace holds every MAC launch the
    counted steps ran (at most ``TRACE_ATTEMPTS`` serves, each loss
    logged); the trace's stats."""
    lost = []
    for _ in range(TRACE_ATTEMPTS):
        out = _traced_serve(torch, st, capture, out_dir)
        if out["mac_launches"] == out["mac_ran"]:
            break
        lost.append({k: out[k] for k in ("mac_launches", "conversions",
                                         "mac_ran", "mac_per_step")})
        log(f"  the trace holds {out['mac_launches']} MAC kernels and "
            f"{out['conversions']} conversions of the {out['mac_ran']} MAC "
            f"launches run (MAC records per step {out['mac_per_step']}); "
            f"serving again")
    check(out["mac_launches"] == out["mac_ran"],
          f"no trace of {TRACE_ATTEMPTS} held every MAC launch the serve "
          f"ran: {lost}")
    out["lost_traces"] = lost
    first = 4
    log(f"  {'captured' if capture else 'eager'}, steps {first}-"
        f"{first + out['steps'] - 1} traced: MAC "
        f"{out['mac_device_ms_per_step']:.3f}"
        f" ms of device time per step; all device work "
        f"{out['device_busy_ms_per_step']:.3f} ms per step over a "
        f"{out['window_ms_per_step']:.3f} ms window (device idle "
        f"{100 * out['device_idle_share']:.1f}%), "
        f"{out['device_events_per_step']:.0f} device events per step; "
        f"step under the trace {out['traced_step_ms']:.2f} ms")
    return out


def _host_ops_of_one_step(torch, st, at_step=2, top=12):
    """One eager step in a ``torch.profiler`` trace with CPU activity on:
    the host ops (aten ops and CUDA runtime calls) by self CPU time."""
    from torch.profiler import ProfilerActivity, profile

    _reset_counts()
    sched = st.scheduler(capture=False)
    for r in st.requests():
        sched.submit(r)
    for _ in range(at_step):
        sched.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sched.step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    _check_traced_once(sched.capture_report()["A"], False)
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host_ms = sum(e.self_cpu_time_total for e in rows) / 1e3
    ops = [{"name": e.key, "calls": e.count,
            "self_cpu_ms": e.self_cpu_time_total / 1e3,
            "cpu_ms": e.cpu_time_total / 1e3} for e in rows[:top]]
    log(f"  one eager step under a trace with CPU activity: {wall:.1f} ms "
        f"wall, {host_ms:.1f} ms of self CPU time over "
        f"{sum(e.count for e in rows)} host events; by self CPU time:")
    for op in ops:
        log(f"    {op['name'][:48]:48s} {op['calls']:6d} calls "
            f"{op['self_cpu_ms']:8.2f} ms self")
    return {"step": at_step + 1, "wall_ms": wall, "self_cpu_ms": host_ms,
            "top_ops": ops}


def phase_witness(torch, dev, argv, want, out_dir):
    """The 36-layer serve of ``argv`` on one model, programmed once: the
    eager step (``capture=False``) untraced, its streams equal to the
    captured serve's (``want``); then the captured and the eager serves
    with steps 4 on in a trace of the card; last, one
    eager step in a trace with CPU activity on."""
    from repro_torch.launch import serve

    gc.collect()
    torch.cuda.empty_cache()
    st = serve.setup(argv)
    t0 = time.perf_counter()
    sched = st.scheduler(capture=False)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    _reset_counts()
    rep = serve.drive(sched, st.requests(), dev)
    cap = sched.capture_report()["A"]
    _check_traced_once(cap, False)
    del sched
    streams = {r.rid: list(r.out) for r in rep["requests"]}
    check(streams == want, f"the eager 36-layer serve's streams {streams} "
          f"differ from the captured serve's {want}")
    stats = _step_stats(rep["step_s"])
    log(f"  eager: tokens/s {rep['tok_per_s']:.2f} ({rep['tokens']} tokens,"
        f" {rep['steps']} steps, {rep['seconds']:.2f} s; step "
        f"{stats['step_ms']:.2f} ms, median after the first two "
        f"{stats['later_step_ms']:.2f} ms); streams equal the captured "
        f"serve's; programming {program_s:.2f} s")
    out = {"eager": {"tok_per_s": rep["tok_per_s"], "steps": rep["steps"],
                     "seconds": rep["seconds"], **stats,
                     "program_s": program_s}}
    # the traces slow the host for what follows them: untraced first
    for name, capture in (("trace_captured", True), ("trace_eager", False)):
        out[name] = _serve_in_trace(torch, st, capture, out_dir)
        check(out[name]["streams"] == want,
              f"{name}: streams differ from the captured serve's")
    out["host_ops"] = _host_ops_of_one_step(torch, st)
    return out


def check_mode_report(rep):
    """The auto policy's report: attention and head fused, the MLP in
    deep-net layout, and the IR-drop reduction scored on the card equal
    to the port's CPU value within 1e-4 (two float32 LU solves of the
    same nodal system: docs/PORT.md)."""
    from repro_torch.core import ir_drop
    from repro_torch.core.timing import PAPER

    agg = rep["aggregate"]
    layers = int(agg["n_expansion"] + agg["n_deepnet"])
    check(agg["n_expansion"] == (layers - 1) // 7 * 4 + 1,
          f"auto policy fused {agg['n_expansion']} of {layers} weights")
    cpu = ir_drop.mode_ir_report(agg["tile_rows"], agg["tile_cols"],
                                 r_wire=PAPER.r_wire, device="cpu")
    diff = abs(agg["ir_drop_reduction_expansion"]
               - cpu["ir_drop_reduction"])
    check(diff <= 1e-4, f"IR-drop reduction on the card "
          f"{agg['ir_drop_reduction_expansion']:.6f} vs the CPU "
          f"{cpu['ir_drop_reduction']:.6f}")
    log(f"  mode report: {agg['n_expansion']} expansion / "
        f"{agg['n_deepnet']} deep-net weights; IR-drop reduction on the "
        f"card {agg['ir_drop_reduction_expansion']:.6f}, CPU "
        f"{cpu['ir_drop_reduction']:.6f} (|diff| {diff:.2e} <= 1e-4)")
    return {"aggregate": agg, "cpu_ir_drop_reduction":
            cpu["ir_drop_reduction"], "abs_diff": diff}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke",
                    help="directory for chip_smoke.json and ptxas.log")
    out_dir = ap.parse_args().out
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py; "
              "run it from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    t_start = time.perf_counter()
    phase = "build"
    try:
        from repro_torch.kernels import build
        log("[1/4] build")
        secs = build.build_all()
        for name, s in secs.items():
            log(f"  nvcc {name}: {s:.1f} s -> {build.library_path(name).name}")
        log(f"  card: {smi}")
        report["build_s"] = secs
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "ptxas.log").write_text(
            "\n".join(f"== {k}\n{v}" for k, v in build.BUILD_LOG.items()))

        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
        phase = "kernels"
        log("[2/4] kernels vs plain versions on the card")
        mac_rows, mac_err = phase_crossbar_mac(torch, dev, flush)
        pa = phase_paged_attention(torch, dev, flush)
        report["crossbar_mac"] = mac_rows
        report["paged_attention"] = pa
        report["deepnet_stream"] = phase_deepnet_stream(torch, dev, flush)
        report["ir_solve"] = phase_ir_solve(torch, dev, flush, out_dir)
        del flush
        torch.cuda.empty_cache()

        phase = "parity"
        log("[3/4] token parity: full width, 2 layers, fp32, crossbar, "
            "paged KV, with and without the kernels")
        report["parity"] = phase_parity(torch, dev)
        report["parity_auto"] = phase_parity(torch, dev, "auto")

        phase = "serve"
        log(f"[4/4] serve {ARCH} at full width through launch/serve.py "
            f"(window step captured)")
        main_argv = ["--arch", ARCH, "--backend", "crossbar", "--use-kernel",
                     "--kv", "paged", "--requests", "4", "--prompt-len",
                     "16", "--max-new", "8", "--slots", "4", "--max-len",
                     "64", "--chunk", "4"]
        report["serve"] = phase_serve(
            torch, dev, main_argv,
            ["crossbar_mac", "paged_attention_scratch"], rows_per_adc=[128])
        sv = report["serve"]
        mac_est, mac_per_step = mac_step_ms(mac_rows)
        sv["mac_launches_per_step"] = sv["launches"]["crossbar_mac"] / \
            sv["steps"]
        log(f"  the MAC's {mac_per_step} launches per step (run "
            f"{sv['mac_launches_per_step']:.1f}) would take {mac_est:.2f} ms "
            f"of device time at phase 2's per-geometry times (an estimate; "
            f"the traces below measure it)")
        log("  --mode-policy auto (attention and head expansion-fused)")
        report["serve_auto"] = phase_serve(
            torch, dev, main_argv + ["--mode-policy", "auto"],
            ["crossbar_mac", "paged_attention_scratch"],
            rows_per_adc=[128, 256])
        report["serve_auto"]["mode_check"] = check_mode_report(
            report["serve_auto"]["mode_report"])
        stream_argv = ["--arch", ARCH, "--layers", "4", "--backend",
                       "crossbar", "--use-kernel", "--kv", "paged",
                       "--requests", "4", "--prompt-len", "16", "--max-new",
                       "4", "--slots", "4", "--max-len", "256", "--chunk",
                       "4", "--stream-pages", "4", "--block-pages", "4"]
        long_argv = ["--arch", ARCH, "--layers", "4", "--backend",
                     "crossbar", "--use-kernel", "--kv", "paged",
                     "--requests", "4", "--slots", "4", "--prompt-len",
                     "1024", "--max-new", "8", "--max-len", "2048",
                     "--chunk", "16", "--stream-pages", "64",
                     "--block-pages", "16"]
        for key, what, argv, must in (
                ("serve_streamed", "streamed lane: --stream-pages 4 "
                 "--max-len 256, 4 layers", stream_argv,
                 ["crossbar_mac", "paged_attention_streamed"]),
                ("serve_long", "long context: --prompt-len 1024 --max-len "
                 "2048 --chunk 16, streamed lane, 4 layers", long_argv,
                 ["crossbar_mac", "paged_attention_streamed",
                  "paged_attention_combine"])):
            log(f"  {what}; captured, then eager")
            report[key] = phase_serve(torch, dev, argv, must)
            eager = phase_serve(torch, dev, argv, must, capture=False)
            check(eager["streams"] == report[key]["streams"],
                  f"{key}: captured and eager streams differ")
            report[key]["eager"] = {k: eager[k] for k in (
                "tok_per_s", "steps", "seconds", "step_ms",
                "later_step_ms", "launches")}
        # last: the serves after a trace ran slower (the profiler's state
        # outlives it), so none of the timed CLI serves follows one
        log("  the main serve on one programmed model: eager (the "
            "witness), then captured and eager in a torch.profiler trace "
            "of the card, then one eager step with CPU activity traced")
        sv["witness"] = phase_witness(torch, dev, main_argv, sv["streams"],
                                      out_dir)
        tc = sv["witness"]["trace_captured"]
        te = sv["witness"]["trace_eager"]
        ev = sv["witness"]["eager"]
        log(f"  36-layer step: captured {sv['step_ms']:.2f} ms (replays "
            f"{sv['later_step_ms']:.2f} ms), eager {ev['step_ms']:.2f} ms "
            f"({ev['later_step_ms']:.2f} ms); tokens/s "
            f"{sv['tok_per_s']:.2f} vs {ev['tok_per_s']:.2f}; device idle "
            f"{100 * tc['device_idle_share']:.1f}% vs "
            f"{100 * te['device_idle_share']:.1f}%; MAC device ms per step "
            f"{tc['mac_device_ms_per_step']:.3f} vs "
            f"{te['mac_device_ms_per_step']:.3f}")
    except Exception:  # noqa: BLE001 — report the failing phase, exit 1
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
        return 1

    report["seconds"] = time.perf_counter() - t_start
    head, head64 = (next(r for r in report["crossbar_mac"]
                         if r["geometry"] == "head" and r["mode"] == "deepnet"
                         and r["b"] == b and "ms" in r) for b in (16, 64))
    witness = report["serve"]["witness"]
    serve_l = report["serve"]["launches"]
    stream_l = report["serve_streamed"]["launches"]
    long_l = report["serve_long"]["launches"]
    kernels = [
        {"name": "crossbar_mac", "route": "cuda",
         "source": "src/repro_torch/csrc/crossbar_mac.cu",
         "replaces": "src/repro/kernels/crossbar_mac/kernel.py:98",
         "launches": serve_l["crossbar_mac"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in report["crossbar_mac"]),
         "ms": head["ms"], "device_ms": head["device_ms"],
         "plain_ms": head["plain_ms"],
         "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
         "library_ms": None, "shape": f"B=16 K={head['k']} N={head['n']}",
         "b64_ms": head64["ms"], "b64_device_ms": head64["device_ms"],
         "b64_bound_ms": head64["bound_ms"],
         "step_device_ms": witness["trace_captured"][
             "mac_device_ms_per_step"],
         "step_idle_share": witness["trace_captured"]["device_idle_share"],
         "step_ms": report["serve"]["step_ms"],
         "replay_step_ms": report["serve"]["later_step_ms"],
         "eager_step_device_ms": witness["trace_eager"][
             "mac_device_ms_per_step"],
         "eager_step_idle_share": witness["trace_eager"][
             "device_idle_share"],
         "eager_step_ms": witness["eager"]["step_ms"]},
    ]
    for lane, line, launches in (
            ("scratch", 124, serve_l["paged_attention_scratch"]),
            ("streamed", 258, stream_l["paged_attention_streamed"])):
        r = report["paged_attention"][lane]
        lg = r["long"]
        kernels.append({
            "name": f"paged_attention_{lane}", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention/kernel.py:{line}",
            "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in
                               (r, lg, r.get("serve_long", lg),
                                r.get("hd40", lg))),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": f"B={r['b']} sq={r['sq']} max_len={r['max_len']}",
            "long_launches": long_l[f"paged_attention_{lane}"],
            "long_ms": lg["ms"], "long_device_ms": lg["device_ms"],
            "long_library_ms": lg["library_ms"],
            "long_bound_ms": lg["bound_ms"],
            "long_shape": f"B={lg['b']} sq={lg['sq']} "
                          f"max_len={lg['max_len']}"})
        if "serve_long" in r:     # the streamed lane at the long serve's
            sl = r["serve_long"]  # shape: two 16-row groups
            kernels[-1].update({
                "serve_long_ms": sl["ms"],
                "serve_long_device_ms": sl["device_ms"],
                "serve_long_library_ms": sl["library_ms"],
                "serve_long_bound_ms": sl["bound_ms"],
                "serve_long_shape": f"B={sl['b']} sq={sl['sq']} "
                                    f"max_len={sl['max_len']}"})
    ds_head = next(r for r in report["deepnet_stream"]["rows"]
                   if r["geometry"] == "head")
    kernels.append({
        "name": "deepnet_stream", "route": "cuda",
        "source": "src/repro_torch/csrc/deepnet_stream.cu",
        "replaces": "src/repro/kernels/deepnet_stream/kernel.py:102",
        "launches": report["deepnet_stream"]["launches"],
        "max_abs_err": report["deepnet_stream"]["max_abs_err"],
        "ms": ds_head["ms"], "device_ms": ds_head["device_ms"],
        "plain_ms": ds_head["plain_ms"],
        "bound_ms": ds_head["bound_ms"], "bound_by": ds_head["bound_by"],
        "library_ms": None, "shape": f"B=16 K={ds_head['k']} "
        f"N={ds_head['n']} f32 weights",
        "bf16_ms": ds_head["ms_bf16"],
        "bf16_device_ms": ds_head["device_ms_bf16"],
        "bf16_bound_ms": ds_head["bound_ms_bf16"],
        "popcount_ms": ds_head["popcount_ms"],
        "popcount_device_ms": ds_head["popcount_device_ms"],
        "popcount_bf16_ms": ds_head["popcount_ms_bf16"],
        "popcount_bf16_device_ms": ds_head["popcount_device_ms_bf16"]})
    ir_rows = {r["n"]: r for r in report["ir_solve"]["rows"]}
    tile = ir_rows[128]
    kernels.append({
        "name": "jacobi_sweeps", "route": "cuda",
        "source": "src/repro_torch/csrc/ir_solve.cu",
        "replaces": "src/repro/kernels/ir_solve/kernel.py:56",
        "launches": report["ir_solve"]["launches"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in report["ir_solve"]["rows"]),
        "ms": tile["ms"], "device_ms": tile["device_ms"],
        "plain_ms": tile["plain_ms"],
        "bound_ms": tile["bound_ms"], "bound_by": tile["bound_by"],
        "library_ms": None, "shape": "128x128, 16 sweeps",
        "us_per_sweep": tile["us_per_sweep"],
        **{f"device_ms_{n}x{n}": ir_rows[n]["device_ms"]
           for n in (10, 64, 256, 512)}})
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"chip_smoke: all phases passed in {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
