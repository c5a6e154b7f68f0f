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
             device ms.  The MAC also runs at the other decoder LMs'
             widest reads (``ARCH_GEOMS``: minitron-4b's 256,000-column
             head and its wi, qwen3-8b's wi, nemotron-4-340b's
             18,432-square wq), at qwen2-vl-72b's and whisper-base's
             (``FAMILY_GEOMS``: qwen2-vl's wq, wi, 29,568-row mlp wo and
             head, whisper's head) and at whisper's encoder prefill (its
             wq at B 6000: 4 x 1500 frames), and both paged lanes at
             their groups
             (``ARCH_PAGED_CASES``: 24 q heads over 8, and 96 over 16 at
             head dim 192).  The streamed lane also runs at head dim 40.
             Both paged lanes run again at a long-context shape (windows
             up to 4096 tokens), the streamed lane also at the
             long-context serve's shape (32 query rows per KV head), and
             each carries, beside the call time, the device time of its
             kernels alone (``torch.profiler``); the bf16 scratch lane
             also holds an 8192-token window on a cluster of 8 CTAs
             (past one CTA's capacity), both lanes' capacity logged, and
             the float32 scratch lane runs at ``F32_CASES`` (its serving
             table, 4096 and 8192 tokens on a cluster, 32 query rows per
             KV head at 2048).  With fp8 (float8_e4m3fn) K/V pools, q at
             bf16 and at float32, both lanes at their serving shapes and
             the long shape, and at q bf16 the prefix-sharing serve's
             aliased 128-token table, must equal the same lane on the
             pages upcast to q's type bit for bit; past the on-chip
             capacity (float32 and bf16 at 65,536 tokens, B 1) the
             scratch lane keeps its logits in a global workspace, one
             launch through the dispatcher and none of the streamed
             lane's.
             The deep-net streaming kernel is driven through its entry
             point ``stream_linear`` at every qwen3-4b projection and
             held bitwise against the programmed read (``engine.linear``
             on the crossbar-MAC kernel) and against the popcount kernel
             (its independent integer witness), float32 and bfloat16
             weights, both kernels timed (call and device ms), and wq at
             8, 16 and 24 weight bits (codes past a byte run in passes of
             one byte) also bitwise against the exact code sums; the
             Jacobi kernel is held bitwise against its plain version at
             10, 64, 128, 256 and 512 squared, traced (one device kernel
             per call), timed (call and device ms, device µs per sweep),
             and driven through ``ir_solve.solve`` at 12 x 8, bitwise
             against the plain solve and against the dense nodal solve;
   physics — the device physics and the two array modes, each held on
             the card against the same port function on CPU tensors:
             (a) the paper's 10 x 10 x 2 array (``expansion_mac`` against
             ``expansion_mac_ir``, ``deepnet_read`` with its leakage, the
             bank ops at N = 2 and 3 bit for bit the pair ops) and the
             paper's C1 (the line-loss reduction of 20 SET inputs at
             V_write, 0.22 +- 0.03), C2 (``speedup(200, 10)``, 0.29 +-
             0.01), C3 (2.5 pA +- 5%), C4 (39.6 nA +- 1%) and C5 (the
             worst read deviation over 200 ``sample_conductances`` trials
             and its bits per cell, logged); (b) ``hysteresis_loop`` at
             its defaults (pinched, nonzero area) and ``program_verify``
             (48 pulses x 16 steps) on every cell of qwen3-4b's wq planes,
             83.9 M, a 10 x 10 corner against the CPU; (c)
             ``matmul_analog`` at wq, B 16, against ``engine.matmul`` on
             the same planes and against the CPU, and with noise from four
             generators; (d) ``deepnet_mlp`` through the MAC kernel at
             qwen3-4b's MLP widths (2560 -> 9728 -> 2560 -> 9728 -> 2560,
             B 16), bit for bit the exact plain MAC, each layer's
             programming s and MAC ms; (e) the quickstart's body
             (``examples/torch_quickstart.py``);
3. parity  — full-width qwen3-4b, 2 layers, float32, crossbar backend:
             greedy streams with the plain versions and with the CUDA
             kernels, the window step captured in a CUDA graph (the
             default on the card) and eager (``capture=False``, the
             witness), paged and dense KV, must all be identical, with
             every weight in deep-net layout and under
             ``--mode-policy auto``; then with an fp8 cache
             (``kv_dtype=float8_e4m3fn``): identical with the attention
             kernels on and off at the MAC kernel, and across paged and
             dense, captured and eager; the plain MAC's streams are
             logged beside the kernel's, and in their place the first
             step's layer-0 K/V under both MACs must cast to the same
             fp8 bytes except where the two float32 inputs lie on either
             side of an e4m3 rounding midpoint (a neighbouring step);
             then minitron-4b (squared ReLU, a group of 3) and
             phi3.5-moe (16 experts, top 2) the same way at float32,
             paged: plain, and the kernels captured and eager; then
             ``greedy_generate`` at float32: qwen2-vl-72b (1 layer, 16
             patches on a 4 x 4 grid) and whisper-base (6 + 6 layers,
             1500 frames), the MAC kernel's streams identical to the
             MAC's exact plain version's on the same model (whisper's
             also beside the engine's float32 plain path, logged), and
             rwkv6-3b (2 layers) and zamba2-1.2b (7) on the card and on
             the CPU from the same params, identical;
4. serve   — ``repro_torch.launch.serve.main`` at full width (36 layers)
             with ``--backend crossbar --use-kernel --kv paged`` under
             ``--mode-policy auto`` (attention and head read as
             expansion-fused pairs, 256 rows per ADC), then two
             4-layer serves through the streamed attention lane (the
             second with 1024-token prompts in a 2048-token window), each
             captured and eager with identical streams; then the hot-swap
             serves at full width and 8 layers (``SWAP_ARGV``): without
             a swap, with ``--hot-swap ft:0.02`` captured and eager
             (identical streams), with ``--hot-swap init`` captured (the
             no-swap streams), each swap at version 2 with one
             overlapped ``swap_history`` entry, every request served,
             two closures traced and none retraced, two captures (the
             flip drops the graph), at least 3 decode steps inside the
             window and 2 replays after the flip (the window's steps,
             wall seconds, step ms against the replays before and after
             it, and peak memory logged), and one timed
             ``stop_the_world_swap`` on an 8-layer scheduler; then the
             multiplex serves at full width and 8 layers (``MUX_ARGV``:
             tenants A and B at QoS 2:1 from one 2-plane bank, B's page
             budget binding): the CLI's serve captured; on one programmed
             model the serve captured and eager (equal streams per
             tenant), an in-place swap of B onto its own checkpoint (the
             no-swap streams; A one capture, B two, no retrace), an
             ``evict_tenant("B")`` and live redeploy of B (the no-swap
             streams), an in-place swap of B onto ``ft:0.02`` (A's
             no-swap streams; A's replay ms before, inside and after B's
             window, per-tenant tokens/s and peak memory logged), and a
             dedicated single-tenant serve of B's checkpoint (B's
             streams); then the prefix-sharing and preemption serves at
             full width and 4 layers (``PP_SHARE``, ``PP_PREEMPT``): the
             CLI's shared serve captured, on one programmed model the
             same eager and unshared (equal streams), a preempting serve
             under 8 pages against ample pages (equal streams), and on a
             model reading through the streamed lane both policies under
             24 pages against the plain serve (equal streams), every
             count of shared pages, skipped tokens, COW copies and
             evictions equal to the CPU's on the same arguments; then the
             fp8 cache at full width and 4 layers on one programmed model
             (``kv_dtype=float8_e4m3fn``, bf16 compute): the scratch lane
             at ``PP_PREEMPT`` captured and eager, the streamed lane at
             ``PP_SHARE`` shared captured and eager and unshared (equal
             streams, the CPU's sharing counts, one capture, no
             retrace), the K/V pool half the bf16 serve's bytes at equal
             pages, the token agreement with the bf16-cache serves
             logged; then the other decoder LMs (``ARCH_SERVES``):
             minitron-4b at 8 of its 32 layers and phi3.5-moe at 4, each on
             one model programmed once, captured (one capture, no
             retrace) and eager with identical streams, with tokens/s,
             step ms, programming s and peak memory logged; then the
             other families through ``greedy_generate`` at bf16, B 4
             (``FAMILY_SERVES``): whisper-base (1500 frames, 64 new) and
             qwen2-vl-72b at 2 layers (256 patches, 64 text tokens, 16
             new) on the crossbar with the kernels, no plain version run,
             and rwkv6-3b and zamba2-1.2b at full depth (512-token
             prompts, 32 new), digital, ``chunked_gla`` held against
             ``naive_gla`` at their shapes; each with finite logits, its
             prefill ms, median decode-step ms, tokens/s, programming s
             and peak memory logged; then the training slice
             (``phase_train``): (1) ``launch/train.py``'s ``main`` on
             qwen3-4b FULL at 8 of 36 layers (``TRAIN_ARGV``: bf16
             compute over float32 masters, 4 x 512 tokens in 2
             microbatches, 12 steps), the train step captured in one
             CUDA graph (one capture, then replays), then eager
             (``capture=False``, the witness), both with deterministic
             algorithms: every loss, grad norm and leaf of the final
             state bit for bit, every loss and grad norm finite and the
             last loss below the first (both runs' median step ms of
             steps 3-12, tokens/s, peak and reserved memory, the losses
             logged); (2) qwen3-4b and phi3.5-moe SMOKE at float32 on
             the card (captured) and on the CPU from the same params and
             batches (``TRAIN_PARITY``, within ``TRAIN_LOSS_RTOL`` and
             ``TRAIN_PARAM_RTOL``); (3) with deterministic algorithms, 2k
             captured steps of ``launch/train.py`` against k, a
             checkpoint, ``restore_or_init`` and k more, the final state
             bit for bit, keep-3 and a stale ``.tmp`` collected;
             (4) ``examples/torch_crossstack_deploy.py``'s crossbar
             reads (its precision sweep and its resident prefill) on the
             MAC kernel, one launch a read, each bit for bit the exact
             plain MAC's, then the four serve examples' ``main``; then
             the distribution slice (``phase_dist``): (a)
             ``launch/train.py --mesh local`` at world 1 on NCCL
             (``DIST_TRAIN``, qwen3-4b SMOKE, 3 steps, captured) against
             the same steps on plain tensors without rules; (b)
             ``compressed_psum`` and ``tp_bf16_matmul`` at world 1 on
             CUDA tensors, bitwise their formulas; (c) the MoE block at
             top_k 4 (``DIST_MOE``): two runs bitwise, within
             ``MOE_RTOL`` x max|y| of the CPU; (d) ``dryrun.run_cell``
             for qwen3-4b FULL on the fake 16 x 16 mesh
             (``DIST_DRYRUN``: decode_32k at 36 layers, train_4k cut to
             1 for time), per rank peak, flops, collective bytes and wall
             logged, the card's allocated bytes unmoved; last
             the 36-layer serve on one model programmed once (the
             CLI's setup): captured (its step time: the warm-up, the
             capture and the replays; its launches are the kernels
             line's), eager (its step time, streams equal to the captured
             serve's), then
             captured and eager with steps 4 on in a ``torch.profiler``
             trace of the card (step 3 is the profiler's warm-up; a
             serve whose trace lost device records is served and traced
             again, at most three times) (the MAC's device ms per step
             and the device's idle share), then one eager step in a
             trace with CPU
             activity (the host ops that cost most), and after it
             phi3.5-moe's captured serve once more with its replays in a
             trace of the card (the kernels that take most of a step;
             the streams of its untraced serve), and last the train
             step of (1) under the default algorithms, one eager step and
             three replays, each timed (CUDA events) and then traced on
             the card (``phase_train_trace``: the device's idle share,
             its events per step, the kernels with the most device
             time).  Every serve traces
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
import contextlib
import dataclasses
import gc
import io
import json
import math
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
# kernels launched inside a serve's trace after its counted steps: the
# records a trace lost were always the tail of its last step, so the
# counted steps' records are followed by these before the trace stops
# (outside the window ``_trace_stats`` reads)
TRACE_TAIL_KERNELS = 32768


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
# (name, K, N): the other decoder LMs' widest reads, at B 16: minitron-4b's
# 256,000-column head and its wi, qwen3-8b's wi, nemotron-4-340b's wq
ARCH_GEOMS = [("minitron head", 3072, 256000), ("minitron wi", 3072, 9216),
              ("qwen3-8b wi", 4096, 12288), ("nemotron wq", 18432, 18432)]
# (name, K, N): the VLM's and the encoder-decoder's reads, at B 16:
# qwen2-vl-72b's wq, wi/wg, mlp wo (231 row groups) and head, whisper-base's
# head; and whisper's encoder prefill (4 x 1500 frames) through its wq
FAMILY_GEOMS = [("qwen2-vl wq", 8192, 8192), ("qwen2-vl wi", 8192, 29568),
                ("qwen2-vl mlp wo", 29568, 8192),
                ("qwen2-vl head", 8192, 152064),
                ("whisper head", 512, 51968)]
ENC_GEOM = ("whisper enc wq", 512, 512)
WHISPER_FRAMES = 1500                # Whisper's 30-second window
FAMILY_B = 4                         # the family serves' batch


def phase_crossbar_mac(torch, dev, flush):
    """The MAC at every qwen3-4b projection (B 16, 128 rows per ADC, leak
    0 and 0.37), at the auto policy's 256-row reads, at B 64 (the
    long-context serve's batch), at B 20 and 12 (the multiplexed serve's
    two lanes), at the other archs' geometries (``ARCH_GEOMS``,
    ``FAMILY_GEOMS``) and at whisper's encoder prefill (B 6000):
    BITWISE equal to the exact int64 code sums of
    ``crossbar_mac_codes_ref`` times the LSB, and within 1e-5 of the f32
    plain version.  Runs at leak 0 are timed: call ms (CUDA
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
    # the multiplexed serve's lanes (``MUX_ARGV``): A's 5 slots and B's 3
    # at chunk 4, so 20 rows (a partial second 16-row tile) and 12
    runs += [(g, "deepnet", 128, leak, b) for b in (20, 12)
             for g in (geoms[0], geoms[-1]) for leak in (0.0, 0.37)]
    runs += [(g, "deepnet", 128, 0.0, 16) for g in ARCH_GEOMS + FAMILY_GEOMS]
    runs += [(ENC_GEOM, "deepnet", 128, 0.0, FAMILY_B * WHISPER_FRAMES)]
    for (name, k, n), mode, rows, leak, b in runs:
        t_row = time.perf_counter()
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
        row["wall_s"] = time.perf_counter() - t_row
        rows_out.append(row)
        log(f"  crossbar_mac {name:8s} K={k:5d} N={n:6d} B={b:4d} {mode:9s} "
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
#: past one CTA's capacity (~6,000 tokens at 8 query rows per KV head):
#: either scratch lane on a cluster of 8 CTAs, qwen3-4b's heads, B 4
CLUSTER_CASE = dict(max_len=8192, kv_len=[8192, 6100, 3000, 17])
#: the long-context serve's attention shape (phase 4): chunk 16, so each
#: KV head serves g * sq = 32 query rows, two 16-row groups of the split
#: kernel; windows up to its 2048-token table
SERVE_LONG_CASE = dict(sq=16, max_len=2048, kv_len=[2048, 1500, 1030, 17],
                       block_pages=16)


def _paged_case(torch, dev, gen, b, sq, max_len, ps, hq, kv, hd, kv_len,
                dtype, shared_pages=0):
    """Each row's pages in order from one pool, row 1's first page aliased
    to row 0's; with ``shared_pages``, every later row reads row 0's first
    ``shared_pages`` pages (as far as its own fill reaches) through its
    table instead, as the followers of a shared prefix do."""
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
    if b > 1:
        pt[1, 0] = pt[0, 0]                   # an aliased first page
    for r, length in enumerate(kv_len[1:], 1):
        n = min(shared_pages, -(-length // ps))
        pt[r, :n] = pt[0, :n]
    kv_len_t = torch.tensor(kv_len, dtype=torch.int32)
    q_off = torch.clamp(kv_len_t - sq, min=0)
    if b > 1:
        q_off[-1] = 0                         # a row at the start of prefill
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
                   flush, up=None):
    """Hold one lane against its plain version and time it: the call
    (wrapper and launches, CUDA events), the kernels' device time alone,
    the plain version and one SDPA call over the gathered view.  With
    ``up`` (the same case with fp8 K/V upcast to q's type) the lane on
    ``args`` must equal the lane on ``up`` bit for bit, and SDPA runs on
    ``up``."""
    t0 = time.perf_counter()
    run, plain = _paged_run(kernel, ref, lane, args, bp)
    y = run()
    y_ref = plain()
    torch.cuda.synchronize()
    err, rel = rel_err(torch, y, y_ref)
    q = args[0]
    what = (f"paged_attention_{lane} max_len={max_len} q {q.dtype} K/V "
            f"{args[1].dtype}")
    # bf16 values: the weights (scratch) and outputs round to bf16,
    # whose unit roundoff is 2^-8 = 3.9e-3; float32: exp and the f32 sums
    # in another order
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-5
    check(bool(torch.isfinite(y.float()).all()),
          f"{what}: non-finite output")
    check(rel <= tol, f"{what}: max rel err {rel:.3e} > {tol:g}")
    if up is not None:
        y_up = _paged_run(kernel, ref, lane, up, bp)[0]()
        torch.cuda.synchronize()
        check(torch.equal(y, y_up), f"{what}: not bitwise equal to the "
              f"lane on the pages upcast to {q.dtype}")
    b, sq, hq, hd = q.shape
    kv = args[1].shape[2]
    attended = sum(min(n, max_len) for n in kv_len)
    # K/V bytes: each cached position read once, an aliased page once
    ps = args[1].shape[1]
    pt = args[3].cpu().long()
    held = torch.cat([pt[r, torch.arange(min(n, max_len)) // ps] * ps
                      + torch.arange(min(n, max_len)) % ps
                      for r, n in enumerate(kv_len)]).unique().numel()
    nbytes = (2 * held * kv * hd * args[1].element_size()
              + 2 * y.numel() * y.element_size()
              + args[3].numel() * 4 + 2 * b * 4)
    ops = 4 * sq * hq * hd * attended
    bnd, by = bound(nbytes, ops,
                    "bf16" if q.dtype == torch.bfloat16 else "fp32")
    dms, src = device_ms(torch, run, 20, flush, PAGED_KERNELS[lane])
    sdpa = _sdpa_yardstick(torch, args if up is None else up)
    lib_dms, _ = device_ms(torch, sdpa, 20, flush)
    r = {"max_len": max_len, "kv_len": kv_len, "block_pages": bp,
         "b": b, "sq": sq, "hq": hq, "kv": kv, "hd": hd,
         "q_dtype": str(q.dtype), "kv_dtype": str(args[1].dtype),
         "bitwise_upcast": up is not None,
         "page_size": ps, "held_tokens": held, "max_abs_err": err,
         "max_rel_err": rel, "tol": tol, "ms": timed(torch, run, 20, flush),
         "device_ms": dms, "device_ms_source": src,
         "plain_ms": timed(torch, plain, 5, flush),
         "library_ms": timed(torch, sdpa, 20, flush),
         "library_device_ms": lib_dms,
         "bound_ms": bnd, "bound_by": by,
         "wall_s": time.perf_counter() - t0}
    what += f" hq={hq} kv={kv} hd={hd}"
    log(f"  {what} kv_len={kv_len}"
        f"{' (bitwise = the lane on upcast pages)' if up else ''}: "
        f"max|err| {err:.3e} (rel {rel:.2e} <= {tol:g}); call "
        f"{r['ms']:.4f} ms, device {dms:.4f} ms ({src}), plain "
        f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms (device "
        f"{lib_dms:.4f}), bound {bnd:.5f} ms ({by})")
    return r


#: the prefix-sharing serves' attention (phase 4d, ``PP_SHARE``): B 4,
#: chunk 4, qwen3-4b's 16 KV heads over a 128-token table, the followers
#: reading the owner's first 7 pages; the streamed serve's 16-page block
#: covers the whole table (one split, a combine of one partial)
PP_PAGED_CASE = dict(max_len=128, kv_len=[107, 76, 60, 16], shared_pages=7,
                     block_pages=16)
#: fp8 K/V at each lane's serving shape, at the long shape and at the
#: prefix-sharing serve's shape (what the ``kv_fp8`` phase's sharing serve
#: gives both lanes: one 16-page block, one split): (shape, lane, table,
#: fills, block pages, shared pages, q types)
FP8_CASES = (
    ("serve", "scratch", 64, [64, 37, 12, 5], 0, 0, ("bf16", "f32")),
    ("serve", "streamed", 512, [512, 300, 77, 9], 4, 0, ("bf16", "f32")),
    ("long", "scratch", LONG_CASE["max_len"], LONG_CASE["kv_len"], 0, 0,
     ("bf16", "f32")),
    ("long", "streamed", LONG_CASE["max_len"], LONG_CASE["kv_len"],
     LONG_CASE["block_pages"], 0, ("bf16", "f32")),
    ("prefix_share", "scratch", PP_PAGED_CASE["max_len"],
     PP_PAGED_CASE["kv_len"], 0, PP_PAGED_CASE["shared_pages"], ("bf16",)),
    ("prefix_share", "streamed", PP_PAGED_CASE["max_len"],
     PP_PAGED_CASE["kv_len"], PP_PAGED_CASE["block_pages"],
     PP_PAGED_CASE["shared_pages"], ("bf16",)))
#: past the scratch lane's on-chip capacity (a cluster of 8 holds ~47,000
#: tokens at B 1), the logits in the global workspace: (tag, q and K/V
#: type, B, table, fills); the bf16 window's K/V is 0.54 GB (65,536 tokens
#: x 16 KV heads x 128 x 2 bytes x 2), the float32 one's 1.07 GB
GLOBAL_CASES = (("bf16_65536", "bfloat16", 1, 65536, [65536]),
                ("f32_65536", "float32", 1, 65536, [65536]))
#: the float32 scratch lane (q and K/V float32, qwen3-4b's heads, B 4):
#: (tag, queries per row sq, table, fills) at the serving
#: table, the long shape, 8192 tokens on a cluster of 8 and the long
#: serve's shape (32 query rows per KV head)
F32_CASES = (("serve", 4, 64, [64, 37, 12, 5]),
             ("long", 4, LONG_CASE["max_len"], LONG_CASE["kv_len"]),
             ("cluster", 4, CLUSTER_CASE["max_len"], CLUSTER_CASE["kv_len"]),
             ("serve_long", SERVE_LONG_CASE["sq"], SERVE_LONG_CASE["max_len"],
              SERVE_LONG_CASE["kv_len"]))
#: the multiplexed serve's scratch lanes: (rows, fill of each row)
MUX_PAGED_CASES = ((5, [64, 37, 12, 5, 31]), (3, [31, 20, 5]))
#: the other archs' attention at both lanes' serving shapes, bf16: (tag,
#: q heads, cached KV heads, head dim): minitron-4b's group of 3 (grok-1's
#: 48 over 16 too), nemotron-4-340b's group of 6 at head dim 192
ARCH_PAGED_CASES = (("g3", 24, 8, 128), ("g6_hd192", 96, 16, 192))


def phase_paged_attention(torch, dev, flush):
    """Both lanes at their serving shapes (a 64-token table for the
    scratch lane, 512 tokens in 4-page blocks for the streamed lane), at
    qwen3-4b's heads and at the other archs' (``ARCH_PAGED_CASES``), then
    both at the long-context shape (``LONG_CASE``), then the scratch lane
    past one CTA's capacity on a cluster (``CLUSTER_CASE``), the streamed lane
    at the long-context serve's shape (``SERVE_LONG_CASE``), past the
    scratch lane's capacity, then the scratch lane at the multiplexed
    serve's two lanes (``MUX_PAGED_CASES``) and both lanes at the
    prefix-sharing serves' shape (``PP_PAGED_CASE``)."""
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
    for tag, a_hq, a_kv, a_hd in ARCH_PAGED_CASES:
        for lane, max_len, kv_len, bp in (
                ("scratch", 64, [64, 37, 12, 5], 0),
                ("streamed", 512, [512, 300, 77, 9], 4)):
            args = _paged_case(torch, dev, gen, b, sq, max_len, ps, a_hq,
                               a_kv, a_hd, kv_len, torch.bfloat16)
            out[lane][tag] = _paged_measure(torch, kernel, ref, lane, args,
                                            bp, max_len, kv_len, flush)
    long_args = _paged_case(torch, dev, gen, b, sq, LONG_CASE["max_len"], ps,
                            hq, kv, hd, LONG_CASE["kv_len"], torch.bfloat16)
    for lane in ("scratch", "streamed"):
        out[lane]["long"] = _paged_measure(
            torch, kernel, ref, lane, long_args, LONG_CASE["block_pages"],
            LONG_CASE["max_len"], LONG_CASE["kv_len"], flush)
    cap = {dt: kernel.scratch_capacity(b, sq, hq, kv, hd, ps, eb)
           for dt, eb in (("bf16", 2), ("f32", 4))}
    c = CLUSTER_CASE
    check(min(cap.values()) >= c["max_len"],
          f"scratch lane capacity at B {b}, hq {hq}, kv {kv}: {cap} "
          f"(want both >= {c['max_len']})")
    args = _paged_case(torch, dev, gen, b, sq, c["max_len"], ps, hq, kv, hd,
                       c["kv_len"], torch.bfloat16)
    out["scratch"]["cluster"] = _paged_measure(
        torch, kernel, ref, "scratch", args, 0, c["max_len"], c["kv_len"],
        flush)
    out["scratch"]["capacity"] = cap
    log(f"  scratch lane capacity at B {b}, {hq // kv * sq} query rows per "
        f"KV head, a cluster of up to 8 CTAs: bf16 {cap['bf16']} tokens, "
        f"float32 {cap['f32']}")
    del args
    for tag, sq_f, max_len, kv_len in F32_CASES:  # the float32 lane
        args = _paged_case(torch, dev, gen, b, sq_f, max_len, ps, hq, kv, hd,
                           kv_len, torch.float32)
        out["scratch"].setdefault("f32", {})[tag] = _paged_measure(
            torch, kernel, ref, "scratch", args, 0, max_len, kv_len, flush)
        del args
    c = SERVE_LONG_CASE
    serve_args = _paged_case(torch, dev, gen, b, c["sq"], c["max_len"], ps,
                             hq, kv, hd, c["kv_len"], torch.bfloat16)
    out["streamed"]["serve_long"] = _paged_measure(
        torch, kernel, ref, "streamed", serve_args, c["block_pages"],
        c["max_len"], c["kv_len"], flush)
    # the multiplexed serve's scratch lanes (``MUX_ARGV``): A's 5 rows and
    # B's 3 at chunk 4 over a 64-token table, qwen3-4b's 16 cached KV heads
    # (8 x kv_repeat 2)
    for b_mux, kv_len in MUX_PAGED_CASES:
        args = _paged_case(torch, dev, gen, b_mux, sq, 64, ps, hq, kv, hd,
                           kv_len, torch.bfloat16)
        out["scratch"][f"mux_b{b_mux}"] = _paged_measure(
            torch, kernel, ref, "scratch", args, 0, 64, kv_len, flush)
    c = PP_PAGED_CASE
    args = _paged_case(torch, dev, gen, b, sq, c["max_len"], ps, hq, kv, hd,
                       c["kv_len"], torch.bfloat16,
                       shared_pages=c["shared_pages"])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = kernel.choose_n_split(b, kv, hq // kv * sq, c["max_len"] // ps,
                                    c["block_pages"], ps, sms)
    check(n_split == 1, f"the prefix-sharing serve's streamed lane plans "
          f"{n_split} splits (want 1: one 16-page block)")
    for lane, bp in (("scratch", 0), ("streamed", c["block_pages"])):
        out[lane]["prefix_share"] = _paged_measure(
            torch, kernel, ref, lane, args, bp, c["max_len"], c["kv_len"],
            flush)
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
    phase_paged_fp8(torch, dev, flush, out)
    phase_scratch_global(torch, dev, flush, out)
    return out


def phase_paged_fp8(torch, dev, flush, out):
    """Both lanes with float8_e4m3fn K/V pools (``FP8_CASES``): q at
    bfloat16 and at float32 at their serving shapes and at the long
    shape, and q at bfloat16 at the prefix-sharing serve's aliased
    128-token table; each BITWISE equal to the same lane on the pages
    upcast to q's type, within the lane's bound of the plain version,
    and timed as the other cases (the byte bound counts K/V at 1 byte;
    SDPA runs on the upcast pages)."""
    from repro_torch.kernels.paged_attention import kernel, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    hq, kv, hd, ps, b, sq = 32, 16, 128, 8, 4, 4
    for qdt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for shape, lane, max_len, kv_len, bp, shared, q_types in FP8_CASES:
            if tag not in q_types:
                continue
            args = _paged_case(torch, dev, gen, b, sq, max_len, ps, hq, kv,
                               hd, kv_len, qdt, shared_pages=shared)
            k8, v8 = (t.to(torch.float8_e4m3fn) for t in args[1:3])
            fp8 = (args[0], k8, v8, *args[3:])
            up = (args[0], k8.to(qdt), v8.to(qdt), *args[3:])
            out[lane].setdefault("fp8", {}).setdefault(tag, {})[shape] = \
                _paged_measure(torch, kernel, ref, lane, fp8, bp, max_len,
                               kv_len, flush, up=up)
            del args, fp8, up, k8, v8
    torch.cuda.empty_cache()


def phase_scratch_global(torch, dev, flush, out):
    """The scratch lane past its on-chip capacity (``GLOBAL_CASES``):
    through the dispatcher (no streamed threshold), one scratch launch and
    none of the streamed lane's (nothing rerouted), the logits in the
    global workspace, within the lane's bound of the plain version, and
    timed."""
    from repro_torch.kernels.paged_attention import kernel, ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    hq, kv, hd, ps, sq = 32, 16, 128, 8, 4
    for tag, dt, b, max_len, kv_len in GLOBAL_CASES:
        dtype = getattr(torch, dt)
        args = _paged_case(torch, dev, gen, b, sq, max_len, ps, hq, kv, hd,
                           kv_len, dtype)
        eb = args[0].element_size()
        cap = kernel.scratch_capacity(b, sq, hq, kv, hd, ps, eb)
        ws = kernel.scratch_workspace(b, sq, hq, kv, hd, max_len, ps, eb, eb)
        check(max_len > cap and ws > 0, f"scratch lane {tag}: capacity "
              f"{cap}, workspace {ws} B (want past the on-chip layout)")
        launches = dict(kernel.LAUNCHES)
        calls = dict(ops.paged_path_calls)
        y = ops.paged_attention(*args)
        torch.cuda.synchronize()
        ran = {k: kernel.LAUNCHES[k] - n for k, n in launches.items()}
        routed = {k: ops.paged_path_calls[k] - n for k, n in calls.items()}
        check(ran == {"paged_attention_scratch": 1,
                      "paged_attention_streamed": 0,
                      "paged_attention_combine": 0}
              and routed["paged_scratch"] == 1
              and routed["paged_streamed"] == 0,
              f"scratch lane {tag}: launches {ran}, dispatches {routed}")
        check(bool(torch.isfinite(y.float()).all()),
              f"scratch lane {tag}: non-finite output")
        del y
        r = _paged_measure(torch, kernel, ref, "scratch", args, 0, max_len,
                           kv_len, flush)
        r.update(capacity=cap, workspace_bytes=ws)
        out["scratch"][f"global_{tag}"] = r
        log(f"  scratch lane {tag}: past its on-chip capacity ({cap} "
            f"tokens), {ws / 2**20:.1f} MiB of global logits, no reroute")
        del args
        torch.cuda.empty_cache()


#: weight bits past the serve's 4 that phase 2 drives at wq: one byte of
#: codes, two passes of one byte, three
WIDE_W_BITS = (8, 16, 24)


def phase_deepnet_stream(torch, dev, flush):
    """``stream_linear`` (the entry point) at every qwen3-4b projection,
    B 16, float32 weights: its launches are counted over that run alone,
    and it must reach neither the popcount kernel nor the plain version.
    Then, at 4 weight bits for every projection and at 8, 16 and 24
    (``WIDE_W_BITS``: codes up to 2^24 - 1, the widest the kernels take,
    past 8 bits in passes of one byte) for wq, each output is held
    BITWISE against ``engine.linear`` on the crossbar-MAC kernel (program,
    then read: the same integer codes and the same final conversion), for
    float32 and bfloat16 weights; the tensor-core kernel BITWISE against
    the popcount kernel (an independent integer MAC) on the same operands,
    for both weight types, and against the exact code sums of the plain
    integer MAC (``crossbar_mac_codes_ref`` on ``quantize_codes``,
    converted as the kernel converts) and its plain version (1e-5 x
    max|y|: the plain version shift-adds in f32) for float32 weights.
    Both kernels are timed at every case, call ms (CUDA events) and device
    ms (``torch.profiler``: the zeroing, the kernel and the conversion),
    for both weight types."""
    from repro_torch.core import engine
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.crossbar_mac import ref as mac_ref
    from repro_torch.kernels.deepnet_stream import kernel, ops, ref

    b = 16
    cfg = engine.EngineConfig(mode="deepnet", quant=QuantConfig())
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

    cases = [(cfg, name) for name in geoms] + [
        (dataclasses.replace(cfg, quant=QuantConfig(w_bits=wb)), GEOMS[0][0])
        for wb in WIDE_W_BITS]
    rows, max_abs = [], 0.0
    for c, name in cases:
        q = c.quant
        k, n = geoms[name]
        if c is cfg:
            x, w, y = xs[name], ws[name], outs[name]
        else:
            x = torch.randn((b, k), generator=gen, device=dev)
            w = torch.randn((k, n), generator=gen, device=dev) * 0.05
            y = ops.stream_linear(x, w, c)
        at = f"{name} at w_bits {q.w_bits}"
        kcfg = dataclasses.replace(c, use_kernel=True)
        kw = dict(w_bits=q.w_bits, in_bits=q.in_bits, adc_bits=q.adc_bits,
                  bits_per_cell=q.bits_per_cell, rows_per_adc=c.rows_per_adc)
        full_scale = float(c.rows_per_adc * (2 ** q.bits_per_cell - 1))
        ops_n = 2 * 2 * b * q.in_bits * q.n_slices   # x K x N: AND-add
        wb = w.to(torch.bfloat16)
        prog = engine.linear(x, w, kcfg)
        prog_b = engine.linear(x, wb.float(), kcfg)
        y_b = ops.stream_linear(x, wb, c)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()) and y.shape == (b, n),
              f"stream_linear {at}: bad output")
        prog_err = max((y - prog).abs().max().item(),
                       (y_b - prog_b).abs().max().item())
        check(prog_err == 0.0, f"stream_linear {at} differs from the "
              f"programmed read by {prog_err:.3e}")
        del prog, prog_b, y_b
        x_int = torch.randint(-128, 128, (b, k), generator=gen, device=dev,
                              dtype=torch.int32)
        row = {"geometry": name, "w_bits": q.w_bits, "k": k, "n": n, "b": b,
               "prog_max_abs_err": prog_err, "popcount_bitwise": True,
               "bitwise_codes": True}
        for tag, wt in (("", w), ("_bf16", wb)):
            scale = ops.weight_scales(wt, q)
            yk = kernel.deepnet_stream(x_int, wt, scale, **kw)
            yp = kernel.deepnet_stream_popcount(x_int, wt, scale, **kw)
            torch.cuda.synchronize()
            check(torch.equal(yk, yp), f"deepnet_stream {at}{tag}: not "
                  f"bitwise equal to the popcount kernel (max|diff| "
                  f"{(yk - yp).abs().max().item():.3e})")
            if not tag:
                pos, neg = ref.quantize_codes(wt, scale, w_bits=q.w_bits,
                                              bits_per_cell=q.bits_per_cell)
                codes = mac_ref.crossbar_mac_codes_ref(
                    x_int, pos, neg, in_bits=q.in_bits, adc_bits=q.adc_bits,
                    bits_per_cell=q.bits_per_cell,
                    rows_per_adc=c.rows_per_adc)
                want = mac_ref.codes_to_float(codes, q.adc_bits, full_scale)
                torch.cuda.synchronize()
                check(torch.equal(yk, want), f"deepnet_stream {at}: not "
                      f"bitwise equal to the exact code sums (max|diff| "
                      f"{(yk - want).abs().max().item():.3e})")
                row["max_code_sum"] = int(codes.abs().max())
                del pos, neg, codes, want
                yr = ref.deepnet_stream_ref(x_int, wt, scale, **kw)
                torch.cuda.synchronize()
                err, rel = rel_err(torch, yk, yr)
                tol = 1e-5
                check(rel <= tol, f"deepnet_stream {at}: max rel err "
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
        log(f"  deepnet_stream {name:8s} K={k:5d} N={n:6d} w_bits "
            f"{q.w_bits} ({q.n_slices} slices): programmed read max|diff| "
            f"{prog_err:.1e}; bitwise = popcount kernel and exact code sums "
            f"(largest {row['max_code_sum']}); vs plain max|err| "
            f"{row['max_abs_err']:.3e} (rel {row['max_rel_err']:.2e} <= "
            f"{row['tol']:g}); f32 call {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} ms (popcount {row['popcount_ms']:.4f}, "
            f"{row['popcount_device_ms']:.4f}); bf16 call "
            f"{row['ms_bf16']:.4f}, device {row['device_ms_bf16']:.4f} "
            f"(popcount {row['popcount_ms_bf16']:.4f}, "
            f"{row['popcount_device_ms_bf16']:.4f}); bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}; bf16 "
            f"{row['bound_ms_bf16']:.4f})" + (
                f"; plain {row['plain_ms']:.3f} ms" if "plain_ms" in row
                else ""))
        del x_int, x, w, wb, y
        if c is cfg:
            xs[name] = ws[name] = outs[name] = None
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


# -- the physics phase: device physics and the two array modes ----------------

#: qwen3-4b's MLP widths for ``deepnet_mlp``: d_model -> d_ff -> d_model,
#: twice (four deep-net layers)
MLP_WIDTHS = (2560, 9728, 2560, 9728, 2560)
PHYSICS_B = 16
#: ``matmul_analog(noise=False)`` against ``engine.matmul`` on the same
#: planes, max |diff| / max |twin| (tests/test_torch_physics.py)
ANALOG_TWIN_REL = 0.25
#: outputs of ``matmul_analog`` that an ADC code on either side of a
#: rounding midpoint may move between the card and the CPU
ANALOG_FLIP_SHARE = 0.02
#: the Euler trajectories, card against CPU (tests/test_torch_physics.py)
STATE_ATOL = 2.0 ** -20
LOOP_RTOL = 2.0 ** -18
SOLVE_RTOL = 1e-4     # cuSOLVER's LU against LAPACK's (docs/PORT.md)
MAC_RTOL = 1e-6       # x max: a float32 v @ G in another order


def _close(torch, got, want, rtol, what):
    _, rel = rel_err(torch, got.cpu(), want.cpu())
    check(rel <= rtol, f"{what}: card vs CPU rel err {rel:.3e} > {rtol}")
    return rel


def _analog_moved(torch, got, want, x, pw, cfg):
    """The share of ``matmul_analog`` outputs that differ by more than
    1e-6 x max|want|, and the largest such difference in ADC codes at the
    heaviest (pulse, slice) weight (one flipped code at a rounding
    midpoint moves an output by at most one)."""
    from repro_torch.core import engine

    code = engine._analog_code_value(x, pw, cfg).cpu()
    diff = (got.cpu().double() - want.cpu().double()).abs()
    moved = diff > 1e-6 * want.abs().max().item()
    worst = float((diff[moved] / code[moved]).max()) if moved.any() else 0.0
    return float(moved.double().mean()), worst


def _paper_array(torch, dev):
    """(a) The paper's 10 x 10 x 2 array: the mode ops on the card held
    against the CPU, the bank ops against the pair ops, and C1-C5."""
    from repro_torch.core import crossbar, ir_drop, modes, pipeline
    from repro_torch.core import device as dm
    from repro_torch.core.timing import PAPER

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    g_all = (PAPER.g_reset + (PAPER.g_set - PAPER.g_reset)
             * torch.rand((3, 10, 10), generator=gen))
    v_all = torch.rand((2, 10), generator=gen) * PAPER.v_read
    cfg = modes.StackConfig(10, 10)
    out = {}

    def both(fn):
        """``fn(device)`` on the card and on the CPU."""
        return fn(dev), fn(cpu)

    def pair_on(d):
        return modes.StackState(g_all[0].to(d), g_all[1].to(d),
                                torch.tensor(True, device=d))

    i_id, i_id_cpu = both(lambda d: modes.expansion_mac(
        pair_on(d), v_all[0].to(d), v_all[1].to(d), cfg))
    i_ir, i_ir_cpu = both(lambda d: modes.expansion_mac_ir(
        pair_on(d), v_all[0].to(d), v_all[1].to(d), cfg))
    check(bool((i_ir <= i_id + 1e-12).all())
          and bool((1.0 - i_ir / i_id < 0.05).all()),
          "expansion_mac_ir is not within 5% under the ideal expansion_mac")
    out["expansion_mac_rel"] = _close(torch, i_id, i_id_cpu, MAC_RTOL,
                                      "expansion_mac")
    out["expansion_mac_ir_rel"] = _close(torch, i_ir, i_ir_cpu, SOLVE_RTOL,
                                         "expansion_mac_ir")
    out["ir_loss_max"] = float((1.0 - i_ir / i_id).max())
    rd, rd_cpu = both(lambda d: modes.deepnet_read(pair_on(d),
                                                   v_all[0].to(d), cfg))
    out["deepnet_read_rel"] = _close(torch, rd, rd_cpu, MAC_RTOL,
                                     "deepnet_read")
    leak = rd - modes.deepnet_read(pair_on(dev), v_all[0].to(dev), cfg,
                                   include_leakage=False)
    out["deepnet_read_leak_A"] = float(leak.mean())

    # the bank ops, bit for bit the pair ops (tests/test_planebank.py)
    pair, vt, vb = pair_on(dev), v_all[0].to(dev), v_all[1].to(dev)
    g_new = g_all[2].to(dev)
    bank = modes.bank_from_pair(pair)
    check(torch.equal(modes.bank_read(bank, vt, cfg),
                      modes.deepnet_read(pair, vt, cfg)),
          "bank_read at N = 2 differs from deepnet_read")
    i_pair, pair2 = modes.deepnet_layer(pair, vt, g_new, cfg)
    i_bank, bank2 = modes.bank_layer(bank, vt, g_new, cfg)
    check(torch.equal(i_pair, i_bank)
          and torch.equal(bank2.g[0], pair2.g_top)
          and torch.equal(bank2.g[1], pair2.g_bot)
          and bool(bank2.read_idx == torch.logical_not(
              pair2.read_top).to(torch.int32)),
          "bank_layer at N = 2 differs from deepnet_layer")
    check(torch.equal(modes.bank_expansion_mac(bank, vt, vb, cfg),
                      modes.expansion_mac(pair, vt, vb, cfg))
          and torch.equal(modes.bank_expansion_mac_ir(bank, vt, vb, cfg),
                          modes.expansion_mac_ir(pair, vt, vb, cfg)),
          "the fused pair at N = 2 differs from the expansion ops")
    g3 = g_all.to(dev)
    bank3 = modes.BankState(g3, torch.tensor(0, dtype=torch.int32,
                                             device=dev))
    for idx in range(3):
        one = modes.StackState(g3[idx], g3[idx], torch.tensor(True,
                                                              device=dev))
        check(torch.equal(
            modes.bank_read(modes.bank_set_read(bank3, idx), vt, cfg,
                            include_leakage=False),
            modes.deepnet_read(one, vt, cfg, include_leakage=False)),
            f"bank_read of plane {idx} at N = 3")
    b2 = modes.bank_write_plane(bank3, modes.bank_write_idx(bank3), g_new)
    check(torch.equal(b2.g[1], g_new) and torch.equal(b2.g[0], g3[0])
          and torch.equal(b2.g[2], g3[2]),
          "bank_write_plane at N = 3 touched another plane")
    b3 = modes.bank_advance(modes.bank_advance(modes.bank_advance(bank3)))
    check(b3.read_idx.device == g3.device and int(b3.read_idx) == 0,
          "the N = 3 ring did not come round")
    lk = [modes.bank_read(bank3, vt, cfg, n_writing=n) for n in (0, 1, 2)]
    check(torch.allclose(lk[2] - lk[0], 2.0 * (lk[1] - lk[0]), rtol=1e-6),
          "two writing planes do not leak twice one")

    # C1: 20 inputs, all SET, at V_write (tests/test_core.py:77-91)
    def c1(d):
        g = torch.full((20, 20), PAPER.g_set, device=d)
        v = torch.full((20,), PAPER.v_write, device=d)
        i_ideal = ir_drop.ideal_currents(
            crossbar.effective_conductance(g, crossbar.PlaneConfig(20, 20)),
            v)
        i_pl, _, _ = ir_drop.solve_planar(g, v)
        gt = torch.full((10, 20), PAPER.g_set, device=d)
        vt_ = torch.full((10,), PAPER.v_write, device=d)
        i_cs, _, _ = ir_drop.solve_crossstack(gt, gt, vt_, vt_)
        return 1.0 - float(ir_drop.ir_drop_loss(i_cs, i_ideal).mean()
                           / ir_drop.ir_drop_loss(i_pl, i_ideal).mean())

    c1_card, c1_cpu = both(c1)
    check(abs(c1_card - 0.22) <= 0.03,
          f"C1: line-loss reduction {c1_card:.4f} not 0.22 +- 0.03")
    check(abs(c1_card - c1_cpu) <= 1e-4,
          f"C1: card {c1_card} vs CPU {c1_cpu}")
    c2 = pipeline.speedup(200, 10)
    check(abs(c2 - 0.29) <= 0.01, f"C2: speedup(200, 10) = {c2:.4f}")
    c3 = float(dm.transistor_leakage(
        torch.tensor(PAPER.v_write, device=dev),
        torch.tensor(0.0, device=dev)))
    check(abs(c3 / 2.5e-12 - 1.0) <= 0.05, f"C3: leakage {c3:.4e} A")
    c4 = float(crossbar.mac(torch.full((1,), 0.004, device=dev),
                            torch.full((1, 1), PAPER.g_reset, device=dev),
                            crossbar.PlaneConfig(1, 1))[0]) * 1e9
    check(abs(c4 / 39.6 - 1.0) <= 0.01, f"C4: read current {c4:.3f} nA")
    # C5: the worst read deviation of a 10-cell all-SET column over 200
    # Monte-Carlo trials, and the bits per cell it leaves
    cgen = torch.Generator(device=dev).manual_seed(1)
    g = dm.sample_conductances(cgen, torch.ones((200, 10), device=dev))
    i_cols = (PAPER.v_read * crossbar.effective_conductance(
        g, crossbar.PlaneConfig(10, 10))).sum(dim=1)
    i_nom = PAPER.v_read * 10 / (PAPER.r_set + PAPER.r_on_transistor)
    worst = float(((i_cols - i_nom).abs() / i_nom).max())
    c5_bits = float(torch.log2(torch.tensor(1.0 / worst)))
    out.update(c1=c1_card, c1_cpu=c1_cpu, c2=c2, c3_A=c3, c4_nA=c4,
               c5_worst_dev=worst, c5_bits_per_cell=c5_bits)
    log(f"  (a) 10 x 10 x 2: expansion_mac vs CPU "
        f"{out['expansion_mac_rel']:.2e}, through the nodal solve "
        f"{out['expansion_mac_ir_rel']:.2e} "
        f"(IR loss up to {100 * out['ir_loss_max']:.3f}%); deepnet_read "
        f"{out['deepnet_read_rel']:.2e}, leakage "
        f"{out['deepnet_read_leak_A'] * 1e12:.2f} pA a column; bank ops at "
        f"N = 2 and 3 bitwise the pair ops")
    log(f"  paper: C1 line-loss reduction {c1_card:.4f} (CPU {c1_cpu:.4f}; "
        f"paper 0.22); C2 speedup(200, 10) {c2:.4f} (0.29); C3 leakage "
        f"{c3 * 1e12:.4f} pA (2.5); C4 read {c4:.3f} nA (39.6); C5 worst "
        f"read deviation {100 * worst:.2f}% over 200 trials -> "
        f"{c5_bits:.2f} bits per cell (paper: 8%, 3.5)")
    return out


def _device_dynamics(torch, dev, pw, cfg):
    """(b) ``hysteresis_loop`` at its defaults and ``program_verify`` on
    every cell of ``pw``'s planes (both sides, every slice), each run
    captured (its Euler blocks replayed from one CUDA graph) and eagerly
    (``capture=False``): bitwise equal, and held against the CPU.  Wall
    s of both, peak memory of both ``program_verify`` runs, and the
    memory reserved but unused after each once the cache is emptied (the
    captured call's graph pool must be released)."""
    import numpy as np

    from repro_torch.core import device as dm
    from repro_torch.core import quant
    from repro_torch.core.timing import PAPER

    out = {}
    loops = {}
    for capture in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops[capture] = dm.hysteresis_loop(device=dev, capture=capture)
        torch.cuda.synchronize()
        out["hysteresis_s" if capture else "hysteresis_eager_s"] = (
            time.perf_counter() - t0)
    v, i, w = loops[True]
    check(all(torch.equal(a, b) for a, b in zip(loops[True], loops[False])),
          "hysteresis_loop: the captured trajectory differs from the eager")
    del loops
    t0 = time.perf_counter()
    v_c, i_c, w_c = dm.hysteresis_loop(device="cpu")
    out["hysteresis_cpu_s"] = time.perf_counter() - t0
    vn, i_n = v.cpu().numpy(), i.cpu().numpy()
    near0 = np.abs(vn) < 0.01
    pinch = float(np.abs(i_n[near0]).max() / np.abs(i_n).max())
    half = len(vn) // 2
    area = float(abs(np.trapezoid(i_n[half:], vn[half:])))
    check(pinch < 0.05 and area > 0.0,
          f"hysteresis loop: pinch {pinch:.3e}, area {area:.3e}")
    dv = float((v.cpu() - v_c).abs().max())
    dw = float((w.cpu() - w_c).abs().max())
    di = float((i.cpu() - i_c).abs().max() / i_c.abs().max())
    check(dv <= STATE_ATOL and dw <= STATE_ATOL and di <= LOOP_RTOL,
          f"hysteresis card vs CPU: v {dv:.3e}, w {dw:.3e}, i {di:.3e}")
    out.update(pinch=pinch, area=area, steps=len(vn), dv=dv, dw=dw, di=di)
    log(f"  (b) hysteresis_loop, {len(vn)} steps: captured "
        f"{out['hysteresis_s']:.3f} s, eager {out['hysteresis_eager_s']:.3f}"
        f" s on the card, bitwise equal ({out['hysteresis_cpu_s']:.2f} s "
        f"CPU); pinch {pinch:.2e}, area {area:.3e} V A; card vs CPU: v "
        f"{dv:.2e}, w {dw:.2e}, i {di:.2e} of max")

    q = cfg.quant
    codes = torch.stack([pw.pos, pw.neg])          # (2, S, T, R, N)
    target = quant.slices_to_conductance(codes, q, PAPER.g_reset,
                                         PAPER.g_set)
    del codes
    w0 = torch.rand(target.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    model = dm.MemristorModel()
    runs = {}
    for capture in (True, False):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        runs[capture] = model.program_verify(w0, target, n_pulses=48,
                                             n_steps=16, capture=capture)
        torch.cuda.synchronize()
        tag = "" if capture else "_eager"
        out[f"program_verify{tag}_s"] = time.perf_counter() - t0
        out[f"program_verify{tag}_peak_gb"] = (
            torch.cuda.max_memory_allocated(dev) - before) / 1e9
        torch.cuda.empty_cache()
        out[f"program_verify{tag}_cached_gb"] = (
            torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev)) / 1e9
    check(torch.equal(runs[True][0], runs[False][0])
          and torch.equal(runs[True][1], runs[False][1]),
          "program_verify: the captured states or trace differ from the "
          "eager ones")
    # a graph pool still held would stay reserved past empty_cache()
    cached = (out["program_verify_cached_gb"],
              out["program_verify_eager_cached_gb"])
    check(cached[0] <= cached[1] + 0.1,
          f"program_verify: {cached[0]:.3f} GB reserved and unused after "
          f"the captured call (eager {cached[1]:.3f}): the graph's pool "
          f"was not released")
    w_fin, g_tr = runs[True]
    del runs
    r_fin = 1.0 / model.conductance(w_fin)
    share = float(((r_fin * target - 1.0).abs() <= 0.25).double().mean())
    corner = (0, 0, 0, slice(0, 10), slice(0, 10))
    w_cpu, g_cpu = model.program_verify(w0[corner].cpu(),
                                        target[corner].cpu(),
                                        n_pulses=48, n_steps=16)
    dw_pv = float((w_fin[corner].cpu() - w_cpu).abs().max())
    dg_pv = float(((g_tr[(slice(None),) + corner].cpu() - g_cpu).abs()
                   / g_cpu).max())
    check(dw_pv <= STATE_ATOL and dg_pv <= LOOP_RTOL,
          f"program_verify card vs CPU at the 10 x 10 corner: w {dw_pv:.3e}"
          f", g {dg_pv:.3e}")
    out.update(cells=target.numel(), within_25pct=share, dw_pv=dw_pv,
               dg_pv=dg_pv, trace_gb=g_tr.numel() * 4 / 1e9)
    log(f"  (b) program_verify, 48 pulses x 16 steps, on {target.numel():,}"
        f" cells (wq's planes, both sides): captured "
        f"{out['program_verify_s']:.2f} s, eager "
        f"{out['program_verify_eager_s']:.2f} s, bitwise equal; peak "
        f"{out['program_verify_peak_gb']:.2f} / "
        f"{out['program_verify_eager_peak_gb']:.2f} GB over the inputs, "
        f"reserved unused after {cached[0]:.3f} / {cached[1]:.3f} GB; "
        f"{100 * share:.2f}% of cells within 25% of their target "
        f"resistance; the 10 x 10 corner vs CPU: w {dw_pv:.2e}, g "
        f"{dg_pv:.2e}")
    return out


def _analog_at_wq(torch, dev, w, pw, cfg):
    """(c) ``matmul_analog`` at qwen3-4b's wq: noise off against
    ``engine.matmul`` (the MAC kernel) and against the CPU; noise on from
    four seeded generators."""
    from repro_torch.core import engine

    out = {}
    x = torch.randn((PHYSICS_B, w.shape[0]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    twin = engine.matmul(x, pw, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    analog = engine.matmul_analog(None, x, pw, cfg, noise=False)
    torch.cuda.synchronize()
    out["card_s"] = time.perf_counter() - t0
    pw_cpu = engine.ProgrammedLinear(pw.pos.cpu(), pw.neg.cpu(),
                                     pw.w_scale.cpu(), pw.k, pw.n)
    t0 = time.perf_counter()
    analog_cpu = engine.matmul_analog(None, x.cpu(), pw_cpu, cfg,
                                      noise=False)
    out["cpu_s"] = time.perf_counter() - t0
    _, rel_twin = rel_err(torch, analog, twin)
    check(rel_twin <= ANALOG_TWIN_REL,
          f"matmul_analog vs engine.matmul: {rel_twin:.4f} > "
          f"{ANALOG_TWIN_REL}")
    share, worst = _analog_moved(torch, analog, analog_cpu, x, pw, cfg)
    check(share <= ANALOG_FLIP_SHARE and worst <= 2.0,
          f"matmul_analog card vs CPU: {100 * share:.3f}% of outputs moved"
          f", up to {worst:.2f} codes")
    noisy = torch.stack([engine.matmul_analog(
        torch.Generator(device=dev).manual_seed(k), x, pw, cfg)
        for k in range(4)])
    check(bool(torch.isfinite(noisy).all()), "noisy matmul_analog: "
          "non-finite output")
    scale = analog.abs().max()
    spread = float(noisy.std(dim=0).max() / scale)
    dev_noise = float((noisy - analog).abs().max() / scale)
    out.update(rel_twin=rel_twin, moved_share=share, moved_codes=worst,
               noise_spread=spread, noise_dev=dev_noise)
    log(f"  (c) matmul_analog at wq ({w.shape[0]} x {w.shape[1]}, B "
        f"{PHYSICS_B}): {out['card_s'] * 1e3:.1f} ms on the card, "
        f"{out['cpu_s']:.2f} s on the CPU; against engine.matmul "
        f"{rel_twin:.4f} of max (bound {ANALOG_TWIN_REL}); card vs CPU "
        f"{100 * share:.3f}% of outputs moved by an ADC midpoint (up to "
        f"{worst:.2f} codes); noise on, 4 generators: spread {spread:.4f} "
        f"of max, up to {dev_noise:.4f} from the noiseless read")
    return out


def _deepnet_mlp_at_width(torch, dev):
    """(d) ``deepnet_mlp`` through the CUDA MAC at qwen3-4b's MLP widths:
    its launches, bit for bit the exact plain MAC's output, and each
    layer's programming and MAC time."""
    from repro_torch.core import engine, pipeline

    cfg = engine.EngineConfig(mode="deepnet", use_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    ws = [torch.randn((a, b), device=dev, generator=gen) * 0.02
          for a, b in zip(MLP_WIDTHS[:-1], MLP_WIDTHS[1:])]
    x = torch.randn((PHYSICS_B, MLP_WIDTHS[0]), device=dev, generator=gen)
    _reset_counts()
    y = pipeline.deepnet_mlp(x, ws, cfg)
    torch.cuda.synchronize()
    counted, plain, by_rows = _read_counts()
    check(counted["crossbar_mac"] == len(ws)
          and by_rows == {cfg.rows_per_adc: len(ws)}
          and not any(plain.values()),
          f"deepnet_mlp launched {counted}, plain {plain}, rows {by_rows}")
    with _exact_plain_mac(torch):
        y_exact = pipeline.deepnet_mlp(x, ws, cfg)
    check(torch.equal(y, y_exact),
          "deepnet_mlp through the MAC kernel differs from the exact plain "
          "MAC's")
    # each layer again, timed: programming (the write) and the MAC (read)
    prog_s, mac_ms, h = [], [], x
    for i, w in enumerate(ws):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pw = engine.program(w, cfg)
        torch.cuda.synchronize()
        prog_s.append(time.perf_counter() - t0)
        h_in = h
        h = engine.matmul(h_in, pw, cfg)
        mac_ms.append(timed(torch, lambda: engine.matmul(h_in, pw, cfg), 5))
        if i < len(ws) - 1:
            h = torch.relu(h)
    check(torch.equal(h, y), "the timed layers differ from deepnet_mlp")
    overlap = pipeline.streaming_speedup(
        statistics.mean(mac_ms) / 1e3, statistics.mean(prog_s), len(ws))
    log(f"  (d) deepnet_mlp {' -> '.join(map(str, MLP_WIDTHS))}, B "
        f"{PHYSICS_B}, deep-net (128 rows per ADC): {counted['crossbar_mac']}"
        f" MAC launches, bitwise the exact plain MAC; per layer programming "
        + ", ".join(f"{s:.4f}" for s in prog_s) + " s, MAC "
        + ", ".join(f"{m:.3f}" for m in mac_ms)
        + f" ms; streaming_speedup {overlap:.4f}")
    return {"launches": counted["crossbar_mac"], "program_s": prog_s,
            "mac_ms": mac_ms, "streaming_speedup": overlap}


def phase_physics(torch, dev):
    """The device physics and the two array modes on the card, (a)-(e)
    of the module docstring."""
    from repro_torch.core import engine

    t_phase = time.perf_counter()
    out = {"paper_array": _paper_array(torch, dev)}
    cfg = engine.EngineConfig(mode="deepnet", use_kernel=True)
    k, n = GEOMS[0][1:]
    w = torch.randn((k, n), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5)
                    ) * 0.02
    pw = engine.program(w, cfg)
    out["dynamics"] = _device_dynamics(torch, dev, pw, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    out["analog"] = _analog_at_wq(torch, dev, w, pw, cfg)
    del w, pw
    out["deepnet_mlp"] = _deepnet_mlp_at_width(torch, dev)
    quickstart = _example("quickstart")
    _reset_counts()
    qs = quickstart.main(dev)
    torch.cuda.synchronize()
    counted, plain, _ = _read_counts()
    check(counted["crossbar_mac"] == len(qs["outputs"])
          and not any(plain.values()),
          f"quickstart launched {counted}, plain {plain}")
    # every read again through the MAC's exact plain version: the
    # kernel's outputs at 64-row tiles, 2 x 64-row pairs, a 12-bit ADC and
    # w_bits 8, 4 and 2, bit for bit
    with _exact_plain_mac(torch), contextlib.redirect_stdout(io.StringIO()):
        qs_exact = quickstart.main(dev)
    differ = [key for key, y in qs["outputs"].items()
              if not torch.equal(y, qs_exact["outputs"][key])]
    check(not differ and qs["reads"] == qs_exact["reads"]
          and qs["executor_rel_err"] == qs_exact["executor_rel_err"],
          f"quickstart: the kernel's reads {differ} differ from the exact "
          f"plain MAC's")
    check(all(0.0 <= e < 1.0 for e in qs["reads"].values())
          and abs(qs["speedups"][10] - 0.29) <= 0.01,
          f"quickstart: {qs['reads']}, speedups {qs['speedups']}")
    log(f"  (e) quickstart: {counted['crossbar_mac']} MAC launches, each "
        f"read bitwise the exact plain MAC's")
    out["quickstart"] = {"reads": {f"{m}_{b}": e for (m, b), e in
                                   qs["reads"].items()},
                         "executor_rel_err": qs["executor_rel_err"]}
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  physics phase: {out['phase_s']:.1f} s")
    return out


# -- phase 3: token parity with and without the kernels -------------------------

#: the MAC-toggle probe's first step at fp8: slots x chunk query rows,
#: each row's K and V cast into the cache by every layer
PROBE_SLOTS, PROBE_CHUNK = 8, 16


def _first_step_cache_inputs(torch, model, params, gen, vocab):
    """The float32 K and V that each layer casts into the cache (its
    ``cache_cast`` inputs, in call order: layer 0's K, layer 0's V, layer
    1's K, ...) in an eager paged serve's first step over
    ``PROBE_SLOTS`` prompts, one ``PROBE_CHUNK``-token chunk each."""
    from repro_torch.models import layers
    from repro_torch.serve.engine import BatchScheduler, Request

    sched = BatchScheduler(model, params, n_slots=PROBE_SLOTS, max_len=64,
                           kv="paged", capture=False, chunk=PROBE_CHUNK)
    for i in range(PROBE_SLOTS):
        sched.submit(Request(rid=i, prompt=torch.randint(
            0, vocab - 1, (PROBE_CHUNK + 8,), generator=gen,
            dtype=torch.int32), max_new=1))
    seen, cast = [], layers.cache_cast

    def record(x, dtype):
        seen.append(x.detach().float().cpu())
        return cast(x, dtype)

    layers.cache_cast = record
    try:
        sched.step()
    finally:
        layers.cache_cast = cast
    return seen


def _fp8_flips(torch, a, b):
    """Where the float32 tensors ``a`` and ``b`` (one cache write computed
    twice) cast to different e4m3 bytes: the count, and how many of them
    are explained by rounding, that is, the two fp8 values are neighbours
    on the e4m3 grid and the rounding midpoint between them lies between
    ``a`` and ``b`` (inclusive).  Also the gap |a - b| over every entry:
    its largest value against the tensor's largest magnitude, and in
    e4m3 steps at the larger of the two values."""
    from repro_torch.models.layers import FP8, cache_cast

    fa, fb = (cache_cast(t, FP8) for t in (a, b))
    flip = fa.view(torch.uint8) != fb.view(torch.uint8)
    grid = torch.arange(256, dtype=torch.uint8).view(FP8).double()
    grid = grid[torch.isfinite(grid)].unique()        # sorted, one zero
    va, vb = fa[flip].double(), fb[flip].double()
    x, y = a[flip].double(), b[flip].double()
    mid = (va + vb) / 2
    step = (torch.searchsorted(grid, va) - torch.searchsorted(grid, vb))
    explained = (torch.isfinite(va) & torch.isfinite(vb)
                 & (step.abs() <= 1)                  # 0 only for -0 / +0
                 & (torch.minimum(x, y) <= mid) & (mid <= torch.maximum(x, y)))
    gap = (a.double() - b.double()).abs()
    big = torch.maximum(a.abs(), b.abs()).double()
    # e4m3's spacing: 2^-9 below 2^-6 (subnormals), else 2^(e - 3)
    e4m3_step = torch.ldexp(torch.ones_like(big),
                            torch.frexp(big).exponent.clamp(min=-5) - 4)
    return {"values": a.numel(), "f32_differ": int((a != b).sum()),
            "flips": int(flip.sum()), "explained": int(explained.sum()),
            "max_gap_of_scale": float(gap.max() / big.max()),
            "max_gap_steps": float((gap / e4m3_step).max())}


def phase_parity(torch, dev, mode_policy=None, kv_dtype=None, arch=ARCH,
                 kvs=("paged", "dense")):
    """Greedy streams of ``arch`` at full width, 2 layers, float32,
    crossbar backend: the plain versions (captured), and the CUDA kernels
    captured and eager (``capture=False``, the witness), with each KV
    layout of ``kvs``, must all be identical; each serve must trace its
    window step once.  ``kv_dtype``: the cache's dtype.  With the fp8
    cache (``torch.float8_e4m3fn``) the MAC kernel runs with the
    attention kernels on and off, and the plain MAC with neither: the
    MAC's plain version shift-adds its codes in float32 and its kernel
    sums them exactly, so K and V differ in the
    last float32 bits before the cache cast, and the cast to e4m3 (3
    mantissa bits) turns the values that lie within that gap of a
    rounding midpoint into a whole fp8 step.  So at fp8 the streams must
    be identical with the attention kernels on and off at the MAC kernel,
    and across paged and dense, captured and eager; in place of the plain
    MAC's streams equalling the kernel's, the first step's cache inputs
    of both MACs (``_first_step_cache_inputs``) must cast to the same
    bytes except where the rounding explains the flip
    (``_fp8_flips``), at layer 0, whose input is the same token
    embeddings under both; if the streams differ, layer 0's inputs must
    differ (float32 caches hold the streams equal, above)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import BatchScheduler, Request

    t_phase = time.perf_counter()
    base = dataclasses.replace(get_config(arch), n_layers=2,
                               backend="crossbar", dtype=torch.float32,
                               kv_dtype=kv_dtype)
    gen = torch.Generator()
    gen.manual_seed(2)
    prompts = [torch.randint(0, base.vocab - 1, (n,), generator=gen,
                             dtype=torch.int32) for n in (5, 11, 3)]
    params = None
    streams, probe = {}, {}
    pairs = ([(False, False), (True, True)] if kv_dtype is None else
             [(False, False), (True, False), (True, True)])
    for mac, attn in pairs:
        use_kernel = mac and attn
        cfg = dataclasses.replace(
            base, paged_kernel=attn,
            xbar=dataclasses.replace(base.xbar, use_kernel=mac))
        model = build_model(cfg, device=dev)
        if params is None:
            params = model.init(0)
        runs = ([(kv, c) for kv in kvs for c in (True, False)]
                if use_kernel else [("paged", True)])
        for kv, capture in runs:
            _reset_counts()
            sched = BatchScheduler(model, params, n_slots=2, max_len=64,
                                   kv=kv, mode_policy=mode_policy,
                                   capture=capture)
            cache = sched._lanes["A"].cache["layers"]
            check(cache["k"].dtype == cache["v"].dtype
                  == (kv_dtype or torch.float32),
                  f"the cache is {cache['k'].dtype} (want {kv_dtype})")
            for i, p in enumerate(prompts):
                sched.submit(Request(rid=i, prompt=p, max_new=4))
            done, steps = [], 0
            while len(done) < len(prompts) and steps < 100:
                done += sched.step()
                steps += 1
            check(len(done) == len(prompts), "parity run did not finish")
            caps = sched.capture_report()
            cap = caps["A"]
            counted, _, by_rows = _read_counts()
            ran = _executed(counted, caps)
            n_mac = ran["crossbar_mac"]
            n_pa = ran["paged_attention_scratch"]
            _check_traced_once(caps, capture)
            run = (mac, attn, kv, capture)
            streams[run] = {r.rid: r.out for r in done}
            check((n_mac > 0) == mac
                  and (n_pa > 0) == (attn and kv == "paged"),
                  f"mac kernel={mac} attention kernels={attn} kv={kv}: "
                  f"launches mac={n_mac} paged={n_pa}")
            if use_kernel and mode_policy == "auto":
                check(by_rows.get(256, 0) > 0 and by_rows.get(128, 0) > 0,
                      f"auto policy: crossbar_mac launches by rows "
                      f"{by_rows}")
            log(f"  {arch} policy={mode_policy} kv_dtype={kv_dtype} "
                f"mac kernel="
                f"{mac} attention kernels={attn} kv={kv} "
                f"{'captured' if capture else 'eager'}: streams "
                f"{streams[run]} (kernel launches run: crossbar_mac {n_mac}"
                f" {by_rows}, paged scratch {n_pa}; {cap['captures']} "
                f"capture, {cap['replays']} replays)")
            del sched
        if kv_dtype is not None and mac == attn:
            probe_gen = torch.Generator()
            probe_gen.manual_seed(3)
            probe[mac] = _first_step_cache_inputs(torch, model, params,
                                                  probe_gen, base.vocab)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    # the runs that must agree: all of them, or at fp8 the MAC kernel's
    group = [r for r in streams if kv_dtype is None or r[0]]
    first = streams[group[0]]
    check(all(streams[r] == first for r in group),
          f"{arch}: greedy streams differ across plain/kernel, "
          f"paged/dense, captured/eager (mode_policy={mode_policy}, kv_dtype="
          f"{kv_dtype}): { {r: streams[r] for r in group} }")
    plain, kern = (streams[(m, m, "paged", True)] for m in (False, True))
    mac_equal = plain == kern
    log(f"  {arch} parity: {time.perf_counter() - t_phase:.1f} s")
    out = {"arch": arch, "seconds": time.perf_counter() - t_phase,
           "streams": {str(k): v for k, v in kern.items()},
           "identical": True, "layers": 2, "dtype": "float32",
           "kv_dtype": str(kv_dtype), "mode_policy": mode_policy,
           "plain_mac_streams_equal": mac_equal,
           "plain_mac_agreement": _agreement(plain, kern),
           "runs": [f"mac_kernel={m} attention_kernels={a} kv={kv} "
                    f"capture={c}" for m, a, kv, c in streams]}
    if kv_dtype is None:
        return out
    names = [f"layer{i // 2}_{'kv'[i % 2]}" for i in range(len(probe[True]))]
    flips = {n: _fp8_flips(torch, a, b)
             for n, a, b in zip(names, probe[False], probe[True])}
    for n, f in flips.items():
        log(f"  MAC toggle, first step ({PROBE_SLOTS} x {PROBE_CHUNK} "
            f"tokens) {n}: {f['f32_differ']} of {f['values']} float32 "
            f"inputs differ, by at most {f['max_gap_of_scale']:.2e} of the "
            f"largest magnitude and {f['max_gap_steps']:.3f} e4m3 steps; "
            f"{f['flips']} fp8 bytes flip, {f['explained']} of them a "
            f"neighbour across a rounding midpoint that lies between the "
            f"two inputs")
    layer0 = [flips[n] for n in names[:2]]
    check(all(f["flips"] == f["explained"] for f in layer0),
          f"kv_dtype={kv_dtype}: layer 0's fp8 bytes under the plain MAC "
          f"and the MAC kernel differ where rounding does not explain "
          f"it: {layer0}")
    check(mac_equal or any(f["f32_differ"] for f in layer0),
          f"kv_dtype={kv_dtype}: the plain MAC's streams differ from the "
          f"MAC kernel's, but layer 0's cache inputs are equal: {layer0}")
    log(f"  kv_dtype={kv_dtype}: the plain MAC's streams "
        f"{'equal' if mac_equal else 'differ from'} the MAC kernel's "
        f"(token agreement {out['plain_mac_agreement']:.3f}); every "
        f"flipped fp8 byte of layer 0 is rounding across a midpoint")
    out["mac_toggle"] = flips
    return out


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


def _executed(counted, caps):
    """The kernel launches a serve ran: the wrappers count the eager
    steps' launches and, once, the launches each capture records; every
    replay runs the recorded launches again, so the replays of each lane
    (``caps``: the scheduler's ``capture_report()``) beyond the one that
    follows each capture add its ``launches_per_replay`` each."""
    out = dict(counted)
    for cap in caps.values():
        for k, n in cap["launches_per_replay"].items():
            out[k] = out.get(k, 0) + n * (cap["replays"] - cap["captures"])
    return out


def _check_traced_once(caps, capture, closures=1):
    """One trace of each window-step closure each lane built (``closures``
    per lane, or a count per tenant: a lane whose planes flip builds two,
    before and after) — its capture, or its first call when eager — and
    no retrace, since the counts were last set to 0."""
    from repro_torch import obs

    if isinstance(closures, int):
        closures = {t: closures for t in caps}
    reg = obs.registry()
    traces = reg.total("serve_jit_traces_total", closure="decode")
    retraces = reg.total("serve_jit_retraces_total", closure="decode")
    want_traces = sum(closures.values())
    check(traces == want_traces and retraces == 0,
          f"window step traced {traces} times, {retraces} retraces "
          f"(want {want_traces}, 0)")
    want = (capture is not False)
    for t, cap in caps.items():
        check(cap["capture"] == want
              and cap["captures"] == closures[t] * want
              and (cap["replays"] > 0) == want,
              f"lane {t}: capture report {cap} (capture={capture}, "
              f"closures {closures[t]})")


def _step_stats(step_s):
    """Per-step wall ms: the mean, the first two steps (the warm-up and,
    captured, the capture) and the median of the rest."""
    ms = [t * 1e3 for t in step_s]
    return {"step_ms": sum(ms) / len(ms), "first_steps_ms": ms[:2],
            "later_step_ms": statistics.median(ms[2:])}


def phase_serve(torch, dev, argv, must_launch, rows_per_adc=(),
                capture=None, closures=1, run=None):
    """``launch/serve.main(argv)``, its window step captured (the default)
    or eager (``capture=False``); every kernel of ``must_launch`` must have
    run and no plain version.  ``closures``: the window-step closures the
    serve builds (2 across a hot-swap's flip).  ``run``, if given, serves
    instead of ``main`` (on a model it holds programmed, so memory is
    not checked to be free first) and returns what ``main`` returns."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    # greedy decoding takes the argmax over the head's padded vocab (as
    # the reference does), so any id below padded_vocab is one the model
    # can emit and embed; random weights do emit ids past vocab
    vocab = get_config(argv[argv.index("--arch") + 1]).padded_vocab
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    check(run is not None or held < 1 << 30, f"{held / 2**30:.2f} GiB "
          f"still allocated before the serve")
    _reset_counts()
    rep = run() if run is not None else serve.main(argv, capture=capture)
    torch.cuda.synchronize()
    counted, plain, by_rows = _read_counts()
    caps = rep["captures"]
    cap = caps["A"]
    kernels = _executed(counted, caps)
    _check_traced_once(caps, capture, closures)
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
    lanes = "; ".join(
        f"{t}: {c['captures']} capture(s), {c['replays']} replays of "
        f"{c['launches_per_replay']}" for t, c in caps.items())
    log(f"  kernel launches run {kernels} (counted by the wrappers "
        f"{counted}; {lanes}; crossbar_mac by rows per ADC {by_rows}); "
        f"plain-version calls {plain}")
    n_req = int(argv[argv.index("--requests") + 1])
    max_new = int(argv[argv.index("--max-new") + 1])
    check(len(rep["requests"]) == n_req
          and all(len(r.out) == max_new for r in rep["requests"]),
          "serve did not complete every request")
    check(all(0 <= t < vocab for t in toks),
          "token outside the head's padded vocab")
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
            **stats, "capture": cap, "captures": caps,
            "streams": {r.rid: list(r.out) for r in rep["requests"]},
            "tenant_of": {r.rid: r.model_id for r in rep["requests"]},
            "max_memory_allocated": peak, "memory_before": held,
            "launches": kernels, "launches_counted": counted,
            "launches_by_rows": by_rows,
            "plain_calls": plain, "mode_report": rep.get("mode_report"),
            "step_s": rep["step_s"], "swap_phase": rep["swap_phase"],
            "swap_history": rep["swap_history"], "version": rep["version"],
            "versions": rep.get("versions"), "qos": rep.get("qos"),
            "kv": rep.get("kv"), "lane_ms": rep.get("lane_ms"),
            "kv_counts": rep.get("kv_counts"), "host": rep.get("host"),
            "peak_pages": rep.get("peak_pages"),
            "kv_dtype": rep.get("kv_dtype"),
            "pool_bytes": rep.get("pool_bytes"),
            "in_flight": {r.rid: [r.t_admit, r.t_done]
                          for r in rep["requests"]}}


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
    its conversion kernel), every device event's ms per step, the eight
    kernel names with the most device time per step, and the device's
    idle share (the window less the union of those events)."""
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
    by_name = {}
    for e in evs:
        if lo <= float(e["ts"]) < hi:
            name = e["name"][:96]
            by_name[name] = by_name.get(name, 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"mac_device_ms_per_step": mac_us / steps / 1e3,
            "top_kernels_ms_per_step": {k: us / steps / 1e3
                                        for k, us in top},
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
        tail = torch.zeros(1, device=st.model.device)
        for _ in range(TRACE_TAIL_KERNELS):
            tail.add_(1)
        torch.cuda.synchronize()
    counted = {k: n - before.get(k, 0) for k, n in launch_counts().items()}
    cap = sched.capture_report()["A"]
    _check_traced_once(sched.capture_report(), capture)
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
    _check_traced_once(sched.capture_report(), False)
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


def phase_witness(torch, dev, argv, out_dir):
    """The 36-layer serve of ``argv`` on one model, programmed once: the
    captured serve (``phase_serve``: its step times, launches and
    streams), the eager step (``capture=False``) untraced, its streams
    equal to the captured serve's; then the captured and the eager serves
    with steps 4 on in a trace of the card; last, one eager step in a
    trace with CPU activity on.  Returns the captured serve's report with
    the rest under ``witness``."""
    from repro_torch.launch import serve

    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated(dev) < 1 << 30,
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still "
          f"allocated before the 36-layer serve")
    st = serve.setup(argv)
    t0 = time.perf_counter()
    st.model.executor.program_params(st.params)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    log(f"  programming {program_s:.2f} s")
    sv = phase_serve(torch, dev, argv,
                     ["crossbar_mac", "paged_attention_scratch"],
                     rows_per_adc=[128], run=lambda: _drive(st, dev))
    sv["program_s"] = program_s
    want = sv["streams"]
    _reset_counts()
    sched = st.scheduler(capture=False)
    rep = serve.drive(sched, st.requests(), dev)
    _check_traced_once(sched.capture_report(), False)
    del sched
    streams = {r.rid: list(r.out) for r in rep["requests"]}
    check(streams == want, f"the eager 36-layer serve's streams {streams} "
          f"differ from the captured serve's {want}")
    stats = _step_stats(rep["step_s"])
    log(f"  eager: tokens/s {rep['tok_per_s']:.2f} ({rep['tokens']} tokens,"
        f" {rep['steps']} steps, {rep['seconds']:.2f} s; step "
        f"{stats['step_ms']:.2f} ms, median after the first two "
        f"{stats['later_step_ms']:.2f} ms); streams equal the captured "
        f"serve's")
    out = {"eager": {"tok_per_s": rep["tok_per_s"], "steps": rep["steps"],
                     "seconds": rep["seconds"], **stats}}
    # the traces slow the host for what follows them: untraced first
    for name, capture in (("trace_captured", True), ("trace_eager", False)):
        out[name] = _serve_in_trace(torch, st, capture, out_dir)
        check(out[name]["streams"] == want,
              f"{name}: streams differ from the captured serve's")
    out["host_ops"] = _host_ops_of_one_step(torch, st)
    sv["witness"] = out
    return sv


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


# -- phase 4b: hot-swap at full width ----------------------------------------

#: the hot-swap serves: qwen3-4b at full width, 8 layers (a staged swap
#: holds two plane sets and two params trees: 64.45 GB at 16 layers, more
#: than the card's 80 GB at 36; cut from 16 to 8 to keep the run inside
#: its time limit), 8 requests on 4 slots, 16 new tokens
SWAP_ARGV = ["--arch", ARCH, "--layers", "8", "--backend", "crossbar",
             "--use-kernel", "--kv", "paged", "--requests", "8", "--slots",
             "4", "--prompt-len", "16", "--max-new", "16", "--max-len", "64",
             "--chunk", "4"]
SWAP_FLAGS = ["--swap-after", "2", "--swap-chunks", "256"]


def _window(sv):
    """A swap serve's steps split at its window: ms of the replays before
    it (after the warm-up and the capture), of the window's steps, and of
    the replays after the flip (after its warm-up and its capture)."""
    phase, ms = sv["swap_phase"], [t * 1e3 for t in sv["step_s"]]
    first, flip = phase.index("window"), phase.index("flip")
    check(phase[first:flip] == ["window"] * (flip - first)
          and "window" not in phase[flip:],
          f"the swap window is not one run of steps: {phase}")
    return {"before_ms": ms[2:first], "window_ms": ms[first:flip],
            "flip_ms": ms[flip:flip + 2], "after_ms": ms[flip + 2:],
            "first_window_step": first, "flip_step": flip}


def _check_swap(sv, policy="overlapped", version=2):
    """The deploy ``version`` and one ``swap_history`` entry of
    ``policy``."""
    check(sv["version"] == version and len(sv["swap_history"]) == 1
          and sv["swap_history"][0]["policy"] == policy,
          f"swap: version {sv['version']} (want {version}), history "
          f"{[h['policy'] for h in sv['swap_history']]}")
    return sv["swap_history"][0]


@contextlib.contextmanager
def _swap_host_timers():
    """Wall seconds a swap spends in the source digests
    (``planes.fingerprint_weight``, which copies each weight to the host),
    in the chunk writes less their digests, and in write-verify; the
    functions are wrapped for the block and restored after it."""
    from repro_torch.core import planes

    spent = {"digest": 0.0, "chunks": 0.0, "verify": 0.0}
    cp = planes.ChunkedProgram
    saved = (planes.fingerprint_weight, cp.write_chunk, cp.verify)

    def timer(key, fn):
        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t
        return wrapped

    planes.fingerprint_weight = timer("digest", saved[0])
    cp.write_chunk = timer("chunks", saved[1])
    cp.verify = timer("verify", saved[2])
    try:
        yield spent
    finally:
        planes.fingerprint_weight, cp.write_chunk, cp.verify = saved
        spent["chunks"] -= spent["digest"]   # first chunks take digests


def _drive(st, dev, swap_params=None, capture=None):
    """A serve of ``st``'s requests on its model, whose weights are
    resident (``launch/serve.drive``, with a hot-swap of ``swap_params``
    as ``SWAP_FLAGS`` set it), captured unless ``capture`` is False;
    returns what ``launch/serve.main`` returns."""
    from repro_torch.launch import serve

    sched = st.scheduler(capture)
    after, chunks = (int(SWAP_FLAGS[i]) for i in (1, 3))
    rep = serve.drive(sched, st.requests(), dev, swap_params=swap_params,
                      swap_after=after, swap_chunks=chunks)
    caps = sched.capture_report()
    rep.update(program_s=0.0, capture=caps["A"], captures=caps,
               swap_history=list(sched.swap_history),
               version=st.model.executor.version())
    return rep


def phase_hotswap(torch, dev):
    """The 8-layer serve with an ``ft:0.02`` swap through the CLI,
    captured and eager (equal streams); then on one programmed model the
    serve without a swap and with an ``init`` swap, captured (equal
    streams: the graph captured after the flip reads the promoted
    planes), and one timed ``stop_the_world_swap``."""
    from repro_torch.launch import serve
    from repro_torch.serve.hotswap import finetune_delta

    must = ["crossbar_mac", "paged_attention_scratch"]
    ft = SWAP_ARGV + ["--hot-swap", "ft:0.02"] + SWAP_FLAGS
    out = {"argv": ft}
    log(f"  {' '.join(ft)}; captured")
    cap = out["ft"] = phase_serve(torch, dev, ft, must, closures=2)
    log("  the same, eager")
    eager = out["ft_eager"] = phase_serve(torch, dev, ft, must,
                                          capture=False, closures=2)
    check(eager["streams"] == cap["streams"],
          "ft swap: captured and eager streams differ")
    log("  one programmed model: no swap, then --hot-swap init, captured")
    gc.collect()
    torch.cuda.empty_cache()
    st = serve.setup(SWAP_ARGV)
    t0 = time.perf_counter()
    st.model.executor.program_params(st.params)
    torch.cuda.synchronize()
    out["program_s"] = time.perf_counter() - t0
    base = out["no_swap"] = phase_serve(torch, dev, SWAP_ARGV, must,
                                        run=lambda: _drive(st, dev))
    ident = out["init"] = phase_serve(
        torch, dev, SWAP_ARGV, must, closures=2,
        run=lambda: _drive(st, dev, swap_params=st.params))
    check(ident["streams"] == base["streams"],
          "init swap: streams differ from the serve without a swap")
    for key, sv in (("ft", cap), ("ft_eager", eager), ("init", ident)):
        h = _check_swap(sv)
        w = sv["window"] = _window(sv)
        check(h["decode_steps_during_swap"] >= 3,
              f"{key}: {h['decode_steps_during_swap']} decode steps in the "
              f"window (want >= 3)")
        check(len(w["after_ms"]) >= 2,
              f"{key}: {len(w['after_ms'])} replays after the flip "
              f"(want >= 2)")
        lpr = sv["capture"]["launches_per_replay"].get("crossbar_mac", 0)
        sv["window_mac_launches"] = (h["decode_steps_during_swap"] * lpr
                                     if lpr else None)
        med = {k: statistics.median(w[k]) for k in
               ("before_ms", "window_ms", "after_ms")}
        sv["window_median_ms"] = med
        log(f"  {key}: {h['n_chunks']} chunks in "
            f"{h['decode_steps_during_swap']} decode steps, window "
            f"{h['wall_swap_s']:.3f} s wall; step ms median before "
            f"{med['before_ms']:.2f}, in the window {med['window_ms']:.2f}"
            f" (max {max(w['window_ms']):.1f}), after "
            f"{med['after_ms']:.2f} (flip and the next "
            f"{w['flip_ms'][0]:.1f}, {w['flip_ms'][1]:.1f}); MAC launches "
            f"in the window {sv['window_mac_launches']} (replays x "
            f"{lpr}); max_memory_allocated "
            f"{sv['max_memory_allocated'] / 1e9:.2f} GB")
    check(cap["window"]["flip_step"] == eager["window"]["flip_step"]
          and cap["swap_history"][0]["decode_steps_during_swap"]
          == eager["swap_history"][0]["decode_steps_during_swap"],
          "captured and eager swaps flipped at different steps")
    log("  stop_the_world_swap (ft:0.02) on a scheduler of that model")
    sched = st.scheduler()
    fp_old = st.model.executor.fingerprint()
    new = finetune_delta(st.params, 0.02)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with _swap_host_timers() as spent:
        stats = sched.stop_the_world_swap(new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = _check_swap({"version": stats["programmed_version"],
                     "swap_history": sched.swap_history}, "stop_the_world",
                    version=3)
    check(st.model.executor.fingerprint() != fp_old
          and not sched.swap_in_flight, "stop-the-world swap did not land")
    peak = torch.cuda.max_memory_allocated(dev)
    out["stop_the_world"] = {"wall_s": wall, "n_chunks": stats["n_chunks"],
                             "max_memory_allocated": peak,
                             "report_wall_s": h["wall_swap_s"],
                             "host_s": spent}
    log(f"  stop-the-world: {stats['n_chunks']} chunks in {wall:.3f} s "
        f"wall (no step served): source digests {spent['digest']:.3f} s, "
        f"chunk writes {spent['chunks']:.3f} s, write-verify "
        f"{spent['verify']:.3f} s; programming the model took "
        f"{out['program_s']:.2f} s; max_memory_allocated "
        f"{peak / 1e9:.2f} GB")
    del st, sched, new
    return out


# -- phase 4c: multiplexing at full width ---------------------------------

#: the multiplex serves: qwen3-4b at full width, 8 layers (until the
#: promote an in-place swap of B holds three plane sets and three params
#: trees, ~48 GB at 8 layers and ~77 GB at 16), tenants A (seed 0) and B
#: (seed 1) at QoS 2:1, 8 requests round-robin.  --kv-pages 16 splits
#: into 21 pages for A and 11 for B (``_split_slots``), and every request
#: claims 4 pages (16 + 16 - 1 tokens): A's four requests all fit, B holds
#: two of its four at a time, so the page budget binds on B's lane only
#: the other decoder LMs served at full width through the CLI's entry
#: points: minitron-4b (squared ReLU, a group of 3, the 256,000-column
#: head) at 8 of its 32 layers (all 32 fit, ~47 GB, but take ~42 s to
#: program; 16 took 30.4 s, and chip_smoke passed 1000 s with them and
#: the dist phase); phi3.5-moe (16 experts, top 2) at 4 layers, ~27 GB
#: (its f32 experts are 5 GB a layer)
ARCH_SERVES = (("minitron-4b", 8), ("phi3.5-moe", 4))


def _serve_argv(arch, layers=None):
    """The main serve's command line (4 slots, chunk 4, 4 requests x 8
    new tokens, a 64-token window) for ``arch`` at ``layers``."""
    return (["--arch", arch] + (["--layers", str(layers)] if layers else [])
            + ["--backend", "crossbar", "--use-kernel", "--kv", "paged",
               "--requests", "4", "--prompt-len", "16", "--max-new", "8",
               "--slots", "4", "--max-len", "64", "--chunk", "4"])


def phase_arch_trace(torch, dev, out_dir, want):
    """phi3.5-moe's captured serve of ``ARCH_SERVES`` on a new model, its
    replayed steps 4 on in a trace of the card (after every timed serve:
    a trace slows the serves that follow it): the MAC's device ms per
    step, all device work, the idle share and the kernels that take the
    most; its streams must be ``want``, the untraced serve's."""
    from repro_torch.launch import serve

    arch, layers = ARCH_SERVES[1]
    gc.collect()
    torch.cuda.empty_cache()
    st = serve.setup(_serve_argv(arch, layers))
    out = _serve_in_trace(torch, st, True, out_dir)
    check(out["streams"] == want,
          f"{arch}: the traced serve's streams differ from the untraced")
    log(f"  {arch}: device ms per step by kernel "
        + "; ".join(f"{ms:.3f} {name[:60]}" for name, ms in
                    out["top_kernels_ms_per_step"].items()))
    return out


def phase_archs(torch, dev):
    """Each of ``ARCH_SERVES`` on one model programmed once: the serve
    captured (one capture, no retrace; tokens/s, step ms, peak memory),
    then the eager witness on the same resident planes, whose streams must
    equal the captured serve's."""
    from repro_torch.launch import serve

    must = ["crossbar_mac", "paged_attention_scratch"]
    out = {}
    for arch, layers in ARCH_SERVES:
        t_phase = time.perf_counter()
        argv = _serve_argv(arch, layers)
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated(dev) < 1 << 30,
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still "
              f"allocated before the {arch} serve")
        st = serve.setup(argv)
        t0 = time.perf_counter()
        st.model.executor.program_params(st.params)
        torch.cuda.synchronize()
        program_s = time.perf_counter() - t0
        cfg = st.model.cfg
        log(f"  {' '.join(argv)}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, act {cfg.act}, {cfg.family}; programming "
            f"{program_s:.2f} s; captured, then eager")
        cap = phase_serve(torch, dev, argv, must,
                          run=lambda: _drive(st, dev))
        eager = phase_serve(torch, dev, argv, must, capture=False,
                            run=lambda: _drive(st, dev, capture=False))
        check(eager["streams"] == cap["streams"],
              f"{arch}: captured and eager streams differ")
        del st
        cap["program_s"] = program_s
        cap["eager"] = {k: eager[k] for k in (
            "tok_per_s", "steps", "seconds", "step_ms", "first_steps_ms",
            "later_step_ms", "launches", "max_memory_allocated")}
        cap["phase_s"] = time.perf_counter() - t_phase
        log(f"  {arch}: streams equal captured and eager; replays "
            f"{cap['later_step_ms']:.2f} ms against eager "
            f"{eager['later_step_ms']:.2f} ms; peak "
            f"{cap['max_memory_allocated'] / 1e9:.2f} GB; "
            f"{cap['phase_s']:.1f} s")
        out[arch] = cap
    return out


# -- the VLM, encoder-decoder and recurrent families ------------------------

#: qwen2-vl-72b's serve (2 of its 80 layers): a 16 x 16 grid of patches at
#: t = 0, 64 text tokens after it, 16 new; its cache holds all 336 slots
VLM_SERVE = dict(layers=2, grid=16, text=64, new=16, max_len=336)
#: (arch, layers (None: all), backend, batch kwargs, new tokens, max_len)
FAMILY_SERVES = (
    ("whisper-base", None, "crossbar", dict(text=4, frames=WHISPER_FRAMES),
     64, None),
    ("qwen2-vl-72b", VLM_SERVE["layers"], "crossbar",
     dict(text=VLM_SERVE["text"], grid=VLM_SERVE["grid"]), VLM_SERVE["new"],
     VLM_SERVE["max_len"]),
    ("rwkv6-3b", None, "digital", dict(text=512), 32, None),
    ("zamba2-1.2b", None, "digital", dict(text=512), 32, None))
#: chunked_gla against naive_gla at the recurrent serves' shapes: within
#: this x max(1, max|naive|), float32 (docs/PORT.md)
GLA_SERVE_BOUND = 2.0 ** -18


def _family_batch(torch, dev, cfg, b, gen, text, grid=0, frames=0):
    """A ``greedy_generate`` batch for ``cfg``'s family, drawn from ``gen``
    (a generator on ``dev``): ``text`` tokens a row; for a VLM ``grid`` x
    ``grid`` patch embeddings at t = 0, ids (0, h, w), and the text's ids
    after the grid; for an encoder-decoder ``frames`` frame embeddings."""
    batch = {"tokens": torch.randint(0, cfg.vocab - 1, (b, text),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        ar = torch.arange(grid, device=dev)
        h, w = torch.meshgrid(ar, ar, indexing="ij")
        vis = torch.stack([torch.zeros_like(h), h, w], -1).reshape(-1, 3)
        txt = (grid + torch.arange(text, device=dev))[:, None].expand(-1, 3)
        batch["positions_thw"] = torch.cat([vis, txt]).to(
            torch.int32)[None].expand(b, -1, -1).contiguous()
        batch["vis_emb"] = torch.randn((b, grid * grid, cfg.d_model),
                                       generator=gen, device=dev)
    if cfg.family == "encdec":
        batch["enc_emb"] = torch.randn((b, frames, cfg.d_model),
                                       generator=gen, device=dev)
    return batch


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _timed_generate(torch, model, params, batch, max_new, max_len=None,
                    capture=True, replays=False):
    """``greedy_generate`` with the model's prefill timed on the host
    clock, the device synchronized around it, and every step's logits
    checked finite on the device.  Captured (the default), a decode step
    is the generate wall less the prefill over the ``max_new - 1`` steps
    (the warm-up and the capture included): a sync inside the capture is
    illegal.  With ``replays`` each run of the loop's ``GraphStep`` is
    timed between syncs instead (outside the capture), and the decode
    step ms are the replays' alone.  Eager (``capture=False``, the
    witness), each decode step is timed between syncs.  Returns (tokens,
    prefill ms, decode-step ms, wall s, logits finite,
    ``greedy_generate``'s stats)."""
    from repro_torch.graphs import GraphStep
    from repro_torch.serve.engine import greedy_generate

    ms = {"prefill": [], "decode_step": []}
    finite = torch.ones((), dtype=torch.bool, device=model.device)
    inner = {key: getattr(model, key) for key in ms}

    def timed(key):
        sync = key == "prefill" or not capture

        def run(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            logits, cache = inner[key](*args, **kwargs)
            finite.logical_and_(torch.isfinite(logits).all())
            if sync:
                torch.cuda.synchronize()
                ms[key].append((time.perf_counter() - t0) * 1e3)
            return logits, cache
        return run

    run, runs = GraphStep.run, []

    def timed_run(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(step)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)

    for key in ms:
        setattr(model, key, timed(key))
    if capture and replays:
        GraphStep.run = timed_run
    stats = {}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = greedy_generate(model, params, batch, max_new,
                               max_len=max_len, capture=capture,
                               stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        GraphStep.run = run
        for key in ms:
            setattr(model, key, inner[key])
    step_ms = ms["decode_step"]
    if capture:
        step_ms = (runs[2:] if replays else
                   [(wall * 1e3 - ms["prefill"][0]) / (max_new - 1)])
    return toks, ms["prefill"][0], step_ms, wall, bool(finite), stats


def _check_generate_stats(stats, max_new, what):
    """One capture a call: the warm-up eager, every later decode step
    served by the graph."""
    want = (1, max_new - 2, 1)
    got = (stats["captures"], stats["replays"], stats["eager_steps"])
    check(got == want, f"{what}: captures, replays, eager steps {got}, "
          f"want {want}")


#: columns per call of the exact plain MAC (``_exact_plain_mac``): bounds
#: its float32 copies of the planes (2.1 GB at K 8192)
EXACT_COLS = 16384


@contextlib.contextmanager
def _exact_plain_mac(torch):
    """Route the engine's MAC reads through the MAC's exact plain version:
    the int64 code sums of ``crossbar_mac_codes_ref`` times the LSB,
    ``EXACT_COLS`` columns at a time, which the kernel equals bit for bit
    (phase 2).  Inside, a model built with ``use_kernel=True`` launches
    no kernel; everything else it computes is unchanged."""
    from repro_torch.kernels.crossbar_mac import ops, ref

    launch = ops.crossbar_mac

    def exact(x, pos, neg, leak, *, in_bits, adc_bits, bits_per_cell,
              rows_per_adc, full_scale_rows=None):
        fs_rows = full_scale_rows or rows_per_adc
        kw = dict(in_bits=in_bits, adc_bits=adc_bits,
                  bits_per_cell=bits_per_cell, rows_per_adc=rows_per_adc,
                  full_scale_rows=fs_rows, leak_codes=leak)
        full_scale = float(fs_rows * (2 ** bits_per_cell - 1))
        return torch.cat([ref.codes_to_float(ref.crossbar_mac_codes_ref(
            x, pos[..., c:c + EXACT_COLS], neg[..., c:c + EXACT_COLS],
            **kw), adc_bits, full_scale)
            for c in range(0, pos.shape[-1], EXACT_COLS)], dim=-1)

    ops.crossbar_mac = exact
    try:
        yield
    finally:
        ops.crossbar_mac = launch


def _logits_at(torch, model, params, batch, toks, step, max_len):
    """The logits (B, V) and the cache of a greedy run of ``model`` at
    decode step ``step`` (0: the prefill's), fed ``toks[:, :step]``."""
    b, s = batch["tokens"].shape
    max_len = max_len or s + toks.shape[1]
    cache = (model.init_cache(b, max_len, src_len=s)
             if model.cfg.family == "encdec" else
             model.init_cache(b, max_len))
    logits, cache = model.prefill(params, batch, cache)
    for j in range(step):
        logits, cache = model.decode_step(params, toks[:, j:j + 1], cache)
    return logits[:, -1].float(), cache


def _explain_divergence(torch, dev, models, params, batch, streams,
                        max_len):
    """The first decode step at which the plain MAC's and the kernel's
    streams part, both models fed the kernel's tokens before it: each
    must pick its own stream's token again; how far apart their logits
    (and an encoder-decoder's encoder K) lie is logged."""
    kern, plain = (torch.tensor(streams[k], device=dev) for k in (True,
                                                                   False))
    step = int((kern != plain).any(0).nonzero()[0])
    (lk, ck), (lp, cp) = (_logits_at(torch, models[k], params, batch, kern,
                                     step, max_len) for k in (True, False))
    check(torch.equal(lk.argmax(-1), kern[:, step])
          and torch.equal(lp.argmax(-1), plain[:, step]),
          "the fed runs do not repeat the greedy streams' tokens")
    scale = lp.abs().max()
    gap = ((lk - lp).abs().max() / scale).item()
    rows = (kern[:, step] != plain[:, step]).nonzero()[:, 0].tolist()
    margins = [((lp[r, plain[r, step]] - lp[r, kern[r, step]]) / scale)
               .item() for r in rows]
    out = {"step": step, "rows": rows, "logit_gap": gap,
           "plain_margins": margins}
    if "cross_kv" in ck:
        out["cross_k_gap"] = ((ck["cross_kv"]["k"] - cp["cross_kv"]["k"])
                              .abs().max() / cp["cross_kv"]["k"].abs().max()
                              ).item()
    log(f"  the streams part at decode step {step}, rows {rows}: fed the "
        f"same tokens, the two paths' logits differ by {gap:.2e} of the "
        f"largest magnitude, the plain path's own pick leads the kernel's "
        f"by {', '.join(f'{m:.2e}' for m in margins)} of it"
        + (f"; the encoder's K by {out['cross_k_gap']:.2e}"
           if "cross_k_gap" in out else ""))
    return out


def phase_family_parity(torch, dev):
    """``greedy_generate`` at float32: qwen2-vl-72b at full width and 1
    layer (its programming ~25 s; 8 text tokens after 16 patches on a 4 x
    4 grid) and whisper-base at its 6 + 6 layers (1500 frames, 4 tokens),
    crossbar: the MAC kernel's streams must equal, on the same programmed
    model, those of the MAC's exact plain version (``_exact_plain_mac``).
    For whisper-base (a 1 s programming) the engine's plain path
    (``use_kernel=False``: the reference's order, shift-adding the codes
    in float32) runs too, each path alone launched; its streams are
    logged beside the kernel's, and where they part
    ``_explain_divergence`` logs how far: its reads are 1e-5 from the
    kernel's (phase 2), and each layer's int8 input quantization turns a
    value that close to a rounding midpoint into a whole code, a gap the
    layers after it widen;
    rwkv6-3b at full width and 2 layers and zamba2-1.2b at 7 (one
    shared-attention application, then a trailing Mamba2 block), digital,
    must give on the card the streams the port gives on the CPU from the
    same params.  Every ``greedy_generate`` call on the card is captured
    (the default): one capture a call, each decode step after the
    warm-up served by the graph."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import greedy_generate

    out = {}
    for arch, layers, kw, routes in (
            ("qwen2-vl-72b", 1, dict(text=8, grid=4), (True,)),
            ("whisper-base", None, dict(text=4, frames=WHISPER_FRAMES),
             (False, True))):
        t_arch = time.perf_counter()
        base = get_config(arch)
        base = dataclasses.replace(base, n_layers=layers or base.n_layers,
                                   backend="crossbar", dtype=torch.float32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(4)
        batch = _family_batch(torch, dev, base, 2, gen, **kw)
        max_len = (kw["grid"] ** 2 + kw["text"] + 4 if "grid" in kw
                   else None)
        params, streams, models = None, {}, {}
        for use_kernel in routes:
            cfg = dataclasses.replace(base, xbar=dataclasses.replace(
                base.xbar, use_kernel=use_kernel))
            model = models[use_kernel] = build_model(cfg, device=dev)
            params = params if params is not None else model.init(0)
            _reset_counts()
            stats = {}
            toks = greedy_generate(model, params, batch, 4, max_len=max_len,
                                   stats=stats)
            torch.cuda.synchronize()
            counted, plain, _ = _read_counts()
            _check_generate_stats(stats, 4, f"{arch} use_kernel="
                                  f"{use_kernel}")
            n_mac = counted["crossbar_mac"]
            n_ref = plain["engine.matmul_reference"]
            check((n_mac > 0) == use_kernel and (n_ref > 0) != use_kernel,
                  f"{arch} use_kernel={use_kernel}: MAC launches {n_mac}, "
                  f"plain MAC calls {n_ref}")
            streams[use_kernel] = toks.tolist()
            log(f"  {arch} ({cfg.n_layers} layers) fp32 use_kernel="
                f"{use_kernel}: streams {streams[use_kernel]} (MAC launches "
                f"{n_mac}, plain MAC calls {n_ref})")
        _reset_counts()
        stats = {}
        with _exact_plain_mac(torch):
            exact = greedy_generate(models[True], params, batch, 4,
                                    max_len=max_len, stats=stats).tolist()
        counted, plain, _ = _read_counts()
        _check_generate_stats(stats, 4, f"{arch}, the exact plain MAC")
        check(counted["crossbar_mac"] == 0
              and plain["crossbar_mac_codes_ref"] > 0,
              f"{arch}: the exact plain MAC's run launched "
              f"{counted['crossbar_mac']} kernels, "
              f"{plain['crossbar_mac_codes_ref']} exact reads")
        log(f"  {arch}: the exact plain MAC's streams {exact} "
            f"({plain['crossbar_mac_codes_ref']} reads)")
        check(exact == streams[True],
              f"{arch}: the MAC kernel's streams {streams[True]} differ "
              f"from its exact plain version's {exact}")
        out[arch] = {"layers": base.n_layers, "streams": streams[True]}
        if False in streams:
            equal = streams[False] == streams[True]
            out[arch].update(
                plain_streams=streams[False], streams_equal=equal,
                agreement=_agreement(dict(enumerate(streams[False])),
                                     dict(enumerate(streams[True]))))
            if not equal:
                out[arch]["divergence"] = _explain_divergence(
                    torch, dev, models, params, batch, streams, max_len)
        del models, model, params, batch
        gc.collect()
        torch.cuda.empty_cache()
        out[arch]["seconds"] = time.perf_counter() - t_arch
        log(f"  {arch}: the kernel's streams equal the exact plain MAC's"
            + (f"; the engine's plain path's "
               f"{'equal' if out[arch]['streams_equal'] else 'part'}"
               if False in streams else "")
            + f" ({out[arch]['seconds']:.1f} s)")
    for arch, layers in (("rwkv6-3b", 2), ("zamba2-1.2b", 7)):
        t_arch = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype=torch.float32)
        model = build_model(cfg, device=dev)
        params = model.init(0)
        gen = torch.Generator()
        gen.manual_seed(5)
        toks = torch.randint(0, cfg.vocab - 1, (2, 16), generator=gen,
                             dtype=torch.int32)
        stats = {}
        got = greedy_generate(model, params, {"tokens": toks.to(dev)}, 4,
                              stats=stats)
        _check_generate_stats(stats, 4, arch)
        want = greedy_generate(build_model(cfg, device="cpu"),
                               _to(params, "cpu"), {"tokens": toks}, 4)
        check(got.cpu().tolist() == want.tolist(),
              f"{arch}: the card's streams {got.tolist()} differ from the "
              f"CPU's {want.tolist()}")
        out[arch] = {"layers": layers, "streams": want.tolist(),
                     "seconds": time.perf_counter() - t_arch}
        log(f"  {arch} ({layers} layers) fp32: the card's streams equal "
            f"the CPU's {want.tolist()} ({out[arch]['seconds']:.1f} s)")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _gla_at_serve_shapes(torch, dev, cfg):
    """``chunked_gla`` against ``naive_gla`` on random inputs of the
    recurrent serve's shapes (B 4, 512 positions, its heads and chunk;
    RWKV6's decays and ``u``, Mamba2's per-head decays); returns the
    error over max(1, max|naive|) of the outputs and the final state."""
    import math

    from repro_torch.models import lin_attn

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    b, s = FAMILY_B, 512
    if cfg.family == "rwkv6":
        rc = cfg.rwkv
        h, dk, dv, chunk = rc.n_heads, rc.head_dim, rc.head_dim, rc.chunk
        log_w = -torch.exp(rand(b, s, h, dk) * 6 - 6.5)
        u = randn(h, dk, scale=0.3)
        k = randn(b, s, h, dk, scale=0.1)
        v = randn(b, s, h, dv)
    else:
        mc = cfg.mamba
        h, dk, dv, chunk = mc.n_heads, mc.d_state, mc.head_dim, mc.chunk
        dt = torch.exp((rand(b, s, h) - 1) * math.log(1000))
        a = torch.exp(rand(h) * math.log(16))
        log_w = (-a * dt)[..., None].expand(b, s, h, dk)
        u = None
        k = randn(b, s, h, dk)
        v = randn(b, s, h, dv) * dt[..., None]
    q = randn(b, s, h, dk)
    y, st = lin_attn.chunked_gla(q, k, v, log_w, u, chunk=chunk)
    ny, nst = lin_attn.naive_gla(q, k, v, log_w, u)
    return [((got - want).abs().max() / want.abs().max().clamp(
        min=1.0)).item() for got, want in ((y, ny), (st, nst))]


def phase_family_serves(torch, dev):
    """``FAMILY_SERVES`` through ``greedy_generate`` at bfloat16, B 4, each
    on a new model: whisper-base at full depth (1500 random frames, a
    4-token prompt, 64 new) and qwen2-vl-72b at full width and 2 layers,
    crossbar with the kernels (every MAC read on the kernel, no plain
    version); rwkv6-3b and zamba2-1.2b at full depth, digital, 512-token
    prompts and 32 new, with ``chunked_gla`` held against ``naive_gla``
    at the serve's shapes.  Each serve runs captured (the decode loop
    replayed from one CUDA graph), then eagerly (``capture=False``, the
    witness) on the same model and batch: the streams must be equal bit
    for bit, the captured call must capture once and serve every decode
    step after the warm-up from the graph, and a crossbar serve must
    launch the MAC kernel (its replays included) with no plain MAC call.
    Each logs, captured and eager, the prefill ms, the decode step ms
    (captured: the wall less the prefill over the steps; eager: the
    median step), tokens/s and peak memory, and the programming s; and a
    replay's ms, the median of a third, captured call of half the steps
    whose loop runs are timed between syncs (its tokens the first half
    of the full call's).  Every step's logits must
    be finite and every token inside the padded vocab."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    out = {}
    for arch, layers, backend, kw, new, max_len in FAMILY_SERVES:
        t_arch = time.perf_counter()
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=layers or base.n_layers,
                                  backend=backend)
        if backend == "crossbar":
            cfg = dataclasses.replace(cfg, xbar=dataclasses.replace(
                cfg.xbar, use_kernel=True))
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated(dev) < 1 << 30,
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still "
              f"allocated before the {arch} serve")
        model = build_model(cfg, device=dev)
        params = model.init(0)
        program_s = 0.0
        if backend == "crossbar":
            t0 = time.perf_counter()
            model.executor.program_params(params)
            torch.cuda.synchronize()
            program_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        batch = _family_batch(torch, dev, cfg, FAMILY_B, gen, **kw)
        runs = {}
        for capture in (True, False):
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_counts()
            toks, prefill_ms, step_ms, wall, finite, stats = \
                _timed_generate(torch, model, params, batch, new, max_len,
                                capture=capture)
            counted, plain, _ = _read_counts()
            what = f"{arch} ({'captured' if capture else 'eager'})"
            check(finite, f"{what}: non-finite logits")
            check(tuple(toks.shape) == (FAMILY_B, new)
                  and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
                  f"{what}: tokens {tuple(toks.shape)} outside the padded "
                  f"vocab")
            if capture:
                _check_generate_stats(stats, new, what)
            launches = _executed(counted, {"generate": stats})
            if backend == "crossbar":
                check(launches["crossbar_mac"] > 0
                      and all(v == 0 for v in plain.values()),
                      f"{what}: MAC launches {launches['crossbar_mac']}, "
                      f"plain versions {plain}")
            runs[capture] = {
                "prefill_ms": prefill_ms,
                "decode_step_ms": statistics.median(step_ms),
                "tok_per_s": FAMILY_B * new / wall, "seconds": wall,
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                "launches": launches, "plain_calls": plain,
                "generate_stats": stats, "streams": toks.tolist()}
        check(runs[True]["streams"] == runs[False]["streams"],
              f"{arch}: the captured streams differ from the eager ones")
        # a replay's ms: a captured call of half the steps, each run of
        # its loop timed between syncs (outside the capture)
        half = new // 2
        toks, _, replay_ms, _, _, _ = _timed_generate(
            torch, model, params, batch, half, max_len, replays=True)
        check(toks.tolist() == [r[:half] for r in runs[True]["streams"]],
              f"{arch}: {half} captured tokens are not the first of {new}")
        runs[True]["replay_ms"] = statistics.median(replay_ms)
        row = {"layers": cfg.n_layers, "backend": backend, "b": FAMILY_B,
               "prompt": kw, "new": new, "max_len": max_len,
               "program_s": program_s, **runs[True],
               "eager": {k: v for k, v in runs[False].items()
                         if k != "streams"}}
        if backend == "digital":
            row["gla_err"] = _gla_at_serve_shapes(torch, dev, cfg)
            check(max(row["gla_err"]) <= GLA_SERVE_BOUND,
                  f"{arch}: chunked_gla against naive_gla {row['gla_err']} "
                  f"> {GLA_SERVE_BOUND:.2e} of the largest magnitude")
        del model, params, batch
        row["phase_s"] = time.perf_counter() - t_arch
        ev = row["eager"]
        per_replay = row["generate_stats"]["launches_per_replay"].get(
            "crossbar_mac", 0)
        log(f"  {arch} ({cfg.n_layers} layers, {backend}, bf16, B "
            f"{FAMILY_B}, {kw}, {new} new), captured vs eager: prefill "
            f"{row['prefill_ms']:.2f} / {ev['prefill_ms']:.2f} ms, decode "
            f"step {row['decode_step_ms']:.3f} / {ev['decode_step_ms']:.3f}"
            f" ms (a replay {row['replay_ms']:.3f} ms, the median of a "
            f"captured call of {new // 2}), {row['tok_per_s']:.2f} / "
            f"{ev['tok_per_s']:.2f} tok/s, "
            f"peak {row['max_memory_allocated'] / 2**30:.2f} / "
            f"{ev['max_memory_allocated'] / 2**30:.2f} GiB; streams equal; "
            f"{row['generate_stats']['replays']} replays; programming "
            f"{program_s:.2f} s; MAC launches "
            f"{row['launches'].get('crossbar_mac', 0)} (per replay "
            f"{per_replay})"
            + (f"; chunked_gla vs naive at the serve's shapes: y "
               f"{row['gla_err'][0]:.2e}, state {row['gla_err'][1]:.2e} of "
               f"the largest magnitude" if "gla_err" in row else "")
            + f"; {row['phase_s']:.1f} s")
        out[arch] = row
    return out


MUX_ARGV = ["--arch", ARCH, "--layers", "8", "--backend", "crossbar",
            "--use-kernel", "--kv", "paged", "--requests", "8", "--slots",
            "4", "--prompt-len", "16", "--max-new", "16", "--max-len", "64",
            "--chunk", "4", "--multiplex", "init,seed:1", "--qos", "2,1",
            "--stack-planes", "2", "--kv-pages", "16"]
#: the swap of B begins after this many steps (A's warm-up, its capture
#: and 4 replays before the window), 256 chunks a step: 1,684 chunks (8 x
#: 208 + 20) make 6 window steps and the flip
MUX_SWAP_AT, MUX_CHUNKS, MUX_TOTAL_CHUNKS = 6, 256, 1684
#: the memory an in-place swap at 8 layers was reckoned to peak at (GB)
MUX_RECKONED_GB = (50, 62)


class _TimedStep:
    """A lane's window step, timed: for each call the host ms (ending in
    a sync), whether it replayed, captured or ran eagerly, and the step
    it belongs to; every other attribute is the step's own."""

    def __init__(self, step, tenant, rec, clock):
        self._step, self._tenant = step, tenant
        self._rec, self._clock = rec, clock

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self, *args):
        import torch

        stats = self._step.stats
        before = (stats["captures"], stats["replays"])
        t0 = time.perf_counter()
        out = self._step(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        kind = ("capture" if stats["captures"] > before[0] else
                "replay" if stats["replays"] > before[1] else "eager")
        self._rec.append({"tenant": self._tenant, "kind": kind, "ms": ms,
                          "step": self._clock["step"]})
        return out


def _mux_drive(st, dev, swap=None, capture=None):
    """A serve of ``st``'s requests on its model, whose tenants are
    resident (``launch/serve.drive``), each lane's step timed; with
    ``swap``, a hot-swap of tenant B onto it begins after
    ``MUX_SWAP_AT`` steps.  Returns what ``launch/serve.main`` returns,
    plus the lanes' timings."""
    from repro_torch.launch import serve

    sched = st.scheduler(capture)
    rec, clock = [], {"step": 0}
    for t, lane in sched._lanes.items():
        lane.decode = _TimedStep(lane.decode, t, rec, clock)

    def on_step(n):
        clock["step"] = n
        if swap is not None and n == MUX_SWAP_AT:
            sched.begin_hot_swap(swap, chunks_per_step=MUX_CHUNKS,
                                 tenant="B")

    rep = serve.drive(sched, st.requests(), dev, on_step=on_step)
    ex = st.model.executor
    caps = sched.capture_report()
    rep.update(program_s=0.0, capture=caps["A"], captures=caps,
               swap_history=list(sched.swap_history),
               version=ex.version(), lane_ms=rec,
               versions={t: ex.version(t) for t in sched.tenants},
               qos=sched.qos_report(), kv=sched.kv_report())
    return rep


def _by_tenant(sv, tenant):
    return {r: s for r, s in sv["streams"].items()
            if sv["tenant_of"][r] == tenant}


def _most_in_flight(sv, tenant):
    """The most requests of ``tenant`` admitted and unfinished at once."""
    spans = [sv["in_flight"][r] for r in sv["streams"]
             if sv["tenant_of"][r] == tenant]
    return max(sum(a <= t < b for a, b in spans) for t, _ in spans)


def _tenant_tok_per_s(sv, tenant):
    """A tenant's tokens over the wall time from its first admission to
    its last completion (scheduler clock)."""
    rids = [r for r in sv["streams"] if sv["tenant_of"][r] == tenant]
    span = (max(sv["in_flight"][r][1] for r in rids)
            - min(sv["in_flight"][r][0] for r in rids))
    return sum(len(sv["streams"][r]) for r in rids) / span


def _lane_windows(sv, tenant="A"):
    """Tenant's replay ms before B's window, inside it and after the
    flip, from the timed lane steps."""
    phase = sv["swap_phase"]
    first, flip = phase.index("window"), phase.index("flip")
    check(phase[first:flip] == ["window"] * (flip - first)
          and "window" not in phase[flip:],
          f"the swap window is not one run of steps: {phase}")
    out = {"before_ms": [], "window_ms": [], "after_ms": []}
    for r in sv["lane_ms"]:
        if r["tenant"] != tenant or r["kind"] != "replay":
            continue
        key = ("before_ms" if r["step"] < first else
               "window_ms" if r["step"] < flip else "after_ms")
        out[key].append(r["ms"])
    out.update(first_window_step=first, flip_step=flip,
               window_steps=flip - first)
    return out


def phase_multiplex(torch, dev):
    """Two tenants from one plane bank at full width, 8 layers: the CLI's
    multiplexed serve, captured; then on one model, programmed once, the
    serve without a swap captured and eager (equal streams per tenant),
    with an in-place swap of B onto its own checkpoint (B's streams, A's
    streams, A one capture and B two), after ``evict_tenant("B")`` and a
    live redeploy of B's checkpoint (the same streams), and with an
    in-place swap of B onto ``finetune_delta(B, 0.02)`` (A's streams; the
    timed window and peak memory); last a dedicated single-tenant serve
    of B's checkpoint on B's requests (B's streams)."""
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import BatchScheduler, Request
    from repro_torch.serve.hotswap import finetune_delta

    must = ["crossbar_mac", "paged_attention_scratch"]
    t_phase = time.perf_counter()
    out = {"argv": MUX_ARGV}
    log(f"  {' '.join(MUX_ARGV)}; captured, through the CLI")
    cli = out["cli"] = phase_serve(torch, dev, MUX_ARGV, must)
    check(cli["versions"] == {"A": 1, "B": 1}
          and cli["kv"]["A"]["budget"] == 21 and cli["kv"]["B"]["budget"]
          == 11 and cli["qos"]["A"]["slots"] == 5
          and cli["qos"]["B"]["slots"] == 3,
          f"multiplex split: versions {cli['versions']}, qos {cli['qos']}")
    check(_most_in_flight(cli, "A") == 4 and _most_in_flight(cli, "B") == 2,
          f"in flight at once: A {_most_in_flight(cli, 'A')}, B "
          f"{_most_in_flight(cli, 'B')} (want 4 and 2: B's page budget "
          f"binds)")
    log("  one programmed model: no swap captured and eager, an in-place "
        "swap of B onto its own checkpoint, evict + redeploy B, an "
        "in-place swap of B onto ft:0.02")
    gc.collect()
    torch.cuda.empty_cache()
    st = serve.setup(MUX_ARGV)
    ex = st.model.executor
    params_b = st.tenants["B"][0]
    t0 = time.perf_counter()
    for t, (params, _) in sorted(st.tenants.items()):
        ex.program_params(params, tenant=t)
    torch.cuda.synchronize()
    out["program_s"] = time.perf_counter() - t0
    base = out["no_swap"] = phase_serve(
        torch, dev, MUX_ARGV, must, run=lambda: _mux_drive(st, dev))
    check(base["streams"] == cli["streams"],
          "the programmed model's streams differ from the CLI's")
    eager = out["eager"] = phase_serve(
        torch, dev, MUX_ARGV, must, capture=False,
        run=lambda: _mux_drive(st, dev, capture=False))
    for t in "AB":
        check(_by_tenant(eager, t) == _by_tenant(base, t),
              f"tenant {t}: captured and eager streams differ")
    two = {"A": 1, "B": 2}
    init = out["init_b"] = phase_serve(
        torch, dev, MUX_ARGV, must, closures=two,
        run=lambda: _mux_drive(st, dev, swap=params_b))
    check(init["streams"] == base["streams"],
          "in-place swap of B onto its own checkpoint: streams differ "
          "from the serve without a swap")
    check(init["versions"] == {"A": 1, "B": 2},
          f"versions after B's swap {init['versions']}")
    ex.evict_tenant("B")
    check(ex.tenants == ["A"], f"resident after eviction: {ex.tenants}")
    t0 = time.perf_counter()
    stats = ex.swap(params_b, chunk_burst=MUX_CHUNKS, tenant="B")
    torch.cuda.synchronize()
    out["redeploy_s"] = time.perf_counter() - t0
    check(stats["swap_mode"] == "staged" and ex.tenants == ["A", "B"],
          f"live redeploy of B: {stats}")
    redeploy = out["redeploy_b"] = phase_serve(
        torch, dev, MUX_ARGV, must, run=lambda: _mux_drive(st, dev))
    check(redeploy["streams"] == base["streams"],
          "evict + redeploy of B: streams differ from the serve without "
          "a swap")
    ft = finetune_delta(params_b, 0.02)
    torch.cuda.synchronize()
    swap = out["ft_b"] = phase_serve(
        torch, dev, MUX_ARGV, must, closures=two,
        run=lambda: _mux_drive(st, dev, swap=ft))
    del ft
    check(_by_tenant(swap, "A") == _by_tenant(base, "A"),
          "A's streams under B's in-place swap differ from no swap")
    check(swap["versions"] == {"A": 1, "B": 4},
          f"versions after evict, redeploy and B's ft swap "
          f"{swap['versions']}")
    for key, sv in (("init_b", init), ("ft_b", swap)):
        (h,) = sv["swap_history"]
        check(h["tenant"] == "B" and h["swap_mode"] == "in_place"
              and h["policy"] == "overlapped"
              and h["n_chunks"] == MUX_TOTAL_CHUNKS,
              f"{key}: swap report {h}")
        w = sv["lanes"] = _lane_windows(sv)
        check(w["window_steps"] == 6 and h["decode_steps_during_swap"]
              == 6 and len(w["before_ms"]) >= 3 and len(w["window_ms"])
              == 6 and len(w["after_ms"]) >= 3,
              f"{key}: A's replays around B's window {w}")
        med = {k: statistics.median(w[k]) for k in
               ("before_ms", "window_ms", "after_ms")}
        sv["a_replay_median_ms"] = med
        wb = _lane_windows(sv, "B")
        check(not wb["window_ms"], f"{key}: B replayed inside its window")
        sv["b_replay_median_ms"] = {k: statistics.median(wb[k]) for k in
                                    ("before_ms", "after_ms")}
        lpr = {t: c["launches_per_replay"].get("crossbar_mac", 0)
               for t, c in sv["captures"].items()}
        log(f"  {key}: {h['n_chunks']} chunks in {w['window_steps']} "
            f"window steps, window {h['wall_swap_s']:.3f} s wall; A's "
            f"replay ms median before {med['before_ms']:.2f}, in B's "
            f"window {med['window_ms']:.2f}, after {med['after_ms']:.2f} "
            f"(B's before {sv['b_replay_median_ms']['before_ms']:.2f}, "
            f"after {sv['b_replay_median_ms']['after_ms']:.2f}); captures "
            f"{ {t: c['captures'] for t, c in sv['captures'].items()} }, "
            f"replays { {t: c['replays'] for t, c in sv['captures'].items()} }"
            f"; MAC launches per replay {lpr}; max_memory_allocated "
            f"{sv['max_memory_allocated'] / 1e9:.2f} GB (reckoned "
            f"{MUX_RECKONED_GB[0]}-{MUX_RECKONED_GB[1]} GB)")
    for key in ("cli", "no_swap", "eager", "init_b", "redeploy_b", "ft_b"):
        sv = out[key]
        sv["tok_per_s_by_tenant"] = {t: _tenant_tok_per_s(sv, t)
                                     for t in "AB"}
        log(f"  {key}: tokens/s by tenant over its own span, A "
            f"{sv['tok_per_s_by_tenant']['A']:.2f}, B "
            f"{sv['tok_per_s_by_tenant']['B']:.2f}")
    log("  a dedicated single-tenant serve of B's checkpoint on B's "
        "requests")
    ded = build_model(st.model.cfg, device=dev)
    t0 = time.perf_counter()
    ded.executor.program_params(params_b)
    torch.cuda.synchronize()
    out["dedicated_program_s"] = time.perf_counter() - t0
    a = st.args
    sched = BatchScheduler(ded, params_b, n_slots=a.slots,
                           max_len=a.max_len, kv=a.kv,
                           page_size=a.page_size, chunk=a.chunk)
    reqs = [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in st.requests() if r.model_id == "B"]
    rep = serve.drive(sched, reqs, dev)
    got = {r.rid: list(r.out) for r in rep["requests"]}
    check(got == _by_tenant(base, "B"),
          "B's multiplexed streams differ from a dedicated serve of B")
    out["dedicated_b"] = {"tok_per_s": rep["tok_per_s"],
                          "steps": rep["steps"], "seconds": rep["seconds"]}
    del sched, ded, st, ex, params_b
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  multiplex phase: {out['seconds']:.1f} s (programming two "
        f"tenants {out['program_s']:.2f} s, redeploying B "
        f"{out['redeploy_s']:.2f} s, programming the dedicated B "
        f"{out['dedicated_program_s']:.2f} s)")
    for key in ("cli", "no_swap", "eager", "init_b", "redeploy_b", "ft_b"):
        out[key].pop("lane_ms", None)
    return out


# -- the train phase: the trainer, card against CPU, resume, deploy -----------

#: the trainer's cell: qwen3-4b FULL cut to 8 of its 36 layers (36 need
#: ~88 GB of float32 masters, moments, bf16 copy and grads), bf16
#: compute, 4 x 512 tokens in 2 microbatches, 12 steps at a peak lr of
#: 1e-4 (the CLI's default 1e-3 is sized for SMOKE models: at this
#: width the loss ends above where it began)
TRAIN_ARGV = ["--arch", ARCH, "--layers", "8", "--steps", "12",
              "--seq-len", "512", "--batch", "4", "--microbatches", "2",
              "--lr", "1e-4", "--log-every", "100"]
#: card against CPU (float32 compute, TF32 off): each step's loss within
#: TRAIN_LOSS_RTOL x |loss|, the final params within TRAIN_PARAM_RTOL x
#: max|p| of each leaf (AdamW's m / sqrt(v) turns a last-bit difference
#: of a gradient near zero into a step of up to lr)
TRAIN_PARITY = (("qwen3-4b", 8), ("phi3.5-moe", 8))
TRAIN_LOSS_RTOL = 2.0 ** -16
TRAIN_PARAM_RTOL = 2.0 ** -8
#: the resume check: 2k steps against k, save, restore_or_init, k more
RESUME_K = 4
SERVE_EXAMPLES = ("serve_batch", "hotswap_deploy", "multiplex_serve",
                  "planebank_serve")


def _example(name):
    """``examples/torch_<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_run(torch, capture):
    """``launch/train.py``'s ``main`` at ``TRAIN_ARGV`` on the card:
    (the per-step records, the final state, peak allocated and peak
    reserved GiB above what was held before the run, wall s)."""
    from repro_torch.launch import train as train_cli
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    rec = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_cli.main(TRAIN_ARGV, record=rec, capture=capture)
    wall = time.perf_counter() - t0
    return (rec, state,
            (torch.cuda.max_memory_allocated() - held[0]) / 2 ** 30,
            (torch.cuda.max_memory_reserved() - held[1]) / 2 ** 30, wall)


def _train_full_width(torch):
    """(1) ``launch/train.py``'s ``main`` at ``TRAIN_ARGV`` on the card,
    captured (one capture, then replays), then eager (``capture=False``,
    the witness), both under deterministic algorithms (``_resume``): every
    loss, grad norm and leaf of the final state bit for bit."""
    from repro_torch import tree
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        rec, state, peak, reserved, wall = _train_run(torch, None)
        n_params = sum(p.numel() for p in tree.leaves(state.params))
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree.leaves(state))
        erec, estate, epeak, ereserved, ewall = _train_run(torch, False)
    finally:
        torch.use_deterministic_algorithms(False)
    differ = [key for (key, a), b in zip(tree.leaves_with_keys(state),
                                         tree.leaves(estate))
              if not torch.equal(a, b)]
    del state, estate
    gc.collect()
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in rec]
    norms = [r["grad_norm"] for r in rec]
    log(f"  (1) losses {[round(v, 4) for v in losses]}")
    check(len(rec) == 12 and all(math.isfinite(v) for v in losses + norms),
          f"train: losses {losses}, grad norms {norms}")
    check(losses[-1] < losses[0],
          f"train: the last loss {losses[-1]} is not below the first "
          f"{losses[0]}")
    last = rec[-1]
    check((last.get("captures"), last.get("eager_steps"),
           last.get("replays")) == (1, 1, 11),
          f"train: the captured run's step stats {last}")
    check("captures" not in erec[-1], "train: the witness was captured")
    check(losses == [r["loss"] for r in erec]
          and norms == [r["grad_norm"] for r in erec] and not differ,
          f"train: captured against eager: losses {losses} vs "
          f"{[r['loss'] for r in erec]}, leaves {differ[:4]} differ")
    tokens = 4 * 512
    out = {"argv": TRAIN_ARGV, "n_params": n_params,
           "state_gib": state_bytes / 2 ** 30,
           "loss_first": losses[0], "loss_last": losses[-1],
           "grad_norm_first": norms[0], "grad_norm_last": norms[-1],
           "losses": losses, "bitwise_eager": True}
    for key, r, pk, rs, w in (("captured", rec, peak, reserved, wall),
                              ("eager", erec, epeak, ereserved, ewall)):
        ms = statistics.median(x["s"] for x in r[2:]) * 1e3
        out[key] = {"step_ms": ms, "first_step_ms": r[0]["s"] * 1e3,
                    "second_step_ms": r[1]["s"] * 1e3,
                    "tok_per_s": tokens / (ms / 1e3), "peak_gib": pk,
                    "reserved_gib": rs, "wall_s": w}
    c, e = out["captured"], out["eager"]
    log(f"  (1) qwen3-4b 8 layers, {n_params / 1e9:.3f} B params, "
        f"deterministic algorithms: captured step {c['step_ms']:.1f} ms "
        f"(median of steps 3-12, replays; step 1 {c['first_step_ms']:.0f} "
        f"ms, step 2 with the capture {c['second_step_ms']:.0f} ms), "
        f"{c['tok_per_s']:.0f} tokens/s, peak {c['peak_gib']:.2f} GiB, "
        f"reserved {c['reserved_gib']:.2f}; eager {e['step_ms']:.1f} ms, "
        f"{e['tok_per_s']:.0f} tokens/s, peak {e['peak_gib']:.2f}, "
        f"reserved {e['reserved_gib']:.2f}; state {out['state_gib']:.2f} "
        f"GiB; losses, grad norms and the final state bitwise; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad norm {norms[0]:.3f} "
        f"-> {norms[-1]:.3f}")
    return out


def _device_window(evs):
    """Device busy ms, window ms and idle share over a list of the card's
    events, and the kernels with the most device time."""
    lo = min(float(e["ts"]) for e in evs)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in evs)
    busy, end, by_name = 0.0, lo, {}
    for e in evs:
        a, b = max(float(e["ts"]), end), float(e["ts"]) + float(e["dur"])
        if b > a:
            busy += b - a
            end = b
        name = e["name"].replace("void ", "").replace("at::native::", "")
        name = name.replace("(anonymous namespace)::", "")[:160]
        by_name[name] = by_name.get(name, 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy_ms": busy / 1e3, "window_ms": (hi - lo) / 1e3,
            "idle_share": 1.0 - busy / (hi - lo), "events": len(evs),
            "top_ms": {k: us / 1e3 for k, us in top}}


def phase_train_trace(torch, dev, out_dir, replays=3):
    """``TRAIN_ARGV``'s step under the default algorithms: one eager step
    (``capture=False``) and ``replays`` replays of the captured step,
    each timed between syncs (CUDA events) and then traced on the card
    (``torch.profiler``): the device's idle share, its events per step,
    the kernels with the most device time.  Run last: a trace slows the
    phases after it."""
    import dataclasses as dc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dc.replace(get_config(ARCH), n_layers=8)
    model = build_model(cfg, device=dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=513,
                                  global_batch=4), device=dev)
    ocfg = opt.AdamWConfig(lr=1e-4, warmup_steps=10, total_steps=12)
    steps = {c: trainer.make_train_step(model, ocfg, microbatches=2,
                                        donate=True, capture=c)
             for c in (False, True)}
    state = trainer.init_state(model, 0)
    batch = data.batch_at(0)

    def timed(fn, n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        for i in range(n):
            fn()
            ev[i + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]

    out = {}
    for key, n in (("eager", 1), ("captured", replays)):
        step = steps[key == "captured"]
        if key == "captured":
            step(state, batch)                 # the warm-up
            step(state, batch)                 # the capture, one replay
            fn = step.graph.replay
        else:
            step(state, batch)                 # kernels and cache warm
            fn = lambda: step(state, batch)    # noqa: E731
        ms = timed(fn, n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = _device_events(torch, prof, out_dir)
        check(len(evs) > 0, f"train trace: no device events ({key})")
        win = _device_window(evs)
        out[key] = dict(win, ms=ms, steps=n,
                        events_per_step=win["events"] / n)
    cap = steps[True]
    out["captured"].update(captures=cap.stats["captures"],
                           launches_per_replay=cap.launches_per_replay)
    check(cap.stats["captures"] == 1, f"train trace: {cap.report()}")
    cap.reset()
    del steps, cap, state, model
    gc.collect()
    torch.cuda.empty_cache()
    e, c = out["eager"], out["captured"]
    log(f"  train trace (default algorithms): eager step {e['ms'][0]:.1f} "
        f"ms, {e['events_per_step']:.0f} device events, device idle "
        f"{100 * e['idle_share']:.1f}% of {e['window_ms']:.1f} ms; replays "
        f"{', '.join(f'{v:.1f}' for v in c['ms'])} ms, "
        f"{c['events_per_step']:.0f} device events each, idle "
        f"{100 * c['idle_share']:.1f}% of {c['window_ms']:.1f} ms; "
        f"{c['captures']} capture, the port's kernel launches per replay "
        f"{c['launches_per_replay'] or 'none'}")
    for key in ("eager", "captured"):
        log(f"    {key}, device ms per step by kernel: " + "; ".join(
            f"{k[:110]} {v / out[key]['steps']:.2f}"
            for k, v in out[key]["top_ms"].items()))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _card_against_cpu(torch, dev):
    """(2) SMOKE qwen3-4b and phi3.5-moe, float32 compute, the same
    params and batches on the card and on the CPU."""
    import dataclasses as dc

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    out = {}
    for arch, steps in TRAIN_PARITY:
        cfg = dc.replace(get_config(arch, smoke=True), dtype=torch.float32)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=33,
                                      global_batch=8), device="cpu")
        runs = {}
        for where in ("cpu", dev):           # the card's step captured
            model = build_model(cfg, device=where)
            step = trainer.make_train_step(
                model, opt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=steps),
                compute_dtype=torch.float32, donate=True)
            state = trainer.init_state(build_model(cfg, device="cpu"), 0)
            state = tree.map(lambda t: t.to(where), state)
            losses = []
            for i in range(steps):
                batch = {k: v.to(where) for k, v in data.batch_at(i).items()}
                state, met = step(state, batch)
                losses.append(float(met["loss"]))
            if where != "cpu":
                check(step.stats["captures"] == 1,
                      f"train {arch}: the card's step {step.report()}")
            runs[str(where)] = (losses, tree.map(lambda t: t.cpu(),
                                                 state.params))
        (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        param_rel = max(float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)) for a, b in zip(tree.leaves(pg), tree.leaves(pc)))
        check(loss_rel <= TRAIN_LOSS_RTOL and param_rel <= TRAIN_PARAM_RTOL,
              f"train {arch}: card against CPU, loss rel {loss_rel:.3g}, "
              f"params rel {param_rel:.3g}")
        out[arch] = {"loss_rel": loss_rel, "param_rel": param_rel,
                     "losses": lg}
        log(f"  (2) {arch} SMOKE float32, {steps} steps: card against CPU, "
            f"losses within {loss_rel:.3g} "
            f"(2^{math.log2(loss_rel or 2**-60):.1f}), "
            f"params within {param_rel:.3g} x max|p| "
            f"(2^{math.log2(param_rel or 2**-60):.1f})")
    return out


def _resume(torch):
    """(3) deterministic algorithms on: 2k uninterrupted steps against k,
    save, ``restore_or_init``, k more, through ``launch/train.py``; keep-K
    and the GC of a stale ``.tmp`` in the phase's own directory.  The
    accumulating ``index_put_`` of the embedding's backward takes its
    deterministic kernel; cuBLAS only warns (its determinism wants
    ``CUBLAS_WORKSPACE_CONFIG`` set before it loads, which would change
    every other phase's workspace; one stream and the same shapes pick
    the same products here), and the check holds the result."""
    import tempfile

    from repro_torch import tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as train_cli
    k = RESUME_K
    base = ["--smoke", "--seq-len", "64", "--batch", "8", "--ckpt-every",
            "1", "--log-every", "100"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(io.StringIO()) as said:
            whole = train_cli.main(base + ["--steps", str(2 * k)])
            ckpt = str(Path(tmp) / "ckpt")
            train_cli.main(base + ["--steps", str(k), "--ckpt-dir", ckpt])
            stale = Path(ckpt) / "step_000000999.tmp"
            stale.mkdir()
            resumed = train_cli.main(base + ["--steps", str(2 * k),
                                             "--ckpt-dir", ckpt])
            steps_left = CheckpointManager(ckpt).all_steps()
            stale_gone = not stale.exists()
    finally:
        torch.use_deterministic_algorithms(False)
    differ = [key for (key, a), b in zip(tree.leaves_with_keys(resumed),
                                         tree.leaves(whole))
              if not torch.equal(a, b)]
    check(f"[resume] from step {k}" in said.getvalue() and not differ,
          f"resume: leaves {differ[:4]} differ from the uninterrupted run")
    check(steps_left == [2 * k - 2, 2 * k - 1, 2 * k] and stale_gone,
          f"resume: checkpoints {steps_left}, stale .tmp gone {stale_gone}")
    log(f"  (3) resume at step {k} of {2 * k}: every leaf of the final "
        f"TrainState equals the uninterrupted run's; kept steps "
        f"{steps_left}, the stale .tmp collected")
    return {"k": k, "kept": steps_left}


def _deploy_and_examples(torch, dev):
    """(4) ``torch_crossstack_deploy.py``'s reads on the MAC kernel, each
    bit for bit the exact plain MAC's, and the four serve examples."""
    deploy = _example("crossstack_deploy")
    with contextlib.redirect_stdout(io.StringIO()):
        model, data, params, digital = deploy.train(dev)
    _reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        got = deploy.deploy(model, data, params)
    torch.cuda.synchronize()
    counted, plain, _ = _read_counts()
    n_reads = len(got["reads"]) + got["n_resident"]
    check(counted["crossbar_mac"] == n_reads and not any(plain.values()),
          f"deploy: MAC launches {counted}, plain {plain}, reads {n_reads}")
    with _exact_plain_mac(torch), contextlib.redirect_stdout(io.StringIO()):
        exact = deploy.deploy(model, data, params)
    differ = [i for i, (a, b) in enumerate(zip(got["reads"], exact["reads"]))
              if not torch.equal(a, b)]
    check(not differ and torch.equal(got["logits_x"], exact["logits_x"])
          and got["sweep"] == exact["sweep"],
          f"deploy: reads {differ[:4]} (or the resident prefill) differ "
          f"from the exact plain MAC's")
    check(all(math.isfinite(v) for v in got["sweep"].values())
          and got["prefill_rel_dev"] < 0.1,
          f"deploy: sweep {got['sweep']}, prefill rel dev "
          f"{got['prefill_rel_dev']}")
    out = {"launches": counted["crossbar_mac"], "digital_loss": digital,
           "base_loss": got["base_loss"],
           "sweep": {f"{m}_{b}": v for (m, b), v in got["sweep"].items()},
           "prefill_rel_dev": got["prefill_rel_dev"]}
    log(f"  (4) deploy: {counted['crossbar_mac']} MAC launches "
        f"({len(got['reads'])} engine.linear reads, {got['n_resident']} "
        f"resident), each bit for bit the exact plain MAC's; held-out "
        f"loss {got['base_loss']:.4f}, w8 {got['sweep'][('deepnet', 8)]:.4f}"
        f", w2 {got['sweep'][('deepnet', 2)]:.4f}; prefill rel dev "
        f"{got['prefill_rel_dev']:.4f}")
    del model, params, got, exact
    out["examples_s"] = {}
    for name in SERVE_EXAMPLES:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = _example(name).main(dev)
        out["examples_s"][name] = time.perf_counter() - t0
        if "versions" in res:
            check(res["versions"]["B"] == 2, f"{name}: {res['versions']}")
        if "version" in res:
            check(res["version"] == 2, f"{name}: version {res['version']}")
    log("  (4) the serve examples ran: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["examples_s"].items()))
    return out


def phase_train(torch, dev):
    """The training slice on the card, (1)-(4) of the module docstring."""
    t_phase = time.perf_counter()
    out = {"full_width": _train_full_width(torch),
           "card_vs_cpu": _card_against_cpu(torch, dev),
           "resume": _resume(torch),
           "deploy": _deploy_and_examples(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  train phase: {out['phase_s']:.1f} s")
    return out


# -- phase 4c': distribution and the dry run --------------------------------

#: --mesh local at world 1 (NCCL) against the same steps without rules
DIST_TRAIN = ["--smoke", "--steps", "3", "--seq-len", "32", "--batch", "8",
              "--log-every", "100"]
#: the MoE block on the card: top_k 4 of 8 experts, float32, TF32 off
DIST_MOE = dict(b=4, s=64, d=256, f=512, e=8, k=4)
MOE_RTOL = 1e-5
#: the dry run's cells on the fake 16 x 16 mesh: qwen3-4b FULL at full
#: width; decode at all 36 layers, train cut to 1 to fit the phase's 30
#: s (a full-depth train cell runs 36 layers x 4 microbatches eagerly)
DIST_DRYRUN = (("decode_32k", None), ("train_4k", 1))


def _train_without_rules(torch, argv_steps=3):
    """``DIST_TRAIN``'s run on plain tensors on the card (no mesh, no
    rules): the trainer as ``launch/train.py`` builds it, captured."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    cfg = get_config("qwen3-4b", smoke=True)
    model = build_model(cfg)
    step = trainer.make_train_step(
        model, opt.AdamWConfig(lr=1e-3, warmup_steps=10,
                               total_steps=argv_steps), donate=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=33,
                                  global_batch=8), device=model.device)
    state, losses = trainer.init_state(model, 0), []
    for i in range(argv_steps):
        state, met = step(state, data.batch_at(i))
        losses.append(float(met["loss"]))
    check(step.stats["captures"] == 1,
          f"dist: the step without rules {step.report()}")
    step.reset()
    return losses, state


def _dist_collectives(torch, dev):
    """``compressed_psum`` and ``tp_bf16_matmul`` at world 1 (NCCL) on
    CUDA tensors, bitwise against their formulas (one rank: the
    all-reduce returns its input)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import optimizer as opt
    mesh = make_local_mesh()
    check(dist.get_backend() == "nccl" and mesh.device_type == "cuda",
          f"dist: --mesh local's group is {dist.get_backend()} on "
          f"{mesh.device_type}")
    try:
        gen = torch.Generator(device=dev).manual_seed(7)
        g = torch.randn(4096, device=dev, generator=gen)
        err = 0.01 * torch.randn(4096, device=dev, generator=gen)
        mean, new_err = opt.compressed_psum(g, None, err)
        q, scale = opt.quantize_grad_int8(g + err)
        deq = opt.dequantize_grad(q, scale)
        psum_ok = (torch.equal(mean, torch.div(deq, torch.ones(
            (), device=dev))) and torch.equal(new_err, (g + err) - deq))
        mm = init_device_mesh("cuda", (1, 1),
                              mesh_dim_names=("data", "model"))
        rules = shd.ShardingRules(rules=dict(shd.fsdp_rules().rules,
                                             _tp_bf16_reduce=True))
        h = torch.randn(8, 16, 2560, device=dev, generator=gen).to(
            torch.bfloat16)
        w = (torch.randn(2560, 1024, device=dev, generator=gen)
             / 50).to(torch.bfloat16)
        with shd.use_rules(rules, mm):
            y = shd.tp_bf16_matmul(h, w)
        want = torch.einsum("bsf,fd->bsd", h.float(), w.float()).to(
            torch.bfloat16)
        tp_ok = isinstance(y, torch.Tensor) and torch.equal(y, want)
    finally:
        dist.destroy_process_group()
    check(psum_ok, "dist: compressed_psum at world 1 differs from "
          "dequantize(quantize(g + err)) and its residual")
    check(tp_ok, "dist: tp_bf16_matmul at world 1 differs from the bf16 "
          "cast of the float32 product")
    log("  (b) compressed_psum (4,096 values) and tp_bf16_matmul (8 x 16 x "
        "2560 @ 2560 x 1024) at world 1 on NCCL: bitwise their formulas")
    return {"compressed_psum": psum_ok, "tp_bf16_matmul": tp_ok}


def _moe_top4(torch, dev):
    """The MoE block at top_k 4 on the card: two runs bitwise equal (the
    combine's fixed order), within ``MOE_RTOL`` x max|y| of the CPU's."""
    from repro_torch.models import layers as L
    c = DIST_MOE
    cfg = L.MoEConfig(c["e"], c["k"], 1.25, "swiglu")
    gen = torch.Generator().manual_seed(5)
    p = {"router": torch.randn(c["d"], c["e"], generator=gen) / 16,
         "wi": torch.randn(c["e"], c["d"], c["f"], generator=gen) / 16,
         "wg": torch.randn(c["e"], c["d"], c["f"], generator=gen) / 16,
         "wo": torch.randn(c["e"], c["f"], c["d"], generator=gen) / 22}
    x = torch.randn(c["b"], c["s"], c["d"], generator=gen)
    want, _ = L.moe_block(p, x, cfg)
    pd = {k: v.to(dev) for k, v in p.items()}
    runs = [L.moe_block(pd, x.to(dev), cfg)[0] for _ in range(2)]
    torch.cuda.synchronize()
    same = torch.equal(runs[0], runs[1])
    err = float((runs[0].cpu() - want).abs().max())
    lim = MOE_RTOL * float(want.abs().max())
    check(same and err <= lim,
          f"dist: MoE top_k 4 on the card: runs equal {same}, "
          f"max|err| {err:.3g} against {lim:.3g}")
    log(f"  (c) MoE top_k 4 of 8 on the card (B {c['b']} S {c['s']} d "
        f"{c['d']}, float32): two runs bitwise equal; max|err| against "
        f"the CPU {err:.3g} (limit {lim:.3g})")
    return {"bitwise_runs": same, "max_abs_err": err, "limit": lim}


def _dryrun_hand_count(torch):
    """The op record on this machine's torch against a hand count: a
    (8 x 16) @ (16 x 4) product split over "model" of a fake (2, 2) mesh,
    all-reduced: one all-reduce of 8 x 4 float32 values, 2 x 8 x 8 x 4
    flops on a rank (the sharding propagation's reruns not counted)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as hlo
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh((2, 2), ("data", "model"))
        with dryrun.fake_tensors():
            x = DTensor.from_local(torch.empty(8, 8), mesh,
                                   [Replicate(), Shard(1)], run_check=False,
                                   shape=(8, 16), stride=(16, 1))
            w = DTensor.from_local(torch.empty(8, 4), mesh,
                                   [Replicate(), Shard(0)], run_check=False,
                                   shape=(16, 4), stride=(4, 1))
            rec = hlo.OpRecord()
            with rec:
                (x @ w).redistribute(mesh, [Replicate(), Replicate()])
    colls = hlo.collective_bytes(rec)
    check(colls == {"all-reduce": {"bytes": 128.0, "count": 1}}
          and rec.flops == 512,
          f"dist: the op record's hand count: {colls}, {rec.flops} flops, "
          f"ops {dict(rec.ops)}")


def _dryrun_cells(torch, out_dir):
    """``dryrun.run_cell`` for qwen3-4b FULL on the fake 16 x 16 mesh;
    the card's allocated bytes must not move."""
    from repro_torch.launch import dryrun
    _dryrun_hand_count(torch)
    out = {}
    for shape, layers in DIST_DRYRUN:
        before = torch.cuda.memory_allocated()
        peak0 = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        res = dryrun.run_cell("qwen3-4b", shape, False,
                              str(out_dir / "dryrun"), extrapolate=False,
                              n_layers=layers)
        wall = time.perf_counter() - t0
        check(torch.cuda.memory_allocated() == before
              and torch.cuda.max_memory_allocated() == peak0,
              f"dist: the dry run of {shape} allocated on the card")
        m, coll = res["memory"], res["collective_bytes_total"]
        check(m["peak_bytes_per_device"] > 0 and res["cost"]["flops"] > 0
              and coll > 0, f"dist: dry run {shape}: {res['memory']}")
        out[shape] = {"n_layers": res["n_layers"], "wall_s": wall,
                      "peak_gib": m["peak_bytes_per_device"] / 2**30,
                      "flops": res["cost"]["flops"],
                      "bytes_accessed": res["cost"]["bytes_accessed"],
                      "collective_bytes": coll,
                      "collectives": res["collectives"],
                      "run_s": res["run_s"]}
        kinds = ", ".join(f"{k} {int(v['count'])}"
                          for k, v in res["collectives"].items())
        log(f"  (d) dry run qwen3-4b {shape}, 16x16 fake mesh, "
            f"{res['n_layers']} of 36 layers: per rank peak "
            f"{out[shape]['peak_gib']:.3f} GiB, flops "
            f"{res['cost']['flops']:.4g}, collectives "
            f"{coll / 2**20:.1f} MiB ({kinds}), wall {wall:.1f} s")
    return out


def phase_dist(torch, dev, out_dir):
    """The distribution slice on the card: (a) ``launch/train.py --mesh
    local`` at world 1 (NCCL) against the same steps without rules; (b)
    the two collectives at world 1; (c) the MoE block at top_k 4; (d) the
    dry run of qwen3-4b FULL on the fake 16 x 16 mesh."""
    from repro_torch.launch import train as train_cli
    t_phase = time.perf_counter()
    rec = []
    # the embedding's backward accumulates with atomics on the card: both
    # runs take the deterministic kernels (cuBLAS only warns; _resume)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(DIST_TRAIN, record=rec)
        plain, _ = _train_without_rules(torch)
    finally:
        torch.use_deterministic_algorithms(False)
    meshed = [r["loss"] for r in rec]
    same = meshed == plain
    check(all(math.isfinite(v) for v in meshed) and len(meshed) == 3,
          f"dist: --mesh local losses {meshed}")
    check(rec[-1].get("captures") == 1,
          f"dist: --mesh local at world 1 was not captured: {rec[-1]}")
    diff = max(abs(a - b) for a, b in zip(meshed, plain))
    log(f"  (a) launch/train.py --mesh local, world 1 (NCCL), qwen3-4b "
        f"SMOKE, 3 steps, captured: losses {meshed}; without rules {plain}; "
        f"{'bitwise' if same else f'max |diff| {diff:.3g}'}")
    check(same, f"dist: --mesh local losses {meshed} against {plain}")
    out = {"mesh_local": {"losses": meshed, "plain": plain,
                          "bitwise": same, "max_abs_diff": diff},
           "collectives": _dist_collectives(torch, dev),
           "moe_top4": _moe_top4(torch, dev),
           "dryrun": _dryrun_cells(torch, out_dir)}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  dist phase: {out['phase_s']:.1f} s")
    return out


# -- phase 4d: prefix sharing and preemption at full width --------------------

#: the prefix-sharing and preemption serves: qwen3-4b at full width, 4
#: layers (8 through PR 26, cut for chip_smoke's time: the pool's counts
#: depend on lengths and tokens, not depth), bf16, the CUDA kernels,
#: paged KV
PP_ARGV = ["--arch", ARCH, "--layers", "4", "--backend", "crossbar",
           "--use-kernel", "--kv", "paged", "--requests", "8", "--slots",
           "4", "--prompt-len", "16", "--chunk", "4"]
#: sharing: a 60-token common head before each 16-token prompt, request i
#: submitted at step 20 i, each claiming 107 tokens (14 pages of 8)
PP_SHARE = PP_ARGV + ["--common-prefix", "60", "--max-new", "32",
                      "--max-len", "128", "--stagger", "20"]
#: preemption: every request claims 31 tokens (4 pages), 8 pages hold two;
#: the later four arrive at QoS 2
PP_PREEMPT = PP_ARGV + ["--max-new", "16", "--max-len", "64"]
PP_PREEMPT_PAGES = ["--kv-pages", "8", "--preemption"]
#: both, through the streamed lane: a 24-page budget holds a 14-page owner
#: and one follower's 7 fresh pages, so a QoS-2 arrival evicts
PP_STREAM = ["--stream-pages", "4"]
PP_BOTH = ["--prefix-share", "--preemption", "--kv-pages", "24"]


def _pp_drive(st, dev, argv, capture=None):
    """A serve of ``argv``'s scheduler and requests on ``st``'s model (the
    model's own flags must match ``argv``'s), as ``launch/serve.main``
    serves them: the host seconds spent in ``_admit`` and, within it, in
    the pool's ``plan_shared``, and the most pages in use after any step,
    are added to what ``main`` returns."""
    from repro_torch.launch import serve

    st = dataclasses.replace(st, args=serve.parse_args(argv))
    sched = st.scheduler(capture)
    host = {"admit_s": 0.0, "plan_shared_s": 0.0}
    peak = [0]

    def timer(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[key] += time.perf_counter() - t0
        return run

    sched._admit = timer("admit_s", sched._admit)
    pool = sched._lanes["A"].pool
    pool.plan_shared = timer("plan_shared_s", pool.plan_shared)

    def on_step(n):
        peak[0] = max(peak[0], pool.pages_in_use)

    rep = serve.drive(sched, st.requests(), dev, on_step=on_step,
                      stagger=st.args.stagger)
    ex = st.model.executor
    caps = sched.capture_report()
    cache = sched._lanes["A"].cache["layers"]
    rep.update(program_s=0.0, capture=caps["A"], captures=caps,
               swap_history=[], version=ex.version() if ex else None,
               kv=sched.kv_report(), kv_counts=serve.kv_counts(sched),
               host=host, peak_pages=peak[0],
               kv_dtype=str(cache["k"].dtype),
               pool_bytes=sum(cache[k].numel() * cache[k].element_size()
                              for k in ("k", "v")))
    return rep


def _cpu_counts(torch, argv):
    """The page-pool counters that ``argv``'s scheduler and requests give
    on the CPU.  The pool decides from lengths and from which feed tokens
    are equal, never from the model's values (a re-admission's emitted
    tokens reach the index only past a prompt no other request shares),
    so a 2-layer digital model at the SMOKE widths with the full vocab
    (the same prompts) stands in for the card's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    args = serve.parse_args(argv)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              vocab=get_config(ARCH).vocab)
    model = build_model(cfg, device="cpu")
    st = serve.Setup(args, model, model.init(0), None, torch.device("cpu"))
    t0 = time.perf_counter()
    sched = st.scheduler()
    rep = serve.drive(sched, st.requests(), torch.device("cpu"),
                      stagger=args.stagger)
    check(len(rep["requests"]) == args.requests,
          f"the CPU serve of {argv} dropped requests")
    return serve.kv_counts(sched), time.perf_counter() - t0


def _pp_log(key, sv):
    line = (f"  {key}: {sv['steps']} steps, {sv['seconds']:.3f} s wall, "
            f"step ms first two {sv['first_steps_ms'][0]:.2f} / "
            f"{sv['first_steps_ms'][1]:.2f}, then median "
            f"{sv['later_step_ms']:.2f}; counts {sv['kv_counts']}")
    h = sv.get("host")
    if h:
        admit = 100 * h["admit_s"] / sv["seconds"]
        plan = 100 * h["plan_shared_s"] / sv["seconds"]
        line += (f"; host in _admit {h['admit_s']:.4f} s ({admit:.2f}% of "
                 f"the wall), plan_shared {h['plan_shared_s']:.4f} s "
                 f"({plan:.2f}%); peak pages {sv['peak_pages']}")
    log(line)


def phase_prefix_preempt(torch, dev):
    """Prefix sharing and preemption at full width, 4 layers: the CLI's
    shared serve captured; on one programmed model the same serve eager
    and captured without ``--prefix-share`` (all three streams equal), a
    preempting serve under an 8-page budget and a serve with ample pages
    (equal streams); on a model reading through the streamed lane, both
    policies under a 24-page budget and the plain serve (equal streams).
    Each run's sharing, copy-on-write and preemption counts must equal
    the CPU's on the same arguments (``_cpu_counts``), every request is
    served, each lane captures once and nothing retraces."""
    from repro_torch.launch import serve

    scratch = ["crossbar_mac", "paged_attention_scratch"]
    streamed = ["crossbar_mac", "paged_attention_streamed",
                "paged_attention_combine"]
    t_phase = time.perf_counter()
    out = {}
    want, cpu_s = {}, 0.0
    for key, argv in (("share", PP_SHARE + ["--prefix-share"]),
                      ("preempt", PP_PREEMPT + PP_PREEMPT_PAGES),
                      ("both", PP_SHARE + PP_STREAM + PP_BOTH)):
        want[key], secs = _cpu_counts(torch, argv)
        cpu_s += secs
    log(f"  the CPU's counts on the same arguments ({cpu_s:.1f} s): {want}")
    check(want["share"]["serve_kv_shared_tokens_total"] > 0
          and want["preempt"]["serve_preemptions_total"] > 0
          and want["both"]["serve_preemptions_total"] > 0
          and want["both"]["serve_kv_shared_tokens_total"] > 0,
          f"the arguments do not exercise both policies: {want}")
    argv = PP_SHARE + ["--prefix-share"]
    log(f"  {' '.join(argv)}; captured, through the CLI")
    cli = out["share_cli"] = phase_serve(torch, dev, argv, scratch)
    check(cli["kv_counts"] == want["share"],
          f"CLI sharing counts {cli['kv_counts']} != the CPU's "
          f"{want['share']}")
    _pp_log("share_cli", cli)

    def on_model(st, key, argv, must, want_counts=None, capture=None):
        sv = out[key] = phase_serve(
            torch, dev, argv, must, capture=capture,
            run=lambda: _pp_drive(st, dev, argv, capture))
        if want_counts is not None:
            check(sv["kv_counts"] == want_counts,
                  f"{key}: counts {sv['kv_counts']} != the CPU's "
                  f"{want_counts}")
        _pp_log(key, sv)
        return sv

    log("  one programmed model: the shared serve eager, the unshared "
        "serve, a preempting serve and one with ample pages, captured")
    gc.collect()
    torch.cuda.empty_cache()
    st = serve.setup(PP_SHARE)
    t0 = time.perf_counter()
    st.model.executor.program_params(st.params)
    torch.cuda.synchronize()
    out["program_s"] = time.perf_counter() - t0
    eager = on_model(st, "share_eager", argv, scratch, want["share"],
                     capture=False)
    plain = on_model(st, "unshared", PP_SHARE, scratch)
    check(cli["streams"] == eager["streams"] == plain["streams"],
          "captured shared, eager shared and unshared streams differ")
    check(plain["kv_counts"] == dict.fromkeys(serve.KV_COUNTERS, 0),
          f"the unshared serve counted {plain['kv_counts']}")
    pre = on_model(st, "preempt", PP_PREEMPT + PP_PREEMPT_PAGES, scratch,
                   want["preempt"])
    ample = on_model(st, "ample", PP_PREEMPT, scratch)
    check(pre["streams"] == ample["streams"],
          "preempted and unpreempted streams differ")
    del st
    log("  a model reading through the streamed lane (--stream-pages 4): "
        "both policies under a 24-page budget, and the plain serve")
    gc.collect()
    torch.cuda.empty_cache()
    st = serve.setup(PP_SHARE + PP_STREAM)
    t0 = time.perf_counter()
    st.model.executor.program_params(st.params)
    torch.cuda.synchronize()
    out["program_streamed_s"] = time.perf_counter() - t0
    both = on_model(st, "both_streamed", PP_SHARE + PP_STREAM + PP_BOTH,
                    streamed, want["both"])
    base = on_model(st, "unshared_streamed", PP_SHARE + PP_STREAM, streamed)
    check(both["streams"] == base["streams"],
          "streamed lane: shared and preempted streams differ from the "
          "plain serve's")
    del st
    gc.collect()
    torch.cuda.empty_cache()
    out["cpu_counts"], out["cpu_s"] = want, cpu_s
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  prefix/preemption phase: {out['seconds']:.1f} s (programming "
        f"{out['program_s']:.2f} s and {out['program_streamed_s']:.2f} s; "
        f"peak pages shared {eager['peak_pages']} against unshared "
        f"{plain['peak_pages']}; through the streamed lane "
        f"{both['peak_pages']} against {base['peak_pages']})")
    for sv in out.values():
        if isinstance(sv, dict):
            sv.pop("step_s", None)
    return out


#: the fp8-cache serves' model reads tables of 16 pages and more (the
#: 128-token window of ``PP_SHARE``) through the streamed lane and
#: shorter ones (the 64-token window of ``PP_PREEMPT``) through the
#: scratch lane, so one programmed model serves both lanes
FP8_STREAM_PAGES = 16


def _agreement(a, b):
    """The share of positions at which two serves' streams agree."""
    pairs = [(x, y) for rid in a for x, y in zip(a[rid], b[rid])]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def phase_kv_fp8(torch, dev, pp):
    """The fp8 KV cache at full width, 4 layers, bfloat16 compute, through
    ``BatchScheduler`` (the reference reaches fp8 through ``ModelConfig``,
    not its CLI): one programmed model with
    ``kv_dtype=torch.float8_e4m3fn``, the scratch lane at ``PP_PREEMPT``'s
    64-token window captured and eager, the streamed lane at ``PP_SHARE``
    shared captured and eager and unshared captured.  Streams equal per
    lane, one capture and no retrace per serve, the sharing counts equal
    to the CPU's (``pp``: the prefix/preemption phase's report, whose
    bf16-cache serves use the same params), and the K/V pool's bytes
    exactly half of the bf16 serve's at equal pages.  The token agreement
    with the bf16-cache serves is logged, not gated."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    scratch = ["crossbar_mac", "paged_attention_scratch"]
    streamed = ["crossbar_mac", "paged_attention_streamed",
                "paged_attention_combine"]
    t_phase = time.perf_counter()
    out = {}
    base = get_config(ARCH)
    cfg = dataclasses.replace(
        base, n_layers=4, backend="crossbar", paged_kernel=True,
        xbar=dataclasses.replace(base.xbar, use_kernel=True),
        paged_stream_pages=FP8_STREAM_PAGES, paged_block_pages=16,
        kv_dtype=torch.float8_e4m3fn)
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg, device=dev)
    st = serve.Setup(serve.parse_args(PP_SHARE), model, model.init(0), None,
                     dev)
    t0 = time.perf_counter()
    model.executor.program_params(st.params)
    torch.cuda.synchronize()
    out["program_s"] = time.perf_counter() - t0

    def on_model(key, argv, must, capture=None):
        sv = out[key] = phase_serve(
            torch, dev, argv, must, capture=capture,
            run=lambda: _pp_drive(st, dev, argv, capture))
        check(sv["kv_dtype"] == "torch.float8_e4m3fn",
              f"{key}: the cache is {sv['kv_dtype']}")
        _pp_log(key, sv)
        return sv

    log(f"  scratch lane: {' '.join(PP_PREEMPT)}; captured, then eager")
    sc = on_model("scratch", PP_PREEMPT, scratch)
    sc_eager = on_model("scratch_eager", PP_PREEMPT, scratch, capture=False)
    check(sc["streams"] == sc_eager["streams"],
          "fp8 cache, scratch lane: captured and eager streams differ")
    argv = PP_SHARE + ["--prefix-share"]
    log(f"  streamed lane: {' '.join(argv)} captured and eager, and the "
        f"unshared serve")
    sh = on_model("share", argv, streamed)
    check(sh["kv_counts"] == pp["cpu_counts"]["share"],
          f"fp8 sharing counts {sh['kv_counts']} != the CPU's "
          f"{pp['cpu_counts']['share']}")
    sh_eager = on_model("share_eager", argv, streamed, capture=False)
    plain = on_model("unshared", PP_SHARE, streamed)
    check(sh["streams"] == sh_eager["streams"] == plain["streams"],
          "fp8 cache, streamed lane: captured shared, eager shared and "
          "unshared streams differ")
    check(plain["kv_counts"] == dict.fromkeys(serve.KV_COUNTERS, 0),
          f"the unshared fp8 serve counted {plain['kv_counts']}")
    bf16 = pp["unshared"]
    n8, n16 = (x["kv"]["A"]["n_pages"] for x in (plain, bf16))
    check(n8 == n16 and 2 * plain["pool_bytes"] == bf16["pool_bytes"],
          f"fp8 pool {plain['pool_bytes']} B at {n8} pages against the "
          f"bf16 pool's {bf16['pool_bytes']} B at {n16} pages (want half)")
    out["pool_bytes"] = {"fp8": plain["pool_bytes"],
                         "bf16": bf16["pool_bytes"], "n_pages": n8}
    out["agreement_with_bf16_cache"] = {
        "scratch": _agreement(sc["streams"], pp["ample"]["streams"]),
        "streamed": _agreement(plain["streams"],
                               pp["unshared_streamed"]["streams"])}
    del st, model
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  fp8 cache phase: {out['seconds']:.1f} s (programming "
        f"{out['program_s']:.2f} s); K/V pool {plain['pool_bytes']} B "
        f"against bf16's {bf16['pool_bytes']} B at {n8} pages; token "
        f"agreement with the bf16-cache serves (not gated) "
        f"{out['agreement_with_bf16_cache']}")
    for sv in out.values():
        if isinstance(sv, dict):
            sv.pop("step_s", None)
    return out


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
        phase = "physics"
        log("  physics: the paper's 10 x 10 x 2 array, the device dynamics "
            "at wq's cell count, matmul_analog at wq, deepnet_mlp at the "
            "MLP widths, the quickstart")
        report["physics"] = phase_physics(torch, dev)

        log(f"  ({time.perf_counter() - t_start:.1f} s so far)")
        phase = "parity"
        log("[3/4] token parity: full width, 2 layers, fp32, crossbar, "
            "paged KV, with and without the kernels")
        report["parity"] = phase_parity(torch, dev)
        report["parity_auto"] = phase_parity(torch, dev, "auto")
        log("  the same with an fp8 cache (kv_dtype=float8_e4m3fn)")
        report["parity_fp8"] = phase_parity(
            torch, dev, kv_dtype=torch.float8_e4m3fn)
        for arch, _ in ARCH_SERVES:
            log(f"  {arch}: kernels on and off, captured and eager")
            report[f"parity_{arch}"] = phase_parity(torch, dev, arch=arch,
                                                    kvs=("paged",))
        log("  the VLM, encoder-decoder and recurrent families through "
            "greedy_generate")
        report["parity_families"] = phase_family_parity(torch, dev)

        log(f"  ({time.perf_counter() - t_start:.1f} s so far)")
        phase = "serve"
        log(f"[4/4] serve {ARCH} at full width through launch/serve.py "
            f"(window step captured), the 36-layer serve last")
        main_argv = _serve_argv(ARCH)
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
        log(f"  ({time.perf_counter() - t_start:.1f} s so far)")
        phase = "hotswap"
        log("  hot-swap at full width, 8 layers")
        report["hotswap"] = phase_hotswap(torch, dev)
        phase = "multiplex"
        log("  multiplexing two tenants at full width, 8 layers")
        report["multiplex"] = phase_multiplex(torch, dev)
        phase = "prefix_preempt"
        log("  prefix sharing and preemption at full width, 4 layers")
        report["prefix_preempt"] = phase_prefix_preempt(torch, dev)
        phase = "kv_fp8"
        log("  the fp8 KV cache at full width, 4 layers, both lanes")
        report["kv_fp8"] = phase_kv_fp8(torch, dev,
                                        report["prefix_preempt"])
        log(f"  ({time.perf_counter() - t_start:.1f} s so far)")
        phase = "archs"
        log("  the other decoder LMs at full width: "
            + ", ".join(f"{a} ({n or 'all'} layers)" for a, n in ARCH_SERVES))
        report["archs"] = phase_archs(torch, dev)
        phase = "families"
        log("  the VLM, encoder-decoder and recurrent families through "
            "greedy_generate: " + ", ".join(
                f"{a} ({n or 'all'} layers, {bk})"
                for a, n, bk, *_ in FAMILY_SERVES))
        report["families"] = phase_family_serves(torch, dev)
        phase = "train"
        log("  training: qwen3-4b at full width, 8 layers, through "
            "launch/train.py; the card against the CPU; a resume; the "
            "deploy example's reads on the MAC kernel and the serve "
            "examples")
        report["train"] = phase_train(torch, dev)
        phase = "dist"
        log("  distribution: --mesh local on NCCL, the collectives at world "
            "1, the MoE block at top_k 4, the dry run on a fake 16x16 mesh")
        report["dist"] = phase_dist(torch, dev, out_dir)
        log(f"  ({time.perf_counter() - t_start:.1f} s so far)")
        phase = "serve"
        # last: the serves after a trace ran slower (the profiler's state
        # outlives it), so none of the timed CLI serves follows one
        log("  the main serve on one programmed model: captured (the "
            "serve's step time and launches), eager (the witness), then "
            "captured and eager in a torch.profiler trace of the card, then "
            "one eager step with CPU activity traced")
        report["serve"] = sv = phase_witness(torch, dev, main_argv, out_dir)
        mac_est, mac_per_step = mac_step_ms(mac_rows)
        sv["mac_launches_per_step"] = sv["launches"]["crossbar_mac"] / \
            sv["steps"]
        log(f"  the MAC's {mac_per_step} launches per step (run "
            f"{sv['mac_launches_per_step']:.1f}) would take {mac_est:.2f} ms "
            f"of device time at phase 2's per-geometry times (an estimate; "
            f"the traces measure it)")
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
        phase = "archs"
        arch = ARCH_SERVES[1][0]
        log(f"  {arch}'s captured serve traced")
        report["archs"][arch]["trace"] = phase_arch_trace(
            torch, dev, out_dir, report["archs"][arch]["streams"])
        phase = "train"
        log("  the train step traced: one eager step and three replays")
        report["train"]["trace"] = phase_train_trace(torch, dev, out_dir)
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
    swap_l = report["hotswap"]["ft"]["launches"]
    mux_l = report["multiplex"]["ft_b"]["launches"]
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
         "swap_serve_launches": swap_l["crossbar_mac"],
         "mux_serve_launches": mux_l["crossbar_mac"],
         "deepnet_mlp_launches": report["physics"]["deepnet_mlp"][
             "launches"],
         "deploy_launches": report["train"]["deploy"]["launches"],
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
            "max_abs_err": max([r["max_abs_err"]] + [
                r[k]["max_abs_err"] for k in (
                    "long", "serve_long", "hd40", "mux_b5", "mux_b3",
                    "prefix_share", "global_f32_65536", "global_bf16_65536",
                    *(c[0] for c in ARCH_PAGED_CASES))
                if k in r] + [
                    c["max_abs_err"] for by_q in r["fp8"].values()
                    for c in by_q.values()] + [
                    c["max_abs_err"] for c in r.get("f32", {}).values()]),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": f"B={r['b']} sq={r['sq']} max_len={r['max_len']}",
            "long_launches": long_l[f"paged_attention_{lane}"],
            "mux_serve_launches": mux_l.get(f"paged_attention_{lane}", 0),
            **{f"mux_b{b}_device_ms": r[f"mux_b{b}"]["device_ms"]
               for b, _ in MUX_PAGED_CASES if f"mux_b{b}" in r},
            "prefix_share_ms": r["prefix_share"]["ms"],
            "prefix_share_device_ms": r["prefix_share"]["device_ms"],
            "prefix_share_bound_ms": r["prefix_share"]["bound_ms"],
            "long_ms": lg["ms"], "long_device_ms": lg["device_ms"],
            "long_library_ms": lg["library_ms"],
            "long_bound_ms": lg["bound_ms"],
            "long_shape": f"B={lg['b']} sq={lg['sq']} "
                          f"max_len={lg['max_len']}"})
        for qt, by_shape in r["fp8"].items():   # fp8 K/V, q at qt
            for shape, c in by_shape.items():
                pre = f"fp8_{qt}_" + ("" if shape == "serve" else
                                       f"{shape}_")
                kernels[-1].update({
                    pre + "ms": c["ms"], pre + "device_ms": c["device_ms"],
                    pre + "plain_ms": c["plain_ms"],
                    pre + "bound_ms": c["bound_ms"],
                    pre + "library_ms": c["library_ms"],
                    pre + "library_device_ms": c["library_device_ms"],
                    pre + "shape": f"B={c['b']} sq={c['sq']} "
                                   f"max_len={c['max_len']}"})
        for tag, c in r.get("f32", {}).items():  # the float32 lane
            kernels[-1].update({
                f"f32_{tag}_{k}": c[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                    "library_device_ms")})
            kernels[-1][f"f32_{tag}_shape"] = (f"B={c['b']} sq={c['sq']} "
                                               f"max_len={c['max_len']}")
        for tag, *_ in GLOBAL_CASES:  # past the scratch lane's capacity
            if f"global_{tag}" in r:
                g = r[f"global_{tag}"]
                kernels[-1].update({
                    f"global_{tag}_{k}": g[k] for k in (
                        "ms", "device_ms", "plain_ms", "bound_ms",
                        "library_ms", "workspace_bytes")})
        if "cluster" in r:        # the bf16 scratch lane on a cluster
            cl = r["cluster"]
            kernels[-1].update({
                "cluster_ms": cl["ms"], "cluster_device_ms": cl["device_ms"],
                "cluster_library_ms": cl["library_ms"],
                "cluster_bound_ms": cl["bound_ms"],
                "cluster_shape": f"B={cl['b']} sq={cl['sq']} "
                                 f"max_len={cl['max_len']}",
                "capacity_tokens": r["capacity"]})
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
                   if r["geometry"] == "head" and r["w_bits"] == 4)
    ds_wide = {r["w_bits"]: r for r in report["deepnet_stream"]["rows"]
               if r["geometry"] == GEOMS[0][0] and r["w_bits"] > 4}
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
        "popcount_bf16_device_ms": ds_head["popcount_device_ms_bf16"],
        **{f"w{wb}_{k}": ds_wide[wb][k] for wb in WIDE_W_BITS for k in (
            "ms", "device_ms", "bound_ms", "popcount_ms",
            "popcount_device_ms")}})
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
    # the other archs: their serves' launches, the kernels at their shapes
    arch_l = {a: report["archs"][a]["launches"] for a, _ in ARCH_SERVES}
    for kr in kernels[:3]:
        kr.update({f"{a}_serve_launches": arch_l[a].get(kr["name"], 0)
                   for a in arch_l})
    for a, _, backend, *_ in FAMILY_SERVES:
        if backend == "crossbar":
            kernels[0][f"{a}_serve_launches"] = report["families"][a][
                "launches"]["crossbar_mac"]
    for r in report["crossbar_mac"]:
        if any(r["geometry"] == g[0]
               for g in ARCH_GEOMS + FAMILY_GEOMS + [ENC_GEOM]):
            tag = r["geometry"].replace(" ", "_")
            kernels[0].update({f"{tag}_{k}": r[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")})
    for kr, lane in zip(kernels[1:3], ("scratch", "streamed")):
        for tag, *_ in ARCH_PAGED_CASES:
            c = report["paged_attention"][lane][tag]
            kr.update({f"{tag}_{k}": c[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")})
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
