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
             and operations / the type's peak rate (H100 SXM data sheet);
3. parity  — full-width qwen3-4b, 2 layers, float32, crossbar backend,
             paged KV: greedy streams with and without the CUDA kernels
             must be identical;
4. serve   — ``repro_torch.launch.serve.main`` at full width (36 layers)
             with ``--backend crossbar --use-kernel --kv paged``, then a
             shorter serve through the streamed attention lane; every
             kernel of each path must have launched, and no plain
             version may have run.

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


def rel_err(torch, got, want):
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


# -- phase 2: kernels against their plain versions -----------------------------

def phase_crossbar_mac(torch, dev, flush):
    from repro_torch.kernels.crossbar_mac import kernel, ref

    # (name, K, N): every projection geometry of a qwen3-4b decode step
    geoms = [("wq", 2560, 4096), ("wk/wv", 2560, 2048),
             ("attn wo", 4096, 2560), ("wi/wg", 2560, 9728),
             ("mlp wo", 9728, 2560), ("head", 2560, 152064)]
    b, s, in_bits, adc_bits = 16, 4, 8, 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows_out, max_abs = [], 0.0
    runs = [(g, "deepnet", 128, leak) for g in geoms for leak in (0.0, 0.37)]
    runs.append((geoms[0], "expansion", 256, 0.0))
    for (name, k, n), mode, rows, leak in runs:
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
        y_ref = ref.crossbar_mac_ref(x, pos, neg, leak_codes=lk, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, y, y_ref)
        # the kernel sums integer codes exactly (int64); the plain version
        # shift-adds in f32, in another order
        tol = 1e-5
        check(bool(torch.isfinite(y).all()), f"crossbar_mac {name}: "
              f"non-finite output")
        check(rel <= tol, f"crossbar_mac {name} {mode} leak={leak}: "
              f"max rel err {rel:.3e} > {tol:g}")
        max_abs = max(max_abs, err)
        row = {"geometry": name, "k": k, "n": n, "b": b, "mode": mode,
               "leak": leak, "max_abs_err": err, "max_rel_err": rel,
               "tol": tol}
        if leak == 0.0 and mode == "deepnet":
            row["ms"] = timed(torch, lambda: kernel.crossbar_mac(
                x, pos, neg, lk, **kw), 10, flush)
            row["plain_ms"] = timed(torch, lambda: ref.crossbar_mac_ref(
                x, pos, neg, leak_codes=lk, **kw), 2, flush)
            nbytes = x.numel() * 4 + 2 * pos.numel() + b * n * 4 + 4
            ops = 2 * 2 * b * in_bits * s * k * n    # AND-accumulate, +/-
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops, "int8")
            row["library_ms"] = None
        rows_out.append(row)
        log(f"  crossbar_mac {name:8s} K={k:5d} N={n:6d} {mode:9s} "
            f"leak={leak:4.2f}: max|err| {err:.3e} (rel {rel:.2e} <= "
            f"{tol:g})" + (f"; kernel {row['ms']:.3f} ms, plain "
                          f"{row['plain_ms']:.3f} ms, bound "
                          f"{row['bound_ms']:.3f} ms ({row['bound_by']})"
                          if "ms" in row else ""))
        del x, pos, neg, y, y_ref
        torch.cuda.empty_cache()
    return rows_out, max_abs


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


def phase_paged_attention(torch, dev, flush):
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
        if lane == "scratch":
            def run():
                return kernel.paged_attention_scratch(*args)

            def plain():
                return ref.paged_attention_ref(*args)
        else:
            def run():
                return kernel.paged_attention_streamed(*args,
                                                       block_pages=bp)

            def plain():
                return ref.paged_attention_streamed_ref(*args,
                                                        block_pages=bp)
        y = run()
        y_ref = plain()
        torch.cuda.synchronize()
        err, rel = rel_err(torch, y, y_ref)
        # bf16 values: the weights (scratch) and outputs round to bf16,
        # whose unit roundoff is 2^-8 = 3.9e-3
        tol = 1e-2
        check(bool(torch.isfinite(y.float()).all()),
              f"paged_attention_{lane}: non-finite output")
        check(rel <= tol, f"paged_attention_{lane}: max rel err {rel:.3e} "
              f"> {tol:g}")
        attended = sum(min(n, max_len) for n in kv_len)
        nbytes = (2 * attended * kv * hd * 2 + 2 * y.numel() * 2
                  + args[3].numel() * 4 + 2 * b * 4)
        ops = 4 * sq * hq * hd * attended
        bnd, by = bound(nbytes, ops, "bf16")
        out[lane] = {
            "max_len": max_len, "kv_len": kv_len, "block_pages": bp,
            "b": b, "sq": sq, "hq": hq, "kv": kv, "hd": hd,
            "page_size": ps, "max_abs_err": err, "max_rel_err": rel,
            "tol": tol, "ms": timed(torch, run, 20, flush),
            "plain_ms": timed(torch, plain, 5, flush),
            "library_ms": timed(torch, _sdpa_yardstick(torch, args), 20,
                                flush),
            "bound_ms": bnd, "bound_by": by}
        r = out[lane]
        log(f"  paged_attention_{lane:8s} max_len={max_len} "
            f"kv_len={kv_len}: max|err| {err:.3e} (rel {rel:.2e} <= "
            f"{tol:g}); kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
            f"bound {bnd:.5f} ms ({by})")
    return out


# -- phase 3: token parity with and without the kernels -------------------------

def phase_parity(torch, dev):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.crossbar_mac import kernel as mac
    from repro_torch.kernels.paged_attention import kernel as pa
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
        mac.LAUNCHES["crossbar_mac"] = 0
        pa.LAUNCHES["paged_attention_scratch"] = 0
        sched = BatchScheduler(model, params, n_slots=2, max_len=64)
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=i, prompt=p, max_new=4))
        done, steps = [], 0
        while len(done) < len(prompts) and steps < 100:
            done += sched.step()
            steps += 1
        streams[use_kernel] = {r.rid: r.out for r in done}
        n_mac = mac.LAUNCHES["crossbar_mac"]
        n_pa = pa.LAUNCHES["paged_attention_scratch"]
        check(len(done) == len(prompts), "parity run did not finish")
        check((n_mac > 0 and n_pa > 0) if use_kernel
              else (n_mac == 0 and n_pa == 0),
              f"use_kernel={use_kernel}: launches mac={n_mac} paged={n_pa}")
        log(f"  use_kernel={use_kernel}: streams {streams[use_kernel]} "
            f"(kernel launches: crossbar_mac {n_mac}, paged scratch {n_pa})")
        del model, sched
        gc.collect()
        torch.cuda.empty_cache()
    check(streams[False] == streams[True],
          "greedy streams differ with and without the CUDA kernels")
    return {"streams": {str(k): v for k, v in streams[True].items()},
            "identical": True, "layers": 2, "dtype": "float32"}


# -- phase 4: serve through the port's CLI ---------------------------------------

def _reset_counts():
    from repro_torch import obs
    from repro_torch.kernels.crossbar_mac import kernel as mac
    from repro_torch.kernels.crossbar_mac import ref as mac_ref
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.paged_attention import ref as pa_ref
    for counts in (mac.LAUNCHES, pa.LAUNCHES, mac_ref.CALLS, pa_ref.CALLS):
        for key in counts:
            counts[key] = 0
    obs.reset()


def _read_counts():
    from repro_torch.core import engine
    from repro_torch.kernels.crossbar_mac import kernel as mac
    from repro_torch.kernels.crossbar_mac import ref as mac_ref
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.paged_attention import ref as pa_ref
    kernels = {**mac.LAUNCHES, **pa.LAUNCHES}
    plain = {**mac_ref.CALLS, **pa_ref.CALLS,
             "engine.matmul_reference": engine.path_calls["reference"]}
    return kernels, plain


def phase_serve(torch, dev, argv, must_launch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    vocab = get_config(ARCH).vocab
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    rep = serve.main(argv)
    torch.cuda.synchronize()
    kernels, plain = _read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    toks = [t for r in rep["requests"] for t in r.out]
    log(f"  tokens/s {rep['tok_per_s']:.2f} ({rep['tokens']} tokens, "
        f"{rep['steps']} steps, {rep['seconds']:.2f} s); programming "
        f"{rep['program_s']:.2f} s; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    log(f"  kernel launches {kernels}; plain-version calls {plain}")
    n_req = int(argv[argv.index("--requests") + 1])
    max_new = int(argv[argv.index("--max-new") + 1])
    check(len(rep["requests"]) == n_req
          and all(len(r.out) == max_new for r in rep["requests"]),
          "serve did not complete every request")
    check(all(0 <= t < vocab for t in toks), "token outside the vocab")
    for name in must_launch:
        check(kernels[name] > 0, f"{name} never launched on this path")
    check(all(v == 0 for v in plain.values()),
          f"plain versions ran on the serving path: {plain}")
    return {"argv": argv, "tok_per_s": rep["tok_per_s"],
            "tokens": rep["tokens"], "steps": rep["steps"],
            "seconds": rep["seconds"], "program_s": rep["program_s"],
            "max_memory_allocated": peak, "launches": kernels,
            "plain_calls": plain}


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
        del flush
        torch.cuda.empty_cache()

        phase = "parity"
        log("[3/4] token parity: full width, 2 layers, fp32, crossbar, "
            "paged KV, with and without the kernels")
        report["parity"] = phase_parity(torch, dev)

        phase = "serve"
        log(f"[4/4] serve {ARCH} at full width through launch/serve.py")
        main_argv = ["--arch", ARCH, "--backend", "crossbar", "--use-kernel",
                     "--kv", "paged", "--requests", "4", "--prompt-len",
                     "16", "--max-new", "8", "--slots", "4", "--max-len",
                     "64", "--chunk", "4"]
        report["serve"] = phase_serve(
            torch, dev, main_argv,
            ["crossbar_mac", "paged_attention_scratch"])
        log("  streamed lane: --stream-pages 4 --max-len 256, 4 layers")
        stream_argv = ["--arch", ARCH, "--layers", "4", "--backend",
                       "crossbar", "--use-kernel", "--kv", "paged",
                       "--requests", "4", "--prompt-len", "16", "--max-new",
                       "4", "--slots", "4", "--max-len", "256", "--chunk",
                       "4", "--stream-pages", "4", "--block-pages", "4"]
        report["serve_streamed"] = phase_serve(
            torch, dev, stream_argv,
            ["crossbar_mac", "paged_attention_streamed"])
    except Exception:  # noqa: BLE001 — report the failing phase, exit 1
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
        return 1

    report["seconds"] = time.perf_counter() - t_start
    head = next(r for r in report["crossbar_mac"]
                if r["geometry"] == "head" and "ms" in r)
    serve_l = report["serve"]["launches"]
    stream_l = report["serve_streamed"]["launches"]
    kernels = [
        {"name": "crossbar_mac", "route": "cuda",
         "source": "src/repro_torch/csrc/crossbar_mac.cu",
         "replaces": "src/repro/kernels/crossbar_mac/kernel.py:98",
         "launches": serve_l["crossbar_mac"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in report["crossbar_mac"]),
         "ms": head["ms"], "plain_ms": head["plain_ms"],
         "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
         "library_ms": None, "shape": f"B=16 K={head['k']} N={head['n']}"},
    ]
    for lane, line, launches in (
            ("scratch", 124, serve_l["paged_attention_scratch"]),
            ("streamed", 258, stream_l["paged_attention_streamed"])):
        r = report["paged_attention"][lane]
        kernels.append({
            "name": f"paged_attention_{lane}", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention/kernel.py:{line}",
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": f"B={r['b']} sq={r['sq']} max_len={r['max_len']}"})
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
