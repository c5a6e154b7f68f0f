"""Serving CLI: ``python -m repro_torch.launch.serve --arch qwen3-4b``.

Continuous-batching decode over the port's BatchScheduler with synthetic
prompts (random params and prompts from seeded torch Generators).

``--backend crossbar`` serves every linear layer from weight-resident
crossbar tiles: weights are programmed once at scheduler construction
and every step is a read-only bit-serial MAC (core/executor.py).
``--use-kernel`` routes those reads through the CUDA crossbar-MAC kernel
(``EngineConfig.use_kernel``) and paged decode attention through the
CUDA paged-attention kernels (``ModelConfig.paged_kernel``); without it
the plain PyTorch reference computes both.

KV storage defaults to the block-paged pool (``--kv paged``); prompts
stream into the running batch as ``--chunk``-token prefill chunks.
``--stream-pages N`` routes decode attention through the streamed
(online-softmax) lane once a row's page table is at least N pages wide.

``--mode-policy`` (crossbar backend only) sets each weight's read mode:
an expansion-fused plane pair cuts worst-case IR drop (paper: 22%) but
gives up the write shadow; ``auto`` fuses the accuracy-critical layers
(attention, head) and keeps the MLP in deep-net layout, and the per-layer
choices and IR-drop deltas print from ``mode_report()``.

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain
PyTorch path on the CPU.  ``--layers N`` cuts the configuration's depth
(never its width).  On the card every window step after the first runs
as one captured CUDA graph (``BatchScheduler``); no flag turns that off.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Any, Dict, List

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import BatchScheduler, Request


def parse_mode_policy(spec):
    """``--mode-policy`` parsing: ``auto`` | ``expansion`` | ``deepnet``
    | ``name=mode[,name=mode...]`` (names may be dotted fragments like
    ``attn`` or ``blocks.0.mlp.wi``; ``default=<mode>`` covers the rest;
    mapped modes may themselves be ``auto``)."""
    if spec is None:
        return None
    if spec in ("auto", "expansion", "deepnet"):
        return spec
    policy = {}
    for item in spec.split(","):
        name, sep, mode = item.partition("=")
        name, mode = name.strip(), mode.strip()
        if not sep or not name or mode not in ("expansion", "deepnet",
                                               "auto"):
            raise SystemExit(
                f"--mode-policy: bad entry {item!r} (want auto | "
                f"expansion | deepnet | name=mode,... with mode one of "
                f"expansion/deepnet/auto)")
        policy[name] = mode
    return policy


def _print_mode_report(rep) -> None:
    agg = rep["aggregate"]
    print(f"mode policy: {agg['n_expansion']} expansion-fused / "
          f"{agg['n_deepnet']} deep-net weight grids; mean worst-case "
          f"IR-drop reduction on expansion layers "
          f"{agg['ir_drop_reduction_expansion'] * 100:.1f}% (paper: 22%)")
    for name, entry in list(rep["layers"].items())[:6]:
        gain = (f"-{entry['ir_drop_reduction'] * 100:.1f}% IR drop"
                if entry["mode"] == "expansion" else
                f"-{entry['ir_drop_reduction'] * 100:.1f}% if fused")
        print(f"  {name}: {entry['mode']:9s} "
              f"dev {entry['dev_deepnet']:.4f} -> "
              f"{entry['dev_expansion']:.4f} ({gain})  "
              f"[{entry['reason']}]")
    if len(rep["layers"]) > 6:
        print(f"  ... {len(rep['layers']) - 6} more weight grids "
              f"(sched.mode_report() for the full table)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Setup:
    """A parsed command line and the model and params it builds."""
    args: argparse.Namespace
    model: Any
    params: Any
    mode_policy: Any
    device: torch.device

    def scheduler(self, capture=None) -> BatchScheduler:
        """The command line's scheduler (programming the weights);
        ``capture`` as ``BatchScheduler`` takes it."""
        a = self.args
        return BatchScheduler(self.model, self.params, n_slots=a.slots,
                              max_len=a.max_len, kv=a.kv,
                              page_size=a.page_size, chunk=a.chunk,
                              mode_policy=self.mode_policy, capture=capture)

    def requests(self) -> List[Request]:
        """The command line's synthetic requests (seeded prompts)."""
        a = self.args
        gen = torch.Generator()
        gen.manual_seed(1)
        return [Request(rid=rid,
                        prompt=torch.randint(0, self.model.cfg.vocab - 1,
                                             (a.prompt_len,), generator=gen,
                                             dtype=torch.int32),
                        max_new=a.max_new)
                for rid in range(a.requests)]


def drive(sched: BatchScheduler, reqs: List[Request],
          device: torch.device) -> Dict[str, Any]:
    """Submit ``reqs`` and step until all finish: the requests, tokens,
    steps, wall seconds, tokens/s and each step's wall seconds (a step
    ends with its tokens on the host)."""
    for r in reqs:
        sched.submit(r)
    done, step_s = [], []
    t0 = time.perf_counter()
    while len(done) < len(reqs) and len(step_s) < 10_000:
        t = time.perf_counter()
        done += sched.step()
        step_s.append(time.perf_counter() - t)
    _sync(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in done)
    return {"requests": done, "tokens": total_tokens, "steps": len(step_s),
            "seconds": dt, "tok_per_s": total_tokens / max(dt, 1e-9),
            "step_s": step_s}


def setup(argv=None) -> Setup:
    """Parse ``argv`` and build the model and its random params."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="serve only the first N layers (depth cut; width "
                         "stays the configuration's)")
    ap.add_argument("--backend", default="digital",
                    choices=["digital", "crossbar"],
                    help="crossbar = weight-resident tiles, program-once")
    ap.add_argument("--mode-policy", default=None, metavar="POLICY",
                    help="per-weight read modes (crossbar backend): auto | "
                         "expansion | deepnet | name=mode,...")
    ap.add_argument("--use-kernel", action="store_true",
                    help="crossbar reads and paged attention through the "
                         "CUDA kernels (EngineConfig.use_kernel, "
                         "ModelConfig.paged_kernel)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--kv", default="paged", choices=["paged", "dense"],
                    help="KV storage: paged = block-paged pool with "
                         "per-slot page tables; dense = per-slot dense "
                         "cache")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (must divide --max-len)")
    ap.add_argument("--chunk", type=int, default=4,
                    help="prompt tokens fed per step while a request "
                         "prefills inside the running decode batch")
    ap.add_argument("--stream-pages", type=int, default=0, metavar="N",
                    help="route paged decode attention through the "
                         "streamed online-softmax lane whenever a row's "
                         "page table is >= N pages wide (0 = the "
                         "gather-scratch lane; requires --kv paged)")
    ap.add_argument("--block-pages", type=int, default=16, metavar="N",
                    help="pages per streamed attention block (clamped to "
                         "a divisor of the table width)")
    args = ap.parse_args(argv)
    if args.stream_pages and args.kv != "paged":
        raise SystemExit("--stream-pages routes paged attention; it "
                         "requires --kv paged")
    if args.mode_policy and args.backend != "crossbar":
        raise SystemExit("--mode-policy requires --backend crossbar")
    mode_policy = parse_mode_policy(args.mode_policy)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, backend=args.backend)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.use_kernel:
        cfg = dataclasses.replace(
            cfg, paged_kernel=True,
            xbar=dataclasses.replace(cfg.xbar, use_kernel=True))
    if args.stream_pages:
        cfg = dataclasses.replace(cfg, paged_stream_pages=args.stream_pages,
                                  paged_block_pages=args.block_pages)
    model = build_model(cfg, device=device)
    return Setup(args, model, model.init(0), mode_policy, device)


def main(argv=None, *, capture=None):
    """Serve the command line's requests and print what was served.
    ``capture`` goes to ``BatchScheduler`` (None: capture on the card);
    it is no command-line flag: ``capture=False`` is the eager witness
    that tests and ``chip_smoke.py`` hold the captured step against."""
    st = setup(argv)
    args, cfg, device = st.args, st.model.cfg, st.device
    mode_policy = st.mode_policy
    t0 = time.perf_counter()
    sched = st.scheduler(capture)
    _sync(device)
    program_s = time.perf_counter() - t0
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}, backend {cfg.backend}"
          f"{' (CUDA kernels)' if args.use_kernel else ''} on {device}")
    if args.kv == "paged":
        desc = ", ".join(f"{t}:{r['n_pages']}p"
                         for t, r in sched.kv_report().items())
        print(f"paged KV: page_size={args.page_size} tokens, pools "
              f"[{desc}], chunk={args.chunk} prompt tokens/step")
    ex = st.model.executor
    if ex is not None:
        print(f"crossbar backend: {ex.n_resident} resident weight grids, "
              f"{ex.n_devices} programmed devices/plane, "
              f"{ex.stack_planes}-plane banks "
              f"({ex.n_devices_physical} physical devices; "
              f"programmed={ex.stats['programmed']}, "
              f"cache_hits={ex.stats['cache_hits']}) in {program_s:.2f}s")
        for t, entry in ex.residency().items():
            m = entry["modes"]
            print(f"  resident tenant {t}: v{entry['version']} "
                  f"fingerprint={entry['fingerprint']} "
                  f"modes={m['expansion']} expansion / "
                  f"{m['deepnet']} deep-net")
        if mode_policy is not None:
            _print_mode_report(sched.mode_report())

    rep = drive(sched, st.requests(), device)
    done = rep["requests"]
    print(f"served {len(done)} requests, {rep['tokens']} tokens in "
          f"{rep['steps']} decode steps, {rep['seconds']:.2f}s "
          f"({rep['tok_per_s']:.1f} tok/s)")
    cap = sched.capture_report()["A"]
    ms = [t * 1e3 for t in rep["step_s"]]
    if cap["capture"]:
        print(f"window step: {cap['captures']} CUDA graph capture(s), "
              f"{cap['replays']} replays, {cap['eager_steps']} eager "
              f"warm-up step(s); step ms "
              + ", ".join(f"{t:.1f}" for t in ms[:2])
              + (f", then median {statistics.median(ms[2:]):.1f}"
                 if len(ms) > 2 else ""))
    if args.stream_pages:
        lanes = sched.attn_lane_report()
        d = lanes["dispatch"]
        print(f"attn lanes: streamed >= {lanes['stream_min_pages']}p of "
              f"{lanes['pages_per_seq']}p table, "
              f"block={lanes['block_pages']}p; dispatches "
              f"scratch={d['paged_scratch']} "
              f"streamed={d['paged_streamed']} "
              f"fallback={d['paged_fallback']}")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")
    rep.update(program_s=program_s, capture=cap)
    if mode_policy is not None:
        rep["mode_report"] = sched.mode_report()
    return rep


if __name__ == "__main__":
    main()
