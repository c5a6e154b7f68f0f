"""Serving CLI: ``python -m repro_torch.launch.serve --arch qwen3-4b``.

``--arch`` takes every decoder LM of the registry (``configs/``): the
dense qwen3-4b, qwen3-8b, minitron-4b and nemotron-4-340b, and the MoE
phi3.5-moe and grok-1-314b, by the reference's names and aliases.  The
VLM, encoder-decoder and recurrent archs (qwen2-vl-72b, whisper-base,
rwkv6-3b, zamba2-1.2b) exit, as the reference's CLI exits for them: they
generate through ``serve.engine.greedy_generate``.

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

``--hot-swap SPEC`` (crossbar backend only) deploys a second
checkpoint under live traffic (deep-net mode at the serving tier,
serve/hotswap.py): once ``--swap-after`` requests have finished, the new
weights program onto the staging planes, ``--swap-chunks`` row-tile
chunks between steps, and an atomic flip promotes them with zero dropped
requests.  SPEC is ``ft:<scale>`` (the serving params plus a scaled
fine-tune delta), ``seed:<int>`` (a fresh init), ``init`` (the serving
params themselves) or a checkpoint directory (its latest step, written
by either package's ``CheckpointManager``).

``--multiplex SPEC,SPEC[,SPEC...]`` (crossbar backend only) serves N
checkpoints (tenants A, B, C, ...) from the plane banks of one executor:
requests round-robin across the tenants, each tenant reads its own
resident plane, and the physical device count is one deployment's.
SPECs are those of ``--hot-swap``.  ``--stack-planes N`` sets the bank
height (the paper's geometry is 2), ``--qos W,W,...`` gives per-tenant
QoS weights (the slot and page split and the lane order) and
``--kv-pages N`` the page budget the weights split per tenant.  Under
``--multiplex``, ``--hot-swap`` targets the last tenant: with a full bank
its planes are rewritten in place under the other tenants' traffic.

``--prefix-share`` aliases the KV pages of a prefilled head that a new
request repeats (copy-on-write where it diverges inside a page), and
``--preemption`` lets a higher-QoS request evict a lower one when the
pool saturates (the later half of the requests arrive at QoS 2); both
need ``--kv paged`` and print a summary line.  ``--common-prefix N``
puts one N-token head before every synthetic prompt, and ``--stagger
N`` submits request i at step i * N.

``--metrics-out FILE.jsonl`` writes the telemetry at exit (request and
swap spans, then every metric sample), ``--metrics-interval N`` prints a
stats line every N steps, ``--no-telemetry`` turns the scheduler's
metrics and spans off, and ``--tile-rows`` sets the crossbar tile's
wordlines.

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain
PyTorch path on the CPU.  ``--layers N`` cuts the configuration's depth
(never its width).  On the card every window step after the first runs
as one captured CUDA graph (``BatchScheduler``); no flag turns that off.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.device import DeviceConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import BatchScheduler, Request
from repro_torch.serve.hotswap import finetune_delta


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


def resolve_swap_params(spec: str, model, params):
    """``--hot-swap`` / ``--multiplex`` spec resolution: ``init`` (the
    serving params, tenant A's) | ``seed:<int>`` | ``ft:<scale>`` | a
    checkpoint directory (its latest step, restored into the structure of
    ``params``: a params tree saved by either package)."""
    if spec == "init":
        return params
    if spec.startswith("seed:"):
        try:
            seed = int(spec[5:])
        except ValueError:
            raise SystemExit(f"--hot-swap: {spec!r} needs an integer seed")
        return model.init(seed)
    if spec.startswith("ft:"):
        try:
            scale = float(spec[3:])
        except ValueError:
            raise SystemExit(f"--hot-swap: {spec!r} needs a float scale")
        return finetune_delta(params, scale=scale)
    if os.path.isdir(spec):
        from repro_torch.checkpoint.manager import CheckpointManager
        return CheckpointManager(spec).restore(target=params)
    raise SystemExit(f"--hot-swap: unknown spec {spec!r} "
                     f"(want init, ft:<scale>, seed:<int>, or a "
                     f"checkpoint dir)")


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
    """A parsed command line and the model and params it builds: tenant
    A's params, and under ``--multiplex`` every tenant's ``(params,
    weight)``."""
    args: argparse.Namespace
    model: Any
    params: Any
    mode_policy: Any
    device: torch.device
    tenants: Optional[Dict[str, Any]] = None
    tenant_ids: Tuple[str, ...] = ("A",)

    def scheduler(self, capture=None) -> BatchScheduler:
        """The command line's scheduler (programming the weights);
        ``capture`` as ``BatchScheduler`` takes it."""
        a = self.args
        return BatchScheduler(self.model, self.params, n_slots=a.slots,
                              max_len=a.max_len, tenants=self.tenants,
                              kv=a.kv, page_size=a.page_size,
                              kv_pages=a.kv_pages, chunk=a.chunk,
                              prefix_share=a.prefix_share,
                              preemption=a.preemption,
                              mode_policy=self.mode_policy,
                              telemetry=not a.no_telemetry, capture=capture)

    def requests(self) -> List[Request]:
        """The command line's synthetic requests (seeded prompts, behind
        one ``--common-prefix`` head from a second seeded generator),
        round-robin across the tenants; under ``--preemption`` the later
        half at QoS 2."""
        a = self.args
        vocab = self.model.cfg.vocab
        gen = torch.Generator()
        gen.manual_seed(1)
        head_gen = torch.Generator()
        head_gen.manual_seed(2)
        head = torch.randint(0, vocab - 1, (a.common_prefix,),
                             generator=head_gen, dtype=torch.int32)
        ids = self.tenant_ids
        reqs = []
        for rid in range(a.requests):
            prompt = torch.randint(0, vocab - 1, (a.prompt_len,),
                                   generator=gen, dtype=torch.int32)
            if a.common_prefix:
                prompt = torch.cat([head, prompt])
            qos = 2.0 if a.preemption and rid >= a.requests // 2 else 1.0
            reqs.append(Request(rid=rid, prompt=prompt, max_new=a.max_new,
                                model_id=ids[rid % len(ids)], qos=qos))
        return reqs


def drive(sched: BatchScheduler, reqs: List[Request],
          device: torch.device, swap_params=None, swap_after: int = 0,
          swap_chunks: int = 8, swap_tenant: str = "A",
          on_step: Optional[Callable[[int], None]] = None,
          stagger: int = 0) -> Dict[str, Any]:
    """Submit ``reqs`` (request i before step ``i * stagger``) and step
    until all finish: the requests, tokens, steps, wall seconds, tokens/s
    and each step's wall seconds (a step ends with its tokens on the
    host).

    With ``swap_params`` a hot-swap of ``swap_tenant`` begins once
    ``swap_after`` requests have finished; if the requests drain first,
    the loop steps on until the swap promotes.  ``swap_phase`` labels
    each step: ``"window"`` (chunks programmed, the old planes serving),
    ``"flip"`` (the last chunks, the promotion, and the step on the new
    planes) or ``"-"``."""
    n_submitted = 0
    done: List[Request] = []
    step_s: List[float] = []
    phase: List[str] = []

    def one_step():
        in_flight = sched.swap_in_flight
        t = time.perf_counter()
        out = sched.step()
        step_s.append(time.perf_counter() - t)
        phase.append("window" if sched.swap_in_flight
                     else "flip" if in_flight else "-")
        if on_step is not None:
            on_step(len(step_s))
        return out

    t0 = time.perf_counter()
    while len(done) < len(reqs) and len(step_s) < 10_000:
        while (n_submitted < len(reqs)
               and len(step_s) >= n_submitted * stagger):
            sched.submit(reqs[n_submitted])
            n_submitted += 1
        if (swap_params is not None and not sched.swap_in_flight
                and not sched.swap_history and len(done) >= swap_after):
            hs = sched.begin_hot_swap(swap_params,
                                      chunks_per_step=swap_chunks,
                                      tenant=swap_tenant)
            print(f"hot-swap: staging {hs.plan.total_chunks} chunks onto "
                  f"tenant {hs.tenant}'s write planes after {len(done)} "
                  f"requests ({len(step_s)} decode steps)")
        done += one_step()
    # requests can drain before the chunked swap completes — finish the
    # deployment rather than abandon a half-written shadow plane (idle
    # steps still program chunks and promote at the boundary)
    if sched.swap_in_flight:
        print("hot-swap: requests drained mid-swap; finishing shadow "
              "programming before exit")
        while sched.swap_in_flight and len(step_s) < 20_000:
            one_step()
    _sync(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in done)
    return {"requests": done, "tokens": total_tokens, "steps": len(step_s),
            "seconds": dt, "tok_per_s": total_tokens / max(dt, 1e-9),
            "step_s": step_s, "swap_phase": phase}


#: the scheduler's page-pool policy counters (prefix sharing, preemption)
KV_COUNTERS = ("serve_kv_pages_shared_total", "serve_kv_shared_tokens_total",
               "serve_kv_cow_total", "serve_preemptions_total")


def kv_counts(sched: BatchScheduler) -> Dict[str, int]:
    """Each of ``KV_COUNTERS`` summed over the tenants (0 with telemetry
    off)."""
    return {name: int(sched.metrics.total(name)) for name in KV_COUNTERS}


def parse_args(argv=None) -> argparse.Namespace:
    """The command line ``argv``, checked (a contradiction exits)."""
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
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="per-tenant page-pool budget for the "
                         "QoS-weighted split (default: slots * max_len "
                         "/ page_size pages per lane, i.e. no "
                         "oversubscription)")
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
    ap.add_argument("--prefix-share", action="store_true",
                    help="refcounted prefix sharing: requests whose "
                         "prompt head matches fully-written pages of a "
                         "resident request alias those pages instead of "
                         "re-filling them (copy-on-write on sub-page "
                         "divergence); requires --kv paged")
    ap.add_argument("--preemption", action="store_true",
                    help="QoS preemption: when the page pool or a "
                         "tenant budget saturates, evict the lowest-QoS "
                         "in-flight request (its pages reclaim; the "
                         "request re-admits via chunked prefill with a "
                         "bit-identical stream); requires --kv paged")
    ap.add_argument("--common-prefix", type=int, default=0, metavar="N",
                    help="prepend the same N-token head to every "
                         "synthetic prompt (a shared system prompt) so "
                         "--prefix-share has aliasable pages to find")
    ap.add_argument("--stagger", type=int, default=0, metavar="N",
                    help="submit request i at decode step i*N instead "
                         "of all upfront; sharing needs the head "
                         "request's prompt pages written (and still "
                         "resident) before a follower admits")
    ap.add_argument("--tile-rows", type=int, default=None,
                    help="override crossbar tile rows (wordlines per "
                         "plane); expansion fusing pairs row tiles "
                         "across the two planes, so it needs an even "
                         "count >= 2 per weight")
    ap.add_argument("--hot-swap", default=None, metavar="SPEC",
                    help="second checkpoint to deploy mid-serving "
                         "(ft:<scale> | seed:<int> | init | a checkpoint "
                         "dir); requires --backend crossbar")
    ap.add_argument("--multiplex", default=None,
                    metavar="SPEC,SPEC[,SPEC...]",
                    help="serve N checkpoints (tenants A,B,C,...) from "
                         "the plane bank of one executor (specs as in "
                         "--hot-swap); requires --backend crossbar and "
                         "stack-planes >= N")
    ap.add_argument("--stack-planes", type=int, default=None,
                    help="bank height: planes stacked per cell site "
                         "(default: the device model's 2, the paper "
                         "geometry)")
    ap.add_argument("--qos", default=None, metavar="W,W[,W...]",
                    help="per-tenant QoS weights for --multiplex (one "
                         "float per spec, e.g. 2,1,1): weighted slot "
                         "split + admission order in the scheduler")
    ap.add_argument("--swap-after", type=int, default=None,
                    help="begin the swap once this many requests finished "
                         "(default: half)")
    ap.add_argument("--swap-chunks", type=int, default=8,
                    help="shadow-plane chunks programmed per decode step")
    ap.add_argument("--metrics-out", default=None, metavar="FILE.jsonl",
                    help="write the telemetry at exit: one JSON object per "
                         "line — request and swap spans, then every metric "
                         "sample")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    metavar="N",
                    help="print a one-line stats banner every N decode "
                         "steps (0 = off)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable scheduler metrics and span collection")
    args = ap.parse_args(argv)
    if args.no_telemetry and (args.metrics_out or args.metrics_interval):
        raise SystemExit("--no-telemetry contradicts --metrics-out / "
                         "--metrics-interval")
    if args.hot_swap and args.backend != "crossbar":
        raise SystemExit("--hot-swap requires --backend crossbar")
    if args.multiplex and args.backend != "crossbar":
        raise SystemExit("--multiplex requires --backend crossbar")
    if args.stream_pages and args.kv != "paged":
        raise SystemExit("--stream-pages routes paged attention; it "
                         "requires --kv paged")
    if args.mode_policy and args.backend != "crossbar":
        raise SystemExit("--mode-policy requires --backend crossbar")
    if (args.prefix_share or args.preemption) and args.kv != "paged":
        raise SystemExit("--prefix-share/--preemption operate on the "
                         "page pool; they require --kv paged")
    return args


def setup(argv=None) -> Setup:
    """Parse ``argv`` and build the model and its random params."""
    args = parse_args(argv)
    mode_policy = parse_mode_policy(args.mode_policy)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family in ("encdec", "vlm", "rwkv6", "zamba2"):
        raise SystemExit("scheduler demo targets decoder LMs; "
                         "see serve.engine.greedy_generate for other "
                         "families")
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
    if args.tile_rows is not None:
        cfg = dataclasses.replace(
            cfg, xbar=dataclasses.replace(cfg.xbar,
                                          tile_rows=args.tile_rows))
    if args.stack_planes is not None:
        cfg = dataclasses.replace(
            cfg, xbar=dataclasses.replace(
                cfg.xbar, device=DeviceConfig(
                    stack_planes=args.stack_planes)))
    model = build_model(cfg, device=device)
    params = model.init(0)
    tenants = None
    tenant_ids: Tuple[str, ...] = ("A",)
    if args.multiplex:
        specs = args.multiplex.split(",")
        if len(specs) < 2:
            raise SystemExit("--multiplex wants >= 2 comma-separated "
                             "specs, e.g. init,ft:0.02 or "
                             "init,ft:0.02,seed:7")
        names = model.executor.tenant_names
        if len(specs) > len(names):
            raise SystemExit(
                f"--multiplex {len(specs)} tenants > {len(names)} plane "
                f"slots; raise --stack-planes to {len(specs)}")
        tenant_ids = tuple(names[:len(specs)])
        weights = [1.0] * len(specs)
        if args.qos:
            try:
                weights = [float(w) for w in args.qos.split(",")]
            except ValueError:
                raise SystemExit(f"--qos: {args.qos!r} wants floats")
            if len(weights) != len(specs):
                raise SystemExit(f"--qos wants one weight per "
                                 f"--multiplex spec ({len(specs)})")
        tenants = {
            t: (resolve_swap_params(s, model, params), w)
            for t, s, w in zip(tenant_ids, specs, weights)}
        params = tenants["A"][0]
    elif args.qos:
        raise SystemExit("--qos only applies under --multiplex")
    return Setup(args, model, params, mode_policy, device, tenants,
                 tenant_ids)


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

    reqs = st.requests()
    swap_params = (resolve_swap_params(args.hot_swap, st.model, st.params)
                   if args.hot_swap else None)
    swap_after = (args.swap_after if args.swap_after is not None
                  else args.requests // 2)

    def stats_banner(steps):
        if not args.metrics_interval or steps % args.metrics_interval:
            return
        reg = sched.metrics
        parts = []
        for t in sched.tenants:
            n = int(reg.total("serve_tokens_total", tenant=t))
            e = reg.total("serve_device_energy_joules_total", tenant=t)
            pj = e / n * 1e12 if n else 0.0
            parts.append(f"{t}:{n}tok/{pj:.0f}pJ")
        retr = int(obs.registry().total("serve_jit_retraces_total"))
        print(f"[obs] step {steps}: {int(reg.total('serve_tokens_total'))} "
              f"tokens ({', '.join(parts)}); jit retraces {retr}")

    rep = drive(sched, reqs, device, swap_params=swap_params,
                swap_after=swap_after, swap_chunks=args.swap_chunks,
                swap_tenant=st.tenant_ids[-1], on_step=stats_banner,
                stagger=args.stagger)
    done = rep["requests"]
    print(f"served {len(done)} requests, {rep['tokens']} tokens in "
          f"{rep['steps']} decode steps, {rep['seconds']:.2f}s "
          f"({rep['tok_per_s']:.1f} tok/s)")
    caps = sched.capture_report()
    ms = [t * 1e3 for t in rep["step_s"]]
    for t, cap in caps.items():
        if cap["capture"]:
            print(f"window step [{t}]: {cap['captures']} CUDA graph "
                  f"capture(s), {cap['replays']} replays, "
                  f"{cap['eager_steps']} eager warm-up step(s)")
    if sched.capture:
        print("step ms " + ", ".join(f"{t:.1f}" for t in ms[:2])
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
    if (args.prefix_share or args.preemption) and sched.metrics.enabled:
        reg = sched.metrics
        if args.prefix_share:
            print(f"prefix sharing: "
                  f"{int(reg.total('serve_kv_pages_shared_total'))} pages "
                  f"aliased, "
                  f"{int(reg.total('serve_kv_shared_tokens_total'))} "
                  f"prompt tokens skipped, "
                  f"{int(reg.total('serve_kv_cow_total'))} copy-on-write "
                  f"page copies")
        if args.preemption:
            n_evict = int(reg.total("serve_preemptions_total"))
            print(f"preemption: {n_evict} evictions, "
                  f"{sum(r.preemptions for r in done)} re-admissions, "
                  f"zero dropped requests")
    if st.tenants:
        qos = sched.qos_report()
        for t in sched.tenants:
            mine = [r for r in done if r.model_id == t]
            q = qos[t]
            print(f"  tenant {t}: {len(mine)} requests, "
                  f"{sum(len(r.out) for r in mine)} tokens; qos "
                  f"weight={q['weight']:g} slots={q['slots']} "
                  f"share={q['token_share'] * 100:.1f}% "
                  f"(fingerprint={ex.fingerprint(tenant=t)})")
    for r in done[:3]:
        print(f"  req {r.rid} [{r.model_id}]: {r.out[:8]}...")
    for h in sched.swap_history:
        print(f"hot-swap promoted [{h['policy']} tenant {h['tenant']}]: "
              f"version={ex.version(h['tenant'])} "
              f"fingerprint={ex.fingerprint(tenant=h['tenant'])} "
              f"wall={h['wall_swap_s']:.2f}s "
              f"({h['decode_steps_during_swap']} decode steps served "
              f"during the swap, zero dropped) swap_mode={h['swap_mode']}")
        print(f"  device-time: overlapped window "
              f"{h['device_swap_window_overlapped_s'] * 1e6:.1f}us vs "
              f"stop-the-world "
              f"{h['device_swap_window_stop_world_s'] * 1e6:.1f}us; "
              f"throughput-during-swap ratio "
              f"{h['throughput_ratio_overlap_vs_stop_world']:.2f}x; "
              f"steady-state overlap "
              f"{h['overlap_frac_steady_state'] * 100:.1f}% at "
              f"{h['in_bits']}-bit reads (paper: ~29% at 10-bit)")
    if ex is not None and sched.metrics.enabled:
        # traffic-weighted device figures (per emitted token; see
        # sched.mode_report()["traffic"])
        for t in sched.tenants:
            n = int(sched.metrics.total("serve_tokens_total", tenant=t))
            if not n:
                continue
            for mode in ("expansion", "deepnet"):
                e = sched.metrics.total(
                    "serve_device_energy_joules_total", tenant=t, mode=mode)
                r = sched.metrics.total(
                    "serve_device_read_seconds_total", tenant=t, mode=mode)
                if e:
                    print(f"  device [{t}/{mode}]: {r * 1e6:.1f}us read, "
                          f"{e / n * 1e12:.0f} pJ/token over {n} tokens")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(sched.tracer.to_jsonl())
            f.write(sched.metrics.to_jsonl())
            f.write(obs.tracer().to_jsonl())
            f.write(obs.registry().to_jsonl())
        n_spans = len(sched.tracer) + len(obs.tracer())
        print(f"telemetry: wrote {n_spans} spans + metric samples to "
              f"{args.metrics_out}")
        print("# --- Prometheus snapshot (scheduler + global) ---")
        print(sched.metrics.to_prometheus(), end="")
        print(obs.registry().to_prometheus(), end="")
    rep.update(program_s=program_s, capture=caps["A"], captures=caps,
               swap_history=list(sched.swap_history),
               version=ex.version() if ex is not None else None,
               versions=({t: ex.version(t) for t in sched.tenants}
                         if ex is not None else None),
               qos=sched.qos_report(), kv=sched.kv_report(),
               kv_counts=kv_counts(sched))
    if mode_policy is not None:
        rep["mode_report"] = sched.mode_report()
    return rep


if __name__ == "__main__":
    main()
