"""Batched serving runtime: the paged continuous-batching scheduler
(PyTorch).

The scheduler serves its tenant through ONE window step of fixed shape
``(width, chunk)`` with per-row valid counts.  Newly admitted prompts
join the running batch as prefill *chunks* — rows mid prompt consume
``chunk`` tokens per step, decoding rows consume one — so admission
never stalls an in-flight decode step.  KV storage is a block-paged pool
(serve/kv_pool.py): fixed-size pages, per-slot page tables, free-list
allocation at admission and reclaim at completion.

The window step is the reference's compiled step: on the card it runs
once eagerly as a warm-up, is captured into one CUDA graph per lane at
its second call, and is replayed on every later step, over static device
buffers that the scheduler refills in place (``_WindowStep``).  Each
capture counts as a trace (``serve_jit_traces_total{closure="decode"}``),
as the reference counts its jit traces.  ``capture=False`` runs the same
body eagerly; it is the CPU's step, and on the card the witness the
captured step is held against.

This slice serves one tenant, with the executor's per-weight read-mode
policy (``mode_policy``) and its :meth:`BatchScheduler.mode_report`.
Hot-swap, multi-tenant multiplexing with QoS weights, prefix sharing and
preemption are later slices of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.executor import flatten_with_path
from repro_torch.kernels import launch_counts
from repro_torch.models.model import Model
from repro_torch.serve.kv_pool import PagedKVPool, default_pool_pages

TENANT = "A"


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is a later slice of the PyTorch port (ROADMAP.md); this "
        f"slice's BatchScheduler serves one tenant")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Any                # (S,) int tokens (numpy, list or tensor)
    max_new: int
    model_id: str = TENANT     # tenant whose checkpoint serves this request
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # chunked-prefill progress: prompt tokens already fed to the window
    # step (scheduler-owned; the first token emits once fed == len)
    fed: int = 0
    # the admission feed (scheduler-owned): the prompt tokens
    feed: Optional[np.ndarray] = None
    # pages the pool allocated at admission (None on the dense path)
    bucket: Optional[int] = None
    # lifecycle timestamps (scheduler tracer clock): queue_wait
    # [t_submit, t_admit] + prefill [t_admit, t_first] + decode
    # [t_first, t_done] = request wall time
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


class _WindowStep:
    """One lane's window step ``(params, tokens, m, leak) -> token`` over
    static device buffers: ``tokens`` (width, chunk) int32, ``m`` (width,)
    int32, ``leak`` 0-d float32 and ``token`` (width,) int32, beside the
    lane's cache, whose K/V pools, fill markers and page tables keep their
    storage for the scheduler's life (admission and release write them
    in place).

    ``tokens`` is the fixed window; ``m`` the per-row valid counts (chunk
    tokens for a row mid-prompt, 1 for a decoding row, 0 for an empty
    slot).  The fill marker is pinned to ``old_len + m``, so pad positions
    past a row's count are never attendable, and the token emitted at row
    position ``m - 1`` equals an unpadded reference's.  ``leak`` is the
    write-plane leakage (0.0 in this slice), which the MAC reads from
    device memory.

    With ``capture`` the first call runs eagerly as the warm-up (kernels
    built, the allocator warm; its result is used), the second is
    captured into one CUDA graph in the scheduler's memory pool and
    replayed for its result, and every later call replays the graph.
    The capture is the closure's trace (``obs.note_jit_trace``); a host
    sync or a CUDA call that is no stream operation inside it raises.
    Without ``capture`` every call runs the same body eagerly, and the
    closure's first call is its trace.  A new params tree drops the graph
    and builds the closure anew, whose first trace is no retrace (the
    reference's fresh counter at a rebuild).
    """

    def __init__(self, model: Model, cache: Dict[str, Any], width: int,
                 chunk: int, tenant: str, capture: bool, pool=None):
        dev = model.device
        self.model, self.cache, self.tenant = model, cache, tenant
        self.capture, self.pool = capture, pool
        self.tokens = torch.zeros((width, chunk), dtype=torch.int32,
                                  device=dev)
        self.m = torch.zeros((width,), dtype=torch.int32, device=dev)
        self.leak = torch.zeros((), dtype=torch.float32, device=dev)
        self.token = torch.zeros((width,), dtype=torch.int32, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._leaves: Optional[Tuple[Any, ...]] = None
        self._warm = False
        self._traces = 0                  # traces of the current closure
        self.stats = {"captures": 0, "replays": 0, "eager_steps": 0}
        #: kernel launches one replay runs (recorded at the capture)
        self.launches_per_replay: Dict[str, int] = {}

    def __call__(self, params, tokens: np.ndarray, m: np.ndarray,
                 leak: torch.Tensor) -> torch.Tensor:
        leaves = tuple(w for _, w in flatten_with_path(params))
        if self._leaves is None or len(leaves) != len(self._leaves) or any(
                a is not b for a, b in zip(leaves, self._leaves)):
            self._build(params, leaves)
        self.tokens.copy_(torch.from_numpy(tokens))
        self.m.copy_(torch.from_numpy(m))
        self.leak.copy_(leak)
        if self.graph is not None:
            self.graph.replay()
            self.stats["replays"] += 1
        elif self.capture and self._warm:
            self._capture(params)
        else:
            with self._reading():
                self._body(params)
            self.stats["eager_steps"] += 1
            if self.capture:
                self._warm = True
            elif self._traces == 0:
                self._note_trace()
        return self.token

    def _build(self, params, leaves) -> None:
        """A new closure for ``params``: programming is host work, done
        here and never inside a capture."""
        ex = self.model.executor
        if ex is not None:
            ex.ensure_programmed(params)
        self.graph, self._warm, self._traces = None, False, 0
        self._leaves = leaves

    def _note_trace(self) -> None:
        self._traces += 1
        obs.note_jit_trace("decode", self.tenant, retrace=self._traces > 1)

    @contextlib.contextmanager
    def _reading(self):
        """No autograd, and reads on the resident tiles with this step's
        leak buffer (the executor's Python state, entered before a
        capture)."""
        ex = self.model.executor
        with torch.no_grad():
            if ex is None:
                yield
            else:
                with ex.activate(), ex.leak_scope(self.leak):
                    yield

    def _body(self, params) -> None:
        fill = self.cache["layers"]["len"]                 # (L, B)
        old = fill.clone()
        logits, _ = self.model.decode_step(params, self.tokens, self.cache)
        fill.copy_(old + self.m[None, :])
        idx = torch.clamp(self.m - 1, min=0).to(torch.int64)
        sel = logits[torch.arange(logits.shape[0], device=logits.device),
                     idx]
        self.token.copy_(torch.argmax(sel.to(torch.float32), dim=-1))

    def _capture(self, params) -> None:
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with self._reading(), torch.cuda.graph(graph, pool=self.pool):
            self._body(params)
        self.launches_per_replay = {
            k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n != before.get(k, 0)}
        self.graph = graph
        self.stats["captures"] += 1
        self._note_trace()
        graph.replay()             # the capture recorded; this step runs
        self.stats["replays"] += 1


@dataclasses.dataclass
class _Lane:
    """The tenant's serving state: a fixed slot batch with its cache,
    queue and window step."""
    tenant: str
    params: Any
    slots: List[Optional[Request]]
    cache: Any
    queue: List[Request]
    decode: _WindowStep
    pool: Optional[PagedKVPool] = None
    width: int = 0
    # modeled per-token device read cost by mode (crossbar backend)
    device_cost: Optional[Dict[str, Dict[str, float]]] = None
    # tokens emitted by this lane (admission + decode)
    tokens_served: int = 0


class BatchScheduler:
    """Paged continuous-batching scheduler (ragged, one tenant).

    Per step, every occupied slot contributes either its next ``chunk``
    prompt tokens (admission prefill, emitting its first token on the
    final chunk) or one generated token (decode); the per-row valid
    count ``m`` pins each row's cache fill marker, and pad positions are
    causally masked, so the streams equal an unpadded per-request
    reference.  ``kv="paged"`` (default) stores K/V in a block-paged
    pool; ``kv="dense"`` keeps a per-slot dense cache — same step, same
    streams.

    ``capture`` (default: on the card, not on the CPU) runs each lane's
    window step as one CUDA graph, captured once and replayed
    (``_WindowStep``); ``capture=False`` on the card keeps the eager step
    as the witness the captured one is held against.
    """

    def __init__(self, model: Model, params, n_slots: int, max_len: int,
                 tenants: Optional[Dict[str, Any]] = None,
                 mode_policy=None, telemetry: bool = True,
                 kv: str = "paged", page_size: int = 8, chunk: int = 4,
                 prefix_share: bool = False, preemption: bool = False,
                 capture: Optional[bool] = None):
        if tenants is not None and set(tenants) != {TENANT}:
            raise _later("multi-tenant multiplexing (tenants=...)")
        if prefix_share:
            raise _later("prefix sharing (prefix_share=True)")
        if preemption:
            raise _later("QoS preemption (preemption=True)")
        if kv not in ("paged", "dense"):
            raise ValueError(f"kv must be 'paged' or 'dense', got {kv!r}")
        if kv == "paged" and max_len % page_size:
            raise ValueError(f"page_size {page_size} must divide max_len "
                             f"{max_len}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if mode_policy is not None and model.executor is None:
            raise RuntimeError(
                "mode_policy selects per-weight crossbar read modes; it "
                "requires the crossbar backend "
                "(ModelConfig(backend='crossbar'))")
        if capture is None:
            capture = model.device.type == "cuda"
        if capture and model.device.type != "cuda":
            raise ValueError("capture=True records the window step as a "
                             "CUDA graph; it needs the model on the card")
        if tenants is not None:
            params = tenants[TENANT]
        self.model = model
        self.device = model.device
        self.capture = bool(capture)
        # one memory pool for every lane's graph
        self._graph_pool = (torch.cuda.graph_pool_handle() if capture
                            else None)
        self.n_slots, self.max_len = n_slots, max_len
        self.kv, self.page_size, self.chunk = kv, page_size, int(chunk)
        self.pages_per_seq = (max_len // page_size if kv == "paged"
                              else 0)
        # per-scheduler telemetry: request lifecycle, token latency,
        # modeled device time/energy; process-wide signals (engine
        # dispatch counters) live in obs.registry()
        self.metrics = obs.MetricsRegistry(enabled=telemetry)
        self.tracer = obs.Tracer(enabled=telemetry)
        executor = model.executor
        if executor is not None:
            # crossbar backend: program the weights ONCE at construction
            # (program-at-load, read-at-inference); mode_policy decides
            # each weight's plane layout here, and reads follow it
            executor.ensure_programmed(params, mode_policy=mode_policy)
        self._lane = self._make_lane(params)

    # -- telemetry helpers ---------------------------------------------------

    def _account_tokens(self, lane: _Lane, n: int, kind: str) -> None:
        """Count ``n`` emitted tokens, plus modeled device-read time and
        energy split by read mode."""
        if n <= 0:
            return
        lane.tokens_served += n
        if not self.metrics.enabled:
            return
        self.metrics.counter(
            "serve_tokens_total",
            help="tokens emitted, by tenant and kind "
                 "(admission|decode)").inc(n, tenant=lane.tenant, kind=kind)
        for mode, c in (lane.device_cost or {}).items():
            self.metrics.counter(
                "serve_device_read_seconds_total",
                help="modeled device read time spent producing tokens, "
                     "by read mode (t_read accounting)").inc(
                n * c["read_s"], tenant=lane.tenant, mode=mode)
            self.metrics.counter(
                "serve_device_energy_joules_total",
                help="modeled worst-case analog read energy spent "
                     "producing tokens, by read mode").inc(
                n * c["energy_j"], tenant=lane.tenant, mode=mode)

    def _finish_request(self, lane: _Lane, req: Request) -> None:
        """Completion bookkeeping: counter + the request's span set."""
        req.done = True
        self.metrics.counter(
            "serve_requests_completed_total",
            help="requests that emitted their full max_new budget").inc(
                tenant=lane.tenant)
        tr = self.tracer
        if not tr.enabled or req.t_submit is None:
            return
        tr.record("queue_wait", req.t_submit, req.t_admit,
                  rid=req.rid, tenant=lane.tenant)
        tr.record("prefill", req.t_admit, req.t_first,
                  rid=req.rid, tenant=lane.tenant, bucket=req.bucket)
        tr.record("decode", req.t_first, req.t_done,
                  rid=req.rid, tenant=lane.tenant, n_tokens=len(req.out))
        tr.record("request", req.t_submit, req.t_done,
                  rid=req.rid, tenant=lane.tenant, bucket=req.bucket,
                  n_tokens=len(req.out),
                  ttft_s=req.t_first - req.t_submit)

    # -- the lane --------------------------------------------------------------

    def _make_lane(self, params) -> _Lane:
        n = self.n_slots
        ex = self.model.executor
        pool = None
        if self.kv == "paged":
            n_pages = default_pool_pages(n, self.max_len, self.page_size)
            pool = PagedKVPool(n_pages, self.page_size, self.max_len, n)
            cache = self.model.init_paged_cache(n, self.max_len, n_pages,
                                                self.page_size)
        else:
            cache = self.model.init_cache(n, self.max_len)
        step = _WindowStep(self.model, cache, n, self.chunk, TENANT,
                           self.capture, self._graph_pool)
        return _Lane(tenant=TENANT, params=params, slots=[None] * n,
                     cache=cache, queue=[], decode=step,
                     pool=pool, width=n,
                     device_cost=(ex.device_token_cost(TENANT)
                                  if ex is not None else None))

    def submit(self, req: Request):
        if req.model_id != TENANT:
            raise ValueError(
                f"request {req.rid} routes to unknown tenant "
                f"{req.model_id!r}; serving [{TENANT!r}]")
        req.t_submit = self.tracer.now()
        self.metrics.counter(
            "serve_requests_submitted_total",
            help="requests accepted into a tenant queue").inc(tenant=TENANT)
        self._lane.queue.append(req)

    # -- later slices ----------------------------------------------------------

    def set_weights(self, weights: Dict[str, float]) -> None:
        raise _later("QoS weights (set_weights)")

    def begin_hot_swap(self, new_params, chunks_per_step: int = 8,
                       tenant: str = TENANT):
        raise _later("hot-swap (begin_hot_swap)")

    def stop_the_world_swap(self, new_params, tenant: str = TENANT):
        raise _later("hot-swap (stop_the_world_swap)")

    # -- admission (host bookkeeping only: slots + pages) --------------------

    def _leak_now(self) -> torch.Tensor:
        ex = self.model.executor
        return (ex.current_leak_codes() if ex is not None
                else self._lane.decode.leak)

    def _admit(self, lane: _Lane) -> None:
        """Move queued requests into free slots: a slot index, a
        page-table row and a fill marker — host bookkeeping, so admission
        never stalls an in-flight step.  When the pool cannot cover a
        request's whole lifetime (``min(prompt + max_new - 1, max_len)``
        tokens, claimed up front) the request waits in FIFO order."""
        while lane.queue:
            req = lane.queue[0]
            feed = np.asarray(
                req.prompt.cpu() if torch.is_tensor(req.prompt)
                else req.prompt, dtype=np.int32).reshape(-1)
            plen = int(feed.shape[0])
            if plen - 1 >= self.max_len:
                # the last real token's K/V lands at position plen - 1
                raise ValueError(f"prompt length {plen} exceeds the "
                                 f"scheduler's max_len {self.max_len}")
            free = [i for i, s in enumerate(lane.slots) if s is None]
            if not free:
                return
            row = free[0]
            layers = lane.cache["layers"]
            if lane.pool is not None:
                need = min(plen + req.max_new - 1, self.max_len)
                if not lane.pool.can_alloc(need):
                    return                        # backpressure: wait, FIFO
                pages = lane.pool.alloc(row, need)
                req.bucket = len(pages)
                tab = torch.from_numpy(lane.pool.table_row(row))
                layers["pt"][:, row] = tab.to(self.device)[None]
            layers["len"][:, row] = 0
            lane.queue.pop(0)
            req.feed = feed
            req.fed = 0
            if req.t_admit is None:
                req.t_admit = self.tracer.now()
                if self.metrics.enabled and req.t_submit is not None:
                    self.metrics.histogram(
                        "serve_queue_wait_seconds",
                        help="submit-to-admission wait").observe(
                        req.t_admit - req.t_submit, tenant=lane.tenant)
            lane.slots[row] = req

    def _release_slot(self, lane: _Lane, row: int) -> None:
        """Return a completed slot: reclaim its pages and null its table
        row so stale writes land on the null page."""
        lane.slots[row] = None
        layers = lane.cache["layers"]
        if lane.pool is not None:
            lane.pool.free_row(row)
            layers["pt"][:, row] = 0
        layers["len"][:, row] = 0

    def step(self) -> List[Request]:
        """One window step over the active slots; returns the requests
        that finished.  Each occupied row contributes its next prompt
        chunk or its last generated token; empty rows ride along at
        ``m = 0``.  One fixed-shape call serves them all."""
        lane = self._lane
        finished: List[Request] = []
        self._admit(lane)
        if all(s is None for s in lane.slots):
            return finished
        c = self.chunk
        toks = np.zeros((lane.width, c), np.int32)
        m = np.zeros((lane.width,), np.int32)
        emit: List[Optional[str]] = [None] * lane.width
        for i, req in enumerate(lane.slots):
            if req is None:
                continue
            flen = int(req.feed.shape[0])
            if req.fed < flen:
                piece = req.feed[req.fed:req.fed + c]
                toks[i, :piece.shape[0]] = piece
                m[i] = piece.shape[0]
                req.fed += int(piece.shape[0])
                if req.fed >= flen:
                    emit[i] = "admission"     # final chunk: first token
            else:
                toks[i, 0] = req.out[-1]
                m[i] = 1
                emit[i] = "decode"
        t0 = self.tracer.now()
        tok = lane.decode(lane.params, toks, m, self._leak_now())
        tok_host = tok.cpu().numpy()
        n_admit = n_dec = 0
        for i, req in enumerate(lane.slots):
            if req is None or emit[i] is None:
                continue
            req.out.append(int(tok_host[i]))
            if emit[i] == "admission":
                req.t_first = self.tracer.now()
                n_admit += 1
                if self.metrics.enabled and req.t_submit is not None:
                    self.metrics.histogram(
                        "serve_ttft_seconds",
                        help="submit to first emitted token").observe(
                        req.t_first - req.t_submit, tenant=lane.tenant)
            else:
                n_dec += 1
            if len(req.out) >= req.max_new:
                req.t_done = self.tracer.now()
                self._finish_request(lane, req)
                finished.append(req)
                self._release_slot(lane, i)
        self._account_tokens(lane, n_admit, "admission")
        self._account_tokens(lane, n_dec, "decode")
        if self.metrics.enabled and (n_admit + n_dec):
            # every emitted token materialized in this one batched step,
            # so the per-token latency IS the step wall time
            dt = self.tracer.now() - t0
            h = self.metrics.histogram(
                "serve_token_latency_seconds",
                help="wall time of the step that produced each token")
            for _ in range(n_admit + n_dec):
                h.observe(dt, tenant=lane.tenant)
        return finished

    def capture_report(self) -> Dict[str, Dict[str, Any]]:
        """Per lane: whether its window step captures, its captures,
        replays and eager steps, and the kernel launches one replay runs
        (so a serve ran ``launches_per_replay x replays`` launches from
        its graphs beside those the wrappers counted eagerly)."""
        d = self._lane.decode
        return {TENANT: {"capture": d.capture, **d.stats,
                         "launches_per_replay": dict(d.launches_per_replay)}}

    def kv_report(self) -> Dict[str, Dict[str, Any]]:
        """Page-pool accounting (paged lane only), including the
        conservation invariant ``pages_in_use + pages_free == n_pages``."""
        lane = self._lane
        return {TENANT: lane.pool.report()} if lane.pool is not None else {}

    def mode_report(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Per-weight read-mode choices and their IR-drop economics
        (``CrossbarExecutor.mode_report``) plus a ``traffic`` block:
        tokens served and the modeled device read time / energy /
        pJ-per-token accumulated per read mode."""
        ex = self.model.executor
        if ex is None:
            raise RuntimeError(
                "mode_report requires the crossbar backend "
                "(ModelConfig(backend='crossbar'))")
        if tenant not in (None, TENANT):
            raise KeyError(
                f"no lane for tenant {tenant!r}: this scheduler serves "
                f"tenants [{TENANT!r}]")
        lane = self._lane
        rep = ex.mode_report(tenant=TENANT)
        tokens = lane.tokens_served
        modes: Dict[str, Any] = {}
        for mode, cost in sorted((lane.device_cost or {}).items()):
            if self.metrics.enabled:
                read_s = self.metrics.total(
                    "serve_device_read_seconds_total",
                    tenant=TENANT, mode=mode)
                energy = self.metrics.total(
                    "serve_device_energy_joules_total",
                    tenant=TENANT, mode=mode)
            else:
                # metrics off: the per-token cost is constant, so the
                # accumulated figure is exactly cost * tokens
                read_s = cost["read_s"] * tokens
                energy = cost["energy_j"] * tokens
            modes[mode] = {
                "device_read_s": read_s,
                "energy_j": energy,
                "pj_per_token": (energy / tokens * 1e12
                                 if tokens else 0.0),
            }
        rep["traffic"] = {"tokens_served": tokens, "modes": modes}
        return rep

    def attn_lane_report(self) -> Dict[str, Any]:
        """Which paged-attention lane the steps dispatched, plus the
        model's streaming configuration."""
        from repro_torch.kernels.paged_attention import paged_path_calls
        cfg = self.model.cfg
        return {"paged_kernel": bool(cfg.paged_kernel),
                "stream_min_pages": int(cfg.paged_stream_pages),
                "block_pages": int(cfg.paged_block_pages),
                "pages_per_seq": self.pages_per_seq,
                "dispatch": dict(paged_path_calls)}
