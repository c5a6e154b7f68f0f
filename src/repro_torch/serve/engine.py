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

The scheduler multiplexes up to ``stack_planes`` tenants ("A", "B",
...) from the plane banks of one crossbar executor: each tenant lane has
its own slots, cache, page pool and window step, reading its own planes
(``executor.read_tenant``), and QoS weights split the slots and pages
(``_split_slots``) and order the lanes.  A tenant's checkpoint hot-swaps
under traffic (:meth:`BatchScheduler.begin_hot_swap`): chunks of the new
checkpoint program between steps and the planes flip at a step boundary.
With a free plane the swap is staged and the tenant serves its old
planes through the window; with a full bank a non-anchor tenant is
rewritten in place and its lane pauses while the others serve.  A lane's
captured graph holds plane addresses, so the step compares its tenant's
plane generation before each replay and captures anew once it moved.
Prefix sharing and preemption are later slices of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.executor import flatten_with_path
from repro_torch.kernels import launch_counts
from repro_torch.models.model import Model
from repro_torch.serve.hotswap import HotSwapper, overlap_report
from repro_torch.serve.kv_pool import PagedKVPool, default_pool_pages


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is a later slice of the PyTorch port (ROADMAP.md)")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Any                # (S,) int tokens (numpy, list or tensor)
    max_new: int
    model_id: str = "A"        # tenant whose checkpoint serves this request
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
    write-plane leakage (0.0 outside a swap window, the live value inside
    one), which the MAC reads from device memory, so one graph serves
    both.  The step reads its tenant's planes (``read_tenant``).

    With ``capture`` the first call runs eagerly as the warm-up (kernels
    built, the allocator warm; its result is used), the second is
    captured into one CUDA graph in the scheduler's memory pool and
    replayed for its result, and every later call replays the graph.
    The capture is the closure's trace (``obs.note_jit_trace``); a host
    sync or a CUDA call that is no stream operation inside it raises.
    Without ``capture`` every call runs the same body eagerly, and the
    closure's first call is its trace.

    A graph holds the device addresses of the planes it read, not the
    planes, so it must never replay once they may have been freed.  A
    closure records its tenant's plane generation when it is built;
    before every call the step compares the generation, and once it
    moved (a promotion, staged or in place, an eviction and redeploy, a
    program walk) the step drops the graph and builds a new closure:
    warm-up, then capture, one trace and no retrace (the reference's
    fresh counter at a rebuild).  A tenant no longer resident drops the
    graph and raises.  A new params tree builds a new closure too.
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
        # the tenant's plane generation the current closure was built at
        self._generation: Optional[int] = None
        self.stats = {"captures": 0, "replays": 0, "eager_steps": 0}
        #: kernel launches one replay runs (recorded at the capture)
        self.launches_per_replay: Dict[str, int] = {}

    def __call__(self, params, tokens: np.ndarray, m: np.ndarray,
                 leak: Optional[torch.Tensor]) -> torch.Tensor:
        ex = self.model.executor
        stale = ex is not None and self._planes_moved(ex)
        leaves = tuple(w for _, w in flatten_with_path(params))
        if stale or self._leaves is None or len(leaves) != len(
                self._leaves) or any(
                a is not b for a, b in zip(leaves, self._leaves)):
            self._build(params, leaves)
        self.tokens.copy_(torch.from_numpy(tokens))
        self.m.copy_(torch.from_numpy(m))
        if leak is not None:
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

    def _planes_moved(self, ex) -> bool:
        """Whether the tenant's plane generation moved since the closure
        was built (its graph must then not replay); a tenant no longer
        resident drops the closure and raises."""
        if self.tenant not in ex.tenants:
            self.reset()
            raise RuntimeError(
                f"tenant {self.tenant!r} is not resident (evicted); its "
                f"lane's window step has no planes to read")
        return (self._generation is not None
                and ex.plane_generation(self.tenant) != self._generation)

    def reset(self) -> None:
        """Drop the captured graph (releasing its memory to the pool) and
        the built closure: the next call builds a new closure, runs it
        eagerly as the warm-up and captures it over the planes the
        executor holds then."""
        if self.graph is not None:
            self.graph.reset()
        self.graph, self._warm, self._leaves = None, False, None
        self._generation = None

    def _build(self, params, leaves) -> None:
        """A new closure for ``params``: programming is host work, done
        here and never inside a capture."""
        ex = self.model.executor
        self.reset()
        if ex is not None:
            with ex.read_tenant(self.tenant):
                ex.ensure_programmed(params)
            self._generation = ex.plane_generation(self.tenant)
        self._traces = 0
        self._leaves = leaves

    def _note_trace(self) -> None:
        self._traces += 1
        obs.note_jit_trace("decode", self.tenant, retrace=self._traces > 1)

    @contextlib.contextmanager
    def _reading(self):
        """No autograd, and reads of this lane's tenant on the resident
        tiles with this step's leak buffer (the executor's Python state,
        entered before a capture)."""
        ex = self.model.executor
        with torch.no_grad():
            if ex is None:
                yield
            else:
                with ex.activate(), ex.read_tenant(self.tenant), \
                        ex.leak_scope(self.leak):
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
    """One tenant's serving state: a fixed slot batch against its plane
    set, with its cache, queue and window step."""
    tenant: str
    params: Any
    slots: List[Optional[Request]]
    cache: Any
    queue: List[Request]
    decode: _WindowStep
    pool: Optional[PagedKVPool] = None
    # the window step's batch width (fixed at construction)
    width: int = 0
    # QoS: the lane's effective slot quota (an admission cap <= width,
    # re-split by set_weights) and its weight
    n_slots: int = 0
    weight: float = 1.0
    # tokens emitted by this lane (admission + decode)
    tokens_served: int = 0
    # True while the tenant's own planes are mid-write (in-place swap)
    # or being deployed back after an eviction: the lane neither admits,
    # steps nor writes its buffers, and resumes on the promoted planes
    paused: bool = False
    # modeled per-token device read cost by mode (crossbar backend)
    device_cost: Optional[Dict[str, Dict[str, float]]] = None


def _split_slots(n_slots: int, weights: Dict[str, float]) -> Dict[str, int]:
    """QoS-weighted budget split across tenant lanes (slots or pages).

    The budget is ``n_slots`` per tenant (equal weights give the even
    split); quotas are proportional to weight with largest-remainder
    rounding, and every tenant keeps at least 1 unit, so a resident
    tenant with queued work always decodes.
    """
    total = n_slots * len(weights)
    wsum = float(sum(weights.values()))
    raw = {t: total * float(w) / wsum for t, w in weights.items()}
    alloc = {t: max(1, int(raw[t])) for t in weights}
    leftover = total - sum(alloc.values())
    # leftover units go to the largest fractional remainders (the name
    # breaks ties, so the split is deterministic)
    order = sorted(weights, key=lambda t: (-(raw[t] - int(raw[t])), t))
    i = 0
    while leftover > 0:
        alloc[order[i % len(order)]] += 1
        leftover -= 1
        i += 1
    while leftover < 0:
        # the >= 1 floor oversubscribed the budget: take from the
        # largest allocation that can spare a unit
        t = max(sorted(alloc), key=lambda k: alloc[k])
        if alloc[t] <= 1:
            break
        alloc[t] -= 1
        leftover += 1
    return alloc


class BatchScheduler:
    """Paged continuous-batching scheduler (ragged, multi-tenant).

    Per step, every occupied slot of a lane contributes either its next
    ``chunk`` prompt tokens (admission prefill, emitting its first token
    on the final chunk) or one generated token (decode); the per-row
    valid count ``m`` pins each row's cache fill marker, and pad
    positions are causally masked, so the streams equal an unpadded
    per-request reference.  ``kv="paged"`` (default) stores K/V in a
    block-paged pool per lane; ``kv="dense"`` keeps a per-slot dense
    cache — same step, same streams.

    ``tenants={"A": params_a, "B": params_b, ...}`` multiplexes up to
    ``stack_planes`` checkpoints from the plane banks of one crossbar
    executor: each tenant gets its own slot partition, cache, pool and
    window step (reading its planes under ``executor.read_tenant``), and
    every ``step`` serves all lanes.  Requests route by
    ``Request.model_id``.  A tenant value may be a ``(params, weight)``
    pair: QoS weights split the slots and, with ``kv_pages``, the pages
    (``_split_slots``), and order the lanes (heavier first);
    :meth:`set_weights` re-splits them at a step boundary.

    ``capture`` (default: on the card, not on the CPU) runs each lane's
    window step as one CUDA graph, captured once and replayed
    (``_WindowStep``); ``capture=False`` on the card keeps the eager step
    as the witness the captured one is held against.  All lanes' graphs
    share one memory pool: no tensor a graph allocates is read outside
    its own replay (its outputs go to static buffers allocated outside
    the pool), and replays run one after another on one stream.
    """

    def __init__(self, model: Model, params, n_slots: int, max_len: int,
                 tenants: Optional[Dict[str, Any]] = None,
                 mode_policy=None, telemetry: bool = True,
                 kv: str = "paged", page_size: int = 8,
                 kv_pages: Optional[int] = None, chunk: int = 4,
                 prefix_share: bool = False, preemption: bool = False,
                 capture: Optional[bool] = None):
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
        if capture is None:
            capture = model.device.type == "cuda"
        if capture and model.device.type != "cuda":
            raise ValueError("capture=True records the window step as a "
                             "CUDA graph; it needs the model on the card")
        tenant_params: Dict[str, Any] = {}
        self._weights: Dict[str, float] = {}
        for t, spec in (dict(tenants) if tenants else {"A": params}).items():
            if (isinstance(spec, (tuple, list)) and len(spec) == 2
                    and isinstance(spec[1], (int, float))):
                p, w = spec
            else:
                p, w = spec, 1.0
            if w <= 0:
                raise ValueError(
                    f"tenant {t!r} QoS weight must be > 0, got {w}")
            tenant_params[t] = p
            self._weights[t] = float(w)
        if "A" not in tenant_params:
            raise ValueError("tenant 'A' is required (it anchors the "
                             "plane banks)")
        executor = model.executor
        if len(tenant_params) > 1 and executor is None:
            raise RuntimeError(
                "multi-tenant multiplexing serves each checkpoint from "
                "one plane of a stacked bank; it requires the "
                "crossbar backend (ModelConfig(backend='crossbar'))")
        if mode_policy is not None and executor is None:
            raise RuntimeError(
                "mode_policy selects per-weight crossbar read modes; it "
                "requires the crossbar backend "
                "(ModelConfig(backend='crossbar'))")
        self.model = model
        self.device = model.device
        self.capture = bool(capture)
        # one memory pool for every lane's graph (see the class doc)
        self._graph_pool = (torch.cuda.graph_pool_handle() if capture
                            else None)
        self.n_slots, self.max_len = n_slots, max_len
        self.kv, self.page_size, self.chunk = kv, page_size, int(chunk)
        self.kv_pages = kv_pages
        self.pages_per_seq = (max_len // page_size if kv == "paged"
                              else 0)
        # per-scheduler telemetry: request lifecycle, token latency, QoS
        # shares, modeled device time/energy; process-wide signals
        # (engine dispatch counters) live in obs.registry()
        self.metrics = obs.MetricsRegistry(enabled=telemetry)
        self.tracer = obs.Tracer(enabled=telemetry)
        if executor is not None:
            # crossbar backend: program each tenant's weights onto its
            # plane set ONCE at construction (program-at-load,
            # read-at-inference); mode_policy decides each weight's plane
            # layout here, and reads follow it
            for t in sorted(tenant_params):
                with executor.read_tenant(t):
                    executor.ensure_programmed(tenant_params[t],
                                               mode_policy=mode_policy)
        self._slot_quota = _split_slots(n_slots, self._weights)
        self._page_quota: Dict[str, int] = {}
        if kv == "paged":
            if kv_pages is None:
                self._page_quota = {
                    t: self._slot_quota[t] * self.pages_per_seq
                    for t in self._weights}
            else:
                self._page_quota = _split_slots(kv_pages, self._weights)
        self._lanes: Dict[str, _Lane] = {
            t: self._make_lane(t, p) for t, p in sorted(tenant_params.items())}
        self._swap: Optional[HotSwapper] = None
        self._swap_t0: Optional[float] = None
        self.swap_history: List[Dict[str, Any]] = []
        for t, lane in self._lanes.items():
            self._set_qos_gauges(t, lane)

    # -- telemetry helpers ---------------------------------------------------

    def _set_qos_gauges(self, tenant: str, lane: _Lane) -> None:
        self.metrics.gauge(
            "serve_qos_weight",
            help="configured QoS weight per tenant lane").set(
                lane.weight, tenant=tenant)
        self.metrics.gauge(
            "serve_qos_slot_quota",
            help="decode slots the QoS-weighted split granted").set(
                lane.n_slots, tenant=tenant)
        if lane.pool is not None:
            self.metrics.gauge(
                "serve_qos_page_budget",
                help="KV pages the QoS-weighted split granted").set(
                    lane.pool.budget, tenant=tenant)

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

    # -- lanes ---------------------------------------------------------------

    def _make_lane(self, tenant: str, params) -> _Lane:
        n = self._slot_quota.get(tenant, self.n_slots)
        ex = self.model.executor
        pool = None
        if self.kv == "paged":
            n_pages = self._page_quota.get(
                tenant, default_pool_pages(n, self.max_len, self.page_size))
            pool = PagedKVPool(n_pages, self.page_size, self.max_len, n)
            cache = self.model.init_paged_cache(n, self.max_len, n_pages,
                                                self.page_size)
        else:
            cache = self.model.init_cache(n, self.max_len)
        step = _WindowStep(self.model, cache, n, self.chunk, tenant,
                           self.capture, self._graph_pool)
        return _Lane(tenant=tenant, params=params, slots=[None] * n,
                     cache=cache, queue=[], decode=step, pool=pool,
                     width=n, n_slots=n,
                     weight=self._weights.get(tenant, 1.0),
                     device_cost=(ex.device_token_cost(tenant)
                                  if ex is not None else None))

    def _lane_order(self) -> List[str]:
        """QoS order: heavier lanes first, the name breaks ties (so equal
        weights step in sorted order)."""
        return sorted(self._lanes,
                      key=lambda t: (-self._lanes[t].weight, t))

    @property
    def params(self):
        """Tenant A's serving params (single-tenant compatibility)."""
        return self._lanes["A"].params

    @property
    def tenants(self) -> List[str]:
        return sorted(self._lanes)

    @property
    def queue(self) -> List[Request]:
        """Tenant A's queue (single-tenant compatibility)."""
        return self._lanes["A"].queue

    def submit(self, req: Request):
        lane = self._lanes.get(req.model_id)
        if lane is None:
            raise ValueError(
                f"request {req.rid} routes to unknown tenant "
                f"{req.model_id!r}; serving {self.tenants}")
        req.t_submit = self.tracer.now()
        self.metrics.counter(
            "serve_requests_submitted_total",
            help="requests accepted into a tenant queue").inc(
                tenant=lane.tenant)
        lane.queue.append(req)

    # -- dynamic QoS ---------------------------------------------------------

    def set_weights(self, weights: Dict[str, float]) -> None:
        """Re-weight QoS live: recompute the slot quotas and page budgets
        at a step boundary and update the ``serve_qos_*`` gauges.
        ``weights`` may cover any subset of the lanes; the rest keep
        theirs.  A quota never grows past its lane's width (the window
        step's shape, so no capture); shrinking takes effect as
        admissions, and occupied slots above the new quota drain as
        their requests complete.  Page-budget shrinks likewise gate only
        new admissions."""
        for t, w in weights.items():
            if t not in self._lanes:
                raise KeyError(f"no lane for tenant {t!r}: this "
                               f"scheduler serves {self.tenants}")
            if w <= 0:
                raise ValueError(
                    f"tenant {t!r} QoS weight must be > 0, got {w}")
        self._weights.update({t: float(w) for t, w in weights.items()})
        quota = _split_slots(self.n_slots, self._weights)
        pquota = (_split_slots(self.kv_pages, self._weights)
                  if (self.kv == "paged" and self.kv_pages is not None)
                  else None)
        for t, lane in self._lanes.items():
            lane.weight = self._weights[t]
            lane.n_slots = min(quota.get(t, lane.width), lane.width)
            self._slot_quota[t] = lane.n_slots
            if pquota is not None and lane.pool is not None:
                lane.pool.set_budget(pquota[t])
            self._set_qos_gauges(t, lane)

    # -- deep-net-mode hot-swap (serve reads while shadow planes program) ----

    def _require_crossbar(self):
        ex = self.model.executor
        if ex is None:
            raise RuntimeError("hot-swap requires the crossbar backend "
                               "(ModelConfig(backend='crossbar'))")
        if self._swap is not None:
            raise RuntimeError("a hot-swap is already in flight")
        return ex

    def begin_hot_swap(self, new_params, chunks_per_step: int = 8,
                       tenant: str = "A") -> HotSwapper:
        """Start programming ``new_params`` onto a write plane set.

        Chunks are written between steps (inside :meth:`step`); when
        every chunk lands, the planes land atomically at a step boundary
        and later tokens come from the new weights — no request is
        dropped and no step reads mixed planes.  The lifecycle follows
        the bank (``CrossbarExecutor.begin_swap``): with a free plane the
        swap is staged and the tenant (resident, or a first-time live
        deploy) serves throughout; with a full bank a non-anchor tenant
        is rewritten in place, and its lane pauses for the window — its
        in-flight requests freeze and resume on the promoted planes —
        while every other lane serves.  The lane of a tenant deployed
        back after an eviction pauses the same way: its planes are gone
        until the promotion."""
        ex = self._require_crossbar()
        self._swap = HotSwapper(ex, new_params,
                                chunks_per_step=chunks_per_step,
                                tenant=tenant)
        self._swap_t0 = self.tracer.now()
        lane = self._lanes.get(tenant)
        if lane is not None and (self._swap.plan.in_place
                                 or tenant not in ex.tenants):
            lane.paused = True
        return self._swap

    @property
    def swap_in_flight(self) -> bool:
        return self._swap is not None

    def _apply_promotion(self, tenant: str, new_params) -> None:
        """Land promoted params on a lane.  The promotion moved the
        tenant's plane generation, so the lane's window step drops its
        graph at its next call, whatever the new tree is (an ``init`` swap
        promotes the same tree object), warms up and captures a new
        closure: one trace, no retrace, zero dropped requests.  A tenant
        deployed live (``begin_hot_swap(..., tenant=...)`` with no lane)
        gets a new lane here, in the QoS split at weight 1."""
        lane = self._lanes.get(tenant)
        if lane is None:
            if tenant not in self._weights:
                # the newcomer's quota follows the construction-time
                # proportional rule; existing lanes keep theirs (resizing
                # them would drop in-flight cache state)
                self._weights[tenant] = 1.0
                total = self.n_slots * len(self._weights)
                wsum = sum(self._weights.values())
                self._slot_quota[tenant] = max(1, round(total / wsum))
                if self.kv == "paged":
                    if self.kv_pages is None:
                        self._page_quota[tenant] = (
                            self._slot_quota[tenant] * self.pages_per_seq)
                    else:
                        ptotal = self.kv_pages * len(self._weights)
                        self._page_quota[tenant] = max(
                            self.pages_per_seq, round(ptotal / wsum))
            self._lanes[tenant] = self._make_lane(tenant, new_params)
        else:
            lane.params = new_params
            lane.paused = False
            lane.device_cost = self.model.executor.device_token_cost(tenant)
        self._set_qos_gauges(tenant, self._lanes[tenant])

    def _note_swap_window(self, tenant: str, lifecycle: str, policy: str,
                          rep: Dict[str, Any]) -> None:
        """Record a completed swap window: one counter bump plus a span
        tagged with its lifecycle (``staged``/``in_place``) and policy
        (``overlapped``/``stop_the_world``)."""
        self.metrics.counter(
            "serve_swap_windows_total",
            help="completed swap windows, by lifecycle and policy").inc(
                tenant=tenant, lifecycle=lifecycle, policy=policy)
        if self._swap_t0 is not None:
            self.tracer.record(
                "swap_window", self._swap_t0, self.tracer.now(),
                tenant=tenant, lifecycle=lifecycle, policy=policy,
                chunks=rep.get("n_chunks"),
                decode_steps_during=rep.get("decode_steps_during_swap"))

    def stop_the_world_swap(self, new_params,
                            tenant: str = "A") -> Dict[str, Any]:
        """Blocking reprogram (the conventional-2-D-array policy): serving
        stalls while every chunk is written, the planes land, and the
        window step is built anew.  The comparison baseline for the
        overlapped path — same end state, but no tokens flow during the
        swap; it lands in ``swap_history`` like the overlapped path."""
        ex = self._require_crossbar()
        t0 = time.perf_counter()
        stats = ex.swap(new_params, tenant=tenant)
        wall = time.perf_counter() - t0
        self._apply_promotion(tenant, new_params)
        rep = overlap_report(ex.cfg, n_grids=ex.n_resident,
                             n_chunks=stats["n_chunks"],
                             batch_size=self.n_slots,
                             decode_steps_during=0, wall_swap_s=wall)
        rep["policy"] = "stop_the_world"
        rep["tenant"] = tenant
        rep["swap_mode"] = stats["swap_mode"]
        self.swap_history.append(rep)
        self._swap_t0 = t0
        self._note_swap_window(tenant, rep["swap_mode"],
                               "stop_the_world", rep)
        self._swap_t0 = None
        return stats

    def _advance_swap(self) -> None:
        """Program a burst of chunks; promote at the step boundary once
        the staged planes are fully written."""
        sw = self._swap
        if sw is None:
            return
        sw.step()
        if sw.done:
            new_params = sw.promote()
            self._apply_promotion(sw.tenant, new_params)
            rep = sw.report(batch_size=self.n_slots)
            self.swap_history.append(rep)
            self._note_swap_window(sw.tenant, rep["swap_mode"],
                                   "overlapped", rep)
            self._swap = None
            self._swap_t0 = None

    # -- admission (host bookkeeping only: slots + pages) --------------------

    def _leak_now(self) -> Optional[torch.Tensor]:
        """The leak this step's reads carry (a device scalar; see
        ``CrossbarExecutor.current_leak_codes``); None on the digital
        backend, whose steps read no planes."""
        ex = self.model.executor
        return ex.current_leak_codes() if ex is not None else None

    def _admit(self, lane: _Lane) -> None:
        """Move queued requests into free slots: a slot index, a
        page-table row and a fill marker — host bookkeeping, so admission
        never stalls an in-flight step.  A lane admits up to its QoS
        slot quota.  When the pool (or its QoS page budget) cannot cover
        a request's whole lifetime (``min(prompt + max_new - 1,
        max_len)`` tokens, claimed up front) the request waits in FIFO
        order."""
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
            active = len(lane.slots) - len(free)
            if active >= lane.n_slots or not free:
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

    def _check_resident(self) -> None:
        """Drop the graph of every lane whose tenant is no longer
        resident (its planes are freed), and raise if such a lane is
        unpaused and has work."""
        ex = self.model.executor
        if ex is None:
            return
        for t in self._lane_order():
            lane = self._lanes[t]
            if t in ex.tenants:
                continue
            lane.decode.reset()
            if not lane.paused and (lane.queue or any(
                    s is not None for s in lane.slots)):
                raise RuntimeError(
                    f"tenant {t!r} is not resident (evicted); its lane "
                    f"has work and no planes to read")

    def step(self) -> List[Request]:
        """One window step for every lane's active slots, in QoS order;
        returns the requests that finished (across tenants).

        An in-flight hot-swap advances first — plane chunks program
        strictly between steps, and promotion happens here at the
        boundary, so every step reads one consistent plane set.  A lane
        whose planes are the write target stays paused for the window;
        the other lanes step through it.  Each occupied row contributes
        its next prompt chunk or its last generated token; empty rows
        ride along at ``m = 0``.  One fixed-shape call per lane serves
        them all.

        A lane with work whose tenant is no longer resident (evicted, and
        not being deployed back) raises before any lane runs or a swap
        advances, so a step that raises changes nothing."""
        self._check_resident()
        self._advance_swap()
        finished: List[Request] = []
        decoded = False
        leak = self._leak_now()
        c = self.chunk
        for t in self._lane_order():
            lane = self._lanes[t]
            if lane.paused:
                continue
            self._admit(lane)
            if all(s is None for s in lane.slots):
                continue
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
                    if req.fed + m[i] >= flen:
                        emit[i] = "admission"  # final chunk: first token
                else:
                    toks[i, 0] = req.out[-1]
                    m[i] = 1
                    emit[i] = "decode"
            t0 = self.tracer.now()
            tok = lane.decode(lane.params, toks, m, leak)
            decoded = True
            tok_host = tok.cpu().numpy()
            n_admit = n_dec = 0
            for i, req in enumerate(lane.slots):
                if req is not None and req.fed < int(req.feed.shape[0]):
                    # the chunk is fed once the step ran (a step that
                    # raises leaves its requests as they were)
                    req.fed += int(m[i])
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
                # every emitted token materialized in this one batched
                # step, so the per-token latency IS the step wall time
                dt = self.tracer.now() - t0
                h = self.metrics.histogram(
                    "serve_token_latency_seconds",
                    help="wall time of the step that produced each token")
                for _ in range(n_admit + n_dec):
                    h.observe(dt, tenant=lane.tenant)
        if decoded and self._swap is not None:
            self._swap.note_decode_step()
        return finished

    def capture_report(self) -> Dict[str, Dict[str, Any]]:
        """Per lane: whether its window step captures, its captures,
        replays and eager steps, and the kernel launches one replay runs
        (so a serve ran ``launches_per_replay x replays`` launches from
        its graphs beside those the wrappers counted eagerly)."""
        return {t: {"capture": lane.decode.capture, **lane.decode.stats,
                    "launches_per_replay":
                        dict(lane.decode.launches_per_replay)}
                for t, lane in sorted(self._lanes.items())}

    def kv_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant page-pool accounting (paged lanes only), including
        the QoS budget and the conservation invariant ``pages_in_use +
        pages_free == n_pages``."""
        return {t: lane.pool.report()
                for t, lane in sorted(self._lanes.items())
                if lane.pool is not None}

    def mode_report(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Per-weight read-mode choices and their IR-drop economics for a
        tenant's plane set (``CrossbarExecutor.mode_report``) plus a
        ``traffic`` block: tokens served and the modeled device read time
        / energy / pJ-per-token accumulated per read mode.  ``tenant``
        defaults to the anchor; a tenant with no lane is a KeyError."""
        ex = self.model.executor
        if ex is None:
            raise RuntimeError(
                "mode_report requires the crossbar backend "
                "(ModelConfig(backend='crossbar'))")
        if tenant is None:
            tenant = ex.anchor
        lane = self._lanes.get(tenant)
        if lane is None:
            raise KeyError(
                f"no lane for tenant {tenant!r}: this scheduler serves "
                f"tenants {self.tenants}")
        rep = ex.mode_report(tenant=tenant)
        tokens = lane.tokens_served
        modes: Dict[str, Any] = {}
        for mode, cost in sorted((lane.device_cost or {}).items()):
            if self.metrics.enabled:
                read_s = self.metrics.total(
                    "serve_device_read_seconds_total",
                    tenant=tenant, mode=mode)
                energy = self.metrics.total(
                    "serve_device_energy_joules_total",
                    tenant=tenant, mode=mode)
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

    def qos_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant QoS accounting: the weight, the slot quota the
        weighted split granted, the page budget and usage (paged lanes),
        and the served-token count and share so far (admission + decode
        tokens) — the figure the weights shift.  Read from the
        ``serve_qos_*`` gauges' sources and ``serve_tokens_total`` with
        telemetry on, from the lanes with it off."""
        if self.metrics.enabled:
            served = {t: int(self.metrics.total("serve_tokens_total",
                                                tenant=t))
                      for t in self._lanes}
        else:
            served = {t: lane.tokens_served
                      for t, lane in self._lanes.items()}
        total = sum(served.values())
        out = {}
        for t, lane in sorted(self._lanes.items()):
            entry: Dict[str, Any] = {
                "weight": lane.weight,
                "slots": lane.n_slots,
                "tokens_served": served[t],
                "token_share": (served[t] / total if total else 0.0)}
            if lane.pool is not None:
                entry["page_budget"] = lane.pool.budget
                entry["pages_in_use"] = lane.pool.pages_in_use
                entry["pages_owned"] = lane.pool.pages_owned
                entry["pages_shared"] = lane.pool.pages_shared
            out[t] = entry
        return out

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
