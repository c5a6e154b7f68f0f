"""Telemetry for the port's serving stack (dependency-free).

Two tiers of ownership, as in the reference package:

* **Global registry/tracer** (:func:`registry`, :func:`tracer`) —
  process-wide signals below any one scheduler: engine dispatch counts
  (``crossstack_dispatch_total``) and executor program events.
  ``note_jit_trace`` stays as a counter; the port runs eagerly and
  nothing in it calls the function yet.
* **Per-scheduler registry/tracer** (``BatchScheduler.metrics`` /
  ``.tracer``) — request lifecycle, token latency and modeled device
  time/energy, scoped so concurrent schedulers never cross-contaminate.
"""
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    DEFAULT_LATENCY_BUCKETS,
    parse_prometheus,
)
from repro_torch.obs.trace import Span, Tracer

_REGISTRY = MetricsRegistry()
_TRACER = Tracer()


def registry() -> MetricsRegistry:
    """The process-global registry (engine/executor events)."""
    return _REGISTRY


def tracer() -> Tracer:
    """The process-global tracer."""
    return _TRACER


def note_jit_trace(closure: str, tenant: str, retrace: bool) -> None:
    """Record one trace of a serving closure in the global registry
    (``serve_jit_traces_total``; ``serve_jit_retraces_total`` for any
    trace beyond the first of a built closure)."""
    reg = _REGISTRY
    reg.counter(
        "serve_jit_traces_total",
        help="traces of serving closures (decode/prefill)").inc(
            closure=closure, tenant=tenant)
    if retrace:
        reg.counter(
            "serve_jit_retraces_total",
            help="re-traces beyond the first per built closure",
        ).inc(closure=closure, tenant=tenant)


def reset() -> None:
    """Zero the global registry samples and drop global spans."""
    _REGISTRY.reset()
    _TRACER.clear()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span", "Tracer",
    "DEFAULT_LATENCY_BUCKETS", "parse_prometheus",
    "registry", "tracer", "note_jit_trace", "reset",
]
