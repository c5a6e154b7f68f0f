"""Request-lifecycle tracing: named spans with wall-clock bounds.

A :class:`Span` is a closed interval ``[start, end]`` on the tracer's
clock (``time.perf_counter`` by default) plus free-form attributes
(``rid``, ``tenant``, ``bucket``, ``lifecycle``, ...).  The scheduler
records one span *set* per completed request — ``queue_wait``,
``prefill``, ``decode``, and the enclosing ``request`` — chosen so the
parts telescope exactly to the whole:

    queue_wait: [t_submit, t_admit]
    prefill:    [t_admit,  t_first]   (ends at first emitted token; its
                                       duration is TTFT minus queue wait)
    decode:     [t_first,  t_done]
    request:    [t_submit, t_done]

Swap windows and promotions are recorded as ``swap_window`` spans tagged
with ``lifecycle`` (``staged``/``in_place``) and ``policy``.

stdlib only — same constraint as ``registry.py``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "span", "span": self.name, "start": self.start,
                "end": self.end, "duration_s": self.duration,
                **{f"attr_{k}": v for k, v in sorted(self.attrs.items())}}


class Tracer:
    """Append-only span buffer with a monotonic clock.

    ``enabled=False`` keeps :meth:`now` functional (callers may use it
    unconditionally) but makes :meth:`record` a no-op, so a metrics-off
    scheduler pays only the clock reads.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: List[Span] = []

    def now(self) -> float:
        return self._clock()

    def record(self, name: str, start: float, end: float,
               **attrs: Any) -> Optional[Span]:
        if not self.enabled:
            return None
        span = Span(name, float(start), float(end), dict(attrs))
        with self._lock:
            self._spans.append(span)
        return span

    def spans(self, name: Optional[str] = None,
              **attr_filter: Any) -> List[Span]:
        """Recorded spans, optionally filtered by name and exact
        attribute values (e.g. ``spans("request", tenant="B")``)."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        for k, v in attr_filter.items():
            out = [s for s in out if s.attrs.get(k) == v]
        return out

    def __len__(self) -> int:
        return len(self._spans)

    def to_jsonl(self) -> str:
        """One JSON object per span, tagged ``"kind": "span"``."""
        with self._lock:
            lines = [json.dumps(s.to_dict(), sort_keys=True)
                     for s in self._spans]
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


__all__ = ["Span", "Tracer"]
