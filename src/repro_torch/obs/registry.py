"""Dependency-free metrics registry: counters, gauges, fixed-bucket
histograms, snapshot-able to Prometheus text format and JSONL.

Design constraints, in order:

  * **stdlib only** — this package sits UNDER ``core/`` (the engine's
    dispatch counters route here), so it can never import torch, numpy,
    or anything else from the package.
  * **cheap when disabled** — ``MetricsRegistry(enabled=False)`` turns
    every ``inc``/``set``/``observe`` into a dict lookup and a boolean
    test, which is what the CI telemetry smoke's <=5 % decode-overhead
    gate compares against.
  * **labels are first-class** — every sample carries a label set
    (``tenant``, ``mode``, ``path``, ...); :meth:`MetricsRegistry.total`
    sums across a label *subset* so views like ``engine.path_calls``
    (per-geometry labels, summed per path) stay O(samples).

Export formats:

  * :meth:`MetricsRegistry.to_prometheus` — the Prometheus text
    exposition format (``# HELP``/``# TYPE`` headers, escaped label
    values, ``_bucket``/``_sum``/``_count`` histogram series).
    :func:`parse_prometheus` is the matching line-format parser; the CI
    telemetry smoke round-trips every snapshot through it.
  * :meth:`MetricsRegistry.to_jsonl` — one JSON object per sample,
    tagged ``{"kind": "metric", ...}`` so metric lines and span lines
    (``trace.py``) can share one file.
"""
from __future__ import annotations

import json
import re
import threading
from typing import Any, Dict, List, Sequence, Tuple

#: label-set key: sorted (name, value) pairs, values coerced to str
LabelKey = Tuple[Tuple[str, str], ...]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default latency buckets [s]: sub-ms host paths up through multi-second
#: interpret-mode decode steps (fixed at histogram creation — the bucket
#: layout is part of the metric's identity, like a Prometheus scrape)
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v: float) -> str:
    """Prometheus sample value: shortest round-trippable float."""
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


class _Metric:
    """Common machinery: per-label-set sample storage under one lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name, self.help = name, help
        self._registry = registry
        self._lock = registry._lock
        self._samples: Dict[LabelKey, Any] = {}

    @property
    def enabled(self) -> bool:
        return self._registry.enabled

    def _labels_dict(self, key: LabelKey) -> Dict[str, str]:
        return dict(key)

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()


class Counter(_Metric):
    """Monotone counter (per label set)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if not self.enabled:
            return
        if value < 0:
            raise ValueError(
                f"{self.name}: counters are monotone, got inc({value})")
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + value

    def get(self, **labels: Any) -> float:
        return float(self._samples.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Set-table instantaneous value (per label set)."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._samples[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + value

    def get(self, **labels: Any) -> float:
        return float(self._samples.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative ``le`` buckets + sum + count.

    Bucket semantics match Prometheus exactly: an observation lands in
    every bucket whose upper bound is >= the value (``value <= le``),
    and the implicit ``+Inf`` bucket equals the total count.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, registry)
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(
                f"{name}: buckets must be non-empty and strictly "
                f"increasing, got {bs}")
        if any(b != b or b in (float("inf"), float("-inf")) for b in bs):
            raise ValueError(f"{name}: buckets must be finite (the +Inf "
                             f"bucket is implicit), got {bs}")
        self.buckets = bs

    def observe(self, value: float, **labels: Any) -> None:
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            s = self._samples.get(key)
            if s is None:
                s = self._samples[key] = {
                    "counts": [0] * len(self.buckets), "sum": 0.0,
                    "count": 0}
            v = float(value)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s["counts"][i] += 1
            s["sum"] += v
            s["count"] += 1

    def bucket_counts(self, **labels: Any) -> Dict[str, int]:
        """Cumulative per-bucket counts, keyed by the ``le`` bound (str),
        including the implicit ``+Inf`` bucket."""
        s = self._samples.get(_label_key(labels))
        if s is None:
            return {**{_fmt(b): 0 for b in self.buckets}, "+Inf": 0}
        out = {_fmt(b): c for b, c in zip(self.buckets, s["counts"])}
        out["+Inf"] = s["count"]
        return out

    def get_sum(self, **labels: Any) -> float:
        s = self._samples.get(_label_key(labels))
        return float(s["sum"]) if s else 0.0

    def get_count(self, **labels: Any) -> int:
        s = self._samples.get(_label_key(labels))
        return int(s["count"]) if s else 0


class MetricsRegistry:
    """Create-or-get metric families + snapshot/export surface."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    # -- family creation (create-or-get; kind conflicts raise) --------------

    def _get(self, name: str, kind: str, factory) -> Any:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, "counter",
                         lambda: Counter(name, help, self))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, "gauge", lambda: Gauge(name, help, self))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        h = self._get(name, "histogram",
                      lambda: Histogram(name, help, self, buckets))
        if tuple(float(b) for b in buckets) != h.buckets:
            raise ValueError(
                f"metric {name!r} already registered with buckets "
                f"{h.buckets}; bucket layout is fixed at creation")
        return h

    # -- queries -------------------------------------------------------------

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def get(self, name: str, **labels: Any) -> float:
        """Exact-label-set value of a counter/gauge (0.0 when absent)."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        if isinstance(m, Histogram):
            raise TypeError(f"{name}: use bucket_counts/get_sum/get_count "
                            f"on the histogram object")
        return m.get(**labels)

    def total(self, name: str, **label_filter: Any) -> float:
        """Sum a counter/gauge across every sample whose labels are a
        superset of ``label_filter`` — e.g. ``total("dispatch_total",
        path="kernel")`` sums over all geometries."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        want = set(_label_key(label_filter))
        with self._lock:
            if isinstance(m, Histogram):
                return float(sum(
                    s["sum"] for key, s in m._samples.items()
                    if want <= set(key)))
            return float(sum(v for key, v in m._samples.items()
                             if want <= set(key)))

    # -- snapshot / export ---------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict snapshot: ``{name: {type, help, samples: [...]}}``.

        Counter/gauge samples are ``{"labels": {...}, "value": v}``;
        histogram samples carry ``buckets``/``sum``/``count``.
        """
        out: Dict[str, Any] = {}
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                samples: List[Dict[str, Any]] = []
                for key in sorted(m._samples):
                    labels = dict(key)
                    if isinstance(m, Histogram):
                        samples.append({
                            "labels": labels,
                            "buckets": m.bucket_counts(**labels),
                            "sum": m.get_sum(**labels),
                            "count": m.get_count(**labels)})
                    else:
                        samples.append({"labels": labels,
                                        "value": float(m._samples[key])})
                out[name] = {"type": m.kind, "help": m.help,
                             "samples": samples}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format of the whole registry."""
        lines: List[str] = []
        for name, fam in self.snapshot().items():
            if fam["help"]:
                lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["samples"]:
                if fam["type"] == "histogram":
                    for le, c in s["buckets"].items():
                        lines.append(_sample_line(
                            f"{name}_bucket",
                            {**s["labels"], "le": le}, c))
                    lines.append(_sample_line(f"{name}_sum", s["labels"],
                                              s["sum"]))
                    lines.append(_sample_line(f"{name}_count", s["labels"],
                                              s["count"]))
                else:
                    lines.append(_sample_line(name, s["labels"],
                                              s["value"]))
        return "\n".join(lines) + ("\n" if lines else "")

    def to_jsonl(self) -> str:
        """One JSON object per sample, tagged ``"kind": "metric"``."""
        lines = []
        for name, fam in self.snapshot().items():
            for s in fam["samples"]:
                doc = {"kind": "metric", "metric": name,
                       "type": fam["type"], **s}
                lines.append(json.dumps(doc, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every sample (metric definitions persist)."""
        with self._lock:
            for m in self._metrics.values():
                m._samples.clear()


def _sample_line(name: str, labels: Dict[str, Any], value: Any) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(str(v))}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_fmt(float(value))}"
    return f"{name} {_fmt(float(value))}"


# -- Prometheus line-format parser -------------------------------------------

def _parse_labels(body: str, line: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        j = body.index("=", i)
        key = body[i:j].strip()
        if not _LABEL_RE.match(key):
            raise ValueError(f"bad label name {key!r} in line {line!r}")
        if j + 1 >= n or body[j + 1] != '"':
            raise ValueError(f"unquoted label value in line {line!r}")
        i, chars = j + 2, []
        while i < n and body[i] != '"':
            c = body[i]
            if c == "\\" and i + 1 < n:
                nxt = body[i + 1]
                c = {"n": "\n", "\\": "\\", '"': '"'}.get(nxt)
                if c is None:
                    raise ValueError(
                        f"bad escape \\{nxt} in line {line!r}")
                i += 1
            chars.append(c)
            i += 1
        if i >= n:
            raise ValueError(f"unterminated label value in line {line!r}")
        labels[key] = "".join(chars)
        i += 1                       # past the closing quote
        if i < n and body[i] == ",":
            i += 1
        i += len(body[i:]) - len(body[i:].lstrip())
    return labels


def parse_prometheus(text: str) -> List[Dict[str, Any]]:
    """Parse Prometheus text format into sample dicts.

    Returns ``[{"name": str, "labels": {str: str}, "value": float}]`` in
    input order; comment/blank lines are skipped.  Raises ``ValueError``
    on any malformed line — the CI telemetry smoke gates on this parser
    accepting every snapshot the registry emits.
    """
    samples: List[Dict[str, Any]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            body, _, tail = rest.rpartition("}")
            if not _:
                raise ValueError(f"unbalanced braces in line {line!r}")
            labels = _parse_labels(body, line)
            value_str = tail.strip()
        else:
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(f"missing value in line {line!r}")
            name, value_str, labels = parts[0], parts[1], {}
        name = name.strip()
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r} in line {line!r}")
        # a timestamp may trail the value; take the first token
        value_tok = value_str.split()[0] if value_str.split() else ""
        try:
            value = float(value_tok.replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError:
            raise ValueError(
                f"bad sample value {value_tok!r} in line {line!r}")
        samples.append({"name": name, "labels": labels, "value": value})
    return samples


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "parse_prometheus",
]
