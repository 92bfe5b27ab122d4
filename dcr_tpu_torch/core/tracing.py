"""The process-wide telemetry registry (the registry half of
``dcr_tpu/core/tracing.py``): counters, gauges and histograms, and their
Prometheus text exposition.

Metrics carry the JAX package's names (``search/query_total``,
``copy_risk/sim``, ``serve/request_latency_s``, ...), so the two packages
count the same events and a scrape reads the same series. Spans, events and
the trace sink come with ROADMAP Queue A item 7; until then
``SearchConfig.logdir`` and ``ServeConfig.logdir`` raise ``NotPortedError``.
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import Any, Mapping

import numpy as np


class Counter:
    """Monotonic process-wide counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-value-wins instantaneous measurement."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Thread-safe sliding-window reservoir with percentile snapshots: a
    bounded deque, so a long-lived process never grows memory with its
    observation count, while ``count`` and ``total`` stay lifetime totals."""

    def __init__(self, window: int = 1024):
        self._values: deque = deque(maxlen=window)
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))
            self.count += 1
            self.total += float(value)

    def percentiles(self, qs: tuple = (50, 99)) -> dict[str, float]:
        """{"p50": v, "p99": v, ...} over the window (0.0 when empty)."""
        with self._lock:
            vals = list(self._values)
        if not vals:
            return {f"p{q}": 0.0 for q in qs}
        arr = np.asarray(vals)
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.total
        return {"count": count, "sum": total, **self.percentiles((50, 90, 99))}


def sanitize_metric_name(name: str) -> str:
    """Slash-style metric name (``faults/x``) -> a Prometheus identifier
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``; the ``dcr_`` prefix namespaces the export
    and guarantees a legal first character."""
    return "dcr_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def prometheus_value(v: float) -> str:
    """A sample value; Python's ``inf``/``nan`` spellings are not valid
    exposition tokens."""
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(f) if isinstance(v, float) else str(v)


def prometheus_escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class TelemetryRegistry:
    """The process-wide metric home: one snapshot answers for the whole
    process, whichever subsystem is asked."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, window: int = 1024) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(name, Histogram(window))

    def register_histogram(self, name: str, hist: Histogram) -> Histogram:
        """Adopt an externally created histogram (``LatencyTracker(name=...)``)."""
        with self._lock:
            self._histograms[name] = hist
            return hist

    def counters(self, prefix: str = "") -> dict[str, int]:
        with self._lock:
            items = list(self._counters.items())
        return {k: c.value for k, c in items if k.startswith(prefix)}

    def reset(self, prefix: str = "") -> None:
        """Drop the metrics under ``prefix`` ("" clears everything)."""
        with self._lock:
            for d in (self._counters, self._gauges, self._histograms):
                for k in [k for k in d if k.startswith(prefix)]:
                    del d[k]

    def snapshot(self) -> dict:
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        return {"counters": {k: c.value for k, c in counters},
                "gauges": {k: g.value for k, g in gauges},
                "histograms": {k: h.snapshot() for k, h in hists}}

    def prometheus_text(self) -> str:
        """The registry in Prometheus text exposition format: counters and
        gauges 1:1, histograms as summaries (quantile labels, ``_sum``,
        ``_count``); ``dcr_faults_total`` always present. Every metric gets a
        ``# HELP`` line naming the internal name it was sanitized from, and
        two names that sanitize alike share one HELP/TYPE header."""
        snap = self.snapshot()
        lines: list[str] = []
        headered: set[str] = set()

        def header(m: str, orig: str, kind: str) -> None:
            if m in headered:
                return
            headered.add(m)
            lines.append(f"# HELP {m} dcr_tpu internal metric "
                         f"{prometheus_escape_help(orig)!r}")
            lines.append(f"# TYPE {m} {kind}")

        for name, value in sorted(snap["counters"].items()):
            m = sanitize_metric_name(name)
            header(m, name, "counter")
            lines.append(f"{m} {prometheus_value(value)}")
        header("dcr_faults_total", "sum of faults/* counters", "counter")
        faults_total = sum(v for k, v in snap["counters"].items() if k.startswith("faults/"))
        lines.append(f"dcr_faults_total {prometheus_value(faults_total)}")
        for name, value in sorted(snap["gauges"].items()):
            m = sanitize_metric_name(name)
            header(m, name, "gauge")
            lines.append(f"{m} {prometheus_value(value)}")
        for name, h in sorted(snap["histograms"].items()):
            m = sanitize_metric_name(name)
            header(m, name, "summary")
            for q in (50, 90, 99):
                lines.append(f'{m}{{quantile="0.{q}"}} {prometheus_value(h[f"p{q}"])}')
            lines.append(f"{m}_sum {prometheus_value(h['sum'])}")
            lines.append(f"{m}_count {prometheus_value(h['count'])}")
        return "\n".join(lines) + "\n"


_REGISTRY = TelemetryRegistry()


def registry() -> TelemetryRegistry:
    return _REGISTRY


def update_gauges(values: Mapping[str, Any], prefix: str = "") -> None:
    """Mirror a (possibly nested) scalar mapping into registry gauges: how
    MetricWriter scalars and the serve status document reach /metrics."""
    for k, v in values.items():
        if isinstance(v, Mapping):
            update_gauges(v, prefix=f"{prefix}{k}/")
        elif isinstance(v, bool):
            _REGISTRY.gauge(f"{prefix}{k}").set(1.0 if v else 0.0)
        elif isinstance(v, (int, float)):
            _REGISTRY.gauge(f"{prefix}{k}").set(float(v))
