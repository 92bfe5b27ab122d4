"""Process-wide counters (the registry of ``dcr_tpu/core/tracing.py``).

Counters under the JAX package's metric names (``search/query_total``,
``search/ingest_rows_total``, ``search/store_shard_corrupt``, ...), so the
two packages count the same events. Spans, gauges and histograms come with
the trace sink (ROADMAP Queue A item 15); until then
``SearchConfig.logdir`` raises ``NotPortedError``.
"""

from __future__ import annotations

import threading


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


class TelemetryRegistry:
    """The process-wide metric home."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def counters(self, prefix: str = "") -> dict[str, int]:
        with self._lock:
            items = list(self._counters.items())
        return {k: c.value for k, c in items if k.startswith(prefix)}


_REGISTRY = TelemetryRegistry()


def registry() -> TelemetryRegistry:
    return _REGISTRY
