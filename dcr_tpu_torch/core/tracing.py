"""Span tracing, the process-wide telemetry registry and the flight
recorder: counterpart of ``dcr_tpu/core/tracing.py``.

- **Spans and events** -- ``with span("train/step", step=n): ...`` records
  one span per region: ids and parents through :mod:`contextvars` (nesting
  is automatic within a thread), monotonic durations, wall-clock starts,
  rank and thread tags, and an optional distributed trace id
  (:func:`new_trace_id`, inherited like the parent). After
  :func:`configure` they append to ``<dir>/trace.jsonl`` (``trace.p<rank>
  .jsonl`` on another rank), size-capped by ``DCR_TRACE_MAX_MB`` into
  ``trace.jsonl.1..N`` (``DCR_TRACE_KEEP``, default 3). The records are the
  JAX package's (``TRACE_VERSION`` 1, the same keys and phases), so
  ``tools/trace_report.py`` and ``tools/trace_schema.json`` read either
  package's traces. A span times the host: around an eager CUDA launch it
  measures the launches (plus any sync inside), as the JAX spans time
  dispatch; nothing here synchronises the device.
- **Telemetry registry** -- counters, gauges and histograms under the JAX
  package's metric names (``search/query_total``, ``copy_risk/sim``,
  ``serve/request_latency_s``, ...), with their Prometheus text exposition.
- **Flight recorder** -- a bounded ring of the last ``DCR_FLIGHTREC_SPANS``
  (256) records, kept even when no trace file is configured. The fatal
  paths (NaN abort, preemption exit 83, OOM exit 85, hang exit 89, serve's
  drain, an unhandled exception) call :func:`dump_flight_recorder`, which
  writes ``flightrec_<rank>.json`` (``flightrec_w<i>_<rank>.json`` under
  ``DCR_WORKER_INDEX``) with the ring, a registry snapshot and the device
  memory (``obs/memwatch.memory_snapshot_doc``). ``DCR_TRACE=0`` keeps the
  ring and skips the file.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import logging
import os
import re
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterator, Mapping, Optional

import numpy as np

log = logging.getLogger("dcr_tpu_torch")

TRACE_VERSION = 1
# record phases, pinned by tools/trace_schema.json
_PH_SPAN = "X"
_PH_EVENT = "i"


def _detect_rank() -> int:
    """0, or the ``torch.distributed`` rank once a process group is up."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # a torch build without distributed support
        pass
    return 0


class _TraceState:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.dir: Optional[Path] = None
        self.file = None
        self.path: Optional[Path] = None
        self.rank: Optional[int] = None
        self.ring: deque = deque(
            maxlen=int(os.environ.get("DCR_FLIGHTREC_SPANS", "256") or 256))
        self.ids = itertools.count(1)
        self.dumped: Optional[Path] = None
        # size cap (0 = none): a long-lived serve worker must not grow its
        # trace without bound
        self.max_bytes = 0
        self.keep = 3
        self.bytes_written = 0


_state = _TraceState()
_current_span: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "dcr_current_span", default=None)
# the distributed trace id (16 hex chars) of the current span: inherited
# like the parent id within a process
_current_trace: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "dcr_current_trace", default=None)


def new_trace_id() -> str:
    """A fresh 64-bit trace id from os.urandom, which never perturbs (or
    depends on) a seeded random stream."""
    return os.urandom(8).hex()


def configure(directory: str | Path, *, rank: Optional[int] = None) -> Optional[Path]:
    """Write spans and events to ``<directory>/trace.jsonl`` (rank 0) or
    ``trace.p<rank>.jsonl``, and anchor the flight-recorder dumps there.
    Idempotent and re-targetable (the previous file is closed); installs
    the excepthook. ``DCR_TRACE=0`` keeps the ring only. Returns the trace
    path (None when the file is off)."""
    rank = _detect_rank() if rank is None else int(rank)
    directory = Path(directory)
    name = "trace.jsonl" if rank == 0 else f"trace.p{rank}.jsonl"
    # before any early return: ring-only mode exists for the dump an
    # unhandled exception writes
    install_excepthook()
    with _state.lock:
        _state.rank = rank
        _state.dir = directory
        if _state.file is not None:
            try:
                _state.file.close()
            except OSError as e:
                log.warning("[trace] trace_file_close_failed %r", e)
            _state.file = None
            _state.path = None
        if os.environ.get("DCR_TRACE", "1") == "0":
            return None
        directory.mkdir(parents=True, exist_ok=True)
        path = directory / name
        _state.max_bytes = int(float(os.environ.get("DCR_TRACE_MAX_MB", "0") or 0) * 1e6)
        _state.keep = max(1, int(os.environ.get("DCR_TRACE_KEEP", "3") or 3))
        _state.bytes_written = path.stat().st_size if path.exists() else 0
        _state.path = path
        _state.file = path.open("a", buffering=1)  # line-buffered: a crash loses no line
    return path


def trace_dir() -> Optional[Path]:
    return _state.dir


def _rank() -> int:
    r = _state.rank
    return _detect_rank() if r is None else r


def _rotate_locked() -> None:
    """``trace.jsonl`` -> ``.1`` -> ... -> ``.keep`` (the oldest dropped), then
    a fresh file. The caller holds ``_state.lock``. A failure is logged and
    leaves the ring only: telemetry never stops the workload."""
    path = _state.path
    try:
        _state.file.close()
    except OSError as e:
        log.warning("[trace] trace_file_close_failed during rotate %r", e)
    _state.file = None
    try:
        for i in range(_state.keep - 1, 0, -1):
            seg = path.with_name(f"{path.name}.{i}")
            if seg.exists():
                os.replace(seg, path.with_name(f"{path.name}.{i + 1}"))
        os.replace(path, path.with_name(f"{path.name}.1"))
        _state.file = path.open("a", buffering=1)
        _state.bytes_written = 0
    except OSError as e:
        log.warning("[trace] trace_rotate_failed (ring-only from here): %r", e)


def _emit(rec: dict) -> None:
    with _state.lock:
        _state.ring.append(rec)
        f = _state.file
        if f is not None:
            try:
                line = json.dumps(rec, default=str) + "\n"
                f.write(line)
                _state.bytes_written += len(line)
                if _state.max_bytes and _state.bytes_written > _state.max_bytes:
                    _rotate_locked()
            except (OSError, ValueError) as e:  # a full disk, a closed file
                _state.file = None
                log.warning("[trace] trace_write_failed (ring-only from here): %r", e)


class SpanHandle:
    """An open span whose end is not tied to a lexical scope: the cross-thread
    form (a ``serve/request`` root begun on a handler thread and ended by
    the future's callback). :func:`span` where a ``with`` block fits."""

    __slots__ = ("name", "id", "parent", "trace", "attrs", "_t0_wall", "_t0", "_done")

    def __init__(self, name: str, parent: Optional[int], trace: Optional[str],
                 attrs: dict):
        self.name = name
        self.id = next(_state.ids)
        self.parent = parent
        self.trace = trace
        self.attrs = attrs
        self._t0_wall = time.time()
        self._t0 = time.monotonic()
        self._done = False

    def end(self, **extra: Any) -> None:
        if self._done:          # idempotent: callbacks may race .end()
            return
        self._done = True
        dur = time.monotonic() - self._t0
        rec = {"ph": _PH_SPAN, "name": self.name, "id": self.id, "parent": self.parent,
               "ts": round(self._t0_wall * 1e6), "dur": round(dur * 1e6), "pid": _rank(),
               "tid": threading.get_ident(), "tname": threading.current_thread().name,
               "args": {**self.attrs, **extra}}
        if self.trace is not None:
            rec["trace"] = self.trace
        _emit(rec)


def begin_span(name: str, *, parent: Optional[int] = None, trace: Optional[str] = None,
               **attrs: Any) -> SpanHandle:
    """Open a :class:`SpanHandle`; the caller owns ``.end()``. ``parent`` and
    ``trace`` default to the enclosing span's."""
    return SpanHandle(name, parent if parent is not None else _current_span.get(),
                      trace if trace is not None else _current_trace.get(), attrs)


@contextmanager
def span(name: str, *, parent: Optional[int] = None, trace: Optional[str] = None,
         **attrs: Any) -> Iterator[SpanHandle]:
    """Record the block as one span, nested under the enclosing one; an
    exception in the block is recorded as an ``error`` attr and re-raised."""
    h = begin_span(name, parent=parent, trace=trace, **attrs)
    token = _current_span.set(h.id)
    trace_token = _current_trace.set(h.trace)
    try:
        yield h
    except BaseException as e:
        h.end(error=repr(e))
        raise
    finally:
        _current_trace.reset(trace_token)
        _current_span.reset(token)
        h.end()


def event(name: str, *, parent: Optional[int] = None, trace: Optional[str] = None,
          attrs: Optional[Mapping[str, Any]] = None, **kw: Any) -> None:
    """An instant record (a fault, a decision). ``attrs=`` for a dict whose
    keys could collide with ``name`` or ``parent``."""
    rec = {"ph": _PH_EVENT, "name": name, "id": next(_state.ids),
           "parent": parent if parent is not None else _current_span.get(),
           "ts": round(time.time() * 1e6), "pid": _rank(), "tid": threading.get_ident(),
           "tname": threading.current_thread().name, "args": {**(attrs or {}), **kw}}
    trace = trace if trace is not None else _current_trace.get()
    if trace is not None:
        rec["trace"] = trace
    _emit(rec)


def complete_span(name: str, *, start_wall: float, dur_s: float,
                  parent: Optional[int] = None, trace: Optional[str] = None,
                  **attrs: Any) -> None:
    """A span measured elsewhere (a request's queue wait, from its admission
    stamp when its batch forms)."""
    rec = {"ph": _PH_SPAN, "name": name, "id": next(_state.ids), "parent": parent,
           "ts": round(start_wall * 1e6), "dur": round(max(dur_s, 0.0) * 1e6),
           "pid": _rank(), "tid": threading.get_ident(),
           "tname": threading.current_thread().name, "args": attrs}
    if trace is not None:
        rec["trace"] = trace
    _emit(rec)


def current_span_id() -> Optional[int]:
    return _current_span.get()


def current_trace_id() -> Optional[str]:
    return _current_trace.get()


def wire_context(span: SpanHandle, attempt: int = 1) -> dict:
    """The cross-process trace context a dispatcher ships with work (the
    fleet supervisor's ``/generate_batch`` items): enough for the receiving
    process to parent its own root span under ``span``, span ids being
    process-local. The worker's ``serve/request`` root takes the trace id
    and records ``remote_parent`` and ``attempt``, so a requeued
    re-execution merges as a sibling child of the same root."""
    return {"trace_id": span.trace, "parent_span": span.id, "attempt": int(attempt)}


# ---------------------------------------------------------------------------
# Telemetry registry: counters / gauges / histograms
# ---------------------------------------------------------------------------

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


def sanitize_label_name(name: str) -> str:
    """Label-name form of :func:`sanitize_metric_name` (labels may not
    contain colons and may not start with a digit)."""
    s = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    return s if s and not s[0].isdigit() else "_" + s


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


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

def merge_counter_rows(rows) -> dict[str, int]:
    """Sum each counter across per-process dicts (a process that never saw
    a kind contributes nothing): the job's fault view, gathered by the
    trainer's timeout-bounded ``dist.kv_allgather`` round."""
    out: dict[str, int] = {}
    for row in rows:
        for name, count in row.items():
            out[name] = out.get(name, 0) + int(count)
    return out


def flight_records() -> list[dict]:
    """The last-N span/event ring, newest last."""
    with _state.lock:
        return list(_state.ring)


def dump_flight_recorder(reason: str, *, directory: Optional[str | Path] = None,
                         extra: Optional[dict] = None) -> Optional[Path]:
    """Write ``flightrec_<rank>.json`` (``flightrec_w<i>_<rank>.json`` under
    ``DCR_WORKER_INDEX``): the reason, the ring, a registry snapshot and the
    device memory (``memory``), plus the sections of ``extra``, atomically,
    to ``directory`` (default: the configured trace dir, else
    ``DCR_FLIGHTREC_DIR``). Never raises; None when there is nowhere to
    write or the write fails. The first dump wins: the record nearest the
    fault is the post-mortem, not the excepthook's one frame up."""
    if _state.dumped is not None:
        return _state.dumped
    d = directory or _state.dir or os.environ.get("DCR_FLIGHTREC_DIR")
    if not d:
        return None
    rank = _rank()
    widx = os.environ.get("DCR_WORKER_INDEX")
    name = f"flightrec_{rank}.json" if widx is None else f"flightrec_w{widx}_{rank}.json"
    path = Path(d) / name
    try:
        from dcr_tpu_torch.obs import memwatch

        memory = memwatch.memory_snapshot_doc()
    except Exception as e:  # the dump must survive a broken memory read
        log.warning("[trace] flightrec_memory_snapshot_failed %r", e)
        memory = None
    doc = {"version": TRACE_VERSION, "reason": reason, "time": time.time(), "rank": rank,
           "os_pid": os.getpid(), "memory": memory, "records": flight_records(),
           "registry": _REGISTRY.snapshot(), **(extra or {})}
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(doc, indent=1, default=str))
        tmp.replace(path)      # atomic: a dump raced by the exit never tears
    except OSError as e:
        log.warning("[trace] flightrec_write_failed %r", e)
        return None
    _state.dumped = path
    log.warning("[trace] flight_recorder_dumped path=%s reason=%s records=%d",
                path, reason, len(doc["records"]))
    return path


def last_span_names(n: int = 8) -> list[str]:
    """The names of the newest ``n`` records, for a hang's post-mortem line."""
    return [r["name"] for r in flight_records()[-n:]]


_orig_excepthook = None
_hook_lock = threading.Lock()


def _excepthook(exc_type, exc, tb) -> None:
    dump_flight_recorder(f"unhandled_exception: {exc_type.__name__}: {exc}")
    if _orig_excepthook is not None:
        _orig_excepthook(exc_type, exc, tb)


def install_excepthook() -> None:
    """Dump the flight recorder on an unhandled exception, then call the
    previous hook. SystemExit never reaches ``sys.excepthook``: the exits
    83/85/89 dump with their own reasons."""
    global _orig_excepthook
    with _hook_lock:
        if sys.excepthook is _excepthook:
            return
        _orig_excepthook = sys.excepthook
        sys.excepthook = _excepthook


def reset_for_tests() -> None:
    """Close the trace file, clear the ring, the first-dump latch and the
    registry."""
    with _state.lock:
        if _state.file is not None:
            try:
                _state.file.close()
            except OSError:
                log.warning("[trace] trace_file_close_failed during reset")
        _state.file = None
        _state.path = None
        _state.dir = None
        _state.rank = None
        _state.dumped = None
        _state.max_bytes = 0
        _state.bytes_written = 0
        _state.ring.clear()
    _REGISTRY.reset()
