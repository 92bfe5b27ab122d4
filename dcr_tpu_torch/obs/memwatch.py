"""Device-memory telemetry and out-of-memory forensics: counterpart of
``dcr_tpu/obs/memwatch.py`` on PyTorch's caching allocator.

- **Live telemetry** -- :func:`device_memory_stats` reads the current CUDA
  device's allocator statistics into the JAX package's keys
  ``{bytes_in_use, peak_bytes, bytes_limit}``, chosen so that memory the
  allocator caches but no tensor holds counts as free (PyTorch hands it to
  the next allocation):

  - ``bytes_in_use``: ``allocated_bytes.all.current`` (live tensors);
  - ``peak_bytes``: ``allocated_bytes.all.peak`` (reset by
    ``torch.cuda.reset_peak_memory_stats``);
  - ``bytes_limit``: the device's total memory times the per-process
    fraction when ``torch.cuda.set_per_process_memory_fraction`` set one;
  - ``reserved_bytes``: ``reserved_bytes.all.current``, forensic only.

  :func:`remaining_device_bytes` (serve's admission budget, the
  ``device_budget/remaining_bytes`` gauge, which the JAX package does not
  have) also takes the card's free bytes into account, so two processes
  on one card do not each count the whole card as theirs.

  These are host-side reads of the allocator's counters: no read adds a
  device synchronisation. None on the CPU. :class:`MemorySampler` feeds
  the ``device_mem/*`` gauges (``dcr_device_mem_{in_use,peak,limit}_bytes``
  in ``/metrics``) every ``DCR_MEMWATCH_PERIOD_S`` seconds (10; 0 turns it
  off), and :class:`span_hbm` adds ``hbm_peak`` / ``hbm_delta`` to a hot
  span (``train/step``, ``train/encode``, ``serve/device_step``), which
  ``tools/trace_report.py``'s Memory section aggregates.
- **Footprints** -- the eager port compiles nothing, so XLA's static
  accounting (``memory_block``, ``flops_of_compiled``) has no counterpart.
  The live-surface registry (:func:`note_surface`) holds measured
  footprints instead: serve notes each bucket's peak rise over its first
  batch as ``serve/batch_sampler@<bucket>`` (``temp_bytes``), and
  :func:`estimate_surface_bytes` gives the largest sibling, the estimate
  serve's memory budget admits a novel bucket against.
- **Out of memory** -- :func:`is_oom_error` recognises
  ``torch.OutOfMemoryError`` by type, the allocator's messages, and the
  ``oom`` fault kind's :class:`InjectedOom`; :func:`oom_abort` logs a
  ``[fault]`` line, dumps the flight recorder with an ``oom`` section (and,
  as on every dump, the ``memory`` snapshot), then exits with
  ``coordination.EXIT_OOM`` (85).

``DCR_MEMWATCH_FAKE`` (a JSON object with any of ``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``) stands in for the device's
statistics, so the CPU tests drive the gauges, the span attrs, admission
and the OOM path.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
from typing import Optional

import torch

from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing

log = logging.getLogger("dcr_tpu_torch")

#: JSON stand-in for device_memory_stats (tests, stats-less devices)
FAKE_ENV = "DCR_MEMWATCH_FAKE"
#: sampler period in seconds; 0 turns the sampler off
PERIOD_ENV = "DCR_MEMWATCH_PERIOD_S"
DEFAULT_PERIOD_S = 10.0


# ---------------------------------------------------------------------------
# Measured footprints (what this process holds resident)
# ---------------------------------------------------------------------------

_surfaces_lock = threading.Lock()
_live_surfaces: dict[str, dict] = {}


def note_surface(surface: str, key: str, mem: dict) -> None:
    """Record a resident program's footprint under ``surface@key`` (the OOM
    dump's ``live_surfaces``, the admission estimate's input) and emit a
    ``memwatch/surface_memory`` event."""
    with _surfaces_lock:
        _live_surfaces[f"{surface}@{key}"] = dict(mem)
    tracing.event("memwatch/surface_memory", surface=surface, key=key, **mem)


def live_footprints() -> dict[str, dict]:
    with _surfaces_lock:
        return {k: dict(v) for k, v in _live_surfaces.items()}


def _footprint(mem: dict) -> int:
    return (mem.get("temp_bytes", 0) + mem.get("output_bytes", 0)
            + mem.get("generated_code_bytes", 0))


def resident_program_bytes() -> int:
    """The summed footprint of the noted programs."""
    return sum(_footprint(mem) for mem in live_footprints().values())


def estimate_surface_bytes(surface_prefix: str) -> Optional[int]:
    """The footprint of one more program of a family: the largest sibling's
    (same model, same batch shape). None while none is noted (the first
    program is the warm start's to pay, not admission's)."""
    rows = [_footprint(mem) for key, mem in live_footprints().items()
            if key.startswith(surface_prefix)]
    return max(rows) if rows else None


# ---------------------------------------------------------------------------
# Live telemetry
# ---------------------------------------------------------------------------

# the high-water mark carried across region_peak's resets of the allocator's
# peak counter, so that peak_bytes() stays the process's
_peak_floor = 0


def _cuda_stats() -> Optional[dict]:
    # a process that has not touched the card (a run asked onto the CPU)
    # reads nothing, and the read does not start a CUDA context for it
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    dev = torch.cuda.current_device()
    stats = torch.cuda.memory_stats(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    fraction = getattr(torch.cuda, "get_per_process_memory_fraction", lambda d: 1.0)(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes": max(int(stats.get("allocated_bytes.all.peak", 0)), _peak_floor),
            "bytes_limit": int(total * fraction),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0))}


def device_memory_stats() -> Optional[dict]:
    """``{"bytes_in_use", "peak_bytes", "bytes_limit"}`` (+ ``reserved_bytes``
    on a card) of the current CUDA device, ``DCR_MEMWATCH_FAKE``'s numbers
    when set, None on the CPU or before the process has used the card."""
    fake = os.environ.get(FAKE_ENV)
    if fake:
        try:
            doc = json.loads(fake)
            return {"bytes_in_use": int(doc.get("bytes_in_use", 0)),
                    "peak_bytes": int(doc.get("peak_bytes_in_use",
                                              doc.get("bytes_in_use", 0))),
                    "bytes_limit": int(doc.get("bytes_limit", 0))}
        except (ValueError, TypeError, AttributeError) as e:
            R.log_event("memwatch_bad_fake_env", value=fake[:200], error=repr(e))
            return None
    try:
        return _cuda_stats()
    except Exception as e:  # a broken CUDA runtime must not break the caller
        log.debug("memwatch: device stats unavailable: %r", e)
        return None


def peak_bytes() -> Optional[int]:
    """Peak device bytes allocated since the last :func:`reset_peak` (None on
    the CPU), across the resets :func:`region_peak` makes."""
    stats = device_memory_stats()
    return int(stats["peak_bytes"]) if stats else None


def reset_peak() -> None:
    """Start a new high-water mark (``torch.cuda.reset_peak_memory_stats``
    and the carried floor)."""
    global _peak_floor
    _peak_floor = 0
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()


class region_peak:
    """The peak rise of a region over the bytes in use at its start:
    ``.rise`` after the block, None without device statistics. On a card
    the allocator's peak counter is reset at the start (the process's
    high-water mark before it is carried into :func:`peak_bytes`), so the
    rise is the region's own; under ``DCR_MEMWATCH_FAKE`` it is the fake
    peak over the fake use."""

    __slots__ = ("rise", "_before")

    def __init__(self):
        self.rise: Optional[int] = None
        self._before: Optional[dict] = None

    def __enter__(self):
        global _peak_floor
        self._before = device_memory_stats()
        if self._before is not None and not os.environ.get(FAKE_ENV):
            _peak_floor = max(_peak_floor, int(self._before["peak_bytes"]))
            torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None or self._before is None:
            return False
        if os.environ.get(FAKE_ENV):
            after = device_memory_stats()
            peak = None if after is None else int(after["peak_bytes"])
        else:
            peak = int(torch.cuda.max_memory_allocated())   # the region's own
        if peak is not None:
            self.rise = max(0, peak - int(self._before["bytes_in_use"]))
        return False


def _card_free_bytes() -> Optional[int]:
    """The card's free bytes as ``torch.cuda.mem_get_info`` counts them (every process on
    the card), None where there is no card in use or under
    ``DCR_MEMWATCH_FAKE``."""
    if os.environ.get(FAKE_ENV) or not (torch.cuda.is_available()
                                        and torch.cuda.is_initialized()):
        return None
    free, _total = torch.cuda.mem_get_info()
    return int(free)


def remaining_device_bytes() -> Optional[int]:
    """The bytes this process can still allocate, None when unknown: the
    smaller of ``limit - in use`` and the card's free bytes plus what this
    process's allocator has reserved but not handed out. The second figure
    counts other processes on the card (the fleet's workers share one),
    which this process's own statistics cannot see; a JAX worker owns its
    chip, so the first figure alone is its budget."""
    stats = device_memory_stats()
    if not stats or not stats.get("bytes_limit"):
        return None
    in_use = int(stats["bytes_in_use"])
    own = int(stats["bytes_limit"]) - in_use
    try:
        free = _card_free_bytes()
    except Exception as e:  # a broken CUDA runtime must not break admission
        log.debug("memwatch: the card's free bytes unavailable: %r", e)
        free = None
    if free is None:
        return own
    cached = max(0, int(stats.get("reserved_bytes", in_use)) - in_use)
    return min(own, free + cached)


def update_memory_gauges() -> Optional[dict]:
    """One sample into the ``device_mem/*`` gauges; returns it."""
    stats = device_memory_stats()
    if stats is None:
        return None
    reg = tracing.registry()
    reg.gauge("device_mem/in_use_bytes").set(stats["bytes_in_use"])
    reg.gauge("device_mem/peak_bytes").set(stats["peak_bytes"])
    reg.gauge("device_mem/limit_bytes").set(stats["bytes_limit"])
    remaining = remaining_device_bytes()
    if remaining is not None:
        reg.gauge("device_budget/remaining_bytes").set(remaining)
    return stats


class MemorySampler:
    """The ``device_mem/*`` gauges, sampled on a daemon thread. Where the
    device has no statistics the first sample says so and no thread runs."""

    def __init__(self, period_s: float = DEFAULT_PERIOD_S):
        self.period_s = max(0.1, float(period_s))
        self.active = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> bool:
        if self._thread is not None:
            return self.active
        if update_memory_gauges() is None:
            R.log_trace("memwatch_sampler_noop", reason="device reports no memory stats")
            return False
        self.active = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="memwatch-sampler")
        self._thread.start()
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            update_memory_gauges()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)


_sampler_lock = threading.Lock()
_sampler: Optional[MemorySampler] = None


def start_sampler(period_s: Optional[float] = None) -> bool:
    """Start the process-wide sampler once (the trainer and an in-process
    serve worker may both ask); ``DCR_MEMWATCH_PERIOD_S`` sets the period,
    0 turns it off. Returns whether sampling is on."""
    global _sampler
    env = os.environ.get(PERIOD_ENV)
    if period_s is None:
        period_s = float(env) if env else DEFAULT_PERIOD_S
    if period_s <= 0:
        return False
    with _sampler_lock:
        if _sampler is None:
            _sampler = MemorySampler(period_s)
            return _sampler.start()
        return _sampler.active


def reset_for_tests() -> None:
    """Stop the sampler, clear the footprint registry and the carried peak."""
    global _sampler, _peak_floor
    _peak_floor = 0
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
        _sampler = None
    with _surfaces_lock:
        _live_surfaces.clear()


class span_hbm:
    """Add ``hbm_peak`` (peak bytes at exit) and ``hbm_delta`` (the change in
    bytes in use across the region) to an open span::

        with tracing.span("serve/device_step") as sp, memwatch.span_hbm(sp):
            ...

    Without device statistics the span keeps its shape (no attrs)."""

    __slots__ = ("handle", "_before")

    def __init__(self, handle):
        self.handle = handle
        self._before: Optional[dict] = None

    def __enter__(self):
        self._before = device_memory_stats()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._before is None:
            return False
        after = device_memory_stats()
        if after is not None:
            self.handle.attrs.update(
                hbm_peak=int(after["peak_bytes"]),
                hbm_delta=int(after["bytes_in_use"] - self._before["bytes_in_use"]))
        return False


# ---------------------------------------------------------------------------
# Out-of-memory forensics and the typed exit
# ---------------------------------------------------------------------------

class InjectedOom(RuntimeError):
    """The ``oom`` fault kind's error (utils/faults.py), worded like the
    allocator's, raised only by injection hooks."""

    def __init__(self, where: str):
        super().__init__(f"CUDA out of memory (injected oom fault at {where})")


# the allocator's and the CUDA runtime's wordings
_OOM_MARKERS = ("CUDA out of memory", "out of memory", "Out of memory",
                "CUBLAS_STATUS_ALLOC_FAILED", "CUDNN_STATUS_ALLOC_FAILED",
                "RESOURCE_EXHAUSTED", "Failed to allocate")


def is_oom_error(e: BaseException) -> bool:
    """True for ``torch.OutOfMemoryError`` (by type), a ``MemoryError``,
    the injected fault, and errors whose text is an allocator failure's
    (a library call that ran out of workspace)."""
    if isinstance(e, (InjectedOom, MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    text = f"{type(e).__name__}: {e}"
    return any(marker in text for marker in _OOM_MARKERS)


def memory_snapshot_doc() -> dict:
    """The memory section of every flight-recorder dump: device statistics
    (None on the CPU), the noted footprints and their total."""
    return {"device_memory_stats": device_memory_stats(),
            "live_surfaces": live_footprints(),
            "resident_program_bytes": resident_program_bytes()}


def oom_abort(where: str, error: BaseException, *, buckets: Optional[list] = None,
              exit_fn=None) -> None:
    """The out-of-memory fatal path: a ``[fault] oom_abort`` line, a
    flight-recorder dump with an ``oom`` section (where, the error, the
    resident serve buckets), then ``os._exit(EXIT_OOM)`` -- a hard exit, so
    no producer or handler thread can wedge the dying process."""
    from dcr_tpu_torch.core import coordination as C

    exit_fn = exit_fn or C._exit_fn
    R.log_event("oom_abort", where=where, error=repr(error), exit_code=C.EXIT_OOM)
    extra = {"oom": {"where": where, "error": repr(error),
                     "compiled_buckets": [list(b) for b in (buckets or [])]}}
    try:
        tracing.dump_flight_recorder(f"oom: {where}: {error!r}", extra=extra)
    except Exception as dump_err:  # the dump must never block the exit
        log.warning("[fault] oom_dump_failed %r", dump_err)
    # a handler or stream already closed (a library's, or a test harness's)
    # must not keep the process from its exit either
    for stream in (*logging.getLogger().handlers, *log.handlers, sys.stderr, sys.stdout):
        try:
            stream.flush()
        except (ValueError, OSError):
            pass
    exit_fn(C.EXIT_OOM)
