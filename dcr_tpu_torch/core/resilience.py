"""Retry, fault logging and counters, the quarantine manifest, and the
graceful-drain signal hook (the parts of ``dcr_tpu/core/resilience.py`` the
port's trainer, data loader, search stage and serving layer call).

Every recovery action emits one ``[fault]`` WARNING line and bumps a
``faults/<name>`` counter, so a run's recovery history is greppable and
scraped; :func:`retry_call` retries with exponential backoff and jitter, and
by default only transient I/O (a missing file is never transient).
``eval/runner.read_with_retry`` is this retry with the eval config's
settings, the dataset's decode retry is it with every error retried.
:class:`QuarantineManifest` is the per-run ``quarantine.jsonl`` record of
everything skipped or recovered (bad samples, bad checkpoints, NaN
rollbacks). :func:`install_signal_drain` is the serving layer's SIGTERM
hook; a drained service exits with :data:`EXIT_PREEMPTED`. :func:`watchdog`
runs a block under a soft deadline (serve's batch watchdog).
"""

from __future__ import annotations

import json
import logging
import random
import signal
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Iterator, Optional, Sequence

from dcr_tpu_torch.core import tracing
# re-exported: the serving layer's drain exits with the trainer's code
from dcr_tpu_torch.core.coordination import EXIT_PREEMPTED  # noqa: F401

log = logging.getLogger("dcr_tpu_torch")

# structurally-wrong-path errors are never transient; everything else in
# OSError space (EIO on NFS, ESTALE, connection resets) is worth a retry
NONTRANSIENT_IO = (FileNotFoundError, IsADirectoryError, NotADirectoryError)


def log_event(event: str, **fields: Any) -> None:
    """One structured, greppable WARNING line per fault or recovery action
    (the JAX package's ``[fault] <event> {json}`` format), and a
    ``fault/<event>`` trace event, so the flight recorder and
    ``tools/trace_report.py``'s fault timeline see it."""
    log.warning("[fault] %s %s", event, json.dumps(fields, sort_keys=True, default=str))
    tracing.event(f"fault/{event}", attrs=fields)


def log_trace(event: str, **fields: Any) -> None:
    """The INFO-level ``[trace] <event> {json}`` line of lifecycle events
    (a profile armed, a sampler that has nothing to read)."""
    log.info("[trace] %s %s", event, json.dumps(fields, sort_keys=True, default=str))


def bump_counter(name: str, n: int = 1) -> int:
    """Increment the process-wide ``faults/<name>`` counter; returns the new
    value. Thread-safe (loader workers bump concurrently)."""
    return tracing.registry().counter(f"faults/{name}").inc(n)


def counters() -> dict[str, int]:
    """Snapshot of the process-wide fault counters, by name without the
    ``faults/`` prefix (the trainer re-prefixes them in its metrics)."""
    prefixed = tracing.registry().counters("faults/")
    return {k[len("faults/"):]: v for k, v in prefixed.items()}


def reset_counters() -> None:
    """Start a scenario from zero (tests)."""
    tracing.registry().reset("faults/")


class RetriesExhausted(RuntimeError):
    """For callers whose re-raised last error would hide the retry count;
    :func:`retry_call` itself re-raises the underlying exception."""


def retry_call(fn: Callable[[], Any], *, attempts: int = 3, base_delay: float = 0.05,
               max_delay: float = 2.0, jitter: float = 0.5,
               retry_on: tuple[type[BaseException], ...] = (OSError,),
               give_up_on: tuple[type[BaseException], ...] = NONTRANSIENT_IO,
               name: str = "op", sleep: Callable[[float], None] = time.sleep) -> Any:
    """Call ``fn`` up to ``attempts`` times while it raises one of
    ``retry_on``, backing off exponentially: the delay after failed attempt
    k is ``min(max_delay, base_delay * 2**(k-1))`` scaled by a uniform
    factor in ``[1, 1 + jitter]``, so workers sharing a flaky filesystem do
    not retry in lockstep. Exceptions outside ``retry_on``, or inside
    ``give_up_on`` (which wins where the two overlap; by default the
    :data:`NONTRANSIENT_IO` errors), propagate at once; the last failure
    re-raises the underlying exception."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if give_up_on and isinstance(e, give_up_on):
                raise
            if attempt == attempts:
                log_event("retries_exhausted", name=name, attempts=attempts, error=repr(e))
                raise
            delay = min(max_delay, base_delay * (2 ** (attempt - 1)))
            delay *= 1.0 + jitter * random.random()
            log_event("retry", name=name, attempt=attempt, of=attempts,
                      delay_secs=round(delay, 3), error=repr(e))
            sleep(delay)
    raise AssertionError("unreachable")


def read_bytes_with_retry(path: str | Path, *, attempts: int = 3,
                          name: Optional[str] = None) -> bytes:
    """File read hardened against transient I/O errors; a missing file
    raises FileNotFoundError at once."""
    p = Path(path)
    return retry_call(p.read_bytes, attempts=attempts, name=name or f"read:{p.name}")


def install_signal_drain(callback: Callable[[int], None],
                         signals: Optional[Sequence[int]] = None) -> None:
    """A one-shot graceful-drain handler for SIGTERM and SIGINT.

    The first signal calls ``callback(signum)`` once and restores the default
    disposition, so a second signal kills the process at once (the escape
    hatch when the drain itself wedges). ``callback`` runs in signal-handler
    context: it should only set flags or events; the drain work belongs on
    a normal thread."""
    sigs = tuple(signals or (signal.SIGTERM, signal.SIGINT))
    fired = threading.Event()

    def handler(signum, frame):
        for s in sigs:
            signal.signal(s, signal.SIG_DFL)
        if not fired.is_set():
            fired.set()
            log.info("drain signal %d received", signum)
            callback(signum)

    for s in sigs:
        signal.signal(s, handler)


@contextmanager
def watchdog(name: str, seconds: float,
             on_timeout: Optional[Callable[[], None]] = None) -> Iterator[None]:
    """Run a block under a soft deadline: if it still runs after
    ``seconds``, log one ``watchdog_timeout`` fault line and call
    ``on_timeout`` on the timer's thread (serve's batch watchdog passes
    ``coordination.hang_abort``, exit 89). ``seconds <= 0`` disables the
    timer. The block itself is never interrupted: a host thread cannot be
    stopped safely."""
    timer: Optional[threading.Timer] = None
    if seconds > 0:
        def fire() -> None:
            log_event("watchdog_timeout", name=name, budget_secs=seconds)
            if on_timeout is not None:
                on_timeout()
        timer = threading.Timer(seconds, fire)
        timer.daemon = True
        timer.start()
    try:
        yield
    finally:
        if timer is not None:
            timer.cancel()


class QuarantineManifest:
    """Per-run append-only JSONL record of recovered-from failures (the JAX
    package's ``quarantine.jsonl``: one ``{"kind", "time", **fields}``
    object per line, keys sorted).

    One record per quarantined item (bad sample, bad checkpoint, NaN
    rollback), written under a lock so loader worker threads can record
    concurrently. ``counts`` holds per-kind counters for the trainer's
    metrics; they reset with the process, the file is the durable trail."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def record(self, kind: str, **fields: Any) -> dict:
        rec = {"kind": kind, "time": time.time(), **fields}
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self.path.open("a") as f:
                f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
        log_event(f"quarantine_{kind}", **fields)
        return rec

    def count(self, kind: str) -> int:
        with self._lock:
            return self.counts.get(kind, 0)

    def entries(self) -> list[dict]:
        if not self.path.exists():
            return []
        return [json.loads(line) for line in self.path.read_text().splitlines()
                if line.strip()]
