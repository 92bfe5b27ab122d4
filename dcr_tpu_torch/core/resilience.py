"""Retry, fault logging and the graceful-drain signal hook (the parts of
``dcr_tpu/core/resilience.py`` the search stage and the serving layer call).

Every recovery action emits one ``[fault]`` WARNING line and bumps a
``faults/<name>`` counter, so a run's recovery history is greppable and
scraped; :func:`retry_call` retries transient I/O with exponential backoff
and jitter, and a missing file is never transient.
``eval/runner.read_with_retry`` is this retry with the eval config's
settings. :func:`install_signal_drain` is the serving layer's SIGTERM hook;
a drained service exits with :data:`EXIT_PREEMPTED`.
"""

from __future__ import annotations

import json
import logging
import random
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

from dcr_tpu_torch.core import tracing

log = logging.getLogger("dcr_tpu_torch")

#: "clean, restart me": the exit code of a drained service, the JAX package's
#: ``dcr_tpu.core.coordination.EXIT_PREEMPTED`` (one restart wrapper handles
#: a preempted trainer and a drained server alike)
EXIT_PREEMPTED = 83

# structurally-wrong-path errors are never transient; everything else in
# OSError space (EIO on NFS, ESTALE, connection resets) is worth a retry
NONTRANSIENT_IO = (FileNotFoundError, IsADirectoryError, NotADirectoryError)


def log_event(event: str, **fields: Any) -> None:
    """One structured, greppable WARNING line per fault or recovery action
    (the JAX package's ``[fault] <event> {json}`` format)."""
    log.warning("[fault] %s %s", event, json.dumps(fields, sort_keys=True, default=str))


def bump_counter(name: str, n: int = 1) -> int:
    """Increment the process-wide ``faults/<name>`` counter; returns the new
    value."""
    return tracing.registry().counter(f"faults/{name}").inc(n)


def retry_call(fn: Callable[[], Any], *, attempts: int = 3, base_delay: float = 0.05,
               max_delay: float = 2.0, name: str = "op") -> Any:
    """Call ``fn`` up to ``attempts`` times while it raises a transient
    OSError, backing off exponentially: the delay after failed attempt k is
    ``min(max_delay, base_delay * 2**(k-1))`` scaled by a uniform factor in
    ``[1, 1.5]``, so workers sharing a flaky filesystem do not retry in
    lockstep. Other exceptions, and the :data:`NONTRANSIENT_IO` errors,
    propagate at once; the last failure re-raises the underlying
    exception."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except OSError as e:
            if isinstance(e, NONTRANSIENT_IO):
                raise
            if attempt == attempts:
                log_event("retries_exhausted", name=name, attempts=attempts, error=repr(e))
                raise
            delay = min(max_delay, base_delay * (2 ** (attempt - 1)))
            delay *= 1.0 + 0.5 * random.random()
            log_event("retry", name=name, attempt=attempt, of=attempts,
                      delay_secs=round(delay, 3), error=repr(e))
            time.sleep(delay)
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
