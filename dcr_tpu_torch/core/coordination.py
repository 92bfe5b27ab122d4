"""Exit codes and the hang watchdog: the single-process part of
``dcr_tpu/core/coordination.py``.

- :data:`EXIT_PREEMPTED` (83), :data:`EXIT_OOM` (85) and :data:`EXIT_HANG`
  (89) are the codes a restart wrapper branches on: "final checkpoint
  written, restart me", "out of device memory" and "the loop hung, read the
  stack dump, then restart".
- :class:`HangWatchdog` is a heartbeat thread: the train loop beats it at
  every step boundary, and when the beats stop for longer than its timeout
  it calls :func:`hang_abort`, which logs, dumps the flight recorder and
  every thread's stack and exits with :data:`EXIT_HANG` instead of hanging
  until a scheduler kills the job. The out-of-memory exit
  (:data:`EXIT_OOM`) is ``obs/memwatch.oom_abort``'s.
- :func:`simulate_hang` is the target of the ``hang`` fault kind.

The port runs one process, so the reference's fault-agreement rounds
(``Coordinator``, ``Decision``) have nothing to agree on: every recovery
decision is local, as in the reference's single-host branch.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator, Optional

log = logging.getLogger("dcr_tpu_torch")

# chosen outside the shell's reserved ranges (1/2, 126-165)
EXIT_PREEMPTED = 83
EXIT_OOM = 85
EXIT_HANG = 89

# monkeypatchable so tests can observe aborts without dying
_exit_fn = os._exit


_abort_guard = threading.Lock()
_abort_started = False


def hang_abort(name: str, *, detail: str = "") -> None:
    """Post-mortem (a ``[fault] hang_abort`` line, a flight-recorder dump,
    every thread's stack on stderr), then a hard exit with
    :data:`EXIT_HANG`. ``os._exit``, not ``sys.exit``: the wedged main
    thread cannot unwind, and nothing after this call runs, so the logs are
    flushed first."""
    from dcr_tpu_torch.core.resilience import log_event

    global _abort_started
    with _abort_guard:
        if _abort_started:
            return
        _abort_started = True
    # the exit must happen even if the post-mortem itself breaks: an
    # exception on the watchdog thread would leave the process hung forever
    try:
        log_event("hang_abort", name=name, detail=detail, exit_code=EXIT_HANG)
        # the flight recorder: what was making progress, and when it stopped
        from dcr_tpu_torch.core import tracing

        tracing.dump_flight_recorder(f"hang_abort:{name} ({detail})")
        log.error("hang watchdog: aborting %r with exit code %d (%s); last trace records: "
                  "%s; every thread's stack follows", name, EXIT_HANG, detail,
                  tracing.last_span_names())
        for handler in logging.getLogger().handlers + log.handlers:
            handler.flush()
        sys.stderr.flush()
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    except Exception:
        log.exception("hang_abort post-mortem failed; aborting anyway")
    sys.stderr.flush()
    sys.stdout.flush()
    _exit_fn(EXIT_HANG)
    with _abort_guard:  # only reachable when tests stub out _exit_fn
        _abort_started = False


class HangWatchdog:
    """Heartbeat monitor: the train loop calls :meth:`beat` at every step
    boundary; when beats stop for longer than ``timeout_s`` the monitor
    thread calls ``abort(detail)`` (default: :func:`hang_abort`). It arms on
    the first beat, so the first step's kernel builds and allocations cannot
    trip it. ``timeout_s <= 0`` disables it: start, beat and stop do
    nothing."""

    def __init__(self, timeout_s: float, *, name: str = "train",
                 poll_s: Optional[float] = None,
                 abort: Optional[Callable[[str], None]] = None):
        self.timeout_s = float(timeout_s)
        self.name = name
        self._poll_s = poll_s if poll_s is not None else max(0.05, self.timeout_s / 4)
        self._abort = abort
        self._last_beat: Optional[float] = None
        self._last_step: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self.timeout_s <= 0 or self._thread is not None:
            return
        self._stop.clear()
        self._last_beat = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"hang-watchdog:{self.name}")
        self._thread.start()
        log.info("hang watchdog armed: %.1fs heartbeat timeout", self.timeout_s)

    def beat(self, step: Optional[int] = None) -> None:
        if self.timeout_s <= 0:
            return
        self._last_step = step
        self._last_beat = time.monotonic()

    @contextmanager
    def paused(self, step: Optional[int] = None) -> Iterator[None]:
        """Disarmed for work between steps that beats nothing (the port's
        synchronous checkpoint saves, a rollback's restore, the sample
        hook), re-armed by a fresh beat when it ends: a save longer than
        the timeout is not a hang."""
        self._last_beat = None
        try:
            yield
        finally:
            self.beat(step)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll_s)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            last = self._last_beat
            if last is None:            # not armed until the first beat
                continue
            stale = time.monotonic() - last
            if stale > self.timeout_s:
                detail = (f"no step-boundary heartbeat for {stale:.1f}s (timeout "
                          f"{self.timeout_s:.1f}s, last step {self._last_step})")
                if self._abort is not None:
                    self._abort(detail)
                else:
                    hang_abort(self.name, detail=detail)
                return


def simulate_hang(reason: str) -> None:
    """Fault-injection target of the ``hang`` kind: wedge this thread
    forever. Only the watchdog (or the scheduler) ends the process."""
    from dcr_tpu_torch.core.resilience import log_event

    log_event("injected_hang", reason=reason)
    while True:                              # pragma: no cover - ended by the watchdog
        time.sleep(3600)
