"""Pod-safe recovery decisions, exit codes and the hang watchdog: the
port's copy of ``dcr_tpu/core/coordination.py``.

- **The fault agreement.** At each log boundary every process allgathers a
  :class:`FaultWord` (nan_step, rollback_ok, preempt, bad_samples) over the
  store's control plane (``core/dist.kv_allgather``) and reduces the words
  with the pure :func:`reduce_fault_words`, so every process takes the same
  :class:`Action` at the same step: a NaN on one rank rolls every rank
  back, a SIGTERM on one rank gives one checkpoint and exit 83 on all. On
  one process the exchange is the same reduction over one word, with no
  collective.
- :data:`EXIT_PREEMPTED` (83), :data:`EXIT_OOM` (85) and :data:`EXIT_HANG`
  (89) are the codes a restart wrapper branches on: "final checkpoint
  written, restart me", "out of device memory" and "the loop hung, read the
  stack dump, then restart".
- :class:`HangWatchdog` is a heartbeat thread: the train loop beats it at
  every step boundary, and when the beats stop for longer than its timeout
  it calls :func:`hang_abort`, which logs the coordinator's last agreement,
  dumps the flight recorder and every thread's stack and exits with
  :data:`EXIT_HANG` instead of hanging until a scheduler kills the job. An
  agreement round that outlives its timeout aborts the same way. The
  out-of-memory exit (:data:`EXIT_OOM`) is ``obs/memwatch.oom_abort``'s.
- :func:`simulate_hang` is the target of the ``hang`` fault kind.
"""

from __future__ import annotations

import enum
import faulthandler
import logging
import os
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from dcr_tpu_torch.core import dist

log = logging.getLogger("dcr_tpu_torch")

# chosen outside the shell's reserved ranges (1/2, 126-165)
EXIT_PREEMPTED = 83
EXIT_OOM = 85
EXIT_HANG = 89

# monkeypatchable so tests can observe aborts without dying
_exit_fn = os._exit


class CoordinationError(RuntimeError):
    """Processes disagree on state that must be identical (the resume step)."""


class Action(enum.Enum):
    CONTINUE = "continue"
    ROLLBACK = "rollback"                  # every process restores the same checkpoint
    FAIL = "fail"                          # every process fails fast together
    CHECKPOINT_AND_EXIT = "checkpoint_and_exit"
    ABORT_BAD_SAMPLES = "abort_bad_samples"


_WORD_LEN = 4


@dataclass
class FaultWord:
    """One process's contribution to the agreement: fixed width, order-stable."""

    nan_step: int = -1         # step whose observed loss went non-finite; -1 = none
    rollback_ok: bool = False  # this process could roll back (budget and a checkpoint)
    preempt: bool = False      # SIGTERM/SIGINT seen here
    bad_samples: int = 0       # bad samples quarantined here this epoch

    def encode(self) -> np.ndarray:
        return np.asarray([self.nan_step, int(self.rollback_ok), int(self.preempt),
                           self.bad_samples], np.int64)

    @staticmethod
    def decode(vec: Sequence[int]) -> "FaultWord":
        vec = np.asarray(vec).reshape(-1)
        if vec.size != _WORD_LEN:
            raise ValueError(f"fault word must have {_WORD_LEN} fields, got {vec.size}")
        return FaultWord(nan_step=int(vec[0]), rollback_ok=bool(vec[1]),
                         preempt=bool(vec[2]), bad_samples=int(vec[3]))


@dataclass(frozen=True)
class Decision:
    """The reduced outcome of one agreement round, the same on every process."""

    action: Action
    nan_step: int = -1
    nan_ranks: tuple = ()
    preempt_ranks: tuple = ()
    bad_total: int = 0


def reduce_fault_words(words: Sequence[FaultWord], *,
                       bad_budget: Optional[int] = None) -> Decision:
    """One word per process -> one Decision, by precedence:

    1. any ``nan_step >= 0``: ROLLBACK to the earliest reported step when
       every NaN-reporting process can roll back, else FAIL (a NaN is never
       checkpointed, so it outranks preemption);
    2. any ``preempt``: CHECKPOINT_AND_EXIT (progress is kept even past the
       bad-sample budget; the restart judges again);
    3. the summed bad-sample count over ``bad_budget``: ABORT_BAD_SAMPLES;
    4. otherwise CONTINUE."""
    nan_ranks = tuple(i for i, w in enumerate(words) if w.nan_step >= 0)
    preempt_ranks = tuple(i for i, w in enumerate(words) if w.preempt)
    bad_total = int(sum(w.bad_samples for w in words))
    if nan_ranks:
        step = min(words[i].nan_step for i in nan_ranks)
        ok = all(words[i].rollback_ok for i in nan_ranks)
        return Decision(Action.ROLLBACK if ok else Action.FAIL, nan_step=step,
                        nan_ranks=nan_ranks, preempt_ranks=preempt_ranks,
                        bad_total=bad_total)
    if preempt_ranks:
        return Decision(Action.CHECKPOINT_AND_EXIT, preempt_ranks=preempt_ranks,
                        bad_total=bad_total)
    if bad_budget is not None and bad_total > bad_budget:
        return Decision(Action.ABORT_BAD_SAMPLES, bad_total=bad_total)
    return Decision(Action.CONTINUE, bad_total=bad_total)


class Coordinator:
    """One process's handle on the fault agreement.

    ``note_*`` record local observations; :meth:`exchange` allgathers them
    (no collective on one process) and returns the common
    :class:`Decision`. The transport is the store's control plane
    (:func:`dcr_tpu_torch.core.dist.kv_allgather`); tests may inject a
    ``vec -> rows`` allgather instead. Every round runs under ``timeout_s``:
    an overrun aborts with :data:`EXIT_HANG` (``abort_on_timeout=True``,
    the trainer's watchdog contract) or re-raises
    :class:`~dcr_tpu_torch.core.dist.BarrierTimeout`."""

    def __init__(self, *, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 allgather: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 timeout_s: float = 0.0, abort_on_timeout: bool = False,
                 bad_sample_budget: Optional[int] = None):
        self.process_index = dist.process_index() if process_index is None else process_index
        self.process_count = dist.process_count() if process_count is None else process_count
        self.allgather = allgather  # None: the store's control plane
        self.timeout_s = float(timeout_s)
        self.abort_on_timeout = abort_on_timeout
        self.bad_sample_budget = bad_sample_budget
        self._word = FaultWord()
        self.last_agreement: Optional[dict] = None  # dumped by hang_abort
        global _active_coordinator
        _active_coordinator = self  # hang post-mortems find the newest one

    def note_nan(self, step: int, *, rollback_ok: bool) -> None:
        self._word.nan_step = int(step)
        self._word.rollback_ok = bool(rollback_ok)

    def note_preempt(self) -> None:
        self._word.preempt = True           # sticky: preemption never un-happens

    def note_bad_samples(self, count: int) -> None:
        self._word.bad_samples = int(count)  # the epoch's count, not a delta

    def _gather_ints(self, values: Sequence[int], tag: str) -> list[list[int]]:
        """One allgather round of a small int vector per process, in rank
        order; a timeout obeys ``abort_on_timeout``."""
        try:
            if self.allgather is not None:
                rows = dist.run_with_timeout(
                    lambda: self.allgather(np.asarray(values, np.int64)),
                    self.timeout_s, name=f"agree:{tag}")
                return [[int(x) for x in np.asarray(row).reshape(-1)]
                        for row in np.asarray(rows).reshape(self.process_count, -1)]
            payload = ",".join(str(int(v)) for v in values)
            rows = dist.kv_allgather(payload, tag, timeout_s=self.timeout_s)
            return [[int(x) for x in row.split(",")] for row in rows]
        except dist.BarrierTimeout as e:
            if self.abort_on_timeout:
                hang_abort(tag, coordinator=self, detail=str(e))
            raise

    def exchange(self, step: int, tag: str = "sync") -> Decision:
        """One agreement round: collective on several processes, pure on one."""
        from dcr_tpu_torch.core.resilience import log_event

        word = self._word
        if self.process_count == 1:
            words = [word]
        else:
            rows = self._gather_ints([int(x) for x in word.encode()], f"word:{tag}")
            words = [FaultWord.decode(r) for r in rows]
        decision = reduce_fault_words(words, bad_budget=self.bad_sample_budget)
        self.last_agreement = {
            "step": int(step), "tag": tag, "local_word": vars(word).copy(),
            "action": decision.action.value, "nan_step": decision.nan_step,
            "preempt_ranks": list(decision.preempt_ranks),
            "bad_total": decision.bad_total,
        }
        # a NaN is handled right after the exchange; preempt stays;
        # bad_samples is an absolute count the caller refreshes
        self._word = FaultWord(preempt=word.preempt, bad_samples=word.bad_samples)
        if decision.action is not Action.CONTINUE:
            log_event("agreement", **self.last_agreement)
        return decision

    def agree_int(self, value: int, name: str) -> list[int]:
        """Allgather one int per process (the checkpoint-step agreement)."""
        if self.process_count == 1:
            return [int(value)]
        return [row[0] for row in self._gather_ints([int(value)], f"int:{name}")]

    def assert_same(self, name: str, value: int) -> None:
        """Raise :class:`CoordinationError` when processes disagree on a value
        that must be the same everywhere (the resume step)."""
        values = self.agree_int(value, name)
        if len(set(values)) > 1:
            raise CoordinationError(
                f"processes disagree on {name}: per-rank values {values}; refusing to "
                "start collectives from divergent state")


_active_coordinator: Optional[Coordinator] = None


_abort_guard = threading.Lock()
_abort_started = False


def hang_abort(name: str, *, coordinator: Optional[Coordinator] = None,
               detail: str = "") -> None:
    """Post-mortem (a ``[fault] hang_abort`` line with the coordinator's last
    agreement, a flight-recorder dump, every thread's stack on stderr), then
    a hard exit with :data:`EXIT_HANG`. ``os._exit``, not ``sys.exit``: the
    wedged main thread cannot unwind, and nothing after this call runs, so
    the logs are flushed first. On several processes rank 0 serves the
    store, so it waits a grace period before it exits: a peer blocked on the
    store then reaches its own timeout and post-mortem instead of a
    connection error."""
    from dcr_tpu_torch.core.resilience import log_event

    global _abort_started
    with _abort_guard:
        if _abort_started:
            # another thread (the watchdog, or a timed-out round) is already
            # exiting; park here rather than unwind into the caller
            while True:  # pragma: no cover - parked until that thread's _exit
                time.sleep(60)
        _abort_started = True
    coordinator = coordinator or _active_coordinator
    last = coordinator.last_agreement if coordinator is not None else None
    # the exit must happen even if the post-mortem itself breaks: an
    # exception on the watchdog thread would leave the process hung forever
    try:
        log_event("hang_abort", name=name, detail=detail, exit_code=EXIT_HANG,
                  last_agreement=last)
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
    if dist.process_count() > 1 and dist.process_index() == 0:
        timeout = coordinator.timeout_s if coordinator is not None else 0.0
        grace = min(60.0, timeout / 4 + 5.0) if timeout > 0 else 10.0
        log.error("process 0 serves the store: exiting in %.1f s so that its peers "
                  "abort with their own post-mortems first", grace)
        sys.stderr.flush()
        time.sleep(grace)
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
                 coordinator: Optional[Coordinator] = None,
                 poll_s: Optional[float] = None,
                 abort: Optional[Callable[[str], None]] = None):
        self.timeout_s = float(timeout_s)
        self.name = name
        self._coordinator = coordinator
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
                    hang_abort(self.name, coordinator=self._coordinator, detail=detail)
                return


def simulate_hang(reason: str) -> None:
    """Fault-injection target of the ``hang`` kind: wedge this thread
    forever. Only the watchdog (or the scheduler) ends the process."""
    from dcr_tpu_torch.core.resilience import log_event

    log_event("injected_hang", reason=reason)
    while True:                              # pragma: no cover - ended by the watchdog
        time.sleep(3600)
