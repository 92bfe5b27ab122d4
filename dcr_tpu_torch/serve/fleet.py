"""Fleet control plane: heartbeat-leased membership and the request journal
(own copy of ``dcr_tpu/serve/fleet.py``; the lease JSON and the journal
JSONL are the JAX package's byte for byte, so either package's tools read
the other's fleet directory).

Two pieces of durable, inspectable state make multi-worker serving
(:mod:`dcr_tpu_torch.serve.supervisor`) fault-tolerant:

- **Worker leases**: a fleet worker joins by publishing a small JSON lease
  (pid, HTTP port, vae scale, readiness) into the fleet directory and
  renewing it every ``fleet.heartbeat_s``; a lease silent for
  ``fleet.lease_s`` is dead membership, whatever the process table says.
  Lease files survive any subset of processes dying and are readable by
  out-of-process tools (a drill finds its kill target here).
- **Request journal**: the supervisor's append-only JSONL record of every
  accepted request's lifecycle: ``add`` (admitted) -> ``dispatch`` (sent
  to a worker) -> ``ack`` (response delivered) | ``requeue`` (worker died
  mid-flight; the request goes back to the queue head) | ``fail``
  (attempts exhausted: a typed 500, never a silent drop). The in-memory
  view drives requeue and duplicate-completion decisions; the file is the
  audit trail the zero-dropped-requests check replays.

Everything here is stdlib and wall-clock only: leases cross process
boundaries, so ``time.time()`` (one host, one clock) is the base, not a
per-process ``monotonic``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

from dcr_tpu_torch.core import fsio
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.serve.queue import GenBucket, Request


# ---------------------------------------------------------------------------
# Fleet directory layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetPaths:
    """Canonical layout of a fleet control-plane directory."""

    root: Path

    @property
    def leases(self) -> Path:
        return self.root / "leases"

    @property
    def journal(self) -> Path:
        return self.root / "journal.jsonl"

    @property
    def config(self) -> Path:
        return self.root / "config.json"

    @property
    def logs(self) -> Path:
        return self.root / "logs"

    def lease_file(self, index: int) -> Path:
        return self.leases / f"worker_{index}.json"

    def worker_log(self, index: int) -> Path:
        return self.logs / f"worker_{index}.log"

    def ensure(self) -> "FleetPaths":
        self.leases.mkdir(parents=True, exist_ok=True)
        self.logs.mkdir(parents=True, exist_ok=True)
        return self


def fleet_paths(root: str | Path) -> FleetPaths:
    return FleetPaths(Path(root))


# ---------------------------------------------------------------------------
# Heartbeat-leased membership
# ---------------------------------------------------------------------------

@dataclass
class WorkerLease:
    """One worker's membership claim. ``renewed_at``/``lease_s`` define the
    liveness contract; ``port`` is how the supervisor's dispatch channel
    finds the worker (workers bind port 0 and publish the real port here —
    no pick-then-close races); ``vae_scale`` teaches the supervisor the
    model's resolution granularity so it can fully validate buckets without
    loading the model itself."""

    index: int
    pid: int
    port: int
    vae_scale: int
    lease_s: float
    started_at: float = field(default_factory=time.time)
    renewed_at: float = field(default_factory=time.time)
    # warm-start readiness: a worker publishes its lease EARLY
    # (so the supervisor can watch warming progress and spawn_timeout_s
    # covers the whole boot) with ready=False, then flips it once every
    # bucket in its warm plan has run. The supervisor only attaches a
    # dispatch channel to a ready lease — it never dispatches into a cold
    # worker. The defaults keep hand-written leases dispatchable.
    ready: bool = True
    buckets_warm: int = -1    # -1 = not reported
    buckets_total: int = -1
    # copy-risk index state: absent | loading | ok | failed.
    # Rides the lease so the supervisor can (a) surface a worker whose
    # index load FAILED — it serves unscored, which must be visible, not
    # silent — and (b) route POST /check only to workers that can answer.
    # The default keeps leases without the field parseable.
    risk: str = "absent"

    def expired(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.time()) \
            > self.renewed_at + self.lease_s

    def age_s(self, now: Optional[float] = None) -> float:
        return (now if now is not None else time.time()) - self.renewed_at


def write_lease(paths: FleetPaths, lease: WorkerLease) -> Path:
    """Atomic publish/renew: write-to-temp + rename, so a reader never sees
    a torn lease (a corrupt control plane must be impossible by
    construction, not just unlikely). The temp name is per-THREAD, not just
    per-process: the heartbeat thread renews concurrently with the main
    thread's warm-ready flip, and a shared temp path would let one
    os.replace race the other into FileNotFoundError."""
    paths.leases.mkdir(parents=True, exist_ok=True)
    target = paths.lease_file(lease.index)
    tmp = target.with_suffix(
        f".tmp.{lease.pid}.{threading.get_ident()}")
    fsio.publish_durable(tmp, target,
                         json.dumps(vars(lease), sort_keys=True) + "\n")
    return target


def read_lease(paths: FleetPaths, index: int) -> Optional[WorkerLease]:
    """None when absent. A malformed lease is treated as absent but LOUDLY
    (structured log + counter): it means something other than write_lease
    touched the control plane."""
    target = paths.lease_file(index)
    try:
        raw = target.read_text()
    except FileNotFoundError:
        return None
    except OSError as e:
        R.log_event("fleet_lease_read_error", index=index, error=repr(e))
        R.bump_counter("fleet_lease_read_errors")
        return None
    try:
        return WorkerLease(**json.loads(raw))
    except (ValueError, TypeError) as e:
        R.log_event("fleet_lease_corrupt", index=index, error=repr(e))
        R.bump_counter("fleet_lease_corrupt")
        return None


def clear_lease(paths: FleetPaths, index: int) -> None:
    """Remove a dead worker's lease so a respawned incarnation's publish is
    unambiguous and external tools never target a stale pid."""
    try:
        paths.lease_file(index).unlink()
    except FileNotFoundError:
        return
    except OSError as e:
        R.log_event("fleet_lease_clear_error", index=index, error=repr(e))
        R.bump_counter("fleet_lease_clear_errors")


class LeaseHeartbeat:
    """Worker-side renewal thread: republish the lease every ``heartbeat_s``
    until stopped. Renewal is liveness of the PROCESS, not of the device
    step — a wedged sampler still renews, which is why hang detection
    belongs to the worker's own batch watchdog (exit 89) and the
    supervisor's dispatch timeout, and the lease only backstops a fully
    frozen/SIGSTOPped process."""

    def __init__(self, paths: FleetPaths, lease: WorkerLease,
                 heartbeat_s: float):
        self.paths = paths
        self.lease = lease
        self.heartbeat_s = float(heartbeat_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LeaseHeartbeat":
        write_lease(self.paths, self.lease)      # join before the first beat
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"lease-heartbeat:{self.lease.index}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            self.lease.renewed_at = time.time()
            try:
                write_lease(self.paths, self.lease)
            except OSError as e:
                # a missed renewal is survivable (the lease has slack);
                # a silent one is not
                R.log_event("fleet_lease_renew_error", index=self.lease.index,
                            error=repr(e))
                R.bump_counter("fleet_lease_renew_errors")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.heartbeat_s)
            self._thread = None


# ---------------------------------------------------------------------------
# Request journal
# ---------------------------------------------------------------------------

QUEUED = "queued"
IN_FLIGHT = "in_flight"
ACKED = "acked"
FAILED = "failed"


@dataclass
class JournalEntry:
    """In-memory lifecycle state of one accepted request."""

    id: int
    prompt: str
    seed: int
    bucket: tuple
    state: str = QUEUED
    worker: int = -1          # current/last dispatch target
    attempts: int = 0         # dispatches so far (1 = never requeued)
    charged: int = 0          # attempts counted against max_attempts: a
                              # worker-state rejection (drain/overload) is
                              # refunded — the request never executed there
    trace_id: str = ""        # distributed trace id: constant across
                              # requeues, so the journal links every dispatch
                              # attempt to one cross-process span tree


# How many terminal (acked/failed) entries the journal keeps addressable for
# late-completion dedup before evicting the oldest. Only a requeued twin
# still sitting in the bounded admission queue ever needs its terminal
# record, so this just has to comfortably exceed queue_depth + max in-flight;
# an evicted id's late completion is still dropped (unknown == duplicate).
_TERMINAL_KEEP = 4096


class RequestJournal:
    """Supervisor-side accounting that makes "kill a worker, lose no
    requests" checkable rather than hoped-for.

    State machine per request (enforced; violations raise — a supervisor
    bug must never silently corrupt the zero-drop ledger)::

        add -> QUEUED -> dispatch -> IN_FLIGHT -> ack  -> ACKED (terminal)
                  ^                      |
                  +------ requeue -------+--> fail -> FAILED (terminal)

    ``ack`` is first-wins: a second completion for the same id (the worker
    was presumed dead, its batch requeued, and then BOTH executions
    delivered) returns False and is counted as a duplicate, so exactly one
    response reaches the client. Every transition appends one JSONL line to
    the durable journal (when a path is given); :meth:`replay` rebuilds the
    final states from the file alone — a crash drill's dropped-request
    count comes from there, not from in-process counters that die with the
    supervisor.
    """

    def __init__(self, path: Optional[str | Path] = None):
        self.path = Path(path) if path is not None else None
        # live (QUEUED/IN_FLIGHT) entries only: monitor/metrics scans are
        # O(backlog), not O(lifetime). Terminal entries move to the bounded
        # _terminal map (prompt dropped) so a week-long supervisor's RSS
        # doesn't grow with every request it ever served; the durable file
        # keeps the full history for replay().
        self._entries: dict[int, JournalEntry] = {}
        self._terminal: "collections.OrderedDict[int, JournalEntry]" = (
            collections.OrderedDict())
        self._accepted_total = 0
        self._acked_total = 0
        self._failed_total = 0
        self._lock = threading.Lock()
        self._file = None
        self.requeued_total = 0
        self.duplicate_acks = 0
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # one file = one supervisor incarnation: request ids restart per
            # process, so appending a restarted supervisor's lifecycle onto a
            # previous run's file would let run 2's `add` for id N overwrite
            # run 1's terminal state in replay() and corrupt the zero-drop
            # arithmetic. A leftover file (restart wrapper reusing
            # --fleet.dir) is rotated aside, never merged into.
            if self.path.exists() and self.path.stat().st_size:
                os.replace(self.path,
                           self.path.with_name(
                               f"{self.path.name}.{int(time.time())}"
                               f".{os.getpid()}"))
            self._file = self.path.open("a", buffering=1)  # line-buffered

    # -- transitions ---------------------------------------------------------

    def _append(self, op: str, **fields: Any) -> None:
        if self._file is None:
            return
        rec = {"op": op, "t": time.time(), **fields}
        try:
            self._file.write(json.dumps(rec, sort_keys=True) + "\n")
        except OSError as e:
            # the in-memory ledger stays correct; losing the audit trail is
            # loud, not fatal to serving
            R.log_event("fleet_journal_write_error", op=op, error=repr(e))
            R.bump_counter("fleet_journal_write_errors")

    def add(self, req: Request) -> JournalEntry:
        with self._lock:
            if req.id in self._entries or req.id in self._terminal:
                raise ValueError(f"request {req.id} already journaled")
            e = JournalEntry(id=req.id, prompt=req.prompt, seed=req.seed,
                             bucket=tuple(req.bucket),
                             trace_id=getattr(req, "trace_id", None) or "")
            self._entries[req.id] = e
            self._accepted_total += 1
            self._append("add", id=req.id, prompt=req.prompt, seed=req.seed,
                         bucket=list(req.bucket), trace=e.trace_id)
            return e

    def reject(self, req_id: int, reason: str) -> None:
        """Remove a never-dispatched entry (admission rolled back after the
        journal line was written — e.g. the bounded queue was full). Keeps
        the zero-drop arithmetic honest: a rejected request was never
        accepted, so it must not linger as QUEUED forever."""
        with self._lock:
            e = self._entries.get(req_id)
            if e is None:
                return
            if e.state != QUEUED or e.attempts:
                raise ValueError(
                    f"reject of request {req_id} in state {e.state!r} "
                    f"after {e.attempts} dispatch(es)")
            del self._entries[req_id]
            self._accepted_total -= 1
            self._append("reject", id=req_id, reason=reason)

    def dispatch(self, req_id: int, worker: int) -> Optional[int]:
        """QUEUED -> IN_FLIGHT; returns the attempt number (1-based).
        Returns None — caller must skip the request — when the entry is
        already terminal: a requeued twin finished first while this copy
        waited in the queue. Double-dispatch (IN_FLIGHT) is a supervisor
        bug and raises."""
        with self._lock:
            e = self._entries.get(req_id)
            if e is None:
                if req_id in self._terminal:
                    return None
                raise KeyError(req_id)
            if e.state != QUEUED:
                raise ValueError(
                    f"dispatch of request {req_id} in state {e.state!r}")
            e.state, e.worker = IN_FLIGHT, worker
            e.attempts += 1
            e.charged += 1
            self._append("dispatch", id=req_id, worker=worker,
                         attempt=e.attempts)
            return e.attempts

    def requeue(self, req_id: int, worker: int, reason: str,
                charge: bool = True) -> int:
        """IN_FLIGHT -> QUEUED (worker died / dispatch failed); returns the
        attempts charged so far so the caller can enforce max_attempts.
        ``charge=False`` refunds this dispatch: the worker rejected the item
        because of ITS state (draining/overloaded) without executing it, so
        the bounce must not burn the request's budget — the rejecting worker
        retires from dispatch, so the fleet's respawn budget bounds how often
        this can recur."""
        with self._lock:
            e = self._entries.get(req_id)
            if e is None:
                state = (self._terminal[req_id].state
                         if req_id in self._terminal else "unknown")
                raise ValueError(
                    f"requeue of request {req_id} in state {state!r}")
            if e.state != IN_FLIGHT:
                raise ValueError(
                    f"requeue of request {req_id} in state {e.state!r}")
            e.state = QUEUED
            if not charge:
                e.charged -= 1
            self.requeued_total += 1
            self._append("requeue", id=req_id, worker=worker, reason=reason,
                         attempts=e.attempts, charged=e.charged)
            return e.charged

    def ack(self, req_id: int, worker: int) -> bool:
        """First completion wins: True exactly once per request. A False
        return means a duplicate/late completion (or an ack for a request
        already failed) — the caller must DROP that result."""
        with self._lock:
            e = self._entries.get(req_id)
            if e is None:
                self.duplicate_acks += 1
                self._append("duplicate_ack", id=req_id, worker=worker)
                return False
            e.state, e.worker = ACKED, worker
            self._acked_total += 1
            self._retire(e)
            self._append("ack", id=req_id, worker=worker)
            return True

    def fail(self, req_id: int, reason: str) -> bool:
        """Terminal failure (attempts exhausted / unrecoverable worker
        error). False when the request already completed — same first-wins
        contract as :meth:`ack`."""
        with self._lock:
            e = self._entries.get(req_id)
            if e is None:
                return False
            e.state = FAILED
            self._failed_total += 1
            self._retire(e)
            self._append("fail", id=req_id, reason=reason)
            return True

    def _retire(self, e: JournalEntry) -> None:
        """Move a now-terminal entry out of the live map (lock held). The
        prompt is dropped (only the audit file needs it) and the terminal
        map is capped: late completions for evicted ids are still dropped,
        because unknown == duplicate in :meth:`ack`."""
        del self._entries[e.id]
        e.prompt = ""
        self._terminal[e.id] = e
        while len(self._terminal) > _TERMINAL_KEEP:
            self._terminal.popitem(last=False)

    # -- views ---------------------------------------------------------------

    def entry(self, req_id: int) -> Optional[JournalEntry]:
        with self._lock:
            return self._entries.get(req_id) or self._terminal.get(req_id)

    def inflight_for(self, worker: int) -> list[int]:
        """Request ids currently dispatched to ``worker`` — the requeue set
        when its lease lapses (last-resort sweep; the dispatch channel's own
        error path normally requeues first)."""
        with self._lock:
            return [e.id for e in self._entries.values()
                    if e.state == IN_FLIGHT and e.worker == worker]

    def pending_count(self) -> int:
        with self._lock:
            return len(self._entries)   # live == QUEUED or IN_FLIGHT

    def counts(self) -> dict:
        with self._lock:
            by_state = {QUEUED: 0, IN_FLIGHT: 0,
                        ACKED: self._acked_total, FAILED: self._failed_total}
            for e in self._entries.values():
                by_state[e.state] += 1
            return {"accepted": self._accepted_total, **by_state,
                    "requeued_total": self.requeued_total,
                    "duplicate_acks": self.duplicate_acks}

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError as e:
                R.log_event("fleet_journal_close_error", error=repr(e))
                R.bump_counter("fleet_journal_write_errors")
            self._file = None

    # -- offline audit -------------------------------------------------------

    @staticmethod
    def replay(path: str | Path) -> dict:
        """Rebuild final request states from the durable journal alone.

        Returns ``{"states": {id: state}, "counts": {...}}`` with the same
        count keys as :meth:`counts`. This is the acceptance arithmetic for
        chaos runs: ``dropped = accepted - acked - failed`` must be 0 (and
        ``failed`` must be 0 for a run whose churn stayed within the
        respawn/attempt budgets)."""
        states: dict[int, str] = {}
        requeued = duplicates = 0
        for line in Path(path).read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            op, rid = rec["op"], rec.get("id")
            if op == "add":
                states[rid] = QUEUED
            elif op == "reject":
                states.pop(rid, None)    # admission rolled back: never accepted
            elif op == "dispatch":
                states[rid] = IN_FLIGHT
            elif op == "requeue":
                states[rid] = QUEUED
                requeued += 1
            elif op == "ack":
                states[rid] = ACKED
            elif op == "fail":
                states[rid] = FAILED
            elif op == "duplicate_ack":
                duplicates += 1
        by_state = {QUEUED: 0, IN_FLIGHT: 0, ACKED: 0, FAILED: 0}
        for s in states.values():
            by_state[s] += 1
        counts = {"accepted": len(states), **by_state,
                  "requeued_total": requeued, "duplicate_acks": duplicates}
        counts["dropped"] = counts["accepted"] - counts[ACKED] - counts[FAILED]
        return {"states": states, "counts": counts}


def bucket_from_tuple(values: tuple | list) -> GenBucket:
    """Inverse of ``tuple(bucket)`` for journal/wire round-trips. Accepts
    the pre-fast 5-element form too (warm manifests and journals written by
    older incarnations): missing fast fields default to the dense plan —
    exactly what those programs were."""
    res, steps, guidance, sampler, lam, *fast = values
    if fast and len(fast) != 2:
        raise ValueError(f"bucket tuple has {len(values)} elements, "
                         "expected 5 or 7")
    fast_ratio, fast_order = fast or (0.0, 2)
    return GenBucket(resolution=int(res), steps=int(steps),
                     guidance=float(guidance), sampler=str(sampler),
                     rand_noise_lam=float(lam),
                     fast_ratio=float(fast_ratio),
                     fast_order=int(fast_order))
