"""Fleet supervisor: N serve workers behind one front end, zero dropped
requests across worker death (the port of ``dcr_tpu/serve/supervisor.py``).

Topology (``dcr-serve-torch --fleet.workers=N``)::

    supervisor process                         worker subprocess (xN)
    ------------------                         ----------------------
    HTTP front end (serve/server.py)           GenerationService
    bounded RequestQueue  <- admission         own HTTP server, port 0
    RequestJournal        <- zero-drop ledger  lease publish + heartbeat
    DispatchChannel xN    -> POST /generate_batch -> dynamic batching,
    monitor thread: leases, respawn, SLO          batch samplers,
    scrape thread: merged /metrics                batch watchdog (exit 89)

The supervisor owns admission and accounting and loads no model: it opens
no CUDA context. Workers own the device; on one card every worker opens
its own context on it. A dispatch channel pulls bucket-coherent batches
from the shared queue (the single-process :class:`~dcr_tpu_torch.serve.
batcher.Batcher` policy) only while its worker is alive, and keeps at most
one batch in flight per worker, so a worker's in-flight set is exactly one
journal batch.

Failure model: every path ends in "requeue, respawn, keep serving".

- **crash** (SIGKILL, segfault, injected ``worker_crash``, an OOM exit
  85): the in-flight HTTP call breaks, the channel requeues the batch at
  the queue HEAD and the monitor respawns the worker with bounded
  exponential backoff;
- **hang** (injected ``worker_hang``, a wedged device step): the worker's
  own batch watchdog exits 89; without one, ``fleet.dispatch_timeout_s``
  expires, the worker is SIGKILLed, same path;
- **preemption** (an external SIGTERM, exit 83): a death like the others:
  the worker drains what it holds, everything else requeues;
- **lease lapse** (a frozen process): SIGKILL and requeue.

Requeue is safe to re-execute because an image is a pure function of
(checkpoint, prompt, seed, bucket): the worker pads every batch to
``max_batch`` and draws each row from its own generators, so a re-run on
another worker or incarnation is bit-identical, and the journal's
first-completion-wins ack means a client never sees two answers. When
queue-wait p99 breaches ``fleet.slo_queue_wait_p99_s`` with a real
backlog, admission sheds typed 503s with Retry-After. When every slot
exhausts its respawn budget the supervisor fails loudly: pending futures
get typed errors, the flight recorder dumps, and the front end reports
"failed".
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.config import ServeConfig, to_dict
from dcr_tpu_torch.core.coordination import EXIT_OOM
from dcr_tpu_torch.core.metrics import LatencyTracker
from dcr_tpu_torch.obs.slo import SloEngine, default_objectives, parse_exposition
from dcr_tpu_torch.serve.batcher import Batcher
from dcr_tpu_torch.serve.fleet import (FleetPaths, RequestJournal, WorkerLease,
                                 clear_lease, fleet_paths, read_lease)
from dcr_tpu_torch.serve.scrape import (ScrapeCache, http_get_text, inject_labels,
                                  merge_expositions)
from dcr_tpu_torch.sampling import fastsample
from dcr_tpu_torch.serve.queue import (AdmissionError, BucketLimitError,
                                 DrainingError, GenBucket, NoWorkersError,
                                 Request, RequestQueue, SloShedError)
from dcr_tpu_torch.serve.worker import validate_bucket

# worker slot states
SPAWNING = "spawning"   # process launched, waiting for its lease
ALIVE = "alive"         # lease observed, dispatch channel running
BACKOFF = "backoff"     # died; respawn scheduled
RETIRED = "retired"     # respawn budget exhausted — slot permanently down


class RequestFailedError(RuntimeError):
    """A request exhausted its dispatch attempts (every attempt lost its
    worker) or its worker reported a per-request error — surfaced as the
    future's exception, mapped to HTTP 500 by the front end."""


# per-item worker errors (wire format "<TypeName>: <detail>") that describe
# the WORKER's state, not the request: re-execution on a survivor succeeds,
# so these requeue like a transport failure. Everything else (validation,
# generation failure) would fail identically anywhere and becomes a typed
# terminal failure.
_RETRYABLE_ITEM_PREFIXES = ("DrainingError:", "QueueFullError:")


def retryable_item_error(error: str) -> bool:
    return error.startswith(_RETRYABLE_ITEM_PREFIXES)


def _post_json(host: str, port: int, path: str, payload: dict,
               timeout_s: float) -> tuple[int, dict]:
    """One JSON POST over a fresh connection. The timeout is socket-level
    (connect + each read), which bounds a dead/wedged peer; a trickling peer
    is bounded by the worker's own watchdog instead."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        body = json.dumps(payload).encode()
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


class _WorkerSlot:
    """Mutable per-slot record; state transitions happen under the
    supervisor's lock (monitor thread and dispatch channels race on
    death-detection)."""

    def __init__(self, index: int):
        self.index = index
        self.state = BACKOFF                 # start() spawns immediately
        self.proc: Optional[subprocess.Popen] = None
        self.lease: Optional[WorkerLease] = None
        self.channel: Optional["DispatchChannel"] = None
        self.consecutive_failures = 0
        self.respawn_at = 0.0                # wall clock; 0 = due now
        self.spawn_deadline = 0.0
        self.alive_since = 0.0
        self.incarnation = 0                 # spawn count, for log lines

    def snapshot(self) -> dict:
        lease = self.lease
        return {
            "index": self.index, "state": self.state,
            "incarnation": self.incarnation,
            "pid": self.proc.pid if self.proc is not None else None,
            "port": lease.port if lease is not None else None,
            "lease_age_s": round(lease.age_s(), 3) if lease is not None else None,
            "consecutive_failures": self.consecutive_failures,
            # warm-start readiness from the lease payload: a SPAWNING slot
            # with ready=False is a live worker still running its warm plan
            "ready": self.state == ALIVE,
            "buckets_warm": lease.buckets_warm if lease is not None else None,
            "buckets_total": lease.buckets_total if lease is not None else None,
            "risk": lease.risk if lease is not None else None,
        }


def wire_item(req: Request, bucket: GenBucket, attempt: int) -> dict:
    """One ``/generate_batch`` wire item: prompt + seed + the FULL bucket
    identity — every field, including the fast-sampling plan, so the worker
    executes the supervisor's bucket rather than back-filling missing knobs
    from its own default — plus the distributed trace context. The worker
    side decodes it with ``server.request_bucket`` (round-trip pinned in
    tests/test_fastsample.py)."""
    return {"prompt": req.prompt, "seed": req.seed,
            "resolution": bucket.resolution, "steps": bucket.steps,
            "guidance": bucket.guidance, "sampler": bucket.sampler,
            "rand_noise_lam": bucket.rand_noise_lam,
            "fast_ratio": bucket.fast_ratio,
            "fast_order": bucket.fast_order,
            "trace": (tracing.wire_context(req.span, attempt)
                      if req.span is not None else None)}


class DispatchChannel:
    """The per-worker dispatch loop: pull a bucket-coherent batch from the
    shared queue, POST it to the worker, resolve futures from the response.
    One batch in flight at a time; any transport failure requeues the batch
    and reports the worker dead. The epilogue sweep requeues anything the
    journal still shows in flight on this worker — belt-and-braces against a
    channel dying between dispatch bookkeeping and the HTTP call."""

    def __init__(self, supervisor: "FleetSupervisor", slot: _WorkerSlot,
                 lease: WorkerLease):
        self.supervisor = supervisor
        self.slot = slot
        self.index = slot.index
        self.port = lease.port
        self._stop = threading.Event()
        # Event, not a bare bool: set by the monitor thread, read by the
        # dispatch loop — no shared lock covers the pair
        self._dead = threading.Event()       # set (pre-stop) on worker death
        cfg = supervisor.cfg
        self._batcher = Batcher(cfg.max_batch, cfg.max_wait_ms / 1000.0)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"fleet-dispatch:{self.index}.{slot.incarnation}")

    def start(self) -> None:
        self._thread.start()

    def mark_dead(self) -> None:
        self._dead.set()
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()

    def finished(self) -> bool:
        return not self._thread.is_alive()

    def join(self, timeout_s: float) -> None:
        self._thread.join(timeout_s)

    # -- the loop ------------------------------------------------------------

    def _run(self) -> None:
        sup = self.supervisor
        try:
            while True:
                batch = self._batcher.next_batch(sup.queue, stop=self._stop)
                if batch is None:
                    break
                if self._dead.is_set():
                    # stop() raced the take: nothing was dispatched, so this
                    # is a plain reinsertion (journal state is still QUEUED)
                    sup.queue.requeue(batch)
                    break
                if not self._dispatch(batch):
                    break
        except Exception as e:
            # a channel bug must surface as a worker failure (requeue +
            # respawn), never a silently missing consumer
            R.log_event("fleet_channel_error", worker=self.index, error=repr(e))
            R.bump_counter("fleet_channel_errors")
            sup._worker_failed(self.slot, f"dispatch channel error: {e!r}")
        finally:
            sup._sweep_orphans(self.index)

    def _dispatch(self, batch: list[Request]) -> bool:
        sup = self.supervisor
        cfg = sup.cfg
        t0 = time.monotonic()
        now_wall = time.time()
        send: list[Request] = []
        attempts: dict[int, int] = {}
        for req in batch:
            attempt = sup.journal.dispatch(req.id, self.index)
            if attempt is None:
                continue    # completed via a duplicate path while queued
            attempts[req.id] = attempt
            waited = t0 - req.enqueued_at
            sup.metrics.queue_wait.observe(waited)
            tracing.complete_span(
                "serve/queue_wait", start_wall=now_wall - waited,
                dur_s=waited,
                parent=req.span.id if req.span is not None else None,
                trace=req.trace_id, request_id=req.id)
            send.append(req)
        if not send:
            return True
        b = send[0].bucket
        # each wire item carries its distributed trace context: the worker
        # parents its serve/request span on the supervisor's root, so one
        # request = one span tree across both processes — and a requeued
        # re-execution ships the same trace id with attempt+1, merging as a
        # sibling child of the same root
        payload = {"requests": [wire_item(r, b, attempts[r.id])
                                for r in send]}
        ids = [r.id for r in send]
        with tracing.span("fleet/dispatch", worker=self.index,
                          batch=len(send), request_ids=ids,
                          trace_ids=[r.trace_id for r in send]):
            try:
                status, doc = _post_json(
                    cfg.host, self.port, "/generate_batch", payload,
                    cfg.fleet.dispatch_timeout_s)
            except (OSError, ValueError, http.client.HTTPException) as e:
                sup._requeue(send, self.index, f"transport: {e!r}")
                sup._worker_failed(self.slot, f"dispatch failed: {e!r}")
                return False
        results = doc.get("results") if status == 200 else None
        if results is None or len(results) != len(send):
            sup._requeue(send, self.index,
                         f"bad dispatch response (status {status})")
            sup._worker_failed(
                self.slot, f"dispatch rejected: status {status} {doc!r}")
            return False
        retry: list[Request] = []
        retry_reason = ""
        for req, item in zip(send, results):
            err = item.get("error")
            if err is not None:
                if retryable_item_error(err):
                    # the worker rejected the item because of ITS state
                    # (SIGTERM drain, local overload) — survivors can serve
                    # it bit-identically; handled below, stays live
                    retry.append(req)
                    retry_reason = retry_reason or err
                    continue
                # a per-request error from a HEALTHY worker is not transient
                # (typed validation/generation failure) — retrying it
                # elsewhere would fail identically
                if sup.journal.fail(req.id, err):
                    sup.counter("failed").inc()
                    req.future.set_exception(RequestFailedError(err))
            else:
                if sup.journal.ack(req.id, self.index):
                    item["worker"] = self.index
                    req.future.set_result(item)
                    sup.counter("completed").inc()
                else:
                    sup.counter("duplicate_completions").inc()
            sup._finish(req.id)
        sup.counter("batches_dispatched").inc()
        if retry:
            # requeue FIRST (so the orphan sweep can't double-handle them),
            # then retire this worker from dispatch: a draining worker is
            # leaving membership, and redispatching to it from this channel
            # would burn the requests' attempt budget in a tight loop
            sup._requeue(retry, self.index,
                         f"worker rejected items: {retry_reason}",
                         charge=False)
            sup._worker_failed(
                self.slot,
                f"rejected {len(retry)} item(s): {retry_reason}")
            return False
        return True


class FleetSupervisor:
    """Front-end-facing service (duck-compatible with
    :class:`~dcr_tpu_torch.serve.worker.GenerationService`: ``submit`` / ``status``
    / ``default_bucket`` / ``draining``) plus the worker lifecycle engine.
    ``serve/server.py``'s handler works against either."""

    def __init__(self, cfg: ServeConfig,
                 on_fatal: Optional[Callable[[], None]] = None):
        if cfg.fleet.workers < 1:
            raise ValueError("FleetSupervisor requires fleet.workers >= 1")
        self.cfg = cfg
        self.paths: FleetPaths = fleet_paths(cfg.fleet.dir).ensure()
        self.queue = RequestQueue(cfg.queue_depth)
        self.journal = RequestJournal(self.paths.journal)
        self.metrics = _FleetMetrics()
        self._on_fatal = on_fatal
        self._requests: dict[int, Request] = {}   # live until terminal
        self._requests_lock = threading.Lock()
        self._admitted_buckets: set[GenBucket] = set()
        self._buckets_lock = threading.Lock()
        self._vae_scale: Optional[int] = None     # learned from first lease
        # health stays "warming" until the first worker reports READY:
        # _vae_scale alone now arrives with the first warming (not-ready)
        # lease so admission can open and queue early, but a balancer must
        # not see "ok" while nothing can serve yet
        self._ever_ready = False
        # Event, not a bare bool: set by the front end's drain path, read
        # by admission and the monitor loop on their own threads
        self._draining = threading.Event()
        self._fatal = threading.Event()
        self._shutdown = threading.Event()
        self._lock = threading.Lock()             # slot state transitions
        self._slots = [_WorkerSlot(i) for i in range(cfg.fleet.workers)]
        self._poll_s = max(0.05, min(0.25, cfg.fleet.heartbeat_s / 2))
        self._healthy_reset_s = max(10.0, 5 * cfg.fleet.heartbeat_s)
        self._monitor: Optional[threading.Thread] = None
        self._scrape = ScrapeCache(cfg.host, cfg.fleet.scrape_timeout_s)
        self._scraper: Optional[threading.Thread] = None
        self._last_profile_worker: Optional[int] = None
        # the declarative SLO engine rides the monitor loop; the
        # prev-counter snapshots turn lifetime counters into per-tick
        # deltas (a single shed burst must not latch the rate forever)
        self._slo = (SloEngine(cfg.slo, default_objectives(cfg))
                     if cfg.slo.enabled else None)
        self._slo_prev = {"accepted": 0.0, "shed": 0.0}
        self._slo_scrape_prev: dict[int, dict[str, float]] = {}

    def counter(self, name: str):
        return tracing.registry().counter(f"fleet/{name}")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        # one config file feeds every worker spawn: the full supervisor
        # config with the role fields overridden per spawn on the CLI
        self.paths.config.write_text(
            json.dumps(to_dict(self.cfg), indent=2, sort_keys=True) + "\n")
        for slot in self._slots:
            self._spawn(slot)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="fleet-monitor")
        self._monitor.start()
        self._scraper = threading.Thread(target=self._scrape_loop,
                                         daemon=True, name="fleet-scraper")
        self._scraper.start()

    def _spawn(self, slot: _WorkerSlot) -> None:
        f = self.cfg.fleet
        clear_lease(self.paths, slot.index)   # a stale lease must never join
        with self._lock:
            slot.incarnation += 1
            incarnation = slot.incarnation
        argv = [sys.executable, "-m", "dcr_tpu_torch.cli.serve",
                f"--config={self.paths.config}",
                "--fleet.workers=0",
                f"--fleet.worker_index={slot.index}",
                "--port=0"]
        env = dict(os.environ)
        # the `rank` fault coordinate of serve-side DCR_FAULTS kinds (also
        # keys the worker's flightrec_w<i>_<rank>.json dump name)
        env["DCR_WORKER_INDEX"] = str(slot.index)
        # fallback post-mortem destination for workers running without a
        # --logdir: all workers share the fleet dir, so the worker-indexed
        # dump name above is what keeps one crash from clobbering another's
        env.setdefault("DCR_FLIGHTREC_DIR", str(self.paths.root))
        try:
            with open(self.paths.worker_log(slot.index), "ab") as logf:
                # Popen itself runs outside the lock (fork/exec is slow);
                # only the slot-state publish is guarded
                proc = subprocess.Popen(argv, stdout=logf,
                                        stderr=subprocess.STDOUT, env=env)
        except OSError as e:
            R.log_event("fleet_spawn_error", worker=slot.index, error=repr(e))
            R.bump_counter("fleet_spawn_errors")
            self._spawn_failed(slot, f"spawn: {e!r}")
            return
        with self._lock:
            slot.proc = proc
            slot.state = SPAWNING
            slot.spawn_deadline = time.time() + f.spawn_timeout_s
        self.counter("workers_spawned").inc()
        R.log_trace("fleet_spawn", worker=slot.index, pid=proc.pid,
                    incarnation=incarnation)

    def _worker_joined(self, slot: _WorkerSlot, lease: WorkerLease) -> None:
        with self._lock:
            if slot.state != SPAWNING:
                return
            slot.state = ALIVE
            slot.lease = lease
            slot.alive_since = time.time()
            self._ever_ready = True
            if self._vae_scale is None:
                self._vae_scale = lease.vae_scale
            slot.channel = DispatchChannel(self, slot, lease)
        slot.channel.start()
        R.log_trace("fleet_worker_joined", worker=slot.index, pid=lease.pid,
                    port=lease.port, incarnation=slot.incarnation)

    def _schedule_backoff_locked(self, slot: _WorkerSlot) -> bool:
        """One failure tick (caller holds ``self._lock``): bump the streak,
        move the slot to BACKOFF with bounded exponential delay — or RETIRED
        past the respawn budget. Returns whether the slot retired. The ONLY
        place the backoff/retire policy lives; runtime deaths and spawn
        failures must never drift apart."""
        f = self.cfg.fleet
        slot.consecutive_failures += 1
        delay = min(f.respawn_max_delay_s,
                    f.respawn_base_delay_s
                    * (2 ** (slot.consecutive_failures - 1)))
        slot.respawn_at = time.time() + delay
        retire = slot.consecutive_failures > f.respawn_max
        slot.state = RETIRED if retire else BACKOFF
        if retire:
            # a permanently-down slot must not keep serving its last scraped
            # numbers forever from the merged /metrics; the up/staleness
            # gauges still report the slot itself as down
            self._scrape.forget(slot.index)
        return retire

    def _worker_failed(self, slot: _WorkerSlot, reason: str) -> None:
        """First caller wins (monitor vs dispatch channel race); moves the
        slot to BACKOFF (or RETIRED), kills any remaining process, and lets
        the channel's error path / epilogue sweep requeue the in-flight
        work."""
        with self._lock:
            if slot.state not in (ALIVE, SPAWNING):
                return
            proc, channel = slot.proc, slot.channel
            rc = proc.poll() if proc is not None else None
            slot.lease = None
            retire = self._schedule_backoff_locked(slot)
            failures = slot.consecutive_failures
        self.counter("workers_lost").inc()
        R.log_event("fleet_worker_lost", worker=slot.index, reason=reason,
                    rc=rc, consecutive_failures=failures,
                    retired=retire)
        if channel is not None:
            channel.mark_dead()
        if proc is not None and proc.poll() is None:
            # frozen or wedged, not dead: SIGKILL also breaks the channel's
            # in-flight HTTP call, which is what triggers the requeue
            try:
                proc.kill()
            except OSError as e:
                R.log_event("fleet_kill_error", worker=slot.index,
                            error=repr(e))
                R.bump_counter("fleet_kill_errors")
        clear_lease(self.paths, slot.index)
        if retire:
            R.log_event("fleet_slot_retired", worker=slot.index,
                        failures=failures)

    def _spawn_failed(self, slot: _WorkerSlot, reason: str) -> None:
        with self._lock:
            proc = slot.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError as e:
                R.log_event("fleet_kill_error", worker=slot.index,
                            error=repr(e))
                R.bump_counter("fleet_kill_errors")
        with self._lock:
            slot.lease = None    # a warming (not-ready) lease may be attached
            retire = self._schedule_backoff_locked(slot)
        R.log_event("fleet_spawn_failed", worker=slot.index, reason=reason,
                    retired=retire)

    @staticmethod
    def _rc_reason(rc: int) -> str:
        """Name the typed exit codes in death reasons: an OOM (85) is
        handled exactly like any crash — requeue + respawn — but the
        operator-facing reason should say where the post-mortem is."""
        if rc == EXIT_OOM:
            return (f"worker OOM (exit {rc} EXIT_OOM — its flight-recorder "
                    "dump carries the memory snapshot and live-surface "
                    "footprints)")
        return f"process exited rc={rc}"

    def _monitor_loop(self) -> None:
        while not self._shutdown.wait(self._poll_s):
            now = time.time()
            alive = 0
            for slot in self._slots:
                # snapshot the slot under the lock, act on the copy: the
                # branch bodies re-check state under the lock before any
                # dependent write, so a stale snapshot costs one poll tick,
                # never a lost transition
                with self._lock:
                    state = slot.state
                    proc = slot.proc
                    spawn_deadline = slot.spawn_deadline
                    respawn_at = slot.respawn_at
                    channel = slot.channel
                    failures = slot.consecutive_failures
                if state == ALIVE:
                    rc = proc.poll()
                    lease = read_lease(self.paths, slot.index)
                    if rc is not None:
                        self._worker_failed(slot, self._rc_reason(rc))
                    elif lease is None or lease.expired(now):
                        age = lease.age_s(now) if lease is not None else None
                        self._worker_failed(
                            slot, f"lease lapsed (age {age}s) — frozen worker")
                    else:
                        # re-check under the lock: a dispatch channel may
                        # have moved the slot to BACKOFF since the unlocked
                        # state read above — writing lease/streak then would
                        # pin a live-looking lease onto a dead slot and lose
                        # a failure increment
                        with self._lock:
                            if slot.state == ALIVE:
                                slot.lease = lease
                                alive += 1
                                if (slot.consecutive_failures
                                        and now - slot.alive_since
                                        > self._healthy_reset_s):
                                    slot.consecutive_failures = 0
                elif state == SPAWNING:
                    rc = proc.poll()
                    lease = read_lease(self.paths, slot.index)
                    ours = lease is not None and lease.pid == proc.pid
                    if ours and lease.ready:
                        # dispatch is gated on READINESS, not liveness: a
                        # worker publishes its lease with ready=False while
                        # its warm plan runs, and the channel only
                        # attaches once the lease reports ready — the
                        # supervisor never dispatches into a cold worker
                        self._worker_joined(slot, lease)
                        alive += 1
                    elif rc is not None:
                        self._spawn_failed(
                            slot, f"{self._rc_reason(rc)} before publishing "
                            "a ready lease")
                    elif now > spawn_deadline:
                        self._spawn_failed(slot, "no ready lease within "
                                           f"{self.cfg.fleet.spawn_timeout_s}s"
                                           " (spawn_timeout_s covers load + "
                                           "warm start)")
                    elif ours:
                        # warming: surface progress in status() and learn the
                        # model's vae scale early so admission can open (and
                        # queue) while the first worker is still warming
                        with self._lock:
                            if slot.state == SPAWNING:
                                slot.lease = lease
                                if self._vae_scale is None:
                                    self._vae_scale = lease.vae_scale
                elif state == BACKOFF:
                    channel_done = (channel is None
                                    or channel.finished())
                    # a drain suppresses respawns ONLY once the backlog is
                    # gone: if the last worker dies mid-drain with accepted
                    # requests still requeued, refusing to respawn would
                    # strand them until the shutdown timeout 500s them —
                    # breaking "every accepted request receives its response"
                    if (channel_done and now >= respawn_at
                            and (not self._draining.is_set()
                                 or self.journal.pending_count() > 0)):
                        # the old incarnation's channel has fully unwound
                        # (its orphan sweep ran), so requeue/dispatch can't
                        # race the fresh incarnation
                        with tracing.span("fleet/respawn", worker=slot.index,
                                          failures=failures):
                            self.counter("respawns").inc()
                            self._spawn(slot)
            tracing.registry().gauge("fleet/workers_alive").set(float(alive))
            self._update_slo_gauges(alive)
            if self._slo is not None:
                try:
                    self._slo.observe(self._slo_signals())
                except Exception as e:
                    # evaluation is observability; the monitor loop is the
                    # fleet's heartbeat — log the failure, keep monitoring
                    R.log_event("slo_observe_failed", error=repr(e))
                    R.bump_counter("slo_observe_errors")
            with self._lock:
                all_retired = all(s.state == RETIRED for s in self._slots)
            if alive == 0 and all_retired and not self._fatal.is_set():
                self._fail_fleet()

    def _update_slo_gauges(self, alive: int) -> None:
        """Fleet SLO series as first-class exported gauges (scraped via
        /metrics?format=prometheus) instead of log lines: queue-wait p99 vs
        its target, shed rate, requeue rate, availability."""
        reg = tracing.registry()
        f = self.cfg.fleet
        reg.gauge("fleet/availability").set(alive / max(1, len(self._slots)))
        reg.gauge("fleet/queue_wait_p99_s").set(
            self.metrics.queue_wait.percentiles((99,))["p99"])
        reg.gauge("fleet/slo_queue_wait_p99_s").set(f.slo_queue_wait_p99_s)
        counts = reg.counters("fleet/")
        accepted = counts.get("fleet/accepted", 0)
        shed = counts.get("fleet/shed", 0)
        reg.gauge("fleet/shed_rate").set(shed / max(1, accepted + shed))
        reg.gauge("fleet/requeue_rate").set(
            counts.get("fleet/requeued", 0) / max(1, accepted))

    # -- SLO: objective signals + engine access --------------------------------

    def _fresh_worker_metrics(self) -> dict[int, dict[str, float]]:
        """Parsed metric dicts for every ALIVE worker whose cached scrape is
        FRESH (same staleness rule as ``dcr_fleet_worker_up``). A stale or
        missing scrape excludes the worker entirely — the SLO plane judges
        what it can still see, never a dead worker's last-good numbers."""
        f = self.cfg.fleet
        stale_after = (3 * max(f.scrape_period_s, f.scrape_timeout_s)
                       + len(self._slots) * f.scrape_timeout_s)
        scraped = self._scrape.snapshot()
        with self._lock:
            alive_idx = [s.index for s in self._slots if s.state == ALIVE]
        out: dict[int, dict[str, float]] = {}
        for index in alive_idx:
            text_age = scraped.get(index)
            if text_age is not None and text_age[1] <= stale_after:
                out[index] = parse_exposition(text_age[0])
        return out

    def _slo_signals(self) -> dict:
        """One signal snapshot per monitor tick for :meth:`SloEngine.observe`.
        Rates come from per-tick counter DELTAS (lifetime ratios latch old
        incidents forever); absent planes report None (no sample), never a
        fake healthy value."""
        workers = self._fresh_worker_metrics()
        signals: dict = {
            "availability": len(workers) / max(1, len(self._slots)),
            "queue_wait_p99_s":
                self.metrics.queue_wait.percentiles((99,))["p99"],
        }
        counts = tracing.registry().counters("fleet/")
        accepted = float(counts.get("fleet/accepted", 0))
        shed = float(counts.get("fleet/shed", 0))
        d_acc = accepted - self._slo_prev["accepted"]
        d_shed = shed - self._slo_prev["shed"]
        self._slo_prev.update(accepted=accepted, shed=shed)
        signals["shed_rate"] = (d_shed / (d_acc + d_shed)
                                if (d_acc + d_shed) > 0 else None)
        lag = [max(m.get("dcr_ingest_lag_seconds", 0.0),
                   m.get("dcr_ingest_oldest_unfolded_age_s", 0.0))
               for m in workers.values()
               if "dcr_ingest_lag_seconds" in m
               or "dcr_ingest_oldest_unfolded_age_s" in m]
        signals["ingest_lag_s"] = max(lag) if lag else None
        stale = [m["dcr_ann_staleness_rows"] for m in workers.values()
                 if "dcr_ann_staleness_rows" in m]
        signals["ann_staleness_rows"] = max(stale) if stale else None
        # online recall: sample-weighted across workers — a worker with 64
        # probed samples outweighs one that has probed twice
        num = den = 0.0
        for m in workers.values():
            n = m.get("dcr_ann_recall_online_samples", 0.0)
            if n > 0 and "dcr_ann_recall_online_pct" in m:
                num += (m["dcr_ann_recall_online_pct"] / 100.0) * n
                den += n
        signals["recall"] = (num / den) if den > 0 else None
        # coverage: scored/completed per tick, summed across workers; a
        # counter that moved backwards is a restarted worker — clamp its
        # delta to the fresh lifetime value instead of going negative
        d_scored = d_done = 0.0
        for index, m in workers.items():
            prev = self._slo_scrape_prev.get(index, {})
            for key, bucket in (("dcr_copy_risk_scored_total", "scored"),
                                ("dcr_serve_completed_total", "done")):
                cur = m.get(key)
                if cur is None:
                    continue
                delta = cur - prev.get(key, 0.0)
                if delta < 0:
                    delta = cur
                if bucket == "scored":
                    d_scored += delta
                else:
                    d_done += delta
            self._slo_scrape_prev[index] = {
                k: m[k] for k in ("dcr_copy_risk_scored_total",
                                  "dcr_serve_completed_total") if k in m}
        signals["coverage"] = (min(1.0, d_scored / d_done)
                               if d_done > 0 else None)
        return signals

    def slo_doc(self) -> dict:
        """``GET /slo``: the engine's full objective document (also the
        ``dcr-status-torch`` payload)."""
        if self._slo is None:
            return {"enabled": False}
        return self._slo.doc()

    # -- fleet metrics aggregation -------------------------------------------

    def _scrape_loop(self) -> None:
        """Pull each live worker's full telemetry registry (Prometheus text
        on its internal port) into the last-good cache. Bounded per-target
        timeout: a dead/wedged worker costs one socket timeout per cycle,
        never a hang — and its last good section keeps serving with a
        growing staleness gauge."""
        period = self.cfg.fleet.scrape_period_s
        while not self._shutdown.wait(period):
            # snapshot (slot, lease) pairs under the lock — the monitor
            # writes slot.lease under it — then scrape outside the lock so
            # a slow target never stalls state transitions
            with self._lock:
                targets = [(slot, slot.lease) for slot in self._slots
                           if slot.state == ALIVE and slot.lease is not None]
            for slot, lease in targets:
                ok = self._scrape.scrape(slot.index, lease.port)
                # close the scrape/retire race: a GET in flight when the
                # monitor retires the slot (and forgets its section)
                # would otherwise re-insert the dead worker's metrics
                # with nothing left to ever clear them
                if ok:
                    with self._lock:
                        if slot.state == RETIRED:
                            self._scrape.forget(slot.index)

    def prometheus_merged(self) -> str:
        """The fleet-wide ``/metrics?format=prometheus`` document: the
        supervisor's own registry (admission, journal, SLO gauges) plus every
        worker's scraped registry with a ``worker="N"`` label on each series,
        plus per-worker up/staleness gauges. Built entirely from cached
        scrapes — never blocks on a worker."""
        status_doc = dict(self.status())
        for key in ("workers", "role", "health"):   # non-numeric
            status_doc.pop(key, None)
        tracing.update_gauges(status_doc, prefix="serve/")
        sections = [tracing.registry().prometheus_text()]
        scraped = self._scrape.snapshot()
        # staleness threshold is CYCLE-aware: the scrape loop is sequential,
        # so one full cycle can cost period + one timeout per wedged worker —
        # a fixed multiple of the period alone would flap worker_up to 0 on
        # healthy workers whenever siblings are timing out. A truly dead
        # worker still drops out of `up` immediately via slot.state.
        f = self.cfg.fleet
        stale_after = (3 * max(f.scrape_period_s, f.scrape_timeout_s)
                       + len(self._slots) * f.scrape_timeout_s)
        up_lines = [
            "# HELP dcr_fleet_worker_up 1 when the slot is ALIVE and its "
            "last scrape is fresh",
            "# TYPE dcr_fleet_worker_up gauge",
            "# HELP dcr_fleet_worker_scrape_age_seconds age of the worker's "
            "last successful registry scrape",
            "# TYPE dcr_fleet_worker_scrape_age_seconds gauge",
        ]
        with self._lock:
            slot_states = [(s.index, s.state) for s in self._slots]
        for index, state in slot_states:
            label = {"worker": str(index)}
            text_age = scraped.get(index)
            fresh = text_age is not None and text_age[1] <= stale_after
            up = 1 if (state == ALIVE and fresh) else 0
            up_lines.append(inject_labels(
                f"dcr_fleet_worker_up {up}", label).rstrip("\n"))
            if text_age is not None:
                up_lines.append(inject_labels(
                    f"dcr_fleet_worker_scrape_age_seconds "
                    f"{round(text_age[1], 3)}", label).rstrip("\n"))
                sections.append(inject_labels(text_age[0], label))
        sections.insert(1, "\n".join(up_lines) + "\n")
        return merge_expositions(sections)

    # -- on-demand device profiling ------------------------------------------

    def profile(self, body: dict) -> dict:
        """``POST /debug/profile`` routed to a worker: arm a torch.profiler
        capture around that worker's next K device steps. Body
        ``{"worker"?: int, "steps"?: int, "logdir"?: str}``; default target
        is the first ALIVE worker."""
        target = body.get("worker")
        with self._lock:
            alive = {s.index: s.lease for s in self._slots
                     if s.state == ALIVE and s.lease is not None}
        if target is None:
            if not alive:
                raise NoWorkersError("no ALIVE worker to profile")
            target = min(alive)
        target = int(target)
        if target not in alive:
            raise ValueError(f"worker {target} is not ALIVE "
                             f"(alive: {sorted(alive)})")
        fwd = {k: body[k] for k in ("steps", "logdir") if k in body}
        status, doc = _post_json(self.cfg.host, alive[target].port,
                                 "/debug/profile", fwd,
                                 self.cfg.fleet.scrape_timeout_s)
        if status != 200:
            raise RuntimeError(
                f"worker {target} rejected profile arm ({status}): {doc!r}")
        self._last_profile_worker = target
        return {**doc, "worker": target}

    def profile_status(self) -> dict:
        """``GET /debug/profile``: the armed worker's capture status."""
        target = self._last_profile_worker
        if target is None:
            return {"armed": False, "worker": None}
        with self._lock:
            slot = self._slots[target]
            lease = slot.lease if slot.state == ALIVE else None
        if lease is None:
            return {"armed": False, "worker": target,
                    "error": f"worker {target} is no longer alive"}
        try:
            status, text = http_get_text(self.cfg.host, lease.port,
                                         "/debug/profile",
                                         self.cfg.fleet.scrape_timeout_s)
            doc = json.loads(text) if status == 200 else {"error": text}
        except (OSError, ValueError, http.client.HTTPException) as e:
            doc = {"armed": False, "error": repr(e)}
        return {**doc, "worker": target}

    # -- copy-risk -----------------------------------------------------------

    def risk_health(self) -> str:
        """Fleet-level risk-index state for /healthz: "ok" once ANY alive
        worker can score (POST /check routes there), "failed" when every
        reporting worker failed its load — a fleet silently serving
        unscored is exactly what this field makes visible. Only ALIVE
        slots count, matching :meth:`check`'s routing filter exactly: a
        warming worker whose background index load finished early must
        not flip this to "ok" while /check still has nowhere to route."""
        if not (self.cfg.risk.index_path or self.cfg.risk.store_dir):
            return "absent"
        with self._lock:
            statuses = [s.lease.risk for s in self._slots
                        if s.state == ALIVE and s.lease is not None]
        if "ok" in statuses:
            return "ok"
        if "loading" in statuses or not statuses:
            return "loading"
        return "failed"

    def check(self, body: dict) -> dict:
        """``POST /check`` routed to the first ALIVE worker whose lease
        reports a loaded risk index; the reply carries the serving worker's
        index. Raises RiskUnavailableError (503 + status) when no worker
        can answer."""
        from dcr_tpu_torch.obs.copyrisk import RiskUnavailableError

        status = self.risk_health()
        with self._lock:
            ready = [(s.index, s.lease) for s in self._slots
                     if s.state == ALIVE and s.lease is not None
                     and s.lease.risk == "ok"]
        if not ready:
            raise RiskUnavailableError(
                f"no ALIVE worker with a loaded risk index "
                f"(fleet risk: {status})", status=status)
        last_err: Optional[BaseException] = None
        for index, lease in ready:
            try:
                code, doc = _post_json(self.cfg.host, lease.port, "/check",
                                       body,
                                       self.cfg.fleet.dispatch_timeout_s)
            except (OSError, ValueError, http.client.HTTPException) as e:
                # the crash race the fleet is BUILT for: the chosen worker
                # died between the lease read and the POST — fail over to
                # the next ready lease instead of 500ing a query another
                # worker can answer (the monitor reaps the dead one)
                R.log_event("risk_check_transport_error", worker=index,
                            error=repr(e))
                R.bump_counter("fleet_check_transport_errors")
                last_err = e
                continue
            if code == 400:
                raise ValueError(str(doc.get("error", doc)))
            if code == 503:
                # the worker's own risk state regressed (e.g. restarted and
                # reloading); stale-lease race — try the next ready worker
                last_err = RiskUnavailableError(
                    str(doc.get("detail", doc)),
                    status=doc.get("risk", status))
                continue
            if code != 200:
                raise RuntimeError(
                    f"worker {index} rejected /check ({code}): {doc!r}")
            return {**doc, "worker": index}
        if isinstance(last_err, RiskUnavailableError):
            raise last_err
        raise RiskUnavailableError(
            f"every risk-ready worker failed the check query "
            f"(last: {last_err!r})", status=status)

    def _fail_fleet(self) -> None:
        """Every slot exhausted its respawn budget: fail pending work loudly
        and leave a post-mortem, instead of a healthy-looking port whose
        queue never drains."""
        self._fatal.set()
        R.log_event("fleet_failed", workers=self.cfg.fleet.workers,
                    pending=self.journal.pending_count())
        with self._requests_lock:
            pending = list(self._requests.values())
        for req in pending:
            if self.journal.fail(req.id, "fleet failed: all slots retired"):
                self.counter("failed").inc()
                if not req.future.done():
                    req.future.set_exception(RequestFailedError(
                        "fleet failed: every worker slot exhausted its "
                        "respawn budget"))
            self._finish(req.id)
        tracing.dump_flight_recorder("fleet_failed: all worker slots retired")
        if self._on_fatal is not None:
            self._on_fatal()

    # -- requeue / bookkeeping ----------------------------------------------

    def _requeue(self, reqs: list[Request], worker: int, reason: str,
                 charge: bool = True) -> None:
        """Journaled IN_FLIGHT -> QUEUED for a dead worker's batch; requests
        past the attempt budget become typed failures instead (still never a
        silent drop — the journal records which). ``charge=False`` refunds
        the dispatch (worker-state rejection: the request never executed),
        so a rolling restart can't exhaust a request's budget with bounces
        that a survivor would serve identically."""
        keep: list[Request] = []
        with tracing.span("serve/requeue", worker=worker, n=len(reqs),
                          reason=reason,
                          trace_ids=[r.trace_id for r in reqs]):
            for req in reqs:
                attempts = self.journal.requeue(req.id, worker, reason,
                                                charge=charge)
                if attempts >= self.cfg.fleet.max_attempts:
                    if self.journal.fail(
                            req.id, f"attempts exhausted ({attempts})"):
                        self.counter("failed").inc()
                        if not req.future.done():
                            req.future.set_exception(RequestFailedError(
                                f"request lost its worker {attempts} times "
                                f"(last: {reason})"))
                    self._finish(req.id)
                else:
                    keep.append(req)
                    self.counter("requeued").inc()
            self.queue.requeue(keep)
        R.log_event("serve_requeue", worker=worker, n=len(keep),
                    failed=len(reqs) - len(keep), reason=reason)

    def _sweep_orphans(self, worker: int) -> None:
        """Requeue whatever the journal still shows in flight on a stopped
        worker — normally empty (the channel's error path already ran)."""
        ids = self.journal.inflight_for(worker)
        if not ids:
            return
        with self._requests_lock:
            reqs = [self._requests[i] for i in ids if i in self._requests]
        if reqs:
            self._requeue(reqs, worker, "orphan sweep after worker loss")

    def _finish(self, req_id: int) -> None:
        with self._requests_lock:
            self._requests.pop(req_id, None)

    # -- admission (front-end facing) ----------------------------------------

    def default_bucket(self) -> GenBucket:
        c = self.cfg
        ratio, order = fastsample.canonical_plan_params(
            c.num_inference_steps,
            c.fast.reuse_ratio if c.fast.enabled else 0.0, c.fast.order)
        return GenBucket(resolution=c.resolution, steps=c.num_inference_steps,
                         guidance=c.guidance_scale, sampler=c.sampler,
                         rand_noise_lam=c.rand_noise_lam,
                         fast_ratio=ratio, fast_order=order)

    def _check_shed(self) -> None:
        f = self.cfg.fleet
        if f.slo_queue_wait_p99_s <= 0:
            return
        # shedding needs BOTH a breached p99 and a live backlog: the p99
        # window only refreshes while requests flow, so without the depth
        # gate a single bad burst would latch the shed forever
        if self.queue.depth() < self.cfg.max_batch:
            return
        p99 = self.metrics.queue_wait.percentiles((99,)).get("p99", 0.0)
        if p99 > f.slo_queue_wait_p99_s:
            self.counter("shed").inc()
            raise SloShedError(
                f"queue-wait p99 {p99:.2f}s over SLO "
                f"{f.slo_queue_wait_p99_s:.2f}s — shedding",
                retry_after_s=f.shed_retry_after_s)

    def submit(self, prompt: str, *, seed: int = 0,
               bucket: Optional[GenBucket] = None,
               trace_ctx: Optional[dict] = None) -> Request:
        """Admit into the fleet queue. Same typed-rejection contract as
        GenerationService.submit, plus :class:`SloShedError` (503 +
        Retry-After) and :class:`NoWorkersError` (fleet warming/failed).
        ``trace_ctx`` exists for signature duck-compat with
        GenerationService; a supervisor is the trace ROOT, so an incoming
        context is ignored (fleets do not nest)."""
        del trace_ctx
        f = self.cfg.fleet
        bucket = bucket or self.default_bucket()
        try:
            if self._draining.is_set():
                raise DrainingError(
                    "service is draining; not accepting requests")
            if self._fatal.is_set():
                raise NoWorkersError(
                    "fleet failed: every worker slot is retired",
                    retry_after_s=f.shed_retry_after_s)
            with self._lock:   # published by the monitor under the same lock
                vae_scale = self._vae_scale
            if vae_scale is None:
                raise NoWorkersError(
                    "no worker has joined yet (fleet warming up)",
                    retry_after_s=f.shed_retry_after_s)
            validate_bucket(bucket, vae_scale=vae_scale)
            self._check_shed()      # before the bucket is registered
            with self._buckets_lock:
                bucket_added = bucket not in self._admitted_buckets
                if (bucket_added and len(self._admitted_buckets)
                        >= self.cfg.max_compiled_buckets):
                    raise BucketLimitError(
                        f"bucket {bucket} would exceed the resident "
                        f"compiled-sampler budget "
                        f"({self.cfg.max_compiled_buckets}) on every worker")
                self._admitted_buckets.add(bucket)
            req = Request(prompt=prompt, seed=int(seed) & 0xFFFFFFFF,
                          bucket=bucket)
            # the distributed-trace root: the id travels with the request
            # through the journal and every dispatched batch, and survives
            # requeue-after-worker-death unchanged (attempts become sibling
            # child spans under this root)
            req.trace_id = tracing.new_trace_id()
            root = tracing.begin_span("serve/request", parent=None,
                                      trace=req.trace_id,
                                      request_id=req.id, seed=req.seed,
                                      bucket=str(tuple(bucket)))
            req.span = root
            with self._requests_lock:
                self._requests[req.id] = req
            # journal BEFORE queue: a dispatch channel may pop the request
            # the instant it is published, and must find it journaled
            self.journal.add(req)
            try:
                self.queue.submit(req)
            except AdmissionError:
                self.journal.reject(req.id, "queue rejected admission")
                self._finish(req.id)
                # a never-dispatched novel bucket must not consume a
                # compiled-sampler slot forever. Kept when any live request
                # still carries it (the rare concurrent-admit race then at
                # worst over-counts by the one slot we leave registered)
                if bucket_added:
                    with self._requests_lock:
                        in_use = any(r.bucket == bucket
                                     for r in self._requests.values())
                    if not in_use:
                        with self._buckets_lock:
                            self._admitted_buckets.discard(bucket)
                raise
            if self._fatal.is_set():
                # raced _fail_fleet: its one-shot sweep may have snapshotted
                # _requests before this insert, leaving a request no retired
                # channel will ever pop and no sweep will ever fail. Make it
                # terminal here and reject admission with the same typed 503
                # the pre-check gives.
                try:
                    self.journal.reject(req.id, "fleet failed during admission")
                except ValueError:
                    pass            # the sweep got there first: already terminal
                self._finish(req.id)
                raise NoWorkersError(
                    "fleet failed: every worker slot is retired",
                    retry_after_s=f.shed_retry_after_s)
        except AdmissionError as e:
            self.metrics.note_rejected(e)
            tracing.event("serve/rejected", error=type(e).__name__)
            raise
        self.counter("accepted").inc()
        enq = req.enqueued_at
        req.future.add_done_callback(
            lambda fut: self._request_done(root, enq, fut))
        return req

    def _request_done(self, root, enqueued_at: float, fut) -> None:
        if fut.exception() is not None:
            root.end(error=repr(fut.exception()))
        else:
            self.metrics.latency.observe(time.monotonic() - enqueued_at)
            root.end()

    # -- drain / shutdown ----------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def fatal(self) -> bool:
        """True once every worker slot retired and pending work was failed —
        the front end should exit nonzero, not 83-restart-me."""
        return self._fatal.is_set()

    def health(self) -> str:
        if self._fatal.is_set():
            return "failed"
        if self._draining.is_set():
            return "draining"
        with self._lock:   # written by the monitor thread under the same lock
            vae_scale, ever_ready = self._vae_scale, self._ever_ready
        if vae_scale is None or not ever_ready:
            # cold boot: no worker has EVER reached ready — "warming" even
            # though admission may already be queueing. (After first ready,
            # transient all-workers-down churn keeps reporting "ok":
            # respawn is in flight, the queue holds.)
            return "warming"
        return "ok"

    def health_doc(self) -> dict:
        """The /healthz document: overall status plus worker readiness and
        the fleet's aggregate warm-bucket counts (from lease payloads)."""
        with self._lock:
            ready = sum(1 for s in self._slots if s.state == ALIVE)
            leases = [s.lease for s in self._slots if s.lease is not None]
        return {
            "status": self.health(),
            "workers_ready": ready,
            "workers_total": len(self._slots),
            "buckets_warm": sum(max(0, l.buckets_warm) for l in leases),
            "buckets_total": sum(max(0, l.buckets_total) for l in leases),
            "risk": self.risk_health(),
        }

    def begin_drain(self) -> None:
        """Stop admission. The shared queue is NOT closed: requeues of
        already-accepted work must keep landing while channels drain the
        backlog."""
        self._draining.set()
        R.log_trace("fleet_drain_begin", pending=self.journal.pending_count())

    def join_drained(self, timeout_s: float) -> bool:
        """Wait until every accepted request reached a terminal state."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.journal.pending_count() == 0:
                return True
            if self._fatal.is_set():
                return self.journal.pending_count() == 0
            time.sleep(self._poll_s)
        return self.journal.pending_count() == 0

    def shutdown(self, timeout_s: float = 60.0) -> None:
        """Stop channels, SIGTERM workers (their own drain -> exit 83), then
        reap. Call after :meth:`join_drained`; anything still pending at
        this point gets a typed failure, not silence."""
        self._shutdown.set()
        # snapshot channels/procs under the lock once: the monitor thread
        # may still be mid-tick attaching a channel when shutdown starts
        with self._lock:
            channels = [s.channel for s in self._slots]
            procs = [(s.index, s.proc) for s in self._slots]
        for channel in channels:
            if channel is not None:
                channel.stop()
        # one shared deadline across all channel joins (same pattern as the
        # proc reap below): N wedged channels must not serialize into
        # N x timeout_s before workers even see SIGTERM
        join_deadline = time.monotonic() + timeout_s
        for channel in channels:
            if channel is not None:
                channel.join(
                    max(0.1, join_deadline - time.monotonic()))
        with self._requests_lock:
            leftovers = list(self._requests.values())
        for req in leftovers:
            if self.journal.fail(req.id, "supervisor shutdown"):
                self.counter("failed").inc()
                if not req.future.done():
                    req.future.set_exception(RequestFailedError(
                        "supervisor shut down before the request completed"))
            self._finish(req.id)
        for index, proc in procs:
            if proc is not None and proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except OSError as e:
                    R.log_event("fleet_term_error", worker=index,
                                error=repr(e))
                    R.bump_counter("fleet_term_errors")
        deadline = time.monotonic() + timeout_s
        for index, proc in procs:
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                R.log_event("fleet_worker_drain_timeout", worker=index)
                try:
                    proc.kill()
                    proc.wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired) as e:
                    R.log_event("fleet_kill_error", worker=index,
                                error=repr(e))
                    R.bump_counter("fleet_kill_errors")
        if self._monitor is not None:
            self._monitor.join(timeout=5 * self._poll_s)
        if self._scraper is not None:
            # the loop's wait() observes _shutdown within one scrape period;
            # an in-flight scrape is bounded by its socket timeout
            self._scraper.join(timeout=self.cfg.fleet.scrape_period_s
                               + 2 * self.cfg.fleet.scrape_timeout_s)
        self.journal.close()

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        d = {
            "role": "supervisor",
            "health": self.health(),
            "draining": self._draining.is_set(),
            "queue_depth": self.queue.depth(),
            "workers": [s.snapshot() for s in self._slots],
            "workers_alive": sum(1 for s in self._slots if s.state == ALIVE),
            "journal": self.journal.counts(),
            "fleet": {k[len("fleet/"):]: v for k, v in
                      tracing.registry().counters("fleet/").items()},
        }
        d["latency_ms"] = {k: round(v * 1000.0, 3) for k, v in
                           self.metrics.latency.percentiles((50, 99)).items()}
        d["queue_wait_ms"] = {k: round(v * 1000.0, 3) for k, v in
                              self.metrics.queue_wait.percentiles((50, 99)).items()}
        return d


class _FleetMetrics:
    """Latency/queue-wait reservoirs plus the typed-rejection counters; the
    monotonic fleet counters live directly in the telemetry registry
    (``dcr_fleet_*`` in Prometheus text)."""

    def __init__(self):
        self.latency = LatencyTracker(name="fleet/request_latency_s")
        self.queue_wait = LatencyTracker(name="fleet/queue_wait_s")

    def note_rejected(self, error: AdmissionError) -> None:
        tracing.registry().counter(
            f"fleet/rejected_{type(error).__name__}").inc()
