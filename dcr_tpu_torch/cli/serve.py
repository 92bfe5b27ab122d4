"""dcr-serve on one device, or a fleet of them (PyTorch port of ``dcr-serve``).

    python -m dcr_tpu_torch.cli.serve --model_path=<run or checkpoint dir> \\
        [--port=8000] [--risk.index_path=<embedding dump>]
        [--risk.store_dir=<store> [--risk.ann=true] [--ingest.enabled=true]]
        [--fleet.workers=N [--fleet.dir=<dir>]] [--hang_timeout_s=S]

One entry point, three roles, chosen by ``fleet.*``:

- **single process** (default, ``fleet.workers == 0``): load the generation
  stack once (the bulk pipeline's loader, so the two paths cannot drift),
  run the default bucket once (``/healthz`` reads "warming" until then),
  then serve ``POST /generate`` with dynamic batching and an embedding
  cache, ``POST /check``, ``GET /healthz`` and ``GET /metrics`` until
  SIGTERM. ``--port=0`` binds a free port, logged;
- **fleet supervisor** (``--fleet.workers=N``): loads no model and opens no
  CUDA context. It owns the HTTP front end, the bounded admission queue and
  the durable request journal, spawns N worker subprocesses and requeues
  and respawns around their deaths (:mod:`dcr_tpu_torch.serve.supervisor`),
  merges their Prometheus text into its ``/metrics?format=prometheus`` and
  answers ``GET /slo``. ``fleet.dir`` (leases, ``journal.jsonl``, worker
  logs, ``config.json``) defaults to ``<logdir>/fleet``, else a temp dir.
  It exits 83 after the drain, or 1 when the fleet failed (every slot
  retired);
- **fleet worker** (``--fleet.worker_index=I``, spawned by the supervisor
  as ``python -m dcr_tpu_torch.cli.serve --config=<fleet.dir>/config.json
  --fleet.workers=0 --fleet.worker_index=I --port=0``): single-process
  serving plus membership. It publishes its lease early with
  ``ready=False``, renews it every ``fleet.heartbeat_s``, flips it ready
  (``buckets_warm``, ``buckets_total``, ``risk``) once the warm start ran,
  and answers the supervisor's ``POST /generate_batch``. Its trace and
  flight-recorder dumps go to ``<logdir or fleet.dir>/worker_<I>/``.

Every role drains on SIGTERM:

1. admission stops (new requests get typed 503s, /healthz reads
   "draining");
2. queued and in-flight batches finish, and every accepted request gets
   its response;
3. with ``--ingest.enabled=true`` the ingest pump appends its queued rows
   to the store's WAL and releases the writer lease;
4. the flight recorder is dumped (``flightrec_0.json`` under
   ``--logdir``, or ``DCR_FLIGHTREC_DIR``) and the process exits with
   ``EXIT_PREEMPTED`` (83).

``--logdir=<dir>`` writes ``<dir>/trace.jsonl`` (every request's span tree)
and ``<dir>/metrics.jsonl`` (``serve/*`` scalars per batch); ``POST
/debug/profile`` then defaults to ``<dir>/profile``. Out of device memory
in a batch exits 85 after a dump; with ``--hang_timeout_s`` a batch that
runs longer exits 89 after every thread's stack and a dump.

A second signal kills the process at once. Workers run on CUDA;
``DCR_TPU_PLATFORM=cpu`` selects the CPU, and a supervisor started with it
passes it on to its workers. ``--warm.dir=<dir>`` loads the kernel
library from the warm cache and warms the buckets the previous incarnation
ran (``warm_manifest.json``); a fleet supervisor hands its config file, and
so the directory, to every worker it spawns or respawns. A mesh raises
``NotPortedError``, as do the other settings :func:`validate_serve_config`
names.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from pathlib import Path

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core.config import SampleConfig, ServeConfig, parse_cli, validate_serve_config

log = logging.getLogger("dcr_tpu_torch")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = parse_cli(ServeConfig, argv)
    validate_serve_config(cfg)
    if cfg.fleet.workers > 0:
        _run_supervisor(cfg)
    else:
        _run_worker(cfg)


def _run_supervisor(cfg: ServeConfig) -> None:
    """The fleet's front end: admission, the journal and the workers'
    lifecycle. No model, no device."""
    from dcr_tpu_torch.core import resilience as R
    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.serve.server import make_server
    from dcr_tpu_torch.serve.supervisor import FleetSupervisor

    if not cfg.fleet.dir:
        # the control plane must live somewhere concrete before the config
        # is written for the workers
        cfg.fleet.dir = (str(Path(cfg.logdir) / "fleet") if cfg.logdir
                         else tempfile.mkdtemp(prefix="dcr-fleet-"))
    # the trace sink falls back to the fleet dir, as the workers' do
    # (<fleet.dir>/worker_<i>/), so `tools/trace_report <fleet.dir>` merges
    # one span tree per request across the processes
    tracing.configure(cfg.logdir or cfg.fleet.dir)

    drained = threading.Event()
    # a failed fleet (every slot retired) unblocks the same wait as SIGTERM:
    # its pending work already failed with typed errors
    sup = FleetSupervisor(cfg, on_fatal=drained.set)
    sup.start()
    httpd = make_server(cfg, sup)
    server_thread = threading.Thread(target=httpd.serve_forever, name="serve-http",
                                     daemon=True)
    server_thread.start()
    log.info("dcr-serve supervisor listening on http://%s:%d (%d workers, fleet dir %s, "
             "max_batch=%d, queue_depth=%d, dispatch_timeout=%.0fs)",
             cfg.host, httpd.server_address[1], cfg.fleet.workers, cfg.fleet.dir,
             cfg.max_batch, cfg.queue_depth, cfg.fleet.dispatch_timeout_s)

    R.install_signal_drain(lambda signum: drained.set())
    # unbounded by design: the main thread only sleeps until the signal or
    # the fleet's failure
    drained.wait()

    fatal = sup.fatal
    log.warning("drain: admission stopped; %d request(s) pending", sup.journal.pending_count())
    sup.begin_drain()
    if not fatal and not sup.join_drained(cfg.request_timeout_s):
        R.log_event("fleet_drain_incomplete", pending=sup.journal.pending_count())
    httpd.shutdown()
    httpd.server_close()       # joins handler threads: responses are on the wire
    server_thread.join(timeout=5.0)
    sup.shutdown()
    # re-read: a fleet can fail during the drain, which must not exit 83
    fatal = fatal or sup.fatal
    if fatal:
        log.error("fleet failed: every worker slot exhausted its respawn budget — exiting 1")
        raise SystemExit(1)
    tracing.dump_flight_recorder("preempted: fleet supervisor drained")
    log.warning("drained: exiting with code %d for the restart wrapper", R.EXIT_PREEMPTED)
    raise SystemExit(R.EXIT_PREEMPTED)


def _run_worker(cfg: ServeConfig) -> None:
    """Single-process serving: load, warm, listen, drain, exit 83; with
    ``fleet.worker_index >= 0`` also a fleet member (the lease)."""
    import time

    from dcr_tpu_torch.core import resilience as R
    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.core.metrics import MetricWriter
    from dcr_tpu_torch.models.vae import vae_scale_factor
    from dcr_tpu_torch.sampling.pipeline import load_generation_stack
    from dcr_tpu_torch.serve.server import make_server
    from dcr_tpu_torch.serve.worker import GenerationService

    index = cfg.fleet.worker_index
    logdir = cfg.logdir
    if index >= 0:
        # `@rank=` of the serve-side fault kinds is the worker index (the
        # supervisor exports it too; setdefault keeps a hand-launched worker
        # targetable)
        os.environ.setdefault("DCR_WORKER_INDEX", str(index))
        # one telemetry sink per worker: N workers in one trace.jsonl would
        # interleave
        base = logdir or cfg.fleet.dir
        logdir = str(Path(base) / f"worker_{index}") if base else ""
    if logdir:
        # request span trees into <logdir>/trace.jsonl; the drain's and the
        # fatal paths' dumps land beside it
        tracing.configure(logdir)
    writer = MetricWriter(logdir) if logdir else None
    t0 = time.monotonic()
    stack = load_generation_stack(SampleConfig(model_path=cfg.model_path,
                                               iternum=cfg.iternum,
                                               resolution=cfg.resolution),
                                  device=device_from_env())
    log.info("[stage] serve_load: done in %.2fs", time.monotonic() - t0)
    service = GenerationService(cfg, stack, writer=writer)
    # warming flips BEFORE the port opens: /healthz never says "ok" while
    # the default bucket has not run
    planned = service.begin_warm()
    service.start()
    httpd = make_server(cfg, service)
    server_thread = threading.Thread(target=httpd.serve_forever, name="serve-http",
                                     daemon=True)
    server_thread.start()
    port = httpd.server_address[1]
    log.info("dcr-serve listening on http://%s:%d (model %s, device %s, default bucket "
             "%s, max_batch=%d, max_wait=%.0fms, queue_depth=%d, warm plan=%d bucket(s)%s)",
             cfg.host, port, cfg.model_path, stack.device,
             service.default_bucket(), cfg.max_batch, cfg.max_wait_ms, cfg.queue_depth,
             planned, f", cache {cfg.warm.dir}" if cfg.warm.dir else "")

    heartbeat = lease = paths = None
    if index >= 0:
        from dcr_tpu_torch.serve.fleet import (LeaseHeartbeat, WorkerLease, fleet_paths,
                                               write_lease)

        # the lease goes out early with ready=False: the supervisor sees a
        # live, warming worker (spawn_timeout_s covers load and warm start)
        # and attaches no dispatch channel until ready flips
        paths = fleet_paths(cfg.fleet.dir).ensure()
        lease = WorkerLease(index=index, pid=os.getpid(), port=port,
                            vae_scale=vae_scale_factor(stack.models.vae.config),
                            lease_s=cfg.fleet.lease_s, ready=False, buckets_warm=0,
                            buckets_total=planned, risk=service.risk_status())
        heartbeat = LeaseHeartbeat(paths, lease, cfg.fleet.heartbeat_s).start()
        log.info("fleet worker %d warming: lease %s (heartbeat %.1fs, lease %.1fs)", index,
                 paths.lease_file(index), cfg.fleet.heartbeat_s, cfg.fleet.lease_s)

    t0 = time.monotonic()
    warm = service.warm_start()
    log.info("[stage] serve_warm: done in %.2fs", time.monotonic() - t0)
    if heartbeat is not None:
        # readiness rides the lease: the counts are written before `ready`,
        # so a racing heartbeat publishes a warming lease or a ready one with
        # its counts, never a ready one with stale counts
        lease.buckets_warm = warm["buckets_warm"]
        lease.buckets_total = warm["buckets_total"]
        lease.risk = service.risk_status()
        lease.ready = True
        write_lease(paths, lease)
        log.info("fleet worker %d ready: %d/%d bucket(s) warm in %.2fs (risk %s)", index,
                 warm["buckets_warm"], warm["buckets_total"], warm["seconds"],
                 service.risk_status())

    drained = threading.Event()
    R.install_signal_drain(lambda signum: drained.set())

    risk_lease_thread = None
    if lease is not None and (cfg.risk.index_path or cfg.risk.store_dir):
        # the index loads in the background: republish the lease the moment
        # its status settles (ok | failed), so the supervisor's /check routing
        # and fleet health never act on a stale "loading"
        def _sync_risk_lease() -> None:
            while not service.wait_risk_ready(timeout=1.0):
                if drained.is_set():
                    return
            lease.risk = service.risk_status()
            write_lease(paths, lease)
            log.info("fleet worker %d risk index: %s", index, service.risk_status())

        risk_lease_thread = threading.Thread(target=_sync_risk_lease, daemon=True,
                                             name="risk-lease-sync")
        risk_lease_thread.start()
    # unbounded by design: the main thread only sleeps until the signal
    drained.wait()

    # the lease keeps renewing through the drain: the supervisor must not
    # kill a worker for a lapsed lease while it finishes accepted work
    log.warning("drain: admission stopped; finishing %d queued request(s)",
                service.queue.depth())
    service.begin_drain()
    if not service.join_drained(timeout=cfg.request_timeout_s):
        R.log_event("serve_drain_incomplete", queued=service.queue.depth())
    service.stop_ingest()      # the queued rows land in the WAL, the lease is released
    httpd.shutdown()
    httpd.server_close()       # joins handler threads: responses are on the wire
    server_thread.join(timeout=5.0)
    if risk_lease_thread is not None:
        risk_lease_thread.join(timeout=2.0)
    if heartbeat is not None:
        heartbeat.stop()
    if writer is not None:
        writer.close()
    # the exit-83 path: the last requests' spans for the operator
    tracing.dump_flight_recorder("preempted: serve drained")
    log.warning("drained: exiting with code %d for the restart wrapper", R.EXIT_PREEMPTED)
    raise SystemExit(R.EXIT_PREEMPTED)


if __name__ == "__main__":
    main()
