"""dcr-serve on one device (PyTorch port of ``dcr-serve``'s single-process role).

    python -m dcr_tpu_torch.cli.serve --model_path=<run or checkpoint dir> \\
        [--port=8000] [--risk.index_path=<embedding dump>]
        [--risk.store_dir=<store> [--risk.ann=true] [--ingest.enabled=true]]

Loads the generation stack once (the bulk pipeline's loader, so the two
paths cannot drift), runs the default bucket once (``/healthz`` reads
"warming" until then), then serves ``POST /generate`` with dynamic batching
and an embedding cache, ``POST /check``, ``GET /healthz`` and ``GET
/metrics`` until SIGTERM. ``--port=0`` binds a free port, logged. The drain:

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
in a batch exits 85 after a dump.

A second signal kills the process at once. It runs on CUDA;
``DCR_TPU_PLATFORM=cpu`` selects the CPU. The fleet roles
(``--fleet.workers``, ``--fleet.worker_index``) raise ``NotPortedError``,
as do the other settings :func:`validate_serve_config` names.
"""

from __future__ import annotations

import logging
import threading

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core.config import SampleConfig, ServeConfig, parse_cli, validate_serve_config

log = logging.getLogger("dcr_tpu_torch")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = parse_cli(ServeConfig, argv)
    validate_serve_config(cfg)
    _run_worker(cfg)


def _run_worker(cfg: ServeConfig) -> None:
    """Single-process serving: load, warm, listen, drain, exit 83."""
    import time

    from dcr_tpu_torch.core import resilience as R
    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.core.metrics import MetricWriter
    from dcr_tpu_torch.sampling.pipeline import load_generation_stack
    from dcr_tpu_torch.serve.server import make_server
    from dcr_tpu_torch.serve.worker import GenerationService

    if cfg.logdir:
        # request span trees into <logdir>/trace.jsonl; the drain's and the
        # fatal paths' dumps land beside it
        tracing.configure(cfg.logdir)
    writer = MetricWriter(cfg.logdir) if cfg.logdir else None
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
    log.info("dcr-serve listening on http://%s:%d (model %s, device %s, default bucket "
             "%s, max_batch=%d, max_wait=%.0fms, queue_depth=%d, warm plan=%d bucket(s))",
             cfg.host, httpd.server_address[1], cfg.model_path, stack.device,
             service.default_bucket(), cfg.max_batch, cfg.max_wait_ms, cfg.queue_depth,
             planned)
    t0 = time.monotonic()
    service.warm_start()
    log.info("[stage] serve_warm: done in %.2fs", time.monotonic() - t0)

    drained = threading.Event()
    R.install_signal_drain(lambda signum: drained.set())
    # unbounded by design: the main thread only sleeps until the signal
    drained.wait()

    log.warning("drain: admission stopped; finishing %d queued request(s)",
                service.queue.depth())
    service.begin_drain()
    if not service.join_drained(timeout=cfg.request_timeout_s):
        R.log_event("serve_drain_incomplete", queued=service.queue.depth())
    service.stop_ingest()      # the queued rows land in the WAL, the lease is released
    httpd.shutdown()
    httpd.server_close()       # joins handler threads: responses are on the wire
    server_thread.join(timeout=5.0)
    if writer is not None:
        writer.close()
    # the exit-83 path: the last requests' spans for the operator
    tracing.dump_flight_recorder("preempted: serve drained")
    log.warning("drained: exiting with code %d for the restart wrapper", R.EXIT_PREEMPTED)
    raise SystemExit(R.EXIT_PREEMPTED)


if __name__ == "__main__":
    main()
