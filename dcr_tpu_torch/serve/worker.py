"""Resident generation worker: the bucket registry and batch execution.

Counterpart of ``dcr_tpu/serve/worker.py`` on one device, HTTP-free so
benches and tests drive it in-process:

- one batch sampler per :class:`~dcr_tpu_torch.serve.queue.GenBucket`, run
  at a FIXED batch shape (``max_batch``, padded). One shape means one set of
  kernels and algorithms, so a row's image does not depend on the rows it
  shares a batch with;
- per-request draws: every random draw of request i (x_T, the embedding
  noise, DDPM's ancestral noise) comes from a ``torch.Generator`` of its own,
  seeded from ``(root seed, seeds[i])`` by :func:`core.rng.stream_seed`, so
  a prompt sampled alone is bit-identical to the same prompt inside a mixed
  batch;
- the prompt-embedding LRU (:mod:`dcr_tpu_torch.serve.cache`) skips the CLIP
  text tower for repeated prompts;
- copy-risk scoring of every finished batch against a train-embedding index
  that loads in the background (:mod:`dcr_tpu_torch.obs.copyrisk`), exact or
  through the store's IVF tier (``risk.ann``, with the sampled recall probe
  of :mod:`dcr_tpu_torch.obs.recall_probe` while ``slo.enabled``); a failed
  load or score leaves the responses unscored and bumps a counter, never a
  failed batch;
- live provenance (``ingest.enabled``): every scored generation's SSCD row
  goes to the store's WAL through :class:`~dcr_tpu_torch.serve.ingest.
  IngestPump`, keyed ``gen/<trace id>`` as the JAX worker keys it;
  ``/check`` sees it through the live tail once it is acked, and each
  compaction swaps the risk engine onto the new snapshot
  (:meth:`CopyRiskIndex.refresh_store`) without a restart;
- tracing, as the JAX worker's: a trace id and a ``serve/request`` root
  span per request, ``serve/queue_wait``, ``serve/assemble``,
  ``serve/device_step`` (with ``hbm_peak`` / ``hbm_delta``),
  ``serve/risk_score``, ``sample/fast``, and ``serve/rejected`` /
  ``risk/flagged`` events;
- the memory budget: a novel bucket is admitted only while the largest
  measured bucket footprint (each bucket's peak rise over its first batch,
  ``obs/memwatch``), times the admitted buckets that have not run yet plus
  one, fits in the device's remaining memory; else ``MemoryBudgetError``
  (HTTP 503 ``memory_budget``). Out of device memory in a batch (or the
  ``oom`` fault) ends the process with exit 85 and a post-mortem naming
  the resident buckets;
- on-demand profiling (``POST /debug/profile``): ``torch.profiler`` over the
  next K device steps;
- the batch watchdog: with ``hang_timeout_s > 0`` a batch still running
  after that many seconds ends the process through
  ``coordination.hang_abort`` (every thread's stack, a flight-recorder
  dump, exit 89) instead of leaving a dead port listening; the fault hooks
  ``worker_crash``, ``worker_hang``, ``slow_step`` and ``oom`` fire inside
  its window at the process's batch index;
- the fleet's wire path: :meth:`GenerationService.submit` takes the trace
  context a supervisor ships with each ``/generate_batch`` item, so the
  worker's ``serve/request`` root joins the supervisor's trace
  (``remote_parent``, ``attempt``).

The JAX worker traces one jitted scan per bucket; here each step runs
eagerly. Device work runs on the worker thread, the risk loader's thread and
the ``/check`` handler threads: every function that runs a model enters
``torch.inference_mode()`` itself (grad mode is thread-local). With
``warm.dir`` (``core/warmcache.py``) each bucket's sampler resolves its
kernel library through the warm cache, and the warm plan adds the buckets
of the previous incarnation's ``warm_manifest.json`` to the default one,
as the JAX worker plans it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import rng as rngmod
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core import warmcache
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.config import ServeConfig, validate_serve_config
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.core.metrics import LatencyTracker, MetricWriter
from dcr_tpu_torch.models.vae import vae_scale_factor
from dcr_tpu_torch.obs import memwatch
from dcr_tpu_torch.sampling import fastsample
from dcr_tpu_torch.sampling.pipeline import GenerationStack
from dcr_tpu_torch.sampling.sampler import (DiffusionModels, decode_images, denoise,
                                            sampler_grid)
from dcr_tpu_torch.serve.batcher import Batcher
from dcr_tpu_torch.serve.cache import EmbeddingCache, embedding_key, mitigation_tag
from dcr_tpu_torch.serve.queue import (AdmissionError, BucketLimitError, DrainingError,
                                       GenBucket, InvalidRequestError, MemoryBudgetError,
                                       Request, RequestQueue)
from dcr_tpu_torch.utils import faults, profiling

log = logging.getLogger("dcr_tpu_torch")

SAMPLERS = ("ddim", "dpm++", "ddpm")
MAX_STEPS = 1000        # more denoising steps than train timesteps is nonsense
MAX_RESOLUTION = 4096


def validate_bucket(bucket: GenBucket, *, vae_scale: int) -> None:
    """Reject client-controlled bucket parameters before any sampler is
    built: an invalid value is a typed 400-class error, never a degenerate
    resident sampler."""
    if bucket.sampler not in SAMPLERS:
        raise InvalidRequestError(
            f"sampler must be one of {SAMPLERS}, got {bucket.sampler!r}")
    if not 1 <= bucket.steps <= MAX_STEPS:
        raise InvalidRequestError(
            f"steps must be in [1, {MAX_STEPS}], got {bucket.steps}")
    if not (vae_scale <= bucket.resolution <= MAX_RESOLUTION
            and bucket.resolution % vae_scale == 0):
        raise InvalidRequestError(
            f"resolution must be a multiple of {vae_scale} in "
            f"[{vae_scale}, {MAX_RESOLUTION}], got {bucket.resolution}")
    if not 0.0 <= bucket.guidance <= 100.0:
        raise InvalidRequestError(
            f"guidance must be in [0, 100], got {bucket.guidance}")
    if not 0.0 <= bucket.rand_noise_lam <= 10.0:
        raise InvalidRequestError(
            f"rand_noise_lam must be in [0, 10], got {bucket.rand_noise_lam}")
    if not 0.0 <= bucket.fast_ratio <= fastsample.MAX_REUSE_RATIO:
        raise InvalidRequestError(
            f"fast_ratio must be in [0, {fastsample.MAX_REUSE_RATIO}], "
            f"got {bucket.fast_ratio}")
    if bucket.fast_order not in (1, 2):
        raise InvalidRequestError(
            f"fast_order must be 1 or 2, got {bucket.fast_order}")


class InjectedDraws(NamedTuple):
    """Draws handed to the batch sampler instead of drawn, in the JAX
    package's layouts: ``x_t`` [B, h, w, C]; ``emb_noise`` (cond noise,
    uncond noise), each [B, L, D]; ``step_noise`` [steps, B, h, w, C], DDPM's
    noise per step and row. The parity tests carry the JAX package's
    threefry draws across with it."""

    x_t: Optional[np.ndarray] = None
    emb_noise: Optional[tuple[np.ndarray, np.ndarray]] = None
    step_noise: Optional[np.ndarray] = None


def _nchw(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device).permute(
        0, 3, 1, 2).contiguous()


@compile_surface("serve/batch_sampler")
def make_batch_sampler(bucket: GenBucket, models: DiffusionModels, root_seed: int,
                       batch_size: int, device: str | torch.device = "cuda"):
    """``(cond, uncond, seeds, *, draws=None) -> images [B, H, W, 3]`` (float32
    in [0, 1], on ``device``) for one bucket.

    cond/uncond: [B, L, D] prompt embeddings (already encoded or cached);
    seeds: [B] uint32 per-request seeds. Row i draws only from generators
    seeded by ``stream_seed(root_seed, stream, seeds[i])`` with the streams
    ``init`` (x_T), ``emb_noise`` (cond noise, then uncond noise, when
    ``rand_noise_lam`` > 0) and ``steps`` (DDPM's noise, one draw per step),
    the JAX sampler's ``fold_in(root, seed_i)`` streams, so row i's image is
    a function of (weights, cond[i], seeds[i]) alone. ``draws`` hands in
    any of those draws instead (:class:`InjectedDraws`).
    """
    device = resolve_device(device)
    sched = models.schedule.to(device)
    ts, prev_ts, lower_order_final = sampler_grid(bucket.sampler, sched, bucket.steps)
    plan = fastsample.fast_plan(bucket.steps, bucket.fast_ratio)
    latent_size = bucket.resolution // vae_scale_factor(models.vae.config)
    latent_shape = (models.vae.config.vae_latent_channels, latent_size, latent_size)
    lam = bucket.rand_noise_lam

    @torch.inference_mode()
    def sample_fn(cond, uncond, seeds, *, draws: Optional[InjectedDraws] = None
                  ) -> torch.Tensor:
        if cond.shape[0] != batch_size:
            # the fixed-shape invariant: a caller skipping execute()'s padding
            # would make an image depend on its batch's occupancy
            raise ValueError(
                f"batch sampler for {bucket} is built at batch="
                f"{batch_size}; got {cond.shape[0]} rows — pad the batch")
        draws = draws or InjectedDraws()
        row_seeds = [int(s) for s in np.asarray(seeds, np.uint32)]

        def row_generators(stream: str) -> list[torch.Generator]:
            return [rngmod.stream_generator(root_seed, stream, s, device) for s in row_seeds]

        cond = torch.as_tensor(np.asarray(cond, np.float32), device=device)
        uncond = torch.as_tensor(np.asarray(uncond, np.float32), device=device)
        if lam > 0.0:
            # Newpipe mitigation noise, per request: fresh even for a cached
            # embedding, independent of the rest of the batch
            if draws.emb_noise is not None:
                noise_c, noise_u = (torch.as_tensor(np.asarray(n, np.float32), device=device)
                                    for n in draws.emb_noise)
            else:
                pairs = [(torch.randn(cond.shape[1:], generator=g, device=device),
                          torch.randn(uncond.shape[1:], generator=g, device=device))
                         for g in row_generators("emb_noise")]
                noise_c = torch.stack([c for c, _ in pairs])
                noise_u = torch.stack([u for _, u in pairs])
            cond, uncond = cond + lam * noise_c, uncond + lam * noise_u
        ctx = torch.cat([uncond, cond], dim=0)                  # [2B, L, D]
        if draws.x_t is not None:
            x = _nchw(draws.x_t, device)
        else:
            x = torch.stack([torch.randn(latent_shape, generator=g, device=device)
                             for g in row_generators("init")])
        step_noise = None
        if bucket.sampler == "ddpm":
            if draws.step_noise is not None:
                def step_noise(i):
                    return _nchw(draws.step_noise[i], device)
            else:
                step_gens = row_generators("steps")

                def step_noise(i):
                    return torch.stack([torch.randn(latent_shape, generator=g, device=device)
                                        for g in step_gens])
        x = denoise(models, x, ctx, sampler=bucket.sampler, sched=sched, ts=ts,
                    prev_ts=prev_ts, lower_order_final=lower_order_final, plan=plan,
                    fast_order=bucket.fast_order, guidance=bucket.guidance,
                    step_noise=step_noise)
        return decode_images(models, x)

    sample_fn.unet_calls = fastsample.unet_calls(plan)
    return sample_fn


@compile_surface("serve/encode")
def make_text_encoder(models: DiffusionModels, device: str | torch.device = "cuda"):
    """``ids [B, L] -> [B, L, D]`` prompt embeddings (the last hidden state)
    on ``device``: the text tower every cache miss pays."""
    device = resolve_device(device)

    @torch.inference_mode()
    def encode(ids: np.ndarray) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)
        return models.text_encoder(ids).last_hidden_state

    return encode


class ServeMetrics:
    """Counters and the latency reservoir behind one lock; snapshots feed
    the /metrics document."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.rejected_overload = 0
        self.rejected_draining = 0
        self.rejected_invalid = 0
        self.rejected_bucket_limit = 0
        self.rejected_memory_budget = 0
        self.completed_total = 0
        self.failed_total = 0
        self.batches_total = 0
        self.occupancy_last = 0.0
        self.occupancy_max = 0.0
        self._occupancy_sum = 0.0
        # named: registers in the process-wide telemetry registry, so the
        # request latency percentiles ride Prometheus scrapes
        self.latency = LatencyTracker(name="serve/request_latency_s")

    def note_submitted(self) -> None:
        with self._lock:
            self.requests_total += 1

    def note_rejected(self, error: AdmissionError) -> None:
        with self._lock:
            if isinstance(error, DrainingError):
                self.rejected_draining += 1
            elif isinstance(error, InvalidRequestError):
                self.rejected_invalid += 1
            elif isinstance(error, BucketLimitError):
                self.rejected_bucket_limit += 1
            elif isinstance(error, MemoryBudgetError):
                self.rejected_memory_budget += 1
            else:
                self.rejected_overload += 1

    def note_batch(self, n_real: int, batch_size: int, ok: bool) -> None:
        occ = n_real / max(1, batch_size)
        with self._lock:
            self.batches_total += 1
            self.occupancy_last = occ
            self.occupancy_max = max(self.occupancy_max, occ)
            self._occupancy_sum += occ
            if ok:
                self.completed_total += n_real
            else:
                self.failed_total += n_real

    def snapshot(self) -> dict:
        with self._lock:
            batches = self.batches_total
            d = {
                "requests_total": self.requests_total,
                "rejected_overload": self.rejected_overload,
                "rejected_draining": self.rejected_draining,
                "rejected_invalid": self.rejected_invalid,
                "rejected_bucket_limit": self.rejected_bucket_limit,
                "rejected_memory_budget": self.rejected_memory_budget,
                "completed_total": self.completed_total,
                "failed_total": self.failed_total,
                "batches_total": batches,
                "batch_occupancy_last": self.occupancy_last,
                "batch_occupancy_max": self.occupancy_max,
                "batch_occupancy_avg": (self._occupancy_sum / batches
                                        if batches else 0.0),
            }
        pct = self.latency.percentiles((50, 99))
        d["latency_ms"] = {k: round(v * 1000.0, 3) for k, v in pct.items()}
        return d


class GenerationService:
    """The resident serving core: queue + batcher + cache + bucket samplers.

    :mod:`dcr_tpu_torch.serve.server` fronts it for network traffic; benches
    and tests call :meth:`submit`/:meth:`execute` directly. One worker
    thread drains the queue; handler threads only submit and wait.

    On a GPU the service owns the process's numerics: TF32 and cuDNN's
    benchmark mode are switched off, so an algorithm never changes between
    calls and two processes on the same card give the same image.
    """

    def __init__(self, cfg: ServeConfig, stack: GenerationStack,
                 writer: Optional[MetricWriter] = None):
        validate_serve_config(cfg)
        if stack.device.type == "cuda":
            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.stack = stack
        self.queue = RequestQueue(cfg.queue_depth)
        self.batcher = Batcher(cfg.max_batch, cfg.max_wait_ms / 1000.0)
        self.cache = EmbeddingCache(cfg.cache_entries)
        self.metrics = ServeMetrics()
        # serve/* scalars per batch into <logdir>/metrics.jsonl
        self._writer = writer
        self._samplers: dict[GenBucket, object] = {}
        # buckets whose first batch's footprint is noted (obs/memwatch)
        self._measured: set[GenBucket] = set()
        self._batch_index = 0
        # buckets counted against max_compiled_buckets at ADMISSION time, not
        # at first build: otherwise a burst of novel buckets all passes the
        # budget check before the worker builds any of them
        self._admitted_buckets: set[GenBucket] = set()
        self._samplers_lock = threading.Lock()
        self._vae_scale = vae_scale_factor(stack.models.vae.config)
        # a misconfigured default bucket fails at startup, not as a healthy
        # replica that 400s every default request
        validate_bucket(self.default_bucket(), vae_scale=self._vae_scale)
        self._build_lock = threading.Lock()
        # dcr_device_mem_* gauges for /metrics (nothing to sample on the CPU)
        memwatch.start_sampler()
        # warm-start readiness: begin_warm() flips health to "warming",
        # warm_start() runs the plan and flips it back. Set at first, so an
        # in-process service that never warms reports "ok"
        self._warm_plan: Optional[list[GenBucket]] = None
        self._warm_complete = threading.Event()
        self._warm_complete.set()
        # the warm cache: kernel libraries and the warm-start manifest
        self._warmcache = warmcache.WarmCache(cfg.warm.dir) if cfg.warm.dir else None
        self._encode = make_text_encoder(stack.models, stack.device)
        self._tok_fp = stack.tokenizer.fingerprint()
        # copy-risk scoring: the train-embedding index loads in the
        # BACKGROUND; until it terminalizes batches go unscored, and a failed
        # load degrades to scoring-disabled with a counter
        self._risk = None
        self._risk_status = "absent"
        self._risk_done = threading.Event()
        self._evidence = None
        self._pump = None             # IngestPump, with risk.store_dir and ingest on
        if cfg.risk.index_path or cfg.risk.store_dir:
            self._risk_status = "loading"
            threading.Thread(target=self._load_risk_index, daemon=True,
                             name="risk-index-load").start()
        else:
            self._risk_done.set()
        self._uncond: Optional[np.ndarray] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- request plumbing ----------------------------------------------------

    def default_bucket(self) -> GenBucket:
        c = self.cfg
        ratio, order = fastsample.canonical_plan_params(
            c.num_inference_steps,
            c.fast.reuse_ratio if c.fast.enabled else 0.0, c.fast.order)
        return GenBucket(resolution=c.resolution, steps=c.num_inference_steps,
                         guidance=c.guidance_scale, sampler=c.sampler,
                         rand_noise_lam=c.rand_noise_lam,
                         fast_ratio=ratio, fast_order=order)

    def submit(self, prompt: str, *, seed: int = 0,
               bucket: Optional[GenBucket] = None,
               trace_ctx: Optional[dict] = None) -> Request:
        """Admit a request. A typed AdmissionError on every rejection path:
        InvalidRequestError (bad bucket parameters), BucketLimitError (past
        the resident-bucket budget), QueueFullError (overload),
        DrainingError (SIGTERM seen).

        ``trace_ctx`` is the distributed trace context a fleet supervisor
        ships with a dispatched item (:func:`tracing.wire_context`): the
        ``serve/request`` root then takes the supervisor's trace id and
        records ``remote_parent`` (the supervisor's root span) and
        ``attempt``, so a requeued re-execution is a sibling under the same
        root instead of a disconnected tree."""
        bucket = bucket or self.default_bucket()
        try:
            validate_bucket(bucket, vae_scale=self._vae_scale)
            with self._samplers_lock:
                bucket_added = bucket not in self._admitted_buckets
                if bucket_added:
                    if len(self._admitted_buckets) >= self.cfg.max_compiled_buckets:
                        raise BucketLimitError(
                            f"bucket {bucket} would exceed the resident "
                            f"compiled-sampler budget "
                            f"({self.cfg.max_compiled_buckets}); use an "
                            "already-served parameter combination")
                    # a novel bucket: its batch must fit in the memory left
                    self._check_memory_budget(bucket)
                    self._admitted_buckets.add(bucket)
            req = Request(prompt=prompt, seed=int(seed) & 0xFFFFFFFF, bucket=bucket)
            trace_attrs: dict = {}
            if trace_ctx and trace_ctx.get("trace_id"):
                req.trace_id = str(trace_ctx["trace_id"])
                if trace_ctx.get("parent_span") is not None:
                    trace_attrs["remote_parent"] = int(trace_ctx["parent_span"])
                if trace_ctx.get("attempt") is not None:
                    trace_attrs["attempt"] = int(trace_ctx["attempt"])
            else:
                req.trace_id = tracing.new_trace_id()
            # the root of the request's span tree, ended by the future's
            # callback on whichever thread resolves it: its duration is the
            # in-service latency. Attached before the queue publishes the
            # request; a rejected request's root is never ended (not recorded)
            req.span = tracing.begin_span("serve/request", parent=None, trace=req.trace_id,
                                          request_id=req.id, seed=req.seed,
                                          bucket=str(tuple(bucket)), **trace_attrs)
            try:
                self.queue.submit(req)
            except AdmissionError:
                # a never-queued novel bucket must not hold a resident slot
                # forever; kept when a queued request or a built sampler
                # still carries it
                if bucket_added:
                    with self._samplers_lock:
                        if (bucket not in self._samplers
                                and not self.queue.has_bucket(bucket)):
                            self._admitted_buckets.discard(bucket)
                raise
        except AdmissionError as e:
            self.metrics.note_rejected(e)
            tracing.event("serve/rejected", error=type(e).__name__)
            raise
        self.metrics.note_submitted()
        root = req.span
        req.future.add_done_callback(
            lambda f: root.end(error=repr(f.exception())) if f.exception() is not None
            else root.end())
        return req

    def _check_memory_budget(self, bucket: GenBucket) -> None:
        """Reject a novel bucket whose estimated footprint exceeds the
        device's remaining memory (the caller holds ``_samplers_lock``).
        The estimate is the largest measured ``serve/batch_sampler``
        footprint (same model, same padded batch: only the bucket's
        parameters differ); with none measured yet, or no device
        statistics, there is no check. Admitted buckets that have not run
        yet reserve the estimate too: the device's reading moves only once
        a batch runs, so a burst of novel buckets would otherwise all pass
        against the same reading."""
        estimate = memwatch.estimate_surface_bytes("serve/batch_sampler")
        if estimate is None:
            return
        remaining = memwatch.remaining_device_bytes()
        if remaining is None:
            return
        pending = sum(1 for b in self._admitted_buckets if b not in self._measured)
        needed = estimate * (pending + 1)
        if needed > remaining:
            tracing.registry().counter("serve/rejected_memory_budget").inc()
            R.log_event("memory_budget_rejected", bucket=str(tuple(bucket)),
                        estimate_bytes=estimate, pending_compiles=pending,
                        needed_bytes=needed, remaining_bytes=remaining)
            raise MemoryBudgetError(
                f"bucket {bucket} would run a new sampler (~{estimate} bytes estimated "
                f"from measured buckets; {pending} admitted bucket(s) not run yet) past "
                f"remaining device memory ({remaining} bytes); use an already-served "
                "parameter combination")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True, name="serve-worker")
        self._thread.start()

    def begin_drain(self) -> None:
        """Stop admission; the worker keeps going until the queue is empty."""
        self.queue.close()
        self._stop.set()

    def join_drained(self, timeout: Optional[float] = None) -> bool:
        """Wait for the worker to finish the backlog; True when fully drained."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive() and self.queue.empty()

    def stop(self, timeout: Optional[float] = None) -> bool:
        self.begin_drain()
        drained = self.join_drained(timeout)
        self.stop_ingest()
        return drained

    def stop_ingest(self) -> None:
        """After the worker drained: the ingest pump appends its queued
        backlog (durable in the WAL) and releases the store's writer lease."""
        pump = self._pump
        if pump is not None:
            pump.stop()

    @property
    def draining(self) -> bool:
        return self.queue.closed

    # -- execution -----------------------------------------------------------

    def _sampler_for(self, bucket: GenBucket):
        with self._samplers_lock:
            fn = self._samplers.get(bucket)
        if fn is not None:
            return fn
        with self._build_lock:
            # double-checked: the worker thread and warm_start can race on
            # the same bucket; the second caller reuses the first's sampler
            with self._samplers_lock:
                fn = self._samplers.get(bucket)
                if fn is not None:
                    return fn
            fn = make_batch_sampler(bucket, self.stack.models, self.cfg.seed,
                                    self.cfg.max_batch, self.stack.device)
            res = warmcache.aot_compile(
                make_batch_sampler, (self.stack.models,),
                static_config={
                    "flash_attention": self.stack.models.unet.config.flash_attention},
                cache=self._warmcache)
            log.info("serve: built sampler for bucket %s at batch=%d (kernels: %s in %.2fs)",
                     bucket, self.cfg.max_batch, res.source, res.build_s)
            with self._samplers_lock:
                self._samplers[bucket] = fn
        if self._warmcache is not None and self._warm_complete.is_set():
            # a lazily admitted bucket, recorded for the NEXT incarnation's
            # plan (LRU, capped by the bucket budget); during the warm phase
            # warm_start records the whole plan in one update instead
            warmcache.update_warm_manifest(self.cfg.warm.dir, [list(tuple(bucket))],
                                           max_entries=self.cfg.max_compiled_buckets)
        return fn

    # -- warm-start readiness ------------------------------------------------

    def begin_warm(self) -> int:
        """Enter the warming state and plan the warm start: the default
        bucket, then the valid buckets of the previous incarnation's warm
        manifest newest first (the manifest is LRU-ordered), capped at
        ``max_compiled_buckets - 1`` so one admission slot stays free for a
        novel bucket. /healthz reports "warming" from here until
        :meth:`warm_start` finishes. Returns the plan size (0 = disabled)."""
        if not self.cfg.warm.warm_start:
            return 0
        plan = [self.default_bucket()]
        if self._warmcache is not None:
            from dcr_tpu_torch.serve.fleet import bucket_from_tuple

            for entry in reversed(warmcache.read_warm_manifest(self.cfg.warm.dir)):
                try:
                    b = bucket_from_tuple(entry)
                    validate_bucket(b, vae_scale=self._vae_scale)
                except (TypeError, ValueError, InvalidRequestError) as e:
                    # a stale hint (config change, hand edit) costs a log line
                    R.log_event("warm_manifest_entry_invalid", entry=entry, error=repr(e))
                    R.bump_counter("warmcache/manifest_entry_invalid")
                    continue
                if b not in plan:
                    plan.append(b)
        # warm buckets hold resident slots and never leave: a plan that
        # filled the budget would refuse every novel bucket for the process's
        # life and keep the manifest from ever learning it
        cap = max(1, self.cfg.max_compiled_buckets - 1)
        if len(plan) > cap:
            R.log_event("warm_plan_over_budget", planned=len(plan), cap=cap,
                        budget=self.cfg.max_compiled_buckets)
            plan = plan[:cap]
        self._warm_plan = plan
        self._warm_complete.clear()
        return len(plan)

    def warm_start(self) -> dict:
        """Run the warm plan: the text tower and the uncond embedding, then
        ONE padded batch of every planned bucket, so the kernels' builds and
        the library handles are paid before /healthz reads "ok", never by a
        first request."""
        if not self.cfg.warm.warm_start:
            return {"buckets_warm": 0, "buckets_total": 0, "seconds": 0.0}
        if self._warm_plan is None:
            self.begin_warm()
        t0 = time.monotonic()
        uncond = np.stack([self._uncond_embedding()] * self.cfg.max_batch)
        seeds = np.zeros((self.cfg.max_batch,), np.uint32)
        for bucket in self._warm_plan:
            with self._samplers_lock:
                self._admitted_buckets.add(bucket)
            self._run_sampler(bucket, self._sampler_for(bucket), uncond, uncond, seeds)
        if self._warmcache is not None:
            # one batched manifest update for the whole plan
            warmcache.update_warm_manifest(self.cfg.warm.dir,
                                           [list(tuple(b)) for b in self._warm_plan],
                                           max_entries=self.cfg.max_compiled_buckets)
        self._warm_complete.set()
        doc = {"buckets_warm": len(self._warm_plan),
               "buckets_total": len(self._warm_plan),
               "seconds": round(time.monotonic() - t0, 3)}
        log.info("serve: warm start done %s", doc)
        return doc

    def health(self) -> str:
        if self.draining:
            return "draining"
        if not self._warm_complete.is_set():
            return "warming"
        return "ok"

    def health_doc(self) -> dict:
        """The /healthz document: never plain "ok" before the warm plan ran."""
        with self._samplers_lock:
            warm = len(self._samplers)
        total = max(len(self._warm_plan or ()), warm)
        doc = {"status": self.health(), "buckets_warm": warm,
               "buckets_total": total, "risk": self._risk_status}
        if self._pump is not None:
            doc["ingest"] = self._pump.stats()
        return doc

    def _uncond_embedding(self) -> np.ndarray:
        if self._uncond is None:
            ids = self.stack.tokenizer([""])
            self._uncond = self._encode(ids)[0].float().cpu().numpy()
        return self._uncond

    def _cond_embedding(self, req: Request, mitigation: str) -> np.ndarray:
        key = embedding_key(self._tok_fp, req.prompt, mitigation)
        emb = self.cache.get(key)
        req.cache_hit = emb is not None
        if emb is None:
            ids = self.stack.tokenizer([req.prompt])
            emb = self._encode(ids)[0].float().cpu().numpy()
            self.cache.put(key, emb)
        return emb

    # -- copy-risk scoring ---------------------------------------------------

    def _load_risk_index(self) -> None:
        """Background loader: dump or store -> verified index with SSCD on
        the device. Flips the risk status loading -> ok | failed."""
        from dcr_tpu_torch.obs.copyrisk import CopyRiskIndex, EvidenceRecorder

        cfg = self.cfg
        source = cfg.risk.store_dir or cfg.risk.index_path
        try:
            with torch.inference_mode():
                index = CopyRiskIndex.load(cfg.risk, batch=cfg.max_batch,
                                           device=self.stack.device)
        except Exception as e:
            log.exception("serve: copy-risk index load failed")
            R.log_event("risk_index_load_failed", path=source, error=repr(e))
            R.bump_counter("copy_risk/index_load_failed")
            self._risk_status = "failed"
            self._risk_done.set()
            return
        self._evidence = EvidenceRecorder(cfg.risk.evidence_dir or None, cfg.risk.max_evidence)
        if cfg.risk.ann and cfg.slo.enabled:
            # the sampled shadow-exact recall probe rides the ANN scoring
            # path: the full-probe query is its own exact oracle
            from dcr_tpu_torch.obs.recall_probe import RecallProbe

            index.recall_probe = RecallProbe(every_n=cfg.slo.recall_probe_every_n,
                                             k=cfg.slo.recall_probe_k,
                                             window=cfg.slo.recall_probe_window)
        self._risk = index
        self._risk_status = "ok"
        self._risk_done.set()
        log.info("serve: copy-risk index ok — %d train embeddings from %s (threshold %.3f%s)",
                 len(index), source, cfg.risk.threshold,
                 f", evidence -> {cfg.risk.evidence_dir}" if cfg.risk.evidence_dir else "")
        if cfg.ingest.enabled and cfg.risk.store_dir:
            self._start_ingest(index)

    def _start_ingest(self, index) -> None:
        """Stream every scored generation's SSCD embedding into the store.
        The pump owns the writer lease and the compaction loop; the index's
        live-tail hook makes acked but uncompacted rows visible to ``/check``
        and to per-response scoring at once."""
        from dcr_tpu_torch.serve.ingest import IngestPump

        icfg = self.cfg.ingest
        pump = IngestPump(self.cfg.risk.store_dir, embed_dim=index._store.embed_dim,
                          queue_max=icfg.queue_max, batch_rows=icfg.batch_rows,
                          seal_rows=icfg.seal_rows, compact_rows=icfg.compact_rows,
                          lease_s=icfg.lease_s, owner=f"serve-worker.{os.getpid()}",
                          on_snapshot=lambda v: index.refresh_store())
        index.live_tail = pump.tail
        self._pump = pump.start()
        log.info("serve: live ingest on — store %s (queue %d, compact every %d rows)",
                 self.cfg.risk.store_dir, icfg.queue_max, icfg.compact_rows)

    def risk_status(self) -> str:
        """absent | loading | ok | failed."""
        return self._risk_status

    def wait_risk_ready(self, timeout: float) -> bool:
        """True once the index load terminalized (ok OR failed)."""
        return self._risk_done.wait(timeout)

    def _score_risk(self, requests: list[Request], images: np.ndarray, ids: list,
                    traces: list) -> None:
        """Score one finished batch against the train index: ``copy_risk``
        on each request, the sim histogram and flagged counters, a bounded
        evidence dump per over-threshold generation. Any failure is counted
        and the batch ships unscored: scoring never fails generation."""
        from dcr_tpu_torch.obs import copyrisk

        index = self._risk
        if index is None:
            return
        rcfg = self.cfg.risk
        try:
            with tracing.span("serve/risk_score", batch=len(requests), request_ids=ids,
                              trace_ids=traces) as sp:
                scores, feats = index.score_batch_with_features(images)
                agg = copyrisk.observe_scores(scores, rcfg.threshold)
                # the per-row sims ride the span: trace_report's copy-risk
                # percentiles come from here
                sp.attrs.update(sims=[round(s.max_sim, 6) for s in scores],
                                prompts=[r.prompt for r in requests],
                                flagged=agg["flagged"])
        except Exception as e:
            log.exception("serve: copy-risk scoring failed")
            R.log_event("risk_score_failed", batch=len(requests), error=repr(e))
            R.bump_counter("copy_risk/score_failed")
            return
        for req, score, img in zip(requests, scores, images):
            req.risk = score.doc(rcfg.threshold)
            if score.max_sim >= rcfg.threshold:
                tracing.event("risk/flagged", trace=req.trace_id, request_id=req.id,
                              seed=req.seed, prompt=req.prompt,
                              max_sim=round(score.max_sim, 6), top_key=score.top_key,
                              threshold=rcfg.threshold)
                if self._evidence is not None:
                    self._evidence.record(img, score, rcfg.threshold, request_id=req.id,
                                          prompt=req.prompt, seed=req.seed,
                                          bucket=list(tuple(req.bucket)), trace=req.trace_id)
        pump = self._pump
        if pump is not None:
            # offer() never blocks: a full queue drops the row and bumps
            # ingest/dropped_total, generation latency is untouched. The key
            # is the JAX worker's
            for req, row in zip(requests, feats):
                pump.offer(row, f"gen/{req.trace_id or req.id}")

    def check(self, body: dict) -> dict:
        """``POST /check``: score ONE submitted image against the train
        index. Body ``{"image_png_b64": <base64 image>}``. Raises
        RiskUnavailableError (503) while the index is absent, loading or
        failed, ValueError (400) on an undecodable body."""
        from dcr_tpu_torch.obs.copyrisk import RiskUnavailableError, decode_image_b64

        index = self._risk
        if index is None:
            raise RiskUnavailableError(
                f"risk index is {self._risk_status} (source="
                f"{(self.cfg.risk.store_dir or self.cfg.risk.index_path)!r})",
                status=self._risk_status)
        image = decode_image_b64(body)
        with tracing.span("serve/risk_score", source="check", batch=1) as sp:
            score = index.score_batch(image[None])[0]
            sp.attrs.update(sims=[round(score.max_sim, 6)])
        reg = tracing.registry()
        reg.counter("copy_risk/checked_total").inc()
        reg.histogram("copy_risk/sim").observe(score.max_sim)
        return {**score.doc(self.cfg.risk.threshold),
                "threshold": self.cfg.risk.threshold, "index_size": len(index)}

    def execute(self, requests: list[Request]) -> np.ndarray:
        """Run one bucket-coherent batch; returns float32 [n, H, W, 3].

        Pads to the fixed ``max_batch`` shape with uncond-embedding rows of
        seed 0 (results discarded), so every batch of a bucket runs the same
        shapes whatever its occupancy. Scoring runs on the host copy after
        the sampler: images are bit-identical with scoring on or off."""
        if not requests:
            return np.zeros((0,), np.float32)
        bucket = requests[0].bucket
        if any(r.bucket != bucket for r in requests):
            raise ValueError("execute() requires a bucket-coherent batch")
        n = len(requests)
        pad = self.cfg.max_batch - n
        if pad < 0:
            raise ValueError(f"batch of {n} exceeds max_batch={self.cfg.max_batch}")
        fn = self._sampler_for(bucket)
        ids = [r.id for r in requests]
        traces = [r.trace_id for r in requests]
        # batch-level spans carry the member request and trace ids
        with tracing.span("serve/assemble", batch=n, request_ids=ids, trace_ids=traces):
            mitigation = mitigation_tag(bucket)
            uncond_row = self._uncond_embedding()
            cond = np.stack([self._cond_embedding(r, mitigation) for r in requests]
                            + [uncond_row] * pad)
            uncond = np.stack([uncond_row] * self.cfg.max_batch)
            seeds = np.asarray([r.seed for r in requests] + [0] * pad, np.uint32)
        # one sample/fast span per accelerated batch (trace_report's Fast
        # sampling section); a dense bucket's trace keeps its shape
        calls = fastsample.unet_calls(fastsample.fast_plan(bucket.steps, bucket.fast_ratio))
        fast_span = (tracing.span("sample/fast", steps=bucket.steps, unet_calls=calls,
                                  batch=n, fast_ratio=bucket.fast_ratio,
                                  fast_order=bucket.fast_order, sampler=bucket.sampler)
                     if calls < bucket.steps else contextlib.nullcontext())
        # the copy to the host closes the span when the device work is done
        with profiling.capture(), \
                tracing.span("serve/device_step", batch=n, request_ids=ids, trace_ids=traces,
                             bucket=str(tuple(bucket))) as dsp, \
                memwatch.span_hbm(dsp), fast_span:
            images = self._run_sampler(bucket, fn, cond, uncond, seeds)[:n]
        self._score_risk(requests, images, ids, traces)
        return images

    def _run_sampler(self, bucket: GenBucket, fn, cond, uncond, seeds) -> np.ndarray:
        """One padded batch of ``bucket`` to host f32 images. A bucket's first
        batch notes its footprint, the peak rise over the bytes in use
        before it, as ``serve/batch_sampler@<bucket>`` (the memory budget's
        estimate)."""
        if bucket in self._measured:
            return fn(cond, uncond, seeds).float().cpu().numpy()
        with memwatch.region_peak() as region:
            images = fn(cond, uncond, seeds).float().cpu().numpy()
        if region.rise is not None:
            memwatch.note_surface("serve/batch_sampler", str(tuple(bucket)),
                                  {"temp_bytes": region.rise})
        with self._samplers_lock:
            self._measured.add(bucket)
        return images

    # -- the drain loop ------------------------------------------------------

    def _on_hang(self) -> None:
        from dcr_tpu_torch.core.coordination import hang_abort

        hang_abort("serve_batch", detail=f"sampler step exceeded {self.cfg.hang_timeout_s}s")

    def _inject_batch_faults(self, batch_index: int) -> None:
        """The serve-side fault hooks, fired inside the batch watchdog's
        window so an injected wedge is caught by the machinery a real one
        meets. ``worker_crash`` is a true SIGKILL (no drain, no flush, no
        exit handler); ``worker_hang`` wedges this thread; ``slow_step`` is
        a straggler (``DCR_SLOW_STEP_S``, default 30 s); ``oom`` goes through
        the out-of-memory path of :meth:`_process`, as a real one does."""
        if faults.fire("worker_crash", batch=batch_index):
            os.kill(os.getpid(), signal.SIGKILL)
        if faults.fire("worker_hang", batch=batch_index):
            from dcr_tpu_torch.core.coordination import simulate_hang

            simulate_hang(f"worker_hang@batch={batch_index}")
        if faults.fire("slow_step", batch=batch_index):
            time.sleep(float(os.environ.get("DCR_SLOW_STEP_S", "30")))
        if faults.fire("oom", batch=batch_index):
            raise memwatch.InjectedOom(f"serve batch {batch_index}")

    def _process(self, batch: list[Request]) -> None:
        t0 = time.monotonic()
        now_wall = time.time()
        batch_index = self._batch_index
        self._batch_index += 1
        for req in batch:
            # the queue wait from the admission stamp, under the request's root
            waited = t0 - req.enqueued_at
            tracing.complete_span("serve/queue_wait", start_wall=now_wall - waited,
                                  dur_s=waited,
                                  parent=req.span.id if req.span is not None else None,
                                  trace=req.trace_id, request_id=req.id)
        try:
            # a wedged batch becomes a post-mortem and exit 89, not a dead port
            with R.watchdog("serve:batch", self.cfg.hang_timeout_s, on_timeout=self._on_hang):
                self._inject_batch_faults(batch_index)
                images = self.execute(batch)
        except Exception as e:
            if memwatch.is_oom_error(e):
                # this process can promise no further batch: exit 85 with a
                # memory post-mortem naming the resident buckets (the
                # futures are left to the process's death)
                with self._samplers_lock:
                    buckets = [tuple(b) for b in self._samplers]
                memwatch.oom_abort(f"serve batch {batch_index} bucket {batch[0].bucket}", e,
                                   buckets=buckets)
            log.exception("serve: batch failed")
            R.log_event("serve_batch_failed", batch=len(batch),
                        bucket=str(batch[0].bucket), error=repr(e))
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            self.metrics.note_batch(len(batch), self.cfg.max_batch, ok=False)
            return
        now = time.monotonic()
        for req, img in zip(batch, images):
            self.metrics.latency.observe(now - req.enqueued_at)
            req.future.set_result(img)
        self.metrics.note_batch(len(batch), self.cfg.max_batch, ok=True)
        log.info("serve: batch of %d/%d in %.3fs (queue depth %d)",
                 len(batch), self.cfg.max_batch, now - t0, self.queue.depth())
        if self._writer is not None:
            try:
                snap = self.metrics.snapshot()
                self._writer.scalars(snap["batches_total"], {
                    "serve/queue_depth": self.queue.depth(),
                    "serve/batch_occupancy": snap["batch_occupancy_last"],
                    "serve/cache_hit_rate": self.cache.stats()["hit_rate"],
                    "serve/latency_p50_ms": snap["latency_ms"]["p50"],
                    "serve/latency_p99_ms": snap["latency_ms"]["p99"]})
            except Exception as e:
                # a full disk under logdir is not a generation failure: the
                # requests were answered above
                R.log_event("serve_metrics_write_failed", error=repr(e))
                R.bump_counter("serve_metrics_write_failed")

    def _run(self) -> None:
        with torch.inference_mode():
            while True:
                batch = self.batcher.next_batch(self.queue, stop=self._stop)
                if batch is None:
                    break
                try:
                    self._process(batch)
                except Exception as e:
                    # a serving-layer bug (_process already turns generation
                    # failures into per-request exceptions): fail the
                    # batch's futures and keep the port alive
                    log.exception("serve: worker error")
                    R.log_event("serve_worker_error", error=repr(e), batch=len(batch))
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(e)
        log.info("serve: worker drained and stopped")

    # -- on-demand profiling -------------------------------------------------

    def profile(self, body: dict) -> dict:
        """``POST /debug/profile``: arm ``torch.profiler`` over the next K
        ``serve/device_step`` regions. Body ``{"steps"?: int, "logdir"?:
        str}``; the logdir defaults to ``<trace dir>/profile``. Returns the
        armed status; ``GET /debug/profile`` reports the ``artifact`` (the
        Chrome trace's path) once written."""
        steps = int(body.get("steps", 1))
        logdir = body.get("logdir")
        if not logdir:
            base = tracing.trace_dir()
            if base is None:
                raise ValueError("no profile destination: pass 'logdir' or run the "
                                 "worker with --logdir")
            logdir = str(base / "profile")
        return profiling.arm(logdir, steps)

    def profile_status(self) -> dict:
        return profiling.status()

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        """The /metrics document."""
        d = self.metrics.snapshot()
        d["queue_depth"] = self.queue.depth()
        d["draining"] = self.draining
        d["cache"] = self.cache.stats()
        risk = self._risk
        d["risk"] = {"status": self._risk_status,
                     "index_size": len(risk) if risk is not None else 0}
        if self._pump is not None:
            d["ingest"] = self._pump.stats()
        with self._samplers_lock:     # the worker thread mutates concurrently
            d["compiled_buckets"] = [tuple(b) for b in self._samplers]
        return d
