"""The Trainer: the loop around the train step.

Counterpart of ``dcr_tpu/diffusion/trainer.py`` (the reference's
diff_train.py:main, 328-733): it builds the models, the
tokenizer, the dataset and loader and the optimizer from a TrainConfig, runs
the epoch loop with metric logging and periodic checkpoints, resumes from
the newest valid checkpoint, and exports the HF-layout checkpoint at the end.

- Weights: seeded random initialisation; finetuning weights come in through
  ``pretrained_params=`` as the JAX package's param trees (``{"unet",
  "vae", "text"}``, nested dicts of arrays, as its ``params.npz`` hold
  them). ``cfg.pretrained_model`` is read for the tokenizer only, as in the
  JAX trainer.
- Cadences count optimizer steps; the state, the checkpoints and the resume
  count micro-steps, so a run stopped inside an accumulation resumes there.
- Fault tolerance, as the JAX trainer's single-host branch: every recovery
  is written to ``<output_dir>/quarantine.jsonl`` and counted in the
  metrics (``faults/bad_samples``, ``faults/rollbacks``,
  ``faults/ckpt_fallbacks``, ``faults/<counter>``). Resume walks back past
  damaged checkpoints (``bad_checkpoint``); the loader replaces samples
  that do not decode within ``fault.max_bad_sample_frac`` (``bad_sample``);
  a non-finite loss at a log boundary rolls back to the newest valid
  checkpoint and goes on past the bad window while ``fault.max_rollbacks``
  allows (``nan_rollback``), else raises ``FloatingPointError``; after
  :meth:`Trainer.install_preemption_handler` a SIGTERM or SIGINT
  checkpoints at the next step boundary and returns with
  ``preempted_exit`` set (``dcr-train`` exits 83); with
  ``fault.hang_timeout_s`` (or ``DCR_HANG_TIMEOUT_S``) a step that does
  not finish in time exits 89 (the watchdog is paused over the
  synchronous saves, a rollback's restore and the sample hook). ``DCR_FAULTS`` injects each fault
  (``utils/faults.py``).
- Several processes (``core/dist``: the JAX package's ``COORDINATOR_ADDRESS``
  / ``NUM_PROCESSES`` / ``PROCESS_ID`` or torchrun's variables), one device
  each: ``cuda:LOCAL_RANK`` unless the caller names one. ``cfg.mesh`` lays
  them out as data x fsdp x tensor or data x seq (``parallel/mesh.py``);
  each rank loads its ``(data, fsdp)`` coordinate's rows and the step is
  the global batch's (``diffusion/train``). With ``fsdp`` or ``tensor``
  above 1 the models' weights are cut to each rank's shards before the
  optimizer state is made (``parallel/sharded.py``), and every rank takes
  part in a save's and the export's gathers.
  The primary writes the checkpoints, logs, exports and grids, with a
  barrier after each save and at the export; every rank writes its own
  ``quarantine.p<rank>.jsonl`` and ``trace.p<rank>.jsonl``. Every log
  boundary is an agreement round (``core/coordination.Coordinator``): a NaN
  on one rank rolls every rank back at one step, a SIGTERM on any rank
  gives one checkpoint and exit 83 everywhere, the bad-sample budget is the
  job's (a seq replica's bad samples counted once), and the resume step
  must agree; the metrics add ``faults_pod/<counter>``, every rank's fault
  counters summed. Pipelined training keeps the JAX
  behaviour there: ``pipe.latent_cache`` raises, ``pipe.enabled`` logs and
  runs the fused step.
- Pipelined training (``pipe.enabled`` or ``pipe.latent_cache``), as the
  JAX trainer's single-host branch: an :class:`~dcr_tpu_torch.diffusion.
  encode_stage.EncodeProducer` per epoch runs the frozen encoders (or, with
  a latent cache, the cache stage) up to ``pipe.depth`` steps ahead on its
  own thread, and the loop runs the denoiser hot step on what it hands
  over. The cache is resolved after the resume and fingerprinted over the
  restored frozen params; one that cannot serve the run raises
  ``LatentCacheError``. A NaN rollback restores the hot part only: the
  frozen tensors, which the producer reads, are never written.
- Telemetry, as the JAX trainer's: ``<output_dir>/trace.jsonl`` with the
  ``train/data_wait`` and ``train/step`` spans (the step's with
  ``hbm_peak`` / ``hbm_delta``; host time, no device sync) and the
  producer's ``train/encode`` / ``train/encode_wait``; a flight-recorder
  dump (``flightrec_0.json``) on the NaN abort, the preemption exit and the
  hang exit; the ``dcr_device_mem_*`` gauges; ``tflops_per_sec`` and
  ``mfu`` at each log boundary on a card (``utils/profiling``). Out of
  device memory anywhere in the loop (or the ``oom`` fault) ends the
  process with exit 85 and a memory post-mortem
  (``obs/memwatch.oom_abort``). ``DCR_PROFILE_AT_STEP=K`` (and
  ``DCR_PROFILE_STEPS``) captures those steps with ``torch.profiler`` into
  ``<output_dir>/profile``.
- ``sample_hook(trainer, sync)`` runs every ``save_steps`` optimizer steps,
  as in the JAX trainer; ``dcr-train`` installs
  :func:`dcr_tpu_torch.diffusion.sample_hook.make_sample_hook`, which
  writes the sample grids.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import logging
import math
import os
import shutil
import signal
import time
import zlib
from pathlib import Path
from typing import Callable, Optional

import torch

from dcr_tpu_torch.core import coordination as C
from dcr_tpu_torch.core import dist
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import rng as rngmod
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core import warmcache
from dcr_tpu_torch.core.checkpoint import CheckpointManager, export_hf_layout
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.config import TrainConfig, save_config, to_dict, validate_train_config
from dcr_tpu_torch.core.metrics import MetricWriter
from dcr_tpu_torch.data.dataset import ObjectAttributeDataset
from dcr_tpu_torch.data.loader import DataLoader
from dcr_tpu_torch.data.tokenizer import TokenizerBase, load_tokenizer
from dcr_tpu_torch.diffusion import encode_stage as E
from dcr_tpu_torch.diffusion import train as T
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.obs import memwatch
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.sampling.pipeline import build_models
from dcr_tpu_torch.utils import faults, profiling

log = logging.getLogger("dcr_tpu_torch")


@compile_surface("train/params_finite")
def _params_finite(trainable: dict) -> bool:
    """Every trainable parameter finite (the NaN rollback's check of a
    restored checkpoint)."""
    return bool(torch.stack([torch.isfinite(p).all() for group in trainable.values()
                             for p in group.values()]).all())


def state_fingerprint(state: T.TrainState) -> str:
    """crc32 over the UNet params this rank holds and the step: logged at
    the end of a multi-process run (and at a preemption), where equal
    fingerprints on ranks that hold the same shards (all ranks, without
    ``fsdp`` or ``tensor``) show the replicas stayed bit-identical."""
    crc = zlib.crc32(str(state.step).encode())
    for name in sorted(state.unet_params):
        t = state.unet_params[name].detach().cpu().contiguous()
        crc = zlib.crc32(t.reshape(-1).view(torch.uint8).numpy() if t.numel() else b"", crc)
    return f"{crc:08x}"


def _flax_to_state_dicts(trees: dict, cfg: TrainConfig) -> dict:
    """The JAX package's ``{"unet", "vae", "text"}`` param trees (any subset)
    -> the port's state dicts."""
    conv = {"unet": lambda p: EX.unet_from_flax(p, len(cfg.model.block_out_channels)),
            "vae": EX.vae_from_flax, "text": EX.text_from_flax}
    unknown = set(trees) - set(conv)
    if unknown:
        raise KeyError(f"pretrained_params has unknown components {sorted(unknown)} "
                       f"(expected unet, vae, text)")
    return {name: conv[name](tree) for name, tree in trees.items()}


def export_train_state(cfg: TrainConfig, state: T.TrainState, out: Path) -> None:
    """HF-layout export (params.npz and diffusers/transformers safetensors)
    of ``state`` for the sampler and eval stages of either package and for
    diffusers; with EMA on, the EMA weights are the UNet exported. A sharded
    state is gathered whole (every rank calls it) and the primary writes."""
    unet = state.ema_params if state.ema_params is not None else state.unet_params
    weights = {"unet": unet, "vae": state.vae_params, "text": state.text_params}
    if state.layout is not None:  # every rank gathers; the primary keeps them
        weights = {c: state.layout.full_dict(c, w, keep=dist.is_primary())
                   for c, w in weights.items()}
    if not dist.is_primary():
        return
    export_hf_layout(
        out, unet=weights["unet"], vae=weights["vae"], text_encoder=weights["text"],
        scheduler_config={
            "num_train_timesteps": cfg.model.num_train_timesteps,
            "beta_schedule": cfg.model.beta_schedule,
            "beta_start": cfg.model.beta_start,
            "beta_end": cfg.model.beta_end,
            "prediction_type": cfg.model.prediction_type,
        },
        model_config=to_dict(cfg.model))


class Trainer:
    def __init__(self, cfg: TrainConfig, *, dataset: Optional[ObjectAttributeDataset] = None,
                 tokenizer: Optional[TokenizerBase] = None,
                 pretrained_params: Optional[dict] = None,
                 sample_hook: Optional[Callable] = None,
                 device: str | torch.device = "cuda"):
        validate_train_config(cfg)
        self.device = dist.job_device(device)
        dist.initialize(self.device)
        self.mesh = pmesh.make_mesh(cfg.mesh)
        self.multi = dist.process_count() > 1
        # scale_lr resolved into a private copy; config.json records the
        # effective lr
        cfg = T.resolve_scale_lr(cfg, self.mesh.data_parallel_size)
        self.cfg = cfg
        self.sample_hook = sample_hook
        self.out_dir = Path(cfg.output_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        pidx = dist.process_index()
        # spans into <output_dir>/trace.jsonl (trace.p<rank>.jsonl; DCR_TRACE=0
        # keeps the ring only), and the anchor of flightrec_<rank>.json on
        # every fatal path
        tracing.configure(self.out_dir, rank=pidx)
        if dist.is_primary():
            save_config(cfg, self.out_dir / "config.json")
        self.tokenizer = tokenizer or load_tokenizer(
            cfg.pretrained_model or None, vocab_size=cfg.model.text_vocab_size,
            model_max_length=cfg.model.text_max_length)
        if self.tokenizer.vocab_size > cfg.model.text_vocab_size:
            raise ValueError(f"tokenizer vocab ({self.tokenizer.vocab_size}) exceeds "
                             f"model.text_vocab_size ({cfg.model.text_vocab_size})")
        if dist.is_primary():
            self._publish_tokenizer()
        # the durable record of every recovered failure of this run, one
        # file per process
        qname = "quarantine.jsonl" if pidx == 0 else f"quarantine.p{pidx}.jsonl"
        self.quarantine = R.QuarantineManifest(self.out_dir / qname)
        self.dataset = dataset or ObjectAttributeDataset(cfg.data, self.tokenizer,
                                                         fault=cfg.fault)
        # each rank loads its (data, fsdp) coordinate's rows; the tensor and
        # seq replicas of a batch group load the same ones
        self.loader = DataLoader(self.dataset, batch_size=cfg.train_batch_size,
                                 num_workers=cfg.data.num_workers, seed=cfg.data.seed,
                                 process_index=self.mesh.batch_index,
                                 process_count=self.mesh.data_parallel_size,
                                 fault=cfg.fault, quarantine=self.quarantine,
                                 defer_budget_abort=self.multi)
        self.models = build_models(cfg.model, self.device,
                                   seed=rngmod.stream_seed(cfg.seed, "init"), mesh=self.mesh)
        # dcr_device_mem_* gauges (nothing to sample on the CPU)
        memwatch.start_sampler()
        modules = {"unet": self.models.unet, "vae": self.models.vae,
                   "text": self.models.text_encoder}
        for name, sd in _flax_to_state_dicts(pretrained_params or {}, cfg).items():
            modules[name].load_state_dict(sd, strict=True)
        # the state's params are the modules' own parameters: the modules
        # always hold the trained weights (on a sharded mesh, this rank's
        # shards of them, cut before the optimizer state is made)
        params = {name: dict(m.named_parameters()) for name, m in modules.items()}
        self.state = T.init_train_state(cfg, self.models, unet_params=params["unet"],
                                        text_params=params["text"], vae_params=params["vae"],
                                        mesh=self.mesh)
        # pipelined mode splits the fused step into a frozen-encoder producer
        # and the denoiser hot step; the fused step is not built then. On
        # several processes the producer thread's launches would race the
        # consumer's collectives, so, as in the JAX trainer, a latent cache
        # is refused and pipe.enabled falls back to the fused step
        self.pipelined = bool(cfg.pipe.enabled or cfg.pipe.latent_cache)
        if self.pipelined and self.multi:
            if cfg.pipe.latent_cache:
                raise ValueError(
                    "pipe.latent_cache is single-process for now (the producer thread's "
                    "launches would race the collectives of the step): drop the flag on "
                    "multi-process runs")
            log.warning("pipelined training disabled: %d processes (the producer thread "
                        "is single-process only; training continues on the fused step)",
                        dist.process_count())
            R.log_event("pipelined_disabled_multihost", processes=dist.process_count())
            self.pipelined = False
        self._cache_reader = None
        self._cache_fn = None
        if self.pipelined:
            _, self._frozen = E.split_state(self.state, cfg.train_text_encoder)
            self.encode_fn = E.make_encode_stage(cfg, self.models)
            self.denoise_fn = E.make_denoise_step(cfg, self.models)
            # what the loop calls: (state, encoded batch) -> (state, metrics)
            self.step_fn = self._pipelined_step
        else:
            self.step_fn = T.make_train_step(cfg, self.models, self.mesh)
        self.producer: Optional[E.EncodeProducer] = None
        # the consumer's seconds blocked on the producer ring, one per step
        self.ring_wait_s: list[float] = []
        self.writer = MetricWriter(self.out_dir / "logs", active=dist.is_primary())
        # every recovery decision goes through the agreement, so all
        # processes act alike at one step; on one process it is local logic
        hang_timeout = float(os.environ.get("DCR_HANG_TIMEOUT_S",
                                            cfg.fault.hang_timeout_s) or 0.0)
        self.coord = C.Coordinator(
            timeout_s=hang_timeout if hang_timeout > 0 else cfg.fault.barrier_timeout_s,
            abort_on_timeout=hang_timeout > 0,
            bad_sample_budget=(self.loader.epoch_bad_budget()
                               if cfg.fault.max_bad_sample_frac > 0 and self.multi else None))
        self.ckpt = CheckpointManager(self.out_dir / "checkpoints",
                                      max_to_keep=cfg.checkpoints_total_limit,
                                      verify=cfg.fault.verify_checkpoints,
                                      quarantine=self.quarantine, coordinator=self.coord)
        self.watchdog = C.HangWatchdog(hang_timeout, coordinator=self.coord)
        # recovery counters, reported at every log boundary
        self._rollbacks = 0
        self._ckpt_fallbacks = 0
        self._nan_pending = False
        self._preempted = False
        self._previous_handlers: dict = {}
        # set when a preemption wrote the final checkpoint; dcr-train turns
        # it into coordination.EXIT_PREEMPTED for the restart wrapper
        self.preempted_exit = False

    def _publish_tokenizer(self) -> None:
        """Copy BPE vocab/merges into <output_dir>/tokenizer so the sampler
        run on this output dir finds the same tokenizer (decompressing .gz)."""
        paths = (getattr(self.tokenizer, "vocab_path", None),
                 getattr(self.tokenizer, "merges_path", None))
        if any(p is None for p in paths):
            return
        tok_dir = self.out_dir / "tokenizer"
        tok_dir.mkdir(parents=True, exist_ok=True)
        for src, dst in zip(paths, ("vocab.json", "merges.txt")):
            src = Path(src)
            if src.resolve() == (tok_dir / dst).resolve():
                continue
            if src.suffix == ".gz":
                with gzip.open(src, "rt", encoding="utf-8") as f:
                    (tok_dir / dst).write_text(f.read(), encoding="utf-8")
            else:
                shutil.copyfile(src, tok_dir / dst)

    # -- pipelined mode ------------------------------------------------------

    def _pipelined_step(self, state: T.TrainState, enc: dict):
        """The denoiser hot step on the hot view of ``state``; returns the
        merged view (the same tensors) for the checkpoints and the hook."""
        tte = self.cfg.train_text_encoder
        hot, _ = E.split_state(state, tte)
        hot, metrics = self.denoise_fn(hot, enc)
        return E.merge_state(hot, self._frozen, tte), metrics

    def _frozen_groups(self) -> tuple[str, ...]:
        """The checkpoint groups a pipelined rollback leaves unwritten."""
        if not self.pipelined:
            return ()
        return ("vae params",) if self.cfg.train_text_encoder else ("vae params",
                                                                     "text params")

    def _open_latent_cache(self) -> None:
        """Verify and load ``pipe.latent_cache`` against this run's
        fingerprint, over the frozen params as restored (LatentCacheError
        when the cache cannot serve the run)."""
        from dcr_tpu_torch.data import latent_cache as LC

        cfg = self.cfg
        expected = LC.cache_fingerprint(cfg, self.dataset, self.tokenizer,
                                        vae_params=self.state.vae_params,
                                        text_params=self.state.text_params)
        self._cache_reader = LC.LatentCacheReader(cfg.pipe.latent_cache, expected)
        self._cache_fn = E.make_cache_stage(cfg, self.models)
        cached, total = self._cache_reader.coverage()
        log.info("latent cache %s: %d/%d indices cached (misses re-encode live)",
                 cfg.pipe.latent_cache, cached, total)

    def _make_producer(self, batches, start_step: int) -> E.EncodeProducer:
        """The epoch's producer: the live encode stage, or the cache stage
        with the live stage as the recompute path of uncached indices."""
        encode = E.live_encode(self.encode_fn, self._frozen)
        if self._cache_reader is not None:
            encode = E.cached_encode(self._cache_fn, self._cache_reader, encode)
        return E.EncodeProducer(batches, encode, depth=self.cfg.pipe.depth,
                                start_step=start_step, device=self.device)

    # -- checkpoint/resume ---------------------------------------------------

    def _barrier_timeout_s(self) -> float:
        """The bound of the save and export barriers: ``barrier_timeout_s``,
        else the generous allgather bound (0 waits forever)."""
        return self.cfg.fault.barrier_timeout_s or dist.default_allgather_timeout_s()

    def save(self) -> None:
        """The primary writes the step (a sharded state gathered whole, every
        rank taking part); every rank waits at a barrier, so no rank reads
        the checkpoints before the step is in place."""
        self.ckpt.save(self.state.step, self.state, primary=dist.is_primary())
        dist.barrier("checkpoint", timeout_s=self._barrier_timeout_s())

    def maybe_resume(self) -> int:
        """Restore the newest valid checkpoint (0 on a fresh run): damaged
        steps on the way are quarantined and counted as fallbacks. On
        several processes the entry is agreed first (a rank that sees no
        checkpoint while a peer sees one fails in the agreed restore with
        every rank's proposal, instead of the two branching apart)."""
        latest = self.ckpt.latest_step()
        if self.multi:
            views = self.coord.agree_int(-1 if latest is None else latest, "resume_latest")
            if max(views) < 0:
                return 0
        elif latest is None:
            return 0
        step, skipped = self.ckpt.restore_latest_valid(self.state)
        self._ckpt_fallbacks += len(skipped)
        if skipped:
            log.warning("resume fell back past %d corrupt checkpoint(s): %s",
                        len(skipped), [s for s, _ in skipped])
        log.info("resumed from checkpoint step %d", step)
        return step

    def _warm_start(self) -> None:
        """Resolve the kernel libraries of the train step (or, pipelined, of
        the denoiser hot step) through the warm cache
        (``core/warmcache.py``), as the JAX trainer resolves its programs:
        with ``warm.dir`` set, a restarted run loads verified libraries
        instead of running nvcc. The producer stage and the params-finite
        check launch no native kernel, so they have nothing to resolve. A
        cache problem costs a rebuild, never the run."""
        cfg = self.cfg
        if not cfg.warm.dir:
            return
        if self.multi:
            # the JAX rule: ranks must launch the same programs; a per-host
            # hit racing a peer's build is not worth the skew risk
            R.log_event("warmcache_skipped_multihost", processes=dist.process_count())
            return
        cache = warmcache.WarmCache(cfg.warm.dir)
        static = {"flash_attention": cfg.model.flash_attention}
        with tracing.span("train_warm"):
            res = warmcache.aot_compile(
                E.make_denoise_step if self.pipelined else T.make_train_step, (self.state,),
                static_config=static, cache=cache)
        log.info("warm start: %s %s in %.2fs (cache %s)", res.surface, res.source,
                 res.build_s, cfg.warm.dir)

    def _rollback_possible(self) -> bool:
        """The guards of :meth:`_rollback_after_nan`, asked before the
        agreement: the checkpoints and the rollback count are the same on
        every process, so one rank that saw the NaN answers for all."""
        return (self._rollbacks < self.cfg.fault.max_rollbacks
                and self.ckpt.latest_step() is not None)

    def _rollback_after_nan(self, step: int, loss: float) -> bool:
        """NaN rollback (``fault.max_rollbacks``): restore the newest valid
        checkpoint whose trainable params are finite and fast-forward
        ``state.step`` to ``step``, so the loop goes on with the next batch
        and the per-step draws move past the bad window while params,
        optimizer and EMA come from the checkpoint. False when rollback is
        off, used up or impossible: the caller then fails fast."""
        ft = self.cfg.fault
        if self._rollbacks >= ft.max_rollbacks:
            return False
        if self.ckpt.latest_step() is None:
            R.log_event("nan_rollback_impossible", at_step=step,
                        reason="no checkpoint to roll back to")
            return False
        skipped_total = 0
        while True:
            try:
                ckpt_step, skipped = self.ckpt.restore_latest_valid(
                    self.state, skip=self._frozen_groups())
            except FileNotFoundError as e:
                R.log_event("nan_rollback_impossible", at_step=step, reason=repr(e))
                self._ckpt_fallbacks += skipped_total
                return False
            skipped_total += len(skipped)
            # the checksums prove the bytes round-tripped, not that they were
            # ever sane: a checkpoint with non-finite params would re-trip
            finite = _params_finite(T.trainable_of(self.state, self.cfg.train_text_encoder))
            if self.state.layout is not None:  # each rank sees its shards only
                finite = min(self.coord.agree_int(int(finite), "rollback_finite")) == 1
            if finite:
                break
            self.ckpt.quarantine_step(ckpt_step,
                                      f"non-finite params (rollback from step {step})")
        self._ckpt_fallbacks += skipped_total
        self._rollbacks += 1
        self.state.step = step
        self.quarantine.record(
            "nan_rollback", at_step=step, restored_step=ckpt_step, loss=loss,
            rollback=self._rollbacks, max_rollbacks=ft.max_rollbacks,
            skipped_steps=step - ckpt_step)
        return True

    def export_checkpoint(self, tag: str = "checkpoint") -> Path:
        """:func:`export_train_state` to ``<output_dir>/<tag>``, every rank
        waiting at a barrier until it is written."""
        out = self.out_dir / tag
        export_train_state(self.cfg, self.state, out)
        dist.barrier("export", timeout_s=self._barrier_timeout_s())
        return out

    # -- preemption ----------------------------------------------------------

    def install_preemption_handler(self, signals=None) -> None:
        """SIGTERM/SIGINT -> finish the current step, checkpoint, return with
        ``preempted_exit`` set. The handler only sets a flag; the save
        happens at the next step boundary. The first signal restores the
        default disposition, so a second one ends the process at once.
        ``train()`` puts the previous handlers back on every exit path.
        Installed by ``dcr-train``; library users opt in."""
        self._preempted = False
        sigs = tuple(signals or (signal.SIGTERM, signal.SIGINT))
        self._previous_handlers = {s: signal.getsignal(s) for s in sigs}

        def handler(signum, frame):
            log.warning("received signal %d: will checkpoint and stop at the next step "
                        "boundary (send again to abort immediately)", signum)
            self._preempted = True
            signal.signal(signum, signal.SIG_DFL)

        for s in sigs:
            signal.signal(s, handler)

    def _uninstall_preemption_handler(self) -> None:
        for s, previous in self._previous_handlers.items():
            signal.signal(s, previous)
        self._previous_handlers = {}

    # -- the loop ------------------------------------------------------------

    def _fire_step_faults(self, step: int) -> None:
        """The loop's fault-injection hooks (free when DCR_FAULTS is unset)."""
        if faults.fire("nan_loss", step=step):
            self._nan_pending = True
        if faults.fire("oom", step=step):
            # through train()'s out-of-memory path, as a real one goes
            raise memwatch.InjectedOom(f"train step {step}")
        if faults.fire("sigterm", step=step):
            os.kill(os.getpid(), signal.SIGTERM)
        if faults.fire("hang", step=step):
            C.simulate_hang(f"injected hang at step {step}")

    def _agree(self, step: int, nan_here: bool) -> C.Decision:
        """One agreement round over this process's fault word."""
        if nan_here:
            self.coord.note_nan(step, rollback_ok=self._rollback_possible())
        if self._preempted:
            self.coord.note_preempt()
        self.coord.note_bad_samples(self._global_bad_count(self.loader.epoch_bad_count))
        return self.coord.exchange(step, tag="sync")

    def _global_bad_count(self, count: int) -> int:
        """This process's share of a job-wide sum of its bad-sample
        ``count``. The tensor and seq replicas of a batch group read the
        same rows and quarantine the same samples, so only tensor and seq
        index 0 reports them: summing every replica would count each bad
        sample once per replica."""
        replica = self.mesh.index(pmesh.SEQ_AXIS) + self.mesh.index(pmesh.TENSOR_AXIS)
        return count if replica == 0 else 0

    def _fault_metrics(self) -> dict:
        out = {"faults/bad_samples": self.loader.bad_samples,
               "faults/rollbacks": self._rollbacks,
               "faults/ckpt_fallbacks": self._ckpt_fallbacks}
        local = R.counters()
        out.update({f"faults/{name}": n for name, n in local.items()})
        if self.multi:
            # the job's view: every rank's counters summed over the store
            # (a timeout-bounded control-plane round; every rank reaches this
            # log boundary in lockstep), with the bad samples of seq index 0
            mine = dict(local, bad_samples=self._global_bad_count(self.loader.bad_samples))
            rows = dist.kv_allgather(json.dumps(mine), "fault_counters",
                                     timeout_s=dist.default_allgather_timeout_s())
            job = tracing.merge_counter_rows(json.loads(r) for r in rows)
            out.update({f"faults_pod/{name}": n for name, n in job.items()})
        return out

    def train(self) -> dict:
        try:
            return self._train()
        except Exception as e:
            # out of device memory anywhere in the loop (the step, the
            # producer, a restore): the typed exit 85 with a memory post-
            # mortem, so a restart wrapper can tell "shrink the batch" from
            # a crash. Every other error keeps its meaning
            if memwatch.is_oom_error(e):
                self.watchdog.stop()
                memwatch.oom_abort(f"train step {self.state.step}", e)
            raise
        finally:
            # a raise stops the heartbeats: a still-armed watchdog would exit
            # 89 mid-unwind and hide the real failure
            self.watchdog.stop()
            self._uninstall_preemption_handler()

    def _train(self) -> dict:
        cfg = self.cfg
        step = self.maybe_resume()
        if self.multi:
            # divergent resume steps would desynchronize every collective
            self.coord.assert_same("resume_step", step)
        if self.pipelined and cfg.pipe.latent_cache:
            self._open_latent_cache()
        # the step's kernel libraries from the warm cache AFTER restore, so a
        # preempted run's first step builds nothing
        self._warm_start()
        steps_per_epoch = self.loader.steps_per_epoch()
        accum = max(1, cfg.optim.gradient_accumulation_steps)
        # stop at whichever comes first in micro-batches: the requested
        # optimizer steps, or the end of the requested epochs (a trailing
        # partial accumulation is not applied)
        max_micro = min(cfg.max_train_steps * accum, cfg.num_train_epochs * steps_per_epoch)
        log.info("training: %d optimizer steps (micro-batch accum %d, %d micro/epoch), "
                 "batch %d on %s", max_micro // accum, accum, steps_per_epoch,
                 cfg.train_batch_size, self.device)
        # mfu: one step's FLOPs, counted once on meta tensors (on a card;
        # the CPU has no peak to hold them to)
        flops = peak = None
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            try:
                flops = profiling.train_step_flops(cfg, hot_only=self.pipelined)
            except Exception as e:  # telemetry never stops training: logged, no mfu
                R.log_event("step_flops_count_failed", error=repr(e))
            peak = profiling.chip_peak_tflops(
                "bf16" if cfg.mixed_precision == "bf16" else "f32")
            log.info("a step's FLOPs: %s (counted in %.2f s); peak %s TFLOP/s",
                     flops, time.perf_counter() - t0, peak)
        # on-demand profiling: DCR_PROFILE_AT_STEP=K captures micro-steps
        # [K, K + DCR_PROFILE_STEPS) into <output_dir>/profile
        profile_at = int(os.environ.get("DCR_PROFILE_AT_STEP", "-1") or -1)
        profile_steps = int(os.environ.get("DCR_PROFILE_STEPS", "1") or 1)
        t_last, imgs_last = time.time(), 0
        last_metrics: dict = {}
        self.watchdog.start()
        while step < max_micro:
            epoch = step // steps_per_epoch
            batches = self.loader.epoch(epoch, start_step=step % steps_per_epoch)
            # pipelined: the producer thread takes the loader's batches and
            # hands over encoded ones, in step order
            self.producer = (self._make_producer(batches, start_step=step)
                             if self.pipelined else None)
            try:
                while True:
                    if self.producer is None:
                        # the host's wait on the loader (its decodes run on
                        # its worker threads); pipelined, the producer
                        # thread waits and get() spans train/encode_wait
                        with tracing.span("train/data_wait", step=step):
                            batch = next(batches, None)
                    else:
                        batch = self.producer.get(step)
                    if batch is None:
                        break
                    if step == profile_at:
                        try:
                            profiling.arm(str(self.out_dir / "profile"), profile_steps)
                            R.log_trace("profile_armed", at_step=step, steps=profile_steps)
                        except (RuntimeError, ValueError) as e:
                            R.log_event("profile_arm_failed", error=repr(e))
                    # host time of the step's launches (no device sync);
                    # hbm_peak / hbm_delta from the allocator's counters
                    with profiling.capture(), \
                            tracing.span("train/step", step=step) as sp, memwatch.span_hbm(sp):
                        self.state, metrics = self.step_fn(self.state, batch)
                    step += 1
                    imgs_last += cfg.train_batch_size
                    self.watchdog.beat(step)
                    self._fire_step_faults(step)
                    at_sync = step % accum == 0
                    sync = step // accum
                    decision: Optional[C.Decision] = None
                    if (at_sync and sync % cfg.log_every == 0) or step == max_micro:
                        metrics = {k: float(v) for k, v in metrics.items()}
                        if self._nan_pending:
                            metrics["loss"], self._nan_pending = float("nan"), False
                        nan_here = not math.isfinite(metrics["loss"])
                        # one agreement round per boundary: on several
                        # processes every rank enters it, a finite loss too
                        # (one rank's NaN moves them all; a round a peer
                        # never enters is a hang); on one it is local logic
                        if nan_here or self.multi:
                            decision = self._agree(step, nan_here)
                        if decision is not None and decision.action in (C.Action.ROLLBACK,
                                                                        C.Action.FAIL):
                            with self.watchdog.paused(step):
                                rolled_back = (decision.action is C.Action.ROLLBACK
                                               and self._rollback_after_nan(
                                                   decision.nan_step, metrics["loss"]))
                            if not rolled_back:
                                tracing.dump_flight_recorder(
                                    f"nan_abort: step {decision.nan_step} loss "
                                    f"{metrics['loss']}")
                                raise FloatingPointError(
                                    f"non-finite loss {metrics['loss']} at step "
                                    f"{decision.nan_step} (ranks {list(decision.nan_ranks)}); "
                                    f"resume from the last good checkpoint (step "
                                    f"{self.ckpt.latest_step()}) under "
                                    f"{self.out_dir}/checkpoints")
                            # the restored state goes on with the next batch
                            t_last, imgs_last = time.time(), 0
                            if step >= max_micro:
                                break
                            continue
                        dt = max(time.time() - t_last, 1e-9)
                        metrics["images_per_sec"] = imgs_last * self.mesh.data_parallel_size / dt
                        if flops:
                            # per device, and for the job (every rank runs
                            # the step's FLOPs)
                            tflops = flops * imgs_last / cfg.train_batch_size / dt / 1e12
                            metrics["tflops_per_sec"] = tflops
                            metrics["tflops_per_sec_total"] = tflops * dist.process_count()
                            if peak:
                                metrics["mfu"] = tflops / peak
                        metrics.update(self._fault_metrics())
                        self.writer.scalars(sync, metrics)
                        last_metrics = metrics
                        t_last, imgs_last = time.time(), 0
                    if (self.sample_hook and cfg.save_steps > 0 and at_sync
                            and sync % cfg.save_steps == 0):
                        with self.watchdog.paused(step), (
                                self.producer.paused() if self.producer is not None
                                else contextlib.nullcontext()):
                            self.sample_hook(self, sync)
                    if decision is not None and decision.action is C.Action.ABORT_BAD_SAMPLES:
                        from dcr_tpu_torch.data.loader import TooManyBadSamples

                        raise TooManyBadSamples(
                            f"epoch {epoch}: {decision.bad_total} bad samples across "
                            f"{dist.process_count()} processes exceed the job's quarantine "
                            f"budget of {self.coord.bad_sample_budget} "
                            f"(max_bad_sample_frac={cfg.fault.max_bad_sample_frac})")
                    # before the periodic save, so no step is written twice;
                    # on several processes only the agreement stops the job
                    if ((self._preempted and not self.multi) or (
                            decision is not None
                            and decision.action is C.Action.CHECKPOINT_AND_EXIT)):
                        log.warning("preemption: checkpointing at step %d and stopping "
                                    "(resume picks up here; signalled on ranks %s)", step,
                                    list(decision.preempt_ranks) if decision else [0])
                        self.watchdog.stop()
                        self.save()
                        if self.multi:
                            log.info("state fingerprint at step %d: %s", step,
                                     state_fingerprint(self.state))
                        self.writer.close()
                        self.preempted_exit = True
                        # the exit-83 path: the run's last moments for the
                        # restart's operator
                        tracing.dump_flight_recorder(f"preempted: checkpointed at step {step}")
                        return last_metrics
                    if at_sync and sync % cfg.modelsavesteps == 0:
                        with self.watchdog.paused(step):
                            self.save()
                    if step >= max_micro:
                        break
            finally:
                # every exit path stops the producer before the loader's
                # generator closes: the thread may be running it
                if self.producer is not None:
                    self.producer.stop()
                    self.ring_wait_s += self.producer.wait_s
                batches.close()
        self.watchdog.stop()  # the save and export below have no heartbeat
        self.save()
        if self.multi:
            log.info("state fingerprint at step %d: %s", step, state_fingerprint(self.state))
        self.export_checkpoint()
        self.writer.close()
        return last_metrics
