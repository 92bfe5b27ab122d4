"""The Trainer: the loop around the train step, on one device.

Counterpart of ``dcr_tpu/diffusion/trainer.py`` reduced to one device and
fail-fast (the reference's diff_train.py:main, 328-733): it builds the models,
the tokenizer, the dataset and loader and the optimizer from a TrainConfig,
runs the epoch loop with metric logging and periodic checkpoints, resumes
from the newest checkpoint, and exports the HF-layout checkpoint at the end.

- Weights: seeded random initialisation; finetuning weights come in through
  ``pretrained_params=`` as the JAX package's param trees (``{"unet",
  "vae", "text"}``, nested dicts of arrays, as its ``params.npz`` hold
  them). ``cfg.pretrained_model`` is read for the tokenizer only, as in the
  JAX trainer.
- Cadences count optimizer steps; the state, the checkpoints and the resume
  count micro-steps, so a run stopped inside an accumulation resumes there.
- A non-finite loss at a log boundary raises ``FloatingPointError``; the
  last periodic checkpoint is the recovery point (NaN rollback, the
  bad-sample quarantine and multi-host are not ported).
- ``sample_hook(trainer, sync)`` runs every ``save_steps`` optimizer steps,
  as in the JAX trainer; ``dcr-train`` installs
  :func:`dcr_tpu_torch.diffusion.sample_hook.make_sample_hook`, which
  writes the sample grids.
"""

from __future__ import annotations

import gzip
import logging
import math
import shutil
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from dcr_tpu_torch.core import rng as rngmod
from dcr_tpu_torch.core.checkpoint import CheckpointManager, export_hf_layout
from dcr_tpu_torch.core.config import TrainConfig, save_config, to_dict, validate_train_config
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.core.metrics import MetricWriter
from dcr_tpu_torch.data.dataset import ObjectAttributeDataset
from dcr_tpu_torch.data.loader import DataLoader
from dcr_tpu_torch.data.tokenizer import TokenizerBase, load_tokenizer
from dcr_tpu_torch.diffusion import train as T
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.sampling.pipeline import build_models

log = logging.getLogger("dcr_tpu_torch")


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


class Trainer:
    def __init__(self, cfg: TrainConfig, *, dataset: Optional[ObjectAttributeDataset] = None,
                 tokenizer: Optional[TokenizerBase] = None,
                 pretrained_params: Optional[dict] = None,
                 sample_hook: Optional[Callable] = None,
                 device: str | torch.device = "cuda"):
        validate_train_config(cfg)
        self.device = resolve_device(device)
        # scale_lr resolved into a private copy; config.json records the
        # effective lr
        cfg = T.resolve_scale_lr(cfg)
        self.cfg = cfg
        self.sample_hook = sample_hook
        self.out_dir = Path(cfg.output_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        save_config(cfg, self.out_dir / "config.json")
        self.tokenizer = tokenizer or load_tokenizer(
            cfg.pretrained_model or None, vocab_size=cfg.model.text_vocab_size,
            model_max_length=cfg.model.text_max_length)
        if self.tokenizer.vocab_size > cfg.model.text_vocab_size:
            raise ValueError(f"tokenizer vocab ({self.tokenizer.vocab_size}) exceeds "
                             f"model.text_vocab_size ({cfg.model.text_vocab_size})")
        self._publish_tokenizer()
        self.dataset = dataset or ObjectAttributeDataset(cfg.data, self.tokenizer)
        self.loader = DataLoader(self.dataset, batch_size=cfg.train_batch_size,
                                 num_workers=cfg.data.num_workers, seed=cfg.data.seed)
        self.models = build_models(cfg.model, self.device,
                                   seed=rngmod.stream_seed(cfg.seed, "init"))
        modules = {"unet": self.models.unet, "vae": self.models.vae,
                   "text": self.models.text_encoder}
        for name, sd in _flax_to_state_dicts(pretrained_params or {}, cfg).items():
            modules[name].load_state_dict(sd, strict=True)
        # the state's params are the modules' own parameters: the modules
        # always hold the trained weights
        params = {name: dict(m.named_parameters()) for name, m in modules.items()}
        self.state = T.init_train_state(cfg, self.models, unet_params=params["unet"],
                                        text_params=params["text"], vae_params=params["vae"])
        self.step_fn = T.make_train_step(cfg, self.models)
        self.writer = MetricWriter(self.out_dir / "logs")
        self.ckpt = CheckpointManager(self.out_dir / "checkpoints",
                                      max_to_keep=cfg.checkpoints_total_limit)

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

    # -- checkpoint/resume ---------------------------------------------------

    def save(self) -> None:
        self.ckpt.save(self.state.step, self.state)

    def maybe_resume(self) -> int:
        if self.ckpt.latest_step() is None:
            return 0
        step = self.ckpt.restore(self.state)
        log.info("resumed from checkpoint step %d", step)
        return step

    def export_checkpoint(self, tag: str = "checkpoint") -> Path:
        """HF-layout export (params.npz and diffusers/transformers
        safetensors) for the sampler and eval stages of either package and
        for diffusers; with EMA on, the EMA weights are the UNet exported."""
        cfg = self.cfg
        out = self.out_dir / tag
        unet = self.state.ema_params if self.state.ema_params is not None \
            else self.state.unet_params
        export_hf_layout(
            out, unet=unet, vae=self.state.vae_params, text_encoder=self.state.text_params,
            scheduler_config={
                "num_train_timesteps": cfg.model.num_train_timesteps,
                "beta_schedule": cfg.model.beta_schedule,
                "beta_start": cfg.model.beta_start,
                "beta_end": cfg.model.beta_end,
                "prediction_type": cfg.model.prediction_type,
            },
            model_config=to_dict(cfg.model))
        return out

    # -- the loop ------------------------------------------------------------

    def train(self) -> dict:
        cfg = self.cfg
        step = self.maybe_resume()
        steps_per_epoch = self.loader.steps_per_epoch()
        accum = max(1, cfg.optim.gradient_accumulation_steps)
        # stop at whichever comes first in micro-batches: the requested
        # optimizer steps, or the end of the requested epochs (a trailing
        # partial accumulation is not applied)
        max_micro = min(cfg.max_train_steps * accum, cfg.num_train_epochs * steps_per_epoch)
        log.info("training: %d optimizer steps (micro-batch accum %d, %d micro/epoch), "
                 "batch %d on %s", max_micro // accum, accum, steps_per_epoch,
                 cfg.train_batch_size, self.device)
        t_last, imgs_last = time.time(), 0
        last_metrics: dict = {}
        while step < max_micro:
            epoch = step // steps_per_epoch
            batches = self.loader.epoch(epoch, start_step=step % steps_per_epoch)
            try:
                for batch in batches:
                    self.state, metrics = self.step_fn(self.state, batch)
                    step += 1
                    imgs_last += cfg.train_batch_size
                    at_sync = step % accum == 0
                    sync = step // accum
                    if (at_sync and sync % cfg.log_every == 0) or step == max_micro:
                        metrics = {k: float(v) for k, v in metrics.items()}
                        if not math.isfinite(metrics["loss"]):
                            raise FloatingPointError(
                                f"non-finite loss {metrics['loss']} at step {step}; resume "
                                f"from the last good checkpoint (step "
                                f"{self.ckpt.latest_step()}) under {self.out_dir}/checkpoints")
                        metrics["images_per_sec"] = imgs_last / max(time.time() - t_last, 1e-9)
                        self.writer.scalars(sync, metrics)
                        last_metrics = metrics
                        t_last, imgs_last = time.time(), 0
                    if (self.sample_hook and cfg.save_steps > 0 and at_sync
                            and sync % cfg.save_steps == 0):
                        self.sample_hook(self, sync)
                    if at_sync and sync % cfg.modelsavesteps == 0:
                        self.save()
                    if step >= max_micro:
                        break
            finally:
                batches.close()
        self.save()
        self.export_checkpoint()
        self.writer.close()
        return last_metrics
