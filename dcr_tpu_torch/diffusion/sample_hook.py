"""Periodic in-training sample grids, the reference's visual regression check.

Counterpart of ``dcr_tpu/diffusion/sample_hook.py`` (``make_sample_hook``;
reference diff_train.py:669-701). Every ``save_steps`` optimizer steps the
Trainer calls the hook, which samples the live weights (the EMA UNet when
EMA is on) with the port's DDIM sampler and writes
``<output_dir>/generations/step_<n>.png`` with the port's PNG writer.

Noise comes from a ``torch.Generator`` seeded from ``generation_seed`` and
the step (stream ``train_samples``), independent of the train seed. With
``risk.index_path`` set, :func:`score_sample_grid` scores each grid against
the train-embedding index and writes ``risk/*`` gauges, so the
duplication -> copying effect shows on the loss curve's timeline.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from dcr_tpu_torch.core import dist
from dcr_tpu_torch.core import rng as rngmod
from dcr_tpu_torch.core.config import SampleConfig
from dcr_tpu_torch.eval.gallery import image_grid
from dcr_tpu_torch.models.vae import vae_scale_factor
from dcr_tpu_torch.sampling.png import write_png
from dcr_tpu_torch.sampling.prompts import sample_caption_prompts
from dcr_tpu_torch.sampling.sampler import make_sampler

log = logging.getLogger("dcr_tpu_torch")


class _WithParams(nn.Module):
    """A module called with other parameters (the EMA weights) in place of
    its own."""

    def __init__(self, module: nn.Module, params: dict[str, torch.Tensor]):
        super().__init__()
        self.module, self.params = module, params

    def forward(self, *args):
        return functional_call(self.module, self.params, args)


def grid_prompts(trainer, max_prompts: int) -> list[str]:
    """The grid's prompts by conditioning regime (reference
    diff_train.py:573-607): ``classlevel`` the first ``max_prompts`` class
    names; ``instancelevel_*`` ``max_prompts`` draws over the captions of
    the active (trainsubset) paths, seeded by ``generation_seed``;
    otherwise the instance prompt."""
    cfg, ds = trainer.cfg, trainer.dataset
    style = cfg.data.class_prompt
    if style == "classlevel":
        return [f"An image of {c}" for c in ds.classnames[:max_prompts]]
    if style.startswith("instancelevel") and ds.prompts:
        paths = (ds.paths[int(i)] for i in ds.active_indices)
        caption_lists = [ds.prompts[p] for p in paths if p in ds.prompts]
        return sample_caption_prompts(caption_lists, style, max_prompts,
                                      seed=cfg.generation_seed, tokenizer=trainer.tokenizer,
                                      stream="train_sample_prompts")
    return [cfg.data.instance_prompt]


def make_sample_hook(*, num_inference_steps: int = 20, images_per_prompt: int = 4,
                     max_prompts: int = 3, guidance_scale: float = 7.5):
    """A ``hook(trainer, step)`` for ``Trainer(sample_hook=...)``. The
    sampler, prompts and token ids are made at the first call and kept in
    ``hook.state``."""
    state: dict = {}

    def hook(trainer, step: int) -> None:
        cfg = trainer.cfg
        if "sampler" not in state:
            px = vae_scale_factor(cfg.model) * cfg.model.sample_size
            scfg = SampleConfig(resolution=px, num_inference_steps=num_inference_steps,
                                guidance_scale=guidance_scale, sampler="ddim",
                                seed=cfg.generation_seed)
            state["sampler"] = make_sampler(scfg, trainer.models, trainer.device)
            state["prompts"] = grid_prompts(trainer, max_prompts)
            state["ids"] = np.repeat(trainer.tokenizer(state["prompts"]), images_per_prompt,
                                     axis=0)
            state["uncond"] = np.broadcast_to(trainer.tokenizer([""])[0],
                                              state["ids"].shape).copy()
        models = trainer.models
        if trainer.state.ema_params is not None:
            models = models._replace(unet=_WithParams(models.unet, trainer.state.ema_params))
        gen = rngmod.stream_generator(cfg.generation_seed, "train_samples", step,
                                      device=trainer.device)
        # every rank samples (a sequence-parallel UNet needs its peers);
        # the primary writes and scores the grid
        images = state["sampler"](models, state["ids"], state["uncond"], gen)
        if not dist.is_primary():
            return
        grid = image_grid(list(images.float().cpu().numpy()), cols=images_per_prompt)
        out = Path(cfg.output_dir) / "generations"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"step_{step}.png"
        write_png(path, grid)
        log.info("sample grid -> %s", path)
        score_sample_grid(trainer, state, step, images.float().cpu().numpy())

    hook.state = state
    return hook


def score_sample_grid(trainer, state: dict, step: int, images: np.ndarray) -> None:
    """Score one save interval's generations against the train-embedding
    index of ``TrainConfig.risk.index_path`` and write the ``risk/max_sim``,
    ``risk/mean_sim``, ``risk/flagged`` and ``risk/scored`` gauges through
    ``trainer.writer``. The index is loaded once into ``state``; a bad dump
    or a scoring error degrades to unscored grids with a ``copy_risk/*``
    counter, never a failed step. ``trainer`` needs ``.cfg``, ``.writer``
    and ``.device`` (the index's device)."""
    rcfg = trainer.cfg.risk
    if not rcfg.index_path:
        return
    from dcr_tpu_torch.core import resilience as R
    from dcr_tpu_torch.obs import copyrisk

    if "risk_index" not in state:
        try:
            state["risk_index"] = copyrisk.CopyRiskIndex.load(
                rcfg, batch=len(images), device=trainer.device)
        except Exception as e:
            log.exception("risk: index load failed")
            R.log_event("risk_index_load_failed", path=rcfg.index_path, error=repr(e))
            R.bump_counter("copy_risk/index_load_failed")
            state["risk_index"] = None
    index = state["risk_index"]
    if index is None:
        return
    try:
        scores = index.score_batch(images)
        agg = copyrisk.observe_scores(scores, rcfg.threshold)
    except Exception as e:
        log.exception("risk: scoring failed")
        R.log_event("risk_score_failed", step=step, error=repr(e))
        R.bump_counter("copy_risk/score_failed")
        return
    trainer.writer.scalars(step, {
        "risk/max_sim": agg["max_sim"],
        "risk/mean_sim": agg["mean_sim"],
        "risk/flagged": agg["flagged"],
        "risk/scored": agg["scored"],
    })
    log.info("risk: step %d — max_sim %.4f, %d/%d over threshold %.3f",
             step, agg["max_sim"], agg["flagged"], agg["scored"], rcfg.threshold)
