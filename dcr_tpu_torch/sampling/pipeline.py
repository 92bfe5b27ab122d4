"""Bulk generation: checkpoint -> prompts -> sampling -> PNGs.

Counterpart of ``dcr_tpu/sampling/pipeline.py``. It reads an
HF-layout checkpoint directory, an export of either package
(``model_index.json`` with the native ``model_config``) or a genuine
diffusers checkpoint such as a downloaded SD-2.1 (per-subfolder
config.json, safetensors or ``.bin`` weights, its ``tokenizer/``), carries
the weights into the port's modules, builds the prompt list for the
model's conditioning style and writes ``<savepath>/generations/{count}.png``
and ``prompts.txt``: the directory contract the eval stage reads.

:func:`generate` runs over the job's processes (``core/dist``: torchrun's
variables or the JAX package's) as the JAX pipeline runs over its mesh
(``cfg.mesh``): the parameters placed by the JAX rules
(``parallel/sharding.py``: the UNet's and VAE's projections over
``tensor``, FSDP's largest axis over ``fsdp``), the device batch padded
to a multiple of ``data`` x ``fsdp`` whose rows split over those ranks, a
``seq`` axis turning on the UNet's sequence-parallel attention; the
primary writes the images and prompts.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from dcr_tpu_torch.core import dist
from dcr_tpu_torch.core import rng as rngmod
from dcr_tpu_torch.core import warmcache
from dcr_tpu_torch.core.checkpoint import import_torch_layout, model_config_from_diffusers
from dcr_tpu_torch.core.config import (ModelConfig, SampleConfig,
                                       from_dict, validate_fast_config)
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.data.tokenizer import TokenizerBase, load_tokenizer
from dcr_tpu_torch.models import schedulers as S
from dcr_tpu_torch.models.convert import check_state_dict
from dcr_tpu_torch.models.clip_text import CLIPTextModel
from dcr_tpu_torch.models.unet2d import UNet2DCondition
from dcr_tpu_torch.models.vae import AutoencoderKL
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.parallel import sharded as SH
from dcr_tpu_torch.sampling.png import write_png
from dcr_tpu_torch.sampling.prompts import build_prompt_list, save_prompts
from dcr_tpu_torch.sampling.sampler import DiffusionModels, make_sampler

log = logging.getLogger("dcr_tpu_torch")


def build_models(model_cfg: ModelConfig, device: str | torch.device = "cuda",
                 seed: Optional[int] = None, mesh=None) -> DiffusionModels:
    """The module bundle on ``device``, in eval mode, with PyTorch's default
    initialisation (seeded when ``seed`` is given); weights are loaded over
    it by :func:`load_params`. A ``mesh`` (``parallel/mesh.Mesh``) with a
    ``seq`` axis above 1 turns on the UNet's sequence-parallel attention."""
    device = resolve_device(device)
    # a seeded build draws from a forked global generator, leaving the
    # caller's RNG state as it was
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else [],
                               enabled=seed is not None), torch.device(device):
        if seed is not None:
            torch.manual_seed(seed)
        models = DiffusionModels(
            unet=UNet2DCondition(model_cfg, mesh=mesh).eval(),
            vae=AutoencoderKL(model_cfg).eval(),
            text_encoder=CLIPTextModel(model_cfg).eval(),
            schedule=S.make_schedule(
                num_train_timesteps=model_cfg.num_train_timesteps,
                beta_schedule=model_cfg.beta_schedule,
                beta_start=model_cfg.beta_start, beta_end=model_cfg.beta_end,
                prediction_type=model_cfg.prediction_type, device=device))
    return models


def _modules(models: DiffusionModels) -> dict[str, torch.nn.Module]:
    return {"unet": models.unet, "vae": models.vae, "text": models.text_encoder}


def load_params(models: DiffusionModels, params: dict) -> None:
    """Load ``{"unet", "vae", "text"}`` state dicts into the modules (strict)."""
    for name, module in _modules(models).items():
        module.load_state_dict(params[name], strict=True)


def load_checkpoint_models(ckpt_dir: str | Path, device: str | torch.device = "cuda",
                           mesh=None):
    """(models, params, model_cfg) from an HF-layout directory: an export of
    either package (``model_index.json`` with the native ``model_config``)
    or a genuine diffusers checkpoint such as a downloaded SD-2.1, whose
    dims come from its per-subfolder config.json files and schedule from
    ``scheduler/scheduler_config.json``. ``params`` holds the state dicts
    the modules were loaded with; ``mesh`` goes to :func:`build_models`."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    index = json.loads((ckpt_dir / "model_index.json").read_text())
    if "model_config" in index:
        cfg_dict = index["model_config"]
    elif "block_out_channels" in index:
        # round-1 flat dict, whose text tower hardcoded quick_gelu
        cfg_dict = {**index, "text_act": index.get("text_act", "quick_gelu")}
    else:
        cfg_dict = model_config_from_diffusers(ckpt_dir)
    model_cfg = from_dict(ModelConfig, cfg_dict)
    params = {"unet": import_torch_layout(ckpt_dir, "unet"),
              "vae": import_torch_layout(ckpt_dir, "vae"),
              "text": import_torch_layout(ckpt_dir, "text_encoder")}
    models = build_models(model_cfg, device, mesh=mesh)
    problems = [p for name, module in _modules(models).items()
                for p in check_state_dict(module.state_dict(), params[name],
                                          prefix=f"{name}/")]
    if problems:
        raise ValueError(f"checkpoint {ckpt_dir} does not match the architecture its "
                         f"configs describe ({len(problems)} mismatches): "
                         + "; ".join(problems[:8]))
    load_params(models, params)
    return models, params, model_cfg


def resolve_checkpoint(cfg: SampleConfig) -> Path:
    """checkpoint_<iternum>/ or checkpoint/ under the run dir."""
    root = Path(cfg.model_path)
    if (root / "unet").exists():  # already a checkpoint dir
        return root
    if cfg.iternum and cfg.iternum > 0:
        cand = root / f"checkpoint_{cfg.iternum}"
        if not cand.exists():
            raise FileNotFoundError(f"no checkpoint_{cfg.iternum} under {root}")
        return cand
    cand = root / "checkpoint"
    if not cand.exists():
        raise FileNotFoundError(f"no exported checkpoint/ under {root} "
                                "(export one or pass iternum)")
    return cand


class GenerationStack(NamedTuple):
    """What a generation path needs, loaded once: the modules (holding their
    weights, on ``device``), the model config and the tokenizer the
    checkpoint shipped with. The serving worker (:mod:`dcr_tpu_torch.serve.
    worker`) loads through :func:`load_generation_stack`; unlike the JAX
    package's stack it carries no params tree and no mesh (one device)."""

    models: DiffusionModels
    model_cfg: ModelConfig
    tokenizer: TokenizerBase
    device: torch.device


def load_generation_stack(cfg: SampleConfig,
                          device: str | torch.device = "cuda") -> GenerationStack:
    """checkpoint dir -> :class:`GenerationStack` on ``device``: an export of
    either package or a genuine diffusers checkpoint, through
    :func:`load_checkpoint_models`, and the tokenizer it ships with."""
    device = resolve_device(device)
    models, _, model_cfg = load_checkpoint_models(resolve_checkpoint(cfg), device)
    text_cfg = models.text_encoder.config
    tokenizer = load_tokenizer(cfg.model_path or None, vocab_size=text_cfg.text_vocab_size,
                               model_max_length=text_cfg.text_max_length)
    return GenerationStack(models=models, model_cfg=model_cfg, tokenizer=tokenizer,
                           device=device)


def generate(cfg: SampleConfig, *, modelstyle: str,
             tokenizer: Optional[TokenizerBase] = None,
             caption_json: Optional[str] = None,
             prompts: Optional[Sequence[str]] = None,
             models: Optional[DiffusionModels] = None, params: Optional[dict] = None,
             device: str | torch.device = "cuda",
             init_latents: Optional[np.ndarray] = None) -> Path:
    """Run bulk generation; returns the savepath containing generations/.

    ``models`` may be passed pre-built (with ``params``, state dicts loaded
    into them strictly; built with the job's mesh when it has a ``seq``
    axis); otherwise they come from ``cfg.model_path``. On several
    processes every one calls it. ``init_latents``: x_T of every image in
    generation order, in the JAX layout [N, h, w, C], in place of the
    generator's draws (the parity tests hand in the JAX pipeline's)."""
    device = dist.job_device(device)
    validate_fast_config(cfg.fast)
    dist.initialize(device)
    mesh = pmesh.make_mesh(cfg.mesh)
    if models is None:
        models, _, _ = load_checkpoint_models(resolve_checkpoint(cfg), device, mesh=mesh)
    elif params is not None:
        load_params(models, params)
    SH.place_models(models, mesh)
    text_cfg = models.text_encoder.config
    tokenizer = tokenizer or load_tokenizer(cfg.model_path or None,
                                            vocab_size=text_cfg.text_vocab_size,
                                            model_max_length=text_cfg.text_max_length)
    if prompts is None:
        prompts = build_prompt_list(
            modelstyle, cfg.num_batches, seed=cfg.seed, tokenizer=tokenizer,
            caption_json=caption_json,
            rand_augs=cfg.rand_augs if cfg.rand_augs != "none" else None,
            rand_aug_repeats=cfg.rand_aug_repeats)
    savepath = Path(cfg.savepath or "inferences/run")
    gen_dir = savepath / "generations"
    primary = dist.is_primary()
    if primary:
        gen_dir.mkdir(parents=True, exist_ok=True)
        save_prompts(prompts, savepath)

    sampler = make_sampler(cfg, models, device, mesh=mesh)
    if cfg.warm.dir and dist.process_count() == 1:
        # the sampler's kernel library loads from the warm cache: a re-run
        # on the same card starts generating without nvcc
        res = warmcache.aot_compile(
            make_sampler, (models,),
            static_config={"flash_attention": models.unet.config.flash_attention},
            cache=warmcache.WarmCache(cfg.warm.dir))
        log.info("bulk sampler %s via warm cache (%s) in %.2fs",
                 res.source, cfg.warm.dir, res.build_s)
    uncond_ids = tokenizer([""])[0]
    log.info("sampling %d prompts: %d UNet calls per %d-step trajectory (fast %s)",
             len(prompts), sampler.unet_calls, cfg.num_inference_steps, cfg.fast)
    # fixed device batch, as the JAX pipeline sizes it: one row per process
    # (at least one prompt), padded up to a multiple of data x fsdp
    dp = mesh.data_parallel_size
    prompts_per_batch = max(1, mesh.world // max(1, cfg.im_batch))
    device_batch = -(-prompts_per_batch * cfg.im_batch // dp) * dp
    count = 0
    for start in range(0, len(prompts), prompts_per_batch):
        chunk = list(prompts[start:start + prompts_per_batch])
        ids = np.repeat(tokenizer(chunk), cfg.im_batch, axis=0)    # [P*im_batch, L]
        real = len(ids)
        if real < device_batch:                                     # pad to fixed batch
            ids = np.concatenate([ids, np.repeat(ids[-1:], device_batch - real, axis=0)])
        unc = np.broadcast_to(uncond_ids, ids.shape).copy()
        gen = rngmod.stream_generator(cfg.seed, "sample", start, device=device)
        x_t = None
        if init_latents is not None:
            x_t = init_latents[count:count + real]
            x_t = np.concatenate([x_t, np.repeat(x_t[-1:], device_batch - real, axis=0)])
        images = sampler(None, ids, unc, gen, init_latents=x_t)[:real].cpu().numpy()
        for img in images:
            if primary:
                write_png(gen_dir / f"{count}.png", (img * 255).round().astype(np.uint8))
            count += 1
    log.info("wrote %d generations to %s", count, gen_dir)
    return savepath
