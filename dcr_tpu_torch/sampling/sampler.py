"""Text-to-image sampler: a Python loop over denoising steps with CFG.

Counterpart of ``dcr_tpu/sampling/sampler.py``. The JAX package compiles the
trajectory into one ``lax.scan``; here each step runs eagerly on the device,
and the host-side timestep grid, the CFG order ``[uncond, cond]``, the
guidance ``u + g*(c - u)``, the first-order final step under 15 steps and
the output ``clip(x*0.5+0.5, 0, 1)`` are the same.

Randomness comes from one explicit ``torch.Generator``, drawn in a fixed
order: x_T (unless ``init_latents`` hands it in), then the Newpipe
embedding noise, then DDPM's per-step noise.

With ``cfg.fast.enabled`` the loop follows the score-reuse plan of
:mod:`dcr_tpu_torch.sampling.fastsample`: a reuse step launches no UNet. A
plan that skips nothing builds the plain loop.

On a mesh (``parallel/mesh.py``) the sampler is the global batch's, as
the JAX sampler under jit: every draw is made for the global batch from the
one generator, each rank denoises its ``(data, fsdp)`` rows, and the
images of every row come back to every rank.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.config import SampleConfig, validate_fast_config
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.models import schedulers as S
from dcr_tpu_torch.models.clip_text import CLIPTextModel
from dcr_tpu_torch.models.unet2d import UNet2DCondition
from dcr_tpu_torch.models.vae import AutoencoderKL, vae_scale_factor
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.sampling import fastsample


class DiffusionModels(NamedTuple):
    """The modules (holding their weights) and the noise schedule."""

    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    schedule: S.NoiseSchedule


def encode_prompts(models: DiffusionModels, input_ids: torch.Tensor,
                   uncond_ids: torch.Tensor, *, rand_noise_lam: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   rows: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cond, uncond) embeddings [B, L, D] from the last hidden state;
    optional Newpipe noise on both halves. With ``rows`` (a rank's rows of
    the global batch) the ids are the global batch's: the rank embeds its
    rows, and the noise is drawn for the global batch."""
    if rows is not None:
        n_global = input_ids.shape[0]
        input_ids, uncond_ids = rows(input_ids), rows(uncond_ids)
    cond = models.text_encoder(input_ids).last_hidden_state
    uncond = models.text_encoder(uncond_ids).last_hidden_state
    if rand_noise_lam > 0.0:
        shape = tuple(cond.shape) if rows is None else (n_global, *cond.shape[1:])
        noise = torch.randn((2,) + shape, generator=generator,
                            device=cond.device, dtype=cond.dtype)
        if rows is not None:
            noise = torch.stack([rows(noise[0]), rows(noise[1])])
        cond = cond + rand_noise_lam * noise[0]
        uncond = uncond + rand_noise_lam * noise[1]
    return cond, uncond


def decode_images(models: DiffusionModels, x: torch.Tensor) -> torch.Tensor:
    """x_0 latents [B, C, h, w] -> images [B, H, W, 3] in [0, 1]."""
    images = models.vae.decode(x / models.vae.config.vae_scaling_factor)
    return torch.clamp(images * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)


def sampler_grid(sampler: str, sched: S.NoiseSchedule,
                 num_inference_steps: int) -> tuple[np.ndarray, np.ndarray, bool]:
    """(ts, prev_ts, lower_order_final) for a sampler name: linspace spacing
    for dpm++, leading otherwise; steps_offset 1 except for ddpm; the final
    step targets t=0 (prev_t=-1, acp=1, for ddpm); first-order final step
    under 15 steps."""
    spacing = "linspace" if sampler == "dpm++" else "leading"
    offset = 0 if sampler == "ddpm" else 1
    ts = S.inference_timesteps(sched, num_inference_steps, spacing=spacing,
                               steps_offset=offset)
    final_prev = -1 if sampler == "ddpm" else 0
    prev_ts = np.concatenate([ts[1:], np.array([final_prev], ts.dtype)])
    return ts, prev_ts, num_inference_steps < 15


def scheduler_step(sampler: str, sched: S.NoiseSchedule, pred: torch.Tensor,
                   x: torch.Tensor, t, prev_t, dpm_state: S.DPMState, *,
                   force_first_order: bool = False,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None):
    """One denoising update ``x_t -> x_{prev_t}``; returns ``(x_new, dpm_state)``.
    The ancestral ``ddpm`` sampler takes its noise as given (``noise``) or
    draws it from ``generator``."""
    if sampler == "ddim":
        return S.ddim_step(sched, pred, x, t, prev_t), dpm_state
    if sampler == "dpm++":
        return S.dpmpp_2m_step(sched, pred, x, t, prev_t, dpm_state,
                               force_first_order=force_first_order)
    if sampler == "ddpm":
        if generator is None and noise is None:
            raise ValueError("ddpm needs a generator (or the noise) for its per-step noise")
        return S.ddpm_step(sched, pred, x, t, prev_t, noise=noise,
                           generator=generator), dpm_state
    raise ValueError(f"unknown sampler {sampler!r}")


def denoise(models: DiffusionModels, x: torch.Tensor, ctx: torch.Tensor, *,
            sampler: str, sched: S.NoiseSchedule, ts: np.ndarray, prev_ts: np.ndarray,
            lower_order_final: bool, plan: tuple[bool, ...], fast_order: int,
            guidance: float, generator: Optional[torch.Generator] = None,
            step_noise: Optional[Callable[[int], torch.Tensor]] = None) -> torch.Tensor:
    """The CFG denoising loop from x_T [B, C, h, w] with ``ctx`` = [uncond,
    cond] [2B, L, D]; returns x_0. A step the plan marks full runs the UNet
    (and banks its score when the plan reuses any); a reuse step takes
    :func:`fastsample.reuse_score`. DDPM's noise for step i is
    ``step_noise(i)`` when given, else drawn from ``generator``. The bulk
    sampler and the serving batch sampler both run it."""
    bsz = x.shape[0]
    use_fast = not fastsample.is_dense(plan)

    def predict(t: int) -> torch.Tensor:
        tb = torch.full((2 * bsz,), t, dtype=torch.long, device=x.device)
        pred = models.unet(torch.cat([x, x], dim=0), tb, ctx)
        pred_uncond, pred_cond = pred.chunk(2, dim=0)
        return pred_uncond + guidance * (pred_cond - pred_uncond)

    dpm_state = S.dpm_init_state(tuple(x.shape), device=x.device)
    bank = fastsample.bank_init(tuple(x.shape), x.device) if use_fast else None
    for i, (t, prev_t) in enumerate(zip(ts.tolist(), prev_ts.tolist())):
        if plan[i]:
            pred = predict(t)
            if use_fast:
                bank = fastsample.bank_update(bank, pred, t)
        else:
            pred = fastsample.reuse_score(bank, t, fast_order)
        force1 = lower_order_final and i == len(ts) - 1
        noise = step_noise(i) if step_noise is not None and sampler == "ddpm" else None
        x, dpm_state = scheduler_step(sampler, sched, pred, x, t, prev_t, dpm_state,
                                      force_first_order=force1, generator=generator,
                                      noise=noise)
    return x


@compile_surface("sample/sampler")
def make_sampler(cfg: SampleConfig, models: DiffusionModels,
                 device: str | torch.device = "cuda", mesh=None) -> Callable:
    """Build the sampler: ``(models | None, input_ids, uncond_ids, generator, *,
    init_latents=None) -> images [B, H, W, 3]`` float32 in [0, 1].

    ``models=None`` uses the modules given here. ``init_latents`` is x_T in
    the JAX layout [B, h, w, C]; without it x_T is drawn from ``generator``
    on the device. ``unet_calls`` on the sampler is its plan's UNet calls
    per trajectory. ``mesh``: the job's mesh; with ``data`` x ``fsdp``
    above 1 the batch (``B``, a multiple of it) splits over those ranks and
    every rank returns all ``B`` images."""
    device = resolve_device(device)
    validate_fast_config(cfg.fast)
    vae_cfg = models.vae.config
    latent_size = cfg.resolution // vae_scale_factor(vae_cfg)
    latent_ch = vae_cfg.vae_latent_channels
    guidance = cfg.guidance_scale
    ts, prev_ts, lower_order_final = sampler_grid(
        cfg.sampler, models.schedule, cfg.num_inference_steps)
    plan = fastsample.fast_plan(cfg.num_inference_steps,
                                cfg.fast.reuse_ratio if cfg.fast.enabled else 0.0)
    split = mesh is not None and mesh.data_parallel_size > 1
    rows = (lambda t: pmesh.local_rows(t, mesh)) if split else None

    @torch.no_grad()
    def sample_fn(modules: Optional[DiffusionModels], input_ids, uncond_ids,
                  generator: Optional[torch.Generator], *,
                  init_latents=None) -> torch.Tensor:
        m = modules or models
        sched = m.schedule.to(device)
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=device)
        unc = torch.as_tensor(np.asarray(uncond_ids), dtype=torch.long, device=device)
        bsz = ids.shape[0]
        if init_latents is None:
            x = torch.randn((bsz, latent_ch, latent_size, latent_size),
                            generator=generator, device=device)
        else:
            x = torch.as_tensor(np.array(init_latents, dtype=np.float32),
                                device=device).permute(0, 3, 1, 2).contiguous()
            if x.shape != (bsz, latent_ch, latent_size, latent_size):
                raise ValueError(f"init_latents shape {tuple(x.shape)} (NCHW) does not "
                                 f"match {(bsz, latent_ch, latent_size, latent_size)}")
        cond, uncond = encode_prompts(m, ids, unc, rand_noise_lam=cfg.rand_noise_lam,
                                      generator=generator, rows=rows)
        ctx = torch.cat([uncond, cond], dim=0)             # [2B, L, D]
        step_noise = None
        if split:
            x_shape = tuple(x.shape)
            x = rows(x)
            # DDPM's per-step noise for the global batch, the rank's rows
            step_noise = lambda i: rows(torch.randn(x_shape, generator=generator,
                                                    device=device))
        x = denoise(m, x, ctx, sampler=cfg.sampler, sched=sched, ts=ts, prev_ts=prev_ts,
                    lower_order_final=lower_order_final, plan=plan,
                    fast_order=cfg.fast.order, guidance=guidance, generator=generator,
                    step_noise=step_noise)
        images = decode_images(m, x)
        return pmesh.gather_rows(images.contiguous(), mesh) if split else images

    sample_fn.unet_calls = fastsample.unet_calls(plan)
    return sample_fn
