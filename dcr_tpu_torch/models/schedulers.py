"""Diffusion noise schedules and sampler steps as plain tensor functions.

Counterpart of ``dcr_tpu/models/schedulers.py``: the schedule is computed in
f64 numpy and stored f32; the steps are the same formulas (DDPM ancestral,
DDIM eta=0, DPM-Solver++(2M)) over f32 tensors. ``t``/``prev_t`` may be Python
ints or [B] integer tensors. DDPM's noise is passed in or drawn from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed diffusion coefficients, all shape [T] float32."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction" | "sample"

    @property
    def sqrt_alphas_cumprod(self) -> torch.Tensor:
        return torch.sqrt(self.alphas_cumprod)

    @property
    def sqrt_one_minus_alphas_cumprod(self) -> torch.Tensor:
        return torch.sqrt(1.0 - self.alphas_cumprod)

    def to(self, device: str | torch.device) -> "NoiseSchedule":
        return replace(self, betas=self.betas.to(device),
                       alphas_cumprod=self.alphas_cumprod.to(device))


def make_schedule(num_train_timesteps: int = 1000, beta_schedule: str = "scaled_linear",
                  beta_start: float = 0.00085, beta_end: float = 0.012,
                  prediction_type: str = "epsilon",
                  device: str | torch.device = "cpu") -> NoiseSchedule:
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "scaled_linear":
        # SD's schedule: linear in sqrt(beta)
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    elif beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps, dtype=np.float64)

        def f(x):
            return np.cos((x / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2

        betas = np.minimum(1.0 - f(t + 1) / f(t), 0.999)
    else:
        raise ValueError(f"unknown beta_schedule {beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    return NoiseSchedule(
        betas=torch.as_tensor(betas.astype(np.float32), device=device),
        alphas_cumprod=torch.as_tensor(alphas_cumprod.astype(np.float32), device=device),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


def _idx(t, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.long, device=device)


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a scalar or [B] per-timestep value against an ndim-rank tensor."""
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def _gather(coeffs: torch.Tensor, t, ndim: int) -> torch.Tensor:
    """coeffs[t] broadcast against an ndim-rank batched tensor."""
    return _bcast(coeffs[_idx(t, coeffs.device)], ndim)


def _acp_prev_raw(sched: NoiseSchedule, prev_t) -> torch.Tensor:
    """alphas_cumprod[prev_t] with prev_t=-1 meaning "fully denoised" (acp=1)."""
    prev_t = _idx(prev_t, sched.alphas_cumprod.device)
    acp = sched.alphas_cumprod[torch.clamp(prev_t, min=0)]
    return torch.where(prev_t >= 0, acp, torch.ones_like(acp))


def add_noise(sched: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t) -> torch.Tensor:
    """q(x_t | x_0): forward diffusion."""
    a = _gather(sched.sqrt_alphas_cumprod, t, x0.ndim)
    s = _gather(sched.sqrt_one_minus_alphas_cumprod, t, x0.ndim)
    return a * x0.float() + s * noise.float()


def get_velocity(sched: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
                 t) -> torch.Tensor:
    """v-prediction target."""
    a = _gather(sched.sqrt_alphas_cumprod, t, x0.ndim)
    s = _gather(sched.sqrt_one_minus_alphas_cumprod, t, x0.ndim)
    return a * noise.float() - s * x0.float()


def training_target(sched: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
                    t) -> torch.Tensor:
    if sched.prediction_type == "epsilon":
        return noise
    if sched.prediction_type == "v_prediction":
        return get_velocity(sched, x0, noise, t)
    if sched.prediction_type == "sample":
        return x0
    raise ValueError(f"unknown prediction_type {sched.prediction_type!r}")


def pred_to_x0_eps(sched: NoiseSchedule, model_out: torch.Tensor, x_t: torch.Tensor,
                   t) -> tuple[torch.Tensor, torch.Tensor]:
    """Convert the model's output under its prediction_type to (x0_hat, eps_hat)."""
    a = _gather(sched.sqrt_alphas_cumprod, t, x_t.ndim)
    s = _gather(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim)
    if sched.prediction_type == "epsilon":
        eps = model_out
        x0 = (x_t - s * eps) / a
    elif sched.prediction_type == "v_prediction":
        x0 = a * x_t - s * model_out
        eps = a * model_out + s * x_t
    elif sched.prediction_type == "sample":
        x0 = model_out
        eps = (x_t - a * x0) / s
    else:
        raise ValueError(sched.prediction_type)
    return x0, eps


def inference_timesteps(sched: NoiseSchedule, num_inference_steps: int,
                        spacing: str = "leading", steps_offset: int = 1) -> np.ndarray:
    """Descending timestep grid [num_inference_steps] (int64), diffusers'
    ``set_timesteps`` grids: "leading" (DDIM/PNDM family, shifted by
    ``steps_offset``) or "linspace" (DPMSolverMultistep)."""
    T = sched.num_train_timesteps
    if num_inference_steps > T:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} exceeds "
            f"num_train_timesteps={T}")
    if spacing == "leading":
        step = T // num_inference_steps
        ts = (np.arange(num_inference_steps) * step).round()[::-1].copy()
        ts = np.minimum(ts + steps_offset, T - 1)
    elif spacing == "linspace":
        ts = np.linspace(0, T - 1, num_inference_steps + 1).round()[::-1][:-1].copy()
    else:
        raise ValueError(f"unknown timestep spacing {spacing!r}")
    return ts.astype(np.int64)


def ddpm_step(sched: NoiseSchedule, model_out: torch.Tensor, x_t: torch.Tensor,
              t, prev_t, *, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Ancestral step; ``noise`` is used as given, else drawn from ``generator``."""
    nd = x_t.ndim
    x0, _eps = pred_to_x0_eps(sched, model_out, x_t, t)
    x0 = torch.clamp(x0, -1000.0, 1000.0)
    acp = _gather(sched.alphas_cumprod, t, nd)
    acp_prev = _bcast(_acp_prev_raw(sched, prev_t), nd)
    alpha_t = acp / acp_prev
    beta_t = 1.0 - alpha_t
    # posterior mean coefficients (Ho et al. eq. 7)
    coef_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp)
    coef_xt = torch.sqrt(alpha_t) * (1.0 - acp_prev) / (1.0 - acp)
    mean = coef_x0 * x0 + coef_xt * x_t
    var = beta_t * (1.0 - acp_prev) / (1.0 - acp)
    if noise is None:
        noise = torch.randn(x_t.shape, generator=generator, device=x_t.device,
                            dtype=x_t.dtype)
    add_noise_mask = _bcast(_idx(prev_t, x_t.device) >= 0, nd)
    return torch.where(add_noise_mask,
                       mean + torch.sqrt(torch.clamp(var, min=1e-20)) * noise, mean)


def ddim_step(sched: NoiseSchedule, model_out: torch.Tensor, x_t: torch.Tensor,
              t, prev_t) -> torch.Tensor:
    """DDIM step, eta=0 (deterministic)."""
    x0, eps = pred_to_x0_eps(sched, model_out, x_t, t)
    acp_prev = _bcast(_acp_prev_raw(sched, prev_t), x_t.ndim)
    return torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps


@dataclass(frozen=True)
class DPMState:
    """Carried from one DPM-Solver++ step to the next."""

    prev_x0: torch.Tensor      # x0 prediction at the previous step
    prev_lambda: torch.Tensor
    step_index: torch.Tensor   # 0 at the first step (first-order bootstrap)


def _lambda_of(sched: NoiseSchedule, t) -> torch.Tensor:
    t = _idx(t, sched.alphas_cumprod.device)
    acp = sched.alphas_cumprod[torch.clamp(t, min=0)]
    acp = torch.where(t >= 0, acp, torch.full_like(acp, 1.0 - 1e-8))
    alpha = torch.sqrt(acp)
    sigma = torch.sqrt(1.0 - acp)
    return torch.log(alpha) - torch.log(torch.clamp(sigma, min=1e-20))


def dpmpp_2m_step(sched: NoiseSchedule, model_out: torch.Tensor, x_t: torch.Tensor,
                  t, prev_t, state: DPMState,
                  force_first_order: bool | torch.Tensor = False
                  ) -> tuple[torch.Tensor, DPMState]:
    """One DPM-Solver++(2M) update x_t -> x_{prev_t}.

    The first call (state.step_index == 0) takes the first-order update;
    later calls use the 2nd-order multistep correction. ``force_first_order``
    mirrors diffusers' ``lower_order_final``."""
    nd = x_t.ndim
    x0, _eps = pred_to_x0_eps(sched, model_out, x_t, t)

    lam_t = _lambda_of(sched, t)
    lam_s = _lambda_of(sched, prev_t)
    h = lam_s - lam_t

    acp_s = _acp_prev_raw(sched, prev_t)
    alpha_s = torch.sqrt(acp_s)
    sigma_s = torch.sqrt(1.0 - acp_s)
    acp_t = sched.alphas_cumprod[_idx(t, sched.alphas_cumprod.device)]
    sigma_t = torch.sqrt(1.0 - acp_t)

    ratio = _bcast(sigma_s / torch.clamp(sigma_t, min=1e-20), nd)
    phi = _bcast(torch.expm1(-h), nd)

    # 2nd-order combination of current and previous x0 predictions
    h_last = lam_t - state.prev_lambda
    r = h_last / torch.where(h == 0, torch.full_like(h, 1e-20), h)
    inv2r = _bcast(1.0 / (2.0 * torch.clamp(r, min=1e-20)), nd)
    use_second = torch.logical_and(
        state.step_index > 0,
        torch.logical_not(torch.as_tensor(force_first_order, device=x_t.device)))
    d = torch.where(use_second, (1.0 + inv2r) * x0 - inv2r * state.prev_x0, x0)

    x_prev = ratio * x_t - _bcast(alpha_s, nd) * phi * d
    new_state = DPMState(prev_x0=x0,
                         prev_lambda=torch.broadcast_to(lam_t, state.prev_lambda.shape),
                         step_index=state.step_index + 1)
    return x_prev, new_state


def dpm_init_state(shape: tuple[int, ...], dtype=torch.float32,
                   batch_shape: tuple[int, ...] = (),
                   device: str | torch.device = "cpu") -> DPMState:
    """batch_shape must match t's shape when stepping with batched timesteps."""
    return DPMState(prev_x0=torch.zeros(shape, dtype=dtype, device=device),
                    prev_lambda=torch.zeros(batch_shape, device=device),
                    step_index=torch.zeros((), dtype=torch.int32, device=device))
