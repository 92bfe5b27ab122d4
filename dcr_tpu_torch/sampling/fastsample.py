"""Training-free fast sampling: score reuse on a static plan of steps.

Counterpart of ``dcr_tpu/sampling/fastsample.py`` (PFDiff, arXiv:2408.08822:
a diffusion ODE solver's score changes slowly along the trajectory, so a
past score can stand in for the current one). A host-computed plan marks
each step ``full`` or ``reuse``:

- a full step runs the CFG UNet call and banks the guided prediction and
  its timestep;
- a reuse step launches no UNet: it takes the banked score (order 1), or
  extrapolates from the last two, ``e(t) = e_last + (e_last - e_prev) *
  (t - t_last) / (t_last - t_prev)``, once two are banked (order 2).

The solver update runs on every step with whichever prediction it got, so
dpm++'s multistep state advances through reuse steps as through full ones.
The JAX package selects the branch with ``lax.cond`` inside its scan; the
port's eager loop uses a plain ``if``. A dense plan (fast disabled, or a
ratio that skips nothing) builds the sampler's original loop, so the
disabled path is the plain sampler bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: the largest reuse fraction a plan accepts
MAX_REUSE_RATIO = 0.75

#: leading steps that always run full: step 0 has nothing banked, step 1
#: banks the second score so second-order reuse is live from the first
#: reuse step
_FULL_HEAD = 2


def fast_plan(num_steps: int, reuse_ratio: float) -> tuple[bool, ...]:
    """Per-step plan, ``True`` = full UNet call, ``False`` = score reuse.

    The first two steps and the final step are full; ``round(reuse_ratio *
    num_steps)`` reuse steps, capped by the eligible interior, are spread
    evenly over it; ``reuse_ratio <= 0`` or fewer than 4 steps give an
    all-full plan."""
    if not 0.0 <= reuse_ratio <= MAX_REUSE_RATIO:
        raise ValueError(f"reuse_ratio must be in [0, {MAX_REUSE_RATIO}], got {reuse_ratio}")
    plan = [True] * num_steps
    eligible = list(range(_FULL_HEAD, num_steps - 1))
    n_reuse = min(int(round(reuse_ratio * num_steps)), len(eligible))
    if reuse_ratio <= 0.0 or n_reuse <= 0:
        return tuple(plan)
    m = len(eligible)
    # floor((i + 0.5) * m / n) is strictly increasing for n <= m
    for i in range(n_reuse):
        plan[eligible[int((i + 0.5) * m // n_reuse)]] = False
    return tuple(plan)


def unet_calls(plan: tuple[bool, ...]) -> int:
    """Full (UNet-calling) steps in a plan."""
    return sum(1 for full in plan if full)


def is_dense(plan: tuple[bool, ...]) -> bool:
    """True when the plan skips nothing."""
    return all(plan)


def canonical_plan_params(steps: int, fast_ratio: float,
                          fast_order: int) -> tuple[float, int]:
    """``(fast_ratio, fast_order)`` with every parameterization whose plan
    is dense mapped onto ``(0.0, 2)``; invalid values pass through so that
    validation still rejects them."""
    if (fast_order in (1, 2) and 0.0 <= fast_ratio <= MAX_REUSE_RATIO
            and is_dense(fast_plan(steps, fast_ratio))):
        return 0.0, 2
    return fast_ratio, fast_order


class ScoreBank(NamedTuple):
    """The last two banked guided predictions, their timesteps (f32) and how
    many scores were ever banked."""

    pred: torch.Tensor
    prev_pred: torch.Tensor
    t: torch.Tensor
    prev_t: torch.Tensor
    count: int


def bank_init(shape: tuple[int, ...], device: str | torch.device = "cpu",
              dtype: torch.dtype = torch.float32) -> ScoreBank:
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    t0 = torch.zeros((), dtype=torch.float32, device=device)
    return ScoreBank(pred=zeros, prev_pred=zeros, t=t0, prev_t=t0, count=0)


def bank_update(bank: ScoreBank, pred: torch.Tensor, t) -> ScoreBank:
    """Push a freshly computed prediction (a full step just ran)."""
    return ScoreBank(pred=pred, prev_pred=bank.pred,
                     t=torch.as_tensor(t, dtype=torch.float32, device=pred.device),
                     prev_t=bank.t, count=bank.count + 1)


def reuse_score(bank: ScoreBank, t, order: int) -> torch.Tensor:
    """The stand-in prediction for a reuse step at timestep ``t``: the last
    banked score (order 1, or a single score banked), else its linear
    extrapolation through the one before it (order 2)."""
    if order < 2 or bank.count < 2:
        return bank.pred
    dt = bank.t - bank.prev_t
    slope = (bank.pred - bank.prev_pred) / torch.where(dt == 0.0, torch.ones_like(dt), dt)
    t = torch.as_tensor(t, dtype=torch.float32, device=bank.pred.device)
    return bank.pred + slope * (t - bank.t)
