"""Profiling and MFU telemetry: counterpart of ``dcr_tpu/utils/profiling.py``.

- :func:`trace` captures a region with ``torch.profiler`` (CPU and, on a
  card, CUDA activity) and writes a Chrome trace under ``logdir``.
- :func:`arm` / :func:`capture` / :func:`status`: on-demand profiling of
  the next K hot regions of a long-lived process. Serve arms it through
  ``POST /debug/profile`` and wraps each ``serve/device_step`` in
  :func:`capture`; the trainer arms it at ``DCR_PROFILE_AT_STEP`` for
  ``DCR_PROFILE_STEPS`` steps. Unarmed, :func:`capture` is two attribute
  reads. A profiler failure disarms into ``status()["error"]`` and never
  fails the region it wraps.
- :func:`chip_peak_tflops`: dense data-sheet peaks of the card (H100 SXM at
  700 W: 989 TFLOP/s bf16 on the tensor cores; f32-accurate work as split
  TF32, 495 / 3), None where the card is not in the table or there is none.
- :func:`train_step_flops`: the FLOPs of one train step, counted once on
  meta tensors (no device work, no launches) with
  ``torch.utils.flop_counter.FlopCounterMode``. That counter cannot see the
  flash kernels, which launch through ctypes, so their FLOPs are added by
  the convention the kernel table uses: per (batch, head), 4 Sq·Sk·D for
  the forward (B1), 6 for dQ (B2) and 8 for dK/dV (B3), the recomputed
  scores and dP included (:data:`FLASH_FLOPS`).
- :class:`StepTimer`: step time, items/s and MFU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

# dense peak TFLOP/s by card (the data sheet's H100 SXM at 700 W)
PEAK_TFLOPS = {"h100": {"bf16": 989.0, "f32": 495.0 / 3}}

#: flash-attention FLOPs per (batch, head), in units of Sq * Sk * D
FLASH_FLOPS = {"fwd": 4, "dq": 6, "dkv": 8}


def chip_peak_tflops(dtype: str = "bf16") -> Optional[float]:
    """The card's dense peak for ``dtype`` ("bf16" or "f32"), None when no
    card is present or it is not in :data:`PEAK_TFLOPS`."""
    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(torch.cuda.current_device()).lower()
    for name, peaks in PEAK_TFLOPS.items():
        if name in kind:
            return peaks[dtype]
    return None


def _profile_activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_path(logdir: str | Path) -> Path:
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    return logdir / f"trace_{os.getpid()}_{time.time_ns()}.json"


@contextlib.contextmanager
def trace(logdir: str | Path):
    """``torch.profiler`` around a region; the Chrome trace (Perfetto,
    chrome://tracing) lands under ``logdir``."""
    with torch.profiler.profile(activities=_profile_activities()) as prof:
        yield prof
    prof.export_chrome_trace(str(_trace_path(logdir)))


class _ProfileArmer:
    """Arm once, capture the next K regions: the profiler starts at the
    first armed region and stops after the K-th, writing one Chrome trace
    (``status()["artifact"]``) under the armed ``logdir``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._logdir: Optional[str] = None
        self._remaining = 0
        self._active = False
        self._prof = None
        self._artifact: Optional[str] = None
        self._error: Optional[str] = None

    def arm(self, logdir: str, steps: int = 1) -> dict:
        if steps < 1:
            raise ValueError(f"profile steps must be >= 1, got {steps}")
        with self._lock:
            if self._remaining or self._active:
                raise RuntimeError(f"profiler already armed ({self._remaining} step(s) "
                                   f"remaining into {self._logdir})")
            self._logdir = str(logdir)
            self._remaining = int(steps)
            self._artifact = None
            self._error = None
        return self.status()

    def status(self) -> dict:
        with self._lock:
            return {"armed": bool(self._remaining or self._active),
                    "remaining": self._remaining, "logdir": self._logdir,
                    "artifact": self._artifact, "error": self._error}

    @contextlib.contextmanager
    def capture(self):
        if not self._remaining and not self._active:   # unarmed
            yield
            return
        start = False
        with self._lock:
            if self._remaining > 0 and not self._active:
                self._active = True
                start = True
            logdir = self._logdir
        if start:
            try:
                prof = torch.profiler.profile(activities=_profile_activities())
                prof.start()
                self._prof = prof
            except Exception as e:      # a profiler failure must not fail the region
                with self._lock:
                    self._active = False
                    self._remaining = 0
                    self._error = repr(e)
                yield
                return
        try:
            yield
        finally:
            stop = False
            with self._lock:
                if self._active and self._remaining > 0:
                    self._remaining -= 1
                    stop = self._remaining == 0
            if stop:
                self._finish(logdir)

    def _finish(self, logdir: str) -> None:
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            path = _trace_path(logdir)
            prof.export_chrome_trace(str(path))
            with self._lock:
                self._active = False
                self._artifact = str(path)
        except Exception as e:
            with self._lock:
                self._active = False
                self._error = repr(e)


_armer = _ProfileArmer()


def arm(logdir: str, steps: int = 1) -> dict:
    """Arm the process-wide profiler for the next ``steps`` captured regions."""
    return _armer.arm(logdir, steps)


def status() -> dict:
    return _armer.status()


def capture():
    """The context every profileable hot region enters; a no-op unless armed."""
    return _armer.capture()


# ---------------------------------------------------------------------------
# FLOP counting
# ---------------------------------------------------------------------------

def flash_flops(b: int, sq: int, sk: int, h: int, d: int, *, backward: bool) -> int:
    """FLOPs of one flash attention by the kernel table's convention: the
    forward, or the dQ and dK/dV kernels together."""
    per = FLASH_FLOPS["dq"] + FLASH_FLOPS["dkv"] if backward else FLASH_FLOPS["fwd"]
    return per * b * h * sq * sk * d


class _FlashShapes(torch.autograd.Function):
    """Stands in for ``FlashAttention`` while counting: outputs of the right
    shape, no kernel, each call's FLOPs recorded by convention."""

    @staticmethod
    def forward(ctx, q, k, v, record):
        b, sq, h, d = q.shape
        ctx.shape, ctx.record = (b, sq, k.shape[1], h, d), record
        record.append(flash_flops(*ctx.shape, backward=False))
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, do):
        ctx.record.append(flash_flops(*ctx.shape, backward=True))
        return torch.empty_like(do), torch.empty_like(do), torch.empty_like(do), None


@contextlib.contextmanager
def _flash_counted(record: list):
    from dcr_tpu_torch.ops import flash_attention as fa

    real = fa.flash_attention
    fa.flash_attention = lambda q, k, v: _FlashShapes.apply(q, k, v, record)
    try:
        yield
    finally:
        fa.flash_attention = real


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of ``fn(*args, **kwargs)``: FlopCounterMode's count (matmuls,
    convolutions, library attention) plus the flash kernels' by
    :data:`FLASH_FLOPS`. Runs ``fn`` once; give it meta tensors to count
    without device work."""
    from torch.utils.flop_counter import FlopCounterMode

    record: list[int] = []
    with _flash_counted(record), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops()) + sum(record)


_step_flops_cache: dict = {}
_meta_models: dict = {}


def _meta_bundle(mc):
    """The model bundle of ModelConfig ``mc`` on the meta device (no memory,
    no init work kept), built once per configuration."""
    from dcr_tpu_torch.diffusion import train as T
    from dcr_tpu_torch.models import schedulers as S
    from dcr_tpu_torch.models.clip_text import CLIPTextModel
    from dcr_tpu_torch.models.unet2d import UNet2DCondition
    from dcr_tpu_torch.models.vae import AutoencoderKL

    key = repr(mc)
    if key not in _meta_models:
        meta = torch.device("meta")
        with torch.device(meta):
            _meta_models[key] = T.DiffusionModels(
                unet=UNet2DCondition(mc), vae=AutoencoderKL(mc),
                text_encoder=CLIPTextModel(mc),
                schedule=S.make_schedule(num_train_timesteps=mc.num_train_timesteps,
                                         beta_schedule=mc.beta_schedule,
                                         beta_start=mc.beta_start, beta_end=mc.beta_end,
                                         prediction_type=mc.prediction_type, device=meta))
    return _meta_models[key]


@contextlib.contextmanager
def _without_optimizer():
    """The optimizer's update skipped while counting: it is elementwise work,
    which FlopCounterMode counts as none, and the slowest part of a step on
    meta tensors."""
    from dcr_tpu_torch.diffusion import train as T

    update = T.Optimizer.update
    T.Optimizer.update = lambda self, grads, opt, trainable, **kw: True
    try:
        yield
    finally:
        T.Optimizer.update = update


def train_step_flops(cfg, *, hot_only: bool = False) -> int:
    """FLOPs of one train step of ``cfg`` (a TrainConfig), counted once per
    configuration on meta tensors: the fused step (VAE encode, text encode,
    UNet forward and backward), or with ``hot_only`` the pipelined
    denoiser's step alone (the frozen encoders run on the producer)."""
    from dcr_tpu_torch.diffusion import encode_stage as E
    from dcr_tpu_torch.diffusion import train as T
    from dcr_tpu_torch.models.vae import vae_scale_factor

    key = (repr(cfg.model), cfg.train_batch_size, cfg.data.resolution, cfg.mixed_precision,
           cfg.remat, cfg.train_text_encoder, cfg.rand_noise_lam, cfg.mixup_noise_lam,
           hot_only)
    if key in _step_flops_cache:
        return _step_flops_cache[key]
    # the optimizer's elementwise work counts no FLOPs: over plain AdamW,
    # without accumulation or EMA, and its update skipped
    cfg = dataclasses.replace(cfg, ema_decay=0.0, optim=dataclasses.replace(
        cfg.optim, use_8bit_adam=False, gradient_accumulation_steps=1))
    mc, meta = cfg.model, torch.device("meta")
    models = _meta_bundle(mc)
    params = {n: dict(m.named_parameters()) for n, m in
              (("unet", models.unet), ("text", models.text_encoder), ("vae", models.vae))}
    state = T.init_train_state(cfg, models, unet_params=params["unet"],
                               text_params=params["text"], vae_params=params["vae"])
    bsz, res, ctx_len = cfg.train_batch_size, cfg.data.resolution, mc.text_max_length
    lat = res // vae_scale_factor(models.vae.config)
    latent = (bsz, mc.vae_latent_channels, lat, lat)
    draws = {"vae_sample": torch.empty(latent, device=meta),
             "noise": torch.empty(latent, device=meta),
             "timesteps": torch.zeros(bsz, dtype=torch.long, device=meta),
             "emb_noise": torch.empty((bsz, ctx_len, mc.text_hidden_size), device=meta),
             "mixup_beta": torch.empty((), device=meta),
             "mixup_perm": torch.zeros(bsz, dtype=torch.long, device=meta)}
    ids = torch.zeros((bsz, ctx_len), dtype=torch.long, device=meta)
    if hot_only:
        hot, _ = E.split_state(state, cfg.train_text_encoder)
        enc = {"latents": draws["noise"]}
        if cfg.train_text_encoder:
            enc["input_ids"] = ids
        else:
            enc["ctx"] = torch.empty((bsz, ctx_len, mc.text_hidden_size), device=meta)
        with _without_optimizer():
            flops = count_flops(E.make_denoise_step(cfg, models), hot, enc, draws)
    else:
        batch = {"pixel_values": torch.empty((bsz, res, res, 3), device=meta),
                 "input_ids": ids}
        with _without_optimizer():
            flops = count_flops(T.make_train_step(cfg, models), state, batch, draws)
    _step_flops_cache[key] = flops
    return flops


@dataclass
class StepTimer:
    """Steady-state step time, items/s and MFU. ``flops_per_step`` is one
    step's FLOPs on the one device; ``peak_tflops`` the device's peak for
    the step's compute dtype (MFU is left out without it)."""

    flops_per_step: Optional[float] = None
    peak_tflops: Optional[float] = None
    _t0: float = field(default_factory=time.perf_counter)
    _steps: int = 0
    _items: int = 0

    def tick(self, items: int = 0) -> None:
        self._steps += 1
        self._items += items

    def report(self, reset: bool = True) -> dict:
        dt = time.perf_counter() - self._t0
        steps = max(self._steps, 1)
        out = {"step_time_ms": 1e3 * dt / steps,
               "steps_per_sec": steps / dt if dt > 0 else float("inf")}
        if self._items:
            out["items_per_sec"] = self._items / dt
        if self.flops_per_step:
            achieved = self.flops_per_step * steps / dt / 1e12
            out["tflops_per_sec"] = achieved
            if self.peak_tflops:
                out["mfu"] = achieved / self.peak_tflops
        if reset:
            self._t0 = time.perf_counter()
            self._steps = self._items = 0
        return out
