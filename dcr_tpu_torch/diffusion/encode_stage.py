"""Pipelined training: the frozen-encoder producer and the denoiser hot step.

Counterpart of ``dcr_tpu/diffusion/encode_stage.py``. The fused train step
(``diffusion/train.py``) pays the frozen VAE encode and, with a frozen text
encoder, the text encode inside every step. This module splits it in two:

- :func:`make_encode_stage`, the producer: VAE encode + frozen text encode,
  run by :class:`EncodeProducer` on a background thread up to
  ``pipe.depth`` steps ahead of the trainer through a bounded ring;
- :func:`make_denoise_step`, the consumer: the fused step's own q-sample ->
  loss -> grad -> clip/AdamW -> EMA body (``train.make_update``) over a
  :class:`HotState` (step, unet, optimizer, EMA), the frozen params never
  entering it;
- :func:`make_cache_stage`, the latent cache's producer: the latent sample
  rebuilt from precomputed posterior moments and text embeddings
  (``data/latent_cache.py``), the encoders never run.

Draw streams have one owner each, so the draws of step N are the fused
step's: the producer draws ``vae_sample`` (keyed on the step it encodes
for), the denoiser the rest (keyed on ``hot.step``, as the fused step keys
them on ``state.step``). The pipelined-off trainer builds only the fused
step.

On a CUDA device the producer runs its stage on a side stream of its own:
the consumer's stream waits on an event recorded after the encode, and the
encoded tensors are marked as used by the consumer's stream
(``record_stream``), so the caching allocator does not hand their memory
back to the producer before the step that reads them has run.

Telemetry, as the JAX producer's: ``train/data_wait`` and ``train/encode``
spans on the producer thread (the encode's with ``obs/memwatch.span_hbm``'s
attrs), the consumer's ``train/encode_wait`` span inside
:meth:`EncodeProducer.get` (the pipeline bubble ``tools/trace_report.py``'s
Pipeline section reports), and the ``data/queue_depth`` gauge on every ring
transition. :attr:`EncodeProducer.wait_s` keeps the consumer's seconds
blocked on the ring per step.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.config import TrainConfig
from dcr_tpu_torch.diffusion import train as T
from dcr_tpu_torch.obs import memwatch

#: streams drawn by the producer stage; the denoiser owns the rest. Together
#: they are train.DRAW_STREAMS (a test holds it), so a new stream needs an
#: owner before it can ship
PRODUCER_STREAMS = ("vae_sample",)
DENOISER_STREAMS = ("noise", "timesteps", "emb_noise", "mixup_beta", "mixup_perm")


@dataclass
class HotState:
    """The denoiser's state: everything the optimizer touches, nothing
    frozen. Its dicts are the train state's own (the modules' parameters),
    so the producer encodes with the frozen tensors while the consumer
    updates these in place."""

    step: int
    unet_params: T.Params
    opt_state: T.OptState
    text_params: Optional[T.Params] = None     # present iff train_text_encoder
    ema_params: Optional[T.Params] = None


def split_state(state: T.TrainState, train_text_encoder: bool) -> tuple[HotState, dict]:
    """TrainState -> (HotState, frozen ``{"vae", "text"}``): views, no copies."""
    hot = HotState(step=state.step, unet_params=state.unet_params,
                   opt_state=state.opt_state,
                   text_params=state.text_params if train_text_encoder else None,
                   ema_params=state.ema_params)
    frozen = {"vae": state.vae_params,
              "text": None if train_text_encoder else state.text_params}
    return hot, frozen


def merge_state(hot: HotState, frozen: dict, train_text_encoder: bool) -> T.TrainState:
    """(HotState, frozen) -> TrainState, the checkpoint and export view."""
    return T.TrainState(
        step=hot.step, unet_params=hot.unet_params,
        text_params=hot.text_params if train_text_encoder else frozen["text"],
        vae_params=frozen["vae"], opt_state=hot.opt_state, ema_params=hot.ema_params)


@compile_surface("train/encode")
def make_encode_stage(cfg: TrainConfig, models: T.DiffusionModels, *,
                      emit: str = "latents") -> Callable:
    """The producer: ``(frozen, batch, step, draws=None) -> enc``.

    ``emit="latents"`` (training) draws the posterior sample with the
    ``vae_sample`` stream at ``step``, the fused step's draw at that step,
    and gives ``latents`` [B, C, h, w] f32. ``emit="moments"`` (the
    precompute) gives the posterior ``mean`` and ``std`` instead, f32 and
    NCHW: the sample stays a draw of each occurrence, so one cache serves
    every epoch and duplication regime. ``enc`` carries ``ctx`` (the frozen
    text embedding, f32 as the text encoder gives it) with a frozen text
    encoder, else the
    batch's ``input_ids`` for the denoiser to encode with the trained
    params; ``index`` is the batch's dataset indices (numpy).
    """
    if emit not in ("latents", "moments"):
        raise ValueError(f"emit must be 'latents' or 'moments', got {emit!r}")
    vae_encode = T.make_vae_encode(cfg, models)
    text_encode = T.make_text_encode(cfg, models)
    scaling = models.vae.config.vae_scaling_factor

    @torch.no_grad()
    def encode_fn(frozen: dict, batch: dict, step: int,
                  draws: Optional[dict] = None) -> dict:
        device = next(iter(frozen["vae"].values())).device
        pixels, input_ids = T.pixels_and_ids(batch, device)
        post = vae_encode(frozen["vae"], pixels)
        std = T.posterior_std(post.logvar)
        enc: dict = {"index": np.asarray(batch["index"], np.int64)}
        if emit == "moments":
            enc["mean"], enc["std"] = post.mean.float(), std.float()
        else:
            draw = T.draw_fn(cfg.seed, step, device, draws)
            enc["latents"] = T.sample_latents(post.mean, std, draw, scaling)
        if cfg.train_text_encoder:
            enc["input_ids"] = input_ids
        else:
            enc["ctx"] = text_encode(frozen["text"], input_ids)
        return enc

    return encode_fn


@compile_surface("train/encode_cached")
def make_cache_stage(cfg: TrainConfig, models: T.DiffusionModels) -> Callable:
    """The latent cache's producer: ``(moments, step) -> enc``.

    ``moments`` holds the cache's rows as the reader gives them: ``mean``
    and ``std`` [B, h, w, C] f32 (the JAX package's layout on disk), ``ctx``
    [B, L, D] f32 and ``index``. The sample is the fused step's arithmetic,
    ``(mean + std * eps) * scaling`` in f32 with ``eps`` the f32
    ``vae_sample`` draw at ``step``: over the same moments the latents are
    the live stage's bit for bit (f32 copies of bf16 moments are exact).
    ``ctx`` is the stored f32 embedding, the text encoder's own output.
    """
    if cfg.train_text_encoder:
        raise ValueError("latent-cache training requires a frozen text encoder "
                         "(validate_pipe_config enforces this)")
    scaling = models.vae.config.vae_scaling_factor
    device = next(models.unet.parameters()).device

    @torch.no_grad()
    def cache_fn(moments: dict, step: int) -> dict:
        def nchw(x) -> torch.Tensor:
            t = torch.as_tensor(x, dtype=torch.float32).to(device)
            return t.permute(0, 3, 1, 2).contiguous()

        draw = T.draw_fn(cfg.seed, step, device, None)
        latents = T.sample_latents(nchw(moments["mean"]), nchw(moments["std"]), draw,
                                   scaling)
        ctx = torch.as_tensor(moments["ctx"], dtype=torch.float32).to(device)
        return {"latents": latents, "ctx": ctx,
                "index": np.asarray(moments["index"], np.int64)}

    return cache_fn


@compile_surface("train/denoise")
def make_denoise_step(cfg: TrainConfig, models: T.DiffusionModels) -> Callable:
    """The hot step: ``(hot, enc, draws=None) -> (hot, metrics)``.

    The fused step minus the frozen encoders, through the same body
    (``train.make_update``): the q-sample and mitigation draws key on
    ``hot.step`` through the fused step's streams, so step N's draws are the
    same. ``draws`` as the fused step takes them (``vae_sample`` is the
    producer's). The hot state is updated in place and returned.
    """
    update = T.make_update(cfg, models)
    text_encode = T.make_text_encode(cfg, models)

    def step_fn(hot: HotState, enc: dict, draws: Optional[dict] = None):
        latents = enc["latents"]
        draw = T.draw_fn(cfg.seed, hot.step, latents.device, draws)

        def ctx_of(trainable: dict) -> torch.Tensor:
            if cfg.train_text_encoder:
                return text_encode(trainable["text_encoder"], enc["input_ids"])
            return enc["ctx"]

        return update(hot, latents, ctx_of, draw)

    return step_fn


# ---------------------------------------------------------------------------
# The producer ring
# ---------------------------------------------------------------------------

class EncodeProducer:
    """Bounded producer ring: host batches -> encode -> the trainer.

    One thread pulls batches from ``source`` (a loader epoch), runs
    ``encode(batch, step)`` (the live stage or the cache stage) and parks
    the result in a queue of ``depth`` slots. :meth:`_safe_put` re-checks
    the stop flag, so teardown never leaves the thread blocked in ``put``;
    every producer-side error (encode failure, loader error,
    TooManyBadSamples) re-raises on the consumer's next :meth:`get`.

    ``device``: on a CUDA device the encode runs on a side stream; the
    consumer's stream waits on its event in :meth:`get`, and every tensor
    handed over is recorded on the consumer's stream.
    """

    _DONE = object()

    def __init__(self, source: Iterator, encode: Callable[[Any, int], Any], *,
                 depth: int, start_step: int, device: Optional[torch.device] = None):
        self._source = source
        self._encode = encode
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._start_step = start_step
        self._gauge = tracing.registry().gauge("data/queue_depth")
        cuda = device is not None and torch.device(device).type == "cuda"
        self._stream = torch.cuda.Stream(device) if cuda else None
        if self._stream is not None:
            # the frozen params' last writes (build, restore) come first
            self._stream.wait_stream(torch.cuda.current_stream(device))
        # held over each encode: paused() keeps the thread between batches
        self._lock = threading.Lock()
        #: the consumer's seconds blocked in get(), one entry per call
        self.wait_s: list[float] = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="encode-producer")
        self._thread.start()

    def _safe_put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                self._gauge.set(float(self._q.qsize()))
                return True
            except queue.Full:
                continue
        return False

    def _encode_one(self, batch, step: int):
        if self._stream is None:
            return self._encode(batch, step), None
        with torch.cuda.stream(self._stream):
            enc = self._encode(batch, step)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return enc, ready

    def _run(self) -> None:
        step = self._start_step
        try:
            while not self._stop.is_set():
                with tracing.span("train/data_wait", step=step):
                    batch = next(self._source, None)
                if batch is None:
                    break
                with self._lock, tracing.span("train/encode", step=step) as sp, \
                        memwatch.span_hbm(sp):
                    enc, ready = self._encode_one(batch, step)
                if not self._safe_put((step, enc, ready, None)):
                    return
                step += 1
        except BaseException as e:  # loader and encode errors reach the consumer
            self._safe_put((step, None, None, e))
            return
        self._safe_put((step, self._DONE, None, None))

    def get(self, step: int):
        """The encoded batch for ``step`` (producer and consumer advance in
        lockstep), or None at the epoch's end. Producer errors re-raise
        here, on the train thread."""
        start = time.perf_counter()
        with tracing.span("train/encode_wait", step=step):
            got_step, enc, ready, err = self._q.get()
        self.wait_s.append(time.perf_counter() - start)
        self._gauge.set(float(self._q.qsize()))
        if err is not None:
            raise err
        if enc is self._DONE:
            return None
        if got_step != step:
            raise RuntimeError(f"encode ring out of order: got step {got_step}, "
                               f"expected {step}")
        if ready is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(ready)
            for t in enc.values():
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(consumer)
        return enc

    def paused(self) -> threading.Lock:
        """Context manager that holds the thread between two batches. The
        stages run the frozen modules through ``functional_call``, which
        swaps their parameters for the call: another user of those modules
        on the train thread (the sample hook) runs inside ``paused()``."""
        return self._lock

    def stop(self) -> None:
        """Tear down on every exit path (epoch end, preemption, NaN abort,
        errors): set stop, drain the ring until the thread has exited. The
        thread is joined before returning, so the caller may then close the
        source generator."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


def live_encode(encode_fn: Callable, frozen: dict) -> Callable[[Any, int], Any]:
    """Producer callable running the live encode stage on each batch."""
    return lambda batch, step: encode_fn(frozen, batch, step)


def cached_encode(cache_fn: Callable, reader, fallback: Callable[[Any, int], Any]
                  ) -> Callable[[Any, int], Any]:
    """Producer callable serving a verified latent cache.

    A batch whose every index is cached goes through the cache stage (the
    encoders never run). A batch touching any missing index (a quarantined
    shard, an index the precompute never covered) is encoded live through
    ``fallback``, the whole batch, and counts
    ``latentcache/batch_recompute``."""
    def encode(batch, step: int):
        idx = np.asarray(batch["index"])
        rows = reader.lookup(idx)
        if rows is None:
            R.bump_counter("latentcache/batch_recompute")
            R.log_event("latent_cache_batch_recompute", step=int(step),
                        indices=[int(i) for i in idx[:8]])
            return fallback(batch, step)
        mean, std, ctx = rows
        return cache_fn({"mean": mean, "std": std, "ctx": ctx, "index": idx}, step)

    return encode
