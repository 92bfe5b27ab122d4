"""The diffusion finetuning train step and its state.

Counterpart of ``dcr_tpu/diffusion/train.py``. One eager function computes
vae-encode -> q-sample -> text-encode (+ embedding mitigations) -> unet ->
mse(eps|v) -> clip -> AdamW, in the JAX step's order (reference
diff_train.py:613-666). Everything after the VAE's sample is
:func:`make_update`, the body the pipelined denoiser step
(``diffusion/encode_stage.py``) shares. Train-time mitigations
(arXiv:2305.20086):

- ``rand_noise_lam``: Gaussian noise added to the text embeddings;
- ``mixup_noise_lam``: Beta(lambda, 1)-weighted mixup of the text embeddings
  across the batch with a random permutation.

The optimizer is written out rather than taken from ``torch.optim``, so that
it is the JAX package's optax chain step for step: global-norm clipping by
``g * max_norm / g_norm`` (no epsilon), AdamW that decays every parameter,
the learning-rate schedule indexed by the optimizer-update count (the first
update uses ``schedule(0)``), and ``optax.MultiSteps``' running mean of the
gradients when ``gradient_accumulation_steps > 1``. ``optim.use_8bit_adam``
swaps AdamW for the JAX package's ``adamw8bit`` (``core/adam8bit.py``):
8-bit moments per block of 256 for every tensor of at least 4,096
elements, updated one tensor at a time.

Parameters are dicts of f32 master tensors under the port's state-dict
names (the modules' own parameters in the trainer). Under
``mixed_precision="bf16"`` they are cast to bf16 for the forward with
``.to()``, so the gradient flows back to the f32 masters, and the modules
then compute in bf16. Device draws come from per-step ``torch.Generator``s
of :func:`dcr_tpu_torch.core.rng.stream_generator`; the ``draws`` argument
hands them in as tensors instead (the parity tests inject the JAX step's).

On a mesh of several processes (``parallel/mesh.py``) the step is the JAX
package's global-batch step. Each rank holds its data index's rows of the
global batch. Every draw is made for the global batch from the one seeded
stream, and the rank takes its rows; the mixup mitigation mixes across the
global batch through ``mesh.gather_rows``. The optimizer takes one mean
all-reduce of the flat gradients over the world per update, in buckets,
after ``MultiSteps``' accumulation and before the clip, so the clip sees the
global norm as optax does (the seq replicas of a data group hold equal
gradients, so the world's mean is the data groups' mean). The logged loss
is the global mean. With gradient accumulation on several ranks,
``grad_norm`` is the rank's own micro-batch gradient's norm (the JAX step
logs the global micro-batch's); without it, the global norm.

On a mesh with ``fsdp`` or ``tensor`` above 1 the state is sharded
(:func:`init_train_state` given the mesh, ``parallel/sharded.py``): the rows split over
``data`` x ``fsdp``; each rank holds its shards of the parameters, the
Adam moments and the EMA, and updates them; the FSDP modules gather their
weights per call (cast to the compute dtype first). Each gradient is
reduced over the axes its parameter is replicated on (an FSDP shard's
already summed over ``fsdp`` by its gather's backward), never over
``tensor``; the clip's global norm sums the shards' squares.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from dcr_tpu_torch.core import adam8bit as A8
from dcr_tpu_torch.core import rng as rngmod
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.config import OptimConfig, TrainConfig
from dcr_tpu_torch.core.precision import policy_from_string
from dcr_tpu_torch.models import schedulers as S
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.parallel import sharded as SH
from dcr_tpu_torch.sampling.sampler import DiffusionModels  # noqa: F401 (the bundle)

Params = dict[str, torch.Tensor]
# the per-step device draws, named as the JAX step's key streams
DRAW_STREAMS = ("vae_sample", "noise", "timesteps", "emb_noise", "mixup_beta", "mixup_perm")


@dataclass
class OptState:
    """optax's state for clip + AdamW (+ MultiSteps), flat over
    ``<group>/<param name>`` keys. ``count`` is AdamW's update count (it also
    indexes the schedule); ``mini_step`` and ``acc_grads`` are MultiSteps'.

    With ``optim.use_8bit_adam`` (``adamw8bit``'s state), every trainable
    tensor of at least ``adam8bit.MIN_QUANTIZE_SIZE`` elements keeps its
    moments in ``m8`` / ``v8`` instead: ``<key>/q`` the codes (int8 for m,
    uint8 for v, ``[n_blocks, 256]``) and ``<key>/scale`` the f32 block
    scales ``[n_blocks, 1]``; ``mu`` / ``nu`` then hold the smaller
    tensors' f32 moments only. ``m8`` is None without 8-bit Adam."""

    count: int
    mu: Params
    nu: Params
    mini_step: int = 0
    acc_grads: Optional[Params] = None
    m8: Optional[Params] = None
    v8: Optional[Params] = None


@dataclass
class TrainState:
    step: int                        # micro-step counter
    unet_params: Params
    text_params: Params              # trainable iff cfg.train_text_encoder
    vae_params: Params               # always frozen
    opt_state: OptState
    ema_params: Optional[Params] = None
    # the shards' placement on a sharded mesh (None: every tensor whole)
    layout: Optional[SH.Layout] = None


def trainable_of(state: TrainState, train_text_encoder: bool) -> dict[str, Params]:
    t = {"unet": state.unet_params}
    if train_text_encoder:
        t["text_encoder"] = state.text_params
    return t


def _flat(trainable: dict[str, Params]) -> Params:
    return {f"{group}/{name}": p for group, params in trainable.items()
            for name, p in params.items()}


def resolve_scale_lr(cfg: TrainConfig, data_parallel: int = 1) -> TrainConfig:
    """Fold scale_lr (lr x grad-accum x per-rank batch x data ranks: the
    global batch) into a new config with scale_lr cleared."""
    if not cfg.optim.scale_lr:
        return cfg
    new_optim = dataclasses.replace(
        cfg.optim, scale_lr=False,
        learning_rate=cfg.optim.learning_rate * cfg.optim.gradient_accumulation_steps
        * cfg.train_batch_size * data_parallel)
    return dataclasses.replace(cfg, optim=new_optim)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init

    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0."""
    def f(count: int) -> float:
        return init * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
    return f


def _join(first: Callable[[int], float], then: Callable[[int], float],
          boundary: int) -> Callable[[int], float]:
    """optax.join_schedules over two schedules."""
    return lambda count: first(count) if count < boundary else then(count - boundary)


def make_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """The reference's get_scheduler surface (diff_train.py:506-511), with
    optax's values: count -> learning rate."""
    lr, warmup = cfg.learning_rate, cfg.lr_warmup_steps
    if cfg.lr_scheduler == "constant":
        return lambda count: lr
    if cfg.lr_scheduler == "constant_with_warmup":
        return _join(_linear(0.0, lr, warmup), lambda count: lr, warmup)
    if cfg.lr_scheduler == "linear":
        return _join(_linear(0.0, lr, warmup), _linear(lr, 0.0, 10 ** 9), warmup)
    if cfg.lr_scheduler == "cosine":
        return _join(_linear(0.0, lr, warmup), _cosine(lr, 10 ** 6), warmup)
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares over every element, f32."""
    return torch.stack([t.float().pow(2).sum() for t in tensors]).sum().sqrt()


def _dict_norm(grads: Params) -> torch.Tensor:
    return global_norm(grads.values())


class Optimizer:
    """optax.chain(clip_by_global_norm, adamw) -- or, with
    ``use_8bit_adam``, the JAX package's ``adamw8bit`` -- wrapped in
    MultiSteps when accumulating; :meth:`update` applies the update to the
    params in place. Its ``reduce`` (the mean over the ranks, in place, of
    ``{key: gradient}``) runs on the gradients of each update, after the
    accumulation and before the clip, whose global norm is ``norm``'s."""

    def __init__(self, cfg: OptimConfig):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.accum = max(1, cfg.gradient_accumulation_steps)

    def init(self, trainable: dict[str, Params]) -> OptState:
        flat = _flat(trainable)
        zeros = lambda keys: {k: torch.zeros_like(flat[k], dtype=torch.float32)
                              for k in keys}
        small = [k for k, p in flat.items()
                 if not (self.cfg.use_8bit_adam and A8.is_quantized(p.numel()))]
        opt = OptState(count=0, mu=zeros(small), nu=zeros(small),
                       acc_grads=zeros(flat) if self.accum > 1 else None)
        if self.cfg.use_8bit_adam:
            opt.m8, opt.v8 = {}, {}
            for k, p in flat.items():
                if k in opt.mu:
                    continue
                for store, dtype in ((opt.m8, torch.int8), (opt.v8, torch.uint8)):
                    q = A8.zeros(p.numel(), dtype, p.device)
                    store[f"{k}/q"], store[f"{k}/scale"] = q.q, q.scale
        return opt

    @torch.no_grad()
    def update(self, grads: Params, opt: OptState, trainable: dict[str, Params], *,
               reduce: Optional[Callable[[Params], None]] = None,
               norm: Callable[[Params], torch.Tensor] = _dict_norm) -> bool:
        """One optimizer call on flat ``grads``; returns whether the params
        were updated (always, unless inside a gradient accumulation)."""
        if self.accum > 1:
            n = opt.mini_step
            for k, g in grads.items():                 # running mean, as MultiSteps
                acc = opt.acc_grads[k]
                acc.add_((g - acc) / (n + 1))
            if n < self.accum - 1:
                opt.mini_step = n + 1
                return False
            opt.mini_step = 0
            grads = opt.acc_grads
        if reduce is not None:
            reduce(grads)
        adamw = self._adamw8bit if opt.m8 is not None else self._adamw
        adamw(self._clip(grads, norm(grads)), opt, _flat(trainable))
        if self.accum > 1:
            for acc in opt.acc_grads.values():
                acc.zero_()
        return True

    def _clip(self, grads: Params, g_norm: torch.Tensor) -> Params:
        max_norm = self.cfg.max_grad_norm
        keep = g_norm < max_norm
        return {k: torch.where(keep, g, (g / g_norm) * max_norm) for k, g in grads.items()}

    def _adamw(self, grads: Params, opt: OptState, params: Params) -> None:
        c = self.cfg
        lr = self.schedule(opt.count)
        opt.count += 1
        bc1 = 1.0 - c.adam_beta1 ** opt.count
        bc2 = 1.0 - c.adam_beta2 ** opt.count
        for k, g in grads.items():
            mu, nu, p = opt.mu[k], opt.nu[k], params[k]
            mu.mul_(c.adam_beta1).add_(g, alpha=1.0 - c.adam_beta1)
            nu.mul_(c.adam_beta2).addcmul_(g, g, value=1.0 - c.adam_beta2)
            upd = (mu / bc1) / ((nu / bc2).sqrt_() + c.adam_epsilon)
            upd.add_(p, alpha=c.adam_weight_decay)
            p.add_(upd, alpha=-lr)

    def _adamw8bit(self, grads: Params, opt: OptState, params: Params) -> None:
        """``adamw8bit``: per tensor, dequantize (8-bit tensors), update the
        moments, take ``(m/c1)/(sqrt(v/c2)+eps)`` with the bias corrections
        in f32 as the JAX update takes them, requantize; then add ``wd * p``
        and scale by ``-lr``."""
        c = self.cfg
        lr = self.schedule(opt.count)
        opt.count += 1
        c1, c2 = A8.bias_corrections(c.adam_beta1, c.adam_beta2, opt.count)
        for k, g in grads.items():
            p = params[k]
            if k in opt.mu:
                m, v = opt.mu[k], opt.nu[k]
            else:
                m = A8.Quant8(opt.m8[f"{k}/q"], opt.m8[f"{k}/scale"])
                v = A8.Quant8(opt.v8[f"{k}/q"], opt.v8[f"{k}/scale"])
            upd, m_new, v_new = A8.update_leaf(g, m, v, b1=c.adam_beta1, b2=c.adam_beta2,
                                               eps=c.adam_epsilon, c1=c1, c2=c2)
            for old, new in ((m, m_new), (v, v_new)):
                if isinstance(old, A8.Quant8):
                    old.q.copy_(new.q)
                    old.scale.copy_(new.scale)
                else:
                    old.copy_(new)
            upd.add_(p, alpha=c.adam_weight_decay)
            p.add_(upd, alpha=-lr)


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    """AdamW with global-norm clipping and gradient accumulation (reference:
    AdamW diff_train.py:424-446, clip 657-663, accumulate 618)."""
    return Optimizer(cfg)


def world_reducer(mesh: Optional[pmesh.Mesh]) -> Optional[Callable[[Params], None]]:
    """The gradients' mean over the world when the mesh has a process group
    behind it (one rank too), else None."""
    import torch.distributed as tdist

    if mesh is None or not tdist.is_initialized():
        return None
    return lambda grads: pmesh.all_reduce_mean_(list(grads.values()))


def reducers(mesh: Optional[pmesh.Mesh], layout: Optional[SH.Layout]):
    """(reduce, norm) of a step's gradients: by the shards' placement on a
    sharded mesh, else the world's mean and the plain global norm."""
    if layout is None:
        return world_reducer(mesh), _dict_norm
    return SH.grad_reducer(layout), SH.grad_norm(layout)


def init_train_state(cfg: TrainConfig, models: DiffusionModels, *, unet_params: Params,
                     text_params: Params, vae_params: Params,
                     mesh: Optional[pmesh.Mesh] = None,
                     min_fsdp_size: int = 2 ** 16) -> TrainState:
    """The state over the given f32 params (used as they are, not copied);
    marks the trainable ones as requiring grad and the frozen ones not.
    On a ``mesh`` with ``fsdp`` or ``tensor`` above 1 the params are first
    cut in place to this rank's shards by the JAX rules
    (``parallel/sharded.place_models``, which also gives the models their
    gathering forwards and tensor groups), so the Adam moments and the EMA
    are made at shard size (``dcr_tpu/diffusion/train.shard_train_state``)."""
    cfg = resolve_scale_lr(cfg)
    layout = SH.place_models(models, mesh, {"unet": unet_params, "text": text_params,
                                            "vae": vae_params},
                             min_fsdp_size=min_fsdp_size)
    for params, trained in ((unet_params, True), (text_params, cfg.train_text_encoder),
                            (vae_params, False)):
        for p in params.values():
            p.requires_grad_(trained)
    trainable = {"unet": unet_params}
    if cfg.train_text_encoder:
        trainable["text_encoder"] = text_params
    return TrainState(
        step=0, unet_params=unet_params, text_params=text_params, vae_params=vae_params,
        opt_state=make_optimizer(cfg.optim).init(trainable),
        ema_params=({k: p.detach().clone() for k, p in unet_params.items()}
                    if cfg.ema_decay > 0 else None),
        layout=layout)


class _Encode(nn.Module):
    """The VAE's ``encode`` as a forward, for ``functional_call``."""

    def __init__(self, vae: nn.Module):
        super().__init__()
        self.vae = vae

    def forward(self, x: torch.Tensor):
        return self.vae.encode(x)


def draw_fn(seed: int, step: int, device: torch.device,
            draws: Optional[dict]) -> Callable:
    """``draw(name, make)``: the injected tensor for stream ``name`` when
    ``draws`` holds one, else ``make`` of the stream's generator at ``step``.
    Draws are of the global batch."""
    def draw(name: str, make: Callable[[torch.Generator], torch.Tensor]) -> torch.Tensor:
        if draws is not None and name in draws:
            return torch.as_tensor(draws[name], device=device)
        return make(rngmod.stream_generator(seed, f"train/{name}", step, device))
    return draw


def posterior_std(logvar: torch.Tensor) -> torch.Tensor:
    """The VAE posterior's std, in the moments' dtype."""
    return torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))


def global_shape(t: torch.Tensor, mesh: Optional[pmesh.Mesh]) -> tuple[int, ...]:
    """``t``'s shape with its rows (dim 0) those of the global batch."""
    n = 1 if mesh is None else mesh.data_parallel_size
    return (t.shape[0] * n, *t.shape[1:])


def sample_latents(mean: torch.Tensor, std: torch.Tensor, draw: Callable,
                   scaling: float, mesh: Optional[pmesh.Mesh] = None) -> torch.Tensor:
    """The scaled posterior sample ``(mean + std * eps) * scaling`` in f32,
    ``eps`` this rank's rows of an f32 draw of the ``vae_sample`` stream
    (over bf16 moments the sum is formed in f32, so f32 copies of the
    moments give the same bits)."""
    eps = pmesh.local_rows(draw("vae_sample", lambda g: torch.randn(
        global_shape(mean, mesh), generator=g, device=mean.device)), mesh)
    return ((mean + std * eps) * scaling).float()


def pixels_and_ids(batch: dict, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The batch's pixels as NCHW f32 and its token ids as int64 on ``device``."""
    pixels = torch.as_tensor(batch["pixel_values"], dtype=torch.float32, device=device)
    input_ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=device)
    return pixels.permute(0, 3, 1, 2).contiguous(), input_ids


def make_vae_encode(cfg: TrainConfig, models: DiffusionModels) -> Callable:
    """(vae_params, pixels NCHW f32) -> the posterior (``mean``, ``logvar``
    in the compute dtype), without gradients."""
    policy = policy_from_string(cfg.mixed_precision)
    encoder = _Encode(models.vae)

    @torch.no_grad()
    def encode(vae_params: Params, pixels: torch.Tensor, layout: Optional[SH.Layout] = None):
        params = SH.cast_to_compute(policy, "vae", vae_params, layout)
        with SH.compute_dtype(policy.compute_dtype):
            return functional_call(encoder, {f"vae.{k}": v for k, v in params.items()},
                                   (policy.cast_to_compute(pixels),))
    return encode


def make_text_encode(cfg: TrainConfig, models: DiffusionModels) -> Callable:
    """(text_params, input_ids) -> the text encoder's last hidden state in
    the compute dtype (gradients flow where the params require them)."""
    policy = policy_from_string(cfg.mixed_precision)

    def encode(text_params: Params, input_ids: torch.Tensor,
               layout: Optional[SH.Layout] = None) -> torch.Tensor:
        params = SH.cast_to_compute(policy, "text", text_params, layout)
        with SH.compute_dtype(policy.compute_dtype):
            return functional_call(models.text_encoder, params, (input_ids,)).last_hidden_state
    return encode


def make_update(cfg: TrainConfig, models: DiffusionModels,
                mesh: Optional[pmesh.Mesh] = None) -> Callable:
    """The body both train steps share: q-sample -> text conditioning (+
    embedding mitigations) -> unet -> mse(eps|v) -> grad -> clip/AdamW ->
    EMA. ``update(state, latents, ctx_of, draw) -> (state, metrics)``:
    ``state`` is a :class:`TrainState` or the pipelined step's hot view
    (anything with ``step``, ``unet_params``, ``text_params``,
    ``opt_state`` and ``ema_params``), updated in place; ``latents`` the
    scaled f32 latents (this rank's rows); ``ctx_of(trainable)`` the text
    embeddings given the trainable params; ``draw`` as :func:`draw_fn`
    makes it. ``mesh``: the process mesh (None: one process)."""
    cfg = resolve_scale_lr(cfg, 1 if mesh is None else mesh.data_parallel_size)
    policy = policy_from_string(cfg.mixed_precision)
    tx = make_optimizer(cfg.optim)
    sched = models.schedule
    accum = tx.accum

    def rows(t: torch.Tensor) -> torch.Tensor:
        return pmesh.local_rows(t, mesh)

    def update(state, latents: torch.Tensor, ctx_of: Callable, draw: Callable):
        device, step = latents.device, state.step
        layout = getattr(state, "layout", None)
        reduce_grads, norm = reducers(mesh, layout)
        bsz = global_shape(latents, mesh)[0]
        with torch.no_grad():
            noise = rows(draw("noise", lambda g: torch.randn(
                global_shape(latents, mesh), generator=g, device=device)))
            timesteps = rows(draw("timesteps", lambda g: torch.randint(
                0, sched.num_train_timesteps, (bsz,), generator=g, device=device))).long()
            noisy_latents = S.add_noise(sched, latents, noise, timesteps)
            target = S.training_target(sched, latents, noise, timesteps)

        trainable = trainable_of(state, cfg.train_text_encoder)
        with torch.enable_grad():
            ctx = ctx_of(trainable)
            if cfg.rand_noise_lam > 0:
                ctx = ctx + cfg.rand_noise_lam * rows(draw("emb_noise", lambda g: torch.randn(
                    global_shape(ctx, mesh), generator=g, device=device, dtype=ctx.dtype)))
            if cfg.mixup_noise_lam > 0:
                # Beta(a, 1) by inversion: U ** (1 / a)
                lam = draw("mixup_beta", lambda g: torch.rand(
                    (), generator=g, device=device) ** (1.0 / cfg.mixup_noise_lam))
                perm = draw("mixup_perm", lambda g: torch.randperm(
                    bsz, generator=g, device=device)).long()
                # across the global batch: every rank mixes the gathered rows
                full = pmesh.gather_rows(ctx, mesh)
                ctx = rows(lam * full + (1.0 - lam) * full[perm])

            unet_params = SH.cast_to_compute(policy, "unet", trainable["unet"], layout)

            def unet_apply(x, t, c):
                with SH.compute_dtype(policy.compute_dtype):
                    return functional_call(models.unet, unet_params, (x, t, c))

            args = (policy.cast_to_compute(noisy_latents), timesteps,
                    policy.cast_to_compute(ctx))
            pred = (checkpoint(unet_apply, *args, use_reentrant=False) if cfg.remat
                    else unet_apply(*args))
            loss = torch.mean((pred.float() - target) ** 2)
            flat = _flat(trainable)
            grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))

        applied = tx.update(grads, state.opt_state, trainable, reduce=reduce_grads, norm=norm)
        # after the update: without accumulation the reducer left the
        # world's mean in ``grads``, so this is the global norm
        grad_norm = norm(grads)
        loss = loss.detach()
        if reduce_grads is not None:
            loss = loss.reshape(1)
            reduce_grads({"loss": loss})
            loss = loss.reshape(())
        if state.ema_params is not None and applied:
            d = cfg.ema_decay
            with torch.no_grad():
                for k, e in state.ema_params.items():
                    e.mul_(d).add_(state.unet_params[k], alpha=1.0 - d)
        state.step = step + 1
        # the schedule advances once per accumulation boundary
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "lr": tx.schedule(step // accum)}
        return state, metrics

    return update


@compile_surface("train/step")
def make_train_step(cfg: TrainConfig, models: DiffusionModels,
                    mesh: Optional[pmesh.Mesh] = None) -> Callable:
    """The train step: (state, batch, draws=None) -> (state, metrics).

    batch: ``pixel_values`` [B, H, W, 3] f32 in [-1, 1] (NHWC, as the loader
    gives it) and ``input_ids`` [B, L], this rank's rows of the global
    batch. ``draws`` maps the names of :data:`DRAW_STREAMS` to tensors of
    the global batch that replace the step's own draws: ``vae_sample`` and
    ``noise`` [B, C, h, w], ``timesteps`` [B], ``emb_noise`` [B, L, D],
    ``mixup_beta`` (lambda) and ``mixup_perm`` [B]. The state is updated in
    place and returned; metrics are device tensors (``loss``,
    ``grad_norm``) and a float (``lr``).
    """
    cfg = resolve_scale_lr(cfg, 1 if mesh is None else mesh.data_parallel_size)
    vae_encode = make_vae_encode(cfg, models)
    text_encode = make_text_encode(cfg, models)
    update = make_update(cfg, models, mesh)
    scaling = models.vae.config.vae_scaling_factor

    def step_fn(state: TrainState, batch: dict, draws: Optional[dict] = None):
        device = next(iter(state.unet_params.values())).device
        pixels, input_ids = pixels_and_ids(batch, device)
        draw = draw_fn(cfg.seed, state.step, device, draws)
        # frozen VAE encode, posterior sample, scale
        post = vae_encode(state.vae_params, pixels, state.layout)
        with torch.no_grad():
            latents = sample_latents(post.mean, posterior_std(post.logvar), draw, scaling,
                                     mesh)

        def ctx_of(trainable: dict) -> torch.Tensor:
            if cfg.train_text_encoder:
                return text_encode(trainable["text_encoder"], input_ids, state.layout)
            with torch.no_grad():
                return text_encode(state.text_params, input_ids, state.layout)

        return update(state, latents, ctx_of, draw)

    return step_fn
