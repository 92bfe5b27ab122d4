"""PyTorch port: the train step against the JAX package's make_train_step.

Both steps start from the same weights (a JAX param tree filled from a seeded
numpy generator, carried to the port through models/export) and see the same
batch and the same device draws: the test derives them from the JAX step's
own keys (root -> stream -> step, as make_train_step does) and hands them to
the port's step through ``draws``. Compared after each step: loss, grad_norm,
lr and every trainable parameter (and the EMA where enabled).

Tolerances: f32 losses at rtol 1e-5 and grad norms at rtol 1e-4; after
AdamW the parameters at an absolute bound of a small fraction of the
learning rate (Adam turns rounding noise in a near-zero gradient into an
O(lr) step, so a relative bound is the wrong gate). Under bf16 the JAX
modules compute in f32 on bf16-rounded weights while the port computes in
bf16, so losses agree at rtol 2e-2, grad norms at 5e-2, and parameters
within Adam's reach of 2.1 lr per step at most and 0.05 lr per step on
average.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcr_tpu.core import rng as jrng
from dcr_tpu.core.config import MeshConfig, OptimConfig, TrainConfig
from dcr_tpu.diffusion import train as JT
from dcr_tpu.diffusion.trainer import build_modules
from dcr_tpu.models.clip_text import init_clip_text
from dcr_tpu.models.unet2d import init_unet
from dcr_tpu.models.vae import init_vae
from dcr_tpu.parallel import mesh as pmesh
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.diffusion import train as TT
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.sampling.pipeline import build_models as t_build_models
from tests.test_torch_models import jax_params, tiny_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tiny models run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LR = 1e-3
BSZ = 4


def _train_cfg(model=None, **kw) -> TrainConfig:
    optim = dict(learning_rate=LR, lr_scheduler="constant", lr_warmup_steps=0,
                 adam_epsilon=1e-6)
    optim.update(kw.pop("optim", {}))
    cfg = TrainConfig(**{"mixed_precision": "no", "seed": 0, **kw})
    cfg.model = model or tiny_cfg()
    cfg.optim = OptimConfig(**optim)
    return cfg


def _port_cfg(cfg: TrainConfig) -> TC.TrainConfig:
    return TC.from_dict(TC.TrainConfig, dataclasses.asdict(cfg))


def _params(cfg) -> dict:
    return {"unet": jax_params(init_unet, cfg.model, 1),
            "vae": jax_params(init_vae, cfg.model, 2),
            "text": jax_params(init_clip_text, cfg.model, 3)}


def _to_port(params: dict, cfg) -> dict[str, dict[str, torch.Tensor]]:
    return {"unet": EX.unet_from_flax(params["unet"], len(cfg.model.block_out_channels)),
            "vae": EX.vae_from_flax(params["vae"]),
            "text": EX.text_from_flax(params["text"])}


def _batch(cfg, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    px = cfg.model.sample_size * 2 ** (len(cfg.model.vae_block_out_channels) - 1)
    return {"pixel_values": rng.uniform(-1, 1, (BSZ, px, px, 3)).astype(np.float32),
            "input_ids": rng.integers(0, cfg.model.text_vocab_size,
                                      (BSZ, cfg.model.text_max_length)).astype(np.int32),
            "index": np.arange(BSZ)}


def _jax_draws(cfg, key, step: int) -> dict:
    """The draws the JAX step makes at ``step`` (train.py:192-226), in the
    port's layout (NCHW latents)."""
    keys = {name: jrng.step_key(jrng.stream_key(key, name), step)
            for name in TT.DRAW_STREAMS}
    lat = cfg.model.sample_size
    shape = (BSZ, lat, lat, cfg.model.vae_latent_channels)
    nchw = lambda x: torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).contiguous()
    return {
        "vae_sample": nchw(jax.random.normal(keys["vae_sample"], shape, jnp.float32)),
        "noise": nchw(jax.random.normal(keys["noise"], shape)),
        "timesteps": torch.from_numpy(np.asarray(jax.random.randint(
            keys["timesteps"], (BSZ,), 0, cfg.model.num_train_timesteps))),
        "emb_noise": torch.from_numpy(np.asarray(jax.random.normal(
            keys["emb_noise"], (BSZ, cfg.model.text_max_length,
                                cfg.model.text_hidden_size), jnp.float32))),
        "mixup_beta": torch.tensor(float(jax.random.beta(
            keys["mixup_beta"], cfg.mixup_noise_lam or 1.0, 1.0))),
        "mixup_perm": torch.from_numpy(np.asarray(jax.random.permutation(
            keys["mixup_perm"], BSZ))),
    }


class Pair:
    """One configuration, run by both steps from the same start."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.params = _params(cfg)
        self.models = build_modules(cfg)
        self.mesh = pmesh.make_mesh(MeshConfig(), devices=jax.devices()[:1])
        self.jstep = JT.make_train_step(cfg, self.models, self.mesh)
        self.tcfg = _port_cfg(cfg)
        self.tmodels = t_build_models(self.tcfg.model, "cpu")
        self.tstep = TT.make_train_step(self.tcfg, self.tmodels)
        self.key = jrng.root_key(0)

    def run(self, steps: int):
        cfg = self.cfg
        p = jax.tree.map(lambda x: jnp.array(np.asarray(x)), self.params)
        jstate = JT.shard_train_state(JT.init_train_state(
            cfg, self.models, unet_params=p["unet"], text_params=p["text"],
            vae_params=p["vae"]), self.mesh)
        tp = _to_port(self.params, cfg)
        tstate = TT.init_train_state(self.tcfg, self.tmodels, unet_params=tp["unet"],
                                     text_params=tp["text"], vae_params=tp["vae"])
        batch = _batch(cfg)
        jbatch = pmesh.shard_batch(self.mesh, dict(batch))
        history = []
        for i in range(steps):
            jstate, jm = self.jstep(jstate, jbatch, self.key)
            tstate, tm = self.tstep(tstate, batch, _jax_draws(cfg, self.key, i))
            history.append(({k: float(v) for k, v in jax.device_get(jm).items()},
                            {k: float(v) for k, v in tm.items()}))
        return jax.device_get(jstate), tstate, history


def _check_params(jstate, tstate, cfg, atol, mean_atol=None):
    """Every trainable parameter (and the EMA) within ``atol`` of JAX's;
    with ``mean_atol`` also the mean absolute difference over all of them."""
    n_blocks = len(cfg.model.block_out_channels)
    pairs = [(EX.unet_from_flax(jstate.unet_params, n_blocks), tstate.unet_params)]
    if cfg.train_text_encoder:
        pairs.append((EX.text_from_flax(jstate.text_params), tstate.text_params))
    if cfg.ema_decay > 0:
        pairs.append((EX.unet_from_flax(jstate.ema_params, n_blocks), tstate.ema_params))
    for want, got in pairs:
        assert set(want) == set(got)
        diffs = torch.cat([(want[k] - got[k].detach()).abs().flatten() for k in want])
        assert diffs.max().item() <= atol, f"max |param diff| {diffs.max():.3e} > {atol:.3e}"
        if mean_atol is not None:
            assert diffs.mean().item() <= mean_atol, (
                f"mean |param diff| {diffs.mean():.3e} > {mean_atol:.3e}")


def _check_metrics(history, loss_rtol, norm_rtol):
    for jm, tm in history:
        assert set(tm) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=norm_rtol)
        np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6, atol=1e-12)


CASES = {
    "f32": dict(),
    "bf16": dict(mixed_precision="bf16"),
    "emb_noise_mixup": dict(rand_noise_lam=0.1, mixup_noise_lam=0.3),
    "train_text_encoder": dict(train_text_encoder=True),
    "accum2_ema": dict(ema_decay=0.9, optim=dict(gradient_accumulation_steps=2,
                                                 lr_scheduler="constant_with_warmup",
                                                 lr_warmup_steps=2)),
    "clipped": dict(optim=dict(max_grad_norm=1e-3, lr_scheduler="linear",
                               lr_warmup_steps=1)),
}


@pytest.fixture(scope="module")
def pairs():
    cache: dict[str, Pair] = {}

    def get(name: str) -> Pair:
        if name not in cache:
            cache[name] = Pair(_train_cfg(**CASES[name]))
        return cache[name]
    return get


@pytest.mark.parametrize("case,steps", [
    ("f32", 1), ("f32", 3), ("bf16", 1), ("bf16", 3), ("emb_noise_mixup", 2),
    ("train_text_encoder", 2), ("accum2_ema", 4), ("clipped", 2)])
def test_train_step_matches_jax(pairs, case, steps):
    pair = pairs(case)
    jstate, tstate, history = pair.run(steps)
    assert tstate.step == int(jstate.step) == steps
    if pair.cfg.mixed_precision == "bf16":
        _check_metrics(history, loss_rtol=2e-2, norm_rtol=5e-2)
        # a sign flip moves an element by at most 2 lr per Adam step (plus
        # the decay term); the mean difference must stay far below that
        _check_params(jstate, tstate, pair.cfg, atol=2.1 * LR * steps,
                      mean_atol=0.05 * LR * steps)
    else:
        _check_metrics(history, loss_rtol=1e-5, norm_rtol=1e-4)
        _check_params(jstate, tstate, pair.cfg, atol=1e-2 * LR * steps)
    if case == "clipped":
        assert all(jm["grad_norm"] > 1e-3 for jm, _ in history)


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_lr_schedules_match_optax(name):
    jcfg = OptimConfig(learning_rate=3e-4, lr_scheduler=name, lr_warmup_steps=7)
    tcfg = TC.OptimConfig(learning_rate=3e-4, lr_scheduler=name, lr_warmup_steps=7)
    want, got = JT.make_lr_schedule(jcfg), TT.make_lr_schedule(tcfg)
    for count in (0, 1, 3, 6, 7, 8, 50, 10 ** 6 - 1, 2 * 10 ** 6):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0 or name == "constant"


def test_first_update_uses_schedule_zero():
    """optax indexes the schedule by the update count: under warmup the
    first update has lr 0 and leaves the params untouched."""
    cfg = _train_cfg(optim=dict(lr_scheduler="constant_with_warmup", lr_warmup_steps=3,
                                adam_weight_decay=0.0))
    tcfg = _port_cfg(cfg)
    models = t_build_models(tcfg.model, "cpu", seed=0)
    tp = _to_port(_params(cfg), cfg)
    before = {k: v.clone() for k, v in tp["unet"].items()}
    state = TT.init_train_state(tcfg, models, unet_params=tp["unet"],
                                text_params=tp["text"], vae_params=tp["vae"])
    state, m = TT.make_train_step(tcfg, models)(state, _batch(cfg))
    assert m["lr"] == 0.0 and torch.isfinite(m["loss"])
    assert all(torch.equal(before[k], state.unet_params[k]) for k in before)
    state, m = TT.make_train_step(tcfg, models)(state, _batch(cfg))
    assert m["lr"] == pytest.approx(LR / 3)


def test_kernel_shaped_step_goes_through_the_flash_function():
    """Head dim 64 over 16x16 latents (256 tokens): the UNet's self-attention
    takes the autograd Function (its plain path on the CPU), and the step
    still matches the JAX step."""
    from dcr_tpu_torch.ops import flash_attention as TFA

    model = tiny_cfg(sample_size=16, block_out_channels=(64, 128), attention_head_dim=64,
                     norm_num_groups=16, flash_attention=True)
    pair = Pair(_train_cfg(model=model))
    calls = []
    orig = TFA.FlashAttention.backward

    def spy(ctx, do):
        calls.append(tuple(do.shape))
        return orig(ctx, do)

    TFA.FlashAttention.backward = staticmethod(spy)
    try:
        jstate, tstate, history = pair.run(1)
    finally:
        TFA.FlashAttention.backward = staticmethod(orig)
    assert calls and all(s[1] == 256 and s[3] == 64 for s in calls)
    _check_metrics(history, loss_rtol=1e-5, norm_rtol=1e-4)
    _check_params(jstate, tstate, pair.cfg, atol=1e-2 * LR)


def test_remat_recomputes_the_forward_and_changes_nothing():
    """remat=True wraps the UNet in torch.utils.checkpoint: the flash
    Function's forward runs twice per step (the recompute), and loss and
    params equal the plain step's."""
    from dcr_tpu_torch.ops import flash_attention as TFA

    model = tiny_cfg(sample_size=16, block_out_channels=(64, 128), attention_head_dim=64,
                     norm_num_groups=16, flash_attention=True)
    jcfg = _train_cfg(model=model)
    params, draws = _params(jcfg), _jax_draws(jcfg, jrng.root_key(0), 0)
    results = {}
    orig = TFA.FlashAttention.forward
    for remat in (False, True):
        tcfg = _port_cfg(_train_cfg(model=model, remat=remat))
        models = t_build_models(tcfg.model, "cpu")
        tp = _to_port(params, jcfg)
        state = TT.init_train_state(tcfg, models, unet_params=tp["unet"],
                                    text_params=tp["text"], vae_params=tp["vae"])
        calls = []

        def spy(ctx, q, k, v):
            calls.append(q.shape)
            return orig(ctx, q, k, v)

        TFA.FlashAttention.forward = staticmethod(spy)
        try:
            state, m = TT.make_train_step(tcfg, models)(state, _batch(tcfg), draws)
        finally:
            TFA.FlashAttention.forward = staticmethod(orig)
        results[remat] = (len(calls), float(m["loss"]), state.unet_params)
    (n0, loss0, p0), (n1, loss1, p1) = results[False], results[True]
    assert n0 == 3 and n1 == 6
    assert loss0 == loss1
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=0, atol=1e-7)


def test_step_draws_its_own_noise_reproducibly():
    cfg = _train_cfg()
    tcfg = _port_cfg(cfg)
    models = t_build_models(tcfg.model, "cpu", seed=0)

    def run():
        tp = _to_port(_params(cfg), cfg)
        state = TT.init_train_state(tcfg, models, unet_params=tp["unet"],
                                    text_params=tp["text"], vae_params=tp["vae"])
        step = TT.make_train_step(tcfg, models)
        losses = [float(step(state, _batch(cfg))[1]["loss"]) for _ in range(2)]
        return losses, state
    (l1, s1), (l2, s2) = run(), run()
    assert l1 == l2 and l1[0] != l1[1]
    assert all(torch.equal(s1.unet_params[k], s2.unet_params[k]) for k in s1.unet_params)
