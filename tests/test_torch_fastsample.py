"""PyTorch port: score-reuse fast sampling against the JAX package.

- ``fast_plan``, ``unet_calls`` and ``canonical_plan_params`` equal the JAX
  package's over a grid of steps x ratio x order;
- the fast sampler (ddim and dpm++, order 1 and 2) equals the JAX sampler
  from the JAX sampler's own x_T at the f32 bar (atol 2e-4, rtol 1e-3, the
  bar of tests/test_torch_parity.py);
- a dense plan (fast off, ratio 0, or a ratio that rounds to no reuse step)
  is the plain port sampler bit for bit;
- the UNet runs exactly ``unet_calls(plan)`` times per sampler call.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dcr_tpu.core import rng as JR
from dcr_tpu.core.config import (FastSampleConfig as JFast, MeshConfig,
                                 SampleConfig as JSampleConfig)
from dcr_tpu.data.tokenizer import HashTokenizer
from dcr_tpu.diffusion.train import DiffusionModels as JModels
from dcr_tpu.models import schedulers as JS
from dcr_tpu.models.clip_text import CLIPTextModel as JCLIP, init_clip_text
from dcr_tpu.models.unet2d import UNet2DCondition as JUNet, init_unet
from dcr_tpu.models.vae import AutoencoderKL as JVAE, init_vae
from dcr_tpu.parallel import mesh as pmesh
from dcr_tpu.sampling import fastsample as JF
from dcr_tpu.sampling.sampler import make_sampler as j_make_sampler
from dcr_tpu_torch.core.config import FastSampleConfig, SampleConfig
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.sampling import fastsample as TF
from dcr_tpu_torch.sampling import pipeline as TPipe
from dcr_tpu_torch.sampling.sampler import make_sampler as t_make_sampler
from tests.test_torch_models import jax_params, port_cfg, tiny_cfg

ATOL, RTOL = 2e-4, 1e-3
STEPS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 13, 20, 32, 50)
RATIOS = (0.0, 0.05, 0.1, 0.25, 0.4, 0.5, 0.6, 0.75)


@pytest.mark.parametrize("steps", STEPS)
def test_plans_equal_jax(steps):
    for ratio in RATIOS:
        plan = TF.fast_plan(steps, ratio)
        assert plan == JF.fast_plan(steps, ratio), (steps, ratio)
        assert TF.unet_calls(plan) == JF.unet_calls(plan)
        assert TF.is_dense(plan) == JF.is_dense(plan)
        for order in (0, 1, 2, 3):
            assert TF.canonical_plan_params(steps, ratio, order) == \
                JF.canonical_plan_params(steps, ratio, order), (steps, ratio, order)
    for bad in (-0.1, 0.8):
        with pytest.raises(ValueError):
            TF.fast_plan(steps, bad)
        with pytest.raises(ValueError):
            JF.fast_plan(steps, bad)


def test_reuse_score_equals_jax():
    """The reuse arithmetic on its own: one score banked, two banked (order 1
    and 2), and two banked at one timestep (dt = 0)."""
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((2, 3, 4, 4)).astype(np.float32) for _ in range(2))
    for ts in ((801, 741), (500, 500)):
        jb, tb = JF.bank_init(a.shape), TF.bank_init(a.shape)
        for n, (pred, t) in enumerate(zip((a, b), ts)):
            jb = JF.bank_update(jb, jax.numpy.asarray(pred), t)
            tb = TF.bank_update(tb, torch.from_numpy(pred), t)
            for order in (1, 2):
                want = np.asarray(JF.reuse_score(jb, 681, order))
                got = TF.reuse_score(tb, 681, order).numpy()
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6,
                                           err_msg=f"{ts} banked {n + 1} order {order}")


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg(sample_size=8)
    params = {"unet": jax_params(init_unet, cfg, 31),
              "vae": jax_params(init_vae, cfg, 32),
              "text": jax_params(init_clip_text, cfg, 33)}
    jmodels = JModels(unet=JUNet(cfg), vae=JVAE(cfg), text_encoder=JCLIP(cfg),
                      schedule=JS.make_schedule())
    tmodels = TPipe.build_models(port_cfg(cfg), device="cpu")
    TPipe.load_params(tmodels, {
        "unet": EX.unet_from_flax(params["unet"], len(cfg.block_out_channels)),
        "vae": EX.vae_from_flax(params["vae"]),
        "text": EX.text_from_flax(params["text"])})
    tok = HashTokenizer(cfg.text_vocab_size, cfg.text_max_length)
    ids = tok(["a church", "a garbage truck"])
    unc = np.broadcast_to(tok([""])[0], ids.shape).copy()
    return cfg, jmodels, params, tmodels, ids, unc


class _CountCalls:
    def __init__(self, module: torch.nn.Module):
        self.n = 0
        self.handle = module.register_forward_hook(self)

    def __call__(self, *_):
        self.n += 1


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
@pytest.mark.parametrize("order", [1, 2])
def test_fast_sampler_matches_jax_from_injected_x_t(tiny, sampler, order):
    cfg, jmodels, params, tmodels, ids, unc = tiny
    steps, ratio = 10, 0.5
    kw = dict(resolution=16, num_inference_steps=steps, guidance_scale=7.5,
              sampler=sampler, seed=0)
    mesh = pmesh.make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jcfg = JSampleConfig(**kw, fast=JFast(enabled=True, reuse_ratio=ratio, order=order))
    ref = np.asarray(j_make_sampler(jcfg, jmodels, mesh)(params, ids, unc, JR.root_key(5)))
    x_t = np.asarray(jax.random.normal(JR.stream_key(JR.root_key(5), "init"),
                                       (2, 8, 8, cfg.vae_latent_channels)))
    tcfg = SampleConfig(**kw, fast=FastSampleConfig(enabled=True, reuse_ratio=ratio,
                                                     order=order))
    calls = _CountCalls(tmodels.unet)
    sampler = t_make_sampler(tcfg, tmodels, device="cpu")
    try:
        out = sampler(None, ids, unc, None, init_latents=x_t)
    finally:
        calls.handle.remove()
    plan = TF.fast_plan(steps, ratio)
    assert calls.n == TF.unet_calls(plan) == sampler.unet_calls == 5
    assert not TF.is_dense(plan)
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fast", [dict(enabled=False), dict(enabled=True, reuse_ratio=0.0),
                                  dict(enabled=True, reuse_ratio=0.05, order=1)])
def test_dense_plan_is_the_plain_sampler_bit_for_bit(tiny, fast):
    _, _, _, tmodels, ids, unc = tiny
    kw = dict(resolution=16, num_inference_steps=6, sampler="dpm++", seed=0)
    rng = np.random.default_rng(1)
    x_t = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    plain = t_make_sampler(SampleConfig(**kw), tmodels, device="cpu")(
        None, ids, unc, None, init_latents=x_t)
    calls = _CountCalls(tmodels.unet)
    try:
        out = t_make_sampler(SampleConfig(**kw, fast=FastSampleConfig(**fast)), tmodels,
                             device="cpu")(None, ids, unc, None, init_latents=x_t)
    finally:
        calls.handle.remove()
    assert calls.n == 6
    assert torch.equal(out, plain)
