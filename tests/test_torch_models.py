"""PyTorch port: UNet, VAE, CLIP text tower and schedulers against the JAX
package on the same weights and inputs.

JAX param trees have the structure of the JAX package's init functions,
filled from a seeded numpy generator, and reach the port through
dcr_tpu_torch.models.export (strict state-dict loads). Models are
compared in f32 at atol 2e-4, rtol 1e-3, the bar of
tests/test_torch_parity.py; NHWC (JAX) and NCHW (port) meet at the test.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcr_tpu.core.config import ModelConfig
from dcr_tpu.models import schedulers as JS
from dcr_tpu.models.clip_text import init_clip_text
from dcr_tpu.models.unet2d import init_unet
from dcr_tpu.models.vae import AutoencoderKL as JAutoencoderKL, init_vae
from dcr_tpu.sampling import sampler as JSampler
from dcr_tpu_torch.core.config import ModelConfig as TModelConfig
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.models import schedulers as TS
from dcr_tpu_torch.models.clip_text import CLIPTextModel
from dcr_tpu_torch.models.unet2d import UNet2DCondition
from dcr_tpu_torch.models.vae import AutoencoderKL
from dcr_tpu_torch.ops import flash_attention as TFA
from dcr_tpu_torch.sampling import sampler as TSampler

ATOL, RTOL = 2e-4, 1e-3


def tiny_cfg(**kw) -> ModelConfig:
    """tests/test_torch_parity.py's tiny config."""
    base = dict(sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
                attention_head_dim=16, cross_attention_dim=48, transformer_layers=1,
                norm_num_groups=8, flash_attention=False,
                vae_block_out_channels=(32, 64), vae_layers_per_block=1,
                vae_latent_channels=4, text_vocab_size=1000, text_hidden_size=48,
                text_layers=2, text_heads=4, text_max_length=16)
    base.update(kw)
    return ModelConfig(**base)


def port_cfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**dataclasses.asdict(cfg))


def jax_params(init_fn, cfg: ModelConfig, seed: int):
    """A param tree of the structure ``init_fn`` builds (traced with
    jax.eval_shape, no compile), filled from np.random.default_rng(seed):
    fan-in-scaled kernels, unit-centred norm gains, small biases."""
    shapes = jax.eval_shape(lambda k: init_fn(cfg, k)[1], jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        fan_in = int(np.prod(leaf.shape[:-1])) or 1
        return x / np.sqrt(fan_in)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _unet_pair(cfg: ModelConfig, seed: int):
    params = jax_params(init_unet, cfg, seed)
    port = UNet2DCondition(port_cfg(cfg)).eval()
    port.load_state_dict(EX.unet_from_flax(params, len(cfg.block_out_channels)),
                         strict=True)
    return params, port


@pytest.mark.parametrize("variant", ["sd2x", "sd1x", "kernel_shaped"])
def test_unet_matches_jax(variant, monkeypatch):
    if variant == "sd2x":
        cfg, hw = tiny_cfg(), 8
    elif variant == "sd1x":
        cfg, hw = tiny_cfg(attention_num_heads=2, use_linear_projection=False), 8
    else:
        # level-0 self-attention at S=16*16=256, D=64: the plain flash
        # version runs inside the UNet, as the kernel does on the card
        cfg = tiny_cfg(block_out_channels=(64, 128), attention_head_dim=64,
                       norm_num_groups=16, flash_attention=True, sample_size=16)
        hw = 16
    from dcr_tpu.models.unet2d import UNet2DCondition as JUNet

    params, port = _unet_pair(cfg, 11)
    rng = np.random.default_rng(11)
    sample = rng.standard_normal((2, hw, hw, cfg.in_channels)).astype(np.float32)
    t = np.array([7, 421], np.int32)
    ctx = rng.standard_normal((2, 5, cfg.cross_attention_dim)).astype(np.float32)
    ref = jax.jit(JUNet(cfg).apply)({"params": params}, jnp.asarray(sample),
                                    jnp.asarray(t), jnp.asarray(ctx))
    called = []
    orig = TFA.flash_attention_reference
    monkeypatch.setattr(TFA, "flash_attention_reference",
                        lambda *a: called.append(1) or orig(*a))
    with torch.no_grad():
        out = port(torch.from_numpy(sample).permute(0, 3, 1, 2),
                   torch.from_numpy(t.astype(np.int64)), torch.from_numpy(ctx))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    # the kernel-shaped config drives the plain B1 branch (1 down + 2 up
    # self-attentions at level 0); the others never reach it
    assert len(called) == (3 if variant == "kernel_shaped" else 0)


def test_vae_encode_decode_match_jax():
    cfg = tiny_cfg()
    params = jax_params(init_vae, cfg, 1)
    port = AutoencoderKL(port_cfg(cfg)).eval()
    port.load_state_dict(EX.vae_from_flax(params), strict=True)
    model = JAutoencoderKL(cfg)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    dist = model.apply({"params": params}, jnp.asarray(img), method=JAutoencoderKL.encode)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    dec = model.apply({"params": params}, jnp.asarray(z), method=JAutoencoderKL.decode)
    with torch.no_grad():
        tdist = port.encode(torch.from_numpy(img).permute(0, 3, 1, 2))
        tdec = port.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    for ours, theirs in ((tdist.mean, dist.mean), (tdist.logvar, dist.logvar),
                         (tdec, dec)):
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(theirs),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_matches_jax(act):
    from dcr_tpu.models.clip_text import CLIPTextModel as JCLIP

    cfg = tiny_cfg(text_act=act)
    params = jax_params(init_clip_text, cfg, 2)
    port = CLIPTextModel(port_cfg(cfg)).eval()
    port.load_state_dict(EX.text_from_flax(params), strict=True)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.text_vocab_size - 1, (3, cfg.text_max_length)).astype(np.int32)
    ids[:, 5] = cfg.text_vocab_size - 1     # an EOT token for the pooled output
    ref = JCLIP(cfg).apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        out = port(torch.from_numpy(ids.astype(np.int64)))
    for name in ("last_hidden_state", "penultimate_hidden_state", "pooled"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# schedulers: f32 formulas on identical inputs agree to rtol 1e-6 (atol 1e-6
# for values near zero); the grids are integers and must be equal
# ---------------------------------------------------------------------------

SCHED_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("beta_schedule,prediction_type", [
    ("scaled_linear", "epsilon"), ("linear", "v_prediction"),
    ("squaredcos_cap_v2", "sample")])
def test_schedule_and_grids_match_jax(beta_schedule, prediction_type):
    js = JS.make_schedule(beta_schedule=beta_schedule, prediction_type=prediction_type)
    ts_ = TS.make_schedule(beta_schedule=beta_schedule, prediction_type=prediction_type)
    np.testing.assert_array_equal(ts_.betas.numpy(), np.asarray(js.betas))
    np.testing.assert_array_equal(ts_.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    for sampler in ("dpm++", "ddim", "ddpm"):
        for steps in (4, 20, 50):
            jt, jp, jlow = JSampler.sampler_grid(sampler, js, steps)
            tt, tp, tlow = TSampler.sampler_grid(sampler, ts_, steps)
            np.testing.assert_array_equal(tt, np.asarray(jt))
            np.testing.assert_array_equal(tp, np.asarray(jp))
            assert tlow == jlow


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_scheduler_steps_match_jax(prediction_type):
    js = JS.make_schedule(prediction_type=prediction_type)
    ts_ = TS.make_schedule(prediction_type=prediction_type)
    rng = np.random.default_rng(3)
    shape = (2, 4, 4, 4)
    x = rng.standard_normal(shape).astype(np.float32)
    out = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    tx, tout, tnoise = (torch.from_numpy(a) for a in (x, out, noise))
    jx, jout = jnp.asarray(x), jnp.asarray(out)

    for t, prev_t in ((999, 949), (500, 0), (20, -1), (1, 0)):
        np.testing.assert_allclose(
            TS.ddim_step(ts_, tout, tx, t, prev_t).numpy(),
            np.asarray(JS.ddim_step(js, jout, jx, t, prev_t)), **SCHED_TOL)
        # ddpm with its noise handed to both: the JAX step draws it from a key,
        # so the test draws the same numbers from an equal key
        jnoise = np.array(jax.random.normal(jax.random.key(t + 2), shape, jnp.float32))
        np.testing.assert_allclose(
            TS.ddpm_step(ts_, tout, tx, t, prev_t,
                         noise=torch.from_numpy(jnoise)).numpy(),
            np.asarray(JS.ddpm_step(js, jout, jx, t, prev_t, jax.random.key(t + 2))),
            **SCHED_TOL)
        x0_t, eps_t = TS.pred_to_x0_eps(ts_, tout, tx, t)
        x0_j, eps_j = JS.pred_to_x0_eps(js, jout, jx, t)
        np.testing.assert_allclose(x0_t.numpy(), np.asarray(x0_j), **SCHED_TOL)
        np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), **SCHED_TOL)

    tb = np.array([3, 700], np.int64)
    np.testing.assert_allclose(TS.add_noise(ts_, tx, tnoise, torch.from_numpy(tb)).numpy(),
                               np.asarray(JS.add_noise(js, jx, jnp.asarray(noise),
                                                       jnp.asarray(tb))), **SCHED_TOL)
    np.testing.assert_allclose(
        TS.training_target(ts_, tx, tnoise, torch.from_numpy(tb)).numpy(),
        np.asarray(JS.training_target(js, jx, jnp.asarray(noise), jnp.asarray(tb))),
        **SCHED_TOL)


def test_dpmpp_trajectory_matches_jax():
    """Three DPM-Solver++ steps (first order, second order, forced first
    order) through to prev_t=0, carrying the state."""
    js, ts_ = JS.make_schedule(), TS.make_schedule()
    rng = np.random.default_rng(4)
    shape = (2, 4, 4, 4)
    x = rng.standard_normal(shape).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jstate, tstate = JS.dpm_init_state(shape), TS.dpm_init_state(shape)
    for t, prev_t, force in ((999, 666, False), (666, 333, False), (333, 0, True)):
        out = rng.standard_normal(shape).astype(np.float32)
        jx, jstate = JS.dpmpp_2m_step(js, jnp.asarray(out), jx, t, prev_t, jstate,
                                      force_first_order=force)
        tx, tstate = TS.dpmpp_2m_step(ts_, torch.from_numpy(out), tx, t, prev_t, tstate,
                                      force_first_order=force)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **SCHED_TOL)
        np.testing.assert_allclose(tstate.prev_lambda.numpy(),
                                   np.asarray(jstate.prev_lambda), **SCHED_TOL)
        assert int(tstate.step_index) == int(jstate.step_index)
