"""PyTorch port: the bulk sampling slice against the JAX package.

- the whole sampler (text encoder -> CFG denoising loop -> VAE decode) from
  the JAX sampler's own x_T, handed in through ``init_latents``;
- a checkpoint exported by the JAX package, loaded and sampled by the
  port's pipeline on the CPU: PNG count, PNG bytes (read back with PIL) and
  prompts.txt against the JAX prompt builder;
- tokenizer ids, prompt lists and host RNG streams, which must be identical;
- the entry points refuse to run without a GPU unless asked for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dcr_tpu.core import rng as JR
from dcr_tpu.core.checkpoint import export_hf_layout
from dcr_tpu.core.config import MeshConfig, SampleConfig as JSampleConfig
from dcr_tpu.data.tokenizer import ClipBPETokenizer as JBPE, HashTokenizer as JHash
from dcr_tpu.diffusion.train import DiffusionModels as JModels
from dcr_tpu.models import schedulers as JS
from dcr_tpu.models.clip_text import CLIPTextModel as JCLIP, init_clip_text
from dcr_tpu.models.unet2d import UNet2DCondition as JUNet, init_unet
from dcr_tpu.models.vae import AutoencoderKL as JVAE, init_vae
from dcr_tpu.parallel import mesh as pmesh
from dcr_tpu.sampling import prompts as JP
from dcr_tpu.sampling.sampler import make_sampler as j_make_sampler
from dcr_tpu_torch.cli import sample as tcli
from dcr_tpu_torch.core import rng as TR
from dcr_tpu_torch.core.config import SampleConfig, from_dict, parse_cli
from dcr_tpu_torch.data.tokenizer import ClipBPETokenizer as TBPE, HashTokenizer as THash
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.sampling import pipeline as TPipe
from dcr_tpu_torch.sampling import prompts as TP
from dcr_tpu_torch.sampling.png import encode_png
from dcr_tpu_torch.sampling.sampler import make_sampler as t_make_sampler
from tests.test_torch_models import jax_params, port_cfg, tiny_cfg

BPE_DIR = "tests/fixtures/bpe"


@pytest.fixture(scope="module")
def tiny():
    """JAX modules + numpy-filled params, and the port's models on the CPU
    carrying the same weights."""
    cfg = tiny_cfg(sample_size=8)
    params = {"unet": jax_params(init_unet, cfg, 21),
              "vae": jax_params(init_vae, cfg, 22),
              "text": jax_params(init_clip_text, cfg, 23)}
    jmodels = JModels(unet=JUNet(cfg), vae=JVAE(cfg), text_encoder=JCLIP(cfg),
                      schedule=JS.make_schedule())
    tmodels = TPipe.build_models(port_cfg(cfg), device="cpu")
    TPipe.load_params(tmodels, {
        "unet": EX.unet_from_flax(params["unet"], len(cfg.block_out_channels)),
        "vae": EX.vae_from_flax(params["vae"]),
        "text": EX.text_from_flax(params["text"])})
    return cfg, jmodels, params, tmodels


@pytest.mark.parametrize("sampler,steps", [("dpm++", 5), ("ddim", 4)])
def test_sampler_matches_jax_from_injected_x_t(tiny, sampler, steps):
    """Images agree to atol 1e-4. The two packages sum in different orders
    (XLA vs PyTorch CPU kernels, ~1e-7 relative per op); CFG (x7.5) and the
    solver's 1/sqrt(alpha_cumprod) at the first steps amplify that, and the
    VAE decodes it. Measured: ~3e-6 at these sizes, so the bound has 30x room."""
    cfg, jmodels, params, tmodels = tiny
    kw = dict(resolution=16, num_inference_steps=steps, guidance_scale=7.5,
              sampler=sampler, seed=0)
    tok = JHash(cfg.text_vocab_size, cfg.text_max_length)
    ids = np.repeat(tok(["a church", "a garbage truck"]), 1, axis=0)
    unc = np.broadcast_to(tok([""])[0], ids.shape).copy()

    mesh = pmesh.make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    ref = np.asarray(j_make_sampler(JSampleConfig(**kw), jmodels, mesh)(
        params, ids, unc, JR.root_key(3)))
    # the JAX sampler's own x_T, from an equal key
    x_t = np.asarray(jax.random.normal(JR.stream_key(JR.root_key(3), "init"),
                                       (2, 8, 8, cfg.vae_latent_channels)))

    out = t_make_sampler(SampleConfig(**kw), tmodels, device="cpu")(
        None, ids, unc, None, init_latents=x_t)
    assert out.shape == ref.shape == (2, 16, 16, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_sampler_draws_x_t_from_generator(tiny):
    _, _, _, tmodels = tiny
    cfg = SampleConfig(resolution=16, num_inference_steps=3, sampler="ddpm",
                       rand_noise_lam=0.1, seed=0)
    tok = THash(1000, 16)
    ids = tok(["x", "y"])
    unc = np.broadcast_to(tok([""])[0], ids.shape).copy()
    fn = t_make_sampler(cfg, tmodels, device="cpu")

    def run(step):
        return fn(None, ids, unc, TR.stream_generator(0, "sample", step)).numpy()

    a, b, c = run(0), run(0), run(1)
    assert np.isfinite(a).all() and a.min() >= 0.0 and a.max() <= 1.0
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_pipeline_samples_a_jax_exported_checkpoint(tiny, tmp_path):
    cfg, _, params, _ = tiny
    ckpt = tmp_path / "run" / "checkpoint"
    export_hf_layout(ckpt, unet=params["unet"], vae=params["vae"],
                     text_encoder=params["text"], model_config=dataclasses.asdict(cfg))
    models, sds, model_cfg = TPipe.load_checkpoint_models(ckpt, device="cpu")
    assert model_cfg.block_out_channels == cfg.block_out_channels
    assert set(sds) == {"unet", "vae", "text"}

    scfg = SampleConfig(model_path=str(tmp_path / "run"), savepath=str(tmp_path / "out"),
                        num_batches=3, im_batch=2, resolution=16,
                        num_inference_steps=2, sampler="dpm++", seed=5)
    out = TPipe.generate(scfg, modelstyle="classlevel", device="cpu")
    pngs = sorted((out / "generations").glob("*.png"))
    assert [p.name for p in pngs] == [f"{i}.png" for i in range(6)]
    for p in pngs:
        with Image.open(p) as im:
            assert im.mode == "RGB" and im.size == (16, 16)
    expected = JP.build_prompt_list("classlevel", 3, seed=5,
                                    tokenizer=JHash(cfg.text_vocab_size,
                                                    cfg.text_max_length))
    assert (out / "prompts.txt").read_text() == "".join(f"{p}\n" for p in expected)


def test_png_writer_round_trips_through_pil(tmp_path):
    rng = np.random.default_rng(0)
    for h, w in ((1, 1), (16, 16), (7, 33)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = tmp_path / f"{h}x{w}.png"
        path.write_bytes(encode_png(img))
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), img)


def test_tokenizers_give_identical_ids():
    texts = ["An image of a church", "a photo of  English springer!", "", "x" * 300,
             "<|startoftext|>hello world's 123"]
    jb = JBPE(f"{BPE_DIR}/vocab.json", f"{BPE_DIR}/merges.txt")
    tb = TBPE(f"{BPE_DIR}/vocab.json", f"{BPE_DIR}/merges.txt")
    np.testing.assert_array_equal(tb(texts), jb(texts))
    assert tb.fingerprint() == jb.fingerprint()
    assert tb.decode(tb.encode(texts[1])) == jb.decode(jb.encode(texts[1]))
    jh, th = JHash(1000, 16), THash(1000, 16)
    np.testing.assert_array_equal(th(texts), jh(texts))
    assert th.decode([5, 17, 999]) == jh.decode([5, 17, 999])


@pytest.mark.parametrize("style,augs", [
    ("nolevel", None), ("classlevel", None), ("instancelevel_blip", None),
    ("instancelevel_random", None), ("instancelevel_blip", "rand_numb_add"),
    ("instancelevel_blip", "rand_word_add"), ("instancelevel_blip", "rand_word_repeat")])
def test_build_prompt_list_identical(tmp_path, style, augs):
    caps = {f"img{i}": [f"caption number {i} of a scene", "alt"] for i in range(12)}
    if style == "instancelevel_random":
        caps = {f"img{i}": [str([i + 1, i + 2, i + 3])] for i in range(6)}
    j = tmp_path / "caps.json"
    j.write_text(json.dumps(caps))
    kw = dict(seed=9, caption_json=j if style.startswith("instance") else None,
              rand_augs=augs, rand_aug_repeats=2)
    ref = JP.build_prompt_list(style, 7, tokenizer=JHash(1000, 16), **kw)
    assert TP.build_prompt_list(style, 7, tokenizer=THash(1000, 16), **kw) == ref


def test_host_streams_identical():
    for seed, name in ((0, "prompt_list"), (42, "prompt_augs"), (7, "x")):
        assert TR._stream_tag(name) == JR._stream_tag(name)
        np.testing.assert_array_equal(TR.host_python_rng(seed, name).integers(0, 1 << 30, 16),
                                      JR.host_python_rng(seed, name).integers(0, 1 << 30, 16))
    assert TR.stream_seed(0, "sample", 0) != TR.stream_seed(0, "sample", 1)
    a = torch.randn(4, generator=TR.stream_generator(3, "sample", 2))
    b = torch.randn(4, generator=TR.stream_generator(3, "sample", 2))
    assert torch.equal(a, b)


def test_config_parses_like_jax():
    argv = ["--resolution=512", "--num_inference_steps=20", "--sampler=ddim",
            "--guidance_scale=5", "--rand_augs=rand_word_add", "--fast.reuse_ratio=0.25",
            "--warm.dir=w", "--warm.warm_start=false"]
    ours = parse_cli(SampleConfig, argv)
    from dcr_tpu.core.config import parse_cli as j_parse_cli

    theirs = j_parse_cli(JSampleConfig, argv)
    for f in dataclasses.fields(SampleConfig):
        if f.name not in ("fast", "mesh", "warm"):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert dataclasses.asdict(ours.mesh) == dataclasses.asdict(theirs.mesh)
    assert dataclasses.asdict(ours.warm) == dataclasses.asdict(theirs.warm) == {
        "dir": "w", "warm_start": False}
    assert ours.fast.reuse_ratio == theirs.fast.reuse_ratio == 0.25
    model = from_dict(type(port_cfg(tiny_cfg())), dataclasses.asdict(tiny_cfg()))
    assert model == port_cfg(tiny_cfg())


def test_entry_points_refuse_without_gpu_or_with_fast(tiny, tmp_path, monkeypatch):
    _, _, _, tmodels = tiny
    cfg = SampleConfig(resolution=16, num_inference_steps=2, savepath=str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_make_sampler(cfg, tmodels)
        with pytest.raises(RuntimeError, match="cuda"):
            TPipe.generate(cfg, modelstyle="nolevel", models=tmodels)
        with pytest.raises(RuntimeError, match="cuda"):
            TPipe.load_checkpoint_models(tmp_path)
        monkeypatch.delenv("DCR_TPU_PLATFORM", raising=False)
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main([f"--model_path={tmp_path}", "--resolution=16"])
    # fast sampling runs (tests/test_torch_fastsample.py holds it to JAX);
    # knobs out of range are refused, as in the JAX package
    fast = SampleConfig(resolution=16, num_inference_steps=6,
                        fast=from_dict(type(cfg.fast), {"enabled": True}))
    tok = THash(1000, 16)
    ids = tok(["x"])
    out = t_make_sampler(fast, tmodels, device="cpu")(
        None, ids, np.broadcast_to(tok([""])[0], ids.shape).copy(),
        TR.stream_generator(0, "sample", 0))
    assert out.shape == (1, 16, 16, 3) and torch.isfinite(out).all()
    for bad in ({"enabled": True, "reuse_ratio": 0.9}, {"enabled": True, "order": 3}):
        with pytest.raises(ValueError):
            t_make_sampler(SampleConfig(resolution=16, fast=from_dict(type(cfg.fast), bad)),
                           tmodels, device="cpu")


def test_checkpoint_formats_not_ported_yet_are_refused(tmp_path):
    """A directory without weights raises FileNotFoundError, as in the JAX
    package, whether its model_index.json is a genuine diffusers one or an
    export's (genuine checkpoints load: tests/test_torch_checkpoint_interop.py);
    run dirs resolve to checkpoint/ or checkpoint_<iternum>/ as in the JAX
    pipeline."""
    (tmp_path / "model_index.json").write_text(json.dumps({"_class_name": "X"}))
    with pytest.raises(FileNotFoundError):
        TPipe.load_checkpoint_models(tmp_path, device="cpu")
    (tmp_path / "model_index.json").write_text(
        json.dumps({"model_config": dataclasses.asdict(tiny_cfg())}))
    with pytest.raises(FileNotFoundError):
        TPipe.load_checkpoint_models(tmp_path, device="cpu")
    empty = tmp_path / "empty"
    (empty / "unet").mkdir(parents=True)
    shutil.copy(tmp_path / "model_index.json", empty)
    with pytest.raises(FileNotFoundError, match="no params.npz or torch weights"):
        TPipe.load_checkpoint_models(empty, device="cpu")
    (tmp_path / "checkpoint_7" / "unet").mkdir(parents=True)
    assert TPipe.resolve_checkpoint(SampleConfig(model_path=str(tmp_path), iternum=7)) \
        == tmp_path / "checkpoint_7"
    with pytest.raises(FileNotFoundError):
        TPipe.resolve_checkpoint(SampleConfig(model_path=str(tmp_path)))


def test_cli_runs_on_cpu_when_asked(tiny, tmp_path, monkeypatch):
    cfg, _, params, _ = tiny
    export_hf_layout(tmp_path / "run" / "checkpoint", unet=params["unet"],
                     vae=params["vae"], text_encoder=params["text"],
                     model_config=dataclasses.asdict(cfg))
    (tmp_path / "run" / "config.json").write_text(
        json.dumps({"data": {"class_prompt": "classlevel"}}))
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    tcli.main([f"--model_path={tmp_path / 'run'}", f"--savepath={tmp_path / 'out'}",
               "--num_batches=2", "--im_batch=1", "--resolution=16",
               "--num_inference_steps=2"])
    assert len(list((tmp_path / "out" / "generations").glob("*.png"))) == 2
    assert (tmp_path / "out" / "prompts.txt").read_text().startswith("An image of ")
