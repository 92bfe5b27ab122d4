"""PyTorch port: genuine diffusers checkpoints in, diffusers-loadable exports
out, against the JAX package.

- A directory the JAX ``export_hf_layout`` writes, made genuine as in
  tests/test_export.py (no params.npz, no native ``model_config``), loads in
  the port: state dicts equal the JAX params carried by ``*_from_flax`` bit
  for bit, ``model_config_from_diffusers`` gives the JAX dict, and a tiny
  sampler call equals the JAX sampler's from its own x_T at the f32 bar
  (atol 2e-4, rtol 1e-3). SD-2.x (linear projections, per-block heads) and
  SD-1.x (1x1-conv projections, one head count, ``hidden_act`` omitted).
- Variants a downloaded checkpoint may carry all load: the VAE under the
  to_q/to_k/to_v/to_out.0 names, a text dict without ``text_model.`` and
  with ``position_ids``, fp16 and bf16 weight files, ``.bin`` files.
- The port's export: safetensors equal to the JAX export's for the same
  params (keys, shapes, values); with params.npz removed it loads through
  the JAX package's torch-layout fallback and equals the JAX tree; its text
  encoder loads in ``transformers.CLIPTextModel.from_pretrained``; at
  SD-2.1 widths (modules on the meta device) its key/shape sets equal the
  vendored manifests tests/fixtures/sd21_*_keys.json.
- A config wider than its weights raises ValueError; SDXL depths are refused.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import safetensors.numpy as snp
import safetensors.torch as st
import torch

from dcr_tpu.core import checkpoint as JCK
from dcr_tpu.core import rng as JR
from dcr_tpu.core.config import MeshConfig, ModelConfig, SampleConfig as JSampleConfig
from dcr_tpu.data.tokenizer import HashTokenizer
from dcr_tpu.models.clip_text import init_clip_text
from dcr_tpu.models.unet2d import init_unet
from dcr_tpu.models.vae import init_vae
from dcr_tpu.parallel import mesh as pmesh
from dcr_tpu.sampling.pipeline import load_checkpoint_models as j_load
from dcr_tpu.sampling.sampler import make_sampler as j_make_sampler
from dcr_tpu_torch.cli import sample as tcli
from dcr_tpu_torch.core import checkpoint as TCK
from dcr_tpu_torch.core.config import ModelConfig as TModelConfig, SampleConfig
from dcr_tpu_torch.data.tokenizer import ClipBPETokenizer, load_tokenizer
from dcr_tpu_torch.models import convert as CV
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.models.clip_text import CLIPTextModel
from dcr_tpu_torch.models.unet2d import UNet2DCondition
from dcr_tpu_torch.models.vae import AutoencoderKL
from dcr_tpu_torch.sampling import pipeline as TPipe
from dcr_tpu_torch.sampling.sampler import make_sampler as t_make_sampler
from tests.test_torch_models import jax_params

ATOL, RTOL = 2e-4, 1e-3
FIXTURES = Path(__file__).parent / "fixtures"
COMPONENTS = {"unet": "unet", "vae": "vae", "text": "text_encoder"}


def _sd1x_tiny() -> ModelConfig:
    return dataclasses.replace(
        ModelConfig.sd1x(), sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
        attention_num_heads=2, norm_num_groups=8, cross_attention_dim=48,
        flash_attention=False, vae_block_out_channels=(16, 32), vae_layers_per_block=1,
        text_vocab_size=1000, text_hidden_size=48, text_layers=2, text_heads=4,
        text_max_length=16)


CONFIGS = {"sd2": ModelConfig.tiny, "sd1x": _sd1x_tiny}


def _jax_params(cfg: ModelConfig, seed: int) -> dict:
    return {"unet": jax_params(init_unet, cfg, seed), "vae": jax_params(init_vae, cfg, seed + 1),
            "text": jax_params(init_clip_text, cfg, seed + 2)}


def _expected_state_dicts(cfg: ModelConfig, params: dict) -> dict:
    return {"unet": EX.unet_from_flax(params["unet"], len(cfg.block_out_channels)),
            "vae": EX.vae_from_flax(params["vae"]), "text": EX.text_from_flax(params["text"])}


def _scheduler_config(cfg) -> dict:
    return {"num_train_timesteps": cfg.num_train_timesteps, "beta_schedule": cfg.beta_schedule,
            "beta_start": cfg.beta_start, "beta_end": cfg.beta_end,
            "prediction_type": cfg.prediction_type}


def make_genuine(ckpt: Path, drop_hidden_act: bool = False) -> None:
    """Make an export indistinguishable from a downloaded checkpoint
    (tests/test_export.py:356-360)."""
    for comp in COMPONENTS.values():
        (ckpt / comp / "params.npz").unlink()
    index = json.loads((ckpt / "model_index.json").read_text())
    del index["model_config"]
    (ckpt / "model_index.json").write_text(json.dumps(index))
    if drop_hidden_act:        # transformers omits keys equal to its defaults
        path = ckpt / "text_encoder" / "config.json"
        text = json.loads(path.read_text())
        assert text.pop("hidden_act") == "quick_gelu"
        path.write_text(json.dumps(text))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def genuine(request, tmp_path_factory):
    """A genuine diffusers directory written by the JAX package."""
    cfg = CONFIGS[request.param]()
    params = _jax_params(cfg, 40)
    ckpt = tmp_path_factory.mktemp(f"genuine_{request.param}") / "ckpt"
    JCK.export_hf_layout(ckpt, unet=params["unet"], vae=params["vae"],
                         text_encoder=params["text"], scheduler_config=_scheduler_config(cfg),
                         model_config=dataclasses.asdict(cfg))
    make_genuine(ckpt, drop_hidden_act=request.param == "sd1x")
    return request.param, cfg, params, ckpt


def test_genuine_checkpoint_loads_bit_for_bit(genuine):
    name, cfg, params, ckpt = genuine
    mine = TCK.model_config_from_diffusers(ckpt)
    assert mine == JCK.model_config_from_diffusers(ckpt)
    models, sds, model_cfg = TPipe.load_checkpoint_models(ckpt, device="cpu")
    assert model_cfg.text_act == cfg.text_act
    assert model_cfg.use_linear_projection == cfg.use_linear_projection == (name == "sd2")
    assert model_cfg.attention_num_heads == cfg.attention_num_heads
    want = _expected_state_dicts(cfg, params)
    for comp, module in (("unet", models.unet), ("vae", models.vae),
                         ("text", models.text_encoder)):
        assert set(sds[comp]) == set(want[comp]), comp
        for k, v in want[comp].items():
            assert sds[comp][k].dtype == torch.float32 and torch.equal(sds[comp][k], v), k
        loaded = module.state_dict()
        assert all(torch.equal(loaded[k], v) for k, v in want[comp].items()), comp
    if name == "sd1x":
        assert sds["unet"]["mid_block.attentions.0.proj_in.weight"].ndim == 4


def test_genuine_checkpoint_samples_like_jax(genuine):
    _, cfg, _, ckpt = genuine
    jmodels, jparams, _ = j_load(ckpt)
    kw = dict(resolution=16, num_inference_steps=4, guidance_scale=7.5, sampler="dpm++",
              seed=0)
    tok = HashTokenizer(cfg.text_vocab_size, cfg.text_max_length)
    ids = tok(["a church", "a garbage truck"])
    unc = np.broadcast_to(tok([""])[0], ids.shape).copy()
    mesh = pmesh.make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    ref = np.asarray(j_make_sampler(JSampleConfig(**kw), jmodels, mesh)(
        jparams, ids, unc, JR.root_key(7)))
    x_t = np.asarray(jax.random.normal(JR.stream_key(JR.root_key(7), "init"),
                                       (2, 8, 8, cfg.vae_latent_channels)))
    tmodels, _, _ = TPipe.load_checkpoint_models(ckpt, device="cpu")
    out = t_make_sampler(SampleConfig(**kw), tmodels, device="cpu")(None, ids, unc, None,
                                                                     init_latents=x_t)
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def sd2_genuine(tmp_path_factory):
    cfg = ModelConfig.tiny()
    params = _jax_params(cfg, 50)
    ckpt = tmp_path_factory.mktemp("sd2_variants") / "ckpt"
    JCK.export_hf_layout(ckpt, unet=params["unet"], vae=params["vae"],
                         text_encoder=params["text"], scheduler_config=_scheduler_config(cfg),
                         model_config=dataclasses.asdict(cfg))
    make_genuine(ckpt)
    return cfg, params, ckpt


_NEW_VAE_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def _rewrite(ckpt: Path, comp: str, variant: str) -> None:
    """Replace one component's weight file with a variant."""
    sub = ckpt / comp
    src = sub / TCK.WEIGHT_FILE[comp]
    sd = st.load_file(str(src))
    src.unlink()
    stem = TCK.WEIGHT_FILE[comp].rsplit(".", 1)[0]
    if variant == "vae_new_names":
        sd = {re.sub(r"\.(query|key|value|proj_attn)\.", lambda m: f".{_NEW_VAE_NAMES[m[1]]}.",
                     k): v for k, v in sd.items()}
        assert sum(".to_out.0." in k for k in sd) == 4     # encoder + decoder, w + b
        st.save_file(sd, str(sub / f"{stem}.safetensors"))
    elif variant == "text_no_prefix_position_ids":
        sd = {k.removeprefix("text_model."): v for k, v in sd.items()}
        sd["embeddings.position_ids"] = torch.arange(16)[None]
        st.save_file(sd, str(sub / f"{stem}.safetensors"))
    elif variant in ("fp16", "bf16"):
        dtype = torch.float16 if variant == "fp16" else torch.bfloat16
        st.save_file({k: v.to(dtype) for k, v in sd.items()}, str(sub / f"{stem}.fp16.safetensors"))
    elif variant == "bin":
        name = "pytorch_model.bin" if comp == "text_encoder" else f"{stem}.bin"
        torch.save(sd, sub / name)


@pytest.mark.parametrize("variant,comp", [
    ("vae_new_names", "vae"), ("text_no_prefix_position_ids", "text_encoder"),
    ("fp16", "unet"), ("bf16", "vae"), ("bin", "unet"), ("bin", "text_encoder")])
def test_checkpoint_variants_load(sd2_genuine, tmp_path, variant, comp):
    cfg, params, src = sd2_genuine
    ckpt = tmp_path / "ckpt"
    shutil.copytree(src, ckpt)
    _rewrite(ckpt, comp, variant)
    _, sds, _ = TPipe.load_checkpoint_models(ckpt, device="cpu")
    key = {v: k for k, v in COMPONENTS.items()}[comp]
    want = _expected_state_dicts(cfg, params)[key]
    if variant in ("fp16", "bf16"):
        dtype = torch.float16 if variant == "fp16" else torch.bfloat16
        want = {k: v.to(dtype).float() for k, v in want.items()}
    assert set(sds[key]) == set(want)
    for k, v in want.items():
        assert sds[key][k].dtype == torch.float32 and torch.equal(sds[key][k], v), k


def test_genuine_checkpoint_samples_through_the_cli(sd2_genuine, tmp_path, monkeypatch):
    """dcr-sample on a downloaded-style directory: its tokenizer/ is the
    checkpoint's BPE files; no manual step."""
    _, _, src = sd2_genuine
    ckpt = tmp_path / "sd"
    shutil.copytree(src, ckpt)
    shutil.copytree(FIXTURES / "bpe", ckpt / "tokenizer")
    assert isinstance(load_tokenizer(ckpt), ClipBPETokenizer)
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    tcli.main([f"--model_path={ckpt}", f"--savepath={tmp_path / 'out'}", "--num_batches=2",
               "--im_batch=1", "--resolution=16", "--num_inference_steps=2",
               "--modelstyle=classlevel"])
    assert len(list((tmp_path / "out" / "generations").glob("*.png"))) == 2


def test_mismatched_or_sdxl_checkpoints_are_refused(sd2_genuine, tmp_path):
    _, _, src = sd2_genuine
    ckpt = tmp_path / "wide"
    shutil.copytree(src, ckpt)
    path = ckpt / "unet" / "config.json"
    unet = json.loads(path.read_text())
    path.write_text(json.dumps({**unet, "block_out_channels": [64, 128]}))
    with pytest.raises(ValueError, match="does not match the architecture"):
        TPipe.load_checkpoint_models(ckpt, device="cpu")
    path.write_text(json.dumps({**unet, "transformer_layers_per_block": [1, 2, 10]}))
    with pytest.raises(ValueError, match="SDXL"):
        TPipe.load_checkpoint_models(ckpt, device="cpu")
    with pytest.raises(ValueError, match="SDXL"):
        TCK._uniform_transformer_layers({"transformer_layers_per_block": [1, 2, 10]})


@pytest.fixture(scope="module")
def port_export(tmp_path_factory):
    """The port's export and the JAX export of the same params."""
    cfg = ModelConfig.tiny()
    params = _jax_params(cfg, 60)
    sds = _expected_state_dicts(cfg, params)
    root = tmp_path_factory.mktemp("port_export")
    TCK.export_hf_layout(root / "port", unet=sds["unet"], vae=sds["vae"],
                         text_encoder=sds["text"], scheduler_config=_scheduler_config(cfg),
                         model_config=dataclasses.asdict(cfg))
    JCK.export_hf_layout(root / "jax", unet=params["unet"], vae=params["vae"],
                         text_encoder=params["text"], scheduler_config=_scheduler_config(cfg),
                         model_config=dataclasses.asdict(cfg))
    return cfg, params, sds, root


@pytest.mark.parametrize("comp", sorted(COMPONENTS.values()))
def test_port_export_equals_the_jax_export(port_export, comp):
    _, _, _, root = port_export
    name = TCK.WEIGHT_FILE[comp]
    mine, theirs = (snp.load_file(str(root / w / comp / name)) for w in ("port", "jax"))
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        assert mine[k].dtype == np.float32 and mine[k].shape == v.shape, k
        np.testing.assert_array_equal(mine[k], v.astype(np.float32), err_msg=k)
    for f in ("config.json",):
        assert json.loads((root / "port" / comp / f).read_text()) == \
            json.loads((root / "jax" / comp / f).read_text())


def test_port_export_loads_in_jax_through_the_torch_layout(port_export, tmp_path):
    _, params, _, root = port_export
    ckpt = tmp_path / "ckpt"
    shutil.copytree(root / "port", ckpt)
    make_genuine(ckpt)
    for key, comp in COMPONENTS.items():
        tree = JCK.import_hf_layout(ckpt, comp)
        want = dict(EX._leaves(params[key]))
        got = dict(EX._leaves(tree))
        assert set(got) == set(want), comp
        for k, v in want.items():       # the port holds f32: the tree at f32
            assert got[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], v.astype(np.float32), err_msg=f"{comp}/{k}")
    _, jparams, _ = j_load(ckpt)
    assert jparams["text"]["final_layer_norm"]["scale"].shape == (32,)


def test_export_without_torch_weights_loads_through_params_npz(port_export, tmp_path):
    _, _, sds, root = port_export
    ckpt = tmp_path / "ckpt"
    shutil.copytree(root / "port", ckpt)
    for f in ckpt.rglob("*.safetensors"):
        f.unlink()
    models, _, _ = TPipe.load_checkpoint_models(ckpt, device="cpu")
    for key, module in (("unet", models.unet), ("vae", models.vae),
                        ("text", models.text_encoder)):
        got = module.state_dict()
        assert set(got) == set(sds[key]), key
        for k, t in sds[key].items():
            assert torch.equal(got[k], t), f"{key}/{k}"


@pytest.mark.parametrize("comp,key", [("unet", "block_out_channels"),
                                      ("text_encoder", "text_heads")])
def test_port_export_needs_the_widths_its_weights_do_not_hold(port_export, tmp_path,
                                                              comp, key):
    cfg, _, sds, _ = port_export
    sd = sds["unet" if comp == "unet" else "text"]
    partial = {k: v for k, v in dataclasses.asdict(cfg).items() if k != key}
    for mc in (partial, None):
        with pytest.raises(ValueError, match=key):
            TCK.export_hf_layout(tmp_path / "ckpt", **{comp: sd}, model_config=mc)


def test_port_export_text_encoder_loads_in_transformers(port_export):
    from transformers import CLIPTextModel as HFCLIPText

    cfg, _, sds, root = port_export
    hf = HFCLIPText.from_pretrained(str(root / "port" / "text_encoder"),
                                    local_files_only=True).eval()
    port = CLIPTextModel(TModelConfig(**dataclasses.asdict(cfg))).eval()
    port.load_state_dict(sds["text"], strict=True)
    ids = torch.tensor([[5, 7, 9, 11, 2] + [0] * 11])
    with torch.no_grad():
        want = hf(input_ids=ids).last_hidden_state
        got = port(ids).last_hidden_state
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def _manifest(name: str) -> dict[str, list[int]]:
    return json.loads((FIXTURES / f"sd21_{name}_keys.json").read_text())


@pytest.mark.parametrize("comp,module", [("unet", UNet2DCondition), ("vae", AutoencoderKL),
                                         ("text_encoder", CLIPTextModel)])
def test_sd21_widths_match_the_vendored_manifests(comp, module):
    """At SD-2.1 widths (modules on the meta device: no weights made), the
    state dict the export writes has the real checkpoint's keys and shapes,
    and the real checkpoint's names (f16, as published) convert onto it."""
    manifest = _manifest({"text_encoder": "text"}.get(comp, comp))
    with torch.device("meta"):
        sd = module(TModelConfig()).state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == manifest
    published = {k: torch.empty(s, dtype=torch.float16, device="meta")
                 for k, s in manifest.items()}
    assert CV.check_state_dict(sd, CV.CONVERTERS[comp](published)) == []
