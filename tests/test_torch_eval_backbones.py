"""The port's FID Inception, VGG16 fc2 and CLIP scorer against the JAX
package's modules, at their fixed input sizes, on the CPU.

Weights go from a Flax init (kernels scaled to He's variance and batch-norm
statistics drawn at random, so a random network keeps its activations'
scale and a wrong statistic or layout shows) through the port's
``models/export.*_from_flax`` into a strict load. Inception and VGG16 also
load the torch twins' state dicts (``tests/fixtures/torch_backbones.py``,
pytorch-fid's and torchvision's names) as they are, and the CLIP scorer an
OpenAI-layout state dict through ``scorer_state_dict_from_openai``, held
against the JAX package's ``convert_openai_clip``. Bound: the f32 bar, atol
2e-4 * max(1, max|ref|) and rtol 1e-3.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dcr_tpu.data.tokenizer import HashTokenizer  # noqa: E402
from dcr_tpu.models import clip_image as JCLIP  # noqa: E402
from dcr_tpu.models.convert import (  # noqa: E402
    convert_inception_fid,
    convert_openai_clip,
    convert_vgg16,
    torch_state_dict_to_numpy,
)
from dcr_tpu.models.inception import InceptionV3FID as JaxInception  # noqa: E402
from dcr_tpu.models.vgg import VGG16Features as JaxVGG  # noqa: E402
from dcr_tpu_torch.models import clip_image as CLIP  # noqa: E402
from dcr_tpu_torch.models import export as EX  # noqa: E402
from dcr_tpu_torch.models.inception import InceptionV3FID  # noqa: E402
from dcr_tpu_torch.models.vgg import VGG16Features  # noqa: E402
from tests.fixtures.torch_backbones import TorchInceptionFID, TorchVGG16  # noqa: E402


def _close(ours: torch.Tensor, ref: np.ndarray) -> None:
    ours = ours.detach().numpy()
    atol = 2e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=1e-3)


def _randomized(params, seed: int):
    """He-scaled kernels; random batch-norm scale, bias, mean and var."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x, key = np.asarray(x), path[-1].key
        if key == "kernel" and x.ndim == 4:
            return x * np.float32(np.sqrt(2.0))
        if key in ("scale", "var"):
            return (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        if key == "mean" or (key == "bias" and len(path) > 1 and path[-2].key == "bn"):
            return (x + rng.uniform(-0.1, 0.1, x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _run(model: torch.nn.Module, x: np.ndarray) -> torch.Tensor:
    with torch.inference_mode():
        return model.eval()(_nchw(x))


def test_inception_from_flax_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (1, 299, 299, 3)).astype(np.float32)
    jmodel = JaxInception()
    params = _randomized(jmodel.init(jax.random.key(1), jnp.zeros((1, 299, 299, 3)))["params"], 1)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    port = InceptionV3FID()
    port.load_state_dict(EX.inception_from_flax(params), strict=True)
    assert np.abs(ref).max() > 1e-2          # the random network did not vanish
    _close(_run(port, img), ref)


def test_inception_loads_the_pytorch_fid_names_and_resizes():
    """The twin's state dict (pytorch-fid names, BatchNorm2d's batch counter
    included) loads strictly; a 128 px input is resized to 299 inside, as
    in the JAX module and the twin."""
    torch.manual_seed(0)
    twin = TorchInceptionFID()
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    twin.eval()
    port = InceptionV3FID()
    port.load_state_dict(twin.state_dict(), strict=True)
    img = np.random.default_rng(2).uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    with torch.no_grad():
        want = twin(_nchw(img))
    _close(_run(port, img), want.numpy())
    ref = np.asarray(JaxInception().apply(
        {"params": convert_inception_fid(torch_state_dict_to_numpy(twin))}, jnp.asarray(img)))
    _close(_run(port, img), ref)


def test_vgg16_weights_both_ways_match_jax():
    """fc2 features: a Flax init through vgg16_from_flax (which undoes the
    JAX converter's HWC column order), and the torchvision-named twin's
    state dict loaded as it is (CHW flatten) against convert_vgg16 -> JAX."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    jmodel = JaxVGG()
    params = _randomized(jmodel.init(jax.random.key(2), jnp.zeros((1, 224, 224, 3)))["params"], 2)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    port = VGG16Features()
    port.load_state_dict(EX.vgg16_from_flax(params), strict=True)
    assert np.abs(ref).max() > 1e-2
    _close(_run(port, img), ref)

    torch.manual_seed(1)
    twin = TorchVGG16().eval()
    port2 = VGG16Features()
    port2.load_state_dict(twin.state_dict(), strict=True)
    ref2 = np.asarray(jmodel.apply({"params": convert_vgg16(torch_state_dict_to_numpy(twin))},
                                   jnp.asarray(img)))
    _close(_run(port2, img), ref2)
    with torch.no_grad():
        _close(_run(port2, img), twin(_nchw(img)).numpy())


def _openai_clip_state_dict(seed: int) -> dict[str, torch.Tensor]:
    """A random state dict in OpenAI CLIP ViT-B/16's layout."""
    g = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}

    def put(name, *shape, scale=0.02, offset=0.0):
        sd[name] = torch.randn(*shape, generator=g) * scale + offset

    def block(prefix, d):
        for ln in ("ln_1", "ln_2"):
            put(f"{prefix}.{ln}.weight", d, scale=0.1, offset=1.0)
            put(f"{prefix}.{ln}.bias", d)
        put(f"{prefix}.attn.in_proj_weight", 3 * d, d)
        put(f"{prefix}.attn.in_proj_bias", 3 * d)
        put(f"{prefix}.attn.out_proj.weight", d, d)
        put(f"{prefix}.attn.out_proj.bias", d)
        put(f"{prefix}.mlp.c_fc.weight", 4 * d, d)
        put(f"{prefix}.mlp.c_fc.bias", 4 * d)
        put(f"{prefix}.mlp.c_proj.weight", d, 4 * d)
        put(f"{prefix}.mlp.c_proj.bias", d)

    put("visual.conv1.weight", 768, 3, 16, 16)
    put("visual.class_embedding", 768)
    put("visual.positional_embedding", 197, 768)
    for ln in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        d = 512 if ln == "ln_final" else 768
        put(f"{ln}.weight", d, scale=0.1, offset=1.0)
        put(f"{ln}.bias", d)
    put("visual.proj", 768, 512)
    for i in range(12):
        block(f"visual.transformer.resblocks.{i}", 768)
        block(f"transformer.resblocks.{i}", 512)
    put("token_embedding.weight", 49408, 512)
    put("positional_embedding", 77, 512)
    put("text_projection", 512, 512)
    return sd


@pytest.fixture(scope="module")
def clip_inputs():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (1, 224, 224, 3)).astype(np.float32)
    ids = HashTokenizer(49408, 77)(["a photo of a cat on a mat"])
    jscorer = JCLIP.make_clip_scorer()
    score = jax.jit(lambda p, im, t: (jscorer.image_features(p, im),
                                      jscorer.text_features(p, t), jscorer.score(p, im, t)))
    return img, ids, jscorer, score


def _port_scorer(sd) -> CLIP.CLIPScorer:
    scorer = CLIP.make_clip_scorer()
    missing, unexpected = scorer.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    return scorer


def _check_scorer(scorer, img, ids, ref) -> None:
    ref_img, ref_txt, ref_score = (np.asarray(r) for r in ref)
    x, t = _nchw(img), torch.from_numpy(ids).long()
    with torch.inference_mode():
        _close(scorer.image_features(x), ref_img)
        _close(scorer.text_features(t), ref_txt)
        got = scorer.score(x, t).numpy()
    np.testing.assert_allclose(got, ref_score, atol=1e-4)


def test_clip_scorer_from_flax_matches_jax(clip_inputs):
    img, ids, jscorer, score = clip_inputs
    params = JCLIP.init_clip_scorer(jax.random.key(7), jscorer)
    ref = score(params, jnp.asarray(img), jnp.asarray(ids))
    scorer = _port_scorer(EX.clip_scorer_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    _check_scorer(scorer, img, ids, ref)
    # the image tower alone, unnormalised
    with torch.inference_mode():
        tower = scorer.image(_nchw(img))
    want = np.asarray(jscorer.image_tower.apply({"params": params["image"]}, jnp.asarray(img)))
    _close(tower, want)


def test_clip_scorer_from_openai_archive_matches_jax(clip_inputs):
    img, ids, _, score = clip_inputs
    sd = _openai_clip_state_dict(5)
    params = convert_openai_clip({k: v.numpy() for k, v in sd.items()})
    ref = score(params, jnp.asarray(img), jnp.asarray(ids))
    _check_scorer(_port_scorer(CLIP.scorer_state_dict_from_openai(sd)), img, ids, ref)
