"""The retrieval backbones beyond SSCD in the port: the DINO ViT
(``models/vit.py``), XCiT (``models/xcit.py``), the DINO ResNet-50
(``models/resnet.ResNet50Classifier``) and the CLIP image tower as the
embedder, with the ``layer > 1`` and splitloss token paths of ``run_eval``.

- The port's ViT, loaded from the torch names of
  ``tests/goldens/dino_reference.npz``, against the activations the
  executed reference recorded there (outputs at four input shapes, the
  interpolated position table through them, intermediate layers).
- ViT, XCiT and ResNet50Classifier against the JAX modules through the
  ``models/export`` bridges at small depths; XCiT also against the torch
  twin of ``tests/fixtures/torch_backbones.py``; the checkpoint loader
  (``eval/runner.load_backbone_params``) against the JAX converters.
- ``run_eval`` with ``pt_style="dino"`` (a ViT, an XCiT and the ResNet-50
  arch), ``pt_style="clip"``, and ``layer=2`` with splitloss, against the
  JAX ``run_eval`` on the same weights.
Bound: the f32 bar, atol 2e-4 and rtol 1e-3.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dcr_tpu.core.config import EvalConfig as JaxEvalConfig  # noqa: E402
from dcr_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer  # noqa: E402
from dcr_tpu.eval import runner as JRUN  # noqa: E402
from dcr_tpu.models import clip_image as JCLIP  # noqa: E402
from dcr_tpu.models import convert as JCV  # noqa: E402
from dcr_tpu.models import resnet as JRES  # noqa: E402
from dcr_tpu.models import vit as JVIT  # noqa: E402
from dcr_tpu.models import xcit as JXCIT  # noqa: E402
from dcr_tpu_torch.core import config as TC  # noqa: E402
from dcr_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from dcr_tpu_torch.eval import runner as RUN  # noqa: E402
from dcr_tpu_torch.models import clip_image as CLIP  # noqa: E402
from dcr_tpu_torch.models import export as EX  # noqa: E402
from dcr_tpu_torch.models import resnet as RES  # noqa: E402
from dcr_tpu_torch.models import vit as VIT  # noqa: E402
from dcr_tpu_torch.models import xcit as XCIT  # noqa: E402
from dcr_tpu_torch.sampling.png import write_png  # noqa: E402
from tests.fixtures.torch_backbones import TorchResNet50, TorchXCiT  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tiny models run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLD = Path(__file__).parent / "goldens" / "dino_reference.npz"
ATOL, RTOL = 2e-4, 1e-3


def _close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=ATOL, rtol=RTOL)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _randomize(module: torch.nn.Module, seed: int) -> None:
    """Random weights and random batch-norm statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)


# -- the DINO ViT against the executed reference ------------------------------

@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLD)
    sd = {k[len("sd/"):]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    model = VIT.VisionTransformer(patch_size=8, embed_dim=64, depth=3, num_heads=2, img_size=32)
    model.load_state_dict(sd, strict=True)
    return data, model.eval()


@pytest.mark.parametrize("case", ["native", "interp", "rect", "ragged"])
def test_vit_matches_reference_outputs(golden, case):
    """native 32 px; interp 48 px (the bicubic table); rect 16x64 (a square
    patch count from a non-square input still interpolates); ragged 36 px
    (the padding-0 patch conv floors the grid)."""
    data, model = golden
    with torch.inference_mode():
        _close(model(torch.from_numpy(data[f"x_{case}"])), data[f"out_{case}"])


def test_vit_matches_reference_intermediate_layers(golden):
    data, model = golden
    with torch.inference_mode():
        outs = model(torch.from_numpy(data["x_native"]), return_layers=2)
    assert len(outs) == 2
    _close(outs[0], data["inter_0"])
    _close(outs[1], data["inter_1"])


@pytest.mark.parametrize("grid,pixels", [((6, 6), (48, 48)), ((2, 8), (16, 64)),
                                         ((4, 4), (32, 39)), ((5, 3), (40, 24))])
def test_interpolated_position_table_matches_reference_bicubic_and_jax(golden, grid, pixels):
    """The table against the reference's own call (dino_vits.py:213-233:
    F.interpolate bicubic with the +0.1 scale factors) and against JAX."""
    data, _ = golden
    pos = torch.from_numpy(data["sd/pos_embed"])
    h, w = grid
    ours = VIT.interpolate_pos_embed(pos, h * w, grid, pixel_hw=pixels)
    side = int(math.sqrt(pos.shape[1] - 1))
    patch = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
    ref = F.interpolate(patch, scale_factor=((h + 0.1) / side, (w + 0.1) / side), mode="bicubic")
    ref = torch.cat([pos[:, :1], ref.permute(0, 2, 3, 1).reshape(1, h * w, -1)], dim=1)
    _close(ours, ref)
    _close(ours, JVIT.interpolate_pos_embed(jnp.asarray(pos.numpy()), h * w, grid,
                                            pixel_hw=pixels))
    assert VIT.interpolate_pos_embed(pos, 16, (4, 4), pixel_hw=(32, 32)) is pos


# -- the modules against the JAX package through the bridges -----------------

@pytest.mark.parametrize("size", [32, 48])
def test_vit_from_flax_matches_jax(size):
    jmodel = JVIT.VisionTransformer(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
    params = jax.jit(jmodel.init)(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))["params"]
    model = VIT.VisionTransformer(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
    model.load_state_dict(EX.vit_from_flax(_np_tree(params)), strict=True)
    x = np.random.default_rng(size).standard_normal((2, 3, size, size)).astype(np.float32)
    with torch.inference_mode():
        _close(model.eval()(torch.from_numpy(x)), jmodel.apply({"params": params}, _nhwc(x)))
        ours = model(torch.from_numpy(x), return_layers=2)
    ref = jmodel.apply({"params": params}, _nhwc(x), return_layers=2)
    for a, b in zip(ours, ref):
        _close(a, b)


def _jax_xcit(patch_size):
    return JXCIT.XCiT(patch_size=patch_size, embed_dim=64, depth=2, num_heads=4,
                      cls_attn_layers=2, eta=1.0)


def _port_xcit(patch_size):
    return XCIT.XCiT(patch_size=patch_size, embed_dim=64, depth=2, num_heads=4,
                     cls_attn_layers=2, eta=1.0)


@pytest.mark.parametrize("patch_size", [16, 8])
def test_xcit_from_flax_matches_jax(patch_size):
    jmodel = _jax_xcit(patch_size)
    params = jax.jit(jmodel.init)(jax.random.key(patch_size), jnp.zeros((1, 32, 32, 3)))["params"]
    # random batch-norm statistics, so a misplaced mean or var shows
    rng = np.random.default_rng(patch_size)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                         else np.asarray(v) + rng.normal(0, 0.05, v.shape)).astype(np.float32),
        params)
    model = _port_xcit(patch_size)
    model.load_state_dict(EX.xcit_from_flax(params), strict=True)
    x = np.random.default_rng(1).standard_normal((2, 3, 2 * patch_size, 3 * patch_size))
    x = x.astype(np.float32)
    with torch.inference_mode():
        _close(model.eval()(torch.from_numpy(x)), jax.jit(jmodel.apply)({"params": params}, _nhwc(x)))


@pytest.mark.parametrize("patch_size", [16, 8])
def test_xcit_loads_the_hub_names_and_matches_the_torch_twin(patch_size):
    twin = TorchXCiT(patch_size=patch_size, embed_dim=64, depth=2, num_heads=4,
                     cls_attn_layers=2, eta=1.0)
    _randomize(twin, 5 + patch_size)
    twin.eval()
    model = _port_xcit(patch_size)
    model.load_state_dict(twin.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 2 * patch_size, 3 * patch_size)).astype(np.float32))
    with torch.inference_mode():
        _close(model.eval()(x), twin(x))


def test_resnet50_classifier_from_flax_matches_jax():
    jmodel = JRES.ResNet50Classifier()
    params = jax.jit(jmodel.init)(jax.random.key(4), jnp.zeros((1, 64, 64, 3)))["params"]
    model = RES.ResNet50Classifier()
    model.load_state_dict(EX.resnet50_classifier_from_flax(_np_tree(params)), strict=True)
    x = np.random.default_rng(3).standard_normal((2, 3, 64, 64)).astype(np.float32)
    with torch.inference_mode():
        _close(model.eval()(torch.from_numpy(x)), jax.jit(jmodel.apply)({"params": params}, _nhwc(x)))


def test_dino_archs_match_jax_names():
    assert list(VIT.DINO_ARCHS) == list(JVIT.DINO_ARCHS)
    for name, (dim, depth) in {"dino_vits16": (384, 12), "dino_vitb8": (768, 12)}.items():
        model = VIT.DINO_ARCHS[name]()
        assert model.embed_dim == dim and model.depth == depth
    assert isinstance(VIT.DINO_ARCHS["dino_resnet50"](), RES.ResNet50Classifier)
    x = VIT.DINO_ARCHS["dino_xcit_medium_24_p8"]()
    assert len(x.blocks) == 24 and x.patch_size == 8
    assert float(x.blocks[0].gamma1[0]) == pytest.approx(1e-5)


# -- checkpoint files through the loaders of both packages -------------------

def test_load_backbone_params_reads_a_dino_vit_checkpoint(golden, tmp_path):
    data, _ = golden
    sd = {k[len("sd/"):]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    sd["head.weight"] = torch.zeros(3, 64)          # a hub checkpoint's extra keys
    torch.save(sd, tmp_path / "vit.pth")
    ours = RUN.load_backbone_params("dino", "dino_vits8", str(tmp_path / "vit.pth"))
    assert "head.weight" not in ours
    model = VIT.VisionTransformer(patch_size=8, embed_dim=64, depth=3, num_heads=2, img_size=32)
    model.load_state_dict(ours, strict=True)
    with torch.inference_mode():
        _close(model.eval()(torch.from_numpy(data["x_interp"])), data["out_interp"])


def test_load_backbone_params_reads_xcit_and_resnet_checkpoints(tmp_path):
    twin = TorchXCiT(patch_size=16, embed_dim=64, depth=2, num_heads=4)
    _randomize(twin, 1)
    torch.save(twin.state_dict(), tmp_path / "xcit.pth")
    ours = RUN.load_backbone_params("dino", "dino_xcit_small_12_p16", str(tmp_path / "xcit.pth"))
    ref = JRUN.load_backbone_params("dino", "dino_xcit_small_12_p16", str(tmp_path / "xcit.pth"))
    x = np.random.default_rng(0).standard_normal((1, 3, 32, 32)).astype(np.float32)
    model = XCIT.XCiT(patch_size=16, embed_dim=64, depth=2, num_heads=4)
    model.load_state_dict(ours, strict=True)
    jmodel = JXCIT.XCiT(patch_size=16, embed_dim=64, depth=2, num_heads=4)
    with torch.inference_mode():
        _close(model.eval()(torch.from_numpy(x)), jax.jit(jmodel.apply)({"params": ref}, _nhwc(x)))

    resnet = TorchResNet50()
    _randomize(resnet, 2)
    sd = dict(resnet.state_dict(), **{"fc.weight": torch.zeros(10, 2048),
                                      "fc.bias": torch.zeros(10)})
    torch.save(sd, tmp_path / "resnet.pth")
    ours = RUN.load_backbone_params("dino", "dino_resnet50", str(tmp_path / "resnet.pth"))
    ref = JRUN.load_backbone_params("dino", "dino_resnet50", str(tmp_path / "resnet.pth"))
    model = RES.ResNet50Classifier()
    model.load_state_dict(ours, strict=True)
    x = np.random.default_rng(1).standard_normal((1, 3, 64, 64)).astype(np.float32)
    with torch.inference_mode():
        _close(model.eval()(torch.from_numpy(x)),
               jax.jit(JRES.ResNet50Classifier().apply)({"params": ref}, _nhwc(x)))


def _openai_visual(width=64, layers=2, patch=8, tokens=17, embed=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def put(name, *shape, scale=0.05, offset=0.0):
        sd[name] = torch.randn(*shape, generator=g) * scale + offset

    put("visual.conv1.weight", width, 3, patch, patch)
    put("visual.class_embedding", width)
    put("visual.positional_embedding", tokens, width)
    for ln in ("visual.ln_pre", "visual.ln_post"):
        put(f"{ln}.weight", width, offset=1.0)
        put(f"{ln}.bias", width)
    put("visual.proj", width, embed)
    for i in range(layers):
        p = f"visual.transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            put(f"{p}.{ln}.weight", width, offset=1.0)
            put(f"{p}.{ln}.bias", width)
        put(f"{p}.attn.in_proj_weight", 3 * width, width)
        put(f"{p}.attn.in_proj_bias", 3 * width)
        put(f"{p}.attn.out_proj.weight", width, width)
        put(f"{p}.attn.out_proj.bias", width)
        put(f"{p}.mlp.c_fc.weight", 4 * width, width)
        put(f"{p}.mlp.c_fc.bias", 4 * width)
        put(f"{p}.mlp.c_proj.weight", width, 4 * width)
        put(f"{p}.mlp.c_proj.bias", width)
    return sd


def test_load_backbone_params_reads_an_openai_clip_archive(tmp_path):
    torch.save(_openai_visual(), tmp_path / "clip.pt")
    ours = RUN.load_backbone_params("clip", "", str(tmp_path / "clip.pt"))
    # the JAX loader assumes ViT-B/16's 12 blocks: its converter, told the depth
    ref = JCV.convert_clip_image(JCV.load_torch_file(tmp_path / "clip.pt"), layers=2)
    model = CLIP.CLIPImageTower(image_size=32, patch_size=8, width=64, layers=2, heads=4,
                                embed_dim=32)
    model.load_state_dict(ours, strict=True)
    jmodel = JCLIP.CLIPImageTower(patch_size=8, width=64, layers=2, heads=4, embed_dim=32)
    x = np.random.default_rng(5).uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    with torch.inference_mode():
        _close(model.eval()(torch.from_numpy(x)), jmodel.apply({"params": ref}, _nhwc(x)))
    (tmp_path / "bad.pt").write_bytes(b"")
    torch.save({"text_model.x": torch.zeros(1)}, tmp_path / "bad.pt")
    with pytest.raises(KeyError, match="neither an OpenAI CLIP archive"):
        RUN.load_backbone_params("clip", "", str(tmp_path / "bad.pt"))


def test_backbone_paths_refused_as_in_jax(tmp_path):
    with pytest.raises(ValueError, match="unknown dino arch"):
        RUN.build_backbone("dino", "dino_vitz", "cpu")
    with pytest.raises(ValueError, match="layer=2 needs a DINO ViT"):
        RUN.build_backbone("dino", "dino_resnet50", "cpu", layer=2)
    with pytest.raises(ValueError, match="layer=2 needs a DINO ViT"):
        RUN.build_backbone("clip", "", "cpu", layer=2)
    with pytest.raises(ValueError, match="flatten_tokens needs"):
        RUN.build_backbone("dino", "dino_vits16", "cpu", flatten_tokens=True)
    cfg = TC.EvalConfig(pt_style="dino", arch="dino_vits16", layer=2,
                        similarity_metric="splitloss", multiscale=True,
                        output_dir=str(tmp_path / "out"))
    with pytest.raises(ValueError, match="multiscale"):
        RUN.run_eval(cfg, device="cpu")
    assert not (tmp_path / "out").exists()          # refused before anything is written


# -- run_eval against the JAX run_eval ----------------------------------------

def _write_folders(root, n_gen=5, per_class=3):
    rng = np.random.default_rng(2)
    gen = root / "gens"
    gen.mkdir(parents=True)
    for i in range(n_gen):
        write_png(gen / f"{i}.png", rng.integers(0, 256, (37, 37, 3), dtype=np.uint8))
    for c in ("c0", "c1"):
        (root / "train" / c).mkdir(parents=True)
        for i in range(per_class):
            shape = (37, 40, 3) if i % 2 else (40, 37, 3)
            write_png(root / "train" / c / f"{i}.png", rng.integers(0, 256, shape, dtype=np.uint8))
    return gen, root / "train"


def _jax_params(pt_style, arch):
    model = JVIT.DINO_ARCHS[arch]() if pt_style == "dino" else JCLIP.CLIPImageTower()
    return _np_tree(jax.jit(model.init)(jax.random.key(11), jnp.zeros((1, 32, 32, 3)))["params"])


BRIDGES = {"dino_vits16": EX.vit_from_flax, "dino_xcit_small_12_p16": EX.xcit_from_flax,
           "dino_resnet50": EX.resnet50_classifier_from_flax, "": EX.clip_image_from_flax}


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dino_eval")
    return tmp, *_write_folders(tmp)


@pytest.mark.parametrize("pt_style,arch,extra", [
    ("dino", "dino_vits16", {}),
    ("dino", "dino_xcit_small_12_p16", {}),
    ("dino", "dino_resnet50", {}),
    ("clip", "", {}),
    ("dino", "dino_vits16", {"layer": 2, "similarity_metric": "splitloss"}),
    ("dino", "dino_vits16", {"layer": 2}),
])
def test_run_eval_matches_jax(folders, pt_style, arch, extra):
    tmp, gen, train = folders
    params = _jax_params(pt_style, arch or "")
    name = f"{pt_style}_{arch}_{'_'.join(f'{k}{v}' for k, v in extra.items())}"
    common = dict(query_dir=str(gen), values_dir=str(train), pt_style=pt_style,
                  arch=arch or "resnet50_disc", image_size=32, batch_size=4,
                  compute_fid=False, compute_clip_score=False, compute_complexity=False,
                  galleries=False, **extra)
    ref = JRUN.run_eval(JaxEvalConfig(output_dir=str(tmp / "jax" / name), **common),
                        backbone_params=params, tokenizer=JaxHashTokenizer(1000, 77))
    ours = RUN.run_eval(TC.EvalConfig(output_dir=str(tmp / "port" / name), **common),
                        device="cpu", backbone_state_dict=BRIDGES[arch](params),
                        tokenizer=HashTokenizer(1000, 77))
    assert list(ours) == list(ref)
    for key in ref:
        assert ours[key] == pytest.approx(ref[key], abs=ATOL, rel=RTOL), key
    sim = np.load(tmp / "port" / name / "similarity.npy")
    sim_ref = np.load(tmp / "jax" / name / "similarity.npy")
    np.testing.assert_allclose(sim, sim_ref, atol=ATOL, rtol=RTOL)
    top2 = np.sort(sim_ref, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 10 * ATOL            # argmax not decided by noise
    np.testing.assert_array_equal(sim.argmax(1)[decided], sim_ref.argmax(1)[decided])
