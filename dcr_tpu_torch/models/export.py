"""Carry parameter trees between the JAX package and the port's state dicts.

Own copy of the name maps and layout rules of ``dcr_tpu/models/export.py``:
each ``*_from_flax`` takes a Flax param tree (nested dicts of numpy arrays,
as ``params.npz`` holds them) and returns a torch state dict under diffusers
/ transformers naming that the port's modules load with ``strict=True``.
The eval backbones' (``sscd_from_flax``, ``inception_from_flax``,
``vgg16_from_flax``, ``clip_image_from_flax``, ``clip_scorer_from_flax``)
are the inverses of ``dcr_tpu/models/convert.py``'s ``convert_sscd``,
``convert_inception_fid``, ``convert_vgg16``, ``convert_clip_image`` and
``convert_openai_clip``: frozen batch norm's ``scale``/``mean``/``var``
become ``weight``/``running_mean``/``running_var``.
Dense kernels [in, out] become [out, in]; conv kernels HWIO become OIHW.
Each ``*_to_flax`` is the inverse, for the port's own exports: a round trip
gives back the same tree, key for key and bit for bit.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Iterator

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, np.asarray(tree)


def _torch_leaf(path: str, value: np.ndarray,
                name_map: Callable[[str], str]) -> tuple[str, np.ndarray]:
    """One Flax leaf -> (torch key, torch-layout array)."""
    parts = path.split("/")
    leaf = parts[-1]
    prefix = name_map("/".join(parts[:-1]))
    if leaf == "kernel":
        if value.ndim == 4:                       # HWIO -> OIHW
            return f"{prefix}.weight", np.transpose(value, (3, 2, 0, 1))
        return f"{prefix}.weight", np.transpose(value, (1, 0))
    if leaf == "scale":
        return f"{prefix}.weight", value
    return f"{prefix}.{leaf}", value


def _to_torch(sd: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def _tree_to_sd(params: Any, name_map: Callable[[str], str]) -> dict[str, torch.Tensor]:
    return _to_torch(dict(_torch_leaf(p, v, name_map) for p, v in _leaves(params)))


def unet_name_map(n_blocks: int) -> Callable[[str], str]:
    def f(p: str) -> str:
        p = re.sub(r"^down_(\d+)_res_(\d+)", r"down_blocks.\1.resnets.\2", p)
        p = re.sub(r"^down_(\d+)_attn_(\d+)", r"down_blocks.\1.attentions.\2", p)
        p = re.sub(r"^down_(\d+)_downsample", r"down_blocks.\1.downsamplers.0", p)
        p = re.sub(r"^up_(\d+)_res_(\d+)",
                   lambda m: f"up_blocks.{n_blocks - 1 - int(m.group(1))}"
                             f".resnets.{m.group(2)}", p)
        p = re.sub(r"^up_(\d+)_attn_(\d+)",
                   lambda m: f"up_blocks.{n_blocks - 1 - int(m.group(1))}"
                             f".attentions.{m.group(2)}", p)
        p = re.sub(r"^up_(\d+)_upsample",
                   lambda m: f"up_blocks.{n_blocks - 1 - int(m.group(1))}"
                             f".upsamplers.0", p)
        p = re.sub(r"^mid_res_(\d)", r"mid_block.resnets.\1", p)
        p = re.sub(r"^mid_attn", r"mid_block.attentions.0", p)
        p = re.sub(r"blocks_(\d+)", r"transformer_blocks.\1", p)
        p = re.sub(r"/(attn\d)/to_out", r"/\1/to_out.0", p)
        p = p.replace("/ff/proj_in", "/ff/net.0.proj")
        p = p.replace("/ff/proj_out", "/ff/net.2")
        p = p.replace("/GroupNorm_0", "")
        return p.replace("/", ".")
    return f


def unet_from_flax(params: Any, n_blocks: int) -> dict[str, torch.Tensor]:
    """UNet2DCondition tree -> the port's UNet2DCondition state dict."""
    return _tree_to_sd(params, unet_name_map(n_blocks))


_VAE_ATTN_OLD = {"to_q": "query", "to_k": "key", "to_v": "value",
                 "to_out": "proj_attn"}


def vae_name_map(p: str) -> str:
    p = re.sub(r"^encoder/down_(\d+)_res_(\d+)", r"encoder.down_blocks.\1.resnets.\2", p)
    p = re.sub(r"^encoder/down_(\d+)_downsample", r"encoder.down_blocks.\1.downsamplers.0", p)
    p = re.sub(r"^(encoder|decoder)/mid_res_(\d)", r"\1.mid_block.resnets.\2", p)
    p = re.sub(r"^(encoder|decoder)/mid_attn", r"\1.mid_block.attentions.0", p)
    p = re.sub(r"^decoder/up_(\d+)_res_(\d+)", r"decoder.up_blocks.\1.resnets.\2", p)
    p = re.sub(r"^decoder/up_(\d+)_upsample", r"decoder.up_blocks.\1.upsamplers.0", p)
    p = p.replace("encoder/quant_conv", "quant_conv")
    p = p.replace("decoder/post_quant_conv", "post_quant_conv")
    p = re.sub(r"/(to_q|to_k|to_v|to_out)$", lambda m: "/" + _VAE_ATTN_OLD[m.group(1)], p)
    p = p.replace("/GroupNorm_0", "")
    return p.replace("/", ".")


def vae_from_flax(params: Any) -> dict[str, torch.Tensor]:
    """AutoencoderKL tree -> the port's AutoencoderKL state dict."""
    return _tree_to_sd(params, vae_name_map)


def text_from_flax(params: Any) -> dict[str, torch.Tensor]:
    """CLIPTextModel tree -> the port's CLIPTextModel state dict. The flax
    MultiHeadDotProductAttention kernels [D, H, hd] / [H, hd, D] fold back
    into [D, D] linears."""
    sd: dict[str, np.ndarray] = {}
    p = "text_model."
    sd[f"{p}embeddings.token_embedding.weight"] = np.asarray(
        params["token_embedding"]["embedding"])
    sd[f"{p}embeddings.position_embedding.weight"] = np.asarray(
        params["position_embedding"])
    names = {"query": "q_proj", "key": "k_proj", "value": "v_proj"}
    i = 0
    while f"layers_{i}" in params:
        lp = params[f"layers_{i}"]
        dst = f"{p}encoder.layers.{i}"
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            sd[f"{dst}.{theirs}.weight"] = np.asarray(lp[ours]["scale"])
            sd[f"{dst}.{theirs}.bias"] = np.asarray(lp[ours]["bias"])
        d = np.asarray(lp["attn"]["query"]["kernel"]).shape[0]
        for ours, theirs in names.items():
            w = np.asarray(lp["attn"][ours]["kernel"]).reshape(d, d)  # [in, out]
            sd[f"{dst}.self_attn.{theirs}.weight"] = w.T
            sd[f"{dst}.self_attn.{theirs}.bias"] = np.asarray(lp["attn"][ours]["bias"]).reshape(d)
        wo = np.asarray(lp["attn"]["out"]["kernel"]).reshape(d, d)     # [in, out]
        sd[f"{dst}.self_attn.out_proj.weight"] = wo.T
        sd[f"{dst}.self_attn.out_proj.bias"] = np.asarray(lp["attn"]["out"]["bias"])
        for fc in ("fc1", "fc2"):
            sd[f"{dst}.mlp.{fc}.weight"] = np.asarray(lp[fc]["kernel"]).T
            sd[f"{dst}.mlp.{fc}.bias"] = np.asarray(lp[fc]["bias"])
        i += 1
    sd[f"{p}final_layer_norm.weight"] = np.asarray(params["final_layer_norm"]["scale"])
    sd[f"{p}final_layer_norm.bias"] = np.asarray(params["final_layer_norm"]["bias"])
    return _to_torch(sd)


# ---------------------------------------------------------------------------
# the eval backbones
# ---------------------------------------------------------------------------

_BN_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _bn_tree_to_sd(params: Any, name_map: Callable[[str], str]) -> dict[str, torch.Tensor]:
    """:func:`_tree_to_sd` for trees with frozen batch norms, whose ``mean``
    and ``var`` leaves are ``running_mean`` and ``running_var`` in torch."""
    sd = {}
    for path, value in _leaves(params):
        key, arr = _torch_leaf(path, value, name_map)
        prefix, leaf = key.rsplit(".", 1)
        sd[f"{prefix}.{_BN_LEAVES.get(leaf, leaf)}"] = arr
    return _to_torch(sd)


def sscd_name_map(p: str) -> str:
    p = re.sub(r"layer(\d+)_(\d+)", r"layer\1.\2", p)
    p = p.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
    return p.replace("/", ".")


def sscd_from_flax(params: Any) -> dict[str, torch.Tensor]:
    """SSCDModel tree (``backbone``, ``embeddings``) -> the port's SSCDModel
    state dict, the SSCD TorchScript archive's names."""
    return _bn_tree_to_sd(params, sscd_name_map)


def inception_from_flax(params: Any) -> dict[str, torch.Tensor]:
    """InceptionV3FID tree -> the port's InceptionV3FID state dict (the
    pt_inception-2015-12-05 names: the JAX modules carry the same ones)."""
    return _bn_tree_to_sd(params, lambda p: p.replace("/", "."))


def vgg16_from_flax(params: Any) -> dict[str, torch.Tensor]:
    """VGG16Features tree -> the port's VGG16Features state dict (torchvision
    names). The JAX fc1 reads the 7x7x512 map flattened as (H, W, C), the
    port's as (C, H, W): fc1's input columns are reordered back."""
    from dcr_tpu_torch.models.vgg import conv_indices

    idx = conv_indices()
    names = {f"conv_{i}": f"features.{j}" for i, j in enumerate(idx)}
    names.update(fc1="classifier.0", fc2="classifier.3")
    sd = {}
    for path, value in _leaves(params):
        key, arr = _torch_leaf(path, value, lambda p: names[p])
        if key == "classifier.0.weight":               # [4096, (h, w, c)] -> [4096, (c, h, w)]
            arr = arr.reshape(-1, 7, 7, 512).transpose(0, 3, 1, 2).reshape(arr.shape[0], -1)
        sd[key] = arr
    return _to_torch(sd)


def _clip_block_name_map(p: str) -> str:
    p = re.sub(r"^blocks_(\d+)", r"blocks.\1", p)
    p = re.sub(r"/(qkv|proj)$", r"/attn/\1", p)
    p = re.sub(r"/(fc1|fc2)$", r"/mlp/\1", p)
    return p.replace("/", ".")


def clip_image_from_flax(params: Any) -> dict[str, torch.Tensor]:
    """CLIPImageTower tree -> the port's CLIPImageTower state dict. The
    class embedding, positional table and projection are plain parameters
    in both packages and copy as they are ([width], [1, tokens, width],
    [width, embed_dim])."""
    plain = {k: np.asarray(params[k]) for k in ("class_embedding", "pos_embed", "proj")}
    rest = {k: v for k, v in params.items() if k not in plain}
    sd = dict(_to_torch(plain))
    sd.update(_tree_to_sd(rest, _clip_block_name_map))
    return sd


def clip_scorer_from_flax(params: Any) -> dict[str, torch.Tensor]:
    """CLIPScorer params ``{image, text, text_projection}`` -> the port's
    CLIPScorer state dict."""
    sd = {f"image.{k}": v for k, v in clip_image_from_flax(params["image"]).items()}
    sd.update({f"text.{k}": v for k, v in text_from_flax(params["text"]).items()})
    sd.update(_to_torch({"text_projection": np.asarray(params["text_projection"])}))
    return sd


# ---------------------------------------------------------------------------
# the inverse: the port's state dicts -> Flax trees of numpy arrays
# ---------------------------------------------------------------------------

def _nest(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        cur = tree
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = value
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _sd_to_tree(sd: dict[str, torch.Tensor],
                inverse_map: Callable[[str], str]) -> dict:
    """Inverse of :func:`_tree_to_sd`. A module's kind comes from its weight's
    rank: 4 a conv (OIHW -> HWIO), 2 a dense ([out, in] -> [in, out]), 1 a
    norm (``weight`` -> ``scale``). Every GroupNorm outside the transformer
    blocks sits one level down in Flax, under ``GroupNorm_0``."""
    flat: dict[str, np.ndarray] = {}
    for key, value in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        rank = sd[f"{prefix}.weight"].ndim
        path = inverse_map(prefix)
        if rank == 1 and "transformer_blocks" not in prefix:
            path += "/GroupNorm_0"
        arr = _numpy(value)
        if leaf == "weight":
            leaf = {4: "kernel", 2: "kernel", 1: "scale"}[rank]
            arr = np.transpose(arr, (2, 3, 1, 0)) if rank == 4 else (arr.T if rank == 2 else arr)
        flat[f"{path}/{leaf}"] = np.ascontiguousarray(arr)
    return _nest(flat)


def unet_inverse_name_map(n_blocks: int) -> Callable[[str], str]:
    def f(p: str) -> str:
        p = re.sub(r"^down_blocks\.(\d+)\.resnets\.(\d+)", r"down_\1_res_\2", p)
        p = re.sub(r"^down_blocks\.(\d+)\.attentions\.(\d+)", r"down_\1_attn_\2", p)
        p = re.sub(r"^down_blocks\.(\d+)\.downsamplers\.0", r"down_\1_downsample", p)
        p = re.sub(r"^up_blocks\.(\d+)\.resnets\.(\d+)",
                   lambda m: f"up_{n_blocks - 1 - int(m.group(1))}_res_{m.group(2)}", p)
        p = re.sub(r"^up_blocks\.(\d+)\.attentions\.(\d+)",
                   lambda m: f"up_{n_blocks - 1 - int(m.group(1))}_attn_{m.group(2)}", p)
        p = re.sub(r"^up_blocks\.(\d+)\.upsamplers\.0",
                   lambda m: f"up_{n_blocks - 1 - int(m.group(1))}_upsample", p)
        p = re.sub(r"^mid_block\.resnets\.(\d)", r"mid_res_\1", p)
        p = p.replace("mid_block.attentions.0", "mid_attn")
        p = re.sub(r"transformer_blocks\.(\d+)", r"blocks_\1", p)
        p = re.sub(r"\.(attn\d)\.to_out\.0$", r".\1.to_out", p)
        p = p.replace(".ff.net.0.proj", ".ff.proj_in").replace(".ff.net.2", ".ff.proj_out")
        return p.replace(".", "/")
    return f


def unet_to_flax(sd: dict[str, torch.Tensor], n_blocks: int) -> dict:
    """The port's UNet2DCondition state dict -> the JAX package's param tree."""
    return _sd_to_tree(sd, unet_inverse_name_map(n_blocks))


_VAE_ATTN_NEW = {v: k for k, v in _VAE_ATTN_OLD.items()}


def vae_inverse_name_map(p: str) -> str:
    p = re.sub(r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)", r"encoder.down_\1_res_\2", p)
    p = re.sub(r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0", r"encoder.down_\1_downsample", p)
    p = re.sub(r"^(encoder|decoder)\.mid_block\.resnets\.(\d)", r"\1.mid_res_\2", p)
    p = re.sub(r"^(encoder|decoder)\.mid_block\.attentions\.0", r"\1.mid_attn", p)
    p = re.sub(r"^decoder\.up_blocks\.(\d+)\.resnets\.(\d+)", r"decoder.up_\1_res_\2", p)
    p = re.sub(r"^decoder\.up_blocks\.(\d+)\.upsamplers\.0", r"decoder.up_\1_upsample", p)
    p = re.sub(r"^quant_conv", "encoder.quant_conv", p)
    p = re.sub(r"^post_quant_conv", "decoder.post_quant_conv", p)
    p = re.sub(r"\.(query|key|value|proj_attn)$", lambda m: "." + _VAE_ATTN_NEW[m.group(1)], p)
    return p.replace(".", "/")


def vae_to_flax(sd: dict[str, torch.Tensor]) -> dict:
    """The port's AutoencoderKL state dict -> the JAX package's param tree."""
    return _sd_to_tree(sd, vae_inverse_name_map)


def text_to_flax(sd: dict[str, torch.Tensor], heads: int) -> dict:
    """The port's CLIPTextModel state dict -> the JAX package's param tree;
    the [D, D] attention linears unfold into flax's [D, H, hd] / [H, hd, D]."""
    p = "text_model."
    g = lambda k: _numpy(sd[f"{p}{k}"])
    tree: dict = {
        "token_embedding": {"embedding": g("embeddings.token_embedding.weight")},
        "position_embedding": g("embeddings.position_embedding.weight"),
        "final_layer_norm": {"scale": g("final_layer_norm.weight"),
                             "bias": g("final_layer_norm.bias")},
    }
    names = {"query": "q_proj", "key": "k_proj", "value": "v_proj"}
    i = 0
    while f"{p}encoder.layers.{i}.layer_norm1.weight" in sd:
        src = f"encoder.layers.{i}"
        d = g(f"{src}.self_attn.q_proj.weight").shape[0]
        hd = d // heads
        attn = {ours: {"kernel": np.ascontiguousarray(
                           g(f"{src}.self_attn.{theirs}.weight").T.reshape(d, heads, hd)),
                       "bias": g(f"{src}.self_attn.{theirs}.bias").reshape(heads, hd)}
                for ours, theirs in names.items()}
        attn["out"] = {"kernel": np.ascontiguousarray(
                           g(f"{src}.self_attn.out_proj.weight").T.reshape(heads, hd, d)),
                       "bias": g(f"{src}.self_attn.out_proj.bias")}
        layer = {"attn": attn}
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            layer[ours] = {"scale": g(f"{src}.{theirs}.weight"), "bias": g(f"{src}.{theirs}.bias")}
        for fc in ("fc1", "fc2"):
            layer[fc] = {"kernel": np.ascontiguousarray(g(f"{src}.mlp.{fc}.weight").T),
                         "bias": g(f"{src}.mlp.{fc}.bias")}
        tree[f"layers_{i}"] = layer
        i += 1
    return tree
