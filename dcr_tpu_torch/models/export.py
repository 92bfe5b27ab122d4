"""Carry the JAX package's parameter trees into the port's state dicts.

Own copy of the name maps and layout rules of ``dcr_tpu/models/export.py``:
each function takes a Flax param tree (nested dicts of numpy arrays, as
``params.npz`` holds them) and returns a torch state dict under diffusers /
transformers naming that the port's modules load with ``strict=True``.
Dense kernels [in, out] become [out, in]; conv kernels HWIO become OIHW.
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
