"""Diffusers and transformers state dicts -> the port's state dicts.

Own copy of the diffusers parts of ``dcr_tpu/models/convert.py``
(``convert_unet``, ``convert_vae`` with ``normalize_vae_attn_names``,
``convert_clip_text``, ``check_converted``). The port's modules carry the
diffusers-0.14 / transformers names already, so the map is short:

- VAE mid-block attention saved by diffusers >= 0.17 as ``to_q``/``to_k``/
  ``to_v``/``to_out.0`` takes the 0.14 names ``query``/``key``/``value``/
  ``proj_attn`` that the port's modules (and on-hub SD VAEs) use: the
  reverse of the JAX package's direction;
- a transformers CLIP text state dict with or without its ``text_model.``
  prefix; the ``position_ids`` buffer older transformers saved is dropped;
- SD-1.x 1x1-conv ``proj_in``/``proj_out`` (4-D weights) load into the
  conv projections ``use_linear_projection=False`` builds; nothing to map;
- f16 and bf16 weights become f32.

:func:`check_state_dict` lists every missing, extra or mis-shaped key
against the modules a config describes.
"""

from __future__ import annotations

import re
from typing import Mapping

import torch

_VAE_ATTN_OLD = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
_VAE_ATTN = re.compile(r"(.*\.attentions\.\d+)\.(to_q|to_k|to_v|to_out\.0)\.(weight|bias)$")
TEXT_PREFIX = "text_model."


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.is_floating_point() else t


def convert_unet(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A diffusers UNet2DConditionModel state dict (linear or 1x1-conv
    projections) -> the port's UNet2DCondition state dict."""
    return {k: _f32(v) for k, v in sd.items()}


def convert_vae(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict, attention under either naming
    -> the port's AutoencoderKL state dict (the 0.14 names)."""
    out = {}
    for k, v in sd.items():
        m = _VAE_ATTN.match(k)
        if m:
            k = f"{m.group(1)}.{_VAE_ATTN_OLD[m.group(2)]}.{m.group(3)}"
        out[k] = _f32(v)
    return out


def convert_clip_text(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A transformers CLIPTextModel state dict, with or without the
    ``text_model.`` prefix -> the port's CLIPTextModel state dict."""
    out = {}
    for k, v in sd.items():
        k = k if k.startswith(TEXT_PREFIX) else TEXT_PREFIX + k
        if k.endswith("embeddings.position_ids"):      # a buffer, not a weight
            continue
        out[k] = _f32(v)
    return out


CONVERTERS = {"unet": convert_unet, "vae": convert_vae, "text_encoder": convert_clip_text}


def check_state_dict(expected: Mapping[str, torch.Tensor],
                     converted: Mapping[str, torch.Tensor], *, prefix: str = "") -> list[str]:
    """Every mismatch between a module's state dict (``expected``; meta
    tensors will do) and a converted one, as ``<prefix><key>: why``; an
    empty list when keys and shapes line up exactly."""
    problems = [f"{prefix}{k}: missing from converted" for k in expected if k not in converted]
    problems += [f"{prefix}{k}: unexpected in converted" for k in converted if k not in expected]
    problems += [f"{prefix}{k}: shape {tuple(converted[k].shape)} != expected "
                 f"{tuple(expected[k].shape)}"
                 for k in expected if k in converted and converted[k].shape != expected[k].shape]
    return problems
