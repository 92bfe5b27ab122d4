"""CLIP image tower (ViT-B/16) and the CLIP scorer of the alignment score.

Counterpart of ``dcr_tpu/models/clip_image.py``: ``CLIPImageTower`` (CLIP's
normalisation inside, a 16x16 patch conv without bias, a class token and a
positional table, ``ln_pre``, 12 pre-LN blocks with ``quick_gelu``,
``ln_post`` on the class token, projection to 512), and ``CLIPScorer``,
which adds the port's ``CLIPTextModel`` at CLIP-B/16's text widths (512
wide, 12 layers, 8 heads, ``quick_gelu``) and the text projection. The
score of an (image, caption) pair is the cosine of their L2-normalised
embeddings (reference gen_clipscore, utils_ret.py:1045-1066).

Module names follow the JAX module's (``patch_embed``, ``class_embedding``,
``pos_embed``, ``ln_pre``, ``blocks.N``, ``ln_post``, ``proj``), with the
blocks under :class:`~dcr_tpu_torch.models.vit.ViTBlock`'s names. An OpenAI
CLIP archive loads through :func:`scorer_state_dict_from_openai`, the
counterpart of ``dcr_tpu/models/convert.py`` ``convert_openai_clip``; an
image tower from an OpenAI archive or a transformers ``CLIPVisionModel``
through :func:`image_state_dict_from_openai` or
:func:`image_state_dict_from_transformers`, the two branches of
``convert_clip_image``.
LayerNorms have Flax's eps of 1e-6 in the image tower; the text tower keeps
the port's CLIPTextModel (eps 1e-5, as the JAX text tower).
"""

from __future__ import annotations

import re
from typing import Mapping, Optional

import torch
import torch.nn as nn

from dcr_tpu_torch.core.config import ModelConfig
from dcr_tpu_torch.core.rng import seeded_cpu_init
from dcr_tpu_torch.models.clip_text import CLIPTextModel
from dcr_tpu_torch.models.vit import LAYER_NORM_EPS, ViTBlock

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_b16_text_config(vocab_size: int = 49408) -> ModelConfig:
    """CLIP ViT-B/16 text tower dims (512 wide, 12 layers, 8 heads)."""
    return ModelConfig(text_vocab_size=vocab_size, text_hidden_size=512,
                       text_layers=12, text_heads=8, text_max_length=77,
                       text_act="quick_gelu")


class CLIPImageTower(nn.Module):
    """[B, 3, H, W] in [0, 1] -> [B, embed_dim] (not normalised). The
    positional table has (image_size / patch_size)^2 + 1 rows, as the JAX
    module's does once initialised at that size."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, embed_dim: int = 512):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        n_tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, width))
        self.ln_pre = nn.LayerNorm(width, eps=LAYER_NORM_EPS)
        self.blocks = nn.ModuleList([ViTBlock(width, heads, act="quick_gelu")
                                     for _ in range(layers)])
        self.ln_post = nn.LayerNorm(width, eps=LAYER_NORM_EPS)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))
        self.register_buffer("mean", torch.tensor(CLIP_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(CLIP_STD).view(1, 3, 1, 1),
                             persistent=False)
        for p in (self.class_embedding, self.pos_embed, self.proj):
            nn.init.normal_(p, std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed((x - self.mean) / self.std)          # [B, W, gh, gw]
        tokens = x.flatten(2).transpose(1, 2)                     # [B, gh*gw, W]
        cls = self.class_embedding.expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed
        tokens = self.ln_pre(tokens)
        for block in self.blocks:
            tokens = block(tokens)
        return self.ln_post(tokens[:, 0]) @ self.proj


class CLIPScorer(nn.Module):
    """Image tower, text tower and text projection (``image.*``, ``text.*``,
    ``text_projection`` [text width, embed_dim])."""

    def __init__(self, image_size: int = 224, embed_dim: int = 512):
        super().__init__()
        self.text_config = clip_b16_text_config()
        self.image = CLIPImageTower(image_size=image_size, embed_dim=embed_dim)
        self.text = CLIPTextModel(self.text_config)
        self.text_projection = nn.Parameter(
            torch.randn(self.text_config.text_hidden_size, embed_dim) * 0.02)

    def image_features(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.image(images)
        return feats / feats.norm(dim=-1, keepdim=True)

    def text_features(self, input_ids: torch.Tensor) -> torch.Tensor:
        feats = self.text(input_ids).pooled @ self.text_projection
        return feats / feats.norm(dim=-1, keepdim=True)

    def score(self, images: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """Per-pair cosine similarity [B] (the reference's (img*txt).sum(-1))."""
        return (self.image_features(images) * self.text_features(input_ids)).sum(-1)


def make_clip_scorer(image_size: int = 224, seed: int = 7) -> CLIPScorer:
    """A scorer on the CPU with weights drawn from ``seed``, frozen, in eval
    mode: the JAX package's ``make_clip_scorer`` + ``init_clip_scorer``
    (its random weights, from key 7, differ from these; weights carry across
    through ``models/export.clip_scorer_from_flax``)."""
    with seeded_cpu_init(seed):
        scorer = CLIPScorer(image_size=image_size)
    return scorer.eval().requires_grad_(False)


def image_state_dict_from_openai(sd: Mapping[str, torch.Tensor], *,
                                 layers: Optional[int] = None) -> dict[str, torch.Tensor]:
    """An OpenAI CLIP archive's image tower (``visual.*`` with fused
    ``in_proj`` attention) -> the port's :class:`CLIPImageTower` state dict
    (``layers`` blocks; by default as many as the archive has). Counterpart
    of ``dcr_tpu/models/convert.py`` ``convert_clip_image``."""
    out: dict[str, torch.Tensor] = {}
    v = "visual."
    if layers is None:
        blocks = re.compile(r"visual\.transformer\.resblocks\.(\d+)\.")
        layers = 1 + max(int(m.group(1)) for k in sd if (m := blocks.match(k)))
    out["patch_embed.weight"] = sd[f"{v}conv1.weight"]
    out["class_embedding"] = sd[f"{v}class_embedding"]
    out["pos_embed"] = sd[f"{v}positional_embedding"][None]
    for name in ("ln_pre", "ln_post"):
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = sd[f"{v}{name}.{leaf}"]
    out["proj"] = sd[f"{v}proj"]
    block_map = (("norm1", "ln_1"), ("norm2", "ln_2"), ("attn.proj", "attn.out_proj"),
                 ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj"))
    for i in range(layers):
        src, dst = f"{v}transformer.resblocks.{i}", f"blocks.{i}"
        out[f"{dst}.attn.qkv.weight"] = sd[f"{src}.attn.in_proj_weight"]
        out[f"{dst}.attn.qkv.bias"] = sd[f"{src}.attn.in_proj_bias"]
        for ours, theirs in block_map:
            for leaf in ("weight", "bias"):
                out[f"{dst}.{ours}.{leaf}"] = sd[f"{src}.{theirs}.{leaf}"]
    return {k: torch.as_tensor(val).float().contiguous() for k, val in out.items()}


def image_state_dict_from_transformers(sd: Mapping[str, torch.Tensor], *,
                                       layers: Optional[int] = None
                                       ) -> dict[str, torch.Tensor]:
    """A transformers ``CLIPVisionModel`` state dict (``vision_model.*``
    with split q/k/v projections; ``visual_projection.weight`` when it was
    saved with its projection) -> the port's :class:`CLIPImageTower` state
    dict (``layers`` blocks; by default as many as the state dict has). The
    second branch of ``dcr_tpu/models/convert.py`` ``convert_clip_image``:
    q, k and v concatenated in that order into the fused ``qkv``, and both
    spellings of the pre-LayerNorm (transformers' ``pre_layrnorm``)."""
    out: dict[str, torch.Tensor] = {}
    v = "vision_model."
    if layers is None:
        blocks = re.compile(r"vision_model\.encoder\.layers\.(\d+)\.")
        layers = 1 + max(int(m.group(1)) for k in sd if (m := blocks.match(k)))
    out["patch_embed.weight"] = sd[f"{v}embeddings.patch_embedding.weight"]
    out["class_embedding"] = torch.as_tensor(sd[f"{v}embeddings.class_embedding"]).reshape(-1)
    out["pos_embed"] = sd[f"{v}embeddings.position_embedding.weight"][None]
    pre = f"{v}pre_layrnorm" if f"{v}pre_layrnorm.weight" in sd else f"{v}pre_layernorm"
    for ours, theirs in (("ln_pre", pre), ("ln_post", f"{v}post_layernorm")):
        for leaf in ("weight", "bias"):
            out[f"{ours}.{leaf}"] = sd[f"{theirs}.{leaf}"]
    if "visual_projection.weight" in sd:
        out["proj"] = torch.as_tensor(sd["visual_projection.weight"]).t()
    block_map = (("norm1", "layer_norm1"), ("norm2", "layer_norm2"),
                 ("attn.proj", "self_attn.out_proj"), ("mlp.fc1", "mlp.fc1"),
                 ("mlp.fc2", "mlp.fc2"))
    for i in range(layers):
        src, dst = f"{v}encoder.layers.{i}", f"blocks.{i}"
        for leaf in ("weight", "bias"):
            out[f"{dst}.attn.qkv.{leaf}"] = torch.cat(
                [torch.as_tensor(sd[f"{src}.self_attn.{n}_proj.{leaf}"]) for n in "qkv"])
            for ours, theirs in block_map:
                out[f"{dst}.{ours}.{leaf}"] = sd[f"{src}.{theirs}.{leaf}"]
    return {k: torch.as_tensor(val).float().contiguous() for k, val in out.items()}


def scorer_state_dict_from_openai(sd: Mapping[str, torch.Tensor], *, image_layers: int = 12,
                                  text_layers: int = 12) -> dict[str, torch.Tensor]:
    """An OpenAI CLIP archive's state dict (``visual.*`` with fused
    ``in_proj`` attention, the text tower under ``transformer.resblocks.*``)
    -> the port's :class:`CLIPScorer` state dict. Counterpart of
    ``dcr_tpu/models/convert.py`` ``convert_openai_clip``."""
    out: dict[str, torch.Tensor] = {
        f"image.{k}": v for k, v in image_state_dict_from_openai(sd, layers=image_layers).items()}
    t = "text.text_model."
    out[f"{t}embeddings.token_embedding.weight"] = sd["token_embedding.weight"]
    out[f"{t}embeddings.position_embedding.weight"] = sd["positional_embedding"]
    text_map = (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                ("self_attn.out_proj", "attn.out_proj"), ("mlp.fc1", "mlp.c_fc"),
                ("mlp.fc2", "mlp.c_proj"))
    for i in range(text_layers):
        src, dst = f"transformer.resblocks.{i}", f"{t}encoder.layers.{i}"
        w, b = sd[f"{src}.attn.in_proj_weight"], sd[f"{src}.attn.in_proj_bias"]
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            d = w.shape[0] // 3
            out[f"{dst}.self_attn.{name}.weight"] = w[j * d:(j + 1) * d]
            out[f"{dst}.self_attn.{name}.bias"] = b[j * d:(j + 1) * d]
        for ours, theirs in text_map:
            for leaf in ("weight", "bias"):
                out[f"{dst}.{ours}.{leaf}"] = sd[f"{src}.{theirs}.{leaf}"]
    for leaf in ("weight", "bias"):
        out[f"{t}final_layer_norm.{leaf}"] = sd[f"ln_final.{leaf}"]
    out["text_projection"] = sd["text_projection"]
    return {k: torch.as_tensor(val).float().contiguous() for k, val in out.items()}
