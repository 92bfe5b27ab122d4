"""Vision Transformer (DINO): a copy-detection backbone, and the pre-LN
block that the CLIP image tower shares.

Counterpart of ``dcr_tpu/models/vit.py`` (the reference's DINO ViT zoo,
dino_vits.py: PatchEmbed 153-168, Block 132-150, VisionTransformer 171-275
with the positional-table interpolation 213-233 and
get_intermediate_layers 267-275, hub constructors 340-487), in NCHW under
the DINO/timm names, so a DINO hub state dict loads with ``strict=True``:
``cls_token``, ``pos_embed``, ``patch_embed.proj``, ``blocks.N.norm1``,
``blocks.N.attn.qkv``, ``blocks.N.attn.proj``, ``blocks.N.norm2``,
``blocks.N.mlp.fc1``, ``blocks.N.mlp.fc2`` and ``norm``.

Numerics to keep: Flax's ``nn.LayerNorm`` has eps 1e-6 (torch's default is
1e-5); OpenAI CLIP's activation is ``quick_gelu``, h * sigmoid(1.702 h); and
the JAX block's ``gelu`` is Flax's, the tanh approximation.
Attention goes through the port's dispatcher with ``use_flash=False``, as
the JAX block does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dcr_tpu_torch.ops.attention import dot_product_attention

LAYER_NORM_EPS = 1e-6   # flax.linen.LayerNorm's default


class _Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads, d // self.num_heads).unbind(2)
        out = dot_product_attention(q, k, v, use_flash=False)
        return self.proj(out.reshape(b, s, d))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str):
        super().__init__()
        if act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown activation {act!r} (gelu | quick_gelu)")
        self.act = act
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if self.act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h, approximate="tanh")   # flax.linen.gelu's default
        return self.fc2(h)


class ViTBlock(nn.Module):
    """x + attn(norm1(x)), then + mlp(norm2(x)); [B, S, D] -> [B, S, D]."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, act: str = "gelu"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = _Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp = _MLP(dim, int(dim * mlp_ratio), act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """p x p patches, stride p, no padding: a non-divisible input floors to
    the grid the reference's padding-0 conv gives. [B, 3, H, W] ->
    [B, (H/p)(W/p), D]."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


def _bicubic_axis(out_size: int, in_size: int, scale: float) -> tuple[np.ndarray, np.ndarray]:
    """Tap indices [4, out] and weights [4, out] of one axis of torch's
    ``F.interpolate(mode="bicubic", align_corners=False, scale_factor=scale)``:
    source coordinate (dst + 0.5) / scale - 0.5, the cubic-convolution
    kernel with A = -0.75, taps clamped at the border."""
    a = -0.75
    k_near = lambda x: ((a + 2) * x - (a + 3)) * x * x + 1        # |x| <= 1
    k_far = lambda x: ((a * x - 5 * a) * x + 8 * a) * x - 4 * a   # 1 < |x| < 2
    src = (np.arange(out_size) + 0.5) / scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    weights = np.stack([k_far(t + 1.0), k_near(t), k_near(1.0 - t), k_far(2.0 - t)])
    idx = np.stack([i0 - 1, i0, i0 + 1, i0 + 2]).clip(0, in_size - 1)
    return idx, weights


def interpolate_pos_embed(pos_embed: torch.Tensor, num_patches: int,
                          grid_hw: tuple[int, int],
                          pixel_hw: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """Bicubic interpolation of the patch rows of the position table
    [1, 1 + side^2, D] to a (h, w) grid, the reference's arithmetic
    (dino_vits.py:213-233: the scale factors carry the +0.1 nudge and map
    the coordinates directly). The table is kept as it is when it has
    ``num_patches`` rows and the input is square in pixels (the reference
    tests pixel squareness, not grid squareness)."""
    cls_pos, patch_pos = pos_embed[:, :1], pos_embed[:, 1:]
    n_orig = patch_pos.shape[1]
    h, w = grid_hw
    ph, pw = pixel_hw if pixel_hw is not None else (h, w)
    if n_orig == num_patches and ph == pw:
        return pos_embed
    side = int(math.sqrt(n_orig))
    grid = patch_pos.reshape(side, side, -1)
    iy, wy = _bicubic_axis(h, side, (h + 0.1) / side)
    ix, wx = _bicubic_axis(w, side, (w + 0.1) / side)
    dev, dt = grid.device, grid.dtype
    wy = torch.as_tensor(wy, dtype=dt, device=dev)
    wx = torch.as_tensor(wx, dtype=dt, device=dev)
    rows = torch.einsum("kh,khsd->hsd", wy, grid[torch.as_tensor(iy, device=dev)])
    out = torch.einsum("kw,hkwd->hwd", wx, rows[:, torch.as_tensor(ix, device=dev)])
    return torch.cat([cls_pos, out.reshape(1, h * w, -1)], dim=1)


class VisionTransformer(nn.Module):
    """DINO ViT. forward([B, 3, H, W]) -> the normed CLS token [B, D] (the
    retrieval feature), or with ``return_layers=k`` the normed hidden states
    of the last k blocks, each [B, 1 + (H/p)(W/p), D]
    (get_intermediate_layers). ``img_size`` sizes the position table; other
    input sizes interpolate it."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, img_size: int = 224):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.randn(1, grid * grid + 1, embed_dim) * 0.02)
        self.blocks = nn.ModuleList([ViTBlock(embed_dim, num_heads, mlp_ratio)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, *, return_layers: Optional[int] = None
                ) -> torch.Tensor | list[torch.Tensor]:
        b, _, h, w = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        tokens = self.patch_embed(x)
        pos = interpolate_pos_embed(self.pos_embed, gh * gw, (gh, gw), pixel_hw=(h, w))
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1) + pos
        outputs = []
        for block in self.blocks:
            tokens = block(tokens)
            outputs.append(tokens)
        if return_layers:
            return [self.norm(o) for o in outputs[-return_layers:]]
        return self.norm(tokens)[:, 0]


# constructors of the reference's zoo (dino_vits.py:278-296, 340-487)
def vit_tiny(patch_size: int = 16, **kw) -> VisionTransformer:
    return VisionTransformer(patch_size, 192, 12, 3, **kw)


def vit_small(patch_size: int = 16, **kw) -> VisionTransformer:
    return VisionTransformer(patch_size, 384, 12, 6, **kw)


def vit_base(patch_size: int = 16, **kw) -> VisionTransformer:
    return VisionTransformer(patch_size, 768, 12, 12, **kw)


def _dino_resnet50() -> nn.Module:
    # the torchvision ResNet-50 trunk + average pool (dino_vits.py:438-452)
    from dcr_tpu_torch.models.resnet import ResNet50Classifier

    return ResNet50Classifier()


def _xcit(name: str) -> nn.Module:
    from dcr_tpu_torch.models import xcit

    size, patch = name.rsplit("_p", 1)
    ctor = {"xcit_small_12": xcit.xcit_small_12, "xcit_medium_24": xcit.xcit_medium_24}[size]
    return ctor(patch_size=int(patch))


DINO_ARCHS: dict[str, Callable[[], nn.Module]] = {
    "dino_vits16": lambda: vit_small(16),
    "dino_vits8": lambda: vit_small(8),
    "dino_vitb16": lambda: vit_base(16),
    "dino_vitb8": lambda: vit_base(8),
    # the CIFAR-10-finetuned ViT-B/16 (dino_vits.py:340-360): the same
    # architecture with another checkpoint
    "dino_vitb_cifar10": lambda: vit_base(16),
    "dino_resnet50": _dino_resnet50,
    "dino_xcit_small_12_p16": lambda: _xcit("xcit_small_12_p16"),
    "dino_xcit_small_12_p8": lambda: _xcit("xcit_small_12_p8"),
    "dino_xcit_medium_24_p16": lambda: _xcit("xcit_medium_24_p16"),
    "dino_xcit_medium_24_p8": lambda: _xcit("xcit_medium_24_p8"),
}
