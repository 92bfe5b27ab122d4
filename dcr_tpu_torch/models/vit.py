"""The pre-LN transformer block of the vision towers.

Counterpart of ``dcr_tpu/models/vit.py`` ``ViTBlock`` (the DINO ViT and CLIP
image towers share it), under the DINO/timm module names: ``norm1``,
``attn.qkv``, ``attn.proj``, ``norm2``, ``mlp.fc1``, ``mlp.fc2``. The rest of
the JAX module (``VisionTransformer``, ``PatchEmbed``, the positional-table
interpolation) serves the DINO backbones, which the port does not have yet.

Numerics to keep: Flax's ``nn.LayerNorm`` has eps 1e-6 (torch's default is
1e-5); OpenAI CLIP's activation is ``quick_gelu``, h * sigmoid(1.702 h); and
the JAX block's ``gelu`` is Flax's, the tanh approximation.
Attention goes through the port's dispatcher with ``use_flash=False``, as
the JAX block does.
"""

from __future__ import annotations

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
