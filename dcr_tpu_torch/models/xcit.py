"""XCiT (Cross-Covariance Image Transformer): the DINO ``dino_xcit_*``
copy-detection backbones.

Counterpart of ``dcr_tpu/models/xcit.py`` (El-Nouby et al., NeurIPS 2021;
the reference's hub constructors, dino_vits.py:413-487, load DINO
checkpoints of facebookresearch/xcit), in NCHW under the hub's state-dict
names, so a hub checkpoint loads with ``strict=True``: ``cls_token``,
``pos_embeder.token_projection``, ``patch_embed.proj.{0,2,4,6}.{0,1}``,
``blocks.N.{norm1,attn,norm3,local_mp,norm2,mlp,gamma1..3}``,
``cls_attn_blocks.N.{norm1,attn,norm2,mlp,gamma1,gamma2}`` and ``norm``.

- ``ConvPatchEmbed``: stride-2 conv3x3 + frozen BN stages (4 for patch 16,
  3 for patch 8), exact GELU between them;
- ``PositionalEncodingFourier``: a 2-D sinusoidal signal projected by a
  1x1 conv;
- ``XCA``: attention over channels (L2-normalised q and k, a learned
  per-head temperature, a d x d softmax), linear in the token count;
- ``LPI``: depthwise 3x3, GELU, frozen BN, depthwise 3x3 on the token grid;
- two class-attention layers (``tokens_norm=True``) that bring the CLS
  token in after the trunk.

XCA attends over channels, not tokens, so it is no flash attention: the
port runs it as plain PyTorch ops, as the JAX package runs it as XLA.
GELU is the exact (erf) form, LayerNorm eps 1e-6.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dcr_tpu_torch.models.resnet import FrozenBatchNorm

LAYER_NORM_EPS = 1e-6


class PositionalEncodingFourier(nn.Module):
    """Per-axis positions normalised to (0, 2pi], sin/cos over a
    ``hidden_dim``-frequency bank (temperature 10000), y bank then x bank,
    projected to ``dim``: [1, h*w, dim]."""

    def __init__(self, dim: int, hidden_dim: int = 32, temperature: float = 10000.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.temperature = temperature
        self.token_projection = nn.Conv2d(2 * hidden_dim, dim, 1)

    def forward(self, h: int, w: int) -> torch.Tensor:
        eps, scale = 1e-6, 2 * math.pi
        dev = self.token_projection.weight.device
        y = torch.arange(1, h + 1, dtype=torch.float32, device=dev) / (h + eps) * scale
        x = torch.arange(1, w + 1, dtype=torch.float32, device=dev) / (w + eps) * scale
        dim_t = torch.arange(self.hidden_dim, dtype=torch.float32, device=dev)
        dim_t = self.temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                                     / self.hidden_dim)

        def bank(pos: torch.Tensor) -> torch.Tensor:   # [L] -> [L, hidden], interleaved
            t = pos[:, None] / dim_t
            return torch.stack([t[:, 0::2].sin(), t[:, 1::2].cos()], dim=-1).flatten(1)

        py = bank(y)[:, None, :].expand(h, w, self.hidden_dim)
        px = bank(x)[None, :, :].expand(h, w, self.hidden_dim)
        pos = torch.cat([py, px], dim=-1).permute(2, 0, 1)[None]   # [1, 2*hidden, h, w]
        pos = self.token_projection(pos.to(self.token_projection.weight.dtype))
        return pos.flatten(2).transpose(1, 2)


class _ConvBN(nn.Sequential):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(nn.Conv2d(in_ch, out_ch, 3, stride=2, padding=1, bias=False),
                         FrozenBatchNorm(out_ch))


class ConvPatchEmbed(nn.Module):
    """Stride-2 conv3x3 + BN tower, channels doubling up to ``embed_dim``,
    GELU between stages: [B, 3, H, W] -> ([B, h*w, D], (h, w))."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 384):
        super().__init__()
        if patch_size == 16:
            widths = (embed_dim // 8, embed_dim // 4, embed_dim // 2, embed_dim)
        elif patch_size == 8:
            widths = (embed_dim // 4, embed_dim // 2, embed_dim)
        else:
            raise ValueError(f"XCiT patch_size must be 8 or 16, got {patch_size}")
        mods, in_ch = [], 3
        for i, width in enumerate(widths):
            if i:
                mods.append(nn.GELU())
            mods.append(_ConvBN(in_ch, width))
            in_ch = width
        self.proj = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        x = self.proj(x)
        return x.flatten(2).transpose(1, 2), (x.shape[2], x.shape[3])


class XCA(nn.Module):
    """Cross-covariance attention: softmax over each head's channel Gram
    matrix of L2-normalised q and k, times a learned temperature."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 4, 1).unbind(0)         # [B, heads, d, N]
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = (q @ k.transpose(-2, -1)) * self.temperature     # [B, heads, d, d]
        out = attn.softmax(dim=-1) @ v                          # [B, heads, d, N]
        return self.proj(out.permute(0, 3, 1, 2).reshape(b, n, c))


class LPI(nn.Module):
    """Local patch interaction: depthwise 3x3 -> GELU -> BN -> depthwise 3x3."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.act = nn.GELU()
        self.bn = FrozenBatchNorm(dim)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        g = x.transpose(1, 2).reshape(b, c, *hw)
        g = self.conv2(self.bn(self.act(self.conv1(g))))
        return g.reshape(b, c, n).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class XCABlock(nn.Module):
    """Trunk layer: LayerScale'd XCA, LPI and MLP residual branches."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, eta: float = 1.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = XCA(dim, num_heads)
        self.norm3 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.local_mp = LPI(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma1 = nn.Parameter(torch.full((dim,), eta))
        self.gamma2 = nn.Parameter(torch.full((dim,), eta))
        self.gamma3 = nn.Parameter(torch.full((dim,), eta))

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        x = x + self.gamma1 * self.attn(self.norm1(x))
        x = x + self.gamma3 * self.local_mp(self.norm3(x), hw)
        return x + self.gamma2 * self.mlp(self.norm2(x))


class ClassAttention(nn.Module):
    """Class attention: only the CLS query attends over all tokens; the
    other rows of the (normed) input pass through."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)         # [B, heads, N, d]
        attn = ((q[:, :, :1] * k).sum(-1) * d ** -0.5).softmax(dim=-1)   # [B, heads, N]
        cls = torch.einsum("bhn,bhnd->bhd", attn, v).reshape(b, 1, c)
        return torch.cat([self.proj(cls), x[:, 1:]], dim=1)


class ClassAttentionBlock(nn.Module):
    """Class-attention layer with ``tokens_norm=True`` (the hub models'):
    norm2 runs over every token and the final residual adds the normed
    tokens onto [gamma2 * MLP(CLS), patches], as the original does."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, eta: float = 1.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = ClassAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma1 = nn.Parameter(torch.full((dim,), eta))
        self.gamma2 = nn.Parameter(torch.full((dim,), eta))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.gamma1 * self.attn(self.norm1(x))
        x = self.norm2(x)
        cls = self.gamma2 * self.mlp(x[:, :1])
        return x + torch.cat([cls, x[:, 1:]], dim=1)


class XCiT(nn.Module):
    """[B, 3, H, W] -> the normed CLS embedding [B, embed_dim]. The Fourier
    encoding is made for the actual grid, so any input size divisible by
    the patch stages works without interpolation."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 8, mlp_ratio: float = 4.0, cls_attn_layers: int = 2,
                 eta: float = 1.0):
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = ConvPatchEmbed(patch_size, embed_dim)
        self.pos_embeder = PositionalEncodingFourier(embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList([XCABlock(embed_dim, num_heads, mlp_ratio, eta)
                                     for _ in range(depth)])
        self.cls_attn_blocks = nn.ModuleList(
            [ClassAttentionBlock(embed_dim, num_heads, mlp_ratio, eta)
             for _ in range(cls_attn_layers)])
        self.norm = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        tokens, hw = self.patch_embed(x)
        tokens = tokens + self.pos_embeder(*hw)
        for block in self.blocks:
            tokens = block(tokens, hw)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        for block in self.cls_attn_blocks:
            tokens = block(tokens)
        return self.norm(tokens)[:, 0]


# the hub models' hyperparameters (dino_vits.py:413-487)
def xcit_small_12(patch_size: int = 16, **kw) -> XCiT:
    return XCiT(patch_size, 384, 12, 8, eta=1.0, **kw)


def xcit_medium_24(patch_size: int = 16, **kw) -> XCiT:
    return XCiT(patch_size, 512, 24, 8, eta=1e-5, **kw)
