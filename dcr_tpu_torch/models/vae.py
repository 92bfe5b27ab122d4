"""AutoencoderKL, the latent-space VAE (SD architecture), PyTorch NCHW.

Counterpart of ``dcr_tpu/models/vae.py`` with diffusers' AutoencoderKL
state-dict names (0.14-era mid-attention naming). Norms use
``groups = min(32, block_out[0])`` and eps 1e-6. ``encode`` returns the
diagonal Gaussian's (mean, logvar); ``decode`` maps latents to pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dcr_tpu_torch.core.config import ModelConfig
from dcr_tpu_torch.models import layers as L
from dcr_tpu_torch.parallel import sharded as SH


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor


class _Blocks(nn.Module):
    def __init__(self, resnets, attentions=None, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions or [])
        self.downsamplers = nn.ModuleList(downsamplers or [])
        self.upsamplers = nn.ModuleList(upsamplers or [])


def _mid(ch: int, groups: int) -> _Blocks:
    return _Blocks([L.ResnetBlock2D(ch, ch, 0, groups, eps=1e-6),
                    L.ResnetBlock2D(ch, ch, 0, groups, eps=1e-6)],
                   [L.AttentionBlock2D(ch, groups)])


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        bo = cfg.vae_block_out_channels
        g = min(cfg.norm_num_groups, bo[0])
        self.conv_in = nn.Conv2d(3, bo[0], 3, padding=1)
        blocks, ch = [], bo[0]
        for i, out_ch in enumerate(bo):
            resnets = []
            for _ in range(cfg.vae_layers_per_block):
                resnets.append(L.ResnetBlock2D(ch, out_ch, 0, g, eps=1e-6))
                ch = out_ch
            down = [L.Downsample2D(ch, asymmetric_pad=True)] if i < len(bo) - 1 else None
            blocks.append(_Blocks(resnets, downsamplers=down))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid(bo[-1], g)
        self.conv_norm_out = L.GroupNorm(g, bo[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(bo[-1], 2 * cfg.vae_latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            for ds in blk.downsamplers:
                h = ds(h)
        mb = self.mid_block
        h = mb.resnets[1](mb.attentions[0](mb.resnets[0](h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        bo = cfg.vae_block_out_channels
        g = min(cfg.norm_num_groups, bo[0])
        self.conv_in = nn.Conv2d(cfg.vae_latent_channels, bo[-1], 3, padding=1)
        self.mid_block = _mid(bo[-1], g)
        blocks, ch = [], bo[-1]
        for i, out_ch in enumerate(reversed(bo)):
            resnets = []
            for _ in range(cfg.vae_layers_per_block + 1):
                resnets.append(L.ResnetBlock2D(ch, out_ch, 0, g, eps=1e-6))
                ch = out_ch
            up = [L.Upsample2D(ch)] if i < len(bo) - 1 else None
            blocks.append(_Blocks(resnets, upsamplers=up))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = L.GroupNorm(g, bo[0], eps=1e-6)
        self.conv_out = nn.Conv2d(bo[0], 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        mb = self.mid_block
        h = mb.resnets[1](mb.attentions[0](mb.resnets[0](h)))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            for us in blk.upsamplers:
                h = us(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        zc = config.vae_latent_channels
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * zc, 2 * zc, 1)
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(zc, zc, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """x: [B, 3, H, W] -> Gaussian over [B, C_latent, H/f, W/f] (f32)."""
        dtype = SH.dtype_of(self.quant_conv.weight)
        moments = self.quant_conv(self.encoder(x.to(dtype))).float()
        mean, logvar = moments.chunk(2, dim=1)
        return DiagonalGaussian(mean, logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: [B, C_latent, h, w] -> pixels [B, 3, h*f, w*f] (f32)."""
        dtype = SH.dtype_of(self.post_quant_conv.weight)
        return self.decoder(self.post_quant_conv(z.to(dtype))).float()


def vae_scale_factor(cfg: ModelConfig) -> int:
    """Pixel-to-latent downscale (8 for the SD 4-block VAE)."""
    return 2 ** (len(cfg.vae_block_out_channels) - 1)
