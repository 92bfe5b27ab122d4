"""UNet2DCondition, the denoiser (SD-2.1 architecture), PyTorch NCHW.

Counterpart of ``dcr_tpu/models/unet2d.py`` with diffusers'
UNet2DConditionModel state-dict names. Structure: conv_in -> [CrossAttnDown
x(n-1), Down] -> mid(Res, T2D, Res) -> [Up, CrossAttnUp x(n-1)] with skip
concats ``[h, skip]`` -> GN -> silu -> conv_out. Every spatial self-attention
goes through ``ops.attention`` (the flash kernel where the shape allows), or,
with a ``mesh`` whose ``seq`` axis is above 1, sequence-parallel ring or
Ulysses attention from ``seq_parallel_min_seq`` tokens on, as the JAX
UNet's ``mesh`` field selects.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dcr_tpu_torch.core.config import ModelConfig
from dcr_tpu_torch.models import layers as L
from dcr_tpu_torch.parallel import sharded as SH


def attn_dims(cfg: ModelConfig, ch: int) -> tuple[int, int]:
    """(num_heads, head_dim) for a block of width ch. SD-2.x fixes head_dim
    (64) and varies the count; SD-1.x fixes the count (8) and varies the dim."""
    if cfg.attention_num_heads:
        return cfg.attention_num_heads, ch // cfg.attention_num_heads
    return ch // cfg.attention_head_dim, cfg.attention_head_dim


class _Blocks(nn.Module):
    """Container with diffusers' child names inside a down/up/mid block."""

    def __init__(self, resnets, attentions=None, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions or [])
        self.downsamplers = nn.ModuleList(downsamplers or [])
        self.upsamplers = nn.ModuleList(upsamplers or [])


class UNet2DCondition(nn.Module):
    def __init__(self, config: ModelConfig, mesh=None):
        super().__init__()
        cfg = self.config = config
        bo = cfg.block_out_channels
        n = len(bo)
        temb_ch = bo[0] * 4
        g = cfg.norm_num_groups
        lpb = cfg.layers_per_block

        def transformer(ch: int) -> L.Transformer2D:
            heads, head_dim = attn_dims(cfg, ch)
            return L.Transformer2D(
                ch, cfg.cross_attention_dim, heads, head_dim,
                num_layers=cfg.transformer_layers, groups=g,
                use_flash=cfg.flash_attention,
                use_linear_projection=cfg.use_linear_projection, mesh=mesh,
                seq_parallel_min_seq=cfg.seq_parallel_min_seq,
                seq_parallel_mode=cfg.seq_parallel_mode)

        self.conv_in = nn.Conv2d(cfg.in_channels, bo[0], 3, padding=1)
        self.time_embedding = L.TimestepEmbedding(bo[0], temb_ch)

        down, skip_chs, ch = [], [bo[0]], bo[0]
        for i, out_ch in enumerate(bo):
            final = i == n - 1
            resnets, attns = [], []
            for _ in range(lpb):
                resnets.append(L.ResnetBlock2D(ch, out_ch, temb_ch, g))
                if not final:  # cross-attn blocks everywhere but the bottom
                    attns.append(transformer(out_ch))
                ch = out_ch
                skip_chs.append(ch)
            down.append(_Blocks(resnets, attns,
                                downsamplers=None if final else [L.Downsample2D(ch)]))
            if not final:
                skip_chs.append(ch)
        self.down_blocks = nn.ModuleList(down)

        mid = bo[-1]
        self.mid_block = _Blocks([L.ResnetBlock2D(mid, mid, temb_ch, g),
                                  L.ResnetBlock2D(mid, mid, temb_ch, g)],
                                 [transformer(mid)])

        up = []
        for i, out_ch in enumerate(reversed(bo)):
            first = i == 0  # bottom of the U: no cross-attn (mirrors DownBlock2D)
            resnets, attns = [], []
            for _ in range(lpb + 1):
                resnets.append(L.ResnetBlock2D(ch + skip_chs.pop(), out_ch, temb_ch, g))
                ch = out_ch
                if not first:
                    attns.append(transformer(out_ch))
            up.append(_Blocks(resnets, attns,
                              upsamplers=[L.Upsample2D(ch)] if i < n - 1 else None))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = L.GroupNorm(g, bo[0], eps=1e-5)
        self.conv_out = nn.Conv2d(bo[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """sample: [B, C_latent, H, W]; timesteps: [B] int; context: [B, S, D_txt].
        Returns the prediction [B, C_out, H, W] in f32."""
        dtype = SH.dtype_of(self.conv_in.weight)
        t_emb = L.timestep_embedding(timesteps, self.config.block_out_channels[0])
        temb = self.time_embedding(t_emb.to(dtype))
        context = encoder_hidden_states.to(dtype)

        h = self.conv_in(sample.to(dtype))
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context)
                skips.append(h)
            for ds in blk.downsamplers:
                h = ds(h)
                skips.append(h)

        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, context)
        h = self.mid_block.resnets[1](h, temb)

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context)
            for us in blk.upsamplers:
                h = us(h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.float()
