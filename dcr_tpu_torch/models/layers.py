"""Shared building blocks of the diffusion models (PyTorch, NCHW).

Counterpart of ``dcr_tpu/models/layers.py``. Module and parameter names follow
the diffusers state-dict layout, so the name maps of ``models/export.py``
carry the JAX package's weights straight in with ``strict=True``. Numerics
follow the Flax blocks: GroupNorm statistics in f32, GEGLU with flax's
default (tanh) GELU, nearest-neighbour upsampling, symmetric padding in the
UNet downsampler and the (0,1,0,1) pre-pad in the VAE encoder's.

Tensor parallelism (``parallel/sharding.py`` places the projections,
``parallel/sharded.install`` hands the blocks the group): a block whose
``TP_COLUMN`` projections hold their rank's output features and whose
``TP_ROW`` projection holds its input features runs Megatron's forward.
The replicated input enters through *f* (``tensor_enter``); each rank
computes its columns (a replicated column bias contributes its chunk); the
row-parallel output is summed over the group (*g*, ``tensor_reduce``) and
its bias added once. Attention runs each rank's heads when they divide by
the group; otherwise (SD-2.1's first level has 5 heads, the VAE's one) the
columns are gathered, every rank runs all heads and keeps its chunk of the
output for the row-parallel projection. GEGLU's projection splits into
``h`` and ``gate`` halves, which a column shard does not pair, so its
columns are gathered whole first.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dcr_tpu_torch.ops import ring_attention, ulysses_attention
from dcr_tpu_torch.ops.attention import dot_product_attention
from dcr_tpu_torch.parallel.mesh import (SEQ_AXIS, tensor_enter, tensor_gather, tensor_reduce,
                                         tensor_scatter)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding [B] -> [B, dim] f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """2-layer MLP lifting the sinusoidal embedding to the UNet's time channels."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


class GroupNorm(nn.GroupNorm):
    """GroupNorm whose statistics are always f32; output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class ResnetBlock2D(nn.Module):
    """norm -> silu -> conv -> (+time) -> norm -> silu -> conv, 1x1 skip when
    the width changes."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int = 0,
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch) if temb_ch else None
        self.norm2 = GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + skip


def _column(lin: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel linear on ``x`` (already entered): the rank's
    weight rows, and its chunk of a replicated bias."""
    bias = None if lin.bias is None else tensor_scatter(lin.bias, group, 0)
    return F.linear(x, lin.weight, bias)


def _row(lin: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel linear on the rank's input features: the partial
    products summed over the group, then the bias."""
    y = tensor_reduce(F.linear(x, lin.weight), group)
    return y if lin.bias is None else y + lin.bias


def _tp_attention(q, k, v, heads: int, group, row: bool, attend) -> torch.Tensor:
    """The attention of column-parallel ``q``/``k``/``v`` [B, S, C/t]: on the
    rank's heads when they divide by the group (and the output projection is
    row-parallel), else on every head after a gather; returns the output
    [B, S, C'] the output projection reads (its rank's chunk when ``row``)."""
    n = torch.distributed.get_world_size(group)
    local = row and heads % n == 0
    if not local:
        q, k, v = (tensor_gather(t, group, -1) for t in (q, k, v))
    out = attend(q, k, v, heads // n if local else heads)
    return tensor_scatter(out, group, -1) if row and not local else out


class CrossAttention(nn.Module):
    """Multi-head attention over [B, S, C] tokens; self-attention when
    context is None. q/k/v projections carry no bias, the output one does.

    With a mesh whose ``seq`` axis is above 1, a self-attention whose
    sequence reaches ``seq_parallel_min_seq`` (and splits over the axis)
    runs sequence-parallel over the axis, as the JAX block does:
    ``seq_parallel_mode="ring"`` rotates K/V around the ranks
    (``ops/ring_attention.py``), ``"ulysses"`` re-splits sequence to heads
    and runs the flash kernels per head group
    (``ops/ulysses_attention.py``), falling back to ring when the heads do
    not divide by the axis. Tensor-parallel (``tp_group``) as the module
    docstring says."""

    TP_COLUMN = ("to_q", "to_k", "to_v")
    TP_ROW = ("to_out.0",)
    tp_group = None
    tp_col = tp_row = False

    def __init__(self, query_dim: int, context_dim: int, heads: int, head_dim: int,
                 use_flash: bool = True, *, mesh=None, seq_parallel_min_seq: int = 4096,
                 seq_parallel_mode: str = "ring"):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.use_flash = heads, head_dim, use_flash
        self.mesh = mesh
        self.seq_parallel_min_seq = seq_parallel_min_seq
        self.seq_parallel_mode = seq_parallel_mode
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def _seq_n(self) -> int:
        return self.mesh.size(SEQ_AXIS) if self.mesh is not None else 1

    def _ring_ok(self, b: int, sq: int, is_self: bool) -> bool:
        """The JAX block's conditions: self-attention, a seq axis above 1,
        ``sq >= seq_parallel_min_seq`` and ``sq % n_seq == 0``. Its fifth,
        the global batch splitting over the data ranks, holds by
        construction here: ``b`` is this rank's rows of a global batch of
        ``b x n_data``."""
        if not is_self or self.mesh is None:
            return False
        n_seq = self._seq_n()
        return n_seq > 1 and sq >= self.seq_parallel_min_seq and sq % n_seq == 0

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.tp_col or self.tp_row:
            return self._tensor_parallel(x, context)
        is_self = context is None
        context = x if context is None else context
        b, sq, _ = x.shape
        sk = context.shape[1]
        q = self.to_q(x).reshape(b, sq, self.heads, self.head_dim)
        k = self.to_k(context).reshape(b, sk, self.heads, self.head_dim)
        v = self.to_v(context).reshape(b, sk, self.heads, self.head_dim)
        if self._ring_ok(b, sq, is_self):
            if self.seq_parallel_mode == "ulysses" and self.heads % self._seq_n() == 0:
                out = ulysses_attention.ulysses_self_attention(q, k, v, self.mesh,
                                                               use_flash=self.use_flash)
            else:
                out = ring_attention.ring_self_attention(q, k, v, self.mesh)
        else:
            out = dot_product_attention(q, k, v, use_flash=self.use_flash)
        return self.to_out[0](out.reshape(b, sq, self.heads * self.head_dim))

    def _tensor_parallel(self, x: torch.Tensor, context: Optional[torch.Tensor]
                         ) -> torch.Tensor:
        g, hd = self.tp_group, self.head_dim
        b, sq, _ = x.shape
        if self.tp_col:
            x_in = tensor_enter(x, g)
            c_in = x_in if context is None else tensor_enter(context, g)
            q, k, v = (_column(lin, t, g) for lin, t in
                       ((self.to_q, x_in), (self.to_k, c_in), (self.to_v, c_in)))
        else:
            c = x if context is None else context
            q, k, v = self.to_q(x), self.to_k(c), self.to_v(c)

        def attend(q, k, v, heads):
            split = lambda t: t.reshape(b, t.shape[1], heads, hd)
            return dot_product_attention(split(q), split(k), split(v),
                                         use_flash=self.use_flash).reshape(b, sq, heads * hd)

        if self.tp_col:
            out = _tp_attention(q, k, v, self.heads, g, self.tp_row, attend)
        else:
            out = attend(q, k, v, self.heads)
            out = tensor_scatter(out, g, -1) if self.tp_row else out
        return _row(self.to_out[0], out, g) if self.tp_row else self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        # flax nn.gelu defaults to the tanh approximation
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward; diffusers names ``net.0`` (GEGLU) and ``net.2``.
    Tensor-parallel (``tp_group``): GEGLU's columns gathered whole (each
    ``h`` meets its own ``gate``), the rank's chunk into the row-parallel
    ``net.2``."""

    TP_COLUMN = ("net.0.proj",)
    TP_ROW = ("net.2",)
    tp_group = None
    tp_col = tp_row = False

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.tp_col or self.tp_row):
            return self.net[2](self.net[0](x))
        g = self.tp_group
        if self.tp_col:
            hg = tensor_gather(_column(self.net[0].proj, tensor_enter(x, g), g), g, -1)
        else:
            hg = self.net[0].proj(x)
        h, gate = hg.chunk(2, dim=-1)
        a = h * F.gelu(gate, approximate="tanh")
        return _row(self.net[2], tensor_scatter(a, g, -1), g) if self.tp_row else self.net[2](a)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> ff, each pre-LayerNormed with residuals.
    Only the self-attention (attn1) can run sequence-parallel: the
    cross-attention's K/V are the 77 text tokens."""

    def __init__(self, dim: int, context_dim: int, heads: int, head_dim: int,
                 use_flash: bool = True, **seq_parallel):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, heads, head_dim, use_flash, **seq_parallel)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, heads, head_dim, use_flash)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj in -> N blocks -> proj out + residual.
    ``use_linear_projection`` selects SD-2.x linears (after the reshape to
    tokens) or SD-1.x 1x1 convs (before it). ``seq_parallel`` (``mesh``,
    ``seq_parallel_min_seq``, ``seq_parallel_mode``) reaches the blocks'
    self-attentions."""

    def __init__(self, ch: int, context_dim: int, heads: int, head_dim: int,
                 num_layers: int = 1, groups: int = 32, use_flash: bool = True,
                 use_linear_projection: bool = True, **seq_parallel):
        super().__init__()
        inner = heads * head_dim
        self.use_linear_projection = use_linear_projection
        # diffusers Transformer2DModel norms with eps=1e-6 (not the resnets' 1e-5)
        self.norm = GroupNorm(groups, ch, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(ch, inner)
            self.proj_out = nn.Linear(inner, ch)
        else:
            self.proj_in = nn.Conv2d(ch, inner, 1)
            self.proj_out = nn.Conv2d(inner, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, context_dim, heads, head_dim, use_flash,
                                   **seq_parallel) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        out = self.norm(x)
        if self.use_linear_projection:
            out = self.proj_in(out.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            out = self.proj_in(out)
            out = out.permute(0, 2, 3, 1).reshape(b, h * w, out.shape[1])
        for blk in self.transformer_blocks:
            out = blk(out, context)
        if self.use_linear_projection:
            out = self.proj_out(out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            out = self.proj_out(out.reshape(b, h, w, -1).permute(0, 3, 1, 2))
        return out + x


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv. The UNet pads symmetrically; the VAE encoder pads
    (0,1,0,1) and convolves VALID, as diffusers' AutoencoderKL does."""

    def __init__(self, ch: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0 if asymmetric_pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class AttentionBlock2D(nn.Module):
    """Spatial self-attention of the VAE mid blocks (biased q/k/v/out, always
    the library attention). diffusers 0.14 names: query/key/value/proj_attn.
    Tensor-parallel (``tp_group``) as the module docstring says: with one
    head, the columns gathered."""

    TP_COLUMN = ("query", "key", "value")
    TP_ROW = ("proj_attn",)
    tp_group = None
    tp_col = tp_row = False

    def __init__(self, ch: int, groups: int = 32, eps: float = 1e-6, heads: int = 1):
        super().__init__()
        self.heads = heads
        self.group_norm = GroupNorm(groups, ch, eps=eps)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        out = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        hd = c // self.heads

        def attend(q, k, v, heads):
            split = lambda t: t.reshape(b, h * w, heads, hd)
            return dot_product_attention(split(q), split(k), split(v),
                                         use_flash=False).reshape(b, h * w, heads * hd)

        g = self.tp_group
        if self.tp_col:
            out = tensor_enter(out, g)
            q, k, v = (_column(lin, out, g) for lin in (self.query, self.key, self.value))
            out = _tp_attention(q, k, v, self.heads, g, self.tp_row, attend)
        else:
            out = attend(self.query(out), self.key(out), self.value(out), self.heads)
            out = tensor_scatter(out, g, -1) if self.tp_row else out
        out = _row(self.proj_attn, out, g) if self.tp_row else self.proj_attn(out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
