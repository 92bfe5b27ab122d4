"""CLIP text encoder (OpenCLIP ViT-H text tower shape for SD-2.1), PyTorch.

Counterpart of ``dcr_tpu/models/clip_text.py`` with transformers'
CLIPTextModel state-dict names (``text_model.*``). Pre-LN transformer with a
causal mask and biased q/k/v/out projections; the final LayerNorm is applied
to both the last and the penultimate hidden state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dcr_tpu_torch.core.config import ModelConfig
from dcr_tpu_torch.ops.attention import dot_product_attention


class CLIPTextOutput(NamedTuple):
    last_hidden_state: torch.Tensor         # [B, S, D] after final LN
    penultimate_hidden_state: torch.Tensor  # [B, S, D] layer -2, final LN applied
    pooled: torch.Tensor                    # [B, D] EOT-token embedding


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.heads
        q = self.q_proj(x).reshape(b, s, self.heads, hd)
        k = self.k_proj(x).reshape(b, s, self.heads, hd)
        v = self.v_proj(x).reshape(b, s, self.heads, hd)
        out = dot_product_attention(q, k, v, mask=mask)
        return self.out_proj(out.reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, act: str):
        super().__init__()
        if act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown text_act {act!r}")
        self.act = act
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if self.act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h)  # exact, as the JAX tower's approximate=False
        return self.fc2(h)


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, heads: int, act: str):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = CLIPMLP(dim, act)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.text_vocab_size, cfg.text_hidden_size)
        self.position_embedding = nn.Embedding(cfg.text_max_length, cfg.text_hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPLayer(cfg.text_hidden_size, cfg.text_heads, cfg.text_act)
             for _ in range(cfg.text_layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.text_hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextModel(config)

    def forward(self, input_ids: torch.Tensor) -> CLIPTextOutput:
        tm = self.text_model
        s = input_ids.shape[1]
        positions = torch.arange(s, device=input_ids.device)
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding(positions)[None])
        causal = torch.ones((s, s), dtype=torch.bool, device=input_ids.device).tril()
        hidden = penultimate = x
        layers = tm.encoder.layers
        for i, layer in enumerate(layers):
            if i == len(layers) - 1:
                penultimate = hidden
            hidden = layer(hidden, causal)
        last = tm.final_layer_norm(hidden)
        penultimate = tm.final_layer_norm(penultimate)
        # pooled = embedding at the EOT token (it has the largest id in the vocab)
        eot = input_ids.argmax(dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eot]
        return CLIPTextOutput(last.float(), penultimate.float(), pooled.float())
