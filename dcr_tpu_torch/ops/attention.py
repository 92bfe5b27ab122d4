"""Attention dispatcher (counterpart of dcr_tpu/ops/attention.py).

One function for every attention in the models. A kernel-capable shape with
no mask goes to the hand-written flash-attention kernels through the autograd
Function ``FlashAttention``: the forward kernel, and under autograd the dQ
and dK/dV kernels for its gradient (on the CPU, their plain versions).
Everything else goes to ``F.scaled_dot_product_attention``,
the role XLA's fused attention plays in the JAX package: cross-attention over
77 text tokens, the 8x8 mid self-attention, the VAE attention (D=512) and
CLIP's causal attention. The choice depends on shapes alone.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dcr_tpu_torch.ops import flash_attention as fa


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None,
                          use_flash: bool = True) -> torch.Tensor:
    """Multi-head attention over [B, S, H, D] tensors (BSHD layout).

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D]; mask: boolean, broadcastable to
    [B, H, Sq, Sk], True where a key takes part. Returns [B, Sq, H, D].
    """
    if use_flash and mask is None and fa.supported(q, k, v):
        return fa.flash_attention(q, k, v)
    return _sdpa_attention(q, k, v, mask)


def _sdpa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), attn_mask=mask)
    return out.transpose(1, 2)
