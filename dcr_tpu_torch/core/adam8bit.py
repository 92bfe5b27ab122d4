"""Blockwise 8-bit AdamW state: counterpart of ``dcr_tpu/core/adam8bit.py``.

The reference's optional bitsandbytes 8-bit Adam (``--use_8bit_adam``,
diff_train.py:424-435) as the JAX package rebuilt it: both Adam moments
live as 8-bit codes with one f32 scale per block of :data:`BLOCK` (256)
elements, about 2.03 bytes per parameter instead of 8:

- the first moment m as symmetric linear int8, scale = the block's absmax;
- the second moment v as a logarithmic uint8 code over [1e-7, 1] times the
  block's max (:data:`_VCODE`: code 0 is exact zero, then 255 log-spaced
  values, ~3 % relative spacing), so a coordinate's relative error stays
  small whatever the spread of v inside its block.

Tensors under :data:`MIN_QUANTIZE_SIZE` (4,096) elements keep f32 moments.
The functions take and give torch tensors with the JAX functions' layout
(codes ``[n_blocks, BLOCK]``, the last block zero-padded; scales
``[n_blocks, 1]`` f32) and arithmetic: ``torch.round`` and ``jnp.round``
both round half to even, and ``torch.searchsorted`` and ``jnp.searchsorted``
both default to the left side. :func:`update_leaf` is ``scale_by_adam8``'s
per-leaf body; ``diffusion/train.Optimizer`` runs it tensor by tensor, so
the dequantized f32 moments exist for one tensor at a time.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

BLOCK = 256
MIN_QUANTIZE_SIZE = 4096

# log code for v: 0, then 255 log-spaced values over [1e-7, 1]. Code 0 is
# exact zero (a fresh state), so the first step's bias correction sees a
# true zero, not 1e-7 * scale
_VCODE = np.concatenate([[0.0], np.logspace(-7.0, 0.0, 255)]).astype(np.float32)

_vcode_on: dict[torch.device, torch.Tensor] = {}


class Quant8(NamedTuple):
    """One quantized tensor: codes [n_blocks, BLOCK] + per-block scale."""

    q: torch.Tensor          # int8 (linear) or uint8 (log code)
    scale: torch.Tensor      # [n_blocks, 1] f32


def _vcode(device: torch.device) -> torch.Tensor:
    t = _vcode_on.get(device)
    if t is None:
        t = _vcode_on[device] = torch.from_numpy(_VCODE).to(device)
    return t


def n_blocks(size: int) -> int:
    return -(-int(size) // BLOCK)


def state_bytes(size: int) -> int:
    """Bytes of one tensor's 8-bit state: int8 m and uint8 v codes over the
    padded blocks, and one f32 scale per block for each."""
    return n_blocks(size) * (2 * BLOCK + 2 * 4)


def is_quantized(numel: int, min_size: int = MIN_QUANTIZE_SIZE) -> bool:
    return numel >= min_size


def _blocked(flat: torch.Tensor) -> torch.Tensor:
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def zeros(size: int, dtype: torch.dtype, device) -> Quant8:
    """All-zero codes and scales for a tensor of ``size`` elements (what
    quantizing zeros gives, without the f32 transient)."""
    nb = n_blocks(size)
    return Quant8(torch.zeros((nb, BLOCK), dtype=dtype, device=device),
                  torch.zeros((nb, 1), dtype=torch.float32, device=device))


def quantize_linear(x: torch.Tensor) -> Quant8:
    xb = _blocked(x.reshape(-1).float())
    scale = xb.abs().amax(dim=1, keepdim=True)
    q = torch.round(xb / torch.clamp(scale, min=1e-20) * 127.0)
    return Quant8(q.to(torch.int8), scale)


def dequantize_linear(t: Quant8, shape, size: int) -> torch.Tensor:
    x = t.q.float() / 127.0 * t.scale
    return x.reshape(-1)[:size].reshape(shape)


def quantize_log(x: torch.Tensor) -> Quant8:
    """Nonnegative tensor -> log-coded uint8 (nearest code in relative
    terms). Code 0 is kept for true zeros: a tiny nonzero value (under the
    code's floor against its block's max) clamps to code 1, never 0, so a
    later zero-gradient step cannot divide its surviving m by eps."""
    xb = _blocked(x.reshape(-1).float())
    scale = xb.amax(dim=1, keepdim=True)
    r = xb / torch.clamp(scale, min=1e-20)
    code = _vcode(xb.device)
    idx = torch.clamp(torch.searchsorted(code, r), 1, 255)      # int64
    lo, hi = code[idx - 1], code[idx]
    q = torch.where(r - lo < hi - r, idx - 1, idx)
    q = torch.where(xb > 0, torch.clamp(q, min=1), torch.zeros_like(q))
    return Quant8(q.to(torch.uint8), scale)


def dequantize_log(t: Quant8, shape, size: int) -> torch.Tensor:
    x = _vcode(t.q.device)[t.q.long()] * t.scale
    return x.reshape(-1)[:size].reshape(shape)


def bias_corrections(b1: float, b2: float, count: int) -> tuple[float, float]:
    """``1 - b ** count`` in f32, as the JAX update takes them
    (``b1 ** count.astype(f32)``), returned as the f32 values."""
    n = np.float32(count)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** n), float(one - np.float32(b2) ** n))


Moment = Union[Quant8, torch.Tensor]


def update_leaf(g: torch.Tensor, m: Moment, v: Moment, *, b1: float, b2: float,
                eps: float, c1: float, c2: float
                ) -> tuple[torch.Tensor, Moment, Moment]:
    """``scale_by_adam8``'s body for one tensor: (direction, new m, new v).

    ``m`` and ``v`` are both :class:`Quant8` (a quantized tensor: they are
    dequantized, updated and requantized) or both f32 tensors (a small one:
    updated as they are). ``c1``/``c2`` from :func:`bias_corrections`."""
    g = g.float()
    quantized = isinstance(m, Quant8)
    if quantized:
        m = dequantize_linear(m, g.shape, g.numel())
        v = dequantize_log(v, g.shape, g.numel())
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    out = (m / c1) / (torch.sqrt(v / c2) + eps)
    if quantized:
        return out, quantize_linear(m), quantize_log(v)
    return out, m, v
