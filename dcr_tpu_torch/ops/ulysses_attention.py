"""Ulysses attention: exact attention over a sequence split across the
ranks of the mesh's ``seq`` axis, by head-scatter and sequence-gather.
Counterpart of ``dcr_tpu/ops/ulysses_attention.py``.

Where ring attention (``ops/ring_attention.py``) keeps the queries resident
and rotates K/V in n-1 hops, Ulysses re-shards once each way: an
:func:`~dcr_tpu_torch.parallel.mesh.all_to_all` turns the sequence-split
[B, S/n, H, D] into the head-split [B, S, H/n, D], each rank runs ordinary
attention over the whole sequence for its head group through
``ops/attention.dot_product_attention`` (so the flash kernels run: B1
forward, B2/B3 backward), and a second all_to_all restores the sequence
split. The heads must divide by n; the UNet falls back to ring otherwise.
"""

from __future__ import annotations

import torch

from dcr_tpu_torch.ops.attention import dot_product_attention
from dcr_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh, all_to_all, seq_gather, seq_scatter


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, *,
                      use_flash: bool = True) -> torch.Tensor:
    """Exact attention with q/k/v re-split from sequence to heads over
    ``group`` (None: one rank). q/k/v are the rank's slices
    [B, S_local, H, D]; H must divide by the group's size."""
    n = 1 if group is None else torch.distributed.get_world_size(group)
    if q.shape[2] % n:
        raise ValueError(f"ulysses needs heads {q.shape[2]} divisible by seq axis {n} "
                         "(use ring attention otherwise)")
    # head-scatter / sequence-gather: [B, S/n, H, D] -> [B, S, H/n, D]
    q, k, v = (all_to_all(t, group, 2, 1) for t in (q, k, v))
    out = dot_product_attention(q, k, v, use_flash=use_flash)
    # and back: sequence-scatter / head-gather
    return all_to_all(out, group, 1, 2)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                           *, use_flash: bool = True) -> torch.Tensor:
    """q/k/v whole [B, S, H, D] on every rank of the seq group; the sequence
    is split over the group, and the output is whole again."""
    group = mesh.group(SEQ_AXIS)
    q, k, v = (seq_scatter(t, group, 1) for t in (q, k, v))
    return seq_gather(ulysses_attention(q, k, v, group, use_flash=use_flash), group, 1)
