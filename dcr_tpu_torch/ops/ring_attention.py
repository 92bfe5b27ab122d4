"""Ring attention: exact attention over a sequence split across the ranks
of the mesh's ``seq`` axis. Counterpart of ``dcr_tpu/ops/ring_attention.py``.

The queries stay on their rank while the K/V slices rotate around the
``seq`` group through :func:`~dcr_tpu_torch.parallel.mesh.ppermute`, each
visiting block merged by the online softmax of :func:`_block_update`
(torch ops in f32, as the JAX einsums compute with
``preferred_element_type=float32``): n-1 update-and-rotate steps and a
final update, with no trailing exchange. The backward is autograd through
the same ops; the ppermute's backward sends each K/V gradient back along
the inverse permutation to the rank that owns the slice. Memory per rank is
O((S/n)^2) per head, and the result is full attention over the whole
sequence.

:func:`ring_attention` takes the rank's local slices;
:func:`ring_self_attention` takes q/k/v whole on every rank of the seq
group (the UNet's replicated activations) and wraps the local call in the
region boundary (``parallel/mesh.seq_scatter`` / ``seq_gather``), as the
JAX ``shard_map`` wrapper does.
"""

from __future__ import annotations

import torch

from dcr_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh, ppermute, seq_gather, seq_scatter


def _block_update(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                  m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online-softmax merge of one visiting K/V block. q [B,Sq,H,D];
    k_blk/v_blk [B,Sk,H,D]; m/l [B,H,Sq,1]; acc [B,Sq,H,D] (f32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)                                  # [B,H,Sq,Sk]
    corr = torch.exp(m - m_new)                               # [B,H,Sq,1]
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk)
    acc_new = acc * corr.transpose(1, 2) + pv.float()
    return m_new, l_new, acc_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group) -> torch.Tensor:
    """Exact attention with K/V rotating around ``group`` (None: one rank).
    q/k/v are the rank's slices [B, S_local, H, D]; returns its output slice."""
    n = 1 if group is None else torch.distributed.get_world_size(group)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    b, sq, h, d = q.shape
    m = torch.full((b, h, sq, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    for _ in range(n - 1):
        m, l, acc = _block_update(q, k, v, m, l, acc, scale)
        k, v = ppermute(k, group), ppermute(v, group)
    m, l, acc = _block_update(q, k, v, m, l, acc, scale)
    return (acc / l.transpose(1, 2)).to(q.dtype)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh: Mesh) -> torch.Tensor:
    """q/k/v whole [B, S, H, D] on every rank of the seq group; the sequence
    is split over the group, and the output is whole again."""
    group = mesh.group(SEQ_AXIS)
    q, k, v = (seq_scatter(t, group, 1) for t in (q, k, v))
    return seq_gather(ring_attention(q, k, v, group), group, 1)
