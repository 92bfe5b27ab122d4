"""The process mesh and its exchanges: the port's copy of
``dcr_tpu/parallel/mesh.py`` on ``torch.distributed``.

One process per device, laid out as the JAX mesh lays out its devices: the
ranks ``0..n-1`` reshaped to ``(data, fsdp, tensor, seq)``, seq innermost,
so rank r sits where the JAX mesh puts device r. Each axis of size above 1
gets one process group per line of ranks along it. Training runs
``data`` x ``seq``: the global batch splits over the data axis (the rank's
rows by its data index), and the seq replicas of one data group hold the
same rows and split only the long self-attentions (``ops/ring_attention``,
``ops/ulysses_attention``). ``fsdp`` and ``tensor`` above 1 are ROADMAP
Queue A item 9b.

The exchanges are ``torch.autograd.Function``s, so gradients cross ranks as
they do under GSPMD:

- :func:`ppermute` (backward: the inverse permutation) and
  :func:`all_to_all` (backward: the inverse all_to_all), the collectives of
  ``jax.lax`` that ring and Ulysses attention use;
- the sequence-parallel region's boundary, the transpose GSPMD inserts
  around the JAX ``shard_map``: :func:`seq_scatter` (forward: the rank's
  S/n slice of a replicated tensor; backward: all-gather the gradient) at
  the entry, :func:`seq_gather` (forward: all-gather; backward: slice) at
  the exit;
- :func:`gather_rows` (forward: all-gather the data group's rows;
  backward: sum the gradient over the group, keep the rank's rows), for the
  mixup mitigation, which mixes rows across the global batch;
- :func:`all_reduce_mean_`, the gradients' mean over the world, in buckets.

gloo moves CUDA tensors only for ``broadcast`` and ``all_reduce``, so on a
gloo group every exchange here stages a CUDA tensor through host memory
(``.cpu()``, the collective, ``.to(device)``); NCCL moves device memory.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from dcr_tpu_torch.core import dist
from dcr_tpu_torch.core.config import MeshConfig, NotPortedError

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQ_AXIS)

# bytes per all-reduce bucket of the gradients' mean
BUCKET_BYTES = 64 << 20


@dataclass
class Mesh:
    """This process's place in the mesh: ``shape`` and ``coords`` by axis,
    and the process group of each axis above size 1 (None otherwise)."""

    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, Optional[object]] = field(default_factory=dict)
    rank: int = 0
    world: int = 1

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def data_parallel_size(self) -> int:
        return data_parallel_size(self)

    def __repr__(self) -> str:
        dims = "x".join(str(self.shape[a]) for a in AXES)
        return f"Mesh({dims} {AXES}, rank {self.rank} at {self.coords})"


def mesh_coords(cfg: MeshConfig, world: int, rank: int) -> dict[str, int]:
    """Rank ``rank``'s coordinates by axis: its place in ``range(world)``
    reshaped to the axis sizes, as the JAX mesh places device ``rank``."""
    grid = np.arange(world).reshape(cfg.axis_sizes(world))
    return {a: int(i) for a, i in zip(AXES, np.argwhere(grid == rank)[0])}


def make_mesh(cfg: Optional[MeshConfig] = None, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The mesh of ``cfg`` over the job's processes (``core/dist``), with one
    process group per line of ranks along each axis above size 1. Every
    process calls it, in the same order as any other group it makes."""
    cfg = cfg or MeshConfig()
    world = dist.process_count() if world_size is None else world_size
    rank = dist.process_index() if rank is None else rank
    d, f, t, s = cfg.axis_sizes(world)
    if f > 1 or t > 1:
        raise NotPortedError(
            f"mesh.fsdp={f}, mesh.tensor={t}: FSDP and tensor-parallel sharding are not "
            "ported to dcr_tpu_torch yet (ROADMAP Queue A item 9b)")
    shape = dict(zip(AXES, (d, f, t, s)))
    grid = np.arange(world).reshape(d, f, t, s)
    coords = mesh_coords(cfg, world, rank)
    groups: dict[str, Optional[object]] = {}
    for i, axis in enumerate(AXES):
        groups[axis] = None
        if shape[axis] == 1:
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[axis])
        for line in lines:  # every process makes every group, in one order
            group = tdist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(shape=shape, coords=coords, groups=groups, rank=rank, world=world)


def data_parallel_size(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS] * mesh.shape[FSDP_AXIS]


def local_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of a global batch (dim 0), by its data index."""
    if mesh is None or mesh.shape[DATA_AXIS] == 1:
        return x
    n = mesh.shape[DATA_AXIS]
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} does not split over {n} data ranks")
    b = x.shape[0] // n
    i = mesh.coords[DATA_AXIS]
    return x[i * b:(i + 1) * b]


# -- staging and the plain collectives ---------------------------------------

# seconds, calls and bytes of each exchange kind in this process
EXCHANGE_STATS: dict[str, dict] = {}


def _note(kind: str, start: float, nbytes: int) -> None:
    st = EXCHANGE_STATS.setdefault(kind, {"calls": 0, "seconds": 0.0, "bytes": 0})
    st["calls"] += 1
    st["seconds"] += time.perf_counter() - start
    st["bytes"] += nbytes


def _host_staged(group) -> bool:
    return tdist.get_backend(group) == "gloo"


def _to_comm(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if t.device.type != "cpu" and _host_staged(group) else t


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    start = time.perf_counter()
    send = _to_comm(x, group)
    parts = [torch.empty_like(send) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=dim).to(x.device)
    _note("all_gather", start, send.numel() * send.element_size())
    return out


def _own_chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = tdist.get_world_size(group), tdist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    return x.chunk(n, dim=dim)[r].contiguous()


def _ppermute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    start = time.perf_counter()
    n, r = tdist.get_world_size(group), tdist.get_rank(group)
    send = _to_comm(x, group)
    recv = torch.empty_like(send)
    dst = tdist.get_global_rank(group, (r + shift) % n)
    src = tdist.get_global_rank(group, (r - shift) % n)
    ops = [tdist.P2POp(tdist.isend, send, dst, group),
           tdist.P2POp(tdist.irecv, recv, src, group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    out = recv.to(x.device)
    _note("ppermute", start, send.numel() * send.element_size())
    return out


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    start = time.perf_counter()
    n = tdist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split over {n} ranks")
    send = _to_comm(torch.stack(x.chunk(n, dim=split_dim)), group)
    recv = torch.empty_like(send)
    tdist.all_to_all_single(recv, send, group=group)
    out = torch.cat(recv.to(x.device).unbind(0), dim=concat_dim)
    _note("all_to_all", start, send.numel() * send.element_size())
    return out


# -- the differentiable exchanges --------------------------------------------

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.group, ctx.dim), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_sum_([g], ctx.group)
        return _own_chunk(g, ctx.group, 0), None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on along ``group`` and return
    what the rank ``shift`` places back sent (``jax.lax.ppermute`` with
    ``perm = [(i, (i + shift) % n)]``). Identity without a group."""
    return x if group is None else _PPermute.apply(x, group, shift)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: chunk j of ``split_dim`` goes
    to rank j of ``group``; the chunks received are concatenated along
    ``concat_dim`` in rank order. Identity without a group."""
    return x if group is None else _AllToAll.apply(x, group, split_dim, concat_dim)


def seq_scatter(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Enter the sequence-parallel region: this rank's slice of a tensor
    every rank of ``group`` holds whole."""
    return x if group is None else _SeqScatter.apply(x, group, dim)


def seq_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Leave the sequence-parallel region: the whole tensor on every rank."""
    return x if group is None else _SeqGather.apply(x, group, dim)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The data group's rows of ``x`` concatenated in data order: the global
    batch of a per-rank tensor. Its gradient is summed over the group."""
    group = None if mesh is None else mesh.group(DATA_AXIS)
    return x if group is None else _GatherRows.apply(x, group)


# -- the gradients' reduction ------------------------------------------------

def _buckets(tensors: Sequence[torch.Tensor]) -> list[list[torch.Tensor]]:
    out: list[list[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if not out or size + nbytes > BUCKET_BYTES or out[-1][0].dtype != t.dtype:
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum ``tensors`` over ``group`` (None: the world) in place, in
    buckets of :data:`BUCKET_BYTES`, every bucket's collective in flight at
    once (on gloo the next bucket's copy to the host overlaps the earlier
    ones' exchanges)."""
    start = time.perf_counter()
    nbytes = 0
    pending = []
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        comm = _to_comm(flat, group)
        nbytes += comm.numel() * comm.element_size()
        pending.append((bucket, flat, comm, tdist.all_reduce(
            comm, op=tdist.ReduceOp.SUM, group=group, async_op=True)))
    for bucket, flat, comm, work in pending:
        work.wait()
        flat = comm.to(flat.device)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    _note("all_reduce", start, nbytes)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """The mean of ``tensors`` over ``group`` (None: the world), in place: a
    sum, then a divide by the group's size (exact on one rank)."""
    tensors = list(tensors)
    all_reduce_sum_(tensors, group)
    n = tdist.get_world_size(group)
    for t in tensors:
        t.div_(n)


def to_host(x: torch.Tensor, mesh: Optional[Mesh] = None) -> np.ndarray:
    """A batch-sharded tensor (each data rank holds its rows) as host numpy
    on every process: the rows of the whole data group, under
    :func:`dist.default_allgather_timeout_s`, so a dead peer becomes a
    named ``BarrierTimeout`` instead of a hang."""
    group = None if mesh is None else mesh.group(DATA_AXIS)
    if group is None:
        return x.detach().cpu().numpy()
    return dist.run_with_timeout(lambda: _all_gather(x.detach(), group, 0).cpu().numpy(),
                                 dist.default_allgather_timeout_s(), name="to_host")

