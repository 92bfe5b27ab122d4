"""The process mesh and its exchanges: the port's copy of
``dcr_tpu/parallel/mesh.py`` on ``torch.distributed``.

One process per device, laid out as the JAX mesh lays out its devices: the
ranks ``0..n-1`` reshaped to ``(data, fsdp, tensor, seq)``, seq innermost,
so rank r sits where the JAX mesh puts device r. Each axis of size above 1
gets one process group per line of ranks along it, and ``data`` x
``fsdp``, when both are above 1, one per plane. The global batch splits over ``data`` x ``fsdp``,
as the JAX ``batch_sharding`` does (a rank's rows by its ``(data, fsdp)``
coordinate, fsdp minor); the ``tensor`` and ``seq`` replicas of one batch
group hold the same rows. ``seq`` splits only the long self-attentions
(``ops/ring_attention``, ``ops/ulysses_attention``); ``fsdp`` shards the
parameters and ``tensor`` the transformer projections
(``parallel/sharding.py``, ``parallel/sharded.py``). ``seq`` above 1 with
``fsdp`` or ``tensor`` above 1 is ROADMAP Queue A item 9c.

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
- :func:`fsdp_gather` (forward: all-gather a parameter's shards along a
  dimension, cast first when asked; backward: reduce-scatter, a sum);
- Megatron's *f* :func:`tensor_enter` (forward: identity; backward:
  all-reduce over ``tensor``) and *g* :func:`tensor_reduce` (forward:
  all-reduce over ``tensor``; backward: identity), and the tensor group's
  replicated region, :func:`tensor_gather` / :func:`tensor_scatter` (the
  pair the seq region uses, over ``tensor``);
- :func:`all_reduce_mean_`, the gradients' mean over a group, in buckets.

gloo moves CUDA tensors only for ``broadcast`` and ``all_reduce``, so on a
gloo group every exchange here stages a CUDA tensor through host memory
(``.cpu()``, the collective, ``.to(device)``); NCCL moves device memory.
FSDP's reduce-scatter is an all-to-all of the gradient's chunks in their
own dtype, summed on arrival in the shard's.
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
# the batch axes: the rows split over both, and they get a group per plane
# when both are above 1 (seq with either sharded axis is item 9c)
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)


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
    def batch_group(self):
        """The group of this rank's batch ranks (:data:`BATCH_AXES`, ``data``
        x ``fsdp``, the other axes fixed): None when both are 1, the one
        axis's own group when only one is above 1."""
        live = [a for a in BATCH_AXES if self.shape[a] > 1]
        if not live:
            return None
        return self.groups[live[0] if len(live) == 1 else "+".join(live)]

    @property
    def batch_index(self) -> int:
        """This rank's place along the batch axes: ``data`` major, ``fsdp``
        minor, as the JAX ``P((data, fsdp))`` splits the rows."""
        return self.coords[DATA_AXIS] * self.shape[FSDP_AXIS] + self.coords[FSDP_AXIS]

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
    if s > 1 and (f > 1 or t > 1):
        raise NotPortedError(
            f"mesh.seq={s} with mesh.fsdp={f}, mesh.tensor={t}: sequence parallelism "
            "together with FSDP or tensor-parallel sharding is not ported to "
            "dcr_tpu_torch yet (ROADMAP Queue A item 9c)")
    shape = dict(zip(AXES, (d, f, t, s)))
    grid = np.arange(world).reshape(d, f, t, s)
    coords = mesh_coords(cfg, world, rank)
    groups: dict[str, Optional[object]] = {}
    for axes in [(a,) for a in AXES] + [BATCH_AXES]:
        live = [a for a in axes if shape[a] > 1]
        if len(live) != len(axes):
            if len(axes) == 1:
                groups[axes[0]] = None
            continue
        idx = [AXES.index(a) for a in axes]
        n = int(np.prod([shape[a] for a in axes]))
        planes = np.moveaxis(grid, idx, list(range(4 - len(idx), 4))).reshape(-1, n)
        for plane in planes:  # every process makes every group, in one order
            group = tdist.new_group([int(r) for r in plane])
            if rank in plane:
                groups["+".join(axes)] = group
    return Mesh(shape=shape, coords=coords, groups=groups, rank=rank, world=world)


def data_parallel_size(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS] * mesh.shape[FSDP_AXIS]


def local_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of a global batch (dim 0), by its ``(data, fsdp)``
    coordinate."""
    n = 1 if mesh is None else mesh.data_parallel_size
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} does not split over {n} data x fsdp "
                         "ranks")
    b = x.shape[0] // n
    i = mesh.batch_index
    return x[i * b:(i + 1) * b]


def fsdp_axis(shape: Sequence[int], fsdp: int, min_size: int = 2 ** 16) -> Optional[int]:
    """The FSDP rule on a JAX shape: the axis sharded over ``fsdp`` ranks
    (the largest that ``fsdp`` divides, ties to the first), or None when
    the tensor is too small to be worth scattering or no axis divides."""
    if fsdp > 1 and int(np.prod(shape, dtype=np.int64)) >= min_size:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % fsdp == 0:
                return i
    return None


def fsdp_spec(mesh: Mesh, shape: Sequence[int], min_size: int = 2 ** 16) -> Optional[int]:
    """``dcr_tpu/parallel/mesh.fsdp_spec`` on a JAX shape: the axis sharded
    over the mesh's ``fsdp`` axis, or None (replicated)."""
    return fsdp_axis(shape, mesh.shape[FSDP_AXIS], min_size)


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


def _all_gather(x: torch.Tensor, group, dim: int, kind: str = "all_gather") -> torch.Tensor:
    start = time.perf_counter()
    send = _to_comm(x, group)
    parts = [torch.empty_like(send) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=dim).to(x.device)
    _note(kind, start, send.numel() * send.element_size())
    return out


def _all_reduce(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The sum of ``x`` over ``group``, as a new tensor."""
    start = time.perf_counter()
    comm = _to_comm(x, group)
    if comm is x:
        comm = x.clone()
    tdist.all_reduce(comm, op=tdist.ReduceOp.SUM, group=group)
    _note(kind, start, comm.numel() * comm.element_size())
    return comm.to(x.device)


def _reduce_scatter(x: torch.Tensor, group, dim: int, dtype: torch.dtype,
                    kind: str) -> torch.Tensor:
    """The sum over ``group`` of this rank's chunk along ``dim`` of every
    rank's ``x``, formed in ``dtype``: an all-to-all of the chunks in
    ``x``'s dtype (a bf16 gradient moves half an f32 one's bytes), summed
    here, so the sum of bf16 terms is the exact f32 sum one process's cast
    and mean would form."""
    start = time.perf_counter()
    n = tdist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    send = _to_comm(torch.stack(x.chunk(n, dim=dim)), group)
    recv = torch.empty_like(send)
    tdist.all_to_all_single(recv, send, group=group)
    out = recv.to(x.device).to(dtype).sum(0)
    _note(kind, start, send.numel() * send.element_size())
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
    def forward(ctx, x, group, dim, kind="all_gather"):
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return _own_chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim, ctx.kind), None, None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, kind="all_gather"):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.group, ctx.dim), None, None, None


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


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, dtype):
        ctx.args = (group, dim, x.dtype)
        return _all_gather(x if dtype is None else x.to(dtype), group, dim, "fsdp_gather")

    @staticmethod
    def backward(ctx, g):
        group, dim, dtype = ctx.args
        return (_reduce_scatter(g.contiguous(), group, dim, dtype, "fsdp_reduce_scatter"),
                None, None, None)


class _TensorEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group, "tp_all_reduce"), None


class _TensorReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, "tp_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


def fsdp_gather(x: torch.Tensor, group, dim: int, *,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole parameter of the ``fsdp`` group's shards ``x``: the
    shards concatenated along ``dim`` in rank order, each cast to ``dtype``
    before it moves (half the bytes for a bf16 copy of an f32 shard).
    Backward: the whole gradient summed over the group, this rank's chunk
    of it (a reduce-scatter), in ``x``'s dtype (bf16 gradients move as
    bf16 and are summed in f32, as one process's cast and mean sum them)."""
    if group is None:
        return x if dtype is None else x.to(dtype)
    return _FsdpGather.apply(x, group, dim, dtype)


def tensor_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Into the tensor group's replicated region: the ranks' ``x``
    concatenated along ``dim`` (a column-parallel output made whole).
    Backward: this rank's chunk of the gradient, which every rank holds
    whole there."""
    return x if group is None else _SeqGather.apply(x, group, dim % x.dim(), "tp_all_gather")


def tensor_scatter(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Out of the replicated region: this rank's chunk of ``x`` along
    ``dim`` (the input of a row-parallel layer, a column-parallel layer's
    bias). Backward: the chunks' gradients all-gathered, so a replicated
    tensor's gradient is whole and equal on every rank."""
    return x if group is None else _SeqScatter.apply(x, group, dim % x.dim(), "tp_all_gather")


def tensor_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*, where a replicated activation enters a
    column-parallel layer: the identity; backward, the gradient summed over
    the tensor group."""
    return x if group is None else _TensorEnter.apply(x, group)


def tensor_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*, after a row-parallel layer: the partial outputs
    summed over the tensor group; backward, the identity."""
    return x if group is None else _TensorReduce.apply(x, group)


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
    """The batch group's rows of ``x`` concatenated in ``(data, fsdp)``
    order: the global batch of a per-rank tensor. Its gradient is summed
    over the group."""
    group = None if mesh is None else mesh.batch_group
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
    """A batch-sharded tensor (each batch rank holds its rows) as host numpy
    on every process: the rows of the whole ``data`` x ``fsdp`` group, under
    :func:`dist.default_allgather_timeout_s`, so a dead peer becomes a
    named ``BarrierTimeout`` instead of a hang."""
    group = None if mesh is None else mesh.batch_group
    if group is None:
        return x.detach().cpu().numpy()
    return dist.run_with_timeout(lambda: _all_gather(x.detach(), group, 0).cpu().numpy(),
                                 dist.default_allgather_timeout_s(), name="to_host")

