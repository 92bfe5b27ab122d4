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

Eval and search split rows, not parameters (the JAX ``dcr_tpu/eval`` and
``dcr_tpu/search`` shardings): a batch or a store segment over ``data`` x
``fsdp`` (:func:`rank_slab`, :func:`to_host`), the similarity products'
query rows over every rank (:func:`gather_world_rows`), each padded first
(:func:`pad_rows`); the engines' per-rank top-k tables meet in
:func:`exchange_topk`, one all-gather of the candidates and a merge in the
one-device order. Their gathers wait under
:func:`dist.default_allgather_timeout_s`, so a dead peer raises a named
``BarrierTimeout`` instead of hanging.

gloo moves CUDA tensors only for ``broadcast`` and ``all_reduce``, so on a
gloo group every exchange here stages a CUDA tensor through host memory
(``.cpu()``, the collective, ``.to(device)``); NCCL moves device memory.
FSDP's reduce-scatter is an all-to-all of the gradient's chunks in their
own dtype, summed on arrival in the shard's.
"""

from __future__ import annotations

import json
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




# -- row splits and the top-k exchange of eval and search ---------------------

#: the row id of a pad candidate while candidates sort (after every real row)
NO_ROW = np.iinfo(np.int64).max


def rank_slab(n: int, parts: int, index: int) -> slice:
    """Part ``index`` of ``n`` rows cut into ``parts`` equal slabs in order
    (``n`` a multiple of ``parts``): the rows a JAX row sharding over
    ``parts`` devices puts on device ``index``."""
    if n % parts:
        raise ValueError(f"{n} rows do not split over {parts} ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


@dataclass(frozen=True)
class Slabs:
    """A store's rows in segments of ``segment_rows``, each cut into
    ``parts`` equal slabs over the ``data`` x ``fsdp`` ranks, and this
    rank's slab of each (the JAX engines' ``P((data, fsdp))`` on a
    segment): the rows a search engine's rank holds and reads."""

    segment_rows: int
    parts: int = 1
    index: int = 0

    @classmethod
    def of(cls, want: int, mesh: Optional[Mesh]) -> "Slabs":
        """Segments of at least ``want`` rows, padded up to a multiple of
        the mesh's batch ranks as the JAX engines pad them."""
        n = 1 if mesh is None else mesh.data_parallel_size
        return cls(-(-int(want) // n) * n, n, 0 if mesh is None else mesh.batch_index)

    @property
    def rows(self) -> int:
        return self.segment_rows // self.parts

    def slab(self, seg: int, total: int) -> tuple[int, int]:
        """This rank's global rows ``[lo, hi)`` of segment ``seg`` of
        ``total`` rows (empty past the end)."""
        lo = seg * self.segment_rows + self.index * self.rows
        return lo, max(lo, min(lo + self.rows, total))

    def meets(self, a: int, e: int, total: int) -> bool:
        """Whether global rows ``[a, e)`` (a shard, a list) hold rows of
        one of this rank's slabs."""
        for seg in range(a // self.segment_rows, (e - 1) // self.segment_rows + 1):
            lo, hi = self.slab(seg, total)
            if lo < e and a < hi:
                return True
        return False


def pad_rows(x: np.ndarray, multiple: int, *, repeat_last: bool = False) -> np.ndarray:
    """``x`` padded along dim 0 to a multiple of ``multiple``, after its real
    rows: zero rows where JAX pads with zeros (``_row_sharded``,
    ``dcr_tpu/eval/similarity.py:49-53``), copies of the last row where it
    repeats it (the CLIP score, ``dcr_tpu/eval/runner.py:203-207``, and the
    extractors' last batch)."""
    pad = (-x.shape[0]) % max(1, multiple)
    if not pad:
        return x
    fill = (np.repeat(x[-1:], pad, axis=0) if repeat_last
            else np.zeros((pad, *x.shape[1:]), x.dtype))
    return np.concatenate([x, fill])


def _bounded(fn, name: str):
    return dist.run_with_timeout(fn, dist.default_allgather_timeout_s(), name=name)


def _comm_device(group) -> torch.device:
    """Where a host array goes to be exchanged: the host for gloo, the
    current CUDA device for NCCL."""
    return (torch.device("cpu") if _host_staged(group)
            else torch.device("cuda", torch.cuda.current_device()))


def gather_world_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> np.ndarray:
    """Every rank's rows of ``x`` concatenated in rank order over every rank
    of the mesh, as host numpy on each (the similarity products' split, the
    JAX ``P(tuple(mesh.axis_names))``)."""
    if mesh is None or mesh.world == 1:
        return x.detach().cpu().numpy()
    return _bounded(lambda: _all_gather(x.detach(), None, 0, "row_gather").cpu().numpy(),
                    "gather_world_rows")


def union_over_ranks(items, tag: str, mesh: Optional[Mesh]) -> set[int]:
    """The union of every rank's ``items`` (ints) on the job's control plane
    (the store; bounded), so the ranks agree on, e.g., the store shards that
    failed verification on any of them. Local without a mesh of ranks."""
    mine = {int(i) for i in items}
    if mesh is None or mesh.world == 1:
        return mine
    rows = dist.kv_allgather(json.dumps(sorted(mine)), f"union:{tag}",
                             dist.default_allgather_timeout_s())
    return set().union(*(json.loads(r) for r in rows))


def merge_candidates(scores: np.ndarray, rows: np.ndarray, keys: Optional[np.ndarray],
                     k: int) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The best ``k`` of each row of a candidate table ``(scores [n, m],
    global row ids [n, m], keys [n, m] or None)`` in the one-device order:
    score descending, the lower global row first on equal scores (the order
    of ``lax.top_k`` over the whole segment). Pads (``-inf``) sort last,
    with row -1 and key ``""``; fewer than ``k`` candidates pad to ``k``."""
    n, m = scores.shape
    if m < k:
        scores = np.concatenate([scores, np.full((n, k - m), -np.inf, np.float32)], axis=1)
        rows = np.concatenate([rows, np.full((n, k - m), -1, np.int64)], axis=1)
        if keys is not None:
            keys = np.concatenate([keys, np.full((n, k - m), "", dtype=object)], axis=1)
    pad = np.isneginf(scores)
    order = np.lexsort((np.where(pad, NO_ROW, rows), -scores), axis=-1)[:, :k]
    scores = np.take_along_axis(scores, order, axis=1)
    pad = np.isneginf(scores)
    rows = np.where(pad, -1, np.take_along_axis(rows, order, axis=1))
    if keys is not None:
        keys = np.where(pad, "", np.take_along_axis(keys, order, axis=1)).astype(object)
    return scores, rows, keys


def exchange_topk(scores: np.ndarray, rows: np.ndarray, keys: Optional[np.ndarray], k: int,
                  mesh: Optional[Mesh]) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The cross-rank top-k: each batch rank's candidates ``(scores [n, m],
    global row ids [n, m], keys [n, m] or None)`` for the same ``n``
    queries, merged into the best ``k`` of their union on every rank by
    :func:`merge_candidates`. One all-gather carries the candidates packed
    as bytes (scores, rows, keys as UTF-8 at the widest rank's width; one
    small gather agrees on the width first), under the bounded wait. The
    ``tensor`` and ``seq`` replicas of a batch group hold the same rows and
    exchange within their own group."""
    group = None if mesh is None else mesh.batch_group
    scores = np.asarray(scores, np.float32)
    rows = np.asarray(rows, np.int64)
    if group is None:
        return merge_candidates(scores, rows, keys, k)
    n, m = scores.shape
    dev = _comm_device(group)
    parts = [np.ascontiguousarray(scores, "<f4").view(np.uint8).reshape(n, m, 4),
             np.ascontiguousarray(rows, "<i8").view(np.uint8).reshape(n, m, 8)]

    def exchange():
        width = 0
        if keys is not None:
            enc = np.char.encode(np.asarray(keys).astype(str), "utf-8")
            mine = torch.tensor([max(1, enc.dtype.itemsize)], dtype=torch.int64, device=dev)
            width = int(_all_gather(mine, group, 0, "topk_exchange").max())
            parts.append(np.ascontiguousarray(enc.astype(f"S{width}")).view(np.uint8)
                         .reshape(n, m, width))
        buf = torch.from_numpy(np.concatenate(parts, axis=2)).to(dev)
        got = _all_gather(buf[None], group, 0, "topk_exchange").cpu().numpy()
        return got, width

    got, width = _bounded(exchange, "exchange_topk")
    ranks = got.shape[0]

    def field(lo: int, hi: int, dtype: str) -> np.ndarray:
        x = np.ascontiguousarray(got[..., lo:hi]).view(dtype)[..., 0]   # [ranks, n, m]
        return np.moveaxis(x, 0, 1).reshape(n, ranks * m)

    all_keys = None
    if keys is not None:
        all_keys = np.char.decode(field(12, 12 + width, f"S{width}"), "utf-8").astype(object)
    return merge_candidates(field(0, 4, "<f4"), field(4, 12, "<i8"), all_keys, k)
