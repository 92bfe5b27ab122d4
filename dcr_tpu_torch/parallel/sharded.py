"""Sharded parameter storage: FSDP (ZeRO-3) and tensor-parallel shards.

GSPMD does this work for the JAX package; the port does it here. Between
steps each rank holds only its shards (``parallel/sharding.py`` places
them): of the parameters, and, through the train state, of the gradients,
the Adam moments and the EMA. A :class:`Layout` maps every tensor of the
three models to its :class:`~dcr_tpu_torch.parallel.sharding.Placement`
and cuts or joins tensors by it.

- **FSDP.** A module that holds an FSDP shard of its own parameters runs :class:`_FsdpForward`: its full weight is
  all-gathered for its own forward only (``mesh.fsdp_gather``, cast to the
  compute dtype first under :func:`compute_dtype`, so a bf16 step moves
  half the bytes), and freed when the module returns: the tensors autograd
  saves of it are packed as a token and gathered again when the backward
  reaches the module (``torch.autograd.graph.saved_tensors_hooks``). The
  gather's backward reduce-scatters the full gradient, in the shard's
  dtype, so each rank's gradient is its shard's, summed over ``fsdp``.
- **Tensor parallelism.** The modules whose projections are tensor-sharded
  (``models/layers.py``: ``CrossAttention``, ``FeedForward``,
  ``AttentionBlock2D``) get the tensor group and run Megatron's forward.
- :func:`grad_reducer` and :func:`grad_norm` reduce each gradient over the
  axes it is replicated on, and sum the squares of the shards, counting a
  replicated element once.

The checkpoint and export (``core/checkpoint.py``, the Trainer) go through
:meth:`Layout.full` and :meth:`Layout.local`, so the files hold whole
tensors and load on any mesh.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Iterable, Optional

import torch
import torch.nn as nn

from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.parallel.sharding import REPLICATED, Placement, params_sharding

# the dtype an FSDP shard is cast to before its gather (None: as stored)
_COMPUTE_DTYPE: ContextVar[Optional[torch.dtype]] = ContextVar("fsdp_compute_dtype",
                                                               default=None)
# the optimizer's flat key prefixes (diffusion/train._flat) by component
_FLAT_COMPONENT = {"unet": "unet", "text_encoder": "text"}


@contextmanager
def compute_dtype(dtype: Optional[torch.dtype]):
    """FSDP gathers inside the block cast their shards to ``dtype`` first."""
    token = _COMPUTE_DTYPE.set(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(token)


def dtype_of(weight: torch.Tensor) -> torch.dtype:
    """The dtype a model computes in, given one of its weights: inside a
    :func:`compute_dtype` block the block's (an FSDP shard stays as stored
    until its gather casts it), else the weight's own."""
    return _COMPUTE_DTYPE.get() or weight.dtype


class Layout:
    """The placement of every tensor of the models on ``mesh``:
    ``placements[component][name]`` (components ``unet``, ``vae``,
    ``text``), and each one's whole shape, ``shapes[component][name]``."""

    def __init__(self, mesh: pmesh.Mesh, placements: dict, shapes: dict):
        self.mesh = mesh
        self.placements = placements
        self.shapes = shapes

    def placement(self, component: Optional[str], name: str) -> Placement:
        """The placement of ``component``'s tensor ``name``; with
        ``component`` None, of an optimizer key ``<unet|text_encoder>/<name>``
        (anything else, the loss: replicated)."""
        if component is None:
            prefix, _, name = name.partition("/")
            component = _FLAT_COMPONENT.get(prefix)
        return self.placements.get(component, {}).get(name, REPLICATED)

    def _cuts(self, p: Placement):
        for axis, dim in ((pmesh.FSDP_AXIS, p.fsdp), (pmesh.TENSOR_AXIS, p.tensor)):
            if dim is not None:
                yield axis, dim

    def local(self, full: torch.Tensor, p: Placement) -> torch.Tensor:
        """This rank's shard of the whole tensor ``full`` (a copy)."""
        out = full
        for axis, dim in self._cuts(p):
            n, i = self.mesh.size(axis), self.mesh.index(axis)
            out = out.chunk(n, dim=dim)[i]
        return out if out is full else out.contiguous().clone()

    def full_shape(self, shape: Iterable[int], p: Placement) -> tuple[int, ...]:
        shape = list(shape)
        for axis, dim in self._cuts(p):
            shape[dim] *= self.mesh.size(axis)
        return tuple(shape)

    @torch.no_grad()
    def full(self, t: torch.Tensor, p: Placement) -> torch.Tensor:
        """The whole tensor of this rank's shard ``t``: every rank of the
        shard's groups calls it."""
        out = t.detach()
        for axis, dim in reversed(list(self._cuts(p))):
            out = pmesh._all_gather(out, self.mesh.group(axis), dim, "gather_whole")
        return out

    def full_dict(self, component: Optional[str], tensors: dict, *, keep: bool = True) -> dict:
        """``{name: whole tensor on the host}`` of a component's shards (None:
        of optimizer keys); every rank calls it, and ``keep=False`` gives
        ``{}``, the rank taking part in the gathers only."""
        out = {}
        for name, t in tensors.items():
            whole = self.full(t, self.placement(component, name))
            if keep:
                out[name] = whole.cpu()
        return out


def place(mesh: pmesh.Mesh, params: dict, *, text_heads: int = 1,
          min_fsdp_size: int = 2 ** 16) -> Layout:
    """The layout of ``{component: {name: whole tensor}}`` under the JAX
    rules (tensor parallelism when the mesh's ``tensor`` axis is above 1,
    as the JAX ``shard_train_state`` turns it on), and each tensor cut to
    this rank's shard in place (``t.data``: a module's Parameter stays the
    same object)."""
    tensor_parallel = mesh.size(pmesh.TENSOR_AXIS) > 1
    layout = Layout(mesh, params_sharding(mesh, params, tensor_parallel=tensor_parallel,
                                          text_heads=text_heads,
                                          min_fsdp_size=min_fsdp_size),
                    {c: {k: tuple(t.shape) for k, t in ts.items()} for c, ts in params.items()})
    for component, tensors in params.items():
        for name, t in tensors.items():
            p = layout.placement(component, name)
            if not p.replicated:
                with torch.no_grad():
                    t.data = layout.local(t.data, p)
    return layout


# -- the modules ---------------------------------------------------------------

class _Regather:
    """A saved full weight, kept as its shard: gathered again on unpack."""

    __slots__ = ("shard", "group", "dim", "dtype", "size", "stride", "offset")

    def __init__(self, shard, group, dim, dtype, t: torch.Tensor):
        self.shard, self.group, self.dim, self.dtype = shard, group, dim, dtype
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()

    def unpack(self) -> torch.Tensor:
        with torch.no_grad():
            shard = self.shard if self.dtype is None else self.shard.to(self.dtype)
            whole = pmesh._all_gather(shard.detach(), self.group, self.dim, "fsdp_regather")
        return whole.as_strided(self.size, self.stride, self.offset)


class _FsdpForward:
    """A leaf module's forward over its whole weights, gathered from the
    FSDP shards it holds (its own Parameters, or what ``functional_call``
    put in their place) and put in their place for this call only, as
    ``functional_call`` puts tensors in place."""

    def __init__(self, module: nn.Module, shards: dict[str, tuple[int, tuple]], group):
        self.module, self.shards, self.group = module, shards, group

    def __call__(self, *args):
        m, dtype = self.module, _COMPUTE_DTYPE.get()
        shards, gathered = {}, {}
        try:
            for name, (dim, whole) in self.shards.items():
                t = m._parameters[name]
                if tuple(t.shape) == whole:
                    continue
                cast = dtype if t.is_floating_point() else None
                shards[name] = t
                m._parameters[name] = full = pmesh.fsdp_gather(t, self.group, dim, dtype=cast)
                gathered[full.untyped_storage().data_ptr()] = (t, dim, cast)
            if not gathered or not torch.is_grad_enabled():
                return type(m).forward(m, *args)
            return self._with_regather(m, args, gathered)
        finally:
            m._parameters.update(shards)

    def _with_regather(self, m: nn.Module, args, gathered: dict):
        """The forward with every saved view of a gathered weight packed as
        its shard, gathered again when the backward unpacks it."""

        def pack(t: torch.Tensor):
            try:
                key = t.untyped_storage().data_ptr()
            except (RuntimeError, NotImplementedError):
                return t
            if key in gathered:
                shard, dim, cast = gathered[key]
                return _Regather(shard, self.group, dim, cast, t)
            return t

        def unpack(obj):
            return obj.unpack() if isinstance(obj, _Regather) else obj

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            return type(m).forward(m, *args)


def install(module: nn.Module, component: str, layout: Layout) -> None:
    """Give ``module``'s leaf modules holding FSDP shards the gathering
    forward, and its tensor-parallel blocks (those naming ``TP_COLUMN`` /
    ``TP_ROW`` projections) the tensor group."""
    mesh = layout.mesh
    for mname, m in module.named_modules():
        prefix = f"{mname}." if mname else ""
        col, row = getattr(m, "TP_COLUMN", ()), getattr(m, "TP_ROW", ())
        if col or row:
            on = lambda names: bool(names) and all(
                layout.placement(component, f"{prefix}{n}.weight").tensor is not None
                for n in names)
            m.tp_col, m.tp_row = on(col), on(row)
            m.tp_group = mesh.group(pmesh.TENSOR_AXIS) if (m.tp_col or m.tp_row) else None
        shards = {}
        for pname, _ in m.named_parameters(recurse=False):
            name = f"{prefix}{pname}"
            p = layout.placement(component, name)
            if p.fsdp is not None:
                shards[pname] = (p.fsdp, layout.shapes[component][name])
        if shards:
            m.forward = _FsdpForward(m, shards, mesh.group(pmesh.FSDP_AXIS))


def place_models(models, mesh: pmesh.Mesh, params: Optional[dict] = None, *,
                 text_heads: Optional[int] = None, min_fsdp_size: int = 2 ** 16
                 ) -> Optional[Layout]:
    """Shard the models of a ``DiffusionModels`` bundle on ``mesh``: the
    tensors of ``params`` (``{"unet", "vae", "text"}``; default the modules'
    own parameters) cut in place and the modules given their gathering
    forwards and tensor groups. None (nothing done) on a mesh whose
    ``fsdp`` and ``tensor`` are 1."""
    if mesh is None or (mesh.size(pmesh.FSDP_AXIS) == 1
                        and mesh.size(pmesh.TENSOR_AXIS) == 1):
        return None
    modules = {"unet": models.unet, "vae": models.vae, "text": models.text_encoder}
    if params is None:
        params = {c: dict(m.named_parameters()) for c, m in modules.items()}
    heads = text_heads or models.text_encoder.config.text_heads
    layout = place(mesh, params, text_heads=heads, min_fsdp_size=min_fsdp_size)
    for component, module in modules.items():
        install(module, component, layout)
    return layout


def cast_to_compute(policy, component: str, params: dict, layout: Optional[Layout]) -> dict:
    """``policy.cast_to_compute(params)``, with the FSDP shards left as
    stored: their gather casts them (under :func:`compute_dtype`)."""
    if layout is None:
        return policy.cast_to_compute(params)
    return {k: t if layout.placement(component, k).fsdp is not None
            else policy.cast_to_compute(t) for k, t in params.items()}


# -- the gradients ---------------------------------------------------------------

def grad_reducer(layout: Layout) -> Callable[[dict], None]:
    """``reduce(grads)`` in place, for ``{optimizer key: gradient}``: the
    mean over the batch ranks (``data`` x ``fsdp``; a sharded mesh has no
    ``seq`` axis), each gradient reduced over the axes it is replicated on.
    An FSDP shard's gradient is already summed over ``fsdp`` (its gather's
    backward): it is summed over ``data``; any other over ``data`` x
    ``fsdp``; none over ``tensor``, whose ranks hold other shards or equal
    gradients."""
    mesh = layout.mesh
    n_fsdp = mesh.size(pmesh.FSDP_AXIS)
    rest = mesh.group(pmesh.DATA_AXIS)
    every = mesh.batch_group

    def reduce(grads: dict) -> None:
        sharded = [g for k, g in grads.items() if layout.placement(None, k).fsdp is not None]
        other = [g for k, g in grads.items() if layout.placement(None, k).fsdp is None]
        if sharded:
            if rest is not None:
                pmesh.all_reduce_mean_(sharded, rest)
            for g in sharded:
                g.div_(n_fsdp)
        if other and every is not None:
            pmesh.all_reduce_mean_(other, every)
    return reduce


def grad_norm(layout: Layout) -> Callable[[dict], torch.Tensor]:
    """``norm(grads)``: optax's global norm of the gradients whose shards
    the ranks hold: each shard's sum of squares summed over the axes it is
    sharded on, a replicated gradient counted once."""
    mesh = layout.mesh

    def norm(grads: dict) -> torch.Tensor:
        parts: dict[tuple, list] = {}
        for k, g in grads.items():
            p = layout.placement(None, k)
            axes = tuple(a for a, d in ((pmesh.FSDP_AXIS, p.fsdp),
                                        (pmesh.TENSOR_AXIS, p.tensor)) if d is not None)
            parts.setdefault(axes, []).append(g.float().pow(2).sum())
        total = []
        for axes, sums in parts.items():
            s = torch.stack(sums).sum().reshape(1)
            for axis in axes:
                s = pmesh._all_reduce(s, mesh.group(axis), "norm_all_reduce")
            total.append(s)
        return torch.cat(total).sum().sqrt()
    return norm
