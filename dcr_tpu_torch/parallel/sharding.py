"""Parameter placement rules: FSDP and Megatron-style tensor parallelism.

The port's copy of ``dcr_tpu/parallel/sharding.py``, over the FSDP rule of
``parallel/mesh.py`` (``fsdp_spec``). The rules are the JAX
package's, stated on its layout (a Dense kernel ``[in, out]``, a conv kernel
HWIO, the text encoder's attention kernels ``[D, H, hd]`` / ``[H, hd, D]``)
and carried to the port's tensors through the transposes of
``models/export.py``:

- tensor parallelism (when asked for): the q/k/v projections and the GEGLU
  input projection (``_COLUMN_PAT``) shard their output features over
  ``tensor`` when those divide; the attention output and the feed-forward
  output projections (``_ROW_PAT``) their input features. They match the
  UNet's transformer blocks and the VAE's mid-block attention, not the text
  encoder;
- FSDP: any other tensor of at least ``min_fsdp_size`` elements shards its
  largest axis that ``fsdp`` divides (ties to the first in the JAX order);
- everything else is replicated.

A :class:`Placement` names the port tensor's dimension sharded over each
axis. The optimizer state and the EMA take their parameter's placement: the
JAX rules give each state leaf the placement of a parameter of its shape.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from dcr_tpu_torch.parallel.mesh import FSDP_AXIS, TENSOR_AXIS, Mesh, fsdp_axis

# column-parallel (shard the output features): qkv projections, ff up-projection
_COLUMN_PAT = re.compile(r"(to_q|to_k|to_v|ff/proj_in|qkv)/kernel$")
# row-parallel (shard the input features): attention out, ff down-projection
_ROW_PAT = re.compile(r"(to_out|ff/proj_out)/kernel$")

# the port's name endings of the JAX kernels the two patterns can match
# (models/export.py: unet_name_map, vae_name_map)
_JAX_KERNEL = (
    (".to_q.weight", "to_q/kernel"), (".to_k.weight", "to_k/kernel"),
    (".to_v.weight", "to_v/kernel"), (".to_out.0.weight", "to_out/kernel"),
    (".ff.net.0.proj.weight", "ff/proj_in/kernel"), (".ff.net.2.weight", "ff/proj_out/kernel"),
    (".query.weight", "to_q/kernel"), (".key.weight", "to_k/kernel"),
    (".value.weight", "to_v/kernel"), (".proj_attn.weight", "to_out/kernel"),
)


@dataclass(frozen=True)
class Placement:
    """The port tensor's dimension sharded over ``fsdp`` and over
    ``tensor`` (None: not sharded over that axis)."""

    fsdp: Optional[int] = None
    tensor: Optional[int] = None

    @property
    def replicated(self) -> bool:
        return self.fsdp is None and self.tensor is None


REPLICATED = Placement()


def _jax_view(component: str, name: str, shape: tuple[int, ...], text_heads: int
              ) -> tuple[str, tuple[int, ...], list[Optional[int]]]:
    """(the JAX path ending the patterns read, the JAX shape, the port
    dimension of each JAX axis: None where a JAX axis is no contiguous
    chunk of one port dimension)."""
    if component == "text":
        d = shape[-1] if len(shape) == 2 else None
        # hd is a contiguous chunk of the port's H * hd features for one head
        # only (the rule never picks it otherwise: H * hd outranks it)
        one = text_heads == 1
        if name.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight")):
            return "", (d, text_heads, d // text_heads), [1, 0, 0 if one else None]
        if name.endswith("out_proj.weight"):
            return "", (text_heads, d // text_heads, shape[0]), [1, 1 if one else None, 0]
        if name.endswith(("q_proj.bias", "k_proj.bias", "v_proj.bias")):
            return "", (text_heads, shape[0] // text_heads), [0, 0 if one else None]
        if name.endswith(("fc1.weight", "fc2.weight")):
            return "", (shape[1], shape[0]), [1, 0]
        return "", shape, list(range(len(shape)))                     # embeddings, norms
    path = next((jax for port, jax in _JAX_KERNEL if name.endswith(port)), "")
    if len(shape) == 4 and name.endswith(".weight"):                 # OIHW <- HWIO
        return path, (shape[2], shape[3], shape[1], shape[0]), [2, 3, 1, 0]
    if len(shape) == 2 and name.endswith(".weight"):                 # [out, in] <- [in, out]
        return path, (shape[1], shape[0]), [1, 0]
    return path, shape, list(range(len(shape)))


def placement(component: str, name: str, shape: tuple[int, ...], *, fsdp: int, tensor: int,
              text_heads: int = 1, min_fsdp_size: int = 2 ** 16) -> Placement:
    """One port tensor's placement under the JAX rules (``tensor`` 1: no
    tensor parallelism)."""
    path, jshape, to_port = _jax_view(component, name, tuple(shape), text_heads)
    if tensor > 1 and len(jshape) == 2:
        if _COLUMN_PAT.search(path) and jshape[1] % tensor == 0:
            return Placement(tensor=to_port[1])
        if _ROW_PAT.search(path) and jshape[0] % tensor == 0:
            return Placement(tensor=to_port[0])
    axis = fsdp_axis(jshape, fsdp, min_fsdp_size)
    if axis is None:
        return REPLICATED
    if to_port[axis] is None:
        raise ValueError(f"{component}/{name}: the JAX FSDP rule shards axis {axis} of "
                         f"{jshape}, which is no contiguous chunk of the port's tensor")
    return Placement(fsdp=to_port[axis])


def params_sharding(mesh: Mesh, params: dict, *, tensor_parallel: bool = False,
                    text_heads: int = 1, min_fsdp_size: int = 2 ** 16) -> dict:
    """``{component: {name: Placement}}`` for ``{component: {name:
    tensor}}`` (components ``unet``, ``vae``, ``text``, as the JAX package
    places ``{"unet", "vae", "text"}``): the tensor-parallel rules first
    (when ``tensor_parallel``), then the FSDP rule, else replicated.
    ``text_heads`` is the text encoder's head count, which its JAX kernel
    shapes carry."""
    fsdp = mesh.size(FSDP_AXIS)
    tensor = mesh.size(TENSOR_AXIS) if tensor_parallel else 1
    return {component: {name: placement(component, name, tuple(t.shape), fsdp=fsdp,
                                        tensor=tensor, text_heads=text_heads,
                                        min_fsdp_size=min_fsdp_size)
                         for name, t in tensors.items()}
            for component, tensors in params.items()}
