"""Mixed-precision policy: parameters in f32, compute in bf16.

Counterpart of ``dcr_tpu/core/precision.py``. The master weights stay f32;
:meth:`Policy.cast_to_compute` casts a dict of parameters (or one tensor) to
the compute dtype with ``.to()``, which autograd records, so the gradient of
the bf16 copy flows back to the f32 master as the JAX package's cast at the
jit boundary does. No loss scaling: bf16 needs none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


def _cast(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree


@dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.bfloat16

    def cast_to_compute(self, tree: Any) -> Any:
        return _cast(tree, self.compute_dtype)


def policy_from_string(mixed_precision: str) -> Policy:
    if mixed_precision in ("no", "fp32", "float32"):
        return Policy(compute_dtype=torch.float32)
    if mixed_precision in ("bf16", "bfloat16"):
        return Policy(compute_dtype=torch.bfloat16)
    raise ValueError(f"unsupported mixed_precision {mixed_precision!r} (use 'no' or 'bf16')")
