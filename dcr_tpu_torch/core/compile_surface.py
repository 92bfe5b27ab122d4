"""Surface registry: every entry point of the hot paths declares itself.

Own copy of ``dcr_tpu/core/compile_surface.py``. There a *compile surface*
is a function that creates a ``jax.jit`` program; the port runs eagerly and
compiles no program, so here a surface is the function that builds a hot
path's callable (the train step, the per-bucket serve samplers, the bulk
sampler, the eval feature extractor, the search scorers). Each one is marked
at its definition with the JAX package's name::

    @compile_surface("train/step")
    def make_train_step(cfg, models, ...): ...

so that logs, spans and warm-cache entries of the two packages line up.
:func:`dcr_tpu_torch.core.warmcache.aot_compile` takes the decorated
function and reads its name from ``fn.__compile_surface__``, so a surface's
name is written once, here.

Import-light on purpose: no torch import, no side effects beyond the
registry dict.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


@dataclass(frozen=True)
class SurfaceInfo:
    """One registered surface."""

    name: str
    qualname: str          # "module:function"


#: surface name -> registration, populated at import time by the decorators
REGISTRY: dict[str, SurfaceInfo] = {}


def compile_surface(name: str) -> Callable[[F], F]:
    """Mark a function as a hot-path entry point (see module docstring)."""

    def deco(fn: F) -> F:
        info = SurfaceInfo(name=name, qualname=f"{fn.__module__}:{fn.__qualname__}")
        prev = REGISTRY.get(name)
        if prev is not None and prev.qualname != info.qualname:
            raise ValueError(
                f"compile surface {name!r} registered twice: "
                f"{prev.qualname} and {info.qualname}")
        REGISTRY[name] = info
        fn.__compile_surface__ = name
        return fn

    return deco
