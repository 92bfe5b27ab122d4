"""Explicit, reproducible RNG streams for the PyTorch port.

Host numpy streams (prompt picks, augmentation choices) are bit-identical to
``dcr_tpu/core/rng.py``: same stream tag, same PCG64 seeding. Device noise
comes from ``torch.Generator``s seeded from (root seed, stream name, step) by
the same hash. jax's threefry bits cannot be reproduced here, so parity tests
hand the JAX package's draws in as tensors instead.
"""

from __future__ import annotations

import hashlib
from contextlib import contextmanager
from typing import Iterator

import numpy as np
import torch


def _stream_tag(name: str) -> int:
    # stable 31-bit tag from the stream name
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little") & 0x7FFFFFFF


def host_python_rng(seed: int, name: str) -> np.random.Generator:
    """Deterministic host-side numpy Generator for data-pipeline decisions
    (caption picks, augmentation choices)."""
    return np.random.Generator(np.random.PCG64([seed, _stream_tag(name)]))


def stream_seed(seed: int, name: str, step: int | None = None) -> int:
    """63-bit torch seed for (root seed, stream name[, step])."""
    payload = f"{seed}\x00{_stream_tag(name)}\x00{'' if step is None else int(step)}"
    return int.from_bytes(hashlib.sha256(payload.encode()).digest()[:8], "little") >> 1


def stream_generator(seed: int, name: str, step: int | None = None,
                     device: str | torch.device = "cpu") -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` for one named (per-step) stream."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name, step))


@contextmanager
def seeded_cpu_init(seed: int) -> Iterator[None]:
    """Modules built inside draw their initial weights from the CPU generator
    seeded with ``seed``, forked so the caller's RNG state stays as it was.
    Weights made on the CPU are the same whichever device they move to."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield
