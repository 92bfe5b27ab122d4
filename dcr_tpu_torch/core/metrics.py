"""Metric writer and latency tracker.

``MetricWriter`` is ``dcr_tpu/core/metrics.py``'s writer reduced to its
jsonl sink (tensorboard and wandb are not ported): one JSON line per call,
``{"step", "time", **scalars}``, under the same scalar names (``loss``,
``grad_norm``, ``lr``, ``images_per_sec``, ``risk/max_sim``), so the two
packages' logs read the same way; each float scalar is also mirrored into
the telemetry registry as a gauge, as the JAX writer does.
``LatencyTracker`` is the serving layer's request-latency reservoir.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch

from dcr_tpu_torch.core import tracing


class MetricWriter:
    """``active=False`` (a non-primary process of a job) writes nothing."""

    def __init__(self, logdir: str | Path, *, active: bool = True):
        self._jsonl = None
        if active:
            logdir = Path(logdir)
            logdir.mkdir(parents=True, exist_ok=True)
            self._jsonl = (logdir / "metrics.jsonl").open("a")

    def scalars(self, step: int, values: Mapping[str, Any]) -> None:
        if self._jsonl is None:
            return
        clean = {}
        for k, v in values.items():
            v = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            clean[k] = float(v) if v.ndim == 0 else v.tolist()
        tracing.update_gauges({k: v for k, v in clean.items() if isinstance(v, float)})
        rec = {"step": int(step), "time": time.time(), **clean}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


class LatencyTracker(tracing.Histogram):
    """Sliding-window latency reservoir with p50/p99 snapshots (averages
    would hide the tail an overloaded service degrades first). ``name``
    registers it in the telemetry registry, so its percentiles ride every
    registry snapshot and Prometheus scrape."""

    def __init__(self, window: int = 1024, *, name: Optional[str] = None):
        super().__init__(window=window)
        if name:
            tracing.registry().register_histogram(name, self)
