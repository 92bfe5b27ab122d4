"""Metric writer: scalars per step into ``<logdir>/metrics.jsonl``.

Counterpart of ``dcr_tpu/core/metrics.py``'s ``MetricWriter`` reduced to its
jsonl sink (tensorboard and wandb are not ported): one JSON line per call,
``{"step", "time", **scalars}``, under the same scalar names (``loss``,
``grad_norm``, ``lr``, ``images_per_sec``), so the two packages' logs read
the same way.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch


class MetricWriter:
    def __init__(self, logdir: str | Path):
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = (logdir / "metrics.jsonl").open("a")

    def scalars(self, step: int, values: Mapping[str, Any]) -> None:
        clean = {}
        for k, v in values.items():
            v = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            clean[k] = float(v) if v.ndim == 0 else v.tolist()
        rec = {"step": int(step), "time": time.time(), **clean}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
