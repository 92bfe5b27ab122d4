"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. A missing GPU
is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (or DCR_TPU_PLATFORM=cpu for the CLI) to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (expected cuda or cpu)")
    return dev
