"""Read the components of an HF-layout checkpoint directory.

The fast path of dcr_tpu's ``import_hf_layout``: each component subfolder
holds ``params.npz``, the Flax tree flattened to ``a/b/c`` keys. A genuine
diffusers checkpoint (safetensors or .bin weights only) is not read yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from dcr_tpu_torch.core.config import NotPortedError


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    """``a/b/c`` keys -> nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return tree


def import_npz(ckpt_dir: str | Path, component: str) -> dict:
    """One component's Flax param tree (numpy) from ``<ckpt>/<component>/params.npz``."""
    npz = Path(ckpt_dir) / component / "params.npz"
    if not npz.exists():
        raise NotPortedError(
            f"no {npz}: loading torch-layout (safetensors/.bin) checkpoints is "
            "not ported to dcr_tpu_torch yet; export with the JAX package, "
            "which writes params.npz beside them")
    with np.load(npz) as z:
        return unflatten({k: z[k] for k in z.files})
