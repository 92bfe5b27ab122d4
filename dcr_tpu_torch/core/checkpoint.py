"""Checkpoints: the port's resume format and the HF-layout export.

- :class:`CheckpointManager` keeps the full train state (params, optimizer,
  EMA, step) under ``<output_dir>/checkpoints/<step>/state.pt``, one
  ``torch.save`` file per step, written under a temporary name and renamed,
  keeping the newest ``max_to_keep``. It is the port's own format; the JAX
  package's orbax/npz checkpoints are not read.
- :func:`export_hf_layout` writes the directory-of-subfolders export of
  ``dcr_tpu/core/checkpoint.py``: ``<component>/params.npz`` (the Flax tree
  flattened to ``a/b/c`` keys) with a diffusers/transformers
  ``config.json``, ``scheduler/scheduler_config.json`` and
  ``model_index.json`` carrying the native ``model_config``. The
  torch-layout safetensors beside them are not written yet.
- :func:`import_npz` reads one component of such a directory back.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from dcr_tpu_torch.core.config import NotPortedError

STATE_FILE = "state.pt"


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


def flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> ``a/b/c`` keys (the inverse of :func:`unflatten`)."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


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


# ---------------------------------------------------------------------------
# resume checkpoints
# ---------------------------------------------------------------------------

def _state_dict(state) -> dict:
    def plain(d: Optional[dict]) -> Optional[dict]:
        return None if d is None else {k: t.detach() for k, t in d.items()}

    opt = state.opt_state
    return {"step": int(state.step),
            "params": {"unet": plain(state.unet_params), "text": plain(state.text_params),
                       "vae": plain(state.vae_params)},
            "opt": {"count": opt.count, "mini_step": opt.mini_step, "mu": opt.mu,
                    "nu": opt.nu, "acc_grads": opt.acc_grads},
            "ema": state.ema_params}


def _copy_into(dst: Optional[dict], src: Optional[dict], what: str) -> None:
    if (dst is None) != (src is None):
        raise ValueError(f"checkpoint {what} does not match the run's configuration "
                         f"({'absent' if src is None else 'present'} in the checkpoint)")
    if dst is None:
        return
    if set(dst) != set(src):
        raise ValueError(f"checkpoint {what} keys differ from the run's: "
                         f"{sorted(set(dst) ^ set(src))[:5]}")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


class CheckpointManager:
    """Step-numbered full-state checkpoints under one directory."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.dir = Path(directory)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        if not self.dir.exists():
            return []
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> bool:
        """Write ``state`` as step ``step``; returns False when that step is
        already saved."""
        final = self.dir / str(step)
        if (final / STATE_FILE).exists():
            return False
        tmp = self.dir / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        with open(tmp / STATE_FILE, "wb") as f:
            torch.save(_state_dict(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(self.dir / str(old), ignore_errors=True)
        return True

    def restore(self, state, step: Optional[int] = None) -> int:
        """Copy checkpoint ``step`` (default: the latest) into ``state``'s
        tensors in place; returns the restored step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        device = next(iter(state.unet_params.values())).device
        saved = torch.load(self.dir / str(step) / STATE_FILE, map_location=device,
                           weights_only=True)
        for name, dst in (("unet", state.unet_params), ("text", state.text_params),
                          ("vae", state.vae_params)):
            _copy_into(dst, saved["params"][name], f"{name} params")
        opt = state.opt_state
        _copy_into(opt.mu, saved["opt"]["mu"], "Adam first moments")
        _copy_into(opt.nu, saved["opt"]["nu"], "Adam second moments")
        _copy_into(opt.acc_grads, saved["opt"]["acc_grads"], "accumulated gradients")
        _copy_into(state.ema_params, saved["ema"], "EMA params")
        opt.count, opt.mini_step = int(saved["opt"]["count"]), int(saved["opt"]["mini_step"])
        state.step = int(saved["step"])
        return state.step


# ---------------------------------------------------------------------------
# HF-layout export
# ---------------------------------------------------------------------------

def diffusers_configs(mc: dict) -> dict[str, dict]:
    """Per-subfolder diffusers/transformers config.json contents from a
    ModelConfig dict (own copy of dcr_tpu's ``_diffusers_configs``: the
    shipped stabilityai/stable-diffusion-2-1 configs at the default dims)."""
    ch = list(mc.get("block_out_channels", (320, 640, 1280, 1280)))
    # diffusers' attention_head_dim is the per-block head COUNT
    num_heads = mc.get("attention_num_heads")
    head_dim = mc.get("attention_head_dim", 64)
    heads_cfg = num_heads if num_heads else [c // head_dim for c in ch]
    n = len(ch)
    unet = {
        "_class_name": "UNet2DConditionModel",
        "_diffusers_version": "0.14.0",
        "sample_size": mc.get("sample_size", 32),
        "in_channels": mc.get("in_channels", 4),
        "out_channels": mc.get("out_channels", 4),
        "down_block_types": ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"],
        "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * (n - 1),
        "block_out_channels": ch,
        "layers_per_block": mc.get("layers_per_block", 2),
        "cross_attention_dim": mc.get("cross_attention_dim", 1024),
        "attention_head_dim": heads_cfg,
        "use_linear_projection": bool(mc.get("use_linear_projection", True)),
        "norm_num_groups": mc.get("norm_num_groups", 32),
        "act_fn": "silu",
        "center_input_sample": False,
        "downsample_padding": 1,
        "flip_sin_to_cos": True,
        "freq_shift": 0,
        "mid_block_scale_factor": 1,
        "norm_eps": 1e-5,
    }
    vch = list(mc.get("vae_block_out_channels", (128, 256, 512, 512)))
    vae = {
        "_class_name": "AutoencoderKL",
        "_diffusers_version": "0.14.0",
        "sample_size": mc.get("sample_size", 32) * 8,
        "in_channels": 3,
        "out_channels": 3,
        "down_block_types": ["DownEncoderBlock2D"] * len(vch),
        "up_block_types": ["UpDecoderBlock2D"] * len(vch),
        "block_out_channels": vch,
        "latent_channels": mc.get("vae_latent_channels", 4),
        "layers_per_block": mc.get("vae_layers_per_block", 2),
        "norm_num_groups": min(mc.get("norm_num_groups", 32), vch[0]),
        "act_fn": "silu",
        "scaling_factor": mc.get("vae_scaling_factor", 0.18215),
    }
    text = {
        "architectures": ["CLIPTextModel"],
        "model_type": "clip_text_model",
        "vocab_size": mc.get("text_vocab_size", 49408),
        "hidden_size": mc.get("text_hidden_size", 1024),
        "intermediate_size": 4 * mc.get("text_hidden_size", 1024),
        "num_hidden_layers": mc.get("text_layers", 23),
        "num_attention_heads": mc.get("text_heads", 16),
        "max_position_embeddings": mc.get("text_max_length", 77),
        "hidden_act": mc.get("text_act", "gelu"),
        "layer_norm_eps": 1e-5,
        "torch_dtype": "float32",
    }
    return {"unet": unet, "vae": vae, "text_encoder": text}


def export_hf_layout(out_dir: str | Path, *, unet: Optional[dict] = None,
                     vae: Optional[dict] = None, text_encoder: Optional[dict] = None,
                     scheduler_config: Optional[dict] = None,
                     model_config: Optional[dict] = None) -> None:
    """Write ``<out_dir>/<component>/{params.npz,config.json}`` from Flax
    trees (models/export ``*_to_flax``), the scheduler config and
    ``model_index.json``: the layout ``dcr_tpu``'s ``export_hf_layout``
    writes, which both packages' ``load_checkpoint_models`` read."""
    out = Path(out_dir)
    configs = diffusers_configs(dict(model_config or {}))
    for name, params in (("unet", unet), ("vae", vae), ("text_encoder", text_encoder)):
        if params is None:
            continue
        sub = out / name
        sub.mkdir(parents=True, exist_ok=True)
        np.savez(sub / "params.npz", **flatten(params))
        (sub / "config.json").write_text(json.dumps(configs[name], indent=2))
    if scheduler_config is not None:
        sub = out / "scheduler"
        sub.mkdir(parents=True, exist_ok=True)
        sched = {
            "_class_name": "DPMSolverMultistepScheduler",
            "_diffusers_version": "0.14.0",
            "algorithm_type": "dpmsolver++",
            "solver_order": 2,
            "solver_type": "midpoint",
            "lower_order_final": True,
            "steps_offset": 1,
            "thresholding": False,
            "trained_betas": None,
            **scheduler_config,
        }
        (sub / "scheduler_config.json").write_text(json.dumps(sched, indent=2))
    if model_config is not None:
        index = {
            "_class_name": "StableDiffusionPipeline",
            "_diffusers_version": "0.14.0",
            "unet": ["diffusers", "UNet2DConditionModel"],
            "vae": ["diffusers", "AutoencoderKL"],
            "text_encoder": ["transformers", "CLIPTextModel"],
            "scheduler": ["diffusers", "DPMSolverMultistepScheduler"],
            "model_config": model_config,
        }
        (out / "model_index.json").write_text(json.dumps(index, indent=2))
