"""Config dataclasses + dotted-key CLI overrides for the PyTorch port.

Own copy of the fields of ``dcr_tpu/core/config.py`` that the sampling path
reads (``ModelConfig``, ``SampleConfig``, ``FastSampleConfig``) and of its
``from_dict``/``parse_cli`` machinery, so a ``model_index.json`` written by
either package and a ``dcr-sample`` command line parse the same way here.
The mesh and warm-cache sections of ``SampleConfig`` are not ported yet.
"""

from __future__ import annotations

import json
import sys
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Optional, Sequence, Type, TypeVar, get_args, get_origin

T = TypeVar("T")

CONDITIONING_REGIMES = (
    "nolevel",
    "classlevel",
    "instancelevel_blip",
    "instancelevel_random",
    "instancelevel_ogcap",
)
INFERENCE_AUGS = ("none", "rand_numb_add", "rand_word_add", "rand_word_repeat")


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this port does not implement yet."""


@dataclass
class ModelConfig:
    """Diffusion-stack dimensions (SD-2.1 base by default)."""

    # UNet2DCondition
    sample_size: int = 32              # latent spatial size = resolution // 8
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 64
    # SD-1.x fixes the head COUNT instead (8 heads, head_dim = ch/8); when
    # set, attention_head_dim is ignored
    attention_num_heads: Optional[int] = None
    cross_attention_dim: int = 1024
    transformer_layers: int = 1
    # SD-2.x transformers project with linears; SD-1.x uses 1x1 convs
    use_linear_projection: bool = True
    norm_num_groups: int = 32
    flash_attention: bool = True       # hand-written kernel where the shape allows
    # sequence-parallel attention knobs: kept so checkpoints of either
    # package parse; the port runs on one device and does not read them yet
    seq_parallel_min_seq: int = 4096
    seq_parallel_mode: str = "ring"
    # VAE
    vae_block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    vae_layers_per_block: int = 2
    vae_latent_channels: int = 4
    vae_scaling_factor: float = 0.18215
    # CLIP text encoder (OpenCLIP ViT-H text tower for SD-2.1)
    text_vocab_size: int = 49408
    text_hidden_size: int = 1024
    text_layers: int = 23
    text_heads: int = 16
    text_max_length: int = 77
    # "gelu" (exact; SD-2.x OpenCLIP tower) or "quick_gelu" (OpenAI CLIP-B/L)
    text_act: str = "gelu"
    # diffusion process
    num_train_timesteps: int = 1000
    beta_schedule: str = "scaled_linear"
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "epsilon"   # or "v_prediction"

    @staticmethod
    def sd1x() -> "ModelConfig":
        """SD-1.4/1.5 stack: fixed 8-head attention, 1x1-conv transformer
        projections, CLIP ViT-L/14 text tower (quick_gelu, 768-d)."""
        return ModelConfig(
            sample_size=64,
            attention_head_dim=0,
            attention_num_heads=8,
            use_linear_projection=False,
            cross_attention_dim=768,
            text_hidden_size=768,
            text_layers=12,
            text_heads=12,
            text_act="quick_gelu",
        )

    @staticmethod
    def tiny() -> "ModelConfig":
        """CPU-runnable smoke config."""
        return ModelConfig(
            sample_size=8,
            block_out_channels=(32, 64),
            layers_per_block=1,
            attention_head_dim=8,
            cross_attention_dim=32,
            norm_num_groups=8,
            vae_block_out_channels=(16, 32),
            vae_layers_per_block=1,
            text_vocab_size=1000,
            text_hidden_size=32,
            text_layers=2,
            text_heads=2,
            text_max_length=16,
            flash_attention=False,
        )


@dataclass
class FastSampleConfig:
    """Training-free sampler acceleration (score reuse). Parsed so command
    lines and configs of the JAX package load, but ``enabled=True`` is
    refused by :func:`validate_fast_config`: the port has no fast path yet."""

    enabled: bool = False
    reuse_ratio: float = 0.5
    order: int = 2


@dataclass
class SampleConfig:
    """Bulk sampling (reference diff_inference.py:203-243)."""

    model_path: str = ""
    iternum: int = -1                      # select checkpoint_<step>; -1 = final
    savepath: str = ""
    num_batches: int = 50
    im_batch: int = 10                     # images per prompt per batch
    resolution: int = 256
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    sampler: str = "dpm++"                 # "ddim" | "dpm++" | "ddpm"
    seed: int = 42
    # inference-time mitigations
    rand_noise_lam: float = 0.0            # gaussian noise on prompt embeddings
    rand_augs: str = "none"                # INFERENCE_AUGS
    rand_aug_repeats: int = 2
    fast: FastSampleConfig = field(default_factory=FastSampleConfig)


def validate_fast_config(f: FastSampleConfig) -> None:
    if f.enabled:
        raise NotPortedError(
            "fast.enabled=true (score-reuse sampling) is not ported to "
            "dcr_tpu_torch yet; run without it or use the JAX package")


# ---------------------------------------------------------------------------
# (de)serialization + CLI
# ---------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def _coerce(value: Any, typ: Any) -> Any:
    origin = get_origin(typ)
    if origin in (tuple, list):
        args = get_args(typ)
        elem = args[0] if args else str
        if isinstance(value, str):
            value = [v for v in value.split(",") if v]
        out = [_coerce(v, elem) for v in value]
        return tuple(out) if origin is tuple else out
    if origin is typing.Union:  # Optional[...]
        args = [a for a in get_args(typ) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0])
    if is_dataclass(typ):
        return from_dict(typ, value)
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "y")
        return bool(value)
    if typ in (int, float, str):
        return typ(value)
    return value


def from_dict(cls: Type[T], d: dict) -> T:
    hints = typing.get_type_hints(cls)
    names = {f.name for f in fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        kwargs[k] = _coerce(v, hints[k])
    return cls(**kwargs)


def load_config(cls: Type[T], path: str | Path) -> T:
    return from_dict(cls, json.loads(Path(path).read_text()))


def _set_nested(d: dict, dotted: str, value: str) -> None:
    parts = dotted.split(".")
    cur = d
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def parse_cli(cls: Type[T], argv: Optional[Sequence[str]] = None,
              base: Optional[T] = None) -> T:
    """``--a.b.c=value`` overrides on top of defaults (or ``--config=file.json``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides: dict = {}
    cfg_path = None
    for arg in argv:
        if not arg.startswith("--"):
            raise SystemExit(f"unrecognized argument {arg!r} (expected --key=value)")
        key, eq, value = arg[2:].partition("=")
        if key == "config":
            cfg_path = value
        else:
            # bare `--flag` means true for booleans; _coerce rejects it
            # loudly for any non-bool field
            _set_nested(overrides, key, value if eq else "true")
    if base is not None and cfg_path:
        raise SystemExit("--config cannot be combined with a programmatic base config")
    if base is not None:
        cfg = base
    elif cfg_path:
        cfg = load_config(cls, cfg_path)
    else:
        cfg = cls()
    merged = to_dict(cfg)

    def merge(dst: dict, src: dict) -> None:
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(merged, overrides)
    return from_dict(cls, merged)
