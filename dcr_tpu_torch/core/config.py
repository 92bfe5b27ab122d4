"""Config dataclasses + dotted-key CLI overrides for the PyTorch port.

Own copy of the fields of ``dcr_tpu/core/config.py`` that the sampling,
training and eval paths read (``ModelConfig``, ``SampleConfig``,
``FastSampleConfig``, ``DataConfig``, ``OptimConfig``, ``TrainConfig`` and
its nested sections, ``EvalConfig``) and of its ``from_dict``/``parse_cli``/
``save_config`` machinery, so a ``model_index.json`` or ``config.json``
written by either package and a ``dcr-sample``, ``dcr-train`` or
``dcr-eval`` command line parse the same way here. Sections the port does
not run yet (mesh, fault-tolerance budgets, warm cache, copy risk,
pipelined training) parse, and :func:`validate_train_config` and
:func:`validate_eval_config` refuse a setting that would need them with
:class:`NotPortedError`. The mesh and warm-cache sections of
``SampleConfig`` are not ported yet.
"""

from __future__ import annotations

import json
import sys
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Optional, Sequence, Type, TypeVar, get_args, get_origin

T = TypeVar("T")

DUPLICATION_REGIMES = ("nodup", "dup_both", "dup_image")
CONDITIONING_REGIMES = (
    "nolevel",
    "classlevel",
    "instancelevel_blip",
    "instancelevel_random",
    "instancelevel_ogcap",
)
TRAIN_MITIGATIONS = ("none", "allcaps", "randrepl", "randwordadd", "wordrepeat")
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
    """Training-free sampler acceleration (score reuse,
    :mod:`dcr_tpu_torch.sampling.fastsample`)."""

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
    from dcr_tpu_torch.sampling.fastsample import MAX_REUSE_RATIO

    if not 0.0 <= f.reuse_ratio <= MAX_REUSE_RATIO:
        raise ValueError(f"fast.reuse_ratio must be in [0, {MAX_REUSE_RATIO}], "
                         f"got {f.reuse_ratio}")
    if f.order not in (1, 2):
        raise ValueError(f"fast.order must be 1 or 2, got {f.order}")


@dataclass
class MeshConfig:
    """Device-mesh shape (parsed; the port runs on one device)."""

    data: int = -1  # -1: all remaining devices
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1


@dataclass
class DataConfig:
    """Dataset + duplication + conditioning knobs (reference datasets.py:32-152)."""

    train_data_dir: str = ""
    resolution: int = 256
    center_crop: bool = True
    random_flip: bool = True
    class_prompt: str = "nolevel"          # CONDITIONING_REGIMES
    instance_prompt: str = "an image"      # nolevel constant caption
    duplication: str = "nodup"             # DUPLICATION_REGIMES
    weight_pc: float = 0.1                 # fraction of samples duplicated
    dup_weight: int = 5                    # sampling weight for duplicated samples
    caption_jsons: tuple[str, ...] = ()    # blip/ogcap caption tables
    trainspecial: str = "none"             # TRAIN_MITIGATIONS
    trainspecial_prob: float = 0.1
    trainsubset: int = -1                  # -1: full dataset (reference --trainsubset)
    rand_caption_tokens: int = 4           # instancelevel_random token count
    num_workers: int = 8
    seed: int = 42


@dataclass
class FaultToleranceConfig:
    """Recovery knobs. The port is fail-fast: the budgets must stay 0."""

    decode_retries: int = 1
    max_bad_sample_frac: float = 0.0
    max_rollbacks: int = 0
    verify_checkpoints: bool = True
    io_retries: int = 3
    retry_base_delay: float = 0.05
    retry_max_delay: float = 2.0
    stage_deadline_secs: float = 0.0
    barrier_timeout_s: float = 0.0
    hang_timeout_s: float = 0.0


@dataclass
class WarmCacheConfig:
    """Persistent executable cache (parsed; ``dir`` is not ported)."""

    dir: str = ""
    warm_start: bool = True


@dataclass
class RiskConfig:
    """Online copy-risk scoring (parsed; an index or store is not ported)."""

    index_path: str = ""
    store_dir: str = ""
    segment_rows: int = 0
    ann: bool = False
    nprobe: int = 8
    weights_path: str = ""
    threshold: float = 0.5
    top_k: int = 1
    image_size: int = 224
    evidence_dir: str = ""
    max_evidence: int = 32


@dataclass
class PipeConfig:
    """Pipelined training and the latent cache (parsed; not ported)."""

    enabled: bool = False
    depth: int = 2
    latent_cache: str = ""
    cache_shard_size: int = 512


@dataclass
class OptimConfig:
    learning_rate: float = 5e-6
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    lr_scheduler: str = "constant_with_warmup"
    lr_warmup_steps: int = 5000
    gradient_accumulation_steps: int = 1
    scale_lr: bool = False
    use_8bit_adam: bool = False            # not ported


@dataclass
class TrainConfig:
    output_dir: str = "runs/dcr"
    pretrained_model: str = ""             # tokenizer source (weights: pretrained_params=)
    seed: int = 42
    generation_seed: int = 1024
    train_batch_size: int = 16             # per-device
    max_train_steps: int = 100_000
    num_train_epochs: int = 100
    train_text_encoder: bool = False
    unet_from_scratch: bool = False
    mixed_precision: str = "bf16"          # "no" | "bf16"
    remat: bool = False                    # torch.utils.checkpoint around the UNet
    ema_decay: float = 0.0                 # 0 disables EMA
    # train-time embedding mitigations (reference diff_train.py:637-642)
    rand_noise_lam: float = 0.0
    mixup_noise_lam: float = 0.0
    # cadence (reference diff_train.py:709-716)
    save_steps: int = 500                  # sample-image grids
    modelsavesteps: int = 1000             # checkpoints
    log_every: int = 50
    use_wandb: bool = False                # not ported
    checkpoints_total_limit: int = 3
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    fault: FaultToleranceConfig = field(default_factory=FaultToleranceConfig)
    warm: WarmCacheConfig = field(default_factory=WarmCacheConfig)
    risk: RiskConfig = field(default_factory=RiskConfig)
    pipe: PipeConfig = field(default_factory=PipeConfig)


def validate_risk_config(r: RiskConfig) -> None:
    if r.top_k < 1:
        raise ValueError("risk.top_k must be >= 1")
    if r.image_size < 16:
        raise ValueError("risk.image_size must be >= 16 (the SSCD backbone "
                         "downsamples 32x; tiny crops degenerate)")
    if not r.threshold == r.threshold:   # NaN compares unequal to itself
        raise ValueError("risk.threshold must be a number, not NaN")
    if r.max_evidence < 0:
        raise ValueError("risk.max_evidence must be >= 0")
    if r.ann and not r.store_dir:
        raise ValueError("risk.ann needs risk.store_dir (the IVF tier is "
                         "an index over a built store — the dump-file path "
                         "is exact-only)")
    if r.nprobe < 1:
        raise ValueError("risk.nprobe must be >= 1")


def validate_pipe_config(cfg: TrainConfig) -> None:
    p = cfg.pipe
    if p.depth < 1:
        raise ValueError("pipe.depth must be >= 1 (the prefetch ring needs "
                         "at least one slot)")
    if p.cache_shard_size < 1:
        raise ValueError("pipe.cache_shard_size must be >= 1")
    if p.latent_cache:
        if cfg.train_text_encoder:
            raise ValueError(
                "pipe.latent_cache requires train_text_encoder=False: the "
                "cache replaces the frozen text encoder's output; a trained "
                "text encoder must run live (use pipe.enabled without a "
                "cache)")
        if cfg.data.trainspecial != "none":
            raise ValueError(
                "pipe.latent_cache is incompatible with caption mitigations "
                "(data.trainspecial): they redraw captions per occurrence, "
                "but the cache holds one frozen text embedding per image")
        if cfg.data.duplication == "dup_image":
            raise ValueError(
                "pipe.latent_cache is incompatible with duplication="
                "'dup_image': that regime redraws a DIFFERENT caption per "
                "occurrence of a duplicated image, but the cache holds one "
                "frozen text embedding per image (dup_both/nodup are fine "
                "— their captions are deterministic per index)")
        if cfg.data.random_flip:
            raise ValueError(
                "pipe.latent_cache requires data.random_flip=false: the "
                "cache holds one pixel realization per image, a "
                "per-occurrence flip cannot be served from it")
        if not cfg.data.center_crop:
            raise ValueError(
                "pipe.latent_cache requires data.center_crop=true: "
                "center_crop=false draws a RANDOM crop per occurrence, "
                "which the cache would silently freeze to one realization")


def _mesh_devices(m: MeshConfig) -> int:
    """Devices a mesh config asks for, counting "all remaining" (-1) as one."""
    return max(1, m.data) * max(1, m.fsdp) * max(1, m.tensor) * max(1, m.seq)


def _not_ported(cfg: TrainConfig) -> list[str]:
    """Settings of a valid config that need a part of the JAX package the
    port does not have yet."""
    mesh_devices = _mesh_devices(cfg.mesh)
    checks = [
        (cfg.optim.use_8bit_adam, "optim.use_8bit_adam (8-bit Adam)"),
        (cfg.pipe.enabled, "pipe.enabled (pipelined training)"),
        (bool(cfg.pipe.latent_cache), "pipe.latent_cache (the latent cache)"),
        (bool(cfg.warm.dir), "warm.dir (the warm executable cache)"),
        (bool(cfg.risk.index_path), "risk.index_path (copy-risk scoring)"),
        (bool(cfg.risk.store_dir), "risk.store_dir (copy-risk scoring)"),
        (cfg.fault.max_rollbacks > 0, "fault.max_rollbacks > 0 (NaN rollback)"),
        (cfg.fault.max_bad_sample_frac > 0,
         "fault.max_bad_sample_frac > 0 (bad-sample quarantine)"),
        (mesh_devices > 1, f"a mesh of {mesh_devices} devices (the port trains on one)"),
        (cfg.use_wandb, "use_wandb (the wandb sink)"),
    ]
    return [name for on, name in checks if on]


def validate_train_config(cfg: TrainConfig) -> None:
    """Cross-flag validation (reference diff_train.py:739-743), then
    NotPortedError for anything this port does not run yet."""
    d = cfg.data
    if d.duplication not in DUPLICATION_REGIMES:
        raise ValueError(f"duplication must be one of {DUPLICATION_REGIMES}")
    if d.class_prompt not in CONDITIONING_REGIMES:
        raise ValueError(f"class_prompt must be one of {CONDITIONING_REGIMES}")
    if d.trainspecial not in TRAIN_MITIGATIONS:
        raise ValueError(f"trainspecial must be one of {TRAIN_MITIGATIONS}")
    if d.duplication == "dup_image" and d.class_prompt == "instancelevel_ogcap":
        # guarded invalid in the reference (diff_train.py:739)
        raise ValueError("dup_image requires multiple captions per image; ogcap has one")
    if d.trainspecial != "none" and d.class_prompt != "instancelevel_blip":
        # caption mitigations are blip-captions-only (reference diff_train.py:741-743)
        raise ValueError("trainspecial mitigations require class_prompt=instancelevel_blip")
    validate_risk_config(cfg.risk)
    validate_pipe_config(cfg)
    if cfg.model.seq_parallel_mode not in ("ring", "ulysses"):
        raise ValueError("seq_parallel_mode must be 'ring' or 'ulysses'")
    ft = cfg.fault
    if ft.decode_retries < 0 or ft.max_rollbacks < 0:
        raise ValueError("fault.decode_retries/max_rollbacks must be >= 0")
    if not 0.0 <= ft.max_bad_sample_frac <= 1.0:
        raise ValueError("fault.max_bad_sample_frac must be in [0, 1]")
    if ft.io_retries < 1:
        raise ValueError("fault.io_retries must be >= 1")
    missing = _not_ported(cfg)
    if missing:
        raise NotPortedError(
            "not ported to dcr_tpu_torch yet: " + "; ".join(missing)
            + ". Run without them or use the JAX package.")


@dataclass
class EvalConfig:
    """Replication metrics (reference diff_retrieval.py:124-182); the JAX
    package's fields and defaults. :func:`validate_eval_config` says which
    settings the port runs."""

    query_dir: str = ""                    # generations
    values_dir: str = ""                   # train data
    pt_style: str = "sscd"                 # "sscd" | "dino" | "clip"
    arch: str = "resnet50_disc"
    layer: int = 1                         # DINO ViT intermediate layer
    similarity_metric: str = "dotproduct"  # "dotproduct" | "splitloss"
    batch_size: int = 64
    image_size: int = 224
    multiscale: bool = False
    num_loss_chunks: int = 1
    chunk_style: str = "max"               # splitloss chunk reduce; "cross" variant
    compute_fid: bool = True
    compute_clip_score: bool = True
    compute_complexity: bool = True
    galleries: bool = True
    gallery_topk: int = 10
    gallery_rows: int = 10
    gallery_max_rank: int = 200
    dup_weights_pickle: str = ""           # training sampling-weights file
    # pretrained checkpoint files; empty = seeded random weights (metrics are
    # then not comparable to reference numbers)
    weights_path: str = ""                 # copy-detection backbone (SSCD)
    inception_weights_path: str = ""       # pt_inception-2015-12-05 for FID
    clip_weights_path: str = ""            # OpenAI CLIP archive for the alignment score
    output_dir: str = "ret_plots"
    use_wandb: bool = False                # not ported
    seed: int = 42
    mesh: MeshConfig = field(default_factory=MeshConfig)
    fault: FaultToleranceConfig = field(default_factory=FaultToleranceConfig)
    warm: WarmCacheConfig = field(default_factory=WarmCacheConfig)


# the fault settings the port's eval honours: the retries of its file reads
_EVAL_FAULT_HONOURED = ("io_retries", "retry_base_delay", "retry_max_delay")


def validate_eval_config(cfg: EvalConfig) -> None:
    """ValueError for a setting no package runs, then NotPortedError for one
    the port does not run yet: a mesh of more than one device, the warm
    cache, wandb, and any fault setting other than the I/O retries at a
    non-default value. Every backbone (sscd, dino, clip, ``layer`` > 1) and
    every stage, the complexity stage included, runs."""
    if cfg.pt_style not in ("sscd", "dino", "clip"):
        raise ValueError(f"unknown pt_style {cfg.pt_style!r} (sscd | dino | clip)")
    if cfg.similarity_metric not in ("dotproduct", "splitloss"):
        raise ValueError(f"unknown similarity metric {cfg.similarity_metric!r}")
    if cfg.fault.io_retries < 1:
        raise ValueError("fault.io_retries must be >= 1")
    mesh_devices = _mesh_devices(cfg.mesh)
    default_fault = FaultToleranceConfig()
    fault = [f"fault.{f.name}" for f in fields(FaultToleranceConfig)
             if f.name not in _EVAL_FAULT_HONOURED
             and getattr(cfg.fault, f.name) != getattr(default_fault, f.name)]
    checks = [
        (mesh_devices > 1, f"a mesh of {mesh_devices} devices (the port evaluates on one)"),
        (bool(cfg.warm.dir), "warm.dir (the warm executable cache)"),
        (cfg.use_wandb, "use_wandb (the wandb sink)"),
        (bool(fault), ", ".join(fault) + " (the port honours only the I/O retries)"),
    ]
    missing = [name for on, name in checks if on]
    if missing:
        raise NotPortedError(
            "not ported to dcr_tpu_torch yet: " + "; ".join(missing)
            + ". Run without them or use the JAX package.")


def run_name(cfg: TrainConfig) -> str:
    """Human-readable run directory name (reference diff_train.py:745-760);
    informational only, the source of truth is config.json."""
    d = cfg.data
    parts = [d.class_prompt, d.duplication]
    if d.duplication != "nodup":
        parts += [str(d.weight_pc), str(d.dup_weight)]
    if cfg.rand_noise_lam:
        parts.append(f"glam{cfg.rand_noise_lam}")
    if cfg.mixup_noise_lam:
        parts.append(f"mixlam{cfg.mixup_noise_lam}")
    if d.trainspecial != "none":
        parts.append(f"special_{d.trainspecial}_{d.trainspecial_prob}")
    if d.trainsubset > 0:
        parts.append(f"{d.trainsubset}subset")
    return "_".join(parts)


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


def save_config(cfg: Any, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_dict(cfg), indent=2, sort_keys=True) + "\n")


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
