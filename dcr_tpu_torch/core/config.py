"""Config dataclasses + dotted-key CLI overrides for the PyTorch port.

Own copy of the fields of ``dcr_tpu/core/config.py`` that the sampling,
training, eval and search paths read (``ModelConfig``, ``SampleConfig``,
``FastSampleConfig``, ``DataConfig``, ``OptimConfig``, ``TrainConfig`` and
its nested sections, ``EvalConfig``, ``SearchConfig``, ``ServeConfig`` and
its fleet, ingest and SLO sections) and of its
``from_dict``/``parse_cli``/``save_config`` machinery, so a
``model_index.json`` or ``config.json`` written by either package and a
``dcr-sample``, ``dcr-train``, ``dcr-eval``, ``dcr-search``,
``dcr-mitigate`` or ``dcr-serve`` command line parse the same way here.
Sections the port does not run yet (mesh, warm cache, the ANN tier,
pipelined training, the search's live tier, the serving fleet and live
ingest) parse, and :func:`validate_train_config`,
:func:`validate_eval_config`, :func:`validate_search_config` and
:func:`validate_serve_config` refuse a setting that would need them with
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
    """Recovery knobs (the JAX package's defaults: fail-fast). Training
    runs every one of them on one process: decode retries, the bad-sample
    quarantine budget, NaN rollbacks, checkpoint manifests, I/O retries and
    the hang watchdog; ``stage_deadline_secs`` and ``barrier_timeout_s``
    bound eval stages and multi-host barriers, which single-process
    training does not have."""

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
    """Online copy-risk scoring (:mod:`dcr_tpu_torch.obs.copyrisk`): a
    train-embedding dump (``index_path``) or store (``store_dir``), SSCD at
    ``image_size``, a generation flagged at ``max_sim >= threshold``.
    Scoring through the ANN tier (``ann``) is not ported."""

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
        (cfg.risk.ann, "risk.ann (the IVF + int8 tier in copy-risk scoring, ROADMAP Queue A "
                       "item 1)"),
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


@dataclass
class SearchConfig:
    """LAION-scale embedding search (reference embedding_search/): the JAX
    package's fields and defaults. The store fields drive ``dcr-search
    build/append/verify/query``: embeddings ingested once into a
    manifest-keyed, sha256-verified shard store (``store_dir``), then queried
    through the top-k engine instead of the per-folder brute force.
    :func:`validate_search_config` says which settings the port runs."""

    parquet_path: str = ""
    laion_folder: str = ""
    gen_folder: str = ""
    embedding_out: str = ""      # default: <gen_folder>/embedding.npz
    out_path: str = "similarity_result.npz"
    num_chunks: int = 20
    batch_size: int = 128
    image_size: int = 224
    delete_tars: bool = False
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # the sharded embedding store and its top-k engine
    store_dir: str = ""          # built store; "" = brute-force folder scan
    dumps: tuple[str, ...] = ()  # extra dump files/dirs for build/append
    shard_rows: int = 4096       # rows per store shard file (ingest unit)
    store_normalize: bool = False  # L2-normalise rows at ingest (cosine)
    top_k: int = 1               # nearest corpus keys kept per query
    query_batch: int = 64        # query rows per engine call
    segment_rows: int = 0        # rows per device segment; 0 = auto
    live: bool = False           # the WAL live tail (not ported)
    # the IVF + int8 approximate tier
    ann: bool = False
    n_lists: int = 64
    nprobe: int = 8
    ivf_iters: int = 10
    ivf_seed: int = 0
    ivf_train_rows: int = 0
    ivf_normalize: bool = False
    shortlist_k: int = 32
    json_out: bool = False       # machine-readable `stats` output
    warm_dir: str = ""           # persistent executable cache (not ported)
    logdir: str = ""             # trace.jsonl sink (not ported)


def validate_search_config(cfg: SearchConfig) -> None:
    """NotPortedError for a search setting the port does not run yet, naming
    the ROADMAP Queue A item that ports it: the WAL live tail (item 3), the
    warm cache and the trace sink (item 7), a mesh of more than one device
    (item 9)."""
    mesh_devices = _mesh_devices(cfg.mesh)
    checks = [
        (cfg.live, "live (the WAL live tail, ROADMAP Queue A item 3)"),
        (mesh_devices > 1, f"a mesh of {mesh_devices} devices (the port searches on "
                           "one; ROADMAP Queue A item 9)"),
        (bool(cfg.warm_dir), "warm_dir (the warm executable cache, ROADMAP Queue A item 7)"),
        (bool(cfg.logdir), "logdir (the trace.jsonl sink, ROADMAP Queue A item 7)"),
    ]
    missing = [name for on, name in checks if on]
    if missing:
        raise NotPortedError(
            "not ported to dcr_tpu_torch yet: " + "; ".join(missing)
            + ". Run without them or use the JAX package.")


@dataclass
class IngestConfig:
    """Streaming provenance ingest into ``risk.store_dir`` (parsed;
    ``enabled`` is not ported)."""

    enabled: bool = False
    queue_max: int = 1024      # response-path queue bound (rows)
    batch_rows: int = 16       # rows folded into one WAL record / fsync
    seal_rows: int = 4096      # rows per WAL segment before it seals
    compact_rows: int = 2048   # acked rows that trigger compaction; 0 = never
    lease_s: float = 10.0      # writer-lease TTL


@dataclass
class SloConfig:
    """Service-level objectives of the fleet supervisor (parsed; the fleet
    is not ported)."""

    enabled: bool = True
    short_window_s: float = 60.0
    long_window_s: float = 300.0
    warn_burn: float = 1.0
    breach_burn: float = 2.0
    recover_burn: float = 0.5
    budget: float = 0.1
    dump_after_s: float = 120.0
    availability_min: float = 0.75
    shed_rate_max: float = 0.05
    ingest_lag_s_max: float = 30.0
    ann_staleness_rows_max: float = 50000.0
    recall_min: float = 0.80
    coverage_min: float = 0.95
    recall_probe_every_n: int = 32
    recall_probe_k: int = 10
    recall_probe_window: int = 64


@dataclass
class FleetConfig:
    """Multi-worker serving (parsed; ``workers > 0`` and ``worker_index >=
    0`` are not ported)."""

    workers: int = 0           # >0 runs dcr-serve as a fleet supervisor
    worker_index: int = -1     # >=0 marks a fleet worker process
    dir: str = ""              # control-plane dir: leases, journal, worker logs
    heartbeat_s: float = 1.0
    lease_s: float = 5.0
    dispatch_timeout_s: float = 600.0
    max_attempts: int = 3
    respawn_max: int = 3
    respawn_base_delay_s: float = 0.5
    respawn_max_delay_s: float = 10.0
    spawn_timeout_s: float = 600.0
    slo_queue_wait_p99_s: float = 0.0
    shed_retry_after_s: float = 5.0
    scrape_period_s: float = 2.0
    scrape_timeout_s: float = 2.0


@dataclass
class ServeConfig:
    """Online generation service (:mod:`dcr_tpu_torch.serve`): a resident
    sampler behind an HTTP front end with dynamic batching, an LRU
    prompt-embedding cache, bounded-queue admission and SIGTERM drain. The
    serving defaults (resolution/steps/guidance/sampler) define the default
    request bucket; every batch is padded to exactly ``max_batch`` requests.
    :func:`validate_serve_config` says which settings the port runs."""

    model_path: str = ""
    iternum: int = -1                      # select checkpoint_<step>; -1 = final
    host: str = "127.0.0.1"
    port: int = 8000                       # 0: any free port (logged)
    # default generation bucket (per-request overrides allowed)
    resolution: int = 256
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    sampler: str = "dpm++"                 # "ddim" | "dpm++" | "ddpm"
    rand_noise_lam: float = 0.0            # inference-time mitigation (Newpipe)
    max_batch: int = 8                     # the fixed padded batch
    max_wait_ms: float = 50.0              # a partial batch flushes after this
    queue_depth: int = 64                  # admission bound (typed 503 beyond)
    cache_entries: int = 1024              # LRU prompt-embedding cache capacity
    max_compiled_buckets: int = 8          # resident bucket budget (typed 503 beyond)
    request_timeout_s: float = 600.0       # per-request wait bound in the handler
    hang_timeout_s: float = 0.0            # the batch watchdog (not ported: the fleet)
    logdir: str = ""                       # the trace / metrics sink (not ported)
    seed: int = 42                         # root of the per-request draws
    mesh: MeshConfig = field(default_factory=MeshConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    warm: WarmCacheConfig = field(default_factory=WarmCacheConfig)
    risk: RiskConfig = field(default_factory=RiskConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    fast: FastSampleConfig = field(default_factory=FastSampleConfig)
    slo: SloConfig = field(default_factory=SloConfig)


def validate_serve_config(cfg: ServeConfig) -> None:
    """The JAX package's checks (``ValueError``), then NotPortedError for a
    serve setting the port does not run yet, naming the ROADMAP Queue A item
    that ports it: the ANN tier in copy-risk scoring (item 1), live ingest
    (item 3), the warm cache and the trace sink (item 7), the fleet and the
    hang watchdog (item 8), a mesh of more than one device (item 9)."""
    if cfg.sampler not in ("ddim", "dpm++", "ddpm"):
        raise ValueError("serve sampler must be 'ddim', 'dpm++' or 'ddpm'")
    if cfg.max_batch < 1:
        raise ValueError("serve max_batch must be >= 1")
    if cfg.queue_depth < 1:
        raise ValueError("serve queue_depth must be >= 1")
    if cfg.max_wait_ms < 0:
        raise ValueError("serve max_wait_ms must be >= 0")
    if cfg.cache_entries < 0:
        raise ValueError("serve cache_entries must be >= 0")
    if cfg.max_compiled_buckets < 1:
        raise ValueError("serve max_compiled_buckets must be >= 1")
    f = cfg.fleet
    if f.workers < 0:
        raise ValueError("fleet.workers must be >= 0")
    if f.workers > 0 and f.worker_index >= 0:
        raise ValueError("fleet.workers and fleet.worker_index are mutually "
                         "exclusive (supervisor vs worker role)")
    if f.workers > 0 or f.worker_index >= 0:
        if f.heartbeat_s <= 0 or f.lease_s <= f.heartbeat_s:
            raise ValueError("fleet.lease_s must exceed fleet.heartbeat_s > 0 "
                             "(a lease shorter than its renewal period "
                             "expires between heartbeats)")
        if f.dispatch_timeout_s <= 0:
            raise ValueError("fleet.dispatch_timeout_s must be > 0 (an "
                             "unbounded dispatch turns a hung worker into a "
                             "hung fleet)")
        if f.max_attempts < 1:
            raise ValueError("fleet.max_attempts must be >= 1")
        if f.respawn_max < 0:
            raise ValueError("fleet.respawn_max must be >= 0")
        if f.scrape_period_s <= 0 or f.scrape_timeout_s <= 0:
            raise ValueError("fleet.scrape_period_s and fleet.scrape_timeout_s"
                             " must be > 0 (an unbounded scrape turns a dead "
                             "worker into a hung /metrics)")
    validate_risk_config(cfg.risk)
    validate_ingest_config(cfg)
    validate_fast_config(cfg.fast)
    validate_slo_config(cfg.slo)
    mesh_devices = _mesh_devices(cfg.mesh)
    checks = [
        (f.workers > 0, "fleet.workers > 0 (the fleet supervisor, ROADMAP Queue A item 8)"),
        (f.worker_index >= 0, "fleet.worker_index >= 0 (a fleet worker, ROADMAP Queue A "
                              "item 8)"),
        (cfg.ingest.enabled, "ingest.enabled (live ingest, ROADMAP Queue A item 3)"),
        (cfg.risk.ann, "risk.ann (the IVF + int8 tier in copy-risk scoring, ROADMAP Queue A "
                       "item 1)"),
        (bool(cfg.warm.dir), "warm.dir (the warm executable cache, ROADMAP Queue A item 7)"),
        (bool(cfg.logdir), "logdir (the trace and metrics sink, ROADMAP Queue A item 7)"),
        (cfg.hang_timeout_s > 0, "hang_timeout_s > 0 (the hang watchdog, ROADMAP Queue A "
                                 "item 8)"),
        (mesh_devices > 1, f"a mesh of {mesh_devices} devices (the port serves on one; "
                           "ROADMAP Queue A item 9)"),
    ]
    missing = [name for on, name in checks if on]
    if missing:
        raise NotPortedError(
            "not ported to dcr_tpu_torch yet: " + "; ".join(missing)
            + ". Run without them or use the JAX package.")


def validate_slo_config(s: SloConfig) -> None:
    if not s.enabled:
        return
    if s.short_window_s <= 0 or s.long_window_s <= 0:
        raise ValueError("slo windows must be > 0 (a zero-width window has "
                         "no samples to burn)")
    if s.long_window_s < s.short_window_s:
        raise ValueError("slo.long_window_s must be >= slo.short_window_s "
                         "(the long window exists to veto short-window "
                         "spikes; inverted windows would breach on noise)")
    if s.budget <= 0 or s.budget > 1:
        raise ValueError("slo.budget must be in (0, 1]: the allowed "
                         "bad-sample fraction at burn rate 1.0")
    if s.breach_burn < s.warn_burn:
        raise ValueError("slo.breach_burn must be >= slo.warn_burn "
                         "(breach is a worse state than warn)")
    if s.recover_burn >= s.warn_burn:
        raise ValueError("slo.recover_burn must be < slo.warn_burn: "
                         "recovery needs hysteresis or the state flaps at "
                         "the threshold")
    if s.dump_after_s < 0:
        raise ValueError("slo.dump_after_s must be >= 0")
    if s.recall_probe_every_n < 1:
        raise ValueError("slo.recall_probe_every_n must be >= 1")
    if s.recall_probe_k < 1 or s.recall_probe_window < 1:
        raise ValueError("slo.recall_probe_k and slo.recall_probe_window "
                         "must be >= 1")


def validate_ingest_config(cfg: ServeConfig) -> None:
    i = cfg.ingest
    if not i.enabled:
        return
    if not cfg.risk.store_dir:
        raise ValueError(
            "ingest.enabled requires risk.store_dir: live ingest appends to "
            "the sharded embedding store the risk index scores against "
            "(a dense risk.index_path dump has no append path)")
    if i.queue_max < 1:
        raise ValueError("ingest.queue_max must be >= 1")
    if i.batch_rows < 1:
        raise ValueError("ingest.batch_rows must be >= 1")
    if i.seal_rows < 1:
        raise ValueError("ingest.seal_rows must be >= 1")
    if i.compact_rows < 0:
        raise ValueError("ingest.compact_rows must be >= 0 (0 disables "
                         "auto-compaction)")
    if i.lease_s <= 0:
        raise ValueError("ingest.lease_s must be > 0 (the stale-writer "
                         "takeover horizon)")


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
