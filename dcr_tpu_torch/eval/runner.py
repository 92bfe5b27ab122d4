"""The eval driver: backbone -> features -> the copying metrics -> plots.

Counterpart of ``dcr_tpu/eval/runner.py`` ``run_eval`` (the reference's
diff_retrieval.py:main_worker) on one device. Stages, in the JAX order and
under the same scalar names:

1. ``eval/features``: the copy-detection embedder over the generations
   (query) and the training images (values), L2-normalised. The embedder
   is SSCD (``pt_style="sscd"``), a DINO backbone (``"dino"``: the ViTs,
   XCiTs and ResNet-50 of ``models/vit.DINO_ARCHS``; ``layer`` > 1 takes
   the layer-th-from-last ViT block, and splitloss all its tokens) or the
   CLIP image tower (``"clip"``);
2. ``eval/similarity``: the similarity matrix, the gen↔train statistics
   (``sim_gt_05pc`` ..) and the train↔train background;
3. ``eval/clip_score``: mean CLIP cosine of each folder's images with their
   captions (``gen_clipscore``, ``train_clipscore``);
4. ``eval/complexity``: entropy, JPEG size and total variation of each
   top-1 match against its similarity (``corr_*``, ``mean_*``);
5. the duplicated-vs-not split of top-1 similarity from the training
   weights pickle;
6. ``eval/fid_ipr``: FID on Inception pool3 features of the uncropped
   images, precision and recall on VGG16 fc2 features;
7. ``eval/galleries``: ranked [query | top-k matches] pages.

Artifacts in ``output_dir``: ``similarity.npy``, ``logs/metrics.jsonl``,
``provenance.json``, ``fid_stats_values.npz``, ``galleries/gallery_rank*.png``
and ``histogram.png`` / ``scatter_{entropy,jpegsize,tv}.png`` /
``dup_barplot.png`` when matplotlib imports. Each stage logs ``[stage]
<name>: begin`` and ``done in <s>s`` (the record carries ``stage`` and
``seconds``). Weights are seeded random unless a checkpoint file or state
dict is given; every backbone is built on the CPU from its seed (so the CPU
and the card get the same weights), frozen, and run under
``torch.inference_mode()`` on ``device``. ``warm.dir`` is accepted and
builds nothing: the extractors launch no native kernel, so the warm cache
(``core/warmcache.py``) has nothing of theirs to hold. Wandb and the fault
settings other than the I/O retries are not ported
(:func:`~dcr_tpu_torch.core.config.validate_eval_config`).

On a mesh (``cfg.mesh`` over the job's processes, one per device; JAX
``runner.py:221-224``) the extractors of stages 1 and 6 and the CLIP score
split each batch over the ``data`` x ``fsdp`` ranks (each rank decodes only
its slab; the CLIP batch padded with its last row, ``dcr_tpu/eval/
runner.py:173-210``) and the similarity products split query rows over
every rank; the results are gathered, so every rank holds the same
features, matrix and scalars. The complexity stage and the host statistics
run alike on every rank. Rank 0 alone writes the artifacts, and the ranks
meet at a named barrier after each stage, as the JAX stages do.
"""

from __future__ import annotations

import logging
import pickle
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Iterator, Mapping, Optional, TypeVar

import numpy as np
import torch

from dcr_tpu_torch.core import dist
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.config import (
    EvalConfig,
    FaultToleranceConfig,
    validate_eval_config,
)
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.core.metrics import MetricWriter
from dcr_tpu_torch.core.rng import seeded_cpu_init
from dcr_tpu_torch.data.tokenizer import TokenizerBase, load_tokenizer
from dcr_tpu_torch.eval import complexity as CX
from dcr_tpu_torch.eval import fid as FID
from dcr_tpu_torch.eval import gallery as G
from dcr_tpu_torch.eval import ipr as IPR
from dcr_tpu_torch.eval import similarity as SIM
from dcr_tpu_torch.eval.features import (
    HALF_NORM,
    EvalImageFolder,
    extract_features,
    make_extractor,
    reference_resize_for,
)
from dcr_tpu_torch.models.clip_image import (
    CLIPImageTower,
    CLIPScorer,
    image_state_dict_from_openai,
    image_state_dict_from_transformers,
    make_clip_scorer,
    scorer_state_dict_from_openai,
)
from dcr_tpu_torch.models.inception import InceptionV3FID
from dcr_tpu_torch.models.resnet import SSCDModel
from dcr_tpu_torch.models.vgg import VGG16Features
from dcr_tpu_torch.models.vit import DINO_ARCHS, VisionTransformer
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.utils.provenance import stamp

log = logging.getLogger("dcr_tpu_torch")

T = TypeVar("T")
StateDict = Mapping[str, torch.Tensor]


@contextmanager
def stage(name: str) -> Iterator[None]:
    """A timed stage: ``[stage] <name>: begin`` and ``done in <s>s`` log lines
    (the JAX package's ``R.stage`` lines); the done record carries ``stage``
    and ``seconds`` for log handlers."""
    t0 = time.perf_counter()
    log.info("[stage] %s: begin", name)
    yield
    dt = time.perf_counter() - t0
    log.info("[stage] %s: done in %.2fs", name, dt, extra={"stage": name, "seconds": dt})


def read_with_retry(read: Callable[[], T], fault: FaultToleranceConfig, what: str) -> T:
    """``read()`` up to ``fault.io_retries`` times on OSError, backing off
    from ``retry_base_delay`` by doubling, capped at ``retry_max_delay``, with
    up to 50 % jitter; a missing file fails at once. It is
    :func:`~dcr_tpu_torch.core.resilience.retry_call` with the eval config's
    settings, so the two retries cannot drift."""
    return R.retry_call(read, attempts=fault.io_retries, base_delay=fault.retry_base_delay,
                        max_delay=fault.retry_max_delay, name=what)


def load_torch_weights(path: str) -> dict[str, torch.Tensor]:
    """A torch state dict file or a TorchScript archive (the SSCD
    distribution format) -> its state dict, on the CPU."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # a TorchScript archive is not a pickled state dict
        try:
            obj = torch.jit.load(path, map_location="cpu")
        except Exception as jit_e:
            raise RuntimeError(f"{path!r} is neither a loadable state dict ({e!r}) nor "
                               "a TorchScript archive") from jit_e
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


# the state-dict keys each DINO family's converter reads in the JAX package
# (convert_dino_vit, convert_xcit, convert_resnet50); others are dropped
_DINO_KEYS = {
    "vit": ("cls_token", "pos_embed", "patch_embed.", "blocks.", "norm."),
    "xcit": ("cls_token", "pos_embeder.", "patch_embed.", "blocks.", "cls_attn_blocks.",
             "norm."),
    "resnet50": ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.", "layer4."),
}


def _dino_family(arch: str) -> str:
    if arch == "dino_resnet50":
        return "resnet50"
    return "xcit" if arch.startswith("dino_xcit") else "vit"


def load_backbone_params(pt_style: str, arch: str, path: str) -> dict[str, torch.Tensor]:
    """The copy-detection backbone's checkpoint file -> the port's state
    dict, from the torch names the JAX package's converters read: SSCD (a
    TorchScript archive or a plain state dict, whose names are the port's),
    a DINO hub checkpoint (ViT and XCiT names are the port's; the ResNet-50
    trunk goes under ``backbone.``), or a CLIP image tower: an OpenAI CLIP
    archive (``visual.*``) or a transformers ``CLIPVisionModel`` state dict
    (``vision_model.*``). Any other CLIP layout raises ``KeyError``, as the
    JAX converter does."""
    sd = load_torch_weights(path)
    if pt_style == "sscd":
        return sd
    if pt_style == "dino":
        family = _dino_family(arch)
        keep = {k: v for k, v in sd.items() if k.startswith(_DINO_KEYS[family])}
        if family == "resnet50":
            return {f"backbone.{k}": v for k, v in keep.items()}
        if "cls_token" in keep:
            keep["cls_token"] = keep["cls_token"].reshape(1, 1, -1)
        return keep
    if pt_style == "clip":
        if any(k.startswith("visual.") for k in sd):
            return image_state_dict_from_openai(sd)
        if any(k.startswith("vision_model.") for k in sd):
            return image_state_dict_from_transformers(sd)
        raise KeyError(f"{path}: neither an OpenAI CLIP archive (visual.*) nor a "
                       f"transformers CLIPVisionModel state dict (vision_model.*)")
    raise ValueError(f"unknown pt_style {pt_style!r} (sscd | dino | clip)")


def _frozen(module: torch.nn.Module, state_dict: Optional[StateDict], what: str,
            device: torch.device) -> torch.nn.Module:
    """Loads ``state_dict`` (strict, with a readable message on mismatch),
    then freezes the module in eval mode on ``device``."""
    if state_dict is not None:
        expected = module.state_dict()
        missing = sorted(set(expected) - set(state_dict))
        unexpected = sorted(set(state_dict) - set(expected))
        shapes = [f"{k}: {tuple(state_dict[k].shape)} != {tuple(expected[k].shape)}"
                  for k in sorted(set(expected) & set(state_dict))
                  if tuple(state_dict[k].shape) != tuple(expected[k].shape)]
        # a checkpoint without the batch counter is fine (FrozenBatchNorm)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        problems = ([f"missing {k}" for k in missing] + [f"unexpected {k}" for k in unexpected]
                    + shapes)
        if problems:
            raise ValueError(f"{what} weights do not match the architecture "
                             f"({len(problems)} mismatches): {'; '.join(problems[:8])}")
        module.load_state_dict(state_dict, strict=True)
    return module.to(device).eval().requires_grad_(False)


class IntermediateLayerFeatures(torch.nn.Module):
    """A DINO ViT's features from its layer-th-from-last block
    (get_intermediate_layers(x, layer)[0], the reference's --layer,
    utils_ret.py:726-745): the CLS token [B, D], or with ``flatten_tokens``
    every token flattened [B, n_tokens * D] (the splitloss path, whose
    similarity is chunked per token: ``n_tokens`` is the chunk count)."""

    def __init__(self, vit: VisionTransformer, layer: int, flatten_tokens: bool,
                 image_size: int):
        super().__init__()
        self.vit = vit
        self.layer = layer
        self.flatten_tokens = flatten_tokens
        self.n_tokens = (image_size // vit.patch_size) ** 2 + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        states = self.vit(x, return_layers=self.layer)[0]
        return states.reshape(states.shape[0], -1) if self.flatten_tokens else states[:, 0]


def build_backbone(pt_style: str, arch: str, device: str | torch.device = "cuda", *,
                   state_dict: Optional[StateDict] = None, seed: int = 0,
                   layer: int = 1, flatten_tokens: bool = False,
                   image_size: int = 224) -> torch.nn.Module:
    """The copy-detection embedder, frozen on ``device`` (the reference's
    model zoo, diff_retrieval.py:249-285): SSCD (ResNet-50 -> GeM -> 512),
    a DINO arch of ``DINO_ARCHS``, or the CLIP image tower with its table
    sized for ``image_size``. Seeded random weights unless ``state_dict``
    is given, which is checked against the architecture first. ``layer`` >
    1 (DINO ViTs only) and ``flatten_tokens``: see
    :class:`IntermediateLayerFeatures`."""
    with seeded_cpu_init(seed):
        if pt_style == "sscd":
            model = SSCDModel(embed_dim=512)
        elif pt_style == "dino":
            if arch not in DINO_ARCHS:
                raise ValueError(f"unknown dino arch {arch!r} (have {sorted(DINO_ARCHS)})")
            model = DINO_ARCHS[arch]()
        elif pt_style == "clip":
            model = CLIPImageTower(image_size=image_size)
        else:
            raise ValueError(f"unknown pt_style {pt_style!r} (sscd | dino | clip)")
    if layer > 1:
        if pt_style != "dino" or not isinstance(model, VisionTransformer):
            raise ValueError(
                f"layer={layer} needs a DINO ViT arch (the reference path, "
                "utils_ret.py:731, is get_intermediate_layers on the ViT; "
                f"{pt_style}/{arch} has no intermediate-layer surface)")
    elif flatten_tokens:
        raise ValueError("flatten_tokens needs a DINO ViT with layer > 1 "
                         "(token-level features; reference utils_ret.py:729-737)")
    model = _frozen(model, state_dict, "backbone", resolve_device(device))
    if layer > 1:
        return IntermediateLayerFeatures(model, layer, flatten_tokens, image_size)
    return model


@compile_surface("eval/clip_score")
def clip_alignment_score(folder: EvalImageFolder, tokenizer: TokenizerBase,
                         scorer: CLIPScorer, device: str | torch.device, *,
                         batch_size: int = 32, clip_image_size: int = 224,
                         mesh: Optional[pmesh.Mesh] = None) -> float:
    """Mean CLIP cosine between each image and its caption (the reference's
    gen_clipscore). Images are loaded again raw in [0, 1]; the tower applies
    CLIP's own normalisation. NaN when the folder has no captions. On a mesh
    each batch is padded with its last row to a multiple of the ``data`` x
    ``fsdp`` ranks and each rank scores (and decodes) its slab."""
    if folder.captions is None:
        return float("nan")
    raw = EvalImageFolder(folder.root, clip_image_size,
                          resize_to=reference_resize_for(clip_image_size))
    device = torch.device(device)
    n = 1 if mesh is None else mesh.data_parallel_size
    scores = []
    for start in range(0, len(folder), batch_size):
        idx = np.arange(start, min(start + batch_size, len(folder)))
        real = len(idx)
        idx = pmesh.pad_rows(idx, n, repeat_last=True)
        if n > 1:
            idx = idx[pmesh.rank_slab(len(idx), n, mesh.batch_index)]
        images = np.stack([raw.load(i) for i in idx])
        ids = tokenizer([folder.captions[i] for i in idx],
                        max_length=scorer.text_config.text_max_length)
        x = torch.from_numpy(images).to(device).permute(0, 3, 1, 2)
        with torch.inference_mode():
            out = scorer.score(x, torch.from_numpy(ids).long().to(device))
        scores.extend(pmesh.to_host(out.float(), mesh)[:real].tolist())
    return float(np.mean(scores))


def run_eval(cfg: EvalConfig, *, device: str | torch.device = "cuda",
             backbone_state_dict: Optional[StateDict] = None,
             inception_state_dict: Optional[StateDict] = None,
             vgg_state_dict: Optional[StateDict] = None,
             tokenizer: Optional[TokenizerBase] = None,
             query_caption_json: Optional[str] = None,
             values_caption_json: Optional[str] = None) -> dict:
    """Every metric stage of ``cfg`` on ``device``, over the mesh of
    ``cfg.mesh`` (module docstring); returns the scalar dict, the same on
    every rank, and rank 0 writes the artifacts. Weights: the
    ``*_state_dict`` arguments (the port's names; ``models/export.*_from_flax``
    carries the JAX package's across), else the files of ``cfg``, else
    seeded random weights (the CLIP scorer: ``cfg.clip_weights_path`` or
    seeded random weights)."""
    validate_eval_config(cfg)
    # splitloss on a DINO ViT layer > 1: token-level features, the similarity
    # chunked per token (the reference's numpatches -> num_loss_chunks
    # aliasing, diff_retrieval.py:394-395, utils_ret.py:729-737)
    flatten_tokens = (cfg.similarity_metric == "splitloss" and cfg.pt_style == "dino"
                      and cfg.layer > 1)
    if flatten_tokens and cfg.multiscale:
        raise ValueError("multiscale pools per-scale embeddings and has no token surface; "
                         "drop --multiscale for the splitloss+layer token path")
    device = dist.job_device(device)
    dist.initialize(device)
    mesh = pmesh.make_mesh(cfg.mesh)
    primary = dist.is_primary()
    out_dir = Path(cfg.output_dir)
    if primary:
        out_dir.mkdir(parents=True, exist_ok=True)
    writer = MetricWriter(out_dir / "logs", active=primary)
    tokenizer = tokenizer or load_tokenizer(None)

    def stage_sync(name: str) -> None:
        # every rank leaves a stage together: a peer that died inside it
        # surfaces as a named BarrierTimeout here, not as a hang later
        dist.barrier(f"eval:{name}", timeout_s=dist.default_allgather_timeout_s())

    # the reference's retrieval transform: Resize(256) + CenterCrop(224) +
    # Normalize([0.5], [0.5]), scaled to image_size
    resize_to = reference_resize_for(cfg.image_size)
    query = EvalImageFolder(cfg.query_dir, cfg.image_size, resize_to=resize_to,
                            normalize=HALF_NORM, caption_json=query_caption_json)
    values = EvalImageFolder(cfg.values_dir, cfg.image_size, resize_to=resize_to,
                             normalize=HALF_NORM, caption_json=values_caption_json)
    log.info("eval: %d query (gen) vs %d values (train) on %s (%r)", len(query), len(values),
             device, mesh)

    def weights_file(path: str, what: str) -> dict[str, torch.Tensor]:
        log.info("loading %s weights from %s", what, path)
        return read_with_retry(lambda: load_torch_weights(path), cfg.fault, what)

    if backbone_state_dict is None and cfg.weights_path:
        backbone_state_dict = read_with_retry(
            lambda: load_backbone_params(cfg.pt_style, cfg.arch, cfg.weights_path),
            cfg.fault, "backbone")
    backbone = build_backbone(cfg.pt_style, cfg.arch, device,
                              state_dict=backbone_state_dict, seed=0, layer=cfg.layer,
                              flatten_tokens=flatten_tokens, image_size=cfg.image_size)
    num_loss_chunks = cfg.num_loss_chunks
    if flatten_tokens:
        if cfg.num_loss_chunks not in (1, backbone.n_tokens):
            raise ValueError(
                f"splitloss with dino layer>1 chunks per token: num_loss_chunks is set by "
                f"the {backbone.n_tokens}-token feature layout (diff_retrieval.py:394-395); "
                f"drop --num_loss_chunks={cfg.num_loss_chunks} or set it to "
                f"{backbone.n_tokens}")
        num_loss_chunks = backbone.n_tokens
    extractor = make_extractor(backbone, device, multiscale=cfg.multiscale)
    with stage("eval/features"):
        query_feats = SIM.l2_normalize(extract_features(query, extractor,
                                                        batch_size=cfg.batch_size, mesh=mesh))
        values_feats = SIM.l2_normalize(extract_features(values, extractor,
                                                         batch_size=cfg.batch_size, mesh=mesh))
    stage_sync("features")

    with stage("eval/similarity"):
        sim = SIM.similarity_matrix(values_feats, query_feats, metric=cfg.similarity_metric,
                                    num_chunks=num_loss_chunks,
                                    chunk_style=cfg.chunk_style, device=device, mesh=mesh)
        stats = SIM.gen_train_stats(sim)
        scalars: dict = stats.scalars()
        bg = SIM.train_train_background(values_feats, device=device, mesh=mesh)
        scalars.update(SIM.background_stats(bg))
    if primary:
        stamp(out_dir)
        np.save(out_dir / "similarity.npy", sim)
        G.histogram_plot(stats.top1, bg, out_dir / "histogram.png")
    stage_sync("similarity")

    if cfg.compute_clip_score:
        with stage("eval/clip_score"):
            scorer = make_clip_scorer(seed=7)
            scorer_state_dict = None
            if cfg.clip_weights_path:
                scorer_state_dict = scorer_state_dict_from_openai(
                    weights_file(cfg.clip_weights_path, "CLIP"))
            scorer = _frozen(scorer, scorer_state_dict, "CLIP scorer", device)
            scalars["gen_clipscore"] = clip_alignment_score(query, tokenizer, scorer, device,
                                                            mesh=mesh)
            scalars["train_clipscore"] = clip_alignment_score(values, tokenizer, scorer,
                                                              device, mesh=mesh)
            del scorer
        stage_sync("clip_score")

    if cfg.compute_complexity:
        # each unique match is decoded once and reduced to its three scalars
        # at once: bounded host memory at any scale
        with stage("eval/complexity"):
            series = CX.streamed_series(values.load, stats.top1_index)
            scalars.update(CX.correlations_from_series(series, stats.top1))
            for key, label, name in (("entropy", "match entropy", "entropy"),
                                     ("jpeg_bytes", "match jpeg bytes", "jpegsize"),
                                     ("tv", "match total variation", "tv")):
                if primary:
                    G.scatter_plot(np.asarray(series[key]), stats.top1, label, "top1 sim",
                                   out_dir / f"scatter_{name}.png")
        stage_sync("complexity")

    if cfg.dup_weights_pickle:
        # the training run's own sampling-weights file (a pickle it wrote)
        weights = np.asarray(pickle.loads(read_with_retry(
            lambda: Path(cfg.dup_weights_pickle).read_bytes(), cfg.fault,
            "dup_weights_pickle")))
        dup = SIM.dup_vs_nondup_means(stats.top1, stats.top1_index, weights)
        scalars.update(dup)
        if primary:
            G.dup_barplot(dup["dupsim_mean"], dup["nondupsim_mean"],
                          out_dir / "dup_barplot.png")

    if cfg.compute_fid:
        with stage("eval/fid_ipr"):
            # the values' statistics cache: read where it existed when the
            # stage began (every rank alike), written by rank 0 alone
            fid_cache = out_dir / "fid_stats_values.npz"
            fid_cache = fid_cache if primary or fid_cache.exists() else None
            with seeded_cpu_init(1):
                inception = InceptionV3FID()
            if inception_state_dict is None and cfg.inception_weights_path:
                inception_state_dict = weights_file(cfg.inception_weights_path,
                                                    "FID Inception")
            inception = _frozen(inception, inception_state_dict, "FID Inception", device)
            fid_extract = make_extractor(inception, device)
            # the reference's FID feeds whole (uncropped) images
            q_act = extract_features(EvalImageFolder(cfg.query_dir, 299, crop=False),
                                     fid_extract, batch_size=50, mesh=mesh)
            v_act = extract_features(EvalImageFolder(cfg.values_dir, 299, crop=False),
                                     fid_extract, batch_size=50, mesh=mesh)
            del inception, fid_extract
            scalars["FID_val"] = FID.fid_from_features(v_act, q_act, cache1=fid_cache)
            # precision/recall on VGG16 fc2 features, as the reference's IPR
            with seeded_cpu_init(2):
                vgg = VGG16Features()
            vgg = _frozen(vgg, vgg_state_dict, "VGG16", device)
            vgg_extract = make_extractor(vgg, device)
            q224 = EvalImageFolder(cfg.query_dir, 224, resize_to=256)
            v224 = EvalImageFolder(cfg.values_dir, 224, resize_to=256)
            scalars.update(IPR.precision_recall(
                extract_features(v224, vgg_extract, batch_size=cfg.batch_size, mesh=mesh),
                extract_features(q224, vgg_extract, batch_size=cfg.batch_size, mesh=mesh),
                device=device))
            del vgg, vgg_extract
        stage_sync("fid_ipr")

    if cfg.galleries and primary:
        with stage("eval/galleries"):
            _, idx = SIM.topk_matches(sim, cfg.gallery_topk)
            G.ranked_galleries(query.paths, values.paths, stats.top1, idx,
                               out_dir / "galleries", rows_per_page=cfg.gallery_rows,
                               max_rank=cfg.gallery_max_rank)

    writer.scalars(0, {k: v for k, v in scalars.items() if isinstance(v, (int, float))})
    writer.close()
    stage_sync("done")
    log.info("eval scalars: %s", scalars)
    return scalars
