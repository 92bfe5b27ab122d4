"""Build a persistent latent cache once, then train every regime against it
(PyTorch port of ``dcr-precompute-latents``).

    python -m dcr_tpu_torch.cli.precompute --pipe.latent_cache=<dir> \\
        --data.train_data_dir=... --data.random_flip=false [--key=value ...]

Takes the same TrainConfig as ``dcr-train-torch``: the cache's fingerprint
hashes the frozen VAE and text params (built from ``seed`` and ``model`` as
the Trainer builds them, or given as ``pretrained_params=`` as the Trainer
takes them), the dataset's paths, resolution and crop, the caption regime
and the tokenizer. ``dcr-train-torch --pipe.latent_cache=<dir>`` with a
matching config verifies and loads it; anything else is a fingerprint
mismatch naming the fields that differ.

Cached per active dataset index: the VAE posterior moments (mean, std) and
the frozen text embedding of that index's caption. Needs
``data.random_flip=false``, ``data.center_crop=true`` and a frozen text
encoder (``validate_pipe_config`` names the flag to flip). Prints one JSON
summary line. Runs on CUDA unless ``DCR_TPU_PLATFORM=cpu``.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

import numpy as np
import torch

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core.config import TrainConfig, parse_cli, validate_train_config

log = logging.getLogger("dcr_tpu_torch")


def precompute(cfg: TrainConfig, *, pretrained_params: Optional[dict] = None,
               device: str | torch.device = "cuda") -> dict:
    """Encode the dataset's active indices into ``cfg.pipe.latent_cache``.
    Returns the summary (the CLI's JSON line)."""
    from dcr_tpu_torch.core import rng as rngmod
    from dcr_tpu_torch.core.device import resolve_device
    from dcr_tpu_torch.data import latent_cache as LC
    from dcr_tpu_torch.data.dataset import ObjectAttributeDataset
    from dcr_tpu_torch.data.tokenizer import load_tokenizer
    from dcr_tpu_torch.diffusion import encode_stage as E
    from dcr_tpu_torch.diffusion.trainer import _flax_to_state_dicts
    from dcr_tpu_torch.sampling.pipeline import build_models

    if not cfg.pipe.latent_cache:
        raise SystemExit("dcr-precompute-latents-torch: set --pipe.latent_cache=<cache dir>")
    # validate_pipe_config's cache rules, with messages naming the flag
    validate_train_config(cfg)
    device = resolve_device(device)
    t0 = time.perf_counter()
    tokenizer = load_tokenizer(cfg.pretrained_model or None,
                               vocab_size=cfg.model.text_vocab_size,
                               model_max_length=cfg.model.text_max_length)
    dataset = ObjectAttributeDataset(cfg.data, tokenizer, fault=cfg.fault)
    # the Trainer's derivation: equal (seed, model) or equal pretrained
    # params give equal frozen params, so an equal fingerprint
    models = build_models(cfg.model, device, seed=rngmod.stream_seed(cfg.seed, "init"))
    modules = {"vae": models.vae, "text": models.text_encoder}
    for name, sd in _flax_to_state_dicts(pretrained_params or {}, cfg).items():
        if name in modules:
            modules[name].load_state_dict(sd, strict=True)
    frozen = {"vae": dict(models.vae.named_parameters()),
              "text": dict(models.text_encoder.named_parameters())}
    encode_fn = E.make_encode_stage(cfg, models, emit="moments")
    t_fp = time.perf_counter()
    fp = LC.cache_fingerprint(cfg, dataset, tokenizer, vae_params=frozen["vae"],
                              text_params=frozen["text"])
    fingerprint_s = time.perf_counter() - t_fp
    writer = LC.LatentCacheWriter(cfg.pipe.latent_cache, fp,
                                  shard_size=cfg.pipe.cache_shard_size)

    bsz, n = cfg.train_batch_size, len(dataset)
    done = 0
    t_enc = time.perf_counter()
    for lo in range(0, n, bsz):
        positions = list(range(lo, min(lo + bsz, n)))
        valid = len(positions)
        # the tail is padded to the batch size; padded rows are discarded
        positions += [positions[-1]] * (bsz - valid)
        examples = [dataset.get(p) for p in positions]
        batch = {"pixel_values": np.stack([e.pixel_values for e in examples]),
                 "input_ids": np.stack([e.input_ids for e in examples]),
                 "index": np.asarray([e.index for e in examples], np.int64)}
        enc = encode_fn(frozen, batch, 0)
        nhwc = lambda t: t[:valid].permute(0, 2, 3, 1).cpu().numpy()
        writer.add(batch["index"][:valid], nhwc(enc["mean"]), nhwc(enc["std"]),
                   enc["ctx"][:valid].float().cpu().numpy())
        done += valid
        if (lo // bsz) % 20 == 0:
            log.info("precompute: %d/%d indices encoded", done, n)
    encode_s = time.perf_counter() - t_enc
    manifest = json.loads(writer.finalize().read_text())
    seconds = time.perf_counter() - t0
    summary = {"cache": cfg.pipe.latent_cache, "indices": done,
               "shards": len(manifest["shards"]), "seconds": round(seconds, 3),
               "encode_s": round(encode_s, 3), "fingerprint_s": round(fingerprint_s, 3),
               "images_per_s": round(done / max(encode_s, 1e-9), 3),
               "bytes": sum((writer.dir / s["file"]).stat().st_size
                            for s in manifest["shards"])}
    log.info("latent cache written: %s", summary)
    return summary


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        force=True)
    cfg = parse_cli(TrainConfig, argv)
    print(json.dumps(precompute(cfg, device=device_from_env())))


if __name__ == "__main__":
    main()
