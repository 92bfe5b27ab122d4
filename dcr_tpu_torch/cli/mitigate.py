"""Inference-time mitigation on known-replication prompts (PyTorch port of
``dcr-mitigate``).

    python -m dcr_tpu_torch.cli.mitigate --model_path=<checkpoint> \\
        [--rand_noise_lam=0.1] [--rand_augs=rand_word_add]

The reference's sd_mitigation.py: generate from 12 LAION prompts that stock
SD-1.4 reproduces from its training set, with the inference-time
mitigations (``--rand_noise_lam`` embedding noise, ``--rand_augs`` prompt
augmentation) on or off. Same flags, prompts, augmentation stream and
``savepath`` as the JAX package's ``dcr-mitigate``. It runs on one CUDA
device (``DCR_TPU_PLATFORM=cpu`` selects the CPU), or on the job's
processes with ``--mesh.*`` (``sampling/pipeline.generate``).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core.config import SampleConfig, parse_cli
from dcr_tpu_torch.core.rng import host_python_rng
from dcr_tpu_torch.data.tokenizer import load_tokenizer
from dcr_tpu_torch.sampling.pipeline import generate
from dcr_tpu_torch.sampling.prompts import prompt_augmentation

# the 12 known-replication LAION prompts (the mitigation paper's fixture,
# reference sd_mitigation.py:81)
KNOWN_REPLICATION_PROMPTS = (
    "Wall View 002",
    "Wall View 003",
    "Chamberly - Alloy 5 Piece Sectional",
    "Hopped-Up Gaming: East",
    "Pantomine - Driftwood 4 Piece Sectional",
    "Cresson - Pewter 4 Piece Sectional",
    "Jinllingsly - Chocolate 3 Piece Sectional",
    "Maier - Charcoal 2 Piece Sectional",
    "Classic Cars for Sale",
    "Mothers influence on her young hippo",
    "Living in the Light with Ann Graham Lotz",
    "The No Limits Business Woman Podcast",
)


def mitigation_plan(cfg: SampleConfig) -> list[str]:
    """Set ``cfg.savepath`` by the JAX rules when unset and return the
    prompts, augmented from the ``mitigation_augs`` stream when
    ``cfg.rand_augs`` names an augmentation (which is then set to "none":
    applied once here, not again in generate)."""
    if not cfg.savepath:
        suffix = "nomit"
        if cfg.rand_noise_lam > 0:
            suffix = f"glam{cfg.rand_noise_lam}"
        if cfg.rand_augs != "none":
            suffix = f"aug_{cfg.rand_augs}"
        cfg.savepath = f"inferences/mitigation_{suffix}"
    prompts = list(KNOWN_REPLICATION_PROMPTS)
    if cfg.rand_augs != "none":
        tokenizer = load_tokenizer(cfg.model_path or None)
        rng = host_python_rng(cfg.seed, "mitigation_augs")
        prompts = [prompt_augmentation(p, cfg.rand_augs, tokenizer=tokenizer, rng=rng,
                                       repeat_num=cfg.rand_aug_repeats)
                   for p in prompts]
        cfg.rand_augs = "none"
    return prompts


def main(argv=None) -> Path:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        force=True)
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_cli(SampleConfig, argv)
    prompts = mitigation_plan(cfg)
    out = generate(cfg, modelstyle="fixed", prompts=prompts, device=device_from_env())
    logging.getLogger("dcr_tpu_torch").info("mitigation generations -> %s", out)
    return out


if __name__ == "__main__":
    main()
