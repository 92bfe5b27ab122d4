"""Replication metrics (PyTorch port of ``dcr-eval``).

    python -m dcr_tpu_torch.cli.evaluate --query_dir=<generations> \\
        --values_dir=<training images>

Same flags and ``--config=<config.json>`` as the JAX package's ``dcr-eval``,
plus its ``--query_caption_json=`` / ``--values_caption_json=`` caption
tables. It runs on one CUDA device (``DCR_TPU_PLATFORM=cpu`` selects the
CPU), or as N processes, one device each, under torchrun or the JAX
package's variables, laid out by ``--mesh.*``:

    torchrun --nproc_per_node=N -m dcr_tpu_torch.cli.evaluate \
        --query_dir=... --values_dir=... --mesh.data=N

where the extractors and the CLIP score split each batch over ``data`` x
``fsdp``, the similarity products split query rows over every rank, every
rank returns the same scalars and rank 0 alone writes the artifacts
(``eval/runner.run_eval``). The JAX defaults run as they are (the
complexity stage included); the backbones are ``--pt_style=sscd``,
``dino`` (every ``--arch`` of ``models/vit.DINO_ARCHS``, ``--layer`` > 1 on
the ViTs) and ``clip``. A setting the port does not run is refused with
``NotPortedError``.
"""

from __future__ import annotations

import logging
import sys

import torch.distributed as tdist

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core import dist
from dcr_tpu_torch.core.config import EvalConfig, parse_cli
from dcr_tpu_torch.eval.runner import run_eval

CAPTION_FLAGS = ("query_caption_json", "values_caption_json")


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        force=True)
    argv = list(sys.argv[1:] if argv is None else argv)
    extra, rest = {}, []
    for arg in argv:
        key = next((k for k in CAPTION_FLAGS if arg.startswith(f"--{k}=")), None)
        if key is None:
            rest.append(arg)
        else:
            extra[key] = arg.split("=", 1)[1]
    cfg = parse_cli(EvalConfig, rest)
    joined_here = not tdist.is_initialized()
    scalars = run_eval(cfg, device=device_from_env(), **extra)
    if joined_here:
        dist.shutdown()
    return scalars


if __name__ == "__main__":
    main()
