"""Replication metrics (PyTorch port of ``dcr-eval``).

    python -m dcr_tpu_torch.cli.evaluate --query_dir=<generations> \\
        --values_dir=<training images> --compute_complexity=false

Same flags and ``--config=<config.json>`` as the JAX package's ``dcr-eval``,
plus its ``--query_caption_json=`` / ``--values_caption_json=`` caption
tables. It runs on one CUDA device (``DCR_TPU_PLATFORM=cpu`` selects the
CPU). The complexity stage is not ported, so a run needs
``--compute_complexity=false``; a setting the port does not run is refused
with ``NotPortedError``.
"""

from __future__ import annotations

import logging
import sys

from dcr_tpu_torch.cli import device_from_env
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
    return run_eval(cfg, device=device_from_env(), **extra)


if __name__ == "__main__":
    main()
