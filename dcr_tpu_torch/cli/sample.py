"""Bulk generation from a checkpoint (PyTorch port of ``dcr-sample``).

    python -m dcr_tpu_torch.cli.sample --model_path=<run or checkpoint dir> \\
        --resolution=512 --num_batches=4 --im_batch=2 [--modelstyle=...]

Same flags as the JAX package's ``dcr-sample``. The conditioning style comes
from the run's config.json when present; ``--modelstyle`` overrides it.
Under torchrun (or the JAX package's variables) every process runs it and
``--mesh.*`` lays them out (``sampling/pipeline.generate``):

    torchrun --nproc_per_node=2 -m dcr_tpu_torch.cli.sample \
        --model_path=<run> --mesh.data=1 --mesh.tensor=2
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core.config import SampleConfig, parse_cli
from dcr_tpu_torch.sampling.pipeline import generate

log = logging.getLogger("dcr_tpu_torch")


def infer_modelstyle(model_path: str) -> str:
    """Conditioning regime from the run's config.json; falls back to
    "nolevel", with a warning when a config.json exists but lacks it."""
    cfg_file = Path(model_path) / "config.json"
    if cfg_file.exists():
        try:
            return json.loads(cfg_file.read_text())["data"]["class_prompt"]
        except (KeyError, TypeError, json.JSONDecodeError) as e:
            log.warning("modelstyle_fallback: %s has no data.class_prompt (%r); "
                        "sampling with 'nolevel'", cfg_file, e)
    return "nolevel"


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    modelstyle = None
    caption_json = None
    rest = []
    for arg in argv:
        if arg.startswith("--modelstyle="):
            modelstyle = arg.split("=", 1)[1]
        elif arg.startswith("--caption_json="):
            caption_json = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    cfg = parse_cli(SampleConfig, rest)
    modelstyle = modelstyle or infer_modelstyle(cfg.model_path)
    out = generate(cfg, modelstyle=modelstyle, caption_json=caption_json,
                   device=device_from_env())
    log.info("generations -> %s", out)


if __name__ == "__main__":
    main()
