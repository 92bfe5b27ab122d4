"""Finetune the diffusion stack (PyTorch port of ``dcr-train``).

    python -m dcr_tpu_torch.cli.train --output_dir=runs/x \\
        --data.train_data_dir=<class-folder of PNGs> --max_train_steps=100

Same flags and ``--config=<config.json>`` as the JAX package's ``dcr-train``.
It trains on one CUDA device (``DCR_TPU_PLATFORM=cpu`` selects the CPU), from
seeded random weights, writes a sample grid every ``save_steps``
(``<output_dir>/generations/step_<n>.png``), resumes from
``<output_dir>/checkpoints`` and exports ``<output_dir>/checkpoint`` at the
end. A setting the port does not run yet is refused with ``NotPortedError``.
"""

from __future__ import annotations

import logging

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core.config import TrainConfig, parse_cli
from dcr_tpu_torch.diffusion.sample_hook import make_sample_hook
from dcr_tpu_torch.diffusion.trainer import Trainer

log = logging.getLogger("dcr_tpu_torch")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        force=True)
    cfg = parse_cli(TrainConfig, argv)
    metrics = Trainer(cfg, sample_hook=make_sample_hook(),
                      device=device_from_env()).train()
    log.info("training done: %s", metrics)


if __name__ == "__main__":
    main()
