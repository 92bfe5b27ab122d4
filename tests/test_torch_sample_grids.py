"""The port's Trainer writes no sample grids; with ``save_steps > 0`` it
says so once, as a warning at the start of ``train()`` (the JAX package's
dcr-train writes a grid every ``save_steps``)."""

from __future__ import annotations

import logging

import numpy as np

from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.diffusion.trainer import Trainer
from dcr_tpu_torch.sampling.png import write_png


def _trainer(tmp_path, save_steps: int) -> Trainer:
    rng = np.random.default_rng(0)
    for i in range(4):
        d = tmp_path / "data" / f"c{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        write_png(d / f"{i}.png", rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    cfg = TC.TrainConfig(output_dir=str(tmp_path / f"run{save_steps}"), train_batch_size=2,
                         max_train_steps=1, log_every=1, mixed_precision="no",
                         save_steps=save_steps)
    cfg.model = TC.ModelConfig.tiny()
    cfg.data = TC.DataConfig(train_data_dir=str(tmp_path / "data"), resolution=16,
                             num_workers=1)
    return Trainer(cfg, device="cpu")


def _grid_warnings(caplog) -> list[logging.LogRecord]:
    return [r for r in caplog.records
            if r.levelno == logging.WARNING and "sample grids are not written" in r.message]


def test_save_steps_warns_once_that_no_grids_are_written(tmp_path, caplog):
    trainer = _trainer(tmp_path, save_steps=500)
    with caplog.at_level(logging.WARNING, logger="dcr_tpu_torch"):
        trainer.train()
    warnings = _grid_warnings(caplog)
    assert len(warnings) == 1 and "save_steps=500" in warnings[0].message


def test_no_warning_without_save_steps(tmp_path, caplog):
    trainer = _trainer(tmp_path, save_steps=0)
    with caplog.at_level(logging.WARNING, logger="dcr_tpu_torch"):
        trainer.train()
    assert not _grid_warnings(caplog)
