"""``dcr-mitigate``: the port's prompts and savepath against the JAX
package's, with ``generate`` stubbed in both, and one tiny run on the CPU."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dcr_tpu.cli import mitigate as jax_mitigate  # noqa: E402
from dcr_tpu_torch.cli import mitigate  # noqa: E402
from dcr_tpu_torch.core.config import INFERENCE_AUGS, ModelConfig  # noqa: E402
from dcr_tpu_torch.sampling.png import read_png  # noqa: E402

BPE = Path(__file__).parent / "fixtures" / "bpe"


def _captured(module, monkeypatch, argv):
    seen = {}

    def fake_generate(cfg, *, modelstyle, prompts, **kw):
        seen.update(cfg=dataclasses.asdict(cfg), modelstyle=modelstyle, prompts=list(prompts))
        return Path(cfg.savepath)

    monkeypatch.setattr(module, "generate", fake_generate)
    module.main(list(argv))
    return seen


@pytest.mark.parametrize("lam", [0.0, 0.1])
@pytest.mark.parametrize("augs", INFERENCE_AUGS)
@pytest.mark.parametrize("extra", [[], ["--seed=2", "--rand_aug_repeats=3"],
                                   ["--savepath=out/mine"], [f"--model_path={BPE}"]],
                         ids=["defaults", "seed2", "savepath", "bpe"])
def test_prompts_and_savepath_equal_jax(monkeypatch, augs, lam, extra):
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    argv = [f"--rand_augs={augs}", f"--rand_noise_lam={lam}"] + extra
    mine = _captured(mitigate, monkeypatch, argv)
    theirs = _captured(jax_mitigate, monkeypatch, argv)
    assert mine["prompts"] == theirs["prompts"]
    assert len(mine["prompts"]) == 12 and mine["modelstyle"] == theirs["modelstyle"] == "fixed"
    for key in ("savepath", "rand_augs", "rand_noise_lam", "seed", "rand_aug_repeats"):
        assert mine["cfg"][key] == theirs["cfg"][key], key
    if augs == "none":
        assert mine["prompts"] == list(jax_mitigate.KNOWN_REPLICATION_PROMPTS)
    else:
        assert mine["cfg"]["rand_augs"] == "none"


def test_known_prompts_equal_jax():
    assert mitigate.KNOWN_REPLICATION_PROMPTS == jax_mitigate.KNOWN_REPLICATION_PROMPTS


def test_tiny_run_writes_twelve_images(tmp_path, monkeypatch):
    from dcr_tpu_torch.core.checkpoint import export_hf_layout
    from dcr_tpu_torch.sampling.pipeline import build_models

    mc = ModelConfig.tiny()
    models = build_models(mc, "cpu", seed=0)
    ckpt = tmp_path / "ckpt"
    export_hf_layout(ckpt, unet=models.unet.state_dict(), vae=models.vae.state_dict(),
                     text_encoder=models.text_encoder.state_dict(),
                     scheduler_config={"num_train_timesteps": mc.num_train_timesteps,
                                       "beta_schedule": mc.beta_schedule,
                                       "beta_start": mc.beta_start, "beta_end": mc.beta_end,
                                       "prediction_type": mc.prediction_type},
                     model_config=dataclasses.asdict(mc))
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    out = mitigate.main([f"--model_path={ckpt}", "--resolution=16", "--num_batches=1",
                         "--im_batch=1", "--num_inference_steps=2", "--sampler=ddim",
                         "--rand_noise_lam=0.1", "--rand_augs=rand_word_add"])
    assert out == Path("inferences/mitigation_aug_rand_word_add")
    pngs = sorted((tmp_path / out / "generations").glob("*.png"))
    assert len(pngs) == 12
    imgs = np.stack([read_png(p) for p in pngs])
    assert imgs.shape == (12, 16, 16, 3) and imgs.std() > 0
    prompts = (tmp_path / out / "prompts.txt").read_text().splitlines()
    assert len(prompts) == 12 and prompts != list(mitigate.KNOWN_REPLICATION_PROMPTS)
