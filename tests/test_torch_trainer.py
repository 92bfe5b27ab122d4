"""PyTorch port: the Trainer on a tiny CPU run.

A straight run of N steps equals 2 steps + resume + N-2 (bit for bit: the
loader order, the per-step draws and the optimizer state all resume); the
run writes metrics.jsonl with the JAX trainer's scalar names (the
``faults/*`` counters included); the HF-layout
export loads in the JAX package's load_checkpoint_models with the port's
params; a JAX param tree goes in through ``pretrained_params=``; and the
CLI runs on the CPU when asked.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from dcr_tpu.sampling.pipeline import load_checkpoint_models as jax_load_checkpoint_models
from dcr_tpu_torch.cli import train as train_cli
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.diffusion.trainer import Trainer
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.sampling.pipeline import load_checkpoint_models
from dcr_tpu_torch.sampling.png import write_png


def _data(root, n=10):
    rng = np.random.default_rng(0)
    for i in range(n):
        d = root / f"c{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        h, w = (16, 16) if i % 3 else (20, 26)
        write_png(d / f"{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return root


def _cfg(tmp_path, out="run", **kw) -> TC.TrainConfig:
    cfg = TC.TrainConfig(output_dir=str(tmp_path / out), train_batch_size=3,
                         max_train_steps=5, log_every=1, modelsavesteps=1000,
                         mixed_precision="no", seed=1, **kw)
    cfg.model = TC.ModelConfig.tiny()
    cfg.data = TC.DataConfig(train_data_dir=str(tmp_path / "data"), resolution=16,
                             num_workers=2, class_prompt="classlevel")
    cfg.optim = TC.OptimConfig(learning_rate=1e-3, lr_scheduler="constant", lr_warmup_steps=0)
    return cfg


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    _data(tmp / "data")
    R.reset_counters()  # the process's fault counters join every metrics row
    cfg = _cfg(tmp)
    trainer = Trainer(cfg, device="cpu")
    metrics = trainer.train()
    return tmp, cfg, trainer, metrics


def test_straight_run_equals_resumed_run(straight, tmp_path):
    tmp, cfg, trainer, _ = straight
    _data(tmp_path / "data")
    first = _cfg(tmp_path, out="resumed")
    first.max_train_steps = 2
    Trainer(first, device="cpu").train()
    second = Trainer(_cfg(tmp_path, out="resumed"), device="cpu")
    assert second.maybe_resume() == 2 and second.state.opt_state.count == 2
    second.train()
    assert second.state.step == trainer.state.step == 5
    for k, p in trainer.state.unet_params.items():
        assert torch.equal(p, second.state.unet_params[k]), k
    for k, m in trainer.state.opt_state.nu.items():
        assert torch.equal(m, second.state.opt_state.nu[k]), k
    straight_log = [json.loads(x) for x in
                    (tmp / "run" / "logs" / "metrics.jsonl").read_text().splitlines()]
    resumed_log = [json.loads(x) for x in
                   (tmp_path / "resumed" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in resumed_log] == [1, 2, 3, 4, 5]
    assert [r["loss"] for r in resumed_log] == [r["loss"] for r in straight_log]


def test_metrics_log_has_the_jax_keys(straight):
    tmp, cfg, _, metrics = straight
    rows = [json.loads(x) for x in (tmp / "run" / "logs" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    for r in rows:
        assert set(r) == {"step", "time", "loss", "grad_norm", "lr", "images_per_sec",
                          "faults/bad_samples", "faults/rollbacks", "faults/ckpt_fallbacks"}
        assert np.isfinite([r["loss"], r["grad_norm"], r["lr"], r["images_per_sec"]]).all()
    assert metrics["loss"] == rows[-1]["loss"]
    saved = json.loads((tmp / "run" / "config.json").read_text())
    assert saved["optim"]["learning_rate"] == 1e-3 and saved["model"]["text_layers"] == 2


def test_export_loads_in_the_jax_package(straight):
    tmp, cfg, trainer, _ = straight
    ckpt = tmp / "run" / "checkpoint"
    assert (ckpt / "scheduler" / "scheduler_config.json").exists()
    for sub in ("unet", "vae", "text_encoder"):
        assert json.loads((ckpt / sub / "config.json").read_text())
    _, jparams, jcfg = jax_load_checkpoint_models(ckpt)
    assert jcfg.text_layers == cfg.model.text_layers
    n_blocks = len(cfg.model.block_out_channels)
    for want, got in ((trainer.state.unet_params, EX.unet_from_flax(jparams["unet"], n_blocks)),
                      (trainer.state.vae_params, EX.vae_from_flax(jparams["vae"])),
                      (trainer.state.text_params, EX.text_from_flax(jparams["text"]))):
        assert set(want) == set(got)
        for k in want:
            assert torch.equal(want[k].detach(), got[k]), k
    # and back into the port
    _, params, model_cfg = load_checkpoint_models(ckpt, "cpu")
    assert model_cfg == cfg.model
    for k, p in trainer.state.unet_params.items():
        assert torch.equal(p.detach(), params["unet"][k])


def test_checkpoints_total_limit(tmp_path):
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, checkpoints_total_limit=2)
    cfg.modelsavesteps, cfg.max_train_steps = 1, 4
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    assert trainer.ckpt.all_steps() == [3, 4]
    assert not list((tmp_path / "run" / "checkpoints").glob(".*tmp"))


def test_jax_tree_goes_in_through_pretrained_params(tmp_path):
    from dcr_tpu.core.config import ModelConfig
    from dcr_tpu.models.clip_text import init_clip_text
    from dcr_tpu.models.unet2d import init_unet
    from dcr_tpu.models.vae import init_vae
    from tests.test_torch_models import jax_params

    _data(tmp_path / "data")
    cfg = _cfg(tmp_path)
    cfg.max_train_steps = 1
    from dcr_tpu.core.checkpoint import export_hf_layout, import_hf_layout

    jcfg = ModelConfig.tiny()
    export_hf_layout(tmp_path / "jax_ckpt", unet=jax_params(init_unet, jcfg, 1),
                     vae=jax_params(init_vae, jcfg, 2),
                     text_encoder=jax_params(init_clip_text, jcfg, 3))
    trees = {"unet": import_hf_layout(tmp_path / "jax_ckpt", "unet"),
             "vae": import_hf_layout(tmp_path / "jax_ckpt", "vae"),
             "text": import_hf_layout(tmp_path / "jax_ckpt", "text_encoder")}
    trainer = Trainer(cfg, pretrained_params=trees, device="cpu")
    want = EX.unet_from_flax(trees["unet"], 2)
    for k, p in trainer.state.unet_params.items():
        assert torch.equal(p.detach(), want[k]), k
    metrics = trainer.train()
    assert np.isfinite(metrics["loss"]) and trainer.state.step == 1
    with pytest.raises(KeyError, match="unknown components"):
        Trainer(_cfg(tmp_path, out="bad"), pretrained_params={"unet2": {}}, device="cpu")


def test_non_finite_loss_fails_fast(tmp_path):
    _data(tmp_path / "data")
    trainer = Trainer(_cfg(tmp_path), device="cpu")
    step_fn = trainer.step_fn

    def poisoned(state, batch):
        state, metrics = step_fn(state, batch)
        return state, {**metrics, "loss": torch.tensor(float("nan"))}

    trainer.step_fn = poisoned
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.train()


@pytest.mark.parametrize("override,what", [
    ("--use_wandb=true", "wandb"),
    ("--mesh.fsdp=2 --mesh.seq=2", "item 9c"),
    ("--mesh.tensor=2 --optim.use_8bit_adam=true", "item 9d"),
])
def test_settings_not_ported_are_refused(tmp_path, override, what):
    cfg = TC.parse_cli(TC.TrainConfig, override.split(), base=_cfg(tmp_path))
    with pytest.raises(TC.NotPortedError, match=what):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("override,ok", [("--mesh.data=-1", True), ("--mesh.seq=1", True),
                                         ("--mesh.data=2", False), ("--mesh.seq=2", False)])
def test_a_training_mesh_is_the_jobs_processes(tmp_path, override, ok):
    """A data x seq mesh trains (as processes: tests/test_torch_dist.py,
    test_torch_seqpar.py and test_torch_coordination.py run two ranks); in
    one process it must be 1 x 1, and a larger one names the mismatch."""
    _data(tmp_path / "data")
    cfg = TC.parse_cli(TC.TrainConfig, [override, "--max_train_steps=1"],
                       base=_cfg(tmp_path))
    if ok:
        trainer = Trainer(cfg, device="cpu")
        assert trainer.mesh.shape["data"] == trainer.mesh.shape["seq"] == 1
        assert np.isfinite(trainer.train()["loss"])
    else:
        with pytest.raises(ValueError, match="1 devices"):
            Trainer(cfg, device="cpu")


@pytest.mark.parametrize("override", ["--optim.use_8bit_adam=true"])
def test_8bit_adam_setting_runs(tmp_path, override):
    """8-bit Adam runs since its slice was ported: the Trainer trains with
    int8/uint8 moment codes for the large tensors (tests/test_torch_adam8bit.py
    holds it to the JAX package)."""
    _data(tmp_path / "data")
    cfg = TC.parse_cli(TC.TrainConfig, [override, "--max_train_steps=1"],
                       base=_cfg(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    metrics = trainer.train()
    assert trainer.state.step == 1 and np.isfinite(metrics["loss"])
    opt = trainer.state.opt_state
    assert opt.m8 and {t.dtype for k, t in opt.m8.items() if k.endswith("/q")} == {torch.int8}


@pytest.mark.parametrize("override", ["--pipe.enabled=true"])
def test_pipelined_settings_run(tmp_path, override):
    """Pipelined training runs since its slice was ported: the Trainer
    builds the producer and the denoiser step in place of the fused step
    and trains."""
    _data(tmp_path / "data")
    cfg = TC.parse_cli(TC.TrainConfig, [override, "--max_train_steps=2"],
                       base=_cfg(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.pipelined and trainer.step_fn == trainer._pipelined_step
    metrics = trainer.train()
    assert trainer.state.step == 2 and np.isfinite(metrics["loss"])
    assert len(trainer.ring_wait_s) == 2


def test_warm_dir_setting_runs(tmp_path):
    """``warm.dir`` runs since the warm cache was ported: after restore the
    Trainer resolves the step's kernels through it (the train step;
    pipelined, the denoiser step), eager on the CPU where every kernel
    wrapper takes its plain version, so nothing is stored."""
    _data(tmp_path / "data")
    warm = tmp_path / "warm"
    def eager():
        return tracing.registry().counter("warmcache/eager").value

    before = eager()
    cfg = TC.parse_cli(TC.TrainConfig, [f"--warm.dir={warm}", "--max_train_steps=1"],
                       base=_cfg(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    assert np.isfinite(trainer.train()["loss"]) and trainer.state.step == 1
    assert eager() == before + 1
    piped = Trainer(TC.parse_cli(TC.TrainConfig, ["--pipe.enabled=true"], base=cfg),
                    device="cpu")
    piped._warm_start()
    assert eager() == before + 2 and list(warm.iterdir()) == []


def test_cli_trains_on_cpu_when_asked(tmp_path, monkeypatch):
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, out="cli")
    cfg.max_train_steps = 2
    TC.save_config(cfg, tmp_path / "cfg.json")
    monkeypatch.delenv("DCR_TPU_PLATFORM", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main([f"--config={tmp_path / 'cfg.json'}"])
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    train_cli.main([f"--config={tmp_path / 'cfg.json'}"])
    assert (tmp_path / "cli" / "checkpoint" / "model_index.json").exists()
    assert len((tmp_path / "cli" / "logs" / "metrics.jsonl").read_text().splitlines()) == 2


@pytest.mark.parametrize("component", ["unet", "unet_sd1x", "vae", "text"])
def test_export_maps_round_trip_bit_for_bit(component):
    """``*_to_flax`` inverts ``*_from_flax``: same tree, key for key, bit for bit."""
    import jax

    from dcr_tpu.models.clip_text import init_clip_text
    from dcr_tpu.models.unet2d import init_unet
    from dcr_tpu.models.vae import init_vae
    from tests.test_torch_models import jax_params, tiny_cfg

    cfg = tiny_cfg(**(dict(attention_head_dim=0, attention_num_heads=4,
                           use_linear_projection=False) if component == "unet_sd1x" else {}))
    init = {"unet": init_unet, "unet_sd1x": init_unet, "vae": init_vae,
            "text": init_clip_text}[component]
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jax_params(init, cfg, 4))
    there, back = {
        "unet": (lambda t: EX.unet_from_flax(t, 2), lambda s: EX.unet_to_flax(s, 2)),
        "unet_sd1x": (lambda t: EX.unet_from_flax(t, 2), lambda s: EX.unet_to_flax(s, 2)),
        "vae": (EX.vae_from_flax, EX.vae_to_flax),
        "text": (EX.text_from_flax, lambda s: EX.text_to_flax(s, cfg.text_heads)),
    }[component]
    flat = lambda t: {jax.tree_util.keystr(k): v
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    want, got = flat(tree), flat(back(there(tree)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_jax_written_config_and_command_line_parse_unchanged(tmp_path):
    import dataclasses

    from dcr_tpu.core import config as JC

    argv = ["--data.class_prompt=instancelevel_blip", "--data.duplication=dup_image",
            "--rand_noise_lam=0.1", "--optim.gradient_accumulation_steps=2",
            "--model.block_out_channels=64,128", "--data.caption_jsons=a.json,b.json",
            "--fault.decode_retries=2", "--pipe.depth=3", "--risk.top_k=2"]
    jcfg = JC.parse_cli(JC.TrainConfig, argv)
    JC.save_config(jcfg, tmp_path / "config.json")
    for tcfg in (TC.load_config(TC.TrainConfig, tmp_path / "config.json"),
                 TC.parse_cli(TC.TrainConfig, argv)):
        assert TC.to_dict(tcfg) == JC.to_dict(jcfg)
    assert TC.to_dict(TC.TrainConfig()) == JC.to_dict(JC.TrainConfig())
    assert dataclasses.asdict(TC.TrainConfig()) == dataclasses.asdict(JC.TrainConfig())
