"""PyTorch port: the trainer's sample grids against the JAX package's
``make_sample_hook``.

- prompts (and token ids) equal the JAX hook's ``state["prompts"]`` for
  ``classlevel``, ``instancelevel_blip`` under a trainsubset, and
  ``nolevel``;
- the grid's images equal the JAX hook's from the JAX hook's own x_T at the
  f32 bar (atol 2e-4, rtol 1e-3) under ``mixed_precision="no"``, from the EMA
  weights; the PNG grids agree within one uint8 level (both truncate);
- the hook fires at the JAX trainer's syncs under gradient accumulation
  (``at_sync and sync % save_steps == 0``; tests/test_trainer_e2e.py);
- ``dcr-train`` installs it and writes ``generations/step_<n>.png`` in
  ``image_grid``'s layout;
- ``score_sample_grid`` writes the JAX hook's ``risk/*`` gauges for the same
  grid and index (similarities within 1e-3: SSCD features at the f32 bar),
  and a bad index becomes a counter, never a failed step.
"""

from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import dcr_tpu.diffusion.sample_hook as JH
import dcr_tpu_torch.diffusion.sample_hook as TH
from dcr_tpu.core import config as JC
from dcr_tpu.core import rng as JR
from dcr_tpu.data.dataset import ObjectAttributeDataset as JDataset
from dcr_tpu.data.tokenizer import HashTokenizer as JHash
from dcr_tpu.diffusion.train import DiffusionModels as JModels
from dcr_tpu.models import schedulers as JS
from dcr_tpu.models.clip_text import CLIPTextModel as JCLIP
from dcr_tpu.models.unet2d import UNet2DCondition as JUNet
from dcr_tpu.models.vae import AutoencoderKL as JVAE
from dcr_tpu.parallel import mesh as pmesh
from dcr_tpu_torch.cli import train as train_cli
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.diffusion.trainer import Trainer
from dcr_tpu_torch.eval.gallery import image_grid
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.sampling.png import read_png, write_png


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tiny models run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL, RTOL = 2e-4, 1e-3


def _data(root, n=8):
    rng = np.random.default_rng(0)
    table = {}
    for i in range(n):
        d = root / f"c{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        write_png(d / f"{i}.png", rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
        table[str(d / f"{i}.png")] = [f"a photo about c{i % 2}/{i}", "second caption"]
    (root / "blip.json").write_text(json.dumps(table))
    return root


def _cfg(tmp_path, out: str, style: str = "classlevel", **kw) -> TC.TrainConfig:
    cfg = TC.TrainConfig(output_dir=str(tmp_path / out), train_batch_size=2,
                         max_train_steps=2, log_every=1, modelsavesteps=1000,
                         mixed_precision="no", seed=1, generation_seed=7, **kw)
    cfg.model = TC.ModelConfig.tiny()
    cfg.data = TC.DataConfig(train_data_dir=str(tmp_path / "data"), resolution=16,
                             num_workers=1, class_prompt=style)
    if style.startswith("instancelevel"):
        cfg.data.caption_jsons = (str(tmp_path / "data" / "blip.json"),)
        cfg.data.trainsubset = 5
    cfg.optim = TC.OptimConfig(learning_rate=1e-3, lr_scheduler="constant", lr_warmup_steps=0)
    return cfg


def _jax_trainer(trainer: Trainer, ema: bool) -> SimpleNamespace:
    """What the JAX hook reads of a JAX Trainer, over the port trainer's
    config (through its config.json), data and weights."""
    jcfg = JC.load_config(JC.TrainConfig, trainer.out_dir / "config.json")
    tok = JHash(jcfg.model.text_vocab_size, jcfg.model.text_max_length)
    s = trainer.state
    n_blocks = len(jcfg.model.block_out_channels)
    unet = EX.unet_to_flax(s.unet_params, n_blocks)
    return SimpleNamespace(
        cfg=jcfg, tokenizer=tok, dataset=JDataset(jcfg.data, tok),
        mesh=pmesh.make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1]),
        models=JModels(unet=JUNet(jcfg.model), vae=JVAE(jcfg.model),
                       text_encoder=JCLIP(jcfg.model), schedule=JS.make_schedule()),
        state=SimpleNamespace(
            unet_params=unet, vae_params=EX.vae_to_flax(s.vae_params),
            text_params=EX.text_to_flax(s.text_params, jcfg.model.text_heads),
            ema_params=EX.unet_to_flax(s.ema_params, n_blocks) if ema else None))


def _stub_sampler(*_a, **_kw):
    def fn(params, ids, uncond, key, *a, **kw):
        return np.zeros((len(ids), 16, 16, 3), np.float32)
    return fn


@pytest.mark.parametrize("style", ["classlevel", "instancelevel_blip", "nolevel"])
def test_prompts_equal_the_jax_hook(tmp_path, monkeypatch, style):
    _data(tmp_path / "data")
    trainer = Trainer(_cfg(tmp_path, "run", style), device="cpu")
    monkeypatch.setattr(JH, "make_sampler", _stub_sampler)
    monkeypatch.setattr(TH, "make_sampler", lambda *a, **kw: lambda m, ids, *r: torch.zeros(
        len(ids), 16, 16, 3))
    jtrainer = _jax_trainer(trainer, ema=False)
    jtrainer.cfg.output_dir = str(tmp_path / "jax")
    jhook, thook = JH.make_sample_hook(), TH.make_sample_hook()
    jhook(jtrainer, 3)
    thook(trainer, 3)
    assert thook.state["prompts"] == jhook.state["prompts"]
    np.testing.assert_array_equal(thook.state["ids"], jhook.state["ids"])
    np.testing.assert_array_equal(thook.state["uncond"], jhook.state["uncond"])
    expected = {"classlevel": ["An image of c0", "An image of c1"],
                "nolevel": ["an image"]}.get(style)
    if expected is None:         # first captions of the 5 active paths only
        ds = trainer.dataset
        active = {ds.prompts[ds.paths[i]][0] for i in ds.active_indices}
        assert len(active) == 5 and len(ds.paths) == 8
        assert len(thook.state["prompts"]) == 3 and set(thook.state["prompts"]) <= active
    else:
        assert thook.state["prompts"] == expected


def test_grid_images_equal_the_jax_hook_from_its_x_t(tmp_path, monkeypatch):
    _data(tmp_path / "data")
    trainer = Trainer(_cfg(tmp_path, "run", ema_decay=0.999), device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():       # EMA weights apart from the live ones
        for t in trainer.state.ema_params.values():
            t.add_(0.05 * torch.randn(t.shape, generator=g))
    jtrainer = _jax_trainer(trainer, ema=True)
    jtrainer.cfg.output_dir = str(tmp_path / "jax")
    step = 4
    key = JR.step_key(JR.stream_key(JR.root_key(7), "train_samples"), step)
    x_t = np.asarray(jax.random.normal(JR.stream_key(key, "init"), (8, 8, 8, 4)))
    images = {}

    def capture(make, name, **extra):
        def wrapped(*a, **kw):
            fn = make(*a, **kw)

            def run(*args):
                out = fn(*args, **extra)
                images[name] = np.asarray(out)
                return out
            return run
        return wrapped

    t_make = TH.make_sampler
    monkeypatch.setattr(JH, "make_sampler", capture(JH.make_sampler, "jax"))
    monkeypatch.setattr(TH, "make_sampler", capture(t_make, "port", init_latents=x_t))
    JH.make_sample_hook()(jtrainer, step)
    TH.make_sample_hook()(trainer, step)
    assert images["port"].shape == images["jax"].shape == (8, 16, 16, 3)
    np.testing.assert_allclose(images["port"], images["jax"], atol=ATOL, rtol=RTOL)
    mine = read_png(tmp_path / "run" / "generations" / f"step_{step}.png")
    theirs = read_png(tmp_path / "jax" / "generations" / f"step_{step}.png")
    assert mine.shape == theirs.shape == (2 * 16 + 2, 4 * 16 + 3 * 2, 3)
    assert np.abs(mine.astype(int) - theirs.astype(int)).max() <= 1
    # and the live UNet gives another grid: the hook sampled the EMA weights
    live = TH.make_sample_hook()
    monkeypatch.setattr(TH, "make_sampler", capture(t_make, "live", init_latents=x_t))
    trainer.state.ema_params = None
    live(trainer, step)
    assert np.abs(images["live"] - images["port"]).max() > 1e-3


@pytest.mark.parametrize("save_steps,expected", [(3, [3]), (2, [2, 4]), (0, [])])
def test_hook_fires_at_the_jax_syncs_under_accumulation(tmp_path, save_steps, expected):
    """Accumulation 2 over 4 optimizer steps (8 micro-steps): the JAX rule
    ``at_sync and sync % save_steps == 0`` (tests/test_trainer_e2e.py gives
    [3] for save_steps 3); ``save_steps=0`` writes no grid."""
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, "run", save_steps=save_steps)
    cfg.max_train_steps = 4
    cfg.optim.gradient_accumulation_steps = 2
    calls = []
    trainer = Trainer(cfg, sample_hook=lambda tr, s: calls.append((s, tr.state.step)),
                      device="cpu")
    trainer.train()
    assert [s for s, _ in calls] == expected
    assert all(micro == 2 * s for s, micro in calls)
    jax_rule = [m // 2 for m in range(1, 9) if m % 2 == 0 and save_steps
                and (m // 2) % save_steps == 0]
    assert jax_rule == expected


def test_cli_installs_the_hook_and_writes_grids(tmp_path, monkeypatch):
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, "cli", save_steps=1)
    TC.save_config(cfg, tmp_path / "cfg.json")
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    train_cli.main([f"--config={tmp_path / 'cfg.json'}"])
    gen = tmp_path / "cli" / "generations"
    assert sorted(p.name for p in gen.glob("*.png")) == ["step_1.png", "step_2.png"]
    grid = read_png(gen / "step_2.png")
    # classlevel over two classes: 2 prompts x 4 images at 16 px, 2 px apart
    layout = image_grid([np.zeros((16, 16, 3), np.float32)] * 8, cols=4)
    assert grid.shape == layout.shape == (34, 70, 3)


# ---------------------------------------------------------------------------
# copy-risk scoring of the grids (score_sample_grid)
# ---------------------------------------------------------------------------

def _risk_setup(tmp_path):
    """Two grid images, a dump of the port's SSCD (He-scaled Flax weights
    carried across, one torch file both packages read) over the first and
    two unrelated images, and a threshold midway between the copy's
    similarity and the other image's."""
    from dcr_tpu_torch.core.config import SearchConfig
    from dcr_tpu_torch.obs.copyrisk import CopyRiskIndex
    from dcr_tpu_torch.search.embed import embed_images
    from tests.test_torch_eval_runner import _he_scaled_sscd_params

    state = EX.sscd_from_flax(_he_scaled_sscd_params())
    torch.save(state, tmp_path / "sscd.pt")
    rng = np.random.default_rng(4)
    imgs = rng.random((2, 16, 16, 3)).astype(np.float32)
    train = tmp_path / "train"
    train.mkdir()
    for i, img in enumerate([imgs[0], *rng.random((2, 16, 16, 3))]):
        write_png(train / f"{i}.png", (img * 255).round().astype(np.uint8))
    dump = embed_images(SearchConfig(image_size=32, batch_size=4), source=train,
                        sscd_state=state, out_path=tmp_path / "train.npz", device="cpu")
    risk = TC.RiskConfig(index_path=str(dump), image_size=32,
                         weights_path=str(tmp_path / "sscd.pt"))
    hit, miss = (s.max_sim for s in CopyRiskIndex.load(risk, batch=2, device="cpu")
                 .score_batch(imgs))
    assert hit > 0.9999 and hit > miss + 1e-2, (hit, miss)
    risk.threshold = (hit + miss) / 2
    return imgs, risk


def test_score_sample_grid_writes_the_jax_hooks_gauges(tmp_path):
    """The same risk/* gauges as the JAX hook on the same grid: scored and
    flagged equal, similarities within 1e-3 (SSCD features at the f32 bar);
    the index loads once per hook state; the gauges reach the registry."""
    from dcr_tpu.core.metrics import MetricWriter as JWriter
    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.core.metrics import MetricWriter as TWriter

    imgs, risk = _risk_setup(tmp_path)
    jcfg = JC.TrainConfig()
    jcfg.risk = JC.RiskConfig(**dataclasses.asdict(risk))
    tcfg = TC.TrainConfig()
    tcfg.risk = risk
    jtrainer = SimpleNamespace(cfg=jcfg, writer=JWriter(tmp_path / "jax", use_tensorboard=False))
    ttrainer = SimpleNamespace(cfg=tcfg, writer=TWriter(tmp_path / "port"), device="cpu")
    jstate, tstate = {}, {}
    for step in (500, 1000):
        JH.score_sample_grid(jtrainer, jstate, step, imgs)
        TH.score_sample_grid(ttrainer, tstate, step, imgs)
        if step == 500:
            first = tstate["risk_index"]
    assert tstate["risk_index"] is first is not None
    jtrainer.writer.close()
    ttrainer.writer.close()
    rows = {}
    for name in ("jax", "port"):
        rows[name] = [json.loads(line) for line in
                      (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows["port"]] == [r["step"] for r in rows["jax"]] == [500, 1000]
    for mine, theirs in zip(rows["port"], rows["jax"]):
        assert {k for k in mine if k.startswith("risk/")} == {
            k for k in theirs if k.startswith("risk/")} == {
            "risk/max_sim", "risk/mean_sim", "risk/flagged", "risk/scored"}
        assert (mine["risk/scored"], mine["risk/flagged"]) == (theirs["risk/scored"],
                                                               theirs["risk/flagged"]) == (2, 1)
        for k in ("risk/max_sim", "risk/mean_sim"):
            assert abs(mine[k] - theirs[k]) <= 1e-3, (k, mine[k], theirs[k])
    assert tracing.registry().snapshot()["gauges"]["risk/max_sim"] == rows["port"][-1][
        "risk/max_sim"]


def test_score_sample_grid_degrades_to_a_counter(tmp_path):
    from dcr_tpu_torch.core import resilience as R

    bad = tmp_path / "embedding.npz"
    bad.write_bytes(b"garbage")
    cfg = TC.TrainConfig()
    cfg.risk = TC.RiskConfig(index_path=str(bad), image_size=32)
    written = []
    trainer = SimpleNamespace(cfg=cfg, device="cpu",
                              writer=SimpleNamespace(scalars=lambda *a: written.append(a)))
    before = R.bump_counter("copy_risk/index_load_failed", 0)
    state = {}
    TH.score_sample_grid(trainer, state, 3, np.zeros((2, 16, 16, 3), np.float32))
    assert state["risk_index"] is None and written == []
    assert R.bump_counter("copy_risk/index_load_failed", 0) == before + 1


def test_the_hook_scores_its_grids(tmp_path, monkeypatch):
    """With risk.index_path set, dcr-train's hook scores each grid into the
    trainer's metrics.jsonl."""
    _data(tmp_path / "data")
    _, risk = _risk_setup(tmp_path)
    cfg = _cfg(tmp_path, "run")
    cfg.risk = risk
    trainer = Trainer(cfg, device="cpu")
    monkeypatch.setattr(TH, "make_sampler", lambda *a, **kw: lambda m, ids, *r: torch.zeros(
        len(ids), 16, 16, 3))
    TH.make_sample_hook()(trainer, 3)
    trainer.writer.close()
    rows = [json.loads(line) for line in
            (tmp_path / "run" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["step"] == 3 and rows[-1]["risk/scored"] == 8
