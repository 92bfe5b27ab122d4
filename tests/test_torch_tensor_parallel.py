"""PyTorch port: Megatron-style tensor parallelism (``models/layers.py``
over ``parallel/sharded``) and sampling over a mesh, against the JAX
package.

- The f32 train step as gloo ranks on ``tensor = 2`` (two ranks, each all
  four rows) and ``fsdp = 2 x tensor = 2`` (four ranks, two rows each)
  against the JAX step on a mesh of the same shape, at
  ``tests/test_torch_dist.py``'s bars (the bf16 case runs on ``fsdp = 2``,
  ``tests/test_torch_fsdp.py``). The tiny config's first level has one head of 16 (``tensor``
  divides its columns, not its heads: the columns are gathered), its second
  eight (each rank runs four); the VAE's attention has one head.
- ``sampling.pipeline.generate`` on ``tensor = 2``, on ``seq = 2`` (ring
  attention in the UNet) and on ``fsdp = 2`` (the rows split over the
  ranks) as two ranks against the JAX ``generate`` on meshes with those
  axes, each image from the JAX pipeline's own x_T (DDIM,
  deterministic from there): within 1 uint8 LSB, the bar of
  ``tests/test_sampling_pipeline.py``; the primary writes every PNG and
  the prompts.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dcr_tpu.core import rng as jrng
from dcr_tpu.core.checkpoint import export_hf_layout
from dcr_tpu.core.config import MeshConfig, SampleConfig as JSampleConfig
from dcr_tpu.data.tokenizer import HashTokenizer as JHash
from dcr_tpu.sampling.pipeline import generate as j_generate
from dcr_tpu_torch.core import config as TC
from tests._torch_ranks import Ranks, check
from tests.test_torch_dist import assert_step_matches, run_steps
from tests.test_torch_fsdp import mesh_model
from tests.test_torch_train import _params, _train_cfg

TP_RUNS = {"tensor": (dict(tensor=2), dict(ema_decay=0.9), 2, 2),
           "fsdp_tensor": (dict(fsdp=2, tensor=2), dict(train_text_encoder=True), 1, 4)}


def _tp_cfg(name):
    mesh, kw, _, _ = TP_RUNS[name]
    cfg = _train_cfg(model=mesh_model(), **kw)
    cfg.mesh = MeshConfig(data=1, **mesh)
    return cfg


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    runs = {name: (_tp_cfg(name), steps) for name, (_, _, steps, _) in TP_RUNS.items()}
    worlds = {name: world for name, (_, _, _, world) in TP_RUNS.items()}
    return runs, run_steps(tmp_path_factory.mktemp("tp"), runs, worlds)


@pytest.mark.parametrize("name", list(TP_RUNS))
def test_tensor_parallel_step_matches_jax_on_the_same_mesh(tp_runs, name):
    """Every rank's loss, grad norm and lr against the JAX step's; the
    gathered parameters against JAX's; the projections held as shards,
    the Megatron exchanges taken."""
    runs, results = tp_runs
    (cfg, steps), (jstate, jhist, ranks) = runs[name], results[name]
    assert_step_matches(jstate, jhist, ranks, cfg, steps)
    shapes, whole = ranks[0]["shapes"], ranks[0]["unet"]
    attn = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    ff = "up_blocks.1.attentions.0.transformer_blocks.0.ff"
    assert shapes[f"{attn}.to_q.weight"] == (8, 16)         # one head's columns, halved
    assert shapes[f"{attn}.to_out.0.weight"] == (16, 8)
    assert shapes[f"{ff}.net.0.proj.weight"] == (64, 16)    # GEGLU's 128 columns, halved
    assert shapes[f"{ff}.net.2.weight"] == (16, 32)
    assert tuple(whole[f"{ff}.net.2.weight"].shape) == (16, 64)
    ex = ranks[0]["exchanges"]
    assert ex["tp_all_reduce"]["calls"] > 0 and ex["tp_all_gather"]["calls"] > 0
    # the replicated gradients are not reduced over tensor: without data or
    # fsdp ranks to average, only the loss and grad norm exchanges run
    if cfg.mesh.fsdp == 1:
        assert "all_reduce" not in ex
    if name == "fsdp_tensor":
        assert ex["fsdp_gather"]["calls"] > 0


# ---------------------------------------------------------------------------
# generate over a mesh
# ---------------------------------------------------------------------------

GEN = dict(num_batches=3, im_batch=2, resolution=16, num_inference_steps=3, sampler="ddim",
           seed=0)


def _jax_x_t(cfg: JSampleConfig, n_images: int, model_cfg) -> np.ndarray:
    """The x_T of each image the JAX ``generate`` draws over the 8 CPU
    devices: per device batch of 8 rows from its batch key, the real rows
    in order."""
    per = max(1, len(jax.devices()) // cfg.im_batch)
    batch = per * cfg.im_batch
    lat = cfg.resolution // 2 ** (len(model_cfg.vae_block_out_channels) - 1)
    key = jrng.root_key(cfg.seed)
    out = []
    for start in range(0, cfg.num_batches, per):
        bkey = jrng.step_key(jrng.stream_key(key, "sample"), start)
        x = jax.random.normal(jrng.stream_key(bkey, "init"),
                              (batch, lat, lat, model_cfg.vae_latent_channels))
        real = min(per, cfg.num_batches - start) * cfg.im_batch
        out.append(np.asarray(x)[:real])
    return np.concatenate(out)[:n_images]


def _export(run, model_cfg):
    """An HF-layout checkpoint of seeded params (no JAX init compile)."""
    from dcr_tpu.core.config import to_dict

    params = _params(_train_cfg(model=model_cfg))
    export_hf_layout(run / "checkpoint", unet=params["unet"], vae=params["vae"],
                     text_encoder=params["text"], model_config=to_dict(model_cfg))


@pytest.mark.parametrize("axis", ["tensor", "seq", "fsdp"])
def test_generate_over_a_mesh_matches_jax_within_one_lsb(axis, tmp_path):
    """The ranks' exchanges show the mesh's path ran: the Megatron
    all-reduces, the ring's K/V hops (seq_parallel_min_seq 64 at 32 px puts
    the UNet's first level on the ring), or FSDP's gathers with the device
    batch's rows split over the two ranks and gathered back."""
    from dcr_tpu.core.config import ModelConfig

    model_cfg = (dataclasses.replace(ModelConfig.tiny(), seq_parallel_min_seq=64)
                 if axis == "seq" else mesh_model())
    res = 16 if axis == "tensor" else 32
    run = tmp_path / "run"
    _export(run, model_cfg)
    common = dict(GEN, model_path=str(run), resolution=res)
    tok = (model_cfg.text_vocab_size, model_cfg.text_max_length)
    port_cfg = TC.SampleConfig(**common, savepath=str(tmp_path / "port"),
                               mesh=TC.MeshConfig(data=1, **{axis: 2}))
    jcfg = JSampleConfig(**common, savepath=str(tmp_path / "jax"),
                         mesh=MeshConfig(data=-1, **{axis: 2}))
    n = GEN["num_batches"] * GEN["im_batch"]
    np.save(tmp_path / "x_t.npy", _jax_x_t(jcfg, n, model_cfg))
    args = {"cfg": dataclasses.asdict(port_cfg), "tokenizer": tok}
    ranks = Ranks("generate", 2, tmp_path, args)
    j_generate(jcfg, modelstyle="classlevel", tokenizer=JHash(*tok))
    check(ranks.wait())
    want = sorted((tmp_path / "jax" / "generations").glob("*.png"))
    got = sorted((tmp_path / "port" / "generations").glob("*.png"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == n
    for a, b in zip(got, want):
        with Image.open(a) as ia, Image.open(b) as ib:
            diff = np.abs(np.asarray(ia).astype(np.int16) - np.asarray(ib).astype(np.int16))
        assert diff.max() <= 1, (a.name, diff.max())
    assert ((tmp_path / "port" / "prompts.txt").read_text()
            == (tmp_path / "jax" / "prompts.txt").read_text())
    exchanges = torch.load(tmp_path / "exchanges_0.pt")
    path = {"tensor": "tp_all_reduce", "seq": "ppermute", "fsdp": "fsdp_gather"}[axis]
    assert exchanges[path]["calls"] > 0
    if axis == "fsdp":
        assert exchanges["all_gather"]["calls"] > 0  # the images' rows


@pytest.mark.parametrize("cli", ["sample", "mitigate"])
def test_the_sampling_clis_take_mesh_flags(cli, tmp_path, monkeypatch):
    """``--mesh.*`` reaches ``generate``'s mesh (one process cannot hold a
    tensor = 2 mesh, and the mesh says so); ``--warm.*`` reaches its
    ``warm`` section since the warm cache was ported. The CLIs' logging
    set-up is left out: ``force=True`` would leave the root logger writing
    to this test's captured stderr."""
    import importlib
    import logging

    module = importlib.import_module(f"dcr_tpu_torch.cli.{cli}")
    main = module.main
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: None)
    with pytest.raises(ValueError, match="mesh 1x1x2x1 != 1 devices"):
        main([f"--model_path={tmp_path}", "--mesh.data=1", "--mesh.tensor=2"])
    seen = []
    monkeypatch.setattr(module, "generate", lambda cfg, **kw: seen.append(cfg) or tmp_path)
    main([f"--model_path={tmp_path}", "--warm.dir=w", "--warm.warm_start=false"])
    assert (seen[0].warm.dir, seen[0].warm.warm_start) == ("w", False)
