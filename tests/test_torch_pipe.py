"""PyTorch port: pipelined training and the latent cache against the JAX
package (``dcr_tpu/diffusion/encode_stage.py``, ``dcr_tpu/data/latent_cache.py``,
``dcr_tpu/cli/precompute.py``), on the CPU at ``ModelConfig.tiny()``.

Held:
- the draw streams: producer + denoiser = the fused step's, disjoint, the
  JAX package's lists;
- the state views share storage;
- within the port, the fused step equals encode stage + denoise step bit
  for bit in f32 over 3 steps (also with the embedding mitigations and a
  trained text encoder), and the cache stage gives the live stage's
  latents bit for bit from the same moments (f32 and bf16);
- against the JAX package, with its draws injected: the encode stage's
  moments, latents and text embeddings and the denoise step's losses,
  grad norms and params at the f32 bars of ``test_torch_train.py``
  (moments within atol 2e-4, rtol 1e-3);
- the producer ring (order, bounded depth, errors, stop, the gauge);
- the cache: round trip, fingerprint mismatch, corrupt shard quarantined,
  ``latent_cache_corrupt@load=0``, corrupt and missing manifests, the
  recompute path; either package's cache opens in the other's reader, and
  ``params_digest`` is byte-equal;
- the Trainer: pipelined end to end with checkpoints and a pipelined
  resume (bit-equal to the fused run), a sample hook that runs the VAE and
  text encoder while the producer is paused (losses equal to a fused run
  with the same hook), a pipelined NaN rollback that never
  writes the frozen tensors, precompute -> cache-fed training within 1e-3
  of fused, a seed mismatch refused, a corrupt shard recomputed.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcr_tpu.core import rng as jrng
from dcr_tpu.core.config import MeshConfig
from dcr_tpu.data import latent_cache as JLC
from dcr_tpu.diffusion import encode_stage as JE
from dcr_tpu.diffusion import train as JT
from dcr_tpu.diffusion.trainer import build_modules
from dcr_tpu.parallel import mesh as pmesh
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.data import latent_cache as LC
from dcr_tpu_torch.diffusion import encode_stage as E
from dcr_tpu_torch.diffusion import train as TT
from dcr_tpu_torch.diffusion.trainer import Trainer
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.sampling.pipeline import build_models as t_build_models
from dcr_tpu_torch.sampling.png import write_png
from dcr_tpu_torch.utils import faults
from tests.test_torch_train import (LR, _batch, _jax_draws, _params, _port_cfg, _to_port,
                                    _train_cfg)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# streams and views
# ---------------------------------------------------------------------------

def test_stream_ownership_partitions_the_fused_streams_as_in_jax():
    producer, denoiser = set(E.PRODUCER_STREAMS), set(E.DENOISER_STREAMS)
    assert producer | denoiser == set(TT.DRAW_STREAMS)
    assert not producer & denoiser
    assert (E.PRODUCER_STREAMS, E.DENOISER_STREAMS) == (JE.PRODUCER_STREAMS,
                                                        JE.DENOISER_STREAMS)


def _port_state(tcfg, models, params: dict) -> TT.TrainState:
    """A train state over fresh copies of ``params`` (port state dicts)."""
    own = {g: {k: v.detach().clone() for k, v in sd.items()} for g, sd in params.items()}
    return TT.init_train_state(tcfg, models, unet_params=own["unet"],
                               text_params=own["text"], vae_params=own["vae"])


@pytest.mark.parametrize("tte", [False, True])
def test_split_and_merge_are_views(tte):
    tcfg = _port_cfg(_train_cfg(train_text_encoder=tte))
    models = t_build_models(tcfg.model, "cpu", seed=0)
    params = {"unet": dict(models.unet.named_parameters()),
              "text": dict(models.text_encoder.named_parameters()),
              "vae": dict(models.vae.named_parameters())}
    state = TT.init_train_state(tcfg, models, unet_params=params["unet"],
                                text_params=params["text"], vae_params=params["vae"])
    hot, frozen = E.split_state(state, tte)
    assert (hot.text_params is not None) == tte and (frozen["text"] is None) == tte
    merged = E.merge_state(hot, frozen, tte)
    ptr = lambda d: {k: t.data_ptr() for k, t in d.items()}
    for group in ("unet_params", "text_params", "vae_params"):
        assert ptr(getattr(merged, group)) == ptr(getattr(state, group))
    assert ptr(hot.unet_params) == ptr(dict(models.unet.named_parameters()))
    assert ptr(frozen["vae"]) == ptr(dict(models.vae.named_parameters()))
    assert merged.opt_state is state.opt_state and merged.step == state.step


# ---------------------------------------------------------------------------
# the split's numerics, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"rand_noise_lam": 0.5}, {"mixup_noise_lam": 0.3},
                                {"train_text_encoder": True}],
                         ids=["f32", "emb_noise", "mixup", "train_text_encoder"])
def test_fused_equals_encode_then_denoise_bit_for_bit(kw):
    cfg = _train_cfg(**kw)
    tcfg = _port_cfg(cfg)
    models = t_build_models(tcfg.model, "cpu", seed=0)
    params = {"unet": dict(models.unet.named_parameters()),
              "text": dict(models.text_encoder.named_parameters()),
              "vae": dict(models.vae.named_parameters())}
    batch = _batch(cfg)
    fused, fused_state = TT.make_train_step(tcfg, models), _port_state(tcfg, models, params)
    encode = E.make_encode_stage(tcfg, models)
    denoise = E.make_denoise_step(tcfg, models)
    pipe_state = _port_state(tcfg, models, params)
    hot, frozen = E.split_state(pipe_state, tcfg.train_text_encoder)
    for i in range(3):
        fused_state, fm = fused(fused_state, batch)
        enc = encode(frozen, batch, hot.step)
        assert ("ctx" in enc) != tcfg.train_text_encoder
        hot, pm = denoise(hot, enc)
        assert fm["loss"].item() == pm["loss"].item(), i
        assert fm["grad_norm"].item() == pm["grad_norm"].item() and fm["lr"] == pm["lr"]
    merged = E.merge_state(hot, frozen, tcfg.train_text_encoder)
    assert merged.step == fused_state.step == 3
    for group in ("unet_params", "text_params"):
        want, got = getattr(fused_state, group), getattr(merged, group)
        assert all(torch.equal(want[k], got[k]) for k in want), group
    assert all(torch.equal(fused_state.opt_state.nu[k], merged.opt_state.nu[k])
               for k in fused_state.opt_state.nu)


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_cache_stage_reproduces_live_latents_bit_for_bit(precision):
    tcfg = _port_cfg(_train_cfg(mixed_precision=precision))
    models = t_build_models(tcfg.model, "cpu", seed=0)
    frozen = {"vae": dict(models.vae.named_parameters()),
              "text": dict(models.text_encoder.named_parameters())}
    batch = _batch(tcfg)
    mom = E.make_encode_stage(tcfg, models, emit="moments")(frozen, batch, 0)
    live = E.make_encode_stage(tcfg, models)
    cache = E.make_cache_stage(tcfg, models)
    # the reader's rows: numpy f32 in the on-disk layout
    rows = {"mean": mom["mean"].permute(0, 2, 3, 1).numpy(),
            "std": mom["std"].permute(0, 2, 3, 1).numpy(),
            "ctx": mom["ctx"].float().numpy(), "index": mom["index"]}
    for step in (0, 7):
        got, want = cache(rows, step), live(frozen, batch, step)
        assert got["latents"].dtype == want["latents"].dtype == torch.float32
        assert torch.equal(got["latents"], want["latents"]), step
        assert got["ctx"].dtype == want["ctx"].dtype and torch.equal(got["ctx"], want["ctx"])
    assert not torch.equal(cache(rows, 0)["latents"], cache(rows, 1)["latents"])
    with pytest.raises(ValueError, match="frozen text encoder"):
        E.make_cache_stage(_port_cfg(_train_cfg(train_text_encoder=True)), models)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"train_text_encoder": True}], ids=["f32", "tte"])
def test_encode_and_denoise_match_jax(kw):
    cfg = _train_cfg(**kw)
    tte = cfg.train_text_encoder
    params, key = _params(cfg), jrng.root_key(0)
    jmodels = build_modules(cfg)
    mesh = pmesh.make_mesh(MeshConfig(), devices=jax.devices()[:1])
    p = jax.tree.map(lambda x: jnp.array(np.asarray(x)), params)
    jstate = JT.shard_train_state(JT.init_train_state(
        cfg, jmodels, unet_params=p["unet"], text_params=p["text"], vae_params=p["vae"]), mesh)
    jhot, jfrozen = JE.split_state(jstate, tte)
    tcfg = _port_cfg(cfg)
    tmodels = t_build_models(tcfg.model, "cpu")
    tp = _to_port(params, cfg)
    tstate = TT.init_train_state(tcfg, tmodels, unet_params=tp["unet"],
                                 text_params=tp["text"], vae_params=tp["vae"])
    hot, frozen = E.split_state(tstate, tte)
    batch = _batch(cfg)
    jbatch = pmesh.shard_batch(mesh, dict(batch))
    nchw = lambda x: torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)

    # the moments (the precompute's stage)
    jm = JE.make_encode_stage(cfg, jmodels, mesh, emit="moments")(jfrozen, jbatch, key,
                                                                 np.uint32(0))
    tm = E.make_encode_stage(tcfg, tmodels, emit="moments")(frozen, batch, 0)
    for name in ("mean", "std"):
        torch.testing.assert_close(tm[name], nchw(jm[name]), atol=2e-4, rtol=1e-3)
    if not tte:
        torch.testing.assert_close(tm["ctx"], torch.from_numpy(np.asarray(jm["ctx"])),
                                   atol=2e-4, rtol=1e-3)

    jencode = JE.make_encode_stage(cfg, jmodels, mesh)
    jdenoise = JE.make_denoise_step(cfg, jmodels, mesh)
    encode, denoise = E.make_encode_stage(tcfg, tmodels), E.make_denoise_step(tcfg, tmodels)
    steps = 2
    for i in range(steps):
        draws = _jax_draws(cfg, key, i)
        jenc = jencode(jfrozen, jbatch, key, np.uint32(i))
        enc = encode(frozen, batch, i, {"vae_sample": draws["vae_sample"]})
        torch.testing.assert_close(enc["latents"], nchw(jenc["latents"]), atol=2e-4,
                                   rtol=1e-3)
        assert ("input_ids" in enc) == ("input_ids" in jenc) == tte
        jhot, jmet = jdenoise(jhot, jenc, key)
        hot, met = denoise(hot, enc, {k: v for k, v in draws.items() if k != "vae_sample"})
        jmet = {k: float(v) for k, v in jax.device_get(jmet).items()}
        np.testing.assert_allclose(float(met["loss"]), jmet["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), jmet["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(met["lr"], jmet["lr"], rtol=1e-6, atol=1e-12)
    assert hot.step == int(jax.device_get(jhot.step)) == steps
    jhot = jax.device_get(jhot)
    pairs = [(EX.unet_from_flax(jhot.unet_params, len(cfg.model.block_out_channels)),
              hot.unet_params)]
    if tte:
        pairs.append((EX.text_from_flax(jhot.text_params), hot.text_params))
    for want, got in pairs:
        diff = max((want[k] - got[k].detach()).abs().max().item() for k in want)
        assert diff <= 1e-2 * LR * steps, diff


# ---------------------------------------------------------------------------
# the producer ring
# ---------------------------------------------------------------------------

def _ring(batches, encode, depth=2, start=0):
    return E.EncodeProducer(iter(batches), encode, depth=depth, start_step=start)


def test_producer_ring_orders_and_terminates():
    seen = []

    def encode(batch, step):
        seen.append(step)
        return {"v": batch, "step": step}

    p = _ring(list(range(5)), encode, depth=2, start=3)
    try:
        for i in range(5):
            assert p.get(3 + i) == {"v": i, "step": 3 + i}
        assert p.get(8) is None
        assert seen == [3, 4, 5, 6, 7] and len(p.wait_s) == 6
        with pytest.raises(RuntimeError, match="out of order"):
            q = _ring([0, 1], encode)
            try:
                q.get(1)
            finally:
                q.stop()
    finally:
        p.stop()


def test_producer_ring_bounded_depth_and_pause():
    encoded = []

    def encode(batch, step):
        encoded.append(step)
        return step

    p = _ring(list(range(32)), encode, depth=2)
    try:
        time.sleep(0.5)
        assert len(encoded) <= 3          # 2 in the ring + 1 blocked in put
        with p.paused():
            n = len(encoded)
            assert p.get(0) == 0
            time.sleep(0.3)
            assert len(encoded) == n      # no encode while paused
        for i in range(1, 32):
            assert p.get(i) == i
    finally:
        p.stop()


def test_producer_ring_propagates_errors():
    def encode(batch, step):
        if step == 2:
            raise RuntimeError("encoder exploded")
        return step

    p = _ring(list(range(5)), encode)
    try:
        assert p.get(0) == 0 and p.get(1) == 1
        with pytest.raises(RuntimeError, match="encoder exploded"):
            p.get(2)
    finally:
        p.stop()


def test_producer_ring_stop_mid_stream_and_gauge():
    def source():
        yield from range(100)

    gen = source()
    p = E.EncodeProducer(gen, lambda b, s: s, depth=3, start_step=0)
    assert p.get(0) == 0
    p.stop()
    p.stop()                              # idempotent
    assert not p._thread.is_alive()
    gen.close()                           # the thread no longer runs it
    assert 0 <= tracing.registry().gauge("data/queue_depth").value <= 3


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,match", [
    (["--pipe.depth=0"], "depth"),
    (["--pipe.cache_shard_size=0"], "cache_shard_size"),
    (["--pipe.latent_cache=c", "--train_text_encoder=true"], "train_text_encoder"),
    (["--pipe.latent_cache=c", "--data.random_flip=false",
      "--data.class_prompt=instancelevel_blip", "--data.trainspecial=allcaps"], "trainspecial"),
    (["--pipe.latent_cache=c", "--data.random_flip=false",
      "--data.duplication=dup_image"], "dup_image"),
    (["--pipe.latent_cache=c"], "random_flip"),
    (["--pipe.latent_cache=c", "--data.random_flip=false",
      "--data.center_crop=false"], "center_crop"),
    (["--pipe.latent_cache=c", "--data.random_flip=false"], None),
    (["--pipe.enabled=true", "--pipe.depth=3", "--data.duplication=dup_image"], None),
], ids=lambda a: "_".join(a) if isinstance(a, list) else str(a))
def test_pipe_config_validation_as_in_jax(argv, match):
    """Every ValueError of validate_pipe_config fires as the JAX package's
    does, and the valid pipelined configs raise nothing (no NotPortedError)."""
    from dcr_tpu.core import config as JC

    jcfg, tcfg = JC.parse_cli(JC.TrainConfig, argv), TC.parse_cli(TC.TrainConfig, argv)
    if match is None:
        JC.validate_train_config(jcfg)
        TC.validate_train_config(tcfg)
        return
    for validate, cfg in ((JC.validate_train_config, jcfg), (TC.validate_train_config, tcfg)):
        with pytest.raises(ValueError, match=match):
            validate(cfg)


# ---------------------------------------------------------------------------
# the latent cache
# ---------------------------------------------------------------------------

def _write_cache(root, n=10, shard_size=4, fp=None):
    fp = fp or {"version": 1, "test": "roundtrip"}
    w = LC.LatentCacheWriter(root, fp, shard_size=shard_size)
    rng = np.random.default_rng(0)
    mean = rng.standard_normal((n, 2, 2, 4)).astype(np.float32)
    std = np.abs(rng.standard_normal((n, 2, 2, 4))).astype(np.float32)
    ctx = rng.standard_normal((n, 3, 8)).astype(np.float32)
    idx = np.arange(100, 100 + n, dtype=np.int64)
    w.add(idx[:3], mean[:3], std[:3], ctx[:3])
    w.add(idx[3:], mean[3:], std[3:], ctx[3:])
    w.finalize()
    return fp, idx, mean, std, ctx


def test_latent_cache_round_trip_multi_shard(tmp_path):
    fp, idx, mean, std, ctx = _write_cache(tmp_path, n=10, shard_size=4)
    assert len(list(tmp_path.glob("shard_*.npz"))) == 3
    r = LC.LatentCacheReader(tmp_path, fp)
    assert r.coverage() == (10, 10)
    got = r.lookup(np.asarray([103, 100, 109]))
    for a, b in zip(got, (mean, std, ctx)):
        np.testing.assert_array_equal(a, b[[3, 0, 9]])
    assert r.lookup(np.asarray([100, 555])) is None


def test_latent_cache_fingerprint_mismatch(tmp_path):
    fp, *_ = _write_cache(tmp_path)
    before = R.counters().get("latentcache/fingerprint_mismatch", 0)
    with pytest.raises(LC.LatentCacheError, match="different run.*test"):
        LC.LatentCacheReader(tmp_path, dict(fp, test="other"))
    assert R.counters()["latentcache/fingerprint_mismatch"] == before + 1


def test_latent_cache_corrupt_shard_quarantined(tmp_path):
    fp, idx, mean, *_ = _write_cache(tmp_path)
    shard = tmp_path / "shard_00001.npz"
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    r = LC.LatentCacheReader(tmp_path, fp)
    assert not shard.exists()
    assert any("quarantined" in p.name for p in tmp_path.iterdir())
    assert r.lookup(np.asarray([104])) is None
    np.testing.assert_array_equal(r.lookup(np.asarray([100, 109]))[0], mean[[0, 9]])
    assert r.coverage() == (6, 10)


def test_latent_cache_corrupt_fault_kind(tmp_path):
    fp, *_ = _write_cache(tmp_path)
    before = R.counters().get("latentcache/shard_corrupt", 0)
    faults.install("latent_cache_corrupt@load=0")
    try:
        r = LC.LatentCacheReader(tmp_path, fp)
    finally:
        faults.clear()
    assert not (tmp_path / "shard_00000.npz").exists()
    assert r.lookup(np.asarray([100])) is None and r.coverage()[0] == 6
    assert R.counters()["latentcache/shard_corrupt"] == before + 1


def test_latent_cache_corrupt_and_missing_manifest(tmp_path):
    _write_cache(tmp_path)
    (tmp_path / "manifest.json").write_text("{not json")
    with pytest.raises(LC.LatentCacheError, match="corrupt"):
        LC.LatentCacheReader(tmp_path)
    assert any("quarantined" in p.name for p in tmp_path.iterdir())
    with pytest.raises(LC.LatentCacheError, match="precompute"):
        LC.LatentCacheReader(tmp_path / "nope")
    # every shard damaged: nothing to serve is an error, not a slow run
    fp, *_ = _write_cache(tmp_path / "all", n=4, shard_size=4)
    (tmp_path / "all" / "shard_00000.npz").write_bytes(b"\0" * 64)
    with pytest.raises(LC.LatentCacheError, match="no shard survived"):
        LC.LatentCacheReader(tmp_path / "all", fp)


def test_cached_encode_falls_back_on_miss(tmp_path):
    fp, *_ = _write_cache(tmp_path, n=4, shard_size=4)
    r = LC.LatentCacheReader(tmp_path, fp)
    calls = {"cache": 0, "live": 0}

    def cache_fn(moments, step):
        calls["cache"] += 1
        assert moments["mean"].shape == (2, 2, 2, 4)
        return {"from": "cache"}

    def fallback(batch, step):
        calls["live"] += 1
        return {"from": "live"}

    enc = E.cached_encode(cache_fn, r, fallback)
    before = R.counters().get("latentcache/batch_recompute", 0)
    assert enc({"index": np.asarray([100, 101])}, 0) == {"from": "cache"}
    assert enc({"index": np.asarray([100, 999])}, 1) == {"from": "live"}
    assert R.counters()["latentcache/batch_recompute"] == before + 1
    assert calls == {"cache": 1, "live": 1}


# ---------------------------------------------------------------------------
# interop with the JAX package's cache
# ---------------------------------------------------------------------------

def _data(root, n=16, size=16):
    rng = np.random.default_rng(0)
    for i in range(n):
        d = root / f"c{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        write_png(d / f"{i}.png", rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    return root


def _pipe_cfg(tmp_path, out, **pipe) -> TC.TrainConfig:
    return TC.TrainConfig(
        output_dir=str(tmp_path / out), seed=0, train_batch_size=2, max_train_steps=6,
        num_train_epochs=10, mixed_precision="no", save_steps=1000, modelsavesteps=4,
        log_every=2, model=TC.ModelConfig.tiny(),
        data=TC.DataConfig(train_data_dir=str(tmp_path / "data"), resolution=16,
                           class_prompt="nolevel", num_workers=2, seed=0, random_flip=False),
        optim=TC.OptimConfig(learning_rate=1e-4, lr_scheduler="constant",
                             lr_warmup_steps=0),
        pipe=TC.PipeConfig(**pipe))


def _jax_cfg(cfg: TC.TrainConfig):
    from dcr_tpu.core import config as JC

    return JC.from_dict(JC.TrainConfig, dataclasses.asdict(cfg))


def test_params_digest_equals_jax_byte_for_byte():
    cfg = _train_cfg()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), _params(cfg))
    for name in ("vae", "text"):
        assert LC.params_digest(params[name]) == JLC.params_digest(params[name])
    vae_sha, text_sha = LC.frozen_digests(EX.vae_from_flax(params["vae"]),
                                          EX.text_from_flax(params["text"]),
                                          cfg.model.text_heads)
    assert (vae_sha, text_sha) == (JLC.params_digest(params["vae"]),
                                   JLC.params_digest(params["text"]))
    assert LC.params_digest({"a": {"b": np.zeros(2, np.float32)}}) != LC.params_digest(
        {"a": {"c": np.zeros(2, np.float32)}})


def test_latent_cache_opens_in_either_package(tmp_path):
    """The JAX package's precompute and the port's, over the same weights
    and dataset: equal fingerprints, each cache opens in the other's reader
    with its rows as written, and the two caches' rows agree at the f32 bar."""
    from dcr_tpu.cli.precompute import precompute as jprecompute
    from dcr_tpu.diffusion.trainer import build_models as jbuild_models
    from dcr_tpu_torch.cli.precompute import precompute

    _data(tmp_path / "data")
    cfg = _pipe_cfg(tmp_path, "unused", latent_cache=str(tmp_path / "jax_cache"),
                    cache_shard_size=6)
    jcfg = _jax_cfg(cfg)
    jsummary = jprecompute(jcfg)
    _, jparams = jbuild_models(jcfg, jrng.stream_key(jrng.root_key(cfg.seed), "init"))
    frozen = {k: jax.tree.map(lambda x: np.asarray(x), jparams[k]) for k in ("vae", "text")}
    pcfg = dataclasses.replace(cfg, pipe=TC.PipeConfig(latent_cache=str(tmp_path / "port"),
                                                       cache_shard_size=6))
    summary = precompute(pcfg, pretrained_params=frozen, device="cpu")
    assert summary["indices"] == jsummary["indices"] == 16
    assert summary["shards"] == jsummary["shards"] == 3 and summary["bytes"] > 0
    jfp = json.loads((tmp_path / "jax_cache" / "manifest.json").read_text())["fingerprint"]
    fp = json.loads((tmp_path / "port" / "manifest.json").read_text())["fingerprint"]
    assert fp == jfp
    # each package's reader over the other's cache, keyed on its own fingerprint
    port_reads_jax = LC.LatentCacheReader(tmp_path / "jax_cache", fp)
    jax_reads_port = JLC.LatentCacheReader(tmp_path / "port", jfp)
    jax_reads_jax = JLC.LatentCacheReader(tmp_path / "jax_cache", jfp)
    port_reads_port = LC.LatentCacheReader(tmp_path / "port", fp)
    idx = np.arange(16)[::-1]
    for a, b in zip(port_reads_jax.lookup(idx), jax_reads_jax.lookup(idx)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax_reads_port.lookup(idx), port_reads_port.lookup(idx)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port_reads_port.lookup(idx), jax_reads_jax.lookup(idx)):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _losses(run) -> list[float]:
    return [json.loads(x)["loss"] for x in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def fused_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_trainer")
    _data(tmp / "data")
    t = Trainer(_pipe_cfg(tmp, "fused"), device="cpu")
    metrics = t.train()
    return tmp, t, metrics


def test_trainer_pipelined_end_to_end_and_resume(fused_run):
    tmp, fused, _ = fused_run
    assert not fused.pipelined
    t = Trainer(_pipe_cfg(tmp, "pipe", enabled=True, depth=2), device="cpu")
    assert t.pipelined and t.step_fn == t._pipelined_step
    t.train()
    # the same draws and ops as the fused run: bit for bit
    assert _losses(tmp / "pipe") == _losses(tmp / "fused")
    for k, p in fused.state.unet_params.items():
        assert torch.equal(p, t.state.unet_params[k]), k
    assert t.ckpt.all_steps() == [4, 6] and t.producer is not None
    assert not t.producer._thread.is_alive() and len(t.ring_wait_s) == 6
    cfg2 = _pipe_cfg(tmp, "pipe", enabled=True)
    cfg2.max_train_steps = 8
    t2 = Trainer(cfg2, device="cpu")
    t2.train()
    assert t2.pipelined and t2.state.step == 8 and 8 in t2.ckpt.all_steps()
    assert len(t2.ring_wait_s) == 2       # resumed at step 6


def test_sample_hook_runs_with_the_producer_paused(fused_run):
    tmp, _, _ = fused_run
    in_hook = threading.Event()
    overlaps, hook_calls = [], []

    def hook(trainer, sync):
        in_hook.set()
        try:
            hook_calls.append(sync)
            g = torch.Generator().manual_seed(sync)
            pixels = torch.rand(2, 3, 16, 16, generator=g) * 2 - 1
            ids = torch.randint(0, 100, (2, trainer.cfg.model.text_max_length), generator=g)
            with torch.no_grad():
                assert torch.isfinite(trainer.models.vae.encode(pixels).mean).all()
                assert torch.isfinite(
                    trainer.models.text_encoder(ids).last_hidden_state).all()
            time.sleep(0.2)               # room for a producer that is not paused
        finally:
            in_hook.clear()

    def run(out, **pipe) -> Trainer:
        cfg = _pipe_cfg(tmp, out, **pipe)
        cfg.save_steps = 2
        t = Trainer(cfg, sample_hook=hook, device="cpu")
        if t.pipelined:
            encode_fn = t.encode_fn

            def slow_encode(frozen, batch, step):
                time.sleep(0.05)          # the consumer waits on the ring
                overlaps.append(in_hook.is_set())
                enc = encode_fn(frozen, batch, step)
                overlaps.append(in_hook.is_set())
                return enc
            t.encode_fn = slow_encode
        t.train()
        return t

    run("hook_fused")
    assert hook_calls == [2, 4, 6]
    hook_calls.clear()
    t = run("hook_pipe", enabled=True, depth=4)
    assert hook_calls == [2, 4, 6] and len(overlaps) >= 2 * 6
    assert not any(overlaps), "the producer encoded while the sample hook ran"
    assert _losses(tmp / "hook_pipe") == _losses(tmp / "hook_fused")
    assert not t.producer._thread.is_alive()


def test_pipelined_nan_rollback_never_writes_the_frozen_tensors(fused_run):
    tmp, _, _ = fused_run
    cfg = _pipe_cfg(tmp, "nanpipe", enabled=True)
    cfg.log_every, cfg.modelsavesteps = 1, 2
    cfg.fault.max_rollbacks = 1
    faults.install("nan_loss@step=3")
    try:
        t = Trainer(cfg, device="cpu")
        frozen = [*t.state.vae_params.values(), *t.state.text_params.values()]
        versions = [p._version for p in frozen]
        unet_versions = [p._version for p in t.state.unet_params.values()]
        m = t.train()
    finally:
        faults.clear()
    assert np.isfinite(m["loss"]) and t._rollbacks == 1 and t.state.step == 6
    assert "nan_rollback" in (tmp / "nanpipe" / "quarantine.jsonl").read_text()
    assert [p._version for p in frozen] == versions
    # the hot params were restored (and trained) in place
    assert all(p._version > v for p, v in zip(t.state.unet_params.values(), unet_versions))


def test_precompute_then_cache_fed_training(fused_run, monkeypatch, capsys):
    from dcr_tpu_torch.cli import precompute as precompute_cli

    tmp, _, fused_metrics = fused_run
    cache = tmp / "lcache"
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    pcfg = _pipe_cfg(tmp, "pre")
    TC.save_config(pcfg, tmp / "pre.json")
    precompute_cli.main([f"--config={tmp / 'pre.json'}", f"--pipe.latent_cache={cache}",
                         "--pipe.cache_shard_size=4"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["indices"] == 16 and summary["shards"] == 4
    assert len(list(cache.glob("shard_*.npz"))) == 4

    t = Trainer(_pipe_cfg(tmp, "cache", latent_cache=str(cache)), device="cpu")
    assert t.pipelined
    encoder_calls = []
    t.models.vae.encoder.register_forward_pre_hook(lambda m, a: encoder_calls.append(1))
    before = R.counters().get("latentcache/batch_recompute", 0)
    m = t.train()
    assert encoder_calls == [] and t._cache_reader.coverage() == (16, 16)
    assert R.counters().get("latentcache/batch_recompute", 0) == before
    assert abs(m["loss"] - fused_metrics["loss"]) <= 1e-3 * abs(fused_metrics["loss"])
    np.testing.assert_allclose(_losses(tmp / "cache"), _losses(tmp / "fused"), rtol=1e-3)

    bad = _pipe_cfg(tmp, "badcache", latent_cache=str(cache))
    bad.seed = 1                          # other frozen params
    with pytest.raises(LC.LatentCacheError, match="vae_sha"):
        Trainer(bad, device="cpu").train()

    shard = next(cache.glob("shard_*.npz"))
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    t3 = Trainer(_pipe_cfg(tmp, "cache2", latent_cache=str(cache)), device="cpu")
    m3 = t3.train()
    assert np.isfinite(m3["loss"]) and t3._cache_reader.coverage() == (12, 16)
    assert any("quarantined" in p.name for p in cache.iterdir())
    assert R.counters()["latentcache/batch_recompute"] > before
