"""PyTorch port: the serving slice (``dcr_tpu_torch.serve``,
``dcr_tpu_torch.cli.serve``) against the JAX package's ``dcr_tpu.serve``,
on the CPU at a tiny model, 16 px, 2-5 steps and ``max_batch`` 2.

- the batch sampler against the JAX ``make_batch_sampler`` on the same
  weights (``models/export``'s ``*_from_flax`` bridges), the JAX package's
  threefry draws (x_T, the embedding noise, DDPM's per-step noise, each per
  row) computed here and injected: images within atol 1e-4, the bulk
  sampler's bar (``tests/test_torch_sampling.py``);
- a request alone and inside a mixed batch gives the same image bit for bit
  in the port (dpm++ with embedding noise, ddpm);
- queue, batcher, cache, ``validate_bucket``, ``request_bucket`` and
  ``admission_response`` give the JAX modules' results on the same call
  sequences (the fast cases of ``tests/test_serve.py``, through both
  packages);
- ``GenerationService`` through its worker thread, the HTTP front end on
  port 0 (documents with the JAX package's keys), copy-risk scoring of a
  planted copy, and ``dcr-serve-torch`` as a subprocess on the CPU drained
  by SIGTERM with exit code 83;
- every serve setting the port does not run (a mesh) raises
  ``NotPortedError`` naming its ROADMAP item; the fleet's roles, the batch
  watchdog and the warm cache validate as in the JAX package, and with
  ``warm.dir`` a service records its buckets in ``warm_manifest.json`` and
  the next one plans them.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import dcr_tpu.core.metrics as JM  # noqa: E402
import dcr_tpu.serve.batcher as JB  # noqa: E402
import dcr_tpu.serve.cache as JCa  # noqa: E402
import dcr_tpu.serve.queue as JQ  # noqa: E402
import dcr_tpu.serve.server as JS  # noqa: E402
import dcr_tpu.serve.worker as JW  # noqa: E402
import dcr_tpu_torch.core.metrics as TM  # noqa: E402
import dcr_tpu_torch.serve.batcher as TB  # noqa: E402
import dcr_tpu_torch.serve.cache as TCa  # noqa: E402
import dcr_tpu_torch.serve.queue as TQ  # noqa: E402
import dcr_tpu_torch.serve.server as TS  # noqa: E402
import dcr_tpu_torch.serve.worker as TW  # noqa: E402
from dcr_tpu.core import config as JC  # noqa: E402
from dcr_tpu.core import rng as JR  # noqa: E402
from dcr_tpu.core.checkpoint import export_hf_layout  # noqa: E402
from dcr_tpu.data.tokenizer import HashTokenizer as JHash  # noqa: E402
from dcr_tpu.diffusion.train import DiffusionModels as JModels  # noqa: E402
from dcr_tpu.models import schedulers as JSch  # noqa: E402
from dcr_tpu.models.clip_text import CLIPTextModel as JCLIP, init_clip_text  # noqa: E402
from dcr_tpu.models.unet2d import UNet2DCondition as JUNet, init_unet  # noqa: E402
from dcr_tpu.models.vae import AutoencoderKL as JVAE, init_vae  # noqa: E402
from dcr_tpu.sampling.pipeline import GenerationStack as JStack  # noqa: E402
from dcr_tpu_torch.core import config as TC  # noqa: E402
from dcr_tpu_torch.core import resilience as R  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.core import warmcache  # noqa: E402
from dcr_tpu_torch.data.tokenizer import HashTokenizer as THash  # noqa: E402
from dcr_tpu_torch.models import export as EX  # noqa: E402
from dcr_tpu_torch.sampling import pipeline as TPipe  # noqa: E402
from dcr_tpu_torch.sampling.png import decode_png, encode_png  # noqa: E402
from tests.test_torch_models import jax_params, port_cfg, tiny_cfg  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny stack with numpy-filled params, and the port's stack on
    the CPU carrying the same weights."""
    cfg = tiny_cfg(sample_size=8)
    params = {"unet": jax_params(init_unet, cfg, 31),
              "vae": jax_params(init_vae, cfg, 32),
              "text": jax_params(init_clip_text, cfg, 33)}
    jmodels = JModels(unet=JUNet(cfg), vae=JVAE(cfg), text_encoder=JCLIP(cfg),
                      schedule=JSch.make_schedule())
    tmodels = TPipe.build_models(port_cfg(cfg), device="cpu")
    TPipe.load_params(tmodels, {
        "unet": EX.unet_from_flax(params["unet"], len(cfg.block_out_channels)),
        "vae": EX.vae_from_flax(params["vae"]),
        "text": EX.text_from_flax(params["text"])})
    jtok = JHash(cfg.text_vocab_size, cfg.text_max_length)
    ttok = THash(cfg.text_vocab_size, cfg.text_max_length)
    jstack = JStack(jmodels, params, cfg, jtok, None)
    tstack = TPipe.GenerationStack(tmodels, port_cfg(cfg), ttok, torch.device("cpu"))
    return SimpleNamespace(cfg=cfg, params=params, jstack=jstack, tstack=tstack)


def _serve_cfg(**kw) -> TC.ServeConfig:
    base = dict(resolution=16, num_inference_steps=2, sampler="ddim", max_batch=2,
                max_wait_ms=30.0, queue_depth=16, seed=0)
    base.update(kw)
    return TC.ServeConfig(**base)


# ---------------------------------------------------------------------------
# the batch sampler against the JAX one, from the JAX package's draws
# ---------------------------------------------------------------------------

def jax_draws(root_seed: int, seeds, latent_shape, emb_shape, steps: int):
    """The JAX batch sampler's per-row threefry draws (dcr_tpu/serve/
    worker.py make_batch_sampler): x_T [B, h, w, C], the embedding noise
    (cond, uncond) [B, L, D] and DDPM's noise [steps, B, h, w, C]."""
    root = JR.root_key(root_seed)
    keys = [jax.random.fold_in(root, np.uint32(s)) for s in seeds]
    x_t = np.stack([np.asarray(jax.random.normal(JR.stream_key(k, "init"), latent_shape))
                    for k in keys])
    pairs = [jax.random.split(JR.stream_key(k, "emb_noise")) for k in keys]
    emb = tuple(np.stack([np.asarray(jax.random.normal(p[j], emb_shape)) for p in pairs])
                for j in (0, 1))
    step_keys = [JR.stream_key(k, "steps") for k in keys]
    noise = np.stack([np.stack([np.asarray(jax.random.normal(jax.random.fold_in(sk, i),
                                                             latent_shape))
                                for sk in step_keys]) for i in range(steps)])
    return TW.InjectedDraws(x_t=x_t, emb_noise=emb, step_noise=noise)


@pytest.mark.parametrize("sampler,lam,steps,fast_ratio", [
    ("ddim", 0.0, 3, 0.0),
    ("dpm++", 0.0, 3, 0.0),
    ("dpm++", 0.1, 3, 0.0),
    ("ddpm", 0.0, 3, 0.0),
    ("dpm++", 0.0, 5, 0.5),            # plan FFrrF: two score reuses
])
def test_batch_sampler_matches_jax_from_its_draws(tiny, sampler, lam, steps, fast_ratio):
    """Images within atol 1e-4 (the bulk sampler's bar: XLA and PyTorch sum
    in different orders, CFG and the solver amplify it, the VAE decodes
    it)."""
    cfg = tiny.cfg
    bucket = JQ.GenBucket(16, steps, 7.5, sampler, lam, fast_ratio, 2)
    seeds = np.asarray([7, 1234567], np.uint32)
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((2, cfg.text_max_length, cfg.text_hidden_size)).astype(np.float32)
    uncond = np.repeat(rng.standard_normal((1,) + cond.shape[1:]).astype(np.float32), 2, 0)
    ref = np.asarray(JW.make_batch_sampler(bucket, tiny.jstack.models, 5, 2)(
        tiny.params, cond, uncond, seeds))
    draws = jax_draws(5, seeds, (8, 8, cfg.vae_latent_channels), cond.shape[1:], steps)
    fn = TW.make_batch_sampler(TQ.GenBucket(*bucket), tiny.tstack.models, 5, 2, "cpu")
    assert fn.unet_calls == (3 if fast_ratio else steps)
    out = fn(cond, uncond, seeds, draws=draws).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # the draws matter: the rows differ by far more than the bar
    assert np.abs(out[0] - out[1]).max() > 100 * ATOL


def test_batch_sampler_refuses_an_unpadded_batch(tiny):
    fn = TW.make_batch_sampler(TQ.GenBucket(16, 2, 7.5, "ddim", 0.0), tiny.tstack.models,
                               0, 2, "cpu")
    emb = np.zeros((1, tiny.cfg.text_max_length, tiny.cfg.text_hidden_size), np.float32)
    with pytest.raises(ValueError, match="pad the batch"):
        fn(emb, emb, np.zeros(1, np.uint32))


@pytest.mark.parametrize("sampler", ["dpm++", "ddpm"])
def test_alone_and_mixed_are_bit_identical(tiny, sampler):
    """A request's image alone (padded) and beside another request, bit for
    bit; its neighbour and a reseeded request differ."""
    svc = TW.GenerationService(_serve_cfg(sampler=sampler, num_inference_steps=3,
                                          rand_noise_lam=0.1 if sampler == "dpm++" else 0.0),
                               tiny.tstack)
    b = svc.default_bucket()
    alone = svc.execute([TQ.Request("a red square", 7, b)])
    mixed = svc.execute([TQ.Request("a red square", 7, b), TQ.Request("a blue circle", 9, b)])
    assert alone.shape == (1, 16, 16, 3) and alone.dtype == np.float32
    assert np.array_equal(alone[0], mixed[0])
    assert not np.array_equal(mixed[0], mixed[1])
    reseeded = svc.execute([TQ.Request("a red square", 8, b)])
    assert not np.array_equal(alone[0], reseeded[0])


# ---------------------------------------------------------------------------
# the small layers: the JAX fast cases through both packages
# ---------------------------------------------------------------------------

JAX_NS = SimpleNamespace(q=JQ, b=JB, c=JCa, w=JW, m=JM, s=JS, tok=JHash)
PORT_NS = SimpleNamespace(q=TQ, b=TB, c=TCa, w=TW, m=TM, s=TS, tok=THash)


def _bucket(ns, **kw):
    d = dict(resolution=16, steps=2, guidance=7.5, sampler="ddim", rand_noise_lam=0.0)
    d.update(kw)
    return ns.q.GenBucket(**d)


def _req(ns, prompt="p", seed=0, **bucket_kw):
    return ns.q.Request(prompt=prompt, seed=seed, bucket=_bucket(ns, **bucket_kw))


def case_should_flush(ns):
    f = ns.b.should_flush
    return [f(4, 4, 0.0, 1.0), f(5, 4, 0.0, 1.0), f(2, 4, 0.01, 1.0), f(2, 4, 1.0, 1.0),
            f(0, 4, 99.0, 1.0, draining=True), f(1, 4, 0.0, 1.0, draining=True)]


def case_batcher_full_batch(ns):
    q = ns.q.RequestQueue(maxsize=16)
    for i in range(4):
        q.submit(_req(ns, seed=i))
    t0 = time.monotonic()
    batch = ns.b.Batcher(max_batch=4, max_wait_s=60.0).next_batch(q, stop=threading.Event())
    return [len(batch), time.monotonic() - t0 < 5.0, q.empty()]


def case_batcher_max_wait(ns):
    q = ns.q.RequestQueue(maxsize=16)
    q.submit(_req(ns, seed=1))
    q.submit(_req(ns, seed=2))
    t0 = time.monotonic()
    batch = ns.b.Batcher(max_batch=8, max_wait_s=0.08).next_batch(q, stop=threading.Event())
    return [[r.seed for r in batch], time.monotonic() - t0 >= 0.05]


def case_batcher_groups_by_bucket(ns):
    q = ns.q.RequestQueue(maxsize=16)
    q.submit(_req(ns, seed=1, steps=2))
    q.submit(_req(ns, seed=2, steps=4))
    q.submit(_req(ns, seed=3, steps=2))
    b = ns.b.Batcher(max_batch=8, max_wait_s=0.02)
    first = b.next_batch(q, stop=threading.Event())
    second = b.next_batch(q, stop=threading.Event())
    return [[r.seed for r in first], [r.seed for r in second], q.empty()]


def case_batcher_drain(ns):
    q = ns.q.RequestQueue(maxsize=16)
    q.submit(_req(ns, seed=1))
    stop = threading.Event()
    stop.set()
    b = ns.b.Batcher(max_batch=8, max_wait_s=60.0)
    t0 = time.monotonic()
    batch = b.next_batch(q, stop=stop)
    return [len(batch), time.monotonic() - t0 < 5.0, b.next_batch(q, stop=stop)]


def case_queue_overload(ns):
    q = ns.q.RequestQueue(maxsize=2)
    q.submit(_req(ns, seed=1))
    q.submit(_req(ns, seed=2))
    try:
        q.submit(_req(ns, seed=3))
        raised = None
    except ns.q.AdmissionError as e:
        raised = type(e).__name__
    requeued = _req(ns, seed=0)
    q.requeue([requeued])                 # past the bound, at the head
    return [raised, q.depth(), [r.seed for r in q.take_group(8)]]


def case_queue_draining(ns):
    q = ns.q.RequestQueue(maxsize=4)
    q.submit(_req(ns, seed=1))
    q.close()
    try:
        q.submit(_req(ns, seed=2))
        raised = None
    except ns.q.AdmissionError as e:
        raised = type(e).__name__
    return [raised, q.closed, [r.seed for r in q.take_group(4)]]


def case_queue_groups_and_ages(ns):
    q = ns.q.RequestQueue(maxsize=8)
    empty = [q.head_age(), q.head_group_size(), q.wait_nonempty(0.01)]
    for seed, steps in ((1, 2), (2, 3), (3, 2), (4, 2)):
        q.submit(_req(ns, seed=seed, steps=steps))
    return [empty, q.head_group_size(), q.has_bucket(_bucket(ns, steps=3)),
            q.has_bucket(_bucket(ns, steps=9)), q.head_age() >= 0.0,
            [r.seed for r in q.take_group(2)], [r.seed for r in q.take_group(8)]]


def case_validate_bucket(ns):
    out = []
    for kw, scale in [({}, 2), ({"sampler": "foo"}, 2), ({"steps": 0}, 2),
                      ({"steps": 10_001}, 2), ({"resolution": 0}, 2), ({"resolution": 17}, 2),
                      ({"resolution": 1 << 20}, 2), ({"guidance": -1.0}, 2),
                      ({"guidance": 1e6}, 2), ({"rand_noise_lam": -0.1}, 2),
                      ({"fast_ratio": 0.9}, 2), ({"fast_order": 3}, 2),
                      ({"resolution": 260}, 8), ({"resolution": 256}, 8)]:
        try:
            ns.w.validate_bucket(_bucket(ns, **kw), vae_scale=scale)
            out.append("ok")
        except ns.q.InvalidRequestError as e:
            out.append(str(e))
    return out


def case_cache_lru(ns):
    c = ns.c.EmbeddingCache(capacity=2)
    k1, k2, k3 = (("fp", f"p{i}", "lam=0") for i in range(3))
    c.put(k1, np.ones(3))
    c.put(k2, np.ones(3) * 2)
    hit = c.get(k1) is not None
    c.put(k3, np.ones(3) * 3)
    return [hit, k2 in c, k1 in c, k3 in c, len(c), c.stats()]


def case_cache_keys(ns):
    b0, b1 = _bucket(ns, rand_noise_lam=0.0), _bucket(ns, rand_noise_lam=0.1)
    tags = [ns.c.mitigation_tag(b0), ns.c.mitigation_tag(b1)]
    k_clean = ns.c.embedding_key("fp", "a dog", tags[0])
    k_mit = ns.c.embedding_key("fp", "a dog", tags[1])
    k_tok = ns.c.embedding_key("fp2", "a dog", tags[0])
    c = ns.c.EmbeddingCache(capacity=8)
    c.put(k_clean, np.zeros(2))
    return [tags, len({k_clean, k_mit, k_tok}), c.get(k_mit) is None, c.get(k_tok) is None,
            c.stats()]


def case_cache_capacity_zero(ns):
    c = ns.c.EmbeddingCache(capacity=0)
    c.put(("a",), np.zeros(1))
    return [c.get(("a",)) is None, len(c), c.stats()]


def case_tokenizer_fingerprint(ns):
    a, b = ns.tok(vocab_size=100, model_max_length=16), ns.tok(vocab_size=100,
                                                                model_max_length=16)
    c = ns.tok(vocab_size=200, model_max_length=16)
    return [a.fingerprint(), a.fingerprint() == b.fingerprint(),
            a.fingerprint() != c.fingerprint()]


def case_latency_tracker(ns):
    t = ns.m.LatencyTracker(window=100)
    out = [t.percentiles()]
    for v in range(1, 101):
        t.observe(v / 1000.0)
    out.append(t.percentiles((50, 99)))
    for _ in range(200):
        t.observe(1.0)
    return out + [t.percentiles()["p50"], t.snapshot()]


def case_serve_metrics(ns):
    m = ns.w.ServeMetrics()
    m.note_batch(4, 4, ok=True)
    m.note_batch(1, 4, ok=True)
    m.note_batch(2, 4, ok=False)
    m.note_submitted()
    for err in (ns.q.DrainingError("x"), ns.q.InvalidRequestError("x"),
                ns.q.BucketLimitError("x"), ns.q.MemoryBudgetError("x"),
                ns.q.QueueFullError("x")):
        m.note_rejected(err)
    snap = m.snapshot()
    snap["latency_ms"] = sorted(snap["latency_ms"])
    return snap


def case_admission_response(ns):
    q = ns.q
    errors = [q.InvalidRequestError("bad"), q.QueueFullError("full"),
              q.BucketLimitError("limit"), q.MemoryBudgetError("mem"), q.DrainingError("drain"),
              q.SloShedError("shed", retry_after_s=2.4), q.NoWorkersError("none"),
              q.AdmissionError("other")]
    return [list(ns.s.admission_response(e)) for e in errors]


def case_request_bucket(ns):
    class Svc:
        def default_bucket(self):
            return _bucket(ns, steps=20, sampler="dpm++")

    out = []
    for body in [{"prompt": "x"}, {"prompt": "x", "steps": 30, "guidance": 3, "seed": 4},
                 {"prompt": "x", "fast_ratio": 0.5}, {"prompt": "x", "fast_ratio": 0.01},
                 {"prompt": "x", "steps": 3, "fast_ratio": 0.5, "fast_order": 1},
                 {"prompt": "x", "resolution": 32, "sampler": "ddpm", "rand_noise_lam": 0.2},
                 {"prompt": "x", "bogus": 1}, {"prompt": "x", "steps": 0},
                 {"prompt": "x", "steps": 5000}]:
        try:
            out.append(list(ns.s.request_bucket(Svc(), body)))
        except ValueError as e:
            out.append(str(e))
    return out


SMALL_CASES = {f.__name__[5:]: f for f in (
    case_should_flush, case_batcher_full_batch, case_batcher_max_wait,
    case_batcher_groups_by_bucket, case_batcher_drain, case_queue_overload,
    case_queue_draining, case_queue_groups_and_ages, case_validate_bucket, case_cache_lru,
    case_cache_keys, case_cache_capacity_zero, case_tokenizer_fingerprint,
    case_latency_tracker, case_serve_metrics, case_admission_response, case_request_bucket)}


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_small_layers_give_the_jax_results(name):
    theirs = SMALL_CASES[name](JAX_NS)
    mine = SMALL_CASES[name](PORT_NS)
    assert mine == theirs
    expected = {
        "should_flush": [True, True, False, True, False, True],
        "batcher_max_wait": [[1, 2], True],
        "batcher_groups_by_bucket": [[1, 3], [2], True],
        "batcher_drain": [1, True, None],
        "queue_overload": ["QueueFullError", 3, [0, 1, 2]],
        "queue_draining": ["DrainingError", True, [1]],
    }.get(name)
    if expected is not None:
        assert mine == expected


# ---------------------------------------------------------------------------
# GenerationService through its worker thread
# ---------------------------------------------------------------------------

def _key_tree(doc):
    return {k: _key_tree(v) if isinstance(v, dict) else None for k, v in doc.items()}


def test_service_end_to_end_through_its_thread(tiny):
    """Repeated prompts hit the cache, requests share batches, the status
    document has the JAX service's keys, and rejections are typed."""
    svc = TW.GenerationService(_serve_cfg(max_batch=4, max_wait_ms=150.0), tiny.tstack)
    svc.start()
    try:
        reqs = [svc.submit("a red square", seed=i) for i in range(4)]
        imgs = [r.future.result(timeout=120) for r in reqs]
        assert all(i.shape == (16, 16, 3) for i in imgs)
        assert svc.cache.stats()["hits"] >= 3 and svc.cache.stats()["misses"] <= 2
        status = svc.status()
        assert status["batch_occupancy_max"] > 0.25
        assert status["completed_total"] == 4 and status["latency_ms"]["p99"] > 0
        again = svc.submit("a red square", seed=2).future.result(timeout=120)
        assert np.array_equal(again, imgs[2])
        svc.cfg.max_compiled_buckets = 1
        with pytest.raises(TQ.BucketLimitError):
            svc.submit("x", bucket=svc.default_bucket()._replace(steps=3))
        with pytest.raises(TQ.InvalidRequestError):
            svc.submit("x", bucket=svc.default_bucket()._replace(sampler="foo"))
        status = svc.status()
        assert status["rejected_bucket_limit"] == 1 and status["rejected_invalid"] == 1
        jsvc = JW.GenerationService(JC.ServeConfig(**{
            f.name: getattr(svc.cfg, f.name) for f in dataclasses.fields(TC.ServeConfig)
            if f.type in ("int", "float", "str")}), tiny.jstack)
        assert _key_tree(status) == _key_tree(jsvc.status())
        assert svc.health_doc().keys() == jsvc.health_doc().keys()
        assert svc.health_doc()["status"] == "ok"
    finally:
        assert svc.stop(timeout=60)
    with pytest.raises(TQ.DrainingError):
        svc.submit("late")
    assert svc.health() == "draining" and svc.status()["rejected_draining"] == 1


def test_service_warms_the_default_bucket(tiny):
    svc = TW.GenerationService(_serve_cfg(), tiny.tstack)
    assert svc.begin_warm() == 1
    assert svc.health_doc()["status"] == "warming"
    doc = svc.warm_start()
    assert doc["buckets_warm"] == doc["buckets_total"] == 1
    assert svc.health_doc() == {"status": "ok", "buckets_warm": 1, "buckets_total": 1,
                                "risk": "absent"}


def test_warm_dir_records_the_buckets_and_the_next_service_plans_them(tiny, tmp_path):
    """With ``warm.dir``: the warm start records its plan in one manifest
    update, a bucket built after it is recorded too (LRU, the default
    first), and the next incarnation plans both before it reports ready.
    The sampler's kernels resolve through the cache as eager on the CPU
    (the plain versions): nothing is stored."""
    cfg = _serve_cfg(warm=TC.WarmCacheConfig(dir=str(tmp_path)))
    svc = TW.GenerationService(cfg, tiny.tstack)
    default = svc.default_bucket()
    assert svc.begin_warm() == 1
    assert svc.warm_start()["buckets_total"] == 1
    assert warmcache.read_warm_manifest(tmp_path) == [list(default)]
    lazy = default._replace(steps=3)
    svc._sampler_for(lazy)
    assert warmcache.read_warm_manifest(tmp_path) == [list(default), list(lazy)]
    again = TW.GenerationService(cfg, tiny.tstack)
    assert again.begin_warm() == 2 and again._warm_plan == [default, lazy]
    assert again.health_doc()["status"] == "warming"
    assert [p.name for p in tmp_path.iterdir()] == [warmcache.MANIFEST_NAME]


# ---------------------------------------------------------------------------
# HTTP, in-process on port 0, with copy-risk scoring of a planted copy
# ---------------------------------------------------------------------------

def _http(port, path, body=None, timeout=120):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            return resp.status, dict(resp.headers), raw
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _planted_index(tmp_path, image: np.ndarray) -> Path:
    """A dump of the port's SSCD (seeded init, 32 px) over a folder holding
    one generation and two unrelated images."""
    from dcr_tpu_torch.search.embed import embed_images

    train = tmp_path / "train"
    train.mkdir()
    rng = np.random.default_rng(0)
    (train / "0.png").write_bytes(encode_png((image * 255).round().astype(np.uint8)))
    for i in (1, 2):
        (train / f"{i}.png").write_bytes(encode_png(rng.integers(0, 256, (16, 16, 3),
                                                                 dtype=np.uint8)))
    return embed_images(TC.SearchConfig(image_size=32, batch_size=2), source=train,
                        out_path=tmp_path / "train.npz", device="cpu")


def test_http_front_end_in_process(tiny, tmp_path):
    from dcr_tpu_torch.obs.copyrisk import CopyRiskIndex

    plain = TW.GenerationService(_serve_cfg(), tiny.tstack)
    bucket = plain.default_bucket()
    planted = plain.execute([TQ.Request("a red square", 11, bucket)])[0]
    other = plain.execute([TQ.Request("a blue circle", 2, bucket)])[0]
    index = _planted_index(tmp_path, planted)
    # a threshold between the copy's ~1.0 and an unrelated generation's
    # background similarity (random SSCD weights run it high): measured
    probe = CopyRiskIndex.load(TC.RiskConfig(index_path=str(index), image_size=32),
                               batch=2, device="cpu")
    hit, miss = (s.max_sim for s in probe.score_batch(np.stack([planted, other])))
    assert hit > 0.9999 and hit > miss + 1e-4, (hit, miss)
    tracing.registry().reset("copy_risk/")
    cfg = _serve_cfg(port=0, max_compiled_buckets=2)
    cfg.risk = TC.RiskConfig(index_path=str(index), image_size=32,
                             threshold=(hit + miss) / 2, evidence_dir=str(tmp_path / "ev"))
    svc = TW.GenerationService(cfg, tiny.tstack)
    assert svc.wait_risk_ready(timeout=120) and svc.risk_status() == "ok"
    svc.start()
    httpd = TS.make_server(cfg, svc)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        code, _, raw = _http(port, "/healthz")
        assert code == 200 and json.loads(raw) == svc.health_doc()
        with ThreadPoolExecutor(max_workers=3) as ex:
            results = list(ex.map(lambda a: _http(port, "/generate", a),
                                  [{"prompt": "a red square", "seed": 11},
                                   {"prompt": "a blue circle", "seed": 2},
                                   {"prompt": "a blue circle", "seed": 3}]))
        docs = [json.loads(raw) for code, _, raw in results]
        assert [code for code, _, _ in results] == [200] * 3
        img = decode_png(base64.b64decode(docs[0]["image_png_b64"]))
        assert img.shape == (16, 16, 3)
        np.testing.assert_array_equal(img, (planted * 255).round().astype(np.uint8))
        # the planted copy is flagged top-1; the others are scored, unflagged
        assert docs[0]["copy_risk"]["flagged"] and docs[0]["copy_risk"]["max_sim"] > 0.9999
        assert docs[0]["copy_risk"]["top_key"].endswith("0.png")
        assert all(d["copy_risk"] is not None and not d["copy_risk"]["flagged"]
                   for d in docs[1:])
        jreq = JQ.Request(prompt="x", seed=0, bucket=JQ.GenBucket(16, 2, 7.5, "ddim", 0.0))
        assert docs[0].keys() == JS.ServeHandler._render(None, jreq, planted).keys()
        assert len(list((tmp_path / "ev").glob("flagged_*.json"))) == 1
        # /check finds the planted key for the planted PNG
        code, _, raw = _http(port, "/check", {"image_png_b64": docs[0]["image_png_b64"]})
        check = json.loads(raw)
        assert code == 200 and check["flagged"] and check["index_size"] == 3
        assert check["top_key"] == docs[0]["copy_risk"]["top_key"]
        assert _http(port, "/check", {"image_png_b64": "!!!"})[0] == 400
        # metrics: JSON and Prometheus
        code, _, raw = _http(port, "/metrics")
        metrics = json.loads(raw)
        assert metrics["completed_total"] == 3 and metrics["cache"]["hits"] >= 1
        assert metrics["risk"] == {"status": "ok", "index_size": 3}
        code, headers, raw = _http(port, "/metrics?format=prometheus")
        text = raw.decode()
        assert code == 200 and "dcr_serve_completed_total 3.0" in text
        assert "dcr_copy_risk_flagged_total 1" in text
        assert "dcr_copy_risk_checked_total 1" in text
        assert "dcr_copy_risk_scored_total 3" in text
        assert 'dcr_serve_request_latency_s{quantile="0.99"}' in text
        for line in text.splitlines():
            assert line.startswith("#") or len(line.split(" ")) == 2, line
        # admission: a bad sampler is a 400, a bucket past the budget a 503
        code, _, raw = _http(port, "/generate", {"prompt": "x", "sampler": "bogus"})
        assert code == 400 and "bad request" in json.loads(raw)["error"]
        assert _http(port, "/generate", {"prompt": "x", "bogus": 1})[0] == 400
        assert _http(port, "/generate", {"prompt": "x", "steps": 3})[0] == 200
        code, _, raw = _http(port, "/generate", {"prompt": "x", "steps": 4})
        assert code == 503 and json.loads(raw)["error"] == "bucket_limit"
        # /slo belongs to a fleet supervisor's SLO engine: a single service
        # has none and answers 404, as the JAX handler does
        for path in ("/slo", "/nope"):
            assert _http(port, path)[0] == 404
        # profiling is ported: GET is the armer's status, a bad arm a 409
        # (tests/test_torch_profiling.py arms it and reads the trace)
        code, _, raw = _http(port, "/debug/profile")
        assert code == 200 and json.loads(raw)["armed"] is False
        code, _, raw = _http(port, "/debug/profile", {"steps": 0, "logdir": str(tmp_path)})
        assert code == 409 and "steps must be >= 1" in json.loads(raw)["error"]
        # /generate_batch answers (the fleet's dispatch call): the item's image
        # is /generate's for the same prompt and seed; a bad envelope is a 400
        code, _, raw = _http(port, "/generate_batch", {"requests": [{"prompt": "x", "seed": 1}]})
        item, = json.loads(raw)["results"]
        code1, _, raw1 = _http(port, "/generate", {"prompt": "x", "seed": 1})
        assert code == code1 == 200 and item["image_png_b64"] == json.loads(raw1)["image_png_b64"]
        assert _http(port, "/generate_batch", {"requests": []})[0] == 400
    finally:
        svc.begin_drain()
        assert svc.join_drained(timeout=60)
        httpd.shutdown()
        httpd.server_close()


def test_http_front_end_holds_a_burst_of_clients(tiny):
    """32 clients connect and send before the accept loop runs, as a burst
    does while the sampler thread holds the GIL: every one is answered,
    none reset past the listen backlog."""
    import socket

    svc = TW.GenerationService(_serve_cfg(), tiny.tstack)
    httpd = TS.make_server(_serve_cfg(port=0), svc)
    port = httpd.server_address[1]
    clients, server = [], threading.Thread(target=httpd.serve_forever, daemon=True)
    try:
        for _ in range(32):
            c = socket.create_connection(("127.0.0.1", port), timeout=10)
            c.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
            clients.append(c)
        server.start()
        status = []
        for c in clients:
            try:
                status.append(c.makefile("rb").readline().split(b" ")[1])
            except OSError as e:      # reset, or never accepted (timed out)
                status.append(type(e).__name__)
                break
        assert status == [b"200"] * 32, status
    finally:
        for c in clients:
            c.close()
        if server.is_alive():
            httpd.shutdown()
        httpd.server_close()


def test_check_is_a_typed_503_without_an_index(tiny):
    from dcr_tpu_torch.obs.copyrisk import RiskUnavailableError

    svc = TW.GenerationService(_serve_cfg(), tiny.tstack)
    with pytest.raises(RiskUnavailableError) as exc:
        svc.check({"image_png_b64": "x"})
    assert exc.value.status == "absent"


def test_failed_index_load_degrades_to_unscored_serving(tiny, tmp_path):
    bad = tmp_path / "embedding.npz"
    bad.write_bytes(b"garbage")
    before = R.bump_counter("copy_risk/index_load_failed", 0)
    cfg = _serve_cfg()
    cfg.risk = TC.RiskConfig(index_path=str(bad), image_size=32)
    svc = TW.GenerationService(cfg, tiny.tstack)
    assert svc.wait_risk_ready(timeout=60) and svc.risk_status() == "failed"
    assert R.bump_counter("copy_risk/index_load_failed", 0) == before + 1
    req = TQ.Request("still serving", 3, svc.default_bucket())
    assert svc.execute([req]).shape == (1, 16, 16, 3) and req.risk is None


# ---------------------------------------------------------------------------
# the command line: a subprocess on the CPU, drained by SIGTERM
# ---------------------------------------------------------------------------

def _export_tiny_ckpt(tiny, root: Path) -> Path:
    ckpt = root / "checkpoint"
    export_hf_layout(ckpt, unet=tiny.params["unet"], vae=tiny.params["vae"],
                     text_encoder=tiny.params["text"],
                     model_config=dataclasses.asdict(tiny.cfg))
    return ckpt


def test_cli_serves_a_jax_export_and_drains_with_exit_83(tiny, tmp_path):
    """With ``--logdir``: every request's span tree in trace.jsonl, serve/*
    scalars in metrics.jsonl, and the drain's flight-recorder dump."""
    ckpt = _export_tiny_ckpt(tiny, tmp_path)
    env = dict(os.environ, DCR_TPU_PLATFORM="cpu",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logdir = tmp_path / "logs"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dcr_tpu_torch.cli.serve", f"--model_path={ckpt}",
         "--port=0", "--resolution=16", "--num_inference_steps=2", "--sampler=ddim",
         "--max_batch=2", "--max_wait_ms=200", "--seed=0", f"--logdir={logdir}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 120
        port = None
        while port is None:
            for line in list(lines):
                if "dcr-serve listening on http://" in line:
                    port = int(line.split("http://127.0.0.1:")[1].split(" ")[0])
            assert proc.poll() is None and time.monotonic() < deadline, "".join(lines)
            time.sleep(0.1)
        while json.loads(_http(port, "/healthz")[2])["status"] != "ok":
            assert time.monotonic() < deadline, "".join(lines)
            time.sleep(0.1)
        code, _, raw = _http(port, "/generate", {"prompt": "a red square", "seed": 1})
        assert code == 200 and json.loads(raw)["width"] == 16
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(_http, port, "/generate", {"prompt": "a dot", "seed": 100 + i})
                    for i in range(2)]
            # SIGTERM once both are admitted (the batch waits up to 200 ms)
            while json.loads(_http(port, "/metrics")[2])["requests_total"] < 3:
                assert time.monotonic() < deadline, "".join(lines)
                time.sleep(0.01)
            proc.send_signal(signal.SIGTERM)
            drained = [f.result(timeout=60) for f in futs]
        assert [code for code, _, _ in drained] == [200, 200]
        assert proc.wait(timeout=60) == 83, "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert any("drained: exiting with code 83" in line for line in lines)
    from tools import trace_report as TR

    records, errors = TR.load_trace(logdir, TR.load_schema())
    assert errors == []
    roots = [r for r in records if r["name"] == "serve/request"]
    assert len(roots) == 3 and all(r.get("trace") for r in roots)
    for name in ("serve/queue_wait", "serve/assemble", "serve/device_step", "serve/respond"):
        assert any(r["name"] == name for r in records), name
    dump = json.loads((logdir / "flightrec_0.json").read_text())
    assert dump["reason"] == "preempted: serve drained" and "memory" in dump
    rows = [json.loads(x) for x in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert rows and "serve/latency_p99_ms" in rows[-1]


def test_cli_refuses_to_run_without_a_gpu_unless_asked(tmp_path, monkeypatch):
    from dcr_tpu_torch.cli import serve as cli

    monkeypatch.delenv("DCR_TPU_PLATFORM", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([f"--model_path={tmp_path}"])


# ---------------------------------------------------------------------------
# settings the port does not run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides,item", [
    (["--mesh.data=2"], "item 9b"),
])
def test_unported_serve_settings_raise(overrides, item):
    cfg = TC.parse_cli(TC.ServeConfig, overrides)
    JC.validate_serve_config(JC.parse_cli(JC.ServeConfig, overrides))   # valid in JAX
    with pytest.raises(TC.NotPortedError, match=f"ROADMAP Queue A {item}\\)"):
        TC.validate_serve_config(cfg)


@pytest.mark.parametrize("overrides", [
    ["--logdir=l"],
    ["--fleet.workers=2"],
    ["--fleet.worker_index=0"],
    ["--hang_timeout_s=30"],
    ["--warm.dir=w"],
])
def test_serve_settings_that_run(overrides):
    """``logdir`` runs since the trace and metrics sink was ported (the CLI
    test below serves with it); the fleet's roles and the batch watchdog
    since the fleet was (tests/test_torch_fleet.py drives them); the warm
    cache since it was (the manifest test above): each
    validates in both packages, and the fleet's own checks still refuse a
    bad lease contract."""
    JC.validate_serve_config(JC.parse_cli(JC.ServeConfig, overrides))
    TC.validate_serve_config(TC.parse_cli(TC.ServeConfig, overrides))
    if overrides[0].startswith("--fleet."):
        bad = overrides + ["--fleet.heartbeat_s=2", "--fleet.lease_s=1"]
        for pkg in (JC, TC):
            with pytest.raises(ValueError, match="lease_s"):
                pkg.validate_serve_config(pkg.parse_cli(pkg.ServeConfig, bad))


def test_serve_config_parses_as_the_jax_one():
    argv = ["--port=0", "--max_batch=4", "--risk.index_path=x.npz", "--fast.enabled=true",
            "--fleet.heartbeat_s=2", "--slo.budget=0.2", "--ingest.queue_max=8"]
    assert TC.to_dict(TC.parse_cli(TC.ServeConfig, argv)) == \
        JC.to_dict(JC.parse_cli(JC.ServeConfig, argv))
    assert TC.to_dict(TC.ServeConfig()) == JC.to_dict(JC.ServeConfig())
    for bad in (["--max_batch=0"], ["--sampler=x"], ["--risk.top_k=0"],
                ["--slo.budget=0"], ["--fast.order=3"]):
        with pytest.raises(ValueError):
            JC.validate_serve_config(JC.parse_cli(JC.ServeConfig, bad))
        with pytest.raises(ValueError):
            TC.validate_serve_config(TC.parse_cli(TC.ServeConfig, bad))
