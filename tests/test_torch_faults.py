"""PyTorch port: the fault-tolerance machinery, held against the JAX package.

The ``DCR_FAULTS`` grammar parses to the JAX package's entries, and a kind
the port has no hook for is refused; the registry fires once, ``xN`` times,
on matching coordinates only and atomically across threads; retry_call
backs off and gives up as the JAX one does; quarantine records carry the JAX
keys; the checkpoint manifest catches a flipped byte inside a tensor; the
hang watchdog arms on its first beat, stays quiet while paused, fires after
its timeout and stays off at 0; the config runs the fault budgets in training; the two search hooks
drive their real verification paths.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dcr_tpu.core import resilience as JR
from dcr_tpu.utils import faults as jfaults
from dcr_tpu_torch.core import checkpoint as CK
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.core import coordination as C
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DCR_FAULTS", raising=False)
    monkeypatch.delenv("DCR_WORKER_INDEX", raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "",
    "decode_error@step=3",
    "decode_error@step=3,ckpt_corrupt@step=200x2,nan_loss@step=5&epoch=1",
    "nan_loss@step=5@rank=1",
    "sigterm@step=7, hang@step=1x3",
    "decode_error@step=1&slot=4&index=9&epoch=0x2",
    "search_dump_corrupt@load=0,store_shard_corrupt@load=12",
    "ivf_list_corrupt@load=3",
    "kmeans_nan@iter=2x4,ivf_list_corrupt@load=0&rank=0",
])
def test_parse_faults_equals_jax(spec):
    def entries(mod):
        return [(s.kind, s.where, s.times) for s in mod.parse_faults(spec)]

    assert entries(faults) == entries(jfaults)


@pytest.mark.parametrize("spec", ["decode_error", "nan_loss@step=abc", "nan_loss@=1",
                                  "x@step=1x"])
def test_malformed_specs_fail_as_in_jax(spec):
    for mod in (faults, jfaults):
        with pytest.raises(ValueError, match="malformed"):
            mod.parse_faults(spec)


@pytest.mark.parametrize("kind", ["cache_corrupt"])
def test_kinds_without_a_port_hook_are_refused(kind):
    """Every JAX kind has its hook now: the last one without
    (``cache_corrupt``, the warm cache's) parses as the JAX package parses
    it and installs, and ``NOT_PORTED_KINDS`` is empty. A kind the port has
    no hook for is still refused, never silently ignored (the JAX package
    parses any kind; tests/test_torch_warmcache.py drives ``cache_corrupt``
    through the real quarantine path)."""
    spec = f"decode_error@step=1,{kind}@load=2"

    def entries(mod):
        return [(s.kind, s.where, s.times) for s in mod.parse_faults(spec)]

    assert entries(faults) == entries(jfaults)
    assert kind in faults.PORTED_KINDS and faults.NOT_PORTED_KINDS == {}
    reg = faults.install(spec)
    assert not reg.fire(kind, load=1) and reg.fire(kind, load=2)
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.parse_faults("no_such_kind@step=1")


@pytest.mark.parametrize("spec", ["wal_torn@append=3", "ingest_crash@append=5",
                                  "compact_crash@seal=0", "ingest_stall@row=7x2",
                                  "recall_degrade@probe=2&rank=0"],
                         ids=lambda s: s.split("@")[0])
def test_live_tier_kinds_parse_and_fire_as_in_jax(spec):
    """The live tier's kinds have hooks since the live provenance slice:
    they parse as the JAX package parses them and fire at their
    coordinate."""
    def entries(mod):
        return [(s.kind, s.where, s.times) for s in mod.parse_faults(spec)]

    assert entries(faults) == entries(jfaults)
    (kind, where, _), = entries(faults)
    assert kind in faults.PORTED_KINDS and kind not in faults.NOT_PORTED_KINDS
    reg = faults.install(spec)
    coord = {k: v for k, v in where.items() if k != "rank"}
    assert not reg.fire(kind, **{k: v + 1 for k, v in coord.items()})
    assert reg.fire(kind, **coord)


@pytest.mark.parametrize("spec", ["worker_crash@batch=1&rank=0", "worker_hang@batch=0@rank=1",
                                  "slow_step@batch=2x3"],
                         ids=lambda s: s.split("@")[0])
def test_fleet_kinds_parse_and_fire_as_in_jax(spec):
    """The serving fleet's kinds have their hook (the serve worker's batch
    loop) since the fleet slice: they parse as the JAX package parses them
    and fire at their coordinate; tests/test_torch_fleet.py drives each."""
    def entries(mod):
        return [(s.kind, s.where, s.times) for s in mod.parse_faults(spec)]

    assert entries(faults) == entries(jfaults)
    (kind, where, times), = entries(faults)
    assert kind in faults.PORTED_KINDS and set(faults.NOT_PORTED_KINDS) == set()
    reg = faults.install(spec)
    assert not reg.fire(kind, **{k: v + 1 for k, v in where.items()})
    assert all(reg.fire(kind, **where) for _ in range(times))
    assert not reg.fire(kind, **where)


@pytest.mark.parametrize("spec", ["oom@step=2", "oom@batch=0x2"])
def test_oom_kind_parses_and_fires_as_in_jax(spec):
    """The ``oom`` kind has its hooks since the memory slice (the trainer's
    step, the serve worker's batch): it parses as the JAX package parses it
    and fires at its coordinate."""
    def entries(mod):
        return [(s.kind, s.where, s.times) for s in mod.parse_faults(spec)]

    assert entries(faults) == entries(jfaults)
    (kind, where, times), = entries(faults)
    assert kind in faults.PORTED_KINDS and kind not in faults.NOT_PORTED_KINDS
    reg = faults.install(spec)
    assert not reg.fire(kind, **{k: v + 1 for k, v in where.items()})
    assert all(reg.fire(kind, **where) for _ in range(times))
    assert not reg.fire(kind, **where)


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.parse_faults("decode_errr@step=1")


def test_registry_fires_once_on_matching_coordinates():
    reg = faults.install("decode_error@step=3")
    assert not reg.fire("decode_error", step=2, slot=0)
    assert not reg.fire("nan_loss", step=3)
    assert reg.fire("decode_error", step=3, slot=7)      # extra coordinates ignored
    assert not reg.fire("decode_error", step=3, slot=8)  # single-shot
    assert reg.pending() == []


def test_registry_times_env_and_rank(monkeypatch):
    reg = faults.install("nan_loss@step=1x3")
    assert sum(reg.fire("nan_loss", step=1) for _ in range(5)) == 3
    faults.clear()
    monkeypatch.setenv("DCR_FAULTS", "sigterm@step=9")
    assert not faults.fire("sigterm", step=8)
    assert faults.fire("sigterm", step=9)
    # the implicit rank is the worker index, 0 in one process
    reg = faults.install("hang@step=1@rank=1,hang@step=2@rank=0")
    assert not reg.fire("hang", step=1) and reg.fire("hang", step=2)
    monkeypatch.setenv("DCR_WORKER_INDEX", "1")
    assert reg.fire("hang", step=1)


def test_registry_fire_is_atomic_across_threads():
    reg = faults.install("decode_error@step=1x10")
    hits = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: hits.extend(
            1 for _ in range(100) if reg.fire("decode_error", step=1))) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(hits) == 10


# ---------------------------------------------------------------------------
# retry, counters, quarantine records
# ---------------------------------------------------------------------------

def _flaky(fails: int, exc: BaseException):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise exc
        return "ok"
    return fn, calls


@pytest.mark.parametrize("kw", [{}, {"retry_on": (Exception,)},
                                {"retry_on": (Exception,), "give_up_on": (KeyError,)}])
@pytest.mark.parametrize("exc", [OSError("eio"), ValueError("bad"), KeyError("k")])
def test_retry_call_backs_off_and_gives_up_as_in_jax(kw, exc):
    outcomes = []
    for mod in (R, JR):
        fn, calls = _flaky(2, exc)
        delays = []
        try:
            got = mod.retry_call(fn, attempts=4, base_delay=0.1, jitter=0.0,
                                 sleep=delays.append, **kw)
        except Exception as e:
            got = type(e).__name__
        outcomes.append((got, len(calls), delays))
    assert outcomes[0] == outcomes[1]


def test_retry_call_keeps_missing_files_fatal():
    fn, calls = _flaky(5, FileNotFoundError("gone"))
    with pytest.raises(FileNotFoundError):
        R.retry_call(fn, attempts=4, sleep=lambda s: None)
    assert len(calls) == 1


def test_counters_report_and_reset():
    R.reset_counters()
    R.bump_counter("x/y")
    R.bump_counter("x/y", 2)
    assert R.counters() == {"x/y": 3}
    R.reset_counters()
    assert R.counters() == {}


def test_quarantine_records_have_the_jax_keys(tmp_path):
    fields = dict(epoch=0, step=1, slot=3, index=5, path="/d/c0/5.png", replacement_slot=4,
                  replacement_index=7, error="SampleDecodeError()")
    port, jax_ = R.QuarantineManifest(tmp_path / "p.jsonl"), JR.QuarantineManifest(
        tmp_path / "j.jsonl")
    for q in (port, jax_):
        q.record("bad_sample", **fields)
        q.record("nan_rollback", at_step=3, restored_step=2, loss=float("nan"), rollback=1,
                 max_rollbacks=1, skipped_steps=1)
    got, want = port.entries(), jax_.entries()
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    strip = lambda es: [json.dumps({k: v for k, v in e.items() if k != "time"},
                                   sort_keys=True) for e in es]
    assert strip(got) == strip(want)
    assert port.count("bad_sample") == 1 and port.counts == {"bad_sample": 1,
                                                              "nan_rollback": 1}
    # one sorted JSON object per line
    for line in (tmp_path / "p.jsonl").read_text().splitlines():
        assert line == json.dumps(json.loads(line), sort_keys=True)


# ---------------------------------------------------------------------------
# checkpoint manifests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_manifest_detects_a_flipped_byte_inside_a_tensor(dtype):
    payload = {"step": 4, "params": {"unet": {"w": torch.arange(24).reshape(4, 6).to(dtype),
                                              "b": torch.ones(3, dtype=dtype)},
                                     "text": None}}
    manifest = CK.state_manifest(payload)
    assert manifest["leaves"]["params/unet/w"]["dtype"] == str(dtype)
    assert manifest["leaves"]["params/unet/w"]["shape"] == [4, 6]
    assert set(manifest["leaves"]) == {"step", "params/unet/w", "params/unet/b"}
    assert CK.verify_manifest(manifest, payload) == []
    raw = payload["params"]["unet"]["w"].reshape(-1).view(torch.uint8)
    raw[5] ^= 0x10
    assert CK.verify_manifest(manifest, payload) == ["params/unet/w: checksum mismatch"]
    payload["step"] = 5
    assert "step: checksum mismatch" in CK.verify_manifest(manifest, payload)
    del payload["params"]["unet"]["b"]
    assert "params/unet/b: missing from the loaded state" in CK.verify_manifest(
        manifest, payload)


# ---------------------------------------------------------------------------
# the hang watchdog
# ---------------------------------------------------------------------------

def test_watchdog_arms_on_first_beat_pauses_and_fires_after_timeout():
    fired = []
    dog = C.HangWatchdog(0.2, abort=fired.append, poll_s=0.02)
    dog.start()
    try:
        time.sleep(0.5)
        assert fired == []                 # not armed before the first beat
        for step in range(5):
            dog.beat(step)
            time.sleep(0.05)
        assert fired == []                 # beating keeps it quiet
        with dog.paused(5):
            time.sleep(0.5)                # a save longer than the timeout
        assert fired == []
        for step in range(5, 7):
            dog.beat(step)
            time.sleep(0.05)
        deadline = time.monotonic() + 5
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        dog.stop()
    assert len(fired) == 1 and "last step 6" in fired[0]


def test_watchdog_off_at_zero_and_hang_abort_exits_89(monkeypatch):
    dog = C.HangWatchdog(0.0, abort=lambda d: pytest.fail("fired"))
    dog.start()
    dog.beat(1)
    assert dog._thread is None
    dog.stop()
    codes = []
    monkeypatch.setattr(C, "_exit_fn", codes.append)
    C.hang_abort("train", detail="test")
    assert codes == [C.EXIT_HANG] == [89]
    assert (C.EXIT_PREEMPTED, C.EXIT_OOM, R.EXIT_PREEMPTED) == (83, 85, 83)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_training_runs_the_fault_budgets_and_watchdog():
    cfg = TC.parse_cli(TC.TrainConfig, ["--fault.max_rollbacks=2",
                                        "--fault.max_bad_sample_frac=0.1",
                                        "--fault.hang_timeout_s=5",
                                        "--fault.verify_checkpoints=false"])
    TC.validate_train_config(cfg)          # no NotPortedError
    with pytest.raises(ValueError, match="max_bad_sample_frac"):
        TC.validate_train_config(TC.parse_cli(TC.TrainConfig,
                                              ["--fault.max_bad_sample_frac=1.5"]))
    # serving's batch watchdog runs since the fleet slice; eval arms none
    TC.validate_serve_config(TC.ServeConfig(hang_timeout_s=5))
    with pytest.raises(TC.NotPortedError, match="hang_timeout_s"):
        TC.validate_eval_config(TC.parse_cli(TC.EvalConfig, ["--fault.hang_timeout_s=5"]))


# ---------------------------------------------------------------------------
# the search hooks
# ---------------------------------------------------------------------------

def _counter(name: str) -> int:
    return tracing.registry().counters("search/").get(name, 0)


def test_search_dump_corrupt_fault_kind(tmp_path):
    from dcr_tpu_torch.search import embed as E

    path = E.save_embeddings(tmp_path / "embedding.npz",
                             np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32),
                             ["a", "b", "c"])
    E.reset_dump_load_seq()
    faults.install("search_dump_corrupt@load=0")
    before = _counter("search/dump_corrupt")
    with pytest.raises(E.EmbeddingDumpError, match="sha256"):
        E.load_embeddings(path)
    assert _counter("search/dump_corrupt") == before + 1
    _, keys = E.load_embeddings(path)      # the fault fired once
    assert keys == ["a", "b", "c"]


def test_latent_cache_corrupt_fault_kind_fires(tmp_path):
    """latent_cache_corrupt has a hook since the latent cache was ported:
    it parses as the JAX package parses it and damages the Nth shard read,
    which is quarantined and counted."""
    from dcr_tpu_torch.data import latent_cache as LC

    spec = "latent_cache_corrupt@load=1"
    assert [(s.kind, s.where) for s in faults.parse_faults(spec)] == [
        (s.kind, s.where) for s in jfaults.parse_faults(spec)]
    assert "latent_cache_corrupt" in faults.PORTED_KINDS
    w = LC.LatentCacheWriter(tmp_path, {"v": 1}, shard_size=2)
    w.add(np.arange(4), np.zeros((4, 2, 2, 4), np.float32),
          np.ones((4, 2, 2, 4), np.float32), np.zeros((4, 3, 8), np.float32))
    w.finalize()
    R.reset_counters()
    faults.install(spec)
    try:
        reader = LC.LatentCacheReader(tmp_path, {"v": 1})
    finally:
        faults.clear()
    assert reader.coverage() == (2, 4) and reader.lookup(np.asarray([2])) is None
    assert R.counters() == {"latentcache/shard_corrupt": 1}
    assert not (tmp_path / "shard_00001.npz").exists()


def test_store_shard_corrupt_fault_kind(tmp_path):
    from dcr_tpu_torch.search import store as ST

    store = tmp_path / "store"
    w = ST.EmbeddingStoreWriter.create(store, shard_rows=4)
    w.add(np.random.default_rng(1).standard_normal((12, 8)).astype(np.float32),
          [f"k{i}" for i in range(12)])
    w.finalize()
    faults.install("store_shard_corrupt@load=1")
    before = _counter("search/store_shard_corrupt")
    feats, keys = ST.EmbeddingStoreReader(store).load_all()
    assert len(keys) == 8 and keys == [f"k{i}" for i in (0, 1, 2, 3, 8, 9, 10, 11)]
    assert feats.shape == (8, 8)
    assert _counter("search/store_shard_corrupt") == before + 1
    assert list(store.glob("shard_00001.npz.quarantined.*"))
