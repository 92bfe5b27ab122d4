"""Serve-side live ingest: the port's ``serve/ingest.IngestPump`` and the
serve worker's live provenance path against the JAX package's, on the CPU.

- the pump, as ``tests/test_livestore.py`` and ``tests/test_slo.py`` hold
  the JAX pump: ``offer`` never blocks and a full queue drops and counts;
  appends, compactions and the snapshot callback; ``ingest_stall`` delays
  and never drops; a WAL the port's pump wrote reads in the JAX package;
- ``risk.ann`` and ``ingest.enabled`` validate in both packages, and the
  settings the port still lacks keep raising;
- one in-process tiny serve with ``risk.ann`` and ingest on (the port's
  counterpart of ``tests/test_livestore.py``'s serve end to end): the
  served image is unchanged by ingest, the generation is found at once
  through the live tail, still after a compaction swapped the engine, the
  recall probe publishes, and the final store scores a check as a store
  rebuilt over the acked rows does.
"""

from __future__ import annotations

import base64
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dcr_tpu.core import config as JC  # noqa: E402
from dcr_tpu.search import livestore as JL  # noqa: E402
from dcr_tpu.search import store as JST  # noqa: E402
from dcr_tpu.serve import ingest as JI  # noqa: E402
from dcr_tpu.utils import faults as jfaults  # noqa: E402
from dcr_tpu_torch.core import config as TC  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.search import store as ST  # noqa: E402
from dcr_tpu_torch.serve import ingest as TI  # noqa: E402
from dcr_tpu_torch.utils import faults  # noqa: E402

DIM = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # a tiny model's steps are fastest on one intra-op thread, and the
    # suite's parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DCR_FAULTS", raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _counter(name: str) -> int:
    return tracing.registry().counters("ingest/").get(name, 0)


def _wait(cond, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# the pump
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_offer_never_blocks_and_drops_when_full(tmp_path, pkg):
    """While another writer holds the lease the pump waits, the queue fills,
    and offers past its bound drop and count without blocking."""
    mod, stores = (JI, JST) if pkg == "jax" else (TI, ST)
    store = tmp_path / "s"
    blocker = stores.StoreWriterLease(store, owner="blocker").acquire()
    rng = np.random.default_rng(0)
    try:
        pump = mod.IngestPump(store, embed_dim=DIM, queue_max=4, batch_rows=2,
                              lease_s=30.0).start()
        before = _counter("ingest/dropped_total")
        t0 = time.perf_counter()
        accepted = [pump.offer(rng.standard_normal(DIM), f"g{i}") for i in range(32)]
        assert time.perf_counter() - t0 < 1.0
        assert sum(accepted) == 4 and pump.dropped_rows == 28
        if pkg == "port":
            assert _counter("ingest/dropped_total") == before + 28
        _wait(lambda: pump.status == "waiting_lease")
        assert pump.stats()["queued"] == 4
        pump.stop(timeout=5.0)
    finally:
        blocker.release()


def test_pump_appends_compacts_and_calls_back(tmp_path):
    rng = np.random.default_rng(1)
    store, snapshots = tmp_path / "s", []
    rows = rng.standard_normal((16, DIM)).astype(np.float32)
    with TI.IngestPump(store, embed_dim=DIM, queue_max=64, batch_rows=4, compact_rows=8,
                       on_snapshot=snapshots.append) as pump:
        for i in range(16):
            assert pump.offer(rows[i], f"g{i}")
        _wait(lambda: pump.stats()["appended_rows"] == 16 and pump.stats()["compactions"] >= 1)
        # the pump may commit its next compaction between the reads: take
        # the manifest of the snapshot the stats report, between two equal
        # stats documents
        for _ in range(1000):
            s = pump.stats()
            manifest = ST.read_store_manifest(store)
            tail = pump.tail(manifest["wal_through"])[0]
            if manifest["snapshot"] == s["snapshot"] and pump.stats() == s:
                break
            time.sleep(0.01)
        else:
            raise AssertionError(f"the pump's stats never settled: {s}, {manifest}")
        assert s["status"] == "ok" and s["dropped_rows"] == 0
        assert len(tail) == s["total_rows"] - s["snapshot"] * 8
    assert pump.stats()["status"] == "stopped"
    assert snapshots and snapshots[0] == 1
    # every acked row is durable, and the JAX package reads it all
    committed, keys = JST.EmbeddingStoreReader(store).load_all()
    tail, tail_keys, _ = JL.load_wal_tail(store, embed_dim=DIM)
    np.testing.assert_array_equal(np.concatenate([committed, tail]), rows)
    assert list(keys) + list(tail_keys) == [f"g{i}" for i in range(16)]


def test_ingest_stall_delays_but_never_drops(tmp_path, monkeypatch):
    monkeypatch.setenv("DCR_INGEST_STALL_S", "0.6")
    faults.install("ingest_stall@row=0")
    row = np.random.default_rng(2).standard_normal(DIM).astype(np.float32)
    saw_stall = False
    with TI.IngestPump(tmp_path / "s", embed_dim=DIM, queue_max=8, batch_rows=1) as pump:
        assert pump.offer(row, "k0")
        deadline = time.monotonic() + 20
        while pump.stats()["appended_rows"] < 1 and time.monotonic() < deadline:
            saw_stall |= pump.status == "stalled"
            time.sleep(0.02)
        stats = pump.stats()
    assert saw_stall and stats["appended_rows"] == 1 and stats["dropped_rows"] == 0
    assert stats["status"] == "ok"


# ---------------------------------------------------------------------------
# the settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [
    ["--ingest.enabled=true", "--risk.store_dir=s"],
    ["--risk.ann=true", "--risk.store_dir=s"],
], ids=["ingest", "risk_ann"])
def test_live_serve_settings_validate_as_in_jax(overrides):
    JC.validate_serve_config(JC.parse_cli(JC.ServeConfig, overrides))
    TC.validate_serve_config(TC.parse_cli(TC.ServeConfig, overrides))
    for bad in (["--ingest.enabled=true"], ["--ingest.enabled=true", "--risk.store_dir=s",
                                            "--ingest.batch_rows=0"]):
        with pytest.raises(ValueError):
            JC.validate_serve_config(JC.parse_cli(JC.ServeConfig, bad))
        with pytest.raises(ValueError):
            TC.validate_serve_config(TC.parse_cli(TC.ServeConfig, bad))


# ---------------------------------------------------------------------------
# the serve worker, end to end
# ---------------------------------------------------------------------------

def test_serve_with_ann_and_ingest_end_to_end(tmp_path):
    """A generation is found by /check through the live tail once acked,
    and after the compaction that swapped the engine; ingest never changes
    the served image; the recall probe publishes; the final store scores
    the check as a store rebuilt over the acked rows does."""
    from dcr_tpu_torch.data.tokenizer import HashTokenizer
    from dcr_tpu_torch.obs.copyrisk import CopyRiskIndex
    from dcr_tpu_torch.sampling import pipeline as P
    from dcr_tpu_torch.sampling.png import encode_png
    from dcr_tpu_torch.search import ann
    from dcr_tpu_torch.search.embed import embed_images
    from dcr_tpu_torch.search.livestore import LiveStore
    from dcr_tpu_torch.serve.queue import Request
    from dcr_tpu_torch.serve.worker import GenerationService

    mc = TC.ModelConfig.tiny()
    stack = P.GenerationStack(P.build_models(mc, "cpu", seed=0), mc,
                              HashTokenizer(mc.text_vocab_size, mc.text_max_length),
                              torch.device("cpu"))
    cfg = dict(resolution=16, num_inference_steps=2, sampler="ddim", max_batch=2,
               max_wait_ms=10.0, queue_depth=16, seed=0)
    plain = GenerationService(TC.ServeConfig(**cfg), stack)
    bucket = plain.default_bucket()
    img_train, img_new = plain.execute([Request("a red square", 1, bucket),
                                        Request("a blue circle", 2, bucket)])
    train = tmp_path / "train"
    train.mkdir()
    rng = np.random.default_rng(3)
    (train / "0.png").write_bytes(encode_png((img_train * 255).round().astype(np.uint8)))
    for i in (1, 2, 3):
        (train / f"{i}.png").write_bytes(encode_png(rng.integers(0, 256, (16, 16, 3),
                                                                 dtype=np.uint8)))
    dump = embed_images(TC.SearchConfig(image_size=32, batch_size=2), source=train,
                        out_path=tmp_path / "train.npz", device="cpu")
    store = tmp_path / "store"
    writer = ST.EmbeddingStoreWriter.create(store, shard_rows=2)
    writer.add_dump(dump)
    writer.finalize()
    ann.train_ivf(store, n_lists=2, iters=2, normalize=True, device="cpu")

    scfg = TC.ServeConfig(**cfg)
    scfg.risk = TC.RiskConfig(store_dir=str(store), image_size=32, ann=True, nprobe=1,
                              threshold=0.999, top_k=2)
    scfg.ingest = TC.IngestConfig(enabled=True, queue_max=64, batch_rows=1, seal_rows=8,
                                  compact_rows=2)
    scfg.slo = TC.SloConfig(recall_probe_every_n=1)
    svc = GenerationService(scfg, stack)
    png = {"image_png_b64": base64.b64encode(
        encode_png((img_new * 255).round().astype(np.uint8))).decode()}
    tracing.registry().reset("ann/recall")
    try:
        assert svc.wait_risk_ready(timeout=120) and svc.risk_status() == "ok"
        _wait(lambda: svc._pump is not None and svc._pump.stats()["status"] == "ok")
        svc.start()
        req = svc.submit("a blue circle", seed=2)
        np.testing.assert_array_equal(req.future.result(timeout=120), img_new)
        _wait(lambda: svc._pump.stats()["appended_rows"] >= 1)
        key = f"gen/{req.trace_id}"
        check = svc.check(png)
        assert check["top_key"] == key and check["max_sim"] > 0.9999, check
        assert svc.health_doc()["ingest"]["status"] == "ok"
        for seed in (3, 4):
            svc.submit("a red square", seed=seed).future.result(timeout=120)
        _wait(lambda: svc._pump.stats()["compactions"] >= 1
              and svc._risk._store.snapshot >= 1)
        check2 = svc.check(png)
        assert check2["top_key"] == key and check2["index_size"] >= 5
        assert svc.status()["ingest"]["appended_rows"] == 3
        reg = tracing.registry().snapshot()
        assert reg["gauges"]["ann/recall_online_samples"] >= 1
        assert reg["counters"]["ann/recall_probe_total"] >= 1
        assert "dcr_ann_recall_online_pct" in tracing.registry().prometheus_text()
    finally:
        assert svc.stop(timeout=120)
    assert svc._pump.stats()["status"] == "stopped"

    with LiveStore.open(store) as live:      # the lease was released on stop
        live.compact()
    rebuilt = tmp_path / "rebuilt"
    feats, keys = ST.EmbeddingStoreReader(store).load_all()
    w = ST.EmbeddingStoreWriter.create(rebuilt, embed_dim=feats.shape[1])
    w.add(feats, keys)
    w.finalize()
    scores = [CopyRiskIndex.load(TC.RiskConfig(store_dir=str(s), image_size=32), batch=2,
                                 device="cpu").score_batch(img_new[None])[0]
              for s in (store, rebuilt)]
    assert scores[0].max_sim == scores[1].max_sim and scores[0].top_key == scores[1].top_key
