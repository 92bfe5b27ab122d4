"""PyTorch port: device-memory telemetry and the out-of-memory exit
(``dcr_tpu_torch/obs/memwatch.py``) against the JAX package's
``dcr_tpu/obs/memwatch.py``, driven on the CPU through ``DCR_MEMWATCH_FAKE``.

- The cases of ``tests/test_memwatch.py`` with a counterpart: the fake
  statistics and the ``dcr_device_mem_*`` gauges (the same numbers and
  Prometheus lines as the JAX package's), a bad fake, the sampler,
  ``span_hbm``'s attrs, the footprint registry and its estimates (the same
  as the JAX functions' on the same notes), ``is_oom_error`` (and
  ``torch.OutOfMemoryError`` by type), ``oom_abort``'s enriched dump and
  exit 85, the memory section of every dump, the admission check with its
  reservation against the JAX worker's decisions, the 503 tag.
- The serve worker measures each bucket's first batch (its peak rise) and
  refuses a novel bucket past the budget with ``MemoryBudgetError``,
  counted in ``serve/rejected_memory_budget``.
- The ``oom`` fault kind exits 85 with a dump in a trainer subprocess and
  in a serve subprocess.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from dcr_tpu.core import tracing as JT
from dcr_tpu.obs import memwatch as JM
from dcr_tpu.serve.queue import GenBucket as JBucket
from dcr_tpu.serve.worker import GenerationService as JService
from dcr_tpu_torch.core import coordination as C
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.obs import memwatch
from dcr_tpu_torch.serve import queue as Q
from dcr_tpu_torch.serve import worker as TW
from dcr_tpu_torch.serve.server import admission_response
from dcr_tpu_torch.utils import faults
from tests.test_torch_serve import _export_tiny_ckpt, _http, _serve_cfg, tiny  # noqa: F401
from tests.test_torch_trainer import _cfg, _data

REPO = Path(__file__).resolve().parent.parent
FAKE = json.dumps({"bytes_in_use": 1000, "peak_bytes_in_use": 1500, "bytes_limit": 10_000})


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in (memwatch.FAKE_ENV, memwatch.PERIOD_ENV, "DCR_FAULTS", "DCR_FLIGHTREC_DIR"):
        monkeypatch.delenv(var, raising=False)
    for mod in (tracing, JT, memwatch, JM):
        mod.reset_for_tests()
    faults.clear()
    yield
    for mod in (tracing, JT, memwatch, JM):
        mod.reset_for_tests()
    faults.clear()


def test_cpu_reports_no_stats():
    assert memwatch.device_memory_stats() is None is JM.device_memory_stats()
    assert memwatch.peak_bytes() is None and memwatch.remaining_device_bytes() is None
    assert memwatch.start_sampler() is False


def test_fake_stats_and_gauges_match_the_jax_package(monkeypatch):
    monkeypatch.setenv(memwatch.FAKE_ENV, FAKE)
    stats = memwatch.device_memory_stats()
    assert stats == JM.device_memory_stats() == {"bytes_in_use": 1000, "peak_bytes": 1500,
                                                  "bytes_limit": 10_000}
    assert memwatch.peak_bytes() == JM.peak_bytes() == 1500
    assert memwatch.remaining_device_bytes() == JM.remaining_device_bytes() == 9000
    assert memwatch.update_memory_gauges() == JM.update_memory_gauges()

    def lines(reg):
        return sorted(x for x in reg.prometheus_text().splitlines() if "device_mem" in x)

    assert lines(tracing.registry()) == lines(JT.registry())
    assert "dcr_device_mem_limit_bytes 10000.0" in lines(tracing.registry())
    monkeypatch.setenv(memwatch.FAKE_ENV, "{not json")
    assert memwatch.device_memory_stats() is None


def test_sampler_and_span_hbm(monkeypatch):
    with tracing.span("serve/device_step") as sp, memwatch.span_hbm(sp):
        pass
    assert "hbm_peak" not in tracing.flight_records()[-1]["args"]
    monkeypatch.setenv(memwatch.FAKE_ENV, FAKE)
    sampler = memwatch.MemorySampler(period_s=0.1)
    try:
        assert sampler.start() and sampler.active
        assert tracing.registry().gauge("device_mem/in_use_bytes").value == 1000
    finally:
        sampler.stop()
    with tracing.span("serve/device_step") as sp, memwatch.span_hbm(sp):
        pass
    args = tracing.flight_records()[-1]["args"]
    assert args["hbm_peak"] == 1500 and args["hbm_delta"] == 0
    with memwatch.region_peak() as region:
        pass
    assert region.rise == 500                       # fake peak over fake use


def test_footprint_registry_and_estimates_match_the_jax_package():
    notes = [("serve/batch_sampler", "k1", {"temp_bytes": 100, "output_bytes": 50,
                                            "generated_code_bytes": 10,
                                            "argument_bytes": 999}),
             ("serve/batch_sampler", "k2", {"temp_bytes": 400}),
             ("train/step", "k3", {"temp_bytes": 1000})]
    for mod in (memwatch, JM):
        for n in notes:
            mod.note_surface(*n)
    for prefix in ("serve/batch_sampler", "train/", "eval/"):
        assert memwatch.estimate_surface_bytes(prefix) == JM.estimate_surface_bytes(prefix)
    assert memwatch.estimate_surface_bytes("serve/batch_sampler") == 400
    assert memwatch.resident_program_bytes() == JM.resident_program_bytes() == 1560
    assert memwatch.live_footprints() == JM.live_footprints()
    events = [r for r in tracing.flight_records() if r["name"] == "memwatch/surface_memory"]
    assert [e["args"]["key"] for e in events] == ["k1", "k2", "k3"]


def test_is_oom_error_classification():
    cases = [memwatch.InjectedOom("here"),
             RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 13529146368 bytes"),
             RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
             MemoryError(), ValueError("shape mismatch"), FloatingPointError("nan loss")]
    assert [memwatch.is_oom_error(e) for e in cases] == [True, True, True, True, False, False]
    assert [JM.is_oom_error(e) for e in cases[1:]] == [True, True, True, False, False]
    # torch's allocator error is recognised by its type, whatever its text
    assert memwatch.is_oom_error(torch.OutOfMemoryError("allocator says no"))
    assert not JM.is_oom_error(torch.OutOfMemoryError("allocator says no"))


def test_oom_abort_dump_is_enriched_and_exits_85(tmp_path, monkeypatch):
    assert C.EXIT_OOM == 85
    monkeypatch.setenv(memwatch.FAKE_ENV, FAKE)
    docs = {}
    for name, tr, mw in (("port", tracing, memwatch), ("jax", JT, JM)):
        tr.configure(tmp_path / name, rank=0)
        mw.note_surface("serve/batch_sampler", "k1", {"temp_bytes": 123})
        codes: list = []
        mw.oom_abort("serve batch 0", mw.InjectedOom("serve batch 0"),
                     buckets=[(16, 2, 7.5, "ddim", 0.0)], exit_fn=codes.append)
        assert codes == [85]
        docs[name] = json.loads((tmp_path / name / "flightrec_0.json").read_text())
    port, jdoc = docs["port"], docs["jax"]
    assert port["reason"].startswith("oom: serve batch 0")
    assert sorted(port) == sorted(jdoc) and sorted(port["oom"]) == sorted(jdoc["oom"])
    assert port["oom"]["compiled_buckets"] == jdoc["oom"]["compiled_buckets"]
    assert port["memory"] == jdoc["memory"]
    assert port["memory"]["device_memory_stats"]["bytes_in_use"] == 1000
    assert "fault/oom_abort" in [r["name"] for r in port["records"]]


def test_oom_abort_exits_85_past_a_closed_log_stream(monkeypatch):
    """A root handler whose stream is closed (a harness's captured stderr)
    fails its flush; the fatal path still exits 85."""
    import io
    import logging

    stream = io.TextIOWrapper(io.BytesIO())  # pytest's capture: flush raises once closed
    handler = logging.StreamHandler(stream)
    monkeypatch.setattr(logging.root, "handlers", [*logging.root.handlers, handler])
    monkeypatch.setattr(logging, "raiseExceptions", False)
    stream.close()
    codes: list = []
    memwatch.oom_abort("serve batch 0", memwatch.InjectedOom("serve batch 0"),
                       exit_fn=codes.append)
    assert codes == [85]


def _stub(**kw):
    return types.SimpleNamespace(**{"_admitted_buckets": set(), "_samplers": {},
                                    "_measured": set(), **kw})


def test_memory_budget_admission_matches_the_jax_worker(monkeypatch):
    """The same admission decisions as the JAX worker's
    ``_check_memory_budget`` at each state: no sibling, no stats, room,
    the reservation of an admitted bucket not run yet, its release once it
    ran, a nearly full device."""
    bucket, other = Q.GenBucket(16, 2, 7.5, "ddim", 0.0), Q.GenBucket(16, 4, 7.5, "ddim", 0.0)
    jb, jother = JBucket(16, 2, 7.5, "ddim", 0.0), JBucket(16, 4, 7.5, "ddim", 0.0)

    def decide(stub, jstub) -> tuple[bool, bool]:
        out = []
        for fn, st, b, err in ((TW.GenerationService._check_memory_budget, stub, bucket,
                                Q.MemoryBudgetError),
                               (JService._check_memory_budget, jstub, jb, Exception)):
            try:
                fn(st, b)
                out.append(True)
            except err:
                out.append(False)
        return tuple(out)

    port, jax_stub = _stub(), _stub()
    assert decide(port, jax_stub) == (True, True)          # no sibling measured
    for mod in (memwatch, JM):
        mod.note_surface("serve/batch_sampler", "k1", {"temp_bytes": 5000})
    assert decide(port, jax_stub) == (True, True)          # no device stats
    monkeypatch.setenv(memwatch.FAKE_ENV, FAKE)
    assert decide(port, jax_stub) == (True, True)          # 5000 <= 9000
    port._admitted_buckets, jax_stub._admitted_buckets = {other}, {jother}
    assert decide(port, jax_stub) == (False, False)        # 2 x 5000 > 9000
    port._measured, jax_stub._samplers = {other}, {jother: object()}
    assert decide(port, jax_stub) == (True, True)          # the reservation released
    monkeypatch.setenv(memwatch.FAKE_ENV, json.dumps(
        {"bytes_in_use": 9900, "peak_bytes_in_use": 9900, "bytes_limit": 10_000}))
    assert decide(port, jax_stub) == (False, False)
    assert tracing.registry().counter("serve/rejected_memory_budget").value == 2
    code, payload, _ = admission_response(Q.MemoryBudgetError("too big"))
    assert code == 503 and payload["error"] == "memory_budget"


def test_a_peer_on_the_card_lowers_the_budget(monkeypatch):
    """Two fleet workers share one card, and each one's allocator sees only
    its own tensors. The budget is the smaller of ``limit - in use`` and the
    card's free bytes plus this process's cached bytes, so a peer's
    memory lowers it, and admission refuses (503 ``memory_budget``) a
    bucket that ``limit - in use`` alone (9000 of 10000 here, the JAX
    worker's figure on a chip of its own) admitted."""
    monkeypatch.setenv(memwatch.FAKE_ENV, FAKE)
    memwatch.note_surface("serve/batch_sampler", "k1", {"temp_bytes": 5000})
    assert memwatch._card_free_bytes() is None              # no card under the fake
    assert memwatch.remaining_device_bytes() == 9000
    TW.GenerationService._check_memory_budget(_stub(), Q.GenBucket(16, 2, 7.5, "ddim", 0.0))
    # a peer holds 6000 of the card: the card reports 3000 free
    monkeypatch.setattr(memwatch, "_card_free_bytes", lambda: 3000)
    assert memwatch.remaining_device_bytes() == 3000
    with pytest.raises(Q.MemoryBudgetError, match="remaining device memory"):
        TW.GenerationService._check_memory_budget(_stub(), Q.GenBucket(16, 3, 7.5, "ddim", 0.0))
    # bytes this process's allocator caches but no tensor holds are its own
    monkeypatch.setenv(memwatch.FAKE_ENV, json.dumps(
        {"bytes_in_use": 1000, "peak_bytes_in_use": 1500, "bytes_limit": 10_000}))
    monkeypatch.setattr(memwatch, "device_memory_stats", lambda: {
        "bytes_in_use": 1000, "peak_bytes": 1500, "bytes_limit": 10_000,
        "reserved_bytes": 3500})
    assert memwatch.remaining_device_bytes() == 3000 + 2500
    TW.GenerationService._check_memory_budget(_stub(), Q.GenBucket(16, 3, 7.5, "ddim", 0.0))
    assert memwatch.update_memory_gauges()["bytes_in_use"] == 1000
    assert tracing.registry().gauge("device_budget/remaining_bytes").value == 5500


def test_service_measures_buckets_and_refuses_past_the_budget(tiny, monkeypatch):  # noqa: F811
    """In the worker: the default bucket's first batch notes its footprint
    (the fake peak over the fake use: 4000 of 9000 remaining); novel
    buckets queued but not run reserve it, so the second is admitted
    (2 x 4000) and the third is a typed 503 (3 x 4000)."""
    monkeypatch.setenv(memwatch.FAKE_ENV, json.dumps(
        {"bytes_in_use": 1000, "peak_bytes_in_use": 5000, "bytes_limit": 10_000}))
    svc = TW.GenerationService(_serve_cfg(), tiny.tstack)
    default = svc.default_bucket()
    svc.execute([Q.Request("a red square", 1, default)])
    assert memwatch.live_footprints() == {
        f"serve/batch_sampler@{tuple(default)}": {"temp_bytes": 4000}}
    for steps in (3, 4):                      # queued; the worker is not started
        svc.submit("x", seed=2, bucket=default._replace(steps=steps))
    with pytest.raises(Q.MemoryBudgetError, match="past remaining device memory"):
        svc.submit("x", seed=3, bucket=default._replace(steps=5))
    assert svc.status()["rejected_memory_budget"] == 1
    assert tracing.registry().counter("serve/rejected_memory_budget").value == 1
    rejected = [r for r in tracing.flight_records() if r["name"] == "serve/rejected"]
    assert rejected[-1]["args"]["error"] == "MemoryBudgetError"
    svc.stop(timeout=10)


# ---------------------------------------------------------------------------
# the oom kind in subprocesses: exit 85 with a dump
# ---------------------------------------------------------------------------

def _env(**kw) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("DCR_FAULTS", memwatch.FAKE_ENV)}
    env.update(DCR_TPU_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""), **kw)
    return env


def test_trainer_oom_kind_exits_85_with_a_dump(tmp_path):
    from dcr_tpu_torch.core import config as TC

    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, out="oom")
    TC.save_config(cfg, tmp_path / "cfg.json")
    proc = subprocess.run(
        [sys.executable, "-m", "dcr_tpu_torch.cli.train", f"--config={tmp_path / 'cfg.json'}"],
        env=_env(DCR_FAULTS="oom@step=2", DCR_MEMWATCH_FAKE=FAKE), cwd=tmp_path,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 85, proc.stderr[-3000:]
    assert "[fault] oom_abort" in proc.stderr
    doc = json.loads((tmp_path / "oom" / "flightrec_0.json").read_text())
    assert doc["reason"].startswith("oom: train step 2")
    assert doc["oom"]["where"] == "train step 2" and "InjectedOom" in doc["oom"]["error"]
    assert doc["memory"]["device_memory_stats"]["bytes_limit"] == 10_000


def test_serve_oom_kind_exits_85_with_a_dump(tiny, tmp_path):  # noqa: F811
    ckpt = _export_tiny_ckpt(tiny, tmp_path)
    logdir = tmp_path / "logs"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dcr_tpu_torch.cli.serve", f"--model_path={ckpt}",
         "--port=0", "--resolution=16", "--num_inference_steps=2", "--sampler=ddim",
         "--max_batch=2", "--max_wait_ms=50", "--seed=0", f"--logdir={logdir}"],
        cwd=REPO, env=_env(DCR_FAULTS="oom@batch=0"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True).start()
    try:
        deadline, port = time.monotonic() + 120, None
        while port is None:
            for line in list(lines):
                if "dcr-serve listening on http://" in line:
                    port = int(line.split("http://127.0.0.1:")[1].split(" ")[0])
            assert proc.poll() is None and time.monotonic() < deadline, "".join(lines)
            time.sleep(0.1)
        while json.loads(_http(port, "/healthz")[2])["status"] != "ok":
            assert time.monotonic() < deadline, "".join(lines)
            time.sleep(0.1)
        try:
            _http(port, "/generate", {"prompt": "a red square", "seed": 1}, timeout=60)
        except OSError:
            pass                        # the process died under the request
        assert proc.wait(timeout=60) == 85, "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    doc = json.loads((logdir / "flightrec_0.json").read_text())
    assert doc["reason"].startswith("oom: serve batch 0")
    assert doc["oom"]["compiled_buckets"] and "memory" in doc
