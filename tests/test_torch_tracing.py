"""PyTorch port: span tracing, the trace.jsonl sink and the flight recorder
(``dcr_tpu_torch/core/tracing.py``) against the JAX package's
``dcr_tpu/core/tracing.py``.

- One scenario (nested spans, an event, a handle ended from elsewhere, a
  complete span, a fault line, then a dump) through both packages: the
  records agree in keys, phases, names, args and parent structure, and the
  flight-recorder documents in their keys (bar the times and ids).
- The cases of ``tests/test_tracing.py`` with a counterpart: nesting through
  contextvars, errors recorded and re-raised, threads not sharing parents,
  idempotent handles, the bounded ring, ``DCR_TRACE=0``, the dump's
  contents, first dump wins, no destination, ``DCR_FLIGHTREC_DIR``, the
  worker-indexed name, size rotation, the excepthook.
- A tiny Trainer's ``trace.jsonl`` through ``tools/trace_report.py``: schema
  valid against ``tools/trace_schema.json``, a ``train/step`` and a
  ``train/data_wait`` span per step (the pipelined run's ``train/encode``
  and ``train/encode_wait``), rendered without error; its NaN abort dumps
  ``flightrec_0.json`` with the ``nan_abort`` reason.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import pytest
import torch

from dcr_tpu.core import resilience as JR
from dcr_tpu.core import tracing as JT
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.diffusion.trainer import Trainer
from tests.test_torch_trainer import _cfg, _data
from tools import trace_report as TRP


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tiny models run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_tracing(monkeypatch):
    for var in ("DCR_TRACE", "DCR_FLIGHTREC_DIR", "DCR_WORKER_INDEX", "DCR_TRACE_MAX_MB",
                "DCR_TRACE_KEEP"):
        monkeypatch.delenv(var, raising=False)
    hook = sys.excepthook
    tracing.reset_for_tests()
    JT.reset_for_tests()
    yield
    tracing.reset_for_tests()
    JT.reset_for_tests()
    sys.excepthook = hook


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def _scenario(tr, res, root):
    tr.configure(root, rank=0)
    with tr.span("train/step", step=3) as outer:
        with tr.span("train/data_wait", step=3):
            pass
        tr.event("serve/rejected", error="QueueFullError")
    h = tr.begin_span("serve/request", parent=None, trace="00ff00ff00ff00ff",
                      request_id=7, seed=1)
    tr.complete_span("serve/queue_wait", start_wall=time.time() - 0.01, dur_s=0.01,
                     parent=h.id, trace=h.trace, request_id=7)
    h.end()
    res.log_event("nan_rollback", at_step=3, loss=float("nan"))
    path = tr.dump_flight_recorder("nan_abort: step 3 loss nan")
    return outer, path


def _shape(rec: dict, ids: dict) -> dict:
    """A record without its times, ids and thread: what the two packages
    must agree on."""
    out = {k: v for k, v in rec.items() if k not in ("ts", "dur", "tid", "tname", "id")}
    out["parent"] = ids.get(rec.get("parent"))
    out["keys"] = sorted(rec)
    return out


def test_records_and_dump_match_the_jax_package(tmp_path):
    _scenario(tracing, R, tmp_path / "port")
    _scenario(JT, JR, tmp_path / "jax")
    schema = TRP.load_schema()
    docs, shapes = {}, {}
    for name in ("port", "jax"):
        lines = [json.loads(x) for x in
                 (tmp_path / name / "trace.jsonl").read_text().splitlines()]
        assert all(TRP.validate_record(r, schema) == [] for r in lines)
        ids = {r["id"]: r["name"] for r in lines}
        shapes[name] = [_shape(r, ids) for r in lines]
        docs[name] = json.loads((tmp_path / name / "flightrec_0.json").read_text())
    assert json.dumps(shapes["port"], default=str) == json.dumps(shapes["jax"], default=str)
    port, jax_doc = docs["port"], docs["jax"]
    assert sorted(port) == sorted(jax_doc)
    assert port["version"] == jax_doc["version"] == tracing.TRACE_VERSION == 1
    assert port["reason"] == jax_doc["reason"]
    assert sorted(port["memory"]) == sorted(jax_doc["memory"])
    # on the CPU neither package has device statistics
    assert port["memory"]["device_memory_stats"] is jax_doc["memory"]["device_memory_stats"]
    assert [r["name"] for r in port["records"]] == [r["name"] for r in jax_doc["records"]]
    assert port["registry"]["counters"] == jax_doc["registry"]["counters"]


# ---------------------------------------------------------------------------
# tests/test_tracing.py's cases, for the port
# ---------------------------------------------------------------------------

def test_span_nesting_parents_via_contextvars(tmp_path):
    path = tracing.configure(tmp_path, rank=0)
    assert path == tmp_path / "trace.jsonl"
    with tracing.span("outer") as outer:
        assert tracing.current_span_id() == outer.id
        with tracing.span("inner", detail=1):
            pass
        tracing.event("mark")
    assert tracing.current_span_id() is None
    recs = {r["name"]: r for r in tracing.flight_records()}
    assert recs["inner"]["parent"] == recs["mark"]["parent"] == outer.id
    assert recs["outer"]["parent"] is None and recs["inner"]["args"] == {"detail": 1}
    assert recs["outer"]["dur"] >= recs["inner"]["dur"]
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 3


def test_span_records_error_and_reraises_and_threads_do_not_share_parents(tmp_path):
    tracing.configure(tmp_path, rank=0)
    with pytest.raises(ValueError):
        with tracing.span("boom"):
            raise ValueError("nope")
    [rec] = tracing.flight_records()
    assert rec["name"] == "boom" and "ValueError" in rec["args"]["error"]
    seen = {}

    def worker():
        with tracing.span("thread_root") as h:
            seen["parent"] = h.parent

    with tracing.span("main_root"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["parent"] is None


def test_begin_end_handle_idempotent_and_complete_span(tmp_path):
    tracing.configure(tmp_path, rank=0)
    h = tracing.begin_span("serve/request", request_id=5)
    h.end(outcome="ok")
    h.end(outcome="double")
    tracing.complete_span("serve/queue_wait", start_wall=time.time() - 1.0, dur_s=1.0,
                          parent=h.id, request_id=5)
    recs = tracing.flight_records()
    assert [r["name"] for r in recs] == ["serve/request", "serve/queue_wait"]
    assert recs[0]["args"] == {"request_id": 5, "outcome": "ok"}
    assert recs[1]["parent"] == h.id and recs[1]["dur"] == pytest.approx(1e6, rel=0.01)


def test_ring_is_bounded_and_trace_off_keeps_the_ring(tmp_path, monkeypatch):
    maxlen = tracing._state.ring.maxlen
    for i in range(maxlen + 50):
        tracing.event("e", i=i)
    recs = tracing.flight_records()
    assert len(recs) == maxlen and recs[0]["args"]["i"] == 50
    tracing.reset_for_tests()
    monkeypatch.setenv("DCR_TRACE", "0")
    assert tracing.configure(tmp_path, rank=0) is None
    with tracing.span("still_recorded"):
        pass
    assert not (tmp_path / "trace.jsonl").exists()
    assert [r["name"] for r in tracing.flight_records()] == ["still_recorded"]
    assert tracing.dump_flight_recorder("test") == tmp_path / "flightrec_0.json"


def test_flight_recorder_contents_and_first_dump_wins(tmp_path):
    tracing.configure(tmp_path, rank=0)
    with tracing.span("train/step", step=9):
        pass
    R.bump_counter("rollbacks")
    path = tracing.dump_flight_recorder("nan_abort: step 9 loss nan",
                                        extra={"oom": {"where": "x"}})
    doc = json.loads(path.read_text())
    assert doc["reason"].startswith("nan_abort") and doc["rank"] == 0
    assert [r["name"] for r in doc["records"]] == ["train/step"]
    assert doc["registry"]["counters"]["faults/rollbacks"] == 1
    assert doc["oom"] == {"where": "x"} and "memory" in doc
    assert tracing.dump_flight_recorder("later") == path
    assert json.loads(path.read_text())["reason"].startswith("nan_abort")
    assert not list(tmp_path.glob("*.tmp"))              # written atomically


def test_flight_recorder_destinations(tmp_path, monkeypatch):
    assert tracing.dump_flight_recorder("nowhere to go") is None
    monkeypatch.setenv("DCR_FLIGHTREC_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("DCR_WORKER_INDEX", "3")
    tracing.event("before_death")
    path = tracing.dump_flight_recorder("env fallback")
    assert path == tmp_path / "env" / "flightrec_w3_0.json"


def test_size_rotation_keeps_segments(tmp_path, monkeypatch):
    monkeypatch.setenv("DCR_TRACE_MAX_MB", "0.002")
    monkeypatch.setenv("DCR_TRACE_KEEP", "2")
    path = tracing.configure(tmp_path, rank=0)
    for i in range(200):
        tracing.event("e", i=i, pad="x" * 40)
    tracing.reset_for_tests()
    segments = sorted(p.name for p in tmp_path.glob("trace.jsonl*"))
    assert segments == ["trace.jsonl", "trace.jsonl.1", "trace.jsonl.2"]
    assert all(p.stat().st_size <= 2000 + 200 for p in tmp_path.glob("trace.jsonl.*"))
    records, errors = TRP.load_trace(tmp_path, TRP.load_schema())
    assert errors == [] and [r["args"]["i"] for r in records] == sorted(
        r["args"]["i"] for r in records)
    assert records[-1]["args"]["i"] == 199 and path.exists()


def test_excepthook_dumps_then_defers(tmp_path):
    seen = []
    sys.excepthook = lambda *a: seen.append(a[0])
    tracing.configure(tmp_path, rank=0)
    try:
        raise KeyError("k")
    except KeyError as e:
        sys.excepthook(type(e), e, e.__traceback__)
    assert seen == [KeyError]
    doc = json.loads((tmp_path / "flightrec_0.json").read_text())
    assert doc["reason"].startswith("unhandled_exception: KeyError")


def test_log_event_lands_in_the_ring_as_a_fault_event():
    R.log_event("bad_thing", step=7, name="collides")
    [rec] = [r for r in tracing.flight_records() if r["name"] == "fault/bad_thing"]
    assert rec["args"] == {"step": 7, "name": "collides"}


# ---------------------------------------------------------------------------
# the Trainer's trace through tools/trace_report.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True], ids=["fused", "pipelined"])
def test_trainer_trace_reads_in_trace_report(tmp_path, capsys, pipelined):
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, out="run")
    cfg.max_train_steps = 3
    cfg.pipe.enabled = pipelined
    Trainer(cfg, device="cpu").train()
    tracing.reset_for_tests()             # close the file before reading
    run = tmp_path / "run"
    records, errors = TRP.load_trace(run, TRP.load_schema())
    assert errors == []
    names = [r["name"] for r in records]
    assert names.count("train/step") == 3 and names.count("train/data_wait") >= 3
    if pipelined:
        assert names.count("train/encode") == 3 and names.count("train/encode_wait") >= 3
        assert TRP.summarize(records)["pipeline"] is not None
    assert TRP.main([str(run)]) == 0
    assert "train/step" in capsys.readouterr().out


def test_nan_abort_dumps_the_flight_recorder(tmp_path):
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, out="nan")
    cfg.max_train_steps = 2
    trainer = Trainer(cfg, device="cpu")
    step_fn = trainer.step_fn

    def poisoned(state, batch):
        state, metrics = step_fn(state, batch)
        return state, {**metrics, "loss": torch.tensor(float("nan"))}

    trainer.step_fn = poisoned
    with pytest.raises(FloatingPointError):
        trainer.train()
    doc = json.loads((tmp_path / "nan" / "flightrec_0.json").read_text())
    assert doc["reason"] == "nan_abort: step 1 loss nan"
    assert "train/step" in [r["name"] for r in doc["records"]]
