"""PyTorch port: the serving fleet (``dcr_tpu_torch.serve.{fleet,scrape,
supervisor}``, the worker's wire path and batch watchdog, the fleet's fault
kinds, ``dcr-serve-torch --fleet.workers``) against the JAX package's
``dcr_tpu.serve``, on the CPU at a tiny model, 16 px, 2 steps and
``max_batch`` 2.

- the same journal operations give equal counts, records and replays in
  both packages, and either package's journal file replays through the
  other's ``RequestJournal.replay``;
- a lease written by either package reads in the other, byte for byte; a
  corrupt lease reads as absent;
- ``bucket_from_tuple``, ``inject_labels``, ``merge_expositions`` and the
  retryable-error rule give the JAX results;
- the port's ``POST /generate_batch`` answers items built by the JAX
  supervisor's ``wire_item``, each image the in-process one, its
  ``serve/request`` joined to the item's trace;
- the fault hooks fire: ``worker_crash`` SIGKILLs, ``worker_hang`` ends in
  exit 89 under the batch watchdog (subprocesses), ``slow_step`` stalls;
- a fleet of 2 workers started as a subprocess, worker 0 SIGKILLed by
  ``worker_crash``: every accepted request answered, the journal replays to
  zero dropped and zero failed, and every image equals an in-process
  ``GenerationService`` image bit for bit.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import dcr_tpu.core.tracing as JT  # noqa: E402
import dcr_tpu.serve.fleet as JF  # noqa: E402
import dcr_tpu.serve.queue as JQ  # noqa: E402
import dcr_tpu.serve.scrape as JSc  # noqa: E402
import dcr_tpu.serve.supervisor as JSup  # noqa: E402
import dcr_tpu_torch.serve.fleet as TF  # noqa: E402
import dcr_tpu_torch.serve.queue as TQ  # noqa: E402
import dcr_tpu_torch.serve.scrape as TSc  # noqa: E402
import dcr_tpu_torch.serve.server as TS  # noqa: E402
import dcr_tpu_torch.serve.supervisor as TSup  # noqa: E402
import dcr_tpu_torch.serve.worker as TW  # noqa: E402
from dcr_tpu_torch.core import config as TC  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.core.checkpoint import export_hf_layout  # noqa: E402
from dcr_tpu_torch.sampling.pipeline import (GenerationStack, build_models,  # noqa: E402
                                             load_generation_stack)
from dcr_tpu_torch.sampling.png import decode_png  # noqa: E402
from dcr_tpu_torch.utils import faults  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _bucket(pkg, **kw):
    d = dict(resolution=16, steps=2, guidance=7.5, sampler="ddim", rand_noise_lam=0.0)
    d.update(kw)
    return pkg.GenBucket(**d)


# ---------------------------------------------------------------------------
# the request journal: the same operations in both packages
# ---------------------------------------------------------------------------

def _run_ops(fleet_mod, queue_mod, path, ops) -> tuple[dict, list]:
    """Apply ``ops`` to a journal of ``fleet_mod``; (counts, per-op returns)."""
    j = fleet_mod.RequestJournal(path)
    reqs = {}
    out = []
    for op, rid, *args in ops:
        try:
            if op == "add":
                r = queue_mod.Request(prompt=f"p{rid}", seed=rid, id=rid,
                                      bucket=_bucket(queue_mod, steps=2 + rid % 2))
                r.trace_id = f"{rid:016x}"
                reqs[rid] = r
                e = j.add(r)
                out.append((e.state, e.attempts))
            elif op == "dispatch":
                out.append(j.dispatch(rid, *args))
            elif op == "requeue":
                out.append(j.requeue(rid, *args))
            elif op == "ack":
                out.append(j.ack(rid, *args))
            elif op == "fail":
                out.append(j.fail(rid, *args))
            elif op == "reject":
                out.append(j.reject(rid, *args))
            out.append(("inflight", j.inflight_for(0), j.inflight_for(1), j.pending_count()))
        except (KeyError, ValueError) as e:
            out.append(type(e).__name__)
    counts = j.counts()
    j.close()
    return counts, out


_OPS = {
    "happy": [("add", 1), ("dispatch", 1, 1), ("ack", 1, 1)],
    "requeue": [("add", 1), ("dispatch", 1, 0), ("requeue", 1, 0, "crash"),
                ("dispatch", 1, 1), ("ack", 1, 1)],
    "uncharged": [("add", 1), ("dispatch", 1, 0), ("requeue", 1, 0, "DrainingError: bye", False),
                  ("dispatch", 1, 1), ("requeue", 1, 1, "crash"), ("dispatch", 1, 0),
                  ("ack", 1, 0)],
    "duplicate": [("add", 1), ("dispatch", 1, 0), ("requeue", 1, 0, "presumed dead"),
                  ("dispatch", 1, 1), ("ack", 1, 1), ("ack", 1, 0), ("fail", 1, "too late"),
                  ("dispatch", 1, 0)],
    "invalid": [("add", 1), ("add", 1), ("requeue", 1, 0, "x"), ("dispatch", 1, 0),
                ("dispatch", 1, 1), ("reject", 1, "x"), ("dispatch", 9, 0), ("ack", 1, 0)],
    "mixed": [("add", 1), ("add", 2), ("add", 3), ("add", 4), ("dispatch", 1, 0),
              ("dispatch", 2, 0), ("requeue", 1, 0, "crash"), ("requeue", 2, 0, "crash"),
              ("dispatch", 1, 1), ("ack", 1, 1), ("dispatch", 2, 1), ("fail", 2, "exhausted"),
              ("reject", 3, "queue full"), ("reject", 3, "again"), ("ack", 4, 0)],
}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_journal_operations_count_and_replay_as_in_jax(tmp_path, name):
    ops = _OPS[name]
    tc, tout = _run_ops(TF, TQ, tmp_path / "port" / "journal.jsonl", ops)
    jc, jout = _run_ops(JF, JQ, tmp_path / "jax" / "journal.jsonl", ops)
    assert tc == jc and tout == jout

    def records(path):
        return [{k: v for k, v in json.loads(line).items() if k != "t"}
                for line in path.read_text().splitlines()]

    port_file, jax_file = tmp_path / "port" / "journal.jsonl", tmp_path / "jax" / "journal.jsonl"
    assert records(port_file) == records(jax_file)
    # each package's file replays through the other's replay
    for path in (port_file, jax_file):
        assert TF.RequestJournal.replay(path) == JF.RequestJournal.replay(path)
    replay = TF.RequestJournal.replay(port_file)["counts"]
    assert replay["accepted"] - replay["acked"] - replay["failed"] == replay["dropped"]


def test_journal_holds_its_counts_under_concurrent_channels(tmp_path):
    """16 threads (more than this box's cores) each drive their requests
    through add, dispatch, a requeue and ack, as dispatch channels do, at a
    short switch interval: no transition is lost, and the file replays to
    the in-memory counts."""
    j = TF.RequestJournal(tmp_path / "journal.jsonl")
    per, threads = 25, 16
    errors: list = []

    def channel(w: int) -> None:
        try:
            for i in range(per):
                rid = w * per + i + 1
                j.add(TQ.Request(prompt="p", seed=rid, bucket=_bucket(TQ), id=rid))
                j.dispatch(rid, w)
                j.requeue(rid, w, "crash")
                j.dispatch(rid, (w + 1) % threads)
                assert j.ack(rid, (w + 1) % threads)
                assert not j.ack(rid, w)             # the presumed-dead twin
        except Exception as e:                      # surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=channel, args=(w,)) for w in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    j.close()
    assert errors == []
    n = per * threads
    assert j.counts() == {"accepted": n, "queued": 0, "in_flight": 0, "acked": n, "failed": 0,
                          "requeued_total": n, "duplicate_acks": n}
    replay = JF.RequestJournal.replay(tmp_path / "journal.jsonl")["counts"]
    assert replay == {**j.counts(), "dropped": 0}


def test_journal_rotates_a_previous_incarnation_as_in_jax(tmp_path):
    """A restarted supervisor never appends onto the previous run's file:
    request ids restart per process."""
    for mod, qmod, sub in ((TF, TQ, "port"), (JF, JQ, "jax")):
        path = tmp_path / sub / "journal.jsonl"
        j1 = mod.RequestJournal(path)
        r1 = qmod.Request(prompt="a", seed=0, bucket=_bucket(qmod), id=1)
        j1.add(r1)
        j1.dispatch(1, 0)
        j1.ack(1, 0)
        j1.close()
        j2 = mod.RequestJournal(path)
        j2.add(qmod.Request(prompt="b", seed=1, bucket=_bucket(qmod), id=1))
        j2.close()
        rotated = [p for p in path.parent.iterdir() if p.name.startswith("journal.jsonl.")]
        assert len(rotated) == 1
        for replay in (TF.RequestJournal.replay, JF.RequestJournal.replay):
            assert replay(path)["counts"]["dropped"] == 1
            assert replay(rotated[0])["counts"]["dropped"] == 0


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lease_written_by_either_package_reads_in_the_other(tmp_path, writer):
    fields = dict(index=1, pid=4242, port=18000, vae_scale=8, lease_s=5.0,
                  started_at=1000.0, renewed_at=1001.5, ready=False, buckets_warm=0,
                  buckets_total=1, risk="loading")
    w, r = (TF, JF) if writer == "port" else (JF, TF)
    w.write_lease(w.fleet_paths(tmp_path).ensure(), w.WorkerLease(**fields))
    got = r.read_lease(r.fleet_paths(tmp_path), 1)
    assert got == r.WorkerLease(**fields)
    assert got.expired(now=1007.0) and not got.expired(now=1006.0)
    assert got.age_s(now=1003.0) == pytest.approx(1.5)
    # byte for byte the other package's file
    other = tmp_path / "other"
    r.write_lease(r.fleet_paths(other).ensure(), r.WorkerLease(**fields))
    assert (other / "leases" / "worker_1.json").read_bytes() == \
        (tmp_path / "leases" / "worker_1.json").read_bytes()
    r.clear_lease(r.fleet_paths(tmp_path), 1)
    assert w.read_lease(w.fleet_paths(tmp_path), 1) is None
    r.clear_lease(r.fleet_paths(tmp_path), 1)          # idempotent


@pytest.mark.parametrize("text", ["{not json", '{"unexpected": "fields"}', "", "[1, 2]"])
def test_corrupt_lease_reads_as_absent(tmp_path, text):
    paths = TF.FleetPaths(tmp_path).ensure()
    paths.lease_file(0).write_text(text)
    before = tracing.registry().counters("faults/").get("faults/fleet_lease_corrupt", 0)
    assert TF.read_lease(paths, 0) is None
    assert JF.read_lease(JF.FleetPaths(tmp_path), 0) is None
    assert tracing.registry().counters("faults/")["faults/fleet_lease_corrupt"] == before + 1
    assert TF.read_lease(paths, 7) is None            # absent


def test_lease_heartbeat_renews_until_stopped(tmp_path):
    paths = TF.fleet_paths(tmp_path)
    lease = TF.WorkerLease(index=0, pid=os.getpid(), port=1, vae_scale=8, lease_s=1.0)
    hb = TF.LeaseHeartbeat(paths, lease, 0.05).start()
    try:
        first = TF.read_lease(paths, 0).renewed_at
        deadline = time.monotonic() + 10
        while TF.read_lease(paths, 0).renewed_at == first:
            assert time.monotonic() < deadline
            time.sleep(0.02)
    finally:
        hb.stop()
    assert JF.read_lease(JF.fleet_paths(tmp_path), 0).pid == os.getpid()


@pytest.mark.parametrize("values", [
    (16, 2, 7.5, "ddim", 0.0), [512, 20, 3.5, "dpm++", 0.1, 0.5, 1],
    (256, 50, 7.5, "ddpm", 0.0, 0.0, 2)])
def test_bucket_from_tuple_round_trips_as_in_jax(values):
    t, j = TF.bucket_from_tuple(values), JF.bucket_from_tuple(values)
    assert tuple(t) == tuple(j)
    assert TF.bucket_from_tuple(tuple(t)) == t and TF.bucket_from_tuple(list(t)) == t
    with pytest.raises(ValueError):
        TF.bucket_from_tuple(tuple(values)[:5] + (0.5,))


# ---------------------------------------------------------------------------
# the Prometheus merge
# ---------------------------------------------------------------------------

_EXPOSITIONS = [
    "dcr_up 1\n",
    '# HELP m h\n# TYPE m summary\nm{quantile="0.99"} 0.5\nm_sum 2.0\nm_count 4\n',
    "weird-line-without-space\n\n# comment only\nx{} 3\n",
]


@pytest.mark.parametrize("text", _EXPOSITIONS)
@pytest.mark.parametrize("labels", [{"worker": "1"}, {"worker": "0", "9bad name": 'q"uo\\te\n'},
                                    {}])
def test_inject_labels_gives_the_jax_strings(text, labels):
    assert TSc.inject_labels(text, labels) == JSc.inject_labels(text, labels)


def test_merge_expositions_gives_the_jax_strings():
    reg = tracing.registry()
    reg.counter("fleet/accepted").inc(3)
    reg.gauge("serve/queue_depth").set(2.0)
    reg.histogram("serve/request_latency_s").observe(0.25)
    port_text = reg.prometheus_text()
    sections = [port_text, TSc.inject_labels(port_text, {"worker": "0"}),
                TSc.inject_labels(port_text, {"worker": "1"}), *_EXPOSITIONS]
    merged = TSc.merge_expositions(sections)
    assert merged == JSc.merge_expositions(sections)
    assert merged.count("# TYPE dcr_fleet_accepted counter") == 1
    assert 'dcr_fleet_accepted{worker="1"} 3' in merged


def test_scrape_cache_keeps_the_last_good_text_and_bounds_a_dead_worker():
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            data = b"dcr_up 1\n"
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    cache = TSc.ScrapeCache("127.0.0.1", 0.5)
    try:
        assert cache.scrape(0, port)
    finally:
        httpd.shutdown()
        httpd.server_close()
    t0 = time.monotonic()
    assert not cache.scrape(0, port)               # dead: a bounded failure
    assert time.monotonic() - t0 < 5
    text, age = cache.snapshot()[0]
    assert text == "dcr_up 1\n" and age >= 0       # the last good text stays
    cache.forget(0)
    assert cache.snapshot() == {}


@pytest.mark.parametrize("error", ["DrainingError: service is draining",
                                   "QueueFullError: queue is full",
                                   "InvalidRequestError: bad steps",
                                   "BucketLimitError: budget",
                                   "RuntimeError: generation failed"])
def test_retryable_item_errors_as_in_jax(error):
    assert TSup.retryable_item_error(error) == JSup.retryable_item_error(error)


# ---------------------------------------------------------------------------
# the supervisor without subprocesses
# ---------------------------------------------------------------------------

def _sup_cfg(tmp_path, **kw) -> TC.ServeConfig:
    base = dict(resolution=16, num_inference_steps=2, sampler="ddim",
                fleet=TC.FleetConfig(workers=1, dir=str(tmp_path)))
    base.update(kw)
    return TC.ServeConfig(**base)


def test_supervisor_admission_gates_sheds_and_rolls_back_buckets(tmp_path):
    """No worker yet: a typed 503 no_workers. A queue-rejected novel bucket
    frees its slot; a third bucket past the budget is refused; a breached
    queue-wait p99 with a backlog sheds with Retry-After."""
    cfg = _sup_cfg(tmp_path, queue_depth=1, max_compiled_buckets=2)
    sup = TSup.FleetSupervisor(cfg)               # not started: no subprocesses
    try:
        with pytest.raises(TQ.NoWorkersError):
            sup.submit("a", seed=0)
        assert sup.health() == "warming"
        sup._vae_scale = 8                         # as if a worker had joined
        first = sup.submit("a", seed=0)            # the default bucket fills the queue
        assert first.trace_id and sup.journal.counts()["accepted"] == 1
        novel = _bucket(TQ, steps=7)
        with pytest.raises(TQ.QueueFullError):
            sup.submit("b", seed=1, bucket=novel)
        assert novel not in sup._admitted_buckets
        sup.queue.take_group(8)
        sup.submit("c", seed=2, bucket=novel)
        with pytest.raises(TQ.BucketLimitError):
            sup.submit("d", seed=3, bucket=_bucket(TQ, steps=9))
        with pytest.raises(TQ.InvalidRequestError):
            sup.submit("e", seed=4, bucket=_bucket(TQ, sampler="bogus"))
        code, payload, headers = TS.admission_response(TQ.NoWorkersError("x", 0.2))
        assert (code, payload["error"], headers) == (503, "no_workers", {"Retry-After": "1"})
    finally:
        sup.journal.close()

    shed_cfg = _sup_cfg(tmp_path / "shed", max_batch=1,
                        fleet=TC.FleetConfig(workers=1, dir=str(tmp_path / "shed"),
                                             slo_queue_wait_p99_s=0.5,
                                             shed_retry_after_s=7.0))
    sup = TSup.FleetSupervisor(shed_cfg)
    try:
        sup._vae_scale = 8
        sup.submit("x", seed=0)                    # a backlog of max_batch
        sup.metrics.queue_wait.observe(2.0)        # p99 over its target
        with pytest.raises(TQ.SloShedError) as e:
            sup.submit("y", seed=1)
        assert e.value.retry_after_s == 7.0
        assert tracing.registry().counters("fleet/")["fleet/shed"] >= 1
    finally:
        sup.journal.close()


def test_supervisor_merged_metrics_come_from_the_cache_only(tmp_path):
    cfg = _sup_cfg(tmp_path, fleet=TC.FleetConfig(workers=2, dir=str(tmp_path)))
    sup = TSup.FleetSupervisor(cfg)
    try:
        for slot in sup._slots:
            slot.state = TSup.ALIVE
        now = time.time()
        sup._scrape._cache = {0: ("dcr_serve_completed_total 3.0\n", now),
                              1: ("dcr_serve_completed_total 5.0\n", now - 3600.0)}
        text = sup.prometheus_merged()
        assert 'dcr_fleet_worker_up{worker="0"} 1' in text
        assert 'dcr_fleet_worker_up{worker="1"} 0' in text   # stale: down
        assert 'dcr_serve_completed_total{worker="0"} 3.0' in text
        assert 'dcr_serve_completed_total{worker="1"} 5.0' in text
        assert text.count("# TYPE dcr_fleet_worker_up gauge") == 1
        for line in text.splitlines():
            assert line.startswith("#") or len(line.rsplit(" ", 1)) == 2, line
        status = sup.status()
        assert status["role"] == "supervisor" and len(status["workers"]) == 2
        assert sup.slo_doc()["enabled"] is True
    finally:
        sup.journal.close()


# ---------------------------------------------------------------------------
# the worker's wire path: /generate_batch with the JAX supervisor's items
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stack():
    mc = TC.ModelConfig.tiny()
    models = build_models(mc, "cpu", seed=0)
    from dcr_tpu_torch.data.tokenizer import HashTokenizer

    return GenerationStack(models, mc, HashTokenizer(mc.text_vocab_size, mc.text_max_length),
                           torch.device("cpu"))


def _serve_cfg(**kw) -> TC.ServeConfig:
    base = dict(resolution=16, num_inference_steps=2, sampler="ddim", max_batch=2,
                max_wait_ms=30.0, queue_depth=16, seed=0)
    base.update(kw)
    return TC.ServeConfig(**base)


def _post(port, path, body, timeout=120):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path, timeout=30):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _png(doc) -> np.ndarray:
    return decode_png(base64.b64decode(doc["image_png_b64"]))


def _u8(img) -> np.ndarray:
    return (np.asarray(img) * 255.0).round().astype(np.uint8)


def test_generate_batch_answers_the_jax_supervisors_wire_items(stack):
    svc = TW.GenerationService(_serve_cfg(), stack)
    svc.start()
    httpd = TS.make_server(_serve_cfg(port=0), svc)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        jb = JQ.GenBucket(*tuple(svc.default_bucket()))
        jobs = [("a red square", 1), ("a blue circle", 2)]
        items, roots = [], []
        for attempt, (prompt, seed) in enumerate(jobs, start=1):
            jreq = JQ.Request(prompt=prompt, seed=seed, bucket=jb)
            jreq.trace_id = JT.new_trace_id()
            jreq.span = JT.begin_span("serve/request", parent=None, trace=jreq.trace_id)
            roots.append(jreq.span)
            items.append(JSup.wire_item(jreq, jb, attempt))
        code, doc = _post(port, "/generate_batch", {"requests": items})
        assert code == 200 and len(doc["results"]) == 2
        ref = svc.execute([TQ.Request(p, s, svc.default_bucket()) for p, s in jobs])
        for res, img in zip(doc["results"], ref):
            np.testing.assert_array_equal(_png(res), _u8(img))
            assert set(res) == {"id", "image_png_b64", "width", "height", "cache_hit",
                                "copy_risk", "latency_ms"}
        # each worker root joined the item's trace: remote parent, attempt
        recs = [r for r in tracing.flight_records() if r["name"] == "serve/request"]
        for attempt, root in enumerate(roots, start=1):
            mine = [r for r in recs if r.get("trace") == root.trace]
            assert len(mine) == 1
            assert mine[0]["args"]["remote_parent"] == root.id
            assert mine[0]["args"]["attempt"] == attempt
        # per-item failures are typed items beside a good one
        good = dict(items[0], trace=None)
        code, doc = _post(port, "/generate_batch", {"requests": [
            good, dict(good, sampler="bogus"), "not an object", {"seed": 3},
            dict(good, bogus=1)]})
        assert code == 200
        res = doc["results"]
        np.testing.assert_array_equal(_png(res[0]), _u8(ref[0]))
        assert res[1]["error"].startswith("InvalidRequestError: sampler must be")
        assert res[2]["error"] == "ValueError: body must be a JSON object"
        assert res[3]["error"] == "KeyError: 'prompt'"
        assert res[4]["error"].startswith("ValueError: unknown request fields")
        assert not any(JSup.retryable_item_error(r["error"]) for r in res[1:])
        # a malformed envelope is a 400 (the supervisor requeues the batch)
        for body in ({"requests": []}, {"nope": 1}, {"requests": "x"}, b"not json"):
            assert _post(port, "/generate_batch", body)[0] == 400
        # /slo: no engine on a worker
        assert _get(port, "/slo")[0] == 404
        # a draining worker refuses its items with a retryable error
        svc.begin_drain()
        code, doc = _post(port, "/generate_batch", {"requests": [good]})
        assert code == 200 and doc["results"][0]["error"].startswith("DrainingError:")
        assert TSup.retryable_item_error(doc["results"][0]["error"])
    finally:
        svc.begin_drain()
        assert svc.join_drained(timeout=60)
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# the fault hooks
# ---------------------------------------------------------------------------

_HOOK_CHILD = textwrap.dedent("""
    import sys, torch
    from dcr_tpu_torch.core.config import ModelConfig, ServeConfig
    from dcr_tpu_torch.data.tokenizer import HashTokenizer
    from dcr_tpu_torch.sampling.pipeline import GenerationStack, build_models
    from dcr_tpu_torch.serve.worker import GenerationService
    mc = ModelConfig.tiny()
    stack = GenerationStack(build_models(mc, "cpu", seed=0), mc,
                            HashTokenizer(mc.text_vocab_size, mc.text_max_length),
                            torch.device("cpu"))
    svc = GenerationService(ServeConfig(resolution=16, num_inference_steps=2,
                                        sampler="ddim", max_batch=2, max_wait_ms=0,
                                        hang_timeout_s=float(sys.argv[1])), stack)
    svc.start()
    for seed in range(3):
        svc.submit("x", seed=seed).future.result(timeout=120)
        print("answered", seed, flush=True)
    print("no fault fired", flush=True)
""")


@pytest.mark.parametrize("spec,rc,answered", [
    ("worker_crash@batch=1&rank=0", -signal.SIGKILL, 1),
    ("worker_hang@batch=2", 89, 2),
])
def test_worker_crash_and_hang_kill_the_worker(tmp_path, spec, rc, answered):
    """worker_crash is a real SIGKILL before the batch; worker_hang wedges the
    batch thread until the watchdog's hang_abort: every thread's stack, a
    flight-recorder dump under DCR_FLIGHTREC_DIR, exit 89."""
    env = dict(os.environ, DCR_FAULTS=spec, DCR_WORKER_INDEX="0", OMP_NUM_THREADS="1",
               DCR_FLIGHTREC_DIR=str(tmp_path),
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _HOOK_CHILD, "10"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    out = proc.stdout + proc.stderr
    assert proc.returncode == rc, out[-3000:]
    assert out.count("answered") == answered and "no fault fired" not in out
    assert '[fault] injected {"batch": %d' % answered in out
    if rc == 89:
        assert "hang watchdog: aborting 'serve_batch' with exit code 89" in out
        assert "watchdog_timeout" in out and "Thread" in out     # every stack
        dump = json.loads((tmp_path / "flightrec_w0_0.json").read_text())
        assert dump["reason"].startswith("hang_abort:serve_batch")


def test_slow_step_stalls_the_batch_and_the_watchdog_stays_quiet(stack, monkeypatch):
    monkeypatch.setenv("DCR_SLOW_STEP_S", "0.6")
    faults.install("slow_step@batch=1")
    aborts = []
    svc = TW.GenerationService(_serve_cfg(hang_timeout_s=120.0), stack)
    monkeypatch.setattr(svc, "_on_hang", lambda: aborts.append(1))
    try:
        times = []
        for seed in range(3):
            req = TQ.Request("x", seed, svc.default_bucket())
            t0 = time.monotonic()
            svc._process([req])
            times.append(time.monotonic() - t0)
            assert req.future.result(timeout=1).shape == (16, 16, 3)
        assert times[1] >= 0.6
        assert aborts == [] and faults.registry().pending() == []
    finally:
        faults.clear()


def test_batch_watchdog_calls_hang_abort_past_its_budget(stack, monkeypatch):
    faults.install("slow_step@batch=0")
    monkeypatch.setenv("DCR_SLOW_STEP_S", "1.0")
    aborts = []
    svc = TW.GenerationService(_serve_cfg(hang_timeout_s=0.3), stack)
    monkeypatch.setattr(svc, "_on_hang", lambda: aborts.append(time.monotonic()))
    try:
        req = TQ.Request("x", 0, svc.default_bucket())
        svc._process([req])
        assert len(aborts) == 1 and req.future.done()
    finally:
        faults.clear()


# ---------------------------------------------------------------------------
# a CPU fleet of 2 workers, worker 0 SIGKILLed: zero dropped, bit-equal
# ---------------------------------------------------------------------------

def _export_ckpt(root: Path) -> Path:
    ckpt = root / "checkpoint"
    mc = TC.ModelConfig.tiny()
    models = build_models(mc, "cpu", seed=0)
    export_hf_layout(ckpt, unet=models.unet.state_dict(), vae=models.vae.state_dict(),
                     text_encoder=models.text_encoder.state_dict(),
                     model_config=dataclasses.asdict(mc))
    return ckpt


def test_cpu_fleet_requeues_a_crashed_workers_batch_with_zero_drops(tmp_path):
    ckpt = _export_ckpt(tmp_path)
    fleet_dir = tmp_path / "fleet"
    argv = [f"--model_path={ckpt}", "--port=0", "--resolution=16", "--num_inference_steps=2",
            "--sampler=ddim", "--max_batch=2", "--max_wait_ms=100", "--seed=0",
            "--request_timeout_s=120", "--fleet.workers=2", f"--fleet.dir={fleet_dir}",
            "--fleet.heartbeat_s=0.5", "--fleet.lease_s=10", "--fleet.max_attempts=6",
            "--fleet.respawn_base_delay_s=0.2", "--fleet.scrape_period_s=0.5",
            "--fleet.dispatch_timeout_s=120", "--fleet.spawn_timeout_s=120"]
    # one intra-op thread in every process: the in-process reference below
    # runs with one too, so the float sums are the same
    env = dict(os.environ, DCR_TPU_PLATFORM="cpu", DCR_FAULTS="worker_crash@batch=0&rank=0",
               OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "dcr_tpu_torch.cli.serve", *argv], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True).start()
    jobs = [(p, s) for s in (1, 2) for p in ("a red square", "a blue circle")]
    try:
        deadline = time.monotonic() + 120
        port = None
        while True:
            if port is None:
                m = re.search(r"supervisor listening on http://127\.0\.0\.1:(\d+)",
                              "".join(lines))
                port = int(m.group(1)) if m else None
            if port is not None:
                health = json.loads(_get(port, "/healthz")[1])
                if health["status"] == "ok" and health["workers_ready"] == 2:
                    break
            assert proc.poll() is None and time.monotonic() < deadline, "".join(lines)[-4000:]
            time.sleep(0.1)
        with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
            results = list(ex.map(lambda j: _post(port, "/generate",
                                                  {"prompt": j[0], "seed": j[1]}), jobs))
        assert [code for code, _ in results] == [200] * len(jobs), results
        status = json.loads(_get(port, "/metrics")[1])
        assert status["fleet"]["workers_lost"] >= 1 and status["journal"]["requeued_total"] >= 1
        # the respawned worker 0 comes back ready
        while json.loads(_get(port, "/metrics")[1])["workers_alive"] != 2:
            assert time.monotonic() < deadline, "".join(lines)[-4000:]
            time.sleep(0.1)
        time.sleep(1.2)                            # two scrape periods
        code, raw = _get(port, "/metrics?format=prometheus")
        text = raw.decode()
        assert code == 200 and 'dcr_fleet_worker_up{worker="0"} 1' in text
        assert 'dcr_serve_completed_total{worker="1"}' in text
        slo = json.loads(_get(port, "/slo")[1])
        assert slo["enabled"] and {"availability", "shed_rate"} <= set(slo["objectives"])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 83, "".join(lines)[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    replay = TF.RequestJournal.replay(fleet_dir / "journal.jsonl")
    assert replay == JF.RequestJournal.replay(fleet_dir / "journal.jsonl")
    counts = replay["counts"]
    assert counts["accepted"] == len(jobs) == counts["acked"]
    assert counts["dropped"] == 0 and counts["failed"] == 0 and counts["requeued_total"] >= 1
    # every image is the in-process service's, bit for bit
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = _serve_cfg()
        svc = TW.GenerationService(cfg, load_generation_stack(
            TC.SampleConfig(model_path=str(ckpt), resolution=16), device="cpu"))
        ref = np.concatenate([svc.execute([TQ.Request(p, s, svc.default_bucket())
                                           for p, s in jobs[i:i + 2]])
                              for i in range(0, len(jobs), 2)])
    finally:
        torch.set_num_threads(threads)
    for (_, doc), img in zip(results, ref):
        np.testing.assert_array_equal(_png(doc), _u8(img))
