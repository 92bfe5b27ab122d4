"""PyTorch port: the fleet's SLO engine (``dcr_tpu_torch.obs.slo``), the
supervisor's SLO signals, ``GET /slo`` and ``dcr-status-torch``
(``dcr_tpu_torch.cli.status``) against the JAX package's ``dcr_tpu.obs.slo``,
``dcr_tpu.serve.supervisor`` and ``dcr_tpu.cli.status``.

- the same signal sequences at an injected clock give the JAX engine's
  ``/slo`` document, states and exported gauges;
- ``parse_exposition`` and ``default_objectives`` give the JAX results;
- the supervisor's per-tick signals over the same scrape cache equal the
  JAX supervisor's;
- ``collect``, ``exit_code`` and ``render_human`` give ``dcr-status``'s
  results against a stub fleet behind the port's front end, and the CLI's
  exit codes (0, 1, 2) are dcr-status's.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

pytest.importorskip("jax")

import dcr_tpu.cli.status as JStatus  # noqa: E402
import dcr_tpu.core.config as JC  # noqa: E402
import dcr_tpu.core.tracing as JT  # noqa: E402
import dcr_tpu.obs.slo as JSlo  # noqa: E402
import dcr_tpu.serve.supervisor as JSup  # noqa: E402
import dcr_tpu_torch.cli.status as TStatus  # noqa: E402
import dcr_tpu_torch.core.config as TC  # noqa: E402
import dcr_tpu_torch.obs.slo as TSlo  # noqa: E402
import dcr_tpu_torch.serve.server as TS  # noqa: E402
import dcr_tpu_torch.serve.supervisor as TSup  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_tracing():
    tracing.reset_for_tests()
    JT.reset_for_tests()
    yield
    tracing.reset_for_tests()
    JT.reset_for_tests()


def _slo_cfg(pkg, **kw):
    """Tight windows and budget 0.5 (an all-bad window burns 2.0, the breach
    burn); no flight-recorder dump unless asked."""
    base = dict(short_window_s=10.0, long_window_s=30.0, warn_burn=1.0, breach_burn=2.0,
                recover_burn=0.5, budget=0.5, dump_after_s=-1.0)
    base.update(kw)
    return pkg.SloConfig(**base)


def _objectives(pkg):
    return [pkg.SloObjective("availability", "availability", "min", 0.9, "alive fraction"),
            pkg.SloObjective("shed_rate", "shed_rate", "max", 0.05, "shed share"),
            pkg.SloObjective("recall", "recall", "min", 0.8)]


def _ticks(kind: str):
    """(now, signals) per tick of one scenario."""
    t0 = 1000.0
    if kind == "breach_then_recover":
        good = [(t0 + i, {"availability": 1.0, "shed_rate": 0.0}) for i in range(20)]
        bad = [(t0 + 20 + i, {"availability": 0.5, "shed_rate": 0.5, "recall": 0.1})
               for i in range(40)]
        back = [(t0 + 60 + i, {"availability": 1.0, "shed_rate": None, "recall": 0.95})
                for i in range(40)]
        return good + bad + back
    if kind == "spike":
        return [(t0 + i, {"availability": 0.0 if 20 <= i < 26 else 1.0}) for i in range(40)]
    if kind == "none_drains":
        return ([(t0 + i, {"availability": 0.0}) for i in range(5)]
                + [(t0 + 5 + i, {"availability": None}) for i in range(40)])
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["breach_then_recover", "spike", "none_drains"])
def test_engine_doc_equals_the_jax_engines_at_an_injected_clock(kind):
    t_eng = TSlo.SloEngine(_slo_cfg(TC), _objectives(TSlo))
    j_eng = JSlo.SloEngine(_slo_cfg(JC), _objectives(JSlo))
    states = []
    for now, signals in _ticks(kind):
        t_eng.observe(signals, now=now)
        j_eng.observe(signals, now=now)
        with t_eng._lock, j_eng._lock:
            t_doc, j_doc = t_eng._doc_locked(now), j_eng._doc_locked(now)
        assert t_doc == j_doc
        states.append(t_doc["state"])
        for name in t_doc["objectives"]:
            assert (tracing.registry().gauge(f"slo/state/{name}").value
                    == JT.registry().gauge(f"slo/state/{name}").value)
            assert (tracing.registry().gauge(f"slo/burn_rate/{name}").value
                    == JT.registry().gauge(f"slo/burn_rate/{name}").value)
    assert t_eng.breached() == j_eng.breached()
    assert set(t_eng.doc()) == set(j_eng.doc())
    assert (tracing.registry().counters("slo/") == JT.registry().counters("slo/"))
    if kind == "breach_then_recover":
        assert "breach" in states and states[-1] == "ok"
        events = [r["name"] for r in tracing.flight_records()]
        assert "slo/breach" in events and "slo/recover" in events
    elif kind == "spike":
        assert "breach" not in states and "warn" in states
    else:
        assert states[-1] == "ok"


def test_sustained_breach_dumps_the_flight_recorder(tmp_path, monkeypatch):
    monkeypatch.delenv("DCR_WORKER_INDEX", raising=False)
    tracing.configure(tmp_path, rank=0)
    eng = TSlo.SloEngine(_slo_cfg(TC, dump_after_s=5.0), _objectives(TSlo)[:1])
    for i in range(8):                        # all bad: breach on the first tick
        eng.observe({"availability": 0.0}, now=4000.0 + i)
    doc = json.loads((tmp_path / "flightrec_0.json").read_text())
    assert doc["reason"] == "slo_breach_sustained: availability"
    assert doc["slo"]["objectives"]["availability"]["state"] == "breach"
    assert '"slo/breach"' in (tmp_path / "trace.jsonl").read_text()


@pytest.mark.parametrize("text", [
    "# HELP dcr_up h\n# TYPE dcr_up gauge\ndcr_up 1\n\n",
    'dcr_latency{quantile="0.99"} 0.5\ndcr_bad not-a-float\ndcr_ingest_lag_seconds 2.25\n',
    "noval\n x 1\ndcr_inf +Inf\ndcr_nan NaN\n",
])
def test_parse_exposition_as_in_jax(text):
    # repr: NaN != NaN
    assert repr(TSlo.parse_exposition(text)) == repr(JSlo.parse_exposition(text))


_PLANES = {
    "bare": [],
    "shed_target": ["--fleet.slo_queue_wait_p99_s=2.0"],
    "full": ["--fleet.slo_queue_wait_p99_s=2", "--ingest.enabled=true", "--risk.store_dir=/s",
             "--risk.ann=true"],
    "index_only": ["--risk.index_path=/x.npz"],
    "availability_off": ["--slo.availability_min=0"],
}


@pytest.mark.parametrize("plane", sorted(_PLANES))
def test_default_objectives_as_in_jax(plane):
    argv = _PLANES[plane]
    t = TSlo.default_objectives(TC.parse_cli(TC.ServeConfig, argv))
    j = JSlo.default_objectives(JC.parse_cli(JC.ServeConfig, argv))
    assert [vars(o) for o in t] == [vars(o) for o in j]
    if plane == "bare":
        assert {o.name for o in t} == {"availability", "shed_rate"}


def test_objective_and_engine_refusals_as_in_jax():
    for pkg in (TSlo, JSlo):
        with pytest.raises(ValueError):
            pkg.SloObjective("x", "x", "between", 1.0)
    with pytest.raises(ValueError, match="duplicate"):
        TSlo.SloEngine(_slo_cfg(TC), [TSlo.SloObjective("a", "a", "min", 1.0),
                                      TSlo.SloObjective("a", "b", "max", 1.0)])


# ---------------------------------------------------------------------------
# the supervisor's signals over one scrape cache, in both packages
# ---------------------------------------------------------------------------

_WORKER0_TEXT = ("# HELP h h\n# TYPE h gauge\n"
                 "dcr_ingest_lag_seconds 2.5\n"
                 "dcr_ingest_oldest_unfolded_age_s 7.5\n"
                 "dcr_ann_staleness_rows 1200\n"
                 "dcr_ann_recall_online_pct 90\n"
                 "dcr_ann_recall_online_samples 30\n"
                 "dcr_copy_risk_scored_total 5\n"
                 "dcr_serve_completed_total 10\n")
_WORKER1_TEXT = ("dcr_ingest_lag_seconds 40\n"
                 "dcr_ingest_oldest_unfolded_age_s 1\n"
                 "dcr_ann_staleness_rows 300\n"
                 "dcr_ann_recall_online_pct 50\n"
                 "dcr_ann_recall_online_samples 10\n")


def _supervisors(tmp_path, workers=2):
    out = []
    for pkg, sup, sub in ((TC, TSup, "port"), (JC, JSup, "jax")):
        cfg = pkg.ServeConfig(resolution=16, num_inference_steps=2, sampler="ddim",
                              fleet=pkg.FleetConfig(workers=workers, dir=str(tmp_path / sub)))
        s = sup.FleetSupervisor(cfg)          # never started: no subprocesses
        for slot in s._slots:
            slot.state = sup.ALIVE
        out.append(s)
    return out


def test_supervisor_signals_equal_the_jax_supervisors(tmp_path):
    sups = _supervisors(tmp_path)
    try:
        now = time.time()
        steps = [
            {0: (_WORKER0_TEXT, now), 1: (_WORKER1_TEXT, now)},
            {0: (_WORKER0_TEXT, now), 1: (_WORKER1_TEXT, now - 3600.0)},   # stale: invisible
            {0: ("dcr_copy_risk_scored_total 2\ndcr_serve_completed_total 3\n", now)},
            {0: ("dcr_copy_risk_scored_total 2\ndcr_serve_completed_total 3\n", now)},
        ]
        for i, cache in enumerate(steps):
            if i == 1:
                for reg in (tracing.registry(), JT.registry()):
                    reg.counter("fleet/accepted").inc(8)
                    reg.counter("fleet/shed").inc(2)
            for s in sups:
                s._scrape._cache = dict(cache)
            t_sig, j_sig = (s._slo_signals() for s in sups)
            assert t_sig == j_sig, (i, t_sig, j_sig)
        assert sups[0]._slo_signals()["availability"] == 0.5
    finally:
        for s in sups:
            s.journal.close()


# ---------------------------------------------------------------------------
# GET /slo and dcr-status-torch against a stub fleet
# ---------------------------------------------------------------------------

_STUB_PROM = (
    "# HELP dcr_fleet_worker_up up\n# TYPE dcr_fleet_worker_up gauge\n"
    'dcr_fleet_worker_up{worker="0"} 1\n'
    'dcr_fleet_worker_up{worker="1"} 1\n'
    'dcr_ingest_lag_seconds{worker="0"} 3.0\n'
    'dcr_ingest_lag_seconds{worker="1"} 40.0\n'
    'dcr_ingest_backlog_rows{worker="0"} 5\n'
    'dcr_ingest_backlog_rows{worker="1"} 7\n'
    'dcr_ann_staleness_rows{worker="0"} 1200\n'
    'dcr_ann_recall_online_pct{worker="0"} 90\n'
    'dcr_ann_recall_online_samples{worker="0"} 30\n'
    'dcr_ann_recall_online_pct{worker="1"} 50\n'
    'dcr_ann_recall_online_samples{worker="1"} 10\n'
    "garbage line here\n")


def _stub_slo_doc() -> dict:
    eng = TSlo.SloEngine(_slo_cfg(TC), _objectives(TSlo)[:2])
    for i in range(5):
        eng.observe({"availability": 0.0, "shed_rate": 0.0}, now=100.0 + i)
    return eng.doc()


class _StubFleetService:
    draining = False

    def __init__(self):
        self._slo = _stub_slo_doc()

    def health_doc(self):
        return {"status": "ok", "workers_ready": 2, "workers_total": 2, "risk": "absent"}

    def status(self):
        return {"workers_alive": 2, "queue_depth": 0,
                "workers": [{"index": 0, "state": "alive", "failures": 0},
                            {"index": 1, "state": "alive", "failures": 1}],
                "journal": {"in_flight": 0, "acked": 8}}

    def prometheus_merged(self):
        return _STUB_PROM

    def slo_doc(self):
        return dict(self._slo)


class _NoSloService:
    draining = False

    def health_doc(self):
        return {"status": "ok"}

    def status(self):
        return {}


def _serve_stub(service):
    cfg = TC.ServeConfig(resolution=16, num_inference_steps=2, sampler="ddim", port=0)
    httpd = TS.make_server(cfg, service)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def test_slo_endpoint_serves_the_doc_and_404s_without_an_engine():
    for service, code in ((_StubFleetService(), 200), (_NoSloService(), 404)):
        httpd, port = _serve_stub(service)
        try:
            for mod in (TStatus, JStatus):
                doc = mod.get_json("127.0.0.1", port, "/slo", 5.0)
                assert doc["_http_status"] == code
            if code == 200:
                assert doc["enabled"] is True and doc["state"] == "breach"
            assert TStatus.get_json("127.0.0.1", port, "/healthz", 5.0)["status"] == "ok"
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_status_collect_exit_code_and_render_as_in_jax(capsys):
    httpd, port = _serve_stub(_StubFleetService())
    try:
        t_doc = TStatus.collect("127.0.0.1", port, 5.0)
        j_doc = JStatus.collect("127.0.0.1", port, 5.0)
        assert t_doc == j_doc
        live = t_doc["live"]
        assert live["ingest_lag_seconds"] == 40.0 and live["ingest_backlog_rows"] == 12.0
        assert live["recall_online_pct"] == 80.0 and live["recall_online_samples"] == 40
        assert TStatus.exit_code(t_doc) == JStatus.exit_code(j_doc) == 1
        assert TStatus.render_human(t_doc) == JStatus.render_human(j_doc)
        assert "BREACH" in TStatus.render_human(t_doc)
        with pytest.raises(SystemExit) as e:
            TStatus.main([f"--port={port}", "--json"])
        assert e.value.code == 1
        assert json.loads(capsys.readouterr().out)["slo"]["state"] == "breach"
    finally:
        httpd.shutdown()
        httpd.server_close()
    httpd, port = _serve_stub(_NoSloService())
    try:
        t_doc = TStatus.collect("127.0.0.1", port, 5.0)
        assert t_doc == JStatus.collect("127.0.0.1", port, 5.0)
        assert t_doc["slo"] == {"enabled": False} and TStatus.exit_code(t_doc) == 0
        assert TStatus.render_human(t_doc) == JStatus.render_human(t_doc)
    finally:
        httpd.shutdown()
        httpd.server_close()
    for doc in ({"reachable": True, "health": {"status": "failed"}, "slo": {"enabled": False}},
                {"reachable": True, "health": {"status": "ok"}, "slo": {"enabled": False}},
                {"reachable": False}):
        assert TStatus.exit_code(doc) == JStatus.exit_code(doc)
    from tests._multiproc import free_port

    with pytest.raises(SystemExit) as e:
        TStatus.main([f"--port={free_port()}", "--timeout=1", "--json"])
    assert e.value.code == 2
    assert json.loads(capsys.readouterr().out)["reachable"] is False
