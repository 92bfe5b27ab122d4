"""dcr-status-torch: a one-command fleet health snapshot (the port of
``dcr-status``).

    dcr-status-torch [--host=...] [--port=8000] [--json] [--store_dir=...]

One stdlib-only round trip answers "is the fleet healthy": worker
leases and journal backlog (``GET /metrics``), the SLO states (``GET
/slo``), live-ingest lag, ANN staleness and online recall aggregated from
the fleet's merged Prometheus text, and, with ``--store_dir``, the
three-tier store summary ``dcr-search-torch stats`` prints. It reads a
JAX fleet's front end as it reads the port's. Exit codes:

    0   reachable and no SLO objective in breach
    1   reachable but some objective is BREACHED (or health "failed")
    2   front end unreachable / malformed reply

argparse, http.client and json only: the store summary's import (torch)
happens only when ``--store_dir`` is given.
"""

from __future__ import annotations

import argparse
import http.client
import json
import re
import sys

_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')

_STATE_MARK = {"ok": "ok", "warn": "WARN", "breach": "BREACH"}


def get_json(host: str, port: int, path: str, timeout: float) -> dict:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode("utf-8", "replace")
    finally:
        conn.close()
    doc = json.loads(body)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: expected a JSON object")
    doc["_http_status"] = resp.status
    return doc


def get_text(host: str, port: int, path: str, timeout: float) -> str:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode("utf-8", "replace")
    finally:
        conn.close()


def parse_series(text: str) -> list[tuple[str, dict, float]]:
    """Labeled Prometheus text -> [(name, labels, value)]. Tolerant by
    design: comment and malformed lines are skipped, never fatal — a
    status tool must degrade, not crash, on a half-scraped exposition."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line.strip())
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
        out.append((m.group("name"), labels, value))
    return out


def aggregate_worker_series(series) -> dict:
    """Fold the per-worker ingest and ANN series into the fleet view:
    lag and staleness take the WORST worker (max), recall weights each
    worker by its probe sample count, backlog/growth sum."""
    by_name: dict[str, list[float]] = {}
    recall: dict[str, dict[str, float]] = {}
    for name, labels, value in series:
        by_name.setdefault(name, []).append(value)
        w = labels.get("worker")
        if w is not None and name in ("dcr_ann_recall_online_pct",
                                      "dcr_ann_recall_online_samples"):
            recall.setdefault(w, {})[name] = value
    def agg(name, fn):
        vals = by_name.get(name)
        return fn(vals) if vals else None
    num = den = 0.0
    for doc in recall.values():
        n = doc.get("dcr_ann_recall_online_samples", 0.0)
        pct = doc.get("dcr_ann_recall_online_pct")
        if n > 0 and pct is not None:
            num += pct * n
            den += n
    return {
        "ingest_lag_seconds": agg("dcr_ingest_lag_seconds", max),
        "ingest_oldest_unfolded_age_s":
            agg("dcr_ingest_oldest_unfolded_age_s", max),
        "ingest_backlog_rows": agg("dcr_ingest_backlog_rows", sum),
        "store_growth_rows_per_s": agg("dcr_store_growth_rows_per_s", sum),
        "ann_staleness_rows": agg("dcr_ann_staleness_rows", max),
        "recall_online_pct": round(num / den, 2) if den > 0 else None,
        "recall_online_samples": int(den),
    }


def collect(host: str, port: int, timeout: float,
            store_dir: str = "") -> dict:
    """The full status document (the ``--json`` payload)."""
    health = get_json(host, port, "/healthz", timeout)
    status = get_json(host, port, "/metrics", timeout)
    slo = get_json(host, port, "/slo", timeout)
    if slo.pop("_http_status", 200) == 404:
        slo = {"enabled": False}
    series = parse_series(
        get_text(host, port, "/metrics?format=prometheus", timeout))
    health.pop("_http_status", None)
    status.pop("_http_status", None)
    doc = {
        "reachable": True,
        "target": f"{host}:{port}",
        "health": health,
        "slo": slo,
        "workers": status.get("workers", []),
        "workers_alive": status.get("workers_alive"),
        "queue_depth": status.get("queue_depth"),
        "journal": status.get("journal", {}),
        "live": aggregate_worker_series(series),
    }
    if store_dir:
        # the three-tier summary imports torch: only on demand, so the
        # plain status path stays stdlib-fast
        from dcr_tpu_torch.cli.search import store_stats

        try:
            doc["store"] = store_stats(store_dir)
        except Exception as e:
            doc["store"] = {"error": repr(e), "store_dir": store_dir}
    return doc


def exit_code(doc: dict) -> int:
    if not doc.get("reachable"):
        return 2
    health = doc.get("health", {})
    if health.get("status") == "failed":
        return 1
    slo = doc.get("slo", {})
    if slo.get("enabled") and slo.get("state") == "breach":
        return 1
    return 0


def _fmt(value, suffix="") -> str:
    if value is None:
        return "-"
    if isinstance(value, float):
        value = round(value, 3)
    return f"{value}{suffix}"


def render_human(doc: dict) -> str:
    lines = []
    health = doc.get("health", {})
    lines.append(f"fleet      {doc['target']}  health={health.get('status')}"
                 f"  risk={health.get('risk', 'absent')}")
    lines.append(f"workers    {_fmt(doc.get('workers_alive'))} alive  "
                 f"queue_depth={_fmt(doc.get('queue_depth'))}")
    for w in doc.get("workers", []):
        if isinstance(w, dict):
            lines.append(f"  worker {w.get('index')}: {w.get('state')}"
                         f" (respawns={w.get('failures', 0)})")
    journal = doc.get("journal", {})
    if journal:
        pairs = "  ".join(f"{k}={v}" for k, v in sorted(journal.items()))
        lines.append(f"journal    {pairs}")
    slo = doc.get("slo", {})
    if not slo.get("enabled"):
        lines.append("slo        disabled")
    else:
        lines.append(f"slo        {_STATE_MARK.get(slo.get('state'), '?')}  "
                     f"(breaches={slo.get('breach_total', 0)}, windows="
                     f"{'/'.join(str(int(w)) for w in slo.get('windows_s', []))}s)")
        for name, obj in sorted(slo.get("objectives", {}).items()):
            mark = _STATE_MARK.get(obj.get("state"), "?")
            sign = "<" if obj.get("kind") == "max" else ">"
            lines.append(
                f"  {mark:6s} {name:20s} value={_fmt(obj.get('value')):>10s} "
                f"(want {sign}= {_fmt(obj.get('target'))}, "
                f"burn {_fmt(obj.get('burn_short'))}/"
                f"{_fmt(obj.get('burn_long'))}, "
                f"n={obj.get('samples', 0)})")
    live = doc.get("live", {})
    lines.append(f"ingest     lag={_fmt(live.get('ingest_lag_seconds'), 's')}  "
                 f"oldest={_fmt(live.get('ingest_oldest_unfolded_age_s'), 's')}"
                 f"  backlog={_fmt(live.get('ingest_backlog_rows'))} rows  "
                 f"growth={_fmt(live.get('store_growth_rows_per_s'))} rows/s")
    lines.append(f"ann        staleness={_fmt(live.get('ann_staleness_rows'))}"
                 f" rows  online_recall="
                 f"{_fmt(live.get('recall_online_pct'), '%')} "
                 f"({live.get('recall_online_samples', 0)} samples)")
    store = doc.get("store")
    if store:
        if "error" in store:
            lines.append(f"store      {store['store_dir']}: {store['error']}")
        else:
            c = store.get("committed", {})
            lv = store.get("live", {})
            a = store.get("ann")
            lines.append(
                f"store      {store.get('store_dir')}: "
                f"{c.get('rows')} committed rows (snapshot "
                f"v{c.get('snapshot')}), {lv.get('tail_rows')} WAL tail, "
                + (f"ann {a.get('rows')} rows/{a.get('n_lists')} lists"
                   if a else "no ann tier"))
    return "\n".join(lines)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="dcr-status-torch",
        description="Snapshot fleet health: leases, SLO states, journal, "
                    "store tiers, ANN staleness, online recall.")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--timeout", type=float, default=5.0,
                        help="per-request HTTP timeout (seconds)")
    parser.add_argument("--store_dir", default="",
                        help="also print the three-tier store summary "
                             "(imports torch)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable output")
    args = parser.parse_args(argv)
    try:
        doc = collect(args.host, args.port, args.timeout, args.store_dir)
    except Exception as e:
        doc = {"reachable": False,
               "target": f"{args.host}:{args.port}", "error": repr(e)}
    if args.as_json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        if doc.get("reachable"):
            print(render_human(doc))
        else:
            print(f"dcr-status-torch: {doc['target']} unreachable: {doc['error']}",
                  file=sys.stderr)
    raise SystemExit(exit_code(doc))


if __name__ == "__main__":
    main()
