"""Fleet metrics aggregation: scrape worker registries, merge expositions
(own copy of ``dcr_tpu/serve/scrape.py``; the merged text is the JAX
package's string for string).

The supervisor pulls its own fleet's Prometheus text:

- :class:`ScrapeCache` polls each ALIVE worker's
  ``/metrics?format=prometheus`` on a bounded-timeout loop (socket-level
  timeout: a dead or wedged worker costs at most ``timeout_s``, never a
  hang) and keeps the **last good** text per worker with its scrape time;
- :func:`inject_labels` rewrites every sample line of an exposition with a
  ``worker="N"`` label so merged series stay distinguishable;
- :func:`merge_expositions` concatenates sections while deduplicating
  ``# HELP``/``# TYPE`` headers (the format allows each metric's header
  once per exposition).

Staleness is first-class: the merged document always carries
``dcr_fleet_worker_up{worker="N"}`` and
``dcr_fleet_worker_scrape_age_seconds{worker="N"}`` per slot, so a scrape
of the supervisor tells "worker 3 is dead, these are its last numbers"
from "worker 3 is fine".

Pure stdlib; the label and merge helpers are pure functions.
"""

from __future__ import annotations

import http.client
import threading
import time

from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.tracing import sanitize_label_name


def http_get_text(host: str, port: int, path: str,
                  timeout_s: float) -> tuple[int, str]:
    """One bounded GET over a fresh connection; (status, body text)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace")
    finally:
        conn.close()


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def inject_labels(text: str, labels: dict[str, str]) -> str:
    """Add ``labels`` to every sample line of a Prometheus exposition.

    Comment/blank lines pass through; existing label sets are extended
    (``m{quantile="0.99"}`` -> ``m{quantile="0.99",worker="1"}``). Label
    names are sanitized into valid identifiers, values escaped."""
    rendered = ",".join(
        f'{sanitize_label_name(k)}="{_escape_label_value(str(v))}"'
        for k, v in sorted(labels.items()))
    if not rendered:
        return text
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:           # malformed line: pass through untouched
            out.append(line)
            continue
        if name_part.endswith("}") and "{" in name_part:
            base, _, existing = name_part.partition("{")
            existing = existing[:-1]
            sep = "," if existing else ""
            out.append(f"{base}{{{existing}{sep}{rendered}}} {value_part}")
        else:
            out.append(f"{name_part}{{{rendered}}} {value_part}")
    return "\n".join(out) + "\n"


def merge_expositions(sections: list[str]) -> str:
    """Concatenate exposition sections, keeping each metric's ``# HELP`` /
    ``# TYPE`` header only the first time it appears (the text format allows
    one header per metric per exposition; sample lines with distinct label
    sets are exactly how multi-worker series coexist)."""
    seen_headers: set[tuple[str, str]] = set()
    out: list[str] = []
    for section in sections:
        for line in section.splitlines():
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                kind, _, rest = line[2:].partition(" ")
                metric = rest.split(" ", 1)[0]
                if (kind, metric) in seen_headers:
                    continue
                seen_headers.add((kind, metric))
            elif not line:
                continue
            out.append(line)
    return "\n".join(out) + "\n"


class ScrapeCache:
    """Last-good-text cache over the fleet's internal metrics ports.

    ``scrape()`` is called by the supervisor's scrape loop for each live
    worker; ``snapshot()`` is called by the ``/metrics`` handler and never
    blocks on the network — a dead worker surfaces as a growing
    ``scrape_age`` on its cached section, not a hanging scrape of the
    supervisor itself."""

    def __init__(self, host: str, timeout_s: float):
        self.host = host
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._cache: dict[int, tuple[str, float]] = {}   # index -> (text, t)

    def scrape(self, index: int, port: int) -> bool:
        try:
            status, text = http_get_text(
                self.host, port, "/metrics?format=prometheus", self.timeout_s)
        except (OSError, http.client.HTTPException) as e:
            R.log_trace("fleet_scrape_failed", worker=index, error=repr(e))
            tracing.registry().counter("fleet/scrape_errors").inc()
            return False
        if status != 200:
            R.log_event("fleet_scrape_bad_status", worker=index, status=status)
            tracing.registry().counter("fleet/scrape_errors").inc()
            return False
        with self._lock:
            self._cache[index] = (text, time.time())
        tracing.registry().counter("fleet/scrapes").inc()
        return True

    def forget(self, index: int) -> None:
        """Drop a retired slot's section (a respawned incarnation repopulates
        it on the next successful scrape)."""
        with self._lock:
            self._cache.pop(index, None)

    def snapshot(self) -> dict[int, tuple[str, float]]:
        """{index: (last good exposition text, age seconds)}."""
        now = time.time()
        with self._lock:
            return {i: (text, now - t) for i, (text, t) in self._cache.items()}
