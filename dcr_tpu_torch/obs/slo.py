"""Declarative SLO engine with multi-window burn-rate alerting (own copy of
``dcr_tpu/obs/slo.py``; the ``/slo`` document is the JAX package's).

The judgment layer over the telemetry the fleet supervisor already
scrapes, the classic SRE multi-window burn-rate alert:

- an **objective** is one signal + target + direction (``kind="min"``:
  the value must stay at or above target, e.g. availability;
  ``kind="max"``: at or below, e.g. shed rate);
- every supervisor monitor tick feeds one sample per objective; a sample
  is *bad* when it violates the target. The **burn rate** over a window
  is ``bad_fraction / budget``: burn 1.0 consumes the error budget
  exactly as fast as allowed;
- the state machine is ``ok -> warn`` when the SHORT window burns past
  ``warn_burn``, ``-> breach`` only when BOTH windows burn past
  ``breach_burn`` (a lone spike cannot breach: the long window vetoes
  it), and back to ``ok`` once the short burn drops below
  ``recover_burn`` (< warn_burn: hysteresis, no flapping);
- state is exported as ``dcr_slo_burn_rate_<objective>``,
  ``dcr_slo_state_<objective>`` (0 ok / 1 warn / 2 breach) and
  ``dcr_slo_breach_total``; every transition emits a ``slo/breach`` /
  ``slo/recover`` trace event, and a breach sustained past
  ``dump_after_s`` dumps the flight recorder.

The engine is passive and clock-injectable: it never sleeps, scrapes or
spawns a thread. The supervisor's monitor loop calls
:meth:`SloEngine.observe` with the signals it has, and tests drive breach
-> recover with an explicit ``now``. ``GET /slo`` returns
:meth:`SloEngine.doc`; ``dcr-status-torch`` (``cli/status.py``) renders it
and exits 1 on any breach.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from dcr_tpu_torch.core import tracing

log = logging.getLogger("dcr_tpu_torch")

# objective states, exported as the dcr_slo_state_* gauge value
OK = "ok"
WARN = "warn"
BREACH = "breach"
_STATE_CODE = {OK: 0, WARN: 1, BREACH: 2}


def parse_exposition(text: str) -> dict[str, float]:
    """Unlabeled Prometheus text (one worker's own registry dump) ->
    ``{metric_name: value}``. Comment/blank lines and labeled series
    (histogram quantiles) are skipped — the SLO signals are all plain
    counters/gauges. Unparseable sample values are skipped, never raised:
    a half-written scrape must not take down the monitor loop."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#") or "{" in line:
            continue
        name, _, value = line.rpartition(" ")
        if not name:
            continue
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


@dataclass
class SloObjective:
    """One declarative objective: a named signal judged against a target.

    ``kind="min"`` breaches when the value drops BELOW target
    (availability, recall, coverage); ``kind="max"`` when it rises ABOVE
    (queue wait, shed rate, lag, staleness)."""

    name: str
    signal: str          # key into the signals dict observe() receives
    kind: str            # "min" | "max"
    target: float
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ("min", "max"):
            raise ValueError(
                f"objective {self.name}: kind must be 'min' or 'max', "
                f"got {self.kind!r}")

    def bad(self, value: float) -> bool:
        return value < self.target if self.kind == "min" \
            else value > self.target


class _ObjectiveState:
    """Per-objective sample window + state machine (engine-internal)."""

    def __init__(self, obj: SloObjective):
        self.obj = obj
        self.samples: deque = deque()   # (ts, value, bad)
        self.state = OK
        self.breach_since: Optional[float] = None
        self.breach_total = 0
        self.last_value: Optional[float] = None
        self.burn_short = 0.0
        self.burn_long = 0.0

    def burn(self, now: float, window_s: float, budget: float) -> float:
        lo = now - window_s
        n = bad = 0
        for ts, _, is_bad in self.samples:
            if ts >= lo:
                n += 1
                bad += is_bad
        return (bad / n) / budget if n else 0.0


class SloEngine:
    """Evaluate a set of :class:`SloObjective` against per-tick signal
    snapshots. Thread-safe (`observe` from the monitor loop, `doc` from
    HTTP handler threads); ``now`` is injectable for deterministic tests.
    """

    def __init__(self, cfg, objectives: list[SloObjective]):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._objs = {o.name: _ObjectiveState(o) for o in objectives}
        if len(self._objs) != len(objectives):
            raise ValueError("duplicate objective names")
        self.breach_total = 0
        self._dumped_for: set[str] = set()
        # export the initial all-ok state immediately: a scrape between
        # boot and the first monitor tick must see the series, not a gap
        reg = tracing.registry()
        reg.counter("slo/breach_total")
        for name in self._objs:
            reg.gauge(f"slo/burn_rate/{name}").set(0.0)
            reg.gauge(f"slo/state/{name}").set(0)

    def objectives(self) -> list[SloObjective]:
        return [s.obj for s in self._objs.values()]

    # -- evaluation (one call per monitor tick) ------------------------------

    def observe(self, signals: dict[str, Optional[float]],
                now: Optional[float] = None) -> None:
        """Feed one snapshot. A missing/None signal contributes no sample
        for that objective this tick (the window drains by time, so a
        signal that stops reporting decays toward recovery rather than
        latching its last verdict)."""
        now = time.time() if now is None else float(now)
        c = self.cfg
        with self._lock:
            for st in self._objs.values():
                obj = st.obj
                value = signals.get(obj.signal)
                if value is not None:
                    st.last_value = float(value)
                    st.samples.append((now, float(value),
                                       obj.bad(float(value))))
                lo = now - c.long_window_s
                while st.samples and st.samples[0][0] < lo:
                    st.samples.popleft()
                st.burn_short = st.burn(now, c.short_window_s, c.budget)
                st.burn_long = st.burn(now, c.long_window_s, c.budget)
                self._step_state(st, now)
                reg = tracing.registry()
                reg.gauge(f"slo/burn_rate/{obj.name}").set(st.burn_short)
                reg.gauge(f"slo/state/{obj.name}").set(
                    _STATE_CODE[st.state])

    def _step_state(self, st: _ObjectiveState, now: float) -> None:
        """ok -> warn -> breach -> ok transitions for one objective.
        Caller holds the lock; events/dumps fire inline (tracing never
        blocks)."""
        c = self.cfg
        obj = st.obj
        if st.state != BREACH:
            if (st.burn_short >= c.breach_burn
                    and st.burn_long >= c.breach_burn):
                st.state = BREACH
                st.breach_since = now
                st.breach_total += 1
                self.breach_total += 1
                reg = tracing.registry()
                reg.counter("slo/breach_total").inc()
                reg.counter(f"slo/breach_total/{obj.name}").inc()
                tracing.event("slo/breach", objective=obj.name,
                              value=st.last_value, target=obj.target,
                              kind=obj.kind,
                              burn_short=round(st.burn_short, 4),
                              burn_long=round(st.burn_long, 4))
                log.warning("slo: BREACH %s — value=%s target=%s "
                            "(burn %.2f/%.2f)", obj.name, st.last_value,
                            obj.target, st.burn_short, st.burn_long)
            elif st.state == OK and st.burn_short >= c.warn_burn:
                st.state = WARN
            elif st.state == WARN and st.burn_short < c.warn_burn:
                st.state = OK
        else:
            if st.burn_short <= c.recover_burn:
                duration = now - (st.breach_since or now)
                st.state = OK
                st.breach_since = None
                tracing.event("slo/recover", objective=obj.name,
                              value=st.last_value, target=obj.target,
                              breach_s=round(duration, 3),
                              burn_short=round(st.burn_short, 4))
                log.warning("slo: recovered %s after %.1fs", obj.name,
                            duration)
            elif (c.dump_after_s >= 0
                    and now - (st.breach_since or now) >= c.dump_after_s
                    and obj.name not in self._dumped_for):
                # sustained breach: leave the post-mortem while the
                # signals that caused it are still in the ring. Once per
                # objective per process (dump_flight_recorder itself is
                # additionally first-dump-wins).
                self._dumped_for.add(obj.name)
                tracing.dump_flight_recorder(
                    f"slo_breach_sustained: {obj.name}",
                    extra={"slo": self._doc_locked(now)})

    # -- introspection (GET /slo, dcr-status-torch) --------------------------

    def breached(self) -> bool:
        with self._lock:
            return any(s.state == BREACH for s in self._objs.values())

    def doc(self) -> dict:
        with self._lock:
            return self._doc_locked(time.time())

    def _doc_locked(self, now: float) -> dict:
        objectives = {}
        worst = OK
        for name, st in self._objs.items():
            obj = st.obj
            if _STATE_CODE[st.state] > _STATE_CODE[worst]:
                worst = st.state
            objectives[name] = {
                "state": st.state,
                "kind": obj.kind,
                "target": obj.target,
                "value": st.last_value,
                "burn_short": round(st.burn_short, 4),
                "burn_long": round(st.burn_long, 4),
                "samples": len(st.samples),
                "breach_total": st.breach_total,
                "breach_for_s": (round(now - st.breach_since, 3)
                                 if st.breach_since is not None else 0.0),
                "description": obj.description,
            }
        return {"enabled": True, "state": worst,
                "breach_total": self.breach_total,
                "windows_s": [self.cfg.short_window_s,
                              self.cfg.long_window_s],
                "objectives": objectives}


def default_objectives(cfg) -> list[SloObjective]:
    """The standard objective set for a serve fleet, derived from a
    :class:`~dcr_tpu_torch.core.config.ServeConfig`: objectives whose plane is
    not configured (no ingest, no ANN tier, no risk index) or whose
    target is disabled (<= 0) are simply absent — an objective that can
    never have a signal must not sit at burn 0 pretending to be met."""
    s = cfg.slo
    out: list[SloObjective] = []
    if s.availability_min > 0:
        out.append(SloObjective(
            "availability", "availability", "min", s.availability_min,
            "alive worker slots with a FRESH scrape / total slots"))
    if cfg.fleet.slo_queue_wait_p99_s > 0:
        out.append(SloObjective(
            "queue_wait_p99_s", "queue_wait_p99_s", "max",
            cfg.fleet.slo_queue_wait_p99_s,
            "request queue-wait p99 (same target admission sheds on)"))
    if s.shed_rate_max > 0:
        out.append(SloObjective(
            "shed_rate", "shed_rate", "max", s.shed_rate_max,
            "shed / (accepted + shed) over the tick window, not lifetime"))
    risk_on = bool(cfg.risk.store_dir or cfg.risk.index_path)
    if cfg.ingest.enabled and s.ingest_lag_s_max > 0:
        out.append(SloObjective(
            "ingest_lag_s", "ingest_lag_s", "max", s.ingest_lag_s_max,
            "max(queue ack lag, wall age of oldest acked-but-unfolded row)"))
    if cfg.risk.ann and s.ann_staleness_rows_max > 0:
        out.append(SloObjective(
            "ann_staleness_rows", "ann_staleness_rows", "max",
            s.ann_staleness_rows_max,
            "store rows (committed + tail) not yet folded into IVF lists"))
    if cfg.risk.ann and s.recall_min > 0:
        out.append(SloObjective(
            "recall", "recall", "min", s.recall_min,
            "rolling online recall@k of the ANN path vs the shadow-exact "
            "oracle (obs/recall_probe.py)"))
    if risk_on and s.coverage_min > 0:
        out.append(SloObjective(
            "coverage", "coverage", "min", s.coverage_min,
            "copy-risk-scored generations / completed generations per "
            "tick window"))
    return out
