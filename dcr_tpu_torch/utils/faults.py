"""Deterministic fault injection: the harness that proves recovery works
(own copy of ``dcr_tpu/utils/faults.py``, same grammar).

A fault spec is an env- or config-driven string of comma-separated entries:

    DCR_FAULTS="decode_error@step=3,ckpt_corrupt@step=200,nan_loss@step=5,sigterm@step=7"

Each entry is ``kind@key=value[&key=value...][xN]``: the fault ``kind`` fires
when a hook point reports coordinates matching EVERY ``key=value`` pair of
the entry (coordinates the entry does not name are ignored), at most ``N``
times (default 1). ``@`` also separates pairs, so ``nan_loss@step=5@rank=1``
reads naturally; the ``rank`` coordinate is implicit at every hook point and
is ``DCR_WORKER_INDEX`` (default 0): the port runs one process.

The kinds the port fires, and their hook points:

- ``decode_error``: ``data/loader.DataLoader``, per sample; coordinates
  ``step``, ``slot``, ``index`` (the dataset index), ``epoch``. Raises
  :class:`InjectedFault` through the path a real decode failure takes
  (quarantine and replacement, or fail-fast when the budget is 0).
- ``ckpt_corrupt``: ``core/checkpoint.CheckpointManager.save``, coordinate
  ``step``: after the save commits, zero-fills every file of the step
  directory (a torn write), so the next restore must fall back.
- ``nan_loss``: the Trainer loop, coordinate ``step`` (micro-step): poisons
  the next observed loss, driving the rollback-or-fail-fast path.
- ``sigterm``: the Trainer loop, coordinate ``step``: sends the process a
  real SIGTERM, driving the checkpoint-and-exit-83 path.
- ``hang``: the Trainer loop, coordinate ``step``: wedges the loop forever,
  driving the hang watchdog's exit 89 (``core/coordination.py``).
- ``search_dump_corrupt``: ``search/embed.load_embeddings``, coordinate
  ``load`` (the process's verified-dump read index): damages the read bytes
  in memory so the sha256-sidecar check fails through its real path.
- ``store_shard_corrupt``: ``search/store.EmbeddingStoreReader``, coordinate
  ``load`` (the reader's shard read index): the same for a store shard,
  which is then quarantined while the store serves the surviving rows.
- ``ivf_list_corrupt``: ``search/ann.AnnIndexReader.load_list``, coordinate
  ``load`` (the reader's list read index): damages an inverted list's bytes
  in memory, so the list is quarantined, counted and rebuilt from the store.
- ``kmeans_nan``: ``search/ann.train_ivf``, coordinate ``iter`` (the Lloyd
  iteration): poisons one centroid update, driving the bounded seed-shifted
  restart (and the typed failure once the restarts run out).

The JAX package's other kinds have no hook in the port yet, and a spec that
names one raises :class:`NotPortedError` when it is parsed: a fault that
silently never fires would invalidate the run that asked for it.

The registry is process-global, parsed once from ``DCR_FAULTS`` (tests use
:func:`install` and :func:`clear`), thread-safe (loader workers fire
concurrently) and free when empty: a hook is one ``None`` check. Every fired
fault logs a ``[fault] injected`` line.
"""

from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass, field
from typing import Optional

from dcr_tpu_torch.core.config import NotPortedError
from dcr_tpu_torch.core.resilience import log_event


class InjectedFault(RuntimeError):
    """Raised (or delivered) by an injection hook; never by production code."""


#: kinds with a hook in the port
PORTED_KINDS = ("decode_error", "ckpt_corrupt", "nan_loss", "sigterm", "hang",
                "search_dump_corrupt", "store_shard_corrupt", "ivf_list_corrupt",
                "kmeans_nan")

#: the JAX package's other kinds, each with the ROADMAP Queue A item that
#: brings its hook point
NOT_PORTED_KINDS = {
    "oom": "item 7 (obs/memwatch, the typed OOM exit)",
    "cache_corrupt": "item 7 (the warm executable cache)",
    "worker_crash": "item 8 (the serving fleet)",
    "worker_hang": "item 8 (the serving fleet)",
    "slow_step": "item 8 (the serving fleet)",
    "latent_cache_corrupt": "item 6 (the latent cache)",
    "wal_torn": "item 3 (the live store)",
    "ingest_crash": "item 3 (the live store)",
    "compact_crash": "item 3 (the live store)",
    "ingest_stall": "item 3 (serve-side ingest)",
    "recall_degrade": "item 1 (the ANN tier's recall probe)",
}

_ENTRY_RE = re.compile(r"^(?P<kind>[a-z_]+)@(?P<coords>[a-z_]+=\d+(?:[&@][a-z_]+=\d+)*)"
                       r"(?:x(?P<times>\d+))?$")


def _current_rank() -> int:
    """The implicit ``rank`` coordinate: the serving fleet's worker index,
    else 0 (one process)."""
    return int(os.environ.get("DCR_WORKER_INDEX", 0) or 0)


@dataclass
class FaultSpec:
    kind: str
    where: dict[str, int]
    times: int = 1
    fired: int = 0

    def matches(self, kind: str, coords: dict[str, int]) -> bool:
        if kind != self.kind or self.fired >= self.times:
            return False
        return all(k in coords and coords[k] == v for k, v in self.where.items())


def parse_faults(spec: str) -> list[FaultSpec]:
    """Parse a DCR_FAULTS string. A malformed entry or an unknown kind
    raises ValueError, a kind the port has no hook for NotPortedError."""
    out: list[FaultSpec] = []
    for entry in (e.strip() for e in spec.split(",") if e.strip()):
        m = _ENTRY_RE.match(entry)
        if m is None:
            raise ValueError(
                f"malformed fault entry {entry!r} "
                "(expected kind@key=value[&key=value...][xN])")
        kind = m.group("kind")
        if kind in NOT_PORTED_KINDS:
            raise NotPortedError(
                f"fault kind {kind!r} ({entry!r}) has no hook in dcr_tpu_torch yet: "
                f"ROADMAP Queue A {NOT_PORTED_KINDS[kind]}")
        if kind not in PORTED_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {entry!r} "
                             f"(known: {', '.join(PORTED_KINDS)})")
        where = {k: int(v) for k, v in
                 (pair.split("=") for pair in re.split(r"[&@]", m.group("coords")))}
        out.append(FaultSpec(kind=kind, where=where, times=int(m.group("times") or 1)))
    return out


@dataclass
class FaultRegistry:
    specs: list[FaultSpec] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self) -> None:
        self._needs_rank = any("rank" in s.where for s in self.specs)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def fire(self, kind: str, **coords: int) -> bool:
        """True iff a spec matches these coordinates and still has fires
        left. Firing is atomic: concurrent hooks cannot double-spend a spec.
        An empty registry takes no lock."""
        if not self.specs:
            return False
        if self._needs_rank and "rank" not in coords:
            coords["rank"] = _current_rank()
        with self._lock:
            for s in self.specs:
                if s.matches(kind, coords):
                    s.fired += 1
                    log_event("injected", kind=kind, **coords)
                    return True
        return False

    def pending(self) -> list[str]:
        """Entries that have not used up their fires (diagnostics)."""
        with self._lock:
            return [f"{s.kind}@{s.where} fired {s.fired}/{s.times}"
                    for s in self.specs if s.fired < s.times]


_registry: Optional[FaultRegistry] = None


def registry() -> FaultRegistry:
    """The process-global registry, parsed from DCR_FAULTS on first use."""
    global _registry
    if _registry is None:
        _registry = FaultRegistry(parse_faults(os.environ.get("DCR_FAULTS", "")))
    return _registry


def install(spec: str) -> FaultRegistry:
    """Replace the global registry (tests, programmatic harnesses)."""
    global _registry
    _registry = FaultRegistry(parse_faults(spec))
    return _registry


def clear() -> None:
    global _registry
    _registry = None


def fire(kind: str, **coords: int) -> bool:
    """Module-level hook point; free when no faults are configured."""
    if _registry is None:
        if not os.environ.get("DCR_FAULTS"):
            return False
        registry()
    return _registry.fire(kind, **coords)
