"""Thread-safe request queue with bounded-depth admission control.

Counterpart of ``dcr_tpu/serve/queue.py``, operation for operation; the
port's :class:`Request` has no span or trace id (spans come with ROADMAP
Queue A item 7).

The admission contract is the first line of overload defense: a request
either enters the bounded queue or is rejected *immediately* with a typed
error the HTTP layer maps to 503 — latency under overload stays flat instead
of growing with queue depth, and a drain (SIGTERM) flips the queue closed so
no new work can sneak in behind the in-flight batches.

Requests carry their generation bucket (:class:`GenBucket`) so the batcher
can only ever co-schedule requests that share one sampler.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import NamedTuple, Optional


class AdmissionError(RuntimeError):
    """Base class for typed request rejections."""


class QueueFullError(AdmissionError):
    """Pending depth is at the admission bound — the service is overloaded
    (HTTP 503)."""


class DrainingError(AdmissionError):
    """The service is draining (SIGTERM seen): no new admissions (HTTP 503)."""


class InvalidRequestError(AdmissionError):
    """The request's bucket parameters are invalid for this model — a client
    error (HTTP 400), rejected before any sampler is built or device work runs."""


class BucketLimitError(AdmissionError):
    """Admitting this request would build a new sampler beyond the
    configured resident-bucket budget (HTTP 503). Samplers are never
    evicted, so without this bound a client cycling novel bucket parameters
    could grow memory without limit."""


class MemoryBudgetError(AdmissionError):
    """Admitting this request's novel bucket would build a resident sampler
    whose estimated footprint exceeds remaining device memory (HTTP 503).
    The port raises it nowhere yet: the memory budget comes with ROADMAP
    Queue A item 7; the type keeps the wire tags and counters whole."""


class SloShedError(AdmissionError):
    """The fleet is shedding load: queue-wait p99 breached the configured SLO
    while a backlog exists (HTTP 503 with a Retry-After hint). Distinct from
    :class:`QueueFullError` — the queue has room, but anything admitted now
    would wait past the latency objective anyway."""

    def __init__(self, msg: str, retry_after_s: float = 5.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class NoWorkersError(AdmissionError):
    """No fleet worker has joined (yet), so an admitted request could not be
    dispatched anywhere (HTTP 503 with Retry-After — workers are compiling
    or respawning; balancers should retry shortly)."""

    def __init__(self, msg: str, retry_after_s: float = 5.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class GenBucket(NamedTuple):
    """The static generation parameters one sampler serves. Two
    requests batch together iff their buckets are equal — everything here is
    fixed when the bucket's sampler is built.

    ``fast_ratio``/``fast_order`` select the training-free fast-sampling
    plan (dcr_tpu_torch/sampling/fastsample.py): the per-step full|reuse schedule
    is derived from (steps, fast_ratio) on the host when the sampler is
    built, so a fast bucket is a DISTINCT sampler and the plan is
    batch-uniform by construction — the alone-vs-mixed-batch bit-identity
    contract holds with fast sampling on. ``fast_ratio=0`` is the dense
    (pre-fast, bit-identical) sampler. Defaults keep 5-field constructors
    and old 5-element wire tuples meaning exactly what they used to."""

    resolution: int
    steps: int
    guidance: float
    sampler: str
    rand_noise_lam: float
    fast_ratio: float = 0.0
    fast_order: int = 2


_req_ids = itertools.count(1)


@dataclass
class Request:
    """One admitted generation request. ``future`` resolves to a float32
    [H, W, 3] numpy image in [0, 1] (or an exception)."""

    prompt: str
    seed: int
    bucket: GenBucket
    id: int = field(default_factory=lambda: next(_req_ids))
    future: Future = field(default_factory=Future)
    enqueued_at: float = 0.0          # time.monotonic, stamped on admission
    cache_hit: Optional[bool] = None  # filled by the worker
    # copy-risk verdict (obs/copyrisk.RiskScore.doc), filled by the worker
    # after the device step when a risk index is loaded; None = unscored
    # (scoring disabled / still loading / scoring failed)
    risk: Optional[dict] = None


class RequestQueue:
    """Bounded FIFO with bucket-aware group pops.

    All methods are thread-safe; HTTP handler threads submit while the single
    worker thread pops. ``close()`` permanently stops admission (drain) but
    pops continue until empty — that ordering is what makes "SIGTERM finishes
    in-flight work" true.
    """

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"queue maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._items: list[Request] = []
        self._cond = threading.Condition()
        self._closed = False

    # -- producer side -------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Admit or reject-with-type. Never blocks."""
        with self._cond:
            if self._closed:
                raise DrainingError("service is draining; not accepting requests")
            if len(self._items) >= self.maxsize:
                raise QueueFullError(
                    f"admission queue full ({self.maxsize} pending)")
            req.enqueued_at = time.monotonic()
            self._items.append(req)
            self._cond.notify_all()

    def requeue(self, reqs: list[Request]) -> None:
        """Put already-ACCEPTED requests back at the HEAD of the queue, in
        order (fleet supervisor path: their worker died mid-batch). Bypasses
        both the admission bound and the closed flag deliberately — these
        requests were admitted once and the zero-drop contract says they
        complete even during a drain; their original ``enqueued_at`` stamps
        are preserved so queue-wait telemetry and the batcher's deadline see
        the true wait, not a reset clock."""
        if not reqs:
            return
        with self._cond:
            self._items[:0] = reqs
            self._cond.notify_all()

    def close(self) -> None:
        """Stop admission permanently (drain). Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- consumer side -------------------------------------------------------

    def depth(self) -> int:
        with self._cond:
            return len(self._items)

    def has_bucket(self, bucket: GenBucket) -> bool:
        """Whether any PENDING request carries ``bucket`` — the admission
        rollback's guard: a bucket another thread's queued request still
        references must keep its resident-program slot (and its dcr-hbm
        byte reservation) registered."""
        with self._cond:
            return any(r.bucket == bucket for r in self._items)

    def empty(self) -> bool:
        return self.depth() == 0

    def head_age(self) -> float:
        """Seconds the oldest pending request has waited (0.0 when empty)."""
        with self._cond:
            if not self._items:
                return 0.0
            return time.monotonic() - self._items[0].enqueued_at

    def head_group_size(self) -> int:
        """How many pending requests share the head request's bucket."""
        with self._cond:
            if not self._items:
                return 0
            b = self._items[0].bucket
            return sum(1 for r in self._items if r.bucket == b)

    def wait_nonempty(self, timeout: float) -> bool:
        """Block up to ``timeout`` for any pending request; wakes early on
        close() too (drain must not wait out an idle timeout), but only
        returns True when something is actually pending."""
        with self._cond:
            self._cond.wait_for(lambda: bool(self._items) or self._closed,
                                timeout)
            return bool(self._items)

    def wait_change(self, timeout: float) -> None:
        """Block up to ``timeout`` for any queue state change (new submit or
        close) — the batcher's fill-wait primitive."""
        with self._cond:
            self._cond.wait(timeout)

    def take_group(self, max_n: int) -> list[Request]:
        """Pop up to ``max_n`` requests sharing the head's bucket, preserving
        FIFO order within the group AND for the requests left behind."""
        with self._cond:
            if not self._items:
                return []
            b = self._items[0].bucket
            out, keep = [], []
            for r in self._items:
                if r.bucket == b and len(out) < max_n:
                    out.append(r)
                else:
                    keep.append(r)
            self._items = keep
            return out
