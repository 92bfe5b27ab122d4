"""Deadline-aware dynamic batching policy (``dcr_tpu/serve/batcher.py``).

The worker keeps one sampler per (bucket, max_batch) and every batch runs at
exactly that padded shape, so the batching decision is purely *when* to
flush, never *what shape* to run:

- flush as soon as a full ``max_batch`` group is pending (throughput), or
- flush a partial group once its oldest request has waited ``max_wait_s``
  (the latency deadline — a lone request never waits more than one
  max-wait for company), or
- flush immediately during drain (stop/closed), so SIGTERM finishes the
  backlog at partial occupancy instead of idling out each max-wait.

:func:`should_flush` is the pure decision function (unit-tested directly);
:class:`Batcher` wires it to a live
:class:`~dcr_tpu_torch.serve.queue.RequestQueue`.
"""

from __future__ import annotations

import threading
from typing import Optional

from dcr_tpu_torch.serve.queue import Request, RequestQueue


def should_flush(group_size: int, max_batch: int, oldest_age_s: float,
                 max_wait_s: float, *, draining: bool = False) -> bool:
    """Flush decision for the head bucket group. Pure — no clock, no locks."""
    if group_size <= 0:
        return False
    if group_size >= max_batch:
        return True
    if draining:
        return True
    return oldest_age_s >= max_wait_s


class Batcher:
    """Pulls bucket-coherent batches out of a :class:`RequestQueue`.

    ``next_batch`` blocks until it can return a non-empty batch, or returns
    ``None`` once ``stop`` is set and the queue is fully drained — the worker
    loop's termination signal.
    """

    def __init__(self, max_batch: int, max_wait_s: float, *,
                 poll_s: float = 0.005, idle_wait_s: float = 0.5):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.max_wait_s = float(max_wait_s)
        # fill-wait granularity while a partial batch is pending (bounded by
        # max_wait_s, so the fine poll only runs when there is work)
        self.poll_s = poll_s
        # idle block: submit()/close() notify the queue's condition, so a
        # long timeout costs no latency — it only bounds how often an idle
        # worker wakes to re-check the stop event
        self.idle_wait_s = idle_wait_s

    def next_batch(self, queue: RequestQueue,
                   stop: Optional[threading.Event] = None) -> Optional[list[Request]]:
        stop = stop or threading.Event()
        while True:
            if not queue.wait_nonempty(self.idle_wait_s):
                if stop.is_set() and queue.empty():
                    return None
                continue
            # fill-wait: hold the head group until it is full, its deadline
            # passes, or the service starts draining
            while not should_flush(queue.head_group_size(), self.max_batch,
                                   queue.head_age(), self.max_wait_s,
                                   draining=stop.is_set() or queue.closed):
                if queue.empty():        # raced with another consumer
                    break
                queue.wait_change(self.poll_s)
            batch = queue.take_group(self.max_batch)
            if batch:
                return batch
