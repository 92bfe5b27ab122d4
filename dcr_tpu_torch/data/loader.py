"""Host data loader: deterministic sampling plan + threaded prefetch.

Counterpart of ``dcr_tpu/data/loader.py`` on one device:

- a *sampling plan* is computed up front per (seed, epoch): weighted with
  replacement under the dup regimes, shuffled otherwise;
- worker threads decode and augment into a bounded queue; batches are
  contiguous numpy arrays;
- the order is reproducible given (seed, epoch), including a restart mid-epoch
  through ``start_step``.

It is fail-fast, the JAX package's default: the first sample that does not
decode ends the epoch with its error (the quarantine budget is not ported).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from dcr_tpu_torch.data import duplication as D
from dcr_tpu_torch.data.dataset import ObjectAttributeDataset


class Batch(dict):
    """dict with attribute access: pixel_values [B,H,W,3], input_ids [B,L],
    index [B]."""

    __getattr__ = dict.__getitem__


def sampling_plan(dataset: ObjectAttributeDataset, *, epoch: int,
                  seed: int) -> np.ndarray:
    """Global epoch order. Under dup_both/dup_image: weighted WITH replacement
    (the duplication mechanism itself, reference diff_train.py:470-479);
    otherwise a plain shuffle."""
    n = len(dataset)
    if dataset.cfg.duplication in ("dup_both", "dup_image"):
        weights = np.asarray(dataset.sampling_weights)[dataset.active_indices]
        return D.weighted_sample_indices(weights, n, seed, epoch)
    return D.shuffled_indices(n, seed, epoch)


class DataLoader:
    def __init__(self, dataset: ObjectAttributeDataset, *, batch_size: int,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        if len(dataset) < batch_size and drop_last:
            raise ValueError(f"dataset of {len(dataset)} samples can't fill one batch "
                             f"of {batch_size}")

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.batch_size

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Batch]:
        """Yield the batches of one epoch from ``start_step`` on."""
        plan = sampling_plan(self.dataset, epoch=epoch, seed=self.seed)
        steps = self.steps_per_epoch()
        out_q: "queue.Queue[tuple[int, Optional[Batch], Optional[BaseException]]]" = (
            queue.Queue(maxsize=self.prefetch))
        stop = threading.Event()

        def make_batch(step: int) -> Batch:
            base = step * self.batch_size
            examples = [self.dataset.get(int(plan[base + j]), epoch=epoch, slot=base + j)
                        for j in range(self.batch_size)]
            return Batch(
                pixel_values=np.stack([e.pixel_values for e in examples]),
                input_ids=np.stack([e.input_ids for e in examples]),
                index=np.asarray([e.index for e in examples], np.int64),
            )

        def safe_put(item) -> bool:
            # re-check stop so a consumer that left never pins a producer in put()
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(worker_id: int) -> None:
            for step in range(start_step + worker_id, steps, self.num_workers):
                if stop.is_set():
                    return
                try:
                    if not safe_put((step, make_batch(step), None)):
                        return
                except BaseException as e:  # hand decode errors to the consumer
                    safe_put((step, None, e))
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        pending: dict[int, Batch] = {}
        try:
            for step in range(start_step, steps):
                while step not in pending:
                    got_step, batch, err = out_q.get()
                    if err is not None:
                        raise err
                    pending[got_step] = batch
                yield pending.pop(step)
        finally:
            stop.set()
            for t in threads:
                while t.is_alive():
                    try:
                        out_q.get_nowait()
                    except queue.Empty:
                        t.join(timeout=0.05)
