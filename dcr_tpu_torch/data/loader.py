"""Host data loader: deterministic sampling plan + threaded prefetch.

Counterpart of ``dcr_tpu/data/loader.py``:

- a *sampling plan* is computed up front per (seed, epoch): weighted with
  replacement under the dup regimes, shuffled otherwise;
- worker threads decode and augment into a bounded queue; batches are
  contiguous numpy arrays;
- the order is reproducible given (seed, epoch), including a restart mid-epoch
  through ``start_step``;
- on several processes each loads its slice of the global batch: step s
  takes plan slots ``s * global + process_index * batch_size`` onwards,
  ``process_index`` being the rank's data index, so the seq replicas of one
  data group read the same rows;
- with ``fault.max_bad_sample_frac > 0`` a sample that does not decode is
  quarantined and replaced by the next plan slot that decodes (see
  :meth:`DataLoader.epoch`); with the default budget 0 the first bad sample
  ends the epoch with its error.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core.config import FaultToleranceConfig, NotPortedError
from dcr_tpu_torch.data import duplication as D
from dcr_tpu_torch.data.dataset import ObjectAttributeDataset


class Batch(dict):
    """dict with attribute access: pixel_values [B,H,W,3], input_ids [B,L],
    index [B]."""

    __getattr__ = dict.__getitem__


class TooManyBadSamples(RuntimeError):
    """The epoch's quarantine budget (fault.max_bad_sample_frac) is spent."""


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
                 num_workers: int = 8, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, drop_last: bool = True,
                 prefetch: int = 4, fault: Optional[FaultToleranceConfig] = None,
                 quarantine: Optional[R.QuarantineManifest] = None,
                 defer_budget_abort: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.global_batch_size = batch_size * process_count
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        # fault=None (or max_bad_sample_frac=0): the first bad sample ends
        # the epoch
        self.fault = fault
        self.quarantine = quarantine
        self.bad_samples = 0  # run total, reported as faults/bad_samples
        self._bad_lock = threading.Lock()
        self._epoch_bad = [0]  # rebound per epoch()
        # on several processes the budget is the job's: past it, the
        # trainer aborts every rank through the fault agreement, so a
        # worker does not raise on its own (one rank unwinding while its
        # peers enter the next collective would hang them)
        self.defer_budget_abort = defer_budget_abort
        if len(dataset) < self.global_batch_size and drop_last:
            raise ValueError(f"dataset of {len(dataset)} samples can't fill one global "
                             f"batch of {self.global_batch_size}")

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.global_batch_size

    @property
    def epoch_bad_count(self) -> int:
        """Bad samples this process quarantined in the current epoch."""
        return self._epoch_bad[0]

    def epoch_bad_budget(self) -> int:
        """The epoch's quarantine budget in samples, over the global epoch."""
        budget_frac = self.fault.max_bad_sample_frac if self.fault else 0.0
        return int(budget_frac * self.steps_per_epoch() * self.global_batch_size)

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Batch]:
        """Yield the batches of one epoch from ``start_step`` on.

        Bad samples (decode failures after the dataset's own retries, or
        injected ``decode_error`` faults) are quarantined when
        ``fault.max_bad_sample_frac > 0``: the occurrence is replaced by the
        next plan slot ``(slot + k) % len(plan)`` that decodes (the example
        another step would produce there, so the substitution is the same
        across restarts), recorded in the quarantine manifest, and counted
        against the epoch's budget. Past the budget, or with the default
        budget of 0, the error reaches the consumer. A format the port does
        not read (:class:`NotPortedError`) is never quarantined."""
        from dcr_tpu_torch.utils import faults

        plan = sampling_plan(self.dataset, epoch=epoch, seed=self.seed)
        steps = self.steps_per_epoch()
        out_q: "queue.Queue[tuple[int, Optional[Batch], Optional[BaseException]]]" = (
            queue.Queue(maxsize=self.prefetch))
        stop = threading.Event()
        budget_frac = self.fault.max_bad_sample_frac if self.fault else 0.0
        epoch_budget = self.epoch_bad_budget()
        epoch_bad = [0]  # shared across workers, guarded by _bad_lock
        self._epoch_bad = epoch_bad

        def fetch(step: int, slot: int):
            position = int(plan[slot])
            # the `index` coordinate is the dataset index, the value the
            # quarantine record gives this occurrence
            if faults.fire("decode_error", step=step, slot=slot,
                           index=int(self.dataset.active_indices[position]), epoch=epoch):
                raise faults.InjectedFault(
                    f"decode_error at epoch={epoch} step={step} slot={slot}")
            return self.dataset.get(position, epoch=epoch, slot=slot)

        def fetch_or_replace(step: int, slot: int):
            try:
                return fetch(step, slot)
            except NotPortedError:
                raise
            except Exception as err:
                return self._replace(err, plan=plan, epoch=epoch, step=step, slot=slot,
                                     fetch=fetch, epoch_bad=epoch_bad,
                                     epoch_budget=epoch_budget, budget_frac=budget_frac)

        def make_batch(step: int) -> Batch:
            base = step * self.global_batch_size + self.process_index * self.batch_size
            examples = [fetch_or_replace(step, base + j) for j in range(self.batch_size)]
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

    def _replace(self, err: BaseException, *, plan: np.ndarray, epoch: int, step: int,
                 slot: int, fetch, epoch_bad: list, epoch_budget: int, budget_frac: float):
        """Quarantine a bad occurrence and return its replacement, or
        re-raise when the budget is 0 or spent. Thread-safe: loader workers
        call it concurrently."""
        ds = self.dataset
        bad_index = int(ds.active_indices[int(plan[slot])])
        if budget_frac <= 0:
            raise err  # no quarantine budget: fail fast
        with self._bad_lock:
            epoch_bad[0] += 1
            self.bad_samples += 1
            n_bad = epoch_bad[0]
        if n_bad > epoch_budget and not self.defer_budget_abort:
            raise TooManyBadSamples(
                f"epoch {epoch}: {n_bad} bad samples exceed the quarantine budget of "
                f"{epoch_budget} (max_bad_sample_frac={budget_frac} of {len(plan)} "
                f"samples); last failure: {err!r}") from err
        # walk the same epoch plan to the next slot that decodes: (epoch,
        # slot) fix the example, so a restart substitutes identically
        last: BaseException = err
        for k in range(1, len(plan)):
            cand = (slot + k) % len(plan)
            try:
                example = fetch(step, cand)
            except NotPortedError:
                raise
            except Exception as cand_err:
                last = cand_err
                continue
            if self.quarantine is not None:
                self.quarantine.record(
                    "bad_sample", epoch=epoch, step=step, slot=slot, index=bad_index,
                    path=ds.paths[bad_index], replacement_slot=cand,
                    replacement_index=int(ds.active_indices[int(plan[cand])]),
                    error=repr(err))
            else:
                R.log_event("bad_sample_replaced", epoch=epoch, step=step, slot=slot,
                            index=bad_index, replacement_slot=cand, error=repr(err))
            return example
        raise TooManyBadSamples(
            f"epoch {epoch}: no decodable replacement found in the entire plan "
            f"({len(plan)} slots); last failure: {last!r}") from err
