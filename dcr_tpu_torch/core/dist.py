"""The multi-process runtime: the port's copy of ``dcr_tpu/core/dist.py`` on
``torch.distributed``.

One process per device. :func:`initialize` joins the job that the
environment describes, in either package's words:

- the JAX package's ``COORDINATOR_ADDRESS`` (``host:port``),
  ``NUM_PROCESSES`` and ``PROCESS_ID``, so one launch script drives both
  packages;
- torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
  and ``LOCAL_RANK`` (under torchrun's agent store every rank connects as
  a client).

Rank 0 serves a ``TCPStore`` at the address and every rank builds its
process group on it (``init_process_group(store=...)``); a caller may hand
in its own store, e.g. a ``FileStore``. The join retries with backoff
(``DCR_RENDEZVOUS_ATTEMPTS``), and a post-join health check allgathers
every rank's view of the topology and raises :class:`RendezvousError` on a
duplicate or missing rank (``DCR_RENDEZVOUS_HEALTH_TIMEOUT_S``). The
backend is the caller's (``backend=``); the default is ``nccl`` for a CUDA
device and ``gloo`` for the CPU, and nothing ever switches it.

The control plane (:func:`kv_allgather`, :func:`barrier`) rides the store,
not the process group: plain TCP with a deadline on every read, so it works
before the first collective and goes on working while a device collective
is wedged, which is when the fault agreement (``core/coordination.py``)
must act. A peer that never arrives becomes a :class:`BarrierTimeout`.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
from typing import Any, Callable, Optional

import torch
import torch.distributed as tdist

log = logging.getLogger("dcr_tpu_torch")

# the store's "wait forever" for timeout_s <= 0 (24 days)
_FOREVER = datetime.timedelta(days=24)
# the join's bound on each store connection and on the group's collectives
_JOIN_TIMEOUT = datetime.timedelta(seconds=300)

_store: Optional[Any] = None
_initialized = False


class BarrierTimeout(TimeoutError):
    """A cross-process sync point did not complete within its budget."""


class RendezvousError(RuntimeError):
    """The job came up with an incoherent topology."""


def _timeout(timeout_s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=timeout_s) if timeout_s > 0 else _FOREVER


def _is_deadline(e: BaseException) -> bool:
    return "timeout" in str(e).lower() or "timed out" in str(e).lower()


def env_topology() -> Optional[tuple[str, int, int, int]]:
    """``(host, port, world_size, rank)`` from the environment, or None when
    it describes no multi-process job. The JAX package's variables are read
    first, then torchrun's."""
    env = os.environ
    if env.get("COORDINATOR_ADDRESS") or env.get("NUM_PROCESSES"):
        host, _, port = env.get("COORDINATOR_ADDRESS", "").rpartition(":")
        if not host or not port:
            raise ValueError(f"COORDINATOR_ADDRESS must be host:port, got "
                             f"{env.get('COORDINATOR_ADDRESS')!r}")
        return host, int(port), int(env["NUM_PROCESSES"]), int(env.get("PROCESS_ID", "0"))
    if env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        return (env["MASTER_ADDR"], int(env.get("MASTER_PORT", "29500")),
                int(env["WORLD_SIZE"]), int(env.get("RANK", "0")))
    return None


def local_rank() -> int:
    """This process's device index on its host (``LOCAL_RANK``, default 0)."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def job_device(device: str | torch.device) -> torch.device:
    """The device this process runs on: ``cuda:LOCAL_RANK`` for a bare
    ``cuda`` in a job the environment describes (made current), else
    ``device``, checked by ``core/device.resolve_device``."""
    from dcr_tpu_torch.core.device import resolve_device

    device = torch.device(device)
    if device.type == "cuda" and device.index is None and env_topology():
        device = torch.device("cuda", local_rank())
    device = resolve_device(device)
    if device.type == "cuda" and env_topology():
        torch.cuda.set_device(device)
    return device


def default_backend(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(device: str | torch.device = "cpu", *, backend: Optional[str] = None,
               store=None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> bool:
    """Join the multi-process job the environment (or ``store``, ``rank``
    and ``world_size``) describes; a no-op in a single process. Returns
    whether a process group is up. ``device`` picks the default backend."""
    global _initialized, _store
    if _initialized:
        return True
    topo = None
    if store is None:
        topo = env_topology()
        if topo is None:
            return False
        rank = topo[3] if rank is None else rank
        world_size = topo[2] if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("a store needs rank= and world_size=")
    backend = backend or default_backend(device)
    from dcr_tpu_torch.core import resilience as R

    # torchrun's agent already serves a store at MASTER_ADDR:MASTER_PORT
    agent_store = os.environ.get("TORCHELASTIC_USE_AGENT_STORE", "").lower() == "true"

    def join() -> None:
        global _store
        nonlocal store
        try:
            if topo is not None:
                store = tdist.TCPStore(topo[0], topo[1], world_size,
                                       is_master=rank == 0 and not agent_store,
                                       timeout=_JOIN_TIMEOUT, wait_for_workers=False)
            tdist.init_process_group(backend, store=store, rank=rank,
                                     world_size=world_size, timeout=_JOIN_TIMEOUT)
            _store = store
        except Exception:
            # a half-joined group cannot join again: tear it down so the
            # retry starts clean, and keep the teardown's failure visible
            if tdist.is_initialized():
                try:
                    tdist.destroy_process_group()
                except Exception as te:
                    R.log_event("rendezvous_teardown_error", error=repr(te))
                    R.bump_counter("rendezvous_teardown_errors")
            if topo is not None:
                store = None
            raise

    attempts = int(os.environ.get("DCR_RENDEZVOUS_ATTEMPTS", "3"))
    R.retry_call(join, attempts=attempts, base_delay=0.5, max_delay=10.0,
                 retry_on=(RuntimeError, OSError, ValueError), give_up_on=(),
                 name="rendezvous")
    _initialized = True
    log.info("joined distributed job: process %d/%d over %s", rank, world_size, backend)
    _post_join_health_check()
    return True


def shutdown(timeout_s: float = 60.0) -> None:
    """Leave the job: wait (up to ``timeout_s``) until every rank is done
    with its last collective, then destroy the process group and drop the
    store. A rank that tears its group down while a peer still exchanges
    with it can abort the peer."""
    global _initialized, _store
    if tdist.is_initialized():
        try:
            barrier("shutdown", timeout_s=timeout_s)
        except BarrierTimeout as e:
            log.warning("leaving the job without every peer: %s", e)
        tdist.destroy_process_group()
    _initialized, _store = False, None
    with _seq_lock:
        _seq_counters.clear()


def _post_join_health_check() -> None:
    """Fail fast on an incoherent topology right after the join, while the
    error is still the rendezvous's: every rank publishes ``rank:world`` and
    the ranks must be 0..n-1 in slot order with one world size. A peer that
    joined but never publishes becomes a RendezvousError, not a hang."""
    if process_count() == 1:
        return
    timeout_s = float(os.environ.get("DCR_RENDEZVOUS_HEALTH_TIMEOUT_S", "300"))
    try:
        rows = kv_allgather(f"{process_index()}:{process_count()}", "rendezvous_health",
                            timeout_s)
    except BarrierTimeout as e:
        raise RendezvousError(f"post-join health check stalled: {e} (a peer joined the "
                              "rendezvous but never published its topology)") from e
    parsed = [tuple(int(x) for x in row.split(":")) for row in rows]
    ranks = [r for r, _ in parsed]
    if ranks != list(range(process_count())):
        raise RendezvousError(f"process indices are not 0..{process_count() - 1} in slot "
                              f"order: {ranks} (duplicate or missing rank in the rendezvous)")
    worlds = {w for _, w in parsed}
    if worlds != {process_count()}:
        raise RendezvousError(f"ranks disagree on the world size: {parsed}")
    log.info("rendezvous health check ok: %d processes", process_count())


def is_primary() -> bool:
    """True on the process that owns I/O (checkpoints, logs, exports, grids)."""
    return process_index() == 0


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


_seq_lock = threading.Lock()
_seq_counters: dict[str, int] = {}


def _next_seq(tag: str) -> int:
    """Process-local sequence per tag. Control-plane calls are collectively
    ordered program points, so the sequences line up across processes."""
    with _seq_lock:
        _seq_counters[tag] = _seq_counters.get(tag, 0) + 1
        return _seq_counters[tag]


def kv_allgather(payload: str, tag: str, timeout_s: float = 0.0) -> list[str]:
    """Control-plane allgather: publish ``payload`` under (tag, seq, rank) in
    the store and read every peer's slot in rank order, each read under
    ``timeout_s`` (0 waits forever): an absent peer raises
    :class:`BarrierTimeout`. Each process deletes its own key of round seq-2
    in round seq: a peer publishes round seq-1 only after reading all of
    round seq-2, so nothing live is deleted."""
    if _store is None:
        raise RuntimeError("kv_allgather needs a joined job (dist.initialize)")
    rank, count = process_index(), process_count()
    seq = _next_seq(f"ag:{tag}")
    base = f"dcr:ag:{tag}"
    _store.set(f"{base}:{seq}:{rank}", payload)
    out: list[str] = []
    for peer in range(count):
        if peer == rank:
            out.append(payload)
            continue
        key = f"{base}:{seq}:{peer}"
        try:
            _store.wait([key], _timeout(timeout_s))
            out.append(_store.get(key).decode())
        except RuntimeError as e:
            if _is_deadline(e):
                raise BarrierTimeout(f"allgather:{tag}: peer {peer} absent after "
                                     f"{timeout_s:.1f}s, likely hung or dead") from e
            raise
    if seq > 2:
        try:
            _store.delete_key(f"{base}:{seq - 2}:{rank}")
        except RuntimeError as e:  # cleanup only; the run must not die over it
            from dcr_tpu_torch.core import resilience as R

            R.log_event("kv_gc_error", tag=tag, seq=seq - 2, error=repr(e))
            R.bump_counter("kv_gc_errors")
    return out


def barrier(name: str = "barrier", timeout_s: float = 0.0) -> None:
    """Named cross-process sync point on the store. ``timeout_s > 0`` bounds
    the wait and raises :class:`BarrierTimeout` when a peer never arrives (0
    waits forever)."""
    if process_count() == 1:
        return
    try:
        kv_allgather("", f"bar:{name}", timeout_s)
    except BarrierTimeout as e:
        raise BarrierTimeout(f"barrier:{name}: peers missing after {timeout_s:.1f}s "
                             f"({e})") from e


def default_allgather_timeout_s() -> float:
    """Wall-clock bound for data-plane gathers that have no deadline of
    their own, for :func:`run_with_timeout`. ``DCR_ALLGATHER_TIMEOUT_S``
    (default 600; 0 waits forever)."""
    return float(os.environ.get("DCR_ALLGATHER_TIMEOUT_S", "600"))


def run_with_timeout(fn: Callable[[], Any], timeout_s: float, *,
                     name: str = "collective") -> Any:
    """Run a call that may hang with a wall-clock budget. ``timeout_s <= 0``
    calls ``fn`` inline. Otherwise ``fn`` runs on a daemon thread and an
    overrun raises :class:`BarrierTimeout`: the thread cannot be cancelled
    (it is stuck in native code), but the caller regains control to dump
    its diagnostics and exit with a code of its own."""
    if timeout_s <= 0:
        return fn()
    result: list[Any] = []
    error: list[BaseException] = []

    def target() -> None:
        try:
            result.append(fn())
        except BaseException as e:  # surfaced to the caller below
            error.append(e)

    t = threading.Thread(target=target, daemon=True, name=f"timeout:{name}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise BarrierTimeout(f"{name}: no completion within {timeout_s:.1f}s; a peer "
                             "process is likely hung or dead")
    if error:
        raise error[0]
    return result[0]
