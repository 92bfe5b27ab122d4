"""Durable small-file publishes (own copy of ``dcr_tpu/core/fsio.py``).

The atomic-publish idiom is write-to-temp + ``os.replace``: a reader never
sees a torn file name. The rename is atomic in the namespace only, so the
temp file is flushed and fsynced before it, and callers whose commit point
is ordered against other files (a manifest naming shards, a ``CURRENT``
pointer naming a manifest) also fsync the directory so the rename itself is
durable. :func:`quarantine_rename` (``dcr_tpu/core/warmcache.py:93-108``)
moves a damaged file out of its addressable name.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional


def fsync_file(path: str | Path) -> None:
    """fsync an already-written file by path (e.g. after ``np.savez``
    closed it: the bytes may still be page-cache-only)."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str | Path) -> None:
    """Best-effort directory fsync: makes a completed rename durable.
    A no-op where directories cannot be opened (non-POSIX)."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def publish_durable(tmp: str | Path, target: str | Path,
                    data: bytes | str, *, sync_dir: bool = False) -> None:
    """Write ``data`` to ``tmp``, flush + fsync it, then rename it over
    ``target``. ``sync_dir=True`` also fsyncs the parent directory after the
    rename: needed when a later write (manifest, CURRENT pointer) must never
    become durable before this one."""
    tmp, target = Path(tmp), Path(target)
    payload = data.encode("utf-8") if isinstance(data, str) else data
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    if sync_dir:
        fsync_dir(target.parent)


def quarantine_rename(path: Path) -> Optional[Path]:
    """Rename a bad file out of its addressable name
    (``<name>.quarantined.<pid>.<ts>``); None when the rename itself fails
    (racing quarantiners, an entry already rewritten). Callers log and count
    the degraded load either way."""
    from dcr_tpu_torch.core import resilience as R

    path = Path(path)
    dest = path.with_name(f"{path.name}.quarantined.{os.getpid()}.{int(time.time())}")
    try:
        os.replace(path, dest)
    except OSError as e:
        R.log_event("quarantine_rename_failed", path=str(path), error=repr(e))
        return None
    return dest
