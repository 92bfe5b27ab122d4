"""dcr-warm for the port: a verified on-disk cache of the built native
libraries, and the warm-start manifest.

Counterpart of ``dcr_tpu/core/warmcache.py``, with its formats, names,
counters and readiness rules. The JAX module persists compiled XLA
executables. The port compiles no program: it runs eagerly, and its only
compiled artifacts are the libraries ``ops/build.py`` builds with ``nvcc``
(the flash-attention kernels) or the host compiler (the JPEG codec). So the
payload here is one built library, under the surface name
``native/<source stem>``, in the one tier ``"native"``. The entry points
pass a cache only where a surface launches a kernel (``SURFACE_SOURCES``:
the flash-attention libraries); the JPEG codec's library takes the same
path when ``ops/build.load`` is given a cache, but no entry point gives it
one, so a run that decodes JPEGs still builds the codec with the host
compiler:

- **Entries** (:class:`WarmCache`): one self-verifying file per library,
  byte-compatible with the JAX entry format::

      MAGIC | u32 big-endian meta length | meta JSON | payload bytes

  The meta holds the full fingerprint, the payload's sha256 and length and
  the tier. The fingerprint (:func:`native_fingerprint`) is the library's
  source digest (source, headers and flags, as ``ops/build.library_path``
  keys it), the compiler's identity, the topology (``"gpu"`` or ``"cpu"``,
  the device kind and count, the process count) and the torch and CUDA
  versions. It never equals a JAX fingerprint, so the two packages can
  share a directory without sharing a key.
- **Verification before any load**: a truncated, bit-flipped or
  fingerprint-mismatched entry is renamed out of the key space
  (``core/fsio.quarantine_rename``) and counted as
  ``warmcache/{cache_truncated, cache_corrupt, fingerprint_mismatch}``; a
  verified library that does not load is ``warmcache/load_error``. Each
  then takes the path the JAX package calls "recompile": the library is
  built with the compiler and stored again. It never degrades to the plain
  PyTorch version. The ``cache_corrupt`` fault kind (``utils/faults.py``,
  coordinate ``load``) damages the read blob in memory, so the real path
  runs. Concurrent writers (fleet workers sharing a directory) write a
  temporary file and ``os.replace`` it: last writer wins, no reader sees a
  torn entry.
- **AOT resolution** (:func:`aot_compile`): the JAX function lowers and
  compiles a surface and never runs it; here it resolves the libraries the
  surface launches (``SURFACE_SOURCES``) through the cache, so the first
  call pays no compiler. On the CPU, where every kernel wrapper takes its
  plain version, or with flash attention off, it stores nothing and reports
  ``source="eager"`` (``warmcache/eager``). The surfaces that launch no
  native code at all (search, eval, copy risk, the text encoders) have
  nothing to cache and do not call it: their ``warm.dir`` / ``warm_dir`` is
  accepted by the config and builds nothing.
- **Warm-start manifest** (:func:`read_warm_manifest` /
  :func:`update_warm_manifest`): ``warm_manifest.json`` in the JAX format,
  the bucket set a serve incarnation ran, so the next one warms it before
  it reports ready. Each package reads the manifest the other wrote.

The JAX ``guarded`` has no counterpart: it degrades a deserialised
executable to the jit function, and the port has only the eager function,
so there is nothing to degrade from. CUDA graphs and ``torch.compile`` are
not used here: either would be a speed feature the JAX cache does not have.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import logging
import os
import struct
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.fsio import quarantine_rename

log = logging.getLogger("dcr_tpu_torch")

CACHE_VERSION = 1
MAGIC = b"DCRWC1\n"
_LEN = struct.Struct(">I")

TIER_NATIVE = "native"

#: the native sources (``csrc/``) each surface launches on a CUDA device
SURFACE_SOURCES: dict[str, tuple[str, ...]] = {
    "sample/sampler": ("flash_attention_fwd.cu",),
    "serve/batch_sampler": ("flash_attention_fwd.cu",),
    "train/step": ("flash_attention_fwd.cu", "flash_attention_bwd.cu"),
    "train/denoise": ("flash_attention_fwd.cu", "flash_attention_bwd.cu"),
}


def _sha(data: bytes | str) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return hashlib.sha256(data).hexdigest()


def _canonical(fp: dict) -> dict:
    # one JSON round-trip: the in-memory fingerprint must equal what an
    # entry's meta deserialises to, or a JSON-lossy value (tuple -> list,
    # torch.dtype -> str) would make every boot quarantine the entry it wrote
    return json.loads(json.dumps(fp, sort_keys=True, default=str))


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------

def topology_fingerprint() -> dict:
    """The placement and toolchain facts a library is only valid under."""
    from dcr_tpu_torch.core import dist

    gpu = torch.cuda.is_available()
    return {
        "platform": "gpu" if gpu else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if gpu else "cpu",
        "device_count": torch.cuda.device_count() if gpu else 1,
        "process_count": dist.process_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def native_fingerprint(source: Path) -> dict:
    """The fingerprint of one built library of ``ops/build.py``."""
    from dcr_tpu_torch.ops import build

    source = Path(source)
    cuda = build._is_cuda(source)
    return _canonical({
        "version": CACHE_VERSION,
        "surface": f"native/{source.stem}",
        "static_config": {"flags": list(build._flags(source)),
                          "library": build.library_path(source).name},
        "library_sha256": build.source_digest(source),
        "toolchain": build.toolchain(cuda),
        "topology": topology_fingerprint(),
    })


def entry_key(fingerprint: dict) -> str:
    """Stable content key for an entry file name."""
    return _sha(json.dumps(fingerprint, sort_keys=True, default=str))[:32]


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

@dataclass
class WarmResult:
    """What :func:`aot_compile` hands back."""

    source: str                  # "cache" | "compiled" | "eager"
    surface: str
    build_s: float               # library resolution: cache load or compiler


class WarmCache:
    """Persistent library cache directory (shared by N processes).

    Thread-safe within a process; across processes by construction: one
    file per entry, written to a temporary file and renamed (last writer
    wins; readers never see a torn file), and every load verifies magic,
    lengths, sha256 and fingerprint before the payload is used."""

    def __init__(self, cache_dir: str | Path):
        self.dir = Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._load_seq = 0

    def counter(self, name: str):
        return tracing.registry().counter(f"warmcache/{name}")

    def entry_path(self, surface: str, key: str) -> Path:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in surface)
        return self.dir / f"{safe}.{key}.wce"

    # -- load ----------------------------------------------------------------

    def load(self, surface: str, key: str, fingerprint: dict,
             deserialize: Callable[[bytes], Any] = bytes) -> Optional[Any]:
        """``deserialize(payload)`` of a verified entry, or None (a miss, or
        an entry quarantined). Every verification failure logs a ``[fault]``
        line, bumps its ``warmcache/*`` counter and renames the entry out of
        the key space, so the next incarnation is not poisoned by it."""
        path = self.entry_path(surface, key)
        try:
            blob = R.read_bytes_with_retry(path, name=f"warmcache:{surface}")
        except FileNotFoundError:
            return None
        except OSError as e:
            R.log_event("warmcache_read_error", surface=surface, error=repr(e))
            R.bump_counter("warmcache/read_error")
            return None
        with self._lock:
            seq = self._load_seq
            self._load_seq += 1
        from dcr_tpu_torch.utils import faults

        if faults.fire("cache_corrupt", load=seq):
            # the JAX drill: damage the blob in memory so the REAL
            # verification, quarantine and rebuild path runs
            mid = len(MAGIC) + _LEN.size + 1
            blob = (blob[:mid] + bytes([blob[mid] ^ 0xFF]) + blob[mid + 1:]
                    if len(blob) > mid else b"")
        meta, payload, problem = self._verify(blob, fingerprint)
        if problem is not None:
            kind, detail = problem
            self._quarantine(path, surface, kind, detail)
            return None
        try:
            t0 = time.monotonic()
            with tracing.span("warmcache/load", surface=surface, key=key,
                              tier=meta["tier"], os_pid=os.getpid()):
                out = deserialize(payload)
        except Exception as e:   # a verified payload that does not load: rebuild
            self._quarantine(path, surface, "load_error", repr(e))
            return None
        self.counter("hits").inc()
        tracing.event("warmcache/hit", surface=surface, key=key, tier=meta["tier"],
                      os_pid=os.getpid(), load_s=round(time.monotonic() - t0, 3))
        return out

    @staticmethod
    def _verify(blob: bytes,
                fingerprint: dict) -> tuple[Optional[dict], bytes, Optional[tuple[str, str]]]:
        """(meta, payload, problem); problem is (fault kind, detail)."""
        head = len(MAGIC) + _LEN.size
        if len(blob) < head:
            return None, b"", ("cache_truncated", f"{len(blob)} bytes < {head}-byte header")
        if blob[:len(MAGIC)] != MAGIC:
            return None, b"", ("cache_corrupt", "bad magic")
        (meta_len,) = _LEN.unpack(blob[len(MAGIC):head])
        if len(blob) < head + meta_len:
            return None, b"", ("cache_truncated", f"meta length {meta_len} past EOF")
        try:
            meta = json.loads(blob[head:head + meta_len].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            return None, b"", ("cache_corrupt", f"meta unreadable: {e}")
        payload = blob[head + meta_len:]
        if len(payload) != meta.get("payload_len"):
            return None, b"", ("cache_truncated",
                               f"payload {len(payload)}B != recorded {meta.get('payload_len')}B")
        if _sha(payload) != meta.get("payload_sha256"):
            return None, b"", ("cache_corrupt", "payload sha256 mismatch")
        if meta.get("fingerprint") != fingerprint:
            return None, b"", ("fingerprint_mismatch",
                               "entry fingerprint is not the requested program")
        if meta.get("tier") != TIER_NATIVE:
            return None, b"", ("cache_corrupt", f"unknown tier {meta.get('tier')!r}")
        return meta, payload, None

    def _quarantine(self, path: Path, surface: str, kind: str, detail: str) -> None:
        dest = quarantine_rename(path)
        R.log_event("warmcache_quarantined", surface=surface, kind=kind, detail=detail,
                    entry=str(path), quarantined_to=str(dest) if dest else None)
        R.bump_counter(f"warmcache/{kind}")

    # -- store ---------------------------------------------------------------

    def store(self, surface: str, key: str, fingerprint: dict, tier: str,
              payload: bytes) -> Optional[Path]:
        """Temporary file plus ``os.replace``; concurrent writers last-win.
        A failed store is loud but never fails the caller: the library in
        memory is already correct."""
        path = self.entry_path(surface, key)
        meta = {
            "version": CACHE_VERSION,
            "surface": surface,
            "tier": tier,
            "fingerprint": fingerprint,
            "payload_len": len(payload),
            "payload_sha256": _sha(payload),
            "created_at": time.time(),
            "writer_pid": os.getpid(),
        }
        tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}.{threading.get_ident()}")
        try:
            meta_bytes = json.dumps(meta, sort_keys=True).encode("utf-8")
            blob = MAGIC + _LEN.pack(len(meta_bytes)) + meta_bytes + payload
            tmp.write_bytes(blob)
            os.replace(tmp, path)
        except (TypeError, ValueError, OSError) as e:
            R.log_event("warmcache_store_error", surface=surface, error=repr(e))
            R.bump_counter("warmcache/store_error")
            tmp.unlink(missing_ok=True)
            return None
        self.counter("stores").inc()
        tracing.event("warmcache/store", surface=surface, key=key, tier=tier,
                      bytes=len(blob), os_pid=os.getpid())
        return path


# ---------------------------------------------------------------------------
# The native tier (ops/build.load calls these)
# ---------------------------------------------------------------------------

def load_native(cache: WarmCache, source: Path):
    """(loaded library, "cache" | "compiled"): the verified entry's bytes
    written to ``library_path(source)`` and loaded, with no compiler; else
    the library built (or found built) and stored."""
    from dcr_tpu_torch.ops import build

    surface = f"native/{Path(source).stem}"
    fp = native_fingerprint(source)
    key = entry_key(fp)
    lib_path = build.library_path(source)
    lib = cache.load(surface, key, fp, lambda payload: build.install(lib_path, payload))
    if lib is not None:
        return lib, "cache"
    cache.counter("misses").inc()
    build.build([source])
    lib = ctypes.CDLL(str(lib_path))
    cache.store(surface, key, fp, TIER_NATIVE, lib_path.read_bytes())
    return lib, "compiled"


def store_native(cache: WarmCache, source: Path) -> None:
    """Store an already-loaded library whose entry ``cache`` lacks."""
    from dcr_tpu_torch.ops import build

    surface = f"native/{Path(source).stem}"
    fp = native_fingerprint(source)
    key = entry_key(fp)
    if not cache.entry_path(surface, key).exists():
        cache.store(surface, key, fp, TIER_NATIVE, build.library_path(source).read_bytes())


# ---------------------------------------------------------------------------
# The one entry point call sites use
# ---------------------------------------------------------------------------

def _device_of(tree: Any) -> Optional[torch.device]:
    """The device of the first tensor (or module parameter) in ``tree``."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, torch.device):
        return tree
    if isinstance(tree, torch.nn.Module):
        for p in tree.parameters():
            return p.device
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for item in tree:
            found = _device_of(item)
            if found is not None:
                return found
    return None


def native_sources(surface: str, args: tuple,
                   static_config: Optional[dict] = None) -> tuple[Path, ...]:
    """The native sources ``surface`` launches over ``args``: none on the
    CPU, none with the model's flash attention off."""
    from dcr_tpu_torch.ops import build

    device = _device_of(args)
    if device is None or device.type != "cuda":
        return ()
    if (static_config or {}).get("flash_attention") is False:
        return ()
    return tuple(build.CSRC_DIR / name for name in SURFACE_SOURCES.get(surface, ()))


def aot_compile(fn: Callable, args: tuple, *,
                static_config: Optional[dict] = None,
                cache: Optional[WarmCache] = None) -> WarmResult:
    """Resolve the native libraries the surface ``fn`` (a function marked
    with ``@compile_surface``, which names it) launches over ``args`` before
    its first call: from ``cache`` when a verified entry exists, else built
    now (and stored when ``cache`` is given). The surface itself never runs
    (a train step would change the state). ``static_config`` is read for
    ``flash_attention`` (off: the sampler and train surfaces launch no
    kernel)."""
    surface = fn.__compile_surface__
    sources = native_sources(surface, args, static_config)
    if not sources:
        tracing.registry().counter("warmcache/eager").inc()
        return WarmResult(source="eager", surface=surface, build_s=0.0)
    from dcr_tpu_torch.ops import build

    t0 = time.monotonic()
    for src in sources:
        build.load(src, cache)
    outcomes = {build.resolutions.get(str(src)) for src in sources}
    return WarmResult(source="cache" if outcomes == {"cache"} else "compiled",
                      surface=surface, build_s=time.monotonic() - t0)


# ---------------------------------------------------------------------------
# Warm-start manifest (what the previous incarnation had resident)
# ---------------------------------------------------------------------------

MANIFEST_NAME = "warm_manifest.json"


def _manifest_path(cache_dir: str | Path) -> Path:
    return Path(cache_dir) / MANIFEST_NAME


def read_warm_manifest(cache_dir: str | Path) -> list:
    """The previous incarnation's warm set (a list of JSON entries; for
    serve, bucket tuples). Absent -> []. Corrupt -> quarantined and [] (a
    bad hint must never block a boot: the worst case is a lazy warm-up)."""
    path = _manifest_path(cache_dir)
    try:
        raw = R.read_bytes_with_retry(path, name="warm_manifest")
    except FileNotFoundError:
        return []
    except OSError as e:
        R.log_event("warm_manifest_read_error", error=repr(e))
        R.bump_counter("warmcache/manifest_read_error")
        return []
    try:
        entries = json.loads(raw.decode("utf-8"))["entries"]
        if not isinstance(entries, list):
            raise ValueError(f"entries is {type(entries).__name__}, not list")
        return entries
    except (KeyError, ValueError, TypeError) as e:   # UnicodeDecodeError is a ValueError
        dest = quarantine_rename(path)
        R.log_event("warm_manifest_corrupt", error=repr(e), path=str(path),
                    quarantined_to=str(dest) if dest else None)
        R.bump_counter("warmcache/manifest_corrupt")
        return []


def update_warm_manifest(cache_dir: str | Path, entries: list,
                         max_entries: Optional[int] = None) -> None:
    """Union ``entries`` into the manifest in LRU order: a re-recorded entry
    moves to the END (most recent last) and ``max_entries`` trims the oldest
    from the front, so a long-lived shared directory cannot fill every later
    incarnation's bucket budget with history. Atomic replace; a lost update
    between concurrent workers costs one lazy warm-up, never corruption."""
    path = _manifest_path(cache_dir)
    canon_new = [json.dumps(e, sort_keys=True, default=str) for e in entries]
    merged = [e for e in read_warm_manifest(cache_dir)
              if json.dumps(e, sort_keys=True, default=str) not in canon_new]
    seen: set = set()
    for c in canon_new:
        if c not in seen:
            seen.add(c)
            merged.append(json.loads(c))
    if max_entries is not None and len(merged) > max_entries:
        merged = merged[-max_entries:]
    doc = {"version": CACHE_VERSION, "updated_at": time.time(), "entries": merged}
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
        os.replace(tmp, path)
    except OSError as e:
        R.log_event("warm_manifest_write_error", error=repr(e))
        R.bump_counter("warmcache/manifest_write_error")
