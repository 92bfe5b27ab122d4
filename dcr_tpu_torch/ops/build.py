"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``dcr_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface. The library lands
in ``dcr_tpu_torch/_build/`` (gitignored) under a name keyed by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
loads the library already there. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> Path:
    """nvcc from CUDA_HOME, then /usr/local/cuda, then PATH."""
    tried = []
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            tried.append(str(cand))
            if cand.exists():
                return cand
    found = shutil.which("nvcc")
    if found:
        return Path(found)
    tried.append("nvcc on PATH")
    raise FileNotFoundError(f"nvcc not found (tried {', '.join(tried)})")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def _start(source: Path) -> tuple[Path, Path, subprocess.Popen | None]:
    lib = library_path(source)
    if lib.exists():
        return source, lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [str(nvcc_path()), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return source, lib, proc


def build(sources: Sequence[Path]) -> dict[str, str]:
    """Compile every source not built yet, all nvcc processes at once.
    Returns {source stem: compiler output} ("" for a library already built);
    raises with the compiler output if any build fails."""
    started = [_start(Path(s)) for s in sources]
    logs: dict[str, str] = {}
    failures = []
    for source, lib, proc in started:
        if proc is None:
            logs[source.stem] = ""
            continue
        out, _ = proc.communicate()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            failures.append(f"{source.name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)
        (BUILD_DIR / f"{source.stem}.log").write_text(out)
        logs[source.stem] = out
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return logs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    key = str(source)
    with _lock:
        if key not in _libs:
            build([source])
            _libs[key] = ctypes.CDLL(str(library_path(source)))
        return _libs[key]
