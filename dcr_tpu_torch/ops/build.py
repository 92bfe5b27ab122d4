"""Build the port's native code at first use and load it with ctypes.

Each CUDA source (``dcr_tpu_torch/csrc/*.cu``) is compiled by ``nvcc`` for
``sm_90a``, and each host C++ source (``dcr_tpu_torch/native/*.cc``, the
JPEG codec) by the host C++ compiler that ``nvcc`` itself needs (``$CXX``,
else ``c++`` or ``g++`` on PATH), into a shared library with a plain C
interface. The library lands in ``dcr_tpu_torch/_build/`` (gitignored) under
a name keyed by a hash of the source, the headers it includes from its own
directory and the flags, so an edited source or header rebuilds and an
unchanged one loads the library already there. Nothing is built when a
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

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


def host_compiler() -> Path:
    """The host C++ compiler: $CXX, then c++, then g++ on PATH."""
    cxx = os.environ.get("CXX")
    for name in ([cxx] if cxx else []) + ["c++", "g++"]:
        found = shutil.which(name)
        if found:
            return Path(found)
    raise FileNotFoundError("no host C++ compiler found (tried $CXX, c++, g++ on PATH)")


def _is_cuda(source: Path) -> bool:
    return Path(source).suffix == ".cu"


def _flags(source: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if _is_cuda(source) else HOST_FLAGS


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def dependencies(source: Path) -> list[Path]:
    """``source`` and every header it includes with quotes, transitively,
    that lies beside it, in a fixed order."""
    seen: list[Path] = []
    todo = [Path(source)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / name.decode()
            if header.exists():
                todo.append(header)
    return seen


def library_path(source: Path) -> Path:
    digest = hashlib.sha256()
    for path in dependencies(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def _start(source: Path) -> tuple[Path, Path, subprocess.Popen | None]:
    lib = library_path(source)
    if lib.exists():
        return source, lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    compiler = nvcc_path() if _is_cuda(source) else host_compiler()
    cmd = [str(compiler), *_flags(source), "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return source, lib, proc


def build(sources: Sequence[Path]) -> dict[str, str]:
    """Compile every source not built yet, all compiler processes at once.
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
        raise RuntimeError("the build failed for " + "\n".join(failures))
    return logs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    key = str(source)
    with _lock:
        if key not in _libs:
            build([source])
            _libs[key] = ctypes.CDLL(str(library_path(source)))
        return _libs[key]
