"""Run provenance: the git state of the code, stamped into a run directory.

Own copy of ``dcr_tpu/utils/provenance.py``: ``stamp`` writes
``provenance.json`` (commit, branch, whether the tree was dirty, Python
version, time) so each output directory records the code that made it.
Where git cannot run the git fields read "unknown".
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def _git(args: list[str], cwd: Path) -> str:
    try:
        return subprocess.run(["git", *args], cwd=cwd, capture_output=True,
                              text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def describe(repo_root: Path | None = None) -> dict:
    root = repo_root or Path(__file__).resolve().parents[2]
    return {
        "sha": _git(["rev-parse", "HEAD"], root),
        "branch": _git(["rev-parse", "--abbrev-ref", "HEAD"], root),
        "dirty": bool(_git(["status", "--porcelain"], root)),
        "python": sys.version.split()[0],
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def stamp(out_dir: str | Path) -> Path:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "provenance.json"
    path.write_text(json.dumps(describe(), indent=2) + "\n")
    return path
