"""PyTorch port: the package stands alone. Importing every module of
dcr_tpu_torch loads no jax, no flax and nothing of dcr_tpu, nor the
safetensors package or PIL (the card's machine has neither), and no source
file of the port or chip_smoke.py imports them."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "dcr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dcr_tpu", "safetensors", "PIL")

_PROBE = """
import importlib, json, pkgutil, sys
import dcr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dcr_tpu_torch.__path__, "dcr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_importing_every_module_loads_no_jax_or_dcr_tpu():
    proc = subprocess.run([sys.executable, "-c", _PROBE % (FORBIDDEN,)], cwd=REPO,
                          capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "dcr_tpu_torch.sampling.pipeline" in doc["imported"]
    assert "dcr_tpu_torch.ops.flash_attention" in doc["imported"]
    assert "dcr_tpu_torch.utils.faults" in doc["imported"]
    assert "dcr_tpu_torch.core.coordination" in doc["imported"]
    assert "dcr_tpu_torch.search.ann" in doc["imported"]
    assert "dcr_tpu_torch.search.annindex" in doc["imported"]
    for name in ("search.livestore", "serve.ingest", "obs.recall_probe",
                 "diffusion.encode_stage", "data.latent_cache", "cli.precompute",
                 "core.adam8bit", "core.tracing", "obs.memwatch", "utils.profiling",
                 "serve.fleet", "serve.scrape", "serve.supervisor", "obs.slo", "cli.status",
                 "core.dist", "parallel", "parallel.mesh", "ops.ring_attention",
                 "ops.ulysses_attention", "parallel.sharding", "parallel.sharded",
                 # search and eval on a mesh of ranks
                 "core.config", "search.store", "search.shardindex", "search.search",
                 "search.embed", "cli.search", "eval.features", "eval.similarity",
                 "eval.runner", "cli.evaluate", "obs.copyrisk",
                 # the warm cache
                 "core.warmcache", "core.compile_surface"):
        assert f"dcr_tpu_torch.{name}" in doc["imported"]
    assert doc["bad"] == []


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.append(node.module)
    return out


# the multi-process tests' ranks run tests/_torch_ranks.py, which must stand
# alone like the port
@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "_torch_ranks.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_dcr_tpu(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"
