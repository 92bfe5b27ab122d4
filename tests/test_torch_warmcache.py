"""PyTorch port: the warm cache (``dcr_tpu_torch.core.warmcache``) and the
surface registry (``core/compile_surface``) against the JAX package's
``dcr_tpu.core.warmcache`` and ``compile_surface``, on the CPU.

- ``warm_manifest.json`` written by either package reads back in the other
  as equal entries in equal LRU order, ``max_entries`` trimming included;
- an entry file of either package parses in the other's ``_verify`` and is
  refused there as ``fingerprint_mismatch`` (the two never share a key);
- each verify kind (truncated, bit-flipped, wrong fingerprint) gives the
  JAX package's kind, quarantines the entry and counts it, and
  ``cache_corrupt@load=0`` runs that real path;
- the native tier round-trips a built host library (the JPEG size codec,
  ``native/jpeg_size.cc``): the second, cold build directory loads the
  verified bytes and runs no compiler; a library that does not load is
  quarantined as ``load_error`` and rebuilt;
- ``aot_compile`` takes the decorated surface and reads its name from it;
  on the CPU (every kernel wrapper takes its plain version) it stores
  nothing and reports ``eager``; on a CUDA device the sampler and train
  surfaces name the flash-attention sources;
- the port's serve worker and the JAX worker plan the same warm start from
  one manifest (the JAX ``GenerationService.begin_warm`` on a light
  stand-in);
- every surface name the JAX package registers is registered by the port,
  and each registered function carries its own name.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

jax = pytest.importorskip("jax")

from dcr_tpu.core import compile_surface as JCS  # noqa: E402
from dcr_tpu.core import config as JC  # noqa: E402
from dcr_tpu.core import resilience as JR  # noqa: E402
from dcr_tpu.core import warmcache as JW  # noqa: E402
from dcr_tpu.serve import queue as JQ  # noqa: E402
from dcr_tpu.serve import worker as JSW  # noqa: E402
from dcr_tpu_torch.core import compile_surface as TCS  # noqa: E402
from dcr_tpu_torch.core import config as TC  # noqa: E402
from dcr_tpu_torch.core import resilience as R  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.core import warmcache as W  # noqa: E402
from dcr_tpu_torch.ops import build  # noqa: E402
from dcr_tpu_torch.serve import queue as TQ  # noqa: E402
from dcr_tpu_torch.serve import worker as TSW  # noqa: E402
from dcr_tpu_torch.utils import faults  # noqa: E402

JPEG_SIZE = build.PKG_DIR / "native" / "jpeg_size.cc"


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset_for_tests()
    faults.clear()
    yield
    tracing.reset_for_tests()
    faults.clear()


def _fp(**over) -> dict:
    fp = {"version": W.CACHE_VERSION, "surface": "native/x", "static_config": {"k": [1, 2]},
          "topology": {"platform": "cpu"}}
    fp.update(over)
    return fp


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifests_read_across_packages_in_lru_order(tmp_path, writer):
    write, read = ((W.update_warm_manifest, JW.read_warm_manifest) if writer == "port"
                   else (JW.update_warm_manifest, W.read_warm_manifest))
    buckets = [[16, s, 7.5, "ddim", 0.0, 0.0, 2] for s in range(1, 6)]
    for b in buckets:
        write(tmp_path, [b], max_entries=3)
    assert read(tmp_path) == buckets[2:]
    write(tmp_path, [buckets[2], buckets[0]], max_entries=3)   # re-recorded moves last
    assert read(tmp_path) == [buckets[4], buckets[2], buckets[0]]
    assert W.read_warm_manifest(tmp_path) == JW.read_warm_manifest(tmp_path)
    # a corrupt manifest: quarantined, read as [], counted
    (tmp_path / W.MANIFEST_NAME).write_bytes(b"\xff{not json")
    assert W.read_warm_manifest(tmp_path) == []
    assert R.counters()["warmcache/manifest_corrupt"] == 1
    assert list(tmp_path.glob(f"{W.MANIFEST_NAME}.quarantined.*"))


# ---------------------------------------------------------------------------
# entries: the format and every verify kind
# ---------------------------------------------------------------------------

def test_entry_files_parse_across_packages_as_fingerprint_mismatch(tmp_path):
    port = W.WarmCache(tmp_path / "p")
    theirs = JW.WarmCache(tmp_path / "j")
    fp = _fp()
    key = W.entry_key(fp)
    assert key == JW.entry_key(fp)
    mine_path = port.store("native/x", key, fp, W.TIER_NATIVE, b"library bytes")
    jax_path = theirs.store("sample/sampler", key, fp, JW.TIER_EXPORT, b"stablehlo")
    mine, jblob = mine_path.read_bytes(), jax_path.read_bytes()
    assert mine[:len(W.MAGIC)] == JW.MAGIC == W.MAGIC
    meta_len = int.from_bytes(mine[len(W.MAGIC):len(W.MAGIC) + 4], "big")
    meta = json.loads(mine[len(W.MAGIC) + 4:len(W.MAGIC) + 4 + meta_len])
    jmeta_len = int.from_bytes(jblob[len(W.MAGIC):len(W.MAGIC) + 4], "big")
    assert meta.keys() == json.loads(jblob[len(W.MAGIC) + 4:len(W.MAGIC) + 4 + jmeta_len]).keys()
    other = _fp(surface="native/y")
    assert W.WarmCache._verify(jblob, other)[2][0] == "fingerprint_mismatch"
    assert JW.WarmCache._verify(mine, other)[2][0] == "fingerprint_mismatch"
    # with its own fingerprint each package refuses the other's tier
    assert W.WarmCache._verify(jblob, fp)[2][0] == "cache_corrupt"
    assert W.WarmCache._verify(mine, fp)[2] is None


@pytest.mark.parametrize("kind", ["cache_truncated", "cache_corrupt", "fingerprint_mismatch"])
def test_each_verify_kind_quarantines_and_counts(tmp_path, kind):
    cache = W.WarmCache(tmp_path)
    fp = _fp()
    key = W.entry_key(fp)
    path = cache.store("native/x", key, fp, W.TIER_NATIVE, b"0123456789" * 8)
    blob = path.read_bytes()
    asked = fp
    if kind == "cache_truncated":
        path.write_bytes(blob[:-5])
    elif kind == "cache_corrupt":
        path.write_bytes(blob[:-3] + bytes([blob[-3] ^ 0x01]) + blob[-2:])
    else:
        asked = _fp(static_config={"k": [1, 3]})
    damaged = path.read_bytes()
    assert JW.WarmCache._verify(damaged, asked)[2][0] == kind     # the JAX kind
    assert cache.load("native/x", key, asked) is None
    assert not path.exists() and list(tmp_path.glob(f"{path.name}.quarantined.*"))
    assert R.counters() == {f"warmcache/{kind}": 1}
    assert tracing.registry().counter("warmcache/hits").value == 0


def test_cache_corrupt_fault_runs_the_real_path(tmp_path):
    cache = W.WarmCache(tmp_path)
    fp = _fp()
    key = W.entry_key(fp)
    cache.store("native/x", key, fp, W.TIER_NATIVE, b"payload")
    assert cache.load("native/x", key, fp) == b"payload"          # before the fault
    faults.install("cache_corrupt@load=0")
    assert cache.load("native/x", key, fp) == b"payload"          # this cache's load 1
    fresh = W.WarmCache(tmp_path)                                  # a new process's cache
    assert fresh.load("native/x", key, fp) is None                 # load 0: damaged in memory
    assert R.counters() == {"warmcache/cache_corrupt": 1}
    assert list(tmp_path.glob("*.quarantined.*")) and not fresh.entry_path("native/x", key).exists()
    assert not faults.registry().pending()


# ---------------------------------------------------------------------------
# the native tier, on a host library
# ---------------------------------------------------------------------------

def _cold(monkeypatch, build_dir: Path) -> None:
    """A fresh build directory and no library loaded: a cold tree."""
    monkeypatch.setattr(build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "resolutions", {})


def test_native_tier_round_trips_a_library_and_skips_the_compiler(tmp_path, monkeypatch):
    cache = W.WarmCache(tmp_path / "warm")
    _cold(monkeypatch, tmp_path / "build1")
    runs = build.compiler_runs["jpeg_size"]
    lib = build.load(JPEG_SIZE, cache)                             # a miss: built, stored
    assert build.compiler_runs["jpeg_size"] == runs + 1
    assert build.resolutions[str(JPEG_SIZE)] == "compiled"
    built = build.library_path(JPEG_SIZE).read_bytes()
    fp = W.native_fingerprint(JPEG_SIZE)
    assert fp == json.loads(json.dumps(fp)) and fp["surface"] == "native/jpeg_size"
    assert fp["library_sha256"].startswith(build.library_path(JPEG_SIZE).stem.split("-")[-1])
    entry = cache.entry_path("native/jpeg_size", W.entry_key(fp))
    assert entry.exists() and lib.jpeg_encode

    _cold(monkeypatch, tmp_path / "build2")                        # the next process
    monkeypatch.setattr(build, "_start", lambda source: pytest.fail("a compiler ran"))
    lib = build.load(JPEG_SIZE, W.WarmCache(tmp_path / "warm"))
    assert build.resolutions[str(JPEG_SIZE)] == "cache"
    assert build.library_path(JPEG_SIZE).read_bytes() == built
    assert build.compiler_runs["jpeg_size"] == runs + 1
    assert tracing.registry().counter("warmcache/hits").value == 1
    assert isinstance(lib, ctypes.CDLL) and lib.jpeg_encode
    assert not list(build.BUILD_DIR.glob("*.tmp"))


def test_a_library_that_does_not_load_is_quarantined_and_rebuilt(tmp_path, monkeypatch):
    """The JAX "recompile" degrade: load_error, quarantine, the compiler."""
    cache = W.WarmCache(tmp_path / "warm")
    _cold(monkeypatch, tmp_path / "build")
    fp = W.native_fingerprint(JPEG_SIZE)
    key = W.entry_key(fp)
    cache.store("native/jpeg_size", key, fp, W.TIER_NATIVE, b"not an ELF file")
    runs = build.compiler_runs["jpeg_size"]
    lib = build.load(JPEG_SIZE, cache)
    assert lib.jpeg_encode and build.compiler_runs["jpeg_size"] == runs + 1
    assert R.counters() == {"warmcache/load_error": 1}
    assert list((tmp_path / "warm").glob("*.quarantined.*"))
    # the rebuilt library is the entry now
    assert W.WarmCache(tmp_path / "warm").load("native/jpeg_size", key, fp) == \
        build.library_path(JPEG_SIZE).read_bytes()


def test_concurrent_stores_leave_one_whole_entry(tmp_path):
    cache = W.WarmCache(tmp_path)
    fp = _fp()
    key = W.entry_key(fp)
    payloads = [bytes([i]) * 4096 for i in range(8)]
    threads = [threading.Thread(target=cache.store,
                                args=("native/x", key, fp, W.TIER_NATIVE, p)) for p in payloads]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cache.load("native/x", key, fp) in payloads
    assert [p.name for p in tmp_path.iterdir()] == [cache.entry_path("native/x", key).name]


# ---------------------------------------------------------------------------
# aot_compile
# ---------------------------------------------------------------------------

def test_aot_compile_on_the_cpu_is_eager_and_stores_nothing(tmp_path):
    from dcr_tpu_torch.diffusion.train import make_train_step
    from dcr_tpu_torch.sampling.sampler import make_sampler

    cache = W.WarmCache(tmp_path)
    res = W.aot_compile(make_train_step, ({"w": torch.zeros(2)},), cache=cache)
    assert (res.source, res.surface, res.build_s) == ("eager", "train/step", 0.0)
    # on a CUDA device with flash attention off the sampler launches no kernel
    res = W.aot_compile(make_sampler, (torch.device("cuda"),),
                        static_config={"flash_attention": False})
    assert (res.source, res.surface) == ("eager", "sample/sampler")
    assert tracing.registry().counter("warmcache/eager").value == 2
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("surface,stems", [
    ("sample/sampler", ["flash_attention_fwd"]),
    ("serve/batch_sampler", ["flash_attention_fwd"]),
    ("train/step", ["flash_attention_fwd", "flash_attention_bwd"]),
    ("train/denoise", ["flash_attention_fwd", "flash_attention_bwd"]),
    ("train/encode", []), ("eval/embed", []), ("search/topk", []),
])
def test_native_sources_of_each_surface(surface, stems):
    cuda = torch.device("cuda")
    assert [s.stem for s in W.native_sources(surface, (cuda,))] == stems
    assert all(s.exists() for s in W.native_sources(surface, (cuda,)))
    assert W.native_sources(surface, (torch.zeros(1),)) == ()
    assert W.native_sources(surface, (cuda,), {"flash_attention": False}) == ()


# ---------------------------------------------------------------------------
# the serve warm plan, and the registry
# ---------------------------------------------------------------------------

def _stand_in(service_cls, cfg, default, bucket_cls, cache_cls, warm_dir):
    """What begin_warm reads of a service: cfg, default_bucket(),
    _vae_scale and the cache."""
    return SimpleNamespace(cfg=cfg, default_bucket=lambda: default, _vae_scale=8,
                           _warmcache=cache_cls(warm_dir), _warm_plan=None,
                           _warm_complete=threading.Event())


def test_serve_warm_plan_equals_the_jax_workers(tmp_path):
    fields = dict(resolution=64, steps=4, guidance=7.5, sampler="ddim", rand_noise_lam=0.0)
    tdefault = TQ.GenBucket(**fields)
    jdefault = JQ.GenBucket(**fields)
    manifest = [
        [64, 8, 7.5, "ddim", 0.0],                 # the pre-fast 5-element form
        [64, 4, 7.5, "ddim", 0.0, 0.0, 2],          # the default again
        [64, 6, 7.5, "nope", 0.0, 0.0, 2],          # invalid sampler
        [60, 6, 7.5, "ddim", 0.0, 0.0, 2],          # not a multiple of the VAE scale
        "junk",
        [64, 10, 5.0, "dpm++", 0.1, 0.5, 2],
        [64, 12, 7.5, "ddpm", 0.0, 0.0, 2],
        [32, 4, 7.5, "ddim", 0.0, 0.0, 2],
    ]
    W.update_warm_manifest(tmp_path, manifest)
    plans = {}
    for budget in (8, 3):
        tcfg = TC.ServeConfig(max_compiled_buckets=budget, warm=TC.WarmCacheConfig(dir=str(tmp_path)))
        jcfg = JC.ServeConfig(max_compiled_buckets=budget, warm=JC.WarmCacheConfig(dir=str(tmp_path)))
        tstub = _stand_in(TSW.GenerationService, tcfg, tdefault, TQ.GenBucket, W.WarmCache, tmp_path)
        jstub = _stand_in(JSW.GenerationService, jcfg, jdefault, JQ.GenBucket, JW.WarmCache,
                          tmp_path)
        n = TSW.GenerationService.begin_warm(tstub)
        assert n == JSW.GenerationService.begin_warm(jstub) == min(5, budget - 1)
        plans[budget] = [tuple(b) for b in tstub._warm_plan]
        assert plans[budget] == [tuple(b) for b in jstub._warm_plan]
        assert not tstub._warm_complete.is_set()
    assert plans[8][0] == tuple(tdefault) and plans[8][1] == (32, 4, 7.5, "ddim", 0.0, 0.0, 2)
    assert plans[3] == plans[8][:2]
    # three invalid entries per plan, counted in each package
    assert R.counters()["warmcache/manifest_entry_invalid"] == 6
    assert JR.counters()["warmcache/manifest_entry_invalid"] >= 6


def test_every_jax_surface_name_is_registered_by_the_port():
    for mod in ("dcr_tpu.sampling.sampler", "dcr_tpu.serve.worker", "dcr_tpu.diffusion.train",
                "dcr_tpu.diffusion.encode_stage", "dcr_tpu.diffusion.trainer",
                "dcr_tpu.eval.features", "dcr_tpu.eval.runner", "dcr_tpu.obs.copyrisk",
                "dcr_tpu.search.shardindex", "dcr_tpu.search.search", "dcr_tpu.search.annindex",
                "dcr_tpu.search.ann"):
        importlib.import_module(mod)
        importlib.import_module(mod.replace("dcr_tpu.", "dcr_tpu_torch.", 1))
    jax_names = {n for n in JCS.REGISTRY if not n.startswith("test/")}
    assert len(jax_names) == 15 and jax_names <= set(TCS.REGISTRY)
    for name in jax_names:
        assert TCS.REGISTRY[name].name == JCS.REGISTRY[name].name == name
        assert TCS.REGISTRY[name].qualname.startswith("dcr_tpu_torch.")
    assert set(W.SURFACE_SOURCES) <= set(TCS.REGISTRY)
    with pytest.raises(ValueError, match="registered twice"):
        TCS.compile_surface("train/step")(lambda: None)
    # the name a caller's aot_compile reads is the one registered
    for name, info in TCS.REGISTRY.items():
        module, qualname = info.qualname.split(":")
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        assert obj.__compile_surface__ == name
