"""PyTorch port: the multi-process runtime (``core/dist``), the mesh
(``parallel/mesh``) and the data-parallel train step, against the JAX
package.

Ranks are subprocesses over gloo on a FileStore in the test's tmp dir
(``tests/_torch_ranks.py``); the JAX side runs here on conftest's 8 CPU
devices. The data = 2 step is held to the JAX step on a data = 2 mesh at
the train tests' bars (``tests/test_torch_train.py``): f32 losses at rtol
1e-5, grad norms at 1e-4, parameters within 1e-2 lr per step; bf16 losses
at rtol 2e-2.
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax
import numpy as np
import pytest
import torch

from dcr_tpu.core import rng as jrng
from dcr_tpu.core.config import MeshConfig
from dcr_tpu.diffusion import train as JT
from dcr_tpu.diffusion.trainer import build_modules
from dcr_tpu.parallel import mesh as jpmesh
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.core import dist
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.parallel import mesh as tpmesh
from tests._torch_ranks import Ranks, check, spawn
from tests.test_torch_train import (LR, _batch, _jax_draws, _params, _port_cfg,
                                    _to_port, _train_cfg)


def run_jax_step(cfg, params: dict, steps: int):
    """The JAX step on a mesh of ``cfg.mesh``'s shape over the first CPU
    devices from ``params``, on tests/test_torch_train.py's batch and root
    key: (state after ``steps``, metrics per step)."""
    m = cfg.mesh
    mesh = jpmesh.make_mesh(m, devices=jax.devices()[:m.data * m.fsdp * m.tensor * m.seq])
    models = build_modules(cfg, mesh=mesh)
    p = jax.tree.map(lambda x: jax.numpy.array(np.asarray(x)), params)
    state = JT.shard_train_state(JT.init_train_state(
        cfg, models, unet_params=p["unet"], text_params=p["text"], vae_params=p["vae"]), mesh)
    step = JT.make_train_step(cfg, models, mesh)
    batch = jpmesh.shard_batch(mesh, dict(_batch(cfg)))
    key = jrng.root_key(0)
    history = []
    for _ in range(steps):
        state, m = step(state, batch, key)
        history.append({k: float(v) for k, v in jax.device_get(m).items()})
    return jax.device_get(state), history


def run_steps(tmp, runs: dict, world, extra: dict | None = None) -> dict:
    """Each run ``name: (cfg, steps)`` by both packages from the same seeded
    params, batch and global draws: the port's as ``world`` gloo ranks
    (``world``: a count, or ``{name: count}``; every group started first,
    so they run while the JAX steps compile; ``extra[name]``: more of the
    rank case's run arguments), the JAX step on a mesh of ``cfg.mesh``'s
    shape. Returns ``name: (jax state, jax metrics, [each
    rank's result])``."""
    worlds = world if isinstance(world, dict) else {name: world for name in runs}
    params, args = {}, {}
    for name, (cfg, steps) in runs.items():
        d = tmp / name
        d.mkdir(parents=True)
        params[name] = _params(cfg)
        torch.save(_to_port(params[name], cfg), d / "params.pt")
        np.savez(d / "batch.npz", **_batch(cfg))
        torch.save([_jax_draws(cfg, jrng.root_key(0), i) for i in range(steps)],
                   d / "draws.pt")
        args.setdefault(worlds[name], {})[name] = {
            "cfg": dataclasses.asdict(_port_cfg(cfg)), "steps": steps,
            **(extra or {}).get(name, {})}
    groups = [Ranks("train_step", n, tmp / f"ranks{n}", {"runs": {
        name: dict(a, dir=str(tmp / name)) for name, a in group.items()}})
        for n, group in args.items()]
    jax_runs = {name: run_jax_step(cfg, params[name], steps)
                for name, (cfg, steps) in runs.items()}
    for ranks in groups:
        check(ranks.wait())
    return {name: (*jax_runs[name],
                   [torch.load(tmp / name / f"train_{r}.pt") for r in range(worlds[name])])
            for name in runs}


def assert_step_matches(jstate, jhist, ranks, cfg, steps: int) -> None:
    """Every rank's metrics against the JAX step's, the ranks' parameters
    bit-equal to each other and within the bar of JAX's."""
    bf16 = cfg.mixed_precision == "bf16"
    for r in ranks:
        assert r["step"] == steps
        for jm, tm in zip(jhist, r["history"]):
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-2 if bf16 else 1e-5)
            np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                       rtol=5e-2 if bf16 else 1e-4)
            np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6, atol=1e-12)
    for r in ranks[1:]:
        assert all(torch.equal(r["unet"][k], ranks[0]["unet"][k]) for k in r["unet"])
    want = EX.unet_from_flax(jstate.unet_params, len(cfg.model.block_out_channels))
    diffs = torch.cat([(want[k] - ranks[0]["unet"][k]).abs().flatten() for k in want])
    if bf16:
        assert diffs.max() <= 2.1 * LR * steps and diffs.mean() <= 0.05 * LR * steps
    else:
        assert diffs.max() <= 1e-2 * LR * steps, f"max |param diff| {diffs.max():.3e}"


DATA2_RUNS = {"f32": (dict(), 2), "bf16": (dict(mixed_precision="bf16"), 1),
              "mixup": (dict(rand_noise_lam=0.1, mixup_noise_lam=0.3,
                             train_text_encoder=True), 1)}


def _data2_cfg(name):
    cfg = _train_cfg(**DATA2_RUNS[name][0])
    cfg.mesh = MeshConfig(data=2)
    return cfg


@pytest.fixture(scope="module")
def data2(tmp_path_factory):
    runs = {name: (_data2_cfg(name), steps) for name, (_, steps) in DATA2_RUNS.items()}
    return runs, run_steps(tmp_path_factory.mktemp("data2"), runs, 2)


@pytest.mark.parametrize("name", list(DATA2_RUNS))
def test_data_parallel_step_matches_jax_on_a_data2_mesh(data2, name):
    """Two ranks, two rows each, against the JAX step on a data = 2 mesh
    over the same global batch of 4: one gradient mean per step, the clip
    on the global norm, the global loss on both ranks. ``mixup`` mixes text
    embeddings across the global batch (gather_rows) and trains the text
    encoder through it."""
    runs, results = data2
    cfg, steps = runs[name]
    jstate, jhist, ranks = results[name]
    assert_step_matches(jstate, jhist, ranks, cfg, steps)
    # per step the gradients and the loss; mixup adds gather_rows' backward
    reduces = (3 if name == "mixup" else 2) * steps
    assert ranks[0]["exchanges"]["all_reduce"]["calls"] == reduces
    if name == "mixup":
        want = EX.text_from_flax(jstate.text_params)
        diffs = torch.cat([(want[k] - ranks[0]["text"][k]).abs().flatten() for k in want])
        assert diffs.max() <= 1e-2 * LR
        assert ranks[0]["exchanges"]["all_gather"]["calls"] == 1


def test_control_plane_and_collectives_over_two_ranks(tmp_path):
    results = spawn("basics", 2, tmp_path)
    check(results)
    r0, r1 = (torch.load(tmp_path / f"basics_{r}.pt") for r in (0, 1))
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    assert r0["primary"] and not r1["primary"]
    assert r0["gathered"] == r1["gathered"] == ["r0", "r1"]
    assert r1["gathered_again"] == ["again0", "again1"]
    assert r0["alone"].startswith("BarrierTimeout: barrier:alone0")
    assert r1["alone"].startswith("BarrierTimeout: barrier:alone1")
    assert r0["coords"]["data"] == 0 and r1["coords"]["data"] == 1
    assert r0["to_host"] == r1["to_host"] == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
    assert r0["local_rows"] == [0, 1] and r1["local_rows"] == [2, 3]
    assert r0["mean"] == r1["mean"] == [[1.5] * 5, [1.0] * 70]


@pytest.mark.parametrize("shape", [dict(data=8), dict(data=2, seq=4), dict(data=4, seq=2),
                                   dict(data=-1, seq=2)])
def test_mesh_puts_rank_r_where_the_jax_mesh_puts_device_r(shape):
    """The (data, fsdp, tensor, seq) reshape order, seq innermost: each
    rank's coordinates are those of device r in the JAX mesh."""
    jmesh = jpmesh.make_mesh(MeshConfig(**shape))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(8):
        want = dict(zip(tpmesh.AXES, (int(i) for i in np.argwhere(ids == r)[0])))
        assert tpmesh.mesh_coords(TC.MeshConfig(**shape), 8, r) == want


def test_one_process_mesh_and_refusals():
    mesh = tpmesh.make_mesh(TC.MeshConfig())
    assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}
    assert all(g is None for g in mesh.groups.values())
    x = torch.arange(6).reshape(3, 2)
    assert tpmesh.local_rows(x, mesh) is x
    assert tpmesh.to_host(x, mesh).tolist() == x.tolist()
    with pytest.raises(ValueError, match="mesh"):
        tpmesh.make_mesh(TC.MeshConfig(data=3), world_size=2, rank=0)
    assert not dist.initialize("cpu")  # no job in the environment: one process
    assert (dist.process_index(), dist.process_count(), dist.is_primary()) == (0, 1, True)


def test_env_topology_reads_both_packages_variables(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert dist.env_topology() is None
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert dist.env_topology() == ("10.0.0.1", 1234, 4, 3)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:5678")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    assert dist.env_topology() == ("127.0.0.1", 5678, 2, 1)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "no-port")
    with pytest.raises(ValueError, match="host:port"):
        dist.env_topology()
    assert (dist.default_backend("cuda"), dist.default_backend("cpu")) == ("nccl", "gloo")


def test_run_with_timeout_is_typed_and_inline_without_a_budget():
    with pytest.raises(dist.BarrierTimeout, match="slow"):
        dist.run_with_timeout(lambda: time.sleep(5), 0.2, name="slow")
    assert dist.run_with_timeout(lambda: 7, 0) == 7
    assert dist.run_with_timeout(lambda: 8, 1.0) == 8
    with pytest.raises(KeyError):
        dist.run_with_timeout(lambda: {}["x"], 1.0)
    assert dist.default_allgather_timeout_s() == float(
        os.environ.get("DCR_ALLGATHER_TIMEOUT_S", "600"))


def test_health_check_refuses_an_incoherent_topology(monkeypatch):
    """Ranks out of slot order, or disagreeing on the world, end the join."""
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "process_index", lambda: 0)
    for rows, match in ((["0:2", "0:2"], "slot order"), (["0:2", "1:3"], "world size")):
        monkeypatch.setattr(dist, "kv_allgather", lambda *a, rows=rows: rows)
        with pytest.raises(dist.RendezvousError, match=match):
            dist._post_join_health_check()

    def stalled(*a):
        raise dist.BarrierTimeout("peer 1 absent")
    monkeypatch.setattr(dist, "kv_allgather", stalled)
    with pytest.raises(dist.RendezvousError, match="stalled"):
        dist._post_join_health_check()


@pytest.mark.parametrize("where", ["eval", "search", "serve"])
def test_a_mesh_outside_training_still_raises_naming_item_9b(where, tmp_path):
    """Training and bulk sampling run a mesh (items 9a and 9b's first
    half), and so do eval and search (9b's second half, the rank jobs of
    tests/test_torch_mesh_{eval,search}.py): a ``data = 2`` mesh passes
    eval's validator and parses for search, which runs every setting. A
    mesh in serving is the rest of item 9b and raises, never ignored."""
    mesh = TC.MeshConfig(data=2)
    calls = {
        "eval": lambda: TC.validate_eval_config(TC.EvalConfig(mesh=mesh)),
        "search": lambda: TC.parse_cli(TC.SearchConfig, ["--mesh.data=2"]),
        "serve": lambda: TC.validate_serve_config(TC.ServeConfig(mesh=mesh)),
    }
    if where == "serve":
        with pytest.raises(TC.NotPortedError, match="item 9b"):
            calls[where]()
    else:
        calls[where]()
        # and with the warm cache, which runs since it was ported
        (TC.validate_eval_config(TC.EvalConfig(mesh=mesh, warm=TC.WarmCacheConfig(dir="w")))
         if where == "eval" else
         TC.parse_cli(TC.SearchConfig, ["--mesh.data=2", "--warm_dir=w"]))
    # the data x seq mesh itself passes the training gate
    TC.validate_train_config(TC.TrainConfig(mesh=TC.MeshConfig(data=2, seq=4)))
