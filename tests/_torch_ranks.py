"""Launcher and rank programs of the port's multi-process CPU tests.

A test calls :func:`spawn`; every rank runs this file as a script, imports
only ``torch`` and ``dcr_tpu_torch``, joins a gloo job on a ``FileStore`` in
the test's tmp dir (no ports, so no races between parallel test workers),
runs one case of :data:`CASES` on one intra-op thread and writes what it
computed under that dir with ``torch.save``. The JAX side of each
comparison runs in the test's own process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def rank_env(**extra: str) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("COORDINATOR_", "MASTER_", "DCR_FAULTS", "DCR_HANG"))
           and k not in ("NUM_PROCESSES", "PROCESS_ID", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", DCR_TPU_PLATFORM="cpu",
               PYTHONUNBUFFERED="1")
    env.update(extra)
    return env


class Ranks:
    """``world`` running ranks of ``case``: :meth:`wait` returns
    ``[(returncode, output)]`` by rank, killing every rank still alive after
    ``timeout`` seconds."""

    def __init__(self, case: str, world: int, tmp: Path, args: dict | None = None, *,
                 env: dict | None = None):
        self.tmp = Path(tmp)
        self.tmp.mkdir(parents=True, exist_ok=True)
        (self.tmp / "args.json").write_text(json.dumps(args or {}))
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, case, str(r), str(world), str(self.tmp)],
            env=env or rank_env(), cwd=str(self.tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait(self, timeout: float = 240) -> list[tuple[int, str]]:
        out = []
        try:
            for p in self.procs:
                text, _ = p.communicate(timeout=timeout)
                out.append((p.returncode, text))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        return out


def spawn(case: str, world: int, tmp: Path, args: dict | None = None, *,
          timeout: float = 240, env: dict | None = None) -> list[tuple[int, str]]:
    """Run ``case`` as ``world`` ranks to the end (see :class:`Ranks`)."""
    return Ranks(case, world, tmp, args, env=env).wait(timeout)


def check(results: list[tuple[int, str]]) -> None:
    bad = [(r, rc, text[-3000:]) for r, (rc, text) in enumerate(results) if rc != 0]
    assert not bad, "\n".join(f"rank {r} exit {rc}:\n{text}" for r, rc, text in bad)


# ---------------------------------------------------------------------------
# the rank side: only torch and dcr_tpu_torch from here on
# ---------------------------------------------------------------------------

def _join(rank: int, world: int, tmp: Path) -> None:
    import torch

    from dcr_tpu_torch.core import dist

    torch.set_num_threads(1)
    store = torch.distributed.FileStore(str(tmp / "store"), world)
    dist.initialize("cpu", backend="gloo", store=store, rank=rank, world_size=world)


def case_basics(rank: int, world: int, tmp: Path, args: dict) -> None:
    """The control plane and the mesh's plain collectives."""
    import time

    import torch

    from dcr_tpu_torch.core import dist
    from dcr_tpu_torch.core.config import MeshConfig
    from dcr_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    _join(rank, world, tmp)
    out: dict = {"join_s": time.perf_counter() - t0, "rank": dist.process_index(),
                 "world": dist.process_count(), "primary": dist.is_primary()}
    out["gathered"] = dist.kv_allgather(f"r{rank}", "test", timeout_s=30)
    out["gathered_again"] = dist.kv_allgather(f"again{rank}", "test", timeout_s=30)
    dist.barrier("together", timeout_s=30)
    # a barrier no peer enters (each rank names its own): a typed timeout
    try:
        dist.barrier(f"alone{rank}", timeout_s=0.5)
        out["alone"] = "passed"
    except dist.BarrierTimeout as e:
        out["alone"] = f"BarrierTimeout: {e}"
    dist.barrier("after", timeout_s=30)
    mesh = pmesh.make_mesh(MeshConfig(data=world))
    out["coords"] = mesh.coords
    rows = torch.full((2, 3), float(rank))
    out["to_host"] = pmesh.to_host(rows, mesh).tolist()
    out["local_rows"] = pmesh.local_rows(torch.arange(2 * world), mesh).tolist()
    t = [torch.full((5,), float(rank + 1)), torch.full((70,), 2.0 * rank)]
    pmesh.all_reduce_mean_(t)
    out["mean"] = [x.tolist() for x in t]
    torch.save(out, tmp / f"basics_{rank}.pt")


def case_attention(rank: int, world: int, tmp: Path, args: dict) -> None:
    """ring_self_attention and ulysses_self_attention on the global q/k/v
    of each input file: the output and the gradients of sum(out * g)."""
    import torch

    from dcr_tpu_torch.core.config import MeshConfig
    from dcr_tpu_torch.ops import ring_attention as RA
    from dcr_tpu_torch.ops import ulysses_attention as UA
    from dcr_tpu_torch.parallel import mesh as pmesh

    _join(rank, world, tmp)
    mesh = pmesh.make_mesh(MeshConfig(data=1, seq=world))
    fns = {"ring": RA.ring_self_attention,
           "ulysses": lambda q, k, v, m: UA.ulysses_self_attention(q, k, v, m, use_flash=False)}
    out: dict = {}
    for name in args["inputs"]:
        x = torch.load(tmp / f"{name}.pt")
        for kind, fn in fns.items():
            q, k, v = (x[n].clone().requires_grad_(True) for n in "qkv")
            try:
                o = fn(q, k, v, mesh)
            except ValueError as e:
                out[(name, kind)] = {"error": str(e)}
                continue
            dq, dk, dv = torch.autograd.grad((o * x["g"]).sum(), (q, k, v))
            out[(name, kind)] = {"out": o.detach(), "dq": dq, "dk": dk, "dv": dv}
    torch.save(out, tmp / f"attention_{rank}.pt")


def case_train_step(rank: int, world: int, tmp: Path, args: dict) -> None:
    """For each run of ``args["runs"]``: the port's train step on this
    rank's rows of the run's global batch, with the global draws of every
    step injected (inputs and results in ``<tmp>/<run>/``)."""
    import numpy as np
    import torch

    from dcr_tpu_torch.core import config as TC
    from dcr_tpu_torch.diffusion import train as TT
    from dcr_tpu_torch.parallel import mesh as pmesh
    from dcr_tpu_torch.sampling.pipeline import build_models

    _join(rank, world, tmp)
    for name, run in args["runs"].items():
        d = Path(run.get("dir", tmp / name))
        cfg = TC.from_dict(TC.TrainConfig, run["cfg"])
        mesh = pmesh.make_mesh(cfg.mesh)
        models = build_models(cfg.model, "cpu", mesh=mesh)
        params = torch.load(d / "params.pt")
        state = TT.init_train_state(cfg, models, unet_params=params["unet"],
                                    text_params=params["text"], vae_params=params["vae"],
                                    mesh=mesh, min_fsdp_size=run.get("min_fsdp_size", 2 ** 16))
        step_fn = TT.make_train_step(cfg, models, mesh)
        batch = dict(np.load(d / "batch.npz"))
        n, i = mesh.data_parallel_size, mesh.batch_index
        rows = len(batch["input_ids"]) // n
        local = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        draws = torch.load(d / "draws.pt")
        pmesh.EXCHANGE_STATS.clear()
        history = []
        for step in range(run["steps"]):
            state, m = step_fn(state, local, draws[step])
            history.append({k: float(v) for k, v in m.items()})
        exchanges = dict(pmesh.EXCHANGE_STATS)
        whole = {c: {k: p.detach() for k, p in ps.items()} for c, ps in
                 (("unet", state.unet_params), ("text", state.text_params))}
        if state.layout is not None:  # the shards' whole tensors, and the rank's own
            whole = {c: state.layout.full_dict(c, whole[c]) for c in whole}
            whole["shapes"] = {k: tuple(p.shape) for k, p in state.unet_params.items()}
            whole["mu_shapes"] = {k: tuple(p.shape) for k, p in state.opt_state.mu.items()}
            whole["ema_shapes"] = {k: tuple(p.shape)
                                   for k, p in (state.ema_params or {}).items()}
        torch.save({"history": history, "step": state.step, **whole,
                    "exchanges": exchanges}, d / f"train_{rank}.pt")


def case_fsdp_checkpoint(rank: int, world: int, tmp: Path, args: dict) -> None:
    """One step of the port's train step on ``args["cfg"]``'s sharded mesh
    (its own draws), then the Trainer's checkpoint and HF-layout export
    (every rank gathers, rank 0 writes), and each rank's gathered state in
    ``whole_<rank>.pt``."""
    import numpy as np
    import torch

    from dcr_tpu_torch.core import config as TC
    from dcr_tpu_torch.core import dist
    from dcr_tpu_torch.core.checkpoint import CheckpointManager
    from dcr_tpu_torch.diffusion import train as TT
    from dcr_tpu_torch.diffusion.trainer import export_train_state
    from dcr_tpu_torch.parallel import mesh as pmesh
    from dcr_tpu_torch.sampling.pipeline import build_models

    _join(rank, world, tmp)
    cfg = TC.from_dict(TC.TrainConfig, args["cfg"])
    mesh = pmesh.make_mesh(cfg.mesh)
    models = build_models(cfg.model, "cpu", mesh=mesh)
    params = torch.load(tmp / "params.pt")
    state = TT.init_train_state(cfg, models, unet_params=params["unet"],
                                text_params=params["text"], vae_params=params["vae"],
                                mesh=mesh)
    rng = np.random.default_rng(0)
    px = cfg.model.sample_size * 2 ** (len(cfg.model.vae_block_out_channels) - 1)
    batch = {"pixel_values": rng.uniform(-1, 1, (2, px, px, 3)).astype(np.float32),
             "input_ids": rng.integers(0, 1000, (2, cfg.model.text_max_length))}
    state, _ = TT.make_train_step(cfg, models, mesh)(state, batch)
    CheckpointManager(tmp / "ckpt").save(state.step, state, primary=dist.is_primary())
    export_train_state(cfg, state, tmp / "export")
    layout = state.layout
    whole = {"unet": layout.full_dict("unet", state.unet_params),
             "ema": layout.full_dict("unet", state.ema_params),
             "mu": layout.full_dict(None, state.opt_state.mu)}
    torch.save(whole, tmp / f"whole_{rank}.pt")


def case_generate(rank: int, world: int, tmp: Path, args: dict) -> None:
    """``sampling.pipeline.generate`` on this rank, over ``args["cfg"]``'s
    mesh, the x_T of every image from ``<tmp>/x_t.npy``; the rank's
    exchanges in ``exchanges_<rank>.pt``."""
    import numpy as np
    import torch

    from dcr_tpu_torch.core import config as TC
    from dcr_tpu_torch.data.tokenizer import HashTokenizer
    from dcr_tpu_torch.parallel import mesh as pmesh
    from dcr_tpu_torch.sampling.pipeline import generate

    _join(rank, world, tmp)
    cfg = TC.from_dict(TC.SampleConfig, args["cfg"])
    generate(cfg, modelstyle="classlevel", tokenizer=HashTokenizer(*args["tokenizer"]),
             device="cpu", init_latents=np.load(tmp / "x_t.npy"))
    torch.save(dict(pmesh.EXCHANGE_STATS), tmp / f"exchanges_{rank}.pt")


def case_train_cli(rank: int, world: int, tmp: Path, args: dict) -> None:
    """``dcr-train-torch``'s main on this rank, the job joined first on the
    FileStore (the Trainer then finds it joined)."""
    _join(rank, world, tmp)
    from dcr_tpu_torch.cli import train

    train.main(args["argv"])


def case_mesh_search(rank: int, world: int, tmp: Path, args: dict) -> None:
    """Each run of ``args["runs"]`` on this rank, in order: the exact engine
    (``exact``), the ANN engine (``ann``) or ``query_live`` (``live``) over
    the run's mesh, on ``<tmp>/q.npy``; ``dcr-search-torch``'s main
    (``cli``); or a copy-risk index over a store (``copyrisk``, which must
    make no cross-rank exchange). What each computed, with its exchanges,
    goes to ``mesh_search_<rank>.pkl``."""
    import pickle

    import numpy as np

    from dcr_tpu_torch.cli import search as cli
    from dcr_tpu_torch.core.config import MeshConfig, RiskConfig
    from dcr_tpu_torch.obs.copyrisk import CopyRiskIndex
    from dcr_tpu_torch.parallel import mesh as pmesh
    from dcr_tpu_torch.search import annindex as AI
    from dcr_tpu_torch.search import livestore as LS
    from dcr_tpu_torch.search import shardindex as SI
    from dcr_tpu_torch.search.store import EmbeddingStoreReader

    _join(rank, world, tmp)
    q = np.load(tmp / "q.npy")
    out: dict = {}
    for name, run in args["runs"].items():
        kind, kw = run["kind"], run.get("kw", {})
        pmesh.EXCHANGE_STATS.clear()
        rec: dict = {}
        if kind == "cli":
            cli.main(run["argv"])
        elif kind == "copyrisk":
            index = CopyRiskIndex.load(RiskConfig(store_dir=run["store"], image_size=32,
                                                  top_k=2), batch=2, device="cpu")
            images = np.random.default_rng(rank).uniform(0, 1, (2, 40, 40, 3))
            rec["scores"] = [s.max_sim for s in index.score_batch(images)]
        else:
            mesh = pmesh.make_mesh(MeshConfig(**run["mesh"]))
            if kind == "live":
                rec["scores"], rec["keys"] = LS.query_live(run["store"], q, mesh=mesh,
                                                           device="cpu", **kw)
            else:
                eng = (SI.ShardedTopK(EmbeddingStoreReader(run["store"]), mesh=mesh,
                                      device="cpu", **kw) if kind == "exact" else
                       AI.AnnEngine(run["store"], mesh=mesh, device="cpu", **kw)).build()
                rec["scores"], rec["keys"] = eng.query(q)
                rec.update(segment_rows=eng.segment_rows, resident=eng.resident,
                           rows_held=eng.rows_held,
                           rerank_rows=getattr(eng, "rerank_rows", None))
        rec["exchanges"] = dict(pmesh.EXCHANGE_STATS)
        out[name] = rec
    (tmp / f"mesh_search_{rank}.pkl").write_bytes(pickle.dumps(out))


def case_mesh_eval(rank: int, world: int, tmp: Path, args: dict) -> None:
    """``dcr-eval-torch``'s main for each ``args["eval"]`` argv,
    ``dcr-search-torch embed`` for each ``args["embed"]`` argv, and the
    similarity products of ``<tmp>/sim.npz`` over the job's ``data`` mesh,
    on this rank; the scalars, the embed's decode counts, the matrices and
    every path this rank opened for writing (or made) under
    ``args["watch"]`` go to ``mesh_eval_<rank>.pkl``."""
    import os
    import pickle
    import sys

    import numpy as np
    import torch

    from dcr_tpu_torch.cli import evaluate
    from dcr_tpu_torch.cli import search as cli
    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.core.config import MeshConfig
    from dcr_tpu_torch.data.tokenizer import HashTokenizer
    from dcr_tpu_torch.eval import runner
    from dcr_tpu_torch.eval import similarity as SIM
    from dcr_tpu_torch.parallel import mesh as pmesh

    written: list[str] = []

    def audit(event: str, a: tuple) -> None:
        if event == "open" and isinstance(a[0], (str, bytes, os.PathLike)):
            mode, flags = a[1], a[2]
            writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                      else bool(flags & (os.O_WRONLY | os.O_RDWR)))
        else:
            writes = event in ("os.mkdir", "os.rename", "os.replace")
        if writes:
            path = os.fsdecode(a[0])
            if path.startswith(tuple(args["watch"])):
                written.append(path)

    sys.addaudithook(audit)
    _join(rank, world, tmp)
    backbone = torch.load(tmp / "sscd.pt")
    plain_run_eval = runner.run_eval
    # the weights and tokenizer the test's own runs use
    evaluate.run_eval = lambda cfg, **kw: plain_run_eval(
        cfg, backbone_state_dict=backbone, tokenizer=HashTokenizer(1000, 77), **kw)
    out: dict = {"eval": {}, "embed": {}}
    for name, argv in args["eval"].items():
        out["eval"][name] = evaluate.main(argv)
    for name, argv in args["embed"].items():
        before = tracing.registry().counters("search/embed_decoded")
        cli.main(["embed", *argv])
        after = tracing.registry().counters("search/embed_decoded")
        out["embed"][name] = {k: after[k] - before.get(k, 0) for k in after}
    mesh = pmesh.make_mesh(MeshConfig(data=world))
    with np.load(tmp / "sim.npz") as z:
        values, query = z["values"], z["query"]
    out["sim"] = {
        "dot": SIM.similarity_matrix(values, query, block_size=5, device="cpu", mesh=mesh),
        "cross": SIM.similarity_matrix(values, query, metric="splitloss", num_chunks=4,
                                       chunk_style="cross", block_size=5, device="cpu",
                                       mesh=mesh),
        "bg": SIM.train_train_background(values, block_size=5, device="cpu", mesh=mesh)}
    out["written"] = written
    (tmp / f"mesh_eval_{rank}.pkl").write_bytes(pickle.dumps(out))


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


if __name__ == "__main__":
    case, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    CASES[case](rank, world, tmp, json.loads((tmp / "args.json").read_text()))
    from dcr_tpu_torch.core import dist

    dist.shutdown()
