"""PyTorch port: FSDP sharding (``parallel/sharding``, ``parallel/sharded``)
against the JAX package.

- Placement: for every leaf of the UNet, VAE and text encoder, the port's
  placement cuts the same elements to the same rank as the JAX
  ``params_sharding`` spec does, carried through the converters'
  transposes and reshapes (``models/export``), on ``fsdp = 2``,
  ``tensor = 2`` and ``fsdp = 2 x tensor = 2`` meshes; the JAX optimizer
  state and EMA take their parameter's spec, as the port's do.
- The train step as two gloo ranks on ``fsdp = 2`` against the JAX step on
  an ``fsdp = 2`` mesh (``tests/test_torch_dist.py``'s bars: f32 losses at
  rtol 1e-5, grad norms at 1e-4, parameters within 1e-2 lr per step; bf16
  losses at 2e-2), with the state held as shards between steps.
- A checkpoint saved under ``fsdp = 2`` restores bit for bit in one
  process, and its HF-layout export loads in the JAX package bit for bit.

The tiny config has a first level of one head of 16 (which ``tensor = 2``
does not divide) and a 128-wide second level, whose convolutions and
feed-forward kernels pass FSDP's 2^16 elements.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dcr_tpu.core.config import MeshConfig
from dcr_tpu.diffusion import train as JT
from dcr_tpu.diffusion.trainer import build_modules
from dcr_tpu.parallel import mesh as jpmesh
from dcr_tpu.parallel.sharding import params_sharding as j_params_sharding
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.models import export as EX
from dcr_tpu_torch.parallel import mesh as tpmesh
from dcr_tpu_torch.parallel import sharding as tsh
from tests._torch_ranks import spawn, check
from tests.test_torch_dist import assert_step_matches, run_steps
from tests.test_torch_models import tiny_cfg
from tests.test_torch_train import _params, _to_port, _train_cfg


def mesh_model():
    """Level 0: one head of 16; level 1: 8 heads of 16, 128 wide; a text
    vocabulary of 1,500 x 48 (72,000 elements: FSDP-sharded)."""
    return tiny_cfg(block_out_channels=(16, 128), attention_head_dim=16,
                    text_vocab_size=1500)


MESHES = {"fsdp": dict(fsdp=2), "tensor": dict(tensor=2), "fsdp_tensor": dict(fsdp=2, tensor=2)}


def _owner(shape, dim, n) -> np.ndarray:
    """Which of ``n`` ranks holds each element when ``dim`` is cut in n
    (all 0 when ``dim`` is None)."""
    if dim is None:
        return np.zeros(shape, np.int64)
    idx = np.arange(shape[dim]) // (shape[dim] // n)
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return np.broadcast_to(idx.reshape(view), shape).copy()


def jax_owner_maps(spec_tree, value_tree, axis: str, n: int):
    """The JAX tree's owner map over ``axis`` per leaf, from its specs."""
    def leaf(sharding, x):
        spec = tuple(sharding.spec) + (None,) * (np.ndim(x) - len(sharding.spec))
        dims = [i for i, s in enumerate(spec) if s == axis or (isinstance(s, tuple)
                                                               and axis in s)]
        return _owner(np.shape(x), dims[0] if dims else None, n)
    return jax.tree.map(leaf, spec_tree, value_tree)


def port_mesh(shape: dict) -> tpmesh.Mesh:
    full = {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1, **shape}
    return tpmesh.Mesh(shape=full, coords={a: 0 for a in full})


def check_placement(shape: dict) -> dict:
    """The port's placement of every leaf against the JAX spec on a mesh of
    ``shape``; returns the number of leaves sharded over each axis."""
    mc = mesh_model()
    cfg = _train_cfg(model=mc)
    params = _params(cfg)
    jm = jpmesh.make_mesh(MeshConfig(data=1, **shape),
                          devices=jax.devices()[:int(np.prod(list(shape.values())))])
    tp = jm.shape[jpmesh.TENSOR_AXIS] > 1
    specs = j_params_sharding(jm, params, tensor_parallel=tp)
    port = _to_port(params, cfg)
    placed = tsh.params_sharding(port_mesh(shape), port, tensor_parallel=tp,
                                 text_heads=mc.text_heads)
    if not tp:  # the FSDP rule alone on JAX shapes, against the JAX fsdp_spec
        for s in ((3, 3, 128, 128), (320, 1280), (1024, 2), (255, 257), (8, 8)):
            spec = tuple(jpmesh.fsdp_spec(jm, s))
            want = spec.index(jpmesh.FSDP_AXIS) if spec else None
            assert tpmesh.fsdp_spec(port_mesh(shape), s) == want, s
    conv = {"unet": lambda t: EX.unet_from_flax(t, len(mc.block_out_channels)),
            "vae": EX.vae_from_flax, "text": EX.text_from_flax}
    counts = {}
    for axis, n in shape.items():
        counts[axis] = 0
        owners = jax_owner_maps(specs, params, axis, n)
        for comp, to_port in conv.items():
            want = to_port(owners[comp])
            assert set(want) == set(placed[comp])
            for name, w in want.items():
                p = placed[comp][name]
                dim = p.fsdp if axis == "fsdp" else p.tensor
                got = _owner(tuple(port[comp][name].shape), dim, n)
                assert np.array_equal(got, w.numpy().astype(np.int64)), (axis, comp, name, p)
                counts[axis] += dim is not None
    return counts


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placement_equals_the_jax_spec_for_every_leaf(mesh):
    counts = check_placement(MESHES[mesh])
    assert all(n > 0 for n in counts.values()), counts


def test_jax_optimizer_state_and_ema_take_their_parameters_spec():
    """What lets the port give the Adam moments and the EMA their
    parameter's placement: on the JAX ``fsdp = 2 x tensor = 2`` mesh every
    state leaf's spec is that of the parameter at the same path."""
    cfg = _train_cfg(model=mesh_model(), ema_decay=0.9)
    jm = jpmesh.make_mesh(MeshConfig(data=1, fsdp=2, tensor=2), devices=jax.devices()[:4])
    models = build_modules(cfg, mesh=jm)
    p = jax.tree.map(lambda x: jax.numpy.array(np.asarray(x)), _params(cfg))
    state = JT.shard_train_state(JT.init_train_state(
        cfg, models, unet_params=p["unet"], text_params=p["text"], vae_params=p["vae"]), jm)
    want = {jax.tree_util.keystr(k): x.sharding.spec
            for k, x in jax.tree_util.tree_leaves_with_path(state.unet_params)}
    seen = 0
    for path, x in jax.tree_util.tree_leaves_with_path((state.opt_state, state.ema_params)):
        key = jax.tree_util.keystr(path)
        match = [w for w in want if key.endswith(w)]
        if match and np.ndim(x):
            assert x.sharding.spec == want[max(match, key=len)], key
            seen += 1
    assert seen >= 3 * len(want)  # mu, nu and the EMA of every leaf


def test_one_text_head_cuts_its_head_dim():
    """With one text head the JAX rule's tie goes to the head dim of the
    output kernel [1, hd, D], a contiguous chunk of the port's input
    features: the port cuts those."""
    p = tsh.placement("text", "x.self_attn.out_proj.weight", (24, 24), fsdp=2, tensor=1,
                      text_heads=1, min_fsdp_size=1)
    assert p == tsh.Placement(fsdp=1)


# ---------------------------------------------------------------------------
# the train step on fsdp = 2
# ---------------------------------------------------------------------------

# f32: two steps with the EMA, the text encoder trained and mixup across
# the fsdp ranks' rows; bf16: one step with remat (the gathers and their
# saved tensors' regathers inside a recomputed forward). Both with FSDP's
# threshold at 100 elements on the port's side, so nearly every leaf is
# sharded (the input conv, the 128-wide norms, the VAE's quant convs, the
# text encoder's position embedding, ...; the placement moves no number, so
# the JAX step on its own placement is the reference): under bf16 the
# models then read their compute dtype beside f32 shards
FSDP_RUNS = {"f32": (dict(ema_decay=0.9, train_text_encoder=True, mixup_noise_lam=0.3), 2),
             "bf16": (dict(mixed_precision="bf16", remat=True), 1)}
EVERY_LEAF = {"f32": {"min_fsdp_size": 100}, "bf16": {"min_fsdp_size": 100}}


def _fsdp_cfg(name):
    cfg = _train_cfg(model=mesh_model(), **FSDP_RUNS[name][0])
    cfg.mesh = MeshConfig(data=1, fsdp=2)
    return cfg


@pytest.fixture(scope="module")
def fsdp2(tmp_path_factory):
    runs = {name: (_fsdp_cfg(name), steps) for name, (_, steps) in FSDP_RUNS.items()}
    return runs, run_steps(tmp_path_factory.mktemp("fsdp2"), runs, 2, EVERY_LEAF)


@pytest.mark.parametrize("name", list(FSDP_RUNS))
def test_fsdp_step_matches_jax_on_an_fsdp2_mesh(fsdp2, name):
    """Two ranks, two rows each (the batch splits over fsdp), each holding
    half of every FSDP leaf, its Adam moments and its EMA; the weights
    gathered per module, the gradients reduce-scattered."""
    runs, results = fsdp2
    cfg, steps = runs[name]
    jstate, jhist, ranks = results[name]
    assert_step_matches(jstate, jhist, ranks, cfg, steps)
    shapes, whole = ranks[0]["shapes"], ranks[0]["unet"]
    halved = [k for k in shapes if shapes[k] != tuple(whole[k].shape)]
    assert "down_blocks.1.resnets.0.conv2.weight" in halved and len(halved) >= 8
    if name in EVERY_LEAF:
        assert {"conv_in.weight", "mid_block.resnets.0.norm1.weight",
                "mid_block.attentions.0.transformer_blocks.0.norm1.weight"} <= set(halved)
    assert all(ranks[0]["mu_shapes"][f"unet/{k}"] == v for k, v in shapes.items())
    if cfg.ema_decay > 0:
        assert ranks[0]["ema_shapes"] == shapes
    ex = ranks[0]["exchanges"]
    assert ex["fsdp_gather"]["calls"] > 0 and ex["fsdp_reduce_scatter"]["calls"] > 0
    # the regathers of the backward: each sharded module's weight again
    assert ex["fsdp_regather"]["calls"] > 0
    if cfg.train_text_encoder:
        want = EX.text_from_flax(jstate.text_params)
        diffs = torch.cat([(want[k] - ranks[0]["text"][k]).abs().flatten() for k in want])
        assert diffs.max() <= 1e-2 * 1e-3 * steps


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_a_checkpoint_saved_under_fsdp2_restores_in_one_process_and_in_jax(tmp_path):
    """Two ranks train a step on fsdp = 2 and save (the shards gathered, the
    primary writing): one process of the port restores the state bit for
    bit, and the JAX package loads the HF-layout export bit for bit."""
    from dcr_tpu.sampling.pipeline import load_checkpoint_models as j_load
    from dcr_tpu_torch.core.checkpoint import CheckpointManager
    from dcr_tpu_torch.diffusion import train as TT
    from dcr_tpu_torch.sampling.pipeline import build_models

    cfg = _fsdp_cfg("f32")
    params = _params(cfg)
    torch.save(_to_port(params, cfg), tmp_path / "params.pt")
    args = {"cfg": dataclasses.asdict(TC.from_dict(TC.TrainConfig, dataclasses.asdict(cfg)))}
    args["cfg"].update(train_text_encoder=False, mixup_noise_lam=0.0)
    check(spawn("fsdp_checkpoint", 2, tmp_path, args))
    saved = [torch.load(tmp_path / f"whole_{r}.pt") for r in (0, 1)]
    tcfg = TC.from_dict(TC.TrainConfig, args["cfg"])
    tcfg.mesh = TC.MeshConfig(data=1)
    models = build_models(tcfg.model, "cpu")
    port = _to_port(params, cfg)
    state = TT.init_train_state(tcfg, models, unet_params=port["unet"],
                                text_params=port["text"], vae_params=port["vae"])
    step = CheckpointManager(tmp_path / "ckpt").restore(state)
    assert step == 1 and state.opt_state.count == 1
    for group, tensors in (("unet", state.unet_params), ("ema", state.ema_params),
                           ("mu", state.opt_state.mu)):
        assert set(tensors) == set(saved[0][group])
        for k, t in tensors.items():
            assert torch.equal(t.detach(), saved[0][group][k]), (group, k)
            assert torch.equal(saved[1][group][k], saved[0][group][k])
    _, jparams, _ = j_load(tmp_path / "export")
    want = EX.unet_from_flax(jparams["unet"], len(cfg.model.block_out_channels))
    for k, t in want.items():
        assert torch.equal(t, saved[0]["ema"][k]), k
    assert torch.equal(EX.text_from_flax(jparams["text"])[
        "text_model.embeddings.token_embedding.weight"],
        port["text"]["text_model.embeddings.token_embedding.weight"])


# ---------------------------------------------------------------------------
# dcr-train-torch on a sharded mesh
# ---------------------------------------------------------------------------

def test_the_trainer_saves_rolls_back_and_exports_a_sharded_state(tmp_path):
    """Two ranks of ``dcr-train-torch`` on ``fsdp = 2`` with a NaN on rank
    1 at step 3: both roll back to step 2 (the checkpoint's whole tensors
    cut into each rank's shards), finish, and export whole tensors that one
    process loads into the unsharded modules."""
    import dataclasses as dc
    import json

    from dcr_tpu_torch.sampling.pipeline import load_checkpoint_models
    from tests._torch_ranks import Ranks, rank_env
    from tests.test_torch_trainer import _cfg, _data

    _data(tmp_path / "data", n=8)
    cfg = _cfg(tmp_path)
    cfg.model = TC.ModelConfig(**dc.asdict(mesh_model()))
    cfg.train_batch_size = 2
    cfg.mesh = TC.MeshConfig(data=1, fsdp=2)
    TC.save_config(cfg, tmp_path / "cfg.json")
    argv = [f"--config={tmp_path / 'cfg.json'}", "--max_train_steps=4", "--modelsavesteps=2",
            "--fault.max_rollbacks=1"]
    outputs = Ranks("train_cli", 2, tmp_path / "ranks", {"argv": argv},
                    env=rank_env(DCR_FAULTS="nan_loss@step=3@rank=1")).wait(timeout=300)
    check(outputs)
    run = tmp_path / "run"
    for rank in (0, 1):
        name = "quarantine.jsonl" if rank == 0 else f"quarantine.p{rank}.jsonl"
        recs = [json.loads(x) for x in (run / name).read_text().splitlines()]
        assert [(r["at_step"], r["restored_step"]) for r in recs
                if r["kind"] == "nan_rollback"] == [(3, 2)]
    saved = torch.load(run / "checkpoints" / "4" / "state.pt", weights_only=True)
    models, params, _ = load_checkpoint_models(run / "checkpoint", "cpu")
    for name, t in models.unet.named_parameters():
        assert tuple(saved["params"]["unet"][name].shape) == tuple(t.shape)
        assert torch.equal(params["unet"][name], saved["params"]["unet"][name])
    assert tuple(saved["opt"]["mu"]["unet/down_blocks.1.resnets.0.conv2.weight"].shape) == (
        128, 128, 3, 3)
