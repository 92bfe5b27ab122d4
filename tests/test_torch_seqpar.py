"""PyTorch port: sequence parallelism (``ops/ring_attention``,
``ops/ulysses_attention``, the region boundary of ``parallel/mesh`` and the
UNet's dispatch), against the JAX package.

Ranks are gloo subprocesses on a FileStore (``tests/_torch_ranks.py``);
the JAX functions run here on conftest's 8 CPU devices, on a mesh of
``seq = n``. Attention forward and gradients at the f32 bar (atol 2e-4,
rtol 1e-3); the seq = 2 train step at the train tests' bars
(``tests/test_torch_dist.assert_step_matches``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcr_tpu.core.config import MeshConfig
from dcr_tpu.ops.ring_attention import ring_self_attention as j_ring
from dcr_tpu.ops.ulysses_attention import ulysses_self_attention as j_ulysses
from dcr_tpu.parallel import mesh as jpmesh
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.models import layers as TL
from dcr_tpu_torch.ops import ring_attention as RA
from dcr_tpu_torch.ops import ulysses_attention as UA
from dcr_tpu_torch.parallel import mesh as tpmesh
from tests._torch_ranks import Ranks, check
from tests.test_torch_dist import assert_step_matches, run_steps
from tests.test_torch_models import tiny_cfg
from tests.test_torch_train import _train_cfg

ATOL, RTOL = 2e-4, 1e-3
# name: (b, s, heads, d); "h3" has heads that 2 and 4 do not divide
INPUTS = {"h4": (2, 32, 4, 8), "h3": (2, 32, 3, 8)}


def _inputs(name: str) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = INPUTS[name]
    return {n: rng.standard_normal(shape).astype(np.float32) for n in "qkvg"}


def _jax_attention(kind: str, n: int, x: dict) -> dict:
    """The JAX function on a seq = n mesh: its output and the gradients of
    sum(out * g), in one jitted program."""
    mesh = jpmesh.make_mesh(MeshConfig(data=1, seq=n), devices=jax.devices()[:n])
    fn = (lambda q, k, v: j_ring(q, k, v, mesh)) if kind == "ring" else (
        lambda q, k, v: j_ulysses(q, k, v, mesh, use_flash=False))

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(g))

    got = run(*(jnp.asarray(x[c]) for c in "qkvg"))
    return {k: np.asarray(v) for k, v in zip(("out", "dq", "dk", "dv"), got)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The attention case over 2 and over 4 ranks, run at once."""
    runs = {}
    for n, names in ((2, ("h4", "h3")), (4, ("h4",))):
        tmp = tmp_path_factory.mktemp(f"seq{n}")
        for name in names:
            torch.save({k: torch.from_numpy(v) for k, v in _inputs(name).items()},
                       tmp / f"{name}.pt")
        runs[n] = (tmp, Ranks("attention", n, tmp, {"inputs": list(names)}))
    out = {}
    for n, (tmp, r) in runs.items():
        check(r.wait())
        out[n] = [torch.load(tmp / f"attention_{i}.pt") for i in range(n)]
    return out


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4])
def test_sequence_parallel_attention_matches_jax(ranks, kind, n):
    """The output and the gradients of sum(out * g) on every rank equal
    across ranks (the region's exit all-gathers, its entry's backward too)
    and within the f32 bar of the JAX shard_map on a seq = n mesh."""
    got = [r[("h4", kind)] for r in ranks[n]]
    want = _jax_attention(kind, n, _inputs("h4"))
    for key in ("out", "dq", "dk", "dv"):
        for r in got[1:]:
            assert torch.equal(r[key], got[0][key]), key
        np.testing.assert_allclose(got[0][key].numpy(), want[key], atol=ATOL, rtol=RTOL,
                                   err_msg=f"{kind} n={n} {key}")


def test_heads_that_do_not_divide(ranks):
    """Ulysses refuses 3 heads over 2 ranks, as the JAX function does; ring
    attention has no such limit and still matches."""
    for r in ranks[2]:
        assert "divisible by seq axis 2" in r[("h3", "ulysses")]["error"]
    with pytest.raises(ValueError, match="divisible by seq axis 2"):
        _jax_attention("ulysses", 2, _inputs("h3"))
    want = _jax_attention("ring", 2, _inputs("h3"))
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(ranks[2][0][("h3", "ring")][key].numpy(), want[key],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_one_rank_is_plain_attention(kind):
    """n = 1: no exchange; ring's single online-softmax block and Ulysses'
    plain attention match the JAX functions on a seq = 1 mesh."""
    mesh = tpmesh.make_mesh(TC.MeshConfig(data=1, seq=1))
    x = _inputs("h3")
    q, k, v = (torch.from_numpy(x[c]).requires_grad_(True) for c in "qkv")
    fn = RA.ring_self_attention if kind == "ring" else (
        lambda q, k, v, m: UA.ulysses_self_attention(q, k, v, m, use_flash=False))
    out = fn(q, k, v, mesh)
    grads = torch.autograd.grad((out * torch.from_numpy(x["g"])).sum(), (q, k, v))
    want = _jax_attention(kind, 1, x)
    for key, got in zip(("out", "dq", "dk", "dv"), (out.detach(), *grads)):
        np.testing.assert_allclose(got.numpy(), want[key], atol=ATOL, rtol=RTOL)


def _fake_mesh(seq: int, data: int = 1) -> tpmesh.Mesh:
    shape = {"data": data, "fsdp": 1, "tensor": 1, "seq": seq}
    return tpmesh.Mesh(shape=shape, coords={a: 0 for a in shape})


@pytest.mark.parametrize("mode,heads,sq,context,seq,want", [
    ("ulysses", 4, 64, False, 2, "ulysses"),
    ("ulysses", 3, 64, False, 2, "ring"),     # heads do not divide: ring
    ("ring", 4, 64, False, 2, "ring"),
    ("ulysses", 4, 64, True, 2, "plain"),     # cross-attention
    ("ulysses", 4, 16, False, 2, "plain"),    # below seq_parallel_min_seq
    ("ulysses", 4, 33, False, 2, "plain"),    # sq % n_seq
    ("ulysses", 4, 64, False, 1, "plain"),    # no seq axis
])
def test_cross_attention_dispatch_follows_the_jax_conditions(monkeypatch, mode, heads, sq,
                                                             context, seq, want):
    calls = []
    monkeypatch.setattr(RA, "ring_self_attention",
                        lambda q, k, v, m: calls.append("ring") or q)
    monkeypatch.setattr(UA, "ulysses_self_attention",
                        lambda q, k, v, m, use_flash: calls.append("ulysses") or q)
    attn = TL.CrossAttention(8 * heads, 8 * heads, heads, 8, use_flash=False,
                             mesh=_fake_mesh(seq, data=2), seq_parallel_min_seq=32,
                             seq_parallel_mode=mode)
    x = torch.randn(2, sq, 8 * heads)
    attn(x, torch.randn(2, 5, 8 * heads) if context else None)
    assert calls == ([] if want == "plain" else [want])


SEQ2_MODEL = dict(block_out_channels=(48, 64), seq_parallel_min_seq=16,
                  seq_parallel_mode="ulysses")
SEQ2_RUNS = {"f32": (dict(), 2), "bf16": (dict(mixed_precision="bf16"), 1)}


@pytest.fixture(scope="module")
def seq2(tmp_path_factory):
    runs = {}
    for name, (kw, steps) in SEQ2_RUNS.items():
        cfg = _train_cfg(model=tiny_cfg(**SEQ2_MODEL), **kw)
        cfg.mesh = MeshConfig(data=1, seq=2)
        runs[name] = (cfg, steps)
    return runs, run_steps(tmp_path_factory.mktemp("seq2"), runs, 2)


@pytest.mark.parametrize("name", list(SEQ2_RUNS))
def test_sequence_parallel_step_matches_jax_on_a_seq2_mesh(seq2, name):
    """Two seq ranks on one global batch of 4 against the JAX step on a
    seq = 2 mesh: the 8x8 level's 3 heads take ring attention, the 4x4 mid
    block's 4 heads Ulysses; the replicated layers' gradients neither scale
    by n nor miss a rank's slice, and both ranks end bit-equal."""
    runs, results = seq2
    cfg, steps = runs[name]
    jstate, jhist, ranks = results[name]
    assert_step_matches(jstate, jhist, ranks, cfg, steps)
    ex = ranks[0]["exchanges"]
    # per step: 3 ring layers x (k, v) x (forward, backward), 4 all_to_alls
    # each way for the Ulysses layer
    assert ex["ppermute"]["calls"] == 12 * steps
    assert ex["all_to_all"]["calls"] == 8 * steps
