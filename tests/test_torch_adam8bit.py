"""PyTorch port: blockwise 8-bit AdamW (``dcr_tpu_torch/core/adam8bit.py``
and ``optim.use_8bit_adam`` in ``diffusion/train.Optimizer``) against the
JAX package's ``dcr_tpu/core/adam8bit.py``.

- The cases of ``tests/test_adam8bit.py``, held for the port: the linear
  round-trip bound, the log code's relative error, exact zeros, the spike
  block, the state's dtypes and size, tracking exact AdamW.
- Codes and scales against the JAX quantizers on the same inputs: equal at
  every element (0 differences expected and counted).
- Three updates through the port's ``Optimizer`` against
  ``optax.chain(clip_by_global_norm, adamw8bit)`` on the same grads, at the
  f32 bar (atol 2e-4, rtol 1e-3); the codes after them equal the JAX codes
  wherever the dequantized moments agree to a code step.
- The Trainer with ``optim.use_8bit_adam``: a run saved and resumed equals
  the straight run bit for bit (fused, with gradient accumulation, and
  pipelined), a NaN rollback restores the 8-bit state, and a checkpoint of
  the other setting is refused with an error that names it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dcr_tpu.core import adam8bit as J8  # noqa: E402
from dcr_tpu_torch.core import adam8bit as A8  # noqa: E402
from dcr_tpu_torch.core import checkpoint as CK  # noqa: E402
from dcr_tpu_torch.core import config as TC  # noqa: E402
from dcr_tpu_torch.core import resilience as R  # noqa: E402
from dcr_tpu_torch.diffusion import train as T  # noqa: E402
from dcr_tpu_torch.diffusion.trainer import Trainer  # noqa: E402
from dcr_tpu_torch.utils import faults  # noqa: E402
from tests.test_torch_trainer import _cfg, _data  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tiny models run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DCR_FAULTS", raising=False)
    faults.clear()
    R.reset_counters()
    yield
    faults.clear()


# ---------------------------------------------------------------------------
# the quantizers: tests/test_adam8bit.py's cases, and the JAX codes
# ---------------------------------------------------------------------------

def test_linear_roundtrip_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000)
                         .astype(np.float32)) * 3.0
    t = A8.quantize_linear(x)
    assert t.q.dtype == torch.int8 and t.q.shape == (40, A8.BLOCK)
    back = A8.dequantize_linear(t, x.shape, x.numel())
    # symmetric int8: error <= half a step of the block's absmax
    blocks = np.pad(x.numpy(), (0, (-x.numel()) % A8.BLOCK)).reshape(-1, A8.BLOCK)
    bound = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
    err = np.abs(back.numpy() - x.numpy())
    assert (err <= np.repeat(bound, A8.BLOCK, 1).reshape(-1)[:x.numel()] + 1e-7).all()


def test_log_roundtrip_relative_error_and_exact_zeros():
    mags = np.random.default_rng(1).uniform(-6, 0, 10_000).astype(np.float32)
    x = torch.from_numpy(10.0 ** mags)
    t = A8.quantize_log(x)
    assert t.q.dtype == torch.uint8
    back = A8.dequantize_log(t, x.shape, x.numel()).numpy()
    rel = np.abs(back - x.numpy()) / x.numpy()
    assert np.median(rel) < 0.02 and rel.max() < 0.04
    z = A8.quantize_log(torch.zeros(512))
    assert float(A8.dequantize_log(z, (512,), 512).max()) == 0.0
    # a tiny nonzero value under a spike clamps to code 1, never to zero
    spike = torch.zeros(A8.BLOCK)
    spike[0], spike[1] = 1e6, 1e-9
    q = A8.quantize_log(spike).q.reshape(-1)
    assert int(q[1]) == 1 and int(q[2]) == 0


def _inputs():
    rng = np.random.default_rng(2)
    return {"normal": rng.standard_normal(10_000).astype(np.float32) * 3.0,
            "nine_decades": (10.0 ** rng.uniform(-9, 0, 5_000)).astype(np.float32),
            "spike_and_zeros": np.r_[1e3, 1e-2, np.zeros(254),
                                     rng.standard_normal(300) ** 2].astype(np.float32),
            "odd_size": rng.standard_normal(4099).astype(np.float32) * 1e-4}


@pytest.mark.parametrize("kind", ["linear", "log"])
@pytest.mark.parametrize("name", sorted(_inputs()))
def test_codes_and_scales_equal_the_jax_quantizers(kind, name):
    x = _inputs()[name]
    if kind == "log":
        x = np.abs(x)
    jt = getattr(J8, f"quantize_{kind}")(jnp.asarray(x))
    pt = getattr(A8, f"quantize_{kind}")(torch.from_numpy(x))
    assert pt.q.shape == jt.q.shape and pt.scale.shape == jt.scale.shape
    assert str(pt.q.dtype).split(".")[-1] == str(jt.q.dtype)
    # every element: 0 differing codes, 0 differing scales
    assert int((np.asarray(jt.q) != pt.q.numpy()).sum()) == 0
    assert int((np.asarray(jt.scale) != pt.scale.numpy()).sum()) == 0
    jback = getattr(J8, f"dequantize_{kind}")(jt, x.shape, x.size)
    pback = getattr(A8, f"dequantize_{kind}")(pt, x.shape, x.size)
    np.testing.assert_array_equal(pback.numpy(), np.asarray(jback))


def test_spike_block_zero_grad_does_not_diverge():
    """One coordinate's v dwarfed by a spike elsewhere in its block, then a
    zero gradient: the update stays within 10x of exact Adam's."""
    c1, c2 = A8.bias_corrections(0.9, 0.999, 1)
    m = A8.zeros(A8.BLOCK, torch.int8, "cpu")
    v = A8.zeros(A8.BLOCK, torch.uint8, "cpu")
    g1 = torch.zeros(A8.BLOCK)
    g1[0], g1[1] = 1e3, 1e-2
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    _, m, v = A8.update_leaf(g1, m, v, c1=c1, c2=c2, **kw)
    c1, c2 = A8.bias_corrections(0.9, 0.999, 2)
    u8, _, _ = A8.update_leaf(torch.zeros(A8.BLOCK), m, v, c1=c1, c2=c2, **kw)
    ref = optax.scale_by_adam()
    s = ref.init(jnp.zeros(A8.BLOCK))
    _, s = ref.update(jnp.asarray(g1.numpy()), s)
    uref, _ = ref.update(jnp.zeros(A8.BLOCK), s)
    assert abs(float(u8[1])) < 10 * abs(float(uref[1])) + 1e-3, float(u8[1])


def test_state_is_8bit_and_small():
    """The Optimizer's 8-bit state: int8 m and uint8 v codes [n_blocks, 256]
    and f32 scales [n_blocks, 1] for each tensor of at least 4,096
    elements; f32 moments for the rest; bytes by the formula exactly."""
    params = {"w": torch.randn(128, 128), "odd": torch.randn(4097), "b": torch.zeros(16)}
    opt = T.Optimizer(TC.OptimConfig(use_8bit_adam=True)).init({"unet": params})
    assert set(opt.mu) == set(opt.nu) == {"unet/b"}
    assert opt.m8["unet/w/q"].dtype == torch.int8 and opt.v8["unet/w/q"].dtype == torch.uint8
    assert opt.m8["unet/odd/q"].shape == (17, 256) and opt.m8["unet/odd/scale"].shape == (17, 1)
    assert opt.v8["unet/w/scale"].dtype == torch.float32
    state_bytes = sum(t.numel() * t.element_size()
                      for d in (opt.m8, opt.v8) for t in d.values())
    assert state_bytes == A8.state_bytes(128 * 128) + A8.state_bytes(4097)
    assert state_bytes < 0.3 * 2 * 4 * (128 * 128 + 4097)     # vs two f32 moments


def test_tracks_exact_adamw_on_quadratic():
    """200 steps of least squares: the 8-bit trajectory reaches within 2x of
    exact AdamW's final loss, and both crush the start."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32) / 64)
    y = torch.from_numpy(rng.standard_normal(64).astype(np.float32))

    def loss(w):
        return torch.mean((A @ w - y) ** 2)

    def run(use_8bit: bool) -> float:
        cfg = TC.OptimConfig(use_8bit_adam=use_8bit, learning_rate=1e-2,
                             lr_scheduler="constant", lr_warmup_steps=0,
                             adam_weight_decay=0.0, max_grad_norm=1e9)
        tx = T.Optimizer(cfg)
        w = torch.zeros(4096, requires_grad=True)
        state = tx.init({"unet": {"w": w}})
        for _ in range(200):
            (g,) = torch.autograd.grad(loss(w), [w])
            tx.update({"unet/w": g}, state, {"unet": {"w": w}})
        return float(loss(w).detach())

    l8, lref, l0 = run(True), run(False), float(loss(torch.zeros(4096)))
    assert l8 < 0.1 * l0
    assert l8 < max(2.0 * lref, lref + 1e-4)


# ---------------------------------------------------------------------------
# the Optimizer against optax.chain(clip_by_global_norm, adamw8bit)
# ---------------------------------------------------------------------------

def test_three_updates_match_optax_adamw8bit():
    rng = np.random.default_rng(4)
    shapes = {"conv": (64, 32, 3, 3), "odd": (4099,), "bias": (64,)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    cfg = TC.OptimConfig(use_8bit_adam=True, learning_rate=1e-3, lr_scheduler="constant",
                         lr_warmup_steps=0, max_grad_norm=1.0, adam_weight_decay=1e-2)
    tx = T.Optimizer(cfg)
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init({"unet": ours})
    jtx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                      J8.adamw8bit(cfg.learning_rate, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                                   eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jtx.init(jp)
    for i in range(3):
        # the first step's norm clips (scale 3), the later ones do not
        grads = {k: rng.standard_normal(s).astype(np.float32) * (3.0 if i == 0 else 0.01)
                 for k, s in shapes.items()}
        tx.update({f"unet/{k}": torch.from_numpy(g) for k, g in grads.items()}, state,
                  {"unet": ours})
        upd, js = jtx.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k in shapes:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(jp[k]), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{k} after update {i + 1}")
    moments = js[1][0].moments
    for k in ("conv", "odd"):
        for ours_q, theirs in ((state.m8, moments[k].m), (state.v8, moments[k].v)):
            # the moments differ only by f32 rounding: their codes agree to
            # one step wherever they are not equal
            diff = np.abs(ours_q[f"unet/{k}/q"].numpy().astype(np.int32)
                          - np.asarray(theirs.q).astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.99, (k, diff.max())
            np.testing.assert_allclose(ours_q[f"unet/{k}/scale"].numpy(),
                                       np.asarray(theirs.scale), rtol=1e-5)
    np.testing.assert_allclose(state.mu["unet/bias"].numpy(),
                               np.asarray(moments["bias"]["m"]), atol=1e-6, rtol=1e-5)
    assert state.count == int(js[1][0].count) == 3


# ---------------------------------------------------------------------------
# the Trainer with optim.use_8bit_adam
# ---------------------------------------------------------------------------

def _cfg8(tmp_path, out, **optim):
    cfg = _cfg(tmp_path, out=out)
    cfg.optim = TC.OptimConfig(learning_rate=1e-3, lr_scheduler="constant",
                               lr_warmup_steps=0, use_8bit_adam=True, **optim)
    return cfg


def _assert_same(a: T.TrainState, b: T.TrainState) -> None:
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for name in ("unet_params", "ema_params"):
        for k, p in (getattr(a, name) or {}).items():
            assert torch.equal(p, getattr(b, name)[k]), (name, k)
    for group in ("mu", "nu", "m8", "v8"):
        got, want = getattr(a.opt_state, group), getattr(b.opt_state, group)
        assert set(got) == set(want), group
        for k, t in got.items():
            assert torch.equal(t, want[k]), (group, k)


@pytest.mark.parametrize("mode", ["fused", "accumulate", "pipelined"])
def test_8bit_adam_trains_and_resumes_bit_for_bit(tmp_path, mode):
    """``--optim.use_8bit_adam=true`` trains (the setting the port refused
    before), holds 8-bit codes for the large tensors, and a run stopped
    after one optimizer step and resumed equals the straight run bit for
    bit: fused, with gradient accumulation (2 micro-steps) and pipelined."""
    _data(tmp_path / "data")
    argv = ["--optim.use_8bit_adam=true", "--max_train_steps=2", "--ema_decay=0.99"]
    if mode == "pipelined":
        argv.append("--pipe.enabled=true")
    if mode == "accumulate":
        argv.append("--optim.gradient_accumulation_steps=2")
    straight_cfg = TC.parse_cli(TC.TrainConfig, argv, base=_cfg(tmp_path, out="straight"))
    straight = Trainer(straight_cfg, device="cpu")
    assert straight.pipelined == (mode == "pipelined")
    metrics = straight.train()
    assert np.isfinite(metrics["loss"])
    opt = straight.state.opt_state
    assert opt.m8 and all(t.dtype == torch.int8 for k, t in opt.m8.items() if k.endswith("/q"))
    assert all(t.dtype == torch.uint8 for k, t in opt.v8.items() if k.endswith("/q"))
    assert all(p.numel() < A8.MIN_QUANTIZE_SIZE for k, p in straight.state.unet_params.items()
               if f"unet/{k}" in opt.mu)
    first_cfg = TC.parse_cli(TC.TrainConfig, argv, base=_cfg(tmp_path, out="resumed"))
    first_cfg.max_train_steps, first_cfg.modelsavesteps = 1, 1
    Trainer(first_cfg, device="cpu").train()
    second = Trainer(TC.parse_cli(TC.TrainConfig, argv, base=_cfg(tmp_path, out="resumed")),
                     device="cpu")
    second.train()
    _assert_same(second.state, straight.state)


def test_nan_rollback_restores_the_8bit_state(tmp_path):
    """A NaN at step 3 rolls back to the step-2 checkpoint: the rolled run
    equals a run resumed from that checkpoint with its step set to 3,
    8-bit codes and scales included."""
    _data(tmp_path / "data")
    cfg = _cfg8(tmp_path, "roll")
    cfg.modelsavesteps, cfg.max_train_steps = 2, 4
    cfg.fault = TC.FaultToleranceConfig(max_rollbacks=1)
    faults.install("nan_loss@step=3")
    rolled = Trainer(cfg, device="cpu")
    rolled.train()
    ref_cfg = _cfg8(tmp_path, "ref")
    ref_cfg.modelsavesteps, ref_cfg.max_train_steps = 2, 4
    saved = torch.load(tmp_path / "roll" / "checkpoints" / "2" / CK.STATE_FILE,
                       weights_only=True)
    assert saved["opt"]["m8"] and saved["opt"]["v8"]
    saved["step"] = 3
    (tmp_path / "ref" / "checkpoints" / "3").mkdir(parents=True)
    torch.save(saved, tmp_path / "ref" / "checkpoints" / "3" / CK.STATE_FILE)
    ref = Trainer(ref_cfg, device="cpu")
    ref.train()
    _assert_same(rolled.state, ref.state)


@pytest.mark.parametrize("first,then", [(False, True), (True, False)])
def test_resume_across_the_other_setting_is_refused(tmp_path, first, then):
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, out="run")
    cfg.max_train_steps, cfg.modelsavesteps = 1, 1
    cfg.optim.use_8bit_adam = first
    Trainer(cfg, device="cpu").train()
    cfg.optim.use_8bit_adam, cfg.max_train_steps = then, 2
    trainer = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match=f"optim.use_8bit_adam={first}.*"
                                         f"optim.use_8bit_adam={then}"):
        trainer.train()
