"""PyTorch port: flash-attention backward (plain version) and the autograd
Function against the JAX package.

On the CPU the port's wrappers take their plain versions; the JAX side runs
the Pallas backward kernels in interpret mode, as
tests/test_flash_attention.py does. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py.

Tolerances are the JAX repo's own: f32 at 1e-4 (2e-4 for rectangular shapes
and x100 logits), bf16 at 0.15 (dq) / 0.1 (dk, dv) against an f32 reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcr_tpu.ops import flash_attention as FA
from dcr_tpu_torch.ops import attention as TA
from dcr_tpu_torch.ops import flash_attention as TFA

SHAPES = [
    pytest.param(dict(b=2, sq=256, sk=256, h=2, d=64), 1e-4, id="square"),
    pytest.param(dict(b=1, sq=384, sk=128, h=2, d=64), 2e-4, id="sq_gt_sk"),
    pytest.param(dict(b=1, sq=128, sk=384, h=2, d=64), 2e-4, id="sk_gt_sq"),
    pytest.param(dict(b=1, sq=128, sk=256, h=1, d=128), 2e-4, id="d128"),
    pytest.param(dict(b=1, sq=128, sk=128, h=1, d=256), 1e-4, id="d256"),
]


def _inputs(seed, b, sq, sk, h, d, scale_q=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32) * scale_q
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_bwd(q, k, v, do):
    """(dq, dk, dv, o, lse) from the Pallas forward and backward kernels,
    interpreted; lse lane-broadcast to 128 as the kernels take it."""
    q3, k3, v3, do3 = (FA._to3(jnp.asarray(x)) for x in (q, k, v, do))
    o3, lse = FA._flash_fwd(q3, k3, v3, interpret=True)
    dq3, dk3, dv3 = FA._flash_bwd(q3, k3, v3, o3, lse, do3, interpret=True)
    b, h = q.shape[0], q.shape[2]
    out = [np.array(FA._from3(x, b, h)) for x in (dq3, dk3, dv3, o3)]
    return (*out, np.array(lse[:, :, 0]))


@pytest.mark.parametrize("shape,tol", SHAPES)
def test_plain_bwd_matches_jax_interpret(shape, tol):
    q, k, v, do = _inputs(11, **shape)
    jdq, jdk, jdv, jo, jlse = _jax_bwd(q, k, v, do)
    # the same residuals the JAX backward saw: its o and compact lse
    tq, tk, tv, tdo, to = (torch.from_numpy(x) for x in (q, k, v, do, jo))
    dq, dk, dv = TFA.flash_attention_bwd_reference(tq, tk, tv, to, torch.from_numpy(jlse),
                                                   tdo)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_plain_bwd_large_logits():
    """x100 logits: P is near one-hot; the JAX repo's bound is 2e-4."""
    shape = dict(b=1, sq=256, sk=128, h=1, d=64)
    q, k, v, do = _inputs(12, **shape, scale_q=100.0)
    jdq, jdk, jdv, jo, jlse = _jax_bwd(q, k, v, do)
    tq, tk, tv, tdo, to = (torch.from_numpy(x) for x in (q, k, v, do, jo))
    grads = TFA.flash_attention_bwd_reference(tq, tk, tv, to, torch.from_numpy(jlse), tdo)
    for got, want in zip(grads, (jdq, jdk, jdv)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


BF16_CASES = [
    pytest.param(dict(b=2, sq=256, sk=256, h=2, d=64), 1.0, id="square"),
    pytest.param(dict(b=1, sq=384, sk=128, h=2, d=64), 1.0, id="sq_gt_sk"),
    pytest.param(dict(b=1, sq=256, sk=256, h=1, d=128), 1.0, id="d128"),
    pytest.param(dict(b=2, sq=256, sk=256, h=2, d=64), 10.0, id="logits_x10"),
    # the training path's level-0 length, which the bf16 dQ kernel loops over
    pytest.param(dict(b=1, sq=1024, sk=1024, h=1, d=64), 1.0, id="train_level0"),
]


@pytest.mark.parametrize("shape,scale_q", BF16_CASES)
def test_plain_bwd_bf16_matches_jax_interpret(shape, scale_q):
    """bf16 operands: the plain version rounds P to bf16 before dV and dS
    before dQ and dK, as the Pallas kernels do; each gradient within
    2^-9 max(1, max|ref|) of the kernels run through their interpreter in
    bf16, from the same residuals (the Pallas o and lse). A plain version
    that does not round where the kernels round lands at 3e-3 to 6e-3 of
    max|ref| on these cases, outside that bound."""
    q, k, v, do = _inputs(31, **shape, scale_q=scale_q)
    b, h = shape["b"], shape["h"]
    q3, k3, v3, do3 = (FA._to3(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v, do))
    o3, lse = FA._flash_fwd(q3, k3, v3, interpret=True)
    grads3 = FA._flash_bwd(q3, k3, v3, o3, lse, do3, interpret=True)
    want = [np.asarray(FA._from3(x, b, h).astype(jnp.float32)) for x in grads3]
    jo = np.array(FA._from3(o3, b, h).astype(jnp.float32))
    tq, tk, tv, tdo, to = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do, jo))
    got = TFA.flash_attention_bwd_reference(tq, tk, tv, to,
                                            torch.from_numpy(np.array(lse[:, :, 0])), tdo)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert np.abs(g.float().numpy() - w).max() <= 2.0 ** -9 * max(1.0, np.abs(w).max())


def _jax_grads(q, k, v, do):
    def f(q, k, v):
        return jnp.sum(FA.flash_attention(q, k, v, True) * jnp.asarray(do))
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("shape,tol", SHAPES)
def test_autograd_grads_match_jax_grad(shape, tol):
    """Gradients through the port's flash_attention (the autograd Function,
    plain path on the CPU) against jax.grad through the custom_vjp."""
    q, k, v, do = _inputs(13, **shape)
    want = _jax_grads(q, k, v, do)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TFA.flash_attention(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=tol, rtol=tol)


def test_autograd_grads_large_logits():
    shape = dict(b=1, sq=128, sk=256, h=2, d=64)
    q, k, v, do = _inputs(14, **shape, scale_q=100.0)
    want = _jax_grads(q, k, v, do)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    TFA.flash_attention(tq, tk, tv).backward(torch.from_numpy(do))
    # each side recomputes from its own forward here, so lse (~1e3) differs by
    # f32 rounding; dk = D^-1/2 dS^T q carries q's x100 factor and is held at
    # the same 2e-4 bound once that factor is divided out
    for t, w, unit in zip((tq, tk, tv), want, (1.0, 100.0, 1.0)):
        np.testing.assert_allclose(t.grad.numpy() / unit, w / unit, atol=2e-4, rtol=2e-4)


def test_autograd_bf16_close_to_f32_jax():
    """bf16 inputs through the Function: gradients in bf16 within the JAX
    repo's bf16 bounds (0.15 for dq, 0.1 for dk/dv) of the f32 jax.grad."""
    shape = dict(b=2, sq=256, sk=128, h=2, d=64)
    q, k, v, do = _inputs(15, **shape)
    want = _jax_grads(q, k, v, do)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    TFA.flash_attention(tq, tk, tv).backward(torch.from_numpy(do).to(torch.bfloat16))
    for t, w, tol in zip((tq, tk, tv), want, (0.15, 0.1, 0.1)):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), w, atol=tol, rtol=tol)


def test_dispatcher_gradient_goes_through_the_function():
    """A kernel-shaped attention under autograd reaches the Function's
    backward; on the CPU the kernel counters stay put."""
    q, k, v, do = _inputs(16, b=1, sq=128, sk=128, h=2, d=64)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (TFA.flash_attention_fwd.launches, TFA.flash_attention_bwd.dq_launches,
              TFA.flash_attention_bwd.dkv_launches)
    out = TA.dot_product_attention(tq, tk, tv)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    want = _jax_grads(q, k, v, do)
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-4, rtol=1e-4)
    assert before == (TFA.flash_attention_fwd.launches, TFA.flash_attention_bwd.dq_launches,
                      TFA.flash_attention_bwd.dkv_launches)


def test_bwd_wrapper_rejects_mixed_devices():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(17, b=1, sq=128, sk=128, h=1, d=64))
    o, lse = TFA.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(q, k, v, o, lse, do.to("meta"))
