"""PyTorch port: flash-attention forward (plain version) and dispatcher
against the JAX package.

On the CPU the port's wrapper takes its plain version; the JAX side runs the
Pallas kernel in interpret mode, as tests/test_flash_attention.py does. The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcr_tpu.ops import attention as A
from dcr_tpu.ops import flash_attention as FA
from dcr_tpu_torch.ops import attention as TA
from dcr_tpu_torch.ops import flash_attention as TFA


def _qkv(seed, b=2, sq=256, sk=256, h=2, d=64, scale_q=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32) * scale_q
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    return q, k, v


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("shape", [
    dict(b=2, sq=256, sk=256, h=2, d=64),
    dict(b=1, sq=384, sk=128, h=2, d=64),    # rectangular, Sq != Sk
    dict(b=1, sq=128, sk=256, h=1, d=128),
    dict(b=1, sq=128, sk=128, h=1, d=256),
])
def test_plain_flash_matches_jax_interpret(shape):
    """o at f32 atol/rtol 2e-5 and lse at 2e-5 against the Pallas kernel run
    through its interpreter (its lse is lane-broadcast; column 0 is the row's)."""
    q, k, v = _qkv(1, **shape)
    ref_o = np.asarray(FA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), True))
    _, ref_lse = FA._flash_fwd(FA._to3(jnp.asarray(q)), FA._to3(jnp.asarray(k)),
                               FA._to3(jnp.asarray(v)), interpret=True)
    o, lse = TFA.flash_attention_fwd(*_t(q, k, v))
    assert o.dtype == torch.float32 and lse.shape == (shape["b"] * shape["h"], shape["sq"])
    np.testing.assert_allclose(o.numpy(), ref_o, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, 0],
                               atol=2e-5, rtol=2e-5)


def test_plain_flash_large_logits():
    """x100 logits: online softmax must not overflow; the JAX repo's own bound
    for this case is 2e-4 (tests/test_flash_attention.py)."""
    q, k, v = _qkv(5, b=1, sq=256, sk=128, h=1, d=64, scale_q=100.0)
    ref = np.asarray(FA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    o, lse = TFA.flash_attention_fwd(*_t(q, k, v))
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), ref, atol=2e-4, rtol=2e-4)


def test_plain_flash_bf16_close_to_f32():
    """bf16 inputs: output in bf16 within 3e-2 of the f32 JAX result."""
    q, k, v = _qkv(3, b=2, sq=256, sk=128, h=2, d=64)
    ref = np.asarray(A.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), use_flash=False))
    o = TFA.flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), ref, atol=3e-2, rtol=3e-2)


def test_supported_agrees_with_jax_predicate():
    for sq in (64, 100, 128, 256, 4096):
        for sk in (77, 128, 1024):
            for d in (32, 48, 64, 128, 256, 512):
                for jdt, tdt in ((jnp.float32, torch.float32),
                                 (jnp.bfloat16, torch.bfloat16),
                                 (jnp.float16, torch.float16)):
                    jq = jax.ShapeDtypeStruct((1, sq, 2, d), jdt)
                    jk = jax.ShapeDtypeStruct((1, sk, 2, d), jdt)
                    tq = torch.empty((1, sq, 2, d), dtype=tdt, device="meta")
                    tk = torch.empty((1, sk, 2, d), dtype=tdt, device="meta")
                    assert TFA.supported(tq, tk, tk) == FA.supported(jq, jk, jk), (sq, sk, d, tdt)


@pytest.mark.parametrize("shape,use_flash", [
    (dict(b=2, sq=256, sk=256, h=2, d=64), True),    # kernel-shaped -> plain B1
    (dict(b=2, sq=256, sk=256, h=2, d=64), False),
    (dict(b=2, sq=64, sk=64, h=4, d=64), True),      # 8x8 mid block -> SDPA
    (dict(b=2, sq=256, sk=77, h=2, d=64), True),     # cross-attention -> SDPA
    (dict(b=1, sq=64, sk=64, h=1, d=512), False),    # VAE attention -> SDPA
])
def test_dispatcher_matches_jax(shape, use_flash):
    q, k, v = _qkv(7, **shape)
    ref = np.asarray(A.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), use_flash=False))
    before = TFA.flash_attention_fwd.launches
    out = TA.dot_product_attention(*_t(q, k, v), use_flash=use_flash)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    # on the CPU the plain version runs and the kernel's count stays put
    assert TFA.flash_attention_fwd.launches == before


def test_dispatcher_mask_matches_jax():
    q, k, v = _qkv(8, b=2, sq=16, sk=16, h=2, d=32)
    mask = np.tril(np.ones((16, 16), bool))[None, None]
    ref = np.asarray(A.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), mask=jnp.asarray(mask)))
    out = TA.dot_product_attention(*_t(q, k, v), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_wrapper_rejects_mixed_devices():
    q, k, v = _t(*_qkv(9, b=1, sq=128, sk=128, h=1, d=64))
    with pytest.raises(ValueError):
        TFA.flash_attention_fwd(q, k.to("meta"), v)
