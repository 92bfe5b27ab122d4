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


# bf16 operands, for the plain versions that round where the kernels round
BF16_CASES = [
    pytest.param(dict(b=2, sq=256, sk=256, h=2, d=64), 1.0, id="square"),
    pytest.param(dict(b=1, sq=384, sk=128, h=2, d=64), 1.0, id="sq_gt_sk"),
    pytest.param(dict(b=1, sq=256, sk=256, h=1, d=128), 1.0, id="d128"),
    pytest.param(dict(b=2, sq=256, sk=256, h=2, d=64), 10.0, id="logits_x10"),
]


def bf16_bound(ref: np.ndarray) -> float:
    """Max-abs bound of a bf16 plain version against the Pallas kernel in
    bf16: 2^-9 max(1, max|ref|). A plain version that does not round where
    the kernels round lands at 3e-3 to 6e-3 of max|ref| on these cases, outside it."""
    return 2.0 ** -9 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("shape,scale_q", BF16_CASES)
def test_plain_flash_bf16_matches_jax_interpret(shape, scale_q):
    """bf16 operands: the plain version rounds P to bf16 before P v and
    divides by the unrounded row sum, as the Pallas kernel does
    (p.astype(in_dtype)); o within bf16_bound of the kernel run through its
    interpreter in bf16, lse at 1e-4."""
    q, k, v = _qkv(21, **shape, scale_q=scale_q)
    jq, jk, jv = (FA._to3(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v))
    ref_o, ref_lse = FA._flash_fwd(jq, jk, jv, interpret=True)
    ref_o = np.asarray(FA._from3(ref_o, shape["b"], shape["h"]).astype(jnp.float32))
    o, lse = TFA.flash_attention_fwd(*_t(q, k, v, dtype=torch.bfloat16))
    assert o.dtype == torch.bfloat16
    assert np.abs(o.float().numpy() - ref_o).max() <= bf16_bound(ref_o)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, 0], atol=1e-4, rtol=1e-5)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero: cvt.rna.tf32.f32 on the bits of an int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 forward kernel takes it on the tensor cores: each
    operand split into hi = tf32(x), lo = tf32(x - hi), and the product
    hi*hi' + hi*lo' + lo*hi' with f32 sums (each TF32 product is exact in
    f32); lo*lo' dropped."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _attention_3xtf32(q, k, v):
    """(o, lse) over [B, S, H, D] f32 with both products in split TF32,
    softmax statistics in f32."""
    qh, kh, vh = (torch.from_numpy(x).permute(0, 2, 1, 3) for x in (q, k, v))
    s = _matmul_3xtf32(qh, kh.transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _matmul_3xtf32(p, vh) / l
    return o.permute(0, 2, 1, 3).numpy(), (m + torch.log(l))[..., 0].numpy()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                         -(1.0 + 2.0 ** -10), 3.0], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    hi = _tf32(y)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))
    assert ((y - hi).abs() <= y.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("shape,scale_q,tol", [
    pytest.param(dict(b=1, sq=1024, sk=1024, h=2, d=64), 1.0, 2e-5, id="s1024_d64"),
    pytest.param(dict(b=1, sq=256, sk=256, h=1, d=128), 1.0, 2e-5, id="s256_d128"),
    pytest.param(dict(b=1, sq=256, sk=256, h=1, d=64), 100.0, 2e-4, id="logits_x100"),
])
def test_split_tf32_arithmetic_meets_the_f32_bound(shape, scale_q, tol):
    """The f32 forward kernel's arithmetic (3xTF32 products, f32 softmax)
    emulated here against the Pallas kernel in f32 through its interpreter:
    o within the sampling path's bound (2e-5; 2e-4 at x100 logits, the JAX
    repo's), lse within 1e-4. One TF32 product alone misses it."""
    q, k, v = _qkv(41, **shape, scale_q=scale_q)
    ref_o, ref_lse = FA._flash_fwd(*(FA._to3(jnp.asarray(x)) for x in (q, k, v)),
                                   interpret=True)
    ref_o = np.asarray(FA._from3(ref_o, shape["b"], shape["h"]))
    ref_lse = np.asarray(ref_lse)[:, :, 0].reshape(shape["b"], shape["h"], shape["sq"])
    o, lse = _attention_3xtf32(q, k, v)
    np.testing.assert_allclose(o, ref_o, atol=tol, rtol=tol)
    np.testing.assert_allclose(lse, ref_lse, atol=1e-4, rtol=1e-5)
    if scale_q == 1.0:
        # the same with one TF32 product per product: outside the bound
        qh, kh, vh = (_tf32(torch.from_numpy(x).permute(0, 2, 1, 3)) for x in (q, k, v))
        s = qh @ kh.transpose(-1, -2) / shape["d"] ** 0.5
        p = torch.softmax(s, -1)
        o1 = (_tf32(p) @ vh).permute(0, 2, 1, 3).numpy()
        assert np.abs(o1 - ref_o).max() > tol


def test_kernel_inputs_need_16_byte_row_strides():
    """The kernels copy rows 16 bytes at a time: a bf16 tensor whose seq
    stride is a multiple of 4 elements but not of 8 is not in their layout;
    the same strides in f32 (16-byte multiples) are. The wrapper's layout
    step copies the first into a contiguous tensor of equal values and
    hands the second through as it is, and neither is refused."""
    shape, strides = (1, 128, 1, 64), (128 * 68, 68, 64, 1)
    for dtype, in_layout in ((torch.bfloat16, False), (torch.float32, True)):
        q = torch.arange(128 * 68, dtype=torch.float32).to(dtype).as_strided(shape, strides)
        kv = torch.zeros(shape, dtype=dtype)
        assert TFA._strided_ok(q) == in_layout
        laid = TFA.kernel_layout(q)
        assert TFA._strided_ok(laid) and torch.equal(laid, q)
        assert (laid is q) == in_layout
        TFA._check_kernel_inputs(q, kv, kv)
        TFA._check_kernel_inputs(kv, kv, kv)


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
