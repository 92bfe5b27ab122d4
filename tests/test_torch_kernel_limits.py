"""The flash kernels take every input that ``supported`` admits.

Two limits of the kernels sit below the predicate: b*h runs on the grid's y
dimension (at most 65535 per launch), and the kernels copy rows 16 bytes at
a time. The wrapper issues larger B*H in chunks (``grid_chunks``: the base
each kernel adds to ``blockIdx.y``, and the count of the launch) and copies
an operand outside the kernels' layout to a contiguous tensor
(``kernel_layout``). These tests hold the plan and the layout step on the
CPU; ``chip_smoke.py`` runs both on the card (its "kernel limits" phase).
Values are compared exactly: the layout step copies, it does not compute.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dcr_tpu_torch.ops import attention as TA
from dcr_tpu_torch.ops import flash_attention as TFA


@pytest.mark.parametrize("bh,plan", [
    (1, [(0, 1)]),
    (65535, [(0, 65535)]),
    (65536, [(0, 65535), (65535, 1)]),
    (200000, [(0, 65535), (65535, 65535), (131070, 65535), (196605, 3395)]),
])
def test_grid_chunks_plan(bh, plan):
    assert TFA.grid_chunks(bh) == plan
    # the chunks tile 0 .. bh - 1 in order, each within the grid's limit
    assert sum(c for _, c in plan) == bh
    assert all(0 < c <= TFA.MAX_GRID_Y for _, c in plan)
    assert all(b0 + c == b1 for (b0, c), (b1, _) in zip(plan, plan[1:]))


def test_grid_chunks_refuses_empty():
    with pytest.raises(ValueError):
        TFA.grid_chunks(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layout_step_copies_a_misaligned_view(dtype):
    """A [B, S, H, D] view whose seq stride is H*D + 1 elements (2 bytes off
    a 16-byte multiple in bf16, 4 in f32) comes out in the kernels' layout
    with equal values; a tensor already in it is handed through as is."""
    b, s, h, d = 2, 128, 3, 64
    rng = np.random.default_rng(0)
    buf = torch.from_numpy(rng.standard_normal((b, s, h * d + 1), np.float32)).to(dtype)
    view = buf[:, :, 1:].unflatten(-1, (h, d))
    assert not TFA._strided_ok(view)
    laid = TFA.kernel_layout(view)
    assert TFA._strided_ok(laid) and laid.is_contiguous()
    assert torch.equal(laid, view) and laid.dtype == dtype
    same = torch.zeros((b, s, h, d), dtype=dtype)
    assert TFA.kernel_layout(same) is same


def _meta(shape, dtype=torch.float32, strides=None):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t if strides is None else t.as_strided(shape, strides)


@pytest.mark.parametrize("b,h,dtype,misaligned", [
    (1024, 65, torch.bfloat16, False),   # B*H = 66560 > 65535
    (1024, 65, torch.float32, True),
    (2, 2, torch.bfloat16, True),
    (4000, 50, torch.float32, False),    # B*H = 200000
])
def test_check_refuses_only_what_supported_refuses(b, h, dtype, misaligned):
    """Every input ``supported`` admits passes the kernels' own check,
    B*H above the grid limit and misaligned strides included."""
    s, d = 128, 64
    strides = (s * (h * d + 1), h * d + 1, d, 1) if misaligned else None
    q = _meta((b, s, h, d), dtype, strides)
    kv = _meta((b, s, h, d), dtype)
    assert TFA.supported(q, kv, kv)
    TFA._check_kernel_inputs(q, kv, kv)


@pytest.mark.parametrize("case", ["k_dtype", "v_shape", "heads", "seq"])
def test_supported_refuses_what_the_check_refuses(case):
    q = _meta((1, 128, 2, 64))
    k = v = _meta((1, 128, 2, 64))
    if case == "k_dtype":
        k = _meta((1, 128, 2, 64), torch.bfloat16)
    elif case == "v_shape":
        v = _meta((1, 256, 2, 64))
    elif case == "heads":
        k = v = _meta((1, 128, 3, 64))
    else:
        q = _meta((1, 192, 2, 64))
    assert not TFA.supported(q, k, v)


def test_dispatcher_takes_a_misaligned_operand_on_the_kernel_path():
    """On the CPU the kernel path is the plain version: a misaligned q goes
    through the flash route (the autograd Function) and equals SDPA."""
    b, s, h, d = 1, 128, 2, 64
    rng = np.random.default_rng(1)
    buf = torch.from_numpy(rng.standard_normal((b, s, h * d + 1), np.float32))
    q = buf[:, :, 1:].unflatten(-1, (h, d)).requires_grad_(False)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32)) for _ in range(2))
    out = TA.dot_product_attention(q.detach().requires_grad_(), k, v)
    assert "FlashAttention" in type(out.grad_fn).__name__
    ref = TA._sdpa_attention(q, k, v, None)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=2e-6, rtol=0)
