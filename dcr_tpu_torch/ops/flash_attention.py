"""Flash attention: hand-written Hopper kernels and their plain versions.

Counterpart of ``dcr_tpu/ops/flash_attention.py``. The Pallas ``_fwd_kernel``
becomes the CUDA kernel in ``dcr_tpu_torch/csrc/flash_attention_fwd.cu``;
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` become the two kernels in
``dcr_tpu_torch/csrc/flash_attention_bwd.cu`` (each built by :mod:`.build` at
first use). :func:`flash_attention_reference` and
:func:`flash_attention_bwd_reference` are the same functions in plain
PyTorch. :class:`FlashAttention` ties them together as the JAX package's
``custom_vjp`` does: its forward is the forward kernel, it saves (q, k, v, o,
lse), and its backward is the dQ and dK/dV kernels.

Routing is by device only. Tensors on the CPU go to the plain versions (the
CPU tests); tensors on the GPU launch the kernels or raise. Nothing falls
back from a kernel.

Layout contract: [B, S, H, D] in and out, read through its strides; the
log-sum-exp comes back compact as [B*H, Sq] float32.
"""

from __future__ import annotations

import ctypes

import torch

from dcr_tpu_torch.ops import build

SOURCE = build.CSRC_DIR / "flash_attention_fwd.cu"
BWD_SOURCE = build.CSRC_DIR / "flash_attention_bwd.cu"
# sequence lengths are multiples of this (csrc/flash_attention_fwd.cu TILE)
KERNEL_TILE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_int64


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Kernel-capable shapes, the predicate of dcr_tpu's ``supported``: 128
    divides both sequence lengths, D is 64, 128 or 256, f32 or bf16."""
    if q.ndim != 4:
        return False
    _, sq, _, d = q.shape
    sk = k.shape[1]
    return (
        sq % 128 == 0
        and sk % 128 == 0
        and d in (64, 128, 256)
        and q.dtype in (torch.float32, torch.bfloat16)
    )


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (softmax(q k^T D^-1/2) v in q's dtype, lse [B*H, Sq] f32),
    computed in f32 over [B, S, H, D] inputs. With bf16 operands it rounds
    where the kernels round: P = exp(s - rowmax) goes to bf16 before P v, and
    the row sum it divides by is the unrounded one (the Pallas kernel's
    ``p.astype(in_dtype)``)."""
    b, sq, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if q.dtype == torch.float32:
        lse = torch.logsumexp(logits, dim=-1)                   # [B, H, Sq]
        p = torch.exp(logits - lse[..., None])
        out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    else:
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        l = p.sum(dim=-1, keepdim=True)
        lse = (m + torch.log(l))[..., 0]
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
        out = out / l.permute(0, 2, 1, 3)
    return out.to(q.dtype), lse.reshape(b * h, sq)


def _strided_ok(t: torch.Tensor) -> bool:
    """The kernels' layout: 16-byte aligned, contiguous last dim, other
    strides multiples of 16 bytes (4 f32 or 8 bf16 elements), so every row
    starts on a 16-byte boundary for the kernels' 16-byte copies."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3]))


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes f32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash kernel takes [B, S, H, D] tensors")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != (b, sk, h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in (64, 128, 256):
        raise ValueError(f"flash kernel takes head dim 64, 128 or 256, got {d}")
    if sq % KERNEL_TILE or sk % KERNEL_TILE or sq == 0 or sk == 0:
        raise ValueError(f"flash kernel needs sequence lengths that are nonzero "
                         f"multiples of {KERNEL_TILE}, got Sq={sq}, Sk={sk}")
    if b * h > 65535:
        raise ValueError(f"flash kernel takes at most 65535 batch*heads, got {b * h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _strided_ok(t):
            raise ValueError(f"flash kernel needs 16-byte aligned {name} with a contiguous "
                             f"last dim and strides that are multiples of 16 bytes, "
                             f"got {t.stride()} in {t.dtype}")


_LIBS: dict[str, ctypes.CDLL] = {}


def _library(source) -> ctypes.CDLL:
    """The loaded kernel library of ``source`` with its C signatures set."""
    key = source.name
    if key not in _LIBS:
        lib = build.load(source)
        if source == SOURCE:
            lib.dcr_flash_fwd.restype = ctypes.c_int
            lib.dcr_flash_fwd.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [_I64] * 12
                + [ctypes.c_float, ctypes.c_void_p])
        else:
            for fn, n_out in ((lib.dcr_flash_bwd_dq, 1), (lib.dcr_flash_bwd_dkv, 2)):
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * (6 + n_out) + [ctypes.c_int] * 6
                               + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        lib.dcr_cuda_error_string.restype = ctypes.c_char_p
        lib.dcr_cuda_error_string.argtypes = [ctypes.c_int]
        _LIBS[key] = lib
    return _LIBS[key]


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        msg = lib.dcr_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, D], lse [B*H, Sq] f32) for [B, S, H, D] q/k/v.
    A raw launch that records no autograd graph: :func:`flash_attention`
    is the differentiable op. ``flash_attention_fwd.launches`` counts kernel
    launches."""
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return flash_attention_reference(q, k, v)
    if devices != {"cuda"}:
        raise ValueError(f"flash attention takes cpu or cuda tensors, got {devices}")
    _check_kernel_inputs(q, k, v)
    lib = _library(SOURCE)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dcr_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            1.0 / (d ** 0.5), stream)
    _raise_on(lib, err, "flash-attention forward")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels, in f32 by recomputation:
    P = exp(S - lse), dP = dO V^T, dS = P (dP - rowsum(dO O)); returns
    (dq, dk, dv) in the inputs' dtypes over [B, S, H, D]. With bf16 operands
    P is rounded to bf16 before dV and dS before dQ and dK, where the
    kernels round (the Pallas kernels' ``astype(in_dtype)``)."""
    b, sq, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float().reshape(b, h, sq)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 1)                     # [B, H, Sq]
    ds = p * (dp - delta[..., None])
    # the operand dtype's rounding (none for f32)
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_operands(q, k, v, o, lse, do):
    """Checks the backward's operands for the kernels; returns do in the
    kernels' layout (a contiguous copy when autograd handed in other strides)."""
    devices = {t.device for t in (q, k, v, o, lse, do)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash attention backward kernels take tensors on one cuda "
                         f"device, got {sorted(str(d) for d in devices)}")
    _check_kernel_inputs(q, k, v)
    if not _strided_ok(do):
        do = do.contiguous()
    b, sq, h, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, {q.dtype}), got "
                             f"{tuple(t.shape)}, {t.dtype}")
    if not _strided_ok(o):
        raise ValueError(f"flash backward needs o in the kernels' layout, got strides "
                         f"{o.stride()}")
    if lse.shape != (b * h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 [{b * h}, {sq}] tensor, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    return do


def _bwd_launch(kind: str, q, k, v, o, lse, do, outs) -> None:
    """One launch of the dQ (kind "dq") or dK/dV ("dkv") kernel into outs."""
    lib = _library(BWD_SOURCE)
    b, sq, h, d = q.shape
    # strides of (dQ, dK, dV); the slots a kernel does not write take q's
    grads = (outs[0], q, q) if kind == "dq" else (q, outs[0], outs[1])
    strides = (_I64 * 24)(*(s for t in (q, k, v, o, do, *grads) for s in t.stride()[:3]))
    fn = lib.dcr_flash_bwd_dq if kind == "dq" else lib.dcr_flash_bwd_dkv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), *(t.data_ptr() for t in outs),
                 _DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d, strides,
                 1.0 / (d ** 0.5), stream)
    _raise_on(lib, err, f"flash-attention {'dQ' if kind == 'dq' else 'dK/dV'}")


def flash_attention_bwd_dq(q, k, v, o, lse, do) -> torch.Tensor:
    """dq from the dQ kernel (CUDA tensors only); counts in
    ``flash_attention_bwd.dq_launches``."""
    do = _bwd_operands(q, k, v, o, lse, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("dq", q, k, v, o, lse, do, (dq,))
    flash_attention_bwd.dq_launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, o, lse, do) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dK/dV kernel (CUDA tensors only); counts in
    ``flash_attention_bwd.dkv_launches``."""
    do = _bwd_operands(q, k, v, o, lse, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("dkv", q, k, v, o, lse, do, (dk, dv))
    flash_attention_bwd.dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the forward's (q, k, v, o, lse) and the output's
    gradient ``do``. On CUDA tensors it launches the dQ kernel, then the
    dK/dV kernel. ``do`` from autograd may come with any strides: the kernels
    read [B, S, H, D] strides with a contiguous last dimension, so a ``do``
    without that layout is copied to a contiguous tensor first. Counts:
    ``flash_attention_bwd.dq_launches`` and ``.dkv_launches``."""
    if {t.device.type for t in (q, k, v, o, lse, do)} == {"cpu"}:
        return flash_attention_bwd_reference(q, k, v, o, lse, do)
    do = _bwd_operands(q, k, v, o, lse, do)
    dq = flash_attention_bwd_dq(q, k, v, o, lse, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do)
    return dq, dk, dv


flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's ``custom_vjp``):
    forward kernel, residuals (q, k, v, o, lse), dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        return flash_attention_bwd(*ctx.saved_tensors, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash attention over [B, S, H, D] tensors, differentiable in q, k, v."""
    return FlashAttention.apply(q, k, v)
