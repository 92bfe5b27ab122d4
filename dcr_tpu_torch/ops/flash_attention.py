"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

Counterpart of the forward half of ``dcr_tpu/ops/flash_attention.py``: the
Pallas ``_fwd_kernel`` becomes the CUDA kernel in
``dcr_tpu_torch/csrc/flash_attention_fwd.cu`` (built by :mod:`.build` at
first use), and :func:`flash_attention_reference` is the same function in
plain PyTorch.

Routing is by device only. A tensor on the CPU goes to the plain version (the
CPU tests); a tensor on the GPU launches the kernel or raises. Nothing falls
back from the kernel. The kernel is forward only: on the GPU an input that
requires grad raises (the backward kernels come with the training path).

Layout contract: [B, S, H, D] in and out, read through its strides; the
log-sum-exp comes back compact as [B*H, Sq] float32.
"""

from __future__ import annotations

import ctypes

import torch

from dcr_tpu_torch.ops import build

SOURCE = build.CSRC_DIR / "flash_attention_fwd.cu"
# the kernel's query and key tile (csrc/flash_attention_fwd.cu BM, BN)
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
    computed in f32 over [B, S, H, D] inputs."""
    b, sq, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)                       # [B, H, Sq]
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse.reshape(b * h, sq)


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
        if t.stride(3) != 1:
            raise ValueError(f"flash kernel needs a contiguous last dim in {name}")
        if t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(f"flash kernel needs 16-byte aligned {name} with strides "
                             f"that are multiples of 4 elements, got {t.stride()}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("the flash-attention kernel is forward only; call it "
                           "under torch.no_grad() (the backward is not ported yet)")


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE)
        lib.dcr_flash_fwd.restype = ctypes.c_int
        lib.dcr_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [_I64] * 12
            + [ctypes.c_float, ctypes.c_void_p])
        lib.dcr_cuda_error_string.restype = ctypes.c_char_p
        lib.dcr_cuda_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, D], lse [B*H, Sq] f32) for [B, S, H, D] q/k/v.
    ``flash_attention_fwd.launches`` counts kernel launches."""
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return flash_attention_reference(q, k, v)
    if devices != {"cuda"}:
        raise ValueError(f"flash attention takes cpu or cuda tensors, got {devices}")
    _check_kernel_inputs(q, k, v)
    lib = _library()
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
    if err:
        msg = lib.dcr_cuda_error_string(err).decode()
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA error {err} ({msg})")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash attention over [B, S, H, D] tensors (forward only)."""
    return flash_attention_fwd(q, k, v)[0]
