"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit code:
1. card: name and power limit from nvidia-smi; TF32 off for matmuls and convs;
2. build: every kernel source in dcr_tpu_torch/csrc (one nvcc each, at once);
   per kernel symbol, its registers and spill bytes (ptxas) and its count of
   tensor-core instructions (HMMA/HGMMA in cuobjdump's SASS); the kernels of
   TENSOR_CORE_KERNELS (the forward in both dtypes, as split TF32 for f32;
   dQ and dK/dV in bf16) must have tensor-core instructions, and no spills
   at D=64;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and a few edge shapes, in f32 and bf16 (bf16
   against the plain version in bf16, which rounds where the kernels round),
   with times, the plain version's and the library call's time, the bound
   and the share of it reached, and for f32 the kernel's and the plain
   version's errors against f64: the forward kernel (B1), then the dQ (B2)
   and dK/dV (B3) backward kernels, which must also give bit-identical
   gradients over two launches; a gradient probe through the autograd
   Function;
4. small references: a kernel-shaped tiny sampler, and 2 train steps of a
   kernel-shaped tiny model, on the card against the same on the CPU (plain
   attention), from the same x_T / weights and draws;
5. sampling main path: dcr_tpu_torch.sampling.pipeline.generate at SD-2.1
   widths (ModelConfig()), 512 px, 20 DPM-Solver++ steps with CFG, 2
   prompts x 2 images, seeded random weights built on the card; the forward
   kernel's launch count must be 15 per UNet call;
6. training main path: dcr_tpu_torch.diffusion.trainer.Trainer(TrainConfig())
   (SD-2.1 widths, 256 px, batch 16, bf16, AdamW with warmup) on a
   class-folder of PNGs written here, seeded random weights, a few optimizer
   steps; 10 launches of each kernel per step, finite losses, a checkpoint
   and an HF-layout export that loads back;
7. the f32 training mode: 2 steps of the train step (make_train_step) at
   SD-2.1 widths with mixed_precision="no"; 10 launches of each kernel per
   step, all in f32, finite losses.
Each main path runs with every launch count set to 0 just before it and
read just after. The last line is {"ok": true, "device": {...}}; the line
before it holds the kernels' numbers as JSON, one record per kernel and
dtype.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch


# H100 SXM data-sheet peaks at 700 W (dense), HBM3 bandwidth. bf16: the
# tensor cores. f32: the least time for f32-accurate work is that of split
# TF32 on the tensor cores (3 TF32 products per f32 product, 495 / 3
# TFLOP/s), above the 67 TFLOP/s of the CUDA cores; one TF32 product alone
# misses f32 accuracy
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


# bf16 kernels against their plain versions in bf16: max-abs error at most
# this share of max(1, max|reference|)
BF16_TOL = 2.0 ** -6


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph, so
    no host time lies between them; CUDA events around each of 5 replays,
    median over the replays of the time per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    run = g.replay
    run()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def call_ms(fn, reps: int) -> float:
    """Median time of one call with the device idle before it, CUDA events
    around each call: the kernel plus the wrapper's host time (the kernel
    table's older measure)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_tol(ref: torch.Tensor) -> float:
    return BF16_TOL * max(1.0, ref.float().abs().max().item())


def flash_bound(b: int, sq: int, sk: int, h: int, d: int, dtype) -> tuple[float, str]:
    """Least time (ms) for one flash forward: q, k, v read once, o and lse
    written once, 4*Sq*Sk*D flops per (b, h) at the dtype's peak rate."""
    el = torch.finfo(dtype).bits // 8
    nbytes = el * (2 * b * sq * h * d + 2 * b * sk * h * d) + 4 * b * h * sq
    flops = 4.0 * b * h * sq * sk * d
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def reset_launches() -> None:
    from dcr_tpu_torch.ops import flash_attention as fa

    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.dq_launches = 0
    fa.flash_attention_bwd.dkv_launches = 0


def read_launches() -> tuple[int, int, int]:
    """(forward, dQ, dK/dV) launch counts."""
    from dcr_tpu_torch.ops import flash_attention as fa

    return (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.dq_launches,
            fa.flash_attention_bwd.dkv_launches)


def phase_card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmuls (torch.backends.cuda.matmul.allow_tf32=False) and "
        "convolutions (torch.backends.cudnn.allow_tf32=False)")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")


# kernels that must run on the tensor cores: B1 in both dtypes, B2 and B3
# in bf16
TENSOR_CORE_KERNELS = ("flash_fwd_bf16_kernel", "flash_fwd_tf32x3_kernel",
                       "flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel")


def _ptxas_stats(text: str) -> dict[str, dict]:
    """{mangled kernel: {"registers": n, "spill_bytes": stores + loads}}
    from nvcc -Xptxas -v output."""
    stats: dict[str, dict] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?",
                      line)
        if m:
            cur = stats.setdefault(m.group(1), {"registers": None, "spill_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return stats


def _sass_tensor_core_counts(lib: Path, cuobjdump: Path) -> dict[str, int]:
    """{mangled kernel: count of HMMA/HGMMA instructions} in a built library."""
    out = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts: dict[str, int] = {}
    cur = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and re.search(r"\bHG?MMA\.", line):
            counts[cur] += 1
    return counts


def _demangle(names: list[str]) -> list[str]:
    filt = shutil.which("c++filt")
    if not filt or not names:
        return names
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else names


def phase_build() -> dict:
    """Builds both sources at once; prints, per kernel symbol, registers,
    spill bytes and tensor-core instruction count; raises if a kernel of
    TENSOR_CORE_KERNELS is missing, or has an instantiation with no
    tensor-core instruction or that spills at D=64."""
    from dcr_tpu_torch.ops import build
    from dcr_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    sources = [fa.SOURCE, fa.BWD_SOURCE]
    logs = build.build(sources)
    log(f"build: {len(logs)} kernel source(s) in {time.perf_counter() - t0:.2f} s "
        f"with {build.nvcc_path()}")
    cuobjdump = build.nvcc_path().parent / "cuobjdump"
    kernels = {}
    for source in sources:
        text = logs[source.stem] or (build.BUILD_DIR / f"{source.stem}.log").read_text()
        ptxas = _ptxas_stats(text)
        counts = _sass_tensor_core_counts(build.library_path(source), cuobjdump)
        names = sorted(counts)
        for name, pretty in zip(names, _demangle(names)):
            st = ptxas.get(name, {"registers": None, "spill_bytes": None})
            kernels[pretty] = {"source": source.name, "symbol": name,
                               "tensor_core_instructions": counts[name], **st}
            log(f"  {source.stem}: {pretty}: {st['registers']} registers, "
                f"{st['spill_bytes']} spill bytes, {counts[name]} HMMA/HGMMA")
    bad = [(k, v) for k, v in kernels.items()
           if any(t in v["symbol"] for t in TENSOR_CORE_KERNELS)
           and (v["tensor_core_instructions"] == 0
                or ("ILi64E" in v["symbol"] and v["spill_bytes"] != 0))]
    missing = [t for t in TENSOR_CORE_KERNELS
               if not any(t in v["symbol"] for v in kernels.values())]
    if bad or missing:
        raise AssertionError(f"tensor-core kernels missing {missing}, or without tensor-core "
                             f"instructions or spilling at D=64: {bad}")
    return kernels


def phase_kernels(reps: int) -> dict:
    import torch.nn.functional as F

    from dcr_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # (name, B, Sq, Sk, H, D, logit scale, main-path shape)
    cases = [
        ("level0", 4, 4096, 4096, 5, 64, 1.0, True),
        ("level1", 4, 1024, 1024, 10, 64, 1.0, True),
        ("level2", 4, 256, 256, 20, 64, 1.0, True),
        ("train_level0", 16, 1024, 1024, 5, 64, 1.0, True),
        ("train_level1", 16, 256, 256, 10, 64, 1.0, True),
        ("d128", 2, 1024, 1024, 4, 128, 1.0, False),
        ("d256", 2, 512, 512, 4, 256, 1.0, False),
        ("rect", 2, 1024, 256, 4, 64, 1.0, False),
        ("logits_x100", 2, 1024, 1024, 4, 64, 100.0, False),
    ]
    rows = []
    for name, b, sq, sk, h, d, scale, main in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, sq, h, d), generator=gen, device=dev) * scale
            k = torch.randn((b, sk, h, d), generator=gen, device=dev)
            v = torch.randn((b, sk, h, d), generator=gen, device=dev)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            with torch.no_grad():
                o, lse = fa.flash_attention_fwd(q, k, v)
                torch.cuda.synchronize()
                ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
            err_o = (o.float() - ref_o.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            if dtype is torch.bfloat16:
                tol_o = dict(atol=bf16_tol(ref_o), rtol=0.0)  # vs the plain version in bf16
            elif scale != 1.0:
                tol_o = dict(atol=2e-4, rtol=2e-4)     # x100 logits: JAX repo's bound
            else:
                tol_o = dict(atol=2e-5, rtol=0.0)
            ok_o = torch.allclose(o.float(), ref_o.float(), **tol_o)
            ok_lse = torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-5)
            finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
            f64 = None
            if dtype is torch.float32:
                # the kernel's and the plain version's own errors, against f64
                with torch.no_grad():
                    lg = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / d ** 0.5
                    o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(lg, -1), v.double())
                    f64 = {"kernel": (o.double() - o64).abs().max().item(),
                           "plain": (ref_o.double() - o64).abs().max().item()}
                    del lg, o64
            with torch.no_grad():
                ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v), reps)
                per_call_ms = call_ms(lambda: fa.flash_attention_fwd(q, k, v), reps)
                plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v), reps)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)
            bound_ms, bound_by = flash_bound(b, sq, sk, h, d, dtype)
            row = dict(case=name, shape=[b, sq, sk, h, d], dtype=str(dtype).split(".")[-1],
                       max_abs_err=err_o, lse_max_abs_err=err_lse, ms=ms,
                       call_ms=per_call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       pct_of_bound=100.0 * bound_ms / ms, main_path=main, tol=tol_o,
                       max_abs_err_vs_f64=f64)
            rows.append(row)
            log(f"flash {name:12s} {row['dtype']:8s} B={b} Sq={sq} Sk={sk} H={h} D={d}: "
                f"kernel {ms:.4f} ms ({row['pct_of_bound']:.1f} % of bound; "
                f"{per_call_ms:.4f} ms per call with host), plain {plain_ms:.4f} ms, "
                f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                f"max|o-ref| {err_o:.3e} (tol {tol_o['atol']:.3e}), "
                f"max|lse-ref| {err_lse:.3e}"
                + (f", max|o-f64| kernel {f64['kernel']:.3e} plain {f64['plain']:.3e}"
                   if f64 else ""))
            if not (ok_o and ok_lse and finite):
                raise AssertionError(f"flash kernel disagrees with its plain version at "
                                     f"{name} {dtype}: o err {err_o:.3e} (tol {tol_o}), "
                                     f"lse err {err_lse:.3e}, finite={finite}")

    # a gradient through the autograd Function reaches the backward kernels
    # and agrees with autograd through the plain version
    q, k, v = (torch.randn((2, 256, 2, 64), generator=gen, device=dev).requires_grad_()
               for _ in range(3))
    before = (fa.flash_attention_bwd.dq_launches, fa.flash_attention_bwd.dkv_launches)
    out = fa.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), out.detach())
    torch.cuda.synchronize()
    ref_out, _ = fa.flash_attention_reference(q, k, v)
    ref = torch.autograd.grad(ref_out, (q, k, v), out.detach())
    launched = (fa.flash_attention_bwd.dq_launches - before[0],
                fa.flash_attention_bwd.dkv_launches - before[1])
    err_g = max((g - r).abs().max().item() for g, r in zip(grads, ref))
    log(f"gradient probe: autograd through the flash Function vs through the plain "
        f"version, max|diff| {err_g:.3e}, backward launches (dQ, dK/dV) {launched}")
    if not (err_g <= 1e-4 and launched == (1, 1)):
        raise AssertionError(f"gradient probe failed: err {err_g:.3e}, launches {launched}")
    y = torch.randn((1, 128, 2, 48), device=dev)
    try:
        fa.flash_attention_fwd(y, y, y)
    except ValueError as e:
        log(f"unsupported head dim refused on the card: {e}")
    else:
        raise AssertionError("flash kernel accepted head dim 48")
    return {"rows": rows}


def bwd_bound(kind: str, b: int, sq: int, sk: int, h: int, d: int,
              dtype) -> tuple[float, str]:
    """Least time (ms) for one backward kernel: q, k, v, o, dO and lse read
    once, its gradients written once; the dQ kernel does 6*Sq*Sk*D flops per
    (b, h) (S and dP recomputed, then dQ), the dK/dV kernel 8*Sq*Sk*D (S, dP,
    dV, dK), at the dtype's peak rate."""
    el = torch.finfo(dtype).bits // 8
    reads = el * (3 * b * sq * h * d + 2 * b * sk * h * d) + 4 * b * h * sq
    writes = el * (b * sq * h * d if kind == "dq" else 2 * b * sk * h * d)
    flops = (6.0 if kind == "dq" else 8.0) * b * h * sq * sk * d
    t_bytes, t_ops = (reads + writes) / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def phase_bwd_kernels(reps: int) -> dict:
    """The dQ (B2) and dK/dV (B3) kernels against flash_attention_bwd_reference
    on the same inputs (the forward kernel's o and lse), bit-identical over two
    launches, with times. library_ms is the backward alone of
    F.scaled_dot_product_attention on the same q, k, v and dO, on the device
    (its forward and backward in one CUDA graph, less its forward alone);
    library_call_ms is one torch.autograd.grad call, host included. It
    computes dq, dk and dv, so it stands beside the pair of kernels."""
    import torch.nn.functional as F

    from dcr_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # (name, B, Sq, Sk, H, D, logit scale, train main-path shape)
    cases = [
        ("train_level0", 16, 1024, 1024, 5, 64, 1.0, True),
        ("train_level1", 16, 256, 256, 10, 64, 1.0, True),
        ("d128", 2, 1024, 1024, 4, 128, 1.0, False),
        ("d256", 2, 512, 512, 4, 256, 1.0, False),
        ("sq_gt_sk", 2, 1024, 256, 4, 64, 1.0, False),
        ("sk_gt_sq", 2, 256, 1024, 4, 64, 1.0, False),
        ("logits_x100", 2, 1024, 1024, 4, 64, 100.0, False),
    ]
    rows = []
    for name, b, sq, sk, h, d, scale, main in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = (torch.randn((b, sq, h, d), generator=gen, device=dev) * scale).to(dtype)
            k, v = (torch.randn((b, sk, h, d), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            do = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
            with torch.no_grad():
                o, lse = fa.flash_attention_fwd(q, k, v)
                dq = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
                dk, dv = fa.flash_attention_bwd_dkv(q, k, v, o, lse, do)
                dq2 = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
                dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, o, lse, do)
                torch.cuda.synchronize()
                ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
            same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
            # tolerance relative to the gradient's magnitude: f32 kernels
            # differ from the plain version by summation order only; bf16
            # kernels are held against the plain version in bf16, which
            # rounds P and dS to bf16 before their products as they do
            errs, tols = [], []
            for got, want in zip((dq, dk, dv), ref):
                errs.append((got.float() - want.float()).abs().max().item())
                tols.append(1e-5 * max(1.0, want.abs().max().item())
                            if dtype is torch.float32 else bf16_tol(want))
            finite = all(bool(torch.isfinite(g.float()).all()) for g in (dq, dk, dv))
            with torch.no_grad():
                ms_dq = time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do), reps)
                ms_dkv = time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, o, lse, do), reps)
                call_dq = call_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do), reps)
                call_dkv = call_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, o, lse, do),
                                   reps)
                plain_ms = time_ms(lambda: fa.flash_attention_bwd_reference(
                    q, k, v, o, lse, do), reps)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qt, kt, vt)
                torch.autograd.grad(out, (qt, kt, vt), dot)

            # SDPA's backward on the device alone: its forward and backward
            # captured in one graph, less its forward captured alone
            with torch.no_grad():
                lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)
            lib_ms = time_ms(sdpa_fwd_bwd, reps) - lib_fwd_ms
            # and host included: one autograd.grad call on a graph built once
            out = F.scaled_dot_product_attention(qt, kt, vt)
            lib_call_ms = call_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                              retain_graph=True), reps)
            del out
            b_dq, by_dq = bwd_bound("dq", b, sq, sk, h, d, dtype)
            b_dkv, by_dkv = bwd_bound("dkv", b, sq, sk, h, d, dtype)
            row = dict(case=name, shape=[b, sq, sk, h, d], dtype=str(dtype).split(".")[-1],
                       main_path=main, bit_identical=same,
                       max_abs_err={"dq": errs[0], "dk": errs[1], "dv": errs[2]},
                       tol={"dq": tols[0], "dk": tols[1], "dv": tols[2]},
                       dq_ms=ms_dq, dkv_ms=ms_dkv, dq_call_ms=call_dq, dkv_call_ms=call_dkv,
                       plain_ms=plain_ms, library_ms=lib_ms, library_call_ms=lib_call_ms,
                       dq_bound_ms=b_dq, dq_bound_by=by_dq, dkv_bound_ms=b_dkv,
                       dkv_bound_by=by_dkv, dq_pct_of_bound=100.0 * b_dq / ms_dq,
                       dkv_pct_of_bound=100.0 * b_dkv / ms_dkv)
            rows.append(row)
            log(f"flash bwd {name:12s} {row['dtype']:8s} B={b} Sq={sq} Sk={sk} H={h} D={d}: "
                f"dQ {ms_dq:.4f} ms (bound {b_dq:.4f}, {by_dq}, "
                f"{row['dq_pct_of_bound']:.1f} %; {call_dq:.4f} per call), dK/dV "
                f"{ms_dkv:.4f} ms (bound {b_dkv:.4f}, {by_dkv}, "
                f"{row['dkv_pct_of_bound']:.1f} %; {call_dkv:.4f} per call), plain "
                f"{plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms ({lib_call_ms:.4f} per "
                f"autograd.grad call), max err dq/dk/dv "
                f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
                f"{tols[0]:.3e}/{tols[1]:.3e}/{tols[2]:.3e}), bit-identical {same}")
            if not (same and finite and all(e <= t for e, t in zip(errs, tols))):
                raise AssertionError(f"flash backward kernels disagree with their plain "
                                     f"version at {name} {dtype}: errs {errs}, tols {tols}, "
                                     f"bit-identical {same}, finite {finite}")
    return {"rows": rows}


def phase_small_reference() -> None:
    """Kernel-shaped tiny sampler: card (kernel) vs CPU (plain), same weights
    and x_T; images within 1e-3 (f32 both sides, TF32 off; the CFG and solver
    steps amplify summation-order differences)."""
    import numpy as np

    from dcr_tpu_torch.core.config import ModelConfig, SampleConfig
    from dcr_tpu_torch.ops import flash_attention as fa
    from dcr_tpu_torch.sampling.pipeline import build_models, load_params
    from dcr_tpu_torch.sampling.sampler import make_sampler

    cfg = ModelConfig(sample_size=16, block_out_channels=(64, 128), layers_per_block=1,
                      attention_head_dim=64, cross_attention_dim=64, norm_num_groups=16,
                      vae_block_out_channels=(32, 64, 64, 64), vae_layers_per_block=1,
                      text_vocab_size=1000, text_hidden_size=64, text_layers=2,
                      text_heads=2, text_max_length=16)
    cpu = build_models(cfg, "cpu", seed=1)
    gpu = build_models(cfg, "cuda")
    load_params(gpu, {"unet": cpu.unet.state_dict(), "vae": cpu.vae.state_dict(),
                      "text": cpu.text_encoder.state_dict()})
    scfg = SampleConfig(resolution=128, num_inference_steps=4, sampler="dpm++",
                        guidance_scale=7.5)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 999, (2, 16))
    unc = np.full((2, 16), 999)
    x_t = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    before = fa.flash_attention_fwd.launches
    out_gpu = make_sampler(scfg, gpu, "cuda")(None, ids, unc, None, init_latents=x_t).cpu()
    launched = fa.flash_attention_fwd.launches - before
    out_cpu = make_sampler(scfg, cpu, "cpu")(None, ids, unc, None, init_latents=x_t)
    err = (out_gpu - out_cpu).abs().max().item()
    log(f"small reference (kernel-shaped tiny sampler, 128 px, 4 dpm++ steps): "
        f"card vs cpu max|diff| {err:.3e}, kernel launches {launched}")
    if not (err <= 1e-3 and launched == 3 * 4):
        raise AssertionError(f"small reference failed: err {err:.3e}, launches {launched}")


def phase_main_path(out_dir: Path) -> dict:
    import numpy as np

    from dcr_tpu_torch.core.config import ModelConfig, SampleConfig
    from dcr_tpu_torch.ops import flash_attention as fa
    from dcr_tpu_torch.sampling import pipeline as P

    model_cfg = ModelConfig(sample_size=64)        # SD-2.1 widths, 512 px latents
    t0 = time.perf_counter()
    models = P.build_models(model_cfg, "cuda", seed=0)
    params = {"unet": models.unet.state_dict(), "vae": models.vae.state_dict(),
              "text": models.text_encoder.state_dict()}
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (models.unet, models.vae, models.text_encoder)
                   for p in m.parameters())
    log(f"main path: SD-2.1 widths, {n_params / 1e6:.1f}M params built on the card "
        f"in {time.perf_counter() - t0:.2f} s")

    calls, images = [], []
    make = P.make_sampler

    def timed_make_sampler(*a, **kw):
        fn = make(*a, **kw)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - start)
            images.append(out.float().cpu())
            return out
        return timed

    P.make_sampler = timed_make_sampler
    steps = 20
    cfg = SampleConfig(resolution=512, num_inference_steps=steps, sampler="dpm++",
                       guidance_scale=7.5, num_batches=2, im_batch=2, seed=0,
                       savepath=str(out_dir))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        out = P.generate(cfg, modelstyle="nolevel", models=models, params=params,
                         device="cuda")
    finally:
        launches, bwd_launches = fa.flash_attention_fwd.launches, read_launches()[1:]
        P.make_sampler = make
    peak = torch.cuda.max_memory_allocated()
    pngs = sorted((out / "generations").glob("*.png"))
    imgs = torch.cat(images)
    expected = 15 * steps * len(calls)
    log(f"main path: {len(calls)} sampler calls, {[f'{c:.3f}' for c in calls]} s each, "
        f"{statistics.mean(calls) / steps:.4f} s per step (2x2 CFG batch), "
        f"peak memory {peak / 2**30:.2f} GiB, {len(pngs)} PNGs, flash launches "
        f"{launches} (expected {expected})")
    if len(pngs) != 4 or imgs.shape != (4, 512, 512, 3):
        raise AssertionError(f"expected 4 PNGs of 512x512, got {len(pngs)}, {tuple(imgs.shape)}")
    if not (torch.isfinite(imgs).all() and imgs.min() >= 0.0 and imgs.max() <= 1.0):
        raise AssertionError("main path images are not finite values in [0, 1]")
    if len(calls) != 2 or launches != expected or bwd_launches != (0, 0):
        raise AssertionError(f"flash kernel launched {launches} times, expected {expected} "
                             f"(backward kernels {bwd_launches}, expected none)")
    return {"launches": launches, "sampler_call_s": calls,
            "step_s": statistics.mean(calls) / steps, "peak_bytes": peak,
            "image_std": float(np.std(imgs.numpy()))}


def _tiny_kernel_cfg():
    """The kernel-shaped tiny model of the small references: head dim 64 over
    16x16 latents (256 tokens) at level 0, so 3 self-attentions per UNet
    call take the kernels and the rest goes to SDPA."""
    from dcr_tpu_torch.core.config import ModelConfig

    return ModelConfig(sample_size=16, block_out_channels=(64, 128), layers_per_block=1,
                       attention_head_dim=64, cross_attention_dim=64, norm_num_groups=16,
                       vae_block_out_channels=(32, 64, 64, 64), vae_layers_per_block=1,
                       text_vocab_size=1000, text_hidden_size=64, text_layers=2,
                       text_heads=2, text_max_length=16)


def phase_small_train_reference() -> dict:
    """2 train steps of the kernel-shaped tiny model on the card (kernels)
    against the same on the CPU (plain versions): same weights, batch and
    injected draws, f32, TF32 off. Held: loss at rtol 1e-4 and grad norm at
    1e-3 per step; params within 0.1 lr per step at most and 0.01 lr per
    step on average (Adam turns rounding noise in a near-zero gradient into
    an O(lr) step, so the bound on params is absolute); 3 launches of each
    kernel per step. Then the first step once more with remat on the card:
    6 forward launches, and the loss within 1e-6 of the step without it."""
    import numpy as np

    from dcr_tpu_torch.core.config import OptimConfig, TrainConfig
    from dcr_tpu_torch.diffusion import train as T
    from dcr_tpu_torch.sampling.pipeline import build_models

    lr, steps, bsz = 1e-3, 2, 2
    cfg = TrainConfig(mixed_precision="no", seed=0, train_batch_size=bsz)
    cfg.model = _tiny_kernel_cfg()
    cfg.optim = OptimConfig(learning_rate=lr, lr_scheduler="constant", lr_warmup_steps=0,
                            adam_epsilon=1e-6)
    cpu = build_models(cfg.model, "cpu", seed=2)
    gpu = build_models(cfg.model, "cuda")
    sds = {"unet": cpu.unet.state_dict(), "text": cpu.text_encoder.state_dict(),
           "vae": cpu.vae.state_dict()}
    states = {}
    for dev, models in (("cpu", cpu), ("cuda", gpu)):
        p = {name: {k: v.detach().clone().to(dev) for k, v in sd.items()}
             for name, sd in sds.items()}
        states[dev] = T.init_train_state(cfg, models, unet_params=p["unet"],
                                         text_params=p["text"], vae_params=p["vae"])
    rng = np.random.default_rng(3)
    batch = {"pixel_values": rng.uniform(-1, 1, (bsz, 128, 128, 3)).astype(np.float32),
             "input_ids": rng.integers(0, 999, (bsz, 16))}
    metrics = {"cpu": [], "cuda": []}
    launched = (0, 0, 0)
    all_draws = []
    for i in range(steps):
        draws = {"vae_sample": torch.from_numpy(rng.standard_normal((bsz, 4, 16, 16),
                                                                    np.float32)),
                 "noise": torch.from_numpy(rng.standard_normal((bsz, 4, 16, 16), np.float32)),
                 "timesteps": torch.from_numpy(rng.integers(0, 1000, (bsz,)))}
        all_draws.append(draws)
        for dev, models in (("cpu", cpu), ("cuda", gpu)):
            before = read_launches()
            states[dev], m = T.make_train_step(cfg, models)(states[dev], batch, draws)
            metrics[dev].append({k: float(v) for k, v in m.items()})
            if dev == "cuda":
                launched = tuple(a + b - c for a, b, c in zip(launched, read_launches(),
                                                              before))
    diffs = torch.cat([(states["cuda"].unet_params[k].detach().cpu()
                        - states["cpu"].unet_params[k].detach()).abs().flatten()
                       for k in states["cpu"].unet_params])
    loss_rel = max(abs(g["loss"] - c["loss"]) / abs(c["loss"])
                   for g, c in zip(metrics["cuda"], metrics["cpu"]))
    norm_rel = max(abs(g["grad_norm"] - c["grad_norm"]) / abs(c["grad_norm"])
                   for g, c in zip(metrics["cuda"], metrics["cpu"]))
    out = {"loss_rel_err": loss_rel, "grad_norm_rel_err": norm_rel,
           "param_max_abs_err": diffs.max().item(), "param_mean_abs_err": diffs.mean().item(),
           "launches": launched, "losses_cuda": [m["loss"] for m in metrics["cuda"]]}
    # the first step again with remat on the card: torch.utils.checkpoint
    # recomputes the UNet forward, so the forward kernel runs twice
    cfg.remat = True
    p = {name: {k: v.detach().clone().to("cuda") for k, v in sd.items()}
         for name, sd in sds.items()}
    state = T.init_train_state(cfg, gpu, unet_params=p["unet"], text_params=p["text"],
                               vae_params=p["vae"])
    before = read_launches()
    _, m = T.make_train_step(cfg, gpu)(state, batch, all_draws[0])
    out["remat_launches"] = tuple(b - a for a, b in zip(before, read_launches()))
    out["remat_loss_rel_err"] = abs(float(m["loss"]) - metrics["cuda"][0]["loss"]) / abs(
        metrics["cuda"][0]["loss"])
    log(f"small train reference (kernel-shaped tiny model, 128 px, {steps} steps, f32): "
        f"card vs cpu {json.dumps(out)}")
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-3 and out["param_max_abs_err"] <= 0.1 * lr * steps
            and out["param_mean_abs_err"] <= 0.01 * lr * steps
            and launched == (3 * steps, 3 * steps, 3 * steps)
            and out["remat_launches"] == (6, 3, 3) and out["remat_loss_rel_err"] <= 1e-6):
        raise AssertionError(f"small train reference failed: {out}")
    return out


def phase_train_main_path(out_dir: Path, steps: int) -> dict:
    """Trainer(TrainConfig()) at the JAX defaults (SD-2.1 widths, 256 px,
    batch 16, bf16, remat off, AdamW with constant_with_warmup) on a
    class-folder of 48 random 256 px PNGs, HashTokenizer, seeded random
    weights built on the card, ``steps`` optimizer steps."""
    import shutil

    import numpy as np

    from dcr_tpu_torch.core.config import TrainConfig
    from dcr_tpu_torch.diffusion.trainer import Trainer
    from dcr_tpu_torch.sampling.pipeline import load_checkpoint_models
    from dcr_tpu_torch.sampling.png import write_png

    rng = np.random.default_rng(0)
    data = out_dir / "data"
    for i in range(48):
        (data / f"class{i % 2}").mkdir(parents=True, exist_ok=True)
        write_png(data / f"class{i % 2}" / f"{i}.png",
                  rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
    free = shutil.disk_usage(out_dir).free
    cfg = TrainConfig(output_dir=str(out_dir / "run"), max_train_steps=steps, log_every=1,
                      modelsavesteps=10 ** 6, checkpoints_total_limit=1)
    cfg.data.train_data_dir = str(data)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = {name: sum(p.numel() for p in d.values()) for name, d in
                (("unet", trainer.state.unet_params), ("text", trainer.state.text_params),
                 ("vae", trainer.state.vae_params))}
    log(f"train main path: TrainConfig() defaults, params {n_params}, built on the card in "
        f"{build_s:.2f} s, {free / 2**30:.1f} GiB free on disk")

    step_s, losses = [], []
    step_fn = trainer.step_fn

    def timed(state, batch):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
        return state, metrics

    trainer.step_fn = timed
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        last = trainer.train()
    finally:
        launches = read_launches()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    run = out_dir / "run"
    rows = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    median_s = statistics.median(step_s[1:])
    stats = {"steps": steps, "batch": cfg.train_batch_size, "step_s": step_s,
             "median_step_s_after_first": median_s,
             "images_per_s": cfg.train_batch_size / median_s,
             "peak_bytes": peak, "losses": losses, "launches_fwd_dq_dkv": launches,
             "loop_and_save_s": total_s, "save_and_export_s": total_s - sum(step_s),
             "last_metrics": last}
    log(f"train main path: {json.dumps(stats)}")
    expected = (10 * steps,) * 3
    if launches != expected:
        raise AssertionError(f"train main path launched (fwd, dQ, dK/dV) {launches}, "
                             f"expected {expected}")
    if len(losses) != steps or not all(np.isfinite(losses)) or len(rows) != steps:
        raise AssertionError(f"train main path: losses {losses}, {len(rows)} metric rows")
    if not (run / "checkpoints" / str(steps) / "state.pt").exists():
        raise AssertionError("train main path wrote no checkpoint")
    models, _, mcfg = load_checkpoint_models(run / "checkpoint", "cuda")
    if mcfg != cfg.model:
        raise AssertionError(f"export's model config {mcfg} differs from {cfg.model}")
    for want, module in ((trainer.state.unet_params, models.unet),
                         (trainer.state.vae_params, models.vae),
                         (trainer.state.text_params, models.text_encoder)):
        loaded = dict(module.named_parameters())
        bad = [k for k, t in want.items() if not torch.equal(t.detach(), loaded[k])]
        if bad or set(want) != set(loaded):
            raise AssertionError(f"export does not load back: {bad[:3]}")
    log("train main path: checkpoint written; HF-layout export loads back through "
        "load_checkpoint_models with every tensor equal")
    return stats


def phase_train_f32_step(steps: int) -> dict:
    """The f32 training mode (mixed_precision="no") at SD-2.1 widths and the
    JAX defaults otherwise (256 px, batch 16): its train step's entry point,
    dcr_tpu_torch.diffusion.train.make_train_step, on seeded random weights
    built on the card and a random batch, ``steps`` steps. Every attention
    kernel runs in f32 (B1 as split TF32): 10 launches of each per step,
    finite losses."""
    import numpy as np

    from dcr_tpu_torch.core.config import TrainConfig
    from dcr_tpu_torch.diffusion import train as T
    from dcr_tpu_torch.sampling.pipeline import build_models

    cfg = TrainConfig(mixed_precision="no")
    models = build_models(cfg.model, "cuda", seed=0)
    params = {name: dict(m.named_parameters()) for name, m in
              (("unet", models.unet), ("text", models.text_encoder), ("vae", models.vae))}
    state = T.init_train_state(cfg, models, unet_params=params["unet"],
                               text_params=params["text"], vae_params=params["vae"])
    step_fn = T.make_train_step(cfg, models)
    rng = np.random.default_rng(4)
    bsz, res = cfg.train_batch_size, cfg.data.resolution
    batch = {"pixel_values": rng.uniform(-1, 1, (bsz, res, res, 3)).astype(np.float32),
             "input_ids": rng.integers(0, cfg.model.text_vocab_size - 1,
                                       (bsz, cfg.model.text_max_length))}
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - start)
    finally:
        launches = read_launches()
    stats = {"steps": steps, "batch": bsz, "step_s": step_s, "losses": losses,
             "peak_bytes": torch.cuda.max_memory_allocated(), "launches_fwd_dq_dkv": launches}
    log(f"f32 train step: {json.dumps(stats)}")
    if launches != (10 * steps,) * 3 or not all(np.isfinite(losses)):
        raise AssertionError(f"f32 train step: launches (fwd, dQ, dK/dV) {launches}, expected "
                             f"{(10 * steps,) * 3}; losses {losses}")
    return stats


def kernel_entry(kind: str, dtype: str, rows: list[dict], cases: tuple[str, ...],
                 launches: dict, tensor_core_instructions: dict) -> dict:
    """One kernel's record for the JSON line, from its phase-3 rows at the
    shapes of its main path (the first is the lead) and its launches on the
    main paths. kind: "fwd" (B1), "dq" (B2) or "dkv" (B3)."""
    key = "" if kind == "fwd" else f"{kind}_"
    by_case = {r["case"]: r for r in rows if r["dtype"] == dtype}

    def err(row):
        e = row["max_abs_err"]
        return e if kind == "fwd" else (e["dq"] if kind == "dq" else max(e["dk"], e["dv"]))

    lead = by_case[cases[0]]
    entry = {
        "name": ("flash_attention_fwd" if kind == "fwd" else f"flash_attention_bwd_{kind}")
        + f"[{dtype}]",
        "route": "cuda",
        "source": "dcr_tpu_torch/csrc/" + ("flash_attention_fwd.cu" if kind == "fwd"
                                           else "flash_attention_bwd.cu"),
        "replaces": "dcr_tpu/ops/flash_attention.py:" + {"fwd": "112", "dq": "181",
                                                         "dkv": "209"}[kind],
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(err(by_case[c]) for c in cases),
        "ms": lead[f"{key}ms"], "plain_ms": lead["plain_ms"], "bound_ms": lead[f"{key}bound_ms"],
        "bound_by": lead[f"{key}bound_by"], "library_ms": lead["library_ms"],
        "pct_of_bound": lead[f"{key}pct_of_bound"],
        "shape": "B={} Sq={} Sk={} H={} D={} {}".format(*lead["shape"], dtype),
        "main_path_shapes": {c: {"shape": by_case[c]["shape"], "ms": by_case[c][f"{key}ms"],
                                 "bound_ms": by_case[c][f"{key}bound_ms"],
                                 "pct_of_bound": by_case[c][f"{key}pct_of_bound"],
                                 "library_ms": by_case[c]["library_ms"]} for c in cases},
        "tensor_core_instructions": tensor_core_instructions,
    }
    if kind != "fwd":
        entry["library_call_ms"] = lead["library_call_ms"]
        entry["plain_and_library_compute"] = (
            "dq, dk and dv together (the backward of one attention); library_ms is SDPA's "
            "backward on the device (forward and backward in one CUDA graph, less the "
            "forward); library_call_ms is one autograd.grad call, host included")
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    import dcr_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_card()
    built = phase_build()
    kern = phase_kernels(reps=10)
    bwd = phase_bwd_kernels(reps=10)
    phase_small_reference()
    small_train = phase_small_train_reference()
    with tempfile.TemporaryDirectory() as tmp:
        main_stats = phase_main_path(Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_stats = phase_train_main_path(Path(tmp), steps=6)
    torch.cuda.empty_cache()
    f32_train_stats = phase_train_f32_step(steps=2)

    def fwd_row(case, dtype):
        return next(r for r in kern["rows"] if r["case"] == case and r["dtype"] == dtype)

    def bwd_row(case, dtype):
        return next(r for r in bwd["rows"] if r["case"] == case and r["dtype"] == dtype)

    # the kernels' share of a train step, from this run's kernel times at the
    # train shapes: 5 attentions at level 0 and 5 at level 1 per step
    kernel_ms = sum(5 * (fwd_row(c, "bfloat16")["ms"] + bwd_row(c, "bfloat16")["dq_ms"]
                         + bwd_row(c, "bfloat16")["dkv_ms"])
                    for c in ("train_level0", "train_level1"))
    train_stats["kernel_ms_per_step"] = kernel_ms
    train_stats["kernel_share_of_step"] = kernel_ms / 1e3 / train_stats[
        "median_step_s_after_first"]
    # and B1's share of a UNet call in sampling: 5 attentions at each level
    main_stats["b1_ms_per_unet_call"] = sum(5 * fwd_row(c, "float32")["ms"]
                                            for c in ("level0", "level1", "level2"))

    def tensor_cores(kernel):
        """{instantiation: HMMA/HGMMA count} of a kernel's symbols"""
        return {name: k["tensor_core_instructions"] for name, k in built.items()
                if kernel + "<" in name or kernel in k["symbol"]}

    # launches by main path: sampling is f32, the default training path
    # bf16, the f32 training mode f32
    train = dict(zip(("fwd", "dq", "dkv"), train_stats["launches_fwd_dq_dkv"]))
    f32_train = dict(zip(("fwd", "dq", "dkv"), f32_train_stats["launches_fwd_dq_dkv"]))
    sample_cases, train_cases = ("level0", "level1", "level2"), ("train_level0", "train_level1")
    entries = [
        kernel_entry("fwd", "float32", kern["rows"], sample_cases,
                     {"sample": main_stats["launches"], "train_f32": f32_train["fwd"]},
                     tensor_cores("flash_fwd_tf32x3_kernel")),
        kernel_entry("fwd", "bfloat16", kern["rows"], train_cases, {"train": train["fwd"]},
                     tensor_cores("flash_fwd_bf16_kernel")),
    ]
    for kind in ("dq", "dkv"):
        entries += [
            kernel_entry(kind, "float32", bwd["rows"], train_cases,
                         {"train_f32": f32_train[kind]}, tensor_cores(f"flash_bwd_{kind}_kernel")),
            kernel_entry(kind, "bfloat16", bwd["rows"], train_cases, {"train": train[kind]},
                         tensor_cores(f"flash_bwd_{kind}_bf16_kernel")),
        ]
    entries[0]["per_shape"] = kern["rows"]
    entries[2]["per_shape"] = bwd["rows"]
    log(f"main path stats: {json.dumps(main_stats)}")
    log(f"train path stats: {json.dumps(train_stats)}")
    log(f"f32 train step stats: {json.dumps(f32_train_stats)}")
    log(f"small train reference: {json.dumps(small_train)}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
