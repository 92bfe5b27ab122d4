"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit code:
1. card: name and power limit from nvidia-smi; TF32 off for matmuls and convs;
2. build: every kernel source in dcr_tpu_torch/csrc (one nvcc each) and the
   JPEG codec's host sources in dcr_tpu_torch/native (one g++ each), all at once;
   each kernel in two instantiations, without and with the chunk base of a
   B*H above the grid's limit); per kernel symbol, its registers and spill
   bytes (ptxas) and its count of
   tensor-core instructions (HMMA/HGMMA in cuobjdump's SASS); the kernels of
   TENSOR_CORE_KERNELS (every kernel: bf16 products in bf16, split TF32 in
   f32) must have tensor-core instructions, and no spills at D=64;
2b. JPEG codec: every committed fixture of tests/fixtures/jpeg decoded to
   PIL's pixels (its PNG) within 1 level, CMYK refused, truncated data
   refused; the encoder's sizes within 0.5 % of PIL's and its files
   decoding to PIL's pixels; decode rates (500x375 full scale, 1024x768 at
   the scale that covers 256; 1 and 8 threads) and the encode time;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and a few edge shapes, in f32 and bf16 (bf16
   against the plain version in bf16, which rounds where the kernels round),
   with times, the plain version's and the library call's time, the bound
   and the share of it reached, and for f32 the kernel's and the plain
   version's errors against f64: the forward kernel (B1), then the dQ (B2)
   and dK/dV (B3) backward kernels, which must also give bit-identical
   gradients over two launches, with the pair's time beside SDPA's
   backward; a gradient probe through the autograd Function;
4. small references: a kernel-shaped tiny sampler, and 2 train steps of a
   kernel-shaped tiny model, on the card against the same on the CPU (plain
   attention), from the same x_T / weights and draws;
5. sampling main path: dcr_tpu_torch.sampling.pipeline.generate at SD-2.1
   widths (ModelConfig()), 512 px, 20 DPM-Solver++ steps with CFG, 2
   prompts x 2 images, seeded random weights built on the card; the forward
   kernel's launch count must be 15 per UNet call;
5b. checkpoint interop: phase 5's weights through export_hf_layout
   (params.npz + diffusers/transformers safetensors), made a genuine
   diffusers directory (no params.npz, no model_config), loaded back by
   load_checkpoint_models on the card bit for bit; one sampler call from
   it equals phase 5's first call bit for bit, with 300 forward launches;
   bytes written, export and load seconds, load GB/s, peak memory;
5c. fast sampling: phase 5 with fast.enabled (reuse 0.5, order 2): 15
   forward launches per UNet call of the plan, images finite in [0, 1];
   seconds per call beside phase 5's, max |diff| to its images (reported);
6. training main path: dcr_tpu_torch.diffusion.trainer.Trainer(TrainConfig())
   (SD-2.1 widths, 256 px, batch 16, bf16, AdamW with warmup) on a
   class-folder of 48 JPEGs at 500x375 written by the port's encoder
   (decoded at the 6/8 scale that covers 256, each decode timed), seeded
   random weights, a few optimizer steps; 10 launches of each kernel per step, finite losses, a checkpoint
   and an HF-layout export that loads back; dcr-train's sample hook at
   save_steps=3 writes grids at syncs 3 and 6 (read back with the port's
   PNG reader, image_grid's size), 200 forward launches per grid, counted
   apart from the steps' launches and times;
7. the f32 training mode: 2 steps of the train step (make_train_step) at
   SD-2.1 widths with mixed_precision="no"; 10 launches of each kernel per
   step, all in f32, finite losses;
8. kernel limits (after phase 3): B*H = 66560, above the grid's y limit,
   with a misaligned q, forward and backward through the dispatcher and the
   autograd Function in both dtypes, against the plain versions;
9. small eval reference (after phase 4): the port's run_eval on the card
   and on the CPU over one tiny folder, every scalar within 1e-4;
9b. small dino eval reference: the dino run_eval (ViT-S/16, its layer 2
   with splitloss, XCiT-S/16) on the card and on the CPU, within 1e-4;
10. eval main path: run_eval at the JAX defaults (SSCD at 224, the
   complexity stage, FID, precision/recall, CLIP score, galleries) on 256
   generations at 512 px (16 of them copies of training files) and 512
   training JPEGs at 256 px; scalars finite, the copies found, the
   artifacts written; stage seconds, SSCD images/s and ms per batch, host
   decode against device time, peak memory;
11. backbones (last): one run_eval each with dino_vitb8, dino_xcit_small_12_p16,
   dino_resnet50 and the CLIP image tower at full width over 500x375 JPEGs;
   device ms per batch of 64, images/s, peak memory.
No kernel lies on the eval paths (9-11: their attention is SDPA's, XCiT's
is over channels): their launch counts must stay 0.
Each main path runs with every launch count set to 0 just before it and
read just after (the hook's launches are read around each hook call). The last line is {"ok": true, "device": {...}}; the line
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


# kernels that must run on the tensor cores: B1, B2 and B3 in both dtypes
TENSOR_CORE_KERNELS = ("flash_fwd_bf16_kernel", "flash_fwd_tf32x3_kernel",
                       "flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
                       "flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel")


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
    """Builds both kernel sources and the JPEG codec's two host sources at
    once; prints, per kernel symbol, registers,
    spill bytes and tensor-core instruction count; raises if a kernel of
    TENSOR_CORE_KERNELS is missing, or has an instantiation with no
    tensor-core instruction or that spills at D=64."""
    from dcr_tpu_torch.native import jpeg_decoder, jpeg_helper
    from dcr_tpu_torch.ops import build
    from dcr_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    sources = [fa.SOURCE, fa.BWD_SOURCE]
    host = [jpeg_decoder.SOURCE, jpeg_helper.SOURCE]
    logs = build.build(sources + host)
    log(f"build: {len(sources)} kernel source(s) with {build.nvcc_path()} and "
        f"{len(host)} host source(s) (the JPEG codec) with {build.host_compiler()}, "
        f"all at once, in {time.perf_counter() - t0:.2f} s")
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


def _photo(seed: int, h: int, w: int):
    """A seeded photo-like uint8 [h, w, 3]: gradients, a pattern, noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([x * 255 / w, y * 255 / h,
                     128 + 90 * np.sin((x + 2 * y) / (7 + seed % 5))], axis=-1)
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def phase_jpeg_codec() -> dict:
    """The port's host JPEG codec (dcr_tpu_torch/native, built in phase 2).
    Held: every decodable fixture of tests/fixtures/jpeg equals its PNG
    (PIL's pixels) within 1 level, the refused one (CMYK) raises
    NotPortedError, truncated data raises ValueError; every size in the
    manifest within 0.5 % of PIL's, and the port's encode then decode of
    each input within 1 level of PIL's decode of its own file. Rates (host, wall clock): decode of 500x375
    at full scale and of 1024x768 at the scale that covers 256, on one
    thread and on 8; encode of 224x224 at quality 95."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from dcr_tpu_torch.core.config import NotPortedError
    from dcr_tpu_torch.native import jpeg_decoder as D
    from dcr_tpu_torch.native import jpeg_helper as H
    from dcr_tpu_torch.sampling.png import read_png

    fx = Path(__file__).resolve().parent / "tests" / "fixtures" / "jpeg"
    manifest = json.loads((fx / "manifest.json").read_text())
    fixture_err = {}
    for name, png in manifest["decoded"].items():
        ours, ref = D.decode((fx / name).read_bytes(), name=name), read_png(fx / png)
        fixture_err[name] = (int(np.abs(ours.astype(int) - ref).max())
                             if ours.shape == ref.shape else None)
    refused = {}
    for name in manifest["refused"]:
        try:
            D.decode((fx / name).read_bytes(), name=name)
            refused[name] = "decoded"
        except NotPortedError as e:
            refused[name] = str(e)
    data = (fx / "baseline_420_q50.jpg").read_bytes()
    try:
        D.decode(data[:len(data) // 2], name="truncated.jpg")
        truncated = "decoded"
    except ValueError as e:
        truncated = str(e)
    sizes = []
    for e in manifest["sizes"]:
        jpg = H.encode(read_png(fx / e["input"]), e["quality"])
        back = D.decode(jpg).astype(int) - read_png(fx / e["pil_decoded"])
        sizes.append({**e, "port_bytes": len(jpg), "round_trip_max_abs_err": int(np.abs(back).max())})

    def rate(blobs, min_side, threads):
        fn = (lambda b: D.decode_scaled(b, min_side))
        fn(blobs[0])
        t0 = time.perf_counter()
        if threads == 1:
            out = [fn(b) for b in blobs]
        else:
            with ThreadPoolExecutor(threads) as ex:
                out = list(ex.map(fn, blobs))
        dt = time.perf_counter() - t0
        return {"images": len(blobs), "threads": threads, "out_shape": list(out[0].shape),
                "ms_per_image": 1e3 * dt / len(blobs),
                "source_mpx_per_s": len(blobs) * float(np.prod(D.sof_dims(blobs[0]))) / dt / 1e6}

    small = [H.encode(_photo(i, 375, 500), 90) for i in range(8)]
    large = [H.encode(_photo(i, 768, 1024), 90) for i in range(8)]
    rates = {"500x375_full_1thread": rate(small * 5, 0, 1),
             "500x375_full_8threads": rate(small * 40, 0, 8),
             "1024x768_cover256_1thread": rate(large * 3, 256, 1),
             "1024x768_cover256_8threads": rate(large * 24, 256, 8)}
    tile = _photo(1, 224, 224)
    H.encoded_size(tile, 95)
    t0 = time.perf_counter()
    for _ in range(50):
        H.encode(tile, 95)
    encode_ms = 1e3 * (time.perf_counter() - t0) / 50
    stats = {"fixture_max_abs_err": fixture_err, "refused": refused, "truncated": truncated,
             "sizes": sizes, "sizes_byte_equal": sum(e["port_bytes"] == e["pil_bytes"]
                                                      for e in sizes),
             "decode": rates, "encode_224_q95_ms": encode_ms}
    log(f"jpeg codec: {json.dumps(stats)}")
    log("jpeg codec: decode " + ", ".join(
        f"{k} {v['ms_per_image']:.3f} ms/image {v['source_mpx_per_s']:.1f} Mpx/s"
        for k, v in rates.items()) + f"; encode 224x224 q95 {encode_ms:.3f} ms")
    bad = [k for k, e in fixture_err.items() if e is None or e > 1]
    bad_sizes = [e for e in sizes if abs(e["port_bytes"] - e["pil_bytes"]) > 0.005 * e["pil_bytes"]
                 or e["round_trip_max_abs_err"] > 1]
    if (bad or bad_sizes or any(v == "decoded" for v in refused.values())
            or "truncated" not in truncated
            or rates["1024x768_cover256_1thread"]["out_shape"] != [288, 384, 3]):
        raise AssertionError(f"jpeg codec failed: fixtures {bad}, sizes or round trips "
                             f"{bad_sizes}, refused {refused}, truncated {truncated!r}")
    return stats


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
        # dcr-train's sample hook: 1 prompt x 4 images with CFG at 256 px
        ("hook_level0", 8, 1024, 1024, 5, 64, 1.0, True),
        ("hook_level1", 8, 256, 256, 10, 64, 1.0, True),
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


def bwd_f64(q, k, v, o, lse, do) -> tuple:
    """(dq, dk, dv) in f64 from the same o and lse the kernels take: the
    plain version's formula without its f32 roundings."""
    b, sq, h, d = q.shape
    q, k, v, o, do = (x.double() for x in (q, k, v, o, do))
    scale = 1.0 / d ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - lse.double().reshape(b, h, sq)[..., None])
    del s
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v)
              - (do * o).sum(-1).permute(0, 2, 1)[..., None])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, do))


def phase_bwd_kernels(reps: int) -> dict:
    """The dQ (B2) and dK/dV (B3) kernels against flash_attention_bwd_reference
    on the same inputs (the forward kernel's o and lse), bit-identical over two
    launches, with times; for f32 the kernels' and the plain version's
    errors against f64 (bwd_f64), printed, not held. library_ms is the
    backward alone of
    F.scaled_dot_product_attention on the same q, k, v and dO, on the device
    (its forward and backward in one CUDA graph, less its forward alone);
    library_call_ms is one torch.autograd.grad call, host included. It
    computes dq, dk and dv, so it stands beside the pair of kernels
    (pair_ms = dq_ms + dkv_ms)."""
    import torch.nn.functional as F

    from dcr_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # (name, B, Sq, Sk, H, D, logit scale, train main-path shape)
    cases = [
        ("train_level0", 16, 1024, 1024, 5, 64, 1.0, True),
        ("train_level1", 16, 256, 256, 10, 64, 1.0, True),
        # dcr-train's sample hook: 1 prompt x 4 images with CFG at 256 px
        ("hook_level0", 8, 1024, 1024, 5, 64, 1.0, True),
        ("hook_level1", 8, 256, 256, 10, 64, 1.0, True),
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
            f64 = None
            if dtype is torch.float32:
                with torch.no_grad():
                    exact = bwd_f64(q, k, v, o, lse, do)
                    f64 = {side: {n: (g.double() - e).abs().max().item()
                                  for n, g, e in zip(("dq", "dk", "dv"), grads, exact)}
                           for side, grads in (("kernel", (dq, dk, dv)), ("plain", ref))}
                del exact
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
                       dkv_pct_of_bound=100.0 * b_dkv / ms_dkv, pair_ms=ms_dq + ms_dkv,
                       pair_over_library=(ms_dq + ms_dkv) / lib_ms, max_abs_err_vs_f64=f64)
            rows.append(row)
            log(f"flash bwd {name:12s} {row['dtype']:8s} B={b} Sq={sq} Sk={sk} H={h} D={d}: "
                f"dQ {ms_dq:.4f} ms (bound {b_dq:.4f}, {by_dq}, "
                f"{row['dq_pct_of_bound']:.1f} %; {call_dq:.4f} per call), dK/dV "
                f"{ms_dkv:.4f} ms (bound {b_dkv:.4f}, {by_dkv}, "
                f"{row['dkv_pct_of_bound']:.1f} %; {call_dkv:.4f} per call), pair "
                f"{row['pair_ms']:.4f} ms ({row['pair_over_library']:.2f}x sdpa bwd), plain "
                f"{plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms ({lib_call_ms:.4f} per "
                f"autograd.grad call), max err dq/dk/dv "
                f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
                f"{tols[0]:.3e}/{tols[1]:.3e}/{tols[2]:.3e}), bit-identical {same}"
                + "".join(f", max|{side}-f64| dq/dk/dv "
                          + "/".join(f"{e[n]:.3e}" for n in ("dq", "dk", "dv"))
                          for side, e in (f64 or {}).items()))
            if not (same and finite and all(e <= t for e, t in zip(errs, tols))):
                raise AssertionError(f"flash backward kernels disagree with their plain "
                                     f"version at {name} {dtype}: errs {errs}, tols {tols}, "
                                     f"bit-identical {same}, finite {finite}")
    return {"rows": rows}


def phase_kernel_limits() -> dict:
    """Inputs past the kernels' own limits, which ``supported`` admits: B*H =
    66560 (above the grid's y limit of 65535: two chunks per launch) with a
    q whose seq stride is H*D + 1 elements (2 bytes off a 16-byte multiple
    in bf16), forward and backward through ops/attention's dispatcher and
    the autograd Function, in bf16 and f32. Held: one launch of each kernel
    per call, and the plain versions' bounds of phase 3 (forward: bf16
    2^-6 max(1, max|ref|), f32 2e-5; backward against the plain version on
    the kernel's o and lse: bf16 the same share, f32 1e-5 max(1, max|ref|))."""
    from dcr_tpu_torch.ops import attention as A
    from dcr_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    b, s, h, d = 1024, 128, 65, 64
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(11)
        qbuf = torch.randn((b, s, h * d + 1), generator=gen, device=dev).to(dtype)
        q = qbuf[:, :, 1:].unflatten(-1, (h, d))
        k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
                    for _ in range(3))
        if fa._strided_ok(q) or not fa.supported(q, k, v):
            raise AssertionError("kernel limits: q should be misaligned and supported")
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        before = read_launches()
        o = A.dot_product_attention(qg, kg, vg)
        grads = torch.autograd.grad(o, (qg, kg, vg), do)
        torch.cuda.synchronize()
        launched = tuple(a - c for a, c in zip(read_launches(), before))
        o = o.detach()
        with torch.no_grad():
            # the forward kernel is deterministic: this is the o and lse the
            # autograd Function saved for its backward (launches not counted)
            o_k, lse_k = fa.flash_attention_fwd(q, k, v)
            same_o = torch.equal(o_k, o)
            errs = {"o": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
            refmax = dict.fromkeys(errs, 0.0)
            step = 128   # the plain versions one batch slice at a time (memory)
            for i in range(0, b, step):
                sl = slice(i, i + step)
                ref_o, _ = fa.flash_attention_reference(q[sl], k[sl], v[sl])
                lse_sl = lse_k.view(b, h * s)[sl].reshape(-1, s)
                ref = fa.flash_attention_bwd_reference(q[sl], k[sl], v[sl], o_k[sl], lse_sl,
                                                       do[sl])
                for name, got, want in zip(errs, (o[sl], *(g[sl] for g in grads)),
                                           (ref_o, *ref)):
                    errs[name] = max(errs[name], (got.float() - want.float()).abs().max().item())
                    refmax[name] = max(refmax[name], want.float().abs().max().item())
                del ref_o, ref
        if dtype is torch.bfloat16:
            tols = {n: BF16_TOL * max(1.0, m) for n, m in refmax.items()}
        else:
            tols = {n: (2e-5 if n == "o" else 1e-5 * max(1.0, m)) for n, m in refmax.items()}
        key = str(dtype).split(".")[-1]
        out[key] = {"shape": [b, s, s, h, d], "launches_fwd_dq_dkv": launched,
                    "chunks": fa.grid_chunks(b * h), "q_strides": list(q.stride()),
                    "max_abs_err": errs, "tol": tols, "o_equals_raw_launch": same_o}
        log(f"kernel limits {key}: B={b} S={s} H={h} D={d} (B*H={b * h}, chunks "
            f"{fa.grid_chunks(b * h)}), q strides {tuple(q.stride())}: launches (fwd, dQ, "
            f"dK/dV) {launched}, max err o/dq/dk/dv "
            + "/".join(f"{errs[n]:.3e}" for n in errs) + " (tol "
            + "/".join(f"{tols[n]:.3e}" for n in tols) + ")")
        if not (launched == (1, 1, 1) and same_o and all(errs[n] <= tols[n] for n in errs)):
            raise AssertionError(f"kernel limits failed in {key}: {out[key]}")
        del qbuf, q, k, v, do, qg, kg, vg, o, grads, o_k, lse_k
        torch.cuda.empty_cache()
    return out


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


def _timed_generate(cfg, models, params=None) -> dict:
    """dcr_tpu_torch.sampling.pipeline.generate with the sampler's calls
    timed (host clock around each call, synchronised) and their images
    kept; the launch counts are set to 0 just before and read just after."""
    from dcr_tpu_torch.sampling import pipeline as P

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
        timed.unet_calls = fn.unet_calls
        return timed

    P.make_sampler = timed_make_sampler
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        out = P.generate(cfg, modelstyle="nolevel", models=models, params=params,
                         device="cuda")
    finally:
        launches = read_launches()
        P.make_sampler = make
    return {"calls": calls, "images": torch.cat(images), "launches": launches,
            "peak": torch.cuda.max_memory_allocated(),
            "pngs": sorted((out / "generations").glob("*.png"))}


def _check_images(imgs: torch.Tensor, what: str) -> None:
    if not (torch.isfinite(imgs).all() and imgs.min() >= 0.0 and imgs.max() <= 1.0):
        raise AssertionError(f"{what} images are not finite values in [0, 1]")


def phase_main_path(out_dir: Path) -> tuple[dict, dict]:
    """Phase 5; returns its stats and what the phases after it reuse: the
    models (on the card), their state dicts and the images."""
    import numpy as np

    from dcr_tpu_torch.core.config import ModelConfig, SampleConfig
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

    steps = 20
    cfg = SampleConfig(resolution=512, num_inference_steps=steps, sampler="dpm++",
                       guidance_scale=7.5, num_batches=2, im_batch=2, seed=0,
                       savepath=str(out_dir))
    run = _timed_generate(cfg, models, params)
    calls, imgs, (launches, *bwd_launches) = run["calls"], run["images"], run["launches"]
    expected = 15 * steps * len(calls)
    log(f"main path: {len(calls)} sampler calls, {[f'{c:.3f}' for c in calls]} s each, "
        f"{statistics.mean(calls) / steps:.4f} s per step (2x2 CFG batch), "
        f"peak memory {run['peak'] / 2**30:.2f} GiB, {len(run['pngs'])} PNGs, flash launches "
        f"{launches} (expected {expected})")
    if len(run["pngs"]) != 4 or imgs.shape != (4, 512, 512, 3):
        raise AssertionError(f"expected 4 PNGs of 512x512, got {len(run['pngs'])}, "
                             f"{tuple(imgs.shape)}")
    _check_images(imgs, "main path")
    if len(calls) != 2 or launches != expected or bwd_launches != [0, 0]:
        raise AssertionError(f"flash kernel launched {launches} times, expected {expected} "
                             f"(backward kernels {bwd_launches}, expected none)")
    stats = {"launches": launches, "sampler_call_s": calls,
             "step_s": statistics.mean(calls) / steps, "peak_bytes": run["peak"],
             "image_std": float(np.std(imgs.numpy()))}
    return stats, {"models": models, "params": params, "model_cfg": model_cfg,
                   "sample_cfg": cfg, "images": imgs}


def phase_checkpoint_interop(root: Path, main: dict) -> dict:
    """Phase 5's weights through the port's export_hf_layout (params.npz and
    the diffusers/transformers safetensors), made genuine (params.npz and
    model_index.json's model_config deleted, as tests/test_export.py does),
    loaded back with load_checkpoint_models on the card: every tensor equal
    to its source bit for bit. Before that, the export loads once through
    params.npz alone (safetensors set aside), so both load paths are timed.
    Then one sampler call of phase 5's seed and
    batch from the loaded models, whose images must equal phase 5's first
    call bit for bit, with 15 x 20 forward launches."""
    import dataclasses

    from dcr_tpu_torch.core.checkpoint import export_hf_layout
    from dcr_tpu_torch.sampling import pipeline as P

    mc, params = main["model_cfg"], main["params"]
    ckpt = root / "sd21"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    export_hf_layout(ckpt, unet=params["unet"], vae=params["vae"],
                     text_encoder=params["text"],
                     scheduler_config={"num_train_timesteps": mc.num_train_timesteps,
                                       "beta_schedule": mc.beta_schedule,
                                       "beta_start": mc.beta_start, "beta_end": mc.beta_end,
                                       "prediction_type": mc.prediction_type},
                     model_config=dataclasses.asdict(mc))
    export_s = time.perf_counter() - t0
    written = {str(f.relative_to(ckpt)): f.stat().st_size for f in ckpt.rglob("*")
               if f.is_file()}
    npz_bytes = sum(f.stat().st_size for f in ckpt.rglob("params.npz"))
    weight_bytes = sum(f.stat().st_size for f in ckpt.rglob("*.safetensors"))

    def timed_load(what):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models, _, lcfg = P.load_checkpoint_models(ckpt, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        bad = []
        for name, module in (("unet", models.unet), ("vae", models.vae),
                             ("text", models.text_encoder)):
            got = module.state_dict()
            bad += [f"{name}/{k}" for k, t in params[name].items()
                    if k not in got or got[k].dtype != t.dtype or not torch.equal(got[k], t)]
            bad += [f"{name}/{k} (extra)" for k in set(got) - set(params[name])]
        if bad:
            raise AssertionError(f"{what} does not load back bit for bit: {bad[:5]}")
        return models, lcfg, load_s

    # the params.npz path alone: the safetensors set aside for one load
    weights = sorted(ckpt.rglob("*.safetensors"))
    for f in weights:
        f.rename(f.with_name(f.name + ".aside"))
    models, _, npz_load_s = timed_load("the export through params.npz")
    del models
    for f in weights:
        f.with_name(f.name + ".aside").rename(f)
    # genuine: no params.npz, no native model_config
    for comp in ("unet", "vae", "text_encoder"):
        (ckpt / comp / "params.npz").unlink()
    index = json.loads((ckpt / "model_index.json").read_text())
    del index["model_config"]
    (ckpt / "model_index.json").write_text(json.dumps(index))
    models, lcfg, load_s = timed_load("the genuine checkpoint")
    scfg = dataclasses.replace(main["sample_cfg"], num_batches=1,
                               savepath=str(root / "genuine_out"))
    run = _timed_generate(scfg, models)
    imgs, first = run["images"], main["images"][:2]
    stats = {"bytes_written": sum(written.values()), "files": written,
             "safetensors_bytes": weight_bytes, "export_s": export_s, "load_s": load_s,
             "load_gb_per_s": weight_bytes / load_s / 1e9,
             "npz_bytes": npz_bytes, "npz_load_s": npz_load_s,
             "npz_load_gb_per_s": npz_bytes / npz_load_s / 1e9,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "sampler_call_s": run["calls"], "launches": run["launches"][0],
             "max_abs_diff_to_phase5": (imgs - first).abs().max().item(),
             "model_config_differs": [f.name for f in dataclasses.fields(mc)
                                      if getattr(mc, f.name) != getattr(lcfg, f.name)]}
    log(f"checkpoint interop (SD-2.1 widths): {json.dumps(stats)}")
    if run["launches"] != (15 * 20, 0, 0) or len(run["calls"]) != 1:
        raise AssertionError(f"genuine checkpoint sampling launched {run['launches']} "
                             f"in {len(run['calls'])} calls, expected (300, 0, 0) in 1")
    if not torch.equal(imgs, first):
        raise AssertionError(f"genuine checkpoint images differ from phase 5's first call: "
                             f"max|diff| {stats['max_abs_diff_to_phase5']:.3e}")
    del models
    return stats


def phase_fast_sampling(out_dir: Path, main: dict, main_stats: dict) -> dict:
    """Phase 5 again with score reuse: fast.enabled, reuse_ratio 0.5, order
    2, dpm++, 20 steps, same prompts, seed and weights. Forward launches
    15 x unet_calls(plan) per sampler call; images finite in [0, 1]; their
    max |diff| to phase 5's is reported, not bounded."""
    import dataclasses

    from dcr_tpu_torch.core.config import FastSampleConfig
    from dcr_tpu_torch.sampling import fastsample

    cfg = dataclasses.replace(main["sample_cfg"], savepath=str(out_dir),
                              fast=FastSampleConfig(enabled=True, reuse_ratio=0.5, order=2))
    plan = fastsample.fast_plan(cfg.num_inference_steps, cfg.fast.reuse_ratio)
    run = _timed_generate(cfg, main["models"])
    calls, imgs = run["calls"], run["images"]
    expected = 15 * fastsample.unet_calls(plan) * len(calls)
    stats = {"plan": "".join("F" if f else "r" for f in plan),
             "unet_calls": fastsample.unet_calls(plan), "sampler_call_s": calls,
             "dense_sampler_call_s": main_stats["sampler_call_s"],
             "speedup_per_call": statistics.mean(main_stats["sampler_call_s"])
             / statistics.mean(calls),
             "launches": run["launches"][0], "peak_bytes": run["peak"],
             "max_abs_diff_to_dense": (imgs - main["images"]).abs().max().item()}
    log(f"fast sampling (reuse 0.5, order 2): {json.dumps(stats)}")
    _check_images(imgs, "fast sampling")
    if len(calls) != 2 or run["launches"] != (expected, 0, 0):
        raise AssertionError(f"fast sampling launched {run['launches']} in {len(calls)} "
                             f"calls, expected ({expected}, 0, 0) in 2")
    return stats


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
    class-folder of 48 JPEGs at 500x375 (Imagenette's common size) that the
    port's encoder writes, HashTokenizer, seeded random weights built on
    the card, ``steps`` optimizer steps, with dcr-train's sample hook at
    save_steps=3 (grids at syncs 3 and 6; its launches and seconds counted
    apart from the steps'). The loader's JPEG decodes (at the 6/8 scale that
    covers 256) are timed one by one on its worker threads."""
    import shutil

    import numpy as np

    from dcr_tpu_torch.core.config import TrainConfig
    from dcr_tpu_torch.data import dataset as DS
    from dcr_tpu_torch.diffusion.sample_hook import make_sample_hook
    from dcr_tpu_torch.diffusion.trainer import Trainer
    from dcr_tpu_torch.eval.gallery import image_grid
    from dcr_tpu_torch.native.jpeg_helper import encode
    from dcr_tpu_torch.sampling.pipeline import load_checkpoint_models
    from dcr_tpu_torch.sampling.png import read_png

    data = out_dir / "data"
    for i in range(48):
        (data / f"class{i % 2}").mkdir(parents=True, exist_ok=True)
        (data / f"class{i % 2}" / f"{i}.jpg").write_bytes(encode(_photo(i, 375, 500), 90))
    decode, decode_s = DS.decode_image, []

    def timed_decode(path, size=0):
        start = time.perf_counter()
        img = decode(path, size)
        decode_s.append((time.perf_counter() - start, img.shape))
        return img

    free = shutil.disk_usage(out_dir).free
    cfg = TrainConfig(output_dir=str(out_dir / "run"), max_train_steps=steps, log_every=1,
                      modelsavesteps=10 ** 6, checkpoints_total_limit=1, save_steps=3)
    cfg.data.train_data_dir = str(data)
    # the sample hook dcr-train installs; its launches and time are counted
    # apart from the train steps'
    hook, hook_s, hook_launches = make_sample_hook(), [], [0, 0, 0]

    def counted_hook(trainer, sync):
        before = read_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        hook(trainer, sync)
        torch.cuda.synchronize()
        hook_s.append(time.perf_counter() - start)
        for i, (a, b) in enumerate(zip(before, read_launches())):
            hook_launches[i] += b - a

    t0 = time.perf_counter()
    trainer = Trainer(cfg, sample_hook=counted_hook, device="cuda")
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
    DS.decode_image = timed_decode
    reset_launches()
    t0 = time.perf_counter()
    try:
        last = trainer.train()
    finally:
        launches = tuple(a - b for a, b in zip(read_launches(), hook_launches))
        DS.decode_image = decode
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    run = out_dir / "run"
    rows = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    median_s = statistics.median(step_s[1:])
    grids = {n: read_png(run / "generations" / f"step_{n}.png").shape for n in (3, 6)}
    stats = {"steps": steps, "batch": cfg.train_batch_size, "step_s": step_s,
             "median_step_s_after_first": median_s,
             "images_per_s": cfg.train_batch_size / median_s,
             "peak_bytes": peak, "losses": losses, "launches_fwd_dq_dkv": launches,
             "loop_and_save_s": total_s,
             "save_and_export_s": total_s - sum(step_s) - sum(hook_s),
             "hook_s_per_grid": hook_s, "hook_launches_fwd_dq_dkv": tuple(hook_launches),
             "hook_prompts": hook.state["prompts"], "grid_shapes": grids,
             "jpeg_decodes": len(decode_s),
             "jpeg_decoded_shape": list(decode_s[0][1]) if decode_s else None,
             "jpeg_decode_ms_per_image": 1e3 * statistics.mean(t for t, _ in decode_s),
             "jpeg_decode_ms_per_batch": 1e3 * cfg.train_batch_size * statistics.mean(
                 t for t, _ in decode_s),
             "last_metrics": last}
    log(f"train main path: {json.dumps(stats)}")
    log(f"train main path on JPEG data: {len(decode_s)} decodes to "
        f"{stats['jpeg_decoded_shape']}, {stats['jpeg_decode_ms_per_image']:.2f} ms each, "
        f"{stats['jpeg_decode_ms_per_batch']:.1f} ms of decode per batch of "
        f"{cfg.train_batch_size} (on the loader's threads) beside a step median of "
        f"{1e3 * median_s:.1f} ms; peak {peak / 2**30:.2f} GiB")
    expected = (10 * steps,) * 3
    if decode_s and decode_s[0][1] != (282, 375, 3):
        raise AssertionError(f"the loader decoded to {decode_s[0][1]}, expected the 6/8 "
                             "scale of 375x500 (282x375) that covers 256")
    if len(decode_s) < steps * cfg.train_batch_size:
        raise AssertionError(f"the loader decoded {len(decode_s)} JPEGs for {steps} steps")
    if launches != expected:
        raise AssertionError(f"train main path launched (fwd, dQ, dK/dV) {launches}, "
                             f"expected {expected}")
    # the hook: a grid at syncs 3 and 6, each 20 DDIM steps of the f32
    # weights at 256 px, 10 forward launches per UNet call (S = 64 takes SDPA),
    # at phase 3's hook shapes: one prompt x 4 images, B = 8 with CFG
    if len(hook.state["prompts"]) != 1:
        raise AssertionError(f"sample hook prompts {hook.state['prompts']}: phase 3's "
                             f"hook_level cases assume one prompt")
    n_img = len(hook.state["prompts"]) * 4
    layout = image_grid([np.zeros((256, 256, 3), np.float32)] * n_img, cols=4).shape
    if (len(hook_s) != 2 or tuple(hook_launches) != (2 * 10 * 20, 0, 0)
            or any(g != layout for g in grids.values())):
        raise AssertionError(f"sample hook: {len(hook_s)} grids, launches {hook_launches} "
                             f"(expected (400, 0, 0)), grids {grids} (expected {layout})")
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
    kernel runs in f32 (split TF32): 10 launches of each per step, finite
    losses."""
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


class StageLog:
    """Collects the eval runner's ``[stage] <name>: done`` records
    ({stage: seconds}) while installed on the port's logger."""

    def __init__(self):
        import logging

        self.seconds: dict[str, float] = {}
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.logger = logging.getLogger("dcr_tpu_torch")

    def _emit(self, record) -> None:
        if hasattr(record, "stage"):
            self.seconds[record.stage] = record.seconds

    def __enter__(self) -> "StageLog":
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def _write_eval_folders(root: Path, n_gen: int, gen_px: int, n_train: int, train_px,
                        n_copies: int, seed: int, train_jpeg: bool = False
                        ) -> tuple[Path, Path, Path, dict]:
    """Generations (``n_gen`` PNGs, natural order, prompts.txt beside them)
    and training images (two class folders, a caption json), random pixels
    (train_jpeg: seeded photo-like JPEGs of ``train_px`` = (h, w) from the
    port's encoder at quality 90); ``n_copies`` training files copied byte
    for byte into the generations (every ``n_gen // n_copies``-th name, with
    the source's suffix). Returns (generations, train, caption json,
    {generation name: source training path})."""
    import shutil

    import numpy as np

    from dcr_tpu_torch.native.jpeg_helper import encode
    from dcr_tpu_torch.sampling.png import write_png

    rng = np.random.default_rng(seed)
    gen, train = root / "gens" / "generations", root / "train"
    gen.mkdir(parents=True)
    caps, train_paths = {}, []
    for i in range(n_train):
        d = train / f"class{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        if train_jpeg:
            p = d / f"{i}.jpg"
            p.write_bytes(encode(_photo(seed * 1000 + i, *train_px), 90))
        else:
            p = d / f"{i}.png"
            write_png(p, rng.integers(0, 256, (train_px, train_px, 3), dtype=np.uint8))
        caps[str(p)] = [f"class{i % 2} image {i}"]
        train_paths.append(p)
    (root / "caps.json").write_text(json.dumps(caps))
    every = n_gen // n_copies if n_copies else 0
    copies = {}
    for i in range(n_gen):
        name = f"{i}.png"
        if n_copies and i % every == 0 and len(copies) < n_copies:
            src = train_paths[(37 * len(copies) + 5) % n_train]
            name = f"{i}{src.suffix}"
            shutil.copyfile(src, gen / name)
            copies[name] = src
        else:
            write_png(gen / name, rng.integers(0, 256, (gen_px, gen_px, 3), dtype=np.uint8))
    (root / "gens" / "prompts.txt").write_text("".join(f"a prompt number {i}\n"
                                                       for i in range(n_gen // 2)))
    return gen, train, root / "caps.json", copies


# the JAX runner's scalar list (tests/test_eval_runner.py)
EVAL_SCALARS = ("sim_mean", "sim_std", "sim_75pc", "sim_90pc", "sim_95pc", "sim_gt_05pc",
                "bg_mean", "bg_std", "FID_val", "precision", "recall", "gen_clipscore",
                "train_clipscore")
COMPLEXITY_SCALARS = ("corr_entropy_sim", "corr_jpegsize_sim", "corr_tv_sim",
                      "corr_entropy_jpegsize", "mean_entropy", "mean_jpeg_bytes", "mean_tv")


def _has_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def phase_small_eval_reference(root: Path) -> dict:
    """The port's run_eval on the card and on the CPU over one tiny folder (8
    generations, 10 training PNGs at 80 px), SSCD at image_size=64, every
    other default stage on (FID, precision/recall, CLIP score, galleries),
    compute_complexity=false, TF32 off, the same seeded weights. Held:
    every scalar within 1e-4 absolute; the top-1 indices equal wherever the
    CPU's top-1/top-2 margin exceeds 1e-4."""
    import numpy as np

    from dcr_tpu_torch.core.config import EvalConfig
    from dcr_tpu_torch.eval.runner import run_eval

    gen, train, caps, _ = _write_eval_folders(root, 8, 80, 10, 80, 0, seed=7)
    out, sims = {}, {}
    reset_launches()
    for dev in ("cuda", "cpu"):
        cfg = EvalConfig(query_dir=str(gen), values_dir=str(train), image_size=64,
                         batch_size=4, compute_complexity=False, gallery_topk=3,
                         gallery_max_rank=8, output_dir=str(root / f"out_{dev}"))
        out[dev] = run_eval(cfg, device=dev, values_caption_json=str(caps))
        sims[dev] = np.load(root / f"out_{dev}" / "similarity.npy")
    launches = read_launches()
    errs = {k: abs(out["cuda"][k] - out["cpu"][k]) for k in out["cpu"]}
    top2 = np.sort(sims["cpu"], axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 1e-4
    same_top1 = bool(np.array_equal(sims["cuda"].argmax(1)[decided],
                                    sims["cpu"].argmax(1)[decided]))
    stats = {"max_abs_err": max(errs.values()), "errs": errs, "scalars_cpu": out["cpu"],
             "decided_rows": int(decided.sum()), "same_top1": same_top1,
             "launches_fwd_dq_dkv": launches,
             "sim_max_abs_err": float(np.abs(sims["cuda"] - sims["cpu"]).max())}
    log(f"small eval reference (8 gens, 10 train, sscd at 64 px, FID/IPR/CLIP/galleries on): "
        f"card vs cpu {json.dumps(stats)}")
    if (list(out["cuda"]) != list(out["cpu"]) or not all(e <= 1e-4 for e in errs.values())
            or not same_top1 or launches != (0, 0, 0)):
        raise AssertionError(f"small eval reference failed: {stats}")
    return stats


def phase_eval_main_path(root: Path) -> dict:
    """dcr_tpu_torch.eval.runner.run_eval(EvalConfig(...)) at the JAX
    defaults (SSCD ResNet-50 at 224 px, batch 64; the complexity stage; FID
    with Inception at 299; precision/recall with VGG16; CLIP score with
    ViT-B/16; galleries), seeded random weights, on 256 generations at 512 px
    (16 of them training files copied byte for byte) and 512 training JPEGs
    at 256 px (the port's encoder) in two class folders. Checks the scalars,
    the copies' top-1 matches and the artifacts; prints stage seconds, SSCD
    images/s, device ms per SSCD batch of 64, host decode + transform ms per
    batch, the device's busy share during eval/features and peak memory."""
    import numpy as np

    from dcr_tpu_torch.core.config import EvalConfig
    from dcr_tpu_torch.eval import runner as R
    from dcr_tpu_torch.eval.features import EvalImageFolder

    t0 = time.perf_counter()
    gen, train, caps, copies = _write_eval_folders(root, 256, 512, 512, (256, 256), 16, seed=8,
                                                   train_jpeg=True)
    write_s = time.perf_counter() - t0
    # per batch of each extraction: host ms to decode + transform it, device
    # ms from CUDA events around the extractor's call (the batch's upload
    # and forward). run_eval extracts in this order: SSCD over the query and
    # the values (eval/features), then Inception and VGG16 (eval/fid_ipr)
    passes = ("sscd", "sscd", "inception", "inception", "vgg", "vgg")
    batches: list[dict] = []
    calls = []
    extract = R.extract_features

    def timed_extract(folder, extractor, *, batch_size=64):
        backbone = passes[len(calls)]
        calls.append(backbone)
        chunks = []
        it = folder.batches(batch_size)
        while True:
            h0 = time.perf_counter()
            try:
                images, mask = next(it)
            except StopIteration:
                break
            host_s = time.perf_counter() - h0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            feats = extractor(images)
            end.record()
            chunks.append(feats.float().cpu().numpy()[mask])
            batches.append({"backbone": backbone, "n": int(mask.sum()),
                            "host_ms": 1e3 * host_s, "device_ms": start.elapsed_time(end)})
        return np.concatenate(chunks, axis=0)

    cfg = EvalConfig(query_dir=str(gen), values_dir=str(train), output_dir=str(root / "out"))
    R.extract_features = timed_extract
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with StageLog() as stages:
            scalars = R.run_eval(cfg, device="cuda", values_caption_json=str(caps))
    finally:
        R.extract_features = extract
        launches = read_launches()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    out = root / "out"
    sim = np.load(out / "similarity.npy")
    qpaths = EvalImageFolder(gen, 224).paths
    vpaths = [str(p) for p in EvalImageFolder(train, 224).paths]
    copy_rows = []
    for name, src in copies.items():
        qi = next(i for i, p in enumerate(qpaths) if p.name == name)
        copy_rows.append({"gen": name, "source": vpaths.index(str(src)),
                          "top1": int(sim[qi].argmax()), "sim": float(sim[qi].max())})
    sscd = [b for b in batches if b["backbone"] == "sscd"]
    feat_s = stages.seconds["eval/features"]
    # device ms of one SSCD batch of 64 alone: CUDA events around 10 calls
    backbone = R.build_backbone("sscd", cfg.arch, "cuda", seed=0)
    x = torch.randn((64, 3, 224, 224), generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    with torch.inference_mode():
        for _ in range(2):
            backbone(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            backbone(x)
        end.record()
        end.synchronize()
    sscd_batch_ms = start.elapsed_time(end) / 10
    del backbone, x
    stats = {
        "total_s": total_s, "write_data_s": write_s, "stage_s": stages.seconds,
        "extract_calls": calls,
        "sscd_images_per_s": sum(b["n"] for b in sscd) / feat_s,
        "sscd_batch64_device_ms": sscd_batch_ms,
        "features_host_ms_per_batch": statistics.mean(b["host_ms"] for b in sscd),
        "features_device_ms_per_batch": statistics.mean(b["device_ms"] for b in sscd),
        "features_device_busy_share": sum(b["device_ms"] for b in sscd) / 1e3 / feat_s,
        "per_backbone": {name: {"batches": sum(b["backbone"] == name for b in batches),
                                "host_ms_per_batch": statistics.mean(
                                    b["host_ms"] for b in batches if b["backbone"] == name),
                                "device_ms_per_batch": statistics.mean(
                                    b["device_ms"] for b in batches if b["backbone"] == name)}
                         for name in ("sscd", "inception", "vgg")},
        "peak_bytes": peak, "launches_fwd_dq_dkv": launches, "scalars": scalars,
        "copies": copy_rows,
    }
    log(f"eval main path: {json.dumps(stats)}")
    log(f"eval main path: stages (s) " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                 stages.seconds.items())
        + f"; SSCD {stats['sscd_images_per_s']:.1f} images/s, "
        f"{sscd_batch_ms:.2f} device ms per batch of 64 alone; eval/features per batch of "
        f"64: host decode + transform {stats['features_host_ms_per_batch']:.1f} ms, device "
        f"{stats['features_device_ms_per_batch']:.1f} ms, device busy "
        f"{100 * stats['features_device_busy_share']:.1f} % of the stage; peak memory "
        f"{peak / 2**30:.2f} GiB")
    missing = [k for k in EVAL_SCALARS + COMPLEXITY_SCALARS
               if not (k in scalars and np.isfinite(scalars[k]))]
    absent_plots = [n for n in ("scatter_entropy", "scatter_jpegsize", "scatter_tv")
                    if not (out / f"{n}.png").exists()]
    bad_copies = [r for r in copy_rows if r["top1"] != r["source"] or r["sim"] < 0.999]
    artifacts = [out / "similarity.npy", out / "logs" / "metrics.jsonl",
                 out / "fid_stats_values.npz", out / "provenance.json"]
    absent = [str(p) for p in artifacts if not p.exists()]
    if not list((out / "galleries").glob("gallery_rank*.png")):
        absent.append("galleries/gallery_rank*.png")
    if _has_matplotlib():
        absent += absent_plots
    if (missing or bad_copies or absent or sim.shape != (256, 512)
            or scalars["sim_gt_05pc"] < 16 / 256 or len(copy_rows) != 16
            or calls != list(passes)):
        raise AssertionError(f"eval main path failed: scalars missing or not finite "
                             f"{missing}, copies {bad_copies}, artifacts absent {absent}, "
                             f"sim {sim.shape}, sim_gt_05pc {scalars.get('sim_gt_05pc')}")
    return stats


def phase_small_dino_reference(root: Path) -> dict:
    """The dino run_eval on the card and on the CPU over one tiny folder (8
    generations, 10 training PNGs at 80 px) at image_size=64, beside phase
    9's: the ViT-S/16 (CLS), its layer 2 with splitloss (every token), and
    XCiT-S/16; the other stages off, TF32 off, the same seeded weights.
    Held: every scalar within 1e-4, the top-1 indices equal where the CPU's
    margin exceeds 1e-4, no flash launch."""
    import numpy as np

    from dcr_tpu_torch.core.config import EvalConfig
    from dcr_tpu_torch.eval.runner import run_eval

    gen, train, _, _ = _write_eval_folders(root, 8, 80, 10, 80, 0, seed=9)
    runs = {"dino_vits16": {}, "dino_vits16_layer2_splitloss":
            {"layer": 2, "similarity_metric": "splitloss"}, "dino_xcit_small_12_p16": {}}
    stats, bad = {}, []
    for name, extra in runs.items():
        arch = name if name.startswith("dino_xcit") else "dino_vits16"
        out, sims = {}, {}
        reset_launches()
        for dev in ("cuda", "cpu"):
            cfg = EvalConfig(query_dir=str(gen), values_dir=str(train), pt_style="dino",
                             arch=arch, image_size=64, batch_size=4, compute_fid=False,
                             compute_clip_score=False, compute_complexity=False,
                             galleries=False, output_dir=str(root / f"{name}_{dev}"), **extra)
            out[dev] = run_eval(cfg, device=dev)
            sims[dev] = np.load(root / f"{name}_{dev}" / "similarity.npy")
        launches = read_launches()
        errs = {k: abs(out["cuda"][k] - out["cpu"][k]) for k in out["cpu"]}
        top2 = np.sort(sims["cpu"], axis=1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 1e-4
        same = bool(np.array_equal(sims["cuda"].argmax(1)[decided],
                                   sims["cpu"].argmax(1)[decided]))
        stats[name] = {"max_abs_err": max(errs.values()), "decided_rows": int(decided.sum()),
                       "same_top1": same, "launches_fwd_dq_dkv": launches,
                       "sim_max_abs_err": float(np.abs(sims["cuda"] - sims["cpu"]).max())}
        if (list(out["cuda"]) != list(out["cpu"]) or stats[name]["max_abs_err"] > 1e-4
                or not same or launches != (0, 0, 0)):
            bad.append(name)
    log(f"small dino eval reference (8 gens, 10 train, 64 px): card vs cpu {json.dumps(stats)}")
    if bad:
        raise AssertionError(f"small dino eval reference failed for {bad}: {stats}")
    return stats


# the retrieval backbones beyond SSCD, at full width: (pt_style, arch)
BACKBONES = (("dino", "dino_vitb8"), ("dino", "dino_xcit_small_12_p16"),
             ("dino", "dino_resnet50"), ("clip", "resnet50_disc"))


def phase_backbones(root: Path) -> dict:
    """One run_eval per backbone of BACKBONES at the published widths
    (ViT-B/8 at 224 px: 785 tokens; XCiT-S/16; the DINO ResNet-50; the CLIP
    ViT-B/16 image tower as the embedder), seeded random weights, batch 64,
    over 64 generations at 256 px and 128 training JPEGs at 500x375 (the
    port's encoder, 4 of them copied into the generations); the other
    stages off. Held: finite similarities of the right shape, each copy's
    source within 1e-5 of its row's best, no flash launch. Prints eval/features seconds, images/s, the
    device ms of one batch of 64 at 224 px alone (CUDA events over 5 calls)
    and peak memory."""
    import numpy as np

    from dcr_tpu_torch.core.config import EvalConfig
    from dcr_tpu_torch.eval import runner as R
    from dcr_tpu_torch.eval.features import EvalImageFolder

    gen, train, _, copies = _write_eval_folders(root, 64, 256, 128, (375, 500), 4, seed=10,
                                                train_jpeg=True)
    qpaths = EvalImageFolder(gen, 224).paths
    vpaths = [str(p) for p in EvalImageFolder(train, 224).paths]
    stats, bad = {}, []
    for pt_style, arch in BACKBONES:
        name = arch if pt_style == "dino" else "clip"
        cfg = EvalConfig(query_dir=str(gen), values_dir=str(train), pt_style=pt_style, arch=arch,
                         compute_fid=False, compute_clip_score=False, compute_complexity=False,
                         galleries=False, output_dir=str(root / name))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with StageLog() as stages:
            scalars = R.run_eval(cfg, device="cuda")
        total_s = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        sim = np.load(root / name / "similarity.npy")
        # a copy's match: its source within float noise of the row's best
        # (seeded random XCiT and DINO ResNet embed every image alike, so
        # the rows are nearly flat; exact top-1s are reported)
        rows = {g: next(i for i, p in enumerate(qpaths) if p.name == g) for g in copies}
        top1 = [bool(sim[rows[g], vpaths.index(str(src))] >= sim[rows[g]].max() - 1e-5)
                for g, src in copies.items()]
        exact = sum(int(sim[rows[g]].argmax()) == vpaths.index(str(src))
                    for g, src in copies.items())
        backbone = R.build_backbone(pt_style, arch, "cuda", seed=0, image_size=224)
        x = torch.randn((64, 3, 224, 224), generator=torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
        with torch.inference_mode():
            dim = backbone(x[:2]).shape[-1]
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                backbone(x)
            end.record()
            end.synchronize()
        del backbone, x
        feat_s = stages.seconds["eval/features"]
        stats[name] = {"total_s": total_s, "stage_s": stages.seconds, "feature_dim": dim,
                       "images_per_s": (len(qpaths) + len(vpaths)) / feat_s,
                       "batch64_device_ms": start.elapsed_time(end) / 5, "peak_bytes": peak,
                       "launches_fwd_dq_dkv": launches, "copies_top1": top1,
                       "copies_exact_top1": exact,
                       "sim_row_spread_median": float(np.median(sim.max(1) - sim.min(1))),
                       "sim_gt_05pc": scalars["sim_gt_05pc"]}
        log(f"backbone {name}: eval/features {feat_s:.2f} s, "
            f"{stats[name]['images_per_s']:.1f} images/s, "
            f"{stats[name]['batch64_device_ms']:.2f} device ms per batch of 64 at 224 px, "
            f"peak {peak / 2**30:.2f} GiB, features [{dim}], copies matched {sum(top1)}/4 "
            f"({exact} exact top-1), median row spread "
            f"{stats[name]['sim_row_spread_median']:.2e}")
        if (sim.shape != (64, 128) or not np.isfinite(sim).all() or not all(top1)
                or launches != (0, 0, 0)):
            bad.append(name)
    log(f"backbones: {json.dumps(stats)}")
    if bad:
        raise AssertionError(f"backbone eval failed for {bad}: {stats}")
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
    codec = phase_jpeg_codec()
    kern = phase_kernels(reps=10)
    bwd = phase_bwd_kernels(reps=10)
    limits = phase_kernel_limits()
    phase_small_reference()
    small_train = phase_small_train_reference()
    with tempfile.TemporaryDirectory() as tmp:
        small_eval = phase_small_eval_reference(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        small_dino = phase_small_dino_reference(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        main_stats, main = phase_main_path(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        interop_stats = phase_checkpoint_interop(Path(tmp), main)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        fast_stats = phase_fast_sampling(Path(tmp), main, main_stats)
    del main
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_stats = phase_train_main_path(Path(tmp), steps=6)
    torch.cuda.empty_cache()
    f32_train_stats = phase_train_f32_step(steps=2)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        eval_stats = phase_eval_main_path(Path(tmp))
    if eval_stats["launches_fwd_dq_dkv"] != (0, 0, 0):
        raise AssertionError(f"the eval path launched flash kernels: "
                             f"{eval_stats['launches_fwd_dq_dkv']}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        backbone_stats = phase_backbones(Path(tmp))

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
    # and of an f32 train step: the same attentions, every kernel in f32
    f32_train_stats["kernel_ms_per_step"] = sum(
        5 * (fwd_row(c, "float32")["ms"] + bwd_row(c, "float32")["pair_ms"])
        for c in ("train_level0", "train_level1"))
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
    sample_cases = ("level0", "level1", "level2", "hook_level0", "hook_level1")
    train_cases = ("train_level0", "train_level1")
    entries = [
        kernel_entry("fwd", "float32", kern["rows"], sample_cases,
                     {"sample": main_stats["launches"],
                      "sample_genuine": interop_stats["launches"],
                      "sample_fast": fast_stats["launches"],
                      "train_hook": train_stats["hook_launches_fwd_dq_dkv"][0],
                      "train_f32": f32_train["fwd"]},
                     tensor_cores("flash_fwd_tf32x3_kernel")),
        kernel_entry("fwd", "bfloat16", kern["rows"], train_cases, {"train": train["fwd"]},
                     tensor_cores("flash_fwd_bf16_kernel")),
    ]
    for kind in ("dq", "dkv"):
        entries += [
            kernel_entry(kind, "float32", bwd["rows"], train_cases,
                         {"train_f32": f32_train[kind]},
                         tensor_cores(f"flash_bwd_{kind}_tf32x3_kernel")),
            kernel_entry(kind, "bfloat16", bwd["rows"], train_cases, {"train": train[kind]},
                         tensor_cores(f"flash_bwd_{kind}_bf16_kernel")),
        ]
    entries[0]["per_shape"] = kern["rows"]
    entries[2]["per_shape"] = bwd["rows"]
    log(f"main path stats: {json.dumps(main_stats)}")
    log(f"checkpoint interop stats: {json.dumps(interop_stats)}")
    log(f"fast sampling stats: {json.dumps(fast_stats)}")
    log(f"train path stats: {json.dumps(train_stats)}")
    log(f"f32 train step stats: {json.dumps(f32_train_stats)}")
    log(f"small train reference: {json.dumps(small_train)}")
    log(f"kernel limits: {json.dumps(limits)}")
    log(f"small eval reference: {json.dumps(small_eval)}")
    log(f"eval path stats: {json.dumps(eval_stats)}")
    log(f"jpeg codec stats: {json.dumps(codec)}")
    log(f"small dino eval reference: {json.dumps(small_dino)}")
    log(f"backbone stats: {json.dumps(backbone_stats)}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
