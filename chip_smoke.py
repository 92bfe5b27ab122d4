"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit code:
1. card: name and power limit from nvidia-smi; TF32 off for matmuls and convs;
2. build: every kernel of the sampling path from dcr_tpu_torch/csrc (nvcc);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and a few edge shapes, with times (CUDA events,
   median), the plain version's and the library call's time, and the bound;
4. small reference: a kernel-shaped tiny sampler on the card against the same
   sampler on the CPU (plain attention), from the same x_T;
5. main path: dcr_tpu_torch.sampling.pipeline.generate at SD-2.1 widths
   (ModelConfig()), 512 px, 20 DPM-Solver++ steps with CFG, 2 prompts x 2
   images, seeded random weights built on the card; the flash kernel's
   launch count must be 15 per UNet call.
The last line is {"ok": true, "device": {...}}; the line before it holds the
kernels' numbers as JSON.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch


# H100 SXM data-sheet peaks at 700 W (dense): f32 outside the tensor cores,
# bf16 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
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


def flash_bound(b: int, sq: int, sk: int, h: int, d: int, dtype) -> tuple[float, str]:
    """Least time (ms) for one flash forward: q, k, v read once, o and lse
    written once, 4*Sq*Sk*D flops per (b, h) at the dtype's peak rate."""
    el = torch.finfo(dtype).bits // 8
    nbytes = el * (2 * b * sq * h * d + 2 * b * sk * h * d) + 4 * b * h * sq
    flops = 4.0 * b * h * sq * sk * d
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


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


def phase_build() -> None:
    from dcr_tpu_torch.ops import build
    from dcr_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    logs = build.build([fa.SOURCE])
    log(f"build: {len(logs)} kernel source(s) in {time.perf_counter() - t0:.2f} s "
        f"with {build.nvcc_path()}")
    for stem, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")


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
        ("d128", 2, 1024, 1024, 4, 128, 1.0, False),
        ("d256", 2, 512, 512, 4, 256, 1.0, False),
        ("rect", 2, 1024, 256, 4, 64, 1.0, False),
        ("logits_x100", 2, 1024, 1024, 4, 64, 100.0, False),
    ]
    rows = []
    worst = 0.0
    for name, b, sq, sk, h, d, scale, main in cases:
        for dtype in (torch.float32, torch.bfloat16):
            if not main and dtype is torch.bfloat16 and name != "d256":
                continue
            q = torch.randn((b, sq, h, d), generator=gen, device=dev) * scale
            k = torch.randn((b, sk, h, d), generator=gen, device=dev)
            v = torch.randn((b, sk, h, d), generator=gen, device=dev)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            with torch.no_grad():
                o, lse = fa.flash_attention_fwd(q, k, v)
                torch.cuda.synchronize()
                ref_o, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float())
            err_o = (o.float() - ref_o).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            if dtype is torch.bfloat16:
                tol_o = dict(atol=3e-2, rtol=0.0)      # bf16 output vs f32 plain
            elif scale != 1.0:
                tol_o = dict(atol=2e-4, rtol=2e-4)     # x100 logits: JAX repo's bound
            else:
                tol_o = dict(atol=2e-5, rtol=0.0)
            ok_o = torch.allclose(o.float(), ref_o, **tol_o)
            ok_lse = torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-5)
            finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
            with torch.no_grad():
                ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v), reps)
                plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v), reps)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)
            bound_ms, bound_by = flash_bound(b, sq, sk, h, d, dtype)
            row = dict(case=name, shape=[b, sq, sk, h, d], dtype=str(dtype).split(".")[-1],
                       max_abs_err=err_o, lse_max_abs_err=err_lse, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by, main_path=main, tol=tol_o)
            rows.append(row)
            log(f"flash {name:12s} {row['dtype']:8s} B={b} Sq={sq} Sk={sk} H={h} D={d}: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), max|o-ref| {err_o:.3e}, "
                f"max|lse-ref| {err_lse:.3e}")
            if not (ok_o and ok_lse and finite):
                raise AssertionError(f"flash kernel disagrees with its plain version at "
                                     f"{name} {dtype}: o err {err_o:.3e} (tol {tol_o}), "
                                     f"lse err {err_lse:.3e}, finite={finite}")
            if main and dtype is torch.float32:
                worst = max(worst, err_o)

    # what the kernel does not take raises on the card; nothing falls back
    x = torch.randn((1, 128, 2, 64), device=dev, requires_grad=True)
    try:
        fa.flash_attention_fwd(x, x, x)
    except RuntimeError as e:
        log(f"requires_grad input refused on the card: {e}")
    else:
        raise AssertionError("flash kernel accepted an input that requires grad")
    y = torch.randn((1, 128, 2, 48), device=dev)
    try:
        fa.flash_attention_fwd(y, y, y)
    except ValueError as e:
        log(f"unsupported head dim refused on the card: {e}")
    else:
        raise AssertionError("flash kernel accepted head dim 48")
    return {"rows": rows, "worst_main_f32_err": worst}


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
    fa.flash_attention_fwd.launches = 0
    try:
        out = P.generate(cfg, modelstyle="nolevel", models=models, params=params,
                         device="cuda")
    finally:
        launches = fa.flash_attention_fwd.launches
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
    if len(calls) != 2 or launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times, expected {expected}")
    return {"launches": launches, "sampler_call_s": calls,
            "step_s": statistics.mean(calls) / steps, "peak_bytes": peak,
            "image_std": float(np.std(imgs.numpy()))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    import dcr_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_card()
    phase_build()
    kern = phase_kernels(reps=10)
    phase_small_reference()
    with tempfile.TemporaryDirectory() as tmp:
        main_stats = phase_main_path(Path(tmp))

    lead = next(r for r in kern["rows"] if r["case"] == "level0" and r["dtype"] == "float32")
    entry = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "dcr_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "dcr_tpu/ops/flash_attention.py:112",
        "launches": main_stats["launches"],
        "max_abs_err": kern["worst_main_f32_err"],
        "ms": lead["ms"], "plain_ms": lead["plain_ms"], "bound_ms": lead["bound_ms"],
        "bound_by": lead["bound_by"], "library_ms": lead["library_ms"],
        "shape": "B=4 S=4096 H=5 D=64 float32 (UNet level 0 at 512 px)",
        "per_shape": kern["rows"],
    }
    log(f"main path stats: {json.dumps(main_stats)}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
