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
5d. mitigation (inside 5b, on its genuine directory): dcr-mitigate
   (cli.mitigate.main) at 512 px, 20 steps, rand_noise_lam 0.1,
   rand_word_add: 12 prompts and 12 PNGs under
   inferences/mitigation_aug_rand_word_add, finite images, 15 forward
   launches per UNet call, every launch at a shape of phase 3's
   mitigate_level rows (CFG batch 2); seconds per prompt;
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
15. training faults (after phase 7): Trainer(TrainConfig()) as in phase 6
   on 48 JPEGs and one truncated JPEG with fault.max_bad_sample_frac 0.05,
   max_rollbacks 1 and DCR_FAULTS's decode_error, nan_loss, sigterm and
   ckpt_corrupt: bad samples retried, quarantined and replaced, a NaN rolled
   back, a SIGTERM checkpointed, the torn checkpoint quarantined on resume,
   the run trained to its end and exported; quarantine.jsonl and the
   faults/* metrics held to the expected records, 10 launches of each
   kernel per executed step at the train shapes in bf16; a straight run
   beside the resumed one; dcr-train-torch subprocesses exiting 83 on
   SIGTERM and 89 on a hang. Seconds per step and per save with and without
   the manifest pass, restore seconds, the cost of a bad sample;
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
11. backbones: one run_eval each with dino_vitb8, dino_xcit_small_12_p16,
   dino_resnet50 and the CLIP image tower at full width over 500x375 JPEGs;
   device ms per batch of 64, images/s, peak memory;
12. small search reference: a store of 8,192 unit rows x 512 in 4 segments
   of 2,048, 100 queries at top_k=5, resident and streamed: the card
   against the CPU, and the store against search_folders on the card,
   under the tie rule (scores within 1e-5 |q||x|, keys equal away from
   near-ties) against a float64 reference;
13. search main path (last), through dcr-search-torch: embed (SSCD at 224,
   batch 128, over 2 tars of 512 JPEGs at 256 px and a corrupt member),
   build from 2 reference-format pickle dumps of 1,048,576 unit rows x
   512 (32 shards of 65,536, 4.3 GB), verify, query 4,096 rows (64 planted
   copies) at top_k=1 and 10 (host-streamed) and on a resident one-chunk
   store, and the brute force (num_chunks=20); every copy top-1, a float64
   oracle over the whole store for 64 queries and the brute force against
   the store under the tie rule; seconds, rows x queries per second and
   the share of the bound (at the CUDA cores' f32 rate, where the engine's
   matmul runs, and at split TF32's), upload GB/s, device busy share, peak
   memory; the flash launch counts are read across the whole phase.
14. serving main path (inside 5b, on its genuine directory; after 5d):
   ServeConfig()'s default bucket (256 px, 50 DPM++ steps, guidance 7.5,
   max_batch 8, max_wait 50 ms). In-process through GenerationService: the
   wave's 16 requests as two full batches, a request alone against mixed
   bit for bit (dpm++ with rand_noise_lam 0.1, ddpm; 10 steps), 10 B1
   launches per UNet call at phase 3's train_level0/1 shapes in f32; the
   planted generation's SSCD embedding among 65,536 random unit rows (an
   .npz dump). Then `python -m dcr_tpu_torch.cli.serve` as a subprocess
   with that index: /healthz warming then ok, risk ok; 16 concurrent
   requests answered with 256x256 PNGs, all scored, the planted one
   flagged top-1 with the in-process pixels; cache hits, Prometheus text,
   a bad sampler 400, /check; a fast_ratio 0.5 bucket, a third bucket 503
   bucket_limit; SIGTERM with a batch queued, every request answered,
   exit 83. Seconds per batch, images/s, p50/p99, UNet call ms, risk ms
   per batch, /check ms, peak memory, load and warm seconds.
16. ANN (after 13), through dcr-search-torch: a store of 1,048,576 rows x
   512 clustered as tools/bench_ann.py builds its corpus (1,024 clusters),
   `train-ivf` with 1,024 lists and 10 iterations, `query --ann=true` and
   the exact `query` for 4,096 queries from 16 hot clusters at top_k 10,
   and an nprobe sweep (1-32, 1,024) on one engine: train-ivf seconds and
   their split, ms per k-means step against its bound, seconds per query
   call, recall@10 against the exact answer, segments scanned and skipped,
   the device's busy share, peak memory. Held: each query's top-1 at nprobe
   8 is its float64 nearest row, recall@10 >= 0.95 at nprobe 8, scores are
   exact dots (float64, 64 queries), nprobe 1,024 agrees with the exact
   engine, k-means again from the same seed gives bit-identical centroids;
   on 65,536 rows the card agrees with the CPU, ivf_list_corrupt@load=3
   quarantines, counts and rebuilds one list with unchanged answers, and
   kmeans_nan@iter=2 makes train-ivf restart once.
No kernel lies on the eval, search and ANN paths (9-13 and 16: their
attention is SDPA's, XCiT's is over channels; search and ANN are matmuls,
sorts and torch.topk): their launch counts must stay 0.
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
# f32 on the CUDA cores: the search engine's matmul runs there (TF32 off)
PEAK_FLOPS_F32_CUDA_CORES = 67e12
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


# the card's name and power limit as nvidia-smi gives them (phase 1)
CARD = [""]


def phase_card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    CARD[0] = smi.stdout.strip().splitlines()[0]
    log(CARD[0])
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


# dcr-mitigate (phase 5d): one image per prompt with CFG at 512 px; phase 5d
# holds every forward launch it makes to one of these shapes
MITIGATE_CASES = [
    ("mitigate_level0", 2, 4096, 4096, 5, 64, 1.0, True),
    ("mitigate_level1", 2, 1024, 1024, 10, 64, 1.0, True),
    ("mitigate_level2", 2, 256, 256, 20, 64, 1.0, True),
]


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
        *MITIGATE_CASES,
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
        # dcr-mitigate's forward shapes; it runs no backward
        *(c[:-1] + (False,) for c in MITIGATE_CASES),
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


# the training faults phase (15): the spec that fires every recovery once
FAULT_SPEC = ("decode_error@step=0&slot=3,nan_loss@step=4,sigterm@step=5,"
              "ckpt_corrupt@step=5")


def _expected_bad_samples(dataset, seed: int, epochs: int, steps: int, batch: int,
                          bad_index: int, injected: tuple) -> set:
    """The (epoch, step, slot, index, replacement_slot, replacement_index) of
    every quarantined occurrence the loader's rule gives: each slot of the
    truncated file, and the injected (epoch, step, slot), replaced by the
    next plan slot that decodes."""
    from dcr_tpu_torch.data.loader import sampling_plan

    out = set()
    for epoch in range(epochs):
        plan = sampling_plan(dataset, epoch=epoch, seed=seed)
        index = lambda s: int(dataset.active_indices[int(plan[s])])
        for slot in range(steps * batch):
            if index(slot) != bad_index and (epoch, slot // batch, slot) != injected:
                continue
            cand = next(c for c in ((slot + k) % len(plan) for k in range(1, len(plan)))
                        if index(c) != bad_index)
            out.add((epoch, slot // batch, slot, index(slot), cand, index(cand)))
    return out


def _cli_fault_run(root: Path, name: str, dcr_faults: str, *extra: str,
                   steps: int) -> dict:
    """dcr-train-torch as a subprocess on the card at phase 4's kernel-shaped
    tiny model (128 px, batch 2), with DCR_FAULTS set: (exit code, seconds,
    the run directory, the tail of stderr)."""
    import os

    from dcr_tpu_torch.core.config import DataConfig, OptimConfig, TrainConfig, save_config

    cfg = TrainConfig(output_dir=str(root / name), max_train_steps=steps, log_every=1,
                      train_batch_size=2, mixed_precision="bf16", seed=0)
    cfg.model = _tiny_kernel_cfg()
    cfg.data = DataConfig(train_data_dir=str(root / "tiny_data"), resolution=128,
                          class_prompt="nolevel", num_workers=2)
    cfg.optim = OptimConfig(learning_rate=1e-4, lr_scheduler="constant", lr_warmup_steps=0)
    save_config(cfg, root / f"{name}.json")
    env = {k: v for k, v in os.environ.items() if k not in ("DCR_FAULTS",
                                                             "DCR_HANG_TIMEOUT_S")}
    env.update(DCR_FAULTS=dcr_faults, PYTHONPATH=str(Path(__file__).resolve().parent))
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dcr_tpu_torch.cli.train",
                           f"--config={root / f'{name}.json'}", *extra], env=env,
                          cwd=root, capture_output=True, text=True, timeout=300)
    return {"rc": proc.returncode, "s": time.perf_counter() - start, "run": root / name,
            "stderr": proc.stderr}


def phase_train_faults(out_dir: Path) -> dict:
    """Phase 15: training's fault tolerance at full width. Trainer(TrainConfig())
    (SD-2.1 widths, 256 px, batch 16, bf16) on 48 photo-like JPEGs and one
    truncated JPEG, with fault.max_bad_sample_frac 0.05, max_rollbacks 1,
    a checkpoint every 3 steps (2 kept) and FAULT_SPEC installed:
    - steps 1-3: the injected decode_error (epoch 0, step 0, slot 3) and
      every occurrence of the truncated file are retried (the injected one
      is not: it fails before the decode) and quarantined, each replaced by
      the next plan slot that decodes; a checkpoint at step 3;
    - step 4: nan_loss -> rollback to step 3, state.step = 4, on with the
      next batch;
    - step 5: sigterm -> the preemption's save of step 5, which ckpt_corrupt
      then zero-fills; train() returns with preempted_exit;
    - a second Trainer on the same output_dir quarantines step 5, restores
      step 3, trains steps 4-6, saves and exports.
    Held: the quarantine.jsonl records (bad_sample by the rule of
    _expected_bad_samples, one nan_rollback, one bad_checkpoint), the
    faults/* metrics, checkpoints/quarantined/5, finite losses, 10 launches
    of each kernel per executed step, all at the two train shapes in bf16,
    the export loading back. A straight run (the same spec's decode_error
    only, no saves) gives the resumed run's reference: equal step counter,
    optimizer count and loader index sequences; the params' max |diff| is
    reported (cuDNN's backward may pick nondeterministic algorithms). Then
    two dcr-train-torch subprocesses at the tiny kernel-shaped model:
    sigterm@step=2 exits 83 with a checkpoint at step 2, and hang@step=1
    with --fault.hang_timeout_s=5 exits 89 with a thread dump on stderr.
    Reports s per step, s per save with the manifest pass (steps 3 and 6)
    and without it (step 5, the save that is torn: a torn file fails its
    load, so it needs no manifest to be caught),
    restore s of the rollback and of the fallback, decode-retry and
    quarantine ms per bad sample, wall time and peak memory."""
    import dataclasses
    import gc

    import numpy as np

    from dcr_tpu_torch.core import checkpoint as CK
    from dcr_tpu_torch.core import resilience as R
    from dcr_tpu_torch.core.config import FaultToleranceConfig, TrainConfig
    from dcr_tpu_torch.data import dataset as DS
    from dcr_tpu_torch.diffusion.trainer import Trainer
    from dcr_tpu_torch.native.jpeg_helper import encode
    from dcr_tpu_torch.ops import flash_attention as fa
    from dcr_tpu_torch.sampling.pipeline import load_checkpoint_models
    from dcr_tpu_torch.sampling.png import write_png
    from dcr_tpu_torch.utils import faults

    wall0 = time.perf_counter()
    data = out_dir / "data"
    for i in range(48):
        (data / f"class{i % 2}").mkdir(parents=True, exist_ok=True)
        (data / f"class{i % 2}" / f"{i}.jpg").write_bytes(encode(_photo(i, 375, 500), 90))
    whole = encode(_photo(99, 375, 500), 90)
    truncated = data / "class1" / "truncated.jpg"
    truncated.write_bytes(whole[: len(whole) * 3 // 5])
    run = out_dir / "run"
    cfg = TrainConfig(output_dir=str(run), max_train_steps=6, log_every=1, modelsavesteps=3,
                      checkpoints_total_limit=2)
    cfg.data.train_data_dir = str(data)
    cfg.fault = FaultToleranceConfig(max_bad_sample_frac=0.05, max_rollbacks=1)

    # timers around the checkpoint manager's saves, restores and manifest passes
    times = {"save": [], "no_manifest_save": [], "manifest": [], "verify": [], "restore": []}
    state_manifest, verify_manifest = CK.state_manifest, CK.verify_manifest

    def timed(key, fn):
        def call(*a, **kw):
            start = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                times[key].append(time.perf_counter() - start)
        return call

    shapes, check_inputs = set(), fa._check_kernel_inputs

    def recording_check(q, k, v):
        shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3], q.dtype))
        return check_inputs(q, k, v)

    def instrument(trainer, record):
        mgr, save = trainer.ckpt, trainer.ckpt.save

        def timed_save(step, state):
            # the preemption's save of step 5, torn right after it commits,
            # is the one written without the manifest pass
            mgr.verify = step != 5
            start = time.perf_counter()
            try:
                if save(step, state):  # an already-saved step writes nothing
                    times["save" if mgr.verify else "no_manifest_save"].append(
                        time.perf_counter() - start)
            finally:
                mgr.verify = True
        trainer.ckpt.save = timed_save
        trainer.ckpt.restore_latest_valid = timed("restore", trainer.ckpt.restore_latest_valid)
        step_fn = trainer.step_fn

        def step(state, batch):
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, metrics = step_fn(state, batch)
            record["losses"].append(float(metrics["loss"]))
            torch.cuda.synchronize()
            record["step_s"].append(time.perf_counter() - start)
            record["index"].append([int(i) for i in batch["index"]])
            return state, metrics
        trainer.step_fn = step

    first = {"losses": [], "step_s": [], "index": []}
    resumed = {"losses": [], "step_s": [], "index": []}
    straight = {"losses": [], "step_s": [], "index": []}
    CK.state_manifest = timed("manifest", state_manifest)
    CK.verify_manifest = timed("verify", verify_manifest)
    fa._check_kernel_inputs = recording_check
    torch.cuda.reset_peak_memory_stats()
    R.reset_counters()
    reset_launches()
    try:
        faults.install(FAULT_SPEC)
        a = Trainer(cfg, device="cuda")
        instrument(a, first)
        a.install_preemption_handler()
        a.train()
        if not a.preempted_exit:
            raise AssertionError("the first trainer did not stop on the injected SIGTERM")
        bad_index = a.dataset.paths.index(str(truncated))
        expected_bad = _expected_bad_samples(
            a.dataset, cfg.data.seed, 2, a.loader.steps_per_epoch(), cfg.train_batch_size,
            bad_index, (0, 0, 3))
        # the decode-retry and quarantine cost of one bad sample: the failed
        # attempts (with the retry's backoff) and the replacement's decode
        bad_pos = int(np.flatnonzero(a.dataset.active_indices == bad_index)[0])
        overhead = []
        for _ in range(3):
            start = time.perf_counter()
            try:
                a.dataset.get(bad_pos, epoch=0, slot=0)
                raise AssertionError(f"{truncated} decoded")
            except DS.SampleDecodeError:
                failed = time.perf_counter() - start
            start = time.perf_counter()
            a.dataset.get((bad_pos + 1) % len(a.dataset), epoch=0, slot=1)
            overhead.append((failed, time.perf_counter() - start))
        rollback_restore_s = list(times["restore"])
        del a
        gc.collect()
        torch.cuda.empty_cache()
        b = Trainer(cfg, device="cuda")
        instrument(b, resumed)
        b.train()
        fallback_restore_s = times["restore"][len(rollback_restore_s):]
        launches_ab = read_launches()
        models, _, mcfg = load_checkpoint_models(run / "checkpoint", "cuda")
        bad = [k for k, t in b.state.unet_params.items()
               if not torch.equal(t.detach(), dict(models.unet.named_parameters())[k])]
        if mcfg != cfg.model or bad:
            raise AssertionError(f"the export does not load back: {bad[:3]}")
        del models
        resumed_unet = {k: t.detach().cpu() for k, t in b.state.unet_params.items()}
        resumed_counts = (b.state.step, b.state.opt_state.count)
        del b
        gc.collect()
        torch.cuda.empty_cache()
        # the straight run: the same bad samples, no NaN, no stop, no saves
        faults.install("decode_error@step=0&slot=3")
        straight_cfg = dataclasses.replace(cfg, output_dir=str(out_dir / "straight"))
        c = Trainer(straight_cfg, device="cuda")
        instrument(c, straight)
        c.save = lambda: None
        c.export_checkpoint = lambda tag="checkpoint": None
        c.train()
        straight_counts = (c.state.step, c.state.opt_state.count)
        max_diff = max((t.detach().cpu() - resumed_unet[k]).abs().max().item()
                       for k, t in c.state.unet_params.items())
        del c
    finally:
        faults.clear()
        CK.state_manifest, CK.verify_manifest = state_manifest, verify_manifest
        fa._check_kernel_inputs = check_inputs
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()

    records = [json.loads(x) for x in (run / "quarantine.jsonl").read_text().splitlines()]
    kinds = [r["kind"] for r in records]
    got_bad = {(r["epoch"], r["step"], r["slot"], r["index"], r["replacement_slot"],
                r["replacement_index"]) for r in records if r["kind"] == "bad_sample"}
    rows = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps_run = len(first["step_s"]) + len(resumed["step_s"]) + len(straight["step_s"])
    stats = {
        "card": CARD[0], "spec": FAULT_SPEC, "records": {k: kinds.count(k) for k in set(kinds)},
        "expected_bad_samples": sorted(expected_bad),
        "metric_steps": [r["step"] for r in rows],
        "faults_metrics": [{k: r[k] for k in r if k.startswith("faults/")} for r in rows],
        "steps_run": [len(first["step_s"]), len(resumed["step_s"]), len(straight["step_s"])],
        "step_s": first["step_s"] + resumed["step_s"],
        "median_step_s_after_first": statistics.median(
            first["step_s"][1:] + resumed["step_s"][1:] + straight["step_s"][1:]),
        "save_s": times["save"], "manifest_s": times["manifest"],
        "no_manifest_save_s": times["no_manifest_save"], "verify_s": times["verify"],
        "rollback_restore_s": rollback_restore_s, "fallback_restore_s": fallback_restore_s,
        "bad_sample_failed_decode_ms": [1e3 * f for f, _ in overhead],
        "bad_sample_replacement_decode_ms": [1e3 * g for _, g in overhead],
        "launches_fwd_dq_dkv": launches, "launches_first_and_resumed": launches_ab,
        "kernel_shapes": sorted(list(s[:5]) + [str(s[5])] for s in shapes),
        "straight_vs_resumed_max_abs_diff": max_diff,
        "straight_counts": straight_counts, "resumed_counts": resumed_counts,
        "peak_bytes": peak, "losses": first["losses"] + resumed["losses"],
    }
    problems = []
    if kinds.count("nan_rollback") != 1 or kinds.count("bad_checkpoint") != 1:
        problems.append(f"records {stats['records']}")
    roll = next((r for r in records if r["kind"] == "nan_rollback"), {})
    if (roll.get("at_step"), roll.get("restored_step"), roll.get("skipped_steps"),
            roll.get("rollback"), roll.get("max_rollbacks")) != (4, 3, 1, 1, 1):
        problems.append(f"nan_rollback record {roll}")
    ckpt_rec = next((r for r in records if r["kind"] == "bad_checkpoint"), {})
    if ckpt_rec.get("step") != 5 or not (run / "checkpoints" / "quarantined" / "5").is_dir():
        problems.append(f"bad_checkpoint record {ckpt_rec}")
    if got_bad != expected_bad or (0, 0, 3) not in {b[:3] for b in got_bad}:
        problems.append(f"bad_sample records {sorted(got_bad)}, expected {sorted(expected_bad)}")
    if len(times["save"]) != 2 or len(times["no_manifest_save"]) != 1:
        problems.append(f"saves {times['save']} with, {times['no_manifest_save']} without "
                        "the manifest pass (expected steps 3 and 6, and 5)")
    if stats["metric_steps"] != [1, 2, 3, 5, 4, 5, 6]:
        problems.append(f"metrics rows {stats['metric_steps']}")
    fm = stats["faults_metrics"]
    if (any({"faults/bad_samples", "faults/rollbacks", "faults/ckpt_fallbacks"} - set(m)
            for m in fm)
            or [m["faults/rollbacks"] for m in fm] != [0, 0, 0, 1, 0, 0, 0]
            or [m["faults/ckpt_fallbacks"] for m in fm] != [0, 0, 0, 0, 1, 1, 1]
            or fm[0]["faults/bad_samples"] < 1
            or fm[-1]["faults/bad_samples"] != sum(1 for b in expected_bad if b[0] == 1)):
        problems.append(f"faults/* metrics {fm}")
    if not all(np.isfinite(r["loss"]) for r in rows) or not np.isfinite(stats["losses"]).all():
        problems.append(f"losses {stats['losses']}")
    if stats["steps_run"] != [5, 3, 6] or launches != (10 * steps_run,) * 3:
        problems.append(f"steps {stats['steps_run']}, launches {launches}")
    held = {(16, 1024, 1024, 5, 64, torch.bfloat16), (16, 256, 256, 10, 64, torch.bfloat16)}
    if shapes != held:
        problems.append(f"kernel shapes {sorted(map(str, shapes))}")
    if (straight_counts != resumed_counts != (6, 6)
            or straight["index"][3:] != resumed["index"]
            or straight["index"][:3] != first["index"][:3]):
        problems.append(f"straight vs resumed: counts {straight_counts} / {resumed_counts}, "
                        f"index {straight['index']} / {first['index']} + {resumed['index']}")

    # dcr-train-torch on the card: exit 83 and exit 89
    for i in range(8):
        (out_dir / "tiny_data" / f"c{i % 2}").mkdir(parents=True, exist_ok=True)
        write_png(out_dir / "tiny_data" / f"c{i % 2}" / f"{i}.png", _photo(i, 128, 128))
    stop = _cli_fault_run(out_dir, "cli_sigterm", "sigterm@step=2", steps=3)
    hang = _cli_fault_run(out_dir, "cli_hang", "hang@step=1", "--fault.hang_timeout_s=5",
                          steps=3)
    stats["cli_sigterm"] = {"rc": stop["rc"], "s": stop["s"],
                            "checkpoints": sorted(p.name for p in (stop["run"] / "checkpoints")
                                                  .iterdir()) if stop["rc"] == 83 else None}
    stats["cli_hang"] = {"rc": hang["rc"], "s": hang["s"],
                         "thread_dump": "Thread 0x" in hang["stderr"]
                         and "simulate_hang" in hang["stderr"]}
    if stop["rc"] != 83 or not (stop["run"] / "checkpoints" / "2" / "state.pt").exists():
        problems.append(f"dcr-train-torch with sigterm@step=2: rc {stop['rc']}, "
                        f"{stop['stderr'][-2000:]}")
    if hang["rc"] != 89 or not stats["cli_hang"]["thread_dump"] or hang["s"] > 60:
        problems.append(f"dcr-train-torch with hang@step=1: rc {hang['rc']} in "
                        f"{hang['s']:.1f} s, {hang['stderr'][-2000:]}")
    stats["wall_s"] = time.perf_counter() - wall0
    log(f"training faults (phase 15, {CARD[0]}): {json.dumps(stats, default=str)}")
    log(f"training faults ({CARD[0]}): s per step {stats['median_step_s_after_first']:.4f}; "
        f"save "
        f"{statistics.mean(times['save']):.2f} s with the manifest pass "
        f"({statistics.mean(times['manifest']):.2f} s of it), "
        f"{statistics.mean(times['no_manifest_save']):.2f} s without; restore {rollback_restore_s} s (rollback), {fallback_restore_s} s "
        f"(fallback); a bad sample {statistics.mean(f for f, _ in overhead) * 1e3:.1f} ms "
        f"failing + {statistics.mean(g for _, g in overhead) * 1e3:.1f} ms replacing; "
        f"straight vs resumed max |diff| {max_diff:.3e}; exits {stop['rc']}, {hang['rc']} "
        f"({hang['s']:.1f} s); peak {peak / 2**30:.2f} GiB; {stats['wall_s']:.1f} s")
    if problems:
        raise AssertionError("training faults: " + "; ".join(problems))
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


def phase_mitigation(ckpt: Path, root: Path) -> dict:
    """Phase 5d: dcr-mitigate (dcr_tpu_torch.cli.mitigate.main) on phase 5b's
    genuine diffusers directory at 512 px, 20 DPM++ steps, one image per
    prompt, rand_noise_lam 0.1 and rand_word_add, run from ``root`` so the
    JAX savepath rule's relative directory lands there. Held: 12 prompts
    and 12 PNGs under inferences/mitigation_aug_rand_word_add, finite
    images in [0, 1], 15 B1 launches per UNet call, each at the shape of one
    of phase 3's MITIGATE_CASES. Reports seconds per prompt (the
    checkpoint's load included once)."""
    import os

    from dcr_tpu_torch.cli import mitigate
    from dcr_tpu_torch.ops import flash_attention as fa
    from dcr_tpu_torch.sampling import pipeline as P

    # (B, Sq, Sk, H, D) of every forward launch: the kernel checks its
    # inputs just before it launches
    shapes, check_inputs = set(), fa._check_kernel_inputs

    def recording_check(q, k, v):
        shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3], q.dtype))
        return check_inputs(q, k, v)

    calls, images, unet_calls = [], [], []
    make = P.make_sampler

    def timed_make_sampler(*a, **kw):
        fn = make(*a, **kw)
        unet_calls.append(fn.unet_calls)

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

    cwd = os.getcwd()
    P.make_sampler, fa._check_kernel_inputs = timed_make_sampler, recording_check
    torch.cuda.reset_peak_memory_stats()
    os.chdir(root)
    reset_launches()
    t0 = time.perf_counter()
    try:
        out = mitigate.main([f"--model_path={ckpt}", "--resolution=512", "--num_batches=1",
                             "--im_batch=1", "--num_inference_steps=20",
                             "--rand_noise_lam=0.1", "--rand_augs=rand_word_add"])
    finally:
        launches = read_launches()
        os.chdir(cwd)
        P.make_sampler, fa._check_kernel_inputs = make, check_inputs
    total_s = time.perf_counter() - t0
    out = root / out
    pngs = sorted((out / "generations").glob("*.png"))
    prompts = (out / "prompts.txt").read_text().splitlines()
    imgs = torch.cat(images)
    expected = 15 * unet_calls[0] * len(calls) if unet_calls else -1
    stats = {"savepath": str(out.relative_to(root)), "prompts": len(prompts),
             "pngs": len(pngs), "sampler_calls": len(calls), "total_s": total_s,
             "s_per_prompt": total_s / max(1, len(prompts)),
             "sampler_call_s_median": statistics.median(calls) if calls else None,
             "launches": launches[0], "expected_launches": expected,
             "kernel_shapes": sorted(list(x[:5]) for x in shapes),
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "first_prompt": prompts[0] if prompts else None}
    log(f"mitigation (dcr-mitigate on the genuine checkpoint, 512 px, 20 steps): "
        f"{json.dumps(stats)}")
    _check_images(imgs, "mitigation")
    if (stats["savepath"] != "inferences/mitigation_aug_rand_word_add" or len(prompts) != 12
            or len(pngs) != 12 or imgs.shape != (12, 512, 512, 3)
            or launches != (expected, 0, 0) or expected != 15 * 20 * 12):
        raise AssertionError(f"mitigation failed: {stats}")
    held = {tuple(c[1:6]) + (torch.float32,) for c in MITIGATE_CASES}
    if shapes != held:
        raise AssertionError(f"mitigation launched B1 at {sorted(map(str, shapes))}, phase 3 "
                             f"holds it at {sorted(map(str, held))}")
    return stats


# the serving main path (phase 14): ServeConfig()'s default bucket at SD-2.1
# widths, 256 px, 50 DPM++ steps, guidance 7.5, max_batch 8 with CFG; every
# B1 launch at one of these shapes (phase 3's train_level0/1 rows in f32)
SERVE_CASES = ("train_level0", "train_level1")
SERVE_PROMPTS = ("a red square", "a photo of a church", "a garbage truck", "an old map")


class ServeProcess:
    """``python -m dcr_tpu_torch.cli.serve`` as a subprocess, its output in a
    file; killed on exit unless it ended by itself."""

    def __init__(self, argv: list[str], log_path: Path):
        import os

        self.log_path = log_path
        self._log = open(log_path, "w")
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)
                   + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen([sys.executable, "-m", "dcr_tpu_torch.cli.serve", *argv],
                                     stdout=self._log, stderr=subprocess.STDOUT, env=env,
                                     cwd=str(Path(__file__).resolve().parent))

    def text(self) -> str:
        return self.log_path.read_text(errors="replace")

    def wait_for_port(self, timeout: float) -> int:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = re.search(r"dcr-serve listening on http://[\d.]+:(\d+)", self.text())
            if m:
                return int(m.group(1))
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"dcr-serve did not listen (rc {self.proc.poll()}):\n"
                             + self.text()[-4000:])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._log.close()


def _http(port: int, path: str, body=None, timeout: float = 300.0) -> tuple[int, dict, bytes]:
    """(status, headers, body bytes) of one request to localhost."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _concurrent_posts(port: int, bodies: list[dict]) -> tuple[list, list[float]]:
    """POST /generate for every body at once (a barrier releases the
    threads together); the responses and each request's seconds."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    barrier = threading.Barrier(len(bodies))

    def one(body):
        barrier.wait()
        t0 = time.perf_counter()
        code, _, raw = _http(port, "/generate", body)
        return code, json.loads(raw), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(bodies)) as ex:
        out = list(ex.map(one, bodies))
    return [(c, d) for c, d, _ in out], [s for _, _, s in out]


def _metrics(port: int) -> dict:
    return json.loads(_http(port, "/metrics")[2])


def _percentile(xs: list[float], q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs), q))


def phase_serve(ckpt: Path, root: Path) -> dict:
    """Phase 14: dcr-serve-torch's main path on phase 5b's genuine SD-2.1
    checkpoint at ServeConfig()'s default bucket (256 px, 50 DPM++ steps,
    guidance 7.5, max_batch 8, max_wait 50 ms).

    In-process, through GenerationService on the card: the first wave's
    16 requests as two full batches (the planted one first), and a
    request alone against it in a mixed batch, bit for bit, for dpm++ with
    rand_noise_lam 0.1 and for ddpm (10 steps each); every B1 launch counted
    (10 per UNet call: S = 64 and 16 take SDPA) and at a shape phase 3
    holds. The planted generation, written as PNG and embedded by the port's
    SSCD (seeded init, embed_images), joins 65,536 random unit rows in an
    .npz dump in the JAX format.

    The threshold is set from the in-process similarities of the wave's 16
    generations, which the server reproduces bit for bit. Over HTTP, a
    subprocess with that index: /healthz reads warming then ok,
    risk ok; 16 concurrent requests (4 prompts x 4 seeds) answer 200 with
    256x256 PNGs, every one scored, the planted one flagged top-1 with
    max_sim >= 0.99 and the same pixels as in-process; the cache hits and
    counters on /metrics, Prometheus text that parses, a bad sampler 400,
    /check finding the planted key; then 10 requests of a fast_ratio 0.5
    bucket (8 run, 2 queued), a third bucket refused 503 bucket_limit, and
    SIGTERM with every accepted request answered and exit code 83."""
    import base64
    import dataclasses
    import signal

    import numpy as np

    from dcr_tpu_torch.core.config import SampleConfig, SearchConfig, ServeConfig
    from dcr_tpu_torch.obs.copyrisk import CopyRiskIndex
    from dcr_tpu_torch.ops import flash_attention as fa
    from dcr_tpu_torch.sampling import fastsample
    from dcr_tpu_torch.sampling.pipeline import load_generation_stack
    from dcr_tpu_torch.sampling.png import decode_png, write_png
    from dcr_tpu_torch.search.embed import embed_images, load_embeddings, save_embeddings
    from dcr_tpu_torch.serve.queue import Request
    from dcr_tpu_torch.serve.worker import GenerationService

    cfg = ServeConfig(model_path=str(ckpt))
    wave = [{"prompt": p, "seed": s} for s in (1, 2, 3, 4) for p in SERVE_PROMPTS]
    planted = wave[0]
    stats: dict = {"card": CARD[0]}

    # -- in-process: the batch sampler on the card --------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack = load_generation_stack(SampleConfig(model_path=str(ckpt)), device="cuda")
    torch.cuda.synchronize()
    stats["inprocess_load_s"] = time.perf_counter() - t0
    svc = GenerationService(cfg, stack)
    bucket = svc.default_bucket()
    shapes, check_inputs = set(), fa._check_kernel_inputs

    def recording_check(q, k, v):
        shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3], q.dtype))
        return check_inputs(q, k, v)

    torch.cuda.reset_peak_memory_stats()
    fa._check_kernel_inputs = recording_check
    reset_launches()
    try:
        # the wave's 16 requests as two full batches (the planted one first)
        halves, batch_s = [], []
        for half in (wave[:8], wave[8:]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            halves.append(svc.execute([Request(w["prompt"], w["seed"], bucket) for w in half]))
            torch.cuda.synchronize()
            batch_s.append(time.perf_counter() - t0)
        stats["inprocess_full_batch_s"] = batch_s
        unet_calls = fastsample.unet_calls(fastsample.fast_plan(bucket.steps, 0.0))
        mixed_steps, mixed_checks = 10, {}
        for sampler, lam in (("dpm++", 0.1), ("ddpm", 0.0)):
            sub = GenerationService(dataclasses.replace(
                cfg, sampler=sampler, rand_noise_lam=lam, num_inference_steps=mixed_steps),
                stack)
            b = sub.default_bucket()
            alone = sub.execute([Request("a red square", 7, b)])
            mixed = sub.execute([Request("a red square", 7, b), Request("a blue circle", 9, b),
                                 Request("a red square", 8, b)])
            mixed_checks[sampler] = {"alone_equals_mixed": bool(np.array_equal(alone[0],
                                                                               mixed[0])),
                                     "neighbours_differ": bool(
                                         not np.array_equal(mixed[0], mixed[1])
                                         and not np.array_equal(mixed[0], mixed[2]))}
    finally:
        launches = read_launches()
        fa._check_kernel_inputs = check_inputs
    # 10 per UNet call: the wave's 2 batches, then 2 samplers x 2 batches
    expected = 10 * (2 * unet_calls + 2 * 2 * mixed_steps)
    stats.update(launches=launches[0], expected_launches=expected,
                 kernel_shapes=sorted(list(x[:5]) for x in shapes),
                 alone_vs_mixed=mixed_checks,
                 inprocess_peak_bytes=torch.cuda.max_memory_allocated())
    # one CFG UNet call of the bucket alone: CUDA events around 5 calls
    m = stack.models
    x = torch.randn((16, 4, 32, 32), device="cuda")
    ctx = torch.randn((16, 77, 1024), device="cuda")
    tb = torch.full((16,), 500, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        stats["unet_call_ms"] = call_ms(lambda: m.unet(x, tb, ctx), reps=5)
    del x, ctx

    # -- the index: 65,536 random unit rows and the planted generation ------
    gen_dir = root / "serve_planted"
    gen_dir.mkdir()
    planted_png = (halves[0][0] * 255).round().astype(np.uint8)
    write_png(gen_dir / "planted.png", planted_png)
    t0 = time.perf_counter()
    emb = embed_images(SearchConfig(), source=gen_dir, out_path=root / "planted.npz",
                       device="cuda")
    planted_row, _ = load_embeddings(emb)
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((65536, 512)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    planted_key = f"train/planted_{planted['seed']}.png"
    keys = [f"train/{i:06d}.png" for i in range(len(rows))] + [planted_key]
    index_path = save_embeddings(root / "serve_index.npz",
                                 np.concatenate([rows, planted_row]), keys)
    stats["index_write_s"] = time.perf_counter() - t0
    stats["index_bytes"] = index_path.stat().st_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = CopyRiskIndex.load(dataclasses.replace(cfg.risk, index_path=str(index_path)),
                               batch=cfg.max_batch, device="cuda")
    torch.cuda.synchronize()
    stats["inprocess_index_load_s"] = time.perf_counter() - t0
    # the server scores the same rows with the same weights at the same
    # batch shape, so its similarities are these: the threshold lies midway
    # between the planted copy's and the largest of the 15 others'
    sims = [s.max_sim for half in halves for s in index.score_batch(half)]
    hit, miss = sims[0], max(sims[1:])
    threshold = (hit + miss) / 2
    score_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.score_batch(halves[0])
        torch.cuda.synchronize()
        score_s.append(time.perf_counter() - t0)
    stats.update(planted_sim=hit, other_max_sim=miss, threshold=threshold,
                 risk_score_ms_per_batch=1e3 * statistics.median(score_s))
    del svc, sub, stack, index, m, halves
    torch.cuda.empty_cache()
    log(f"serve in-process ({CARD[0]}): {json.dumps(stats)}")
    if (launches != (expected, 0, 0) or not shapes
            or shapes != {(16, 1024, 1024, 5, 64, torch.float32),
                          (16, 256, 256, 10, 64, torch.float32)}):
        raise AssertionError(f"serve launched B1 {launches} (expected ({expected}, 0, 0)) "
                             f"at {sorted(map(str, shapes))}")
    if not all(v["alone_equals_mixed"] and v["neighbours_differ"]
               for v in mixed_checks.values()):
        raise AssertionError(f"alone against mixed on the card: {mixed_checks}")
    if not (hit >= 0.99 and hit > miss):
        raise AssertionError(f"the planted generation scores {hit} against {miss}")

    # -- over HTTP: dcr-serve-torch as a subprocess -------------------------
    server = ServeProcess([f"--model_path={ckpt}", "--port=0", "--max_compiled_buckets=2",
                           f"--risk.index_path={index_path}", f"--risk.threshold={threshold}"],
                          root / "serve.log")
    try:
        t_start = time.perf_counter()
        port = server.wait_for_port(timeout=300)
        health_seen, risk_seen = [], []
        while True:
            doc = json.loads(_http(port, "/healthz")[2])
            if not health_seen or health_seen[-1] != doc["status"]:
                health_seen.append(doc["status"])
            if not risk_seen or risk_seen[-1] != doc["risk"]:
                risk_seen.append(doc["risk"])
            if doc["status"] == "ok" and doc["risk"] in ("ok", "failed"):
                break
            if time.perf_counter() - t_start > 300 or server.proc.poll() is not None:
                raise AssertionError(f"dcr-serve never became ready: {doc}\n"
                                     + server.text()[-4000:])
            time.sleep(0.1)
        stats["ready_s"] = time.perf_counter() - t_start
        stats.update(health_seen=health_seen, risk_seen=risk_seen)
        if health_seen[0] != "warming" or risk_seen[-1] != "ok":
            raise AssertionError(f"/healthz went {health_seen}, risk {risk_seen}")
        text = server.text()
        for stage in ("serve_load", "serve_warm"):
            m_stage = re.search(rf"\[stage\] {stage}: done in ([\d.]+)s", text)
            stats[f"{stage}_s"] = float(m_stage.group(1)) if m_stage else None
        # the throughput wave: two full batches
        before = _metrics(port)
        t0 = time.perf_counter()
        results, latencies = _concurrent_posts(port, wave)
        wave_s = time.perf_counter() - t0
        after = _metrics(port)
        batch_s = [float(s) for s in re.findall(r"serve: batch of 8/8 in ([\d.]+)s",
                                                 server.text())]
        stats.update(wave_s=wave_s, images_per_s=len(wave) / wave_s,
                     wave_batches=after["batches_total"] - before["batches_total"],
                     server_full_batch_s=batch_s,
                     latency_p50_s=_percentile(latencies, 50),
                     latency_p99_s=_percentile(latencies, 99),
                     server_latency_ms=after["latency_ms"], cache=after["cache"],
                     completed_total=after["completed_total"],
                     batch_occupancy_max=after["batch_occupancy_max"])
        codes = [c for c, _ in results]
        docs = [d for _, d in results]
        risk = [d.get("copy_risk") for d in docs]
        images = [decode_png(base64.b64decode(d["image_png_b64"])) for d in docs
                  if "image_png_b64" in d]
        stats["planted_copy_risk"] = risk[0]
        stats["others_max_sim"] = max(r["max_sim"] for r in risk[1:] if r)
        if (codes != [200] * len(wave) or len(images) != len(wave)
                or any(i.shape != (256, 256, 3) for i in images)):
            raise AssertionError(f"the wave answered {codes}, images "
                                 f"{[i.shape for i in images]}")
        if any(r is None for r in risk):
            raise AssertionError(f"unscored responses: {[r is None for r in risk]}")
        if not (risk[0]["flagged"] and risk[0]["max_sim"] >= 0.99
                and risk[0]["top_key"] == planted_key):
            raise AssertionError(f"the planted copy was not flagged top-1: {risk[0]}")
        if any(r["flagged"] for r in risk[1:]):
            raise AssertionError(f"unrelated generations flagged: {risk}")
        if not np.array_equal(images[0], planted_png):
            raise AssertionError("the served planted image differs from the in-process one: "
                                 f"max |diff| {np.abs(images[0].astype(int) - planted_png).max()}")
        if (after["completed_total"] != len(wave) or after["cache"]["hits"] < 12
                or after["batch_occupancy_max"] != 1.0):
            raise AssertionError(f"metrics after the wave: {after}")
        # Prometheus text parses; a bad sampler is a 400
        code, _, raw = _http(port, "/metrics?format=prometheus")
        samples = {}
        for line in raw.decode().splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        stats["prometheus_samples"] = len(samples)
        if (code != 200 or samples.get("dcr_serve_completed_total") != len(wave)
                or samples.get("dcr_copy_risk_flagged_total") != 1):
            raise AssertionError(f"prometheus: {code}, {len(samples)} samples")
        code, _, _ = _http(port, "/generate", {"prompt": "x", "sampler": "bogus"})
        if code != 400:
            raise AssertionError(f"a bad sampler answered {code}")
        # /check with the planted PNG
        check_s, check = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            code, _, raw = _http(port, "/check", {"image_png_b64": docs[0]["image_png_b64"]})
            check_s.append(time.perf_counter() - t0)
            check = json.loads(raw)
        stats.update(check_ms=[1e3 * s for s in check_s], check=check)
        if code != 200 or check["top_key"] != planted_key or not check["flagged"]:
            raise AssertionError(f"/check: {code} {check}")
        # a fast_ratio 0.5 bucket: 8 run, 2 wait; a third bucket is refused;
        # SIGTERM with the queued batch pending
        from concurrent.futures import ThreadPoolExecutor

        fast_wave = [{"prompt": SERVE_PROMPTS[i % 4], "seed": 100 + i, "fast_ratio": 0.5}
                     for i in range(10)]
        before = _metrics(port)
        with ThreadPoolExecutor(max_workers=len(fast_wave)) as ex:
            futs = [ex.submit(_http, port, "/generate", body) for body in fast_wave]
            deadline = time.monotonic() + 120
            while _metrics(port)["requests_total"] < before["requests_total"] + len(fast_wave):
                if time.monotonic() > deadline:
                    raise AssertionError("the fast wave was not admitted")
                time.sleep(0.01)
            code, _, raw = _http(port, "/generate", {"prompt": "x", "steps": 20})
            stats["third_bucket"] = [code, json.loads(raw).get("error")]
            queued = _metrics(port)["queue_depth"]
            t0 = time.perf_counter()
            server.proc.send_signal(signal.SIGTERM)
            fast_codes = [f.result(timeout=300)[0] for f in futs]
            rc = server.proc.wait(timeout=300)
        stats.update(fast_codes=fast_codes, queued_at_sigterm=queued, exit_code=rc,
                     drain_s=time.perf_counter() - t0)
        if queued < 1:
            raise AssertionError("no batch was queued when SIGTERM came")
        if stats["third_bucket"] != [503, "bucket_limit"]:
            raise AssertionError(f"a third bucket answered {stats['third_bucket']}")
        if fast_codes != [200] * len(fast_wave) or rc != 83:
            raise AssertionError(f"drain: codes {fast_codes}, exit {rc}\n"
                                 + server.text()[-4000:])
    finally:
        server.close()
    stats["server_log_tail"] = server.text()[-1500:].splitlines()[-8:]
    log(f"serve ({CARD[0]}): {json.dumps({k: v for k, v in stats.items() if k != 'check'})}")
    return stats


def tie_rule(what: str, scores_a, keys_a, scores_b, keys_b, exact, *, bound: float = 1e-5,
             gap: float = 2e-5) -> dict:
    """Two top-k tables of unit queries over unit rows agree: scores within
    ``bound`` (1e-5 * |q| * |x|), keys equal at every rank whose reference
    score is more than ``gap`` away from the reference scores on either side
    (``exact``: [n, >= k] descending reference scores, a (k+1)-th column
    where the corpus has one). Near-ties may swap. Raises otherwise."""
    import numpy as np

    scores_a, scores_b = np.asarray(scores_a, np.float64), np.asarray(scores_b, np.float64)
    n, k = scores_a.shape
    ref = np.full((n, k + 2), -np.inf)
    ref[:, 0] = np.inf
    ref[:, 1:1 + min(k + 1, exact.shape[1])] = exact[:, :k + 1]
    above = ref[:, :k] - ref[:, 1:k + 1]
    below = ref[:, 1:k + 1] - ref[:, 2:k + 2]
    decided = np.minimum(above, below) > gap
    finite = np.isfinite(scores_a) & np.isfinite(scores_b)
    err = float(np.abs(scores_a - scores_b)[finite].max()) if finite.any() else 0.0
    mismatch = int(((np.asarray(keys_a) != np.asarray(keys_b)) & decided).sum())
    out = {"max_abs_score_diff": err, "bound": bound, "decided_ranks": int(decided.sum()),
           "ranks": n * k, "key_mismatches": mismatch,
           "same_inf_pads": bool((np.isneginf(scores_a) == np.isneginf(scores_b)).all())}
    if err > bound or mismatch or not out["same_inf_pads"]:
        raise AssertionError(f"{what}: the tie rule fails: {out}")
    return out


def _unit_rows(n: int, dim: int, seed: int):
    """float32 [n, dim] of L2-normalised seeded Gaussian rows, drawn on the
    card (fast at the LAION-chunk scale) and returned on the host."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, dim), generator=g, device="cuda")
    return torch.nn.functional.normalize(x, dim=1).cpu().numpy()


def _exact_topk(q, chunks, k: int):
    """float64 top-k scores and keys of ``q`` over the chunks [(feats, keys)],
    on the host in blocks of 65536 rows."""
    import numpy as np

    q64 = np.asarray(q, np.float64)
    best_s = np.full((len(q), 0), -np.inf)
    best_k = np.zeros((len(q), 0), object)
    for feats, keys in chunks:
        keys = np.asarray(keys, object)
        for start in range(0, len(feats), 65536):
            s = q64 @ feats[start:start + 65536].astype(np.float64).T
            top = np.argpartition(-s, min(k, s.shape[1]) - 1, axis=1)[:, :k]
            all_s = np.concatenate([best_s, np.take_along_axis(s, top, 1)], 1)
            all_k = np.concatenate([best_k, keys[start:start + 65536][top]], 1)
            order = np.argsort(-all_s, axis=1, kind="stable")[:, :k]
            best_s = np.take_along_axis(all_s, order, 1)
            best_k = np.take_along_axis(all_k, order, 1)
    return best_s, best_k


def phase_small_search_reference(root: Path) -> dict:
    """Phase 12: a store of 8,192 unit rows x 512 (two dumps, shards of 1,024
    rows) queried in segments of 2,048 rows (4 segments) by 100 unit queries
    (10 of them store rows) at top_k=5, resident and streamed
    (max_resident_rows=1): the card against the CPU, and on the card the
    store against search_folders over the same dumps, each under the tie
    rule with a float64 reference; no flash launch."""
    import numpy as np

    from dcr_tpu_torch.search import embed as E
    from dcr_tpu_torch.search import search as S
    from dcr_tpu_torch.search import shardindex as SI
    from dcr_tpu_torch.search import store as ST

    feats = _unit_rows(8192, 512, seed=12)
    keys = [f"small{i // 4096}/{i % 4096}" for i in range(8192)]
    folders = []
    for c in range(2):
        folder = root / f"chunk{c}"
        folder.mkdir()
        E.save_embeddings(folder / "embedding.npz", feats[c * 4096:(c + 1) * 4096],
                          keys[c * 4096:(c + 1) * 4096])
        folders.append(folder)
    store = root / "store"
    ST.ingest_dumps(ST.EmbeddingStoreWriter.create(store, shard_rows=1024), folders)
    q = _unit_rows(100, 512, seed=13)
    q[::10] = feats[::820][:10]
    exact, _ = _exact_topk(q, [(feats, keys)], 6)
    reset_launches()
    results, stats = {}, {}
    for mode, limit in (("resident", SI.DEFAULT_MAX_RESIDENT_ROWS), ("streamed", 1)):
        for dev in ("cuda", "cpu"):
            eng = SI.ShardedTopK(ST.EmbeddingStoreReader(store), top_k=5, query_batch=64,
                                 segment_rows=2048, max_resident_rows=limit, device=dev).build()
            if eng.num_segments != 4 or eng.resident != (mode == "resident"):
                raise AssertionError(f"small search: {mode} engine has {eng.num_segments} "
                                     f"segments, resident={eng.resident}")
            results[mode, dev] = eng.query(q)
        stats[f"{mode}_card_vs_cpu"] = tie_rule(f"small search {mode}", *results[mode, "cuda"],
                                                *results[mode, "cpu"], exact)
    brute = S.search_folders(q, [f"g{i}" for i in range(100)], folders, top_k=5, num_chunks=3,
                             device="cuda")
    stats["store_vs_brute_on_card"] = tie_rule("small search store vs brute force",
                                               *results["resident", "cuda"], brute["scores"],
                                               brute["keys"], exact)
    launches = read_launches()
    top1 = results["resident", "cuda"][1][::10, 0].tolist()
    stats.update({"copies_top1": top1 == keys[::820][:10], "launches_fwd_dq_dkv": launches})
    log(f"small search reference (8,192 x 512, 4 segments, 100 queries, top_k=5): "
        f"{json.dumps(stats)}")
    if not stats["copies_top1"] or launches != (0, 0, 0):
        raise AssertionError(f"small search reference failed: {stats}")
    return stats


SEARCH_DIM, SEARCH_CHUNK_ROWS, SEARCH_QUERIES, SEARCH_COPIES = 512, 1 << 20, 4096, 64


def _write_laion_tars(root: Path, n_tars: int, per_tar: int) -> int:
    """webdataset tars of ``per_tar`` 256x256 JPEGs each (img2dataset's
    center_crop 256 output), written by the port's encoder at quality 90,
    with a caption member beside each image, and one corrupt JPEG in the
    first tar. Returns the JPEGs that decode."""
    import io
    import tarfile

    from dcr_tpu_torch.native.jpeg_helper import encode

    root.mkdir(parents=True)
    for t in range(n_tars):
        with tarfile.open(root / f"{t:05d}.tar", "w") as tf:
            members = []
            for i in range(per_tar):
                key = f"{t:05d}{i:04d}"
                members.append((f"{key}.jpg", encode(_photo(t * per_tar + i, 256, 256), 90)))
                members.append((f"{key}.txt", f"a caption {key}".encode()))
            if t == 0:
                members.append(("corrupt.jpg", b"\xff\xd8\xff\xe0 not a jpeg"))
            for name, data in members:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return n_tars * per_tar


def _search_embed(root: Path) -> dict:
    """The embed stage: SSCD ResNet-50 at 224, batch 128 (SearchConfig's
    defaults), seeded weights, over 2 tars of 512 JPEGs + 1 corrupt member.
    Host ms (decode, resize, crop, normalise, stack) against device ms
    (CUDA events around the extractor's call: upload + forward) per batch."""
    import numpy as np

    from dcr_tpu_torch.core.config import SearchConfig
    from dcr_tpu_torch.search import embed as E

    t0 = time.perf_counter()
    n_images = _write_laion_tars(root / "tars", 2, 512)
    write_s = time.perf_counter() - t0
    batches, make = [], E.make_extractor
    last = [0.0]

    def timed_make_extractor(forward, device, **kw):
        fn = make(forward, device, **kw)
        last[0] = time.perf_counter()      # the model is built: batches start

        def timed(images):
            host_ms = 1e3 * (time.perf_counter() - last[0])
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(images)
            end.record()
            end.synchronize()
            batches.append({"n": len(images), "host_ms": host_ms,
                            "device_ms": start.elapsed_time(end)})
            last[0] = time.perf_counter()
            return out
        return timed

    E.make_extractor = timed_make_extractor
    (root / "gen_embed").mkdir()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = E.embed_images(SearchConfig(), source=root / "tars",
                             out_path=root / "gen_embed" / "embedding.npz", device="cuda")
    finally:
        E.make_extractor = make
    embed_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    feats, keys = E.load_embeddings(out)
    # SSCD on one resident contiguous NCHW batch of 128 alone (phase 10's
    # measure at 64), beside the batches above (NHWC host arrays uploaded
    # and permuted)
    from dcr_tpu_torch.eval.runner import build_backbone

    model = build_backbone("sscd", "resnet50_disc", "cuda", seed=0)
    x = torch.randn((128, 3, 224, 224), generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            model(x)
        end.record()
        end.synchronize()
    del model, x
    stats = {"images": len(keys), "write_tars_s": write_s, "embed_s": embed_s,
             "sscd_batch128_alone_device_ms": start.elapsed_time(end) / 5,
             "images_per_s": len(keys) / embed_s, "batches": len(batches),
             "host_ms_per_batch": statistics.mean(b["host_ms"] for b in batches),
             "device_ms_per_batch": statistics.mean(b["device_ms"] for b in batches),
             "host_ms_per_batch_median": statistics.median(b["host_ms"] for b in batches),
             "device_ms_per_batch_median": statistics.median(b["device_ms"] for b in batches),
             "device_busy_share": sum(b["device_ms"] for b in batches) / 1e3 / embed_s,
             "peak_bytes": peak}
    if (feats.shape != (n_images, SEARCH_DIM) or not np.isfinite(feats).all()
            or len(set(keys)) != n_images or any(k.endswith("corrupt") for k in keys)
            or [b["n"] for b in batches] != [128] * 8):
        raise AssertionError(f"search embed failed: {feats.shape}, {len(set(keys))} keys, "
                             f"{stats}")
    return stats


def _cli(argv: list[str]) -> tuple[float, list]:
    """dcr-search-torch with ``argv``: its seconds and the JSON documents it
    printed."""
    import contextlib
    import io

    from dcr_tpu_torch.cli import search as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    seconds = time.perf_counter() - t0
    text, docs, dec = buf.getvalue(), [], json.JSONDecoder()
    pos = 0
    while text[pos:].strip():
        if text[pos:].lstrip().startswith("{"):
            doc, end = dec.raw_decode(text[pos:].lstrip())
            pos = len(text) - len(text[pos:].lstrip()) + end
            docs.append(doc)
        else:
            pos = text.index("\n", pos) + 1 if "\n" in text[pos:] else len(text)
    return seconds, docs


class EngineProbe:
    """Times the top-k engine while installed: the query call (host clock,
    synchronised), each segment upload and each topk call (CUDA events)."""

    def __init__(self):
        from dcr_tpu_torch.search import shardindex as SI

        self.SI = SI
        self.saved = (SI.ShardedTopK.query, SI.ShardedTopK._put_segment, SI.topk,
                      SI.ShardedTopK.build)
        self.query_s, self.build_s, self.uploads, self.topk_events = [], [], [], []

    def __enter__(self) -> "EngineProbe":
        SI = self.SI
        query, put, topk, build = self.saved

        def timed_build(eng):
            t0 = time.perf_counter()
            out = build(eng)
            torch.cuda.synchronize()
            self.build_s.append(time.perf_counter() - t0)
            return out

        def timed_query(eng, q):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = query(eng, q)
            torch.cuda.synchronize()
            self.query_s.append(time.perf_counter() - t0)
            self.resident = eng.resident
            return out

        def timed_put(eng, seg):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = put(eng, seg)
            end.record()
            self.uploads.append((start, end, seg[0].numel() * 4 + seg[1].numel()))
            return out

        def timed_topk(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = topk(*a, **kw)
            end.record()
            self.topk_events.append((start, end))
            return out

        SI.ShardedTopK.query, SI.ShardedTopK._put_segment = timed_query, timed_put
        SI.ShardedTopK.build, SI.topk = timed_build, timed_topk
        return self

    def __exit__(self, *exc) -> None:
        SI = self.SI
        (SI.ShardedTopK.query, SI.ShardedTopK._put_segment, SI.topk,
         SI.ShardedTopK.build) = self.saved

    def report(self, rows: int, queries: int, dim: int) -> dict:
        torch.cuda.synchronize()
        upload_ms = sum(s.elapsed_time(e) for s, e, _ in self.uploads)
        upload_bytes = sum(b for _, _, b in self.uploads)
        topk_ms = sum(s.elapsed_time(e) for s, e in self.topk_events)
        q_s = sum(self.query_s)
        flops = 2.0 * rows * queries * dim
        t_bytes = 4.0 * (rows * dim + queries * dim) / PEAK_BYTES
        # the bound at the rate the engine's f32 matmul runs at (CUDA cores,
        # TF32 off), and at split TF32's (f32-accurate on the tensor cores)
        bound_s = max(flops / PEAK_FLOPS_F32_CUDA_CORES, t_bytes)
        bound_tf32x3_s = max(flops / PEAK_FLOPS[torch.float32], t_bytes)
        return {"resident": self.resident, "engine_build_s": sum(self.build_s),
                "query_call_s": q_s, "rows_x_queries_per_s": rows * queries / q_s,
                "bound_s": bound_s, "bound_by": ("operations" if flops
                                                 / PEAK_FLOPS_F32_CUDA_CORES >= t_bytes
                                                 else "bytes"),
                "share_of_bound": bound_s / q_s, "bound_split_tf32_s": bound_tf32x3_s,
                "share_of_bound_split_tf32": bound_tf32x3_s / q_s,
                "topk_calls": len(self.topk_events),
                "topk_device_ms": topk_ms, "segment_uploads": len(self.uploads),
                "upload_ms": upload_ms,
                "upload_gb_per_s": upload_bytes / upload_ms / 1e6 if upload_ms else None,
                "device_busy_share": (topk_ms + upload_ms) / 1e3 / q_s}


def phase_search_main_path(root: Path) -> dict:
    """Phase 13: the LAION search stage through dcr-search-torch at SSCD's
    width (512) and a LAION-chunk scale: embed (SSCD over 2 tars of 512
    JPEGs), build a store from 2 chunk folders of reference-format pickle
    dumps of 1,048,576 unit rows each (2,097,152 rows, 4.3 GB, 32 shards of
    65,536), verify it, query it with 4,096 generation rows (64 of them
    planted copies, normalize(store row + 0.05 noise)) at top_k=1 and 10
    (host-streamed: above DEFAULT_MAX_RESIDENT_ROWS), query a resident
    one-chunk store, and run the brute force (num_chunks=20) over the same
    folders. Held: every planted copy top-1 with its key, a float64 oracle
    over the whole store for 64 queries, the brute force against the store,
    the top-1 table against the top-10's first column, all under the tie
    rule; 0 flash launches."""
    import pickle

    import numpy as np

    from dcr_tpu_torch.search import embed as E
    from dcr_tpu_torch.search import store as ST

    reset_launches()
    stats = {"embed": _search_embed(root / "embed")}
    log(f"search main path, embed: {json.dumps(stats['embed'])}")

    # the two LAION chunks: reference-format pickles of unit rows
    t0 = time.perf_counter()
    laion, chunks = root / "laion", []
    for c in range(2):
        folder = laion / f"chunk{c}"
        folder.mkdir(parents=True)
        feats = _unit_rows(SEARCH_CHUNK_ROWS, SEARCH_DIM, seed=100 + c)
        keys = [f"{c:05d}{i:07d}" for i in range(SEARCH_CHUNK_ROWS)]
        with open(folder / "embedding.pkl", "wb") as f:
            pickle.dump({"features": feats, "indexes": keys}, f, protocol=4)
        chunks.append((feats, keys))
    dump_bytes = sum((laion / f"chunk{c}" / "embedding.pkl").stat().st_size for c in range(2))
    stats["write_dumps_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(13)
    q = _unit_rows(SEARCH_QUERIES, SEARCH_DIM, seed=200)
    planted_rows = rng.choice(2 * SEARCH_CHUNK_ROWS, SEARCH_COPIES, replace=False)
    planted_q = rng.choice(SEARCH_QUERIES, SEARCH_COPIES, replace=False)
    planted_keys = []
    for qi, row in zip(planted_q, planted_rows):
        feats, keys = chunks[row // SEARCH_CHUNK_ROWS]
        x = feats[row % SEARCH_CHUNK_ROWS] + 0.05 * rng.standard_normal(SEARCH_DIM)
        q[qi] = (x / np.linalg.norm(x)).astype(np.float32)
        planted_keys.append(keys[row % SEARCH_CHUNK_ROWS])
    gens = root / "gens"
    gens.mkdir()
    E.save_embeddings(gens / "embedding.npz", q, [f"gen{i}" for i in range(SEARCH_QUERIES)])

    store, store1 = root / "store", root / "store_one_chunk"
    build_s, (report,) = _cli(["build", f"--store_dir={store}", f"--laion_folder={laion}",
                               "--shard_rows=65536"])
    store_bytes = sum(p.stat().st_size for p in store.glob("shard_*.npz"))
    verify_s, (verify,) = _cli(["verify", f"--store_dir={store}"])
    stats["build"] = {"report": report, "ingest_s": build_s, "store_bytes": store_bytes,
                      "dump_bytes": dump_bytes, "ingest_gb_per_s": store_bytes / build_s / 1e9,
                      "verify": verify, "verify_s": verify_s,
                      "verify_gb_per_s": store_bytes / verify_s / 1e9}
    log(f"search main path, build + verify: {json.dumps(stats['build'])}")
    if (report["rows"] != 2 * SEARCH_CHUNK_ROWS or report["shards"] != 32
            or verify != {"shards": 32, "ok": 32, "corrupt": 0,
                          "rows_ok": 2 * SEARCH_CHUNK_ROWS, "total": 2 * SEARCH_CHUNK_ROWS}):
        raise AssertionError(f"search build/verify failed: {report}, {verify}")

    stats["build"]["one_chunk_ingest_s"], _ = _cli([
        "build", f"--store_dir={store1}", f"--dumps={laion / 'chunk0' / 'embedding.pkl'}",
        "--shard_rows=65536"])
    tables = {}
    for name, s, k in (("streamed_k1", store, 1), ("streamed_k10", store, 10),
                       ("resident_one_chunk_k10", store1, 10)):
        out = root / f"{name}.npz"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with EngineProbe() as probe:
            cli_s, _ = _cli(["query", f"--store_dir={s}", f"--gen_folder={gens}",
                             f"--out_path={out}", f"--top_k={k}"])
        rows = SEARCH_CHUNK_ROWS * (1 if s == store1 else 2)
        entry = {"cli_s": cli_s, "top_k": k, "rows": rows,
                 "peak_bytes": torch.cuda.max_memory_allocated(),
                 **probe.report(rows, SEARCH_QUERIES, SEARCH_DIM)}
        with np.load(out) as z:
            tables[name] = (z["scores"], z["keys"].astype(object))
        stats[name] = entry
        log(f"search main path, query {name}: {json.dumps(entry)}")
    if stats["streamed_k10"]["resident"] or not stats["resident_one_chunk_k10"]["resident"]:
        raise AssertionError("search: the 2M-row store must stream, the 1M-row one stay "
                             "resident")

    # planted copies: top-1 with their keys (in the one-chunk store, those of chunk 0)
    s1, k1 = tables["streamed_k1"]
    found = [k1[qi, 0] == key for qi, key in zip(planted_q, planted_keys)]
    in_chunk0 = [row < SEARCH_CHUNK_ROWS for row in planted_rows]
    kr = tables["resident_one_chunk_k10"][1]
    found_resident = [kr[qi, 0] == key for qi, key, c0 in
                      zip(planted_q, planted_keys, in_chunk0) if c0]
    # the float64 oracle over the whole store: 32 planted and 32 other queries
    others = np.setdiff1d(np.arange(SEARCH_QUERIES), planted_q)[:32]
    oracle_q = np.concatenate([planted_q[:32], others])
    t0 = time.perf_counter()
    ex_s, ex_k = _exact_topk(q[oracle_q], chunks, 11)
    oracle_s = time.perf_counter() - t0
    s10, k10 = tables["streamed_k10"]
    checks = {
        "oracle_vs_store_k10": tie_rule("search oracle", s10[oracle_q], k10[oracle_q],
                                        ex_s[:, :10], ex_k[:, :10], ex_s),
        "oracle_vs_store_k1": tie_rule("search oracle top-1", s1[oracle_q], k1[oracle_q],
                                       ex_s[:, :1], ex_k[:, :1], ex_s),
        "store_k1_vs_k10": tie_rule("search top-1 vs top-10", s1, k1, s10[:, :1], k10[:, :1],
                                    s10, gap=4e-5),
    }
    ex1_s, ex1_k = _exact_topk(q[oracle_q], chunks[:1], 11)
    sr, kr = tables["resident_one_chunk_k10"]
    checks["oracle_vs_resident_k10"] = tie_rule("search oracle, one chunk", sr[oracle_q],
                                                kr[oracle_q], ex1_s[:, :10], ex1_k[:, :10],
                                                ex1_s)

    # the brute force over the same folders, top-11 so rank 10's gap is known
    brute_out = root / "brute.npz"
    torch.cuda.reset_peak_memory_stats()
    brute_s, _ = _cli(["search", f"--gen_folder={gens}", f"--laion_folder={laion}",
                       f"--out_path={brute_out}", "--num_chunks=20", "--top_k=11"])
    with np.load(brute_out) as z:
        bs, bk = z["scores"], z["keys"].astype(object)
    checks["brute_vs_store_k10"] = tie_rule("search brute force vs store", bs[:, :10],
                                            bk[:, :10], s10, k10, bs, gap=4e-5)
    launches = read_launches()
    stats["brute_force"] = {"cli_s": brute_s, "top_k": 11, "num_chunks": 20,
                            "peak_bytes": torch.cuda.max_memory_allocated(),
                            "rows_x_queries_per_s": 2 * SEARCH_CHUNK_ROWS * SEARCH_QUERIES
                            / brute_s}
    stats.update({"checks": checks, "oracle_s": oracle_s,
                  "copies_found": sum(found), "copies": len(found),
                  "copies_found_resident": sum(found_resident),
                  "copies_in_chunk0": len(found_resident),
                  "launches_fwd_dq_dkv": launches})
    log(f"search main path, checks: {json.dumps(checks)}; planted copies top-1 "
        f"{sum(found)}/{len(found)} (one-chunk store {sum(found_resident)}/"
        f"{len(found_resident)}); brute force {brute_s:.2f} s; flash launches {launches}")
    if not all(found) or not all(found_resident) or launches != (0, 0, 0):
        raise AssertionError(f"search main path failed: copies {sum(found)}/{len(found)}, "
                             f"one chunk {sum(found_resident)}/{len(found_resident)}, "
                             f"launches {launches}")
    return stats


# the ANN phase (16): one LAION chunk at SSCD's width, clustered as
# tools/bench_ann.py builds its corpus (random isotropic rows, like phase 13's,
# give an IVF quantizer nothing to learn)
ANN_ROWS, ANN_CLUSTERS, ANN_QUERIES, ANN_HOT = 1 << 20, 1024, 4096, 16
ANN_LISTS, ANN_ITERS, ANN_TOP_K = 1024, 10, 10
ANN_NPROBES = (1, 2, 4, 8, 16, 32, 1024)
# the JAX package's recall gate at the default nprobe (tools/bench_ann.py)
ANN_MIN_RECALL = 0.95


def _ann_corpus(rows: int, dim: int, clusters: int, queries: int, query_clusters: int,
                seed: int = 0):
    """tools/bench_ann.py's build_corpus, draw for draw: cluster centers x 4
    plus N(0, 0.25^2) noise per row, and queries that are corpus rows of
    ``query_clusters`` hot clusters plus N(0, 0.05^2) noise. Returns the
    rows, the queries and each query's source row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, clusters, rows)
    feats = centers[assign] + rng.standard_normal((rows, dim)).astype(np.float32) * 0.25
    hot = rng.choice(clusters, min(query_clusters, clusters), replace=False)
    pool = np.flatnonzero(np.isin(assign, hot))
    picks = rng.choice(pool, queries, replace=len(pool) < queries)
    q = feats[picks] + rng.standard_normal((queries, dim)).astype(np.float32) * 0.05
    return feats.astype(np.float32), q.astype(np.float32), picks


def _oracle_topk(q, feats, k: int):
    """float64 top-k scores and row indices of ``q`` over ``feats``, on the
    card (cuBLAS DGEMM) in chunks of 256 queries."""
    x = torch.from_numpy(feats).to("cuda", torch.float64)
    out_s, out_i = [], []
    for start in range(0, len(q), 256):
        qq = torch.from_numpy(q[start:start + 256]).to("cuda", torch.float64)
        s, i = torch.topk(qq @ x.T, k, dim=1)
        out_s.append(s.cpu())
        out_i.append(i.cpu())
    del x
    return torch.cat(out_s).numpy(), torch.cat(out_i).numpy()


def _union_reference(q, feats, row_of: dict, tables, k: int):
    """[n, k+1] descending float64 scores of each query over the rows that
    any of ``tables`` (key arrays) returned for it, -inf padded: the tie
    rule's reference for answers that rank a candidate set."""
    import numpy as np

    ref = np.full((len(q), k + 1), -np.inf)
    q64 = np.asarray(q, np.float64)
    for i in range(len(q)):
        rows = sorted({row_of[key] for t in tables for key in t[i] if key})
        s = np.sort(feats[rows].astype(np.float64) @ q64[i])[::-1][:k + 1]
        ref[i, :len(s)] = s
    return ref


class AnnProbe:
    """Times the IVF path while installed: train_ivf's k-means loop,
    assign_rows and list materialisation (host clock, synchronised), each
    k-means step and each scan (CUDA events), the engine's build and each
    query call (host clock, synchronised)."""

    def __init__(self):
        from dcr_tpu_torch.search import ann, annindex

        self.ann, self.ai = ann, annindex
        self.saved = (ann.kmeans, ann.make_kmeans_step, ann.assign_rows, ann._materialize_lists,
                      annindex.ivf_scan, annindex.AnnEngine.build, annindex.AnnEngine.query)
        self.host = {"kmeans": [], "assign_rows": [], "materialize": [], "engine_build": [],
                     "query": []}
        self.steps, self.scans = [], []

    def _host_timed(self, name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.host[name].append(time.perf_counter() - t0)
            return out
        return timed

    def _device_timed(self, events, fn):
        def timed(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            events.append((start, end))
            return out
        return timed

    def __enter__(self) -> "AnnProbe":
        ann, ai = self.ann, self.ai
        kmeans, make_step, assign, materialize, scan, build, query = self.saved

        def timed_make_step(n_lists):
            return self._device_timed(self.steps, make_step(n_lists))

        ann.kmeans = self._host_timed("kmeans", kmeans)
        ann.make_kmeans_step = timed_make_step
        ann.assign_rows = self._host_timed("assign_rows", assign)
        ann._materialize_lists = self._host_timed("materialize", materialize)
        ai.ivf_scan = self._device_timed(self.scans, scan)
        ai.AnnEngine.build = self._host_timed("engine_build", build)
        ai.AnnEngine.query = self._host_timed("query", query)
        return self

    def __exit__(self, *exc) -> None:
        ann, ai = self.ann, self.ai
        (ann.kmeans, ann.make_kmeans_step, ann.assign_rows, ann._materialize_lists, ai.ivf_scan,
         ai.AnnEngine.build, ai.AnnEngine.query) = self.saved

    def report(self) -> dict:
        torch.cuda.synchronize()
        step_ms = [s.elapsed_time(e) for s, e in self.steps]
        scan_ms = [s.elapsed_time(e) for s, e in self.scans]
        out = {k: sum(v) for k, v in self.host.items() if v}
        out.update({"kmeans_steps": len(step_ms), "scans": len(scan_ms),
                    "scan_device_ms": sum(scan_ms)})
        if step_ms:
            out["kmeans_step_ms_median"] = statistics.median(step_ms)
            out["kmeans_step_ms_max"] = max(step_ms)
        if self.host["query"]:
            out["device_busy_share_of_query"] = sum(scan_ms) / 1e3 / sum(self.host["query"])
        self.steps.clear()
        self.scans.clear()
        for v in self.host.values():
            v.clear()
        return out


def _kmeans_step_bound_ms(rows: int, dim: int, lists: int) -> tuple[float, str]:
    """Least time of one k-means step over a segment: scores (2 R D L flops)
    and the one-hot sums (2 R L D) at the CUDA cores' f32 rate (TF32 off);
    the segment and centroids read once, sums and counts written once."""
    flops = 4.0 * rows * dim * lists
    nbytes = 4.0 * (rows * dim + rows + lists * dim + lists * dim + lists)
    t_ops, t_bytes = flops / PEAK_FLOPS_F32_CUDA_CORES, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _ann_small_store_drills(root: Path) -> dict:
    """On a small store of 65,536 rows of the same corpus recipe (64
    clusters, 64 lists): the card's answers against the port's CPU answers
    under the tie rule; ivf_list_corrupt@load=3 at the engine's build (one
    list quarantined, counted, rebuilt from the store, answers equal to the
    unfaulted engine's); kmeans_nan@iter=2 through train-ivf (one restart)."""
    import numpy as np

    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.search import ann
    from dcr_tpu_torch.search import annindex as AI
    from dcr_tpu_torch.search import store as ST
    from dcr_tpu_torch.utils import faults

    feats, q, _ = _ann_corpus(65536, SEARCH_DIM, 64, 512, 8, seed=1)
    keys = [f"small{i:05d}" for i in range(len(feats))]
    store = root / "small_store"
    with ST.EmbeddingStoreWriter.create(store, shard_rows=8192) as w:
        w.add(feats, keys)
        w.finalize()
    report = ann.train_ivf(store, n_lists=64, iters=ANN_ITERS, device="cuda")
    card = AI.open_ann_engine(store, top_k=ANN_TOP_K, device="cuda")
    cpu = AI.open_ann_engine(store, top_k=ANN_TOP_K, device="cpu")
    (cs, ck), (ps, pk) = card.query(q), cpu.query(q)
    row_of = {k: i for i, k in enumerate(keys)}
    bound = 1e-5 * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(feats, axis=1).max())
    ref = _union_reference(q, feats, row_of, (ck, pk), ANN_TOP_K)
    stats = {"rows": len(feats), "train": report,
             "card_vs_cpu": tie_rule("ann small store, card vs CPU", cs, ck, ps, pk, ref,
                                     bound=bound, gap=2 * bound)}

    counters = tracing.registry().counters("ann/")
    faults.install("ivf_list_corrupt@load=3")
    try:
        faulted = AI.open_ann_engine(store, top_k=ANN_TOP_K, device="cuda")
    finally:
        faults.clear()
    after = tracing.registry().counters("ann/")
    fs, fk = faulted.query(q)
    stats["ivf_list_corrupt"] = {
        "quarantined": after.get("ann/ivf_list_corrupt", 0)
        - counters.get("ann/ivf_list_corrupt", 0),
        "rebuilt": after.get("ann/list_rebuilt", 0) - counters.get("ann/list_rebuilt", 0),
        "failed_lists": list(faulted.ann.failed_lists),
        "snapshot_after": ann.ann_snapshot_version(store), "rows": faulted.total,
        "vs_unfaulted": tie_rule("ann fault drill, faulted vs unfaulted", fs, fk, cs, ck,
                                 _union_reference(q, feats, row_of, (fk, ck), ANN_TOP_K),
                                 bound=0.0, gap=0.0)}
    faults.install("kmeans_nan@iter=2")
    try:
        _, (nan_report,) = _cli(["train-ivf", f"--store_dir={store}", "--n_lists=64",
                                 f"--ivf_iters={ANN_ITERS}"])
    finally:
        faults.clear()
    stats["kmeans_nan"] = {"report": nan_report,
                           "restart_counter": tracing.registry().counters("ann/").get(
                               "ann/kmeans_restart", 0) - after.get("ann/kmeans_restart", 0)}
    d = stats["ivf_list_corrupt"]
    if (report["restarts"] != 0 or d["quarantined"] != 1 or d["rebuilt"] != 1
            or len(d["failed_lists"]) != 1 or d["snapshot_after"] != 2
            or d["rows"] != len(feats) or nan_report["restarts"] != 1
            or stats["kmeans_nan"]["restart_counter"] != 1 or nan_report["snapshot"] != 3):
        raise AssertionError(f"ann small store drills failed: {json.dumps(stats, default=str)}")
    return stats


def phase_ann(root: Path) -> dict:
    """Phase 16: the IVF tier of dcr-search-torch at one LAION chunk: a
    clustered corpus of 1,048,576 rows x 512 (1,024 clusters; tools/
    bench_ann.py's recipe) built into a store, `train-ivf` with 1,024 lists
    and 10 iterations, `query --ann=true` at the default nprobe 8 and an
    in-process sweep over nprobe 1-32 and 1,024 against `query`'s exact
    answer for 4,096 queries from 16 hot clusters; k-means again from the
    same seed; the small-store drills. Held: each query's ANN top-1 at
    nprobe 8 is its float64 nearest row under the tie rule, recall@10 >=
    0.95 at nprobe 8, returned scores are exact dots (float64, 64 queries),
    nprobe = n_lists agrees with the exact engine, bit-identical centroids,
    the drills, 0 flash launches. The source row of a query is its float64
    top-1 only where no row of its cluster has a larger dot product: the
    share is reported, not held (the engines rank by dot product)."""
    import pickle

    import numpy as np

    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.search import ann
    from dcr_tpu_torch.search import annindex as AI
    from dcr_tpu_torch.search import embed as E

    t_phase = time.perf_counter()
    reset_launches()
    stats: dict = {"card": CARD[0]}
    t0 = time.perf_counter()
    feats, q, picks = _ann_corpus(ANN_ROWS, SEARCH_DIM, ANN_CLUSTERS, ANN_QUERIES, ANN_HOT)
    keys = np.asarray([f"ann{i:07d}" for i in range(ANN_ROWS)], dtype=object)
    dump, gens, store = root / "chunk" / "embedding.pkl", root / "gens", root / "store"
    dump.parent.mkdir()
    gens.mkdir()
    # a reference-format pickle, as phase 13 writes its chunks (an npz dump
    # is zlib-compressed: tens of seconds for 2 GB of random floats)
    with open(dump, "wb") as f:
        pickle.dump({"features": feats, "indexes": keys.tolist()}, f, protocol=4)
    E.save_embeddings(gens / "embedding.npz", q, [f"gen{i}" for i in range(ANN_QUERIES)])
    stats["corpus_s"] = time.perf_counter() - t0
    build_s, (build,) = _cli(["build", f"--store_dir={store}", f"--dumps={dump}",
                              "--shard_rows=65536"])
    stats["build"] = {"ingest_s": build_s, "rows": build["rows"], "shards": build["shards"]}

    # train-ivf through the command line, then k-means again from the same seed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with AnnProbe() as probe:
        train_s, (report,) = _cli(["train-ivf", f"--store_dir={store}",
                                   f"--n_lists={ANN_LISTS}", f"--ivf_iters={ANN_ITERS}"])
        train = {"cli_s": train_s, "report": report, **probe.report(),
                 "peak_bytes": torch.cuda.max_memory_allocated()}
    seg_rows = min(ANN_ROWS, ann.DEFAULT_TRAIN_SEGMENT_ROWS)
    bound_ms, bound_by = _kmeans_step_bound_ms(seg_rows, SEARCH_DIM, ANN_LISTS)
    train.update({"kmeans_step_bound_ms": bound_ms, "kmeans_step_bound_by": bound_by,
                  "kmeans_step_share_of_bound": bound_ms / train["kmeans_step_ms_median"]})
    committed = ann.AnnIndexReader(store).load_centroids()
    t0 = time.perf_counter()
    again, again_restarts = ann.kmeans(feats, ANN_LISTS, ANN_ITERS, 0, device="cuda")
    train["kmeans_again_s"] = time.perf_counter() - t0
    train["centroids_bit_identical"] = bool(np.array_equal(committed, again)
                                            and again_restarts == 0)
    stats["train"] = train
    log(f"ann main path, train-ivf ({CARD[0]}): {json.dumps(train)}")
    if (report["restarts"] != 0 or report["rows"] != ANN_ROWS or report["n_lists"] != ANN_LISTS
            or not train["centroids_bit_identical"]
            or train["kmeans_steps"] != -(-ANN_ROWS // seg_rows) * ANN_ITERS):
        raise AssertionError(f"ann train-ivf failed: {json.dumps(train)}")

    # the exact answer and the float64 oracle
    def query_cli(name, *extra):
        out = root / f"{name}.npz"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with AnnProbe() as aprobe, EngineProbe() as eprobe:
            cli_s, _ = _cli(["query", f"--store_dir={store}", f"--gen_folder={gens}",
                             f"--out_path={out}", f"--top_k={ANN_TOP_K}", *extra])
            entry = {"cli_s": cli_s, "peak_bytes": torch.cuda.max_memory_allocated(),
                     **({"ann": aprobe.report()} if extra else
                        {"exact": eprobe.report(ANN_ROWS, ANN_QUERIES, SEARCH_DIM)})}
        with np.load(out) as z:
            return entry, z["scores"], z["keys"].astype(object)

    stats["exact_query"], ex_s, ex_k = query_cli("exact")
    stats["ann_query_cli"], cli_s, cli_k = query_cli("ann", "--ann=true")
    t0 = time.perf_counter()
    or_s, or_i = _oracle_topk(q, feats, ANN_TOP_K + 1)
    stats["oracle_s"] = time.perf_counter() - t0
    or_k = keys[or_i]
    bound = 1e-5 * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(feats, axis=1).max())
    checks = {"exact_vs_oracle": tie_rule("ann exact engine vs float64", ex_s, ex_k,
                                          or_s[:, :ANN_TOP_K], or_k[:, :ANN_TOP_K], or_s,
                                          bound=bound, gap=2 * bound)}

    # the nprobe sweep on one engine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sweep, tables = {}, {}
    with AnnProbe() as probe:
        eng = AI.open_ann_engine(store, top_k=ANN_TOP_K, device="cuda")
        build_report = probe.report()
        for nprobe in ANN_NPROBES:
            before = tracing.registry().counters("ann/")
            s, k = eng.query(q, nprobe=nprobe)
            after = tracing.registry().counters("ann/")
            tables[nprobe] = (s, k)
            hits = sum(len(set(a[:ANN_TOP_K]) & set(e[:ANN_TOP_K])) for a, e in zip(k, ex_k))
            sweep[nprobe] = {
                "recall_at_10": hits / (ANN_QUERIES * ANN_TOP_K),
                "top1_is_source_row": float(np.mean(k[:, 0] == keys[picks])),
                **{f"segments_{w}": after.get(f"ann/segments_{w}_total", 0)
                   - before.get(f"ann/segments_{w}_total", 0) for w in ("scanned", "skipped")},
                **probe.report()}
        sweep_peak = torch.cuda.max_memory_allocated()
    s8, k8 = tables[8]
    row_of = {key: i for i, key in enumerate(keys)}
    checks["ann_nprobe8_top1_vs_oracle"] = tie_rule(
        "ann top-1 at nprobe 8 vs float64", s8[:, :1], k8[:, :1], or_s[:, :1], or_k[:, :1],
        or_s, bound=bound, gap=2 * bound)
    checks["ann_cli_vs_in_process_nprobe8"] = tie_rule(
        "ann query command vs engine", cli_s, cli_k, s8, k8,
        _union_reference(q, feats, row_of, (cli_k, k8), ANN_TOP_K), bound=bound, gap=2 * bound)
    checks["ann_full_probe_vs_exact"] = tie_rule(
        "ann at nprobe = n_lists vs exact engine", *tables[ANN_LISTS], ex_s, ex_k, or_s,
        bound=bound, gap=2 * bound)
    sample = np.random.default_rng(16).choice(ANN_QUERIES, 64, replace=False)
    dots = np.einsum("qd,qkd->qk", q[sample].astype(np.float64),
                     feats[[[row_of[x] for x in row] for row in k8[sample]]].astype(np.float64))
    checks["exact_dots_max_abs_err"] = float(np.abs(s8[sample] - dots).max())
    checks["exact_dots_bound"] = bound
    checks["source_row_is_float64_top1"] = float(np.mean(or_i[:, 0] == picks))
    launches = read_launches()
    stats.update({"engine_build": build_report, "sweep": sweep, "sweep_peak_bytes": sweep_peak,
                  "checks": checks, "launches_fwd_dq_dkv": launches})
    log(f"ann main path, queries ({CARD[0]}): exact {json.dumps(stats['exact_query'])}; "
        f"ann command {json.dumps(stats['ann_query_cli'])}; engine build "
        f"{json.dumps(build_report)}")
    for nprobe, row in sweep.items():
        log(f"ann main path, nprobe {nprobe}: {json.dumps(row)}")
    log(f"ann main path, checks: {json.dumps(checks)}; flash launches {launches}")
    if (sweep[8]["recall_at_10"] < ANN_MIN_RECALL
            or checks["exact_dots_max_abs_err"] > bound or launches != (0, 0, 0)):
        raise AssertionError(f"ann main path failed: recall@10 at nprobe 8 "
                             f"{sweep[8]['recall_at_10']}, dots "
                             f"{checks['exact_dots_max_abs_err']} > {bound}, launches {launches}")
    del eng, feats
    stats["drills"] = _ann_small_store_drills(root)
    log(f"ann small store drills ({CARD[0]}): {json.dumps(stats['drills'], default=str)}")
    if read_launches() != (0, 0, 0):
        raise AssertionError(f"the ann drills launched flash kernels: {read_launches()}")
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"ann phase 16: {stats['phase_s']:.1f} s")
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
        mitigation_stats = phase_mitigation(Path(tmp) / "sd21", Path(tmp))
        torch.cuda.empty_cache()
        serve_stats = phase_serve(Path(tmp) / "sd21", Path(tmp))
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
        fault_stats = phase_train_faults(Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        eval_stats = phase_eval_main_path(Path(tmp))
    if eval_stats["launches_fwd_dq_dkv"] != (0, 0, 0):
        raise AssertionError(f"the eval path launched flash kernels: "
                             f"{eval_stats['launches_fwd_dq_dkv']}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        backbone_stats = phase_backbones(Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        small_search = phase_small_search_reference(Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        search_stats = phase_search_main_path(Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ann_stats = phase_ann(Path(tmp))

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
    train_faults = dict(zip(("fwd", "dq", "dkv"), fault_stats["launches_fwd_dq_dkv"]))
    f32_train = dict(zip(("fwd", "dq", "dkv"), f32_train_stats["launches_fwd_dq_dkv"]))
    sample_cases = ("level0", "level1", "level2", "hook_level0", "hook_level1",
                    *(c[0] for c in MITIGATE_CASES), *SERVE_CASES)
    train_cases = ("train_level0", "train_level1")
    entries = [
        kernel_entry("fwd", "float32", kern["rows"], sample_cases,
                     {"sample": main_stats["launches"],
                      "sample_genuine": interop_stats["launches"],
                      "sample_fast": fast_stats["launches"],
                      "mitigate": mitigation_stats["launches"],
                      "serve": serve_stats["launches"],
                      "train_hook": train_stats["hook_launches_fwd_dq_dkv"][0],
                      "train_f32": f32_train["fwd"]},
                     tensor_cores("flash_fwd_tf32x3_kernel")),
        kernel_entry("fwd", "bfloat16", kern["rows"], train_cases,
                     {"train": train["fwd"], "train_faults": train_faults["fwd"]},
                     tensor_cores("flash_fwd_bf16_kernel")),
    ]
    for kind in ("dq", "dkv"):
        entries += [
            kernel_entry(kind, "float32", bwd["rows"], train_cases,
                         {"train_f32": f32_train[kind]},
                         tensor_cores(f"flash_bwd_{kind}_tf32x3_kernel")),
            kernel_entry(kind, "bfloat16", bwd["rows"], train_cases,
                         {"train": train[kind], "train_faults": train_faults[kind]},
                         tensor_cores(f"flash_bwd_{kind}_bf16_kernel")),
        ]
    entries[0]["per_shape"] = kern["rows"]
    entries[2]["per_shape"] = bwd["rows"]
    log(f"main path stats: {json.dumps(main_stats)}")
    log(f"checkpoint interop stats: {json.dumps(interop_stats)}")
    log(f"fast sampling stats: {json.dumps(fast_stats)}")
    log(f"train path stats: {json.dumps(train_stats)}")
    log(f"f32 train step stats: {json.dumps(f32_train_stats)}")
    log(f"training faults stats: {json.dumps(fault_stats, default=str)}")
    log(f"small train reference: {json.dumps(small_train)}")
    log(f"kernel limits: {json.dumps(limits)}")
    log(f"small eval reference: {json.dumps(small_eval)}")
    log(f"eval path stats: {json.dumps(eval_stats)}")
    log(f"jpeg codec stats: {json.dumps(codec)}")
    log(f"small dino eval reference: {json.dumps(small_dino)}")
    log(f"backbone stats: {json.dumps(backbone_stats)}")
    log(f"mitigation stats: {json.dumps(mitigation_stats)}")
    log(f"serve stats: {json.dumps({k: v for k, v in serve_stats.items() if k != 'check'})}")
    log(f"small search reference: {json.dumps(small_search)}")
    log(f"search path stats: {json.dumps(search_stats)}")
    log(f"ann path stats: {json.dumps(ann_stats, default=str)}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
