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
   the main paths' shapes (phase 23's per-rank shapes, SEQPAR_CASES and
   TP_CASES, included) and a few edge shapes, in f32 and bf16 (bf16
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
   (cli.mitigate.main) at 512 px, 10 steps, rand_noise_lam 0.1,
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
   apart from the steps' launches and times; the run's trace.jsonl through
   tools/trace_report.py (a train/step and a train/data_wait span per step,
   the Memory section's hbm samples) and mfu in every metrics row;
7. the f32 training mode: 2 steps of the train step (make_train_step) at
   SD-2.1 widths with mixed_precision="no"; 10 launches of each kernel per
   step, all in f32, finite losses;
15. training faults (after phase 7): Trainer(TrainConfig()) as in phase 6
   but with its UNet cut in depth to FAULTS_LAYERS_PER_BLOCK and two
   levels (SD-2.1's widths, so the kernels' shapes are phase 6's; 4 kernel
   attentions per step), on 48 JPEGs and one truncated JPEG with fault.max_bad_sample_frac 0.05,
   max_rollbacks 1 and DCR_FAULTS's decode_error, nan_loss, sigterm and
   ckpt_corrupt: bad samples retried, quarantined and replaced, a NaN rolled
   back, a SIGTERM checkpointed, the torn checkpoint quarantined on resume,
   the run trained to its end and exported; quarantine.jsonl and the
   faults/* metrics held to the expected records, 6 launches of each
   kernel per executed step at the train shapes in bf16; a straight run
   beside the resumed one. Seconds per step and per save with and without
   the manifest pass, restore seconds, the cost of a bad sample;
19. 8-bit AdamW (after 7): TrainConfig() with optim.use_8bit_adam, its
   train step for ADAM8_STEPS steps on seeded random weights: finite
   losses, 10 launches of each kernel per step in bf16, the 8-bit state's
   bytes equal to the formula; one more step from the same state with
   8-bit and with f32 AdamW: the optimizer's ms, the peaks (beside phase
   6's) and the largest parameter difference;
20. exit drills (beside phases 8, 4, 9b, 17a and 17b): four dcr-train-torch subprocesses at once: at
   the tiny kernel-shaped model sigterm@step=2 exits 83, hang@step=1 exits
   89 with a thread dump, oom@step=2 exits 85; at TrainConfig() in a
   process whose share of the card (OOM_LIMIT_BYTES) cannot hold the first
   step, a real torch.OutOfMemoryError exits 85; each with a
   flight-recorder dump holding its reason and the card's memory figures;
8. kernel limits (after phase 3): B*H = 66560, above the grid's y limit,
   with a misaligned q, forward and backward through the dispatcher and the
   autograd Function in both dtypes, against the plain versions;
9. small eval reference (while phase 2 builds): the port's run_eval on the card
   and on the CPU over one tiny folder, every scalar within 1e-4;
9b. small dino eval reference: the dino run_eval (ViT-S/16, its layer 2
   with splitloss, XCiT-S/16) on the card and on the CPU, within 1e-4;
10. eval main path: run_eval at the JAX defaults (SSCD at 224, the
   complexity stage, FID, precision/recall, CLIP score, galleries) on 128
   generations at 512 px (8 of them copies of training files) and 256
   training JPEGs at 256 px (EVAL_GENS, EVAL_COPIES, EVAL_TRAIN); scalars finite, the copies found, the
   artifacts written; stage seconds, SSCD images/s and ms per batch, host
   decode against device time, peak memory;
11. backbones: one run_eval each with dino_vitb8, dino_xcit_small_12_p16,
   dino_resnet50 and the CLIP image tower at full width over 500x375 JPEGs;
   device ms per batch of 64, images/s, peak memory;
12. small search reference (while phase 2 builds): a store of 8,192 unit rows x 512 in 4 segments
   of 2,048, 100 queries at top_k=5, resident and streamed: the card
   against the CPU, and the store against search_folders on the card,
   under the tie rule (scores within 1e-5 |q||x|, keys equal away from
   near-ties) against a float64 reference;
13. search main path (last), through dcr-search-torch: embed (SSCD at 224,
   batch 128, over 2 tars of 512 JPEGs at 256 px and a corrupt member),
   build from 2 reference-format pickle dumps of 1,048,576 and 262,144
   unit rows x 512 (20 shards of 65,536, 2.7 GB), verify, query 4,096 rows (64 planted
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
16. ANN (after the build, on a corpus made while phase 2 builds (16a); phase 17 serves its store), through dcr-search-torch: a store of 1,048,576 rows x
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
17. live provenance serving (inside 5b, after 16, on 5b's genuine SD-2.1
   and phase 16's raw store): `train-ivf --ivf_normalize=true` (1,024
   lists; a subprocess beside phase 20, 17a), then phase 14's bucket in-process behind the HTTP front end with
   --risk.ann=true, --ingest.enabled=true, batch_rows 1, compact_rows 8, the
   recall probe on every call, and ingest_stall before the 8th and 16th
   rows; 16 concurrent requests. Held before any ingest, on 256 queries
   made from corpus rows against a float64 oracle over the normalised
   rows: the served risk engine's top-1 and its rows' scores, and every
   rank through the same tier at nprobe 1,024 with a wide shortlist.
   Held after: 16 rows acked, none dropped; two
   compactions folding rows into exactly the lists they reach (every other
   list's entry byte-identical); every /check (in the tail, then
   committed) against a float64 oracle over the committed and acked rows
   under the tie rule; the online recall within 0.05 of spot_check_recall;
   1,500 B1 launches; each generation's store key gen/<its trace id>,
   read from the phase's trace.jsonl; the dcr_device_mem_* gauges and a
   novel bucket refused 503 memory_budget under a memory share cut for the
   drill (_serve_memory_drills); the exact store engine over the snapshot
   after ingest (past 2^20 rows) host-streamed.
   Drills on phase 16's 65,536-row store (ingest_crash
   and compact_crash in subprocesses, wal_torn, recall_degrade) and the
   JAX-written WAL of tests/fixtures/jax_wal_store, beside phase 20 (17b).
   Reported: ms per WAL
   append, compaction, fold and refresh seconds, risk ms per batch through
   ANN and through the exact store engine over the same snapshot, /check ms
   with a tail, probe ms, p50/p99, peak memory.
18. pipelined training (after 15): phase 6's configuration with
   data.random_flip=false on its 48 JPEGs: (a) 3 steps of the fused step
   against the encode stage + denoiser step from copies of one state, bit
   for bit; (b) dcr-precompute-latents-torch (its main) into shards of 16
   rows, no flash launch; (c) a Trainer fed by that latent cache and (d) a
   live-pipelined Trainer (pipe.enabled, depth 2), 6 steps each: 10
   launches of each kernel per step in bf16 at phase 6's shapes, the VAE
   encoder never called in (c), the two runs' losses within 2e-2 of each
   other; s per step beside phase 6's, the ring wait per step, the
   precompute's seconds, images/s, fingerprint seconds and bytes, peaks.
   Both Trainers skip the final save and export (phase 6 holds them).
22. serving fleet (inside 5b, after 14, on its genuine directory):
   dcr-serve-torch --fleet.workers=2 as a subprocess at phase 14's bucket,
   two worker processes on the card: (a) ready, the supervisor without a
   CUDA context; (b) phase 14's wave, every image phase 14's in-process
   image bit for bit; (c) worker_crash on worker 0 and (d) worker_hang on
   worker 1 (exit 89 under the batch watchdog, its budget 1.5x a
   two-worker batch): each batch requeued and
   answered bit for bit, the journal at 0 dropped and 0 failed, the worker
   respawned; (e) the merged Prometheus text with both workers' series,
   GET /slo, dcr-status-torch --json exit 0; (f) /debug/profile through
   the supervisor to worker 1, 10 forward-kernel events per UNet call in
   its trace; (g) SIGTERM with a wave in flight, every request answered,
   exit 83, no worker left. Under --warm.dir: each respawned worker warms
   the two buckets its previous incarnation ran (the warm manifest) and
   loads the B1 library from the cache; after (e), worker 0 killed with
   the manifest moved aside respawns warming the default bucket alone.
   Ready, wave, requeue and respawn seconds (with and without the
   manifest, the load and warm beside the first boot's), both
   workers' memory gauges and budgets: what both hold plus what either may
   still admit within the card's memory (phase_fleet);
23. multi-process training (inside phase 6's temp dir, on its 48 JPEGs):
   two rank subprocesses on cuda:0 run the Trainer (b) over gloo as data =
   2 (8 rows each, losses within rtol 1e-3 and grad norms within 2e-3 of
   phase 6's, Adam's first moment within 1e-1 of (a)'s, the ranks'
   parameters bit-equal, the gradients' all-reduce through host memory
   timed), (c) over gloo as seq = 2 at 512 px, global batch 2, phase 15's
   depth, Ulysses from 1,024 tokens (ring at level 0; B1/B2/B3 at
   SEQPAR_CASES' shapes per rank; losses, grad norms and Adam's first
   moment within the same bars of a single-process Trainer run here), (e)
   over gloo as fsdp = 2 at TrainConfig(), 8 rows each, and (f) as tensor
   = 2, 16 rows each (each: the bars of (b) against phase 6 and (a), the
   state held as shards, the peak per rank; (f) B1/B2/B3 at each rank's
   heads), (g) generate over gloo as tensor = 2 at SD-2.1, 512 px, 2 DDIM
   steps, f32, from phase 6's export, its PNGs within 1 uint8 level of a
   single-process generate run here, then (a) rank 0 alone over NCCL at
   TrainConfig() (losses and grad norms equal phase 6's first 3 bit for
   bit; join, barrier and agreement times); (d) NCCL refuses two ranks on
   one device ("Duplicate GPU detected"), an expected error;
24. search and eval on a mesh (right after 13): two rank processes on cuda:0
   join one gloo job and run, through dcr-search-torch's and
   dcr-eval-torch's main: (a) `query --mesh.data=2` over phase 13's store
   (streamed; a segment of two shards, so each rank reads half of them),
   its first 1,024 queries at top_k 10, under the tie rule against phase
   13's answer; (b) `query --ann=true` at nprobe 8 over phase 16's index
   (kept as phase 16 left it), under the tie rule against phase 16's
   answer, recall@10 within 1e-3 of it; (c) `embed` of phase 13's first tar
   in batches of 256 (each rank's 128 one of phase 13's batches): keys equal
   and in order, features within the f32 bar of phase 13's dump, each rank
   decoding only its half; (d) dcr-eval-torch over phase 10's folders at
   the JAX defaults: every scalar within the f32 bar of phase 10's,
   sim_gt_05pc equal, the planted copies top-1, the artifacts written.
   Both ranks return the same scalars; an audit hook shows rank 1 writes no
   file; 0 flash launches. Per rank: seconds, peak memory, store or index
   read and query seconds beside one process's, the candidate exchange's
   bytes, decode ms per image;
25. warm cache (beside phases 8, 4, 9b, 17b and 20): the kernel-shaped tiny
   sampler (128 px, 4 DPM++ steps, f32) in three subprocesses under
   --warm.dir: in this checkout (stores native/flash_attention_fwd), in a
   copy of dcr_tpu_torch without _build/ (no compiler process, a cache
   hit, PNGs equal byte for byte) and in a second copy over its own copy of
   the warm dir with DCR_FAULTS=cache_corrupt@load=0 (one entry
   quarantined, nvcc rebuilds once, PNGs equal); the cache load's seconds
   beside the rebuild's. Beside them, phase 20's tiny model trains 2 steps (f32) in two
   subprocesses under the same --warm.dir: in this checkout (stores
   native/flash_attention_bwd) and in the copy with _build/ removed
   (train/step resolved from the cache, both libraries hits, no compiler
   process, the checkout run's loss);
21. profile drill (last): POST /debug/profile on an in-process server at
   SD-2.1 widths arms torch.profiler for one device step; a 4-step request
   runs under it, and its Chrome trace holds the forward kernel's 40
   launches (the launches counted as serve_profiled).
Every phase prints its wall seconds (`phase <name>: N s`).
No kernel lies on the eval, search and ANN paths (9-13, 16 and 24: their
attention is SDPA's, XCiT's is over channels; search and ANN are matmuls,
sorts and torch.topk): their launch counts must stay 0.
Each main path runs with every launch count set to 0 just before it and
read just after (the hook's launches are read around each hook call). The last line is {"ok": true, "device": {...}}; the line
before it holds the kernels' numbers as JSON, one record per kernel and
dtype.
"""

from __future__ import annotations

import json
import math
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


# dcr-mitigate (phase 5d): one image per prompt with CFG at 512 px, in
# MITIGATE_STEPS DPM++ steps (phase 5 runs the 20-step solver; the
# mitigations act on the prompt and the initial noise); phase 5d holds every
# forward launch it makes to one of these shapes
MITIGATE_STEPS = 10
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
        *SEQPAR_CASES,
        *TP_CASES,
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
        # phase 23 (c)'s per-rank shapes: Ulysses' head groups, the mid block
        *SEQPAR_CASES,
        # phase 23 (f)'s per-rank level-1 heads; (g) runs no backward
        TP_CASES[0],
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


def _write_train_jpegs(data: Path) -> None:
    """The training phases' class folder: 48 photo-like JPEGs at 500x375
    (Imagenette's common size), written by the port's encoder."""
    from dcr_tpu_torch.native.jpeg_helper import encode

    for i in range(48):
        (data / f"class{i % 2}").mkdir(parents=True, exist_ok=True)
        (data / f"class{i % 2}" / f"{i}.jpg").write_bytes(encode(_photo(i, 375, 500), 90))


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
    from dcr_tpu_torch.sampling.pipeline import load_checkpoint_models
    from dcr_tpu_torch.sampling.png import read_png

    data = out_dir / "data"
    _write_train_jpegs(data)
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
             "peak_bytes": peak, "losses": losses,
             "grad_norms": [r["grad_norm"] for r in rows], "launches_fwd_dq_dkv": launches,
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
    # the run's trace.jsonl through the repo's own reader (stdlib only)
    report = subprocess.run([sys.executable, "-m", "tools.trace_report", str(run), "--json"],
                            cwd=Path(__file__).resolve().parent, capture_output=True,
                            text=True, timeout=120)
    trace = json.loads(report.stdout) if report.returncode == 0 else {}
    by_name, memory = trace.get("by_name", {}), trace.get("memory") or {}
    stats["trace_report"] = {
        "rc": report.returncode, "records": trace.get("records"),
        "spans": {n: by_name[n] for n in ("train/step", "train/data_wait") if n in by_name},
        "memory": {k: memory.get(k) for k in ("sampled_spans", "peak_bytes",
                                              "resident_delta_by_stage")}}
    stats["mfu"] = rows[-1].get("mfu")
    stats["tflops_per_sec"] = rows[-1].get("tflops_per_sec")
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
    if (report.returncode != 0 or by_name.get("train/step", {}).get("count") != steps
            or by_name.get("train/data_wait", {}).get("count", 0) < steps
            or (memory.get("sampled_spans") or 0) < steps
            or not (memory.get("peak_bytes") or 0) > 0):
        raise AssertionError(f"trace_report on the run: rc {report.returncode}, "
                             f"{stats['trace_report']}, {report.stderr[-2000:]}")
    if not all(r.get("mfu", 0) > 0 for r in rows):
        raise AssertionError(f"train main path: mfu missing from metrics.jsonl: {rows[-1]}")
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


# the 8-bit AdamW phase (19): steps of TrainConfig() with use_8bit_adam
ADAM8_STEPS = 3


def phase_train_8bit(fused_stats: dict) -> dict:
    """Phase 19: 8-bit AdamW at full width. TrainConfig() (SD-2.1 widths,
    256 px, batch 16, bf16, AdamW with warmup) with optim.use_8bit_adam, its
    train step (make_train_step) on seeded random weights built on the card
    and phase 7's random batch, ADAM8_STEPS steps: s per step, finite
    losses, 10 launches of each kernel per step in bf16, the 8-bit state's
    bytes held to the formula exactly (int8 m and uint8 v codes over
    256-element blocks plus two f32 scales per block for every tensor of at
    least 4,096 elements, f32 moments for the rest) and beside f32 AdamW's.
    Then one more step from the same state twice: 8-bit, and f32 AdamW over
    the 8-bit moments dequantized. Reported: the optimizer's ms in each
    (CUDA-synced around Optimizer.update), each one's peak against phase 6's,
    and the largest parameter difference beside the step's own largest
    update."""
    import dataclasses

    import numpy as np

    from dcr_tpu_torch.core import adam8bit as A8
    from dcr_tpu_torch.core.config import TrainConfig
    from dcr_tpu_torch.diffusion import train as T
    from dcr_tpu_torch.sampling.pipeline import build_models

    wall0 = time.perf_counter()
    cfg = TrainConfig()
    cfg8 = TrainConfig(optim=dataclasses.replace(cfg.optim, use_8bit_adam=True))
    models = build_models(cfg.model, "cuda", seed=0)
    params = {name: dict(m.named_parameters()) for name, m in
              (("unet", models.unet), ("text", models.text_encoder), ("vae", models.vae))}
    state = T.init_train_state(cfg8, models, unet_params=params["unet"],
                               text_params=params["text"], vae_params=params["vae"])
    opt = state.opt_state
    n_unet = sum(p.numel() for p in params["unet"].values())
    state_bytes = sum(t.numel() * t.element_size()
                      for d in (opt.m8, opt.v8, opt.mu, opt.nu) for t in d.values())
    formula = sum(A8.state_bytes(p.numel()) if A8.is_quantized(p.numel()) else 8 * p.numel()
                  for p in params["unet"].values())
    quantized = sum(A8.is_quantized(p.numel()) for p in params["unet"].values())
    rng = np.random.default_rng(4)
    bsz, res = cfg.train_batch_size, cfg.data.resolution
    batch = {"pixel_values": rng.uniform(-1, 1, (bsz, res, res, 3)).astype(np.float32),
             "input_ids": rng.integers(0, cfg.model.text_vocab_size - 1,
                                       (bsz, cfg.model.text_max_length))}
    opt_ms: list[float] = []
    update = T.Optimizer.update

    def timed_update(self, grads, opt_state, trainable, **kw):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = update(self, grads, opt_state, trainable, **kw)
        torch.cuda.synchronize()
        opt_ms.append(1e3 * (time.perf_counter() - start))
        return out

    def run(step_fn, st, timed_opt: bool):
        torch.cuda.synchronize()
        start = time.perf_counter()
        if timed_opt:
            T.Optimizer.update = timed_update
        try:
            st, metrics = step_fn(st, batch)
            loss = float(metrics["loss"])
        finally:
            T.Optimizer.update = update
        torch.cuda.synchronize()
        return st, loss, time.perf_counter() - start

    step8 = T.make_train_step(cfg8, models)
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        for _ in range(ADAM8_STEPS):
            state, loss, s = run(step8, state, timed_opt=False)
            losses.append(loss)
            step_s.append(s)
    finally:
        launches = read_launches()
    peak8 = torch.cuda.max_memory_allocated()
    # one more step from this state, twice: 8-bit, then f32 AdamW over the
    # same moments dequantized (the params put back from the host between)
    before = {k: p.detach().cpu() for k, p in params["unet"].items()}
    saved = {name: {k: t.clone() for k, t in getattr(opt, name).items()}
             for name in ("m8", "v8", "mu", "nu")}
    count = opt.count
    state, loss8, s8 = run(step8, state, timed_opt=True)
    opt8_ms = opt_ms[-1]
    after8 = {k: p.detach().cpu() for k, p in params["unet"].items()}
    mu, nu, m8, v8 = saved["mu"], saved["nu"], saved["m8"], saved["v8"]
    for name, p in params["unet"].items():
        k = f"unet/{name}"
        if k not in mu:
            mu[k] = A8.dequantize_linear(A8.Quant8(m8[f"{k}/q"], m8[f"{k}/scale"]),
                                         p.shape, p.numel())
            nu[k] = A8.dequantize_log(A8.Quant8(v8[f"{k}/q"], v8[f"{k}/scale"]),
                                      p.shape, p.numel())
    state.opt_state = T.OptState(count=count, mu=mu, nu=nu)
    del opt, saved, m8, v8
    with torch.no_grad():
        for k, p in params["unet"].items():
            p.copy_(before[k])
    state.step -= 1
    torch.cuda.reset_peak_memory_stats()
    state, loss32, s32 = run(T.make_train_step(cfg, models), state, timed_opt=True)
    peak32 = torch.cuda.max_memory_allocated()
    opt32_ms = opt_ms[-1]
    diff = max((after8[k] - p.detach().cpu()).abs().max().item()
               for k, p in params["unet"].items())
    step_size = max((after8[k] - before[k]).abs().max().item() for k in before)
    lr = T.make_lr_schedule(cfg.optim)(ADAM8_STEPS)
    stats = {"card": CARD[0], "steps": ADAM8_STEPS, "batch": bsz, "step_s": step_s,
             "median_step_s_after_first": statistics.median(step_s[1:]), "losses": losses,
             "launches_fwd_dq_dkv": launches, "unet_params": n_unet,
             "quantized_tensors": quantized, "unet_tensors": len(params["unet"]),
             "state_bytes": state_bytes, "state_bytes_formula": formula,
             "f32_state_bytes": 8 * n_unet, "peak_bytes_8bit": peak8,
             "peak_bytes_f32_step": peak32,
             "peak_bytes_phase6": fused_stats.get("peak_bytes"),
             "optimizer_ms_8bit": opt8_ms, "optimizer_ms_f32": opt32_ms,
             "step_s_with_synced_optimizer": {"8bit": s8, "f32": s32},
             "loss_8bit_vs_f32_step": [loss8, loss32], "lr_at_compared_step": lr,
             "max_param_diff_8bit_vs_f32": diff, "max_param_update": step_size,
             "wall_s": time.perf_counter() - wall0}
    log(f"8-bit adam (phase 19, {CARD[0]}): {json.dumps(stats)}")
    log(f"8-bit adam ({CARD[0]}): {stats['median_step_s_after_first']:.4f} s per step, "
        f"optimizer {opt8_ms:.1f} ms (f32 AdamW {opt32_ms:.1f} ms); state "
        f"{state_bytes / 1e9:.3f} GB (f32 moments {8 * n_unet / 1e9:.3f} GB); peak "
        f"{peak8 / 1e9:.2f} GB against {peak32 / 1e9:.2f} GB with f32 AdamW and "
        f"{(fused_stats.get('peak_bytes') or 0) / 1e9:.2f} GB in phase 6; one step's "
        f"max |8-bit - f32| {diff:.3e} beside its max update {step_size:.3e} (lr {lr:.3e}); "
        f"launches {launches}")
    problems = []
    if state_bytes != formula:
        problems.append(f"8-bit state {state_bytes} bytes, formula {formula}")
    if launches != (10 * ADAM8_STEPS,) * 3:
        problems.append(f"launches (fwd, dQ, dK/dV) {launches}, expected "
                        f"{(10 * ADAM8_STEPS,) * 3}")
    if not all(np.isfinite(losses + [loss8, loss32])):
        problems.append(f"losses {losses}, {loss8}, {loss32}")
    if problems:
        raise AssertionError("8-bit adam: " + "; ".join(problems))
    del state, models, params
    torch.cuda.empty_cache()
    return stats


def _flightrec(run: Path) -> dict:
    """The run's flight-recorder dump (any rank or worker index)."""
    (path,) = sorted(run.glob("flightrec_*.json"))
    return json.loads(path.read_text())


def _real_memory(doc: dict, what: str) -> list[str]:
    """Problems with a dump's memory section: it must hold the card's
    allocator figures (bytes in use > 0, a limit)."""
    mem = (doc.get("memory") or {}).get("device_memory_stats") or {}
    if not (mem.get("bytes_in_use", 0) > 0 and mem.get("bytes_limit", 0) > 0):
        return [f"{what}: memory section {doc.get('memory')}"]
    return []


# the real out-of-memory drill: the process's share of the card, small
# enough that TrainConfig()'s first step cannot fit beside its state
OOM_LIMIT_BYTES = 16e9

_REAL_OOM = """
import sys
import torch
torch.cuda.set_per_process_memory_fraction(float(sys.argv[1]))
from dcr_tpu_torch.cli.train import main
main(sys.argv[2:])
"""


def phase_exit_drills(root: Path) -> dict:
    """Phase 20: dcr-train-torch's typed exits, four subprocesses at once
    (each mostly process start-up on the host): at phase 15's kernel-shaped
    tiny model, sigterm@step=2 exits 83 with a checkpoint at step 2,
    hang@step=1 with --fault.hang_timeout_s=5 exits 89 within 60 s with a
    thread dump on stderr, and oom@step=2 exits 85; and a real
    torch.OutOfMemoryError: TrainConfig() (SD-2.1 widths, 256 px, batch 16)
    on phase 6's 48 JPEGs in a process limited to OOM_LIMIT_BYTES by
    torch.cuda.set_per_process_memory_fraction, where the models and AdamW's
    state fit (~12 GB) and the first step does not, exits 85. Each writes a
    flightrec_0.json whose reason is its exit's and whose memory section
    holds the card's allocator figures; the OOM dumps' oom section names
    the step, the real one's error is the allocator's and its limit the
    fraction's."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from dcr_tpu_torch.core.config import TrainConfig, save_config
    from dcr_tpu_torch.sampling.png import write_png

    stats: dict = {"card": CARD[0]}
    problems: list[str] = []
    for i in range(8):
        (root / "tiny_data" / f"c{i % 2}").mkdir(parents=True, exist_ok=True)
        write_png(root / "tiny_data" / f"c{i % 2}" / f"{i}.png", _photo(i, 128, 128))
    _write_train_jpegs(root / "data")
    cfg = TrainConfig(output_dir=str(root / "real_oom"), max_train_steps=2, log_every=1)
    cfg.data.train_data_dir = str(root / "data")
    save_config(cfg, root / "real_oom.json")
    total = torch.cuda.get_device_properties(0).total_memory
    fraction = OOM_LIMIT_BYTES / total

    def real_oom() -> dict:
        env = {k: v for k, v in os.environ.items() if k != "DCR_FAULTS"}
        env["PYTHONPATH"] = str(Path(__file__).resolve().parent)
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _REAL_OOM, str(fraction),
                               f"--config={root / 'real_oom.json'}"], env=env, cwd=root,
                              capture_output=True, text=True, timeout=300)
        return {"rc": proc.returncode, "s": time.perf_counter() - start,
                "run": root / "real_oom", "stderr": proc.stderr}

    with ThreadPoolExecutor(max_workers=4) as ex:
        jobs = {"sigterm": ex.submit(_cli_fault_run, root, "cli_sigterm", "sigterm@step=2",
                                     steps=3),
                "hang": ex.submit(_cli_fault_run, root, "cli_hang", "hang@step=1",
                                  "--fault.hang_timeout_s=5", steps=3),
                "oom": ex.submit(_cli_fault_run, root, "cli_oom", "oom@step=2", steps=3),
                "real_oom": ex.submit(real_oom)}
        runs = {name: job.result() for name, job in jobs.items()}
    expected = {"sigterm": (83, "preempted: checkpointed at step 2"),
                "hang": (89, "hang_abort:train"),
                "oom": (85, "oom: train step 2"), "real_oom": (85, "oom: train step 0")}
    for name, run in runs.items():
        rc, reason = expected[name]
        stats[name] = {"rc": run["rc"], "s": run["s"]}
        if run["rc"] != rc:
            problems.append(f"{name}: rc {run['rc']} (expected {rc}), {run['stderr'][-2000:]}")
            continue
        try:
            doc = _flightrec(run["run"])
        except ValueError:
            problems.append(f"{name}: no flight-recorder dump under {run['run']}")
            continue
        stats[name].update(reason=doc["reason"][:300],
                           memory=doc["memory"]["device_memory_stats"], oom=doc.get("oom"))
        if not doc["reason"].startswith(reason):
            problems.append(f"{name}'s dump: reason {doc['reason'][:300]}")
        problems += _real_memory(doc, f"{name}'s dump")
    stop, hang = runs["sigterm"], runs["hang"]
    if stop["rc"] == 83:
        stats["sigterm"]["checkpoints"] = sorted(p.name for p in
                                                 (stop["run"] / "checkpoints").iterdir())
        if not (stop["run"] / "checkpoints" / "2" / "state.pt").exists():
            problems.append(f"sigterm@step=2 left no checkpoint at step 2: "
                            f"{stats['sigterm']['checkpoints']}")
    stats["hang"]["thread_dump"] = ("Thread 0x" in hang["stderr"]
                                    and "simulate_hang" in hang["stderr"])
    if not stats["hang"]["thread_dump"] or hang["s"] > 60:
        problems.append(f"hang@step=1: thread dump {stats['hang']['thread_dump']}, "
                        f"{hang['s']:.1f} s, {hang['stderr'][-2000:]}")
    if runs["oom"]["rc"] == 85 and (stats["oom"].get("oom") or {}).get("where") \
            != "train step 2":
        problems.append(f"oom@step=2's dump: {stats['oom'].get('oom')}")
    if runs["real_oom"]["rc"] == 85:
        real = stats["real_oom"]
        real.update(fraction=fraction, limit_bytes=int(total * fraction))
        if "OutOfMemoryError" not in ((real.get("oom") or {}).get("error") or ""):
            problems.append(f"real OOM dump's error: {real.get('oom')}")
        if abs((real.get("memory") or {}).get("bytes_limit", 0) - int(total * fraction)) \
                > 1 << 20:
            problems.append(f"real OOM dump's limit {real.get('memory')}, the fraction's "
                            f"{int(total * fraction)}")
    log(f"exit drills (phase 20, {CARD[0]}): {json.dumps(stats, default=str)}")
    if problems:
        raise AssertionError("exit drills: " + "; ".join(problems))
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


# phase 15's UNet depth: SD-2.1 has 2 layers per block and four levels
# (865.9 M UNet params); 1 layer per block (583.5 M) and its first two
# levels (80.7 M: the 1280-wide blocks go; level 0 and the mid block, now
# at level 1's 640 channels and 256 tokens, are the kernel-shaped
# attentions, at phase 6's two train shapes) cut each checkpoint's UNet
# from 3 x 3.46 to 3 x 0.32 GB of f32 (params and Adam's two moments); the
# fault drills do not depend on depth
FAULTS_LAYERS_PER_BLOCK = 1
FAULTS_BLOCK_OUT_CHANNELS = (320, 640)
# phase 23 (c)'s levels: SD-2.1's first three, so at 512 px level 0 takes
# ring attention, level 1 Ulysses and the mid block the kernels per rank
SEQPAR_BLOCK_OUT_CHANNELS = (320, 640, 1280)


def kernel_attentions_per_step(layers_per_block: int, levels: int = 4) -> int:
    """Kernel-shaped self-attentions per SD-2.1 UNet call at 256 px (32 x 32
    latents), a UNet of ``levels`` levels: each level but the last holds
    layers_per_block down and layers_per_block + 1 up, the mid block one at
    the last level; those whose token count 128 divides take the kernel
    (S = 1024, 256, 64, 16 at levels 0-3: four levels run levels 0 and 1
    through it, two levels level 0 and the mid block at S = 256)."""
    tokens = [1024 // 4 ** i for i in range(levels)]
    per_level = sum(2 * layers_per_block + 1 for s in tokens[:-1] if s % 128 == 0)
    return per_level + (tokens[-1] % 128 == 0)


def phase_train_faults(out_dir: Path) -> dict:
    """Phase 15: training's fault tolerance at SD-2.1's widths, its UNet cut to
    FAULTS_LAYERS_PER_BLOCK and the levels of FAULTS_BLOCK_OUT_CHANNELS.
    Trainer(TrainConfig())
    (256 px, batch 16, bf16) on 48 photo-like JPEGs and one
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
    faults/* metrics, checkpoints/quarantined/5, finite losses,
    kernel_attentions_per_step launches of each kernel per executed step,
    all at the two train shapes in bf16,
    the export loading back. A straight run (the same spec's decode_error
    only, no saves) gives the resumed run's reference: equal step counter,
    optimizer count and loader index sequences; the params' max |diff| is
    reported (cuDNN's backward may pick nondeterministic algorithms). (The
    dcr-train-torch subprocesses that exit 83 and 89 run in phase 20.)
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
    from dcr_tpu_torch.utils import faults

    wall0 = time.perf_counter()
    data = out_dir / "data"
    _write_train_jpegs(data)
    whole = encode(_photo(99, 375, 500), 90)
    truncated = data / "class1" / "truncated.jpg"
    truncated.write_bytes(whole[: len(whole) * 3 // 5])
    run = out_dir / "run"
    cfg = TrainConfig(output_dir=str(run), max_train_steps=6, log_every=1, modelsavesteps=3,
                      checkpoints_total_limit=2)
    cfg.model = dataclasses.replace(cfg.model, layers_per_block=FAULTS_LAYERS_PER_BLOCK,
                                    block_out_channels=FAULTS_BLOCK_OUT_CHANNELS)
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

        def timed_save(step, state, **kw):
            # the preemption's save of step 5, torn right after it commits,
            # is the one written without the manifest pass
            mgr.verify = step != 5
            start = time.perf_counter()
            try:
                if save(step, state, **kw):  # an already-saved step writes nothing
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
        "card": CARD[0], "spec": FAULT_SPEC, "layers_per_block": FAULTS_LAYERS_PER_BLOCK,
        "block_out_channels": FAULTS_BLOCK_OUT_CHANNELS,
        "records": {k: kinds.count(k) for k in set(kinds)},
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
    per_step = kernel_attentions_per_step(FAULTS_LAYERS_PER_BLOCK,
                                          len(FAULTS_BLOCK_OUT_CHANNELS))
    if stats["steps_run"] != [5, 3, 6] or launches != (per_step * steps_run,) * 3:
        problems.append(f"steps {stats['steps_run']}, launches {launches}")
    held = {(16, 1024, 1024, 5, 64, torch.bfloat16), (16, 256, 256, 10, 64, torch.bfloat16)}
    if shapes != held:
        problems.append(f"kernel shapes {sorted(map(str, shapes))}")
    if (straight_counts != resumed_counts != (6, 6)
            or straight["index"][3:] != resumed["index"]
            or straight["index"][:3] != first["index"][:3]):
        problems.append(f"straight vs resumed: counts {straight_counts} / {resumed_counts}, "
                        f"index {straight['index']} / {first['index']} + {resumed['index']}")

    stats["wall_s"] = time.perf_counter() - wall0
    log(f"training faults (phase 15, {CARD[0]}): {json.dumps(stats, default=str)}")
    log(f"training faults ({CARD[0]}): s per step {stats['median_step_s_after_first']:.4f}; "
        f"save "
        f"{statistics.mean(times['save']):.2f} s with the manifest pass "
        f"({statistics.mean(times['manifest']):.2f} s of it), "
        f"{statistics.mean(times['no_manifest_save']):.2f} s without; restore {rollback_restore_s} s (rollback), {fallback_restore_s} s "
        f"(fallback); a bad sample {statistics.mean(f for f, _ in overhead) * 1e3:.1f} ms "
        f"failing + {statistics.mean(g for _, g in overhead) * 1e3:.1f} ms replacing; "
        f"straight vs resumed max |diff| {max_diff:.3e}; peak {peak / 2**30:.2f} GiB; "
        f"{stats['wall_s']:.1f} s")
    if problems:
        raise AssertionError("training faults: " + "; ".join(problems))
    return stats


# the pipelined training phase (18): phase 6's configuration and data
PIPE_STEPS = 6
PIPE_CHECK_STEPS = 3


def _step_recorder(trainer, record: dict):
    """Wrap ``trainer.step_fn``: per step its loss, ``step_s`` the wall time
    from one step's end (its loss on the host) to the next's, waits on the
    loader or the ring included, and ``busy_s`` from the call to its loss on
    the host (phase 6's step time, which excludes those waits), with no
    device-wide sync, so a producer's side stream runs on; and the batch's
    indices."""
    step_fn = trainer.step_fn

    def step(state, batch):
        start = time.perf_counter()
        state, metrics = step_fn(state, batch)
        record["losses"].append(float(metrics["loss"]))
        record.setdefault("grad_norms", []).append(float(metrics["grad_norm"]))
        end = time.perf_counter()
        prev = record["ends"][-1] if record["ends"] else start
        record["step_s"].append(end - prev)
        record["busy_s"].append(end - start)
        record["ends"].append(end)
        record["index"].append([int(i) for i in batch["index"]])
        return state, metrics
    trainer.step_fn = step


def _pipe_step_check(cfg) -> dict:
    """Phase 18 (a): PIPE_CHECK_STEPS steps of the fused step against the
    encode stage + denoiser step, from copies of one state, on the loader's
    first batches with the steps' own generator streams. Held bit for bit:
    losses, grad norms, every UNet param and Adam's second moments."""
    import gc

    from dcr_tpu_torch.core import rng as rngmod
    from dcr_tpu_torch.data.dataset import ObjectAttributeDataset
    from dcr_tpu_torch.data.loader import DataLoader
    from dcr_tpu_torch.data.tokenizer import load_tokenizer
    from dcr_tpu_torch.diffusion import encode_stage as E
    from dcr_tpu_torch.diffusion import train as T
    from dcr_tpu_torch.sampling.pipeline import build_models

    tok = load_tokenizer(None, vocab_size=cfg.model.text_vocab_size,
                         model_max_length=cfg.model.text_max_length)
    loader = DataLoader(ObjectAttributeDataset(cfg.data, tok), batch_size=cfg.train_batch_size,
                        num_workers=cfg.data.num_workers, seed=cfg.data.seed)
    epoch = loader.epoch(0)
    batches = [next(epoch) for _ in range(PIPE_CHECK_STEPS)]
    epoch.close()
    models = build_models(cfg.model, "cuda", seed=rngmod.stream_seed(cfg.seed, "init"))
    unet0 = {k: p.detach().clone() for k, p in models.unet.named_parameters()}
    frozen_params = {"text": dict(models.text_encoder.named_parameters()),
                     "vae": dict(models.vae.named_parameters())}
    fused_state = T.init_train_state(cfg, models, unet_params=dict(models.unet.named_parameters()),
                                     **{f"{k}_params": v for k, v in frozen_params.items()})
    pipe_state = T.init_train_state(cfg, models, unet_params=unet0,
                                    **{f"{k}_params": v for k, v in frozen_params.items()})
    fused, encode = T.make_train_step(cfg, models), E.make_encode_stage(cfg, models)
    denoise = E.make_denoise_step(cfg, models)
    hot, frozen = E.split_state(pipe_state, cfg.train_text_encoder)
    out = {"fused_s": [], "encode_s": [], "denoise_s": [], "fused": [], "pipelined": [],
           "launches_fused": [], "launches_pipelined": [],
           "index": [[int(i) for i in b["index"]] for b in batches]}

    def timed(fn, *args):
        torch.cuda.synchronize()
        start, before = time.perf_counter(), read_launches()
        result = fn(*args)
        torch.cuda.synchronize()
        return result, time.perf_counter() - start, tuple(
            b - a for a, b in zip(before, read_launches()))

    for batch in batches:
        (fused_state, fm), s, n = timed(fused, fused_state, batch)
        out["fused_s"].append(s)
        out["launches_fused"].append(n)
        enc, s, n_enc = timed(encode, frozen, batch, hot.step)
        out["encode_s"].append(s)
        (hot, pm), s, n = timed(denoise, hot, enc)
        out["denoise_s"].append(s)
        out["launches_pipelined"].append(tuple(a + b for a, b in zip(n_enc, n)))
        out["fused"].append((fm["loss"].item(), fm["grad_norm"].item()))
        out["pipelined"].append((pm["loss"].item(), pm["grad_norm"].item()))
    out["unet_max_abs_diff"] = max((fused_state.unet_params[k] - hot.unet_params[k])
                                   .abs().max().item() for k in unet0)
    out["nu_max_abs_diff"] = max((fused_state.opt_state.nu[k] - hot.opt_state.nu[k])
                                 .abs().max().item() for k in fused_state.opt_state.nu)
    out["steps"] = (fused_state.step, hot.step)
    del fused_state, pipe_state, hot, frozen, models, unet0, frozen_params, enc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_pipelined_training(out_dir: Path, fused_stats: dict) -> dict:
    """Phase 18: pipelined training and the latent cache at phase 6's
    configuration (TrainConfig(): SD-2.1 widths, 256 px, batch 16, bf16) with
    data.random_flip=false, on phase 6's 48 JPEGs:
    (a) _pipe_step_check: the fused step and encode stage + denoiser step
        bit for bit over PIPE_CHECK_STEPS steps;
    (b) dcr-precompute-latents-torch through its main (cache shards of 16
        rows): seconds, images/s, the fingerprint's seconds, shards, bytes;
        0 flash launches;
    (c) cache-fed: Trainer with pipe.latent_cache for PIPE_STEPS steps; the
        VAE encoder never called, every index served from the cache;
    (d) live-pipelined: Trainer with pipe.enabled, depth 2, PIPE_STEPS steps;
        the consumer's wait on the ring per step; peak memory.
    (c) and (d): 10 launches of each kernel per step, bf16, at phase 6's
    shapes; (d)'s first PIPE_CHECK_STEPS losses bit-equal to (a)'s (the
    same init, batches and draws, so the producer thread and its side
    stream hand over exactly what the synced stages computed); (c)'s within
    rtol 1e-3 of (d)'s step by step, on the same batches (the cache's rows
    were encoded in other batches). s per step in the step (as phase 6
    times its fused steps) and step to step (waits included), beside phase
    6's; no device-wide sync. Both Trainers skip the final save and
    export (phase 6 holds them at full width; the CPU tests hold the
    pipelined checkpoint and resume)."""
    import contextlib
    import dataclasses
    import gc
    import io

    from dcr_tpu_torch.cli import precompute as precompute_cli
    from dcr_tpu_torch.core.config import PipeConfig, TrainConfig, save_config
    from dcr_tpu_torch.diffusion.trainer import Trainer
    from dcr_tpu_torch.ops import flash_attention as fa

    wall0 = time.perf_counter()
    data = out_dir / "data"
    _write_train_jpegs(data)
    cfg = TrainConfig(output_dir=str(out_dir / "unused"), max_train_steps=PIPE_STEPS,
                      log_every=1, modelsavesteps=10 ** 6, checkpoints_total_limit=1)
    cfg.data.train_data_dir = str(data)
    cfg.data.random_flip = False
    stats: dict = {"card": CARD[0], "steps": PIPE_STEPS, "batch": cfg.train_batch_size}
    problems = []

    # (a) the step-level check
    t0 = time.perf_counter()
    check = _pipe_step_check(cfg)
    check["s"] = time.perf_counter() - t0
    stats["step_check"] = check
    per_step = kernel_attentions_per_step(cfg.model.layers_per_block)
    if (check["fused"] != check["pipelined"] or check["unet_max_abs_diff"] != 0.0
            or check["nu_max_abs_diff"] != 0.0
            or check["steps"] != (PIPE_CHECK_STEPS, PIPE_CHECK_STEPS)
            or any(n != (per_step,) * 3 for n in check["launches_fused"]
                   + check["launches_pipelined"])):
        problems.append(f"(a) fused vs pipelined: {json.dumps(check)}")
    log(f"pipelined training (a) step check ({CARD[0]}): {json.dumps(check)}")

    # (b) the precompute, through the CLI's main
    cache = out_dir / "latent_cache"
    save_config(cfg, out_dir / "pre.json")
    reset_launches()
    shapes, check_inputs = set(), fa._check_kernel_inputs

    def recording_check(q, k, v):
        shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3], q.dtype))
        return check_inputs(q, k, v)

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        precompute_cli.main([f"--config={out_dir / 'pre.json'}",
                             f"--pipe.latent_cache={cache}", "--pipe.cache_shard_size=16"])
    pre = json.loads(out.getvalue().strip().splitlines()[-1])
    pre["main_s"] = time.perf_counter() - t0
    pre["launches_fwd_dq_dkv"] = read_launches()
    stats["precompute"] = pre
    log(f"pipelined training (b) precompute ({CARD[0]}): {json.dumps(pre)}")
    if pre["indices"] != 48 or pre["shards"] != 3 or pre["launches_fwd_dq_dkv"] != (0, 0, 0):
        problems.append(f"(b) precompute: {json.dumps(pre)}")
    gc.collect()
    torch.cuda.empty_cache()

    def leg(name: str, pipe: PipeConfig) -> tuple[dict, "Trainer"]:
        leg_cfg = dataclasses.replace(cfg, output_dir=str(out_dir / name), pipe=pipe)
        record = {"losses": [], "step_s": [], "busy_s": [], "ends": [], "index": []}
        t_build = time.perf_counter()
        trainer = Trainer(leg_cfg, device="cuda")
        build_s = time.perf_counter() - t_build
        _step_recorder(trainer, record)
        open_cache, open_s = trainer._open_latent_cache, []

        def timed_open():
            start = time.perf_counter()
            open_cache()
            open_s.append(time.perf_counter() - start)
        trainer._open_latent_cache = timed_open
        trainer.save = lambda: None
        trainer.export_checkpoint = lambda tag="checkpoint": None
        encoder_calls = []
        hook = trainer.models.vae.encoder.register_forward_pre_hook(
            lambda m, a: encoder_calls.append(1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa._check_kernel_inputs = recording_check
        reset_launches()
        t0 = time.perf_counter()
        try:
            trainer.train()
        finally:
            launches = read_launches()
            fa._check_kernel_inputs = check_inputs
            hook.remove()
        result = {
            "train_s": time.perf_counter() - t0, "build_s": build_s,
            "step_s": record["step_s"],
            "median_step_s_after_first": statistics.median(record["step_s"][1:]),
            "busy_s": record["busy_s"],
            "median_busy_s_after_first": statistics.median(record["busy_s"][1:]),
            "ring_wait_s": trainer.ring_wait_s,
            "losses": record["losses"], "launches_fwd_dq_dkv": launches,
            "encoder_calls": len(encoder_calls),
            "peak_bytes": torch.cuda.max_memory_allocated(), "index": record["index"],
            "cache_open_s": open_s[0] if open_s else None}
        result["images_per_s"] = cfg.train_batch_size / result["median_step_s_after_first"]
        if trainer._cache_reader is not None:
            result["cache_coverage"] = trainer._cache_reader.coverage()
        return result, trainer

    # (c) cache-fed
    cached, trainer = leg("cache_fed", PipeConfig(latent_cache=str(cache)))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    stats["cache_fed"] = cached
    log(f"pipelined training (c) cache-fed ({CARD[0]}): "
        f"{json.dumps({k: v for k, v in cached.items() if k != 'index'})}")

    # (d) live-pipelined
    live, trainer = leg("live", PipeConfig(enabled=True, depth=2))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    stats["live"] = live
    log(f"pipelined training (d) live-pipelined ({CARD[0]}): "
        f"{json.dumps({k: v for k, v in live.items() if k != 'index'})}")

    expected = (per_step * PIPE_STEPS,) * 3
    held = {(16, 1024, 1024, 5, 64, torch.bfloat16), (16, 256, 256, 10, 64, torch.bfloat16)}
    for name, r in (("(c) cache-fed", cached), ("(d) live", live)):
        if r["launches_fwd_dq_dkv"] != expected or len(r["losses"]) != PIPE_STEPS:
            problems.append(f"{name}: launches {r['launches_fwd_dq_dkv']}, expected {expected}; "
                            f"{len(r['losses'])} steps")
        if not all(map(math.isfinite, r["losses"])):
            problems.append(f"{name}: losses {r['losses']}")
    if cached["encoder_calls"] != 0 or cached.get("cache_coverage") != (48, 48):
        problems.append(f"(c) the VAE encoder ran {cached['encoder_calls']} times in the "
                        f"cache-fed loop; coverage {cached.get('cache_coverage')}")
    # the producer may run ahead of the last step by the ring's depth + 1
    if not PIPE_STEPS <= live["encoder_calls"] <= PIPE_STEPS + 3:
        problems.append(f"(d) the VAE encoder ran {live['encoder_calls']} times for "
                        f"{PIPE_STEPS} steps")
    if cached["index"] != live["index"]:
        problems.append("(c) and (d) saw different batches")
    # the producer ring against the synced stages of (a), bit for bit
    stats["live_equals_step_check"] = (
        live["index"][:PIPE_CHECK_STEPS] == check["index"]
        and live["losses"][:PIPE_CHECK_STEPS] == [loss for loss, _ in check["pipelined"]])
    if not stats["live_equals_step_check"]:
        problems.append(f"(d) vs (a): losses {live['losses'][:PIPE_CHECK_STEPS]} vs "
                        f"{check['pipelined']}, batches {live['index'][:PIPE_CHECK_STEPS]} "
                        f"vs {check['index']}")
    if shapes != held:
        problems.append(f"kernel shapes {sorted(map(str, shapes))}")
    rel = [abs(a - b) / abs(b) for a, b in zip(cached["losses"], live["losses"])]
    stats["cache_vs_live_loss_rel"] = rel
    if not rel or max(rel) > 1e-3:
        problems.append(f"(c) vs (d) losses: {cached['losses']} vs {live['losses']}")
    fused_median = fused_stats.get("median_step_s_after_first")
    stats["phase6_fused_median_step_s"] = fused_median
    stats["wall_s"] = time.perf_counter() - wall0
    log(f"pipelined training ({CARD[0]}): s per step (median after the first) fused "
        f"{fused_median} (phase 6); live-pipelined "
        f"{live['median_busy_s_after_first']:.4f} in the step, "
        f"{live['median_step_s_after_first']:.4f} step to step; cache-fed "
        f"{cached['median_busy_s_after_first']:.4f} in the step, "
        f"{cached['median_step_s_after_first']:.4f} step to step; the encode stage "
        f"{1e3 * statistics.median(check['encode_s']):.1f} ms and the denoiser "
        f"{1e3 * statistics.median(check['denoise_s']):.1f} ms beside the fused step "
        f"{1e3 * statistics.median(check['fused_s']):.1f} ms (synced, (a)); ring wait "
        f"{[round(w * 1e3, 1) for w in live['ring_wait_s']]} ms (live), "
        f"{[round(w * 1e3, 1) for w in cached['ring_wait_s']]} ms (cache); cache-vs-live "
        f"loss max rel {max(rel) if rel else None}; live vs (a) bit-equal over "
        f"{PIPE_CHECK_STEPS} steps: {stats['live_equals_step_check']}; precompute {pre['seconds']} s "
        f"({pre['images_per_s']} images/s, fingerprint {pre['fingerprint_s']} s, "
        f"{pre['bytes']} bytes); peak {live['peak_bytes'] / 2**30:.2f} GiB (live), "
        f"{cached['peak_bytes'] / 2**30:.2f} GiB (cache); {stats['wall_s']:.1f} s")
    if problems:
        raise AssertionError("pipelined training: " + "; ".join(problems))
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


# phase 10's corpus (256, 512 and 16 before it was halved for the time
# limit; every check and stage stays)
EVAL_GENS, EVAL_TRAIN, EVAL_COPIES = 128, 256, 8


def phase_eval_main_path(root: Path) -> dict:
    """dcr_tpu_torch.eval.runner.run_eval(EvalConfig(...)) at the JAX
    defaults (SSCD ResNet-50 at 224 px, batch 64; the complexity stage; FID
    with Inception at 299; precision/recall with VGG16; CLIP score with
    ViT-B/16; galleries), seeded random weights, on EVAL_GENS generations at
    512 px (EVAL_COPIES of them training files copied byte for byte) and
    EVAL_TRAIN training JPEGs at 256 px (the port's encoder) in two class folders. Checks the scalars,
    the copies' top-1 matches and the artifacts; prints stage seconds, SSCD
    images/s, device ms per SSCD batch of 64, host decode + transform ms per
    batch, the device's busy share during eval/features and peak memory."""
    import numpy as np

    from dcr_tpu_torch.core.config import EvalConfig
    from dcr_tpu_torch.eval import runner as R
    from dcr_tpu_torch.eval.features import EvalImageFolder

    t0 = time.perf_counter()
    gen, train, caps, copies = _write_eval_folders(root, EVAL_GENS, 512, EVAL_TRAIN, (256, 256),
                                                   EVAL_COPIES, seed=8,
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

    def timed_extract(folder, extractor, *, batch_size=64, mesh=None):
        backbone = passes[len(calls)]
        calls.append(backbone)
        chunks = []
        it = folder.batches(batch_size, mesh=mesh)
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
    if (missing or bad_copies or absent or sim.shape != (EVAL_GENS, EVAL_TRAIN)
            or scalars["sim_gt_05pc"] < EVAL_COPIES / EVAL_GENS
            or len(copy_rows) != EVAL_COPIES
            or calls != list(passes)):
        raise AssertionError(f"eval main path failed: scalars missing or not finite "
                             f"{missing}, copies {bad_copies}, artifacts absent {absent}, "
                             f"sim {sim.shape}, sim_gt_05pc {scalars.get('sim_gt_05pc')}")
    # phase 24 runs the same eval on two ranks over these folders
    MESH_INPUTS["eval"] = {"gen": gen, "train": train, "caps": caps, "scalars": scalars,
                           "copies": copy_rows, "total_s": total_s}
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
    genuine diffusers directory at 512 px, MITIGATE_STEPS DPM++ steps, one
    image per prompt, rand_noise_lam 0.1 and rand_word_add, run from ``root`` so the
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
                             "--im_batch=1", f"--num_inference_steps={MITIGATE_STEPS}",
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
    log(f"mitigation (dcr-mitigate on the genuine checkpoint, 512 px, "
        f"{MITIGATE_STEPS} steps): "
        f"{json.dumps(stats)}")
    _check_images(imgs, "mitigation")
    if (stats["savepath"] != "inferences/mitigation_aug_rand_word_add" or len(prompts) != 12
            or len(pngs) != 12 or imgs.shape != (12, 512, 512, 3)
            or launches != (expected, 0, 0) or expected != 15 * MITIGATE_STEPS * 12):
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
# phase 14's in-process pixels of its wave, by "prompt|seed": phase 22's
# fleet answers are held to them
SERVE_WAVE_PIXELS: dict = {}


class ServeProcess:
    """``python -m dcr_tpu_torch.cli.serve`` as a subprocess, its output in a
    file; killed on exit unless it ended by itself. A fleet (``group``) runs
    in a process group of its own, so its workers die with it."""

    def __init__(self, argv: list[str], log_path: Path, env: dict | None = None,
                 group: bool = False):
        import os

        self.log_path = log_path
        self._log = open(log_path, "w")
        self.group = group
        env = dict(os.environ, **(env or {}),
                   PYTHONPATH=str(Path(__file__).resolve().parent)
                   + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen([sys.executable, "-m", "dcr_tpu_torch.cli.serve", *argv],
                                     stdout=self._log, stderr=subprocess.STDOUT, env=env,
                                     cwd=str(Path(__file__).resolve().parent),
                                     start_new_session=group)

    def text(self) -> str:
        return self.log_path.read_text(errors="replace")

    def wait_for_port(self, timeout: float, role: str = "") -> int:
        """The port of the line ``dcr-serve <role>listening on``; role
        "supervisor " for a fleet's front end."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = re.search(rf"dcr-serve {role}listening on http://[\d.]+:(\d+)", self.text())
            if m:
                return int(m.group(1))
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"dcr-serve did not listen (rc {self.proc.poll()}):\n"
                             + self.text()[-4000:])

    def close(self) -> None:
        import os
        import signal

        if self.group:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)    # the workers too
            except ProcessLookupError:
                pass
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


def _wave_key(body: dict) -> str:
    return f"{body['prompt']}|{body['seed']}"


def _pixel_sha256(image) -> str:
    """sha256 of an image's uint8 pixels as the server's PNG carries them
    (a float image in [0, 1] is rounded as the server rounds it)."""
    import hashlib

    import numpy as np

    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (image * 255.0).round().astype(np.uint8)
    return hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()


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
    from dcr_tpu_torch.obs import memwatch
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

    memwatch.reset_peak()
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
        # phase 22's fleet answers the same wave: its images are held to these
        for w, img in zip(wave, [*halves[0], *halves[1]]):
            SERVE_WAVE_PIXELS[_wave_key(w)] = (img * 255.0).round().astype(np.uint8)
        stats["wave_pixel_sha256"] = {k: _pixel_sha256(v) for k, v in SERVE_WAVE_PIXELS.items()}
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
                 inprocess_peak_bytes=memwatch.peak_bytes())
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

# the batch index (each worker process counts its own from 0) at which phase
# 22's drills fire: past what a respawned incarnation reaches in the phase
FLEET_FAULT_BATCH = 8
FLEET_PROFILE_STEPS = 4
# a batch of phase 14's bucket with two workers on the card over one alone
# (2.12-2.16 measured on an H100 80GB HBM3 at 700 W)
FLEET_SHARED_BATCH_RATIO = 2.2


def _cuda_context_holders(pids: list[int]) -> dict:
    """Which of ``pids`` hold a CUDA context, two ways: nvidia-smi's compute
    apps (whose pids may be another namespace's) and each process's
    mappings of /dev/nvidia*."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi = {int(x) for x in out.stdout.split() if x.strip().isdigit()}
    maps = {}
    for pid in pids:
        try:
            maps[pid] = "/dev/nvidia" in Path(f"/proc/{pid}/maps").read_text()
        except OSError:
            maps[pid] = None
    return {"nvidia_smi": {pid: pid in smi for pid in pids}, "maps": maps}


def _log_times(text: str, pattern: str) -> list[float]:
    """Wall times (s since the epoch) of the log lines matching ``pattern``."""
    import datetime

    out = []
    for m in re.finditer(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) .*" + pattern, text, re.M):
        out.append(datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp())
    return out


def _requeue_latencies(journal: Path, worker: int) -> dict:
    """Per request requeued off ``worker``, from the journal's wall stamps:
    the dispatch that was lost to its requeue (the death's detection), the
    requeue to the next dispatch (the wait for a live worker) and to the
    ack."""
    recs = [json.loads(line) for line in journal.read_text().splitlines() if line.strip()]
    by_id: dict = {}
    for r in recs:
        by_id.setdefault(r.get("id"), []).append(r)
    detect, wait, answer = [], [], []
    for rs in by_id.values():
        for i, r in enumerate(rs):
            if r["op"] != "requeue" or r["worker"] != worker:
                continue
            lost = [x for x in rs[:i] if x["op"] == "dispatch"][-1]
            nxt = [x for x in rs[i + 1:] if x["op"] == "dispatch"]
            ack = [x for x in rs[i + 1:] if x["op"] == "ack"]
            detect.append(r["t"] - lost["t"])
            if nxt:
                wait.append(nxt[0]["t"] - r["t"])
            if ack:
                answer.append(ack[0]["t"] - r["t"])
    med = (lambda xs: statistics.median(xs) if xs else None)
    return {"requeued": len(detect), "detect_s": med(detect), "redispatch_s": med(wait),
            "answer_s": med(answer)}


def phase_fleet(ckpt: Path, root: Path, serve_stats: dict) -> dict:
    """Phase 22: the serving fleet. ``dcr-serve-torch --fleet.workers=2`` as
    a subprocess on phase 5b's genuine SD-2.1 directory at phase 14's bucket
    (ServeConfig()'s: 256 px, 50 DPM++ steps, max_batch 8; max_wait 1 s so a
    wave forms full batches): two worker processes share the card.

    (a) /healthz ok once both leases are ready; the supervisor holds no CUDA
    context, the workers do. (b) phase 14's 16-request wave answers 200,
    every image phase 14's in-process image bit for bit (its pixel hashes).
    (c) and (d) in one wave of the same 16 requests: worker_crash on worker
    0 (it SIGKILLs itself at its batch) and worker_hang on worker 1 with
    hang_timeout_s at 1.5x the predicted two-worker batch time, the
    longest batch the watchdog must let through (exit 89
    after its thread dump and flight-recorder dump); both batches requeued
    and answered bit for bit, the journal at 0 dropped and 0 failed,
    workers_lost >= 2, both workers respawned to ready (workers_alive 2).
    The fault's batch coordinate counts per process and which worker takes
    which batch of a wave is a race, so the drill first brings each worker
    to batch FLEET_FAULT_BATCH with 1-step requests sent to its own port.
    The fleet runs under --warm.dir: before the drills each worker has run
    the default bucket and the drill's 1-step bucket, so the warm manifest
    holds both, and each respawned worker must warm exactly those buckets
    (its /healthz buckets_total equals its previous incarnation's
    buckets_warm) and load the B1 library from the cache; its load and warm
    seconds are printed beside the first incarnation's, which warmed the
    default bucket alone (no manifest yet). (e) the merged
    /metrics parses as Prometheus text with both workers' series under
    worker labels (and each worker's dcr_device_mem_* gauges and its
    dcr_device_budget_remaining_bytes: what both hold plus what either may
    still admit must fit the card's memory), GET /slo has availability and
    shed_rate,
    dcr-status-torch --json exits 0. Then worker 0 is SIGKILLed with the
    warm manifest moved aside: its third incarnation warms the default
    bucket alone, and its respawn-to-ready seconds are printed beside (c)'s
    respawn with the manifest. (f) POST /debug/profile through the
    supervisor arms worker 1 for one batch of (g)'s wave of
    FLEET_PROFILE_STEPS-step requests: its Chrome trace holds 10
    forward-kernel events per UNet call. (g) SIGTERM with that wave in
    flight: every accepted request answered, the supervisor exits 83, no
    worker process left. The workers' B1 launches are not counted (other
    processes); (f)'s trace shows them."""
    import base64
    import contextlib
    import io
    import os
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from dcr_tpu_torch.cli import status as status_cli
    from dcr_tpu_torch.sampling import fastsample
    from dcr_tpu_torch.sampling.png import decode_png
    from dcr_tpu_torch.serve.fleet import RequestJournal, fleet_paths

    t_phase = time.perf_counter()
    wave = [{"prompt": p, "seed": s} for s in (1, 2, 3, 4) for p in SERVE_PROMPTS]
    single_batch_s = statistics.median(serve_stats["server_full_batch_s"])
    # two workers time-slice the card, so a batch of each at once takes
    # FLEET_SHARED_BATCH_RATIO x phase 14's; the watchdog covers every batch
    # of a worker, the clean wave's 50-step ones too, so its budget is 1.5x
    # that, and the hang drill costs this budget plus one respawn
    hang_timeout_s = round(1.5 * FLEET_SHARED_BATCH_RATIO * single_batch_s, 1)
    k = FLEET_FAULT_BATCH
    fault_spec = f"worker_crash@batch={k}&rank=0,worker_hang@batch={k}&rank=1"
    fleet_dir = root / "fleet"
    paths = fleet_paths(fleet_dir)
    argv = [f"--model_path={ckpt}", "--port=0", "--max_wait_ms=1000", "--fleet.workers=2",
            f"--fleet.dir={fleet_dir}", "--fleet.heartbeat_s=1", "--fleet.lease_s=20",
            "--fleet.respawn_base_delay_s=0.5", "--fleet.max_attempts=6",
            "--fleet.spawn_timeout_s=300", "--fleet.scrape_period_s=1",
            "--slo.short_window_s=5", "--slo.long_window_s=10",
            f"--hang_timeout_s={hang_timeout_s}", f"--warm.dir={root / 'fleet_warm'}"]
    stats: dict = {"card": CARD[0], "faults": fault_spec, "hang_timeout_s": hang_timeout_s,
                   "phase14_batch_s": single_batch_s}

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"fleet: {what}: {json.dumps(stats, default=str)}")

    def worker_log(i: int) -> str:
        return paths.worker_log(i).read_text(errors="replace")

    def bring_to_batch(i: int) -> int:
        """1-step requests straight to worker i's own port until its next
        batch is batch k; returns how many were sent."""
        wport = next(w for w in _metrics(port)["workers"] if w["index"] == i)["port"]
        n = json.loads(_http(wport, "/metrics")[2])["batches_total"]
        check(n <= k, f"worker {i} is already past batch {k} ({n} batches)")
        for seed in range(k - n):
            code = _http(wport, "/generate", {"prompt": "warm", "seed": seed, "steps": 1,
                                              "sampler": "ddim"})[0]
            check(code == 200, f"a direct request to worker {i} answered {code}")
        return k - n

    def answer(bodies: list[dict], what: str) -> dict:
        t0 = time.perf_counter()
        results, lat = _concurrent_posts(port, bodies)
        out = {"s": time.perf_counter() - t0, "p50_s": _percentile(lat, 50),
               "p99_s": _percentile(lat, 99)}
        codes = [c for c, _ in results]
        check(codes == [200] * len(bodies), f"{what} answered {codes}")
        if "steps" not in bodies[0]:
            diff = {}
            for body, (_, doc) in zip(bodies, results):
                img = decode_png(base64.b64decode(doc["image_png_b64"]))
                ref = SERVE_WAVE_PIXELS[_wave_key(body)]
                if _pixel_sha256(img) != serve_stats["wave_pixel_sha256"][_wave_key(body)]:
                    diff[_wave_key(body)] = int(np.abs(img.astype(int) - ref.astype(int)).max())
            out["pixel_mismatches"] = diff
            check(not diff, f"{what}: images differ from phase 14's in-process ones "
                            f"(largest |diff| per request {diff})")
        out["workers"] = sorted({doc.get("worker") for _, doc in results})
        return out

    def worker_health(i: int) -> dict:
        wport = next(w for w in _metrics(port)["workers"] if w["index"] == i)["port"]
        return json.loads(_http(wport, "/healthz")[2])

    def wait_alive(n: int, timeout: float) -> float:
        t0 = time.perf_counter()
        while _metrics(port)["workers_alive"] != n:
            check(time.perf_counter() - t0 < timeout and sup.proc.poll() is None,
                  f"workers_alive never returned to {n}")
            time.sleep(0.2)
        return time.perf_counter() - t0

    sup = ServeProcess(argv, root / "fleet_supervisor.log", env={"DCR_FAULTS": fault_spec},
                       group=True)
    try:
        # -- (a) startup --------------------------------------------------
        t0 = time.perf_counter()
        port = sup.wait_for_port(timeout=120, role="supervisor ")
        while True:
            health = json.loads(_http(port, "/healthz")[2])
            if health["status"] == "ok" and health["workers_ready"] == 2:
                break
            check(time.perf_counter() - t0 < 300 and sup.proc.poll() is None,
                  f"the fleet never became ready: {health}\n" + sup.text()[-3000:])
            time.sleep(0.2)
        stats["ready_s"] = time.perf_counter() - t0
        for i in (0, 1):
            text = worker_log(i)
            for stage in ("serve_load", "serve_warm"):
                m = re.search(rf"\[stage\] {stage}: done in ([\d.]+)s", text)
                stats[f"worker{i}_{stage}_s"] = float(m.group(1)) if m else None
        pids = {w["index"]: w["pid"] for w in _metrics(port)["workers"]}
        holders = _cuda_context_holders([sup.proc.pid, pids[0], pids[1]])
        stats["cuda_contexts"] = {"supervisor": sup.proc.pid, "workers": pids, **holders}
        seen = [m for m in ("nvidia_smi", "maps")
                if holders[m][pids[0]] and holders[m][pids[1]]]
        check(bool(seen), "neither nvidia-smi nor /proc/<pid>/maps shows the workers' contexts")
        check(not any(holders[m][sup.proc.pid] for m in seen),
              "the supervisor holds a CUDA context")
        stats["cuda_context_seen_by"] = seen

        # -- (b) the clean wave --------------------------------------------
        stats["clean_wave"] = answer(wave, "the clean wave")
        stats["clean_batches"] = {
            i: [[int(n), float(t)] for n, t in
                re.findall(r"serve: batch of (\d+)/8 in ([\d.]+)s", worker_log(i))]
            for i in (0, 1)}
        fleet_batch_s = [t for b in stats["clean_batches"].values() for n, t in b if n == 8]
        stats["fleet_batch_s_median"] = statistics.median(fleet_batch_s) if fleet_batch_s \
            else None
        if stats["fleet_batch_s_median"]:
            stats["hang_timeout_over_batch"] = hang_timeout_s / stats["fleet_batch_s_median"]

        # -- (c) and (d): the crash and the hang drills, in one wave ----------
        # worker 0 SIGKILLs itself at its batch; its batch waits at the
        # queue's head for the respawned worker 0 (worker 1 is wedged). Worker
        # 1 hangs in its batch until the watchdog's exit 89; that batch goes
        # to worker 0 too, and worker 1 respawns
        with ThreadPoolExecutor(max_workers=2) as ex:
            stats["drill_direct_requests"] = list(ex.map(bring_to_batch, (0, 1)))
        served = {i: worker_health(i)["buckets_warm"] for i in (0, 1)}
        manifest = json.loads((root / "fleet_warm" / "warm_manifest.json").read_text())
        stats["warm_manifest"] = manifest["entries"]
        check(served == {0: 2, 1: 2} and len(manifest["entries"]) == 2,
              f"before the drills each worker served 2 buckets, recorded in the manifest: "
              f"{served}")
        lost0 = _metrics(port)["fleet"].get("workers_lost", 0)
        stats["drill_wave"] = answer(wave, "the drills' wave")
        stats["drill_respawn_wait_s"] = wait_alive(2, 300)
        respawned = {i: worker_health(i) for i in (0, 1)}
        stats["respawned_health"] = respawned
        check(all(respawned[i]["buckets_total"] == served[i] for i in (0, 1)),
              "a respawned worker did not warm its previous incarnation's buckets")
        stats["warm_start"] = {}
        for i in (0, 1):
            text = worker_log(i)
            loads = re.findall(r"\[stage\] serve_load: done in ([\d.]+)s", text)
            warms = re.findall(r"\[stage\] serve_warm: done in ([\d.]+)s", text)
            kernels = re.findall(r"built sampler for bucket .* \(kernels: (\w+) in ([\d.]+)s\)",
                                 text)
            stats["warm_start"][i] = {"load_s": [float(x) for x in loads],
                                      "warm_s": [float(x) for x in warms],
                                      "kernels": kernels}
            # one sampler per bucket and incarnation: 2 at the first boot (the
            # first worker to resolve B1 stores it, so the other may hit), 2 at
            # the respawn, which must load from the cache
            check(len(warms) == 2 and len(kernels) == 4
                  and all(k == "cache" for k, _ in kernels[2:]),
                  f"worker {i}'s respawn did not load the kernel library from the cache")
        check(any(stats["warm_start"][i]["kernels"][0][0] == "compiled" for i in (0, 1)),
              "no worker stored the kernel library at the first boot")
        doc = _metrics(port)
        replay = RequestJournal.replay(paths.journal)["counts"]
        stats["drill_journal"] = replay
        stats["drill_workers_lost"] = doc["fleet"].get("workers_lost", 0) - lost0
        check(stats["drill_workers_lost"] >= 2, "the drills lost fewer than two workers")
        check(replay["dropped"] == 0 and replay["failed"] == 0
              and replay["requeued_total"] >= 2, f"the drills' journal {replay}")
        for w in doc["workers"]:
            check(w["incarnation"] == 2 and w["state"] == "alive",
                  f"worker {w['index']} did not respawn once: {w}")
        check('"kind": "worker_crash"' in worker_log(0), "worker_crash never fired")
        w1log = worker_log(1)
        check('"kind": "worker_hang"' in w1log
              and "hang watchdog: aborting 'serve_batch' with exit code 89" in w1log
              and "Thread 0x" in w1log, "no exit 89 with its thread dump in worker 1's log")
        dump_path = fleet_dir / "worker_1" / "flightrec_w1_0.json"
        dump = json.loads(dump_path.read_text()) if dump_path.exists() else {}
        stats["hang_dump_reason"] = dump.get("reason")
        check(str(dump.get("reason", "")).startswith("hang_abort:serve_batch"),
              f"worker 1's flight-recorder dump: {dump.get('reason')}")
        text = sup.text()
        for i, what in ((0, "crash"), (1, "hang")):
            lost = re.findall(rf'fleet_worker_lost (\{{.*"worker": {i}\}})', text)
            lost_t = _log_times(text, rf'fleet_worker_lost .*"worker": {i}\}}')
            joined_t = _log_times(text, rf'fleet_worker_joined .*"incarnation": 2.*"worker": {i}')
            stats[what] = {"worker_lost": json.loads(lost[-1]) if lost else None,
                           "respawn_s": joined_t[0] - lost_t[0] if lost_t and joined_t
                           else None,
                           "requeue": _requeue_latencies(paths.journal, i)}
            check(stats[what]["requeue"]["requeued"] >= 1, f"no {what} batch was requeued")
            ws = stats["warm_start"][i]
            ws["respawn_s"] = stats[what]["respawn_s"]
        log(f"fleet respawns under --warm.dir (phase 22, {CARD[0]}): " + "; ".join(
            f"worker {i}: respawn to ready {ws['respawn_s']} s with the manifest "
            f"({respawned[i]['buckets_total']} buckets warmed, load {ws['load_s'][-1]} s + warm "
            f"{ws['warm_s'][-1]} s); first boot without it (the default bucket alone) load "
            f"{ws['load_s'][0]} s + warm {ws['warm_s'][0]} s"
            for i, ws in stats["warm_start"].items()))

        # -- (e) observability ---------------------------------------------
        time.sleep(2.5)                       # two scrape periods after the respawn
        code, _, raw = _http(port, "/metrics?format=prometheus")
        samples, bad_lines = {}, []
        for line in raw.decode().splitlines():
            if not line or line.startswith("#"):
                continue
            mm = re.match(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$', line)
            if mm is None:
                bad_lines.append(line)
                continue
            samples[mm.group(1) + (mm.group(2) or "")] = float(mm.group(3))
        per_worker = {i: {n.split("{")[0]: v for n, v in samples.items()
                          if f'worker="{i}"' in n and "quantile" not in n} for i in (0, 1)}
        stats["prometheus"] = {"code": code, "samples": len(samples), "bad_lines": bad_lines[:5],
                               "series_worker0": len(per_worker[0]),
                               "series_worker1": len(per_worker[1])}
        stats["memory_budget"] = {i: {g: per_worker[i].get(f"dcr_device_mem_{g}_bytes")
                                      for g in ("in_use", "peak", "limit")} for i in (0, 1)}
        for i in (0, 1):
            stats["memory_budget"][i]["remaining"] = per_worker[i].get(
                "dcr_device_budget_remaining_bytes")
        card_bytes = torch.cuda.get_device_properties(0).total_memory
        held = sum(stats["memory_budget"][i]["in_use"] or 0 for i in (0, 1))
        most = max(stats["memory_budget"][i]["remaining"] or 0 for i in (0, 1))
        stats["memory_budget"]["card_bytes"] = card_bytes
        stats["memory_budget"]["held_plus_most_remaining"] = held + most
        check(all(stats["memory_budget"][i]["remaining"] for i in (0, 1))
              and held + most <= card_bytes,
              "the workers' budgets: what both hold plus what either may still admit "
              "exceeds the card's memory")
        check(code == 200 and not bad_lines and per_worker[0] and per_worker[1]
              and "dcr_serve_completed_total" in per_worker[0]
              and "dcr_serve_completed_total" in per_worker[1]
              and samples.get('dcr_fleet_worker_up{worker="0"}') == 1
              and samples.get('dcr_fleet_worker_up{worker="1"}') == 1,
              "the merged Prometheus text")
        t0 = time.perf_counter()
        while True:
            slo = json.loads(_http(port, "/slo")[2])
            if slo.get("state") == "ok" or time.perf_counter() - t0 > 60:
                break
            time.sleep(0.5)
        stats["slo"] = {"state": slo.get("state"), "breach_total": slo.get("breach_total"),
                        "objectives": {n: o["state"] for n, o in slo["objectives"].items()},
                        "wait_s": time.perf_counter() - t0}
        check({"availability", "shed_rate"} <= set(slo["objectives"]), "GET /slo objectives")
        # dcr-status-torch's entry point, in this process (stdlib only)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                status_cli.main([f"--port={port}", "--json"])
                rc = 0
            except SystemExit as e:
                rc = e.code
        status_doc = json.loads(out.getvalue()) if out.getvalue().strip() else {}
        stats["dcr_status"] = {"rc": rc, "workers_alive": status_doc.get("workers_alive"),
                               "slo_state": status_doc.get("slo", {}).get("state"),
                               "journal": status_doc.get("journal")}
        check(rc == 0 and status_doc.get("workers_alive") == 2, f"dcr-status-torch: rc {rc}")

        # -- a respawn without the manifest ----------------------------------
        # worker 0 SIGKILLed with warm_manifest.json moved aside: its third
        # incarnation warms the default bucket alone, to set beside (c)'s
        # respawn, which warmed the manifest's two
        manifest_path = root / "fleet_warm" / "warm_manifest.json"
        manifest_path.rename(manifest_path.with_name("warm_manifest.json.aside"))
        os.kill(next(w["pid"] for w in _metrics(port)["workers"] if w["index"] == 0),
                signal.SIGKILL)
        t0 = time.perf_counter()
        while True:
            w0 = next(w for w in _metrics(port)["workers"] if w["index"] == 0)
            if w0["incarnation"] == 3 and w0["state"] == "alive" \
                    and worker_health(0).get("status") == "ok":
                break
            check(time.perf_counter() - t0 < 300 and sup.proc.poll() is None,
                  "worker 0 did not respawn without the manifest")
            time.sleep(0.2)
        text = sup.text()
        lost_t = _log_times(text, r'fleet_worker_lost .*"worker": 0\}')
        joined_t = _log_times(text, r'fleet_worker_joined .*"incarnation": 3.*"worker": 0')
        text0 = worker_log(0)
        bare = {"respawn_s": joined_t[0] - lost_t[-1] if lost_t and joined_t else None,
                "buckets_total": worker_health(0)["buckets_total"],
                "load_s": float(re.findall(r"\[stage\] serve_load: done in ([\d.]+)s",
                                           text0)[-1]),
                "warm_s": float(re.findall(r"\[stage\] serve_warm: done in ([\d.]+)s",
                                           text0)[-1])}
        stats["respawn_without_manifest"] = bare
        check(bare["buckets_total"] == 1 and bare["respawn_s"] is not None,
              "worker 0's respawn without the manifest did not warm the default bucket alone")
        log(f"fleet respawn without the manifest (phase 22, {CARD[0]}): worker 0 respawn to "
            f"ready {bare['respawn_s']} s (1 bucket warmed, load {bare['load_s']} s + warm "
            f"{bare['warm_s']} s), against {stats['crash']['respawn_s']} s with it")

        # -- (f) profiling through the supervisor, (g) the drain ---------------
        # the profiled batch is one of the drain's wave: a capture slows the
        # process's later launches, and nothing runs after the drain
        code, _, raw = _http(port, "/debug/profile", {"steps": 1, "worker": 1})
        armed = json.loads(raw)
        again = _http(port, "/debug/profile", {"steps": 1, "worker": 1})[0]
        check(code == 200 and armed.get("worker") == 1 and armed.get("logdir")
              and again == 409, f"profile arm {code} {raw[:300]!r}, second arm {again}")
        pids = [w["pid"] for w in _metrics(port)["workers"]]
        accepted = _metrics(port)["journal"]["accepted"]
        drain_wave = [{"prompt": SERVE_PROMPTS[i % 4], "seed": 200 + i,
                       "steps": FLEET_PROFILE_STEPS} for i in range(16)]
        with ThreadPoolExecutor(max_workers=len(drain_wave)) as ex:
            futs = [ex.submit(_http, port, "/generate", body) for body in drain_wave]
            t0 = time.perf_counter()
            while _metrics(port)["journal"]["accepted"] < accepted + len(drain_wave):
                check(time.perf_counter() - t0 < 60, "the drain wave was not admitted")
                time.sleep(0.01)
            journal = _metrics(port)["journal"]
            t0 = time.perf_counter()
            sup.proc.send_signal(signal.SIGTERM)
            codes = [f.result(timeout=300)[0] for f in futs]
            rc = sup.proc.wait(timeout=300)
        left = [pid for pid in pids if Path(f"/proc/{pid}").exists()]
        stats["drain"] = {"pending_at_sigterm": journal["queued"] + journal["in_flight"],
                          "codes_ok": codes.count(200), "exit_code": rc,
                          "s": time.perf_counter() - t0, "workers_left": left}
        check(codes == [200] * len(drain_wave) and rc == 83 and not left,
              f"drain: codes {codes}, exit {rc}, workers left {left}")
        traces = sorted(Path(armed["logdir"]).glob("*.json"))
        check(len(traces) == 1, f"worker 1's profile: {traces}")
        events = json.loads(traces[0].read_text()).get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"]
        calls = fastsample.unet_calls(fastsample.fast_plan(FLEET_PROFILE_STEPS, 0.0))
        stats["profile"] = {"artifact": str(traces[0]), "events": len(events),
                            "kernel_events": len(kernels), "unet_calls": calls,
                            "flash_fwd_events": sum("flash_fwd" in e.get("name", "")
                                                    for e in kernels),
                            "bytes": traces[0].stat().st_size}
        check(stats["profile"]["flash_fwd_events"] >= 10 * calls,
              "fewer than 10 forward-kernel events per UNet call in the profiled batch")
        replay = RequestJournal.replay(paths.journal)["counts"]
        stats["journal"] = replay
        check(replay["dropped"] == 0 and replay["failed"] == 0
              and replay["accepted"] == replay["acked"] == 2 * len(wave) + len(drain_wave),
              f"the whole run's journal {replay}")
    finally:
        sup.close()
        stats["supervisor_log_tail"] = sup.text()[-1500:].splitlines()[-6:]
        stats["phase_s"] = time.perf_counter() - t_phase
        log(f"serving fleet (phase 22, {CARD[0]}): {json.dumps(stats, default=str)}")
    return stats


# the warm-cache drills' sampler: the kernel-shaped tiny model at 128 px,
# 4 DPM++ steps, one prompt x 2 images, f32 (3 B1 launches per UNet call)
_WARM_SAMPLE = r"""
import hashlib, json, sys, time
from pathlib import Path

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import dcr_tpu_torch
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing, warmcache
from dcr_tpu_torch.core.config import ModelConfig, SampleConfig, WarmCacheConfig
from dcr_tpu_torch.ops import build
from dcr_tpu_torch.ops import flash_attention as fa
from dcr_tpu_torch.sampling.pipeline import build_models, generate

warm_dir, out = sys.argv[1], Path(sys.argv[2])
resolved = []
real_aot = warmcache.aot_compile


def spy(*args, **kwargs):
    res = real_aot(*args, **kwargs)
    resolved.append({"surface": res.surface, "source": res.source, "build_s": res.build_s})
    return res


warmcache.aot_compile = spy
models = build_models(ModelConfig(**json.loads(sys.argv[3])), "cuda", seed=0)
fa.flash_attention_fwd.launches = 0
t0 = time.perf_counter()
generate(SampleConfig(resolution=128, num_inference_steps=4, sampler="dpm++", num_batches=1,
                      im_batch=2, seed=0, savepath=str(out),
                      warm=WarmCacheConfig(dir=warm_dir)),
         modelstyle="nolevel", models=models, prompts=["a red square"], device="cuda")
torch.cuda.synchronize()
reg = tracing.registry()
print(json.dumps({
    "package": dcr_tpu_torch.__file__,
    "compiler_runs": dict(build.compiler_runs),
    "resolutions": {Path(k).name: v for k, v in build.resolutions.items()},
    "hits": reg.counter("warmcache/hits").value,
    "misses": reg.counter("warmcache/misses").value,
    "stores": reg.counter("warmcache/stores").value,
    "faults": R.counters(),
    "launches": fa.flash_attention_fwd.launches,
    "resolved": resolved,
    "toolchain": build.toolchain(True),
    "generate_s": time.perf_counter() - t0,
    "png_sha256": [hashlib.sha256(p.read_bytes()).hexdigest()
                   for p in sorted((out / "generations").glob("*.png"))],
}))
"""


def _warm_sample(tree: Path, warm: Path, out: Path, env: dict) -> dict:
    """_WARM_SAMPLE run from ``tree`` (its dcr_tpu_torch alone on the path);
    the subprocess's JSON with its wall seconds."""
    import dataclasses

    model = {f.name: getattr(_tiny_kernel_cfg(), f.name)
             for f in dataclasses.fields(_tiny_kernel_cfg())}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _WARM_SAMPLE, str(warm), str(out),
                           json.dumps(model)], cwd=str(tree), env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"warm-cache sampler in {tree} exited {proc.returncode}:\n"
                             + proc.stderr[-4000:])
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    doc["wall_s"] = time.perf_counter() - t0
    doc["log"] = [line for line in proc.stderr.splitlines()
                  if "warm cache" in line or "warmcache" in line][-6:]
    return doc


# the warm-cache drills' trainer: phase 20's kernel-shaped tiny model at
# 128 px, batch 2, 2 steps, f32 (3 launches of each of B1, B2, B3 a step)
WARM_TRAIN_STEPS = 2

_WARM_TRAIN = r"""
import json, sys, time
from pathlib import Path

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import dcr_tpu_torch
from dcr_tpu_torch.core import tracing, warmcache
from dcr_tpu_torch.core.config import TrainConfig, parse_cli
from dcr_tpu_torch.diffusion.trainer import Trainer
from dcr_tpu_torch.ops import build
from dcr_tpu_torch.ops import flash_attention as fa

resolved = []
real_aot = warmcache.aot_compile


def spy(*args, **kwargs):
    res = real_aot(*args, **kwargs)
    resolved.append({"surface": res.surface, "source": res.source, "build_s": res.build_s})
    return res


warmcache.aot_compile = spy
cfg = parse_cli(TrainConfig, [f"--config={sys.argv[1]}"])
fa.flash_attention_fwd.launches = 0
fa.flash_attention_bwd.dq_launches = fa.flash_attention_bwd.dkv_launches = 0
t0 = time.perf_counter()
metrics = Trainer(cfg, device="cuda").train()
torch.cuda.synchronize()
reg = tracing.registry()
print(json.dumps({
    "package": dcr_tpu_torch.__file__,
    "compiler_runs": dict(build.compiler_runs),
    "resolutions": {Path(k).name: v for k, v in build.resolutions.items()},
    "hits": reg.counter("warmcache/hits").value,
    "stores": reg.counter("warmcache/stores").value,
    "launches_fwd_dq_dkv": [fa.flash_attention_fwd.launches, fa.flash_attention_bwd.dq_launches,
                            fa.flash_attention_bwd.dkv_launches],
    "resolved": resolved,
    "loss": float(metrics["loss"]),
    "train_s": time.perf_counter() - t0,
}))
"""


def _warm_train(tree: Path, root: Path, name: str, warm: Path, env: dict) -> dict:
    """_WARM_TRAIN run from ``tree`` (its dcr_tpu_torch alone on the path)
    over the PNGs of ``root/warm_data`` under --warm.dir; the subprocess's
    JSON with its wall seconds."""
    from dcr_tpu_torch.core.config import DataConfig, OptimConfig, TrainConfig, save_config

    cfg = TrainConfig(output_dir=str(root / name), max_train_steps=WARM_TRAIN_STEPS,
                      log_every=1, train_batch_size=2, mixed_precision="no", seed=0)
    cfg.model = _tiny_kernel_cfg()
    cfg.data = DataConfig(train_data_dir=str(root / "warm_data"), resolution=128,
                          class_prompt="nolevel", num_workers=2)
    cfg.optim = OptimConfig(learning_rate=1e-4, lr_scheduler="constant", lr_warmup_steps=0)
    cfg.warm.dir = str(warm)
    save_config(cfg, root / f"{name}.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _WARM_TRAIN, str(root / f"{name}.json")],
                          cwd=str(tree), env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"warm-cache trainer in {tree} exited {proc.returncode}:\n"
                             + proc.stderr[-4000:])
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    doc["wall_s"] = time.perf_counter() - t0
    return doc


def phase_warm_cache(root: Path) -> dict:
    """Phase 25: the warm cache (core/warmcache.py) from a cold tree. (a) In
    this checkout (its _build/ holds the libraries phase 2 built), a
    sampler subprocess under --warm.dir stores native/flash_attention_fwd
    (a miss, no nvcc). (b) dcr_tpu_torch/ copied without _build/ to a
    temporary tree: the same sampler there runs no compiler process at all
    (compiler_runs empty; the compiler's identity is its executable's
    sha256), counts a warm-cache
    hit, resolves the library from the cache and writes PNGs equal to (a)'s
    byte for byte. (c) A second copy without _build/, over its own copy of
    (a)'s warm dir, under DCR_FAULTS=cache_corrupt@load=0: the damaged
    entry is quarantined (faults warmcache/cache_corrupt 1, one
    *.quarantined.* file), nvcc rebuilds the library once, it is stored
    again, and the PNGs are (a)'s. The trainer's warm start: (d) a 2-step
    training subprocess in this checkout under (a)'s --warm.dir finds B1's
    entry and stores native/flash_attention_bwd (B2 and B3); (e) the same
    run in (b)'s copy with its _build/ removed resolves train/step from
    the cache (both libraries hits, no compiler process) and ends at (d)'s
    loss. (b), (c) and (d) run at once after (a), (e) after (b) and (d).
    Reported: each run's seconds, the cache load's seconds against the
    rebuild's nvcc seconds (beside the other runs), B1 launches per
    sampler run (12: 3 per UNet call) and B1/B2/B3 launches per training
    run (3 each a step)."""
    import os

    from dcr_tpu_torch.sampling.png import write_png

    from concurrent.futures import ThreadPoolExecutor

    warm, drill_warm = root / "warm", root / "warm_drill"
    cold, drill_tree = root / "cold", root / "cold_drill"
    repo = Path(__file__).resolve().parent
    for tree in (cold, drill_tree):
        shutil.copytree(repo / "dcr_tpu_torch", tree / "dcr_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k not in ("DCR_FAULTS", "PYTHONPATH")}
    stats: dict = {"card": CARD[0]}
    fill = _warm_sample(repo, warm, root / "out_fill", dict(env, PYTHONPATH=str(repo)))
    # the drill damages its own copy of B1's entry, so it runs beside the
    # cold tree's sampler and trainer, which read the shared one
    shutil.copytree(warm, drill_warm)
    for i in range(4):
        (root / "warm_data" / f"c{i % 2}").mkdir(parents=True, exist_ok=True)
        write_png(root / "warm_data" / f"c{i % 2}" / f"{i}.png", _photo(i, 128, 128))
    with ThreadPoolExecutor(2) as ex:
        drilling = ex.submit(_warm_sample, drill_tree, drill_warm, root / "out_drill",
                             dict(env, PYTHONPATH=str(drill_tree),
                                  DCR_FAULTS="cache_corrupt@load=0"))
        hitting = ex.submit(_warm_sample, cold, warm, root / "out_cold",
                            dict(env, PYTHONPATH=str(cold)))
        train_fill = _warm_train(repo, root, "train_fill", warm, dict(env, PYTHONPATH=str(repo)))
        hit = hitting.result()
        shutil.rmtree(cold / "dcr_tpu_torch" / "_build")
        train_cold = _warm_train(cold, root, "train_cold", warm, dict(env, PYTHONPATH=str(cold)))
        drill = drilling.result()
    stats.update(fill=fill, cold=hit, corrupt_drill=drill, train_fill=train_fill,
                 train_cold=train_cold, entries=sorted(p.name for p in warm.iterdir()),
                 drill_entries=sorted(p.name for p in drill_warm.iterdir()))

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"warm cache: {what}: {json.dumps(stats, default=str)}")

    def sampler(doc: dict) -> dict:
        return next(r for r in doc["resolved"] if r["surface"] == "sample/sampler")

    fwd = "flash_attention_fwd.cu"
    check(fill["package"].startswith(str(repo)) and hit["package"].startswith(str(cold))
          and drill["package"].startswith(str(drill_tree)),
          "a run imported another tree's package")
    check(fill["compiler_runs"].get("flash_attention_fwd", 0) == 0
          and fill["resolutions"].get(fwd) == "compiled" and fill["stores"] >= 1,
          "the fill run did not store the library it found built")
    check(hit["compiler_runs"] == {}, "the cold tree ran a compiler process")
    check(hit["resolutions"].get(fwd) == "cache" and hit["hits"] >= 1
          and sampler(hit)["source"] == "cache", "the cold tree did not load from the cache")
    check(drill["faults"].get("warmcache/cache_corrupt") == 1
          and sum(".quarantined." in n for n in stats["drill_entries"]) == 1,
          "the cache_corrupt drill did not quarantine one entry")
    check(drill["compiler_runs"].get("flash_attention_fwd") == 1
          and drill["resolutions"].get(fwd) == "compiled" and drill["stores"] >= 1,
          "the cache_corrupt drill did not rebuild and store the library")
    for doc in (fill, hit, drill):
        check(doc["launches"] == 12, f"B1 launches {doc['launches']} != 12")
    bwd = "flash_attention_bwd.cu"

    def train_step(doc: dict) -> dict:
        return next(r for r in doc["resolved"] if r["surface"] == "train/step")

    check(train_fill["package"].startswith(str(repo))
          and train_cold["package"].startswith(str(cold)), "a training run imported another "
          "tree's package")
    check(train_fill["compiler_runs"] == {} and train_fill["resolutions"].get(fwd) == "cache"
          and train_fill["resolutions"].get(bwd) == "compiled" and train_fill["stores"] >= 1,
          "the training fill run did not find B1's entry and store B2/B3's")
    check(train_cold["compiler_runs"] == {}, "the cold tree's trainer ran a compiler process")
    check(train_cold["resolutions"].get(fwd) == train_cold["resolutions"].get(bwd) == "cache"
          and train_cold["hits"] >= 2 and train_step(train_cold)["source"] == "cache",
          "the cold tree's trainer did not load both libraries from the cache")
    for doc in (train_fill, train_cold):
        check(doc["launches_fwd_dq_dkv"] == [3 * WARM_TRAIN_STEPS] * 3,
              f"training launches {doc['launches_fwd_dq_dkv']}")
    check(math.isfinite(train_cold["loss"])
          and abs(train_cold["loss"] - train_fill["loss"]) <= 1e-4 * abs(train_fill["loss"]),
          "the cold tree's training loss is not the fill run's")
    check(len(fill["png_sha256"]) == 2 and hit["png_sha256"] == fill["png_sha256"]
          and drill["png_sha256"] == fill["png_sha256"], "the PNGs differ across the runs")
    stats["cache_load_s"] = sampler(hit)["build_s"]
    stats["rebuild_s"] = sampler(drill)["build_s"]
    stats["train_cache_load_s"] = train_step(train_cold)["build_s"]
    log(f"warm cache (phase 25, {CARD[0]}): toolchain {hit['toolchain']!r}; fill run "
        f"{fill['wall_s']:.1f} s (stored, no nvcc), cold tree {hit['wall_s']:.1f} s "
        f"(compiler runs {hit['compiler_runs']}, hits {hit['hits']}, library from the cache "
        f"in {stats['cache_load_s']:.3f} s), cache_corrupt drill {drill['wall_s']:.1f} s "
        f"(quarantined 1, nvcc rebuild {stats['rebuild_s']:.1f} s); B1 launches 12 per run; "
        f"PNGs equal across the three runs; trainer: fill {train_fill['wall_s']:.1f} s "
        f"(stored B2/B3), cold tree {train_cold['wall_s']:.1f} s (compiler runs "
        f"{train_cold['compiler_runs']}, B1 and B2/B3 from the cache in "
        f"{stats['train_cache_load_s']:.3f} s, loss {train_cold['loss']!r} against "
        f"{train_fill['loss']!r}); entries {stats['entries']}")
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
# phase 13's store: a LAION chunk and a quarter of the next one, past
# DEFAULT_MAX_RESIDENT_ROWS (2^20) so the query engine streams (cut from two
# whole chunks so the script keeps inside its time limit)
SEARCH_STORE_CHUNKS = (SEARCH_CHUNK_ROWS, SEARCH_CHUNK_ROWS // 4)
SEARCH_STORE_ROWS = sum(SEARCH_STORE_CHUNKS)


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
    return seconds, _json_docs(buf.getvalue())


def _json_docs(text: str) -> list:
    """The JSON documents a command printed, other lines skipped."""
    docs, dec = [], json.JSONDecoder()
    pos = 0
    while text[pos:].strip():
        if text[pos:].lstrip().startswith("{"):
            doc, end = dec.raw_decode(text[pos:].lstrip())
            pos = len(text) - len(text[pos:].lstrip()) + end
            docs.append(doc)
        else:
            pos = text.index("\n", pos) + 1 if "\n" in text[pos:] else len(text)
    return docs


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
    dumps of 1,048,576 and 262,144 unit rows (SEARCH_STORE_CHUNKS: 1,310,720
    rows, 2.7 GB, 20 shards of 65,536), verify it, query it with 4,096
    generation rows (64 of them
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

    # the two LAION chunk dumps: reference-format pickles of unit rows
    t0 = time.perf_counter()
    laion, chunks = root / "laion", []
    for c, n_rows in enumerate(SEARCH_STORE_CHUNKS):
        folder = laion / f"chunk{c}"
        folder.mkdir(parents=True)
        feats = _unit_rows(n_rows, SEARCH_DIM, seed=100 + c)
        keys = [f"{c:05d}{i:07d}" for i in range(n_rows)]
        with open(folder / "embedding.pkl", "wb") as f:
            pickle.dump({"features": feats, "indexes": keys}, f, protocol=4)
        chunks.append((feats, keys))
    dump_bytes = sum((laion / f"chunk{c}" / "embedding.pkl").stat().st_size for c in range(2))
    stats["write_dumps_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(13)
    q = _unit_rows(SEARCH_QUERIES, SEARCH_DIM, seed=200)
    planted_rows = rng.choice(SEARCH_STORE_ROWS, SEARCH_COPIES, replace=False)
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
    shards = -(-SEARCH_STORE_ROWS // 65536)
    if (report["rows"] != SEARCH_STORE_ROWS or report["shards"] != shards
            or verify != {"shards": shards, "ok": shards, "corrupt": 0,
                          "rows_ok": SEARCH_STORE_ROWS, "total": SEARCH_STORE_ROWS}):
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
        rows = SEARCH_CHUNK_ROWS if s == store1 else SEARCH_STORE_ROWS
        entry = {"cli_s": cli_s, "top_k": k, "rows": rows,
                 "peak_bytes": torch.cuda.max_memory_allocated(),
                 **probe.report(rows, SEARCH_QUERIES, SEARCH_DIM)}
        with np.load(out) as z:
            tables[name] = (z["scores"], z["keys"].astype(object))
        stats[name] = entry
        log(f"search main path, query {name}: {json.dumps(entry)}")
    if stats["streamed_k10"]["resident"] or not stats["resident_one_chunk_k10"]["resident"]:
        raise AssertionError("search: the 1.3M-row store must stream, the 1M-row one stay "
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
                            "rows_x_queries_per_s": SEARCH_STORE_ROWS * SEARCH_QUERIES
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
    # phase 24 queries this store and embeds the first tar on two ranks
    MESH_INPUTS["search"] = {"store": store, "q": q, "s10": s10, "k10": k10,
                             "tars": root / "embed" / "tars",
                             "dump": root / "embed" / "gen_embed" / "embedding.npz",
                             "engine_build_s": stats["streamed_k10"]["engine_build_s"],
                             "query_call_s": stats["streamed_k10"]["query_call_s"],
                             "embed_s": stats["embed"]["embed_s"]}
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


def phase_ann_corpus(root: Path) -> dict:
    """Phase 16's set-up, run while phase 2 builds (numpy and the disk, no
    card kernel, no JPEG library): the clustered corpus, its
    reference-format pickle dump and the generations' npz."""
    import pickle

    import numpy as np

    from dcr_tpu_torch.search import embed as E

    t0 = time.perf_counter()
    feats, q, picks = _ann_corpus(ANN_ROWS, SEARCH_DIM, ANN_CLUSTERS, ANN_QUERIES, ANN_HOT)
    keys = np.asarray([f"ann{i:07d}" for i in range(ANN_ROWS)], dtype=object)
    dump, gens = root / "chunk" / "embedding.pkl", root / "gens"
    dump.parent.mkdir()
    gens.mkdir()
    # a reference-format pickle, as phase 13 writes its chunks (an npz dump
    # is zlib-compressed: tens of seconds for 2 GB of random floats)
    with open(dump, "wb") as f:
        pickle.dump({"features": feats, "indexes": keys.tolist()}, f, protocol=4)
    E.save_embeddings(gens / "embedding.npz", q, [f"gen{i}" for i in range(ANN_QUERIES)])
    return {"feats": feats, "q": q, "picks": picks, "keys": keys, "dump": dump, "gens": gens,
            "corpus_s": time.perf_counter() - t0}


def phase_ann(root: Path, corpus: dict) -> dict:
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
    share is reported, not held (the engines rank by dot product). The
    corpus comes from phase_ann_corpus."""
    import numpy as np

    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.search import ann
    from dcr_tpu_torch.search import annindex as AI

    t_phase = time.perf_counter()
    reset_launches()
    stats: dict = {"card": CARD[0]}
    feats, q, picks, keys = (corpus[k] for k in ("feats", "q", "picks", "keys"))
    dump, gens, store = corpus["dump"], corpus["gens"], root / "store"
    stats["corpus_s"] = corpus["corpus_s"]
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
    # phase 24 asks the same question of this index on two ranks (keep_ann_inputs
    # keeps the store as it is now, before phase 17 retrains it)
    MESH_INPUTS["ann"] = {"cli_s": cli_s, "cli_k": cli_k, "ex_k": ex_k, "bound": bound,
                          "engine_build_s": stats["ann_query_cli"]["ann"].get("engine_build"),
                          "query_call_s": stats["ann_query_cli"]["ann"].get("query")}
    del eng, feats
    stats["drills"] = _ann_small_store_drills(root)
    log(f"ann small store drills ({CARD[0]}): {json.dumps(stats['drills'], default=str)}")
    if read_launches() != (0, 0, 0):
        raise AssertionError(f"the ann drills launched flash kernels: {read_launches()}")
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"ann phase 16: {stats['phase_s']:.1f} s")
    return stats


# the live provenance phase (17): phase 16's raw store of one LAION chunk with
# its IVF tier retrained normalised, behind phase 14's serving bucket with
# ingest and ANN copy-risk scoring on
LIVE_TOP_K = 5
LIVE_WIDE_SHORTLIST = 2048
# the pump stalls (ingest_stall) before the 8th and the 16th row, so each
# wave's first 7 rows sit acked in the live tail while /check reads them
# (7 calls of 0.46-0.47 s each on an H100: the stall leaves them ~2.5x)
LIVE_STALL_S = 9.0
LIVE_FAULTS = "ingest_stall@row=7,ingest_stall@row=15"
# tests/fixtures/jax_wal_store: a live store the JAX package wrote, and the
# recipe of its rows (tests/test_torch_livestore.fixture_rows)
JAX_WAL_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_wal_store"
JAX_WAL_SEED, JAX_WAL_DIM = 2026, 32

_CRASH_APPEND = """
import sys
import numpy as np
from dcr_tpu_torch.search.livestore import LiveStore
from dcr_tpu_torch.utils import faults

faults.install("ingest_crash@append=3")
rows = np.load(sys.argv[2])
with LiveStore.open(sys.argv[1], lease_s=1.0, owner="crash-drill") as live:
    for i in range(6):
        live.append(rows[2 * i:2 * i + 2], ["crash%d_%d" % (i, j) for j in range(2)])
sys.exit(7)
"""

_CRASH_COMPACT = """
import sys
import numpy as np
from dcr_tpu_torch.search.livestore import LiveStore
from dcr_tpu_torch.utils import faults

faults.install("compact_crash@seal=0")
rows = np.load(sys.argv[2])
with LiveStore.open(sys.argv[1], lease_s=1.0, owner="crash-drill") as live:
    live.append(rows[:4], ["compact%d" % j for j in range(4)])
    live.compact()
sys.exit(7)
"""


class LiveProbe:
    """Times the live tier while installed (host clock, synchronised): each
    compaction (with its report), each ann fold, each risk-engine refresh."""

    def __init__(self):
        from dcr_tpu_torch.obs.copyrisk import CopyRiskIndex
        from dcr_tpu_torch.search import ann
        from dcr_tpu_torch.search.livestore import LiveStore

        self.targets = ((LiveStore, "compact"), (ann, "fold_rows"),
                        (CopyRiskIndex, "refresh_store"))
        self.saved = [getattr(obj, name) for obj, name in self.targets]
        self.calls: dict[str, list] = {name: [] for _, name in self.targets}

    def __enter__(self) -> "LiveProbe":
        for (obj, name), fn in zip(self.targets, self.saved):
            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.calls[_name].append((time.perf_counter() - t0, out))
                return out
            setattr(obj, name, timed)
        return self

    def __exit__(self, *exc) -> None:
        for (obj, name), fn in zip(self.targets, self.saved):
            setattr(obj, name, fn)


def _retry_lease(fn, timeout: float = 60.0):
    """``fn()`` once the writer lease of a SIGKILLed process has aged out."""
    from dcr_tpu_torch.search.store import StoreLeaseHeldError

    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except StoreLeaseHeldError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def _crash_child(script: str, store: Path, rows_path: Path) -> int:
    import os

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DCR_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", script, str(store), str(rows_path)], env=env,
                          cwd=str(Path(__file__).resolve().parent), capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != -9:
        raise AssertionError(f"the crash drill's child exited {proc.returncode}, not by "
                             f"SIGKILL:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.returncode


def _live_drills(small: Path, root: Path) -> dict:
    """On phase 16's 65,536-row store (raw rows, its 64-list tier): ms per
    WAL append and a compaction that folds into the lists; ingest_crash at
    the 4th append in a subprocess, then `recover` and `query --live` equal
    to a store rebuilt after the fact from the acked rows; wal_torn
    in-process; compact_crash in a subprocess (the snapshot stays, the WAL
    stays, `compact` then completes); recall_degrade (the probe reads 0,
    the answers are unchanged)."""
    import numpy as np

    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.obs.recall_probe import RecallProbe
    from dcr_tpu_torch.search import annindex as AI
    from dcr_tpu_torch.search import embed as E
    from dcr_tpu_torch.search import store as ST
    from dcr_tpu_torch.search.annindex import spot_check_recall
    from dcr_tpu_torch.search.livestore import LiveStore, load_wal_tail
    from dcr_tpu_torch.search.shardindex import open_engine
    from dcr_tpu_torch.utils import faults

    feats, q, _ = _ann_corpus(65536, SEARCH_DIM, 64, 512, 8, seed=1)
    rng = np.random.default_rng(17)
    new = (feats[rng.choice(len(feats), 64, replace=False)]
           + rng.standard_normal((64, SEARCH_DIM)).astype(np.float32) * 0.05)
    stats: dict = {}
    snap0 = ST.snapshot_version(small)

    # ms per acked append (one 512-d row, fsynced), then a compaction
    append_ms = []
    with LiveStore.open(small, owner="append-drill") as live:
        for i in range(32):
            t0 = time.perf_counter()
            live.append(new[i:i + 1], [f"append{i}"])
            append_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        rep = live.compact()
        stats["compaction_32_rows"] = {"s": time.perf_counter() - t0, **rep}
    stats["append_ms_median"] = statistics.median(append_ms)
    stats["append_ms_max"] = max(append_ms)

    # ingest_crash@append=3: SIGKILL in the 4th append, 3 records acked
    rows_path = root / "drill_rows.npy"
    np.save(rows_path, new[32:])
    torn_before = tracing.registry().counters("ingest/").get("ingest/torn_total", 0)
    _crash_child(_CRASH_APPEND, small, rows_path)
    _, (recovered,) = _retry_lease(lambda: _cli(["recover", f"--store_dir={small}"]))
    stats["ingest_crash"] = {"recover": recovered, "torn_counter": tracing.registry().counters(
        "ingest/").get("ingest/torn_total", 0) - torn_before}
    base, base_keys = ST.EmbeddingStoreReader(small).load_all()
    tail, tail_keys, _ = load_wal_tail(small)
    rebuilt = root / "drill_rebuilt"
    with ST.EmbeddingStoreWriter.create(rebuilt, shard_rows=8192) as w:
        w.add(np.concatenate([base, tail]), list(base_keys) + [str(k) for k in tail_keys])
        w.finalize()
    gens = root / "drill_gens"
    gens.mkdir()
    dq = np.concatenate([q[:56], tail + 0.01]).astype(np.float32)   # the tail surfaces
    E.save_embeddings(gens / "embedding.npz", dq, [f"dq{i}" for i in range(len(dq))])
    tables = {}
    for name, store, extra in (("live", small, ["--live=true"]), ("rebuilt", rebuilt, [])):
        out = root / f"drill_{name}.npz"
        _cli(["query", f"--store_dir={store}", f"--gen_folder={gens}", f"--out_path={out}",
              "--top_k=10", *extra])
        with np.load(out) as z:
            tables[name] = z["scores"], z["keys"].astype(object)
    allf = np.concatenate([base, tail])
    allk = np.asarray(list(base_keys) + [str(k) for k in tail_keys], object)
    or_s, or_i = _oracle_topk(dq, allf, 11)
    bound = 1e-5 * float(np.linalg.norm(dq, axis=1).max() * np.linalg.norm(allf, axis=1).max())
    stats["ingest_crash"].update(
        acked_rows=int(len(tail)), tail_keys_in_answers=int(np.isin(
            tables["live"][1], tail_keys).any(axis=1).sum()),
        live_vs_rebuilt_bit_equal=bool(np.array_equal(tables["live"][0], tables["rebuilt"][0])
                                       and np.array_equal(tables["live"][1],
                                                          tables["rebuilt"][1])),
        live_vs_rebuilt=tie_rule("query --live after ingest_crash vs rebuilt",
                                 *tables["live"], *tables["rebuilt"], or_s, bound=bound,
                                 gap=2 * bound),
        live_vs_float64=tie_rule("query --live after ingest_crash vs float64",
                                 *tables["live"], or_s[:, :10], allk[or_i[:, :10]], or_s,
                                 bound=bound, gap=2 * bound))

    # wal_torn@append=1: a torn frame, not acked; the later append survives
    faults.install("wal_torn@append=1")
    try:
        with LiveStore.open(small, owner="torn-drill") as live:
            live.append(new[48:49], ["torn_a"])
            try:
                live.append(new[49:50], ["torn_b"])
                raise AssertionError("wal_torn did not fire")
            except ST.StoreError as e:
                torn_error = str(e)
            live.append(new[50:51], ["torn_c"])
    finally:
        faults.clear()
    with LiveStore.open(small, owner="torn-drill") as live:
        torn_tail = [str(k) for k in live.tail()[1]]
        stats["wal_torn"] = {"error": torn_error, "torn_segments": live.torn_segments,
                             "tail_rows": len(torn_tail)}
    if "torn_b" in torn_tail or not {"torn_a", "torn_c"} <= set(torn_tail):
        raise AssertionError(f"wal_torn: the tail holds {torn_tail}")

    # compact_crash@seal=0: SIGKILL before the CURRENT flip
    snap = ST.snapshot_version(small)
    wal_before = len(load_wal_tail(small)[0])
    _crash_child(_CRASH_COMPACT, small, rows_path)
    stats["compact_crash"] = {"snapshot_before": snap, "snapshot_after_kill":
                              ST.snapshot_version(small),
                              "wal_rows_before": wal_before,
                              "wal_rows_after_kill": len(load_wal_tail(small)[0])}
    _, (compacted,) = _retry_lease(lambda: _cli(["compact", f"--store_dir={small}"]))
    stats["compact_crash"]["compact"] = compacted["compaction"]

    # recall_degrade@probe=2: the second probe reads 0, answers unchanged
    eng = AI.open_ann_engine(small, top_k=10, device="cuda")
    exact = open_engine(small, top_k=10, device="cuda")
    s1, k1 = eng.query(q)
    probe = RecallProbe(every_n=1, k=10)
    first = probe.observe(eng, q, k1)
    faults.install("recall_degrade@probe=2")
    try:
        degraded = probe.observe(eng, q, k1)
    finally:
        faults.clear()
    s2, k2 = eng.query(q)
    stats["recall_degrade"] = {"first": first, "degraded": degraded,
                               "offline": spot_check_recall(eng, exact, q, k=10),
                               "answers_unchanged": bool(np.array_equal(s1, s2)
                                                         and np.array_equal(k1, k2))}
    d = stats
    ic, cc, rd = d["ingest_crash"], d["compact_crash"], d["recall_degrade"]
    if (d["compaction_32_rows"]["folded_rows"] != 32
            or d["compaction_32_rows"]["ann_lists_folded"] < 1
            or d["compaction_32_rows"]["snapshot"] != snap0 + 1
            or ic["recover"]["recovered_rows"] != 6 or ic["recover"]["torn_segments"] != 1
            or ic["torn_counter"] != 1 or ic["acked_rows"] != 6
            or ic["tail_keys_in_answers"] < 1
            or d["wal_torn"]["torn_segments"] != 1
            or cc["snapshot_after_kill"] != cc["snapshot_before"]
            or cc["wal_rows_after_kill"] != cc["wal_rows_before"] + 4
            or cc["compact"]["snapshot"] != cc["snapshot_before"] + 1
            or cc["compact"]["folded_rows"] != cc["wal_rows_before"] + 4
            or cc["compact"]["ann_lists_folded"] < 1
            or rd["degraded"] != 0.0 or not rd["answers_unchanged"]
            or abs(rd["first"] - rd["offline"]) > 0.05):
        raise AssertionError(f"live drills failed: {json.dumps(stats, default=str)}")
    return stats


def _jax_wal_fixture(root: Path) -> dict:
    """tests/fixtures/jax_wal_store, a live store the JAX package wrote:
    the port reads its WAL (3 acked records, a torn frame), recovers it,
    answers live queries on the card against a float64 oracle, and compacts
    it to rows bit-equal to the recipe's."""
    import numpy as np

    from dcr_tpu_torch.search import store as ST
    from dcr_tpu_torch.search.livestore import LiveStore, load_wal_tail, query_live

    rows = np.random.default_rng(JAX_WAL_SEED).standard_normal(
        (26, JAX_WAL_DIM)).astype(np.float32)
    keys = np.asarray([f"c{i:02d}" for i in range(12)] + [f"w{i:02d}" for i in range(6)]
                      + [f"t{i:02d}" for i in range(6)], object)
    store = root / "jax_wal_store"
    shutil.copytree(JAX_WAL_FIXTURE, store)
    tail, tail_keys, wal = load_wal_tail(store)
    q = rows[[3, 14, 20]] + 0.01
    scores, got = query_live(store, q, top_k=4, device="cuda")
    or_s, or_i = _oracle_topk(q, rows[:24], 5)
    bound = 1e-5 * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(rows, axis=1).max())
    with LiveStore.open(store) as live:
        opened = {"snapshot": live.snapshot, "committed": live.committed_total,
                  "recovered_rows": live.recovered_rows, "torn_segments": live.torn_segments}
        compaction = live.compact()
    feats, final_keys = ST.EmbeddingStoreReader(store).load_all()
    stats = {"wal": wal, "opened": opened, "compaction": compaction,
             "query_live_vs_float64": tie_rule("JAX-written WAL, query_live vs float64",
                                               scores, got, or_s[:, :4], keys[or_i[:, :4]],
                                               or_s, bound=bound, gap=2 * bound)}
    if (wal != {"records": 3, "rows": 6, "torn_segments": 1}
            or not np.array_equal(tail, rows[18:24]) or list(tail_keys) != list(keys[18:24])
            or opened != {"snapshot": 1, "committed": 18, "recovered_rows": 6,
                          "torn_segments": 1}
            or compaction["snapshot"] != 2 or not np.array_equal(feats, rows[:24])
            or final_keys != list(keys)):
        raise AssertionError(f"the JAX-written WAL: {json.dumps(stats, default=str)}")
    return stats


def _risk_engine_over_corpus(engine, store: Path, n: int = 256) -> dict:
    """Before any ingest: the serving risk engine (the normalised IVF tier,
    queries normalised, nprobe and shortlist as served) on ``n`` queries
    made as phase 16 makes its own (a corpus row plus N(0, 0.05^2) noise),
    against a float64 oracle over the normalised committed rows. A cluster's
    rows lie within ~1e-3 of one another, finer than the int8 scan resolves,
    so the served shortlist (32) may hold a rank's row or not: held are the
    served top-1 and the served rows' scores and order (each rescored in
    float64), under the tie rule; the served recall@k is reported. Every
    rank over the corpus is held through the same tier and convention with a
    shortlist of LIVE_WIDE_SHORTLIST (two clusters' rows) at nprobe =
    n_lists."""
    import numpy as np

    from dcr_tpu_torch.search import store as ST
    from dcr_tpu_torch.search.annindex import AnnEngine

    feats, keys = ST.EmbeddingStoreReader(store).load_all()
    keys = np.asarray(keys, object)
    rng = np.random.default_rng(17)
    picks = rng.choice(len(feats), n, replace=False)
    q = feats[picks] + rng.standard_normal((n, feats.shape[1])).astype(np.float32) * 0.05
    feats = ST.normalize_rows(feats)
    qn = ST.normalize_rows(q)
    k = engine.top_k
    or_s, or_i = _oracle_topk(qn, feats, k + 1)
    or_k = keys[or_i]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served_s, served_k = engine.query(q)
    served_ms = 1e3 * (time.perf_counter() - t0) / -(-n // engine.query_batch)
    t0 = time.perf_counter()
    wide = AnnEngine(store, top_k=k, nprobe=engine.ann.n_lists, query_batch=engine.query_batch,
                     shortlist_k=LIVE_WIDE_SHORTLIST, normalize_queries=True,
                     require_normalized_rows=True, device="cuda").build()
    wide_build_s = time.perf_counter() - t0
    wide_s, wide_k = wide.query(q)
    del wide
    torch.cuda.empty_cache()
    row_of = {key: i for i, key in enumerate(keys)}
    out = {"queries": n, "rows": len(feats), "nprobe": engine.nprobe,
           "shortlist_k": engine.shortlist_k, "served_ms_per_batch": served_ms,
           "served_top1_vs_float64": tie_rule(
               "risk engine top-1 as served vs float64 (normalised corpus)",
               served_s[:, :1], served_k[:, :1], or_s[:, :1], or_k[:, :1], or_s),
           "served_vs_its_rows": tie_rule(
               "risk engine as served vs float64 over the rows it returned",
               served_s, served_k, *_exact_rows(qn, feats, row_of, served_k),
               _union_reference(qn, feats, row_of, (served_k,), k)),
           "served_recall_at_k": sum(len(set(a) & set(b)) for a, b in
                                     zip(served_k, or_k[:, :k])) / (n * k),
           "wide_shortlist": LIVE_WIDE_SHORTLIST, "wide_build_s": wide_build_s,
           "wide_full_probe_vs_float64": tie_rule(
               "the normalised tier at nprobe = n_lists, wide shortlist, vs float64",
               wide_s, wide_k, or_s[:, :k], or_k[:, :k], or_s)}
    del feats
    log(f"risk engine over the corpus before ingest (phase 17, {CARD[0]}): {json.dumps(out)}")
    return out


def _exact_rows(q, feats, row_of: dict, keys):
    """float64 scores of each query over the rows ``keys`` names (in its
    order), and those keys: the served answer's own rows, rescored."""
    import numpy as np

    scores = np.asarray([[float(feats[row_of[key]].astype(np.float64) @ q[i].astype(np.float64))
                          for key in row] for i, row in enumerate(keys)])
    return scores, np.asarray(keys, object)


# the profiled request's denoising steps (a bucket of its own)
PROFILE_STEPS = 4


def _serve_memory_drills(port: int, root: Path) -> dict:
    """On phase 17's live server, in-process: (a) the dcr_device_mem_*
    gauges in /metrics' Prometheus text, with the card's figures; (b) the
    memory budget: the process's share of the card
    (torch.cuda.set_per_process_memory_fraction) cut for the drill to the
    bytes in use plus half the default bucket's measured footprint, a
    request for a novel bucket answers 503 memory_budget, then the share
    is put back."""
    from dcr_tpu_torch.obs import memwatch

    out: dict = {}
    problems: list[str] = []
    prom = {}
    for line in _http(port, "/metrics?format=prometheus")[2].decode().splitlines():
        if line.startswith("dcr_device_mem_"):
            name, value = line.rsplit(" ", 1)
            prom[name] = float(value)
    out["gauges"] = prom
    if not (prom.get("dcr_device_mem_in_use_bytes", 0) > 0
            and prom.get("dcr_device_mem_limit_bytes", 0) > 0
            and prom.get("dcr_device_mem_peak_bytes", 0) > 0):
        problems.append(f"dcr_device_mem_* gauges: {prom}")

    estimate = memwatch.estimate_surface_bytes("serve/batch_sampler")
    total = torch.cuda.get_device_properties(0).total_memory
    in_use = torch.cuda.memory_allocated()
    out["budget"] = {"estimate_bytes": estimate, "in_use_bytes": in_use,
                     "limit_bytes": in_use + (estimate or 0) // 2}
    torch.cuda.set_per_process_memory_fraction((in_use + (estimate or 0) // 2) / total)
    try:
        code, _, raw = _http(port, "/generate", {"prompt": "a red square", "seed": 5,
                                                 "steps": PROFILE_STEPS})
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    out["budget"].update(code=code, body=json.loads(raw))
    if not estimate or code != 503 or json.loads(raw).get("error") != "memory_budget":
        problems.append(f"memory budget drill: estimate {estimate}, answered {code} {raw[:300]}")

    log(f"serve memory drills (phase 17, {CARD[0]}): {json.dumps(out, default=str)}")
    if problems:
        raise AssertionError("serve memory drills: " + "; ".join(problems))
    return out


def phase_live_retrain(store: Path) -> dict:
    """Phase 17's set-up, run beside phase 20 and the reference phases:
    `train-ivf --ivf_normalize=true` (1,024 lists) over phase 16's store,
    dcr-search-torch as a subprocess on the card (in this process its
    stdout capture would take the other phases' log lines)."""
    import os

    env = {k: v for k, v in os.environ.items() if k != "DCR_FAULTS"}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent)
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dcr_tpu_torch.cli.search", "train-ivf",
                           f"--store_dir={store}", f"--n_lists={ANN_LISTS}",
                           f"--ivf_iters={ANN_ITERS}", "--ivf_normalize=true"], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"phase 17's train-ivf exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    (report,) = _json_docs(proc.stdout)
    return {"cli_s": time.perf_counter() - start, **report}


def phase_live_drills(ann_root: Path, root: Path) -> dict:
    """Phase 17's drills, run beside phase 20 (they hold results, not
    times): _live_drills on phase 16's small store and the JAX-written WAL
    (_jax_wal_fixture), with no flash launch."""
    before = read_launches()
    stats = {"drills": _live_drills(ann_root / "small_store", root)}
    log(f"live drills (phase 17, {CARD[0]}): {json.dumps(stats['drills'], default=str)}")
    stats["jax_wal"] = _jax_wal_fixture(root)
    log(f"JAX-written WAL (phase 17, {CARD[0]}): {json.dumps(stats['jax_wal'], default=str)}")
    if read_launches() != before:
        raise AssertionError(f"the drills launched flash kernels: {read_launches()}")
    return stats


def phase_live_serving(ckpt: Path, store: Path, root: Path, serve_stats: dict,
                       retrain: dict) -> dict:
    """Phase 17: live provenance in serving on phase 16's raw store of one
    LAION chunk (1,048,576 rows x 512), its IVF tier retrained with
    `train-ivf --ivf_normalize=true` (1,024 lists; phase_live_retrain's
    ``retrain``), behind phase 14's bucket
    (5b's genuine SD-2.1, 256 px, 50 DPM++ steps, max_batch 8, f32): the
    service and its HTTP front end in-process, parsed from dcr-serve's flags
    --risk.store_dir, --risk.ann=true, --risk.top_k=5, --ingest.enabled=true,
    --ingest.batch_rows=1, --ingest.compact_rows=8 and
    --slo.recall_probe_every_n=1, with DCR_FAULTS' ingest_stall before the
    8th and 16th rows (LIVE_STALL_S, 9 s, each) so each wave's first 7 rows sit in the
    live tail while /check reads them. Before any request, the risk engine
    over the corpus against float64 (_risk_engine_over_corpus). 16
    concurrent requests (two full batches). Held: 16 rows acked, none
    dropped; two compactions, each
    publishing a store snapshot and folding rows into the lists, with every
    untouched list's manifest entry byte-identical; every /check (7 + 7 in
    the tail, 16 after the compactions) agrees with a float64 oracle over
    the committed rows plus the rows acked at the time, under the tie rule;
    ann/recall_online_pct on /metrics with samples >= 1, within 0.05 of
    spot_check_recall offline on the 16 generations; 1,500 B1 launches
    (warm batch and two batches, 10 per UNet call); the exact engine that
    the index builds without risk.ann over the snapshot after ingest, past
    DEFAULT_MAX_RESIDENT_ROWS, host-streamed. The drills run apart
    (phase_live_drills). Reported,
    not held: each check's rank of its own gen/ key; risk ms per batch
    through the ANN engine and through the exact engine the index builds
    without risk.ann, over the same snapshot."""
    import base64
    import os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from dcr_tpu_torch.core import tracing
    from dcr_tpu_torch.core.config import (SampleConfig, ServeConfig, parse_cli,
                                           validate_serve_config)
    from dcr_tpu_torch.obs import memwatch
    from dcr_tpu_torch.obs.recall_probe import RecallProbe
    from dcr_tpu_torch.sampling.pipeline import load_generation_stack
    from dcr_tpu_torch.sampling.png import decode_png
    from dcr_tpu_torch.search import ann
    from dcr_tpu_torch.search import store as ST
    from dcr_tpu_torch.search.annindex import spot_check_recall
    from dcr_tpu_torch.search.livestore import load_wal_tail
    from dcr_tpu_torch.search.shardindex import DEFAULT_MAX_RESIDENT_ROWS, ShardedTopK
    from dcr_tpu_torch.serve.server import make_server
    from dcr_tpu_torch.serve.worker import GenerationService
    from dcr_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    stats: dict = {"card": CARD[0]}
    torch.cuda.empty_cache()
    stats["train_ivf"] = retrain
    lists_before = {int(e["list"]): (e["file"], e["sha256"])
                    for e in ann.read_ann_manifest(store)["lists"]}
    ann_snap0, store_snap0 = ann.ann_snapshot_version(store), ST.snapshot_version(store)
    committed0 = ST.EmbeddingStoreReader(store).total

    argv = [f"--model_path={ckpt}", "--port=0", f"--risk.store_dir={store}", "--risk.ann=true",
            f"--risk.top_k={LIVE_TOP_K}", "--ingest.enabled=true", "--ingest.batch_rows=1",
            "--ingest.compact_rows=8", "--slo.recall_probe_every_n=1"]
    cfg = parse_cli(ServeConfig, argv)
    validate_serve_config(cfg)
    stats["argv"] = argv[2:]
    stack = load_generation_stack(SampleConfig(model_path=str(ckpt)), device="cuda")
    os.environ["DCR_INGEST_STALL_S"] = str(LIVE_STALL_S)
    faults.install(LIVE_FAULTS)
    # the served requests' span trees; a generation's store key is
    # gen/<its trace id>, which its serve/request root carries
    tracing.configure(root / "trace")
    memwatch.reset_peak()
    reset_launches()
    probe = LiveProbe().__enter__()
    t0 = time.perf_counter()
    svc = GenerationService(cfg, stack)
    svc.begin_warm()
    svc.start()
    httpd = make_server(cfg, svc)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, name="live-http", daemon=True).start()
    checks: list[dict] = []

    def pump():
        return svc._pump.stats() if svc._pump is not None else {}

    trace_ids: dict[int, str] = {}

    def gen_key(doc) -> str:
        """The store key of a served generation: gen/<trace id>."""
        if doc["id"] not in trace_ids:
            for line in (root / "trace" / "trace.jsonl").read_text().splitlines():
                r = json.loads(line)
                if r["name"] == "serve/request" and "trace" in r:
                    trace_ids[r["args"]["request_id"]] = r["trace"]
        return f"gen/{trace_ids[doc['id']]}"

    def wait_for(what, cond, timeout=600.0):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 17: timed out waiting for {what}: {pump()}")
            time.sleep(0.02)

    def check(doc, when, acked):
        t = time.perf_counter()
        code, _, raw = _http(port, "/check", {"image_png_b64": doc["image_png_b64"]})
        ms = 1e3 * (time.perf_counter() - t)
        body = json.loads(raw)
        if code != 200:
            raise AssertionError(f"/check answered {code}: {body}")
        checks.append({"key": gen_key(doc), "when": when, "ms": ms,
                       "acked": sorted(acked), "scores": [s for _, s in body["topk"]],
                       "keys": [k for k, _ in body["topk"]]})

    try:
        svc.warm_start()
        stats["warm_s"] = time.perf_counter() - t0
        if not svc.wait_risk_ready(600) or svc.risk_status() != "ok":
            raise AssertionError(f"risk index: {svc.risk_status()}")
        wait_for("the live store", lambda: pump().get("status") == "ok")
        stats["ready_s"] = time.perf_counter() - t0
        stats["corpus_hold"] = _risk_engine_over_corpus(svc._risk._engine, store)
        wave = [{"prompt": p, "seed": s} for s in (1, 2, 3, 4) for p in SERVE_PROMPTS]
        barrier = threading.Barrier(len(wave))

        def one(body):
            barrier.wait()
            t = time.perf_counter()
            code, _, raw = _http(port, "/generate", body)
            return code, json.loads(raw), time.perf_counter() - t

        docs, first_batch = {}, set()
        with ThreadPoolExecutor(max_workers=len(wave)) as ex:
            t_wave = time.perf_counter()
            futs = [ex.submit(one, body) for body in wave]
            for n_acked, n_seen in ((7, 8), (15, 16)):
                wait_for(f"{n_seen} responses", lambda: sum(f.done() for f in futs) >= n_seen)
                wait_for(f"the stall at row {n_acked}",
                         lambda: pump().get("status") == "stalled"
                         and pump().get("appended_rows") == n_acked)
                for f in futs:
                    if f.done():
                        doc = f.result()[1]
                        docs.setdefault(doc["id"], doc)
                # acked: the tail, and the first batch once compaction 1 folded it
                tail_keys = {str(k) for k in load_wal_tail(store)[1]}
                for doc in docs.values():
                    if gen_key(doc) in tail_keys:
                        check(doc, "tail", tail_keys | first_batch)
                s = pump()
                if s.get("appended_rows") != n_acked or s.get("status") != "stalled":
                    raise AssertionError(f"the stall ended before the tail checks: {s}")
                stats[f"tail_rows_at_row_{n_acked}"] = len(tail_keys)
                first_batch = {gen_key(d) for d in docs.values()}
            results = [f.result() for f in futs]
            stats["wave_s"] = time.perf_counter() - t_wave
        wait_for("two compactions and refreshes",
                 lambda: pump().get("compactions") == 2 and pump().get("appended_rows") == 16
                 and len(probe.calls["refresh_store"]) == 2)
        codes = [c for c, _, _ in results]
        latencies = [s for _, _, s in results]
        docs = {d["id"]: d for _, d, _ in results}
        all_gen = {gen_key(d) for d in docs.values()}
        for doc in docs.values():
            check(doc, "committed", all_gen)
        metrics = json.loads(_http(port, "/metrics")[2])
        health = json.loads(_http(port, "/healthz")[2])
        prom = {}
        for line in _http(port, "/metrics?format=prometheus")[2].decode().splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                prom[name] = float(value)
        stats["memory_drills"] = _serve_memory_drills(port, root)
    finally:
        svc.begin_drain()
        svc.join_drained(timeout=600)
        svc.stop_ingest()
        httpd.shutdown()
        httpd.server_close()
        probe.__exit__()
        faults.clear()
        os.environ.pop("DCR_INGEST_STALL_S", None)
    launches = read_launches()
    # the warm batch and the wave's two batches
    stats.update(launches=launches[0], expected_launches=10 * 50 * 3,
                 peak_bytes=memwatch.peak_bytes(), codes=codes,
                 latency_p50_s=_percentile(latencies, 50),
                 latency_p99_s=_percentile(latencies, 99),
                 phase14_latency_p50_s=serve_stats.get("latency_p50_s"),
                 phase14_latency_p99_s=serve_stats.get("latency_p99_s"),
                 ingest=metrics.get("ingest"), health_ingest=health.get("ingest"),
                 recall_online_pct=prom.get("dcr_ann_recall_online_pct"),
                 recall_online_samples=prom.get("dcr_ann_recall_online_samples"),
                 recall_probe_total=prom.get("dcr_ann_recall_probe_total"),
                 staleness_rows=prom.get("dcr_ann_staleness_rows"))
    compactions = [(s, rep) for s, rep in probe.calls["compact"]]
    stats["compactions"] = [{"s": s, **{k: rep[k] for k in ("folded_rows", "snapshot",
                                                            "ann_lists_folded")}}
                            for s, rep in compactions]
    stats["fold_s"] = [s for s, _ in probe.calls["fold_rows"]]
    stats["refresh_store_s"] = [s for s, _ in probe.calls["refresh_store"]]
    tail_ms = [c["ms"] for c in checks if c["when"] == "tail"]
    stats["check_ms_with_tail_median"] = statistics.median(tail_ms) if tail_ms else None
    stats["check_ms_committed_median"] = statistics.median(
        [c["ms"] for c in checks if c["when"] == "committed"])

    # the float64 oracle over the committed rows plus the acked rows
    t0 = time.perf_counter()
    reader = ST.EmbeddingStoreReader(store)
    feats, keys = reader.load_all()
    keys = np.asarray(keys, object)
    is_gen = np.asarray([str(k).startswith("gen/") for k in keys])
    gen_rows = {str(k): r for k, r in zip(keys[is_gen], feats[is_gen])}
    base = torch.nn.functional.normalize(torch.from_numpy(feats[~is_gen]).to(
        "cuda", torch.float64), dim=1)
    base_keys = keys[~is_gen]
    qkeys = sorted(gen_rows)
    qn = torch.nn.functional.normalize(torch.from_numpy(np.stack(
        [gen_rows[k] for k in qkeys])).to("cuda", torch.float64), dim=1)
    bs, bi = torch.topk(qn @ base.T, LIVE_TOP_K + 1, dim=1)
    bs, bi = bs.cpu().numpy(), bi.cpu().numpy()
    gs = (qn @ qn.T).cpu().numpy()
    del base, qn
    torch.cuda.empty_cache()
    own_ranks, tie = [], []
    for c in checks:
        r = qkeys.index(c["key"])
        acked = [j for j, k in enumerate(qkeys) if k in set(c["acked"])]
        cand_s = np.concatenate([bs[r], gs[r, acked]])
        cand_k = np.concatenate([base_keys[bi[r]], np.asarray(qkeys, object)[acked]])
        order = np.argsort(-cand_s, kind="stable")[:LIVE_TOP_K + 1]
        ref_s, ref_k = cand_s[order][None], cand_k[order][None]
        tie.append(tie_rule(f"/check of {c['key']} ({c['when']}) vs float64",
                            np.asarray([c["scores"]]), np.asarray([c["keys"]], object),
                            ref_s[:, :LIVE_TOP_K], ref_k[:, :LIVE_TOP_K], ref_s))
        own_ranks.append(c["keys"].index(c["key"]) if c["key"] in c["keys"] else -1)
    stats["oracle_s"] = time.perf_counter() - t0
    stats["checks"] = {"tail": len(tail_ms), "committed": len(checks) - len(tail_ms),
                       "max_abs_score_diff": max(t["max_abs_score_diff"] for t in tie),
                       "decided_ranks": sum(t["decided_ranks"] for t in tie),
                       "own_key_ranks": own_ranks}

    # the folds: changed lists are exactly those the 16 rows went to
    lists_after = {int(e["list"]): (e["file"], e["sha256"])
                   for e in ann.read_ann_manifest(store)["lists"]}
    centroids = ann.AnnIndexReader(store).load_centroids()
    target = set(ann.assign_rows(ST.normalize_rows(np.stack([gen_rows[k] for k in qkeys])),
                                 centroids).tolist())
    changed = {i for i in lists_before if lists_after[i] != lists_before[i]}
    stats["folds"] = {"lists_changed": sorted(changed), "lists_targeted": sorted(target),
                      "untouched_identical": changed == target,
                      "ann_snapshot": [ann_snap0, ann.ann_snapshot_version(store)],
                      "store_snapshot": [store_snap0, reader.snapshot],
                      "rows": [committed0, reader.total]}

    # in-process: risk ms per batch through ANN and through the exact engine
    # that the index builds without risk.ann, over the same snapshot; the
    # probe; offline recall
    index = svc._risk
    index.live_tail, index.recall_probe = None, None
    engine = index._engine
    t0 = time.perf_counter()
    exact = ShardedTopK(reader, top_k=index.top_k, query_batch=index.batch,
                        segment_rows=index.cfg.segment_rows, normalize_queries=True,
                        normalize_rows=not reader.normalized, device="cuda").build()
    torch.cuda.synchronize()
    stats["exact_engine_build_s"] = time.perf_counter() - t0
    images = np.stack([decode_png(base64.b64decode(d["image_png_b64"])) for d in
                       list(docs.values())[:8]]).astype(np.float32) / 255.0
    for name, eng in (("ann", engine), ("exact", exact)):
        index._engine = eng
        score_s = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index.score_batch(images)
            torch.cuda.synchronize()
            score_s.append(time.perf_counter() - t0)
        stats[f"risk_score_ms_per_batch_{name}"] = 1e3 * statistics.median(score_s)
    index._engine = engine
    stats["risk_rows"] = [engine.reader.total, exact.total]
    # past DEFAULT_MAX_RESIDENT_ROWS after ingest: the exact engine streams
    # its segments from pinned host memory, rows normalised as they load
    stats["exact_engine_resident"] = exact.resident
    stats["phase14_risk_score_ms_per_batch_dense"] = serve_stats.get("risk_score_ms_per_batch")
    q = np.stack([gen_rows[k] for k in qkeys])
    _, served = engine.query(q[:8])
    probe_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        RecallProbe(every_n=1, k=10).observe(engine, q[:8], served)
        probe_s.append(time.perf_counter() - t0)
    stats["probe_ms_per_batch"] = 1e3 * statistics.median(probe_s)
    stats["offline_recall"] = spot_check_recall(engine, exact, q, k=10)
    del exact, svc, index, engine, stack
    torch.cuda.empty_cache()
    log(f"live serving (phase 17, {CARD[0]}): {json.dumps(stats)}")
    ing = stats["ingest"] or {}
    if (codes != [200] * 16 or ing.get("appended_rows") != 16 or ing.get("dropped_rows") != 0
            or stats["exact_engine_resident"]
            or stats["risk_rows"][1] <= DEFAULT_MAX_RESIDENT_ROWS
            or launches != (stats["expected_launches"], 0, 0)
            or len(compactions) != 2 or any(r["folded_rows"] != 8 for _, r in compactions)
            or sum(r["ann_lists_folded"] for _, r in compactions) < 1
            or stats["folds"]["ann_snapshot"][1] < ann_snap0 + 2
            or stats["folds"]["store_snapshot"][1] != store_snap0 + 2
            or stats["folds"]["rows"][1] != committed0 + 16
            or not stats["folds"]["untouched_identical"]
            or stats["checks"]["tail"] != 14 or stats["checks"]["committed"] != 16
            or not stats["recall_online_samples"] or stats["recall_online_samples"] < 1
            or stats["recall_online_pct"] is None
            or abs(stats["recall_online_pct"] / 100 - stats["offline_recall"]) > 0.05):
        raise AssertionError(f"phase 17 failed: {json.dumps(stats, default=str)}")

    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"live serving phase 17: {stats['phase_s']:.1f} s")
    return stats


def phase_profile_drill(root: Path) -> dict:
    """Phase 21 (last: torch.profiler's CUDA tracing may leave launches
    slower for the rest of the process, so no measured phase follows it):
    dcr-serve-torch's /debug/profile on an in-process server over
    ServeConfig()'s bucket at SD-2.1 widths (seeded random weights built on
    the card, f32): armed for one device step, a request of a
    PROFILE_STEPS-step bucket runs under torch.profiler; GET reports the
    Chrome trace, whose kernel events hold the forward kernel's
    10 x PROFILE_STEPS launches; a second arm while armed is a 409."""
    import threading

    from dcr_tpu_torch.core.config import ModelConfig, ServeConfig
    from dcr_tpu_torch.data.tokenizer import HashTokenizer
    from dcr_tpu_torch.sampling.pipeline import GenerationStack, build_models
    from dcr_tpu_torch.serve.server import make_server
    from dcr_tpu_torch.serve.worker import GenerationService

    mc = ModelConfig()
    stack = GenerationStack(build_models(mc, "cuda", seed=0), mc,
                            HashTokenizer(mc.text_vocab_size, mc.text_max_length),
                            torch.device("cuda"))
    cfg = ServeConfig(port=0)
    svc = GenerationService(cfg, stack)
    svc.start()
    httpd = make_server(cfg, svc)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, name="profile-http", daemon=True).start()
    reset_launches()
    try:
        t0 = time.perf_counter()
        code, _, raw = _http(port, "/debug/profile", {"steps": 1,
                                                      "logdir": str(root / "profile")})
        again = _http(port, "/debug/profile", {"steps": 1, "logdir": str(root / "x")})[0]
        gen_code = _http(port, "/generate", {"prompt": "a red square", "seed": 5,
                                             "steps": PROFILE_STEPS})[0]
        status = json.loads(_http(port, "/debug/profile")[2])
        deadline = time.monotonic() + 120
        while status.get("armed") and time.monotonic() < deadline:
            time.sleep(0.2)
            status = json.loads(_http(port, "/debug/profile")[2])
        wall = time.perf_counter() - t0
    finally:
        svc.begin_drain()
        svc.join_drained(timeout=120)
        httpd.shutdown()
        httpd.server_close()
        launches = read_launches()
    stats = {"card": CARD[0], "arm": code, "armed": json.loads(raw), "second_arm": again,
             "generate": gen_code, "status": status, "s": wall, "launches": launches[0]}
    artifact = status.get("artifact")
    problems = []
    if (code != 200 or again != 409 or gen_code != 200 or not artifact
            or not Path(artifact).is_file()):
        problems.append("arm, generate or artifact")
    else:
        events = json.loads(Path(artifact).read_text()).get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"]
        stats.update(events=len(events), kernel_events=len(kernels),
                     flash_fwd_events=sum("flash_fwd" in e.get("name", "") for e in kernels),
                     bytes=Path(artifact).stat().st_size)
        if stats["flash_fwd_events"] != 10 * PROFILE_STEPS:
            problems.append(f"{stats['flash_fwd_events']} forward-kernel events in the trace")
    if launches != (10 * PROFILE_STEPS, 0, 0):
        problems.append(f"launches {launches}")
    log(f"profile drill (phase 21, {CARD[0]}): {json.dumps(stats, default=str)}")
    if problems:
        raise AssertionError("profile drill: " + "; ".join(problems) + f": {stats}")
    del svc, stack
    torch.cuda.empty_cache()
    return stats


# phase 23: multi-process training. Two rank subprocesses, both on cuda:0,
# run _DIST_RANK over the parts of <root>/plan.json in order, joining a new
# process group for each (a TCPStore on the part's port), and write
# <root>/rank_<r>.json. (a) runs DIST_STEPS steps, (b) and (c) GLOO_STEPS:
# gloo moves 3.46 GB of gradients through host memory at 0.5-0.8 GB/s
# (PERF.md §6, multi-process training)
DIST_STEPS = 3
GLOO_STEPS = 2
# (c) runs one layer per block and SEQPAR_BLOCK_OUT_CHANNELS at 512 px:
# level 0 (S 4096, 5 heads) takes ring attention, level 1 (S 1024, 10
# heads) Ulysses, the mid block (S 256) the kernels per rank
SEQPAR_CASES = [
    ("seq_level1", 2, 1024, 1024, 5, 64, 1.0, True),
    ("seq_level2", 2, 256, 256, 20, 64, 1.0, True),
]
# (f) and (g)'s per-rank tensor-parallel shapes: SD-2.1's 10 level-1 heads
# split over 2 ranks ((f): bf16, 16 rows; (g): f32, CFG batch 4) and its 20
# level-2 heads ((g)); level 0's 5 heads do not split, so every rank runs
# them whole (phase 3's train_level0 and level0)
TP_CASES = [
    ("tp_level1", 16, 256, 256, 5, 64, 1.0, True),
    ("tp_sample_level1", 4, 1024, 1024, 5, 64, 1.0, True),
    ("tp_sample_level2", 4, 256, 256, 10, 64, 1.0, True),
]
# (g): generate over tensor = 2 from phase 6's export, 1 prompt x 2 images
# (one device batch of 2 on one process and on two, so the reference draws
# the same x_T; CFG batch 4), 512 px, DDIM
TP_SAMPLE_STEPS = 2

# phase 23's bars, against a run of the same global batch and draws in one
# process, from the largest gaps read on the card (PERF.md §6, multi-process
# training): the losses (8.2e-5) and the logged global grad norms (1.2e-4),
# each under a tenth of its bar; Adam's first moment after GLOO_STEPS steps,
# linear in the steps' global gradients so it keeps their scale, which the
# update hides (a leaf's norm 1.2e-2, a DIGEST_LEAVES leaf whole 2.5e-2: bf16
# sums reordered at the 256-token level), under a quarter of its bar. A sum
# in place of a mean moves a moment by 1.0; a missing rank's rows or seq
# slice gives another gradient
DIST_LOSS_RTOL = 1e-3
DIST_GRAD_NORM_RTOL = 2e-3
DIST_MOMENT_RTOL = 1e-1
# the UNet leaves whose whole first moment is compared: the input conv (every
# gradient reaches it), the first self-attention of each block's value and
# output projections (the ring, Ulysses and per-rank paths; the query and
# key projections' gradients at random init are bf16 rounding, up to 4.4e-2
# apart) and the output conv
DIGEST_LEAVES = ("conv_in.weight", *(f"attentions.0.transformer_blocks.0.attn1.{n}.weight"
                                     for n in ("to_v", "to_out.0")),
                 "conv_out.weight")


def adam_digest(state) -> dict:
    """Adam's first moment of every UNet leaf as its norm, and of the
    DIGEST_LEAVES leaves whole, on the host. Of a sharded state, a leaf's
    norm from its shards' sums of squares summed over the axes it is cut
    on, the DIGEST_LEAVES gathered (every rank calls it then)."""
    from dcr_tpu_torch.parallel import mesh as pmesh

    layout = state.layout
    mu = {k[len("unet/"):]: v for k, v in state.opt_state.mu.items() if k.startswith("unet/")}
    sq = torch.stack([v.detach().float().pow(2).sum() for v in mu.values()])
    for axis in (pmesh.FSDP_AXIS, pmesh.TENSOR_AXIS):
        cut = [layout is not None
               and getattr(layout.placement("unet", k), axis) is not None for k in mu]
        if any(cut):
            on = torch.tensor(cut, device=sq.device)
            summed = pmesh._all_reduce(torch.where(on, sq, torch.zeros_like(sq)),
                                       layout.mesh.group(axis), "digest_all_reduce")
            sq = torch.where(on, summed, sq)
    whole = (lambda k, v: v) if layout is None else (
        lambda k, v: layout.full(v, layout.placement("unet", k)))
    return {"norms": dict(zip(mu, sq.sqrt().tolist())),
            "leaves": {k: whole(k, v).detach().float().cpu().clone() for k, v in mu.items()
                       if k.endswith(DIGEST_LEAVES)}}


def digest_gap(got: dict, want: dict) -> dict:
    """The worst relative gap of ``got``'s leaf norms and of its whole
    DIGEST_LEAVES leaves from ``want``'s."""
    norms = {k: abs(got["norms"][k] - n) / n for k, n in want["norms"].items() if n > 0}
    leaves = {k: float((got["leaves"][k] - w).norm() / w.norm())
              for k, w in want["leaves"].items() if float(w.norm()) > 0}
    worst_norm, worst_leaf = max(norms, key=norms.get), max(leaves, key=leaves.get)
    return {"leaf_norms": len(norms), "worst_norm_rel": norms[worst_norm],
            "worst_norm_leaf": worst_norm, "whole_leaves": len(leaves),
            "worst_leaf_rel": leaves[worst_leaf], "worst_leaf": worst_leaf,
            "leaf_rel": leaves}


def rel_gaps(got, want) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(got, want))


_DIST_RANK = r"""
import datetime, json, math, statistics, sys, time
from pathlib import Path

import torch
import torch.distributed as tdist

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from dcr_tpu_torch.core import coordination as C
from dcr_tpu_torch.core import dist
from dcr_tpu_torch.core.config import SampleConfig, TrainConfig, from_dict
from dcr_tpu_torch.diffusion import trainer as TR
from dcr_tpu_torch.diffusion.trainer import Trainer
from dcr_tpu_torch.ops import flash_attention as fa
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.sampling.pipeline import generate
from dcr_tpu_torch.utils import profiling
from chip_smoke import adam_digest

rank, root = int(sys.argv[1]), Path(sys.argv[2])
plan = json.loads((root / "plan.json").read_text())
device = plan["device"]
out = {}
reduce_s, shapes = [], []
plain_reduce = pmesh.all_reduce_mean_


def sync():
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def timed_reduce(tensors, group=None):
    sync()
    start = time.perf_counter()
    plain_reduce(tensors, group)
    sync()
    reduce_s.append(time.perf_counter() - start)


pmesh.all_reduce_mean_ = timed_reduce
plain_flash = fa.flash_attention


def spied_flash(q, k, v):
    shapes.append([list(q.shape), str(q.dtype).split(".")[-1]])
    return plain_flash(q, k, v)


fa.flash_attention = spied_flash
# the state fingerprint the Trainer logs at the end of a multi-process run,
# kept (a second crc32 pass over the UNet costs seconds)
fingerprints = []
plain_fingerprint = TR.state_fingerprint


def noted_fingerprint(state):
    fingerprints.append(plain_fingerprint(state))
    return fingerprints[-1]


TR.state_fingerprint = noted_fingerprint
# mfu's FLOP count (phase 6 holds it) costs each Trainer ~2.5 s
profiling.train_step_flops = lambda *a, **k: None
for part in plan["parts"]:
    if rank >= part["world"]:
        continue
    rec = {"world": part["world"], "backend": part["backend"]}
    part_t0 = start = time.perf_counter()
    store = tdist.TCPStore("127.0.0.1", part["port"], part["world"], is_master=rank == 0,
                           timeout=datetime.timedelta(seconds=600), wait_for_workers=False)
    dist.initialize(device, backend=part["backend"], store=store, rank=rank,
                    world_size=part["world"])
    rec["init_s"] = time.perf_counter() - start
    start = time.perf_counter()
    dist.barrier("probe", timeout_s=120)
    rec["barrier_s"] = time.perf_counter() - start
    coord = C.Coordinator(timeout_s=120)
    start = time.perf_counter()
    rec["probe_action"] = coord.exchange(0, tag="probe").action.value
    rec["exchange_s"] = time.perf_counter() - start
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    reduce_s.clear()
    shapes.clear()
    pmesh.EXCHANGE_STATS.clear()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.dq_launches = fa.flash_attention_bwd.dkv_launches = 0
    if part.get("kind") == "generate":
        start = time.perf_counter()
        generate(from_dict(SampleConfig, part["cfg"]), modelstyle="nolevel", device=device)
        sync()
        rec.update(s=time.perf_counter() - start, launches_fwd=fa.flash_attention_fwd.launches,
                   flash_shapes=sorted({json.dumps(s) for s in shapes}),
                   exchanges=dict(pmesh.EXCHANGE_STATS),
                   peak_bytes=torch.cuda.max_memory_allocated() if device != "cpu" else 0,
                   part_s=time.perf_counter() - part_t0)
        out[part["name"]] = rec
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        dist.shutdown()
        (root / f"rank_{rank}.json").write_text(json.dumps(out))
        continue
    cfg = from_dict(TrainConfig, part["cfg"])
    fingerprints.clear()
    trainer = Trainer(cfg, device=device)
    # phase 6 holds the saves and the export
    trainer.save = lambda: None
    trainer.export_checkpoint = lambda *a, **k: None
    rec["mesh"] = trainer.mesh.shape
    losses, grad_norms, step_s = [], [], []
    step_fn = trainer.step_fn

    def step(state, batch):
        sync()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        sync()
        step_s.append(time.perf_counter() - t0)
        if len(losses) == plan["digest_step"]:
            digest = adam_digest(state)  # a sharded state's gathers: every rank
            if rank == 0:
                torch.save(digest, root / f"digest_{part['name']}.pt")
        return state, metrics

    trainer.step_fn = step
    trainer.train()
    rec["launches_fwd_dq_dkv"] = [fa.flash_attention_fwd.launches,
                                  fa.flash_attention_bwd.dq_launches,
                                  fa.flash_attention_bwd.dkv_launches]
    layout = trainer.state.layout
    rec.update(losses=losses, grad_norms=grad_norms, step_s=step_s, reduce_s=list(reduce_s),
               flash_shapes=sorted({json.dumps(s) for s in shapes}),
               exchanges=dict(pmesh.EXCHANGE_STATS),
               peak_bytes=torch.cuda.max_memory_allocated() if device != "cpu" else 0,
               fingerprint=fingerprints[-1] if part["world"] > 1 else None,
               # elements of the UNet's params this rank holds, and whole
               unet_elements=None if layout is None else [
                   sum(p.numel() for p in trainer.state.unet_params.values()),
                   sum(math.prod(layout.full_shape(p.shape, layout.placement("unet", k)))
                       for k, p in trainer.state.unet_params.items())],
               part_s=time.perf_counter() - part_t0)
    out[part["name"]] = rec
    del trainer
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    dist.shutdown()
    (root / f"rank_{rank}.json").write_text(json.dumps(out))
"""

_NCCL_TWO_ON_ONE = r"""
import datetime, json, sys
import torch
import torch.distributed as tdist
from dcr_tpu_torch.core import dist

rank, port = int(sys.argv[1]), int(sys.argv[2])
store = tdist.TCPStore("127.0.0.1", port, 2, is_master=rank == 0,
                       timeout=datetime.timedelta(seconds=120), wait_for_workers=False)
dist.initialize("cuda:0", backend="nccl", store=store, rank=rank, world_size=2)
try:
    t = torch.ones(1, device="cuda:0")
    tdist.all_reduce(t)
    torch.cuda.synchronize()
    print(json.dumps({"error": None}))
    sys.exit(3)
except Exception as e:
    print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(**extra) -> dict:
    import os

    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "DCR_FAULTS")}
    env["PYTHONPATH"] = (str(Path(__file__).resolve().parent) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def _seqpar_cfg(out_dir: Path, data: Path, **kw):
    """(c)'s configuration: TrainConfig() at 512 px, global batch 2, at
    one layer per block and SD-2.1's first three levels, sequence
    parallelism from 1,024 tokens, Ulysses."""
    from dcr_tpu_torch.core.config import ModelConfig, TrainConfig

    cfg = TrainConfig(output_dir=str(out_dir), max_train_steps=GLOO_STEPS, log_every=1,
                      modelsavesteps=10 ** 6, train_batch_size=2, **kw)
    cfg.data.train_data_dir = str(data)
    cfg.data.resolution = 512
    cfg.model = ModelConfig(sample_size=64, layers_per_block=FAULTS_LAYERS_PER_BLOCK,
                            block_out_channels=SEQPAR_BLOCK_OUT_CHANNELS,
                            seq_parallel_min_seq=1024, seq_parallel_mode="ulysses")
    return cfg


def phase_multi_process_training(root: Path, data: Path, fused_stats: dict) -> dict:
    """Phase 23: dcr-train-torch's Trainer as several processes on the one
    card (one card cannot host two NCCL ranks: (d)). Two rank subprocesses
    on cuda:0 run, in turn,
    (b) two ranks over gloo, mesh data = 2, 8 rows each, GLOO_STEPS steps:
        losses within DIST_LOSS_RTOL and grad norms within
        DIST_GRAD_NORM_RTOL of phase 6's, Adam's first moment within
        DIST_MOMENT_RTOL of (a)'s
        after as many steps (adam_digest), both ranks' parameters bit-equal
        (state fingerprints), the gradients' all-reduce seconds per step
        (gloo stages through host memory: not NCCL's);
    (c) two ranks over gloo, mesh seq = 2, at 512 px, global batch 2, at
        one layer per block and three levels with seq_parallel_min_seq
        1,024 and Ulysses: ring attention at level 0, Ulysses at level 1 (B1/B2/B3 at
        [2,1024,5,64] per rank), the mid block's kernels at [2,256,20,64];
        losses, grad norms and Adam's first moment within the same bars of
        a single-process Trainer on the same batches and draws (run here
        while the ranks start); peak memory;
    (e) two ranks over gloo, mesh fsdp = 2, 8 rows each, GLOO_STEPS steps,
        and (f) mesh tensor = 2, 16 rows each: (b)'s bars against phase 6
        and (a), each rank holding a share of the UNet's elements, the
        FSDP or Megatron exchanges taken; (f) B1/B2/B3 at each rank's heads
        (TP_CASES' tp_level1 at level 1, level 0's 5 heads whole);
    (g) generate over gloo, mesh tensor = 2, from phase 6's export at 512
        px, TP_SAMPLE_STEPS DDIM steps in f32: its PNGs within 1 uint8 level
        of a single-process generate on the same weights run here, B1 at
        level0 and TP_CASES' tp_sample shapes per rank;
    (a) rank 0 alone over NCCL at TrainConfig() on phase 6's data and seed,
        DIST_STEPS steps: its losses and grad norms equal phase 6's first
        ones bit for bit (a one-rank all-reduce and a divide by 1 are
        exact); the join, a
        store barrier and an agreement round timed;
    (d) two ranks over NCCL on one device, beside (c)'s reference: NCCL's
        refusal, kept as an expected error with its text.
    The phase's launches: the ranks' own counts over their train() calls."""
    import dataclasses
    import gc

    import numpy as np

    from dcr_tpu_torch.core.config import MeshConfig, SampleConfig, TrainConfig, to_dict
    from dcr_tpu_torch.diffusion.trainer import Trainer
    from dcr_tpu_torch.ops import flash_attention as fa
    from dcr_tpu_torch.sampling.pipeline import generate
    from dcr_tpu_torch.sampling.png import read_png

    stats: dict = {"card": CARD[0]}
    base = TrainConfig(output_dir=str(root / "a"), max_train_steps=DIST_STEPS, log_every=1,
                       modelsavesteps=10 ** 6, checkpoints_total_limit=1)
    base.data.train_data_dir = str(data)
    b_cfg = TrainConfig(output_dir=str(root / "b"), max_train_steps=GLOO_STEPS, log_every=1,
                        modelsavesteps=10 ** 6, train_batch_size=8)
    b_cfg.data.train_data_dir = str(data)
    b_cfg.mesh = MeshConfig(data=2)
    c_cfg = _seqpar_cfg(root / "c", data, mesh=MeshConfig(data=1, seq=2))
    sharded = {}
    for name, mesh, rows in (("e", MeshConfig(data=1, fsdp=2), 8),
                             ("f", MeshConfig(data=1, tensor=2), 16)):
        sharded[name] = TrainConfig(output_dir=str(root / name), max_train_steps=GLOO_STEPS,
                                    log_every=1, modelsavesteps=10 ** 6,
                                    train_batch_size=rows, mesh=mesh)
        sharded[name].data.train_data_dir = str(data)
    # phase 6's run directory (this phase runs in its temp dir), its export
    g_cfg = SampleConfig(model_path=str(root.parent / "run"), savepath=str(root / "g"),
                         num_batches=1, im_batch=2, resolution=512,
                         num_inference_steps=TP_SAMPLE_STEPS, sampler="ddim", seed=0,
                         mesh=MeshConfig(data=1, tensor=2))
    # (b) and (c) first: both ranks start cold together; (a) last, on rank
    # 0 alone (its first step then skips the process's warm-up, not its
    # numerics). A third process running (a) beside the pair doubled (b)'s
    # steps (host memory and cores shared with gloo's staging)
    parts = [dict(name="b", world=2, backend="gloo", cfg=to_dict(b_cfg)),
             dict(name="c", world=2, backend="gloo", cfg=to_dict(c_cfg)),
             *(dict(name=n, world=2, backend="gloo", cfg=to_dict(c_))
               for n, c_ in sharded.items()),
             dict(name="g", world=2, backend="gloo", kind="generate", cfg=to_dict(g_cfg)),
             dict(name="a", world=1, backend="nccl", cfg=to_dict(base))]
    for part in parts:
        part["port"] = _free_port()
    (root / "plan.json").write_text(json.dumps({"parts": parts, "device": "cuda:0",
                                                "digest_step": GLOO_STEPS}))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _DIST_RANK, str(r), str(root)],
                              env=_rank_env(), stdout=open(root / f"rank_{r}.log", "w"),
                              stderr=subprocess.STDOUT) for r in range(2)]

    # (d), and (c)'s single-process reference here, while the ranks start
    port_d = _free_port()
    nccl = [subprocess.Popen([sys.executable, "-c", _NCCL_TWO_ON_ONE, str(r), str(port_d)],
                             env=_rank_env(NCCL_DEBUG="WARN"), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(2)]
    t_ref = time.perf_counter()
    ref = Trainer(_seqpar_cfg(root / "c_ref", data), device="cuda")
    ref.save = lambda: None
    ref.export_checkpoint = lambda *a, **k: None
    record = {"losses": [], "step_s": [], "busy_s": [], "ends": [], "index": []}
    _step_recorder(ref, record)
    ref.train()
    stats["c_reference"] = {"losses": record["losses"], "grad_norms": record["grad_norms"],
                            "busy_s": record["busy_s"], "s": time.perf_counter() - t_ref}
    ref_digest = adam_digest(ref.state)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    # (g)'s single-process reference on the same weights, its launches
    # counted apart from the ranks'
    t_ref = time.perf_counter()
    fa.flash_attention_fwd.launches = 0
    generate(dataclasses.replace(g_cfg, savepath=str(root / "g_ref"), mesh=MeshConfig()),
             modelstyle="nolevel", device="cuda")
    torch.cuda.synchronize()
    stats["g_reference"] = {"s": time.perf_counter() - t_ref,
                            "launches_fwd": fa.flash_attention_fwd.launches}
    gc.collect()
    torch.cuda.empty_cache()
    nccl_out = []
    for p in nccl:
        try:
            text, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            text = p.communicate()[0] + "\n(killed after 120 s)"
        nccl_out.append((p.returncode, text))
    errors = [json.loads(line)["error"] for _, text in nccl_out for line in text.splitlines()
              if line.startswith('{"error"')]
    stats["d_nccl_two_ranks_one_device"] = {"rcs": [rc for rc, _ in nccl_out],
                                            "errors": errors}
    log(f"multi-process training (d) NCCL, two ranks on cuda:0 ({CARD[0]}): exit codes "
        f"{[rc for rc, _ in nccl_out]}, errors {errors}")
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=600))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            rcs.append(None)
    stats["ranks_s"] = time.perf_counter() - t0
    if not errors or any(e is None for e in errors) or any(rc != 0 for rc, _ in nccl_out):
        tails = [text[-1500:] for _, text in nccl_out]
        raise AssertionError(f"(d): NCCL did not refuse two ranks on one device: {tails}")
    if rcs != [0, 0]:
        tails = [(root / f"rank_{r}.log").read_text(errors="replace")[-4000:] for r in (0, 1)]
        raise AssertionError(f"phase 23 ranks exited {rcs}:\n" + "\n".join(tails))
    ranks = [json.loads((root / f"rank_{r}.json").read_text()) for r in (0, 1)]
    a, b, c = ranks[0]["a"], [r["b"] for r in ranks], [r["c"] for r in ranks]

    want = fused_stats["losses"][:DIST_STEPS]
    want_b = want[:GLOO_STEPS]
    want_norms = fused_stats["grad_norms"][:DIST_STEPS]
    stats["a"] = {k: a[k] for k in ("init_s", "barrier_s", "exchange_s", "losses",
                                    "grad_norms", "step_s", "reduce_s", "launches_fwd_dq_dkv",
                                    "flash_shapes", "peak_bytes", "part_s")}
    stats["a"]["losses_equal_phase6"] = a["losses"] == want
    stats["a"]["grad_norms_equal_phase6"] = a["grad_norms"] == want_norms
    log(f"multi-process training (a) one rank over NCCL ({CARD[0]}): {json.dumps(stats['a'])}; "
        f"phase 6 {want}, grad norms {want_norms}")
    shapes_16 = {json.dumps([[16, s_, h, 64], "bfloat16"]) for s_, h in ((1024, 5), (256, 10))}
    if (a["losses"] != want or a["grad_norms"] != want_norms
            or set(a["flash_shapes"]) != shapes_16
            or tuple(a["launches_fwd_dq_dkv"]) != (10 * DIST_STEPS,) * 3):
        raise AssertionError(f"(a): one NCCL rank's losses {a['losses']} and grad norms "
                             f"{a['grad_norms']} against phase 6's {want} and {want_norms}, "
                             f"shapes {a['flash_shapes']}, launches "
                             f"{a['launches_fwd_dq_dkv']}")
    digests = {p_: torch.load(root / f"digest_{p_}.pt") for p_ in ("a", "b", "c")}
    digests_sharded = {p_: torch.load(root / f"digest_{p_}.pt") for p_ in ("e", "f")}
    stats["b"] = {"losses": [r["losses"] for r in b], "step_s": [r["step_s"] for r in b],
                  "part_s": [r["part_s"] for r in b],
                  "reduce_s_gloo_through_host": [r["reduce_s"] for r in b],
                  "init_s": [r["init_s"] for r in b], "barrier_s": [r["barrier_s"] for r in b],
                  "exchange_s": [r["exchange_s"] for r in b],
                  "launches_fwd_dq_dkv": [r["launches_fwd_dq_dkv"] for r in b],
                  "flash_shapes": b[0]["flash_shapes"], "peak_bytes": [r["peak_bytes"] for r in b],
                  "fingerprints": [r["fingerprint"] for r in b],
                  "grad_norms": [r["grad_norms"] for r in b],
                  "max_rel_diff_phase6": rel_gaps(b[0]["losses"], want_b),
                  "grad_norm_max_rel_diff_phase6": rel_gaps(b[0]["grad_norms"],
                                                            want_norms[:GLOO_STEPS]),
                  "adam_mu_gap_to_a": digest_gap(digests["b"], digests["a"])}
    log(f"multi-process training (b) two ranks over gloo, data = 2 ({CARD[0]}): "
        f"{json.dumps(stats['b'])}")
    # 8 rows per rank: phase 3's hook_level0/1 shapes
    shapes_8 = {json.dumps([[8, s_, h, 64], "bfloat16"]) for s_, h in ((1024, 5), (256, 10))}
    gap_b = stats["b"]["adam_mu_gap_to_a"]
    if (b[0]["losses"] != b[1]["losses"] or b[0]["fingerprint"] != b[1]["fingerprint"]
            or stats["b"]["max_rel_diff_phase6"] > DIST_LOSS_RTOL
            or stats["b"]["grad_norm_max_rel_diff_phase6"] > DIST_GRAD_NORM_RTOL
            or gap_b["worst_norm_rel"] > DIST_MOMENT_RTOL
            or gap_b["worst_leaf_rel"] > DIST_MOMENT_RTOL
            or set(b[0]["flash_shapes"]) != shapes_8
            or any(tuple(r["launches_fwd_dq_dkv"]) != (10 * GLOO_STEPS,) * 3 for r in b)):
        raise AssertionError(f"(b): {json.dumps(stats['b'])}; phase 6's losses {want_b}, "
                             f"grad norms {want_norms[:GLOO_STEPS]}")
    ref_losses = stats["c_reference"]["losses"]
    stats["c"] = {"losses": [r["losses"] for r in c], "step_s": [r["step_s"] for r in c],
                  "part_s": [r["part_s"] for r in c],
                  "reduce_s_gloo_through_host": [r["reduce_s"] for r in c],
                  "launches_fwd_dq_dkv": [r["launches_fwd_dq_dkv"] for r in c],
                  "flash_shapes": c[0]["flash_shapes"], "exchanges": c[0]["exchanges"],
                  "peak_bytes": [r["peak_bytes"] for r in c],
                  "fingerprints": [r["fingerprint"] for r in c],
                  "grad_norms": [r["grad_norms"] for r in c],
                  "max_rel_diff_reference": rel_gaps(c[0]["losses"], ref_losses),
                  "grad_norm_max_rel_diff_reference": rel_gaps(
                      c[0]["grad_norms"], stats["c_reference"]["grad_norms"]),
                  "adam_mu_gap_to_reference": digest_gap(digests["c"], ref_digest)}
    log(f"multi-process training (c) two ranks over gloo, seq = 2 at 512 px ({CARD[0]}): "
        f"{json.dumps(stats['c'])}; single-process reference {ref_losses}, grad norms "
        f"{stats['c_reference']['grad_norms']}")
    held = {json.dumps([[b_, sq, h, d], "bfloat16"]) for _, b_, sq, _, h, d, _, _ in SEQPAR_CASES}
    # per rank and step: 3 Ulysses attentions at level 1 and the mid block's
    expected = (GLOO_STEPS * 4,) * 3
    gap_c = stats["c"]["adam_mu_gap_to_reference"]
    if (c[0]["losses"] != c[1]["losses"] or c[0]["fingerprint"] != c[1]["fingerprint"]
            or stats["c"]["max_rel_diff_reference"] > DIST_LOSS_RTOL
            or stats["c"]["grad_norm_max_rel_diff_reference"] > DIST_GRAD_NORM_RTOL
            or gap_c["worst_norm_rel"] > DIST_MOMENT_RTOL
            or gap_c["worst_leaf_rel"] > DIST_MOMENT_RTOL
            or set(c[0]["flash_shapes"]) != held
            or any(tuple(r["launches_fwd_dq_dkv"]) != expected for r in c)
            or not c[0]["exchanges"].get("ppermute") or not c[0]["exchanges"].get("all_to_all")):
        raise AssertionError(f"(c): {json.dumps(stats['c'])}; reference {ref_losses}; "
                             f"expected shapes {held}, launches {expected} per rank")
    # (e) and (f): the sharded meshes, against phase 6 and (a)
    held_shapes = {"e": shapes_8,
                   "f": {json.dumps([[16, 1024, 5, 64], "bfloat16"]),
                         json.dumps([[*TP_CASES[0][1:3], *TP_CASES[0][4:6]], "bfloat16"])}}
    wanted_exchanges = {"e": ("fsdp_gather", "fsdp_regather"),
                        "f": ("tp_all_reduce", "tp_all_gather")}
    for name in ("e", "f"):
        r_ = [r[name] for r in ranks]
        st = {"mesh": r_[0]["mesh"], "losses": [r["losses"] for r in r_],
              "grad_norms": [r["grad_norms"] for r in r_], "step_s": [r["step_s"] for r in r_],
              "part_s": [r["part_s"] for r in r_],
              "reduce_s_gloo_through_host": [r["reduce_s"] for r in r_],
              "launches_fwd_dq_dkv": [r["launches_fwd_dq_dkv"] for r in r_],
              "flash_shapes": r_[0]["flash_shapes"], "exchanges": r_[0]["exchanges"],
              "peak_bytes": [r["peak_bytes"] for r in r_],
              "unet_elements_held_whole": [r["unet_elements"] for r in r_],
              "max_rel_diff_phase6": rel_gaps(r_[0]["losses"], want_b),
              "grad_norm_max_rel_diff_phase6": rel_gaps(r_[0]["grad_norms"],
                                                        want_norms[:GLOO_STEPS]),
              "adam_mu_gap_to_a": digest_gap(digests_sharded[name], digests["a"])}
        stats[name] = st
        log(f"multi-process training ({name}) two ranks over gloo, {st['mesh']} "
            f"({CARD[0]}): {json.dumps(st)}")
        gap = st["adam_mu_gap_to_a"]
        # the share of the UNet's elements a rank holds: FSDP cuts nearly
        # every leaf in 2; tensor parallelism the transformers' projections
        # (~29 % of SD-2.1's UNet) alone
        held = [h / w for h, w in st["unet_elements_held_whole"]]
        share = (0.4, 0.6) if name == "e" else (0.7, 0.95)
        rs = "fsdp_reduce_scatter" if name == "e" else "tp_all_reduce"
        if (r_[0]["losses"] != r_[1]["losses"]
                or st["max_rel_diff_phase6"] > DIST_LOSS_RTOL
                or st["grad_norm_max_rel_diff_phase6"] > DIST_GRAD_NORM_RTOL
                or gap["worst_norm_rel"] > DIST_MOMENT_RTOL
                or gap["worst_leaf_rel"] > DIST_MOMENT_RTOL
                or set(st["flash_shapes"]) != held_shapes[name]
                or any(tuple(r["launches_fwd_dq_dkv"]) != (10 * GLOO_STEPS,) * 3 for r in r_)
                or not all(share[0] < h < share[1] for h in held)
                or not all(st["exchanges"].get(k) for k in wanted_exchanges[name])
                or not any(k.startswith(rs) for k in st["exchanges"])):
            raise AssertionError(f"({name}): {json.dumps(st)}; phase 6's losses {want_b}, "
                                 f"grad norms {want_norms[:GLOO_STEPS]}, shapes "
                                 f"{held_shapes[name]}")
    # (g): generate over tensor = 2 against one process on the same weights
    g = [r["g"] for r in ranks]
    diffs = []
    for i in range(g_cfg.num_batches * g_cfg.im_batch):
        got = read_png(root / "g" / "generations" / f"{i}.png").astype(np.int16)
        want_px = read_png(root / "g_ref" / "generations" / f"{i}.png").astype(np.int16)
        diffs.append(int(np.abs(got - want_px).max()))
    g_shapes = {json.dumps([[4, 4096, 5, 64], "float32"]),
                *(json.dumps([[c_[1], c_[2], c_[4], c_[5]], "float32"]) for c_ in TP_CASES[1:])}
    per_call = 15  # five attentions at each of levels 0-2
    stats["g"] = {"s": [r["s"] for r in g], "part_s": [r["part_s"] for r in g],
                  "launches_fwd": [r["launches_fwd"] for r in g],
                  "flash_shapes": g[0]["flash_shapes"], "exchanges": g[0]["exchanges"],
                  "peak_bytes": [r["peak_bytes"] for r in g], "max_abs_diff_uint8": diffs,
                  "reference": stats["g_reference"]}
    log(f"multi-process sampling (g) generate over gloo, tensor = 2, 512 px, "
        f"{TP_SAMPLE_STEPS} DDIM steps, f32 ({CARD[0]}): {json.dumps(stats['g'])}")
    if (max(diffs) > 1 or set(g[0]["flash_shapes"]) != g_shapes
            or any(r["launches_fwd"] != per_call * TP_SAMPLE_STEPS for r in g)
            or stats["g_reference"]["launches_fwd"] != per_call * TP_SAMPLE_STEPS
            or not g[0]["exchanges"].get("tp_all_reduce")):
        raise AssertionError(f"(g): {json.dumps(stats['g'])}; expected shapes {g_shapes}, "
                             f"{per_call * TP_SAMPLE_STEPS} launches per rank")
    stats["launches"] = {"a": a["launches_fwd_dq_dkv"],
                         **{p_: [sum(x) for x in zip(*(r[p_]["launches_fwd_dq_dkv"]
                                                         for r in ranks))]
                            for p_ in ("b", "c", "e", "f")},
                         "g": sum(r["launches_fwd"] for r in g)}
    log(f"multi-process training (phase 23, {CARD[0]}): {json.dumps(stats, default=str)}")
    return stats


# phase 24: search and eval on a mesh. Two rank processes on cuda:0 over
# gloo (NCCL refuses two ranks on one device: phase 23 (d)) join once and run
# the parts of <root>/plan.json in turn through the command lines' main
# functions, each writing <root>/rank_<r>.json. Phases 10, 13 and 16 leave
# their inputs and one-process answers here
MESH_INPUTS: dict = {}
# (a) asks phase 13's store for its first MESH_QUERIES queries' top 10. Its
# shards are 65,536 rows: a segment of two of them gives each rank whole
# shards (its slab), so each reads half the store; at one shard a segment
# both ranks would read every shard
MESH_QUERIES = 1024
MESH_SEGMENT_ROWS = 2 * 65536
# (c) embeds phase 13's first tar in batches of 256: each rank's slab of 128
# is one of phase 13's batches, image for image
MESH_EMBED_BATCH = 256

_MESH_RANK = r"""
import datetime, json, os, sys, time
from pathlib import Path

import torch
import torch.distributed as tdist

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from dcr_tpu_torch.cli import evaluate as eval_cli
from dcr_tpu_torch.cli import search as search_cli
from dcr_tpu_torch.core import dist, tracing
from dcr_tpu_torch.ops import flash_attention as fa
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.search import annindex as AI
from dcr_tpu_torch.search import shardindex as SI

rank, root = int(sys.argv[1]), Path(sys.argv[2])
plan = json.loads((root / "plan.json").read_text())
written = []


def audit(event, a):
    # every path this rank opens for writing (or makes) under the outputs
    if event == "open" and isinstance(a[0], (str, bytes, os.PathLike)):
        writes = (any(c in a[1] for c in "wax+") if isinstance(a[1], str)
                  else bool(a[2] & (os.O_WRONLY | os.O_RDWR)))
    else:
        writes = event in ("os.mkdir", "os.rename", "os.replace")
    if writes and os.fsdecode(a[0]).startswith(plan["watch"]):
        written.append(os.fsdecode(a[0]))


sys.addaudithook(audit)
timings = {}


def timed(cls, name):
    plain = getattr(cls, name)

    def call(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(self, *a, **k)
        torch.cuda.synchronize()
        timings.setdefault(f"{name}_s", []).append(time.perf_counter() - t0)
        timings.update(rows_held=self.rows_held, resident=self.resident,
                       segment_rows=self.segment_rows,
                       shards_read=getattr(self, "shards_read", None))
        return out
    setattr(cls, name, call)


for cls in (SI.ShardedTopK, AI.AnnEngine):
    timed(cls, "build")
    timed(cls, "query")
t0 = time.perf_counter()
store = tdist.TCPStore("127.0.0.1", plan["port"], 2, is_master=rank == 0,
                       timeout=datetime.timedelta(seconds=600), wait_for_workers=False)
dist.initialize("cuda", backend="gloo", store=store, rank=rank, world_size=2)
torch.zeros(1, device="cuda")
out = {"join_and_cuda_init_s": time.perf_counter() - t0}
for part in plan["parts"]:
    timings.clear()
    pmesh.EXCHANGE_STATS.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.dq_launches = fa.flash_attention_bwd.dkv_launches = 0
    decodes = tracing.registry().counters("search/embed_")
    t0 = time.perf_counter()
    cli = search_cli if part["cli"] == "search" else eval_cli
    result = cli.main(part["argv"])
    torch.cuda.synchronize()
    decodes = {k: v - decodes.get(k, 0)
               for k, v in tracing.registry().counters("search/embed_").items()}
    out[part["name"]] = {
        "s": time.perf_counter() - t0, "peak_bytes": torch.cuda.max_memory_allocated(),
        "exchanges": dict(pmesh.EXCHANGE_STATS), "engine": dict(timings),
        "launches_fwd_dq_dkv": [fa.flash_attention_fwd.launches,
                                fa.flash_attention_bwd.dq_launches,
                                fa.flash_attention_bwd.dkv_launches],
        **({"embed": decodes} if part["argv"][0] == "embed" else {}),
        **({"scalars": result} if isinstance(result, dict) else {})}
out["written"] = written
dist.shutdown()
(root / f"rank_{rank}.json").write_text(json.dumps(out))
"""


def keep_ann_inputs(ann_root: Path, keep: Path) -> None:
    """Phase 16's store, index and generations, hard-linked into ``keep``
    before phase 17 ingests into the store and retrains its index (every
    file there is written anew and renamed into place, never in place, so
    the links keep phase 16's bytes)."""
    import os

    for name in ("store", "gens"):
        shutil.copytree(ann_root / name, keep / name, copy_function=os.link)
    MESH_INPUTS["ann"].update(store=keep / "store", gens=keep / "gens")


def _close(a: float, b: float, atol: float = 2e-4, rtol: float = 1e-3) -> bool:
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= atol + rtol * abs(b)


def phase_mesh_search_eval(root: Path) -> dict:
    """Phase 24: search and eval on a mesh of two rank processes (one card,
    gloo), through dcr-search-torch and dcr-eval-torch, each part against
    the one-process run of phases 10, 13 and 16: (a) `query` at data = 2
    over phase 13's store (1,310,720 x 512 f32, streamed), its first 1,024
    queries at top_k 10, held to phase 13's answer by the tie rule; (b)
    `query --ann=true` (nprobe 8) over phase 16's index, held to its
    one-process answer by the tie rule, recall@10 against its exact answer
    within 1e-3 of the one-process recall; (c) `embed` of phase 13's first
    tar (512 JPEGs and the corrupt member), keys equal and in order,
    features within the f32 bar of phase 13's dump; (d) `dcr-eval-torch`
    over phase 10's folders at the JAX defaults, every scalar within the
    f32 bar of phase 10's, sim_gt_05pc equal, the planted copies top-1.
    Both ranks return the same answer; rank 1 writes no file; 0 flash
    launches. Per rank: seconds, peak memory, the store or index read and
    the query seconds, the candidate exchange's bytes, decode ms."""
    import os

    import numpy as np

    from dcr_tpu_torch.eval.features import EvalImageFolder
    from dcr_tpu_torch.search import embed as E

    se, an, ev = (MESH_INPUTS[k] for k in ("search", "ann", "eval"))
    out = root / "out"
    out.mkdir(parents=True)
    gens, tar0 = root / "gens", root / "tar0"
    gens.mkdir()
    tar0.mkdir()
    E.save_embeddings(gens / "embedding.npz", se["q"][:MESH_QUERIES],
                      [f"gen{i}" for i in range(MESH_QUERIES)])
    os.link(se["tars"] / "00000.tar", tar0 / "00000.tar")
    parts = [
        dict(name="a", cli="search", argv=[
            "query", f"--store_dir={se['store']}", f"--gen_folder={gens}",
            f"--out_path={out / 'a.npz'}", "--top_k=10", f"--segment_rows={MESH_SEGMENT_ROWS}",
            "--mesh.data=2"]),
        dict(name="b", cli="search", argv=[
            "query", "--ann=true", f"--store_dir={an['store']}", f"--gen_folder={an['gens']}",
            f"--out_path={out / 'b.npz'}", f"--top_k={ANN_TOP_K}", "--mesh.data=2"]),
        dict(name="c", cli="search", argv=[
            "embed", f"--gen_folder={tar0}", f"--batch_size={MESH_EMBED_BATCH}",
            f"--embedding_out={out / 'c'}", "--mesh.data=2"]),
        dict(name="d", cli="eval", argv=[
            f"--query_dir={ev['gen']}", f"--values_dir={ev['train']}",
            f"--output_dir={out / 'd'}", f"--values_caption_json={ev['caps']}",
            "--mesh.data=2"]),
    ]
    (root / "plan.json").write_text(json.dumps({"parts": parts, "port": _free_port(),
                                                "watch": str(out)}))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_RANK, str(r), str(root)],
                              env=_rank_env(), stdout=open(root / f"rank_{r}.log", "w"),
                              stderr=subprocess.STDOUT) for r in range(2)]
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=600))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            rcs.append(None)
    ranks_s = time.perf_counter() - t0
    if rcs != [0, 0]:
        tails = [(root / f"rank_{r}.log").read_text(errors="replace")[-4000:] for r in (0, 1)]
        raise AssertionError(f"phase 24 ranks exited {rcs}:\n" + "\n".join(tails))
    ranks = [json.loads((root / f"rank_{r}.json").read_text()) for r in (0, 1)]

    def per_rank(part: str) -> dict:
        recs = [r[part] for r in ranks]
        topk = [r["exchanges"].get("topk_exchange", {}) for r in recs]
        return {"s": [r["s"] for r in recs], "peak_bytes": [r["peak_bytes"] for r in recs],
                "engine": [r["engine"] for r in recs],
                "topk_exchange_bytes": [t.get("bytes", 0) for t in topk],
                "topk_exchange_calls": [t.get("calls", 0) for t in topk],
                "exchanges": [r["exchanges"] for r in recs]}

    stats: dict = {"card": CARD[0], "ranks_s": ranks_s,
                   "join_and_cuda_init_s": [r["join_and_cuda_init_s"] for r in ranks]}
    checks: dict = {}
    # (a) the exact engine, streamed, against phase 13's one-process answer
    with np.load(out / "a.npz") as z:
        sa, ka = z["scores"], z["keys"].astype(object)
    s10, k10 = se["s10"][:MESH_QUERIES], se["k10"][:MESH_QUERIES]
    checks["a_vs_one_process"] = tie_rule("mesh exact query vs one process", sa, ka, s10, k10,
                                          s10, gap=4e-5)
    stats["a"] = {**per_rank("a"), "one_process_engine_build_s": se["engine_build_s"],
                  "one_process_query_call_s": se["query_call_s"]}
    eng_a = stats["a"]["engine"]
    # (b) the ANN engine against phase 16's `query --ann=true`
    with np.load(out / "b.npz") as z:
        sb, kb = z["scores"], z["keys"].astype(object)
    checks["b_vs_one_process"] = tie_rule("mesh ann query vs one process", sb, kb, an["cli_s"],
                                          an["cli_k"], an["cli_s"], bound=an["bound"],
                                          gap=2 * an["bound"])

    def recall(keys) -> float:
        return sum(len(set(a[:ANN_TOP_K]) & set(e[:ANN_TOP_K]))
                   for a, e in zip(keys, an["ex_k"])) / (len(keys) * ANN_TOP_K)

    stats["b"] = {**per_rank("b"), "recall_at_10": recall(kb),
                  "one_process_recall_at_10": recall(an["cli_k"]),
                  "one_process_engine_build_s": an["engine_build_s"],
                  "one_process_query_call_s": an["query_call_s"]}
    # (c) the embed dump against phase 13's, tar 0's rows
    fc, kc = E.load_embeddings(out / "c.npz")
    # each rank decodes half of each batch of the tar's members (its JPEGs and
    # the corrupt one), the last batch's odd member padded with a copy
    members = sum(1 for _ in E.iter_webdataset_members([tar0 / "00000.tar"]))
    mesh_decodes = sum(-(-min(MESH_EMBED_BATCH, members - b_) // 2)
                       for b_ in range(0, members, MESH_EMBED_BATCH))
    f1, k1 = E.load_embeddings(se["dump"])
    first = [i for i, k in enumerate(k1) if k.startswith("00000/")]
    checks["c_keys_equal_in_order"] = kc == [k1[i] for i in first]
    checks["c_max_abs_diff"] = float(np.abs(fc - f1[first]).max()) if len(fc) == len(
        first) else None
    checks["c_within_f32_bar"] = len(fc) == len(first) and bool(
        np.allclose(fc, f1[first], atol=2e-4, rtol=1e-3))
    decoded = [r["c"]["embed"]["search/embed_decoded_total"] for r in ranks]
    stats["c"] = {**per_rank("c"), "decoded": decoded,
                  "decode_ms_per_image": [r["c"]["embed"]["search/embed_decode_us_total"]
                                          / 1e3 / n_ for r, n_ in zip(ranks, decoded)],
                  "one_process_embed_s": se["embed_s"]}
    # (d) eval against phase 10's run
    scal = [r["d"]["scalars"] for r in ranks]
    want = ev["scalars"]
    checks["d_same_on_both_ranks"] = scal[0] == scal[1] or all(
        _close(scal[0][k], scal[1][k], 0.0, 0.0) for k in scal[0])
    checks["d_off_bar"] = {k: [scal[0].get(k), v] for k, v in want.items()
                           if not (k in scal[0] and _close(scal[0][k], v))}
    checks["d_sim_gt_05pc_equal"] = scal[0]["sim_gt_05pc"] == want["sim_gt_05pc"]
    sim = np.load(out / "d" / "similarity.npy")
    qpaths = [p_.name for p_ in EvalImageFolder(ev["gen"], 224).paths]
    found = [int(sim[qpaths.index(r_["gen"])].argmax()) == r_["source"]
             and float(sim[qpaths.index(r_["gen"])].max()) >= 0.999 for r_ in ev["copies"]]
    checks["d_copies_found"] = f"{sum(found)}/{len(found)}"
    artifacts = [out / "d" / n for n in ("similarity.npy", "logs/metrics.jsonl",
                                         "fid_stats_values.npz", "provenance.json")]
    checks["d_artifacts_absent"] = [str(a_) for a_ in artifacts if not a_.exists()]
    stats["d"] = {**per_rank("d"), "scalars": scal[0], "one_process_total_s": ev["total_s"]}
    checks["rank1_wrote"] = ranks[1]["written"]
    checks["rank0_wrote"] = len(ranks[0]["written"])
    launches = [r[p_]["launches_fwd_dq_dkv"] for r in ranks for p_ in "abcd"]
    stats["checks"] = checks
    log(f"mesh search and eval (phase 24, {CARD[0]}): {json.dumps(stats, default=str)}")
    for part, what in (("a", "exact query"), ("b", "ann query"), ("c", "embed"),
                       ("d", "eval")):
        st = stats[part]
        log(f"mesh {what} ({part}, {CARD[0]}): s per rank {st['s']}, peak GiB per rank "
            f"{[round(b_ / 2**30, 2) for b_ in st['peak_bytes']]}, candidate exchange bytes "
            f"{st['topk_exchange_bytes']}, engine {st['engine']}")
    problems = []
    if any(l_ != [0, 0, 0] for l_ in launches):
        problems.append(f"flash launches {launches}")
    if (any(e["resident"] for e in eng_a) or sum(e["rows_held"] for e in eng_a)
            != SEARCH_STORE_ROWS or stats["a"]["topk_exchange_calls"] != [2, 2]):
        problems.append(f"(a) engine {eng_a}, exchanges {stats['a']['topk_exchange_calls']}")
    if (abs(stats["b"]["recall_at_10"] - stats["b"]["one_process_recall_at_10"]) > 1e-3
            or stats["b"]["recall_at_10"] < ANN_MIN_RECALL
            or stats["b"]["topk_exchange_calls"] != [3, 3]):
        problems.append(f"(b) recall@10 {stats['b']['recall_at_10']} against one process's "
                        f"{stats['b']['one_process_recall_at_10']}, exchanges "
                        f"{stats['b']['topk_exchange_calls']}")
    if (not checks["c_keys_equal_in_order"] or not checks["c_within_f32_bar"]
            or decoded != [mesh_decodes] * 2):
        problems.append(f"(c) keys equal {checks['c_keys_equal_in_order']}, max |diff| "
                        f"{checks['c_max_abs_diff']}, decoded {decoded}")
    if (not checks["d_same_on_both_ranks"] or checks["d_off_bar"]
            or not checks["d_sim_gt_05pc_equal"] or not all(found)
            or checks["d_artifacts_absent"]):
        problems.append(f"(d) same on both ranks {checks['d_same_on_both_ranks']}, off the "
                        f"bar {checks['d_off_bar']}, copies {checks['d_copies_found']}, "
                        f"absent {checks['d_artifacts_absent']}")
    if checks["rank1_wrote"] or not checks["rank0_wrote"]:
        problems.append(f"rank 1 wrote {checks['rank1_wrote'][:5]}, rank 0 "
                        f"{checks['rank0_wrote']} files")
    if problems:
        raise AssertionError("phase 24: " + "; ".join(problems))
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


# wall seconds of each phase of this run, in order
PHASE_S: dict[str, float] = {}


def run_phase(name: str, fn, *args, **kwargs):
    """Run one phase and print its wall seconds."""
    start = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_S[name] = time.perf_counter() - start
        log(f"phase {name}: {PHASE_S[name]:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    import dcr_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    wall0 = time.perf_counter()
    run_phase("1 card", phase_card)
    # the build is nvcc's host work; phases 9 and 12 and phase 16's corpus,
    # which launch no flash kernel, load no JPEG library and hold results
    # or make inputs, not times, run meanwhile
    from concurrent.futures import ThreadPoolExecutor

    # phase 16's store is served again by phase 17
    ann_tmp = tempfile.TemporaryDirectory()
    ann_root = Path(ann_tmp.name) / "ann"
    ann_root.mkdir()
    # phases 10, 13 and 16 leave phase 24 their inputs here
    keep_tmp = tempfile.TemporaryDirectory()
    keep = Path(keep_tmp.name)
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(run_phase, "2 build", phase_build)
        with tempfile.TemporaryDirectory() as tmp:
            small_eval = run_phase("9 small eval reference", phase_small_eval_reference,
                                   Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            small_search = run_phase("12 small search reference",
                                     phase_small_search_reference, Path(tmp))
        ann_corpus = run_phase("16a ann corpus", phase_ann_corpus, ann_root)
        built = building.result()
    ann_stats = run_phase("16 ann", phase_ann, ann_root, ann_corpus)
    del ann_corpus
    keep_ann_inputs(ann_root, keep / "ann")
    torch.cuda.empty_cache()
    codec = run_phase("2b jpeg codec", phase_jpeg_codec)
    kern = run_phase("3 kernels B1", phase_kernels, reps=10)
    bwd = run_phase("3 kernels B2 B3", phase_bwd_kernels, reps=10)
    # the exit drills' four children (phase 20), phase 17's IVF retrain
    # (a subprocess) and phase 25's subprocesses run beside the reference phases
    # and phase 17's drills,
    # which hold results, not times; only this thread launches kernels in
    # this process
    with ThreadPoolExecutor(3) as pool, tempfile.TemporaryDirectory() as drill_tmp, \
            tempfile.TemporaryDirectory() as warm_tmp:
        drilling = pool.submit(run_phase, "20 exit drills", phase_exit_drills, Path(drill_tmp))
        retraining = pool.submit(run_phase, "17a live ivf retrain", phase_live_retrain,
                                 ann_root / "store")
        # phase 25's sampler and trainer subprocesses hold results, not times
        warming = pool.submit(run_phase, "25 warm cache", phase_warm_cache, Path(warm_tmp))
        limits = run_phase("8 kernel limits", phase_kernel_limits)
        run_phase("4 small reference", phase_small_reference)
        small_train = run_phase("4 small train reference", phase_small_train_reference)
        with tempfile.TemporaryDirectory() as tmp:
            small_dino = run_phase("9b small dino eval reference", phase_small_dino_reference,
                                   Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            live_drills = run_phase("17b live drills", phase_live_drills, ann_root, Path(tmp))
        drill_stats = drilling.result()
        live_retrain = retraining.result()
        warm_stats = warming.result()
    with tempfile.TemporaryDirectory() as tmp:
        main_stats, main = run_phase("5 sampling main path", phase_main_path, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        interop_stats = run_phase("5b checkpoint interop", phase_checkpoint_interop,
                                  Path(tmp), main)
        torch.cuda.empty_cache()
        mitigation_stats = run_phase("5d mitigation", phase_mitigation, Path(tmp) / "sd21",
                                     Path(tmp))
        torch.cuda.empty_cache()
        serve_stats = run_phase("14 serving", phase_serve, Path(tmp) / "sd21", Path(tmp))
        torch.cuda.empty_cache()
        fleet_stats = run_phase("22 serving fleet", phase_fleet, Path(tmp) / "sd21", Path(tmp),
                                serve_stats)
        # phase 17 serves 5b's checkpoint over phase 16's store
        live_root = Path(tmp) / "live"
        live_root.mkdir()
        live_stats = run_phase("17 live provenance", phase_live_serving, Path(tmp) / "sd21",
                               ann_root / "store", live_root, serve_stats, live_retrain)
        live_stats.update(live_drills)
    ann_tmp.cleanup()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        fast_stats = run_phase("5c fast sampling", phase_fast_sampling, Path(tmp), main,
                               main_stats)
    del main
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_stats = run_phase("6 training main path", phase_train_main_path, Path(tmp),
                                steps=6)
        torch.cuda.empty_cache()
        (Path(tmp) / "dist").mkdir()
        dist_stats = run_phase("23 multi-process training", phase_multi_process_training,
                               Path(tmp) / "dist", Path(tmp) / "data", train_stats)
    torch.cuda.empty_cache()
    f32_train_stats = run_phase("7 f32 training", phase_train_f32_step, steps=2)
    torch.cuda.empty_cache()
    adam8_stats = run_phase("19 8-bit adam", phase_train_8bit, train_stats)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        fault_stats = run_phase("15 training faults", phase_train_faults, Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        pipe_stats = run_phase("18 pipelined training", phase_pipelined_training, Path(tmp),
                               train_stats)
    torch.cuda.empty_cache()
    eval_stats = run_phase("10 eval main path", phase_eval_main_path, keep / "eval")
    if eval_stats["launches_fwd_dq_dkv"] != (0, 0, 0):
        raise AssertionError(f"the eval path launched flash kernels: "
                             f"{eval_stats['launches_fwd_dq_dkv']}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        backbone_stats = run_phase("11 backbones", phase_backbones, Path(tmp))
    torch.cuda.empty_cache()
    search_stats = run_phase("13 search main path", phase_search_main_path, keep / "search")
    torch.cuda.empty_cache()
    mesh_stats = run_phase("24 mesh search and eval", phase_mesh_search_eval, keep / "mesh")
    keep_tmp.cleanup()
    MESH_INPUTS.clear()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        profile_stats = run_phase("21 profile drill", phase_profile_drill, Path(tmp))

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
    train_pipe = dict(zip(("fwd", "dq", "dkv"), pipe_stats["live"]["launches_fwd_dq_dkv"]))
    train_cache = dict(zip(("fwd", "dq", "dkv"),
                           pipe_stats["cache_fed"]["launches_fwd_dq_dkv"]))
    train_8bit = dict(zip(("fwd", "dq", "dkv"), adam8_stats["launches_fwd_dq_dkv"]))
    # phase 23: (a) one NCCL rank at the train shapes, (b) two ranks at the
    # hook_level shapes (8 rows each), (c) two seq ranks at SEQPAR_CASES,
    # (e) two fsdp ranks at the hook_level shapes, (f) two tensor ranks at
    # train_level0 and tp_level1; (g) two tensor ranks' f32 sampling
    dist_train = {part: dict(zip(("fwd", "dq", "dkv"), dist_stats["launches"][part]))
                  for part in ("a", "b", "c", "e", "f")}
    f32_train = dict(zip(("fwd", "dq", "dkv"), f32_train_stats["launches_fwd_dq_dkv"]))
    sample_cases = ("level0", "level1", "level2", "hook_level0", "hook_level1",
                    *(c[0] for c in MITIGATE_CASES), *SERVE_CASES,
                    *(c[0] for c in TP_CASES[1:]))
    train_cases = ("train_level0", "train_level1")
    # bf16 training also runs phase 23's shapes: 8 rows per rank in (b) (the
    # hook_level rows' shapes), (c)'s per-rank shapes
    bf16_train_cases = (*train_cases, "hook_level0", "hook_level1",
                        *(c[0] for c in SEQPAR_CASES), TP_CASES[0][0])
    entries = [
        kernel_entry("fwd", "float32", kern["rows"], sample_cases,
                     {"sample": main_stats["launches"],
                      "sample_genuine": interop_stats["launches"],
                      "sample_fast": fast_stats["launches"],
                      "mitigate": mitigation_stats["launches"],
                      "serve": serve_stats["launches"],
                      "live_serve": live_stats["launches"],
                      "serve_profiled": profile_stats["launches"],
                      "train_hook": train_stats["hook_launches_fwd_dq_dkv"][0],
                      "train_f32": f32_train["fwd"],
                      "sample_dist_g": dist_stats["launches"]["g"]},
                     tensor_cores("flash_fwd_tf32x3_kernel")),
        kernel_entry("fwd", "bfloat16", kern["rows"], bf16_train_cases,
                     {"train": train["fwd"], "train_faults": train_faults["fwd"],
                      "train_pipe": train_pipe["fwd"], "train_cache": train_cache["fwd"],
                      "train_8bit": train_8bit["fwd"],
                      **{f"train_dist_{p_}": d["fwd"] for p_, d in dist_train.items()}},
                     tensor_cores("flash_fwd_bf16_kernel")),
    ]
    for kind in ("dq", "dkv"):
        entries += [
            kernel_entry(kind, "float32", bwd["rows"], train_cases,
                         {"train_f32": f32_train[kind]},
                         tensor_cores(f"flash_bwd_{kind}_tf32x3_kernel")),
            kernel_entry(kind, "bfloat16", bwd["rows"], bf16_train_cases,
                         {"train": train[kind], "train_faults": train_faults[kind],
                          "train_pipe": train_pipe[kind], "train_cache": train_cache[kind],
                          "train_8bit": train_8bit[kind],
                          **{f"train_dist_{p_}": d[kind] for p_, d in dist_train.items()}},
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
    log(f"serving fleet stats: {json.dumps(fleet_stats, default=str)}")
    log(f"small search reference: {json.dumps(small_search)}")
    log(f"search path stats: {json.dumps(search_stats)}")
    log(f"ann path stats: {json.dumps(ann_stats, default=str)}")
    log(f"live serving stats: {json.dumps(live_stats, default=str)}")
    log(f"pipelined training stats: {json.dumps(pipe_stats, default=str)}")
    log(f"8-bit adam stats: {json.dumps(adam8_stats)}")
    log(f"exit drill stats: {json.dumps(drill_stats, default=str)}")
    log(f"profile drill stats: {json.dumps(profile_stats, default=str)}")
    log(f"multi-process training stats: {json.dumps(dist_stats, default=str)}")
    log(f"mesh search and eval stats: {json.dumps(mesh_stats, default=str)}")
    log(f"warm cache stats: {json.dumps(warm_stats, default=str)}")
    log(f"phase seconds ({CARD[0]}): {json.dumps(PHASE_S)}; script "
        f"{time.perf_counter() - wall0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
