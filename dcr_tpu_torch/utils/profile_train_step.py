"""Where a train step's time goes on the card, at the JAX defaults.

    python -m dcr_tpu_torch.utils.profile_train_step [--batch=16] [--resolution=256]

Builds the models of ``TrainConfig()`` (SD-2.1 widths, bf16 compute on f32
masters, AdamW; seeded random weights) on the GPU with TF32 off, as
chip_smoke.py's training main path does, and feeds the train step a fixed
random batch (no data loader), then
1. splits the step into its phases with CUDA events on the stream: VAE
   encode, text encode, UNet forward, backward, optimizer (clip, AdamW, EMA)
   and the rest (draws, q-sample, the bf16 weight cast, the global norm);
2. times every launch of the three flash-attention kernels with CUDA events
   (their share of the step);
3. traces three steps with torch.profiler for the device's busy share of the
   wall time (the union of the kernel records' intervals).
Prints a table and one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import functools
import json
import statistics
import sys
import time

import numpy as np
import torch

from dcr_tpu_torch.core.config import TrainConfig
from dcr_tpu_torch.diffusion import train as T
from dcr_tpu_torch.ops import flash_attention as fa
from dcr_tpu_torch.sampling.pipeline import build_models


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class PhaseClock:
    """CUDA events at the step's phase boundaries, through hooks and
    wrappers; restores everything it patched on :meth:`close`."""

    def __init__(self, models):
        self.marks: list[tuple[str, torch.cuda.Event]] = []
        self.kernel_pairs: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._undo = []
        self._wrap(models.vae, "encode", "vae_encode")
        self._wrap(torch.autograd, "grad", "backward")
        self._wrap(T.Optimizer, "update", "optimizer")
        for mod, name in ((models.text_encoder, "text_encode"), (models.unet, "unet_forward")):
            h1 = mod.register_forward_pre_hook(lambda m, i, n=name: self.mark(f"{n}:start"))
            h2 = mod.register_forward_hook(lambda m, i, o, n=name: self.mark(f"{n}:end"))
            self._undo += [h1.remove, h2.remove]
        for fn_name, kind in (("flash_attention_fwd", "B1 fwd"),
                              ("flash_attention_bwd_dq", "B2 dQ"),
                              ("flash_attention_bwd_dkv", "B3 dK/dV")):
            self._wrap_kernel(fn_name, kind)

    def mark(self, name: str) -> None:
        self.marks.append((name, _event()))

    def _wrap(self, owner, attr: str, name: str) -> None:
        orig = getattr(owner, attr)

        def wrapped(*a, **kw):
            self.mark(f"{name}:start")
            out = orig(*a, **kw)
            self.mark(f"{name}:end")
            return out

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def _wrap_kernel(self, fn_name: str, kind: str) -> None:
        orig = getattr(fa, fn_name)

        # wraps copies the launch counter, which the wrapped function bumps
        # through its module-level name
        @functools.wraps(orig)
        def wrapped(*a, **kw):
            start = _event()
            out = orig(*a, **kw)
            self.kernel_pairs.append((kind, start, _event()))
            return out

        setattr(fa, fn_name, wrapped)
        self._undo.append(lambda: setattr(fa, fn_name, orig))

    def close(self) -> None:
        for undo in self._undo:
            undo()

    def phases(self) -> dict[str, float]:
        """ms per phase between the first and the last mark (one step);
        "other" is the step's remainder."""
        torch.cuda.synchronize()
        start = {}
        out: dict[str, float] = {}
        for name, ev in self.marks[1:-1]:
            phase, edge = name.split(":")
            if edge == "start":
                start[phase] = ev
            else:
                out[phase] = out.get(phase, 0.0) + start.pop(phase).elapsed_time(ev)
        total = self.marks[0][1].elapsed_time(self.marks[-1][1])
        out["other (draws, casts, norm)"] = total - sum(out.values())
        out["step"] = total
        return out

    def kernels(self) -> dict[str, dict]:
        torch.cuda.synchronize()
        out: dict[str, dict] = {}
        for kind, a, b in self.kernel_pairs:
            row = out.setdefault(kind, {"launches": 0, "ms": 0.0})
            row["launches"] += 1
            row["ms"] += a.elapsed_time(b)
        return out


def main(argv: list[str]) -> int:
    args = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    if not torch.cuda.is_available():
        print("profile_train_step needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TrainConfig()
    cfg.train_batch_size = int(args.get("batch", cfg.train_batch_size))
    cfg.data.resolution = int(args.get("resolution", cfg.data.resolution))
    models = build_models(cfg.model, "cuda", seed=0)
    params = {n: dict(m.named_parameters()) for n, m in
              (("unet", models.unet), ("text", models.text_encoder), ("vae", models.vae))}
    state = T.init_train_state(cfg, models, unet_params=params["unet"],
                               text_params=params["text"], vae_params=params["vae"])
    step = T.make_train_step(cfg, models)
    rng = np.random.default_rng(0)
    px, bsz = cfg.data.resolution, cfg.train_batch_size
    batch = {"pixel_values": rng.uniform(-1, 1, (bsz, px, px, 3)).astype(np.float32),
             "input_ids": rng.integers(0, cfg.model.text_vocab_size - 1,
                                       (bsz, cfg.model.text_max_length))}
    for _ in range(2):                      # warm-up: allocator, cuDNN, kernel builds
        state, m = step(state, batch)
    torch.cuda.synchronize()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    clock = PhaseClock(models)
    try:
        clock.mark("step:start")
        state, m = step(state, batch)
        clock.mark("step:end")
        phases = clock.phases()
        kernels = clock.kernels()
    finally:
        clock.close()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    spans = sorted({(ev.time_range.start, ev.time_range.end) for ev in prof.events()
                    if getattr(ev, "device_type", None) == DeviceType.CUDA})
    busy_us, cursor = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, cursor))
        cursor = max(cursor, end)

    card = torch.cuda.get_device_name(0)
    step_ms = phases["step"]
    kernel_ms = sum(r["ms"] for r in kernels.values())
    doc = {
        "device": card, "resolution": px, "batch": bsz,
        "mixed_precision": cfg.mixed_precision,
        "step_wall_s": walls, "median_step_wall_s": statistics.median(walls),
        "images_per_s": bsz / statistics.median(walls),
        "phases_ms": phases, "flash_kernels": kernels,
        "flash_kernels_share_of_step": kernel_ms / step_ms,
        "device_busy_share": (busy_us / 1e3) / window_ms if spans else None,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "loss": float(m["loss"]),
    }
    print(f"{card}: train step at {px} px, batch {bsz}, {cfg.mixed_precision}, TF32 off; "
          f"wall {statistics.median(walls):.4f} s (median of 3)")
    for name, ms in phases.items():
        print(f"  {name:28s} {ms:10.3f} ms  {100 * ms / step_ms:5.1f} %")
    for kind, row in kernels.items():
        print(f"  {kind:10s} {row['launches']:3d} launches {row['ms']:9.3f} ms")
    busy = (f"{100 * doc['device_busy_share']:.1f} %" if spans
            else "not measured (no kernel records)")
    print(f"  device busy {busy} of 3 traced steps")
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
