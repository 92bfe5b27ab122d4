"""Where a sampler call's time goes on the card, at SD-2.1 widths.

    python -m dcr_tpu_torch.utils.profile_step [--resolution=512] [--batch=2]

Builds the full-width models (ModelConfig(), seeded random weights) on the
GPU in f32 with TF32 off, as chip_smoke.py's main path does, then
1. times each stage of one sampler call with CUDA events: text encoding,
   one CFG UNet call (2*batch rows), one DPM-Solver++ update, VAE decode;
2. splits one UNet call by layer family (convolutions, linears, the flash
   kernel, library attention, norms; the rest is elementwise work) with CUDA
   events around each layer;
3. traces three UNet calls with torch.profiler for the device's busy share
   of the window and the most launched kernels.
Prints a table and one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from dcr_tpu_torch.core.config import ModelConfig
from dcr_tpu_torch.models import schedulers as S
from dcr_tpu_torch.sampling.pipeline import build_models


def family_times(models, run, calls: int = 3) -> dict[str, float]:
    """Device ms per call by layer family, from CUDA events recorded around
    every convolution, linear, norm and attention call. The work runs in
    order on one stream, so the brackets partition it; what lies outside
    them (adds, activations, concatenations, copies) is the remainder."""
    import dcr_tpu_torch.models.layers as L
    from dcr_tpu_torch.ops import flash_attention as fa

    pairs: list[tuple[str, object, object]] = []
    pending: dict[int, object] = {}

    def pre(mod, _inp):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pending[id(mod)] = ev

    def post_for(fam):
        def post(mod, _inp, _out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pairs.append((fam, pending.pop(id(mod)), ev))
        return post

    kinds = ((torch.nn.Conv2d, "convolution"), (torch.nn.Linear, "linear (matmul)"),
             (torch.nn.GroupNorm, "normalisation"), (torch.nn.LayerNorm, "normalisation"))
    handles = []
    for m in (models.unet, models.text_encoder, models.vae):
        for mod in m.modules():
            for cls, fam in kinds:
                if isinstance(mod, cls):
                    handles += [mod.register_forward_pre_hook(pre),
                                mod.register_forward_hook(post_for(fam))]
                    break
    attention = L.dot_product_attention

    def timed_attention(q, k, v, **kw):
        fam = ("flash_fwd (B1)" if kw.get("use_flash", True) and kw.get("mask") is None
               and fa.supported(q, k, v) else "library attention (SDPA)")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = attention(q, k, v, **kw)
        b.record()
        pairs.append((fam, a, b))
        return out

    L.dot_product_attention = timed_attention
    try:
        total = event_ms(lambda: [run() for _ in range(calls)], reps=1) / calls
        pairs.clear()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    finally:
        L.dot_product_attention = attention
        for h in handles:
            h.remove()
    out: dict[str, float] = {}
    for fam, a, b in pairs:
        out[fam] = out.get(fam, 0.0) + a.elapsed_time(b) / calls
    out["elementwise / other"] = total - sum(out.values())
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


@torch.no_grad()
def main(argv: list[str]) -> int:
    args = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    resolution = int(args.get("resolution", 512))
    batch = int(args.get("batch", 2))
    if not torch.cuda.is_available():
        print("profile_step needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ModelConfig(sample_size=resolution // 8)
    models = build_models(cfg, dev, seed=0)
    latent = resolution // 8
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.text_vocab_size - 1, (batch, 77)), device=dev)
    x = torch.randn((batch, 4, latent, latent), device=dev)
    ctx = torch.cat([models.text_encoder(ids).last_hidden_state] * 2)
    tb = torch.full((2 * batch,), 500, dtype=torch.long, device=dev)
    sched = models.schedule
    state = S.dpm_init_state(tuple(x.shape), device=dev)
    pred = models.unet(torch.cat([x, x]), tb, ctx)[:batch]

    stages = {
        "text_encode_ms": event_ms(lambda: (models.text_encoder(ids),
                                            models.text_encoder(ids))),
        "unet_cfg_call_ms": event_ms(lambda: models.unet(torch.cat([x, x]), tb, ctx)),
        "dpm_update_ms": event_ms(lambda: S.dpmpp_2m_step(sched, pred, x, 500, 450, state)),
        "vae_decode_ms": event_ms(lambda: models.vae.decode(x / 0.18215), reps=3),
    }

    by_family = family_times(models, lambda: models.unet(torch.cat([x, x]), tb, ctx))

    # device busy share of three back-to-back UNet calls, from the profiler's
    # kernel records (union of their intervals: records can overlap)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            models.unet(torch.cat([x, x]), tb, ctx)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted({(ev.time_range.start, ev.time_range.end, ev.name)
                      for ev in prof.events()
                      if getattr(ev, "device_type", None) == DeviceType.CUDA})
    busy_us, cursor, launches = 0.0, float("-inf"), {}
    for start, end, name in kernels:
        busy_us += max(0.0, end - max(start, cursor))
        cursor = max(cursor, end)
        launches[name] = launches.get(name, 0) + 1
    busy_ms = busy_us / 1e3 / 3

    card = torch.cuda.get_device_name(0)
    doc = {
        "device": card, "resolution": resolution, "cfg_batch": 2 * batch,
        "stages": stages,
        "unet_call_ms_by_family": by_family,
        "unet_call_device_busy_ms": busy_ms if kernels else None,
        "unet_call_wall_ms": window_ms / 3,
        "device_busy_share": busy_ms * 3 / window_ms if kernels else None,
        "most_launched_kernels": [dict(launches_per_call=n // 3, name=name[:120])
                                  for name, n in sorted(launches.items(),
                                                        key=lambda kv: -kv[1])[:10]],
    }
    print(f"{card}: {resolution} px, CFG batch {2 * batch}, f32, TF32 off")
    for k, v in stages.items():
        print(f"  {k:18s} {v:9.3f}")
    busy = f"{busy_ms:.3f} ms" if kernels else "not measured (no kernel records)"
    print(f"  UNet call: wall {window_ms / 3:.3f} ms, device busy {busy}")
    for fam, ms in by_family.items():
        print(f"    {fam:26s} {ms:9.3f} ms  {100 * ms / sum(by_family.values()):5.1f} %")
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
