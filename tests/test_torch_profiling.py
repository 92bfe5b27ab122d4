"""PyTorch port: profiling and MFU telemetry (``dcr_tpu_torch/utils/
profiling.py``) on the CPU.

- ``train_step_flops`` of a tiny UNet step, counted on meta tensors, equals
  its analytic count from the shapes of every convolution, linear and
  attention the same step runs on the CPU: 2 x out x fan-in per forward,
  the backward's grad-weight and (where the input needs it) grad-input
  products, attention 4 Sq Sk D per (batch, head) forward and 8 backward
  (library attention, as FlopCounterMode counts its matmuls). The flash
  kernels' convention (4, 6 and 8 Sq Sk D) is held on a kernel-shaped
  attention.
- ``POST /debug/profile`` arms ``torch.profiler`` for one device step of
  the CPU server, ``GET`` reports the armed state and then the Chrome trace
  written; a second arm while armed is a 409.
- ``DCR_PROFILE_AT_STEP`` captures a tiny Trainer's step into
  ``<output_dir>/profile``; ``StepTimer``; no card, no peak.
"""

from __future__ import annotations

import json
import threading
import time

import pytest
import torch

from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.diffusion import train as T
from dcr_tpu_torch.diffusion.trainer import Trainer
from dcr_tpu_torch.ops import attention as A
from dcr_tpu_torch.sampling.pipeline import build_models
from dcr_tpu_torch.serve import server as TS
from dcr_tpu_torch.serve import worker as TW
from dcr_tpu_torch.utils import profiling as P
from tests.test_torch_serve import _http, _serve_cfg, tiny  # noqa: F401
from tests.test_torch_trainer import _cfg, _data


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_train_cfg() -> TC.TrainConfig:
    cfg = TC.TrainConfig(mixed_precision="no", train_batch_size=2, seed=0)
    cfg.model = TC.ModelConfig.tiny()
    cfg.data = TC.DataConfig(resolution=16)
    return cfg


def _analytic_step_flops(cfg: TC.TrainConfig) -> int:
    """The step's FLOPs from the shapes of what it runs: one real step on the
    CPU with every convolution, linear and attention call recorded."""
    models = build_models(cfg.model, "cpu", seed=0)
    calls: list[tuple[str, int, bool]] = []     # (component, forward flops, input grad)
    hooks = []
    for component, module in (("unet", models.unet), ("vae", models.vae),
                              ("text", models.text_encoder)):
        for mod in module.modules():
            if isinstance(mod, torch.nn.Conv2d):
                def conv(m, inp, out, c=component):
                    kh, kw = m.kernel_size
                    calls.append((c, 2 * out.numel() * m.in_channels // m.groups * kh * kw,
                                  inp[0].requires_grad))
                hooks.append(mod.register_forward_hook(conv))
            elif isinstance(mod, torch.nn.Linear):
                def linear(m, inp, out, c=component):
                    calls.append((c, 2 * out.numel() * m.in_features, inp[0].requires_grad))
                hooks.append(mod.register_forward_hook(linear))
    sdpa = A._sdpa_attention

    def attention(q, k, v, mask):
        b, sq, h, d = q.shape
        calls.append(("attention", 4 * b * h * sq * k.shape[1] * d, q.requires_grad))
        return sdpa(q, k, v, mask)

    A._sdpa_attention = attention
    try:
        params = {n: dict(m.named_parameters()) for n, m in
                  (("unet", models.unet), ("text", models.text_encoder), ("vae", models.vae))}
        state = T.init_train_state(cfg, models, unet_params=params["unet"],
                                   text_params=params["text"], vae_params=params["vae"])
        res, bsz = cfg.data.resolution, cfg.train_batch_size
        batch = {"pixel_values": torch.zeros(bsz, res, res, 3).numpy(),
                 "input_ids": torch.zeros(bsz, cfg.model.text_max_length, dtype=torch.long)}
        T.make_train_step(cfg, models)(state, batch)
    finally:
        A._sdpa_attention = sdpa
        for h in hooks:
            h.remove()
    total = 0
    for component, fwd, input_grad in calls:
        total += fwd
        if component == "unet":                # grad-weight, and grad-input where needed
            total += fwd + (fwd if input_grad else 0)
        elif component == "attention" and input_grad:
            total += 2 * fwd                   # dP, dV, dQ, dK: four products
    return total


def test_train_step_flops_equal_the_analytic_count():
    cfg = _tiny_train_cfg()
    counted = P.train_step_flops(cfg)
    assert counted == _analytic_step_flops(cfg)
    assert P.train_step_flops(cfg) == counted          # cached, not counted again
    hot = P.train_step_flops(cfg, hot_only=True)
    assert 0 < hot < counted                           # without the frozen encoders


def test_flash_flops_follow_the_kernel_table():
    b, s, h, d = 2, 128, 3, 64
    meta = torch.device("meta")
    q, k, v = (torch.empty(b, s, h, d, device=meta, requires_grad=True) for _ in range(3))

    def fwd_bwd():
        out = A.dot_product_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), grad_outputs=torch.empty_like(out))

    assert P.count_flops(fwd_bwd) == (4 + 6 + 8) * b * h * s * s * d
    assert P.flash_flops(b, s, s, h, d, backward=False) == 4 * b * h * s * s * d


def test_step_timer_peak_and_trace(tmp_path):
    assert P.chip_peak_tflops() is None               # no card here
    with P.trace(tmp_path / "t"):
        torch.ones(8).add_(1)
    (path,) = (tmp_path / "t").glob("trace_*.json")
    assert json.loads(path.read_text())["traceEvents"]
    timer = P.StepTimer(flops_per_step=2e12, peak_tflops=4.0)
    time.sleep(0.01)
    timer.tick(items=8)
    report = timer.report()
    assert report["items_per_sec"] > 0 and report["mfu"] == pytest.approx(
        report["tflops_per_sec"] / 4.0)
    assert "mfu" not in P.StepTimer(flops_per_step=1.0).report()


def test_debug_profile_arms_and_writes_a_trace(tiny, tmp_path):  # noqa: F811
    svc = TW.GenerationService(_serve_cfg(), tiny.tstack)
    svc.start()
    httpd = TS.make_server(_serve_cfg(port=0), svc)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert json.loads(_http(port, "/debug/profile")[2])["armed"] is False
        code, _, raw = _http(port, "/debug/profile", {"steps": 1,
                                                      "logdir": str(tmp_path / "prof")})
        armed = json.loads(raw)
        assert code == 200 and armed["armed"] and armed["remaining"] == 1
        code, _, raw = _http(port, "/debug/profile", {"steps": 1,
                                                      "logdir": str(tmp_path / "prof")})
        assert code == 409 and "already armed" in json.loads(raw)["error"]
        assert _http(port, "/generate", {"prompt": "a red square"})[0] == 200
        status = json.loads(_http(port, "/debug/profile")[2])
        deadline = time.monotonic() + 60
        while status["armed"] and time.monotonic() < deadline:
            time.sleep(0.05)
            status = json.loads(_http(port, "/debug/profile")[2])
        assert status["error"] is None and status["artifact"]
        doc = json.loads(open(status["artifact"]).read())
        assert doc["traceEvents"]
        assert status["artifact"].startswith(str(tmp_path / "prof"))
    finally:
        svc.begin_drain()
        svc.join_drained(timeout=60)
        httpd.shutdown()
        httpd.server_close()


def test_trainer_profiles_at_the_asked_step(tmp_path, monkeypatch):
    monkeypatch.setenv("DCR_PROFILE_AT_STEP", "1")
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, out="run")
    cfg.max_train_steps = 2
    Trainer(cfg, device="cpu").train()
    tracing.reset_for_tests()
    traces = list((tmp_path / "run" / "profile").glob("trace_*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    assert P.status()["armed"] is False
