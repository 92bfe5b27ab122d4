"""PyTorch port: training's fault tolerance on tiny CPU runs.

- The loader's bad-sample quarantine gives the JAX loader's batches (their
  ``index`` arrays) and its ``bad_sample`` records on the same folder, seed
  and ``DCR_FAULTS`` spec; over budget and at the default budget 0 both
  fail alike.
- ``fault.decode_retries`` retries a failed decode from a fresh rng: the
  retried example is the first-try example, and the JAX dataset's.
- Checkpoints: a zero-filled latest step is quarantined and resume falls
  back past it; an explicit restore of a damaged step raises and leaves the
  live state untouched; all steps damaged raise FileNotFoundError, never a
  silent restart.
- NaN rollback: the rolled-back run equals, bit for bit, a run that resumes
  from the same checkpoint with its step set to the failing step; without
  rollbacks it fails fast.
- Preemption: an in-process ``sigterm`` stops with a checkpoint, and the
  resume (past that checkpoint, torn by ``ckpt_corrupt``) equals the
  straight run bit for bit.
- ``dcr-train-torch`` exits 83 on SIGTERM with a checkpoint, and 89 when a
  step hangs past ``fault.hang_timeout_s``, with the thread dump on stderr.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from dcr_tpu.core import resilience as JR
from dcr_tpu.core.config import DataConfig as JDataConfig
from dcr_tpu.core.config import FaultToleranceConfig as JFaultConfig
from dcr_tpu.data import dataset as JDS
from dcr_tpu.data import loader as JL
from dcr_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from dcr_tpu.utils import faults as jfaults
from dcr_tpu_torch.core import checkpoint as CK
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.data import dataset as DS
from dcr_tpu_torch.data import loader as L
from dcr_tpu_torch.data.tokenizer import HashTokenizer
from dcr_tpu_torch.diffusion import train as T
from dcr_tpu_torch.diffusion.trainer import Trainer
from dcr_tpu_torch.utils import faults
from tests.test_torch_trainer import _cfg, _data

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tiny models run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DCR_FAULTS", raising=False)
    monkeypatch.delenv("DCR_HANG_TIMEOUT_S", raising=False)
    faults.clear()
    jfaults.clear()
    R.reset_counters()
    yield
    faults.clear()
    jfaults.clear()


# ---------------------------------------------------------------------------
# data: the loader's quarantine and the dataset's retries, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture()
def folder(tmp_path):
    rng = np.random.default_rng(0)
    for cls in ("c0", "c1"):
        d = tmp_path / "data" / cls
        d.mkdir(parents=True)
        for i in range(6):
            Image.fromarray(rng.integers(0, 255, (40, 52, 3), np.uint8)).save(
                d / f"{cls}_{i}.png")
    return tmp_path / "data"


PORT = (DS.ObjectAttributeDataset, L, TC.DataConfig, TC.FaultToleranceConfig,
        HashTokenizer, R.QuarantineManifest, faults)
JAX = (JDS.ObjectAttributeDataset, JL, JDataConfig, JFaultConfig, JHashTokenizer,
       JR.QuarantineManifest, jfaults)
RECORD_KEYS = ("epoch", "step", "slot", "index", "path", "replacement_slot",
               "replacement_index")


def _epoch(pkg, root, qpath, spec, **fault_kw):
    """(index array per batch, bad_sample records) of epoch 0, or the
    name of the exception that ended it."""
    Dataset, loader_mod, DataConfig, FaultConfig, Tok, Quarantine, fmod = pkg
    cfg = DataConfig(train_data_dir=str(root), resolution=32, class_prompt="nolevel",
                     num_workers=2, seed=7)
    ft = FaultConfig(retry_base_delay=0.0, retry_max_delay=0.0, **fault_kw)
    q = Quarantine(qpath)
    fmod.install(spec)
    loader = loader_mod.DataLoader(Dataset(cfg, Tok(100, 16), fault=ft), batch_size=2,
                                   num_workers=2, seed=1, fault=ft, quarantine=q)
    try:
        batches = [b.index.tolist() for b in loader.epoch(0)]
    except Exception as e:
        return type(e).__name__, None
    finally:
        fmod.clear()
    records = sorted(({k: e[k] for k in RECORD_KEYS} for e in q.entries()
                      if e["kind"] == "bad_sample"), key=lambda e: (e["step"], e["slot"]))
    assert loader.bad_samples == len(records)
    return batches, records


@pytest.mark.parametrize("case,spec,fault_kw", [
    ("corrupt file and injected fault, under budget", "decode_error@step=1",
     dict(max_bad_sample_frac=0.5)),
    ("over budget", "", dict(max_bad_sample_frac=0.05)),
    ("default budget, injected fault", "decode_error@step=0", {}),
    ("default budget, corrupt file", "", {}),
])
def test_loader_quarantine_equals_jax(tmp_path, folder, case, spec, fault_kw):
    corrupt = sorted(folder.rglob("*.png"))[4]
    corrupt.write_bytes(b"garbage, not an image")
    port = _epoch(PORT, folder, tmp_path / "port.jsonl", spec, **fault_kw)
    jax_ = _epoch(JAX, folder, tmp_path / "jax.jsonl", spec, **fault_kw)
    assert port == jax_
    if case.endswith("under budget"):
        batches, records = port
        assert len(batches) == 6 and len(records) == 2
        assert str(corrupt) in [r["path"] for r in records]
        assert 4 not in sum(batches, [])            # the bad sample never reaches a batch
    else:
        assert port[0] == {"over budget": "TooManyBadSamples",
                           "default budget, injected fault": "InjectedFault",
                           "default budget, corrupt file": "SampleDecodeError"}[case]


def test_decode_retry_returns_the_first_try_example(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    for i in range(4):
        (tmp_path / "data" / "c0").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), np.uint8)).save(
            tmp_path / "data" / "c0" / f"{i}.png")
    kw = dict(train_data_dir=str(tmp_path / "data"), resolution=16, center_crop=False,
              random_flip=True, class_prompt="classlevel", seed=3)
    port = DS.ObjectAttributeDataset(TC.DataConfig(**kw), HashTokenizer(100, 16))
    assert port.fault.decode_retries == 1                       # the default
    first = [port.get(p, epoch=1, slot=5 + p) for p in range(4)]
    decode, calls = DS.decode_image, []

    def flaky(path, size=0):
        calls.append(path)
        if len(calls) % 2:
            raise OSError("transient read error")
        return decode(path, size)

    monkeypatch.setattr(DS, "decode_image", flaky)
    retried = [port.get(p, epoch=1, slot=5 + p) for p in range(4)]
    assert len(calls) == 8
    jax_ = JDS.ObjectAttributeDataset(JDataConfig(**kw), JHashTokenizer(100, 16))
    for a, b, j in zip(first, retried, (jax_.get(p, epoch=1, slot=5 + p) for p in range(4))):
        assert np.array_equal(a.pixel_values, b.pixel_values)
        assert np.array_equal(a.pixel_values, j.pixel_values)
        assert np.array_equal(a.input_ids, b.input_ids) and a.index == b.index == j.index
    # two failures in a row exhaust the default: the loader's typed error
    monkeypatch.setattr(DS, "decode_image", lambda path, size=0: (_ for _ in ()).throw(
        OSError("gone bad")))
    with pytest.raises(DS.SampleDecodeError, match="failed to decode"):
        port.get(0)


# ---------------------------------------------------------------------------
# checkpoints: manifests, fallback, quarantine
# ---------------------------------------------------------------------------

def _state(seed: int) -> T.TrainState:
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g)
    unet = {"conv.weight": r(4, 3), "conv.bias": r(4)}
    opt = T.OptState(count=seed, mu={f"unet/{k}": r(*v.shape) for k, v in unet.items()},
                     nu={f"unet/{k}": r(*v.shape) for k, v in unet.items()})
    return T.TrainState(step=seed, unet_params=unet, text_params={"emb": r(5, 2)},
                        vae_params={"dec": r(3).to(torch.bfloat16)}, opt_state=opt,
                        ema_params={k: r(*v.shape) for k, v in unet.items()})


def _flat(state: T.TrainState) -> dict:
    return CK._leaves(CK._state_dict(state))


def _assert_state_equal(a: T.TrainState, b: T.TrainState) -> None:
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert (torch.equal(fa[k], fb[k]) if isinstance(fa[k], torch.Tensor)
                else fa[k] == fb[k]), k


def test_resume_falls_back_past_a_torn_latest_step(tmp_path):
    q = R.QuarantineManifest(tmp_path / "quarantine.jsonl")
    mgr = CK.CheckpointManager(tmp_path / "ckpt", quarantine=q)
    for step in (2, 4):
        assert mgr.save(step, _state(step))
    assert mgr.save(4, _state(4)) is False                   # one save per step
    assert sorted(p.name for p in (tmp_path / "ckpt" / "manifests").iterdir()) == [
        "2.json", "4.json"]
    manifest = json.loads((tmp_path / "ckpt" / "manifests" / "4.json").read_text())
    assert manifest["step"] == 4 and manifest["format"] == 1
    assert manifest["leaves"]["params/vae/dec"]["dtype"] == "torch.bfloat16"
    CK.corrupt_step_dir(tmp_path / "ckpt" / "4")
    live = _state(0)
    step, skipped = mgr.restore_latest_valid(live)
    assert step == 2 and [s for s, _ in skipped] == [4] and "does not load" in skipped[0][1]
    _assert_state_equal(live, _state(2))
    assert (tmp_path / "ckpt" / "quarantined" / "4" / CK.STATE_FILE).exists()
    assert not (tmp_path / "ckpt" / "manifests" / "4.json").exists()
    assert mgr.all_steps() == [2]                            # never offered again
    (rec,) = q.entries()
    assert rec["kind"] == "bad_checkpoint" and rec["step"] == 4
    assert rec["moved_to"] == str(tmp_path / "ckpt" / "quarantined" / "4")


def test_explicit_restore_of_a_damaged_step_raises_and_leaves_state_untouched(tmp_path):
    mgr = CK.CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, _state(1))
    mpath = tmp_path / "ckpt" / "manifests" / "1.json"
    manifest = json.loads(mpath.read_text())
    manifest["leaves"]["ema/conv.bias"]["crc32"] ^= 0xFFFF   # the last group copied
    mpath.write_text(json.dumps(manifest))
    live, before = _state(7), _state(7)
    with pytest.raises(CK.CheckpointCorrupt, match="ema/conv.bias: checksum mismatch"):
        mgr.restore(live, 1)
    _assert_state_equal(live, before)
    CK.corrupt_step_dir(tmp_path / "ckpt" / "1")
    with pytest.raises(CK.CheckpointCorrupt, match="does not load"):
        mgr.restore(live, 1)
    _assert_state_equal(live, before)
    assert mgr.all_steps() == [1]                            # explicit restores move nothing
    # without manifests the same step restores what it holds
    mgr = CK.CheckpointManager(tmp_path / "plain", verify=False)
    mgr.save(3, _state(3))
    assert not (tmp_path / "plain" / "manifests").exists()
    assert mgr.restore(live) == 3
    _assert_state_equal(live, _state(3))


def test_all_steps_corrupt_raises_never_a_silent_restart(tmp_path):
    faults.install("ckpt_corrupt@step=1x2")
    mgr = CK.CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, _state(1))                                   # torn by the injected fault
    with pytest.raises(FileNotFoundError, match="all 1 steps quarantined"):
        mgr.restore_latest_valid(_state(0))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore_latest_valid(_state(0))
    mgr.save(1, _state(1))                                   # torn again
    with pytest.raises(FileNotFoundError, match="quarantined"):
        mgr.restore_latest_valid(_state(0))
    assert sorted(p.name for p in (tmp_path / "ckpt" / "quarantined").iterdir()) == ["1", "1.1"]


# ---------------------------------------------------------------------------
# the Trainer: NaN rollback, preemption and resume
# ---------------------------------------------------------------------------

def _rows(run: Path) -> list[dict]:
    return [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]


def _assert_same_training(a: T.TrainState, b: T.TrainState) -> None:
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for name in ("unet_params", "ema_params"):
        for k, p in (getattr(a, name) or {}).items():
            assert torch.equal(p, getattr(b, name)[k]), (name, k)
    for k, m in a.opt_state.nu.items():
        assert torch.equal(m, b.opt_state.nu[k]), k


def test_nan_rollback_equals_a_resume_past_the_bad_window(tmp_path):
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, out="roll")
    cfg.modelsavesteps, cfg.ema_decay = 2, 0.99
    cfg.fault = TC.FaultToleranceConfig(max_rollbacks=1, max_bad_sample_frac=0.5)
    # a bad sample in the first step and a NaN at step 3 (one epoch = 3 steps)
    faults.install("decode_error@step=0&slot=1,nan_loss@step=3")
    rolled = Trainer(cfg, device="cpu")
    metrics = rolled.train()
    run = tmp_path / "roll"
    records = [json.loads(x) for x in (run / "quarantine.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in records] == ["bad_sample", "nan_rollback"]
    assert records[0]["step"] == 0 and records[0]["replacement_slot"] == 2
    roll = records[1]
    assert (roll["at_step"], roll["restored_step"], roll["skipped_steps"],
            roll["rollback"], roll["max_rollbacks"]) == (3, 2, 1, 1, 1)
    rows = _rows(run)
    assert [r["step"] for r in rows] == [1, 2, 4, 5]         # the NaN row is not logged
    assert all(np.isfinite(r["loss"]) for r in rows) and metrics["loss"] == rows[-1]["loss"]
    assert [(r["faults/bad_samples"], r["faults/rollbacks"]) for r in rows] == [
        (1, 0), (1, 0), (1, 1), (1, 1)]
    # the reference: the same checkpoint with its step set to the failing step
    ref_cfg = _cfg(tmp_path, out="ref")
    ref_cfg.modelsavesteps, ref_cfg.ema_decay = 2, 0.99
    saved = torch.load(run / "checkpoints" / "2" / CK.STATE_FILE, weights_only=True)
    saved["step"] = 3
    (tmp_path / "ref" / "checkpoints" / "3").mkdir(parents=True)
    torch.save(saved, tmp_path / "ref" / "checkpoints" / "3" / CK.STATE_FILE)
    ref = Trainer(ref_cfg, device="cpu")
    ref.train()
    _assert_same_training(rolled.state, ref.state)
    assert [r["loss"] for r in _rows(tmp_path / "ref")] == [r["loss"] for r in rows[2:]]
    # without rollbacks the same NaN fails fast, naming the recovery point
    fast = _cfg(tmp_path, out="fast")
    fast.modelsavesteps, fast.max_train_steps = 2, 3
    faults.install("nan_loss@step=3")
    with pytest.raises(FloatingPointError, match=r"non-finite loss nan at step 3.*step 2\)"):
        Trainer(fast, device="cpu").train()


def test_sigterm_stops_with_a_checkpoint_and_the_resume_equals_the_straight_run(tmp_path):
    _data(tmp_path / "data")
    straight_cfg = _cfg(tmp_path, out="straight")
    straight_cfg.max_train_steps = 4
    straight = Trainer(straight_cfg, device="cpu")
    straight.train()

    cfg = _cfg(tmp_path, out="stopped")
    cfg.max_train_steps, cfg.modelsavesteps = 4, 1
    # the preemption's own checkpoint at step 2 is then torn after it commits
    faults.install("sigterm@step=2,ckpt_corrupt@step=2")
    before = signal.getsignal(signal.SIGTERM)
    stopped = Trainer(cfg, device="cpu")
    stopped.install_preemption_handler()
    stopped.train()
    assert stopped.preempted_exit and stopped.state.step == 2
    assert signal.getsignal(signal.SIGTERM) is before        # handlers put back
    run = tmp_path / "stopped"
    assert stopped.ckpt.all_steps() == [1, 2]
    assert not (run / "checkpoint").exists()                 # no export on preemption

    resumed = Trainer(cfg, device="cpu")
    resumed.train()
    _assert_same_training(resumed.state, straight.state)
    assert (run / "checkpoints" / "quarantined" / "2").exists()
    (rec,) = [json.loads(x) for x in (run / "quarantine.jsonl").read_text().splitlines()]
    assert rec["kind"] == "bad_checkpoint" and rec["step"] == 2
    rows = _rows(run)
    assert [r["step"] for r in rows] == [1, 2, 2, 3, 4]
    assert [r["faults/ckpt_fallbacks"] for r in rows] == [0, 0, 1, 1, 1]
    want = {r["step"]: r["loss"] for r in _rows(tmp_path / "straight")}
    assert [r["loss"] for r in rows] == [want[r["step"]] for r in rows]


# ---------------------------------------------------------------------------
# dcr-train-torch: exit 83 and exit 89
# ---------------------------------------------------------------------------

def _cli(tmp_path, cfg, dcr_faults: str, *extra: str, timeout: int = 240):
    TC.save_config(cfg, tmp_path / "cfg.json")
    env = {k: v for k, v in os.environ.items() if k not in ("DCR_FAULTS", "DCR_HANG_TIMEOUT_S")}
    env.update(DCR_TPU_PLATFORM="cpu", DCR_FAULTS=dcr_faults, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "dcr_tpu_torch.cli.train", f"--config={tmp_path / 'cfg.json'}",
         *extra], env=env, cwd=tmp_path, capture_output=True, text=True, timeout=timeout)


def test_cli_exits_83_with_a_checkpoint_on_sigterm(tmp_path):
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, out="cli")
    cfg.max_train_steps = 4
    proc = _cli(tmp_path, cfg, "sigterm@step=2")
    out = proc.stdout + proc.stderr
    assert proc.returncode == 83, out[-3000:]
    assert "fault injection ACTIVE" in out and "preemption: checkpointing at step 2" in out
    assert (tmp_path / "cli" / "checkpoints" / "2" / CK.STATE_FILE).exists()
    assert (tmp_path / "cli" / "checkpoints" / "manifests" / "2.json").exists()
    assert [r["step"] for r in _rows(tmp_path / "cli")] == [1, 2]
    # the exit-83 path's flight-recorder dump, beside the run's trace
    dump = json.loads((tmp_path / "cli" / "flightrec_0.json").read_text())
    assert dump["reason"] == "preempted: checkpointed at step 2" and "memory" in dump
    assert (tmp_path / "cli" / "trace.jsonl").exists()


def test_cli_exits_89_with_a_thread_dump_when_a_step_hangs(tmp_path):
    _data(tmp_path / "data")
    cfg = _cfg(tmp_path, out="hang")
    proc = _cli(tmp_path, cfg, "hang@step=1", "--fault.hang_timeout_s=2")
    assert proc.returncode == 89, (proc.stdout + proc.stderr)[-3000:]
    assert "hang watchdog armed: 2.0s" in proc.stderr
    assert "[fault] injected_hang" in proc.stderr and "[fault] hang_abort" in proc.stderr
    # faulthandler's dump: the wedged main thread sits in simulate_hang
    assert "Thread 0x" in proc.stderr and "simulate_hang" in proc.stderr
    # the flight recorder, dumped before the exit: the last spans
    dump = json.loads((tmp_path / "hang" / "flightrec_0.json").read_text())
    assert dump["reason"].startswith("hang_abort:train") and "memory" in dump
    assert "train/step" in [r["name"] for r in dump["records"]]
    assert "last trace records:" in proc.stderr
    shutil.rmtree(tmp_path / "hang", ignore_errors=True)
