"""The measurement slice as a whole: the port's ``run_eval`` against the JAX
package's on one folder.

The folder is written at the eval transform's resize size (37 px shorter
side for ``image_size=32``), so neither package resamples and both see the
same pixels. Both runs get the same SSCD weights (a Flax init; the port's
through ``models/export.sscd_from_flax``) and a duplication-weights pickle;
FID, precision/recall, CLIP score and complexity are off (the JAX backbones
of those stages are held one by one in ``test_torch_eval_backbones.py``).
Bounds: the same scalar names; values within 1e-4; ``similarity.npy``
within 1e-5; top-1 indices exact (the test checks the top-1/top-2 margins
are far above that float noise); gallery pages of the same shape within one
uint8 level (the thumbnails' resize is the port's bilinear against PIL's).
Then the port alone with every ported stage on, the settings the port
refuses, and the command line on the CPU.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from dcr_tpu.core.config import EvalConfig as JaxEvalConfig  # noqa: E402
from dcr_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer  # noqa: E402
from dcr_tpu.eval.runner import run_eval as jax_run_eval  # noqa: E402
from dcr_tpu.models.resnet import SSCDModel as JaxSSCD  # noqa: E402
from dcr_tpu_torch.cli import evaluate as eval_cli  # noqa: E402
from dcr_tpu_torch.core import config as TC  # noqa: E402
from dcr_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from dcr_tpu_torch.eval.runner import run_eval  # noqa: E402
from dcr_tpu_torch.models import export as EX  # noqa: E402
from dcr_tpu_torch.sampling.png import write_png  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tiny models run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SCALARS = ("sim_mean", "sim_std", "sim_75pc", "sim_90pc", "sim_95pc", "sim_gt_05pc",
           "bg_mean", "bg_std", "FID_val", "precision", "recall", "gen_clipscore",
           "train_clipscore")


def _write_folder(root, n_gen=8, per_class=5):
    """``n_gen`` generations (37x37) with prompts.txt beside them,
    ``per_class`` training images (37x40 / 40x37) in each of two class
    folders, a caption json and a pickle of sampling weights (3 duplicated
    images)."""
    rng = np.random.default_rng(0)
    gen = root / "gens" / "generations"
    gen.mkdir(parents=True)
    for i in range(n_gen):
        write_png(gen / f"{i}.png", rng.integers(0, 256, (37, 37, 3), dtype=np.uint8))
    (root / "gens" / "prompts.txt").write_text("".join(f"prompt {i}\n" for i in range(4)))
    caps = {}
    for c in ("c0", "c1"):
        (root / "train" / c).mkdir(parents=True)
        for i in range(per_class):
            p = root / "train" / c / f"{i}.png"
            shape = (37, 40, 3) if i % 2 else (40, 37, 3)
            write_png(p, rng.integers(0, 256, shape, dtype=np.uint8))
            caps[str(p)] = [f"{c} image {i}"]
    (root / "caps.json").write_text(json.dumps(caps))
    (root / "weights.pickle").write_bytes(pickle.dumps([5] * 3 + [1] * (2 * per_class - 3)))
    return gen, root / "train"


def _he_scaled_sscd_params():
    """Flax SSCD init at key 0, kernels scaled by sqrt(2) (He), so the random
    trunk keeps its activations' scale through the ReLUs and the embeddings
    tell images apart."""
    params = JaxSSCD().init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * (np.sqrt(2.0) if path[-1].key == "kernel" else 1.0),
        params)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_parity")
    gen, train = _write_folder(tmp)
    params = _he_scaled_sscd_params()
    common = dict(query_dir=str(gen), values_dir=str(train), pt_style="sscd",
                  batch_size=8, image_size=32, compute_fid=False,
                  compute_clip_score=False, compute_complexity=False, galleries=True,
                  gallery_topk=3, gallery_rows=4, gallery_max_rank=8,
                  dup_weights_pickle=str(tmp / "weights.pickle"))
    ref = jax_run_eval(JaxEvalConfig(output_dir=str(tmp / "jax"), **common),
                       backbone_params=params, tokenizer=JaxHashTokenizer(1000, 77))
    ours = run_eval(TC.EvalConfig(output_dir=str(tmp / "port"), **common), device="cpu",
                    backbone_state_dict=EX.sscd_from_flax(params),
                    tokenizer=HashTokenizer(1000, 77))
    return tmp, ref, ours


def test_scalars_match_jax(both_runs):
    _, ref, ours = both_runs
    assert list(ours) == list(ref)
    for name in ref:
        assert abs(ours[name] - ref[name]) <= 1e-4, (name, ours[name], ref[name])
    assert "sim_gt_05pc" in ours and "dupsim_mean" in ours and "nondupsim_mean" in ours


def test_similarity_and_top1_match_jax(both_runs):
    tmp, _, _ = both_runs
    ref = np.load(tmp / "jax" / "similarity.npy")
    ours = np.load(tmp / "port" / "similarity.npy")
    assert ours.shape == ref.shape == (8, 10)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    top2 = np.sort(ref, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4   # argmax is not decided by noise
    np.testing.assert_array_equal(ours.argmax(axis=1), ref.argmax(axis=1))


def test_artifacts_and_galleries_match_jax(both_runs):
    tmp, _, _ = both_runs
    port, jax_dir = tmp / "port", tmp / "jax"
    for name in ("provenance.json", "logs/metrics.jsonl", "similarity.npy"):
        assert (port / name).exists(), name
    logged = json.loads((port / "logs" / "metrics.jsonl").read_text().splitlines()[-1])
    assert logged["step"] == 0 and "sim_gt_05pc" in logged
    pages = sorted(p.name for p in (port / "galleries").glob("gallery_rank*.png"))
    assert pages == sorted(p.name for p in (jax_dir / "galleries").glob("gallery_rank*.png"))
    assert pages == ["gallery_rank0_3.png", "gallery_rank4_7.png"]
    from dcr_tpu_torch.sampling.png import read_png

    for name in pages:
        ours = read_png(port / "galleries" / name).astype(int)
        with Image.open(jax_dir / "galleries" / name) as im:
            ref = np.asarray(im.convert("RGB")).astype(int)
        assert ours.shape == ref.shape
        assert np.abs(ours - ref).max() <= 1


def test_port_alone_with_every_ported_stage(tmp_path):
    gen, train = _write_folder(tmp_path, n_gen=4, per_class=3)
    cfg = TC.EvalConfig(query_dir=str(gen), values_dir=str(train), batch_size=4,
                        image_size=32, compute_complexity=False, gallery_topk=3,
                        gallery_max_rank=8, output_dir=str(tmp_path / "out"))
    scalars = run_eval(cfg, device="cpu", tokenizer=HashTokenizer(1000, 77),
                       values_caption_json=str(tmp_path / "caps.json"))
    for name in SCALARS:
        assert name in scalars and np.isfinite(scalars[name]), name
    assert 0.0 <= scalars["precision"] <= 1.0 and 0.0 <= scalars["recall"] <= 1.0
    assert -1.0 <= scalars["gen_clipscore"] <= 1.0
    out = tmp_path / "out"
    assert (out / "fid_stats_values.npz").exists()
    assert list((out / "galleries").glob("gallery_rank*.png"))
    assert np.load(out / "similarity.npy").shape == (4, 6)


@pytest.mark.parametrize("override,what", [
    ({"fault.barrier_timeout_s": 5.0}, "fault.barrier_timeout_s"),
    ({"fault.hang_timeout_s": 5.0}, "fault.hang_timeout_s"),
    ({"fault.decode_retries": 2}, "fault.decode_retries"),
    ({"fault.max_bad_sample_frac": 0.1}, "fault.max_bad_sample_frac"),
    ({"mesh.data": 2}, "mesh of 2"),
    ({"warm.dir": "w"}, "warm.dir"),
    ({"use_wandb": True}, "use_wandb"),
    ({"fault.stage_deadline_secs": 5.0}, "fault.stage_deadline_secs"),
    ({"fault.max_rollbacks": 1}, "fault.max_rollbacks"),
])
def test_settings_not_ported_are_refused(tmp_path, override, what):
    args = [f"--{k}={v}" for k, v in override.items()]
    cfg = TC.parse_cli(TC.EvalConfig, args)
    with pytest.raises(TC.NotPortedError, match=what):
        TC.validate_eval_config(cfg)
    with pytest.raises(TC.NotPortedError, match=what):
        run_eval(cfg, device="cpu")


def test_io_retry_settings_are_honoured_not_refused():
    cfg = TC.parse_cli(TC.EvalConfig, ["--compute_complexity=false", "--fault.io_retries=5",
                                       "--fault.retry_base_delay=0.1"])
    TC.validate_eval_config(cfg)
    assert cfg.fault.io_retries == 5


def test_eval_config_matches_jax_fields_and_defaults():
    import dataclasses

    ours, ref = TC.EvalConfig(), JaxEvalConfig()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        if f.name not in ("mesh", "fault", "warm"):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert TC.to_dict(ours.fault) == dataclasses.asdict(ref.fault)
    cfg = TC.parse_cli(TC.EvalConfig, ["--compute_fid=false", "--gallery_topk=3",
                                       "--mesh.data=1"])
    assert cfg.compute_fid is False and cfg.gallery_topk == 3 and cfg.compute_clip_score


def test_cli_runs_on_cpu_when_asked(tmp_path, monkeypatch):
    gen, train = _write_folder(tmp_path, n_gen=4, per_class=2)
    argv = [f"--query_dir={gen}", f"--values_dir={train}", "--image_size=32",
            "--batch_size=4", "--compute_complexity=false", "--compute_fid=false",
            "--gallery_max_rank=4", "--gallery_topk=2", f"--output_dir={tmp_path / 'out'}",
            f"--values_caption_json={tmp_path / 'caps.json'}"]
    monkeypatch.delenv("DCR_TPU_PLATFORM", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            eval_cli.main(argv)
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    scalars = eval_cli.main(argv)
    assert np.isfinite(scalars["sim_gt_05pc"]) and np.isfinite(scalars["train_clipscore"])
    rows = (tmp_path / "out" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(rows[-1])["train_clipscore"] == pytest.approx(scalars["train_clipscore"])


def test_reads_retry_transient_errors_only():
    from dcr_tpu_torch.eval.runner import read_with_retry

    fault = TC.FaultToleranceConfig(io_retries=3, retry_base_delay=0.0)
    calls = []

    def failing(n_failures, error=OSError):
        def read():
            calls.append(1)
            if len(calls) <= n_failures:
                raise error("read failed")
            return b"ok"
        return read

    assert read_with_retry(failing(2), fault, "flaky") == b"ok" and len(calls) == 3
    calls.clear()
    with pytest.raises(OSError):
        read_with_retry(failing(3), fault, "always")
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(FileNotFoundError):
        read_with_retry(failing(1, FileNotFoundError), fault, "missing")
    assert len(calls) == 1
