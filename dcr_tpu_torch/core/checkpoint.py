"""Checkpoints: the port's resume format, and the HF layout in and out.

- :class:`CheckpointManager` keeps the full train state (params, optimizer,
  EMA, step) under ``<output_dir>/checkpoints/<step>/state.pt``, one
  ``torch.save`` file per step, written under a temporary name and renamed,
  keeping the newest ``max_to_keep``, with a content manifest per step
  (``manifests/<step>.json``: crc32, shape and dtype of every leaf, the JAX
  package's schema). A restore loads and verifies the whole step before it
  copies anything into the live state; resume walks back past damaged steps
  to the newest valid one and moves each damaged step to
  ``quarantined/<step>``. On several processes (a coordinator given) the
  step restored is agreed: the newest step every process can see, valid on
  every process. It is the port's own format; the JAX package's orbax/npz
  checkpoints are not read. A state sharded on a mesh (its ``layout``,
  ``parallel/sharded.py``) is saved whole: every rank takes part in the
  gathers (:meth:`CheckpointManager.save`) and the primary writes, so
  the file is the one a single process writes, and a restore cuts each
  rank's shards from it; a checkpoint moves between meshes.
- :func:`export_hf_layout` writes the directory-of-subfolders export of
  ``dcr_tpu/core/checkpoint.py``: per component ``params.npz`` (the Flax
  tree flattened to ``a/b/c`` keys) and the torch-layout weights under the
  exact diffusers/transformers names (``diffusion_pytorch_model.safetensors``
  for unet and vae, ``model.safetensors`` for text_encoder) with a
  diffusers/transformers ``config.json``; ``scheduler/scheduler_config.json``
  and ``model_index.json`` carrying the native ``model_config``. diffusers,
  transformers and the JAX package load it.
- :func:`import_torch_layout` reads one component back as the port's state
  dict: the torch-layout weights (safetensors or ``.bin``, fp16 variants
  too) when present, else ``params.npz``; for a genuine
  diffusers/transformers checkpoint :func:`model_config_from_diffusers`
  infers the ModelConfig fields from its ``config.json`` files.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from dcr_tpu_torch.core import fsio
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core.resilience import QuarantineManifest
from dcr_tpu_torch.core.safetensors import load_file, save_file
from dcr_tpu_torch.models import convert as CV
from dcr_tpu_torch.models import export as EX

log = logging.getLogger("dcr_tpu_torch")

STATE_FILE = "state.pt"


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    """``a/b/c`` keys -> nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return tree


def flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> ``a/b/c`` keys (the inverse of :func:`unflatten`)."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


# ---------------------------------------------------------------------------
# resume checkpoints
# ---------------------------------------------------------------------------

MANIFEST_FORMAT = 1


class CheckpointCorrupt(RuntimeError):
    """A checkpoint step does not load, or fails its content manifest."""


# the checkpoint groups of a TrainState whose names are a component's
_GROUP_COMPONENT = {"unet params": "unet", "text params": "text", "vae params": "vae",
                    "EMA params": "unet"}


def _placement(state, what: str, key: str):
    """The placement of ``key`` of group ``what`` of a sharded state."""
    return state.layout.placement(_GROUP_COMPONENT.get(what), key)


def _state_dict(state, keep: bool = True) -> dict:
    """The train state as nested dicts of CPU tensors and ints (what
    ``state.pt`` holds). A sharded state's tensors are gathered whole:
    every rank calls it, and ``keep=False`` drops what this rank gathered."""
    layout = getattr(state, "layout", None)
    groups = _live_groups(state)

    def plain(what: str) -> Optional[dict]:
        d = groups[what]
        if d is None:
            return None
        if layout is None:
            return {k: t.detach().cpu() for k, t in d.items()}
        return layout.full_dict(_GROUP_COMPONENT.get(what), d, keep=keep)

    opt = state.opt_state
    return {"step": int(state.step),
            "params": {"unet": plain("unet params"), "text": plain("text params"),
                       "vae": plain("vae params")},
            "opt": {"count": int(opt.count), "mini_step": int(opt.mini_step),
                    "mu": plain("Adam first moments"), "nu": plain("Adam second moments"),
                    "acc_grads": plain("accumulated gradients"),
                    "m8": plain("8-bit Adam first moments"),
                    "v8": plain("8-bit Adam second moments")},
            "ema": plain("EMA params")}


def _leaves(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Nested dicts -> ``a/b/c`` keys; None subtrees (absent EMA,
    accumulators) have no leaves."""
    if isinstance(tree, dict):
        out: dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


def _leaf_record(leaf: Any) -> dict:
    """crc32 of a CPU tensor's raw bytes (any dtype: bf16 has no numpy type,
    so the bytes are read as uint8) or of an int's decimal text, with its
    shape and dtype."""
    if isinstance(leaf, torch.Tensor):
        raw = leaf.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
        return {"crc32": zlib.crc32(raw), "shape": list(leaf.shape), "dtype": str(leaf.dtype)}
    return {"crc32": zlib.crc32(str(int(leaf)).encode()), "shape": [], "dtype": "int"}


def _records(payload: dict) -> dict[str, dict]:
    leaves = _leaves(payload)
    # zlib releases the GIL on large buffers: the leaves hash in parallel
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return dict(zip(leaves, pool.map(_leaf_record, leaves.values())))


def state_manifest(payload: dict) -> dict:
    """Content manifest of a saved state (the JAX package's schema without
    the step): ``{"format", "leaves": {key: {"crc32", "shape", "dtype"}}}``.
    crc32 is not cryptographic: the adversary is a torn write or bit rot."""
    return {"format": MANIFEST_FORMAT, "leaves": _records(payload)}


def verify_manifest(manifest: dict, payload: dict) -> list[str]:
    """Mismatch descriptions ([] = valid) between a loaded state and the
    manifest written when it was saved."""
    expected = manifest.get("leaves", {})
    got = _records(payload)
    problems = [f"{key}: missing from the loaded state" for key in expected
                if key not in got]
    for key, rec in got.items():
        want = expected.get(key)
        if want is None:
            problems.append(f"{key}: leaf not in manifest")
        elif rec["shape"] != want["shape"] or rec["dtype"] != want["dtype"]:
            problems.append(f"{key}: shape/dtype {rec['shape']}/{rec['dtype']} != "
                            f"{want['shape']}/{want['dtype']}")
        elif rec["crc32"] != want["crc32"]:
            problems.append(f"{key}: checksum mismatch")
    return problems


def corrupt_step_dir(step_dir: Path) -> None:
    """Fault injection: simulate a torn write by zero-filling every file of
    a step directory (tests call it directly too)."""
    for p in Path(step_dir).rglob("*"):
        if p.is_file():
            p.write_bytes(b"\x00" * p.stat().st_size)


def _live_groups(state) -> dict[str, Optional[dict]]:
    opt = state.opt_state
    return {"unet params": state.unet_params, "text params": state.text_params,
            "vae params": state.vae_params, "Adam first moments": opt.mu,
            "Adam second moments": opt.nu, "accumulated gradients": opt.acc_grads,
            "EMA params": state.ema_params, "8-bit Adam first moments": opt.m8,
            "8-bit Adam second moments": opt.v8}


def _saved_groups(saved: dict) -> dict[str, Optional[dict]]:
    try:
        return {"unet params": saved["params"]["unet"], "text params": saved["params"]["text"],
                "vae params": saved["params"]["vae"], "Adam first moments": saved["opt"]["mu"],
                "Adam second moments": saved["opt"]["nu"],
                "accumulated gradients": saved["opt"]["acc_grads"], "EMA params": saved["ema"],
                # absent from checkpoints written before 8-bit Adam was ported
                "8-bit Adam first moments": saved["opt"].get("m8"),
                "8-bit Adam second moments": saved["opt"].get("v8")}
    except (KeyError, TypeError) as e:
        raise CheckpointCorrupt(f"not a train state: {e!r}") from e


def _check_compatible(state, saved: dict) -> None:
    """ValueError when a loaded state cannot go into the run's: a section
    present in one and absent in the other, other keys or other shapes. A
    checkpoint of another configuration, not a damaged one. A checkpoint
    written with the other ``optim.use_8bit_adam`` setting says so: its
    moments are never re-initialised in silence."""
    run_8bit = state.opt_state.m8 is not None
    if run_8bit != (_saved_groups(saved)["8-bit Adam first moments"] is not None):
        raise ValueError(
            f"checkpoint was written with optim.use_8bit_adam={not run_8bit} and the run "
            f"has optim.use_8bit_adam={run_8bit}: its Adam moments cannot be resumed; "
            f"set optim.use_8bit_adam={not run_8bit} or start a new output_dir")
    for what, dst in _live_groups(state).items():
        src = _saved_groups(saved)[what]
        if (dst is None) != (src is None):
            raise ValueError(f"checkpoint {what} does not match the run's configuration "
                             f"({'absent' if src is None else 'present'} in the checkpoint)")
        if dst is None:
            continue
        if set(dst) != set(src):
            raise ValueError(f"checkpoint {what} keys differ from the run's: "
                             f"{sorted(set(dst) ^ set(src))[:5]}")
        whole = ((lambda k, t: tuple(t.shape)) if getattr(state, "layout", None) is None
                 else (lambda k, t: state.layout.full_shape(t.shape, _placement(state, what, k))))
        bad = [k for k, t in dst.items() if tuple(src[k].shape) != whole(k, t)]
        if bad:
            raise ValueError(f"checkpoint {what} shapes differ from the run's: {bad[:5]}")


def _copy_into(state, saved: dict, skip: tuple[str, ...] = ()) -> None:
    """Copy a loaded state into ``state``'s tensors (a sharded state: each
    tensor's shard, cut from the whole)."""
    layout = getattr(state, "layout", None)
    with torch.no_grad():
        for what, dst in _live_groups(state).items():
            if what in skip:
                continue
            src = _saved_groups(saved)[what]
            for k, t in (dst or {}).items():
                t.copy_(src[k] if layout is None
                        else layout.local(src[k], _placement(state, what, k)))
    opt = state.opt_state
    opt.count, opt.mini_step = int(saved["opt"]["count"]), int(saved["opt"]["mini_step"])
    state.step = int(saved["step"])


class CheckpointManager:
    """Step-numbered full-state checkpoints under one directory, with a
    content manifest per step and quarantine-and-fall-back restore.

    Layout: ``<step>/state.pt``, ``manifests/<step>.json`` (written after
    the step directory is renamed into place) and ``quarantined/<step>/``
    (damaged steps moved aside, never offered again). ``verify=False``
    writes and checks no manifests. ``quarantine`` records each bad step
    as a ``bad_checkpoint`` record. ``coordinator``
    (``core/coordination.Coordinator``) makes the restore of a
    multi-process job an agreement (:meth:`_restore_latest_valid_coordinated`);
    there the primary process writes the steps, on a filesystem every
    process reads."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3, *, verify: bool = True,
                 quarantine: Optional[QuarantineManifest] = None, coordinator=None):
        self.dir = Path(directory)
        self.max_to_keep = max_to_keep
        self.verify = verify
        self.quarantine = quarantine
        self.coordinator = coordinator
        self.manifest_dir = self.dir / "manifests"

    def all_steps(self) -> list[int]:
        if not self.dir.exists():
            return []
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest_path(self, step: int) -> Path:
        return self.manifest_dir / f"{step}.json"

    def save(self, step: int, state, *, primary: bool = True) -> bool:
        """Write ``state`` as step ``step``; returns False when that step is
        already saved. On a job every rank calls it and the ``primary``
        writes (the others return False); a sharded state's tensors are
        gathered whole on every rank first."""
        payload = None
        if getattr(state, "layout", None) is not None:
            payload = _state_dict(state, keep=primary)
        final = self.dir / str(step)
        if not primary or (final / STATE_FILE).exists():
            return False
        payload = _state_dict(state) if payload is None else payload
        tmp = self.dir / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        with open(tmp / STATE_FILE, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        fsio.fsync_dir(self.dir)
        if self.verify:
            self.manifest_dir.mkdir(exist_ok=True)
            manifest = {"step": step, **state_manifest(payload)}
            fsio.publish_durable(self._manifest_path(step).with_suffix(".tmp"),
                                 self._manifest_path(step), json.dumps(manifest, sort_keys=True))
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(self.dir / str(old), ignore_errors=True)
            self._manifest_path(old).unlink(missing_ok=True)
        log.info("checkpoint saved at step %d -> %s", step, final)
        from dcr_tpu_torch.utils import faults

        if faults.fire("ckpt_corrupt", step=step):
            corrupt_step_dir(final)
        return True

    def _load_verified(self, step: int) -> dict:
        """Step ``step``'s payload on the CPU, checked against its manifest;
        :class:`CheckpointCorrupt` when it does not load or does not match.
        A step without a manifest (saved with ``verify=False``) is accepted
        unverified."""
        path = self.dir / str(step) / STATE_FILE
        try:
            saved = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:  # a torn file raises any of many types
            raise CheckpointCorrupt(f"checkpoint step {step} does not load: {e!r}") from e
        if not isinstance(saved, dict):
            raise CheckpointCorrupt(f"checkpoint step {step} holds a {type(saved).__name__}")
        if not self.verify:
            return saved
        mpath = self._manifest_path(step)
        if not mpath.exists():
            log.info("checkpoint step %d has no manifest: accepted unverified", step)
            return saved
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(f"checkpoint step {step}: manifest unreadable: {e!r}") from e
        problems = verify_manifest(manifest, saved)
        if problems:
            raise CheckpointCorrupt(f"checkpoint step {step} failed verification "
                                    f"({len(problems)} mismatches): {'; '.join(problems[:5])}")
        return saved

    def restore(self, state, step: Optional[int] = None) -> int:
        """Load checkpoint ``step`` (default: the latest), verify all of it,
        and only then copy it into ``state``'s tensors; returns the restored
        step. A damaged step raises :class:`CheckpointCorrupt` and leaves
        ``state`` untouched; only :meth:`restore_latest_valid` walks back."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        saved = self._load_verified(step)
        _check_compatible(state, saved)
        _copy_into(state, saved)
        return state.step

    def restore_latest_valid(self, state, *, skip: tuple[str, ...] = ()
                             ) -> tuple[int, list[tuple[int, str]]]:
        """(step, skipped): walk the steps newest first to the newest one
        that loads and verifies, restore it into ``state``, and move every
        damaged step on the way to ``quarantined/<step>`` (recorded, logged)
        so it is never offered again. Raises FileNotFoundError only when no
        valid step is left: a silent restart from scratch would hide the
        loss of the run. ``skip`` names groups of :func:`_live_groups`
        ("vae params", ...) that are verified but not written: a pipelined
        run's frozen params, which its producer thread is reading."""
        if self.coordinator is not None and self.coordinator.process_count > 1:
            return self._restore_latest_valid_coordinated(state, skip)
        skipped: list[tuple[int, str]] = []
        while True:
            steps = self.all_steps()
            if not steps:
                if skipped:
                    raise FileNotFoundError(
                        f"no valid checkpoint under {self.dir}: all {len(skipped)} steps "
                        f"quarantined ({skipped})")
                raise FileNotFoundError(f"no checkpoint under {self.dir}")
            step = steps[-1]
            try:
                saved = self._load_verified(step)
            except CheckpointCorrupt as e:
                self.quarantine_step(step, str(e))
                skipped.append((step, str(e)))
                continue
            _check_compatible(state, saved)
            _copy_into(state, saved, skip)
            return step, skipped

    def _restore_latest_valid_coordinated(self, state, skip: tuple[str, ...] = ()
                                          ) -> tuple[int, list[tuple[int, str]]]:
        """The agreement loop of the JAX manager: each round every process
        proposes its newest step, the job takes the minimum (the newest step
        every process sees), every process loads and verifies it, and a
        second round checks that all succeeded. A step any process rejects
        is quarantined everywhere and the loop proposes again, so processes
        that see different damage still resume from one step."""
        coord = self.coordinator
        skipped: list[tuple[int, str]] = []
        while True:
            steps = self.all_steps()
            proposals = coord.agree_int(steps[-1] if steps else -1, "ckpt_candidate")
            agreed = min(proposals)
            if agreed < 0:
                raise FileNotFoundError(
                    f"no checkpoint available on every process under {self.dir}: "
                    f"per-rank proposals {proposals}, skipped {skipped}")
            try:
                saved, reason = self._load_verified(agreed), ""
            except CheckpointCorrupt as e:
                saved, reason = None, str(e)
            oks = coord.agree_int(int(saved is not None), "ckpt_valid")
            if all(oks):
                _check_compatible(state, saved)
                _copy_into(state, saved, skip)
                return agreed, skipped
            reason = reason or f"peer process failed validation of step {agreed} (oks={oks})"
            self.quarantine_step(agreed, reason)
            skipped.append((agreed, reason))

    def quarantine_step(self, step: int, reason: str) -> None:
        """Move step ``step`` to ``quarantined/<step>`` (``<step>.<n>`` when
        that step was quarantined before) and record it. A peer process on
        the same filesystem may move it first."""
        src = self.dir / str(step)
        dst = self.dir / "quarantined" / str(step)
        n = 1
        while dst.exists():
            dst = dst.with_name(f"{step}.{n}")
            n += 1
        dst.parent.mkdir(parents=True, exist_ok=True)
        if src.exists():
            try:
                shutil.move(str(src), str(dst))
            except OSError as e:  # a peer moved it first
                log.info("quarantine move of step %d raced a peer: %r", step, e)
        self._manifest_path(step).unlink(missing_ok=True)
        moved_to = str(dst.absolute())
        R.log_event("ckpt_quarantined", step=step, reason=reason, moved_to=moved_to)
        if self.quarantine is not None:
            self.quarantine.record("bad_checkpoint", step=step, reason=reason,
                                   moved_to=moved_to)


# ---------------------------------------------------------------------------
# HF-layout export
# ---------------------------------------------------------------------------

def diffusers_configs(mc: dict) -> dict[str, dict]:
    """Per-subfolder diffusers/transformers config.json contents from a
    ModelConfig dict (own copy of dcr_tpu's ``_diffusers_configs``: the
    shipped stabilityai/stable-diffusion-2-1 configs at the default dims)."""
    ch = list(mc.get("block_out_channels", (320, 640, 1280, 1280)))
    # diffusers' attention_head_dim is the per-block head COUNT
    num_heads = mc.get("attention_num_heads")
    head_dim = mc.get("attention_head_dim", 64)
    heads_cfg = num_heads if num_heads else [c // head_dim for c in ch]
    n = len(ch)
    unet = {
        "_class_name": "UNet2DConditionModel",
        "_diffusers_version": "0.14.0",
        "sample_size": mc.get("sample_size", 32),
        "in_channels": mc.get("in_channels", 4),
        "out_channels": mc.get("out_channels", 4),
        "down_block_types": ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"],
        "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * (n - 1),
        "block_out_channels": ch,
        "layers_per_block": mc.get("layers_per_block", 2),
        "cross_attention_dim": mc.get("cross_attention_dim", 1024),
        "attention_head_dim": heads_cfg,
        "use_linear_projection": bool(mc.get("use_linear_projection", True)),
        "norm_num_groups": mc.get("norm_num_groups", 32),
        "act_fn": "silu",
        "center_input_sample": False,
        "downsample_padding": 1,
        "flip_sin_to_cos": True,
        "freq_shift": 0,
        "mid_block_scale_factor": 1,
        "norm_eps": 1e-5,
    }
    vch = list(mc.get("vae_block_out_channels", (128, 256, 512, 512)))
    vae = {
        "_class_name": "AutoencoderKL",
        "_diffusers_version": "0.14.0",
        "sample_size": mc.get("sample_size", 32) * 8,
        "in_channels": 3,
        "out_channels": 3,
        "down_block_types": ["DownEncoderBlock2D"] * len(vch),
        "up_block_types": ["UpDecoderBlock2D"] * len(vch),
        "block_out_channels": vch,
        "latent_channels": mc.get("vae_latent_channels", 4),
        "layers_per_block": mc.get("vae_layers_per_block", 2),
        "norm_num_groups": min(mc.get("norm_num_groups", 32), vch[0]),
        "act_fn": "silu",
        "scaling_factor": mc.get("vae_scaling_factor", 0.18215),
    }
    text = {
        "architectures": ["CLIPTextModel"],
        "model_type": "clip_text_model",
        "vocab_size": mc.get("text_vocab_size", 49408),
        "hidden_size": mc.get("text_hidden_size", 1024),
        "intermediate_size": 4 * mc.get("text_hidden_size", 1024),
        "num_hidden_layers": mc.get("text_layers", 23),
        "num_attention_heads": mc.get("text_heads", 16),
        "max_position_embeddings": mc.get("text_max_length", 77),
        "hidden_act": mc.get("text_act", "gelu"),
        "layer_norm_eps": 1e-5,
        "torch_dtype": "float32",
    }
    return {"unet": unet, "vae": vae, "text_encoder": text}


# torch-layout weight file per component, as diffusers and transformers name it
WEIGHT_FILE = {"unet": "diffusion_pytorch_model.safetensors",
               "vae": "diffusion_pytorch_model.safetensors",
               "text_encoder": "model.safetensors"}


def _to_flax(component: str, sd: dict, mc: dict) -> dict:
    """The Flax tree of ``params.npz``: the UNet's up-block numbering needs
    its block count and the text encoder's attention its head count, which
    the weights do not hold, so both come from the model config."""
    if component == "vae":
        return EX.vae_to_flax(sd)
    key = "block_out_channels" if component == "unet" else "text_heads"
    if key not in mc:
        raise ValueError(f"export_hf_layout needs model_config[{key!r}] to write the "
                         f"{component}'s params.npz")
    if component == "unet":
        return EX.unet_to_flax(sd, len(mc[key]))
    return EX.text_to_flax(sd, mc[key])


def export_hf_layout(out_dir: str | Path, *, unet: Optional[dict] = None,
                     vae: Optional[dict] = None, text_encoder: Optional[dict] = None,
                     scheduler_config: Optional[dict] = None,
                     model_config: Optional[dict] = None) -> None:
    """Write ``<out_dir>/<component>/{params.npz,<weights>.safetensors,
    config.json}`` from the port's state dicts (f32, any device), the
    scheduler config and ``model_index.json``: the layout ``dcr_tpu``'s
    ``export_hf_layout`` writes. The safetensors hold the state dicts as
    they are (the port's names are diffusers-0.14's and transformers'), so
    their key sets, shapes and values are the JAX package's
    ``unet_to_diffusers`` / ``vae_to_diffusers`` / ``text_to_transformers``
    of the same params."""
    out = Path(out_dir)
    mc = dict(model_config or {})
    configs = diffusers_configs(mc)
    for name, sd in (("unet", unet), ("vae", vae), ("text_encoder", text_encoder)):
        if sd is None:
            continue
        sub = out / name
        sub.mkdir(parents=True, exist_ok=True)
        np.savez(sub / "params.npz", **flatten(_to_flax(name, sd, mc)))
        save_file({k: t.detach().float() for k, t in sd.items()}, sub / WEIGHT_FILE[name],
                  metadata={"format": "pt"})
        (sub / "config.json").write_text(json.dumps(configs[name], indent=2))
    if scheduler_config is not None:
        sub = out / "scheduler"
        sub.mkdir(parents=True, exist_ok=True)
        sched = {
            "_class_name": "DPMSolverMultistepScheduler",
            "_diffusers_version": "0.14.0",
            "algorithm_type": "dpmsolver++",
            "solver_order": 2,
            "solver_type": "midpoint",
            "lower_order_final": True,
            "steps_offset": 1,
            "thresholding": False,
            "trained_betas": None,
            **scheduler_config,
        }
        (sub / "scheduler_config.json").write_text(json.dumps(sched, indent=2))
    if model_config is not None:
        index = {
            "_class_name": "StableDiffusionPipeline",
            "_diffusers_version": "0.14.0",
            "unet": ["diffusers", "UNet2DConditionModel"],
            "vae": ["diffusers", "AutoencoderKL"],
            "text_encoder": ["transformers", "CLIPTextModel"],
            "scheduler": ["diffusers", "DPMSolverMultistepScheduler"],
            "model_config": model_config,
        }
        (out / "model_index.json").write_text(json.dumps(index, indent=2))


# ---------------------------------------------------------------------------
# HF-layout import
# ---------------------------------------------------------------------------

# the JAX package's search order (``_TORCH_WEIGHT_NAMES``), fp16 variants included
TORCH_WEIGHT_NAMES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                      "diffusion_pytorch_model.fp16.safetensors",
                      "model.fp16.safetensors",
                      "diffusion_pytorch_model.bin", "pytorch_model.bin",
                      "diffusion_pytorch_model.fp16.bin", "pytorch_model.fp16.bin")


def _npz_state_dict(npz: Path, component: str) -> dict[str, torch.Tensor]:
    with np.load(npz) as z:
        tree = unflatten({k: z[k] for k in z.files})
    if component == "unet":
        n_blocks = len({k.split("_")[1] for k in tree if k.startswith("down_")})
        return EX.unet_from_flax(tree, n_blocks)
    if component == "vae":
        return EX.vae_from_flax(tree)
    return EX.text_from_flax(tree)


def load_torch_file(path: Path) -> dict[str, torch.Tensor]:
    """A safetensors file (the port's reader) or a torch ``.bin`` state dict
    (``torch.load(weights_only=True)``) as tensors on the CPU."""
    if path.suffix == ".safetensors":
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(sd, dict) and all(isinstance(v, torch.Tensor) for v in sd.values())):
        raise ValueError(f"{path} does not hold a state dict of tensors")
    return sd


def import_torch_layout(ckpt_dir: str | Path, component: str) -> dict[str, torch.Tensor]:
    """One component (``unet``, ``vae`` or ``text_encoder``) of an HF-layout
    directory as the port's state dict (f32, CPU): the first of
    :data:`TORCH_WEIGHT_NAMES` present (a downloaded diffusers checkpoint,
    or an export of either package) through ``models/convert``, else
    ``params.npz`` (exports that hold no torch-layout weights). The
    safetensors come first because the reader maps them: SD-2.1's 5.16 GB
    load onto an H100 in ~1 s that way and in ~18 s through params.npz,
    which np.load reads and the Flax-to-torch carry copies again
    (``chip_smoke.py``'s checkpoint phase times both). Keys and shapes are
    checked by the caller against the modules its config describes."""
    if component not in CV.CONVERTERS:
        raise ValueError(f"unknown component {component!r}")
    sub = Path(ckpt_dir) / component
    weight_file = next((sub / n for n in TORCH_WEIGHT_NAMES if (sub / n).exists()), None)
    if weight_file is not None:
        return CV.CONVERTERS[component](load_torch_file(weight_file))
    if (sub / "params.npz").exists():
        return _npz_state_dict(sub / "params.npz", component)
    raise FileNotFoundError(f"no params.npz or torch weights "
                            f"({'/'.join(TORCH_WEIGHT_NAMES)}) under {sub}")


def _uniform_transformer_layers(unet_cfg: dict) -> int:
    """SD-1.x/2.x UNets use one transformer depth everywhere; SDXL-style
    per-block lists ([1, 2, 10]) are a different architecture and are
    refused rather than built wrong from a subset of the weights."""
    tl = unet_cfg.get("transformer_layers_per_block", 1)
    if isinstance(tl, (list, tuple)):
        if len(set(tl)) != 1:
            raise ValueError(
                f"per-block transformer depths {tl} (SDXL-family?) are not "
                "supported by this UNet architecture")
        tl = tl[0]
    return int(tl)


def model_config_from_diffusers(ckpt_dir: str | Path) -> dict:
    """ModelConfig fields from a genuine diffusers checkpoint's
    per-subfolder config.json files (the inverse of
    :func:`diffusers_configs`). Both head conventions: SD-2.x per-block
    head lists with a common head_dim, SD-1.x one fixed head count."""
    ckpt = Path(ckpt_dir)
    u = json.loads((ckpt / "unet" / "config.json").read_text())
    block_out = list(u["block_out_channels"])
    heads = u.get("attention_head_dim", 8)
    out: dict = {
        "sample_size": u.get("sample_size", 32),
        "in_channels": u.get("in_channels", 4),
        "out_channels": u.get("out_channels", 4),
        "block_out_channels": tuple(block_out),
        "layers_per_block": u.get("layers_per_block", 2),
        "cross_attention_dim": u.get("cross_attention_dim", 1024),
        "use_linear_projection": u.get("use_linear_projection", False),
        "norm_num_groups": u.get("norm_num_groups", 32),
    }
    out["transformer_layers"] = _uniform_transformer_layers(u)
    if isinstance(heads, (list, tuple)):
        head_dims = {c // h for c, h in zip(block_out, heads)}
        if len(head_dims) != 1:
            raise ValueError(
                f"per-block heads {heads} do not share one head_dim over "
                f"channels {block_out}; not expressible by ModelConfig")
        out["attention_head_dim"] = head_dims.pop()
    else:
        out["attention_num_heads"] = int(heads)
        out["attention_head_dim"] = 0
    vae_cfg = ckpt / "vae" / "config.json"
    if vae_cfg.exists():
        v = json.loads(vae_cfg.read_text())
        out.update(
            vae_block_out_channels=tuple(v["block_out_channels"]),
            vae_layers_per_block=v.get("layers_per_block", 2),
            vae_latent_channels=v.get("latent_channels", 4),
            vae_scaling_factor=v.get("scaling_factor", 0.18215))
    text_cfg = ckpt / "text_encoder" / "config.json"
    if text_cfg.exists():
        t = json.loads(text_cfg.read_text())
        out.update(
            text_vocab_size=t.get("vocab_size", 49408),
            text_hidden_size=t.get("hidden_size", 1024),
            text_layers=t.get("num_hidden_layers", 23),
            text_heads=t.get("num_attention_heads", 16),
            text_max_length=t.get("max_position_embeddings", 77),
            # transformers serializes a config as its diff from the defaults,
            # and CLIPTextConfig's default is quick_gelu: an omitted key
            # means quick_gelu, not gelu
            text_act=t.get("hidden_act", "quick_gelu"))
    sched_cfg = ckpt / "scheduler" / "scheduler_config.json"
    if sched_cfg.exists():
        s = json.loads(sched_cfg.read_text())
        out.update(
            num_train_timesteps=s.get("num_train_timesteps", 1000),
            beta_schedule=s.get("beta_schedule", "scaled_linear"),
            beta_start=s.get("beta_start", 0.00085),
            beta_end=s.get("beta_end", 0.012),
            prediction_type=s.get("prediction_type", "epsilon"))
    return out
