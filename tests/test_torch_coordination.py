"""PyTorch port: the fault agreement (``core/coordination``), the
coordinated restore (``core/checkpoint``) and two-rank recovery drills,
against the JAX package.

- ``reduce_fault_words`` equals the JAX function on a seeded table of
  words; the Coordinator on one process is pure and one-shot, and a peer's
  fault decides locally through an injected allgather.
- The coordinated restore walks the JAX test's scripted cases (pod
  minimum, a step a peer rejects, an empty peer).
- Drills, each ``dcr-train-torch``'s main as two gloo ranks on a FileStore
  (``tests/_torch_ranks.py``), all three at once: ``nan_loss`` on rank 1
  rolls both ranks back at one step and they end bit-equal; ``sigterm`` on
  rank 0 gives one checkpoint and exit 83 on both; ``hang`` on rank 1 gives
  exit 89 on both.
"""

from __future__ import annotations

import json
import math
import re
import time

import numpy as np
import pytest
import torch

from dcr_tpu.core import coordination as JC
from dcr_tpu_torch.core import checkpoint as CK
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.core import coordination as C
from dcr_tpu_torch.core import dist
from dcr_tpu_torch.diffusion import train as T
from dcr_tpu_torch.utils import faults
from tests._torch_ranks import Ranks, rank_env
from tests.test_torch_trainer import _cfg, _data


def _words(rng, n):
    return [dict(nan_step=int(rng.choice([-1, -1, rng.integers(0, 50)])),
                 rollback_ok=bool(rng.integers(2)), preempt=bool(rng.random() < 0.3),
                 bad_samples=int(rng.integers(0, 8))) for _ in range(n)]


def test_reduce_fault_words_matches_jax_on_a_seeded_table():
    rng = np.random.default_rng(0)
    actions = set()
    for _ in range(400):
        words = _words(rng, int(rng.integers(1, 5)))
        budget = None if rng.random() < 0.3 else int(rng.integers(0, 20))
        want = JC.reduce_fault_words([JC.FaultWord(**w) for w in words], bad_budget=budget)
        got = C.reduce_fault_words([C.FaultWord(**w) for w in words], bad_budget=budget)
        assert (got.action.value, got.nan_step, got.nan_ranks, got.preempt_ranks,
                got.bad_total) == (want.action.value, want.nan_step, want.nan_ranks,
                                   want.preempt_ranks, want.bad_total)
        actions.add(got.action)
        w = C.FaultWord(**words[0])
        assert np.array_equal(w.encode(), JC.FaultWord(**words[0]).encode())
        assert C.FaultWord.decode(w.encode()) == w
    assert actions == set(C.Action)
    with pytest.raises(ValueError, match="fields"):
        C.FaultWord.decode(np.zeros(3, np.int64))


def test_coordinator_on_one_process_is_pure_and_one_shot():
    coord = C.Coordinator(process_index=0, process_count=1,
                          allgather=lambda v: pytest.fail("no collective on one process"))
    assert coord.exchange(1).action is C.Action.CONTINUE
    coord.note_nan(3, rollback_ok=True)
    d = coord.exchange(3)
    assert d.action is C.Action.ROLLBACK and d.nan_step == 3
    assert coord.exchange(4).action is C.Action.CONTINUE  # the NaN is consumed
    coord.note_preempt()
    assert coord.exchange(5).action is C.Action.CHECKPOINT_AND_EXIT
    assert coord.exchange(6).action is C.Action.CHECKPOINT_AND_EXIT  # sticky
    assert coord.last_agreement["action"] == "checkpoint_and_exit"
    assert coord.agree_int(7, "x") == [7]


def test_a_peers_fault_decides_here_and_divergence_raises():
    peer = C.FaultWord(nan_step=7, rollback_ok=True)
    coord = C.Coordinator(process_index=0, process_count=2,
                          allgather=lambda v: np.stack([v, peer.encode()]))
    d = coord.exchange(7)
    assert d.action is C.Action.ROLLBACK and d.nan_ranks == (1,)
    coord = C.Coordinator(process_index=0, process_count=2,
                          allgather=lambda v: np.stack([v, v + 2]))
    with pytest.raises(C.CoordinationError, match="resume_step"):
        coord.assert_same("resume_step", 4)


def test_a_round_past_its_timeout_aborts_89_with_the_last_agreement(monkeypatch, caplog):
    exits = []
    monkeypatch.setattr(C, "_exit_fn", exits.append)
    coord = C.Coordinator(process_index=0, process_count=2, timeout_s=0.2,
                          abort_on_timeout=True, allgather=lambda v: time.sleep(5))
    coord.last_agreement = {"step": 4, "action": "continue"}
    with caplog.at_level("WARNING"), pytest.raises(dist.BarrierTimeout):
        coord.exchange(5)
    assert exits == [C.EXIT_HANG]
    assert any("hang_abort" in r.getMessage() and '"step": 4' in r.getMessage()
               for r in caplog.records)


def test_fault_rank_is_the_worker_index_else_the_process_rank(monkeypatch):
    monkeypatch.delenv("DCR_WORKER_INDEX", raising=False)
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    assert faults._current_rank() == 1
    monkeypatch.setenv("DCR_WORKER_INDEX", "3")
    assert faults._current_rank() == 3


# ---------------------------------------------------------------------------
# the coordinated restore: the JAX test's scripted cases
# ---------------------------------------------------------------------------

class ScriptedCoordinator:
    """``agree_int`` plays back per-call responses (value -> row)."""

    process_count = 2

    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    def agree_int(self, value, name):
        self.calls.append((name, int(value)))
        return self.responses.pop(0)(int(value))


def _state(value: float) -> T.TrainState:
    return T.TrainState(step=0, unet_params={"w": torch.full((8,), value)}, text_params={},
                        vae_params={}, opt_state=T.OptState(count=0, mu={}, nu={}))


def _ckpts(tmp_path, steps, coordinator=None):
    mgr = CK.CheckpointManager(tmp_path / "ckpt", max_to_keep=10, coordinator=coordinator)
    for step in steps:
        state = _state(float(step))
        state.step = step
        mgr.save(step, state)
    return mgr


def test_coordinated_restore_takes_the_minimum_proposal(tmp_path):
    _ckpts(tmp_path, [2, 4])
    coord = ScriptedCoordinator([lambda v: [v, 2], lambda v: [v, 1]])
    state = _state(0.0)
    step, skipped = _ckpts(tmp_path, [], coord).restore_latest_valid(state)
    assert step == 2 and skipped == [] and state.step == 2
    assert torch.equal(state.unet_params["w"], torch.full((8,), 2.0))
    assert coord.calls == [("ckpt_candidate", 4), ("ckpt_valid", 1)]


def test_coordinated_restore_quarantines_a_step_a_peer_rejects(tmp_path):
    _ckpts(tmp_path, [2, 4])
    coord = ScriptedCoordinator([lambda v: [v, 4], lambda v: [v, 0],
                                 lambda v: [v, 2], lambda v: [v, 1]])
    state = _state(0.0)
    step, skipped = _ckpts(tmp_path, [], coord).restore_latest_valid(state)
    assert step == 2 and [s for s, _ in skipped] == [4]
    assert "peer process" in skipped[0][1]
    assert (tmp_path / "ckpt" / "quarantined" / "4").exists()


def test_coordinated_restore_raises_when_a_peer_has_none(tmp_path):
    _ckpts(tmp_path, [2])
    coord = ScriptedCoordinator([lambda v: [v, -1]])
    with pytest.raises(FileNotFoundError, match="every process"):
        _ckpts(tmp_path, [], coord).restore_latest_valid(_state(0.0))


def test_coordinated_restore_of_a_locally_torn_step(tmp_path):
    """This process's copy of step 4 is torn: it votes 0, the step is
    quarantined, and the next round lands on 2."""
    _ckpts(tmp_path, [2, 4])
    CK.corrupt_step_dir(tmp_path / "ckpt" / "4")
    coord = ScriptedCoordinator([lambda v: [v, 4], lambda v: [v, 1],
                                 lambda v: [v, 2], lambda v: [v, 1]])
    step, skipped = _ckpts(tmp_path, [], coord).restore_latest_valid(_state(0.0))
    assert step == 2 and [s for s, _ in skipped] == [4]
    assert coord.calls[1] == ("ckpt_valid", 0)


# ---------------------------------------------------------------------------
# two-rank drills through dcr-train-torch
# ---------------------------------------------------------------------------

# name: (DCR_FAULTS, argv, env, mesh). 8 images at 2 rows per data rank:
# "seq_budget" has 4 steps of 2 slots an epoch, a budget of 2 bad samples
# and 2 planted on both seq replicas, "tensor_budget" the same on both
# tensor ranks (the Trainer's own sharded state); "pod" plants one on rank
# 1 (slot 6 is rank 1's first row of step 1, the epoch's second)
DRILLS = {
    "nan": ("nan_loss@step=3@rank=1", ["--max_train_steps=5", "--modelsavesteps=2",
                                       "--fault.max_rollbacks=1"], {}, {"data": 2}),
    "sigterm": ("sigterm@step=2@rank=0", ["--max_train_steps=4"], {}, {"data": 2}),
    "hang": ("hang@step=2@rank=1", ["--max_train_steps=4"], {"DCR_HANG_TIMEOUT_S": "6"},
             {"data": 2}),
    "seq_budget": ("decode_error@step=1&slot=2,decode_error@step=2&slot=4",
                   ["--max_train_steps=4", "--fault.max_bad_sample_frac=0.25"], {},
                   {"data": 1, "seq": 2}),
    "tensor_budget": ("decode_error@step=1&slot=2,decode_error@step=2&slot=4",
                      ["--max_train_steps=4", "--fault.max_bad_sample_frac=0.25"], {},
                      {"data": 1, "tensor": 2}),
    "pod": ("decode_error@step=1&slot=6@rank=1",
            ["--max_train_steps=2", "--fault.max_bad_sample_frac=0.25"], {}, {"data": 2}),
}


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    root = tmp_path_factory.mktemp("drills")
    _data(root / "data", n=8)
    running = {}
    for name, (spec, extra, env, mesh) in DRILLS.items():
        d = root / name
        d.mkdir()
        cfg = _cfg(root, out=f"{name}/run")
        cfg.train_batch_size = 2
        cfg.mesh = TC.MeshConfig(**mesh)
        TC.save_config(cfg, d / "cfg.json")
        argv = [f"--config={d / 'cfg.json'}", *extra]
        running[name] = Ranks("train_cli", 2, d, {"argv": argv},
                              env=rank_env(DCR_FAULTS=spec, **env))
    return {name: (root / name / "run", r.wait(timeout=300)) for name, r in running.items()}


def _records(run, rank):
    path = run / ("quarantine.jsonl" if rank == 0 else f"quarantine.p{rank}.jsonl")
    return [json.loads(x) for x in path.read_text().splitlines()] if path.exists() else []


def _fingerprints(outputs):
    return [re.findall(r"state fingerprint at step (\d+): (\w+)", text) for _, text in outputs]


def test_nan_on_one_rank_rolls_both_back_at_one_step(drills):
    run, outputs = drills["nan"]
    for rc, text in outputs:
        assert rc == 0, text[-3000:]
        assert '"action": "rollback"' in text
    recs = [[r for r in _records(run, rank) if r["kind"] == "nan_rollback"] for rank in (0, 1)]
    assert [(r["at_step"], r["restored_step"]) for r in recs[0]] == [(3, 2)]
    assert [(r["at_step"], r["restored_step"]) for r in recs[1]] == [(3, 2)]
    fp = _fingerprints(outputs)
    assert fp[0] and fp[0] == fp[1] and fp[0][-1][0] == "5"
    rows = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 4, 5]
    assert (run / "checkpoint" / "model_index.json").exists()


def test_sigterm_on_one_rank_gives_one_checkpoint_and_83_on_both(drills):
    run, outputs = drills["sigterm"]
    for rc, text in outputs:
        assert rc == C.EXIT_PREEMPTED, text[-3000:]
        assert "preemption: checkpointing at step 2" in text
        assert "signalled on ranks [0]" in text
    assert CK.CheckpointManager(run / "checkpoints").all_steps() == [2]
    fp = _fingerprints(outputs)
    assert fp[0] and fp[0] == fp[1]
    for rank in (0, 1):
        dump = json.loads((run / f"flightrec_{rank}.json").read_text())
        assert dump["reason"] == "preempted: checkpointed at step 2"


def test_a_hang_on_one_rank_exits_89_on_both(drills):
    run, outputs = drills["hang"]
    for rc, text in outputs:
        assert rc == C.EXIT_HANG, text[-3000:]
        assert "[fault] hang_abort" in text
    assert "[fault] injected_hang" in outputs[1][1]
    assert "exiting in" in outputs[0][1]  # rank 0 serves the store: it exits last


def _metrics(run):
    return [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]


def test_seq_replicas_count_their_shared_bad_samples_once(drills):
    run, outputs = drills["seq_budget"]
    for rc, text in outputs:
        assert rc == 0, text[-3000:]
        assert "TooManyBadSamples" not in text
    # both replicas quarantined the same two samples (the loader's workers
    # may record them in either order) ...
    assert [sorted((r["step"], r["slot"]) for r in _records(run, rank)
                   if r["kind"] == "bad_sample") for rank in (0, 1)] == [[(1, 2), (2, 4)]] * 2
    # ... and the job counted them once, against its budget of 2
    last = _metrics(run)[-1]
    assert last["step"] == 4 and last["faults_pod/bad_samples"] == 2
    fp = _fingerprints(outputs)
    assert fp[0] and fp[0] == fp[1]


def test_tensor_replicas_read_one_batch_and_count_its_bad_samples_once(drills):
    """dcr-train-torch on tensor = 2: both ranks load the batch group's
    rows (the same two quarantined at the same step and slot) and the job
    counts them once against its budget of 2, as the seq replicas do."""
    run, outputs = drills["tensor_budget"]
    for rc, text in outputs:
        assert rc == 0, text[-3000:]
        assert "TooManyBadSamples" not in text
    assert [sorted((r["step"], r["slot"]) for r in _records(run, rank)
                   if r["kind"] == "bad_sample") for rank in (0, 1)] == [[(1, 2), (2, 4)]] * 2
    rows = _metrics(run)
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert rows[-1]["faults_pod/bad_samples"] == 2
    assert all(math.isfinite(r["loss"]) for r in rows)


def test_a_peers_fault_counters_reach_the_primarys_metrics(drills):
    run, outputs = drills["pod"]
    for rc, text in outputs:
        assert rc == 0, text[-3000:]
    assert not _records(run, 0) and len(_records(run, 1)) == 1
    last = _metrics(run)[-1]
    assert last["step"] == 2
    assert last["faults/bad_samples"] == 0 and last["faults_pod/bad_samples"] == 1
