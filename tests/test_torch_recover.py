"""Trainer survivability in ``areal_tpu_torch``: recover bookkeeping, the
committed trainer checkpoint and the worker's recover, rollback and
preemption paths (the counterparts of ``tests/test_fault_tolerance.py``'s
trainer scenarios, ``:485-890``), with the pure-Python pieces held against
``areal_tpu`` on the same inputs.

Here a crash mid-save is a raise from the commit step (after the tensors
are staged, before the rename), the window the ``ckpt.save`` fault point
opens (``tests/test_torch_faults.py`` scripts the point itself). Comparisons of params after a
resume are exact (``torch.equal``): the checkpoint holds every bit of the
training state.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from areal_tpu.base import recover as jax_recover
from areal_tpu.base import timeutil as jax_timeutil
from areal_tpu_torch.api import data as pt_data
from areal_tpu_torch.api.model import PPOHyperparameters, make_interface
from areal_tpu_torch.base import constants, name_resolve, names, recover
from areal_tpu_torch.base import timeutil
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.system import worker_base
from areal_tpu_torch.system.trainer_worker import (AsyncPPOTrainerWorker,
                                                   TrainerControl)
from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine

EXP, TRIAL = "ft", "t0"
CFG = ModelConfig(n_layers=1, n_q_heads=2, n_kv_heads=1, head_dim=8,
                  hidden_dim=16, intermediate_dim=32, vocab_size=64,
                  dtype="float32", use_attention_bias=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path))
    constants.set_experiment_trial_names(EXP, TRIAL)
    saved = name_resolve.default_repository()
    name_resolve.set_repository(name_resolve.MemoryNameRecordRepository())
    yield tmp_path
    name_resolve.set_repository(saved)


def _engine(seed=0, lr=1e-2):
    return TrainEngine(CFG, optimizer=OptimizerConfig(lr=lr),
                       device="cpu").init_random(seed).setup_optimizer(10)


class _EmptyStream:
    def __init__(self):
        self.cleared = False

    def get_batch(self, n, timeout=0.1):
        return []

    def clear(self):
        self.cleared = True
        return 3  # pretend 3 stale trajectories were buffered


def _tiny_trainer(eng=None, **control):
    eng = eng or _engine()
    stream = _EmptyStream()
    worker = AsyncPPOTrainerWorker(
        experiment_name=EXP, trial_name=TRIAL, actor_engine=eng,
        stream=stream, hp=PPOHyperparameters(disable_value=True, kl_ctl=0.0),
        control=TrainerControl(total_train_steps=10, **control),
        train_batch_size=2, hf_family="qwen2",
    )
    return worker, eng, stream


def _leaves(eng):
    return [t.detach().clone() for _, t in recover.tree_leaves_with_path(
        eng.params)]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _announced_version():
    raw = name_resolve.get(names.model_version(EXP, TRIAL, "actor"))
    return int(raw.partition(":")[0]), raw.partition(":")[2]


def _sft_batch(seed):
    rng = np.random.default_rng(seed)
    lens = [6, 9, 7]
    return pt_data.SequenceSample.from_default(
        ids=[0, 1, 2], seqlens=lens, data={
            "packed_input_ids": rng.integers(0, 64, sum(lens)).astype(np.int64),
            "prompt_mask": np.concatenate([
                np.r_[np.ones(2, bool), np.zeros(n - 2, bool)] for n in lens]),
        })


# --------------------------------------------------------------------------- #
# bookkeeping, held against the reference
# --------------------------------------------------------------------------- #


def test_recover_info_round_trips_both_ways(tmp_path):
    info = recover.RecoverInfo(
        recover_start=recover.StepInfo(1, 2, 3),
        last_step_info=recover.StepInfo(0, 5, 7),
        ckpt_ctl_states={"trainer": {"epoch_count": 0, "step_count": 2}},
        hash_vals_to_ignore=[4, 5], samples_consumed=28, model_version=7,
    )
    recover.dump(info, str(tmp_path))
    theirs = jax_recover.load(str(tmp_path))
    assert theirs.to_dict() == info.to_dict()
    jax_recover.dump(theirs, str(tmp_path))
    assert recover.load(str(tmp_path)) == info
    assert recover.load(str(tmp_path / "nowhere")) is None
    assert (recover.StepInfo(0, 4, 9).next(steps_per_epoch=5)
            == recover.StepInfo(1, 0, 10))
    assert recover.StepInfo(0, 1, 1).next() == recover.StepInfo(0, 2, 2)


@pytest.mark.parametrize("freqs", [
    dict(freq_step=3), dict(freq_sec=10.0), dict(freq_step=2, freq_sec=5.0),
    dict(freq_epoch=1, freq_step=4), dict(),
])
def test_freq_ctl_matches_the_reference(monkeypatch, freqs):
    clock = [100.0]
    monkeypatch.setattr(timeutil.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(jax_timeutil.time, "monotonic", lambda: clock[0])
    ours = timeutil.EpochStepTimeFreqCtl(**freqs)
    theirs = jax_timeutil.EpochStepTimeFreqCtl(**freqs)
    rng = np.random.default_rng(0)
    for i in range(40):
        clock[0] += float(rng.uniform(0, 4))
        epochs = int(i % 7 == 6)
        assert ours.check(epochs=epochs, steps=1) == theirs.check(
            epochs=epochs, steps=1), i
        assert ours.state_dict() == theirs.state_dict()
        if i == 20:
            state = ours.state_dict()
            ours.load_state_dict(state)
            theirs.load_state_dict(state)


def test_tree_checksum_is_structural():
    a = {"w": [torch.zeros(2, 3), torch.ones(4)], "b": torch.zeros(())}
    same = {"b": torch.ones(()), "w": [torch.ones(2, 3), torch.zeros(4)]}
    assert recover.tree_checksum(a) == recover.tree_checksum(same)
    for other in ({"w": [torch.zeros(3, 2), torch.ones(4)], "b": a["b"]},
                  {"w": [torch.zeros(2, 3, dtype=torch.bfloat16),
                         torch.ones(4)], "b": a["b"]},
                  {"w": [torch.zeros(2, 3)], "b": a["b"]}):
        assert recover.tree_checksum(other) != recover.tree_checksum(a)


# --------------------------------------------------------------------------- #
# the engine checkpoint
# --------------------------------------------------------------------------- #


def test_resumed_training_equals_uninterrupted_training(tmp_path):
    sft = make_interface("sft")
    spec = pt_data.MicroBatchSpec()
    a = _engine(0)
    sft.train_step(a, _sft_batch(1), spec)
    sft.train_step(a, _sft_batch(2), spec)
    path = str(tmp_path / "ckpt")
    a.save_checkpoint(path)
    m = recover.read_manifest(path)
    assert (m["step"], m["n_updates"], m["with_optim"]) == (2, 2, True)
    sa = sft.train_step(a, _sft_batch(3), spec)
    # "crash": a fresh engine from another seed resumes from the commit
    b = _engine(5)
    assert not _same(_leaves(a), _leaves(b))
    b.load_checkpoint(path)
    assert (b._step, b._n_updates, b.version) == (2, 2, 0)
    sb = sft.train_step(b, _sft_batch(3), spec)
    assert sa == sb
    assert _same(_leaves(a), _leaves(b))
    for pa, pb in zip(a.optimizer.param_groups[0]["params"],
                      b.optimizer.param_groups[0]["params"]):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[pa][k],
                               b.optimizer.state[pb][k]), k


def test_checkpoint_before_any_step_and_without_optimizer(tmp_path):
    sft = make_interface("sft")
    spec = pt_data.MicroBatchSpec()
    a, b = _engine(0), _engine(3)
    a.save_checkpoint(str(tmp_path / "c0"))           # no AdamW state yet
    b.load_checkpoint(str(tmp_path / "c0"))
    sa = sft.train_step(a, _sft_batch(4), spec)
    sb = sft.train_step(b, _sft_batch(4), spec)
    assert sa == sb and _same(_leaves(a), _leaves(b))
    ref = TrainEngine(CFG, device="cpu").init_random(1)
    ref.save_checkpoint(str(tmp_path / "ref"), with_optim=False)
    ref2 = TrainEngine(CFG, device="cpu").init_random(2)
    ref2.load_checkpoint(str(tmp_path / "ref"), with_optim=False)
    assert _same(_leaves(ref), _leaves(ref2))


def test_validate_raises_where_the_reference_does(tmp_path):
    a = _engine(0)
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        a.validate_checkpoint(str(tmp_path / "missing"))
    path = str(tmp_path / "ckpt")
    a.save_checkpoint(path)
    assert a.validate_checkpoint(path)["format"] == "torch-train"
    wider = TrainEngine(
        ModelConfig(**{**CFG.__dict__, "intermediate_dim": 48}),
        optimizer=OptimizerConfig(), device="cpu").init_random(0)
    wider.setup_optimizer(10)
    before = _leaves(wider)
    with pytest.raises(ValueError, match="checksum mismatch on 'params'"):
        wider.load_checkpoint(path)
    assert _same(before, _leaves(wider))   # nothing restored


def test_crash_mid_save_keeps_the_previous_commit(root, monkeypatch):
    w1, eng1, _ = _tiny_trainer()
    w1.step, w1.samples_consumed, eng1.version = 5, 20, 5
    w1.save_recover_checkpoint()
    committed = _leaves(eng1)
    actor_dir = os.path.join(constants.get_recover_root(), "trainer", "actor")
    assert recover.is_committed(actor_dir)
    # the run advances, then dies after staging the next checkpoint
    eng1.init_random(3)
    eng1._step += 7
    w1.step, eng1.version = 12, 12

    def crash(*a, **k):
        raise RuntimeError("killed mid-save")

    monkeypatch.setattr(recover, "commit_checkpoint", crash)
    with pytest.raises(RuntimeError, match="mid-save"):
        w1.save_recover_checkpoint()
    monkeypatch.undo()
    monkeypatch.setenv("AREAL_FILEROOT", str(root))
    assert recover.read_manifest(actor_dir)["version"] == 5
    # restart the world: scrambled engine, fresh worker
    eng1.init_random(9)
    eng1.version = 0
    w2, eng2, _ = _tiny_trainer(eng=eng1)
    assert w2.load_recover_checkpoint()
    assert w2.step == 5 and eng2.version == 5 and w2.samples_consumed == 20
    assert _same(committed, _leaves(eng2))
    assert _announced_version()[0] == 5
    # the staged leftover was cleaned when the commit was resolved
    assert not [d for d in os.listdir(os.path.dirname(actor_dir))
                if ".tmp-" in d]


def test_uncommitted_checkpoint_gives_a_fresh_start(root, monkeypatch):
    w1, eng1, _ = _tiny_trainer()
    w1.step = 2
    monkeypatch.setattr(recover, "commit_checkpoint",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("killed mid-save")))
    with pytest.raises(RuntimeError):
        w1.save_recover_checkpoint()
    monkeypatch.undo()
    monkeypatch.setenv("AREAL_FILEROOT", str(root))
    # a RecoverInfo exists: the engine checkpoint's validation gates it
    recover.dump(recover.RecoverInfo(samples_consumed=8))
    before = _leaves(eng1)
    w2, _, _ = _tiny_trainer(eng=eng1)
    assert not w2.load_recover_checkpoint()
    assert _same(before, _leaves(eng1))
    assert w2.step == 0 and w2.samples_consumed == 0


def test_trainer_recover_round_trip_republishes(root):
    w1, eng1, _ = _tiny_trainer()
    w1.step, w1.samples_consumed, eng1.version = 7, 28, 7
    w1.save_recover_checkpoint()
    saved = _leaves(eng1)
    eng1.init_random(1)
    eng1.version = 0
    w2, eng2, stream2 = _tiny_trainer(eng=eng1)
    assert not _same(saved, _leaves(eng2))
    assert w2.load_recover_checkpoint()
    assert (w2.step, w2.samples_consumed, eng2.version) == (7, 28, 7)
    assert _same(saved, _leaves(eng2))
    assert stream2.cleared
    version, path = _announced_version()
    assert version == 7 and recover.is_committed(path)
    assert name_resolve.get(names.training_samples(EXP, TRIAL)) == "28"


def test_stale_recover_info_version_cannot_win(root):
    w1, eng1, _ = _tiny_trainer()
    w1.step, eng1.version = 6, 6
    w1.save_recover_checkpoint()
    info = recover.load()
    info.model_version = 2
    recover.dump(info)
    eng1.version = 0
    w2, eng2, _ = _tiny_trainer(eng=eng1)
    assert w2.load_recover_checkpoint()
    assert eng2.version == 6
    assert _announced_version()[0] == 6


# --------------------------------------------------------------------------- #
# guardrail rollback and preemption
# --------------------------------------------------------------------------- #


def test_consecutive_anomalies_roll_back_and_republish(root):
    w, eng, stream = _tiny_trainer()
    w.step, eng.version = 4, 4
    w.save_recover_checkpoint()
    committed = _leaves(eng)
    eng.init_random(7)
    eng.version = 6
    k = w.control.guard_rollback_steps
    assert k >= 2
    now = time.time()
    w._pending_stats = [(i, now, {"guard/step_ok": 0.0}) for i in range(k - 1)]
    w.flush_stats()
    assert w._consec_anomalies == k - 1 and not stream.cleared
    w._pending_stats = [(k, now, {"guard/step_ok": 1.0})]
    w.flush_stats()
    assert w._consec_anomalies == 0
    w._pending_stats = [(k + 1 + i, now, {"guard/step_ok": 0.5})
                        for i in range(k)]
    w.flush_stats()
    w._join_publish()
    assert w._consec_anomalies == 0
    assert _same(committed, _leaves(eng))
    # a NEW version above the live one: the manager drops a version <= its
    assert eng.version == 7
    assert _announced_version()[0] == 7
    assert stream.cleared


def test_rollback_without_a_commit_keeps_training(root):
    w, eng, stream = _tiny_trainer()
    before = _leaves(eng)
    w._pending_stats = [(i, time.time(), {"guard/step_ok": 0.0})
                        for i in range(w.control.guard_rollback_steps)]
    w.flush_stats()
    assert w._consec_anomalies == 0 and _same(before, _leaves(eng))
    assert not stream.cleared


def test_preemption_commits_and_sets_the_distinct_code(root):
    w, eng, _ = _tiny_trainer()
    w.step, eng.version = 3, 3
    shutdown = worker_base.GracefulShutdown(deadline_s=30.0, install=False)
    shutdown.request()
    assert w.run(shutdown=shutdown) == 3
    assert w.preempted
    actor_dir = os.path.join(constants.get_recover_root(), "trainer", "actor")
    m = recover.read_manifest(actor_dir)
    assert m is not None and m["version"] == 3
    assert _announced_version()[0] == 3
    assert recover.load().recover_start.global_step == 3
    assert worker_base.EXIT_PREEMPTED not in (0, 1)
    assert len({worker_base.EXIT_PREEMPTED, worker_base.EXIT_WATCHDOG,
                worker_base.EXIT_WORLD_FAILED}) == 3
    assert 0 < shutdown.remaining() <= 30.0


def test_graceful_shutdown_handles_a_real_sigterm():
    shutdown = worker_base.GracefulShutdown(deadline_s=5.0)
    try:
        assert not shutdown.should_stop()
        assert shutdown.remaining() == float("inf")
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not shutdown.should_stop() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert shutdown.should_stop()
        assert shutdown.remaining() <= 5.0
    finally:
        shutdown.uninstall()


def test_hang_watchdog_dumps_once_per_stall():
    dumps = []
    wd = worker_base.HangWatchdog("t", timeout_s=0.1, poll_interval=0.02,
                                  on_dump=dumps.append).start()
    try:
        deadline = time.monotonic() + 5
        while not dumps and time.monotonic() < deadline:
            time.sleep(0.01)
        assert dumps and dumps[0] > 0.1
        for _ in range(20):
            wd.bump()
            time.sleep(0.01)
        assert wd.dumps <= 2
    finally:
        wd.stop()


def test_experiment_status_watch(root):
    watch = worker_base.ExperimentStatusWatch(EXP, TRIAL, timeout=0.05,
                                              poll_interval=0.0)
    worker_base.mark_experiment_running(EXP, TRIAL)
    assert watch.alive() and not worker_base.experiment_stopped(EXP, TRIAL)
    worker_base.mark_experiment_stopped(EXP, TRIAL)
    assert worker_base.experiment_stopped(EXP, TRIAL)
    assert not watch.alive()
    missing = worker_base.ExperimentStatusWatch(EXP, "other", timeout=0.05,
                                                poll_interval=0.0)
    assert missing.alive()
    time.sleep(0.1)
    assert not missing.alive()
    hb = worker_base.Heartbeat(EXP, TRIAL, "w0", interval=0.01).start()
    try:
        deadline = time.monotonic() + 5
        while (worker_base.last_heartbeat(EXP, TRIAL, "w0") is None
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert worker_base.last_heartbeat(EXP, TRIAL, "w0") > 0
    finally:
        hb.stop()
