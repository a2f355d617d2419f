"""Port parity: the async PPO trainer worker of ``areal_tpu_torch``
(``system/trainer_worker.py``) against ``areal_tpu``'s on the CPU.

The slice as a whole: a JAX ``AsyncPPOTrainerWorker`` and the port's take
two ``run_step``s each from identical streams of ``SequenceSample``s made
with numpy from one seed (GRPO groups of 2, random rewards so the
gradients are not zero, one over-stale group the buffers must drop), on
the same initial params (a tiny float32 model, as
``tests/test_torch_train.py``). Held equal:

- the step stats (actor loss, grad norm, importance weight, clip ratio,
  approx KL, token and sequence counts): rtol 1e-4;
- the params after each step: atol 1% of lr per step (Adam divides by
  sqrt(v), so summation-order noise in near-zero gradients grows up to
  ~lr in the update);
- the ``model_version`` announcements (``1:`` then ``2:``), the
  ``training_samples`` counter (8 then 16 groups), the buffers' drop
  counts, and each committed HF export loaded back (same tolerance).

Also: intake drops over-stale and malformed trajectories (the latter
loudly), the stats flush cadence with per-step wall times in
``metrics.jsonl``, and a failed background publish surfacing on join.
"""

import json
import logging
import os

import numpy as np
import pytest

import jax
import torch

from areal_tpu.api import data as jax_data
from areal_tpu.api import model as jax_model
from areal_tpu.base import constants as jax_constants
from areal_tpu.base import name_resolve as jax_nr
from areal_tpu.base import names as jax_names
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu.system import trainer_worker as jax_tw
from areal_tpu.train import engine as jax_engine
from areal_tpu_torch.api import data as pt_data
from areal_tpu_torch.api import model as pt_model
from areal_tpu_torch.base import constants as pt_constants
from areal_tpu_torch.base import name_resolve as pt_nr
from areal_tpu_torch.base import names as pt_names
from areal_tpu_torch.base import recover as pt_recover
from areal_tpu_torch.base.metrics import MetricLogger
from areal_tpu_torch.models import hf as pt_hf
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig
from areal_tpu_torch.system import trainer_worker as pt_tw
from areal_tpu_torch.train import engine as pt_engine

MODEL = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
             hidden_dim=32, intermediate_dim=64, vocab_size=128,
             dtype="float32", use_attention_bias=True)
LR = 1e-3
EXP = "parity"
HP = dict(ppo_n_minibatches=2, use_decoupled_loss=True, kl_ctl=0.0,
          adv_norm=True, disable_value=True)
BATCH = 8       # groups per step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Both packages' file roots in ``tmp_path``, each package under its
    own trial, both name_resolve stores in memory and empty."""
    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path))
    monkeypatch.setenv("AREAL_TRAIN_PREFETCH", "1")
    jax_constants.set_experiment_trial_names(EXP, "jax")
    pt_constants.set_experiment_trial_names(EXP, "torch")
    saved = pt_nr.default_repository()
    pt_nr.set_repository(pt_nr.MemoryNameRecordRepository())
    jax_nr.reset()
    yield tmp_path
    pt_nr.set_repository(saved)
    jax_nr.reset()


class ListStream:
    """The puller stream's surface over a fixed list of samples."""

    def __init__(self, samples):
        self.samples = list(samples)
        self.cleared = 0

    def get_batch(self, n, timeout=0.1):
        out, self.samples = self.samples[:n], self.samples[n:]
        return out

    def clear(self):
        n, self.samples = len(self.samples), []
        self.cleared += n
        return n

    def qsize(self):
        return len(self.samples)


def _group(mod, rng, qid, version=0, group=2, drop=()):
    """One GRPO group (an item of ``group`` sequences) as
    ``mod.SequenceSample``, keys ``drop`` left out."""
    lens, ids, pm, lps = [], [], [], []
    for _ in range(group):
        plen, glen = int(rng.integers(2, 5)), int(rng.integers(3, 9))
        n = plen + glen
        lens.append(n)
        ids.append(rng.integers(0, 128, size=n).astype(np.int64))
        pm.append(np.r_[np.ones(plen, bool), np.zeros(glen, bool)])
        lp = np.zeros(n, np.float32)
        lp[plen - 1:n - 1] = rng.normal(size=glen) * 0.1 - 1.0
        lps.append(lp)
    data = dict(
        packed_input_ids=np.concatenate(ids), prompt_mask=np.concatenate(pm),
        packed_logprobs=np.concatenate(lps),
        rewards=rng.normal(size=group).astype(np.float32),
        seq_no_eos_mask=np.zeros(group, bool),
        version_start=np.full(group, version, np.int32),
    )
    per_seq = ("rewards", "seq_no_eos_mask", "version_start")
    data = {k: v for k, v in data.items() if k not in drop}
    return mod.SequenceSample(
        keys=set(data), ids=[qid],
        seqlens={k: [[1] * group] if k in per_seq else [lens] for k in data},
        data=data,
    )


def _stream_samples(mod, seed, n_groups, stale_at=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_groups):
        if i == stale_at:
            out.append(_group(mod, rng, f"stale{i}", version=-5))
        out.append(_group(mod, rng, f"q{i}"))
    return out


def _engines(seed=0):
    j = jax_engine.TrainEngine(
        JaxConfig(**MODEL), optimizer=jax_engine.OptimizerConfig(lr=LR)
    ).init_random(seed)
    p = pt_engine.TrainEngine(
        PtConfig(**MODEL), optimizer=pt_engine.OptimizerConfig(lr=LR),
        device="cpu",
    ).load_params(jax.device_get(j.params))
    return j.setup_optimizer(100), p.setup_optimizer(100)


def _worker(pkg, eng, stream, trial, **kw):
    tw, model, data = pkg
    control = tw.TrainerControl(
        total_train_steps=2, ckpt_freq_steps=None, ckpt_freq_secs=None,
        weight_sync_freq_steps=1, **kw.pop("control", {}))
    return tw.AsyncPPOTrainerWorker(
        experiment_name=EXP, trial_name=trial, actor_engine=eng,
        stream=stream, hp=model.PPOHyperparameters(**HP), control=control,
        train_batch_size=BATCH,
        mb_spec=data.MicroBatchSpec(max_tokens_per_mb=96),
        hf_family="qwen2", max_head_offpolicyness=1, **kw)


JAX = (jax_tw, jax_model, jax_data)
PT = (pt_tw, pt_model, pt_data)


def _flat(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_close(want_tree, got_tree, atol):
    want, got = _flat(want_tree), _flat(got_tree)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(k))


STAT_KEYS = ("actor_loss", "grad_norm", "importance_weight",
             "actor_clip_ratio", "approx_kl", "loss", "n_tokens",
             "n_seqs_consumed", "n_seqs", "guard/step_ok", "lr")


def test_two_run_steps_match_the_reference(roots):
    jeng, peng = _engines(seed=2)
    jw = _worker(JAX, jeng, ListStream(_stream_samples(jax_data, 7, 16, 3)),
                 "jax")
    pw = _worker(PT, peng, ListStream(_stream_samples(pt_data, 7, 16, 3)),
                 "torch")
    for step in (1, 2):
        jst, pst = jw.run_step(), pw.run_step()
        jw._join_publish()
        pw._join_publish()
        for k in STAT_KEYS:
            np.testing.assert_allclose(pst[k], float(np.asarray(jst[k])),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        assert pst["actor_loss"] != 0.0 and pst["grad_norm"] > 0.0
        assert pw.step == jw.step == step
        assert peng.version == jeng.version == step
        _assert_close(jax.device_get(jeng.params),
                      pt_tfm.params_to_numpy(peng.params),
                      atol=0.01 * LR * step)
        # the fleet's view: training_samples in groups, the announce
        jts = jax_nr.get(jax_names.training_samples(EXP, "jax"))
        pts = pt_nr.get(pt_names.training_samples(EXP, "torch"))
        assert pts == jts == str(BATCH * step)
        jv = jax_nr.get(jax_names.model_version(EXP, "jax", "actor"))
        pv = pt_nr.get(pt_names.model_version(EXP, "torch", "actor"))
        assert jv.partition(":")[0] == pv.partition(":")[0] == str(step)
        jpath, ppath = jv.partition(":")[2], pv.partition(":")[2]
        assert os.path.basename(ppath) == os.path.basename(jpath) == f"v{step}"
        assert pt_recover.is_committed(ppath)
        # each committed export, loaded back: the two agree, and each is
        # its engine's params
        _, jexp = pt_hf.load_hf_checkpoint(jpath)
        _, pexp = pt_hf.load_hf_checkpoint(ppath)
        _assert_close(jexp, pexp, atol=0.01 * LR * step)
        _assert_close(pt_tfm.params_to_numpy(peng.params), pexp, atol=0)
    assert pw._buffer.n_dropped_stale == jw._buffer.n_dropped_stale == 1
    assert (pw._buffer.n_dropped_capacity
            == jw._buffer.n_dropped_capacity == 0)
    assert pw.samples_consumed == jw.samples_consumed == 2 * BATCH


def test_intake_drops_over_stale_and_malformed(roots, caplog):
    _, peng = _engines(seed=3)
    rng = np.random.default_rng(0)
    good = [_group(pt_data, rng, f"g{i}") for i in range(3)]
    stale = _group(pt_data, rng, "old", version=-3)
    bad = _group(pt_data, rng, "bad", drop=("rewards",))
    w = _worker(PT, peng, ListStream([]), "torch")
    with caplog.at_level(logging.ERROR, logger="areal_tpu_torch.trainer_worker"):
        w._intake(good[:2] + [stale, bad] + good[2:])
    assert len(w._buffer) == 3
    assert w._buffer.n_dropped_stale == 1
    errors = [r for r in caplog.records if r.levelno == logging.ERROR]
    assert len(errors) == 1 and "missing required keys" in errors[0].message
    assert "rewards" in errors[0].message
    g = w.telemetry_gauges()
    assert g["buffer_depth"] == 3 and g["buffer_dropped_stale"] == 1
    assert g["stream_qsize"] == 0
    # a stream that stays empty ends the batch collection with None
    assert w._collect_batch(timeout=0.0) is not None    # 3 queued groups
    assert w._collect_batch(timeout=0.0) is None


@pytest.mark.parametrize("prefetch,lines_after_step1",
                         [("1", 0), ("0", 1)])
def test_flush_cadence_logs_each_step_with_its_time(roots, monkeypatch,
                                                    prefetch,
                                                    lines_after_step1):
    monkeypatch.setenv("AREAL_TRAIN_PREFETCH", prefetch)
    _, peng = _engines(seed=4)
    log_dir = pt_constants.get_log_root()
    w = _worker(PT, peng, ListStream(_stream_samples(pt_data, 9, 16)),
                "torch", metric_logger=MetricLogger(log_dir),
                control=dict(stats_log_freq_steps=2))
    path = os.path.join(log_dir, "metrics.jsonl")

    def lines():
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]

    w.run_step()
    assert len(lines()) == lines_after_step1
    w.run_step()
    got = lines()
    assert [ln["step"] for ln in got] == [1, 2]
    # each line carries the wall time its own step ended at
    assert got[0]["time"] < got[1]["time"]
    for ln in got:
        for k in ("ppo/actor_loss", "ppo/grad_norm", "ppo/n_tokens",
                  "ppo/timeperf/e2e", "ppo/tflops_per_sec"):
            assert np.isfinite(ln[k]), k
    w._join_publish()


def test_failed_publish_surfaces_on_join(roots, monkeypatch):
    _, peng = _engines(seed=5)
    w = _worker(PT, peng, ListStream([]), "torch")

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(pt_hf, "save_hf_checkpoint", boom)
    w.publish_weights()
    with pytest.raises(RuntimeError, match="publish failed") as e:
        w._join_publish()
    assert isinstance(e.value.__cause__, OSError)
    # nothing was announced, and the next publish starts clean
    with pytest.raises(pt_nr.NameEntryNotFoundError):
        pt_nr.get(pt_names.model_version(EXP, "torch", "actor"))
    monkeypatch.undo()
    w.publish_weights()
    w._join_publish()
    assert pt_nr.get(pt_names.model_version(EXP, "torch", "actor")
                     ).startswith("0:")


def test_elastic_and_reward_model_are_not_ported(roots):
    _, peng = _engines(seed=6)
    w = _worker(PT, peng, ListStream([]), "torch")
    with pytest.raises(NotImplementedError, match="elastic"):
        w.run(elastic=object())
    with pytest.raises(NotImplementedError, match="reward"):
        _worker(PT, peng, ListStream([]), "torch", reward_engine=peng)
