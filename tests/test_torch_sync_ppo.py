"""The port's sync-PPO loop (``areal_tpu_torch/system/sync_trainer.py``)
against ``areal_tpu``'s, on the tiny arch of ``tests/test_sync_ppo.py``.

- ``build_group_sample`` lays a group out exactly as the reference does
  (the reference's layout test, and both packages' outputs on one group);
- ``math_reward_fn`` grades as the reference's;
- two end-to-end ``run_step``s through the worker (the graph is
  ``["actor_train"]``: fresh logprobs are proximal), with finite loss,
  rewards in [-1, 1] and the sequence count;
- 20 sync-PPO steps raise the mean reward by more than 0.3 (the
  reference's threshold) on a synthetic verifiable reward;
- a save at ``save_freq_steps`` and the ``sync_ppo/`` metrics lines.
"""

import json
import os

import numpy as np
import pytest
import torch

from areal_tpu.system import sync_trainer as jax_sync
from areal_tpu.train.generation import SyncGenOutput as JaxSyncGenOutput
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import GenerationHyperparameters, PPOHyperparameters
from areal_tpu_torch.base import constants
from areal_tpu_torch.base.metrics import MetricLogger
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.system import sync_trainer
from areal_tpu_torch.system.sync_trainer import SyncPPOTrainerWorker, build_group_sample
from areal_tpu_torch.system.trainer_worker import TrainerControl
from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine
from areal_tpu_torch.train.generation import SyncGenOutput


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = ModelConfig(
    n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8, hidden_dim=32,
    intermediate_dim=64, vocab_size=128, dtype="float32",
)


@pytest.fixture(scope="module")
def actor():
    eng = TrainEngine(TINY, optimizer=OptimizerConfig(lr=1e-3), device="cpu")
    eng.init_random(0)
    eng.setup_optimizer(total_train_steps=20)
    return eng


class FakePromptDataset:
    """Minimal prompt dataset: qid -> fixed token prompt + metadata."""

    def __init__(self, n=4, plen=5):
        self.n, self.plen = n, plen
        self.metadata = {str(i): {"solutions": ["42"]} for i in range(n)}

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        ids = np.arange(1, self.plen + 1, dtype=np.int64) + i
        return SequenceSample(
            keys={"packed_prompts"},
            ids=[str(i)],
            seqlens={"packed_prompts": [[self.plen]]},
            data={"packed_prompts": ids},
        )


def _outs(cls):
    return [
        cls(tokens=np.asarray([1, 2, 3, 10, 11], np.int64),
            gen_logprobs=np.asarray([-0.5, -0.7], np.float32), no_eos=False),
        cls(tokens=np.asarray([1, 2, 3, 20], np.int64),
            gen_logprobs=np.asarray([-0.2], np.float32), no_eos=True),
    ]


def test_build_group_sample_layout():
    s = build_group_sample("q0", _outs(SyncGenOutput), prompt_len=3,
                           rewards=[1.0, -1.0])
    assert s.seqlens["packed_input_ids"] == [[5, 4]]
    lp = s.data["packed_logprobs"]
    # token-aligned: logprob of token t at position t-1, zero elsewhere
    np.testing.assert_allclose(lp[:5], [0, 0, -0.5, -0.7, 0])
    np.testing.assert_allclose(lp[5:], [0, 0, -0.2, 0])
    np.testing.assert_array_equal(s.data["seq_no_eos_mask"], [False, True])
    want = jax_sync.build_group_sample("q0", _outs(JaxSyncGenOutput),
                                       prompt_len=3, rewards=[1.0, -1.0])
    assert s.keys == want.keys and s.ids == want.ids
    assert s.seqlens == want.seqlens
    for k in want.keys:
        np.testing.assert_array_equal(s.data[k], want.data[k])
        assert s.data[k].dtype == want.data[k].dtype, k


@pytest.mark.parametrize("answers,solutions", [
    (["the answer is \\boxed{42}", "\\boxed{41}", "42"], ["42"]),
    (["\\boxed{\\frac{1}{2}}", "\\boxed{0.5}", "no"], ["\\frac12"]),
])
def test_math_reward_fn_matches_the_reference(answers, solutions):
    meta = {"solutions": solutions}
    assert sync_trainer.math_reward_fn("q", answers, meta) == \
        jax_sync.math_reward_fn("q", answers, meta)


def test_e2e_steps(actor, tmp_path, monkeypatch):
    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path))
    constants.set_experiment_trial_names("test_sync", "trial0")
    metrics = MetricLogger(str(tmp_path / "logs"), backends=("jsonl",))
    worker = SyncPPOTrainerWorker(
        "test_sync", "trial0",
        actor_engine=actor,
        dataset=FakePromptDataset(),
        hp=PPOHyperparameters(
            disable_value=True,
            use_decoupled_loss=False,
            recompute_logprob=False,
            kl_ctl=0.0,
        ),
        ghp=GenerationHyperparameters(n=2, max_new_tokens=8),
        control=TrainerControl(total_train_steps=2, save_freq_steps=2),
        batch_size=2,
        mb_spec=MicroBatchSpec(),
        metric_logger=metrics,
    )
    # the sync graph has no inference nodes: fresh logprobs ARE proximal
    assert worker.executor.graph.names == ["actor_train"]
    version0 = actor.version
    s1 = worker.run_step()
    s2 = worker.run_step()
    metrics.close()
    assert np.isfinite(s1["actor_loss"]) and np.isfinite(s2["actor_loss"])
    assert -1.0 <= s1["reward_mean"] <= 1.0
    assert s1["n_seqs_consumed"] == 4
    assert worker.step == 2 and actor.version == version0 + 2
    assert s1["timeperf/e2e"] >= s1["timeperf/gen"] > 0
    # one program for the key, every decode step counted (eager on the CPU)
    assert worker.generator.n_compiles() == 1
    assert worker.generator.stats["decode_steps"] == 2 * 7
    save = os.path.join(constants.get_save_root(), "step2")
    assert os.path.exists(os.path.join(save, "model.safetensors"))
    lines = [json.loads(l) for l in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert np.isfinite(lines[-1]["sync_ppo/actor_loss"])
    assert "sync_ppo/reward_mean" in lines[-1]


def test_reward_rises_over_training():
    """Port of ``TestSyncPPOConvergence``: a tiny model and a synthetic
    verifiable reward (the fraction of generated token ids < 64, mapped to
    [-1, 1]); 20 sync-PPO steps must raise the mean reward by more than
    0.3, the reference's threshold."""

    def reward_fn(qid, answers, metadata):
        out = []
        for a in answers:
            toks = [int(t) for t in a.split()] or [0]
            out.append(2.0 * float(np.mean([t < 64 for t in toks])) - 1.0)
        return out

    eng = TrainEngine(TINY, optimizer=OptimizerConfig(lr=3e-2), device="cpu")
    eng.init_random(0)
    eng.setup_optimizer(30)
    worker = SyncPPOTrainerWorker(
        "conv", "t0",
        actor_engine=eng,
        dataset=FakePromptDataset(n=4, plen=4),
        hp=PPOHyperparameters(
            disable_value=True, use_decoupled_loss=False,
            recompute_logprob=False, kl_ctl=0.0, adv_norm=True,
            ppo_n_minibatches=1,
        ),
        ghp=GenerationHyperparameters(n=4, max_new_tokens=6),
        control=TrainerControl(
            total_train_steps=20, ckpt_freq_steps=None, ckpt_freq_secs=None,
        ),
        batch_size=4,
        mb_spec=MicroBatchSpec(),
        reward_fn=reward_fn,
        seed=3,
    )
    rewards = [worker.run_step()["reward_mean"] for _ in range(20)]
    first, last = np.mean(rewards[:5]), np.mean(rewards[-5:])
    assert last > first + 0.3, (
        f"mean reward did not rise: first5={first:.3f} last5={last:.3f} "
        f"trace={np.round(rewards, 3).tolist()}"
    )
