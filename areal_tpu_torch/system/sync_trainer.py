"""Sync-PPO trainer: generate -> verify -> train in one loop, one model copy
(counterpart of ``areal_tpu/system/sync_trainer.py``).

Rollouts come from the trainer's own current weights
(``train/generation.py::SyncGenerator``), so off-policyness is exactly
zero: the staleness-ablation control for async experiments. The PPO
update is the same declared MFC graph the async trainer runs
(``experiments/graphs.build_ppo_graph``); only the data source differs.

The port runs one process on one device, so the reference's
``multihost.is_main()`` is always true here. A step whose update the
engine's guard skipped (``guard/step_ok`` < 1) is logged, as the port's
``AsyncPPOTrainerWorker`` logs it; the process-global guard counters wait
for the telemetry twin (``ROADMAP.md``).
"""

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.dataset import dataset_metadata
from areal_tpu_torch.api.model import GenerationHyperparameters, PPOHyperparameters
from areal_tpu_torch.base import constants
from areal_tpu_torch.base.metrics import MetricLogger
from areal_tpu_torch.experiments import graphs
from areal_tpu_torch.rewards.math_verify import grade_math_answers
from areal_tpu_torch.system.function_executor import FunctionExecutor
from areal_tpu_torch.system.trainer_worker import TrainerControl
from areal_tpu_torch.train.engine import TrainEngine, fetch_stats_dict
from areal_tpu_torch.train.generation import SyncGenerator, SyncGenOutput

logger = logging.getLogger("areal_tpu_torch.sync_trainer")

# reward_fn(qid, decoded_answers, metadata) -> per-sample rewards in [-1, 1]
RewardFn = Callable[[str, List[str], dict], List[float]]


def math_reward_fn(qid: str, answers: List[str], metadata: dict) -> List[float]:
    return grade_math_answers(answers, metadata.get("solutions", []))


def build_group_sample(
    qid: str,
    outs: Sequence[SyncGenOutput],
    prompt_len: int,
    rewards: Sequence[float],
) -> SequenceSample:
    """Assemble one grouped trajectory sample in the rollout-stream layout
    (the keys and alignment of ``agents/math_single_step.py``:
    token-aligned logprobs, prompt mask, per-sequence reward and no-eos
    scalars)."""
    n = len(outs)
    seqlens = [len(o.tokens) for o in outs]
    logprobs = []
    for o in outs:
        lp = np.zeros(len(o.tokens), np.float32)
        lp[prompt_len - 1 : prompt_len - 1 + len(o.gen_logprobs)] = o.gen_logprobs
        logprobs.append(lp)
    return SequenceSample(
        keys={
            "packed_input_ids", "prompt_mask", "packed_logprobs",
            "seq_no_eos_mask", "rewards",
        },
        ids=[qid],
        seqlens={
            "packed_input_ids": [seqlens],
            "prompt_mask": [seqlens],
            "packed_logprobs": [seqlens],
            "seq_no_eos_mask": [[1] * n],
            "rewards": [[1] * n],
        },
        data={
            "packed_input_ids": np.concatenate([o.tokens for o in outs]),
            "prompt_mask": np.concatenate(
                [
                    np.r_[np.ones(prompt_len, np.bool_),
                          np.zeros(sl - prompt_len, np.bool_)]
                    for sl in seqlens
                ]
            ),
            "packed_logprobs": np.concatenate(logprobs),
            "seq_no_eos_mask": np.asarray([o.no_eos for o in outs], np.bool_),
            "rewards": np.asarray(rewards, np.float32),
        },
    )


class SyncPPOTrainerWorker:
    """Generate-on-trainer PPO (the reference's sync mode).

    ``dataset`` yields prompt samples (``packed_prompts`` key) and, for the
    default math reward, exposes per-qid metadata with solutions
    (``MathCodePromptDataset``). ``decode_fn`` turns generated token ids
    into answer text for the verifier (token ids joined by spaces by
    default, as in the agents' test mode).
    """

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        actor_engine: TrainEngine,
        dataset,
        hp: PPOHyperparameters,
        ghp: GenerationHyperparameters,
        control: TrainerControl,
        batch_size: int = 8,               # prompts per step
        mb_spec: Optional[MicroBatchSpec] = None,
        ref_engine: Optional[TrainEngine] = None,
        critic_engine: Optional[TrainEngine] = None,
        ema_ref_eta: Optional[float] = None,
        reward_fn: RewardFn = math_reward_fn,
        decode_fn: Optional[Callable[[List[int]], str]] = None,
        hf_family: str = "qwen2",
        metric_logger: Optional[MetricLogger] = None,
        seed: int = 0,
    ):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.actor_engine = actor_engine
        self.dataset = dataset
        self.hp = hp
        self.ghp = ghp
        self.control = control
        self.batch_size = batch_size
        self.mb_spec = mb_spec or MicroBatchSpec(max_tokens_per_mb=16384)
        self.reward_fn = reward_fn
        self.decode_fn = decode_fn or (lambda ids: " ".join(map(str, ids)))
        self.hf_family = hf_family
        self.metrics = metric_logger
        self.seed = seed

        graph, interfaces = graphs.build_ppo_graph(
            hp,
            use_ref=ref_engine is not None,
            use_critic=critic_engine is not None,
            ema_ref_eta=ema_ref_eta,
            mb_spec=self.mb_spec,
            hf_family=hf_family,
        )
        engines = {"actor": actor_engine}
        if ref_engine is not None:
            engines["ref"] = ref_engine
        if critic_engine is not None:
            engines["critic"] = critic_engine
        self.executor = FunctionExecutor(
            graph, engines, interfaces, default_mb_spec=self.mb_spec
        )
        self.generator = SyncGenerator(actor_engine)
        self.step = 0
        self._order: List[int] = []

    # ------------------------------------------------------------------ #

    def _next_prompt_indices(self) -> List[int]:
        out = []
        while len(out) < min(self.batch_size, len(self.dataset)):
            if not self._order:
                rng = np.random.RandomState(self.seed + self.step)
                self._order = list(rng.permutation(len(self.dataset)))
            out.append(self._order.pop())
        return out

    def run_step(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        idxs = self._next_prompt_indices()
        prompt_samples = [self.dataset[i] for i in idxs]
        qids = [s.ids[0] for s in prompt_samples]
        prompts = [
            np.asarray(s.data["packed_prompts"]).tolist() for s in prompt_samples
        ]
        groups = self.generator.generate(
            prompts, self.ghp, seed=self.seed * 100003 + self.step
        )
        t_gen = time.perf_counter() - t0

        metadata = dataset_metadata(self.dataset)
        items, rewards_flat = [], []
        for qid, plist, group in zip(qids, prompts, groups):
            answers = [
                self.decode_fn(o.tokens[len(plist):].tolist()) for o in group
            ]
            rws = self.reward_fn(str(qid), answers, metadata.get(str(qid), {}))
            rewards_flat.extend(rws)
            items.append(build_group_sample(qid, group, len(plist), rws))
        batch = SequenceSample.gather(items)

        # the sync loop blocks on generation every step anyway: pull every
        # device scalar in ONE transfer and keep per-step host floats
        stats = fetch_stats_dict(self.executor.run(batch))
        # the poisoned update was already skipped on the device; sync PPO
        # generates from the trainer's own params, so the skip also keeps
        # the next rollout batch off poisoned weights
        if float(stats.get("guard/step_ok", 1.0)) < 1.0:
            logger.warning(
                "step %d: non-finite loss/grad_norm; optimizer update was "
                "skipped on device", self.step,
            )
        stats["timeperf/gen"] = t_gen
        stats["timeperf/e2e"] = time.perf_counter() - t0
        if "flops" in stats:  # train-side FLOPs only (gen not counted)
            stats["tflops_per_sec"] = (
                stats.pop("flops") / max(stats["timeperf/e2e"] - t_gen, 1e-9) / 1e12
            )
        stats["reward_mean"] = float(np.mean(rewards_flat))
        stats["n_seqs_consumed"] = sum(len(g) for g in groups)
        self.step += 1

        if (
            self.control.save_freq_steps
            and self.step % self.control.save_freq_steps == 0
        ):
            self.actor_engine.save_hf(
                os.path.join(constants.get_save_root(), f"step{self.step}"),
                self.hf_family,
            )
        if self.metrics is not None:
            self.metrics.log(
                {k: v for k, v in stats.items() if np.isscalar(v)},
                self.step,
                prefix="sync_ppo",
            )
        return stats

    def run(self):
        while self.step < self.control.total_train_steps:
            self.run_step()
        return self.step
