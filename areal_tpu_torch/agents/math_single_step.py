"""Single-step math agent (the counterpart of
``areal_tpu/agents/math_single_step.py``): one prompt -> n samples ->
verify -> one grouped ``SequenceSample``, with the success-rate filter band
and reward scaling.

Layout, as the reference: ``packed_logprobs`` are token-aligned (the
logprob at position t is log p(token t+1), zero outside the generated
span), so a sequence's generated logprobs start at ``plen - 1``.
"""

import asyncio
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np

from areal_tpu_torch.api.agent import (
    Agent,
    BundledGenerationOutputs,
    GenerationFailedError,
)
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.env import EnvironmentService
from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.base import tracing


@dataclasses.dataclass
class MathSingleStepAgent(Agent):
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    tokenizer_path: Optional[str] = None
    answer_save_path: Optional[str] = None
    success_rate_lb: float = 0.0
    success_rate_ub: float = 1.0
    reward_scaling: float = 1.0
    reward_bias: float = 0.0

    def __post_init__(self):
        self.tokenizer = None
        if self.tokenizer_path:
            import transformers

            self.tokenizer = transformers.AutoTokenizer.from_pretrained(
                self.tokenizer_path
            )

    def _decode(self, ids_list: List[List[int]]) -> List[str]:
        if self.tokenizer is None:
            # token-id passthrough (synthetic "text")
            return [" ".join(map(str, ids)) for ids in ids_list]
        return self.tokenizer.batch_decode(
            ids_list, clean_up_tokenization_spaces=False, skip_special_tokens=True
        )

    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env: EnvironmentService,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        await env.reset()
        assert prompt.bs == 1
        prompt_ids = np.asarray(prompt.data["packed_prompts"]).tolist()
        qid = prompt.ids[0]
        birth_time = int(time.time() * 1000)
        await obs_queue.put((qid, prompt_ids, self.gconfig))
        act: BundledGenerationOutputs = await act_queue.get()

        if act.error is not None:
            # fleet failure (not a reward/filter rejection): the rollout
            # worker requeues this sample
            raise GenerationFailedError(f"qid {qid}: {act.error}")
        if all(len(o) == 0 for o in act.output_ids):
            return []
        answers = self._decode(act.output_ids)
        # the reward hop joins the trajectory's trace (this coroutine runs
        # inside the rollout task's activated context)
        with tracing.span("rollout/reward", qid=str(qid)):
            _, success, *_ = await env.step((qid, answers))
        reward_time = time.time()  # lifecycle stamp: reward computed
        rewards = [
            ((float(s) - 0.5) * 2 - self.reward_bias) * self.reward_scaling
            for s in success
        ]
        self._log_rewards(qid, act, answers, success, rewards)

        mean_success = float(np.mean([float(s) for s in success]))
        if not (self.success_rate_lb <= mean_success <= self.success_rate_ub):
            return []

        n = len(act.output_ids)
        seqlens = [len(s) for s in act.seqs]
        plen = len(act.prompt_ids)
        packed_input_ids = np.concatenate(
            [np.asarray(s, np.int64) for s in act.seqs]
        )
        prompt_mask = np.concatenate([
            np.r_[np.ones(plen, np.bool_), np.zeros(sl - plen, np.bool_)]
            for sl in seqlens
        ])
        logprobs = []
        for sl, lps in zip(seqlens, act.logprobs):
            lp = np.zeros(sl, np.float32)
            lp[plen - 1 : plen - 1 + len(lps)] = lps
            logprobs.append(lp)
        sample = SequenceSample(
            keys={
                "packed_input_ids", "prompt_mask", "packed_logprobs",
                "packed_prompts", "seq_no_eos_mask", "rewards",
                "version_start", "version_end", "birth_time",
            },
            ids=[qid],
            seqlens={
                "packed_input_ids": [seqlens],
                "prompt_mask": [seqlens],
                "packed_logprobs": [seqlens],
                "packed_prompts": [[plen]],
                "seq_no_eos_mask": [[1] * n],
                "rewards": [[1] * n],
                "version_start": [[1] * n],
                "version_end": [[1] * n],
                "birth_time": [[1]],
            },
            data={
                "packed_input_ids": packed_input_ids,
                "prompt_mask": prompt_mask,
                "packed_logprobs": np.concatenate(logprobs),
                "packed_prompts": np.asarray(act.prompt_ids, np.int64),
                "seq_no_eos_mask": np.asarray(act.no_eos, np.bool_),
                "rewards": np.asarray(rewards, np.float32),
                "version_start": np.asarray(act.version_start, np.int32),
                "version_end": np.asarray(act.version_end, np.int32),
                "birth_time": np.asarray([birth_time], np.int64),
            },
            # lifecycle stamps ride metadata (host-only, never packed)
            metadata={
                "submit_time": [act.submit_time],
                "first_chunk_time": [act.first_chunk_time],
                "reward_time": [reward_time],
            },
        )
        return [sample]

    def _log_rewards(self, qid, act, answers, success, rewards):
        if not self.answer_save_path:
            return
        os.makedirs(self.answer_save_path, exist_ok=True)
        path = os.path.join(self.answer_save_path, f"v{act.version_start[0]}.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps({
                "qid": str(qid),
                "answers": answers,
                # graded envs return [0, 1] scores; >= 0.5 = success
                "success": [float(s) >= 0.5 for s in success],
                "rewards": rewards,
                "version_start": act.version_start,
                "version_end": act.version_end,
                "seqlens": [len(s) for s in act.seqs],
            }) + "\n")
