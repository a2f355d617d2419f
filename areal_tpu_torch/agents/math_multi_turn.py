"""Multi-turn math agent (the counterpart of
``areal_tpu/agents/math_multi_turn.py``): on a wrong answer, append the
feedback tokens to the whole conversation so far and ask again, until an
answer succeeds or ``max_turns`` are spent. Each turn is one sample with
its own ``<qid>-t<turn>`` id, rewarded ``(s - 0.5) * 2`` (less the bias,
times the scaling) and discounted by ``turn_discount`` per turn.

Layout, as the single-step agent's: ``packed_logprobs`` are token-aligned,
so a turn's generated logprobs start at ``plen - 1``. ``transformers`` is
imported only when ``tokenizer_path`` is set.
"""

import asyncio
import dataclasses
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


@dataclasses.dataclass
class MathMultiTurnAgent(Agent):
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=lambda: GenerationHyperparameters(n=1)
    )
    tokenizer_path: Optional[str] = None
    max_turns: int = 3
    turn_discount: float = 0.9
    feedback_token_ids: List[int] = dataclasses.field(default_factory=list)
    reward_scaling: float = 1.0
    reward_bias: float = 0.0

    def __post_init__(self):
        self.tokenizer = None
        if self.tokenizer_path:
            import transformers

            self.tokenizer = transformers.AutoTokenizer.from_pretrained(
                self.tokenizer_path
            )

    def _decode(self, ids: List[int]) -> str:
        if self.tokenizer is None:
            return " ".join(map(str, ids))
        return self.tokenizer.decode(ids, skip_special_tokens=True)

    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env: EnvironmentService,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        await env.reset()
        assert prompt.bs == 1
        assert self.gconfig.n == 1, "multi-turn agent uses n=1 per turn"
        qid = prompt.ids[0]
        base_prompt = np.asarray(prompt.data["packed_prompts"]).tolist()

        cur_prompt = list(base_prompt)
        discount = 1.0
        samples = []
        for turn in range(self.max_turns):
            await obs_queue.put((f"{qid}-t{turn}", cur_prompt, self.gconfig))
            act: BundledGenerationOutputs = await act_queue.get()
            if act.error is not None:
                # fleet failure: requeue the whole multi-turn sample rather
                # than training on a truncated conversation
                raise GenerationFailedError(f"qid {qid} turn {turn}: {act.error}")
            answer = self._decode(act.output_ids[0])
            _, success, *_ = await env.step((qid, [answer]))
            # graded envs (tool_use) return scores in [0, 1]; >= 0.5 is the
            # success threshold (binary envs are exactly 0/1)
            ok = float(success[0]) >= 0.5
            reward = (
                ((float(success[0]) - 0.5) * 2 - self.reward_bias)
                * self.reward_scaling
                * discount
            )
            seq = act.seqs[0]
            plen = len(cur_prompt)
            sl = len(seq)
            lp = np.zeros(sl, np.float32)
            lp[plen - 1 : plen - 1 + len(act.logprobs[0])] = act.logprobs[0]
            samples.append(
                SequenceSample(
                    keys={
                        "packed_input_ids", "prompt_mask", "packed_logprobs",
                        "seq_no_eos_mask", "rewards", "version_start",
                        "version_end",
                    },
                    ids=[f"{qid}-t{turn}"],
                    seqlens={
                        "packed_input_ids": [[sl]],
                        "prompt_mask": [[sl]],
                        "packed_logprobs": [[sl]],
                        "seq_no_eos_mask": [[1]],
                        "rewards": [[1]],
                        "version_start": [[1]],
                        "version_end": [[1]],
                    },
                    data={
                        "packed_input_ids": np.asarray(seq, np.int64),
                        "prompt_mask": np.r_[
                            np.ones(plen, np.bool_), np.zeros(sl - plen, np.bool_)
                        ],
                        "packed_logprobs": lp,
                        "seq_no_eos_mask": np.asarray(act.no_eos, np.bool_),
                        "rewards": np.asarray([reward], np.float32),
                        "version_start": np.asarray(act.version_start, np.int32),
                        "version_end": np.asarray(act.version_end, np.int32),
                    },
                    # per-turn lifecycle stamps (docs/observability.md)
                    metadata={
                        "submit_time": [act.submit_time],
                        "first_chunk_time": [act.first_chunk_time],
                        "reward_time": [time.time()],
                    },
                )
            )
            if ok:
                break
            cur_prompt = seq + list(self.feedback_token_ids)
            discount *= self.turn_discount
        return samples
