"""Agent API: the trajectory-collection contract and its registry (a copy
of ``areal_tpu/api/agent.py``). An agent talks to the generation fleet
through two asyncio queues: it puts observations ``(qid, prompt_ids,
gen_hyperparams)`` on ``obs_queue`` and awaits ``BundledGenerationOutputs``
on ``act_queue``; the ``PartialRolloutManager`` sits on the other side of
both.
"""

import abc
import asyncio
import dataclasses
from typing import Dict, List, Optional

from areal_tpu_torch.api.data import SequenceSample


class GenerationFailedError(RuntimeError):
    """The fleet failed to produce this prompt's group even after client
    retries and chunk re-scheduling. Agents raise it on ``bundle.error`` so
    the rollout worker requeues the sample instead of dropping it."""


@dataclasses.dataclass
class BundledGenerationOutputs:
    """The grouped result of one prompt's n samples, with per-sample
    version tags for staleness accounting."""

    qid: str
    prompt_ids: List[int]
    output_ids: List[List[int]]        # n samples, generated tokens only
    logprobs: List[List[float]]        # aligned with output_ids
    no_eos: List[bool]                 # True = truncated by length
    version_start: List[int]           # weight version of the first chunk
    version_end: List[int]             # weight version of the last chunk
    # set when generation failed (outputs are empty placeholders)
    error: Optional[str] = None
    # lifecycle stamps (unix seconds; 0.0 = unstamped): when the group was
    # submitted to the fleet and when its first chunk came back
    submit_time: float = 0.0
    first_chunk_time: float = 0.0

    @property
    def seqs(self) -> List[List[int]]:
        return [self.prompt_ids + o for o in self.output_ids]


class Agent(abc.ABC):
    @abc.abstractmethod
    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        ...


ALL_AGENTS: Dict[str, type] = {}


def register_agent(name: str, cls: type):
    assert name not in ALL_AGENTS, name
    ALL_AGENTS[name] = cls


def make_agent(name: str, **kwargs) -> Agent:
    import areal_tpu_torch.agents  # noqa: F401  (triggers registration)

    return ALL_AGENTS[name](**kwargs)
