"""Single-step math/code verification environment (the counterpart of
``areal_tpu/envs/math_code_single_step.py``): one step takes ``(qid,
answers)`` and returns per-answer binary success from the local verifiers.
Task metadata (ground-truth solutions / test cases) comes from the
dataset's qid -> metadata map.

Not ported yet, and raising ``NotImplementedError`` (see ``ROADMAP.md``):
the remote sandbox verifier (``AREAL_ENABLE_FUNCTION_CALL`` with
``AREAL_FUNCTIONCALL_SERVICE_DOMAIN``) and the ``tool_use`` and ``gpqa``
graders.
"""

import asyncio
from typing import Dict, Tuple

from areal_tpu_torch.api.env import EnvironmentService
from areal_tpu_torch.base import constants
from areal_tpu_torch.rewards import code_verify, math_verify


def remote_verifier_enabled() -> bool:
    """``AREAL_ENABLE_FUNCTION_CALL`` with a service domain set: the
    reference routes math/code grading to its remote sandbox."""
    return constants.env_flag("AREAL_ENABLE_FUNCTION_CALL", False) and bool(
        constants.env_str("AREAL_FUNCTIONCALL_SERVICE_DOMAIN", ""))


class MathCodeSingleStepEnv(EnvironmentService):
    def __init__(self, dataset_metadata: Dict[str, dict], timeout: float = 100.0):
        # qid -> {"task": "math"|"code", "solutions": [...] | "input_output": {...}}
        self.metadata = dataset_metadata
        self.timeout = timeout

    async def reset(self, seed=None, options=None):
        return None, {}

    async def step(self, action: Tuple) -> Tuple:
        qid, answers = action
        meta = self.metadata[str(qid)]
        task = meta.get("task", "math")
        if task in ("tool_use", "gpqa"):
            raise NotImplementedError(
                f"the {task} grader is not ported yet (ROADMAP.md)")
        if remote_verifier_enabled():
            raise NotImplementedError(
                "the remote sandbox verifier (rewards/remote.py) is not "
                "ported yet (ROADMAP.md)")
        loop = asyncio.get_running_loop()
        if task == "math":
            fn, gold = math_verify.verify_math_solution, meta["solutions"]
        else:
            fn, gold = code_verify.verify_code_solution, meta["input_output"]
        # return_exceptions: a verifier crashing on one pathological answer
        # grades that answer False; its siblings keep their scores
        success = await asyncio.gather(
            *(loop.run_in_executor(None, fn, a, gold) for a in answers),
            return_exceptions=True,
        )
        return None, [
            bool(s) and not isinstance(s, BaseException) for s in success
        ], True, False, {}
