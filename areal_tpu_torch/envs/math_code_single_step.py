"""Single-step math/code verification environment (the counterpart of
``areal_tpu/envs/math_code_single_step.py``): one step takes ``(qid,
answers)`` and returns a score per answer. Task metadata (ground-truth
solutions / test cases / answers) comes from the dataset's qid ->
metadata map. By task:

- ``tool_use``: the answer tool call's token F1 (or exact match) plus a
  format bonus, normalised into [0, 1] by the weights' sum
  (``rewards/tool_use.py``); host string math, never remoted;
- ``gpqa``: the choice letter against the gold one, 0 or 1
  (``evaluation/grading.py::grade_gpqa_answer``); never remoted;
- ``math`` and ``code``: binary success, from the remote sandbox when
  ``AREAL_ENABLE_FUNCTION_CALL`` is on with
  ``AREAL_FUNCTIONCALL_SERVICE_DOMAIN`` set (``rewards/remote.py``), else
  from the local verifiers.
"""

import asyncio
from typing import Dict, Tuple

from areal_tpu_torch.api.env import EnvironmentService
from areal_tpu_torch.rewards import code_verify, math_verify, remote


class MathCodeSingleStepEnv(EnvironmentService):
    def __init__(self, dataset_metadata: Dict[str, dict], timeout: float = 100.0):
        # qid -> {"task": "math"|"code"|"tool_use"|"gpqa", "solutions": [...]
        #         | "input_output": {...} | "answer": str}
        self.metadata = dataset_metadata
        self.timeout = timeout

    async def reset(self, seed=None, options=None):
        return None, {}

    async def step(self, action: Tuple) -> Tuple:
        qid, answers = action
        meta = self.metadata[str(qid)]
        task = meta.get("task", "math")
        if task == "tool_use":
            # graded, not binary: scores normalised into [0, 1] so that the
            # filter band and the (s - 0.5) * 2 reward stay well-defined
            from areal_tpu_torch.rewards import tool_use

            cw, fw = 1.0, 0.2
            scores = [
                tool_use.tool_use_reward(
                    a,
                    str(meta.get("answer", "")),
                    correctness_weight=cw,
                    format_weight=fw,
                    scoring_method=meta.get("scoring_method", "f1"),
                )
                / (cw + fw)
                for a in answers
            ]
            return None, scores, True, False, {}
        if task == "gpqa":
            # multiple choice must not fall through to the code branch
            # (no input_output in a gpqa row)
            from areal_tpu_torch.evaluation.grading import grade_gpqa_answer

            golds = meta.get("solutions") or []
            scores = [grade_gpqa_answer(a, golds) for a in answers]
            return None, scores, True, False, {}
        if remote.enabled():
            qids = [str(qid)] * len(answers)
            if task == "math":
                success = await remote.math_verify_remote(
                    answers, [meta["solutions"]] * len(answers), qids)
            else:
                success = await remote.code_verify_remote(answers, qids)
        else:
            loop = asyncio.get_running_loop()
            if task == "math":
                fn, gold = math_verify.verify_math_solution, meta["solutions"]
            else:
                fn, gold = (code_verify.verify_code_solution,
                            meta["input_output"])
            # return_exceptions: a verifier crashing on one pathological
            # answer grades that answer False; its siblings keep their scores
            success = await asyncio.gather(
                *(loop.run_in_executor(None, fn, a, gold) for a in answers),
                return_exceptions=True,
            )
        return None, [
            bool(s) and not isinstance(s, BaseException) for s in success
        ], True, False, {}
