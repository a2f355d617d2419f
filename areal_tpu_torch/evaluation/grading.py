"""Grading conventions shared by the rollout environment and the offline
evaluator (the counterpart of ``areal_tpu/evaluation/grading.py``). Only
``grade_gpqa_answer`` is ported; the process-pool grader comes with the
evaluator (``ROADMAP.md``).
"""


def grade_gpqa_answer(answer: str, gold_or_meta) -> float:
    """The gpqa grading convention in ONE place (first gold of a solutions
    list, stringified, through ``mcq.grade_choice``): the env and the
    evaluator must agree or the same samples report different rewards."""
    from areal_tpu_torch.evaluation.mcq import grade_choice

    gold = gold_or_meta
    if isinstance(gold, list):
        gold = gold[0] if gold else ""
    return grade_choice(answer, str(gold))
