"""Evaluation: the graders the rollout environments share with the
offline evaluator. Ported so far: ``mcq.py`` (multiple-choice grading) and
``grading.py::grade_gpqa_answer``; the benchmarks, the process-pool grader
and the evaluator itself are not ported yet (``ROADMAP.md``).
"""
