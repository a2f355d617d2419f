"""Reward computation: the local math verifier, the local code runner and
the tool-use grader (copies of ``areal_tpu/rewards/{math_verify,
code_verify,tool_use}.py``), and the remote sandbox client (``remote.py``,
on ``base/http.py``)."""
