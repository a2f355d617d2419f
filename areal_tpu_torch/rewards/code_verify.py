"""Local code-reward verification: run generated python against test cases
(a copy of ``areal_tpu/rewards/code_verify.py``, which the port may not
import).

Execute the solution in a subprocess per test case (stdin/stdout protocol),
with a wall-clock timeout; reward 1 iff all cases pass. The remote sandbox
route is ``rewards/remote.py``.
"""

import re
import subprocess
import sys
from typing import Dict, List, Optional


def extract_code_block(text: str) -> Optional[str]:
    """Last fenced code block (``` or ```python)."""
    blocks = re.findall(r"```(?:python|py)?\n(.*?)```", text, re.DOTALL)
    return blocks[-1] if blocks else None


def run_test_case(
    code: str, stdin: str, expected_stdout: str, timeout: float = 8.0
) -> bool:
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code],
            input=stdin,
            capture_output=True,
            text=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return False
    if proc.returncode != 0:
        return False
    got = proc.stdout.strip().split("\n")
    want = expected_stdout.strip().split("\n")
    return [l.rstrip() for l in got] == [l.rstrip() for l in want]


def verify_code_solution(
    generated: str, input_output: Dict, timeout: float = 8.0, max_cases: int = 8
) -> bool:
    """``input_output``: {"inputs": [...], "outputs": [...]} (the reference's
    dataset format). True iff every (sub-sampled) case passes."""
    code = extract_code_block(generated)
    if code is None:
        return False
    inputs: List[str] = input_output.get("inputs", [])
    outputs: List[str] = input_output.get("outputs", [])
    if not inputs:
        return False
    cases = list(zip(inputs, outputs))[:max_cases]
    return all(run_test_case(code, i, o, timeout) for i, o in cases)
