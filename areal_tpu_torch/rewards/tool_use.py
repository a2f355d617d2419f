"""Tool-use (agentic search) reward: answer extraction + EM/F1 + format
(a copy of ``areal_tpu/rewards/tool_use.py``, which the port may not
import).

Counterpart of ``realhf/impl/model/interface/tool_use_rw_interface.py``
(533 LoC): responses carry JSON tool calls; the final ``answer`` tool call
holds the prediction, graded against the ground truth with SQuAD-style
normalization (exact match or token F1), plus a small bonus for emitting
any well-formed tool call. Pure host-side string math — no model involved —
so unlike the reference (which routes this through a GPU model-interface
for its data plumbing) it lives beside the other rule-based verifiers.
"""

import re
import string
from collections import Counter
from typing import Optional, Tuple

# JSON string bodies allow escaped characters: ((?:[^"\\]|\\.)*) consumes
# backslash escapes (\" included) without terminating the match early
_JSTR = r'((?:[^"\\]|\\.)*)'
_ANSWER_CALL = re.compile(
    r'"function"\s*:\s*{\s*"name"\s*:\s*"answer"[^}]*'
    r'"arguments"\s*:\s*{\s*"answer"\s*:\s*"' + _JSTR + '"'
)
_BARE_ANSWER = re.compile(r'{"answer"\s*:\s*"' + _JSTR + '"}')
_TOOL_CALL = re.compile(
    r'"function"\s*:\s*{\s*"name"\s*:\s*"[^"]*"[^}]*"arguments"\s*:\s*{[^}]*}'
)
_SIMPLE_JSON = re.compile(r'{"[^"]*"\s*:\s*"[^"]*"}')
_ARTICLES = re.compile(r"\b(a|an|the)\b")


def extract_answer(text: str) -> str:
    """The LAST ``answer`` tool call's argument; falls back to a bare
    ``{"answer": ...}`` object, then to the raw text."""
    m = _ANSWER_CALL.findall(text)
    if not m:
        m = _BARE_ANSWER.findall(text)
    if m:
        return re.sub(r"\\(.)", r"\1", m[-1]).strip()
    return text.strip()


def normalize_answer(s: Optional[str]) -> str:
    """SQuAD-style: lowercase, strip punctuation/articles, squash spaces."""
    if not isinstance(s, str):
        s = "" if s is None else str(s)
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = _ARTICLES.sub(" ", s)
    return " ".join(s.split())


def f1_score(prediction: Optional[str], ground_truth: Optional[str]) -> float:
    """Token-level F1 over normalized answers."""
    if prediction is None or ground_truth is None:
        return 0.0
    pred = normalize_answer(prediction).split()
    gt = normalize_answer(ground_truth).split()
    if not pred and not gt:
        return 1.0
    if not pred or not gt:
        return 0.0
    same = sum((Counter(pred) & Counter(gt)).values())
    if same == 0:
        return 0.0
    precision = same / len(pred)
    recall = same / len(gt)
    return 2 * precision * recall / (precision + recall)


def em_check(pred: Optional[str], answer: Optional[str]) -> Tuple[int, float]:
    """(exact_match, f1) over normalized answers."""
    if pred is None or answer is None:
        return 0, 0.0
    np_, na = normalize_answer(pred), normalize_answer(answer)
    if not np_ and not na:
        em = 1
    elif not np_ or not na:
        em = 0
    else:
        em = int(np_ == na)
    return em, f1_score(pred, answer)


def validate_tool_call_format(text: str) -> bool:
    """True when the response contains at least one well-formed tool call
    (or a minimal JSON object, the reference's lenient fallback)."""
    return bool(_TOOL_CALL.search(text) or _SIMPLE_JSON.search(text))


def tool_use_reward(
    text: str,
    ground_truth: str,
    *,
    correctness_weight: float = 1.0,
    format_weight: float = 0.2,
    scoring_method: str = "f1",
) -> float:
    """Scalar reward = correctness (EM or F1 of the extracted answer) ×
    ``correctness_weight`` + format validity × ``format_weight``.
    ≈ ``compute_tool_use_rewards`` (reference ``:206-262``)."""
    extracted = extract_answer(text)
    correctness = 0.0
    if extracted and ground_truth:
        em, f1 = em_check(extracted, ground_truth)
        correctness = f1 if scoring_method == "f1" else float(em)
    fmt = 1.0 if validate_tool_call_format(text) else 0.0
    return correctness * correctness_weight + fmt * format_weight
