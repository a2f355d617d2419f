"""Prompt datasets for RL rollout (a copy of
``areal_tpu/datasets/prompt.py``): jsonl records with pre-tokenized
``prompt_ids`` or a text ``prompt`` (tokenized with the tokenizer the
``DatasetUtility`` carries) and ground-truth solutions or test cases for
grading. Filtering by qid waits for the trainer worker that drives it.
"""

import logging
from typing import Dict, Optional

import numpy as np

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.dataset import DatasetUtility, load_shuffle_split_jsonl

logger = logging.getLogger("areal_tpu_torch.datasets")


def _qid(r: dict, i: int) -> str:
    return str(r.get("query_id", r.get("qid", i)))


class PromptOnlyDataset:
    def __init__(self, util: DatasetUtility, path: str,
                 max_length: Optional[int] = None):
        self.util = util
        self.records = load_shuffle_split_jsonl(path, util)
        self._tokenize(max_length)

    def _tokenize(self, max_length):
        kept = []
        for r in self.records:
            if "prompt_ids" in r:
                ids = list(map(int, r["prompt_ids"]))
            else:
                assert self.util.tokenizer is not None, "need tokenizer for text"
                ids = self.util.tokenizer(r["prompt"])["input_ids"]
            if max_length is not None and len(ids) > max_length:
                continue
            r["_ids"] = ids
            kept.append(r)
        dropped = len(self.records) - len(kept)
        if dropped:
            logger.info("dropped %d overlong prompts", dropped)
        self.records = kept

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i: int) -> SequenceSample:
        r = self.records[i]
        return SequenceSample(
            keys={"packed_prompts"},
            ids=[_qid(r, i)],
            seqlens={"packed_prompts": [[len(r["_ids"])]]},
            data={"packed_prompts": np.asarray(r["_ids"], np.int64)},
        )


def metadata_from_records(records) -> Dict[str, dict]:
    """qid -> grading metadata."""
    meta: Dict[str, dict] = {}
    for i, r in enumerate(records):
        qid = _qid(r, i)
        task = r.get("task", "math")
        if task in ("math", "gpqa"):  # gpqa: gold is the choice letter
            meta[qid] = {"task": task, "solutions": r.get("solutions", [])}
        elif task == "tool_use":
            meta[qid] = {
                "task": "tool_use",
                "answer": str(
                    r.get("answer", r.get("target", r.get("ground_truth", "")))
                ),
                **({"scoring_method": r["scoring_method"]}
                   if "scoring_method" in r else {}),
            }
        else:
            meta[qid] = {"task": "code",
                         "input_output": r.get("input_output", {})}
    return meta


class MathCodePromptDataset(PromptOnlyDataset):
    """Adds per-qid task metadata (solutions / test cases)."""

    def load_metadata(self) -> Dict[str, dict]:
        return metadata_from_records(self.records)
