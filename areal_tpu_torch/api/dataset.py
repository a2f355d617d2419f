"""Dataset utilities (the slice's part of ``areal_tpu/api/dataset.py``):
``DatasetUtility``, the deterministic shuffle-and-split jsonl loader and
``dataset_metadata``."""

import dataclasses
import json
from typing import Any, List, Optional

import numpy as np


@dataclasses.dataclass
class DatasetUtility:
    seed: int
    dp_rank: int
    world_size: int
    tokenizer: Optional[Any] = None


def load_shuffle_split_jsonl(path: str, util: DatasetUtility) -> List[dict]:
    """Deterministic shuffle + contiguous per-DP-rank split."""
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    rng = np.random.RandomState(util.seed)
    perm = rng.permutation(len(records))
    records = [records[i] for i in perm]
    n = len(records)
    per = n // util.world_size
    lo = util.dp_rank * per
    hi = n if util.dp_rank == util.world_size - 1 else lo + per
    return records[lo:hi]


def dataset_metadata(dataset) -> dict:
    """qid -> task metadata for reward grading: ``load_metadata()`` of a
    prompt dataset, else a plain ``metadata`` attribute (an empty dict
    would grade every answer wrong)."""
    if hasattr(dataset, "load_metadata"):
        return dataset.load_metadata()
    return getattr(dataset, "metadata", {})
