"""Dataset utilities and registry (a copy of ``areal_tpu/api/dataset.py``):
``DatasetUtility``, the deterministic shuffle-and-split jsonl loader,
``register_dataset`` / ``make_dataset`` and ``dataset_metadata``."""

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional

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


ALL_DATASETS: Dict[str, Callable] = {}


def register_dataset(name: str, cls: Callable):
    assert name not in ALL_DATASETS, name
    ALL_DATASETS[name] = cls


def make_dataset(name: str, util: DatasetUtility, **kwargs):
    """``kwargs`` go to the dataset (``path``; ``max_length`` drops prompts
    longer than it)."""
    import areal_tpu_torch.datasets  # noqa: F401  (triggers registration)

    return ALL_DATASETS[name](util=util, **kwargs)


def dataset_metadata(dataset) -> dict:
    """qid -> task metadata for reward grading: ``load_metadata()`` of a
    prompt dataset, else a plain ``metadata`` attribute (an empty dict
    would grade every answer wrong)."""
    if hasattr(dataset, "load_metadata"):
        return dataset.load_metadata()
    return getattr(dataset, "metadata", {})
