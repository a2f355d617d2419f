"""SFT prompt-answer dataset (a copy of ``areal_tpu/datasets/prompt_answer.py``).

Each record: ``{"prompt": ..., "answer": ...}`` (text, tokenized) or
``{"prompt_ids": [...], "answer_ids": [...]}``. Produces packed sequences
with ``prompt_mask`` so the SFT loss covers only answer tokens.
"""

from typing import Optional

import numpy as np

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.dataset import DatasetUtility, load_shuffle_split_jsonl


class PromptAnswerDataset:
    def __init__(
        self,
        util: DatasetUtility,
        path: str,
        max_length: Optional[int] = None,
    ):
        self.util = util
        records = load_shuffle_split_jsonl(path, util)
        self.items = []
        for i, r in enumerate(records):
            if "prompt_ids" in r:
                p = list(map(int, r["prompt_ids"]))
                a = list(map(int, r["answer_ids"]))
            else:
                tok = util.tokenizer
                p = tok(r["prompt"])["input_ids"]
                a = tok(r["answer"], add_special_tokens=False)["input_ids"]
                if tok.eos_token_id is not None:
                    a = a + [tok.eos_token_id]
            if max_length is not None and len(p) + len(a) > max_length:
                continue
            self.items.append((str(r.get("qid", i)), p, a))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> SequenceSample:
        qid, p, a = self.items[i]
        ids = np.asarray(p + a, np.int64)
        mask = np.r_[np.ones(len(p), np.bool_), np.zeros(len(a), np.bool_)]
        return SequenceSample(
            keys={"packed_input_ids", "prompt_mask"},
            ids=[qid],
            seqlens={
                "packed_input_ids": [[len(ids)]],
                "prompt_mask": [[len(ids)]],
            },
            data={"packed_input_ids": ids, "prompt_mask": mask},
        )
