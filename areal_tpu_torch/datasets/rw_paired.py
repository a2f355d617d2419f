"""Paired reward-modeling dataset (pos/neg answer pairs per prompt; a copy
of ``areal_tpu/datasets/rw_paired.py``): jsonl records
with a prompt and one-to-one positive/negative answer lists; each item
yields a GROUPED sample of ``2 * n_pairs`` sequences laid out
``[pos_0, neg_0, pos_1, neg_1, ...]`` with per-sequence ``pair_id`` and
``pair_sign`` keys the Bradley-Terry loss consumes
(``interfaces/reward.py``).

Records carry either pre-tokenized ids (``prompt_ids``,
``pos_answer_ids``, ``neg_answer_ids``) or text (``prompt``,
``pos_answers``, ``neg_answers`` — tokenized with the provided tokenizer,
EOS appended, like the reference).
"""

import logging
from typing import Optional

import numpy as np

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.dataset import DatasetUtility, load_shuffle_split_jsonl

logger = logging.getLogger("areal_tpu_torch.datasets")


class RewardPairedDataset:
    def __init__(
        self,
        util: DatasetUtility,
        path: str,
        max_length: Optional[int] = None,
        max_pairs_per_prompt: int = 2,
    ):
        self.util = util
        self.max_pairs_per_prompt = max_pairs_per_prompt
        records = load_shuffle_split_jsonl(path, util)
        rng = np.random.RandomState(util.seed)
        self.items = []
        dropped = 0
        for r in records:
            pos, neg = self._tokenize_answers(r)
            if len(pos) != len(neg) or not pos:
                raise ValueError(
                    f"record {r.get('qid', r.get('id'))}: pos/neg answers "
                    "must be non-empty one-to-one pairs"
                )
            pairs = list(zip(pos, neg))
            if len(pairs) > max_pairs_per_prompt:
                idx = rng.choice(len(pairs), max_pairs_per_prompt, replace=False)
                pairs = [pairs[i] for i in idx]
            if max_length is not None and any(
                len(p) > max_length or len(n) > max_length for p, n in pairs
            ):
                dropped += 1
                continue
            qid = str(r.get("qid", r.get("id", len(self.items))))
            self.items.append((qid, pairs))
        if dropped:
            logger.info("dropped %d over-long rw items", dropped)

    def _tokenize_answers(self, r):
        if "pos_answer_ids" in r:
            to_ids = lambda seqs: [list(map(int, s)) for s in seqs]
            return to_ids(r["pos_answer_ids"]), to_ids(r["neg_answer_ids"])
        tok = self.util.tokenizer
        assert tok is not None, "need a tokenizer for text records"
        eos = tok.eos_token or ""

        def enc(answers):
            return [tok(r["prompt"] + a + eos)["input_ids"] for a in answers]

        return enc(r["pos_answers"]), enc(r["neg_answers"])

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> SequenceSample:
        qid, pairs = self.items[i]
        seqs, pair_id, pair_sign = [], [], []
        for j, (pos, neg) in enumerate(pairs):
            seqs += [pos, neg]
            pair_id += [j, j]
            pair_sign += [1.0, -1.0]
        seqlens = [len(s) for s in seqs]
        n = len(seqs)
        return SequenceSample(
            keys={"packed_input_ids", "pair_id", "pair_sign"},
            ids=[qid],
            seqlens={
                "packed_input_ids": [seqlens],
                "pair_id": [[1] * n],
                "pair_sign": [[1] * n],
            },
            data={
                "packed_input_ids": np.concatenate(
                    [np.asarray(s, np.int64) for s in seqs]
                ),
                "pair_id": np.asarray(pair_id, np.int32),
                "pair_sign": np.asarray(pair_sign, np.float32),
            },
        )
