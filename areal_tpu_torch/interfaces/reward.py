"""Reward-model interface: Bradley-Terry pairwise training and sequence
scoring (counterpart of ``areal_tpu/interfaces/reward.py``). The model is a
critic-architecture transformer (``is_critic=True``: scalar head); a
sequence's score is the head output at its LAST token.

Training: ``-log sigmoid(s_pos - s_neg)`` over one-to-one pairs. Every
sequence carries ``pair_id`` (its pair within its item) and ``pair_sign``
(+1 pos / -1 neg); signed end-token scores are summed into per-(item,
pair) buckets with one ``index_add``, so a bucket holds exactly ``s_pos -
s_neg`` for a complete pair, with no host-side pair bookkeeping. Tokens
that are not a sequence's end add into one spare bucket past the others,
which is dropped (the reference's out-of-range ``mode="drop"`` index).

As a node of the PPO graph (``reward_inf``) it is not wired yet:
``experiments/graphs.py`` raises for ``use_reward_model`` (``ROADMAP.md``).
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import ModelInterface
from areal_tpu_torch.ops import ppo as ppo_ops
from areal_tpu_torch.train.engine import vmapped_forward


def score_output_fn(params, cfg, arrays):
    """Per-sequence scores written at segment-end positions, 0 elsewhere
    (unpacks into one trailing scalar per sequence)."""
    values = vmapped_forward(params, cfg, arrays)[..., 0]
    is_end = ppo_ops.is_segment_end(arrays["segment_ids"])
    return torch.where(is_end, values, 0.0)


@dataclasses.dataclass
class PairedRewardInterface(ModelInterface):
    hf_family: Optional[str] = None
    max_pairs_per_prompt: int = 8   # static bucket factor for pair matching

    def __post_init__(self):
        K = self.max_pairs_per_prompt

        def rw_loss(params, cfg, arrays):
            values = vmapped_forward(params, cfg, arrays)[..., 0]   # [R, T]
            seg = arrays["segment_ids"]
            R, T = seg.shape
            endf = ppo_ops.is_segment_end(seg).reshape(-1)
            n_buckets = R * T * K
            bucket = (arrays["item_ids"].long() * K
                      + arrays["pair_id"].long()).reshape(-1)
            bucket = torch.where(endf, bucket, n_buckets)   # the spare bucket
            signed = (values.float() * arrays["pair_sign"].float()).reshape(-1)
            zeros = torch.zeros(n_buckets + 1, device=seg.device)
            diffs = zeros.index_add(0, bucket, torch.where(endf, signed, 0.0))[
                :n_buckets]
            counts = zeros.index_add(0, bucket, endf.float())[:n_buckets]
            complete = counts == 2                   # a full pos/neg pair
            n = complete.sum().clamp_min(1)
            loss = torch.where(complete, -F.logsigmoid(diffs), 0.0).sum() / n
            acc = torch.where(complete, (diffs > 0).float(), 0.0).sum() / n
            return loss, {
                "rw_loss": loss.detach(),
                "rw_acc": acc,
                "score_diff": torch.where(complete, diffs, 0.0).sum().detach() / n,
            }

        self._rw_loss_fn = rw_loss

    # ------------------------------------------------------------------ #

    def train_step(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        max_pid = (int(np.max(sample.data["pair_id"]))
                   if sample.data["pair_id"].size else 0)
        if max_pid >= self.max_pairs_per_prompt:
            raise ValueError(
                f"pair_id {max_pid} >= max_pairs_per_prompt "
                f"{self.max_pairs_per_prompt}: bucket indices would collide "
                "across items, silently corrupting the pairwise loss; raise "
                "the interface's max_pairs_per_prompt"
            )

        def pair_weight(pb):
            # weight micro-batches by their COMPLETE pair count so gradient
            # accumulation equals a global pair mean
            ends = {}
            for p in pb.placements:
                key = (p.item_idx, int(pb.arrays["pair_id"][p.row, p.start]))
                ends[key] = ends.get(key, 0) + 1
            return float(sum(1 for v in ends.values() if v == 2))

        stats = engine.train_batch(
            sample, mb_spec, self._rw_loss_fn, loss_weight_fn=pair_weight
        )
        engine.version += 1
        return stats

    def inference(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        """Score sequences: one scalar reward per sequence."""
        outs = engine.forward(sample, mb_spec, score_output_fn)
        scores = np.asarray([float(o.sum()) for o in outs], np.float32)
        main = sample.main_key()
        n_per_item = [len(l) for l in sample.seqlens[main]]
        return SequenceSample(
            keys={"rewards"},
            ids=list(sample.ids),
            seqlens={"rewards": [[1] * n for n in n_per_item]},
            data={"rewards": scores},
        )

    def evaluate(self, engine, eval_samples) -> Dict[str, float]:
        # weight each eval batch by its PAIR count (the loss is a pair mean)
        tot, n = 0.0, 0
        for s in eval_samples:
            r = engine.eval_batch(s, MicroBatchSpec(), self._rw_loss_fn)
            pairs = sum(len(inner) for inner in s.seqlens[s.main_key()]) // 2
            tot += r["loss"] * pairs
            n += pairs
        return {"loss": tot / max(n, 1)} if n else {}
