"""Supervised fine-tuning interface (counterpart of
``areal_tpu/interfaces/sft.py``): next-token cross-entropy over the
non-prompt tokens of packed sequences."""

import dataclasses
from typing import Dict

import torch

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import ModelInterface
from areal_tpu_torch.ops import ppo as ppo_ops
from areal_tpu_torch.train.engine import vmapped_next_token_logprobs


def label_is_prompt(arrays) -> torch.Tensor:
    """[rows, T] bool: the label of position t (token t+1) is a prompt
    token."""
    pm = arrays["prompt_mask"].bool()
    return torch.cat([pm[:, 1:], torch.zeros_like(pm[:, :1])], dim=1)


def sft_loss_fn(params, cfg, arrays):
    """-mean log p(next token) over answer tokens (prompt_mask == 0), plus
    the MoE router's aux loss (0 for a dense MLP) as the reference adds it;
    ``ppl`` is the cross-entropy's alone. ``cfg.loss_chunk_size`` routes
    through the chunked LM-head path."""
    lp, aux = vmapped_next_token_logprobs(params, cfg, arrays, with_aux=True)
    seg = arrays["segment_ids"]
    mask = (seg > 0) & ~ppo_ops.is_segment_end(seg)
    if "prompt_mask" in arrays:
        mask = mask & ~label_is_prompt(arrays)
    n = mask.sum().clamp_min(1)
    loss = -torch.where(mask, lp, 0.0).sum() / n
    return loss + aux, {"ppl": torch.exp(loss.detach()),
                        "n_tokens": n.float()}


@dataclasses.dataclass
class SFTInterface(ModelInterface):
    token_normalize_scope: str = "global"

    def train_step(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        return engine.train_batch(sample, mb_spec, sft_loss_fn)

    def evaluate(self, engine, eval_samples) -> Dict[str, float]:
        tot, n = 0.0, 0
        for s in eval_samples:
            tot += engine.eval_batch(s, MicroBatchSpec(), sft_loss_fn)["loss"]
            n += 1
        return {"loss": tot / n} if n else {}
