"""Logits warping + token sampling (counterpart of
``areal_tpu/gen/sampling.py``): temperature, top-k, top-p and greedy,
vectorized over a slot batch with no data-dependent shapes (top-p uses
sort + cumulative mass masking) and no host sync.

Random draws come from an explicit ``torch.Generator``. They are not the
JAX package's draws: greedy rows match it token for token, sampled rows
match it in distribution.
"""

import dataclasses
from typing import Optional, Tuple

import torch

NEG_INF = -1e10


@dataclasses.dataclass
class SamplingParams:
    """Per-slot sampling hyperparameters (device tensors, [B])."""

    temperature: torch.Tensor   # f32; 0 => greedy
    top_p: torch.Tensor         # f32 in (0, 1]
    top_k: torch.Tensor         # i64; >= vocab => disabled

    @classmethod
    def filled(cls, batch: int, temperature=1.0, top_p=1.0, top_k=1 << 30,
               device=None):
        return cls(
            temperature=torch.full((batch,), temperature,
                                   dtype=torch.float32, device=device),
            top_p=torch.full((batch,), top_p, dtype=torch.float32,
                             device=device),
            top_k=torch.full((batch,), top_k, dtype=torch.int64,
                             device=device),
        )

    def rows(self, idx: torch.Tensor) -> "SamplingParams":
        return SamplingParams(self.temperature[idx], self.top_p[idx],
                              self.top_k[idx])


def warp_logits(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """[B, V] -> warped [B, V] (fp32). Greedy slots (temperature 0) pass
    through; the sampler handles them with argmax.

    ONE descending sort serves both warpers: top-k masks the sorted tail
    (positions >= k), top-p thresholds the cumulative mass over the same
    masked sorted array, and both come back to the unsorted layout as
    VALUE comparisons, which keeps ties at the threshold."""
    logits = logits.float()
    B, V = logits.shape
    logits = logits / sp.temperature.clamp_min(1e-6)[:, None]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    pos = torch.arange(V, device=logits.device)[None, :]
    in_k = pos < sp.top_k[:, None]
    masked_desc = torch.where(in_k, sorted_desc, NEG_INF)
    probs_desc = torch.softmax(masked_desc, dim=-1)
    cum = torch.cumsum(probs_desc, dim=-1)
    keep_desc = ((cum - probs_desc) < sp.top_p[:, None]) & in_k
    # threshold value: smallest logit still kept (first token always kept)
    n_keep = keep_desc.sum(-1).clamp_min(1)
    thresh = torch.gather(sorted_desc, 1, (n_keep - 1)[:, None])
    return torch.where(logits < thresh, NEG_INF, logits)


def _plain_temperature(logits: torch.Tensor, sp: SamplingParams):
    """The no-warp arm: f32 logits over the (floored) temperature."""
    temp = sp.temperature.clamp_min(1e-6).reshape(
        sp.temperature.shape + (1,) * (logits.dim() - 1)
    )
    return logits.float() / temp


def warp_logits_rows(
    logits: torch.Tensor, sp: SamplingParams, rows: torch.Tensor
) -> torch.Tensor:
    """Warp ONLY the slots named by ``rows`` (host-known warping-slot
    indices, padded with the out-of-range index B): the sort runs over
    ``[W, V]``, never the whole batch; every other slot gets the plain
    temperature scaling. Exactly :func:`warp_logits` per row. Padding
    rows scatter into a spare row past the batch, which is dropped."""
    B = logits.shape[0]
    safe = rows.clamp(0, B - 1)
    warped_rows = warp_logits(logits[safe], sp.rows(safe))
    plain = _plain_temperature(logits, sp)
    out = torch.cat([plain, plain[:1]], dim=0)
    out[rows.long()] = warped_rows
    return out[:B]


def _categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_tokens(
    gen: torch.Generator,
    logits: torch.Tensor,
    sp: SamplingParams,
    greedy: Optional[torch.Tensor] = None,
    warp: bool = True,
    warp_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample one token per slot. Returns (tokens [B] i64, logprobs [B]
    f32). ``logprobs`` are w.r.t. the *warped* distribution.

    ``warp=False`` skips top-k/top-p entirely (no ``[B, V]`` sort) and
    reports the sampled token's logprob as ``warped[t] - logsumexp``;
    ``warp_rows`` (with ``warp=True``) narrows the sort to the named slots
    (:func:`warp_logits_rows`). Exact in every mode."""
    if greedy is None:
        greedy = sp.temperature <= 0.0
    arg = torch.argmax(logits, dim=-1)
    if not warp:
        warped = _plain_temperature(logits, sp)
        tokens = torch.where(greedy, arg, _categorical(gen, warped))
        lp = torch.gather(warped, 1, tokens[:, None])[:, 0] - torch.logsumexp(
            warped, dim=-1
        )
        return tokens, lp
    if warp_rows is not None:
        warped = warp_logits_rows(logits, sp, warp_rows)
    else:
        warped = warp_logits(logits, sp)
    logp = torch.log_softmax(warped, dim=-1)
    tokens = torch.where(greedy, arg, _categorical(gen, warped))
    return tokens, torch.gather(logp, 1, tokens[:, None])[:, 0]
