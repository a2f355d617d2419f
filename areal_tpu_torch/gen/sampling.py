"""Logits warping, token sampling and speculative acceptance
(counterpart of ``areal_tpu/gen/sampling.py``): temperature, top-k, top-p
and greedy, vectorized over a slot batch with no data-dependent shapes
(top-p uses sort + cumulative mass masking) and no host sync.

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
    ``[W, V]`` (or ``[W*C, V]`` for the spec-verify ``[B, C, V]`` shape),
    never the whole batch; every other slot gets the plain temperature
    scaling. Exactly :func:`warp_logits` / :func:`warp_logits_multi` per
    row. Padding rows scatter into a spare row past the batch, which is
    dropped."""
    B = logits.shape[0]
    safe = rows.clamp(0, B - 1)
    if logits.dim() == 3:
        warped_rows = warp_logits_multi(logits[safe], sp.rows(safe))
    else:
        warped_rows = warp_logits(logits[safe], sp.rows(safe))
    plain = _plain_temperature(logits, sp)
    out = torch.cat([plain, plain[:1]], dim=0)
    out[rows.long()] = warped_rows
    return out[:B]


def warp_logits_multi(logits: torch.Tensor,
                      sp: SamplingParams) -> torch.Tensor:
    """Warp ``[B, C, V]`` logits (C query positions per slot, the verify
    shape) with per-SLOT sampling params: ONE ``[B*C, V]`` sort serves
    every position of every slot."""
    B, C, V = logits.shape
    flat = SamplingParams(
        temperature=sp.temperature.repeat_interleave(C),
        top_p=sp.top_p.repeat_interleave(C),
        top_k=sp.top_k.repeat_interleave(C),
    )
    return warp_logits(logits.reshape(B * C, V), flat).reshape(B, C, V)


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


def spec_accept(gen: torch.Generator, greedy: torch.Tensor,
                draft: torch.Tensor, argmax: torch.Tensor,
                log_ratio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The acceptance rule shared by both rejection samplers: a greedy
    row accepts ``draft[:, i]`` iff it equals the raw argmax
    ``argmax[:, i]``, any other row with probability
    ``min(1, exp(log_ratio[:, i]))`` (one uniform per draft position from
    ``gen``). Returns ``(accept [B, K] bool, accept_len [B])``: the
    longest accepted prefix, as the first rejection stops everything
    after it."""
    K = draft.shape[1]
    u = torch.rand(draft.shape, generator=gen,
                   device=draft.device).clamp_min(1e-20)
    accept = torch.where(greedy[:, None], draft == argmax[:, :K],
                         torch.log(u) < log_ratio)
    return accept, torch.cumprod(accept.long(), dim=1).sum(dim=1)


def spec_emit(a: torch.Tensor, draft: torch.Tensor, draft_lp: torch.Tensor,
              res_tok: torch.Tensor, res_lp: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The emission layout ``[B, K + 1]``: positions ``< a`` hold the
    accepted draft tokens and their logprobs, position ``a`` (and the
    later, unused ones) the residual or bonus token ``res_tok`` and its
    logprob ``res_lp``."""
    pos = torch.arange(draft.shape[1] + 1, device=a.device)[None, :]
    prefix = pos < a[:, None]
    tokens = torch.where(prefix, torch.cat([draft, draft[:, -1:]], dim=1),
                         res_tok[:, None])
    lps = torch.where(prefix, torch.cat([draft_lp, draft_lp[:, -1:]], dim=1),
                      res_lp[:, None])
    return tokens, lps


def spec_rejection_sample(
    gen: torch.Generator,
    logits: torch.Tensor,        # [B, C, V] target logits; C = K + 1
    draft: torch.Tensor,         # [B, K] proposed tokens
    sp: SamplingParams,
    warp: bool = True,
    greedy: Optional[torch.Tensor] = None,
    q_logprobs: Optional[torch.Tensor] = None,  # [B, K, V] proposal logprobs
    warp_rows: Optional[torch.Tensor] = None,   # [W] warping-slot indices
    return_accept_prob: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Speculative-decoding acceptance: accept a prefix of the draft, then
    sample ONE residual token from the normalized difference distribution.

    ``logits[:, i]`` is the target distribution for the token FOLLOWING
    chunk position ``i`` (chunk = ``[last_token, d_1..d_K]``), so
    ``logits[:, i]`` scores ``draft[:, i]`` and ``logits[:, K]`` is the
    bonus distribution when every draft token is accepted.

    ``q_logprobs`` is the proposal distribution per draft position;
    ``None`` means a deterministic (one-hot) drafter: the accept
    probability reduces to ``p(d)`` and the residual to ``p`` with the
    rejected token removed, renormalized. Otherwise the residual is
    ``max(p - q, 0)`` and the bonus row samples ``p``. Both forms are
    exactly distribution-preserving.

    Greedy slots (``sp.temperature <= 0`` or explicit ``greedy``) accept a
    draft token iff it equals the raw-logits argmax and emit the argmax as
    the residual: token-identical to vanilla greedy decode.

    Returns ``(accept_len [B] in [0, K], tokens [B, C], logprobs [B, C],
    boundary_argmax [B])`` (i64 tokens): positions ``i < accept_len`` hold
    accepted draft tokens, position ``accept_len`` the residual or bonus
    token, later positions garbage. ``logprobs`` are w.r.t. the warped
    target at each position, as ``sample_tokens`` reports them.
    ``boundary_argmax`` is the target argmax at the emission boundary (the
    n-gram drafter's fallback). ``return_accept_prob`` appends
    ``accept_prob [B, K]``: ``min(1, p(d_i) / q(d_i))`` (the 0/1 accept
    indicator for greedy slots)."""
    B, C, V = logits.shape
    K = C - 1
    dev = logits.device
    if not warp:
        warped = _plain_temperature(logits, sp)
    elif warp_rows is not None:
        warped = warp_logits_rows(logits, sp, warp_rows)
    else:
        warped = warp_logits_multi(logits, sp)
    logp = torch.log_softmax(warped, dim=-1)                  # [B, C, V]
    argmax = torch.argmax(logits, dim=-1)                      # [B, C]
    if greedy is None:
        greedy = sp.temperature <= 0.0
    draft = draft.long()
    draft_lp = torch.gather(logp[:, :K], 2, draft[..., None])[..., 0]
    # accept d_i with prob min(1, p(d_i)/q(d_i)); a one-hot proposal has
    # q(d_i) = 1, so the threshold is p(d_i) itself
    log_ratio = draft_lp
    if q_logprobs is not None:
        q_lp = torch.gather(q_logprobs, 2, draft[..., None])[..., 0]
        log_ratio = draft_lp - q_lp
    accept, a = spec_accept(gen, greedy, draft, argmax, log_ratio)

    rows = torch.arange(B, device=dev)
    row_w = warped[rows, a]                                    # [B, V]
    row_lp = logp[rows, a]
    boundary_argmax = argmax[rows, a]
    rejected = a < K                                           # else: bonus
    rej_tok = draft[rows, a.clamp(max=K - 1)]
    if q_logprobs is None:
        # one-hot proposal: residual = p with the rejected token zeroed
        cols = torch.arange(V, device=dev)[None, :]
        res_logits = torch.where(
            rejected[:, None] & (cols == rej_tok[:, None]), NEG_INF, row_w
        )
        sampled = _categorical(gen, res_logits)
    else:
        q_row = q_logprobs[rows, a.clamp(max=K - 1)]           # [B, V]
        resid = (torch.exp(row_lp) - torch.exp(q_row)).clamp_min(0.0)
        # the bonus position (a == K) samples the plain target
        resid = torch.where(rejected[:, None], resid, torch.exp(row_lp))
        sampled = _categorical(gen, torch.log(resid.clamp_min(1e-30)))
    res_tok = torch.where(greedy, boundary_argmax, sampled)
    res_lp = torch.gather(row_lp, 1, res_tok[:, None])[:, 0]
    tokens, lps = spec_emit(a, draft, draft_lp, res_tok, res_lp)
    if return_accept_prob:
        acc_p = torch.where(greedy[:, None], accept.float(),
                            torch.exp(log_ratio).clamp_max(1.0))
        return a, tokens, lps, boundary_argmax, acc_p
    return a, tokens, lps, boundary_argmax
