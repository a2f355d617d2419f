"""Fused LM-head + sampling epilogue (counterpart of
``areal_tpu/ops/fused_sample.py``).

A decode step's plain epilogue materializes the full ``[B, V]`` logits
(``x @ W_head``) and then sorts / log-softmaxes / samples over them. This
module streams the head over vocab blocks instead and folds each block
into online per-row state:

- running max ``m`` and rescaled sum-of-exponentials ``l`` give the exact
  log-normalizer ``m + log l``;
- a running raw-logits argmax (value, index) with strictly-greater updates
  keeps the FIRST maximum, so greedy slots are token-exact against
  ``argmax`` over the full array;
- a running Gumbel-top-1 argmax over ``warped + G`` is a categorical
  sample from ``softmax(warped)``, with an optional per-row *excluded*
  token (masked out of the Gumbel argmax only, not out of the normalizer);
- an optional running top-``TOPK_MAX`` (value, index) buffer serves
  plain top-k slots exactly for ``k <= TOPK_MAX``;
- a per-row gathered warped logit (the speculative draft-token score).

Top-p slots are not handled here: the engine keeps them on the sorted
sampler through its warp-row bucket.

The uniforms behind ``G`` are a pure function of (seed, row, column): the
murmur3 finalizer over a per-element counter, bit for bit the stream of the
JAX package's TPU kernel (``areal_tpu/ops/pallas/fused_sample.py``). The
CUDA kernel, this module's plain version and that kernel in interpret mode
therefore draw the same tokens from the same seed (but for the one draw in
2^24 whose uniform is exactly 1, see ``U_MAX``).

Dispatch (:func:`fused_sample`), as in the JAX package: CUDA tensors with
no top-k buffer launch the hand-written kernel
(``ops/cuda/fused_sample.py``); a ``topk`` operand takes the streamed
PyTorch path (it was XLA code, not a TPU kernel, in the JAX package); CPU
tensors take the plain version. Asking for the kernel where it cannot
serve the request raises.
"""

from typing import Dict, Optional

import torch

from areal_tpu_torch.gen.sampling import spec_accept, spec_emit
from areal_tpu_torch.ops.cuda import fused_sample as cuda_fused

# Matches gen/sampling.py: masked-out entries of a distribution.
NEG_INF = -1e10
# Initializer/mask for online state: below any representable warped logit
# (greedy rows divide by the 1e-6 temperature floor, so real warped values
# reach ~1e8 magnitude; -1e10 would be ambiguous there).
_MASK = -2.3819763e38
# Top-k buffer width: slots with top_k <= TOPK_MAX sample exactly from the
# online buffer; larger top_k falls back to the sorted sampler.
TOPK_MAX = 64

_U32 = 0xFFFFFFFF
_COL_MUL = -1640531527 & _U32      # 0x9E3779B9
_ROW_MUL = -2048144789 & _U32      # 0x85EBCA6B


def hash_uniform(seed: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """Uniforms in (0, 1] from the counter hash of (seed, row, column), f32.

    The reference computes in uint32 with wrap-around products and logical
    shifts. torch has no uint32 arithmetic on every build and ``>>`` on
    int32 is arithmetic, so this computes in int64 and masks to 32 bits
    after every step; the bits are the same. ``seed`` is an int32 tensor
    (one element), ``rows`` / ``cols`` integer tensors that broadcast."""
    s = seed.reshape(()).to(torch.int64) & _U32
    h = ((cols.to(torch.int64) * _COL_MUL) & _U32) \
        ^ ((rows.to(torch.int64) * _ROW_MUL) & _U32) ^ s
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    h = h ^ (h >> 16)
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


# The largest uniform a Gumbel draw is made from. The hash's top value,
# (2^24 - 1) + 0.5, rounds to 2^24 in float32, so u reaches exactly 1 once
# in 2^24 draws and -log(-log(1)) is +inf: that column would win its row
# whatever its logit (about one sampled token in 110 at a 152k vocabulary).
# Capping u one ulp below 1 bounds the noise at 16.6; the mass cut off is
# 6e-8. The TPU kernel has no cap: the two differ on those draws only.
U_MAX = 1.0 - 2.0 ** -24


def _gumbel(seed, rows, cols) -> torch.Tensor:
    u = hash_uniform(seed, rows, cols).clamp_max(U_MAX)
    return -torch.log(-torch.log(u))


def _update_block(
    c: Dict[str, torch.Tensor],
    logits: torch.Tensor,          # [R, Bk] f32 (soft cap already applied)
    col0: int,                     # first column id of the block
    seed: torch.Tensor,
    t: torch.Tensor,               # [R] f32 temperature (floored)
    exclude: Optional[torch.Tensor],
    gather_ids: Optional[torch.Tensor],
    kmax: int,
) -> Dict[str, torch.Tensor]:
    """Fold one vocab block into the online per-row state."""
    R, Bk = logits.shape
    dev = logits.device
    cols = col0 + torch.arange(Bk, device=dev)
    rows = torch.arange(R, device=dev)[:, None]
    warped = logits / t[:, None]
    out = dict(c)

    # online logsumexp of the warped logits
    m_new = torch.maximum(c["m"], warped.max(dim=-1).values)
    out["m"] = m_new
    out["l"] = c["l"] * torch.exp(c["m"] - m_new) + torch.exp(
        warped - m_new[:, None]
    ).sum(dim=-1)

    # running raw argmax: strict > keeps the earliest maximum across
    # blocks; within the block the lowest column among the maxima (argmax
    # itself leaves the tie order unspecified)
    bv = logits.max(dim=-1).values
    bi = _first_index_of(logits, bv, cols)
    upd = bv > c["am_v"]
    out["am_v"] = torch.where(upd, bv, c["am_v"])
    out["am_i"] = torch.where(upd, bi, c["am_i"])

    # Gumbel-top-1: argmax over warped + G across all blocks is a
    # categorical draw from softmax(warped)
    pert = warped + _gumbel(seed, rows, cols[None, :])
    if exclude is not None:
        pert = torch.where(cols[None, :] == exclude[:, None], _MASK, pert)
    pbv = pert.max(dim=-1).values
    pbi = _first_index_of(pert, pbv, cols)
    pwv = torch.gather(warped, 1, (pbi - col0)[:, None])[:, 0]
    upd2 = pbv > c["g_p"]
    out["g_p"] = torch.where(upd2, pbv, c["g_p"])
    out["g_w"] = torch.where(upd2, pwv, c["g_w"])
    out["g_i"] = torch.where(upd2, pbi, c["g_i"])

    if gather_ids is not None:
        hit = cols[None, :] == gather_ids[:, None]
        out["gat"] = torch.where(
            hit.any(dim=-1),
            torch.where(hit, warped, 0.0).sum(dim=-1),
            c["gat"],
        )

    if "topv" in c:
        cat_v = torch.cat([c["topv"], warped], dim=-1)
        cat_i = torch.cat([c["topi"], cols.expand(R, Bk)], dim=-1)
        tv, sel = torch.topk(cat_v, kmax, dim=-1)
        out["topv"] = tv
        out["topi"] = torch.gather(cat_i, 1, sel)
    return out


def _first_index_of(vals: torch.Tensor, row_max: torch.Tensor,
                    cols: torch.Tensor) -> torch.Tensor:
    """Lowest column id at which each row attains ``row_max``."""
    big = torch.iinfo(torch.int64).max
    at_max = vals == row_max[:, None]
    return torch.where(at_max, cols[None, :], big).min(dim=-1).values


def _fused_sample_streamed(
    seed, x, w, temperature, greedy, soft_cap, topk, exclude, gather_ids,
    block_size, kmax,
) -> Dict[str, torch.Tensor]:
    """The streamed plain-PyTorch epilogue: one ``[R, block]`` logits block
    at a time, never ``[R, V]``. Logits are float32 accumulations of the
    serving-dtype operands, never rounded to the serving dtype."""
    R, E = x.shape
    V = w.shape[1]
    dev = x.device
    block = max(1, min(int(block_size), V))
    t = temperature.float().clamp_min(1e-6)
    xf = x.float()

    def full(value, dtype, *shape):
        return torch.full(shape, value, dtype=dtype, device=dev)

    carry = {
        "m": full(_MASK, torch.float32, R),
        "l": full(0.0, torch.float32, R),
        "am_v": full(_MASK, torch.float32, R),
        "am_i": full(0, torch.int64, R),
        "g_p": full(_MASK, torch.float32, R),
        "g_w": full(0.0, torch.float32, R),
        "g_i": full(0, torch.int64, R),
    }
    if gather_ids is not None:
        carry["gat"] = full(_MASK, torch.float32, R)
        gather_ids = gather_ids.long()
    if exclude is not None:
        exclude = exclude.long()
    if topk is not None:
        carry["topv"] = full(_MASK, torch.float32, R, kmax)
        carry["topi"] = full(0, torch.int64, R, kmax)

    for col0 in range(0, V, block):
        logits = xf @ w[:, col0:col0 + block].float()
        if soft_cap is not None and soft_cap > 0:
            logits = torch.tanh(logits / soft_cap) * soft_cap
        carry = _update_block(carry, logits, col0, seed, t, exclude,
                              gather_ids, kmax)

    norm = carry["m"] + torch.log(carry["l"])
    tokens = torch.where(greedy, carry["am_i"], carry["g_i"])
    lp = torch.where(greedy, carry["am_v"] / t - norm, carry["g_w"] - norm)
    if topk is not None:
        kk = topk.long().clamp(1, kmax)[:, None]
        pos = torch.arange(kmax, device=dev)[None, :]
        masked = torch.where(pos < kk, carry["topv"], NEG_INF)
        # the buffer's own Gumbel draw: counters past the vocabulary, so
        # they never collide with a column's
        rows = torch.arange(R, device=dev)[:, None]
        choice = torch.argmax(masked + _gumbel(seed, rows, V + pos), dim=-1)
        tok_k = torch.gather(carry["topi"], 1, choice[:, None])[:, 0]
        lp_k = torch.gather(masked, 1, choice[:, None])[:, 0] \
            - torch.logsumexp(masked, dim=-1)
        use_k = (topk <= kmax) & ~greedy
        tokens = torch.where(use_k, tok_k, tokens)
        lp = torch.where(use_k, lp_k, lp)
    out = {
        "tokens": tokens.to(torch.int32),
        "logprobs": lp.float(),
        "argmax": carry["am_i"].to(torch.int32),
        "norm": norm,
    }
    if gather_ids is not None:
        out["gathered_lp"] = carry["gat"] - norm
    return out


def fused_sample_plain(
    seed: torch.Tensor,            # one int32 element
    x: torch.Tensor,               # [R, E]
    w: torch.Tensor,               # [E, V]
    temperature: torch.Tensor,     # [R] f32
    greedy: torch.Tensor,          # [R] bool
    exclude: Optional[torch.Tensor] = None,     # [R] int, -1 = none
    gather_ids: Optional[torch.Tensor] = None,  # [R] int
    soft_cap: Optional[float] = None,
    block_v: int = 2048,
) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the CUDA kernel
    (``ops/cuda/fused_sample.py::fused_sample``): the same function of the
    same operands, the same counter-hash uniforms, on any device. Tests and
    CPU callers use it; nothing on a GPU path does."""
    return _fused_sample_streamed(
        seed, x, w, temperature, greedy, soft_cap, None, exclude,
        gather_ids, block_v, TOPK_MAX,
    )


def fused_sample(
    seed: torch.Tensor,            # one int32 element, on x's device
    x: torch.Tensor,               # [R, E] final-norm hidden states
    w: torch.Tensor,               # [E, V] head weight (serving dtype)
    temperature: torch.Tensor,     # [R] f32 (0 => greedy slot)
    greedy: torch.Tensor,          # [R] bool
    soft_cap: Optional[float] = None,
    topk: Optional[torch.Tensor] = None,    # [R] int; > TOPK_MAX => inactive
    exclude: Optional[torch.Tensor] = None,  # [R] int token to mask (-1 none)
    gather_ids: Optional[torch.Tensor] = None,  # [R] int token to score
    block_size: int = 2048,
    use_kernel: Optional[bool] = None,
) -> Dict[str, torch.Tensor]:
    """Sample one token per row without materializing ``[R, V]`` logits.

    Returns a dict: ``tokens`` [R] i32 (greedy rows: exact raw argmax;
    rows with active ``topk``: exact top-k sample; others: Gumbel-top-1
    categorical over the temperature-warped head, minus the optional
    ``exclude`` token), ``logprobs`` [R] f32 w.r.t. the warped (and, for
    top-k rows, top-k-restricted) distribution, ``argmax`` [R] i32 (raw
    argmax), ``norm`` [R] f32 (warped log-normalizer) and, when
    ``gather_ids`` is given, ``gathered_lp`` [R] f32.

    ``use_kernel=None`` picks by the operands: CUDA tensors without a
    top-k buffer launch the kernel; a top-k buffer takes the streamed
    PyTorch path on the tensors' device; CPU tensors take the plain
    version. ``use_kernel=True`` raises when the kernel cannot serve the
    request."""
    E = x.shape[1]
    if w.shape[0] != E:
        raise ValueError(
            f"head weight {tuple(w.shape)} does not match hidden "
            f"{tuple(x.shape)}"
        )
    if use_kernel is None:
        use_kernel = x.device.type != "cpu" and topk is None
    if use_kernel:
        if topk is not None:
            raise ValueError(
                "the fused_sample kernel does not maintain the top-k "
                "buffer; leave use_kernel unset so top-k rows take the "
                "streamed PyTorch epilogue"
            )
        return cuda_fused.fused_sample(
            seed, x, w, temperature, greedy, exclude=exclude,
            gather_ids=gather_ids, soft_cap=soft_cap,
        )
    return _fused_sample_streamed(
        seed, x, w, temperature, greedy, soft_cap, topk, exclude,
        gather_ids, block_size, TOPK_MAX,
    )


def fused_spec_rejection(
    gen: torch.Generator,
    hidden: torch.Tensor,          # [B, C, E] final-norm verify hidden
    w: torch.Tensor,               # [E, V]
    draft: torch.Tensor,           # [B, K] proposed tokens
    sp,                            # SamplingParams
    soft_cap: Optional[float] = None,
    block_size: int = 2048,
):
    """Speculative rejection sampling from the streamed head: the fused
    counterpart of ``gen/sampling.py::spec_rejection_sample`` for one-hot
    (deterministic) drafters, fed final-norm verify hidden states instead
    of materialized ``[B, C, V]`` logits.

    ONE :func:`fused_sample` call over the ``B * C`` rows (the kernel on a
    CUDA tensor, the plain version on a CPU one) yields per position the
    draft token's warped target logprob (``gather_ids`` = the draft; the
    acceptance threshold), the raw argmax (greedy acceptance and residual)
    and a pre-sampled residual candidate: Gumbel-top-1 with the position's
    draft token excluded (``exclude`` = the draft, -1 at position K),
    which is a draw from p with the rejected token removed, renormalized;
    the bonus position samples the plain warped target. Acceptance
    (``spec_accept``, greedy rows by ``sp.temperature <= 0``) then picks
    the boundary row. Returns ``(accept_len, tokens [B, C], logprobs
    [B, C], boundary_argmax)`` with the semantics of
    ``spec_rejection_sample``: token-exact for greedy slots,
    distribution-exact otherwise. Warping slots (top-p / top-k) are not
    handled here: the engine routes them through the sorted sampler."""
    B, C, E = hidden.shape
    K = C - 1
    dev = hidden.device
    greedy = sp.temperature <= 0.0
    seed = torch.randint(-(1 << 31), (1 << 31) - 1, (1,), generator=gen,
                         device=dev, dtype=torch.int32)
    d32 = draft.to(torch.int32)
    excl = torch.cat(
        [d32, torch.full((B, 1), -1, dtype=torch.int32, device=dev)], dim=1)
    gids = torch.cat(
        [d32, torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
    res = fused_sample(
        seed, hidden.reshape(B * C, E), w,
        sp.temperature.float().repeat_interleave(C),
        greedy.repeat_interleave(C), soft_cap=soft_cap,
        exclude=excl.reshape(-1), gather_ids=gids.reshape(-1),
        block_size=block_size,
    )
    cand = res["tokens"].long().reshape(B, C)
    cand_lp = res["logprobs"].reshape(B, C)
    argmax = res["argmax"].long().reshape(B, C)
    draft_lp = res["gathered_lp"].reshape(B, C)[:, :K]
    draft = draft.long()

    _, a = spec_accept(gen, greedy, draft, argmax, draft_lp)
    rows = torch.arange(B, device=dev)
    tokens, lps = spec_emit(a, draft, draft_lp, cand[rows, a],
                            cand_lp[rows, a])
    return a, tokens, lps, argmax[rows, a]
