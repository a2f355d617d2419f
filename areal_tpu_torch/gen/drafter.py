"""Draft-token proposers for speculative decoding (counterpart of
``areal_tpu/gen/drafter.py``).

The drafter runs inside the generation engine's spec chunk
(``gen/engine.py::_spec_chunk_body``), which a GPU captures as a CUDA
graph: ``propose`` must be a pure function of device tensors, with no
host sync and no data-dependent shape. The engine hands it the slots'
resident token context and expects ``[B, K]`` proposed tokens; the verify
pass scores all K+1 positions at once and
``sampling.spec_rejection_sample`` accepts a prefix. Acceptance is exactly
distribution-preserving, so a drafter can never corrupt outputs; its
quality moves only the accept rate.

:class:`NGramDrafter` self-drafts by a suffix lookup over the slot's
context (the engine's ``ctx_tokens``), falling back to the target's argmax
at the previous emission boundary. :class:`TransformerDrafter` is a small
draft MODEL that proposes K tokens autoregressively through
``decode_step_paged`` on its own params and its own paged KV pool (the
target pool's page indices, so pages allocate and free in lockstep), and
returns the proposal distribution for the general-q branch of the
rejection sampler.
"""

import dataclasses
from typing import Any, Optional, Tuple

import torch

from areal_tpu_torch.gen.sampling import _categorical, _plain_temperature
from areal_tpu_torch.models import transformer as tfm


class Drafter:
    """Interface: propose K draft tokens per slot from resident context.

    ``deterministic = True`` declares one-hot proposals (the rejection
    sampler then needs no proposal distribution). A sampled drafter
    (``deterministic = False``) must set ``provides_q_logprobs = True`` and
    return its proposal distribution: the engine refuses one that does
    not, since accepting its proposals without q would bias generation.

    ``k`` may change between chunks (adaptive spec-K), so ``propose`` must
    hold no k-dependent state."""

    deterministic: bool = True
    provides_q_logprobs: bool = False

    def propose(
        self,
        ctx_tokens: torch.Tensor,  # [B, S]; [b, :lens[b]+1] is valid
        lens: torch.Tensor,        # [B]; ctx_tokens[b, lens[b]] = last token
        fallback: torch.Tensor,    # [B] greedy-from-last-logits hint
        k: int,
    ) -> torch.Tensor:             # [B, k] i64
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NGramDrafter(Drafter):
    """Self-drafting suffix lookup: find the most recent earlier occurrence
    of the context's trailing bigram (then unigram) and propose the K
    tokens that followed it; positions past the match's continuation, or
    slots with no match, fill with the ``fallback`` token. Cost: two
    ``[B, S]`` comparisons and one gather per spec step."""

    deterministic: bool = True

    def propose(self, ctx_tokens, lens, fallback, k):
        B, S = ctx_tokens.shape
        dev = ctx_tokens.device
        lens = lens.long()
        rows = torch.arange(B, device=dev)
        last = ctx_tokens[rows, lens.clamp(0, S - 1)]
        prev = ctx_tokens[rows, (lens - 1).clamp(0, S - 1)]
        # bigram (prev, last) at (j, j+1): its continuation starts at j+2,
        # inside the valid region (j+2 <= lens); lens >= 1 guards prev
        j = torch.arange(S - 1, device=dev)[None, :]
        big = (
            (ctx_tokens[:, :-1] == prev[:, None])
            & (ctx_tokens[:, 1:] == last[:, None])
            & (j + 1 < lens[:, None])
            & (lens >= 1)[:, None]
        )
        m2 = torch.where(big, j, -1).amax(dim=1)             # most recent
        ju = torch.arange(S, device=dev)[None, :]
        uni = (ctx_tokens == last[:, None]) & (ju < lens[:, None])
        m1 = torch.where(uni, ju, -1).amax(dim=1)
        start = torch.where(m2 >= 0, m2 + 2,
                            torch.where(m1 >= 0, m1 + 1, -1))
        offs = start[:, None] + torch.arange(k, device=dev)[None, :]
        in_ctx = (start[:, None] >= 0) & (offs <= lens[:, None])
        cont = torch.gather(ctx_tokens, 1, offs.clamp(0, S - 1))
        return torch.where(in_ctx, cont, fallback.long()[:, None])


class TransformerDrafter(Drafter):
    """A small transformer draft MODEL proposing K tokens autoregressively
    inside the spec chunk.

    The engine casts ``params`` to the serving dtype on its device, keeps
    the draft's own :class:`~areal_tpu_torch.models.transformer.
    PagedKVCache` (addressed by the target's page tables, so draft pages
    allocate and free in lockstep) and calls :meth:`propose_model` from
    the spec chunk. Each of the K proposal steps is one
    ``decode_step_paged`` on the draft params: sample ``d_i ~ q_i`` (the
    plain temperature-scaled draft distribution; argmax for greedy slots),
    write its KV, feed it back. ``cfg.vocab_size`` must equal the
    target's; ``kv_dtype="int8"`` quantizes the draft pool."""

    deterministic = False
    provides_q_logprobs = True

    def __init__(self, cfg, params: Any, kv_dtype: Optional[str] = None):
        self.cfg = cfg
        self.params = params        # the port's param dict; engine prepares it
        self.kv_dtype = kv_dtype

    @classmethod
    def from_hf(cls, path: str, kv_dtype: Optional[str] = None):
        """Load a draft checkpoint (HF dir) through ``models/hf.py`` (the
        ``AREAL_SPEC_DRAFT_MODEL`` path); the params stay on the CPU until
        an engine takes them."""
        from areal_tpu_torch.models import hf as hf_conv

        cfg, host = hf_conv.load_hf_checkpoint(path)
        return cls(cfg, tfm.params_from_numpy(host, device="cpu"),
                   kv_dtype=kv_dtype)

    @classmethod
    def shared_prefix(cls, cfg, params, n_layers: int,
                      kv_dtype: Optional[str] = None):
        """The first ``n_layers`` of the target's per-layer params, sharing
        its embedding and head: a stand-in for a distilled draft, predictive
        only when the later layers refine rather than overturn the early
        layers' logits."""
        if not 0 < n_layers <= cfg.n_layers:
            raise ValueError(
                f"shared-prefix draft needs 0 < n_layers <= {cfg.n_layers}, "
                f"got {n_layers}"
            )
        dcfg = dataclasses.replace(cfg, n_layers=n_layers)
        dparams = dict(params)
        dparams["layers"] = list(params["layers"][:n_layers])
        return cls(dcfg, dparams, kv_dtype=kv_dtype)

    def propose(self, ctx_tokens, lens, fallback, k):  # pragma: no cover
        raise NotImplementedError(
            "TransformerDrafter proposes through propose_model (it needs "
            "its params and paged KV cache, not just the token context)"
        )

    def propose_model(
        self,
        draft_params,
        cache,                      # draft PagedKVCache, updated in place
        last_tokens: torch.Tensor,  # [B] pending token per slot
        table: torch.Tensor,        # [B, W] page table (the target's)
        lens: torch.Tensor,         # [B] resident tokens per slot
        write_ok: torch.Tensor,     # [B, K+1] position i's KV may land
        sp,                         # SamplingParams
        gen: torch.Generator,
        k: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K autoregressive draft steps. Returns ``(draft [B, K] i64,
        q_logprobs [B, K, V] f32)``: the tokens and the distribution each
        was drawn from; the draft cache gets positions ``lens..lens+K``
        where ``write_ok`` allows (rejected drafts' KV lands beyond the
        post-acceptance ``lens``, never read, overwritten later). All K+1
        positions are written: the K steps write the tokens they consume
        (``last``, ``d_1..d_{K-1}``) and a final headless step writes
        ``d_K``'s, which a fully accepted step leaves resident.
        ``write_ok[:, i]`` is monotone per slot, so the per-step ``lens``
        advance tracks the written prefix exactly."""
        greedy = sp.temperature <= 0.0
        tok, d_lens = last_tokens, lens
        drafts, qlps = [], []
        for i in range(k):
            logits, cache, d_lens = tfm.decode_step_paged(
                draft_params, self.cfg, cache, tok, table, d_lens,
                write_ok[:, i],
            )
            q_logits = _plain_temperature(logits, sp)          # [B, V] f32
            qlps.append(torch.log_softmax(q_logits, dim=-1))
            tok = torch.where(greedy, logits.argmax(dim=-1),
                              _categorical(gen, q_logits))
            drafts.append(tok)
        # d_K's own KV: headless, no logits, no sample
        tfm.decode_step_paged(
            draft_params, self.cfg, cache, tok, table, d_lens,
            write_ok[:, k], with_head=False,
        )
        return torch.stack(drafts, dim=1), torch.stack(qlps, dim=1)
