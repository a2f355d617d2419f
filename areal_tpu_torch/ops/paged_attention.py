"""Paged KV attention: decode + chunked-extend over a page pool
(counterpart of ``areal_tpu/ops/paged_attention.py``).

KV lives in a pool ``[L, P, 2, Hkv, page, D]`` (K and V interleaved per
page, heads before tokens); each slot owns a page TABLE ``[M]``. The pool
is READ-ONLY inside these ops: the model passes the whole pool plus a
layer index and the CURRENT tokens' K/V as separate operands, attention
folds the fresh tokens in analytically, and the model writes all layers'
new KV into the pool in one scatter after its layer loop.

Decode dispatches by device: a CUDA tensor goes to the hand-written
kernel (``ops/cuda/paged_attention.py``), a CPU tensor to its plain
version ``decode_plain``. Chunked prefill (extend) is plain PyTorch, as it
was XLA code (not Pallas) in the JAX package.
"""

from typing import Optional, Tuple

import torch

from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged

NEG_INF = -2.3819763e38


def gather_pages(
    pages: torch.Tensor, table: torch.Tensor, layer: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[L, P, 2, Hkv, page, D]`` + table ``[B, M]`` + layer index ->
    ``(k, v)`` each ``[B, M*page, Hkv, D]`` (contiguous per-slot views;
    garbage beyond the slot's length, masked by the caller's ``lens``)."""
    B, M = table.shape
    g = pages[int(layer)][table.long()]    # [B, M, 2, Hkv, page, D]
    Hkv, page, D = g.shape[3:]
    g = g.transpose(3, 4)                  # [B, M, 2, page, Hkv, D]
    k = g[:, :, 0].reshape(B, M * page, Hkv, D)
    v = g[:, :, 1].reshape(B, M * page, Hkv, D)
    return k, v


def gather_dequant_pages(
    pages: torch.Tensor,
    table: torch.Tensor,
    layer: int,
    scales: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gather_pages`, with the int8 views widened to f32 against
    their per-(token, head) scales when ``scales`` (``[L, P, 2, Hkv,
    page]`` f32) is given. Only the per-slot view widens, never the pool."""
    k, v = gather_pages(pages, table, layer)
    if scales is None:
        return k, v
    B, M = table.shape
    g = scales[int(layer)][table.long()]   # [B, M, 2, Hkv, page]
    Hkv, page = g.shape[3:]
    g = g.transpose(3, 4)                  # [B, M, 2, page, Hkv]
    k_s = g[:, :, 0].reshape(B, M * page, Hkv)
    v_s = g[:, :, 1].reshape(B, M * page, Hkv)
    return k.float() * k_s[..., None], v.float() * v_s[..., None]


def paged_decode_attention(
    q: torch.Tensor,          # [B, H, D] one new token per slot
    k_self: torch.Tensor,     # [B, Hkv, D] the new token's K (not in pool)
    v_self: torch.Tensor,     # [B, Hkv, D]
    pages: torch.Tensor,      # [L, P, 2, Hkv, page, D] the WHOLE pool
    layer: int,
    table: torch.Tensor,      # [B, M] i32
    lens: torch.Tensor,       # [B] i32 tokens RESIDENT IN THE POOL (excl. self)
    *,
    softmax_scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    scales: Optional[torch.Tensor] = None,  # [L, P, 2, Hkv, page] int8 pools
) -> torch.Tensor:
    """Single-token attention against paged KV plus the token itself: the
    pool holds positions ``[0, lens)``, the query sits at ``lens`` and
    always attends itself. Returns ``[B, H, D]``. The self token's K/V
    stay full precision under an int8 pool (they are quantized when the
    caller scatters them after its layer loop). CUDA tensors go to the
    kernel, CPU tensors to :func:`decode_plain`."""
    fn = decode_plain if q.device.type == "cpu" else cuda_paged.decode
    return fn(
        q, k_self, v_self, pages, layer, table, lens,
        softmax_scale=softmax_scale, soft_cap=soft_cap,
        sliding_window=sliding_window, scales=scales,
    )


def decode_plain(
    q, k_self, v_self, pages, layer, table, lens, *,
    softmax_scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    scales: Optional[torch.Tensor] = None,
    pages_per_split: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the paged-decode kernel
    (``ops/cuda/paged_attention.py::decode``), as the JAX package's XLA
    branch (``areal_tpu/ops/paged_attention.py:188-218``): gather the slots'
    pages into contiguous views (dequantized for an int8 pool), masked
    softmax over ``[0, lens)`` merged with the always-attended self token.

    ``pages_per_split`` mirrors the kernel's arithmetic instead of one
    pass: per-split partials ``(m, l, acc)`` under the kernel's split plan
    (``cuda_paged.plan``); the splits with a visible position are rescaled
    to their common max and summed in split order (an empty split, with
    its sentinel max and zero sum, takes no part), then the self token
    folds in with the kernel's sentinel guard."""
    B, H, D = q.shape
    Hkv, page = pages.shape[3], pages.shape[4]
    n_rep = H // Hkv
    if softmax_scale is None:
        softmax_scale = D ** -0.5
    k, v = gather_dequant_pages(pages, table, layer, scales)  # [B, S, Hkv, D]
    S = k.shape[1]
    qg = q.reshape(B, Hkv, n_rep, D).float()
    s_pool = torch.einsum("bgrd,bsgd->bgrs", qg, k.float()) * softmax_scale
    s_self = torch.einsum(
        "bgrd,bgd->bgr", qg, k_self.to(q.dtype).float()
    ) * softmax_scale
    if soft_cap is not None:
        s_pool = soft_cap * torch.tanh(s_pool / soft_cap)
        s_self = soft_cap * torch.tanh(s_self / soft_cap)
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < lens[:, None]                           # [B, S]
    if sliding_window is not None:
        # the query sits at position lens
        mask &= pos > lens[:, None] - sliding_window
    mask = mask[:, None, None]
    s_pool = torch.where(mask, s_pool, NEG_INF)
    if pages_per_split is None:
        m = torch.maximum(s_pool.amax(-1), s_self)       # [B, Hkv, r]
        p_pool = torch.where(mask, torch.exp(s_pool - m[..., None]), 0.0)
        p_self = torch.exp(s_self - m)
        denom = p_pool.sum(-1) + p_self
        acc = torch.einsum(
            "bgrs,bsgd->bgrd", p_pool.to(v.dtype).float(), v.float()
        ) + p_self[..., None] * v_self[:, :, None].float()
        return (acc / denom[..., None]).reshape(B, H, D).to(q.dtype)

    plan = cuda_paged.plan(table.shape[1], page, pages_per_split)
    step = plan.pages_per_split * page
    parts = []                                           # (live, m, l, acc)
    for lo in range(0, S, step):
        s_sp, mk = s_pool[..., lo:lo + step], mask[..., lo:lo + step]
        m_sp = s_sp.amax(-1)                             # NEG_INF if empty
        p = torch.where(mk, torch.exp(s_sp - m_sp[..., None]), 0.0)
        acc_sp = torch.einsum("bgrs,bsgd->bgrd", p.to(v.dtype).float(),
                              v[:, lo:lo + step].float())
        parts.append((mk.any(-1), m_sp, p.sum(-1), acc_sp))
    # live splits against their common max, summed in split order
    m = torch.full_like(s_self, NEG_INF)
    for live, m_sp, _, _ in parts:
        m = torch.where(live, torch.maximum(m, m_sp), m)
    l = torch.zeros_like(s_self)
    acc = torch.zeros(B, Hkv, n_rep, D, device=q.device)
    for live, m_sp, l_sp, acc_sp in parts:
        w = torch.where(live, torch.exp(m_sp - m), 0.0)
        l = l + l_sp * w
        acc = acc + acc_sp * w[..., None]
    m_new = torch.maximum(m, s_self)
    corr = torch.exp(torch.where(m > NEG_INF / 2, m - m_new, 0.0))
    p_self = torch.exp(s_self - m_new)
    l = l * corr + p_self
    acc = acc * corr[..., None] + p_self[..., None] * v_self[:, :, None].float()
    return (acc / l[..., None]).reshape(B, H, D).to(q.dtype)


def paged_extend_attention(
    q: torch.Tensor,          # [B, C, H, D] chunk of new tokens
    k_chunk: torch.Tensor,    # [B, C, Hkv, D] the chunk's K (not in pool)
    v_chunk: torch.Tensor,
    pages: torch.Tensor,      # [L, P, 2, Hkv, page, D] the WHOLE pool
    layer: int,
    table: torch.Tensor,      # [B, M]
    start: torch.Tensor,      # [B] tokens RESIDENT IN THE POOL (chunk start)
    n_new: torch.Tensor,      # [B] valid new tokens in the chunk (<= C)
    *,
    softmax_scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    kv_block: int = 1024,
    skip_pool: bool = False,
    scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked-prefill attention: chunk token i (global position start+i)
    attends every pool position < start plus chunk tokens <= i. Returns
    ``[B, C, H, D]``; rows past ``n_new`` are zero.

    ``skip_pool``: the caller knows every row starts at position 0, so the
    pool holds nothing visible and its gather + scan are skipped. The pool
    part runs as a blockwise online softmax over ``kv_block`` positions at
    a time, so scores peak at ``[B, H, C, kv_block]``; GQA never
    materializes a K/V repeat."""
    B, C, H, D = q.shape
    Hkv = pages.shape[3]
    n_rep = H // Hkv
    if softmax_scale is None:
        softmax_scale = D ** -0.5
    dev = q.device
    qg = q.reshape(B, C, Hkv, n_rep, D).float()
    qpos_in_chunk = torch.arange(C, device=dev)
    valid_q = qpos_in_chunk[None, :] < n_new[:, None]        # [B, C]

    # ---- intra-chunk causal part (every token attends itself) ----------
    s_in = torch.einsum(
        "bcgrd,bsgd->bgrcs", qg, k_chunk.to(q.dtype).float()
    ) * softmax_scale                                        # [B,g,r,C,C]
    if soft_cap is not None:
        s_in = soft_cap * torch.tanh(s_in / soft_cap)
    causal = qpos_in_chunk[:, None] >= qpos_in_chunk[None, :]  # [C, C]
    in_mask = causal[None] & valid_q[:, None, :]             # [B, C, C]
    if sliding_window is not None:
        in_mask &= (
            qpos_in_chunk[:, None] - qpos_in_chunk[None, :] < sliding_window
        )[None]
    in_mask = in_mask[:, None, None]
    s_in = torch.where(in_mask, s_in, NEG_INF)
    m = s_in.amax(-1)                                        # [B,g,r,C]
    p_in = torch.where(in_mask, torch.exp(s_in - m[..., None]), 0.0)
    l = p_in.sum(-1)
    acc = torch.einsum(
        "bgrcs,bsgd->bgrcd", p_in.to(v_chunk.dtype).float(), v_chunk.float()
    )

    if not skip_pool:
        # ---- pool part: blockwise online softmax over resident KV ------
        k, v = gather_dequant_pages(pages, table, layer, scales)
        S = k.shape[1]
        Sb = kv_block if S % kv_block == 0 else S
        qpos = start[:, None] + qpos_in_chunk[None, :]       # [B, C]
        for off in range(0, S, Sb):
            k_blk = k[:, off : off + Sb]
            v_blk = v[:, off : off + Sb]
            s = torch.einsum(
                "bcgrd,bsgd->bgrcs", qg, k_blk.float()
            ) * softmax_scale
            if soft_cap is not None:
                s = soft_cap * torch.tanh(s / soft_cap)
            kpos = off + torch.arange(Sb, device=dev)        # [Sb]
            # every pool position < start is causally visible to every
            # chunk token; the per-token bound only matters for the window
            mask = (kpos[None, None, :] < start[:, None, None]).expand(
                B, C, Sb
            )
            if sliding_window is not None:
                mask = mask & (
                    kpos[None, None, :] > qpos[:, :, None] - sliding_window
                )
            mask = mask[:, None, None]
            s = torch.where(mask, s, NEG_INF)                # [B,g,r,C,Sb]
            m_new = torch.maximum(m, s.amax(-1))
            # m stays at the sentinel while everything so far is masked;
            # keep the rescale finite
            alpha = torch.exp(
                torch.where(m > NEG_INF / 2, m - m_new, torch.zeros_like(m))
            )
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrcs,bsgd->bgrcd", p.to(v_blk.dtype).float(), v_blk.float()
            )
            m = m_new

    out = acc / l.clamp_min(1e-30)[..., None]               # [B,g,r,C,D]
    out = out.movedim(3, 1).reshape(B, C, H, D)
    # fully-masked (invalid) rows carry garbage; zero them
    out = torch.where(valid_q[:, :, None, None], out, 0.0)
    return out.to(q.dtype)
