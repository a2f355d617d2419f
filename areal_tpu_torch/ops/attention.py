"""Packed varlen causal attention (counterpart of
``areal_tpu/ops/attention.py``).

Sequences are packed into one token axis with integer ``segment_ids`` (0 =
padding, real segments from 1). A token attends a key iff they share a
nonzero segment id and the key does not come later in the packed order
(and, with a sliding window, is less than ``window`` tokens back).

``packed_attention`` dispatches by the tensors' device: a CUDA tensor goes
to the hand-written flash kernels (``ops/cuda/flash_attention.py``, forward
and backward through a ``torch.autograd.Function``), a CPU tensor to the
plain version :func:`attention_plain`, differentiated by autograd. The
kernels take the band contract stated in that module (ids non-decreasing
over real tokens, padding at the tail). :func:`attention_tiled` and
:func:`attention_tiled_backward` mirror the kernels' tiling (rows, key
and query tiles, online softmax, the dk/dv parts summed in part order)
on the CPU, so that the schedule is tested against the reference.

:func:`decode_attention` is the dense KV-cache decode path of the
synchronous generator (``train/generation.py``). The reference runs it as
XLA, not Pallas, so its port is plain PyTorch on every device.
"""

from typing import Optional, Tuple

import torch

from areal_tpu_torch.ops.cuda import flash_attention as cuda_flash

NEG_INF = -2.3819763e38  # ~ -float32 max; the reference's finite mask value
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def attention_plain(
    q: torch.Tensor,            # [T, H, D]
    k: torch.Tensor,            # [T, Hkv, D]
    v: torch.Tensor,            # [T, Hkv, D]
    segment_ids: torch.Tensor,  # [T]
    softmax_scale: float,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the flash kernels, as the reference's
    XLA branch ``_attention_xla`` (``areal_tpu/ops/attention.py:40-70``):
    f32 scores, mask, softmax, fully masked rows zeroed, probabilities
    rounded to V's dtype before PV. Returns ``(out [T, H, D] in V's dtype,
    lse [H, T] f32)``, lse natural-log and ``NEG_INF`` on pad rows. GQA
    never repeats K/V: query heads fold as ``[Hkv, n_rep]``."""
    T, H, D = q.shape
    Hkv = k.shape[1]
    n_rep = H // Hkv
    qg = q.reshape(T, Hkv, n_rep, D).float()
    scores = torch.einsum("qgrd,kgd->grqk", qg, k.float()) * softmax_scale
    if soft_cap is not None:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    idx = torch.arange(T, device=q.device)
    seg = segment_ids
    mask = (seg[:, None] == seg[None, :]) & (seg[:, None] > 0)
    mask &= idx[:, None] >= idx[None, :]
    if sliding_window is not None:
        mask &= idx[:, None] - idx[None, :] < sliding_window
    scores = torch.where(mask, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    live = mask.any(dim=-1)                             # [T]
    probs = torch.where(live[:, None], probs, 0.0)
    lse = torch.where(live, lse, NEG_INF)
    out = torch.einsum("grqk,kgd->qgrd", probs.to(v.dtype), v)
    return out.reshape(T, H, D), lse.reshape(H, T)


def _mirror_setup(q, k, segment_ids, sliding_window):
    T, H, D = q.shape
    sp = cuda_flash.plan(T, H, k.shape[1], D)
    seg = segment_ids.to(torch.int32)
    start, end = cuda_flash.segment_bounds(seg)
    return sp, seg.tolist(), start.tolist(), end.tolist()


def _visible_from(seg, start, t, window):
    """First key token t sees (its segment or window start); None for pad."""
    if seg[t] <= 0:
        return None
    lo = start[t]
    return max(lo, t - window + 1) if window else lo


def _scores(s, softmax_scale, soft_cap):
    """log2-domain scores of raw dot products and the cap's tanh (or None)."""
    if soft_cap is None:
        return s * (softmax_scale * LOG2E), None
    tt = torch.tanh(s * (softmax_scale / soft_cap))
    return soft_cap * LOG2E * tt, tt


def _row_mask(seg, start, t0, n, n_rep, k0, n_keys, window):
    """[n * n_rep, n_keys] visibility of keys [k0, k0 + n_keys) from the
    token-major folded rows of tokens [t0, t0 + n)."""
    kt = torch.arange(k0, k0 + n_keys)
    rows = []
    for t in range(t0, t0 + n):
        lo = _visible_from(seg, start, t, window)
        m = (kt >= lo) & (kt <= t) if lo is not None else torch.zeros_like(
            kt, dtype=torch.bool)
        rows.extend([m] * n_rep)
    return torch.stack(rows)


def attention_tiled(
    q: torch.Tensor,            # [T, H, D]
    k: torch.Tensor,            # [T, Hkv, D]
    v: torch.Tensor,            # [T, Hkv, D]
    segment_ids: torch.Tensor,  # [T]
    softmax_scale: float,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's schedule and arithmetic in plain PyTorch (f32,
    on the CPU): the warpgroups' token-major folded rows, key tiles from
    each block's key start (``ops/cuda/flash_attention.py::q_schedule``),
    online softmax in the log2 domain with rescaling, P rounded to V's
    dtype before PV. Returns ``(out [T, H, D] in V's dtype, lse [H, T])``
    as :func:`attention_plain`."""
    T, H, D = q.shape
    Hkv = k.shape[1]
    sp, seg, start, _ = _mirror_setup(q, k, segment_ids, sliding_window)
    n_rep, bk = sp.n_rep, sp.key_tile
    out = torch.zeros(T, H, D)
    lse = torch.full((H, T), NEG_INF)
    for g in range(Hkv):
        heads = slice(g * n_rep, (g + 1) * n_rep)
        for t0, n, tiles in cuda_flash.q_schedule(seg, start, sp,
                                                   sliding_window):
            qr = q[t0:t0 + n, heads].float().reshape(n * n_rep, D)
            m = torch.full((n * n_rep,), NEG_INF)
            l = torch.zeros(n * n_rep)
            acc = torch.zeros(n * n_rep, D)
            for k0 in tiles:
                nk = min(bk, T - k0)  # keys past T are zero-filled and masked
                x, _ = _scores(qr @ k[k0:k0 + nk, g].float().T, softmax_scale,
                               soft_cap)
                ok = _row_mask(seg, start, t0, n, n_rep, k0, nk, sliding_window)
                x = torch.where(ok, x, NEG_INF)
                m_new = torch.maximum(m, x.max(-1).values)
                corr = torch.exp2(m - m_new)
                p = torch.where(ok, torch.exp2(x - m_new[:, None]), 0.0)
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + p.to(v.dtype).float() @ \
                    v[k0:k0 + nk, g].float()
                m = m_new
            live = l > 0
            o = torch.where(live[:, None], acc / torch.where(live, l, 1.0)[:, None],
                            0.0)
            out[t0:t0 + n, heads] = o.reshape(n, n_rep, D)
            lse[heads, t0:t0 + n] = torch.where(
                live, m * LN2 + torch.log(torch.where(live, l, 1.0)),
                NEG_INF).reshape(n, n_rep).T
    return out.to(v.dtype), lse


def attention_tiled_backward(
    q, k, v, segment_ids, out, lse, dout, softmax_scale: float,
    soft_cap: Optional[float] = None, sliding_window: Optional[int] = None,
    parts: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' schedule and arithmetic in plain PyTorch (f32,
    on the CPU): dq over the forward's folded rows and key tiles (P from
    lse, dS = P (dP - delta)); dk and dv per kv head over 64-key
    warpgroups and query tiles (``k_schedule``), for each of the plan's
    ``parts`` (heads ``[p * n_rep / parts, (p + 1) * n_rep / parts)`` of
    the group) into its own f32 partial, the parts summed in part order
    (``parts`` overrides the plan's, to exercise other splits of the group).
    P and dS round to the inputs' dtype before the second products.
    Returns ``(dq, dk, dv)`` in the inputs' dtype."""
    T, H, D = q.shape
    Hkv = k.shape[1]
    sp, seg, start, end = _mirror_setup(q, k, segment_ids, sliding_window)
    if parts is not None:
        if sp.n_rep % parts:
            raise ValueError(f"{parts} parts do not divide a group of {sp.n_rep}")
        sp = sp._replace(parts=parts)
    n_rep, bk, bq = sp.n_rep, sp.key_tile, sp.q_tile
    dt = q.dtype
    lse2 = torch.clamp(lse.float() * LOG2E, min=NEG_INF)       # [H, T]
    delta = (dout.float() * out.float()).sum(-1).T             # [H, T]
    dq = torch.zeros(T, H, D)
    for g in range(Hkv):
        heads = slice(g * n_rep, (g + 1) * n_rep)
        for t0, n, tiles in cuda_flash.q_schedule(seg, start, sp,
                                                   sliding_window):
            qr = q[t0:t0 + n, heads].float().reshape(n * n_rep, D)
            dor = dout[t0:t0 + n, heads].float().reshape(n * n_rep, D)
            l2 = lse2[heads, t0:t0 + n].T.reshape(-1)
            dl = delta[heads, t0:t0 + n].T.reshape(-1)
            acc = torch.zeros(n * n_rep, D)
            for k0 in tiles:
                nk = min(bk, T - k0)
                kk, vv = k[k0:k0 + nk, g].float(), v[k0:k0 + nk, g].float()
                x, tt = _scores(qr @ kk.T, softmax_scale, soft_cap)
                ok = _row_mask(seg, start, t0, n, n_rep, k0, nk, sliding_window)
                p = torch.where(ok, torch.exp2(x - l2[:, None]), 0.0)
                ds = p * (dor @ vv.T - dl[:, None])
                if tt is not None:
                    ds = ds * (1 - tt * tt)
                acc = acc + ds.to(dt).float() @ kk
            dq[t0:t0 + n, heads] = (acc * softmax_scale).reshape(n, n_rep, D)
    parts = torch.zeros(sp.parts, 2, T, Hkv, D)
    hp = n_rep // sp.parts
    for g in range(Hkv):
        for kw0, n, tiles in cuda_flash.k_schedule(seg, start, end, sp,
                                                     sliding_window):
            kk = k[kw0:kw0 + n, g].float()
            vv = v[kw0:kw0 + n, g].float()
            kt = torch.arange(kw0, kw0 + n)
            hi = torch.tensor([
                (min(end[t], t + sliding_window) if sliding_window else end[t])
                if seg[t] > 0 else t for t in range(kw0, kw0 + n)])
            for part in range(sp.parts):
                dk_p = torch.zeros(n, D)
                dv_p = torch.zeros(n, D)
                for h in range(g * n_rep + part * hp, g * n_rep + (part + 1) * hp):
                    for qq in tiles:
                        nq = min(bq, T - qq)
                        qt = q[qq:qq + nq, h].float()
                        dot = dout[qq:qq + nq, h].float()
                        x, tt = _scores(kk @ qt.T, softmax_scale, soft_cap)
                        tq = torch.arange(qq, qq + nq)
                        ok = (tq[None] >= kt[:, None]) & (tq[None] < hi[:, None])
                        p = torch.where(ok, torch.exp2(x - lse2[h, qq:qq + nq]), 0.0)
                        ds = p * (vv @ dot.T - delta[h, qq:qq + nq])
                        if tt is not None:
                            ds = ds * (1 - tt * tt)
                        dv_p = dv_p + p.to(dt).float() @ dot
                        dk_p = dk_p + ds.to(dt).float() @ qt
                parts[part, 0, kw0:kw0 + n, g] = dk_p
                parts[part, 1, kw0:kw0 + n, g] = dv_p
    total = parts[0]
    for part in range(1, sp.parts):
        total = total + parts[part]
    return (dq.to(dt), (total[0] * softmax_scale).to(dt), total[1].to(dt))


def decode_attention(
    q: torch.Tensor,            # [B, H, D] one new token per sequence
    k_cache: torch.Tensor,      # [B, S, Hkv, D]
    v_cache: torch.Tensor,      # [B, S, Hkv, D]
    cache_lens: torch.Tensor,   # [B] valid entries, the new token included
    *,
    softmax_scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode attention against a per-sequence KV cache (the
    reference's ``decode_attention``): the new token's K/V must already sit
    at ``cache_lens - 1``. f32 scores, keys at ``[lens - window, lens)``
    (all of ``[0, lens)`` without a window), probabilities rounded to V's
    dtype before PV, and an all-zero output for a row with ``cache_lens ==
    0``. Returns ``[B, H, D]`` in V's dtype.

    GQA never repeats K/V: the queries fold as ``[B, Hkv, n_rep, D]``, and
    each kv head's two products are batched matmuls over the cache in its
    own layout (a kv head's ``[B, S, D]`` slice is a strided batch of
    row-major matrices), so no transposed copy of K or V is made; K is
    read as f32 one kv head at a time for the f32 scores."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if softmax_scale is None:
        softmax_scale = D ** -0.5
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    scores = torch.stack([
        torch.bmm(qg[:, g], k_cache[:, :, g].float().transpose(1, 2))
        for g in range(Hkv)
    ], dim=1) * softmax_scale                          # [B, Hkv, n_rep, S]
    if soft_cap is not None:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    pos = torch.arange(S, device=q.device)[None, :]
    lens = cache_lens[:, None]
    mask = pos < lens
    if sliding_window is not None:
        mask &= pos >= lens - sliding_window
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where((cache_lens > 0)[:, None, None, None], probs, 0.0)
    probs = probs.to(v_cache.dtype)
    out = torch.stack([torch.bmm(probs[:, g], v_cache[:, :, g])
                       for g in range(Hkv)], dim=1)
    return out.reshape(B, H, D)


def packed_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    *,
    softmax_scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    max_seqlen: Optional[int] = None,
) -> torch.Tensor:
    """Causal self-attention over a packed token axis: ``q [T, H, D]``,
    ``k``/``v`` ``[T, Hkv, D]`` -> ``[T, H, D]``. ``max_seqlen`` is accepted
    for the reference's signature and ignored: the kernels derive each
    block's exact key range, and the train engine rejects sequences over
    ``ModelConfig.attn_max_seqlen`` itself."""
    del max_seqlen
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, segment_ids, softmax_scale, soft_cap,
                               sliding_window)[0]
    return cuda_flash.flash_attention(
        q, k, v, segment_ids, softmax_scale=softmax_scale, soft_cap=soft_cap,
        sliding_window=sliding_window,
    )
