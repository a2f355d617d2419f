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
over real tokens, padding at the tail). ``decode_attention`` (the dense
KV-cache decode path) is not ported yet.
"""

from typing import Optional, Tuple

import torch

from areal_tpu_torch.ops.cuda import flash_attention as cuda_flash

NEG_INF = -2.3819763e38  # ~ -float32 max; the reference's finite mask value


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
