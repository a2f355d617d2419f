"""Mixture-of-experts MLP: a top-k router and its experts (counterpart of
``areal_tpu/ops/moe.py``). Two dispatch modes, selected by
``MoEConfig.dispatch``:

- ``"dense"``: every expert computed for every token, combined with the
  routing weights. No host read and no data-dependent shape, so it runs
  inside the serving paths' CUDA graphs.
- ``"ragged"``: the token copies sorted by expert id, each expert's rows a
  contiguous block, and one GEMM per expert over its block: O(T·K) expert
  FLOPs instead of O(T·X). The reference's ``lax.ragged_dot`` is XLA, not
  a kernel; here the grouped GEMM is plain PyTorch, ``torch.matmul`` per
  expert over ``torch.split`` of the rows, with the group sizes read on
  the host once per call. That read keeps the ragged path out of CUDA
  graphs (the generation engine and ``SyncGenerator`` refuse it).

The router runs in float32. The aux loss is built from per-call routing
statistics (``routing_stats``) that add across calls, so one aux over
several packed rows (the ragged estimator of
``train/engine.py::vmapped_forward``) is the aux of their summed
statistics.
"""

from typing import Optional, Tuple

import torch

from areal_tpu_torch.ops.activations import ACT2FN

DISPATCHES = ("dense", "ragged")


def _route(cfg, router_w, x):
    """The float32 router shared by both dispatch paths: ``(top_vals [T,
    K]`` normalized and scaled combine weights, ``top_idx [T, K]``, ``probs
    [T, X]``, ``logits [T, X])``."""
    moe = cfg.moe
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, moe.top_k, dim=-1)
    if moe.norm_topk_prob:
        top_vals = top_vals / top_vals.sum(-1, keepdim=True)
    return top_vals * moe.routed_scaling_factor, top_idx, probs, logits


def router_probs(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(combine_weights [T, X], router_logits [T, X])``: the top-k
    weights scattered back to ``[T, X]`` (zero elsewhere)."""
    top_vals, top_idx, probs, logits = _route(cfg, p["router"], x)
    return torch.zeros_like(probs).scatter(-1, top_idx, top_vals), logits


def routing_stats(counts, probs, logits) -> torch.Tensor:
    """One call's routing statistics ``[2X + 2]`` float32: the (token,
    slot) selections per expert, the router probabilities summed over
    tokens, the summed squared log-normaliser and the token count. Sums
    only, so the statistics of several calls add."""
    z = torch.logsumexp(logits, dim=-1).square().sum()
    n = torch.full((1,), probs.shape[0], dtype=torch.float32,
                   device=probs.device)
    return torch.cat([counts.float(), probs.sum(0), z[None], n])


def _aux_tail(cfg, stats):
    """The Switch-style load-balance loss plus the z loss from routing
    statistics ``[..., 2X + 2]`` (``routing_stats``) -> ``[...]``: the
    reference's ``_aux_tail`` over the means these sums give."""
    moe = cfg.moe
    X = moe.num_experts
    n = stats[..., -1:]
    frac_tokens, frac_probs = stats[..., :X] / n, stats[..., X:2 * X] / n
    aux = X * (frac_tokens * frac_probs).sum(-1)
    z = stats[..., 2 * X] / n[..., 0]
    return moe.aux_loss_coeff * aux + moe.z_loss_coeff * z


def aux_loss(cfg, stats):
    """The router loss of a model's layers from their routing statistics
    ``[..., L, S]`` (``forward_packed(with_aux=True)``'s second output):
    each layer's aux summed over layers -> ``[...]``. A model without MoE
    layers gives ``S == 0`` and a zero."""
    if cfg.mlp_type != "moe":
        return stats.new_zeros(stats.shape[:-2])
    return _aux_tail(cfg, stats).sum(-1)


def load_balancing_aux_loss(cfg, combine, logits):
    """The Switch-style aux loss from a dense call's combine weights and
    router logits, in float32."""
    probs = torch.softmax(logits, dim=-1)
    counts = (combine > 0).float().sum(0)
    return _aux_tail(cfg, routing_stats(counts, probs, logits))


def check_graphable(cfg, where: str):
    """Raise unless ``cfg``'s MLP can run inside a CUDA graph: the ragged
    dispatch reads its group sizes on the host, so a graphed path built
    over it would capture one routing and replay it for every other."""
    if cfg.mlp_type == "moe" and cfg.moe.dispatch == "ragged":
        raise ValueError(
            f"{where} runs the model in CUDA graphs, which the MoE "
            f"dispatch=\"ragged\" cannot enter (its grouped GEMM reads the "
            f"group sizes on the host); serve with dispatch=\"dense\"")


def moe_forward(cfg, p, x, with_stats: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: ``[..., E]`` -> (``[..., E]``, routing statistics ``[2X + 2]``
    or None). Dispatch per ``cfg.moe.dispatch``; an unknown mode raises."""
    dispatch = cfg.moe.dispatch
    if dispatch not in DISPATCHES:
        raise ValueError(f"MoEConfig.dispatch must be 'dense' or 'ragged', "
                         f"got {dispatch!r}")
    lead = x.shape[:-1]
    xt = x.reshape(-1, x.shape[-1])
    run = _moe_mlp_ragged if dispatch == "ragged" else _moe_mlp_dense
    out, stats = run(cfg, p, xt, with_stats)
    return out.reshape(*lead, -1), stats


def moe_mlp(cfg, p, x):
    """x: ``[..., E]`` -> (``[..., E]``, aux loss), as the reference's.
    The aux includes padding tokens (the layer has no mask)."""
    out, stats = moe_forward(cfg, p, x, with_stats=True)
    return out, _aux_tail(cfg, stats)


def _moe_mlp_dense(cfg, p, xt, with_stats):
    """Every expert over every token: ``[X, T, F]`` intermediates, the
    combine weighting each expert's output and summing over experts."""
    act = ACT2FN[cfg.activation_function]
    top_vals, top_idx, probs, logits = _route(cfg, p["router"], xt)
    combine = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    h = act(torch.matmul(xt, p["w_gate"])) * torch.matmul(xt, p["w_up"])
    y = torch.matmul(h, p["w_down"])                        # [X, T, E]
    out = (y * combine.T.to(y.dtype)[:, :, None]).sum(0, dtype=torch.float32)
    stats = None
    if with_stats:
        stats = routing_stats((combine > 0).float().sum(0), probs, logits)
    return out.to(xt.dtype), stats


def _grouped_matmul(a, w, sizes):
    """``a``'s expert-contiguous row blocks (``sizes`` rows each, on the
    host) times their expert's weight ``w[j]``."""
    return torch.cat([blk @ w[j]
                      for j, blk in enumerate(torch.split(a, sizes))])


def _moe_mlp_ragged(cfg, p, xt, with_stats):
    """The T·K (token, slot) copies sorted stably by expert id, three
    grouped GEMMs over the expert-contiguous rows, then a deterministic
    combine: the sort undone by its inverse permutation and the K slots of
    each token summed in slot order (no atomics)."""
    act = ACT2FN[cfg.activation_function]
    T, K, X = xt.shape[0], cfg.moe.top_k, cfg.moe.num_experts
    top_vals, top_idx, probs, logits = _route(cfg, p["router"], xt)
    flat = top_idx.reshape(-1)                              # [T*K]
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=X)
    sizes = counts.tolist()       # the host read: one per call
    xs = xt[order // K]                                     # [T*K, E]
    h = act(_grouped_matmul(xs, p["w_gate"], sizes)) * _grouped_matmul(
        xs, p["w_up"], sizes)
    y = _grouped_matmul(h, p["w_down"], sizes)              # [T*K, E]
    y = y * top_vals.reshape(-1)[order].to(y.dtype)[:, None]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    slots = y[inverse].reshape(T, K, -1)
    out = slots[:, 0].float()
    for k in range(1, K):
        out = out + slots[:, k].float()
    stats = routing_stats(counts, probs, logits) if with_stats else None
    return out.to(xt.dtype), stats
