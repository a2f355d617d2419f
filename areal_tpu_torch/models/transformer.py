"""The transformer as plain PyTorch functions (counterpart of
``areal_tpu/models/transformer.py``): the packed training / logprob
forward, the dense-KV generation path (``KVCache``, ``prefill``,
``decode_step``: the synchronous generator's) and the paged-KV one.

Parameters are a plain dict. The JAX package stacks layer params on a
leading ``[L, ...]`` axis for its ``lax.scan``; the port keeps one dict
per layer in ``params["layers"]`` (a Python loop over layers needs no
stacking), and keeps the JAX weight layout ``[in, out]`` so that
``x @ w`` reads the same in both packages. :func:`params_from_numpy`
converts a JAX param tree (as numpy) into this form and
:func:`params_to_numpy` back.

The packed forward takes f32 master params and casts them to
``cfg.dtype`` where they are used — per layer INSIDE the checkpointed
layer, as the reference does — so bf16 compute sends its gradients to the
f32 masters and no bf16 copy of the weights persists. The paged path
expects params already in ``cfg.dtype`` (:func:`cast_params`; the
generation engine casts once when it takes params), where those casts are
no-ops. The dense path casts per layer as the reference does; its
caller (``train/generation.py``) hands it params cast once, where those
casts are no-ops too. Logits come out in float32.
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (checkpoint,
                                     create_selective_checkpoint_contexts)

from areal_tpu_torch.base.device import resolve_device, torch_dtype
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.ops import attention as attn_ops
from areal_tpu_torch.ops import moe as moe_ops
from areal_tpu_torch.ops import norms
from areal_tpu_torch.ops import paged_attention as paged_ops
from areal_tpu_torch.ops import ppo as ppo_ops
from areal_tpu_torch.ops.activations import ACT2FN
from areal_tpu_torch.ops.rotary import RotaryConfig, apply_rotary, rotary_cos_sin

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of a dict/list param tree (and the
    matching leaves of ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def cast_params(cfg: ModelConfig, params: Params, device=None) -> Params:
    """Params in the serving dtype (``cfg.dtype``) on ``device``."""
    dt = torch_dtype(cfg.dtype)
    return tree_map(lambda t: t.to(device=device, dtype=dt), params)


def _cast(cfg: ModelConfig, tree):
    """``tree`` in ``cfg.dtype`` (differentiable; a no-op on params that
    are already in it)."""
    dt = torch_dtype(cfg.dtype)
    return tree_map(lambda t: t.to(dt), tree)


def init_params(
    cfg: ModelConfig, seed: int = 0, device=None, dtype=torch.float32
) -> Params:
    """Random init on the device: normal(0.02) weights, zero biases, unit
    norm gains (gemma stores gains as deltas, so they init to 0 there).
    Draws come from a ``torch.Generator`` seeded with ``seed``; they are
    not the JAX package's draws."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    E, D = cfg.hidden_dim, cfg.head_dim
    Hq, Hkv, F, V = (cfg.n_q_heads, cfg.n_kv_heads, cfg.intermediate_dim,
                     cfg.vocab_size)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def gain(*shape):
        fill = 0.0 if cfg.layer_norm_type == "gemma" else 1.0
        return torch.full(shape, fill, device=device, dtype=dtype)

    has_ln_bias = cfg.layer_norm_type == "layer"

    def ln():
        p = {"weight": gain(E)}
        if has_ln_bias:
            p["bias"] = zeros(E)
        return p

    def layer():
        attn = {"wq": w(E, Hq * D), "wk": w(E, Hkv * D),
                "wv": w(E, Hkv * D), "wo": w(Hq * D, E)}
        if cfg.use_attention_bias:
            attn.update(bq=zeros(Hq * D), bk=zeros(Hkv * D),
                        bv=zeros(Hkv * D))
        if cfg.use_attn_proj_bias:
            attn["bo"] = zeros(E)
        if cfg.qk_layernorm:
            attn["q_norm"] = torch.ones(D, device=device, dtype=dtype)
            attn["k_norm"] = torch.ones(D, device=device, dtype=dtype)
        if cfg.mlp_type == "gated":
            mlp = {"w_gate": w(E, F), "w_up": w(E, F), "w_down": w(F, E)}
        elif cfg.mlp_type == "fc":
            mlp = {"w_fc": w(E, F), "w_proj": w(F, E)}
            if cfg.use_mlp_bias:
                mlp.update(b_fc=zeros(F), b_proj=zeros(E))
        elif cfg.mlp_type == "moe":
            X = cfg.moe.num_experts
            mlp = {"router": w(E, X), "w_gate": w(X, E, F),
                   "w_up": w(X, E, F), "w_down": w(X, F, E)}
        else:
            raise ValueError(cfg.mlp_type)
        return {"ln1": ln(), "attn": attn, "ln2": ln(), "mlp": mlp}

    params: Params = {
        "embed": {"weight": w(V, E)},
        "layers": [layer() for _ in range(cfg.n_layers)],
        "final_ln": ln(),
    }
    if cfg.abs_position_embedding:
        params["pos_embed"] = {"weight": w(cfg.n_positions, E)}
    if cfg.is_critic:
        params["head"] = {"weight": w(E, 1)}
    elif not cfg.tied_embedding:
        params["head"] = {"weight": w(E, V)}
    return params


def _to_tensor(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":   # ml_dtypes arrays: no torch twin
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable, contiguous copy
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree: Dict[str, Any], device=None, dtype=None) -> Params:
    """The JAX package's param dict (stacked ``[L, ...]`` layer leaves,
    numpy arrays, ``[in, out]`` weights) -> the port's param dict on
    ``device`` (``dtype`` None keeps each leaf's dtype)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype) if dtype is not None else None
    out: Params = {}
    for k, v in tree.items():
        if k == "layers":
            stacked = tree_map(lambda a: _to_tensor(a, device, dtype), v)
            n = len(next(iter(stacked["ln1"].values())))
            out[k] = [tree_map(lambda t, i=i: t[i].contiguous(), stacked)
                      for i in range(n)]
        else:
            out[k] = tree_map(lambda a: _to_tensor(a, device, dtype), v)
    return out


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: float32 numpy arrays in
    the JAX package's layout (layer leaves stacked ``[L, ...]``). The
    arrays are copies: a later in-place update of ``params`` (an optimizer
    step) does not reach them."""

    def host(t):
        h = t.detach().float().cpu()
        if h.data_ptr() == t.data_ptr():   # f32 on the CPU: no copy so far
            h = h.clone()
        return h.numpy()

    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = tree_map(
                lambda *leaves: np.stack([host(t) for t in leaves]), *v
            )
        else:
            out[k] = tree_map(host, v)
    return out


# --------------------------------------------------------------------------- #
# Layer pieces
# --------------------------------------------------------------------------- #


def _norm(cfg: ModelConfig, p, x):
    if cfg.layer_norm_type == "layer":
        return norms.layer_norm(x, p["weight"], p.get("bias"),
                                cfg.layer_norm_epsilon)
    return norms.rms_norm(x, p["weight"], cfg.layer_norm_epsilon,
                          plus_one=cfg.layer_norm_type == "gemma")


def _qkv(cfg: ModelConfig, p, x):
    """x: [..., E] -> q [..., Hq, D], k/v [..., Hkv, D] (no rotary yet)."""
    D = cfg.head_dim

    def proj(w, b, h):
        y = x @ w
        if b is not None:
            y = y + b
        return y.reshape(*x.shape[:-1], h, D)

    q = proj(p["wq"], p.get("bq"), cfg.n_q_heads)
    k = proj(p["wk"], p.get("bk"), cfg.n_kv_heads)
    v = proj(p["wv"], p.get("bv"), cfg.n_kv_heads)
    if cfg.qk_layernorm:
        q = norms.rms_norm(q, p["q_norm"], cfg.layer_norm_epsilon)
        k = norms.rms_norm(k, p["k_norm"], cfg.layer_norm_epsilon)
    return q, k, v


def _rotary_cfg(cfg: ModelConfig) -> RotaryConfig:
    return RotaryConfig(
        dim=cfg.rot_dim,
        base=cfg.rotary_base,
        scaling_type=cfg.rotary_scaling_type,
        scaling_factor=cfg.rotary_scaling_factor,
        low_freq_factor=cfg.rotary_low_freq_factor,
        high_freq_factor=cfg.rotary_high_freq_factor,
        original_max_position=cfg.rotary_original_max_position,
        max_position=cfg.n_positions,
    )


def _mlp(cfg: ModelConfig, p, x, with_stats: bool = False):
    """The MLP's output; with ``with_stats``, ``(out, stats)``: an MoE
    layer's routing statistics (``ops/moe.py::routing_stats``, from which
    its aux loss follows), None for a dense MLP. The serving paths drop
    the aux, as the reference's do."""
    act = ACT2FN[cfg.activation_function]
    stats = None
    if cfg.mlp_type == "gated":
        h = (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    elif cfg.mlp_type == "fc":
        h = x @ p["w_fc"]
        if "b_fc" in p:
            h = h + p["b_fc"]
        h = act(h) @ p["w_proj"]
        if "b_proj" in p:
            h = h + p["b_proj"]
    elif cfg.mlp_type == "moe":
        h, stats = moe_ops.moe_forward(cfg, p, x, with_stats)
    else:
        raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")
    return (h, stats) if with_stats else h


def _attn_out(p, ctx):
    """ctx: [..., H, D] -> [..., E]."""
    y = ctx.reshape(*ctx.shape[:-2], -1) @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return y


def _embed(cfg: ModelConfig, params: Params, input_ids, positions):
    # gather, then cast the gathered rows (the reference casts the table)
    dt = torch_dtype(cfg.dtype)
    x = params["embed"]["weight"][input_ids].to(dt)
    if cfg.normalize_embed:
        x = x * torch.tensor(cfg.hidden_dim ** 0.5, dtype=x.dtype)
    if cfg.abs_position_embedding:
        x = x + params["pos_embed"]["weight"][positions].to(dt)
    return x


def head_weight(cfg: ModelConfig, params: Params):
    """The LM-head weight ``[E, V]`` (tied embeddings: a transposed view)."""
    if cfg.tied_embedding:
        return params["embed"]["weight"].T
    return params["head"]["weight"]


def _head(cfg: ModelConfig, params: Params, x):
    dt = torch_dtype(cfg.dtype)
    if cfg.is_critic:
        return (x @ params["head"]["weight"].to(dt)).float()
    logits = (x @ head_weight(cfg, params).to(dt)).float()
    if cfg.final_logits_soft_cap is not None:
        c = cfg.final_logits_soft_cap
        logits = c * torch.tanh(logits / c)
    return logits


def apply_head(cfg: ModelConfig, params: Params, x):
    """Full logits (``[..., vocab]`` f32, or ``[..., 1]`` values for a
    critic) from final-norm hidden states."""
    return _head(cfg, params, x)


def _rotary(cfg: ModelConfig, positions):
    if not cfg.apply_rotary:
        return None
    return rotary_cos_sin(_rotary_cfg(cfg), positions, torch.float32)


# --------------------------------------------------------------------------- #
# Packed forward (training / logprob inference)
# --------------------------------------------------------------------------- #

REMAT_POLICIES = ("full", "dots", "dots_attn", "none")
# what the ``dots`` policy saves: the outputs of 2-D matmuls, as
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves the
# dot products without batch dimensions (attention's are batched by head)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_OUT_PROJ = ("wo", "bo")


def _dots_context():
    return create_selective_checkpoint_contexts(list(_DOTS))


def _remat(fn, *args, dots: bool):
    """``fn(*args)`` checkpointed (non-reentrant): the backward recomputes
    every intermediate (``dots=False``) or all but the 2-D matmul outputs
    (``dots=True``)."""
    if dots:
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context)
    return checkpoint(fn, *args, use_reentrant=False)


def _split_at_attention(lp):
    """A layer's params as (before attention: ln1 and the q/k/v
    projections; after it: the out-projection, ln2 and the MLP)."""
    attn = lp["attn"]
    before = {"ln1": lp["ln1"],
              "attn": {k: v for k, v in attn.items() if k not in _OUT_PROJ}}
    after = {"attn": {k: v for k, v in attn.items() if k in _OUT_PROJ},
             "ln2": lp["ln2"], "mlp": lp["mlp"]}
    return before, after


def forward_packed(
    params: Params,
    cfg: ModelConfig,
    input_ids: torch.Tensor,     # [T] int
    segment_ids: torch.Tensor,   # [T] int32, 0 = padding
    positions: torch.Tensor,     # [T] int32, restart per segment
    *,
    remat: bool = True,
    with_head: bool = True,
    with_aux: bool = False,
):
    """Full forward over a packed token axis. Returns ``[T, vocab]`` logits
    (fp32) or ``[T, 1]`` values for critics; ``with_head=False`` returns
    the final-norm HIDDEN states ``[T, E]`` instead (the chunked loss
    applies the head per token block). Padding rows are garbage — mask
    downstream with ``segment_ids > 0``.

    ``with_aux`` returns ``(out, stats)``: each layer's MoE routing
    statistics ``[L, 2X + 2]`` float32 (``ops/moe.py::routing_stats``;
    ``[L, 0]`` for a dense MLP), from which ``ops/moe.py::aux_loss`` gives
    the router loss summed over layers. ``train/engine.py::vmapped_forward``
    folds them over rows before it does.

    ``cfg.remat_policy``, as the reference's (a run without autograd,
    inference, or ``remat=False`` takes ``"none"``):

    - ``"full"``: each layer is one non-reentrant checkpoint, so the
      backward reruns the whole layer, attention's forward included;
    - ``"dots"``: the same region, but a selective policy keeps the 2-D
      matmul outputs (``aten.mm`` / ``aten.addmm``) and recomputes the
      rest, attention's forward included;
    - ``"dots_attn"``: two checkpointed regions under the ``dots`` policy,
      before attention (q, k, v) and after it (out-projection, residual,
      MLP); attention sits between them outside any checkpoint, so the
      flash kernel keeps its own residuals (q, k, v, out, lse) and the
      backward runs no attention forward;
    - ``"none"``: every activation is kept.

    Layer params are cast to ``cfg.dtype`` inside each checkpointed
    region, so the recompute casts again and no cast copy is saved. A
    layer's routing statistics are an output of its checkpointed region
    (of ``post``'s under ``dots_attn``).
    """
    policy = cfg.remat_policy if remat else "none"
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")
    x = _embed(cfg, params, input_ids, positions)
    rot = _rotary(cfg, positions)

    def pre(x, lp):
        h = _norm(cfg, lp["ln1"], x)
        q, k, v = _qkv(cfg, lp["attn"], h)
        if rot is not None:
            q = apply_rotary(q, *rot)
            k = apply_rotary(k, *rot)
        return q, k, v

    def attend(q, k, v):
        return attn_ops.packed_attention(
            q, k, v, segment_ids,
            softmax_scale=cfg.softmax_scale,
            soft_cap=cfg.attn_logits_soft_cap,
            sliding_window=cfg.sliding_window,
            max_seqlen=cfg.attn_max_seqlen,
        )

    def post(x, ctx, lp):
        x = x + _attn_out(lp["attn"], ctx)
        h = _norm(cfg, lp["ln2"], x)
        if not with_aux:   # no routing statistics asked for: none computed
            return x + _mlp(cfg, lp["mlp"], h), None
        m, stats = _mlp(cfg, lp["mlp"], h, with_stats=True)
        return x + m, stats

    def layer(x, lp):
        lp = _cast(cfg, lp)
        return post(x, attend(*pre(x, lp)), lp)

    def split_layer(x, lp):
        # attention between two checkpointed regions: the kernel keeps its
        # own residuals, the regions recompute everything but their matmuls
        lp_pre, lp_post = _split_at_attention(lp)
        q, k, v = _remat(lambda x, lp: pre(x, _cast(cfg, lp)), x, lp_pre,
                         dots=True)
        ctx = attend(q, k, v)
        return _remat(lambda x, ctx, lp: post(x, ctx, _cast(cfg, lp)),
                      x, ctx, lp_post, dots=True)

    if not torch.is_grad_enabled() or policy == "none":
        run = layer
    elif policy == "dots_attn":
        run = split_layer
    else:
        def run(x, lp):
            return _remat(layer, x, lp, dots=policy == "dots")
    stats = []
    for lp in params["layers"]:
        x, st = run(x, lp)
        stats.append(st)
    x = _norm(cfg, _cast(cfg, params["final_ln"]), x)
    out = _head(cfg, params, x) if with_head else x
    if not with_aux:
        return out
    if cfg.mlp_type != "moe":
        return out, torch.zeros((len(stats), 0), dtype=torch.float32,
                                device=x.device)
    return out, torch.stack(stats)


def chunked_next_token_logprobs(
    params: Params,
    cfg: ModelConfig,
    hidden: torch.Tensor,       # [T, E] final-norm hidden (with_head=False)
    input_ids: torch.Tensor,    # [T]
    segment_ids: torch.Tensor,  # [T]
    chunk: int = 4096,
) -> torch.Tensor:
    """Next-token logprobs ``[T]`` without materializing ``[T, vocab]``
    logits: the LM head, log-softmax and label gather run per token block,
    each block checkpointed (its logits are recomputed in the backward).
    The chunk rounds DOWN to a divisor of T. Semantics match
    ``ops.ppo.gather_packed_shifted_log_probs``."""
    T = hidden.shape[0]
    if T % chunk:
        chunk = next(c for c in range(min(chunk, T), 0, -1) if T % c == 0)
    nxt = torch.cat([input_ids[1:], input_ids.new_zeros(1)]).long()

    def block(h_c, ids_c):
        logp = torch.log_softmax(_head(cfg, params, h_c), dim=-1)
        return logp.gather(-1, ids_c[:, None])[:, 0]

    remat = torch.is_grad_enabled()
    lps = []
    for off in range(0, T, chunk):
        args = (hidden[off : off + chunk], nxt[off : off + chunk])
        lps.append(checkpoint(block, *args, use_reentrant=False) if remat
                   else block(*args))
    lp = torch.cat(lps)
    has_next = (segment_ids > 0) & ~ppo_ops.is_segment_end(segment_ids)
    return torch.where(has_next, lp, 0.0)


# --------------------------------------------------------------------------- #
# Dense KV-cache generation (the synchronous generator)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache: ``k, v: [L, B, S, Hkv, D]``; ``lens: [B]`` i32
    counts valid entries per row (0 = free row). :func:`prefill` and
    :func:`decode_step` write ``k`` and ``v`` in place (the reference
    returns new arrays) and return a cache with the new ``lens``."""

    k: torch.Tensor
    v: torch.Tensor
    lens: torch.Tensor

    @classmethod
    def empty(cls, cfg: ModelConfig, batch: int, capacity: int,
              device=None) -> "KVCache":
        device = resolve_device(device)
        shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
        dt = torch_dtype(cfg.dtype)
        return cls(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            lens=torch.zeros(batch, dtype=torch.int32, device=device),
        )


def prefill(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    input_ids: torch.Tensor,     # [B, Sp] right-padded prompts
    prompt_lens: torch.Tensor,   # [B]
) -> Tuple[torch.Tensor, KVCache]:
    """Batched prompt processing: fills the cache at positions ``[0, len)``
    of each row and returns the f32 logits of each row's LAST prompt token
    ``[B, vocab]``.

    Rows flatten onto one packed ``[B * Sp]`` token axis with one segment
    per row, the padding tail inside the segment, through
    ``ops/attention.py::packed_attention`` (the flash kernel on the card,
    the plain version on the CPU): a prompt token never attends the tail
    (causal, the tail comes later), and the tail's rows give finite values
    that nothing reads. Each layer's K/V land straight in the cache's first
    ``Sp`` positions under the ``pos < len`` mask."""
    B, Sp = input_ids.shape
    cap = cache.k.shape[2]
    if Sp > cap:
        raise ValueError("prompt longer than cache capacity")
    dev = input_ids.device
    positions = torch.arange(Sp, dtype=torch.int32, device=dev)[None].expand(
        B, Sp)
    keep = (positions < prompt_lens[:, None])[:, :, None, None]
    flat_pos = positions.reshape(B * Sp)
    flat_seg = (torch.arange(B, dtype=torch.int32, device=dev) + 1)[
        :, None].expand(B, Sp).reshape(B * Sp)
    x = _embed(cfg, params, input_ids.reshape(B * Sp).long(), flat_pos)
    rot = _rotary(cfg, flat_pos)
    for li, lp in enumerate(params["layers"]):
        lp = _cast(cfg, lp)
        q, k, v = _qkv(cfg, lp["attn"], _norm(cfg, lp["ln1"], x))
        if rot is not None:
            q = apply_rotary(q, *rot)
            k = apply_rotary(k, *rot)
        ctx = attn_ops.packed_attention(
            q, k, v, flat_seg,
            softmax_scale=cfg.softmax_scale,
            soft_cap=cfg.attn_logits_soft_cap,
            sliding_window=cfg.sliding_window,
            max_seqlen=Sp,
        )
        for dst, src in ((cache.k[li, :, :Sp], k), (cache.v[li, :, :Sp], v)):
            dst.copy_(torch.where(keep, src.reshape(B, Sp, *src.shape[1:]).to(
                dst.dtype), dst))
        x = x + _attn_out(lp["attn"], ctx.to(x.dtype))
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    x = _norm(cfg, _cast(cfg, params["final_ln"]), x).reshape(B, Sp, -1)
    last = x[torch.arange(B, device=dev), (prompt_lens - 1).clamp_min(0).long()]
    cache = KVCache(k=cache.k, v=cache.v, lens=prompt_lens.to(torch.int32))
    return _head(cfg, params, last), cache


def decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: torch.Tensor,                  # [B] current tokens
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive rows untouched
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for every cache row. Returns f32 logits ``[B,
    vocab]`` and the cache with ``lens`` incremented where ``active``.

    Each layer writes its new K/V with one indexed write at ``lens``: an
    active row writes its fresh values, an inactive row writes back what
    its slot already holds (the reference selects over the whole cache
    with ``jnp.where``; the result is the same)."""
    B = tokens.shape[0]
    dev = tokens.device
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
    S = cache.k.shape[2]
    positions = cache.lens
    x = _embed(cfg, params, tokens, positions)       # [B, E]
    rot = _rotary(cfg, positions)
    rows = torch.arange(B, device=dev)
    write_at = positions.long().clamp(max=S - 1)
    new_lens = torch.where(active, cache.lens + 1, cache.lens)
    put = active[:, None, None]
    for li, lp in enumerate(params["layers"]):
        lp = _cast(cfg, lp)
        q, k, v = _qkv(cfg, lp["attn"], _norm(cfg, lp["ln1"], x))
        if rot is not None:
            q = apply_rotary(q, *rot)
            k = apply_rotary(k, *rot)
        kc, vc = cache.k[li], cache.v[li]
        for c, new in ((kc, k), (vc, v)):
            c[rows, write_at] = torch.where(put, new.to(c.dtype),
                                            c[rows, write_at])
        ctx = attn_ops.decode_attention(
            q, kc, vc, new_lens,
            softmax_scale=cfg.softmax_scale,
            soft_cap=cfg.attn_logits_soft_cap,
            sliding_window=cfg.sliding_window,
        )
        x = x + _attn_out(lp["attn"], ctx.to(x.dtype))
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    x = _norm(cfg, _cast(cfg, params["final_ln"]), x)
    return _head(cfg, params, x), KVCache(k=cache.k, v=cache.v, lens=new_lens)


# --------------------------------------------------------------------------- #
# Paged KV generation
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class PagedKVCache:
    """KV page pool: ``pages [L, P, 2, Hkv, page, D]`` (K and V interleaved
    per page, heads before tokens). Slot state (page tables, lengths)
    lives with the generation engine; the pool has no per-sequence
    structure, which is what lets prompts share pages.

    ``scales`` (int8 mode): pages hold int8 values and a parallel ``[L, P,
    2, Hkv, page]`` f32 array carries one dequant scale per (page slot, kv
    head, K|V), addressed by the same indices.

    Both arrays are views of flat row buffers with ONE extra row past the
    pool: the KV scatter sends the writes it must drop (invalid chunk
    positions, inactive slots) to that trash row — the counterpart of
    JAX's out-of-range ``mode="drop"`` index, which torch lacks. The pool
    is updated IN PLACE, where the JAX engine donated its buffers."""

    flat: torch.Tensor                       # [n_rows + 1, D]
    flat_scales: Optional[torch.Tensor]      # [n_rows + 1] f32 (int8 mode)
    shape: Tuple[int, ...]                   # [L, P, 2, Hkv, page, D]

    @property
    def n_rows(self) -> int:
        return self.flat.shape[0] - 1

    @property
    def pages(self) -> torch.Tensor:
        return self.flat[: self.n_rows].view(self.shape)

    @property
    def scales(self) -> Optional[torch.Tensor]:
        if self.flat_scales is None:
            return None
        return self.flat_scales[: self.n_rows].view(self.shape[:-1])

    @property
    def quantized(self) -> bool:
        return self.flat_scales is not None

    @classmethod
    def empty(
        cls,
        cfg: ModelConfig,
        n_pages: int,
        page_size: int,
        kv_dtype: Optional[str] = None,
        device=None,
    ) -> "PagedKVCache":
        """``kv_dtype``: ``"int8"`` builds the quantized pool + scales pair,
        anything else (None) stores raw ``cfg.dtype`` pages."""
        device = resolve_device(device)
        shape = (cfg.n_layers, n_pages, 2, cfg.n_kv_heads, page_size,
                 cfg.head_dim)
        n_rows = int(np.prod(shape[:-1]))
        quant = kv_dtype == "int8"
        dt = torch.int8 if quant else torch_dtype(cfg.dtype)
        return cls(
            flat=torch.zeros(n_rows + 1, cfg.head_dim, dtype=dt,
                             device=device),
            flat_scales=(torch.zeros(n_rows + 1, dtype=torch.float32,
                                     device=device) if quant else None),
            shape=shape,
        )

    @classmethod
    def from_pages(cls, pages: torch.Tensor,
                   scales: Optional[torch.Tensor] = None) -> "PagedKVCache":
        """A cache holding a copy of ``pages`` (and ``scales``)."""
        D = pages.shape[-1]
        flat = torch.zeros(pages.numel() // D + 1, D, dtype=pages.dtype,
                           device=pages.device)
        flat[:-1] = pages.reshape(-1, D)
        flat_s = None
        if scales is not None:
            flat_s = torch.zeros(scales.numel() + 1, dtype=torch.float32,
                                 device=scales.device)
            flat_s[:-1] = scales.reshape(-1)
        return cls(flat=flat, flat_scales=flat_s, shape=tuple(pages.shape))


def _scatter_chunk_kv(cache: PagedKVCache, ks, vs, table, positions, valid):
    """ONE scatter of every layer's fresh K/V into the pool, in place.

    ks/vs ``[L, B, C, Hkv, D]``; positions/valid ``[B, C]``. Runs on the
    flat ``[rows, D]`` view, row = (((l*P + p)*2 + kv)*Hkv + h)*page + off.
    Invalid positions write to the trash row past the pool.

    Int8 mode: each token's K/V row quantizes symmetrically over head_dim
    (scale = amax/127 per (token, kv head, K|V), round half to even, clip
    to +-127) and the scale lands in the scales buffer through the same
    rows. Per-row scales make incremental page fills exact: a new token
    never forces requantizing its page's earlier residents."""
    L, B, C, Hkv, D = ks.shape
    P, page = cache.shape[1], cache.shape[4]
    M = table.shape[1]
    dev = ks.device
    page_idx = torch.gather(
        table.long(), 1, (positions // page).clamp(0, M - 1).long()
    )                                                   # [B, C]
    off = (positions % page).long()                     # [B, C]
    if cache.quantized:
        kf, vf = ks.float(), vs.float()
        amax = torch.stack(
            [kf.abs().amax(-1), vf.abs().amax(-1)], dim=3
        )                                               # [L, B, C, 2, Hkv]
        scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
        kv = torch.round(
            torch.stack([kf, vf], dim=3) / scale[..., None]
        ).clamp(-127.0, 127.0).to(torch.int8)           # [L, B, C, 2, Hkv, D]
    else:
        scale = None
        kv = torch.stack([ks, vs], dim=3).to(cache.flat.dtype)
    n_rows = cache.n_rows
    base = page_idx[None] + P * torch.arange(L, device=dev)[:, None, None]
    kvi = torch.arange(2, device=dev)[None, None, None, :, None]
    hi = torch.arange(Hkv, device=dev)[None, None, None, None, :]
    rows = ((base[..., None, None] * 2 + kvi) * Hkv + hi) * page \
        + off[None, :, :, None, None]                   # [L, B, C, 2, Hkv]
    rows = torch.where(valid[None, :, :, None, None], rows, n_rows).reshape(-1)
    cache.flat.index_put_((rows,), kv.reshape(-1, D))
    if scale is not None:
        cache.flat_scales.index_put_((rows,), scale.reshape(-1))
    return cache


def _extend_layers(params, cfg, cache, tokens, table, start, n_new,
                   skip_pool=False, verify=False):
    """Multi-token layer loop over the page pool (chunked prefill, and the
    spec-decode verify pass with ``verify``). Returns ``(x [B, C, E]
    pre-final-norm hidden, ks, vs, positions, valid)``; the caller scatters
    KV (and, for verify, applies the head)."""
    B, C = tokens.shape
    ar = torch.arange(C, device=tokens.device)
    positions = start[:, None] + ar[None, :]
    valid = ar[None, :] < n_new[:, None]
    x = _embed(cfg, params, tokens, positions)
    rot = _rotary(cfg, positions)
    ks, vs = [], []
    for li, lp in enumerate(params["layers"]):
        h = _norm(cfg, lp["ln1"], x)
        q, k, v = _qkv(cfg, lp["attn"], h)            # [B, C, H(kv), D]
        if rot is not None:
            q = apply_rotary(q, *rot)
            k = apply_rotary(k, *rot)
        kw = dict(softmax_scale=cfg.softmax_scale,
                  soft_cap=cfg.attn_logits_soft_cap,
                  sliding_window=cfg.sliding_window, scales=cache.scales)
        if verify:
            ctx = paged_ops.paged_verify_attention(
                q, k, v, cache.pages, li, table, start, n_new, **kw)
        else:
            ctx = paged_ops.paged_extend_attention(
                q, k, v, cache.pages, li, table, start, n_new,
                skip_pool=skip_pool, **kw)
        x = x + _attn_out(lp["attn"], ctx.to(x.dtype))
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs), positions, valid


def extend_paged(
    params: Params,
    cfg: ModelConfig,
    cache: PagedKVCache,
    tokens: torch.Tensor,     # [B, C] chunk of prompt tokens
    table: torch.Tensor,      # [B, M] page table
    start: torch.Tensor,      # [B] tokens already resident per slot
    n_new: torch.Tensor,      # [B] valid tokens in this chunk (<= C)
    skip_pool: bool = False,
) -> PagedKVCache:
    """Chunked prefill: attend the chunk causally over everything resident
    and scatter the chunk's KV into the pages once after the layer loop.
    Logits are not computed: admission feeds the last prompt token to the
    first decode step instead."""
    _, ks, vs, positions, valid = _extend_layers(
        params, cfg, cache, tokens, table, start, n_new, skip_pool=skip_pool
    )
    return _scatter_chunk_kv(cache, ks, vs, table, positions, valid)


def verify_step_paged(
    params: Params,
    cfg: ModelConfig,
    cache: PagedKVCache,
    tokens: torch.Tensor,       # [B, C] verify chunk: [last_token, d_1..d_K]
    table: torch.Tensor,        # [B, M]
    lens: torch.Tensor,         # [B] resident tokens (the chunk starts here)
    n_new: torch.Tensor,        # [B] C where the slot is active, 0 otherwise
    write_mask: torch.Tensor,   # [B, C] which chunk positions' KV may land
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, PagedKVCache]:
    """Speculative-decode VERIFY: :func:`decode_step_paged` generalized to
    C = K+1 query tokens per slot in one pass. Returns fp32 logits ``[B,
    C, V]`` (position ``i`` is the distribution of the token following
    ``tokens[:, i]``), or with ``return_hidden`` the final-norm hidden
    states ``[B, C, E]`` for the fused epilogue, and the cache with the
    chunk's KV scattered in place where ``write_mask`` allows.

    ``write_mask`` is the engine's acceptance-agnostic residency bound
    (``active & (n_gen + i < max_gen)``): rejected drafts' KV lands beyond
    the post-acceptance ``lens``, which attention never reads and later
    steps overwrite, so the scatter can run before the accept decision;
    the mask keeps writes inside the slot's allocated pages (a position
    past ``max_gen`` could fall off the table and alias page 0)."""
    x, ks, vs, positions, _ = _extend_layers(
        params, cfg, cache, tokens, table, lens, n_new, verify=True
    )
    _scatter_chunk_kv(cache, ks, vs, table, positions, write_mask)
    x = _norm(cfg, params["final_ln"], x)
    return (x if return_hidden else _head(cfg, params, x)), cache


def decode_step_paged(
    params: Params,
    cfg: ModelConfig,
    cache: PagedKVCache,
    tokens: torch.Tensor,       # [B] current tokens
    table: torch.Tensor,        # [B, M] i32
    lens: torch.Tensor,         # [B] i32 resident tokens (write position)
    active: torch.Tensor,       # [B] bool
    return_hidden: bool = False,
    with_head: bool = True,
) -> Tuple[Optional[torch.Tensor], PagedKVCache, torch.Tensor]:
    """One decode step over the page pool. Returns (fp32 logits ``[B, V]``,
    cache, new lens incremented where active). Each layer's fresh K/V
    merge into attention as the self token (the paged decode kernel on a
    GPU) and land in the pool via one scatter after the layer loop.

    ``return_hidden=True`` returns the final-norm hidden states ``[B, E]``
    in place of the logits: the fused sampling epilogue
    (``ops/fused_sample.py``) streams the head itself.
    ``with_head=False`` skips the final norm and the head and returns
    ``None`` logits: the draft model's KV-maintenance step needs only the
    KV writes."""
    positions = lens
    x = _embed(cfg, params, tokens, positions)        # [B, E]
    rot = _rotary(cfg, positions)
    new_lens = torch.where(active, lens + 1, lens)
    ks, vs = [], []
    for li, lp in enumerate(params["layers"]):
        h = _norm(cfg, lp["ln1"], x)
        q, k, v = _qkv(cfg, lp["attn"], h)            # q [B, H, D]
        if rot is not None:
            q = apply_rotary(q, *rot)
            k = apply_rotary(k, *rot)
        ctx = paged_ops.paged_decode_attention(
            q, k, v, cache.pages, li, table, lens,
            softmax_scale=cfg.softmax_scale,
            soft_cap=cfg.attn_logits_soft_cap,
            sliding_window=cfg.sliding_window,
            scales=cache.scales,
        )
        x = x + _attn_out(lp["attn"], ctx.to(x.dtype))
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
        ks.append(k)
        vs.append(v)
    _scatter_chunk_kv(
        cache, torch.stack(ks)[:, :, None], torch.stack(vs)[:, :, None],
        table, positions[:, None], active[:, None],
    )
    if not with_head:
        return None, cache, new_lens
    x = _norm(cfg, params["final_ln"], x)
    return (x if return_hidden else _head(cfg, params, x)), cache, new_lens
