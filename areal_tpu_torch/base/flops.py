"""Analytic FLOP accounting for throughput logging (a copy of
``areal_tpu/base/flops.py``): the trainer divides these by wall time to
log TFLOP/s per step. The attention term uses true per-sequence lengths
(packed varlen batches cost the sum of len² within segments, not T²).
"""

from typing import Optional, Sequence

from areal_tpu_torch.models.config import ModelConfig


def param_count(cfg: ModelConfig, activated: bool = False) -> int:
    """Total parameter count (embeddings included once). With
    ``activated``, MoE layers count only the ``top_k`` experts a token
    routes through."""
    E, D = cfg.hidden_dim, cfg.head_dim
    L, V, F = cfg.n_layers, cfg.vocab_size, cfg.intermediate_dim
    attn = E * (cfg.n_q_heads * D) + 2 * E * (cfg.n_kv_heads * D) + (
        cfg.n_q_heads * D
    ) * E
    if cfg.mlp_type == "gated":
        mlp = 3 * E * F
    elif cfg.mlp_type == "moe":
        n_active = cfg.moe.top_k if activated else cfg.moe.num_experts
        mlp = n_active * 3 * E * F + E * cfg.moe.num_experts
    else:
        mlp = 2 * E * F
    per_layer = attn + mlp
    head = E if cfg.is_critic else (0 if cfg.tied_embedding else E * V)
    return V * E + L * per_layer + head


def _attn_fwd(cfg: ModelConfig, seqlens: Optional[Sequence[int]]) -> float:
    if not seqlens:
        return 0.0
    D, H = cfg.head_dim, cfg.n_q_heads
    # 2 matmuls x 2 FLOP/MAC x causal half
    return sum(2 * 2 * (l * l / 2) * D * H for l in seqlens) * cfg.n_layers


def train_flops(
    cfg: ModelConfig,
    n_tokens: int,
    seqlens: Optional[Sequence[int]] = None,
) -> float:
    """FLOPs of ONE forward + backward over ``n_tokens`` packed tokens
    (backward ≈ 2x forward for matmuls; attention backward ≈ 2.5x its
    forward)."""
    fwd = 2 * param_count(cfg, activated=True) * n_tokens
    return 3 * fwd + 3.5 * _attn_fwd(cfg, seqlens)


def forward_flops(
    cfg: ModelConfig,
    n_tokens: int,
    seqlens: Optional[Sequence[int]] = None,
) -> float:
    fwd = 2 * param_count(cfg, activated=True) * n_tokens
    return fwd + _attn_fwd(cfg, seqlens)
