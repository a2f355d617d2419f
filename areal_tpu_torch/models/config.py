"""Model architecture config (a copy of ``areal_tpu/models/config.py``).

One dataclass covers every supported HF family (llama, qwen2, qwen3,
mistral, gemma, gpt2, mixtral) via feature switches. The fields and their
meaning are the JAX package's; only ``flash_enabled`` differs, because the
port must not probe jax for a platform.
"""

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (≈ ``ReaLMoEConfig``)."""

    num_experts: int = 8
    top_k: int = 2
    routed_scaling_factor: float = 1.0
    aux_loss_coeff: float = 0.0
    z_loss_coeff: float = 0.0
    input_jitter_eps: Optional[float] = None
    norm_topk_prob: bool = True
    # "dense": every expert for every token (XLA-fused; correct under any
    # sharding of the expert axis). "ragged": sort-by-expert grouped GEMM via
    # ``lax.ragged_dot`` (megablox-style) — the TPU fast path when experts are
    # replicated or fit per-device; GSPMD may all-gather expert weights if the
    # expert axis is sharded. With nonzero aux coefficients the two modes
    # optimize slightly different load-balance estimators under the packed
    # training path (per-row mean vs whole-batch; see ``ops/moe.py``).
    dispatch: str = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    n_layers: int
    n_q_heads: int
    n_kv_heads: int
    head_dim: int
    hidden_dim: int
    intermediate_dim: int
    vocab_size: int
    n_positions: int = 32768

    # Norms
    layer_norm_type: str = "rms"      # "rms" | "gemma" (=(1+w) rms) | "layer" (gpt2)
    layer_norm_epsilon: float = 1e-5

    # Attention
    use_attention_bias: bool = False       # qkv projection bias (qwen2, gpt2)
    use_attn_proj_bias: bool = False       # output projection bias (gpt2)
    qk_layernorm: bool = False             # per-head q/k RMSNorm (qwen3)
    sliding_window: Optional[int] = None
    attn_logits_soft_cap: Optional[float] = None
    softmax_scale: Optional[float] = None  # default head_dim ** -0.5

    # Rotary (apply_rotary False => learned absolute positions, gpt2)
    apply_rotary: bool = True
    rotary_base: float = 10000.0
    rotary_dim: Optional[int] = None       # default head_dim
    rotary_scaling_type: Optional[str] = None
    rotary_scaling_factor: float = 1.0
    rotary_low_freq_factor: float = 1.0
    rotary_high_freq_factor: float = 4.0
    rotary_original_max_position: int = 8192

    # MLP
    activation_function: str = "silu"
    mlp_type: str = "gated"                # "gated" (swiglu) | "fc" (gpt2) | "moe"
    use_mlp_bias: bool = False             # gpt2
    moe: Optional[MoEConfig] = None

    # Embeddings / head
    tied_embedding: bool = False
    normalize_embed: bool = False          # gemma: scale embeds by sqrt(hidden)
    final_logits_soft_cap: Optional[float] = None
    abs_position_embedding: bool = False   # gpt2 learned positions

    # Dropout (SFT only; PPO runs with 0 like the reference)
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0

    # Head
    is_critic: bool = False                # scalar value head instead of LM head

    # Compute dtype for activations (params kept fp32 master in the optimizer)
    dtype: str = "bfloat16"

    # Paged-KV pool storage dtype for generation engines (docs/performance.md
    # "KV quantization"): None = serving ``dtype`` (raw bf16 pages — the
    # chip-verified default until the gen_kvq bench proves int8 on hardware);
    # "int8" stores quantized pages with per-(page-slot, kv-head) scales in a
    # parallel scales array, halving decode's HBM KV traffic and doubling
    # resident pages at fixed pool HBM. The AREAL_KV_DTYPE env knob
    # (base/constants.py) overrides a None here; an explicit engine argument
    # overrides both.
    kv_dtype: Optional[str] = None

    # Attention backend: None = auto (see ``flash_enabled``); True/False
    # force it.
    use_flash_attention: Optional[bool] = None

    # STATIC upper bound on any packed segment's length (e.g. max prompt +
    # max new tokens). When set, the flash kernels iterate a statically
    # narrowed block band instead of the full causal rectangle — a multi-x
    # attention win when packing many short sequences. The train engine
    # rejects batches that violate the bound.
    attn_max_seqlen: Optional[int] = None

    # Flash-attention block size override (None = auto: 1024 at T >= 8192,
    # else 512). Bigger score tiles amortize the kernels' VPU mask/softmax
    # passes at very long context; may need more VMEM.
    flash_block_size: Optional[int] = None
    # Separate K-block size (None = same as flash_block_size). Rectangular
    # tiles trade VPU-pass shape against MXU dot shapes at long context.
    flash_block_size_k: Optional[int] = None

    # Cross-entropy in token blocks of this size (None = dense): the LM
    # head + log-softmax + label gather run per block under remat, so the
    # [T, vocab] logits (4 GB f32 at the 32k protocol shape) never
    # materialize. Trades one extra head matmul in the backward for ~8 GB
    # of HBM round trips per step.
    loss_chunk_size: Optional[int] = None

    # Layer-stack execution: 1 = lax.scan over stacked layers (one trace,
    # fast compiles — the default); an int N or True unrolls the scan (full
    # unroll removes the per-layer dynamic-update-slice bookkeeping XLA
    # emits for scan carries/residuals — measured ~20% step-time win on a
    # 12-layer model at 4k tokens — at the cost of layer-count-proportional
    # compile time; prefer it for models up to a few dozen layers).
    layer_scan_unroll: int = 1

    # Rematerialization policy for the training backward pass:
    #   "full" — checkpoint whole layers (max memory savings, ~1/3 extra
    #            FLOPs; the 32k-context default),
    #   "dots" — save matmul outputs, recompute elementwise (small memory
    #            cost, near-zero recompute on MXU),
    #   "dots_attn" — "dots" for the projections/MLP but the attention
    #            kernel stays un-rematted (its q/k/v/out/lse residuals are
    #            saved): a whole-layer checkpoint re-runs the flash forward
    #            inside the backward, ~25% of a long-context step. Costs
    #            ~4 packed activations per layer of extra HBM.
    #   "none" — save everything (fastest when activations fit HBM; right
    #            for small models / short contexts).
    remat_policy: str = "full"

    def flash_enabled(self) -> bool:
        """The JAX package's attention-backend switch. It gates nothing in
        the port: packed attention takes the CUDA flash kernels for CUDA
        tensors and the plain version for CPU tensors whatever this says.
        The field (and ``flash_block_size``/``flash_block_size_k``) stays
        for configs shared with the JAX package."""
        return bool(self.use_flash_attention)

    @property
    def n_rep(self) -> int:
        return self.n_q_heads // self.n_kv_heads

    @property
    def rot_dim(self) -> int:
        return self.rotary_dim if self.rotary_dim is not None else self.head_dim

    def __post_init__(self):
        if self.n_q_heads % self.n_kv_heads != 0:
            raise ValueError("n_q_heads must be divisible by n_kv_heads")
        if self.mlp_type == "moe" and self.moe is None:
            object.__setattr__(self, "moe", MoEConfig())
        if isinstance(self.moe, dict):   # an arch given as JSON
            object.__setattr__(self, "moe", MoEConfig(**self.moe))
