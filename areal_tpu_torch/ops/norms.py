"""Normalization layers (counterpart of ``areal_tpu/ops/norms.py``).
Computed in float32 whatever the input dtype, cast back at the end."""

import torch


def rms_norm(x, weight, eps: float = 1e-6, *, plus_one: bool = False):
    """RMSNorm. ``plus_one`` selects the Gemma convention ``(1 + w) * x_hat``."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x / torch.sqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (x * w).to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """Standard LayerNorm (GPT-2 family)."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) / torch.sqrt(var + eps)
    out = x * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)
