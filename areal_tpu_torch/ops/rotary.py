"""Rotary position embeddings with scaling variants (counterpart of
``areal_tpu/ops/rotary.py``): none, "linear", "dynamic" (NTK) and
"llama3", computed in float32 from integer positions."""

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RotaryConfig:
    dim: int                      # rotary dimension (usually head_dim)
    base: float = 10000.0
    scaling_type: Optional[str] = None   # None | "linear" | "dynamic" | "llama3"
    scaling_factor: float = 1.0
    # llama3-specific:
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192
    # dynamic-NTK-specific:
    max_position: int = 2048


def _inv_freq(cfg: RotaryConfig, device) -> torch.Tensor:
    base = cfg.base
    if cfg.scaling_type == "dynamic":
        # NTK-aware base rescale, fixed at the configured max length
        base = base * cfg.scaling_factor ** (cfg.dim / (cfg.dim - 2))
    exps = torch.arange(0, cfg.dim, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (base ** (exps / cfg.dim))
    if cfg.scaling_type == "linear":
        inv = inv / cfg.scaling_factor
    elif cfg.scaling_type == "llama3":
        # frequency-dependent interpolation (HF Llama-3.1 convention)
        low_wl = cfg.original_max_position / cfg.low_freq_factor
        high_wl = cfg.original_max_position / cfg.high_freq_factor
        wl = 2 * math.pi / inv
        smooth = (cfg.original_max_position / wl - cfg.low_freq_factor) / (
            cfg.high_freq_factor - cfg.low_freq_factor
        )
        smooth = smooth.clamp(0.0, 1.0)
        scaled = (1 - smooth) * inv / cfg.scaling_factor + smooth * inv
        inv = torch.where(wl > low_wl, inv / cfg.scaling_factor, inv)
        inv = torch.where((wl <= low_wl) & (wl >= high_wl), scaled, inv)
    return inv


def rotary_cos_sin(cfg: RotaryConfig, positions: torch.Tensor,
                   dtype=torch.float32):
    """cos/sin tables for integer positions. Shapes ``[..., dim/2]``."""
    inv = _inv_freq(cfg, positions.device)
    freqs = positions.float()[..., None] * inv
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """``x``: ``[..., heads, head_dim]``; ``cos/sin``: ``[..., head_dim/2]``
    (broadcast over heads). HF "half-split" layout; a partial rotary
    (``2 * d2 < head_dim``) passes the tail through."""
    d2 = cos.shape[-1]
    x1 = x[..., :d2].float()
    x2 = x[..., d2 : 2 * d2].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    parts = [x1 * c - x2 * s, x2 * c + x1 * s]
    if 2 * d2 < x.shape[-1]:
        parts.append(x[..., 2 * d2 :].float())
    return torch.cat(parts, dim=-1).to(x.dtype)
