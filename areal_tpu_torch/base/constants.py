"""Env-var knobs the port reads (a copy of the slice's subset of
``areal_tpu/base/constants.py``, same names and the same tolerant parsing)."""

import logging
import os
from typing import Optional

_logger = logging.getLogger("areal_tpu_torch.constants")

# KV-pool quantization (docs/performance.md "KV quantization").
KV_DTYPE_ENV = "AREAL_KV_DTYPE"         # paged KV pool storage dtype


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(name, default)


def kv_dtype() -> Optional[str]:
    """``AREAL_KV_DTYPE`` (default unset = serving dtype, i.e. raw bf16
    pages). ``"int8"`` stores quantized pages with per-(page-slot, kv-head)
    scales. Unknown values fall back to unset (logged), not crash. An
    explicit ``cfg.kv_dtype`` / engine argument overrides this knob."""
    raw = env_str(KV_DTYPE_ENV)
    if raw is None or not raw.strip():
        return None
    v = raw.strip().lower()
    if v == "int8":
        return "int8"
    if v in ("bf16", "bfloat16"):
        return "bf16"
    _logger.warning(
        "ignoring unknown %s=%r (using the serving dtype)", KV_DTYPE_ENV, raw
    )
    return None


# Fused sampling epilogue (docs/performance.md "Fused sampling epilogue").
FUSED_SAMPLE_ENV = "AREAL_FUSED_SAMPLE"  # streamed LM-head + sampling epilogue
_OFF_STRINGS = ("", "0", "false", "off", "no", "n")


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: unset -> ``default``; ""/"0"/"false"/"off"/"no"/"n" ->
    False; anything else -> True."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in _OFF_STRINGS


def fused_sample_enabled() -> bool:
    """``AREAL_FUSED_SAMPLE`` (default off): decode chunks sample through
    the fused LM-head + sampling epilogue (``ops/fused_sample.py``), so the
    full ``[B, V]`` logits tensor is never materialized for greedy,
    plain-temperature and top-k slots; top-p rows keep the sorted sampler
    through the warp-row bucket. Token-exact for greedy slots,
    distribution-exact for sampled slots. An explicit engine argument
    overrides this knob."""
    return env_flag(FUSED_SAMPLE_ENV, False)


# Decode-chunk pipelining (the reference's ``pipeline_chunks``).
DECODE_PIPELINE_ENV = "AREAL_DECODE_PIPELINE"


def decode_pipeline_enabled() -> bool:
    """``AREAL_DECODE_PIPELINE`` (default off): harvest decode chunks one
    late so the per-chunk host sync overlaps the next chunk's compute. An
    explicit ``pipeline_chunks`` engine argument overrides this knob."""
    return env_flag(DECODE_PIPELINE_ENV, False)
