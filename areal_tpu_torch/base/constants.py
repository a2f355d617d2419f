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
