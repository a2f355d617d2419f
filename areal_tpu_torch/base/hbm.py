"""Device-memory observability and pressure action (the counterpart of
``areal_tpu/base/hbm.py``; the file keeps the reference's name). On a
CUDA device the source is the caching allocator's ``memory_stats``
(bytes allocated now and at peak) and ``mem_get_info`` (the card's total),
under the reference's gauge names; on the CPU there is no source and the
monitor returns no gauges.

Two thresholds, both fractions of the device's memory:
- warn (``AREAL_HBM_WARN_THRESHOLD``, default 0.92): log once per crossing;
- kill (``AREAL_HBM_KILL_THRESHOLD``, default 1.0 = disabled): raise
  :class:`HBMPressureError` so the worker dies loudly and the launcher's
  restart-the-world recovery takes over.
"""

import logging
from typing import Dict, Optional

import torch

from areal_tpu_torch.base import constants

logger = logging.getLogger("areal_tpu_torch.hbm")


class HBMPressureError(RuntimeError):
    """Device memory exceeded the kill threshold."""


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """``{bytes_in_use, peak_bytes_in_use, bytes_limit}`` for one CUDA
    device, or None where there is none to read (the CPU)."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    return {
        "bytes_in_use": in_use,
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", in_use)),
        "bytes_limit": int(total),
    }


class HBMMonitor:
    """Per-process monitor: call :meth:`check` once per step or chunk.
    Returns scalar gauges for the caller's stats sink (empty where the
    device does not report), warns once per threshold crossing, and raises
    :class:`HBMPressureError` past the kill threshold."""

    def __init__(
        self,
        device=None,
        warn_threshold: Optional[float] = None,
        kill_threshold: Optional[float] = None,
        tag: str = "",
    ):
        self._device = device
        self.warn_threshold = (
            constants.hbm_warn_threshold()
            if warn_threshold is None else warn_threshold
        )
        self.kill_threshold = (
            constants.hbm_kill_threshold()
            if kill_threshold is None else kill_threshold
        )
        self.tag = tag
        self._warned = False

    def check(self, kill: bool = True) -> Dict[str, float]:
        """Snapshot gauges; warn / kill on thresholds. ``kill=False`` for
        pull-style paths (metrics endpoints) that must never raise."""
        stats = device_memory_stats(self._device)
        if stats is None:
            return {}
        limit = stats["bytes_limit"]
        util = stats["bytes_in_use"] / limit if limit else 0.0
        out = {
            "hbm_bytes_in_use": float(stats["bytes_in_use"]),
            "hbm_peak_bytes_in_use": float(stats["peak_bytes_in_use"]),
            "hbm_bytes_limit": float(limit),
            "hbm_util": util,
        }
        if kill and limit and util > self.kill_threshold:
            raise HBMPressureError(
                f"{self.tag or 'device'} memory "
                f"{stats['bytes_in_use'] / 2**30:.2f}/{limit / 2**30:.2f} GiB "
                f"= {util:.1%} exceeds kill threshold "
                f"{self.kill_threshold:.2f} (tune ${constants.MEMORY_KILL_ENV})"
            )
        if limit and util > self.warn_threshold:
            if not self._warned:
                logger.warning(
                    "%s memory pressure: %.2f/%.2f GiB (%.1f%%) past warn "
                    "threshold %.2f ($%s)",
                    self.tag or "device", stats["bytes_in_use"] / 2**30,
                    limit / 2**30, util * 100, self.warn_threshold,
                    constants.MEMORY_WARN_ENV,
                )
                self._warned = True
        else:
            self._warned = False
        return out
