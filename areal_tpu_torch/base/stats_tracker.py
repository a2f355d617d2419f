"""Denominator-keyed statistics tracker (the counterpart of
``areal_tpu/base/stats_tracker.py``, after ``realhf/base/stats_tracker.py``).

Collects per-step scalar and vector statistics with named *denominators*
(boolean masks), so means run over exactly the tokens or sequences that
matter. Scopes compose (``with tracker.scope("actor")``). ``export``
reduces everything to plain Python floats; ``export(cross_host=True)``
combines every process's partials (numerator, denominator) or (extreme,
count) over the ``torch.distributed`` world when one is initialised, after
a check that every process recorded the same keys. With one process it
returns the local partials.
"""

import contextlib
from enum import Enum
from typing import Dict, List

import numpy as np


class ReduceType(Enum):
    AVG = "avg"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    SCALAR = "scalar"


class DistributedStatsTracker:
    def __init__(self, name: str = ""):
        self._scope: List[str] = [name] if name else []
        self._denominators: Dict[str, List[np.ndarray]] = {}
        self._stats: Dict[str, List[np.ndarray]] = {}
        self._meta: Dict[str, dict] = {}

    def _key(self, name: str) -> str:
        return "/".join(self._scope + [name]) if self._scope else name

    @contextlib.contextmanager
    def scope(self, name: str):
        self._scope.append(name)
        try:
            yield
        finally:
            self._scope.pop()

    def denominator(self, **kwargs):
        """Register boolean-mask denominators, e.g. ``mask=loss_mask``."""
        for name, mask in kwargs.items():
            mask = np.asarray(mask)
            if mask.dtype != bool:
                mask = mask.astype(bool)
            key = self._key(name)
            self._denominators.setdefault(key, []).append(mask)
            self._meta[key] = dict(is_denominator=True)

    def stat(
        self,
        denominator: str,
        reduce_type: ReduceType = ReduceType.AVG,
        **kwargs,
    ):
        """Record vector stats reduced over a registered denominator mask.

        The value is paired with the *latest* mask recorded under
        ``denominator`` at call time.
        """
        denom_key = self._key(denominator)
        if denom_key not in self._denominators:
            raise ValueError(f"Unknown denominator {denom_key}")
        mask = self._denominators[denom_key][-1]
        for name, value in kwargs.items():
            value = np.asarray(value, dtype=np.float32)
            key = self._key(name)
            if value.shape != mask.shape:
                raise ValueError(
                    f"stat {key}: shape {value.shape} != denominator "
                    f"{denom_key} shape {mask.shape}"
                )
            # Store the (value, mask) pair so export never has to re-align.
            self._stats.setdefault(key, []).append((value, mask))
            self._meta[key] = dict(
                denominator=denom_key, reduce_type=reduce_type
            )

    def scalar(self, **kwargs):
        """Record plain scalars, averaged over occurrences at export."""
        for name, value in kwargs.items():
            key = self._key(name)
            self._stats.setdefault(key, []).append(
                np.asarray(float(value), dtype=np.float32)
            )
            self._meta[key] = dict(reduce_type=ReduceType.SCALAR)

    def _partials(self) -> Dict[str, tuple]:
        """Per-key reduction partials: (reduce_type, a, b) where
        AVG/SCALAR -> (weighted sum, count); SUM -> (sum, 0);
        MIN/MAX -> (extreme, valid-count)."""
        out: Dict[str, tuple] = {}
        for key, values in self._stats.items():
            rt = self._meta[key].get("reduce_type", ReduceType.SCALAR)
            if rt == ReduceType.SCALAR:
                out[key] = (rt, float(np.sum(values)), float(len(values)))
                continue
            vcat = np.concatenate([v.reshape(-1) for v, _ in values])
            mcat = np.concatenate([m.reshape(-1) for _, m in values])
            n = float(mcat.sum())
            if rt in (ReduceType.AVG, ReduceType.SUM):
                out[key] = (rt, float((vcat * mcat).sum()), n)
            elif rt == ReduceType.MIN:
                out[key] = (rt, float(np.where(mcat, vcat, np.inf).min()) if n else np.inf, n)
            elif rt == ReduceType.MAX:
                out[key] = (rt, float(np.where(mcat, vcat, -np.inf).max()) if n else -np.inf, n)
        for key, masks in self._denominators.items():
            out[f"{key}/n"] = (ReduceType.SUM, float(sum(m.sum() for m in masks)), 0.0)
        return out

    def export(self, reset: bool = True, cross_host: bool = False) -> Dict[str, float]:
        parts = self._partials()
        if cross_host:
            parts = _cross_host_reduce(parts)
        result: Dict[str, float] = {}
        for key, (rt, a, b) in parts.items():
            if rt in (ReduceType.AVG, ReduceType.SCALAR):
                result[key] = a / max(b, 1)
            elif rt == ReduceType.SUM:
                result[key] = a
            elif rt == ReduceType.MIN:
                result[key] = a if b else 0.0
            elif rt == ReduceType.MAX:
                result[key] = a if b else 0.0
        if reset:
            self._stats.clear()
            self._denominators.clear()
        return result


def _cross_host_reduce(parts: Dict[str, tuple]) -> Dict[str, tuple]:
    """Combine per-process partials over the initialised
    ``torch.distributed`` world (no-op with one process or none). Keys must
    agree across processes: divergence raises instead of skewing metrics."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or (
            dist.get_world_size() == 1):
        return parts
    keys = sorted(parts)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, keys)
    if any(k != keys for k in everyone):
        raise RuntimeError(
            "stats_tracker keys differ across processes: "
            f"{[len(k) for k in everyone]} keys")
    mat = torch.tensor([[parts[k][1], parts[k][2]] for k in keys],
                       dtype=torch.float64).reshape(len(keys), 2)
    rows = [torch.empty_like(mat) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, mat)
    gathered = torch.stack(rows).numpy()  # [P, n_keys, 2]
    out: Dict[str, tuple] = {}
    for i, k in enumerate(keys):
        rt = parts[k][0]
        a_all, b_all = gathered[:, i, 0], gathered[:, i, 1]
        if rt == ReduceType.MIN:
            out[k] = (rt, float(a_all.min()), float(b_all.sum()))
        elif rt == ReduceType.MAX:
            out[k] = (rt, float(a_all.max()), float(b_all.sum()))
        else:
            out[k] = (rt, float(a_all.sum()), float(b_all.sum()))
    return out


# Default process-level tracker, in the reference's module-level style.
DEFAULT = DistributedStatsTracker()

denominator = DEFAULT.denominator
stat = DEFAULT.stat
scalar = DEFAULT.scalar
scope = DEFAULT.scope
export = DEFAULT.export
