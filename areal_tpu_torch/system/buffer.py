"""Trainer-side sequence buffer: staleness-ordered, capacity-bounded intake
(the counterpart of ``areal_tpu/system/buffer.py``).

- Batches pop oldest version first, bounding the off-policyness actually
  trained on (the manager's gate bounds what is started).
- Samples more than ``max_version_lag`` versions behind the trainer are
  dropped at put and at pop; they never reach the optimizer.
- Over ``capacity``, the oldest sample is dropped.

``record_consumption`` folds a consumed sample's lifecycle stamps into
``HISTOGRAMS`` (this module's observations; the reference feeds its
process-global metrics instead).
"""

import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from areal_tpu_torch.api.data import SequenceSample

logger = logging.getLogger("areal_tpu_torch.buffer")

# the reference's histogram names
STALENESS_VERSIONS = "staleness_versions"
QUEUE_WAIT_S = "queue_wait_s"
E2E_LATENCY_S = "e2e_latency_s"
TTFC_S = "ttfc_s"
REWARD_LAG_S = "reward_lag_s"
HISTOGRAMS: Dict[str, List[float]] = defaultdict(list)


def _meta_time(sample: SequenceSample, key: str) -> Optional[float]:
    """Earliest positive lifecycle stamp under ``metadata[key]``, or None
    when unstamped."""
    vals = (sample.metadata or {}).get(key)
    if not vals:
        return None
    try:
        ts = [float(v) for v in vals if v and float(v) > 0]
    except (TypeError, ValueError):
        return None
    return min(ts) if ts else None


def record_batch_consumption(samples: List[SequenceSample],
                             current_version: int) -> None:
    """Record a committed batch's lifecycle stamps (``pop_batch`` records
    nothing: a popped batch may be put back)."""
    for s in samples:
        record_consumption(s, current_version)


def record_consumption(sample: SequenceSample, current_version: int) -> None:
    """Staleness in versions, queue wait (rollout enqueue -> here),
    end-to-end latency (generation submit -> here), time to first chunk and
    submit -> reward lag of one consumed sample."""
    now = time.time()
    v = sample_version_start(sample)
    if v is not None:
        HISTOGRAMS[STALENESS_VERSIONS].append(max(current_version - v, 0))
    submit = _meta_time(sample, "submit_time")
    enqueue = _meta_time(sample, "enqueue_time")
    first_chunk = _meta_time(sample, "first_chunk_time")
    reward = _meta_time(sample, "reward_time")
    if enqueue is not None:
        HISTOGRAMS[QUEUE_WAIT_S].append(max(now - enqueue, 0.0))
    if submit is not None:
        HISTOGRAMS[E2E_LATENCY_S].append(max(now - submit, 0.0))
        if first_chunk is not None:
            HISTOGRAMS[TTFC_S].append(max(first_chunk - submit, 0.0))
        if reward is not None:
            HISTOGRAMS[REWARD_LAG_S].append(max(reward - submit, 0.0))


def sample_version_start(sample: SequenceSample) -> Optional[int]:
    """Minimum generation-start version across the group's sequences, or
    None when the sample carries no version tags."""
    if sample.data is None or "version_start" not in (sample.data or {}):
        return None
    v = np.asarray(sample.data["version_start"])
    return int(v.min()) if v.size else None


class SequenceBuffer:
    """Not thread-safe; the trainer is the only consumer (the stream
    dataset already serializes arrivals through its queue)."""

    def __init__(self, capacity: int = 16384,
                 max_version_lag: Optional[int] = None):
        self.capacity = capacity
        self.max_version_lag = max_version_lag
        self._items: List[Tuple[int, int, SequenceSample]] = []  # (ver, seq, s)
        self._arrival = 0
        self.n_dropped_stale = 0
        self.n_dropped_capacity = 0

    def __len__(self) -> int:
        return len(self._items)

    def put(self, sample: SequenceSample, current_version: int = 0):
        v = sample_version_start(sample)
        if self._too_stale(v, current_version):
            self.n_dropped_stale += 1
            logger.warning(
                "dropping stale sample %s: version_start=%s, trainer at v%d "
                "(window %s)", sample.ids, v, current_version,
                self.max_version_lag,
            )
            return
        self._items.append((v if v is not None else current_version,
                            self._arrival, sample))
        self._arrival += 1
        if len(self._items) > self.capacity:
            i = min(range(len(self._items)), key=lambda j: self._items[j][:2])
            dropped = self._items.pop(i)
            self.n_dropped_capacity += 1
            logger.warning("buffer over capacity %d: dropped oldest sample %s",
                           self.capacity, dropped[2].ids)

    def clear(self) -> int:
        """Drop every queued sample; returns the number dropped."""
        n = len(self._items)
        self._items = []
        return n

    def _too_stale(self, v: Optional[int], current_version: int) -> bool:
        return (self.max_version_lag is not None and v is not None
                and current_version - v > self.max_version_lag)

    def pop_batch(self, n: int, current_version: int = 0) -> List[SequenceSample]:
        """Up to ``n`` samples, oldest version first (ties: arrival order);
        samples that became over-stale while queued are dropped here."""
        self._items.sort(key=lambda t: (t[0], t[1]))
        kept: List[Tuple[int, int, SequenceSample]] = []
        out: List[SequenceSample] = []
        for v, a, s in self._items:
            if self._too_stale(v, current_version):
                self.n_dropped_stale += 1
                logger.warning("dropping stale queued sample %s (v%s << v%d)",
                               s.ids, v, current_version)
            elif len(out) < n:
                out.append(s)
            else:
                kept.append((v, a, s))
        self._items = kept
        return out
