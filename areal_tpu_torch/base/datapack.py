"""Sequence-length balanced partitioning & bin packing (a copy of
``areal_tpu/base/datapack.py``, which the port may not import).

Counterpart of ``realhf/base/datapack.py`` (``ffd_allocate`` at :191 and the
balanced-partition helpers at :18). Used for:

- splitting a packed batch across DP ranks with near-equal token counts
  (contiguous partition minimizing the max part sum);
- packing sequences into micro-batches under a token budget (first-fit
  decreasing bin packing).

Pure Python/numpy: partitioning a few thousand sequence lengths is
microseconds and never on the hot path (the reference's C++ is also only a
CPU-side helper).
"""

from typing import List, Optional, Sequence

import numpy as np


def partition_balanced(nums: Sequence[int], k: int, min_size: int = 1) -> List[int]:
    """Partition ``nums`` into ``k`` contiguous groups minimizing the largest
    group sum; each group gets >= ``min_size`` items.

    Returns boundary indices ``bounds`` of length k+1 with bounds[0]==0 and
    bounds[k]==len(nums); group i is nums[bounds[i]:bounds[i+1]].
    """
    n = len(nums)
    if k <= 0 or n < k * min_size:
        raise ValueError(f"cannot partition {n} items into {k} groups (min_size={min_size})")
    nums = np.asarray(nums, dtype=np.int64)
    prefix = np.concatenate([[0], np.cumsum(nums)])

    def feasible(cap: int) -> Optional[List[int]]:
        bounds = [0]
        i = 0
        for g in range(k):
            remaining_groups = k - g - 1
            # Largest j such that sum(nums[i:j]) <= cap, j-i >= min_size,
            # and n - j >= remaining_groups * min_size.
            j_max = n - remaining_groups * min_size
            j = int(np.searchsorted(prefix, prefix[i] + cap, side="right")) - 1
            j = min(j, j_max)
            if j < i + min_size:
                return None
            bounds.append(j)
            i = j
        return bounds if bounds[-1] == n else None

    lo = int(max(nums.max(initial=0), (prefix[-1] + k - 1) // k))
    hi = int(prefix[-1])
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        b = feasible(mid)
        if b is not None:
            best = b
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:  # pragma: no cover - feasible(hi) always succeeds
        best = feasible(int(prefix[-1]))
    return best


def ffd_allocate(
    sizes: Sequence[int],
    capacity: int,
    min_groups: int = 1,
) -> List[List[int]]:
    """First-fit-decreasing bin packing: pack items (by original index) into
    the fewest bins with per-bin ``capacity``; at least ``min_groups`` bins.

    Items larger than capacity get singleton bins.
    """
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    bins: List[List[int]] = []
    loads: List[int] = []
    for i in order:
        placed = False
        for b in range(len(bins)):
            if loads[b] + sizes[i] <= capacity:
                bins[b].append(i)
                loads[b] += sizes[i]
                placed = True
                break
        if not placed:
            bins.append([i])
            loads.append(sizes[i])
    while len(bins) < min_groups:
        # Split the heaviest bin (possible only if it has >1 item).
        heavy = max(range(len(bins)), key=lambda b: (len(bins[b]) > 1, loads[b]))
        if len(bins[heavy]) <= 1:
            bins.append([])
            loads.append(0)
            continue
        item = bins[heavy].pop()
        loads[heavy] -= sizes[item]
        bins.append([item])
        loads.append(sizes[item])
    return bins


def flat2seq(x: np.ndarray, seqlens: Sequence[int]) -> List[np.ndarray]:
    """Split a packed 1D array into per-sequence views."""
    offsets = np.concatenate([[0], np.cumsum(seqlens)])
    return [x[offsets[i]: offsets[i + 1]] for i in range(len(seqlens))]
