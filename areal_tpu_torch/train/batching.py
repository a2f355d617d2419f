"""Packed-batch formation: ``SequenceSample`` -> fixed-shape host buffers (a
copy of the pure-Python path of ``areal_tpu/train/batching.py``, which the
port may not import).

Sequences pack into ``[n_rows, capacity]`` numpy buffers — one row per data
shard; one row on one device — with ``segment_ids`` (0 = padding) marking
sequence boundaries and positions restarting per segment. Packing is
length-balanced (LPT greedy, deterministic). Per-sequence scalar keys
(rewards, eos masks, ...) are broadcast across their segment's tokens.

The reference's ``areal_tpu.native`` branches are left out: by its own
docstring they are bit-identical to this Python path.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from areal_tpu_torch.api.data import SequenceSample


@dataclasses.dataclass
class Placement:
    """Where one sequence landed: buffer row + token span."""

    item_idx: int      # index of the item in the source SequenceSample
    seq_idx: int       # index of the sequence within the item (grouped items)
    row: int
    start: int
    length: int
    segment: int       # segment id within the row (>= 1)


@dataclasses.dataclass
class PackedBatch:
    arrays: Dict[str, np.ndarray]          # each [n_rows, capacity] (+trailing)
    placements: List[Placement]
    n_rows: int
    capacity: int

    def unpack(self, out: np.ndarray) -> List[np.ndarray]:
        """Split a token-aligned output ``[n_rows, capacity, ...]`` back into
        per-sequence arrays, ordered like ``placements``."""
        return [
            out[p.row, p.start : p.start + p.length] for p in self.placements
        ]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_rows(lengths: Sequence[int], n_rows: int) -> List[int]:
    """LPT greedy: assign each length (desc order) to the least-loaded row.
    Returns a row index per input; ties go to the lowest row index."""
    if n_rows <= 0:
        raise ValueError(f"n_rows must be positive, got {n_rows}")
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    loads = [0] * n_rows
    rows = [0] * len(lengths)
    for i in order:
        r = min(range(n_rows), key=lambda j: (loads[j], j))
        rows[i] = r
        loads[r] += lengths[i]
    return rows


def pack_sequences(
    sample: SequenceSample,
    n_rows: int,
    capacity: Optional[int] = None,
    pad_multiple: int = 128,
) -> PackedBatch:
    """Pack every sequence of the sample's main key into ``[n_rows, capacity]``
    buffers together with all other keys (token-aligned keys packed in place,
    scalar keys broadcast across their segment)."""
    main_key = sample.main_key()
    units: List[Tuple[int, int, int]] = []  # (item_idx, seq_idx, length)
    for i, inner in enumerate(sample.seqlens[main_key]):
        for j, n in enumerate(inner):
            units.append((i, j, int(n)))
    lengths = [u[2] for u in units]
    rows = plan_rows(lengths, n_rows)
    loads = [0] * n_rows
    seg_counter = [0] * n_rows
    placements: List[Placement] = []
    for (i, j, n), r in zip(units, rows):
        seg_counter[r] += 1
        placements.append(Placement(i, j, r, loads[r], n, seg_counter[r]))
        loads[r] += n
    max_load = max(loads) if loads else 0
    if capacity is None:
        capacity = _round_up(max(max_load, pad_multiple), pad_multiple)
    if max_load > capacity:
        raise ValueError(
            f"Packed row load {max_load} exceeds capacity {capacity}"
        )

    arrays: Dict[str, np.ndarray] = {
        "segment_ids": np.zeros((n_rows, capacity), np.int32),
        "positions": np.zeros((n_rows, capacity), np.int32),
        "item_ids": np.zeros((n_rows, capacity), np.int32),
    }
    for p in placements:
        sl = (p.row, slice(p.start, p.start + p.length))
        arrays["segment_ids"][sl] = p.segment
        arrays["positions"][sl] = np.arange(p.length)
        arrays["item_ids"][sl] = p.item_idx

    main_inner = sample.seqlens[main_key]
    for key in sorted(sample.keys):
        data = sample.data.get(key) if sample.data else None
        if data is None:
            continue
        inner = sample.seqlens[key]
        offsets = sample._offsets(key)
        buf = np.zeros((n_rows, capacity) + data.shape[1:], data.dtype)
        for p in placements:
            item_lens = inner[p.item_idx]
            item_off = offsets[p.item_idx]
            sl = (p.row, slice(p.start, p.start + p.length))
            if len(item_lens) == len(main_inner[p.item_idx]) and item_lens[
                p.seq_idx
            ] == p.length:
                src = item_off + sum(item_lens[: p.seq_idx])
                buf[sl] = data[src : src + p.length]
            elif all(l == 1 for l in item_lens) and len(item_lens) == len(
                main_inner[p.item_idx]
            ):
                buf[sl] = data[item_off + p.seq_idx]
            elif item_lens == [1]:
                buf[sl] = data[item_off]
            else:
                raise ValueError(
                    f"Key {key!r}: cannot align seqlens {item_lens} with main "
                    f"key {main_inner[p.item_idx]}"
                )
        arrays["input_ids" if key == main_key else key] = buf
    return PackedBatch(
        arrays=arrays, placements=placements, n_rows=n_rows, capacity=capacity
    )


def count_action_tokens(pb: PackedBatch) -> float:
    """Host-side count of loss-bearing positions: tokens with a same-segment
    successor whose label is not a prompt token. Mirrors the mask used by the
    SFT/PPO losses so micro-batch grad weighting equals a global token-mean."""
    seg = pb.arrays["segment_ids"]
    nxt = np.concatenate([seg[:, 1:], np.zeros_like(seg[:, :1])], axis=1)
    has_next = (seg > 0) & (nxt == seg)
    if "prompt_mask" in pb.arrays:
        pm = pb.arrays["prompt_mask"].astype(bool)
        label_is_prompt = np.concatenate(
            [pm[:, 1:], np.zeros_like(pm[:, :1])], axis=1
        )
        has_next &= ~label_is_prompt
    return float(has_next.sum())


def split_into_micro_batches(
    sample: SequenceSample, n_mbs: int, max_tokens_per_mb: Optional[int], n_rows: int
) -> List[SequenceSample]:
    """Seqlen-balanced micro-batch split: at least ``n_mbs`` parts, split
    further until every part PACKS within ``max_tokens_per_mb`` per row
    (validated with the same row planner the packer uses). Sequences that
    can never fit a row are rejected here, at data intake."""
    if max_tokens_per_mb is not None:
        seqlens = sample.seqlens[sample.main_key()]
        longest = max((max(inner) for inner in seqlens), default=0)
        if longest > max_tokens_per_mb:
            raise ValueError(
                f"A single sequence of {longest} tokens exceeds "
                f"max_tokens_per_mb={max_tokens_per_mb}; it can never be "
                "packed. Filter over-long sequences at data intake or raise "
                "the micro-batch token budget."
            )
        total = sum(sum(inner) for inner in seqlens)
        budget = max_tokens_per_mb * n_rows
        n_mbs = max(n_mbs, -(-total // budget))
        n_mbs = min(n_mbs, sample.bs)

        def fits(parts: List[SequenceSample]) -> bool:
            for part in parts:
                lens = [
                    int(n)
                    for inner in part.seqlens[part.main_key()]
                    for n in inner
                ]
                rows = plan_rows(lens, n_rows)
                loads = [0] * n_rows
                for ln, r in zip(lens, rows):
                    loads[r] += ln
                if loads and max(loads) > max_tokens_per_mb:
                    return False
            return True

        while True:
            parts = sample.split(n_mbs)
            if fits(parts) or n_mbs >= sample.bs:
                break
            n_mbs += 1
        if not fits(parts):
            raise ValueError(
                "Cannot split into micro-batches fitting "
                f"max_tokens_per_mb={max_tokens_per_mb} with n_rows={n_rows}: "
                "a single (grouped) item overflows a row on its own."
            )
        return parts
    n_mbs = min(n_mbs, sample.bs)
    return sample.split(n_mbs)
