"""The packed-sequence batch ``SequenceSample`` and ``MicroBatchSpec`` (a
copy of the trainer slice's part of ``areal_tpu/api/data.py``, which the
port may not import).

A ``SequenceSample`` is a set of named packed 1D numpy arrays plus per-item
sequence lengths; padding happens only where the trainer packs device
buffers. Key semantics, as the reference:

- ``ids``: one unique id per *item* (an item may hold several sequences of a
  key, e.g. grouped GRPO samples share one item).
- ``seqlens[key]``: ``List[List[int]]`` — outer list over items, inner list
  over the sequences of that key within the item.

Left out until a ported caller needs them: ``from_default``, ``gather``,
``unpack``, ``total_len``, the JSON wire codecs,
``meta``/``select``/``remap_keys_``/``cpu_nbytes`` and the method form of
``split_into_micro_batches`` (the trainer uses
``train/batching.py::split_into_micro_batches``).
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from areal_tpu_torch.base import datapack


def _dtype_name(dt) -> str:
    return np.dtype(dt).name


@dataclasses.dataclass
class MicroBatchSpec:
    """How to split a batch into micro-batches."""

    n_mbs: int = 1                    # minimum number of micro-batches
    max_tokens_per_mb: Optional[int] = None  # token budget per micro-batch

    @classmethod
    def new(cls, other: "MicroBatchSpec", **kwargs):
        return cls(**{**dataclasses.asdict(other), **kwargs})


@dataclasses.dataclass
class SequenceSample:
    keys: set
    ids: List[Any]
    seqlens: Dict[str, List[List[int]]]
    data: Optional[Dict[str, Optional[np.ndarray]]] = None
    dtypes: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)
    trailing_shapes: Dict[str, Optional[Tuple[int, ...]]] = dataclasses.field(
        default_factory=dict
    )
    metadata: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.keys = set(self.keys)
        if self.data is not None:
            for k in self.keys:
                if k not in self.seqlens:
                    raise ValueError(f"Missing seqlens for key {k}")
                v = self.data.get(k)
                if v is None:
                    continue
                v = np.asarray(v)
                self.data[k] = v
                total = sum(sum(s) for s in self.seqlens[k])
                if v.shape[0] != total:
                    raise ValueError(
                        f"Key {k}: packed dim {v.shape[0]} != sum(seqlens) {total}"
                    )
                self.dtypes.setdefault(k, _dtype_name(v.dtype))
                self.trailing_shapes.setdefault(k, tuple(v.shape[1:]))
        for k in self.keys:
            self.dtypes.setdefault(k, None)
            self.trailing_shapes.setdefault(k, None)
        for vs in self.metadata.values():
            if len(vs) != self.bs:
                raise ValueError(
                    f"Metadata lists must have one entry per item "
                    f"({len(vs)} != {self.bs})"
                )

    @property
    def bs(self) -> int:
        return len(self.ids)

    def item_total_len(self, key: str, i: int) -> int:
        return sum(self.seqlens[key][i])

    def _offsets(self, key: str) -> np.ndarray:
        lens = [self.item_total_len(key, i) for i in range(self.bs)]
        return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    def split_with_lengths(self, part_lengths: Sequence[int]) -> List["SequenceSample"]:
        """Split items contiguously: part i gets ``part_lengths[i]`` items."""
        if sum(part_lengths) != self.bs:
            raise ValueError(f"part lengths {part_lengths} != bs {self.bs}")
        out = []
        start = 0
        offsets = {k: self._offsets(k) for k in self.keys}
        for pl in part_lengths:
            end = start + pl
            data = None
            if self.data is not None:
                data = {}
                for k in self.keys:
                    v = self.data.get(k)
                    data[k] = (
                        None
                        if v is None
                        else v[offsets[k][start]: offsets[k][end]]
                    )
            out.append(
                SequenceSample(
                    keys=set(self.keys),
                    ids=self.ids[start:end],
                    seqlens={k: self.seqlens[k][start:end] for k in self.keys},
                    data=data,
                    dtypes=dict(self.dtypes),
                    trailing_shapes=dict(self.trailing_shapes),
                    metadata={
                        mk: vs[start:end] for mk, vs in self.metadata.items()
                    },
                )
            )
            start = end
        return out

    def get_split_spec(self, k_parts: int, key: Optional[str] = None) -> List[int]:
        """Seqlen-balanced contiguous split into ``k_parts`` item groups."""
        key = key or self.main_key()
        lens = [self.item_total_len(key, i) for i in range(self.bs)]
        bounds = datapack.partition_balanced(lens, k_parts)
        return [bounds[i + 1] - bounds[i] for i in range(k_parts)]

    def split(self, k_parts: int, key: Optional[str] = None) -> List["SequenceSample"]:
        return self.split_with_lengths(self.get_split_spec(k_parts, key))

    def main_key(self) -> str:
        for cand in ("packed_input_ids", "packed_prompts", "input_ids"):
            if cand in self.keys:
                return cand
        return sorted(self.keys)[0]

    def update_(self, other: "SequenceSample"):
        """Merge keys of ``other`` (same ids, same order) into self."""
        if list(other.ids) != list(self.ids):
            raise ValueError("update_ requires identical item ids")
        self.keys |= other.keys
        self.seqlens.update(other.seqlens)
        self.dtypes.update(other.dtypes)
        self.trailing_shapes.update(other.trailing_shapes)
        if self.data is not None and other.data is not None:
            self.data.update(other.data)
        self.metadata.update(other.metadata)
