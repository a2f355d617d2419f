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

The rollout stream and the trainer's buffer use ``from_default``,
``gather``, ``unpack``, ``meta``, ``select``, the JSON wire codecs
(``as_json_compatible`` / ``from_json_compatible``) and ``cpu_nbytes``;
the function executor uses ``remap_keys_``. Left out until a ported
caller needs it: the method form of ``split_into_micro_batches`` (the
trainer uses ``train/batching.py::split_into_micro_batches``).
"""

import dataclasses
import itertools
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

    @classmethod
    def from_default(
        cls,
        ids: List[Any],
        seqlens: List[int],
        data: Dict[str, np.ndarray],
        metadata: Optional[Dict[str, List[Any]]] = None,
    ) -> "SequenceSample":
        """Every key holds one sequence per item with the same lengths,
        except keys with one value per item, which get length-1 entries."""
        seqlens = [int(x) for x in seqlens]
        sls: Dict[str, List[List[int]]] = {}
        for k, v in data.items():
            v = np.asarray(v)
            if v.shape[0] == len(ids) and v.shape[0] != sum(seqlens):
                sls[k] = [[1] for _ in ids]  # scalar-per-item key
            else:
                sls[k] = [[s] for s in seqlens]
        return cls(keys=set(data.keys()), ids=list(ids), seqlens=sls,
                   data=dict(data), metadata=metadata or {})

    @property
    def bs(self) -> int:
        return len(self.ids)

    def item_total_len(self, key: str, i: int) -> int:
        return sum(self.seqlens[key][i])

    def total_len(self, key: str) -> int:
        return sum(self.item_total_len(key, i) for i in range(self.bs))

    def _offsets(self, key: str) -> np.ndarray:
        lens = [self.item_total_len(key, i) for i in range(self.bs)]
        return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    @classmethod
    def gather(cls, samples: Sequence["SequenceSample"],
               keys=None) -> "SequenceSample":
        """Concatenate ``samples`` item-wise over ``keys`` (default: the
        first sample's keys); metadata present in every sample is kept."""
        if not samples:
            raise ValueError("gather of zero samples")
        keys = set(keys) if keys is not None else set(samples[0].keys)
        for s in samples:
            if not keys.issubset(s.keys):
                raise ValueError(f"missing keys {keys - s.keys} in gather")
        ids = list(itertools.chain.from_iterable(s.ids for s in samples))
        seqlens = {
            k: list(itertools.chain.from_iterable(s.seqlens[k] for s in samples))
            for k in keys
        }
        data = None
        if all(s.data is not None for s in samples):
            data = {}
            for k in keys:
                parts = [s.data.get(k) for s in samples]
                if all(p is None for p in parts):
                    data[k] = None
                elif any(p is None for p in parts):
                    raise ValueError(
                        f"gather: key {k!r} present in some samples but None "
                        "in others"
                    )
                else:
                    data[k] = np.concatenate(parts, axis=0)
        metadata = {
            mk: list(itertools.chain.from_iterable(s.metadata[mk]
                                                   for s in samples))
            for mk in samples[0].metadata
            if all(mk in s.metadata for s in samples)
        }
        return cls(
            keys=keys, ids=ids, seqlens=seqlens, data=data,
            dtypes={k: samples[0].dtypes.get(k) for k in keys},
            trailing_shapes={k: samples[0].trailing_shapes.get(k)
                             for k in keys},
            metadata=metadata,
        )

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

    def unpack(self) -> List["SequenceSample"]:
        return self.split_with_lengths([1] * self.bs)

    def main_key(self) -> str:
        for cand in ("packed_input_ids", "packed_prompts", "input_ids"):
            if cand in self.keys:
                return cand
        return sorted(self.keys)[0]

    def meta(self) -> "SequenceSample":
        """The structure without the arrays."""
        return SequenceSample(
            keys=set(self.keys),
            ids=list(self.ids),
            seqlens={k: [list(s) for s in v] for k, v in self.seqlens.items()},
            data=None,
            dtypes=dict(self.dtypes),
            trailing_shapes=dict(self.trailing_shapes),
            metadata={mk: list(vs) for mk, vs in self.metadata.items()},
        )

    def select(self, keys) -> "SequenceSample":
        keys = set(keys)
        if not keys.issubset(self.keys):
            raise ValueError(f"select: missing {keys - self.keys}")
        return SequenceSample(
            keys=keys,
            ids=list(self.ids),
            seqlens={k: self.seqlens[k] for k in keys},
            data=None if self.data is None else {k: self.data.get(k)
                                                 for k in keys},
            dtypes={k: self.dtypes.get(k) for k in keys},
            trailing_shapes={k: self.trailing_shapes.get(k) for k in keys},
            metadata=dict(self.metadata),
        )

    def as_json_compatible(self) -> dict:
        """The wire form of the rollout -> trainer stream (flat lists)."""
        data = None if self.data is None else {
            k: (None if v is None else v.reshape(-1).tolist())
            for k, v in self.data.items()
        }
        return dict(
            ids=[str(i) for i in self.ids],
            keys=sorted(self.keys),
            seqlens=self.seqlens,
            dtypes=self.dtypes,
            trailing_shapes={k: (None if v is None else list(v))
                             for k, v in self.trailing_shapes.items()},
            data=data,
            metadata=self.metadata,
        )

    @classmethod
    def from_json_compatible(cls, d: dict) -> "SequenceSample":
        data = None
        if d.get("data") is not None:
            data = {}
            for k, flat in d["data"].items():
                if flat is None:
                    data[k] = None
                    continue
                arr = np.asarray(flat, dtype=np.dtype(d["dtypes"][k]))
                trail = tuple(d["trailing_shapes"][k] or ())
                total = sum(sum(s) for s in d["seqlens"][k])
                data[k] = arr.reshape((total,) + trail)
        return cls(
            keys=set(d["keys"]),
            ids=list(d["ids"]),
            seqlens={k: [list(s) for s in v] for k, v in d["seqlens"].items()},
            data=data,
            dtypes=dict(d["dtypes"]),
            trailing_shapes={k: (None if v is None else tuple(v))
                             for k, v in d["trailing_shapes"].items()},
            metadata={k: list(v) for k, v in d.get("metadata", {}).items()},
        )

    def cpu_nbytes(self) -> int:
        if self.data is None:
            return 0
        return sum(v.nbytes for v in self.data.values() if v is not None)

    def remap_keys_(self, remap: Dict[str, str]):
        for old, new in remap.items():
            if old not in self.keys:
                continue
            self.keys.discard(old)
            self.keys.add(new)
            self.seqlens[new] = self.seqlens.pop(old)
            self.dtypes[new] = self.dtypes.pop(old)
            self.trailing_shapes[new] = self.trailing_shapes.pop(old)
            if self.data is not None and old in self.data:
                self.data[new] = self.data.pop(old)

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
