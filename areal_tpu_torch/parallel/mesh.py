"""Parallelism config (a copy of ``ParallelConfig`` from
``areal_tpu/parallel/mesh.py``, which the port may not import). The port
trains on one device so far: the train engine raises
``NotImplementedError`` for any other world (multi-device training is a
later slice)."""

import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh axis sizes: data, fsdp, model (tensor) and ctx (context /
    sequence) parallelism."""

    data: int = 1
    fsdp: int = 1
    model: int = 1
    ctx: int = 1

    @property
    def world_size(self) -> int:
        return self.data * self.fsdp * self.ctx * self.model

    @classmethod
    def from_str(cls, s: str) -> "ParallelConfig":
        """Parse ``"d2f2c2m2"``-style strings."""
        m = re.fullmatch(r"d(\d+)(?:f(\d+))?(?:c(\d+))?m(\d+)", s)
        if not m:
            raise ValueError(f"Bad parallelism spec: {s!r}")
        return cls(
            data=int(m.group(1)),
            fsdp=int(m.group(2) or 1),
            ctx=int(m.group(3) or 1),
            model=int(m.group(4)),
        )
