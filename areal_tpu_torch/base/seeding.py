"""Deterministic seeding across python, numpy and torch (a copy of
``areal_tpu/base/seeding.py``). Where the reference hands out a root
``jax.random.key``, the port hands out a seeded ``torch.Generator``
derived from (seed, key string): every consumer draws from its own
generator instead of the global RNG state.
"""

import hashlib
import random
from typing import Optional

import numpy as np
import torch

_BASE_SEED: Optional[int] = None
_SEED_NAME: str = ""


def _hash(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:4], "little")


def set_random_seed(base_seed: int, name: str = ""):
    """Seed python and numpy with a per-component offset derived from
    ``name``."""
    global _BASE_SEED, _SEED_NAME
    _BASE_SEED, _SEED_NAME = base_seed, name
    seed = (base_seed + _hash(name)) % (2**31)
    random.seed(seed)
    np.random.seed(seed)


def base_seed() -> int:
    if _BASE_SEED is None:
        raise RuntimeError("set_random_seed() has not been called")
    return _BASE_SEED


def torch_generator(key_string: str = "", device="cpu") -> torch.Generator:
    """A fresh generator on ``device`` seeded from the base seed and a
    component id."""
    seed = (base_seed() + _hash(_SEED_NAME + "/" + key_string)) % (2**31)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
