"""Environment-service API and registry (a copy of
``areal_tpu/api/env.py``)."""

import abc
from typing import Any, Dict, List, Tuple


class EnvironmentService(abc.ABC):
    async def reset(self, seed=None, options=None):
        return None, {}

    @abc.abstractmethod
    async def step(self, action: Tuple) -> Tuple[Any, List[float], bool, bool, Dict]:
        """Returns (obs, rewards, terminated, truncated, info)."""
        ...


ALL_ENVS: Dict[str, type] = {}


def register_environment(name: str, cls: type):
    assert name not in ALL_ENVS, name
    ALL_ENVS[name] = cls


def make_env(name: str, **kwargs) -> EnvironmentService:
    import areal_tpu_torch.envs  # noqa: F401  (triggers registration)

    return ALL_ENVS[name](**kwargs)
