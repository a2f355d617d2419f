"""Environment-service API: ``EnvironmentService`` of
``areal_tpu/api/env.py`` (its registry waits for a caller)."""

import abc
from typing import Any, Dict, List, Tuple


class EnvironmentService(abc.ABC):
    async def reset(self, seed=None, options=None):
        return None, {}

    @abc.abstractmethod
    async def step(self, action: Tuple) -> Tuple[Any, List[float], bool, bool, Dict]:
        """Returns (obs, rewards, terminated, truncated, info)."""
        ...
