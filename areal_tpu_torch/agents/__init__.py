"""Agents."""

from areal_tpu_torch.api.agent import register_agent
from areal_tpu_torch.agents.math_multi_turn import MathMultiTurnAgent
from areal_tpu_torch.agents.math_single_step import MathSingleStepAgent

register_agent("math-single-step", MathSingleStepAgent)
register_agent("math-multi-turn", MathMultiTurnAgent)
