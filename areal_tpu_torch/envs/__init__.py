"""Environment services."""

from areal_tpu_torch.api.env import register_environment
from areal_tpu_torch.envs.math_code_single_step import MathCodeSingleStepEnv

register_environment("math-code-single-step", MathCodeSingleStepEnv)
