"""Prompt datasets for RL rollout (the port's part of
``areal_tpu/datasets``)."""

from areal_tpu_torch.api.dataset import register_dataset
from areal_tpu_torch.datasets.prompt import MathCodePromptDataset, PromptOnlyDataset

register_dataset("math_code_prompt", MathCodePromptDataset)
register_dataset("prompt", PromptOnlyDataset)
