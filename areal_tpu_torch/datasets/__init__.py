"""Datasets (the port's part of ``areal_tpu/datasets``): prompts for RL
rollout, prompt-answer pairs for SFT and paired answers for reward-model
training."""

from areal_tpu_torch.api.dataset import register_dataset
from areal_tpu_torch.datasets.prompt import MathCodePromptDataset, PromptOnlyDataset
from areal_tpu_torch.datasets.prompt_answer import PromptAnswerDataset
from areal_tpu_torch.datasets.rw_paired import RewardPairedDataset

register_dataset("math_code_prompt", MathCodePromptDataset)
register_dataset("prompt", PromptOnlyDataset)
register_dataset("prompt_answer", PromptAnswerDataset)
register_dataset("rw_paired", RewardPairedDataset)
