"""Algorithm API contracts (a copy of ``areal_tpu/api/model.py``, which
the port may not import): ``FinetuneSpec``, ``PPOHyperparameters`` (with
the ``GenerationHyperparameters`` it holds), the ``ModelInterface`` base
(``save`` writes the engine's HF export) and the interface registry.
Interfaces receive the port's ``TrainEngine``.
"""

import abc
import dataclasses
from typing import Dict, List, Optional

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample


@dataclasses.dataclass
class FinetuneSpec:
    total_train_epochs: int
    dataset_size: int
    train_batch_size: int

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.dataset_size // self.train_batch_size)

    @property
    def total_train_steps(self) -> int:
        return self.total_train_epochs * self.steps_per_epoch


@dataclasses.dataclass
class GenerationHyperparameters:
    n: int = 1                      # samples per prompt (group size)
    max_new_tokens: int = 512
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = int(1e8)
    temperature: float = 1.0
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PPOHyperparameters:
    gen: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    ppo_n_minibatches: int = 4
    eps_clip: float = 0.2
    c_clip: Optional[float] = None
    value_eps_clip: float = 0.2
    early_stop_imp_ratio: float = 5.0
    actor_sample_reuse: int = 1
    critic_sample_reuse: int = 1
    max_reward_clip: float = 20.0
    reward_output_scaling: float = 1.0
    reward_output_bias: float = 0.0
    fuse_rew_ref: bool = True
    discount: float = 1.0
    gae_lambda: float = 1.0
    adv_norm: bool = True
    kl_ctl: float = 0.1
    use_adaptive_kl: bool = False
    adaptive_kl_target: float = 6.0
    adaptive_kl_horizon: float = 10000.0
    disable_value: bool = False       # critic-free (GRPO-style)
    value_norm: bool = False
    group_size: int = 1
    group_adv_norm: bool = False
    mask_no_eos_with_zero: bool = False
    # decoupled-PPO (async staleness control)
    use_decoupled_loss: bool = True
    behav_imp_weight_cap: Optional[float] = None
    recompute_logprob: bool = True


class ModelInterface(abc.ABC):
    """Algorithm object invoked per model function call; subclasses
    override what they need."""

    def inference(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Optional[SequenceSample]:
        raise NotImplementedError()

    def generate(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Optional[SequenceSample]:
        raise NotImplementedError()

    def train_step(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        raise NotImplementedError()

    def evaluate(self, engine, eval_dataloader) -> Dict[str, float]:
        return {}

    def save(self, engine, save_dir: str):
        family = getattr(self, "hf_family", None) or getattr(
            engine, "hf_family", None
        )
        if family:
            engine.save_hf(save_dir, family)
        else:
            raise ValueError(
                "No HF family configured for saving: set hf_family on the "
                "interface or load the engine from an HF checkpoint"
            )


ALL_INTERFACES: Dict[str, type] = {}


def register_interface(name: str, cls: type):
    if name in ALL_INTERFACES:
        raise ValueError(f"Interface {name} already registered")
    ALL_INTERFACES[name] = cls


def make_interface(name: str, **kwargs) -> ModelInterface:
    import areal_tpu_torch.interfaces  # noqa: F401  (triggers registration)

    return ALL_INTERFACES[name](**kwargs)
