"""Algorithm interfaces. Importing this package registers the built-in
ones (``sft``, ``ppo_actor``, ``ppo_critic``, ``reward``) for
``api.model.make_interface``."""

from areal_tpu_torch.api.model import register_interface
from areal_tpu_torch.interfaces.ppo import PPOActorInterface, PPOCriticInterface
from areal_tpu_torch.interfaces.reward import PairedRewardInterface
from areal_tpu_torch.interfaces.sft import SFTInterface

register_interface("sft", SFTInterface)
register_interface("ppo_actor", PPOActorInterface)
register_interface("ppo_critic", PPOCriticInterface)
register_interface("reward", PairedRewardInterface)
