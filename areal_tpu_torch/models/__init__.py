"""Model layer of the port: config and the paged-KV transformer."""

from areal_tpu_torch.models.config import ModelConfig  # noqa: F401
