"""Device resolution shared by every entry point of the port."""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one. With no device given and no GPU present this raises —
    the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return torch.device("cuda")


TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (dtype objects pass through)."""
    if isinstance(name, torch.dtype):
        return name
    return TORCH_DTYPES[name]
