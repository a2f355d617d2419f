"""Activation functions (counterpart of ``areal_tpu/ops/activations.py``)."""

import torch
import torch.nn.functional as F

ACT2FN = {
    "silu": F.silu,
    # HF "gelu" is the exact erf form; the "_new"/"pytorch_tanh" names are
    # the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "tanh": torch.tanh,
}
