"""Hand-written CUDA kernels (sources in ``areal_tpu_torch/csrc``) and
their wrappers. Nothing here touches the toolchain at import time."""
