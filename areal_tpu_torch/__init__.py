"""areal_tpu_torch: the PyTorch/CUDA port of ``areal_tpu``.

Mirrors the JAX package module by module (same paths, same names), so each
port module has an obvious counterpart. The port imports ``torch`` and
never ``jax`` or ``areal_tpu``; what it needs from jax-free modules there
is copied. Every kernel that the JAX package wrote in Pallas for the TPU
is a hand-written CUDA kernel here (``csrc/``), built with ``nvcc`` at
first use (``ops/cuda/build.py``), with a plain PyTorch version beside it
that the CPU path and the tests use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
