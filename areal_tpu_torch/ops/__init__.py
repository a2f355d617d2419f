"""Compute ops of the port: plain PyTorch, with hand-written CUDA kernels
(``ops/cuda``) where the JAX package had Pallas kernels."""
