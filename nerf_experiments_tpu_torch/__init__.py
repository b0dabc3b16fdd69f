"""PyTorch/CUDA port of `nerf_experiments_tpu` for one NVIDIA H100.

Same sub-packages and module names as the JAX package, which stays the
reference: tests run both on the same numpy inputs and compare. This package
imports torch and numpy only, never jax or `nerf_experiments_tpu`.
"""
