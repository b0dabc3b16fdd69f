"""The benchmark of the PyTorch and CUDA port (`nerf_experiments_tpu_torch`):
a harness driven by the data files beside it (README.md)."""
