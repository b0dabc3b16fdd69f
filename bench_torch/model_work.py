"""Model FLOPs of a configuration, from its sizes: the multiply-adds of one
ray through its nets' affine layers (`macs_per_ray` of the configuration's
reference family) times the FLOPs a multiply-add costs."""
from __future__ import annotations

from bench_torch import harness


def macs_per_ray(config: dict) -> int:
    return harness.family_module(config).macs_per_ray(config["model"])


def train_flops_per_ray(config: dict) -> int:
    """6 a weight a sample: the forward product and both backward ones."""
    return 6 * macs_per_ray(config)


def render_flops_per_ray(config: dict) -> int:
    """2 a weight a sample: the forward product."""
    return 2 * macs_per_ray(config)
