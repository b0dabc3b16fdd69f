"""Model FLOPs of a BARF configuration, from its sizes: the multiply-adds of
one sample through each net's affine layers times the samples each net sees
a ray."""
from __future__ import annotations

from bench_torch.reference import barf as ref


def macs_per_ray(model: dict) -> int:
    macs = ref.macs_per_sample(model)
    total = macs["radiance"] * model["samples"]
    if "proposal" in macs:
        total += macs["proposal"] * model["proposal"]["samples"]
    return total


def train_flops_per_ray(model: dict) -> int:
    """6 a weight a sample: the forward product and both backward ones."""
    return 6 * macs_per_ray(model)


def render_flops_per_ray(model: dict) -> int:
    """2 a weight a sample: the forward product."""
    return 2 * macs_per_ray(model)
