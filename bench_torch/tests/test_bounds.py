"""The bound arithmetic against `chip_smoke.kernel_bounds` at its own
shapes (8192 rays; K4 fp32 and K2 at 128 samples, K4 bf16 at 32): K4 fp32
25.15 ms, K4 bf16 x 32 1.05 ms, K2 fp32 8.38 ms, K2 bf16 1.40 ms."""
import pytest

from bench_torch import peaks
from bench_torch.bounds import flagship_render, flagship_train

MACS = 658944  # the flagship NerfMLP 4x256 x 2 segments, a sample


@pytest.mark.parametrize("mod, samples, precision, ms", [
    (flagship_train, 128, "fp32", 25.15),
    (flagship_train, 32, "bf16", 1.05),
    (flagship_render, 128, "fp32", 8.38),
    (flagship_render, 128, "bf16", 1.40),
])
def test_bounds_reproduce_the_smoke(mod, samples, precision, ms):
    got, by = peaks.bound_ms(*reversed(mod.work(8192, samples, MACS)), precision)
    assert by == "operations"
    assert round(got, 2) == ms


def test_fp32_rate_is_the_tensor_cores_exact_rate():
    assert abs(peaks.FP32_FLOP_PER_S - 164.8e12) < 0.05e12
    assert abs(peaks.FP32_FLOP_PER_S - peaks.TF32_FLOP_PER_S / 3) < 0.2e12
