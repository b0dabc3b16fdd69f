"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W) that every roofline and MFU reading divides by.

One rate a precision, whatever implements the products: bf16 at the
tensor cores' 989 TFLOP/s; fp32 at 989 / 6 = 164.8 TFLOP/s, the rate of
products exact to fp32 on the tensor cores (each factor split into three
bf16 parts and the six partial products a_i b_j with i + j <= 2 kept; as fast
as 3xTF32 at 495 / 3). A kernel that runs its fp32 products on the CUDA
cores (67 TFLOP/s) is measured against the same rate, so moving it to the
tensor cores cannot read above 100 %.
"""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = BF16_FLOP_PER_S / 6
TF32_FLOP_PER_S = 495e12
CUDA_CORE_FP32_FLOP_PER_S = 67e12

FLOP_PER_S = {"bf16": BF16_FLOP_PER_S, "fp32": FP32_FLOP_PER_S}


def bound_ms(n_bytes: float, flops: float, precision: str):
    """(least ms the card could take, "bytes" or "operations"): the bytes
    once over the memory's rate against the operations at the precision's
    rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOP_PER_S[precision] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
