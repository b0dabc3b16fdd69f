"""K4, the flagship train kernel (`csrc/flagship_train.cu`: the row pass,
the dW GEMM and its reduction, one `netpu_flagship_train` call): forward,
compositing, MSE gradient and backward of the radiance net over each ray's
samples. Operations: 6 a weight a sample (the forward product and both
backward products, 2 each). Bytes: each ray's origin and direction, its
bins' starts and ends and its target read once, its rgb and geometry
gradients written once (`chip_smoke.kernel_bounds`' count)."""

KERNELS = ("flagship_train_kernel", "flagship_train_fma_kernel", "dw_partial_kernel",
           "dw_partial_fma_kernel", "netpu::reduce_kernel")


def work(rays: int, samples: int, macs: int):
    return 6 * macs * rays * samples, 4 * rays * (6 + 2 * samples + 5)
