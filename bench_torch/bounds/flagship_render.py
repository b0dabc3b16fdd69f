"""K2, the flagship render kernel (`csrc/flagship_render.cu`): the radiance
net's forward and the compositing over each ray's samples, no gradient.
Operations: 2 a weight a sample. Bytes: each ray's origin, direction and
bins read once, its rgb written once, as `chip_smoke.kernel_bounds` counts
them."""

KERNELS = ("flagship_render_kernel",)


def work(rays: int, samples: int, macs: int):
    return 2 * macs * rays * samples, 4 * rays * (6 + 2 * samples + 5)
