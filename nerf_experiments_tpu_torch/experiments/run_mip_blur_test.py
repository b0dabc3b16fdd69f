"""Mip blur-schedule test: the Mip-BARF pipeline (`run_bip_barf`) without
pose noise and with a start blur sigma of 15, which isolates the coupled
blur / IPE sigma schedule's effect on the reconstruction (parity with
`barf/run_mip_blur_test.py`)."""
from nerf_experiments_tpu_torch.experiments import run_bip_barf

PRESET = [
    "--camera_origin_noise_sigma", "0.0",
    "--camera_rotation_noise_sigma", "0.0",
    "--start_blur_sigma", "15.0",
    "--start_pixel_width_sigma", "15.0",
    "--max_blur_sigma", "15.0",
]


def parse_args(argv=None):
    return run_bip_barf.parse_args(PRESET + list(argv or []))


def main(argv=None):
    return run_bip_barf.main(PRESET + list(argv or []))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
