"""The "naive" NeRF architecture in the BARF calibration pipeline
(`run_barf`): 4 segments re-injecting the position, the direction fed to
every segment, density from the colour head (parity with
`barf/run_naive_as_barf.py`). Not a flagship config, so it trains through
the plain step."""
from nerf_experiments_tpu_torch.experiments import run_barf

PRESET = ["--n_segments", "4", "--no-delayed_direction", "--delayed_density"]


def parse_args(argv=None):
    return run_barf.parse_args(PRESET + list(argv or []))


def main(argv=None):
    return run_barf.main(PRESET + list(argv or []))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
