"""The vanilla NeRF architecture in the BARF calibration pipeline
(`run_barf`): 2 segments, delayed direction, density from the trunk; the
reference's check that architecture refactors keep their behaviour (parity
with `barf/run_vanilla_as_barf.py`)."""
from nerf_experiments_tpu_torch.experiments import run_barf

PRESET = ["--n_segments", "2", "--delayed_direction"]


def parse_args(argv=None):
    return run_barf.parse_args(PRESET + list(argv or []))


def main(argv=None):
    return run_barf.main(PRESET + list(argv or []))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
