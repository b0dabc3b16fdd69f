"""SARF entry point, the `sarf/main.py` preset of the GARF-family runner
(damped-cosine activations, frequency LR factor 128, near-zero camera LR, 40
epochs)."""
from nerf_experiments_tpu_torch.experiments import garf_main


def main(argv=None):
    return garf_main.main(["--activation", "sarf"] + list(argv or []))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
