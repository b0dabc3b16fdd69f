"""GaborF entry point, the `gaborf/main.py` preset of the GARF-family
runner (Gabor activations, LR factor 128, init U(0,2), 20 epochs)."""
from nerf_experiments_tpu_torch.experiments import garf_main


def main(argv=None):
    return garf_main.main(["--activation", "gabor"] + list(argv or []))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
