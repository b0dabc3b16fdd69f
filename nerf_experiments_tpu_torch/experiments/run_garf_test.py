"""GARF-in-barf controlled test run (`barf/run_garf_test.py:17-167`): the GARF
proposal + radiance nets and estimator with the barf experiment's defaults
(camera LR 2e-3 -> 5e-5 over 5 epochs, activation LR factor 128, radiance LR
2e-4 -> 8e-6 over 8 epochs, proposal 5e-4 -> 5e-6 over 8 epochs, no blur, 40
epochs): a bridge A/B between the barf and garf pipelines."""
from nerf_experiments_tpu_torch.experiments import garf_main


def main(argv=None):
    argv = [
        "--activation", "gauss",
        "--camera_learning_rate_start", "2e-3",
        "--camera_learning_rate_stop", "5e-5",
        "--camera_learning_rate_decay_end", "5.0",
        "--activation_learning_rate_factor", "128.0",
        "--radiance_learning_rate_start", "2e-4",
        "--radiance_learning_rate_stop", "8e-6",
        "--radiance_learning_rate_decay_end", "8.0",
        "--proposal_learning_rate_start", "5e-4",
        "--proposal_learning_rate_stop", "5e-6",
        "--proposal_learning_rate_decay_end", "8.0",
    ] + list(argv or [])
    return garf_main.main(argv)


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
