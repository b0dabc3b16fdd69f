"""Visualise the IPE x BARF-mask encoding weights against the distance t.

Port of the JAX package's `experiments/studies/visualise_pe_mask.py` on the
port's `encodings/fourier.py`. Parity with
`barf/visualise_mip_barf_pe_mask.py:1-80`: the per-frequency attenuation of
the IntegratedBarf encoding along a ray (the IPE Gaussian weight times the
BARF cosine mask) for a sweep of t values and alphas, written as .npz (and a
matplotlib PNG when matplotlib is installed). Useful for choosing alpha /
sigma schedules.

    python -m nerf_experiments_tpu_torch.experiments.studies.visualise_pe_mask
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from nerf_experiments_tpu_torch.encodings.fourier import Integrated, _barf_mask


def pe_mask_weights(levels: int = 10, alphas=(0.0, 2.5, 5.0, 10.0), t_range=(2.0, 8.0),
                    n_t: int = 64, pixel_width: float = 1.0 / 555.0, bin_width: float = 0.05):
    """(ts, {alpha: (n_t, levels) combined weights}) for a canonical
    axis-aligned ray (looking down -z)."""
    ts = np.linspace(*t_range, n_t)
    enc = Integrated(levels=levels, scale=1.0, include_identity=False,
                     distribute_variance=False)
    t = torch.tensor(ts, dtype=torch.float32)[:, None]
    pos = torch.cat([torch.zeros((n_t, 2)), -t], dim=1)
    dirs = torch.tensor([[0.0, 0.0, -1.0]]).expand(n_t, 3)
    feats = enc(pos, dirs, torch.full((n_t, 1), pixel_width), t - bin_width / 2,
                t + bin_width / 2).numpy()
    # the cos block's z channel: |feature| since the mean position's z ~ -t
    cos_z = np.abs(feats[:, 2 * levels:3 * levels])
    # divide out the cosine's value to keep the attenuation weight alone
    arg = -ts[:, None] * (2.0 ** np.arange(levels))
    attenuation = np.clip(cos_z / np.maximum(np.abs(np.cos(arg)), 1e-3), 0, 1)
    out = {}
    for alpha in alphas:
        mask = _barf_mask(levels, 1, float(alpha), torch.zeros(())).numpy()
        out[alpha] = attenuation * mask[:levels]
    return ts, out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default="runs/pe_mask")
    p.add_argument("--levels", type=int, default=10)
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    ts, weights = pe_mask_weights(levels=args.levels)
    path = os.path.join(args.out_dir, "pe_mask_weights.npz")
    np.savez(path, t=ts, **{f"alpha_{a}": w for a, w in weights.items()})
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(path)
        return path
    fig, axes = plt.subplots(1, len(weights), figsize=(4 * len(weights), 3))
    for ax, (a, w) in zip(np.atleast_1d(axes), weights.items()):
        ax.imshow(w.T, aspect="auto", origin="lower", extent=[ts[0], ts[-1], 0, args.levels])
        ax.set_title(f"alpha={a}")
        ax.set_xlabel("t")
        ax.set_ylabel("frequency level")
    fig.tight_layout()
    fig.savefig(os.path.join(args.out_dir, "pe_mask.png"))
    plt.close(fig)
    print(path)
    return path


if __name__ == "__main__":
    main()
