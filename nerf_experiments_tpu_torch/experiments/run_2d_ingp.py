"""2-D multiresolution hash-grid image fitting ("Gigapixel").

Port of the JAX package's `experiments/run_2d_ingp.py`, with the same flags
and defaults: parity with `2d-ingp/main.py` + `2d-ingp/model.py`:
INGPEncoding (16 levels, 2 features, 2^16 tables, resolutions 16-2048) +
small ReLU MLP + sigmoid, Adam 1e-3 (betas 0.9 / 0.99, eps 1e-15) with the
plateau scale of `optax.contrib.reduce_on_plateau(0.5, patience 5,
accumulation 100)`, on the pixels of one image (the procedural test image
unless --image_path). Each step draws its pixels from a seeded
`torch.Generator` on the device; the table access runs the hash-grid
kernels on a CUDA device. Prints the result as one JSON line; with
--save_image also writes recon.png and summary.json into --out_dir.

    python -m nerf_experiments_tpu_torch.experiments.run_2d_ingp [--save_image]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from nerf_experiments_tpu_torch.data import single_image
from nerf_experiments_tpu_torch.models import ingp
from nerf_experiments_tpu_torch.ops import hashgrid
from nerf_experiments_tpu_torch.ops.metrics import psnr
from nerf_experiments_tpu_torch.training.loggers import MetricLogger
from nerf_experiments_tpu_torch.training.optim import ReduceOnPlateau


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image_path", type=str, default=None)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--n_levels", type=int, default=16)
    p.add_argument("--n_features", type=int, default=2)
    p.add_argument("--table_size", type=int, default=2**16)
    p.add_argument("--resolution_min", type=int, default=16)
    p.add_argument("--resolution_max", type=int, default=2048)
    p.add_argument("--n_hidden", type=int, default=2)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--encoder", choices=ingp.ENCODERS, default="fused")
    p.add_argument("--batch_size", type=int, default=8192)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="runs/2d_ingp")
    p.add_argument("--save_image", action="store_true", default=False,
                   help="write recon.png (full-image reconstruction) + "
                        "full-image PSNR into out_dir")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; a run without a card needs --device cpu")
    return p.parse_args(argv)


def train(args):
    """(params, cfg, result {"val_loss", "val_psnr"[, "full_image_psnr"]})."""
    if args.image_path:
        data = single_image.load_path(args.image_path, pixel_shuffle_seed=args.seed)
    else:
        img = single_image.procedural_test_image(args.image_size, args.seed)
        data = single_image.load(img, pixel_shuffle_seed=args.seed)
    dev = torch.device(args.device)

    grid = hashgrid.HashGridConfig(
        dim=2,
        resolution_min=args.resolution_min,
        resolution_max=args.resolution_max,
        table_size=args.table_size,
        n_features=args.n_features,
        n_levels=args.n_levels,
    )
    cfg = ingp.GigapixelConfig(grid=grid, n_hidden=args.n_hidden,
                               hidden_dim=args.hidden_dim, encoder=args.encoder)
    params = ingp.gigapixel_init(torch.Generator().manual_seed(args.seed), cfg).to(dev)
    # Instant-NGP-style Adam: betas (0.9, 0.99), eps 1e-15 (`3d-ingp/model.py:503-510`)
    adam = torch.optim.Adam(params.parameters(), lr=args.learning_rate, betas=(0.9, 0.99),
                            eps=1e-15)
    # plateau per ~epoch (loss averaged over 100 steps), not per batch:
    # factor 0.5 after 5 windows without improvement (its defaults)
    plateau = ReduceOnPlateau()

    coords, colors = (torch.as_tensor(a, device=dev) for a in data.splits["train"])
    val_coords, val_colors = (torch.as_tensor(a, device=dev) for a in data.splits["val"])

    def val_loss() -> float:
        with torch.no_grad():
            return float(torch.mean((ingp.gigapixel_apply(params, cfg, val_coords)
                                     - val_colors) ** 2))

    logger = MetricLogger(args.out_dir)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for i in range(args.steps):
        idx = torch.randint(0, coords.shape[0], (args.batch_size,), generator=gen, device=dev)
        adam.zero_grad(set_to_none=True)
        loss = torch.mean((ingp.gigapixel_apply(params, cfg, coords[idx]) - colors[idx]) ** 2)
        loss.backward()
        scale = plateau.update(loss)
        for group in adam.param_groups:
            group["lr"] = args.learning_rate * scale
        adam.step()
        if (i + 1) % 200 == 0:
            vl = val_loss()
            logger.log({"train_loss": float(loss.detach()), "val_loss": vl,
                        "val_psnr": float(psnr(torch.tensor(vl)))}, i + 1)

    final = val_loss()
    result = {"val_loss": final, "val_psnr": float(psnr(torch.tensor(final)))}
    if args.save_image:
        @torch.no_grad()
        def apply_fn(c):
            return ingp.gigapixel_apply(params, cfg, torch.as_tensor(c, device=dev)).cpu().numpy()

        recon = single_image.reconstruct_image(apply_fn, data)
        os.makedirs(args.out_dir, exist_ok=True)
        single_image.save_png(os.path.join(args.out_dir, "recon.png"), recon)
        result["full_image_psnr"] = single_image.full_image_psnr(recon, data)
        with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    return params, cfg, result


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
