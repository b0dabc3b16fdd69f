"""2-D image reconstruction: a Fourier-feature MLP fits one image.

Port of the JAX package's `experiments/run_2d_reconstruction.py`, with the
same flags and defaults: parity with `2d-reconstruction/main.py` + `model.py`:
Nerf2d (tanh MLP over 2-D Fourier features, sigmoid rgb), Adam 1e-3 with
optax's defaults, the plateau scale of `optax.contrib.reduce_on_plateau(0.5,
patience 20, accumulation 100)` applied to the same step's update, on the
pixels of one image (the procedural test image unless --image_path) with the
seeded (0.9, 0.05, 0.05) pixel split. Each step draws its pixels from a
generator seeded from (seed + 1, step); with --checkpoint_every_n_steps the
run saves the parameters, Adam's and the plateau's state, and --resume
continues from the latest checkpoint in <out_dir>/ckpt bit for bit. Prints
the result as one JSON line; with --save_image also writes recon.png and
summary.json into --out_dir.

    python -m nerf_experiments_tpu_torch.experiments.run_2d_reconstruction [--save_image]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from nerf_experiments_tpu_torch.data import single_image
from nerf_experiments_tpu_torch.models import nerf2d
from nerf_experiments_tpu_torch.ops.metrics import psnr
from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager
from nerf_experiments_tpu_torch.training.loggers import MetricLogger
from nerf_experiments_tpu_torch.training.optim import ReduceOnPlateau
from nerf_experiments_tpu_torch.utils.seeds import mix_seed


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image_path", type=str, default=None,
                   help="image to fit; default = procedural test image")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--fourier_levels", type=int, default=10)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--lr_decay", type=float, default=0.5)
    p.add_argument("--lr_decay_patience", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="runs/2d")
    p.add_argument("--save_image", action="store_true", default=False,
                   help="write recon.png (full-image reconstruction) + "
                        "full-image PSNR into out_dir")
    p.add_argument("--checkpoint_every_n_steps", type=int, default=0,
                   help="save the training state every N steps (and at the end)")
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest checkpoint in out_dir/ckpt")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; a run without a card needs --device cpu")
    return p.parse_args(argv)


class PlateauAdam:
    """optax.chain(adam(lr), reduce_on_plateau(factor, patience,
    accumulation_size)): Adam with optax's defaults (betas 0.9 / 0.999, eps
    1e-8), each step's update scaled by the plateau scale that the same
    step's loss gives (`training/optim.ReduceOnPlateau`)."""

    def __init__(self, params, learning_rate: float, factor: float, patience: int,
                 accumulation_size: int = 100):
        self.learning_rate = learning_rate
        self.adam = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        self.plateau = ReduceOnPlateau(factor, patience, accumulation_size)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self, loss: torch.Tensor) -> float:
        """Adam's update at learning rate x this step's plateau scale; returns
        the scale."""
        scale = self.plateau.update(loss)
        for group in self.adam.param_groups:
            group["lr"] = self.learning_rate * scale
        self.adam.step()
        return scale

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "plateau": self.plateau.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        device = self.adam.param_groups[0]["params"][0].device
        self.plateau.load_state_dict(state["plateau"], device=device)


@dataclasses.dataclass
class Fit2dState:
    params: nerf2d.Nerf2d
    optimizer: PlateauAdam
    step: int = 0


def train_step(state: Fit2dState, cfg: nerf2d.Nerf2dConfig, x: torch.Tensor,
               y: torch.Tensor):
    """One MSE step on the pixels (x, y): (loss, the plateau scale it took)."""
    state.optimizer.zero_grad()
    loss = torch.mean((nerf2d.apply(state.params, cfg, x) - y) ** 2)
    loss.backward()
    scale = state.optimizer.step(loss.detach())
    state.step += 1
    return loss.detach(), scale


def train(args):
    """(params, cfg, result {"val_loss", "val_psnr"[, "full_image_psnr"]})."""
    if args.image_path:
        data = single_image.load_path(args.image_path, pixel_shuffle_seed=args.seed)
    else:
        img = single_image.procedural_test_image(args.image_size, args.seed)
        data = single_image.load(img, pixel_shuffle_seed=args.seed)
    dev = torch.device(args.device)

    cfg = nerf2d.Nerf2dConfig(fourier_levels=args.fourier_levels, hidden_dim=args.hidden_dim,
                              learning_rate=args.learning_rate)
    params = nerf2d.init(torch.Generator().manual_seed(args.seed), cfg).to(dev)
    # the plateau checks once per ~epoch of steps (windows of 100), as the
    # reference's per-epoch ReduceLROnPlateau; per batch it would collapse the
    # LR within a few hundred steps
    state = Fit2dState(params, PlateauAdam(params.parameters(), args.learning_rate,
                                           args.lr_decay, args.lr_decay_patience))
    ckpt = None
    if args.checkpoint_every_n_steps or args.resume:
        ckpt = CheckpointManager(os.path.join(args.out_dir, "ckpt"))
        if args.resume and ckpt.latest_step() is not None:
            state = ckpt.restore(state)
            print(f"resumed from step {state.step}")

    coords, colors = (torch.as_tensor(a, device=dev) for a in data.splits["train"])
    val_coords, val_colors = (torch.as_tensor(a, device=dev) for a in data.splits["val"])

    def val_loss() -> float:
        with torch.no_grad():
            return float(torch.mean((nerf2d.apply(params, cfg, val_coords) - val_colors) ** 2))

    logger = MetricLogger(args.out_dir)
    gen = torch.Generator(device=dev)
    while state.step < args.steps:
        gen.manual_seed(mix_seed(args.seed + 1, state.step))
        idx = torch.randint(0, coords.shape[0], (args.batch_size,), generator=gen, device=dev)
        loss, _ = train_step(state, cfg, coords[idx], colors[idx])
        if state.step % 200 == 0:
            vl = val_loss()
            logger.log({"train_loss": float(loss), "val_loss": vl,
                        "val_psnr": float(psnr(torch.tensor(vl)))}, state.step)
        if ckpt is not None and (state.step == args.steps or (
                args.checkpoint_every_n_steps
                and state.step % args.checkpoint_every_n_steps == 0)):
            ckpt.save(state.step, state)

    final = val_loss()
    result = {"val_loss": final, "val_psnr": float(psnr(torch.tensor(final)))}
    if args.save_image:
        @torch.no_grad()
        def apply_fn(c):
            return nerf2d.apply(params, cfg, torch.as_tensor(c, device=dev)).cpu().numpy()

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
