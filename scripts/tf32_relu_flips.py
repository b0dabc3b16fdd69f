"""How far 3xTF32 forward products move the flagship train step's fp32
gradients, on the CPU: the plain version (`flagship_train_grads_reference`)
with every layer's forward value computed from TF32 hi / lo splits (x W ~
lo hi' + hi lo' + hi hi', the products the tensor-core route would take) and
the backward in exact fp32, against the same plain version in fp32.
`--products fp32` takes instead every forward value x W + b computed in
float64 and rounded once to fp32 (the most exact an fp32 route can be): the
yardstick of how much any other rounding of the same products moves the
gradients in this configuration.

    python scripts/tf32_relu_flips.py [--rays 200] [--samples 128] [--products 3xtf32|fp32]

The forward values move by ~2^-21 relative; a unit whose pre-activation is
that close to 0 flips its ReLU, and the gradients of the layers below it
move by the whole contribution of that unit. Prints the relative norm of the
difference of rgb, d_origs, d_dirs and every dW / db (the flagship width:
BARF 10 / 4 levels, 4 x 256 in 2 segments; random weights and rays from
fixed seeds; TF32 rounding to nearest as `cvt.rna`).
"""
from __future__ import annotations

import argparse
from unittest import mock

import torch

from nerf_experiments_tpu_torch.encodings.fourier import Barf
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.ops import sampling
from nerf_experiments_tpu_torch.ops import train_megakernel as tm


def tf32x3_forward(layer, x, compute_dtype=None):
    """x W + b whose value is 3xTF32's and whose gradient is exact fp32's."""
    xd, wd = x.detach(), layer.w.detach()
    xh, wh = tm.tf32_round(xd), tm.tf32_round(wd)
    xl, wl = tm.tf32_round(xd - xh), tm.tf32_round(wd - wh)
    exact = x @ layer.w + layer.b
    return exact + ((xl @ wh + xh @ wl) + xh @ wh + layer.b - exact).detach()


def fp32_rounded_forward(layer, x, compute_dtype=None):
    """x W + b computed in float64 and rounded once to fp32, with exact fp32's
    gradient."""
    exact = x @ layer.w + layer.b
    value = (x.detach().double() @ layer.w.detach().double() + layer.b.detach().double()).float()
    return exact + (value - exact).detach()


FORWARDS = {"3xtf32": tf32x3_forward, "fp32": fp32_rounded_forward}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rays", type=int, default=200)
    p.add_argument("--samples", type=int, default=128)
    p.add_argument("--products", choices=sorted(FORWARDS), default="3xtf32")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = nerf_mlp.NerfMLPConfig(
        position_encoder=Barf(levels=10, scale=1.0, include_identity=True),
        direction_encoder=Barf(levels=4, scale=1.0, include_identity=True),
        n_hidden=4, hidden_dim=256, n_segments=2)
    params = nerf_mlp.init(torch.Generator().manual_seed(3), cfg)
    gen = torch.Generator().manual_seed(2)
    o = torch.randn((args.rays, 3), generator=gen)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = 0.5 * torch.randn((args.rays, 3), generator=gen) - o
    d = d / d.norm(dim=-1, keepdim=True)
    targets = torch.rand((args.rays, 3), generator=gen)
    ts, te = sampling.sample_stratified(None, args.rays, args.samples, 2.0, 8.0, "equidistant")
    call = (params, cfg, o, d, ts, te, targets, 7.5, 2.5)
    ref = tm.flagship_train_grads_reference(*call)
    with mock.patch.object(nerf_mlp, "linear_apply", FORWARDS[args.products]):
        got = tm.flagship_train_grads_reference(*call)
    print(f"{args.rays} rays x {args.samples} samples, {args.products} forward products vs "
          f"fp32, rel norm:")
    print(f"  rgb {rel(got[0], ref[0]):.3e}  d_origs {rel(got[2], ref[2]):.3e}  "
          f"d_dirs {rel(got[3], ref[3]):.3e}")
    for name, g in got[1].items():
        print(f"  {name} {rel(g, ref[1][name]):.3e}")


if __name__ == "__main__":
    main()
