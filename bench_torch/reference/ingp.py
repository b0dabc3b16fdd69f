"""The plain reference of Instant-NGP's NeRF as `run_3d_ingp` trains it: the
training step in plain PyTorch, float32 with TF32 off, importing nothing of
the program under test. It is the family of `run_3d_ingp`'s configurations,
with the interface `reference/__init__.py` lists; it has no served view.

What it computes (Instant-NGP, Mueller et al. 2022, arXiv 2201.05989, as
`sarphiv/nerf-experiments` writes it in `3d-ingp/model.py`, NaiveINGP):

* camera: as BARF's (`common.camera_rays`), each image's so(3) rotation and
  translation, zero at the start; the entry trains them at learning rate 0;
* sampling: `samples_coarse` stratified bins over [near, far], one uniform
  a bin from the step's generator (the step's only draw); the coarse net's
  weights (held constant) place `samples_fine` fine bins by inverse-CDF at
  evenly spaced quantiles; each bin is queried at its middle;
* a net (coarse and fine have their own): positions x / pos_scale + 0.5,
  clamped to [0, 1 - 1e-6]; `n_levels` levels at resolutions
  floor(r_min b^l), b = exp((ln r_max - ln r_min) / (L - 1)), each a table
  of `table_size` rows of `n_features`; a level whose (res + 1)^3 vertices
  fit the table indexes them densely (x + y (res + 1) + z (res + 1)^2),
  the others by the xor hash of the corner times the primes (1,
  2654435761, 805459861) in 32 bits, modulo the table's size; a level's
  features are the eight corners' rows weighted trilinearly by
  prod(1 - |x res - corner|), with d|u|/du = +1 at u = 0; then a ReLU MLP
  of `n_hidden` layers of `hidden_dim` to hidden + 1 outputs, density
  softplus(threshold 8) of the last output minus 1; colour from a head of
  width hidden / 2 on the other outputs and the direction's Fourier
  encoding (cos and sin of d 2^j, j < `levels_dir`, channel by channel),
  through a sigmoid;
* compositing: alpha = 1 - exp(-sigma delta), transmittance the exclusive
  cumulative product, rgb the weighted sum;
* loss: mean squared error of the fine rgb plus the coarse one against the
  target colour;
* Adam (betas 0.9 / 0.99, eps 1e-15, bias-corrected, eps after the square
  root; the nets' weight decay decoupled), each net's learning rate decayed
  exponentially from `lr` to `lr_stop` over `lr_decay_end` updates, read at
  the count of updates before the step.

Departures from the paper, which are the entry's: NaiveINGP's heads, a
density MLP of `n_hidden` hidden layers of 64 whose 65 outputs give the
density and 64 features for one colour layer of 32 on a 4-level Fourier
encoding of the direction, in place of the paper's density MLP of one
hidden layer of 64 and colour MLP of two on spherical harmonics of degree
4; the density softplus(z - 1) in place of exp; a coarse hash NeRF whose
weights place the fine samples in place of the paper's occupancy-grid ray
marching.

Products run in float32 with TF32 off (`precision="fp32"`), or, for the
control, `"bf16"` as the entry's `--bf16` runs: every gathered table row
rounded to bfloat16 (its gradient passed through in float32), every affine
layer's operands and output rounded to bfloat16.
"""
from __future__ import annotations

import copy
import math
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import torch

from bench_torch.reference.common import (adam_steps, camera_rays, composite, le_nice,
                                          pdf_bins, set_flags, softplus8, uniform_leaves)

ENTRIES = ("run_3d_ingp",)
CONTROLS = ("bf16",)
# what a check step records of its batch; the step's own draw is the coarse
# bins' uniforms (`step_draws`)
BATCH_KEYS = ("origs_noisy", "dirs_noisy", "colors", "img_idx")
PRIMES = (1, 2654435761, 805459861)
NETS = ("radiance", "proposal")  # the fine net and the coarse net, as the program names them
TABLE_INIT = 1e-4  # the tables start uniform in +-1e-4
_U32 = 0xFFFF_FFFF


# --- parameters ---------------------------------------------------------------

def mlp_layers(model: dict) -> List[Tuple[str, int, int]]:
    """(name, in, out) of every affine layer of one net."""
    hidden, levels = model["hidden_dim"], model["n_levels"]
    dims = [levels * model["n_features"]] + [hidden] * model["n_hidden"] + [hidden + 1]
    layers = [(f"density.{i}", a, b) for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]
    layers.append(("color.0", hidden + 6 * model["levels_dir"], hidden // 2))
    layers.append(("color.1", hidden // 2, 3))
    return layers


def param_shapes(model: dict, n_images: int) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every leaf's name and shape, under the names of the parameters of the
    program's system (`radiance.grid.table`, `radiance.density.<i>.w`, ...,
    `proposal.…`, `camera.rotation`, `camera.translation`)."""
    shapes = OrderedDict()
    for net in NETS:
        shapes[f"{net}.grid.table"] = (model["n_levels"], model["table_size"],
                                       model["n_features"])
        for name, d_in, d_out in mlp_layers(model):
            shapes[f"{net}.{name}.w"] = (d_in, d_out)
            shapes[f"{net}.{name}.b"] = (d_out,)
    shapes["camera.rotation"] = (n_images, 3)
    shapes["camera.translation"] = (n_images, 3)
    return shapes


def macs_per_ray(model: dict) -> int:
    """Multiply-adds of one ray through the nets' affine layers (the tables'
    weighting is no product of weights): a sample's times the coarse and
    fine samples."""
    per_sample = sum(i * o for _, i, o in mlp_layers(model))
    return per_sample * (model["samples_coarse"] + model["samples_fine"])


def draw_weights(shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from the seed, on the device in one draw: a table uniform
    in +-1e-4, an affine layer's weight and bias uniform in +-1/sqrt(fan-in)
    (torch's nn.Linear), the camera zero."""
    u = uniform_leaves(shapes, seed, device, lambda n: not n.startswith("camera."))
    out = {}
    for name, shape in shapes.items():
        if name.startswith("camera."):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith(".table"):
            out[name] = u[name] * TABLE_INIT
        else:
            out[name] = u[name] / math.sqrt(shapes[name[:-1] + "w"][0])
    return out


# --- the model ----------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def level_resolutions(model: dict) -> List[int]:
    lo, hi, n = model["resolution_min"], model["resolution_max"], model["n_levels"]
    if n == 1:
        return [lo]
    b = math.exp((math.log(hi) - math.log(lo)) / (n - 1))
    return [int(math.floor(lo * b ** level)) for level in range(n)]


def _rows(corner: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    """corner (..., 3) int64 -> the level's table rows (...)."""
    if (res + 1) ** 3 <= table_size:
        c = torch.clamp(corner, 0, res)
        return c[..., 0] + c[..., 1] * (res + 1) + c[..., 2] * (res + 1) ** 2
    h = (corner[..., 0] * PRIMES[0]) & _U32
    for i in (1, 2):
        h = h ^ ((corner[..., i] * PRIMES[i]) & _U32)
    return h % table_size


def hash_encode(table: torch.Tensor, x: torch.Tensor, model: dict,
                precision: str) -> torch.Tensor:
    """x (M, 3) in [0, 1)^3 -> (M, L F) level features, level-major."""
    corners = torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)],
                           device=x.device)
    feats = []
    for level, res in enumerate(level_resolutions(model)):
        xs = x * res
        corner = torch.floor(xs).long()[:, None, :] + corners  # (M, 8, 3)
        u = xs[:, None, :] - corner.to(x.dtype)
        fac = 1.0 - torch.where(u >= 0, u, -u)
        w = fac[..., 0] * fac[..., 1] * fac[..., 2]  # (M, 8)
        rows = table[level][_rows(corner, res, model["table_size"])]  # (M, 8, F)
        if precision == "bf16":
            rows = rows + (_bf16(rows) - rows).detach()
        feats.append(torch.sum(w[..., None] * rows, dim=1))
    return torch.cat(feats, dim=-1)


def dir_encode(d: torch.Tensor, levels: int) -> torch.Tensor:
    """[cos(d_c 2^j), sin(d_c 2^j)], channel-major."""
    freq = 2.0 ** torch.arange(levels, dtype=d.dtype, device=d.device)
    args = (d[..., None] * freq).reshape(*d.shape[:-1], -1)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _dense(p, name: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    w, b = p[f"{name}.w"], p[f"{name}.b"]
    if precision == "bf16":
        return _bf16(_bf16(x) @ _bf16(w) + b)
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w + b


def field(p, net: str, model: dict, pos: torch.Tensor, direc: torch.Tensor, precision: str):
    """(density (M,), rgb (M, 3)) of net `net` at points pos (M, 3) seen along
    direc (M, 3)."""
    x = torch.clamp(pos / model["pos_scale"] + 0.5, 0.0, 1.0 - 1e-6)
    h = hash_encode(p[f"{net}.grid.table"], x, model, precision)
    n_dense = model["n_hidden"] + 1
    for i in range(n_dense):
        h = _dense(p, f"{net}.density.{i}", h, precision)
        if i < n_dense - 1:
            h = torch.relu(h)
    hidden = model["hidden_dim"]
    c = torch.cat([h[:, :hidden], dir_encode(direc, model["levels_dir"])], dim=-1)
    c = torch.relu(_dense(p, f"{net}.color.0", c, precision))
    rgb = torch.sigmoid(_dense(p, f"{net}.color.1", c, precision))
    return softplus8(h[:, hidden] - 1.0), rgb


def render_rays(p, model: dict, origs, dirs, u, precision: str):
    """(rgb_fine (N, 3), rgb_coarse (N, 3)) of rays (N, 3), the coarse bins
    jittered by u (N, samples_coarse)."""
    n = origs.shape[0]
    near, far = model["near"], model["far"]

    def net_rgb(net, t_start, t_end):
        t_mid = (t_start + t_end) / 2.0
        pts = origs[:, None, :] + t_mid[..., None] * dirs[:, None, :]
        s = t_start.shape[1]
        dens, rgb = field(p, net, model, pts.reshape(-1, 3),
                          dirs[:, None, :].expand(n, s, 3).reshape(-1, 3), precision)
        return composite(dens.reshape(n, s), rgb.reshape(n, s, 3), t_start, t_end)

    s_c = model["samples_coarse"]
    interval = (far - near) / s_c
    t = torch.linspace(near, far - interval, s_c, device=origs.device).expand(n, s_c)
    tc0 = t + u * interval
    tc1 = torch.cat([tc0[:, 1:], torch.full_like(tc0[:, :1], far)], dim=1)
    rgb_coarse, w = net_rgb("proposal", tc0, tc1)
    t0, t1 = pdf_bins(tc0, tc1, w.detach(), model["samples_fine"], far)
    return net_rgb("radiance", t0, t1)[0], rgb_coarse


# --- training -----------------------------------------------------------------

def step_draws(model: dict, batch: dict, generator: torch.Generator) -> dict:
    """What the step draws from its generator, from a generator at the
    step's starting state: the coarse bins' uniforms, one a bin."""
    n = batch["img_idx"].shape[0]
    return {"u": torch.rand((n, model["samples_coarse"]), generator=generator,
                            device=generator.device)}


def lr_of(name: str, model: dict, count: int) -> float:
    if name.startswith("camera."):
        return 0.0
    o = model["optim"]
    return le_nice(o["lr"], o["lr_stop"], o["lr_decay_end"], count)


def train_loss(p, model: dict, batch: dict, precision: str):
    """The step's objective on one batch: origs_noisy, dirs_noisy (B, 3),
    img_idx (B,), colors (B, 1, 3), u (B, samples_coarse)."""
    origs, dirs = camera_rays(p, batch)
    target = batch["colors"][:, -1]
    rgb, rgb_coarse = render_rays(p, model, origs, dirs, batch["u"], precision)
    return torch.mean((rgb - target) ** 2) + torch.mean((rgb_coarse - target) ** 2)


def train_steps(weights: Dict[str, torch.Tensor], model: dict, batches: Sequence[dict],
                start_count: int, precision: str = "fp32") -> dict:
    """Run len(batches) Adam steps from `weights`, starting at update count
    `start_count`: each step's loss, every leaf's first gradient and every
    leaf's change after the last step."""
    o = model["optim"]
    return adam_steps(
        weights, lambda p, batch: train_loss(p, model, batch, precision), batches,
        lambda name, count: lr_of(name, model, count), start_count, o["adam_b1"], o["adam_b2"],
        o["adam_eps"], lambda name: 0.0 if name.startswith("camera.") else o["weight_decay"])


# --- the configuration --------------------------------------------------------

def check_flags(args, config: dict) -> None:
    """Raise ValueError where the entry's parsed flags and the sizes the
    reference reads are not one configuration."""
    m, o = config["model"], config["model"]["optim"]
    pairs = [(k, getattr(args, k), m[k]) for k in (
        "n_levels", "n_features", "table_size", "resolution_min", "resolution_max",
        "hidden_dim", "n_hidden", "near", "far")]
    pairs += [("samples_coarse", args.samples_per_ray_coarse, m["samples_coarse"]),
              ("samples_fine", args.samples_per_ray_fine, m["samples_fine"]),
              ("image_size", args.image_size, config["scene"]["image_size"]),
              ("bf16", args.bf16, config["precision"] == "bf16"),
              ("xor hash", args.encoder in ("fused", "matmul"), True),
              ("lr", args.learning_rate, o["lr"]),
              ("lr_stop", args.learning_rate / 10, o["lr_stop"]),
              ("weight_decay", args.weight_decay, o["weight_decay"])]
    bad = [(what, flag, ref) for what, flag, ref in pairs if flag != ref]
    if bad:
        raise ValueError(f"flags against the reference's sizes (what, flag, reference): {bad}")


SMALL = {"--image_size": 16, "--batch_size": 64, "--samples_per_ray_coarse": 8,
         "--samples_per_ray_fine": 16, "--n_levels": 6, "--table_size": 2**11,
         "--resolution_min": 4, "--resolution_max": 64}


def small(config: dict) -> dict:
    """The configuration cut to a size the CPU runs in seconds, for the
    harness's tests: the same widths, a 16x16 scene of 4 training views, 64
    rays a step, 8 coarse and 16 fine samples, 6 levels of 2^11 rows at
    resolutions 4 to 64 (levels 0-1 dense, 2-5 hashed)."""
    config = copy.deepcopy(config)
    config["scene"].update({"image_size": 16, "train_views": 4, "val_views": 1,
                            "test_views": 4})
    config["flags"] = set_flags(config["flags"], SMALL)
    model = config["model"]
    model.update(samples_coarse=8, samples_fine=16, n_levels=6, table_size=2**11,
                 resolution_min=4, resolution_max=64)
    return config
