"""The plain reference of the BARF cells: the step and the render in plain
PyTorch, written from the published method, and importing nothing of the
program under test. It is the family of `run_barf`'s configurations, with
the interface `reference/__init__.py` lists.

What it computes (BARF, Lin et al. 2021, https://arxiv.org/abs/2104.06405,
as the reference repository `sarphiv/nerf-experiments` trains it in
`barf/run_barf.py`):

* camera: each training image's learnable so(3) rotation and translation,
  zero at the start; a ray's origin is moved by the translation and its
  direction turned by exp(hat(rotation)) (Rodrigues, with the Taylor series
  below theta^2 = 1e-8);
* sampling: `samples` equidistant bins over [near, far], the whole comb of
  a ray shifted by u * interval * offset with one uniform u a ray (offset -1
  in training, 0 in serving); the last bin ends at far;
* encoding: x, then mask * cos(x_c 2^j) and mask * sin(x_c 2^j), channel by
  channel (scale 1), the mask the coarse-to-fine cosine edge at alpha;
* the NeRF MLP: `n_segments` segments of `n_hidden` + 1 layers with the
  encoded position re-entering each segment, ReLU between layers and between
  segments, density from the last segment's extra output through
  softplus(threshold 8), colour from a head of width hidden / 2 on the
  features and the encoded direction, through a sigmoid;
* compositing: alpha = 1 - exp(-sigma delta), transmittance the exclusive
  cumulative product, rgb the weighted sum;
* with a proposal net: its composited rgb gives the coarse loss, and its
  weights (held constant) give the fine bins by inverse-CDF placement at
  evenly spaced quantiles;
* loss: mean squared error of the fine rgb (plus the coarse one) against the
  sharp target colour;
* Adam (beta 0.9 / 0.999, eps 1e-5, bias-corrected, eps after the square
  root) with each group's learning rate decayed exponentially from start to
  stop over `lr_decay_end` updates, read at the count of updates before the
  step.

Products run in float32 with TF32 off (`precision="fp32"`), or, for the
control, with their operands rounded to TF32 (`"tf32"`) or to float8 e4m3
with a scale a tensor (`"fp8"`), in the forward and in both backward
products.
"""
from __future__ import annotations

import copy
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench_torch.reference.common import (adam_steps, camera_rays, composite, le_nice,
                                          pdf_bins, set_flags, softplus8, uniform_leaves)

ENTRIES = ("run_barf",)  # entries with run_barf's flags, `build` and trainer
SERVED_THROUGH = "render_views"  # the program serves their views so (`kinds/serve.py`)
CONTROLS = ("tf32", "fp8")
# what a check step records of its batch; the step's own draw is the comb's
# uniform (`step_draws`)
BATCH_KEYS = ("origs_noisy", "dirs_noisy", "colors", "img_idx")
ADAM_B1, ADAM_B2 = 0.9, 0.999
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


# --- precision of the products ------------------------------------------------

def quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x with its values rounded as `precision` stores a product's operand."""
    if precision == "fp32":
        return x
    if precision == "tf32":  # 10 mantissa bits, rounded to nearest
        bits = x.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    if precision == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


class _RoundedMatmul(torch.autograd.Function):
    """x @ w with every product's operands rounded to `precision`."""

    @staticmethod
    def forward(ctx, x, w, precision):
        xq, wq = quantize(x, precision), quantize(w, precision)
        ctx.save_for_backward(xq, wq)
        ctx.precision = precision
        return xq @ wq

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = quantize(gy, ctx.precision)
        return gq @ wq.t(), xq.t() @ gq, None


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x @ w
    return _RoundedMatmul.apply(x, w, precision)


# --- parameters ---------------------------------------------------------------

def mlp_layers(model: dict, hidden: int, n_hidden: int, n_segments: int) -> List[Tuple[str, int, int]]:
    """(name, in, out) of every affine layer of one NeRF MLP."""
    pos = 3 + 6 * model["levels_pos"]
    direc = 3 + 6 * model["levels_dir"]
    layers = []
    for s in range(n_segments):
        d_in = pos + (hidden if s > 0 else 0)
        d_out = hidden + int(s == n_segments - 1)
        dims = [d_in] + [hidden] * n_hidden + [d_out]
        for j in range(len(dims) - 1):
            layers.append((f"segments.{s}.layers.{j}", dims[j], dims[j + 1]))
    layers.append(("color.0", hidden + direc, hidden // 2))
    layers.append(("color.1", hidden // 2, 3))
    return layers


def nets(model: dict) -> Dict[str, Tuple[int, int, int]]:
    """net name -> (hidden, n_hidden, n_segments)."""
    out = {"radiance": (model["hidden_dim"], model["n_hidden"], model["n_segments"])}
    if model.get("proposal"):
        p = model["proposal"]
        out["proposal"] = (p["hidden_dim"], p["n_hidden"], 1)
    return out


def param_shapes(model: dict, n_images: int) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every leaf's name and shape, under the names of the parameters of a
    BARF system (`radiance.…`, `proposal.…`, `camera.rotation`,
    `camera.translation`)."""
    shapes = OrderedDict()
    for net, dims in nets(model).items():
        for name, d_in, d_out in mlp_layers(model, *dims):
            shapes[f"{net}.{name}.w"] = (d_in, d_out)
            shapes[f"{net}.{name}.b"] = (d_out,)
    shapes["camera.rotation"] = (n_images, 3)
    shapes["camera.translation"] = (n_images, 3)
    return shapes


def macs_per_sample(model: dict) -> Dict[str, int]:
    """Multiply-adds of one sample through each net's affine layers."""
    return {net: sum(i * o for _, i, o in mlp_layers(model, *dims))
            for net, dims in nets(model).items()}


def macs_per_ray(model: dict) -> int:
    """Multiply-adds of one ray: each net's a sample times its samples."""
    macs = macs_per_sample(model)
    total = macs["radiance"] * model["samples"]
    if "proposal" in macs:
        total += macs["proposal"] * model["proposal"]["samples"]
    return total


def draw_weights(shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from the seed, on the device in one draw: an affine
    layer's weight and bias uniform in +-1/sqrt(fan-in) (torch's
    nn.Linear), the camera's rotation and translation zero (BARF's start)."""
    u = uniform_leaves(shapes, seed, device, lambda n: not n.startswith("camera."))
    out = {}
    for name, shape in shapes.items():
        if name.startswith("camera."):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = u[name] / math.sqrt(shapes[name[:-1] + "w"][0])
    return out


# --- the model ----------------------------------------------------------------

def encode(x: torch.Tensor, levels: int, alpha: float) -> torch.Tensor:
    """[x, mask cos(x 2^j), mask sin(x 2^j)] in channel-major order."""
    freq = 2.0 ** torch.arange(levels, dtype=x.dtype, device=x.device)
    args = (x[..., None] * freq).reshape(*x.shape[:-1], -1)
    k = torch.arange(levels, dtype=x.dtype, device=x.device)
    ramp = torch.clamp(torch.as_tensor(alpha, dtype=x.dtype, device=x.device) - k, 0.0, 1.0)
    mask = ((1.0 - torch.cos(ramp * math.pi)) / 2.0).repeat(x.shape[-1])
    return torch.cat([x, mask * torch.cos(args), mask * torch.sin(args)], dim=-1)


def mlp_apply(p: Dict[str, torch.Tensor], net: str, dims, model: dict, pos, direc,
              alpha_pos, alpha_dir, precision: str):
    """(density (M,), rgb (M, 3)) of net `net` at points pos (M, 3) seen along
    direc (M, 3)."""
    hidden, n_hidden, n_segments = dims
    pe = encode(pos, model["levels_pos"], alpha_pos)
    de = encode(direc, model["levels_dir"], alpha_dir)

    def dense(name, x):
        return matmul(x, p[f"{net}.{name}.w"], precision) + p[f"{net}.{name}.b"]

    z = pe[:, :0]
    for s in range(n_segments):
        h = torch.cat([z, pe], dim=-1)
        for j in range(n_hidden + 1):
            h = dense(f"segments.{s}.layers.{j}", h)
            if j < n_hidden:
                h = torch.relu(h)
        z = torch.relu(h) if s < n_segments - 1 else h
    head = torch.relu(dense("color.0", torch.cat([z[:, :hidden], de], dim=-1)))
    rgb = torch.sigmoid(dense("color.1", head))
    return softplus8(z[:, hidden]), rgb


def bins(n_rays: int, n_samples: int, near: float, far: float, u: Optional[torch.Tensor],
         offset: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equidistant bins, the comb shifted by u * interval * offset."""
    interval = (far - near) / n_samples
    t = torch.linspace(near, far - interval, n_samples, device=device).expand(n_rays, n_samples)
    if offset != 0.0:
        t = t + u * interval * offset
    return t, torch.cat([t[:, 1:], torch.full_like(t[:, :1], far)], dim=1)


def render_rays(p, model: dict, origs, dirs, u, offset: float, alpha_pos, alpha_dir,
                precision: str):
    """(rgb_fine (N, 3), rgb_coarse (N, 3) or None) of rays (N, 3)."""
    n, dev = origs.shape[0], origs.device
    near, far = model["near"], model["far"]
    dims = nets(model)

    def field(net, t_start, t_end):
        t_mid = (t_start + t_end) / 2.0
        pts = origs[:, None, :] + t_mid[..., None] * dirs[:, None, :]
        s = t_start.shape[1]
        dens, rgb = mlp_apply(p, net, dims[net], model, pts.reshape(-1, 3),
                              dirs[:, None, :].expand(n, s, 3).reshape(-1, 3),
                              alpha_pos, alpha_dir, precision)
        return composite(dens.reshape(n, s), rgb.reshape(n, s, 3), t_start, t_end)

    rgb_coarse = None
    if "proposal" in dims:
        tc0, tc1 = bins(n, model["proposal"]["samples"], near, far, u, offset, dev)
        rgb_coarse, w = field("proposal", tc0, tc1)
        t0, t1 = pdf_bins(tc0, tc1, w.detach(), model["samples"], far)
    else:
        t0, t1 = bins(n, model["samples"], near, far, u, offset, dev)
    return field("radiance", t0, t1)[0], rgb_coarse


# --- training -----------------------------------------------------------------

def lr_of(name: str, model: dict, count: int) -> float:
    o = model["optim"]
    if name.startswith("camera."):
        return le_nice(o["camera_lr"], o["camera_lr_stop"], o["lr_decay_end"], count)
    return le_nice(o["lr"], o["lr"] / 50.0, o["lr_decay_end"], count)


def step_draws(model: dict, batch: dict, generator: torch.Generator) -> dict:
    """What the step draws from its generator, from a generator at the
    step's starting state: the comb's uniform, first, one a ray."""
    n = batch["img_idx"].shape[0]
    return {"u": torch.rand((n, 1), generator=generator, device=generator.device)}


def train_loss(p, model: dict, batch: dict, alpha_pos, alpha_dir, precision: str):
    """The step's objective on one batch: origs_noisy, dirs_noisy (B, 3),
    img_idx (B,), colors (B, n_sigmas, 3) (the sharp colour last: no blur),
    u (B, 1) the comb's uniform."""
    origs, dirs = camera_rays(p, batch)
    target = batch["colors"][:, -1]
    rgb, rgb_coarse = render_rays(p, model, origs, dirs, batch["u"], model["offset"],
                                  alpha_pos, alpha_dir, precision)
    loss = torch.mean((rgb - target) ** 2)
    if rgb_coarse is not None:
        loss = loss + torch.mean((rgb_coarse - target) ** 2)
    return loss


def train_steps(weights: Dict[str, torch.Tensor], model: dict, batches: Sequence[dict],
                start_count: int, precision: str = "fp32") -> dict:
    """Run len(batches) Adam steps from `weights`, starting at update count
    `start_count`. Returns the readings the comparison takes: each step's
    loss, every leaf's first gradient and every leaf's change after the last
    step."""
    alpha_pos, alpha_dir = float(model["levels_pos"]), float(model["levels_dir"])
    return adam_steps(
        weights, lambda p, batch: train_loss(p, model, batch, alpha_pos, alpha_dir, precision),
        batches, lambda name, count: lr_of(name, model, count), start_count, ADAM_B1, ADAM_B2,
        model["optim"]["adam_eps"])


# --- serving ------------------------------------------------------------------

@torch.no_grad()
def render_view(weights: Dict[str, torch.Tensor], model: dict, origs: torch.Tensor,
                dirs: torch.Tensor, gauge: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                chunk: int = 8192, precision: str = "fp32") -> torch.Tensor:
    """The clipped rgb (HW, 3) of one view's rays (HW, 3) in the ground-truth
    frame, moved into the model's by the similarity gauge = (R, t, c):
    o -> c R o + t, d -> R d; every level of both encodings on."""
    R, t, c = gauge
    out = []
    for lo in range(0, origs.shape[0], chunk):
        o = (origs[lo:lo + chunk] @ R.T) * c + t
        d = dirs[lo:lo + chunk] @ R.T
        rgb, _ = render_rays(weights, model, o, d, None, 0.0, float(model["levels_pos"]),
                             float(model["levels_dir"]), precision)
        out.append(torch.clamp(rgb, 0.0, 1.0))
    return torch.cat(out)


# --- the configuration --------------------------------------------------------

def check_flags(args, config: dict) -> None:
    """Raise ValueError where the entry's parsed flags and the sizes the
    reference reads are not one configuration."""
    m, o = config["model"], config["model"]["optim"]
    pairs = [("hidden_dim", args.hidden_dim, m["hidden_dim"]),
             ("n_hidden", args.n_hidden, m["n_hidden"]),
             ("n_segments", args.n_segments, m["n_segments"]),
             ("levels_pos", args.fourier_levels_pos, m["levels_pos"]),
             ("levels_dir", args.fourier_levels_dir, m["levels_dir"]),
             ("samples", args.samples_per_ray, m["samples"]),
             ("image_size", args.image_size, config["scene"]["image_size"]),
             ("bf16", args.bf16, config["precision"] == "bf16"),
             ("fused_kernel", args.fused_kernel, True),
             ("lr", args.learning_rate, o["lr"]),
             ("lr_decay_end", args.lr_decay_end_step, o["lr_decay_end"]),
             ("camera_lr", args.camera_lr, o["camera_lr"]),
             ("camera_lr_stop", args.camera_lr_stop, o["camera_lr_stop"])]
    if "proposal" in m:
        p = m["proposal"]
        pairs += [("proposal.hidden_dim", args.proposal_hidden_dim, p["hidden_dim"]),
                  ("proposal.n_hidden", args.proposal_n_hidden, p["n_hidden"]),
                  ("proposal.samples", args.samples_per_ray_proposal, p["samples"])]
    else:
        pairs.append(("proposal.samples", args.samples_per_ray_proposal, 0))
    bad = [(what, flag, ref) for what, flag, ref in pairs if flag != ref]
    if bad:
        raise ValueError(f"flags against the reference's sizes (what, flag, reference): {bad}")


def small(config: dict) -> dict:
    """The configuration cut to a size the CPU runs in seconds, for the
    harness's tests: the same widths, a 16x16 scene of 4 training views, 64
    rays a step, 8 fine samples (16 proposal bins)."""
    config = copy.deepcopy(config)
    config["scene"].update({"image_size": 16, "train_views": 4, "val_views": 1,
                            "test_views": 4})
    flags = {"--image_size": 16, "--batch_size": 64, "--samples_per_ray": 8}
    config["model"]["samples"] = 8
    if "proposal" in config["model"]:
        flags["--samples_per_ray_proposal"] = 16
        config["model"]["proposal"]["samples"] = 16
    config["flags"] = set_flags(config["flags"], flags)
    return config
