"""What the reference families share: the seeds of the run's uses, the
weights' uniform draw, TF32 off, the camera's so(3) exponential and the ray
transform it drives, the density's softplus, compositing, inverse-CDF fine
bins, the LeNice decay and the Adam loop over a family's loss. Plain
PyTorch, importing nothing of the program under test, and no family of its
own (it has no `ENTRIES`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

_TAYLOR_EPS = 1e-8
_PDF_EPS = 1e-8


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    x ^= x >> 31
    return x & (2**63 - 1)


def uniform_leaves(shapes, seed: int, device, drawn: Callable[[str], bool]):
    """{leaf: values uniform in [-1, 1)} for every leaf of `shapes` that
    `drawn` names, on the device in one draw from the seed, in the order of
    `shapes`; the family scales each to its own range."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    names = [n for n in shapes if drawn(n)]
    total = sum(math.prod(shapes[n]) for n in names)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name in names:
        n = math.prod(shapes[name])
        out[name] = u[off:off + n].view(shapes[name])
        off += n
    return out


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the block's float32 products, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# --- the camera -----------------------------------------------------------------

def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) rotation matrices (Rodrigues)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    W = torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                     torch.stack([-wy, wx, z], -1)], -2)
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    t2s = torch.clamp(t2, min=_TAYLOR_EPS)
    t = torch.sqrt(t2s)
    a = torch.where(t2 < _TAYLOR_EPS, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(t) / t)
    b = torch.where(t2 < _TAYLOR_EPS, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(t)) / t2s)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * (W @ W)


def camera_rays(p: Dict[str, torch.Tensor], batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """A training batch's rays moved by their image's camera: the origin by
    the translation, the direction turned by exp(hat(rotation))."""
    idx = batch["img_idx"]
    origs = batch["origs_noisy"] + p["camera.translation"][idx]
    dirs = torch.einsum("bij,bj->bi", so3_exp(p["camera.rotation"])[idx], batch["dirs_noisy"])
    return origs, dirs


# --- the fields and volume rendering ---------------------------------------------

def softplus8(x: torch.Tensor) -> torch.Tensor:
    """Softplus, linear above 8 (torch's threshold 8)."""
    return torch.where(x > 8.0, x, torch.nn.functional.softplus(torch.clamp(x, max=8.0)))


def composite(density, rgb, t_start, t_end):
    """(rgb (N, 3), weights (N, S)) of samples (N, S) and (N, S, 3)."""
    b = -density * (t_end - t_start)
    trans = torch.exp(torch.cat([torch.zeros_like(b[:, :1]), torch.cumsum(b, dim=-1)[:, :-1]],
                                dim=-1))
    w = trans * (1.0 - torch.exp(b))
    return torch.sum(w[..., None] * rgb, dim=-2), w


def pdf_bins(t_start, t_end, weights, n_samples: int, far: float):
    """Fine bins placed by the inverse CDF of the coarse weights at quantiles
    (i + 1/2) / n."""
    edges = torch.cat([t_start, t_end[:, -1:]], dim=1)
    w = weights + _PDF_EPS
    cdf = torch.cat([torch.zeros_like(w[:, :1]),
                     torch.cumsum(w / torch.sum(w, dim=-1, keepdim=True), dim=-1)], dim=-1)
    u = ((torch.arange(n_samples, dtype=w.dtype, device=w.device) + 0.5) / n_samples)
    u = u.expand(w.shape[0], n_samples).contiguous()
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, w.shape[1] - 1)
    d_cdf = cdf[:, 1:] - cdf[:, :-1]
    k = (edges[:, 1:] - edges[:, :-1]) / torch.where(d_cdf < _PDF_EPS, torch.ones_like(d_cdf),
                                                     d_cdf)
    base = edges[:, :-1] - cdf[:, :-1] * k
    t = torch.gather(base, 1, idx) + u * torch.gather(k, 1, idx)
    return t, torch.cat([t[:, 1:], torch.full_like(t[:, :1], far)], dim=1)


# --- training -------------------------------------------------------------------

def set_flags(flags: Sequence[str], values: Dict[str, object]) -> List[str]:
    """The entry's flags with each of `values` set, in place where the flag
    is given, else appended."""
    flags = list(flags)
    for name, value in values.items():
        if name in flags:
            flags[flags.index(name) + 1] = str(value)
        else:
            flags += [name, str(value)]
    return flags



def le_nice(start: float, stop: float, n: int, count: int) -> float:
    """start decayed exponentially to stop over n updates, read at `count`."""
    if n <= 0 or start == 0:
        return start
    return start * math.exp((math.log(stop) - math.log(start)) / n * min(float(count), n))


def adam_steps(weights: Dict[str, torch.Tensor], loss_of: Callable, batches: Sequence[dict],
               lr_of: Callable[[str, int], float], start_count: int, b1: float, b2: float,
               eps: float, weight_decay: Callable[[str], float] = lambda name: 0.0) -> dict:
    """len(batches) Adam steps (bias-corrected, eps after the square root;
    a leaf's weight decay decoupled, as AdamW) of `loss_of(params, batch)`
    from `weights`, the learning rate `lr_of(leaf, count)` read at the count
    of updates before each step, from `start_count`. Returns each step's
    loss, every leaf's first gradient and every leaf's change after the last
    step."""
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    first_grad = None
    for i, batch in enumerate(batches):
        loss = loss_of(p, batch)
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        grads = {k: (g if g is not None else torch.zeros_like(p[k]))
                 for k, g in zip(p, grads)}
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        t = i + 1
        with torch.no_grad():
            for k, g in grads.items():
                lr = lr_of(k, start_count + i)
                if weight_decay(k):
                    p[k].mul_(1.0 - lr * weight_decay(k))
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    change = {k: (p[k].detach() - weights[k].float()) for k in p}
    return {"losses": losses, "grad": first_grad, "change": change}
