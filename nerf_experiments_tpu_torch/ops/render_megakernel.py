"""Forward-only render of the flagship BARF radiance field on equidistant bins
shifted by a per-ray offset: the counterpart of the JAX package's
`ops/render_megakernel.py`, whose `flagship_render` runs the TPU kernel
`_mega_kernel` (K11).

K11 computes the function of the flagship render kernel (K2) on bins that
its wrapper builds: `t_start = near + (far - near) / S * s + offset` and
`t_end` the next bin's start, `far` for the last. So the port builds the bins
here, as the JAX wrapper does outside its kernel, and launches K2's kernel
(`csrc/flagship_render.cu`, `netpu_flagship_render`) as a second entry,
counting its own launches. A CPU tensor goes to the plain version
`render_megakernel_reference`; a CUDA tensor goes to the kernel, or the call
raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.ops import cuda_build
from nerf_experiments_tpu_torch.ops.render import DENSITY_SCALE
from nerf_experiments_tpu_torch.ops.sampling import intervals_from_t
from nerf_experiments_tpu_torch.ops.train_megakernel import (
    flagship_render_reference, is_flagship, launch_render_kernel)


def equidistant_bins(offsets: torch.Tensor, n_samples: int, near: float, far: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_start, t_end) (N, S): S equal bins over [near, far], each ray's
    shifted by its offset (N, 1); the last bin ends at far."""
    interval = (float(far) - float(near)) / n_samples
    s_idx = torch.arange(n_samples, dtype=torch.float32, device=offsets.device)[None, :]
    return intervals_from_t(float(near) + interval * s_idx + offsets, float(far))


def render_megakernel_reference(params: nerf_mlp.NerfMLP, cfg: nerf_mlp.NerfMLPConfig,
                                origs, dirs, offsets, alpha_pos, alpha_dir, n_samples: int,
                                near: float, far: float,
                                density_scale: float = DENSITY_SCALE) -> torch.Tensor:
    """Plain version: the same bins through `flagship_render_reference`."""
    t_start, t_end = equidistant_bins(offsets, n_samples, near, far)
    rgb, _, _ = flagship_render_reference(params, cfg, origs, dirs, t_start, t_end,
                                          float(alpha_pos), float(alpha_dir), density_scale)
    return rgb


def flagship_render(params: nerf_mlp.NerfMLP, cfg: nerf_mlp.NerfMLPConfig,
                    origs: torch.Tensor, dirs: torch.Tensor, offsets: torch.Tensor,
                    alpha_pos, alpha_dir, n_samples: int, near: float, far: float,
                    density_scale: float = DENSITY_SCALE) -> torch.Tensor:
    """rgb (N, 3) of the flagship BARF architecture for rays origs, dirs (N,
    3) and per-ray offsets (N, 1) (0 for deterministic bins). Requires Barf
    encoders with identity and one scale, 2 segments, delayed direction and
    immediate density (raises ValueError otherwise). No gradient."""
    if not is_flagship(cfg):
        raise ValueError("flagship_render supports the canonical BARF config only")
    if origs.device.type != "cuda":
        return render_megakernel_reference(params, cfg, origs, dirs, offsets, alpha_pos,
                                           alpha_dir, n_samples, near, far, density_scale)
    cuda_build.library()  # a failed build raises before the bins are made
    t_start, t_end = equidistant_bins(offsets, n_samples, near, far)
    rgb, _, _ = launch_render_kernel(params, cfg, origs, dirs, t_start, t_end,
                                     float(alpha_pos), float(alpha_dir), density_scale)
    flagship_render.launches += 1
    return rgb


flagship_render.launches = 0
