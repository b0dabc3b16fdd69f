"""Occupancy-grid guided sampling: the analog of nerfacc's `OccGridEstimator`
(the reference's native dependency ships it beside the `PropNetEstimator`
that `barf/model_garf.py:222-233` uses).

Port of `nerf_experiments_tpu/ops/occgrid.py`. A flat (R^3,) density grid
over the cube [-h, h]^3 replaces the proposal net's coarse stage:
  1. K coarse bins a ray (stratified or equidistant, as the proposal path
     draws them) and the nearest cell's density at each bin's midpoint,
     gathered after a cast to `gather_dtype` (that rounding shapes the PDF);
  2. an occupancy alpha a bin, 1 - exp(-sigma dt), with no transmittance
     product (a grid cannot see occlusion, and compositing the uniform
     initial grid would pile every sample at the ray's entry);
  3. the S radiance bins by inverse-CDF resampling of (alpha + pdf_floor).
The grid is refreshed every `update_every` train steps from the radiance
net's density at jittered cell centres with the EMA-max rule occ <- max(decay
occ, sigma) (`update_grid`), which replaces nerfacc's CUDA update kernel.

No kernel here: the gather is plain indexing and the refresh a plain forward
of the radiance net, chunked only to bound its memory. Randomness comes from
explicit `torch.Generator`s; `sample_intervals` and `update_grid` also take
the uniforms themselves (`u=`), so that a test can hand them the JAX
package's draws (threefry and Philox never agree).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from nerf_experiments_tpu_torch.ops import sampling


@dataclasses.dataclass(frozen=True)
class OccGridConfig:
    resolution: int = 64          # cells per axis (R^3 in all)
    aabb_half: float = 2.0        # the grid covers the cube [-h, h]^3
    n_coarse: int = 64            # coarse lookup bins a ray
    update_every: int = 16        # refresh cadence in train steps
    decay: float = 0.95           # EMA-max decay at each refresh
    init_sigma: float = 1.0       # initial fill: any constant gives a uniform PDF
    pdf_floor: float = 0.01       # exploration floor added to every bin
    gather_dtype: str = "bfloat16"  # the grid is gathered at this dtype
    update_chunk: int = 2 ** 18   # refresh rows a density evaluation

    @property
    def n_cells(self) -> int:
        return self.resolution ** 3

    @property
    def cell(self) -> float:
        return 2.0 * self.aabb_half / self.resolution


def init_grid(cfg: OccGridConfig, device=None) -> torch.Tensor:
    """Flat (R^3,) fp32 grid at `init_sigma`: every bin's alpha equal, so
    sampling before the first refresh is uniform."""
    return torch.full((cfg.n_cells,), cfg.init_sigma, dtype=torch.float32, device=device)


def cell_index(cfg: OccGridConfig, pos: torch.Tensor) -> torch.Tensor:
    """Positions (..., 3) -> flat cell indices (...,) int64, clipped to the
    grid (points outside the cube fall on its border cells). The division
    is by a tensor: torch divides by a Python scalar as a product with its
    reciprocal, which can move a point on a cell boundary."""
    r = cfg.resolution
    cell = torch.tensor(cfg.cell, dtype=pos.dtype, device=pos.device)
    ijk = torch.clamp(torch.floor((pos + cfg.aabb_half) / cell).long(), 0, r - 1)
    return (ijk[..., 0] * r + ijk[..., 1]) * r + ijk[..., 2]


def lookup(grid: torch.Tensor, cfg: OccGridConfig, pos: torch.Tensor) -> torch.Tensor:
    """The nearest cell's density at positions (..., 3) -> (...,), in
    `gather_dtype` (the grid is cast before the gather, as in the JAX
    package)."""
    return grid.to(getattr(torch, cfg.gather_dtype))[cell_index(cfg, pos)]


def sample_intervals(
    grid: torch.Tensor,
    cfg: OccGridConfig,
    origs: torch.Tensor,
    dirs: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    strategy: str = "equidistant",
    u: Optional[torch.Tensor] = None,
    u_coarse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-guided radiance bins (t_start, t_end), each (N, n_samples), no
    gradient. Training (a generator, or the uniforms `u` (N, n_samples) of
    the resampling and, under "stratified_uniform", `u_coarse` (N, K) of the
    coarse bins): jittered quantiles, and coarse bins drawn by `strategy`.
    Serving (neither): equidistant coarse bins and midpoint quantiles."""
    origs, dirs = origs.detach(), dirs.detach()
    train = generator is not None or u is not None
    coarse_strategy = strategy if train else "equidistant"
    tc_start, tc_end = sampling.sample_stratified(
        generator, origs.shape[0], cfg.n_coarse, near, far, coarse_strategy, 0.0,
        device=origs.device, u=u_coarse)
    t_mid = 0.5 * (tc_start + tc_end)
    pos = origs[:, None, :] + t_mid[..., None] * dirs[:, None, :]
    sigma = lookup(grid, cfg, pos).float()
    # occupancy alpha a bin, deliberately not composited (module docstring)
    alpha = 1.0 - torch.exp(-sigma * (tc_end - tc_start))
    t_start, t_end = sampling.sample_pdf_weighted_intervals(
        tc_start, tc_end, alpha + cfg.pdf_floor, n_samples, far,
        generator=generator if train else None, u=u)
    return t_start.detach(), t_end.detach()


def update_grid(
    grid: torch.Tensor,
    cfg: OccGridConfig,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One refresh: max(decay grid, sigma(centre + jitter)), the jitter
    (u - 1/2) cell from the uniforms `u` (R^3, 3) or `generator`.
    `density_fn` maps positions (M, 3) to densities (M,); it is evaluated
    `update_chunk` rows at a time."""
    r, cell = cfg.resolution, cfg.cell
    ax = (torch.arange(r, dtype=torch.float32, device=grid.device) + 0.5) * cell - cfg.aabb_half
    centers = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(-1, 3)
    if u is None:
        u = torch.rand(centers.shape, generator=generator, device=grid.device)
    pts = centers + (u - 0.5) * cell
    sigma = torch.cat([density_fn(pts[i:i + cfg.update_chunk]).reshape(-1).float()
                       for i in range(0, pts.shape[0], cfg.update_chunk)])
    return torch.maximum(cfg.decay * grid, sigma)


def maybe_update(
    grid: torch.Tensor,
    cfg: OccGridConfig,
    step: int,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """`update_grid` every `update_every` steps (step 0 included), the grid
    as it is otherwise."""
    if step % cfg.update_every:
        return grid
    return update_grid(grid, cfg, density_fn, generator)
