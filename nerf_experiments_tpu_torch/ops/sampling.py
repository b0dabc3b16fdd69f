"""t-sampling along rays: stratified/equidistant init + inverse-CDF resampling.

Reference semantics:
  * `barf/model_interpolation.py:135-180` `_sample_t_stratified_uniform`:
    n equal bins over [near, far], one uniform sample per bin
    ("stratified_uniform") or the left edges ("equidistant"); optionally the
    whole comb shifted by a shared uniform offset in
    [0, interval * offset_size) (offset_size may be negative).
  * `:114-132` `_get_intervals`: t_start = t, t_end = next t (last = far).
  * `:193-277` `_sample_t_pdf_weighted`, replaced (as in the JAX package) by
    deterministic inverse-CDF sampling with evenly spaced quantiles and
    linear in-bin placement.

Randomness comes from an explicit `torch.Generator`, or from uniforms handed
in (`u=`: a test's way to give both packages the same draws). Every draw has
one row a ray and goes through `rand_rows`, so that a data-parallel rank's
`RowShard` of the step generator draws its rows of the global batch's draw.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The step generator as one of `world` data-parallel ranks sees it:
    a draw of n rows draws n * world rows from `generator` and keeps rows
    [rank n, (rank + 1) n). The ranks together draw what one device draws
    for the global batch, which is the JAX package's pjit step (its random
    draws are the global batch's), and every rank's generator stays in step."""

    generator: torch.Generator
    rank: int
    world: int

    def initial_seed(self) -> int:
        return self.generator.initial_seed()


Generator = Union[torch.Generator, RowShard]


def rand_rows(generator: Generator, n_rows: int, n_cols: int, device=None,
              dtype=None) -> torch.Tensor:
    """(n_rows, n_cols) uniforms in [0, 1) from `generator`, one row a ray;
    a `RowShard` keeps its rank's rows of the global draw."""
    if isinstance(generator, RowShard):
        u = torch.rand((n_rows * generator.world, n_cols), generator=generator.generator,
                       device=device, dtype=dtype)
        return u[generator.rank * n_rows:(generator.rank + 1) * n_rows]
    return torch.rand((n_rows, n_cols), generator=generator, device=device, dtype=dtype)


def intervals_from_t(t: torch.Tensor, far: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """t (N, S) sorted -> (t_start, t_end) with t_end[-1] = far."""
    t_end = torch.cat([t[:, 1:], torch.full_like(t[:, :1], far)], dim=1)
    return t.contiguous(), t_end


def sample_stratified(
    generator: Optional[torch.Generator],
    n_rays: int,
    n_samples: int,
    near: float,
    far: float,
    strategy: str = "stratified_uniform",
    offset_size: float = 0.0,
    device=None,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform-bin coarse sampling. Returns (t_start, t_end), each (N, S).
    "stratified_uniform" draws its (N, S) uniforms from `generator` unless
    they are given as `u`."""
    interval = (far - near) / n_samples
    t = torch.linspace(near, far - interval, n_samples, device=device)
    t = t.expand(n_rays, n_samples)
    if strategy == "stratified_uniform":
        if u is None:
            if generator is None:
                raise ValueError("stratified_uniform requires a generator")
            u = rand_rows(generator, n_rays, n_samples, device=device)
        t = t + u * interval
    elif strategy != "equidistant":
        raise ValueError(f"unknown sampling strategy {strategy!r}")

    if offset_size != 0.0:
        if generator is None:
            raise ValueError("offset_size != 0 requires a generator")
        t = t + rand_rows(generator, n_rays, 1, device=device) * interval * offset_size
    return intervals_from_t(t, far)


def broadcast_bins(t: torch.Tensor, block: int) -> torch.Tensor:
    """(N / block, S) bins of the first ray of each run of `block` rays ->
    (N, S), each row repeated for its run (a contiguous copy when block > 1:
    the kernels take row-major bins)."""
    if block == 1:
        return t
    n_rep, s = t.shape
    return t[:, None, :].expand(n_rep, block, s).reshape(n_rep * block, s)


def t_query(t_start: torch.Tensor, t_end: torch.Tensor, strategy: str = "middle") -> torch.Tensor:
    """Integration query point per bin (`_get_t_query:279-286`)."""
    if strategy == "left":
        return t_start
    if strategy == "middle":
        return (t_start + t_end) / 2.0
    raise ValueError(f"unknown integration strategy {strategy!r}")


def sample_pdf(
    t_edges: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-8,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF resampling from a piecewise-constant PDF over bins.

    t_edges (N, B+1) bin edges; weights (N, B) nonnegative bin masses.
    Returns sorted t samples (N, n_samples): evenly spaced quantiles without
    a generator, stratified-jittered quantiles with one (or with its (N,
    n_samples) uniforms given as `u`).
    """
    n_rays, n_bins = weights.shape
    w = weights + eps
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(w[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)

    steps = torch.arange(n_samples, dtype=w.dtype, device=w.device)
    if u is not None:
        u = (steps + u) / n_samples
    elif generator is None:
        u = ((steps + 0.5) / n_samples).expand(n_rays, n_samples).contiguous()
    else:
        u = (steps + rand_rows(generator, n_rays, n_samples, device=w.device,
                               dtype=w.dtype)) / n_samples

    # last bin whose lower cdf edge is <= u; residual mass (u beyond the last
    # edge from rounding) goes to the last bin
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, n_bins - 1)
    d_cdf = cdf[:, 1:] - cdf[:, :-1]
    denom = torch.where(d_cdf < eps, torch.ones_like(d_cdf), d_cdf)
    k = (t_edges[:, 1:] - t_edges[:, :-1]) / denom
    base = t_edges[:, :-1] - cdf[:, :-1] * k
    return torch.gather(base, 1, idx) + u * torch.gather(k, 1, idx)


def sample_pdf_weighted_intervals(
    t_coarse_start: torch.Tensor,
    t_coarse_end: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    far: float,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine sampling (`_sample_t_pdf_weighted`): bin edges from the coarse
    intervals, n_samples inverse-CDF points (monotone by construction, so no
    sort), back to (t_start, t_end) bins."""
    edges = torch.cat([t_coarse_start, t_coarse_end[:, -1:]], dim=1)
    t = sample_pdf(edges, weights, n_samples, generator=generator, u=u)
    return intervals_from_t(t, far)


def unit_edges(
    n_rays: int,
    n_bins: int,
    stratified: bool,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Bin edges uniform in [0, 1], (N, B+1). With stratified=True the
    interior edges are jittered inside their cells from `generator`; the end
    edges stay pinned."""
    s = torch.linspace(0.0, 1.0, n_bins + 1, device=device).expand(n_rays, n_bins + 1)
    if stratified:
        if generator is None:
            raise ValueError("stratified edges require a generator")
        jitter = (rand_rows(generator, n_rays, n_bins + 1, device=device) - 0.5) / n_bins
        jitter[:, 0] = 0.0
        jitter[:, -1] = 0.0
        s = s + jitter
    return s


def lindisp_edges(
    n_rays: int,
    n_bins: int,
    near: float,
    far: float,
    stratified: bool,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Bin edges uniform in inverse depth (nerfacc "lindisp"), (N, B+1):
    `unit_edges` in s-space (s = normalized inverse depth), then
    1/t = (1-s)/near + s/far."""
    s = unit_edges(n_rays, n_bins, stratified, generator, device)
    return 1.0 / ((1.0 - s) / near + s / far)
