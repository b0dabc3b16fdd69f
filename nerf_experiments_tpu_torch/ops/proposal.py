"""Transmittance-estimator sampling and the proposal (interlevel) loss.

Port of `nerf_experiments_tpu/ops/proposal.py`, the counterpart of nerfacc's
`PropNetEstimator` (`barf/model_garf.py:222-233` `.sampling(...,
sampling_type="lindisp", stratified=training)` and `:279`
`.compute_loss(trans)`):

  1. initial bin edges uniform in normalized inverse depth (s-space,
     `sampling.unit_edges`), stratified-jittered during training (end edges
     pinned);
  2. the proposal network's densities over the bins;
  3. compositing weights -> piecewise-constant PDF over s;
  4. inverse-CDF resampling of the radiance bin edges (`sampling.sample_pdf`,
     jittered quantiles from the generator during training);
  5. the Mip-NeRF 360 interlevel loss between the recorded proposal
     histogram and the final radiance weights.

Randomness comes from an explicit `torch.Generator`: the initial jitter,
then one draw per resampling level.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from nerf_experiments_tpu_torch.ops.render import render_weights
from nerf_experiments_tpu_torch.ops.sampling import sample_pdf, unit_edges


class ProposalAux(NamedTuple):
    """Recorded proposal histograms for the interlevel loss (one per level)."""

    s_edges: Tuple[torch.Tensor, ...]  # each (N, B_l + 1), in [0, 1]
    weights: Tuple[torch.Tensor, ...]  # each (N, B_l)
    final_s_edges: torch.Tensor  # (N, S + 1)


def s_to_t(s: torch.Tensor, near: float, far: float, sampling_type: str) -> torch.Tensor:
    if sampling_type == "lindisp":
        return 1.0 / ((1.0 - s) / near + s / far)
    if sampling_type == "uniform":
        return near + s * (far - near)
    raise ValueError(f"unknown sampling_type {sampling_type!r}")


def sampling(
    prop_sigma_fns: Sequence[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]],
    prop_samples: Sequence[int],
    num_samples: int,
    n_rays: int,
    near_plane: float,
    far_plane: float,
    sampling_type: str = "lindisp",
    stratified: bool = False,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, ProposalAux]:
    """nerfacc `PropNetEstimator.sampling` equivalent.

    Each `prop_sigma_fns[l]` maps (t_starts, t_ends) of shape (N, B_l) to
    densities (N, B_l). Returns (t_starts, t_ends) of shape (N, num_samples)
    and the recorded histograms for `compute_loss`. The resampled edges are
    detached (nerfacc's requires_grad=False sample positions): the proposal
    net trains only through the interlevel loss, via the histograms."""
    gen = generator if stratified else None
    s_edges = unit_edges(n_rays, prop_samples[0], stratified, gen, device)
    rec_edges, rec_weights = [], []
    for level, (fn, n_bins) in enumerate(zip(prop_sigma_fns, prop_samples)):
        t_edges = s_to_t(s_edges, near_plane, far_plane, sampling_type)
        t_starts, t_ends = t_edges[:, :-1], t_edges[:, 1:]
        sigmas = fn(t_starts, t_ends)
        weights, _, _ = render_weights(sigmas, t_ends - t_starts)
        rec_edges.append(s_edges)
        rec_weights.append(weights)
        next_n = prop_samples[level + 1] if level + 1 < len(prop_samples) else num_samples
        # monotone quantiles through a monotone CDF stay sorted: no sort
        s_edges = sample_pdf(s_edges, weights.detach(), next_n + 1, generator=gen).detach()

    t_edges = s_to_t(s_edges, near_plane, far_plane, sampling_type)
    aux = ProposalAux(s_edges=tuple(rec_edges), weights=tuple(rec_weights),
                      final_s_edges=s_edges)
    return t_edges[:, :-1].contiguous(), t_edges[:, 1:].contiguous(), aux


def _outer_measure(edges_q: torch.Tensor, edges_ref: torch.Tensor,
                   w_ref: torch.Tensor) -> torch.Tensor:
    """For each query interval [q_lo, q_hi], the total ref mass of every ref
    interval that OVERLAPS it, ends included: ref_end >= q_lo and ref_start <=
    q_hi (outer measure, Mip-NeRF 360 eq. 13).

    edges_q (N, Q+1), edges_ref (N, R+1) sorted, w_ref (N, R) -> (N, Q). With
    sorted edges the overlapping refs are the index range [lo, hi): lo counts
    the ref ends < q_lo, hi the ref starts <= q_hi; the mass is a difference of
    the cumulative sum."""
    ref_start = edges_ref[:, :-1].contiguous()
    ref_end = edges_ref[:, 1:].contiguous()
    lo = torch.searchsorted(ref_end, edges_q[:, :-1].contiguous(), right=False)
    hi = torch.searchsorted(ref_start, edges_q[:, 1:].contiguous(), right=True)
    hi = torch.maximum(hi, lo)
    cum = torch.cat([torch.zeros_like(w_ref[:, :1]), torch.cumsum(w_ref, dim=-1)], dim=-1)
    return torch.gather(cum, 1, hi) - torch.gather(cum, 1, lo)


def compute_loss(aux: ProposalAux, final_weights: torch.Tensor,
                 eps: float = 1e-7) -> torch.Tensor:
    """Interlevel (PropNet histogram) loss, nerfacc `compute_loss` parity:
    mean over proposal bins of clip(outer(final) - w_prop, 0)^2 / (w_prop +
    eps). The final weights and the outer measure carry no gradient."""
    final_weights = final_weights.detach()
    loss = 0.0
    for s_edges, w_prop in zip(aux.s_edges, aux.weights):
        w_outer = _outer_measure(s_edges.detach(), aux.final_s_edges, final_weights)
        excess = torch.clamp(w_outer - w_prop, min=0.0)
        loss = loss + torch.mean(excess**2 / (w_prop + eps))
    return loss
