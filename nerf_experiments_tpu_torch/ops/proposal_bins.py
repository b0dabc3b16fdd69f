"""The serving proposal stage of a hierarchical BARF config: `proposal_bins`,
the wrapper of `csrc/proposal_bins.cu` (one launch: the equidistant coarse
bins, the proposal NerfMLP, compositing and the inverse-CDF resample), and
`proposal_bins_reference`, its plain PyTorch version: the stage
`systems/barf.forward` runs eagerly on deterministic bins, op for op.

Neither has a counterpart in the JAX package, which leaves the stage to XLA
in its `systems/barf.py:forward`. A CPU tensor goes to the plain version; a
CUDA tensor goes to the kernel, or the call raises. The kernel takes the
proposal nets `kernel_fits` accepts: one segment of a NerfMLP with Barf
encoders (identity included), delayed direction, density from the segment,
bf16, hidden width 32, 64 or 128, coarse bins a multiple of 16, and a block
whose shared memory fits (`smem_bytes`).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from nerf_experiments_tpu_torch.encodings.fourier import Barf
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.ops import cuda_build, render, sampling
from nerf_experiments_tpu_torch.ops.cuda_build import check_rays, pointers
from nerf_experiments_tpu_torch.ops.render import DENSITY_SCALE
from nerf_experiments_tpu_torch.ops.train_megakernel import (
    SMEM_LIMIT, _round4, _round16, cached_packs, pack_layers)

HIDDEN_WIDTHS = (32, 64, 128)  # the kernel's instances (`launch<D>`)
WARPS = 8  # a block's warps, one ray each at a time (`kWarps`)


def _encoding_widths(cfg: nerf_mlp.NerfMLPConfig) -> Tuple[int, int]:
    return 3 + 6 * cfg.position_encoder.levels, 3 + 6 * cfg.direction_encoder.levels


def layer_parts(cfg: nerf_mlp.NerfMLPConfig):
    """(input parts, output width) of the kernel's layers: the segment's P ->
    D, D -> D ..., D -> D + 1 (the density column last), then the colour
    head [D | Q] -> C and C -> 3."""
    P, Q = _encoding_widths(cfg)
    D, C = cfg.hidden_dim, cfg.hidden_dim // 2
    return ([((P,), D)] + [((D,), D)] * (cfg.n_hidden - 1)
            + [((D,), D + 1), ((D, Q), C), ((C,), 3)])


def smem_bytes(cfg: nerf_mlp.NerfMLPConfig, n_coarse: int, n_fine: int) -> int:
    """A block's shared memory (`Layout::bytes` in csrc/proposal_bins.cu):
    every layer's packed B (8 bytes a lane a fragment of an n8 tile and a
    16-deep k-step) and fp32 bias, the coarse edges and the BARF window; then
    each warp's staging tile of 16 position encodings and its direction row
    (bf16), and its ray's density, rgb, cdf and fine t (fp32)."""
    P, Q = _encoding_widths(cfg)
    parts = layer_parts(cfg)
    frags = sum(_round16(out) // 8 * sum(map(_round16, ins)) // 16 * 32 for ins, out in parts)
    levels = cfg.position_encoder.levels + cfg.direction_encoder.levels
    floats = sum(_round4(out) for _, out in parts) + _round4(n_coarse + 1) + _round4(levels)
    warp = (2 * (16 * (_round16(P) + 8) + _round16(Q))
            + 4 * (4 * n_coarse + _round4(n_coarse + 1) + _round4(n_fine)))
    return 8 * frags + 4 * floats + WARPS * warp


def kernel_fits(cfg, n_coarse: int, n_fine: int) -> bool:
    """Whether the kernel covers this proposal net at these bin counts."""
    if not isinstance(cfg, nerf_mlp.NerfMLPConfig):
        return False
    pe, de = cfg.position_encoder, cfg.direction_encoder
    return (isinstance(pe, Barf) and isinstance(de, Barf)
            and pe.include_identity and de.include_identity
            and cfg.n_segments == 1 and cfg.n_hidden >= 1
            and cfg.delayed_direction and not cfg.delayed_density
            and cfg.compute_dtype == torch.bfloat16 and cfg.hidden_dim in HIDDEN_WIDTHS
            and n_coarse > 0 and n_coarse % 16 == 0 and n_fine > 0
            and smem_bytes(cfg, n_coarse, n_fine) <= SMEM_LIMIT)


def proposal_bins_reference(
    params: nerf_mlp.NerfMLP,
    cfg: nerf_mlp.NerfMLPConfig,
    origs: torch.Tensor,
    dirs: torch.Tensor,
    near: float,
    far: float,
    n_coarse: int,
    n_fine: int,
    alpha_pos=None,
    alpha_dir=None,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: equidistant coarse bins, middle-point positions,
    `nerf_mlp.apply`, compositing (`render_rays_auto`) and the deterministic
    inverse-CDF resample. Returns (rgb_coarse (N, 3), t_start, t_end (N,
    n_fine))."""
    n = origs.shape[0]
    tc_start, tc_end = sampling.sample_stratified(None, n, n_coarse, near, far, "equidistant",
                                                  device=origs.device)
    t_q = sampling.t_query(tc_start, tc_end, "middle")
    pos = origs[:, None, :] + t_q[..., None] * dirs[:, None, :]
    dirs_rep = dirs[:, None, :].expand(pos.shape)
    density, rgb = nerf_mlp.apply(params, cfg, pos.reshape(n * n_coarse, 3),
                                  dirs_rep.reshape(n * n_coarse, 3),
                                  alpha_pos=alpha_pos, alpha_dir=alpha_dir)
    rgb_coarse, weights = render.render_rays_auto(
        density.reshape(n, n_coarse), rgb.reshape(n, n_coarse, 3), tc_end - tc_start,
        density_scale=density_scale)
    t_start, t_end = sampling.sample_pdf_weighted_intervals(
        tc_start, tc_end, weights.detach(), n_fine, far)
    return rgb_coarse, t_start, t_end


@functools.lru_cache(maxsize=8)
def coarse_edges(near: float, far: float, n_coarse: int, device: str) -> torch.Tensor:
    """The n_coarse + 1 edges of the equidistant coarse bins, computed on the
    device by `sample_stratified` as the plain stage computes its bins."""
    t_start, t_end = sampling.sample_stratified(None, 1, n_coarse, near, far, "equidistant",
                                                device=device)
    return torch.cat([t_start[0], t_end[0, -1:]]).contiguous()


# The kernel's last packed weights, by the parameters they came from: a view
# is served in many calls with the same weights.
_pack: dict = {}


def packed_weights(params: nerf_mlp.NerfMLP, cfg: nerf_mlp.NerfMLPConfig, dev):
    """(every layer's B operand as `pack_b` packs it in bf16, the last segment
    layer with its density column; the fp32 biases), in the kernel's layer
    order, kept across calls by `cached_packs`."""
    layers = [l for seg in params.segments for l in seg.layers] + list(params.color)
    leaves = [t for l in layers for t in (l.w, l.b)]

    def pack():
        fwd, _ = pack_layers([l.w for l in layers], layer_parts(cfg), -1, True, False, dev)
        return fwd, [l.b.detach().to(dev, torch.float32).contiguous() for l in layers]

    return cached_packs(_pack, leaves, str(torch.device(dev)), pack)


def proposal_bins(
    params: nerf_mlp.NerfMLP,
    cfg: nerf_mlp.NerfMLPConfig,
    origs: torch.Tensor,      # (N, 3)
    dirs: torch.Tensor,       # (N, 3)
    near: float,
    far: float,
    n_coarse: int,
    n_fine: int,
    alpha_pos=None,
    alpha_dir=None,
    density_scale: float = DENSITY_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The proposal stage on `n_coarse` equidistant bins from near to far:
    (rgb_coarse (N, 3), fine t_start, t_end (N, n_fine)). No gradient:
    serving and eval (training runs the proposal under autograd)."""
    if origs.device.type != "cuda":
        return proposal_bins_reference(params, cfg, origs, dirs, near, far, n_coarse, n_fine,
                                       alpha_pos, alpha_dir, density_scale)
    if not kernel_fits(cfg, n_coarse, n_fine):
        raise ValueError("the proposal kernel does not cover this net or bin count "
                         "(`proposal_bins.kernel_fits`): such configs take the plain stage")
    pe, de = cfg.position_encoder, cfg.direction_encoder
    alpha_pos = float(pe.levels) if alpha_pos is None else float(alpha_pos)
    alpha_dir = float(de.levels) if alpha_dir is None else float(alpha_dir)
    n, dev = origs.shape[0], origs.device
    check_rays(n, n_fine, dev, origs=origs, dirs=dirs)
    lib = cuda_build.library()
    edges = coarse_edges(float(near), float(far), n_coarse, str(dev))
    wf, bs = packed_weights(params, cfg, dev)
    t_start = torch.empty((n, n_fine), dtype=torch.float32, device=dev)
    t_end = torch.empty((n, n_fine), dtype=torch.float32, device=dev)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_proposal_bins(
            origs.data_ptr(), dirs.data_ptr(), edges.data_ptr(), pointers(wf), pointers(bs),
            len(wf), n, n_coarse, n_fine, cfg.hidden_dim, cfg.n_hidden, pe.levels, de.levels,
            float(pe.scale), float(de.scale), alpha_pos, alpha_dir, float(density_scale),
            float(far), t_start.data_ptr(), t_end.data_ptr(), rgb.data_ptr(), stream)
    cuda_build.check(code, "netpu_proposal_bins")
    proposal_bins.launches += 1
    return rgb, t_start, t_end


proposal_bins.launches = 0
