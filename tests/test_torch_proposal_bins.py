"""The serving proposal stage's kernel (`ops/proposal_bins.py`,
`csrc/proposal_bins.cu`): its plain version is, bit for bit, the eager stage
that `barf.forward(stratified=False)` runs; `barf.can_fuse_proposal` takes
the configs the kernel covers and refuses the rest; the wrapper sends CPU
tensors to the plain version without counting a launch; the packed weights
are `pack_b`'s and the shared memory the kernel's layout.

The tests marked `cuda` need an NVIDIA card and skip elsewhere: the kernel
against the plain stage (cuBLAS and the compositing kernel) at the serving
chunk, the served rgb against the eager route, `render_block_coarse(block=1)`
bitwise equal to `forward`, and the launches a 400x400 view counts. The file
imports no JAX, so on a machine with a card and without JAX it runs without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_proposal_bins.py -q
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from nerf_experiments_tpu_torch.encodings.fourier import Barf, IntegratedBarf
from nerf_experiments_tpu_torch.experiments import render_views
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.ops import occgrid, render, sampling
from nerf_experiments_tpu_torch.ops import proposal_bins as pb
from nerf_experiments_tpu_torch.ops.train_megakernel import pack_b
from nerf_experiments_tpu_torch.systems import barf

NEAR, FAR = 2.0, 8.0
N_COARSE, N_FINE = 64, 32  # the north-star proposal bins and fine samples
PIXEL_WIDTH = 1e-3


def mlp(hidden_dim, n_hidden, n_segments, bf16=True, encoder=Barf):
    enc = dict(scale=1.0, include_identity=True)
    return nerf_mlp.NerfMLPConfig(
        position_encoder=encoder(levels=10, **enc), direction_encoder=encoder(levels=4, **enc),
        n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=n_segments,
        delayed_direction=True, delayed_density=False,
        compute_dtype=torch.bfloat16 if bf16 else None)


def config(name="northstar", hidden_dim=32, n_hidden=1, proposal_dim=64, proposal_hidden=1):
    """The north-star shape (a 64-wide proposal net on 64 bins, 32 fine
    samples, bf16) with a radiance net of the given size, or one of the
    variants the kernel refuses."""
    proposal = mlp(proposal_dim, proposal_hidden, 1)
    kw = dict(n_training_images=4, near=NEAR, far=FAR, samples_per_ray_radiance=N_FINE,
              samples_per_ray_proposal=N_COARSE, uniform_sampling_strategy="equidistant",
              uniform_sampling_offset_size=-1.0)
    radiance = mlp(hidden_dim, n_hidden, 2)
    if name == "fp32_proposal":
        proposal = mlp(proposal_dim, proposal_hidden, 1, bf16=False)
    elif name == "mip_encoders":
        proposal = mlp(proposal_dim, proposal_hidden, 1, encoder=IntegratedBarf)
    elif name == "shared_net":
        proposal, kw["share_proposal_net"] = None, True
    elif name == "no_proposal":
        proposal, kw["samples_per_ray_proposal"] = None, 0
    elif name == "occupancy_grid":
        proposal, kw["samples_per_ray_proposal"] = None, 0
        kw["occ"] = occgrid.OccGridConfig(resolution=16, aabb_half=2.0, n_coarse=64)
    elif name == "width_48":
        proposal = mlp(48, proposal_hidden, 1)
    elif name == "bins_40":
        kw["samples_per_ray_proposal"] = 40
    elif name == "left_integration":
        kw["integration_strategy"] = "left"
    elif name != "northstar":
        raise ValueError(name)
    return barf.BarfConfig(radiance=radiance, proposal=proposal, **kw)


def rays(n, seed=3, device="cpu"):
    """Rays from a sphere of radius 4 towards the unit region around the
    origin."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3)) * 0.3 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.as_tensor(o, dtype=torch.float32, device=device),
            torch.as_tensor(d, dtype=torch.float32, device=device))


def setup(device="cpu", seed=0, **kw):
    cfg = config(**kw)
    params = barf.init(torch.Generator().manual_seed(seed), cfg).to(device)
    return params, cfg


def plain_stage(params, cfg, o, d, alpha_pos, alpha_dir):
    """The stage `forward(stratified=False)` ran before the proposal kernel,
    as it was written there."""
    n = o.shape[0]
    pw = torch.full((n, 1), PIXEL_WIDTH, device=o.device)
    tc_start, tc_end = sampling.sample_stratified(
        None, n, cfg.samples_per_ray_proposal, cfg.near, cfg.far, "equidistant", 0.0,
        device=o.device)
    dens_c, rgb_c_samples = barf._eval_model(
        *barf._proposal_model(params, cfg), o, d, tc_start, tc_end, pw, alpha_pos, alpha_dir,
        cfg.integration_strategy, 0.0)
    rgb_coarse, weights = render.render_rays_auto(
        dens_c, rgb_c_samples, tc_end - tc_start, density_scale=cfg.density_scale)
    tf_start, tf_end = sampling.sample_pdf_weighted_intervals(
        tc_start, tc_end, weights.detach(), cfg.samples_per_ray_radiance, cfg.far)
    return rgb_coarse, tf_start, tf_end


def stage(fn, params, cfg, o, d, alpha_pos, alpha_dir):
    """`fn` (the wrapper or its plain version) at the config's bins."""
    return fn(params.proposal, cfg.proposal, o, d, cfg.near, cfg.far,
              cfg.samples_per_ray_proposal, cfg.samples_per_ray_radiance, alpha_pos, alpha_dir,
              cfg.density_scale)


# ---------------------------------------------------------------- the CPU

ALPHAS = [(10.0, 4.0), (6.5, 2.5)]  # every level on; fractional ramps in both encoders


@pytest.mark.parametrize("alpha_pos,alpha_dir", ALPHAS)
@torch.no_grad()
def test_reference_is_the_plain_stage_of_forward_bitwise(alpha_pos, alpha_dir):
    params, cfg = setup()
    o, d = rays(48)
    want = plain_stage(params, cfg, o, d, alpha_pos, alpha_dir)
    got = stage(pb.proposal_bins_reference, params, cfg, o, d, alpha_pos, alpha_dir)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # forward's own stage, coarse rgb and the fine pass on those bins
    pw = torch.full((48, 1), PIXEL_WIDTH)
    rgb, rgb_coarse = barf.forward(params, cfg, None, o, d, pw, alpha_pos, alpha_dir,
                                   stratified=False)
    assert torch.equal(rgb_coarse, want[0])
    assert torch.equal(rgb, barf.rgb_fine_pass(params, cfg, o, d, want[1], want[2], pw,
                                               alpha_pos, alpha_dir))
    # the bins: sorted in [near, far], t_end the next t_start and far last
    t_start, t_end = got[1], got[2]
    assert torch.all(t_start[:, 1:] >= t_start[:, :-1])
    assert torch.equal(t_end[:, :-1], t_start[:, 1:]) and torch.all(t_end[:, -1] == FAR)
    assert float(t_start.min()) >= NEAR and float(t_start.max()) <= FAR


@torch.no_grad()
def test_wrapper_on_cpu_tensors_is_the_reference_and_counts_no_launch():
    params, cfg = setup()
    o, d = rays(16)
    before = pb.proposal_bins.launches
    got = stage(pb.proposal_bins, params, cfg, o, d, None, None)
    want = stage(pb.proposal_bins_reference, params, cfg, o, d, 10.0, 4.0)
    assert pb.proposal_bins.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,fuses", [
    ("northstar", True), ("fp32_proposal", False), ("shared_net", False),
    ("no_proposal", False), ("occupancy_grid", False), ("mip_encoders", False),
    ("width_48", False), ("bins_40", False), ("left_integration", False)])
def test_can_fuse_proposal_takes_only_what_the_kernel_covers(name, fuses):
    cfg = config(name)
    assert barf.can_fuse_proposal(cfg) == fuses
    assert barf.use_fused_proposal(cfg, "cpu") is False
    assert barf.use_fused_proposal(cfg, "cuda") == fuses


@pytest.mark.parametrize("proposal_dim,proposal_hidden", [(32, 1), (64, 1), (64, 2), (128, 1)])
def test_packed_weights_are_pack_b_a_layer(proposal_dim, proposal_hidden):
    params, cfg = setup(proposal_dim=proposal_dim, proposal_hidden=proposal_hidden)
    net, pcfg = params.proposal, cfg.proposal
    layers = [l for seg in net.segments for l in seg.layers] + list(net.color)
    parts = pb.layer_parts(pcfg)
    assert barf.can_fuse_proposal(cfg)
    assert [tuple(l.w.shape) for l in layers] == [(sum(p), out) for p, out in parts]
    fwd, biases = pb.packed_weights(net, pcfg, "cpu")
    assert len(fwd) == len(biases) == len(layers) == proposal_hidden + 3
    for layer, (p, out), got, b in zip(layers, parts, fwd, biases):
        assert torch.equal(got, pack_b(layer.w.detach(), p, [out], True))
        assert torch.equal(b, layer.b.detach())


def test_smem_bytes_is_the_kernels_layout():
    """North-star by hand: B fragments (8 bytes a lane, 32 lanes) of 8 x 4, 10
    x 4, 4 x 6 and 2 x 2 (n8 tiles x k-steps), biases 64 + 68 + 32 + 4, 68
    edges, 16 window levels; a warp's 16 x 72 + 32 bf16 and 64 x 4 + 68 + 32
    fp32."""
    cfg = config().proposal
    frags = (8 * 4 + 10 * 4 + 4 * 6 + 2 * 2) * 32
    warp = 2 * (16 * 72 + 32) + 4 * (64 * 4 + 68 + 32)
    want = 8 * frags + 4 * (64 + 68 + 32 + 4 + 68 + 16) + 8 * warp
    assert pb.smem_bytes(cfg, N_COARSE, N_FINE) == want == 56_944
    wide = dataclasses.replace(cfg, hidden_dim=128, n_hidden=4)
    assert pb.smem_bytes(wide, N_COARSE, N_FINE) <= pb.SMEM_LIMIT
    assert not pb.kernel_fits(dataclasses.replace(cfg, n_hidden=8, hidden_dim=128), 64, 32)


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the proposal kernel")
    return torch.device("cuda", 0)


CHUNK = 8192  # the serving chunk
# bf16 roundings flip where the tensor cores add a product in another order
# than cuBLAS: a flipped value moves its point's density or colour by ~2^-8
# of itself, which moves the coarse rgb, the weights and the fine bins a
# little. On an H100 the nine cases below read at most 1.4e-5 (coarse rgb),
# 7.8e-5 (a bin edge, of far - near = 6) and 1.5e-7 (the mean edge); each
# tolerance leaves 10-35x room for other seeds' flips, and stays far under
# what a wrong bin or weight moves (a coarse bin is 0.094 wide).
TOL_RGB_COARSE = 5e-4
TOL_T_MAX = 2e-3
TOL_T_MEAN = 2e-6


def bins_errors(got, want):
    dt = (got[1] - want[1]).abs()
    return float((got[0] - want[0]).abs().max()), float(dt.max()), float(dt.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("alpha_pos", [10.0, 6.5, 0.0])
@pytest.mark.parametrize("alpha_dir", [4.0, 2.5])
@torch.no_grad()
def test_on_the_card_the_kernel_matches_the_plain_stage(card, alpha_pos, alpha_dir):
    params, cfg = setup(card)
    o, d = rays(CHUNK, seed=11, device=card)
    before = pb.proposal_bins.launches
    got = stage(pb.proposal_bins, params, cfg, o, d, alpha_pos, alpha_dir)
    want = stage(pb.proposal_bins_reference, params, cfg, o, d, alpha_pos, alpha_dir)
    torch.cuda.synchronize()
    assert pb.proposal_bins.launches == before + 1
    rgb_err, t_max, t_mean = bins_errors(got, want)
    print(f"alpha {alpha_pos} / {alpha_dir}: rgb_coarse {rgb_err:.3e}, t max {t_max:.3e}, "
          f"mean {t_mean:.3e}")
    assert rgb_err <= TOL_RGB_COARSE and t_max <= TOL_T_MAX and t_mean <= TOL_T_MEAN
    t_start, t_end = got[1], got[2]
    assert torch.equal(t_end[:, :-1], t_start[:, 1:]) and torch.all(t_end[:, -1] == FAR)
    assert torch.all(t_start[:, 1:] >= t_start[:, :-1])


@pytest.mark.cuda
@pytest.mark.parametrize("proposal_dim,proposal_hidden", [(32, 1), (64, 2), (128, 1)])
@torch.no_grad()
def test_on_the_card_every_width_matches_the_plain_stage(card, proposal_dim, proposal_hidden):
    params, cfg = setup(card, proposal_dim=proposal_dim, proposal_hidden=proposal_hidden)
    o, d = rays(1000, seed=12, device=card)
    got = stage(pb.proposal_bins, params, cfg, o, d, 10.0, 4.0)
    want = stage(pb.proposal_bins_reference, params, cfg, o, d, 10.0, 4.0)
    rgb_err, t_max, t_mean = bins_errors(got, want)
    print(f"{proposal_dim}x{proposal_hidden}: rgb_coarse {rgb_err:.3e}, t max {t_max:.3e}, "
          f"mean {t_mean:.3e}")
    assert rgb_err <= TOL_RGB_COARSE and t_max <= TOL_T_MAX and t_mean <= TOL_T_MEAN


# A quarter of the north-star serving cell's `rgb_max_gap` limit (1e-3).
TOL_SERVED_RGB = 2.5e-4


@pytest.mark.cuda
@torch.no_grad()
def test_on_the_card_forward_stays_near_the_plain_stage(card):
    """The served rgb (K2 on the kernel's bins) against K2 on the plain
    stage's bins, at the north-star radiance net."""
    params, cfg = setup(card, hidden_dim=256, n_hidden=4)
    o, d = rays(CHUNK, seed=13, device=card)
    pw = torch.full((CHUNK, 1), PIXEL_WIDTH, device=card)
    assert barf.use_fused_render(cfg, card) and barf.use_fused_proposal(cfg, card)
    before = pb.proposal_bins.launches
    rgb, _ = barf.forward(params, cfg, None, o, d, pw, 10.0, 4.0, stratified=False, fused=True)
    assert pb.proposal_bins.launches == before + 1
    _, t_start, t_end = plain_stage(params, cfg, o, d, 10.0, 4.0)
    eager = barf.rgb_fine_pass(params, cfg, o, d, t_start, t_end, pw, 10.0, 4.0, fused=True)
    err = float((rgb - eager).abs().max())
    print(f"served rgb against the eager route: max {err:.3e}")
    assert err <= TOL_SERVED_RGB


@pytest.mark.cuda
@torch.no_grad()
def test_on_the_card_block_coarse_of_one_is_forward_bitwise(card):
    params, cfg = setup(card)
    o, d = rays(2048, seed=14, device=card)
    pw = torch.full((2048, 1), PIXEL_WIDTH, device=card)
    before = pb.proposal_bins.launches
    got = barf.render_block_coarse(params, cfg, o, d, 10.0, 4.0, block=1,
                                   pixel_width=PIXEL_WIDTH)
    want, _ = barf.forward(params, cfg, None, o, d, pw, 10.0, 4.0, stratified=False, fused=True)
    assert pb.proposal_bins.launches == before + 2
    assert torch.equal(got, want)


@pytest.mark.cuda
@torch.no_grad()
def test_on_the_card_block_coarse_of_four_stays_near_the_plain_stage(card):
    """Every fourth ray (a strided view of the chunk) through the kernel,
    against the same render with the plain stage in its place."""
    params, cfg = setup(card)
    o, d = rays(2048, seed=16, device=card)
    before = pb.proposal_bins.launches
    got = barf.render_block_coarse(params, cfg, o, d, 10.0, 4.0, block=4,
                                   pixel_width=PIXEL_WIDTH)
    assert pb.proposal_bins.launches == before + 1
    with mock.patch.object(barf, "proposal_bins", pb.proposal_bins_reference):
        want = barf.render_block_coarse(params, cfg, o, d, 10.0, 4.0, block=4,
                                        pixel_width=PIXEL_WIDTH)
    assert float((got - want).abs().max()) <= TOL_SERVED_RGB


@pytest.mark.cuda
@torch.no_grad()
def test_on_the_card_a_400_view_launches_the_kernel_once_a_chunk(card):
    params, cfg = setup(card)
    o, d = rays(400 * 400, seed=15)
    gauge = (torch.eye(3, device=card), torch.zeros((1, 3), device=card),
             torch.tensor(1.0, device=card))
    before = pb.proposal_bins.launches
    rgb = render_views.render_image(params, cfg, o.numpy(), d.numpy(), gauge, PIXEL_WIDTH,
                                    CHUNK, card, 10.0, 4.0)
    assert pb.proposal_bins.launches - before == 20  # 160,000 rays at 8192 a chunk
    assert rgb.shape == (160_000, 3) and np.isfinite(rgb).all()
