"""Parity of the PyTorch port's ops with the JAX package on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
port. Tolerances: fp32 elementwise ops rtol=1e-5, atol=1e-6; Kabsch (an SVD
in each framework, whose LAPACK paths differ) atol=1e-5; the compositing
backward (suffix sums in another order) rtol=1e-5, atol=1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.ops import kabsch as jkabsch
from nerf_experiments_tpu.ops import lie as jlie
from nerf_experiments_tpu.ops import metrics as jmetrics
from nerf_experiments_tpu.ops import rays as jrays
from nerf_experiments_tpu.ops import render as jrender
from nerf_experiments_tpu.ops import render_pallas as jrender_pallas
from nerf_experiments_tpu.ops import sampling as jsampling
from nerf_experiments_tpu_torch.ops import kabsch as tkabsch
from nerf_experiments_tpu_torch.ops import lie as tlie
from nerf_experiments_tpu_torch.ops import metrics as tmetrics
from nerf_experiments_tpu_torch.ops import rays as trays
from nerf_experiments_tpu_torch.ops import render as trender
from nerf_experiments_tpu_torch.ops import render_cuda
from nerf_experiments_tpu_torch.ops import sampling as tsampling

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP32 = dict(rtol=1e-5, atol=1e-6)


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **(tol or FP32))


def t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------- lie


@pytest.mark.parametrize("scale", [1.0, 1e-5, 0.0])
def test_so3_exp_log_match_jax(scale):
    w = (np.random.default_rng(0).normal(size=(16, 3)) * scale).astype(np.float32)
    R = tlie.so3_exp(t(w))
    close(R, jlie.so3_exp(jnp.asarray(w)))
    close(tlie.hat(t(w)), jlie.hat(jnp.asarray(w)))
    close(tlie.so3_log(R), jlie.so3_log(jlie.so3_exp(jnp.asarray(w))), rtol=1e-4, atol=1e-5)


def test_se3_exp_and_rotate_match_jax():
    rng = np.random.default_rng(1)
    xi = rng.normal(size=(8, 6)).astype(np.float32)
    close(tlie.se3_exp(t(xi)), jlie.se3_exp(jnp.asarray(xi)))
    R = rng.normal(size=(8, 3, 3)).astype(np.float32)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    close(tlie.rotate(t(R), t(x)), jlie.rotate(jnp.asarray(R), jnp.asarray(x)))


def test_so3_exp_gradient_finite_at_zero():
    w = torch.zeros((1, 3), requires_grad=True)
    tlie.so3_exp(w).sum().backward()
    assert torch.isfinite(w.grad).all()


# ---------------------------------------------------------------- kabsch


@pytest.mark.parametrize("remove_outliers", [True, False])
def test_kabsch_matches_jax(remove_outliers):
    rng = np.random.default_rng(2)
    src = rng.normal(size=(24, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    dst = (src @ R.T) * 1.7 + np.array([0.5, -1.0, 2.0])
    dst = dst + rng.normal(size=dst.shape) * 0.01
    dst[:3] += 2.0  # outliers
    dst = dst.astype(np.float32)
    Rt, tt, ct = tkabsch.kabsch(t(src), t(dst), remove_outliers=remove_outliers)
    Rj, tj, cj = jkabsch.kabsch(jnp.asarray(src), jnp.asarray(dst),
                                remove_outliers=remove_outliers)
    tol = dict(rtol=1e-5, atol=1e-5)
    close(Rt, Rj, **tol)
    close(tt, tj, **tol)
    close(ct, cj, **tol)
    close(tkabsch.apply_similarity(Rt, tt, ct, t(src)),
          jkabsch.apply_similarity(Rj, tj, cj, jnp.asarray(src)), **tol)


def test_psnr_and_pose_error_match_jax():
    m = np.array([1e-8, 1e-3, 0.05, 0.5], np.float32)
    close(tmetrics.psnr(t(m)), jmetrics.psnr(jnp.asarray(m)))
    rng = np.random.default_rng(3)
    a = rng.normal(size=(12, 3)).astype(np.float32)
    b = (a + rng.normal(size=a.shape) * 0.05).astype(np.float32)
    close(tmetrics.pose_error(t(a), t(b)), jmetrics.pose_error(jnp.asarray(a), jnp.asarray(b)),
          rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- rays


def test_rays_match_jax():
    rng = np.random.default_rng(4)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2w[:, :3, :3] = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(3, 3)), jnp.float32)))
    c2w[:, :3, 3] = rng.normal(size=(3, 3))
    focal = trays.focal_length(8, 0.69)
    assert focal == pytest.approx(float(jrays.focal_length(8, 0.69)), rel=1e-6)
    mesh_t = trays.directions_meshgrid(6, 8, focal)
    mesh_j = jrays.directions_meshgrid(6, 8, focal)
    close(mesh_t, mesh_j)
    s_t, tr_t = trays.space_transform_params(t(c2w[:, :3, 3]))
    s_j, tr_j = jrays.space_transform_params(jnp.asarray(c2w[:, :3, 3]))
    close(s_t, s_j)
    close(tr_t, tr_j)
    close(trays.transform_c2w(t(c2w), s_t, tr_t), jrays.transform_c2w(jnp.asarray(c2w), s_j, tr_j))
    for a, b in zip(trays.rays_from_c2w(mesh_t, t(c2w)),
                    jrays.rays_from_c2w(mesh_j, jnp.asarray(c2w))):
        close(a, b)
    for a, b in zip(trays.camera_origins_and_directions(t(c2w)),
                    jrays.camera_origins_and_directions(jnp.asarray(c2w))):
        close(a, b)


def test_apply_pose_noise_moves_origins_and_rotates_directions():
    rng = np.random.default_rng(10)
    cam_o = t(rng.normal(size=(4, 3)).astype(np.float32))
    cam_d = t(rng.normal(size=(4, 3)).astype(np.float32))
    ray_o = cam_o[:, None, :].expand(4, 5, 3)
    ray_d = t(rng.normal(size=(4, 5, 3)).astype(np.float32))
    same = trays.apply_pose_noise(torch.Generator().manual_seed(0), cam_o, cam_d, ray_o,
                                  ray_d, 0.0, 0.0)
    for a, b in zip(same, (cam_o, cam_d, ray_o, ray_d)):
        close(a, b)
    co, cd, ro, rd = trays.apply_pose_noise(torch.Generator().manual_seed(0), cam_o, cam_d,
                                            ray_o, ray_d, 0.1, 0.2)
    close(ro - ray_o, (co - cam_o)[:, None, :].expand(4, 5, 3))  # one shift per camera
    close(rd.norm(dim=-1), ray_d.norm(dim=-1))  # rotations keep lengths
    assert not torch.allclose(rd, ray_d)


# ---------------------------------------------------------------- render


def _render_inputs(n=16, s=8, seed=5):
    rng = np.random.default_rng(seed)
    dens = (rng.uniform(size=(n, s)) * 8.0).astype(np.float32)
    colors = rng.uniform(size=(n, s, 3)).astype(np.float32)
    edges = np.sort(rng.uniform(size=(n, s + 1)) * 6.0 + 2.0, axis=-1).astype(np.float32)
    return dens, colors, edges[:, :-1].copy(), edges[:, 1:].copy()


def test_render_full_matches_jax_reference_and_pallas_kernel():
    dens, colors, ts, te = _render_inputs()
    port = trender.render_full(t(dens), t(colors), t(ts), t(te))
    ref = jrender.render_full(*map(jnp.asarray, (dens, colors, ts, te)))
    kern = jrender_pallas.render_full_pallas(*map(jnp.asarray, (dens, colors, ts, te)),
                                             interpret=True)
    for i in range(3):
        close(port[i], ref[i])
        close(port[i], kern[i])
    for k in ("trans", "weights"):
        close(port[3][k], ref[3][k])
        close(port[3][k], kern[3][k])
    close(port[3]["alpha"], ref[3]["alpha"])


def test_render_rays_matches_jax_reference_and_pallas_kernel():
    dens, colors, ts, te = _render_inputs(seed=6)
    dists = te - ts
    rgb, w = trender.render_rays(t(dens), t(colors), t(dists))
    rgb_r, w_r = jrender.render_rays(*map(jnp.asarray, (dens, colors, dists)))
    rgb_k, w_k = jrender_pallas.render_rays_pallas(*map(jnp.asarray, (dens, colors, dists)),
                                                   interpret=True)
    close(rgb, rgb_r)
    close(w, w_r)
    close(rgb, rgb_k)
    close(w, w_k)


@pytest.mark.parametrize("entry", ["rays", "full"])
def test_cpu_tensor_takes_the_plain_version(entry):
    """A CPU tensor reaches the plain version and launches no kernel."""
    dens, colors, ts, te = map(t, _render_inputs(seed=7))
    before = render_cuda.render_fwd_cuda.launches
    if entry == "rays":
        got = trender.render_rays_auto(dens, colors, te - ts)
        want = trender.render_rays(dens, colors, te - ts)
    else:
        got = trender.render_full_auto(dens, colors, ts, te)[:3]
        want = trender.render_full(dens, colors, ts, te)[:3]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert render_cuda.render_fwd_cuda.launches == before


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("n_samples", [8, 32])
def test_sample_stratified_equidistant_matches_jax(n_samples):
    ts, te = tsampling.sample_stratified(None, 4, n_samples, 2.0, 8.0, "equidistant")
    js, je = jsampling.sample_stratified(None, 4, n_samples, 2.0, 8.0, "equidistant")
    close(ts, js)
    close(te, je)
    close(tsampling.t_query(ts, te), jsampling.t_query(js, je))
    close(tsampling.t_query(ts, te, "left"), js)


def test_sample_stratified_generator_is_reproducible_and_in_bins():
    draw = lambda: tsampling.sample_stratified(
        torch.Generator().manual_seed(3), 5, 16, 2.0, 8.0, "stratified_uniform", -1.0)
    (a, b), (c, d) = draw(), draw()
    assert torch.equal(a, c) and torch.equal(b, d)
    assert (a[:, 1:] > a[:, :-1]).all()
    with pytest.raises(ValueError):
        tsampling.sample_stratified(None, 5, 16, 2.0, 8.0, "stratified_uniform")


@pytest.mark.parametrize("peaky", [False, True])
def test_sample_pdf_weighted_intervals_matches_jax(peaky):
    rng = np.random.default_rng(8)
    n, b, s = 12, 16, 24
    ts, te = jsampling.sample_stratified(None, n, b, 2.0, 8.0, "equidistant")
    w = rng.uniform(size=(n, b)).astype(np.float32)
    if peaky:  # empty bins and one dominant bin: exercises ties and residual mass
        w[:, ::2] = 0.0
        w[:, 5] = 40.0
    fs, fe = tsampling.sample_pdf_weighted_intervals(t(ts), t(te), t(w), s, 8.0)
    js, je = jsampling.sample_pdf_weighted_intervals(ts, te, jnp.asarray(w), s, 8.0)
    close(fs, js, rtol=1e-5, atol=2e-6)
    close(fe, je, rtol=1e-5, atol=2e-6)
    assert (fs[:, 1:] >= fs[:, :-1]).all()


def test_sample_pdf_with_generator_stays_in_range():
    rng = np.random.default_rng(9)
    edges = np.sort(rng.uniform(2.0, 8.0, size=(6, 9)), axis=-1).astype(np.float32)
    w = rng.uniform(size=(6, 8)).astype(np.float32)
    out = tsampling.sample_pdf(t(edges), t(w), 20, generator=torch.Generator().manual_seed(0))
    assert out.shape == (6, 20)
    assert (out >= t(edges[:, :1]) - 1e-5).all() and (out <= t(edges[:, -1:]) + 1e-5).all()
    assert (out[:, 1:] >= out[:, :-1]).all()


# ---------------------------------------------------------------- render backward

BWD = dict(rtol=1e-5, atol=1e-5)


def _bwd_inputs(n=12, s=37, seed=11):
    """Inputs and random cotangents; s = 37 spans two 32-sample steps."""
    rng = np.random.default_rng(seed)
    dens, colors, ts, te = _render_inputs(n, s, seed)
    gw, gt = rng.normal(size=(2, n, s)).astype(np.float32)
    gstats = rng.normal(size=(n, 5)).astype(np.float32)
    return dens, (te - ts).astype(np.float32), ((ts + te) / 2).astype(np.float32), colors, \
        gw, gt, gstats


@pytest.mark.parametrize("with_depth", [True, False])
def test_render_bwd_reference_matches_pallas_vjp(with_depth):
    """The plain version of the compositing backward kernel against the JAX
    package's Pallas VJP (`_render_core`, interpret mode): cotangents on
    weights, trans and every stat."""
    dens, dists, tmid, colors, gw, gt, gstats = _bwd_inputs()
    if not with_depth:
        tmid = np.zeros_like(tmid)
    core = lambda d, di, c: jrender_pallas._render_core(
        d, di, jnp.asarray(tmid), c, float(trender.DENSITY_SCALE), True)
    _, vjp = jax.vjp(core, *map(jnp.asarray, (dens, dists, colors)))
    gstats8 = np.concatenate([gstats, np.zeros((gstats.shape[0], 3), np.float32)], axis=-1)
    want = vjp((jnp.asarray(gw), jnp.asarray(gt), jnp.asarray(gstats8)))
    got = trender.render_bwd_reference(t(dens), t(dists), t(tmid) if with_depth else None,
                                       t(colors), t(gw), t(gt), t(gstats))
    for a, b in zip(got, want):
        close(a, b, **BWD)


def test_render_bwd_reference_matches_autograd():
    """... and against torch autograd of the plain compositing, with the
    densities, distances and colours as independent leaves."""
    dens, dists, tmid, colors, gw, gt, gstats = map(t, _bwd_inputs(seed=12))
    leaves = [x.clone().requires_grad_(True) for x in (dens, dists, colors)]
    weights, _, trans = trender.render_weights(leaves[0], leaves[1])
    stats = torch.cat([torch.sum(weights[..., None] * leaves[2], dim=-2),
                       weights.sum(-1, keepdim=True),
                       (weights * tmid).sum(-1, keepdim=True)], dim=-1)
    loss = (weights * gw).sum() + (trans * gt).sum() + (stats * gstats).sum()
    want = torch.autograd.grad(loss, leaves)
    got = trender.render_bwd_reference(dens, dists, tmid, colors, gw, gt, gstats)
    for a, b in zip(got, want):
        close(a, b, **BWD)


@pytest.mark.parametrize("entry", ["rays", "full"])
def test_cpu_autograd_takes_the_plain_version(entry):
    """On CPU tensors that require grad, the dispatchers are plain autograd:
    the same gradients as `render_rays`/`render_full`, no kernel launched."""
    dens, colors, ts, te = map(t, _render_inputs(seed=13))
    launches = (render_cuda.render_fwd_cuda.launches, render_cuda.render_bwd_cuda.launches)
    grads = []
    for fn in ((trender.render_rays_auto, trender.render_rays) if entry == "rays"
               else (trender.render_full_auto, trender.render_full)):
        d, c = dens.clone().requires_grad_(True), colors.clone().requires_grad_(True)
        out = fn(d, c, te - ts) if entry == "rays" else fn(d, c, ts, te)
        out[0].square().sum().backward()
        grads.append((d.grad, c.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert (render_cuda.render_fwd_cuda.launches,
            render_cuda.render_bwd_cuda.launches) == launches
