"""The occupancy grid of the port (`nerf_experiments_tpu_torch/ops/occgrid.py`)
against the JAX package's `ops/occgrid.py` on the CPU: cell indices, the
gathered densities, the refresh, and the grid-guided bins, deterministic
and jittered; then properties of what cannot share a random stream.

Inputs come from numpy with a seed. threefry and Philox never agree, so the
jittered cases hand the port the JAX package's own uniforms (`u=`, drawn here
by the same key splits as the JAX function). Tolerances:
  * cell indices and gathered densities: exact (integer floor and a gather);
  * the refresh: rtol 1e-6 (the same fp32 operations; the density function is
    the same closed form in both) and atol 1e-8 (under lax.map XLA's exp of
    arguments near -80 is 4e-6 off in relative terms: densities of 1e-10,
    1e-9 of the grid's largest, which no PDF can see);
  * bins: compared in the coordinate of the resampling itself, the quantile
    of the coarse PDF that each t sits at (float64, `quantiles`): atol 1e-5.
    In t the same difference is the quantile's times the inverse CDF's slope,
    up to (bin width) / (floor bin mass) ~ 120 here: the two libraries' fp32
    cumsums of the PDF differ in their last bits (JAX's is a parallel scan on
    the CPU, torch's a running sum), so t itself is held to atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.ops import occgrid as jocc
from nerf_experiments_tpu.ops import sampling as jsampling
from nerf_experiments_tpu_torch.ops import occgrid as tocc

NEAR, FAR = 2.0, 6.0


def cfgs(**kw):
    d = dict(resolution=8, aabb_half=2.0, n_coarse=16, update_every=4)
    d.update(kw)
    return jocc.OccGridConfig(**d), tocc.OccGridConfig(**d)


def grid_values(cfg, seed):
    """A grid with empty, sparse and dense cells (densities 0 to 50)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 50.0, size=cfg.n_cells) * (rng.uniform(size=cfg.n_cells) < 0.3)
    return g.astype(np.float32)


def positions(n, seed, cell):
    """Points inside and outside the cube, on cell boundaries and corners."""
    rng = np.random.default_rng(seed)
    p = [rng.uniform(-3.0, 3.0, size=(n, 3)),
         rng.integers(-40, 41, size=(n, 3)) * cell,  # on boundaries (and outside)
         np.array([[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0], [0.0, 0.0, 0.0],
                   [1.9999, -1.9999, 0.0]])]
    return np.concatenate(p).astype(np.float32)


def rays(n, seed):
    """Rays from a sphere of radius 4 towards the region around the origin."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3)) * 0.4 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def blob_density_j(pos):
    return 30.0 * jnp.exp(-4.0 * jnp.sum((pos - 0.3) ** 2, axis=-1))


def blob_density_t(pos):
    return 30.0 * torch.exp(-4.0 * torch.sum((pos - 0.3) ** 2, dim=-1))


@pytest.mark.parametrize("resolution,aabb_half", [(8, 2.0), (16, 2.0), (12, 1.5)])
def test_cell_index_and_lookup_match_jax(resolution, aabb_half):
    """Exact: the same floor of the same fp32 quotient, the same clip, and
    the grid gathered after its cast to bf16."""
    jcfg, tcfg = cfgs(resolution=resolution, aabb_half=aabb_half)
    pos = positions(500, seed=resolution, cell=tcfg.cell)
    grid = grid_values(tcfg, seed=resolution + 1)
    want_idx = np.asarray(jocc.cell_index(jcfg, jnp.asarray(pos)))
    got_idx = tocc.cell_index(tcfg, torch.as_tensor(pos))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    want = np.asarray(jocc.lookup(jnp.asarray(grid), jcfg, jnp.asarray(pos)).astype(jnp.float32))
    got = tocc.lookup(torch.as_tensor(grid), tcfg, torch.as_tensor(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_init_grid_matches_jax():
    jcfg, tcfg = cfgs(init_sigma=0.7)
    got = tocc.init_grid(tcfg)
    assert got.dtype == torch.float32 and got.shape == (512,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jocc.init_grid(jcfg)))


@pytest.mark.parametrize("update_chunk", [2 ** 18, 128])
def test_update_grid_with_jax_jitter_matches_jax(update_chunk):
    """The refresh with the JAX package's jitter draw: rtol 1e-6, atol 1e-8.
    With a chunk of 128 rows the JAX function evaluates through lax.map and
    the port in its loop of chunks."""
    jcfg, tcfg = cfgs(decay=0.9, update_chunk=update_chunk)
    grid = grid_values(tcfg, seed=3)
    key = jax.random.PRNGKey(5)
    want = jocc.update_grid(jnp.asarray(grid), jcfg, blob_density_j, key)
    u = np.array(jax.random.uniform(key, (tcfg.n_cells, 3)))
    got = tocc.update_grid(torch.as_tensor(grid), tcfg, blob_density_t, u=torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-8)


def test_maybe_update_refreshes_on_its_cadence():
    """Every `update_every` steps, step 0 included; the grid as it is
    otherwise (the same object: nothing is computed)."""
    _, tcfg = cfgs(update_every=3)
    grid = torch.zeros(tcfg.n_cells)
    gen = torch.Generator().manual_seed(0)
    for step in range(7):
        out = tocc.maybe_update(grid, tcfg, step, blob_density_t, gen)
        assert (out is grid) == (step % 3 != 0), step
        if step % 3 == 0:
            assert float(out.max()) > 1.0


def jax_coarse_pdf(jcfg, grid, o, d, key, strategy):
    """(coarse bin edges (N, K+1), weights (N, K)) of `jocc.sample_intervals`,
    by its own steps, as float64."""
    k_coarse = jax.random.split(key)[0] if key is not None else None
    if strategy != "stratified_uniform":
        k_coarse = None
    ts, te = jsampling.sample_stratified(k_coarse, o.shape[0], jcfg.n_coarse, NEAR, FAR,
                                         strategy if k_coarse is not None else "equidistant")
    pos = jnp.asarray(o)[:, None] + (0.5 * (ts + te))[..., None] * jnp.asarray(d)[:, None]
    sigma = jocc.lookup(jnp.asarray(grid), jcfg, pos).astype(jnp.float32)
    w = 1.0 - jnp.exp(-sigma * (te - ts)) + jcfg.pdf_floor
    edges = np.concatenate([np.asarray(ts), np.asarray(te)[:, -1:]], axis=1)
    return edges.astype(np.float64), np.asarray(w, np.float64) + 1e-8


def quantiles(t, edges, w):
    """The quantile of the piecewise-constant PDF w over `edges` at each t
    (N, S), in float64: the inverse of the resampling's map from quantiles."""
    t = np.asarray(t, np.float64)
    pdf = w / w.sum(-1, keepdims=True)
    cdf = np.concatenate([np.zeros_like(pdf[:, :1]), np.cumsum(pdf, -1)], axis=1)
    b = np.stack([np.clip(np.searchsorted(e, r, side="right") - 1, 0, w.shape[1] - 1)
                  for e, r in zip(edges, t)])
    take = lambda a: np.take_along_axis(a, b, axis=1)  # noqa: E731
    return take(cdf) + (t - take(edges[:, :-1])) / (take(edges[:, 1:]) - take(edges[:, :-1])) \
        * take(pdf)


def assert_bins_close(got, want, edges, w):
    """Start bins by their quantiles (atol 1e-5) and in t (atol 1e-4); ends
    in t (each is the next start or `far`)."""
    np.testing.assert_allclose(quantiles(got[0].numpy(), edges, w),
                               quantiles(np.asarray(want[0]), edges, w), rtol=0.0, atol=1e-5)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=0.0, atol=1e-4)


@pytest.mark.parametrize("n_samples", [8, 32])
def test_deterministic_sample_intervals_match_jax(n_samples):
    jcfg, tcfg = cfgs()
    grid = grid_values(tcfg, seed=7)
    o, d = rays(48, seed=8)
    want = jocc.sample_intervals(jnp.asarray(grid), jcfg, jnp.asarray(o), jnp.asarray(d),
                                 NEAR, FAR, n_samples, key=None)
    got = tocc.sample_intervals(torch.as_tensor(grid), tcfg, torch.as_tensor(o),
                                torch.as_tensor(d), NEAR, FAR, n_samples)
    assert_bins_close(got, want, *jax_coarse_pdf(jcfg, grid, o, d, None, "equidistant"))


def jax_occ_uniforms(key, n_rays, n_coarse, n_samples, strategy):
    """The uniforms `jocc.sample_intervals(..., key, strategy)` draws: the
    coarse bins' (N, K) from the second half of a split of the first key of
    the split (under "stratified_uniform"), the resampling's (N, S) from the
    second key."""
    k_coarse, k_pdf = jax.random.split(key)
    u_coarse = None
    if strategy == "stratified_uniform":
        u_coarse = torch.as_tensor(np.array(
            jax.random.uniform(jax.random.split(k_coarse)[1], (n_rays, n_coarse))))
    return u_coarse, torch.as_tensor(np.array(jax.random.uniform(k_pdf, (n_rays, n_samples))))


@pytest.mark.parametrize("strategy", ["equidistant", "stratified_uniform"])
def test_stratified_sample_intervals_with_jax_uniforms_match_jax(strategy):
    """Training bins: the resampling jittered (always, even under
    "equidistant"), the coarse bins too under "stratified_uniform"; the port
    takes the JAX package's draws."""
    jcfg, tcfg = cfgs(n_coarse=24)
    grid = grid_values(tcfg, seed=9)
    o, d = rays(40, seed=10)
    key = jax.random.PRNGKey(11)
    want = jocc.sample_intervals(jnp.asarray(grid), jcfg, jnp.asarray(o), jnp.asarray(d),
                                 NEAR, FAR, 16, key=key, strategy=strategy)
    u_coarse, u = jax_occ_uniforms(key, 40, 24, 16, strategy)
    got = tocc.sample_intervals(torch.as_tensor(grid), tcfg, torch.as_tensor(o),
                                torch.as_tensor(d), NEAR, FAR, 16, strategy=strategy,
                                u=u, u_coarse=u_coarse)
    assert_bins_close(got, want, *jax_coarse_pdf(jcfg, grid, o, d, key, strategy))
    # and the deterministic bins differ from them: the jitter is applied
    det = tocc.sample_intervals(torch.as_tensor(grid), tcfg, torch.as_tensor(o),
                                torch.as_tensor(d), NEAR, FAR, 16, strategy=strategy)
    assert not torch.allclose(det[0], got[0])


def test_sample_intervals_from_a_generator_concentrate_in_occupied_cells():
    """With the port's own stream (no JAX draws to share): a slab z in [0, 1]
    imprinted by a refresh into an empty grid takes > 85 % of the bins of rays
    along +z (uniform bins would put a third there); the bins are sorted,
    inside [near, far], carry no gradient, and two generators with one seed
    give the same bins."""
    _, tcfg = cfgs(resolution=32, n_coarse=32)

    def slab(pos):
        return torch.where((pos[..., 2] > 0.0) & (pos[..., 2] < 1.0), 100.0, 0.0)

    grid = tocc.update_grid(torch.zeros(tcfg.n_cells), tcfg, slab,
                            torch.Generator().manual_seed(0))
    n = 64
    o = torch.tensor([[0.0, 0.0, -2.0]]).expand(n, 3).requires_grad_(True)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    bins = [tocc.sample_intervals(grid, tcfg, o, d, 0.5, 3.5, 32,
                                  generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    ts, te = bins[0]
    assert torch.equal(ts, bins[1][0]) and torch.equal(te, bins[1][1])
    assert not ts.requires_grad and not te.requires_grad
    mid = 0.5 * (ts + te)
    assert float(((mid > 2.0) & (mid < 3.0)).float().mean()) > 0.85
    assert bool((torch.diff(ts, dim=1) >= 0).all()) and bool((ts >= 0.5).all())
    assert bool((te <= 3.5).all()) and bool((te[:, -1] == 3.5).all())
