"""The port's hash grid and Instant-NGP models against the JAX package on the
CPU: the grid config, the xor and additive row indices (exact), the
encoding's forward against every JAX encoder, its table and coordinate
gradients against `jax.grad` (with points on grid vertices and at 0, where
the two frameworks' abs gradients differ), the JAX Pallas level kernels (K7
and K8, interpret mode) against the port's plain row fetch and scatter-add,
and the INGP models with carried weights.

Inputs are made with numpy from a seed; tables are drawn N(0, 1) or U(-0.1,
0.1) so that errors are not hidden by the init's 1e-4 scale. Tolerances:
  * indices: exact;
  * forward: atol 1e-6 fp32 (summation order), 2e-6 with bf16 rows (both
    round the same rows to bf16);
  * gradients: d_table atol 2e-5 / rtol 1e-4, d_x atol 2e-4 / rtol 1e-3 (as
    `tests/test_hashgrid_pallas.py` holds the JAX encoders to each other);
  * Pallas level kernels: rtol / atol 1e-6 (fetch), 1e-5 (scatter-add);
  * models: fp32 rtol 1e-5 / atol 1e-6, bf16 atol 2e-2 (both round every
    matmul operand to bf16; products are accumulated in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.encodings.fourier import Fourier as JFourier
from nerf_experiments_tpu.models import ingp as jingp
from nerf_experiments_tpu.ops import hashgrid as jhash
from nerf_experiments_tpu_torch.encodings.fourier import Fourier as TFourier
from nerf_experiments_tpu_torch.models import ingp as tingp
from nerf_experiments_tpu_torch.ops import hashgrid as thash

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=0.0, atol=2e-2)


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **tol)


def cfgs(dim, **kw):
    return jhash.HashGridConfig(dim=dim, **kw), thash.HashGridConfig(dim=dim, **kw)


# small grids with bijective (low) and hashed (high) levels; power-of-two T
SMALL = {2: dict(n_levels=5, table_size=512, resolution_min=4, resolution_max=64),
         3: dict(n_levels=6, table_size=2048, resolution_min=4, resolution_max=64)}


def points(dim, n, seed, resolutions):
    """Random points in [0, 1), points on a vertex of every level's grid,
    and the origin."""
    rng = np.random.default_rng(seed)
    x = [rng.uniform(0.0, 1.0, size=(n, dim))]
    for res in resolutions:
        x.append(rng.integers(0, res, size=(3, dim)) / res)
    x.append(np.zeros((1, dim)))
    x.append(np.full((1, dim), 0.5))
    return np.concatenate(x).astype(np.float32)


def table(cfg, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(cfg.n_levels, cfg.table_size, cfg.n_features))
            * scale).astype(np.float32)


# ---------------------------------------------------------------- config and indices


@pytest.mark.parametrize("dim,kw", [(2, dict(resolution_max=2048)), (3, dict())])
def test_hashgrid_config_matches_jax(dim, kw):
    """run_2d_ingp's and run_3d_ingp's default grids."""
    jcfg, tcfg = cfgs(dim, **kw)
    assert tcfg.level_resolutions == jcfg.level_resolutions
    assert tcfg.output_dim == jcfg.output_dim == 32
    for res in jcfg.level_resolutions:
        assert tcfg.bijective(res) == jcfg.bijective(res)
        assert thash._effective_rows(tcfg, res) == jhash._effective_rows(jcfg, res)
    assert any(jcfg.bijective(r) for r in jcfg.level_resolutions)
    assert not all(jcfg.bijective(r) for r in jcfg.level_resolutions)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("hash", ["xor", "additive"])
def test_row_indices_match_jax_exactly(dim, hash):
    """Every corner of random cells (and the last cell) up to res 2048, on a
    bijective and a hashed level."""
    rng = np.random.default_rng(dim)
    jcfg, tcfg = cfgs(dim, table_size=2**16)
    offsets = np.asarray(jhash._corner_offsets(dim))
    assert np.array_equal(thash._corner_offsets(dim).numpy(), offsets)
    for res in (16, 37, 2048):
        lo = np.concatenate([rng.integers(0, res, size=(200, dim)), np.full((1, dim), res)])
        lo = lo.astype(np.int32)
        if hash == "xor":
            corners = lo[:, None, :] + offsets[None]
            want = np.asarray(jhash._level_indices(jnp.asarray(corners), res, jcfg))
            got = thash._level_indices(torch.as_tensor(corners).long(), res, tcfg)
            assert np.array_equal(got.numpy(), want)
        else:
            jbase, jdeltas = jhash._rolled_level_base_and_deltas(jcfg, res, jnp.asarray(lo))
            base, deltas = thash._rolled_level_base_and_deltas(tcfg, res,
                                                               torch.as_tensor(lo).long())
            assert np.array_equal(base.numpy(), np.asarray(jbase)) and deltas == jdeltas


# ---------------------------------------------------------------- encoding forward


def jax_encode(variant, params, cfg, x):
    if variant == "encode":
        return jhash.encode(params, cfg, x)
    if variant == "fused":
        return jhash.encode_fused(params, cfg, x)
    if variant == "fused_bf16":
        return jhash.encode_fused(params, cfg, x, gather_dtype=jnp.bfloat16)
    if variant == "matmul":
        return jhash.encode_matmul(params, cfg, x, compute_dtype=jnp.float32, chunk=128)
    return jhash.encode_rolled(params, cfg, x, compute_dtype=None)


PORT_ARGS = {"encode": ("xor", None), "fused": ("xor", None),
             "fused_bf16": ("xor", torch.bfloat16), "matmul": ("xor", None),
             "rolled": ("additive", None)}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("variant", sorted(PORT_ARGS))
def test_encode_matches_every_jax_encoder(dim, variant):
    jcfg, tcfg = cfgs(dim, **SMALL[dim])
    tbl = table(jcfg, seed=dim)
    x = points(dim, 300, seed=10 + dim, resolutions=jcfg.level_resolutions)
    want = jax_encode(variant, {"table": jnp.asarray(tbl)}, jcfg, jnp.asarray(x))
    hash, gather_dtype = PORT_ARGS[variant]
    got = thash.encode(thash.HashGrid(torch.as_tensor(tbl)), tcfg, torch.as_tensor(x), hash,
                       gather_dtype)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], tcfg.output_dim)
    close(got, want, rtol=0.0, atol=2e-6 if gather_dtype is not None else 1e-6)


def test_additive_hash_needs_a_power_of_two_table():
    _, tcfg = cfgs(2, n_levels=2, table_size=600, resolution_min=4, resolution_max=64)
    grid = thash.init(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="power-of-two"):
        thash.encode(grid, tcfg, torch.rand(4, 2), "additive")
    assert thash.encode(grid, tcfg, torch.rand(4, 2), "xor").shape == (4, 4)


def test_init_matches_jax_distribution():
    _, tcfg = cfgs(3, **SMALL[3])
    t = thash.init(torch.Generator().manual_seed(0), tcfg).table.detach()
    assert t.shape == (6, 2048, 2) and float(t.abs().max()) <= 1e-4
    assert 0.4e-4 < float(t.abs().mean()) < 0.6e-4


# ---------------------------------------------------------------- encoding gradients


GRAD_VARIANTS = {"encode": ("xor", None), "fused_bf16": ("xor", torch.bfloat16),
                 "rolled": ("additive", None)}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("variant", sorted(GRAD_VARIANTS))
def test_table_and_coordinate_grads_match_jax(dim, variant):
    """d_table and d_x of sum(sin(3 enc)) against `jax.grad`, with points on
    grid vertices and at 0, where d|u|/du must be +1 as in JAX (torch's abs
    gives 0 there: this test pins the convention)."""
    jcfg, tcfg = cfgs(dim, **SMALL[dim])
    tbl = table(jcfg, seed=20 + dim)
    x = points(dim, 200, seed=30 + dim, resolutions=jcfg.level_resolutions)

    def loss(tb, xx):
        return jnp.sum(jnp.sin(3.0 * jax_encode(variant, {"table": tb}, jcfg, xx)))

    want_t, want_x = jax.grad(loss, argnums=(0, 1))(jnp.asarray(tbl), jnp.asarray(x))
    grid = thash.HashGrid(torch.as_tensor(tbl))
    xt = torch.as_tensor(x).requires_grad_(True)
    hash, gather_dtype = GRAD_VARIANTS[variant]
    torch.sum(torch.sin(3.0 * thash.encode(grid, tcfg, xt, hash, gather_dtype))).backward()
    close(grid.table.grad, want_t, atol=2e-5, rtol=1e-4)
    close(xt.grad, want_x, atol=2e-4, rtol=1e-3)


def test_bf16_rows_leave_the_table_gradient_fp32():
    """The plain bf16 path rounds the gathered rows and nothing else: for a
    loss linear in the encoding, d_table (the scatter of weight x cotangent)
    is the fp32 path's bit for bit, while the forward and d_x see the rounded
    rows."""
    _, tcfg = cfgs(3, **SMALL[3])
    x = torch.as_tensor(points(3, 100, seed=6, resolutions=tcfg.level_resolutions))
    g = torch.randn((x.shape[0], tcfg.output_dim), generator=torch.Generator().manual_seed(7))
    out = {}
    for gather_dtype in (None, torch.bfloat16):
        grid = thash.HashGrid(torch.as_tensor(table(tcfg, seed=5)))
        xr = x.clone().requires_grad_(True)
        enc = thash.encode(grid, tcfg, xr, "xor", gather_dtype)
        torch.sum(enc * g).backward()
        out[gather_dtype] = (enc.detach(), grid.table.grad, xr.grad)
    assert out[torch.bfloat16][1].dtype == torch.float32
    assert torch.equal(out[torch.bfloat16][1], out[None][1])
    assert not torch.equal(out[torch.bfloat16][0], out[None][0])
    assert not torch.equal(out[torch.bfloat16][2], out[None][2])


# ---------------------------------------------------------------- the JAX Pallas kernels


def test_jax_row_fetch_kernel_matches_plain_row_fetch():
    """K7 (`level_matmul_fwd_pallas`, interpret mode) against the port's plain
    per-level row fetch, R not a multiple of the tile."""
    from nerf_experiments_tpu.ops import hashgrid_pallas

    t_eff, n_hi, n_lo, F, R = 600, 8, 128, 2, 1000
    rng = np.random.default_rng(2)
    table_l = rng.normal(size=(1024, F)).astype(np.float32)
    idx = rng.integers(0, t_eff, size=R).astype(np.int32)
    want = hashgrid_pallas.level_matmul_fwd_pallas(
        jnp.asarray(table_l), jnp.asarray(idx), t_eff, n_hi, n_lo,
        compute_dtype=jnp.float32, interpret=True)
    got = thash._gather(torch.as_tensor(table_l), torch.as_tensor(idx).long()[:, None], None)
    close(got[:, 0], want, rtol=1e-6, atol=1e-6)


def test_jax_table_gradient_kernel_matches_plain_scatter_add():
    """K8 (`level_matmul_dtable_pallas`, interpret mode) against the port's
    plain table gradient: autograd's scatter-add through the row fetch."""
    from nerf_experiments_tpu.ops import hashgrid_pallas

    t_eff, n_hi, n_lo, F, R = 600, 8, 128, 2, 1000
    rng = np.random.default_rng(3)
    idx = rng.integers(0, t_eff, size=R).astype(np.int32)
    contrib = rng.normal(size=(R, F)).astype(np.float32)
    want = hashgrid_pallas.level_matmul_dtable_pallas(
        jnp.asarray(idx), jnp.asarray(contrib), t_eff, 1024, n_hi, n_lo,
        compute_dtype=jnp.float32, interpret=True)
    table_l = torch.zeros((1024, F), requires_grad=True)
    rows = torch.as_tensor(idx).long()[:, None]
    got, = torch.autograd.grad(thash._gather(table_l, rows, None), table_l,
                               torch.as_tensor(contrib)[:, None])
    close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- models


def ingp_cfgs(bf16=False, encoder="fused", n_hidden=2, hidden_dim=32):
    kw = dict(n_levels=4, table_size=1024, resolution_min=4, resolution_max=32)
    jgrid, tgrid = cfgs(3, **kw)
    common = dict(n_hidden=n_hidden, hidden_dim=hidden_dim, encoder=encoder)
    return (jingp.NerfINGPConfig(grid=jgrid, direction_encoder=JFourier(levels=4, scale=1.0),
                                 compute_dtype=jnp.bfloat16 if bf16 else None, **common),
            tingp.NerfINGPConfig(grid=tgrid, direction_encoder=TFourier(levels=4, scale=1.0),
                                 compute_dtype=torch.bfloat16 if bf16 else None, **common))


def carried(tree, seed):
    """The JAX init with its table redrawn U(-0.1, 0.1), as numpy."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tbl = tree["grid"]["table"]
    tree["grid"]["table"] = np.random.default_rng(seed).uniform(
        -0.1, 0.1, size=tbl.shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("encoder", ["fused", "rolled"])
def test_nerf_ingp_apply_matches_jax(bf16, encoder):
    jcfg, tcfg = ingp_cfgs(bf16, encoder)
    tree = carried(jingp.nerf_ingp_init(jax.random.PRNGKey(0), jcfg), seed=1)
    rng = np.random.default_rng(2)
    pos = (rng.normal(size=(200, 3)) * 3.0).astype(np.float32)  # some clipped
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = jingp.nerf_ingp_apply(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                 jnp.asarray(pos), jnp.asarray(dirs))
    params = tingp.nerf_ingp_from_numpy(tree)
    got = tingp.nerf_ingp_apply(params, tcfg, torch.as_tensor(pos), torch.as_tensor(dirs))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        close(g, np.asarray(w, np.float32), **(BF16 if bf16 else FP32))
    back = tingp.nerf_ingp_to_numpy(params)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, tree))


@pytest.mark.parametrize("bf16", [False, True])
def test_gigapixel_apply_matches_jax(bf16):
    kw = dict(n_levels=4, table_size=512, resolution_min=4, resolution_max=64)
    jgrid, tgrid = cfgs(2, **kw)
    jcfg = jingp.GigapixelConfig(grid=jgrid, n_hidden=1, hidden_dim=32,
                                 compute_dtype=jnp.bfloat16 if bf16 else None)
    tcfg = tingp.GigapixelConfig(grid=tgrid, n_hidden=1, hidden_dim=32,
                                 compute_dtype=torch.bfloat16 if bf16 else None)
    tree = carried(jingp.gigapixel_init(jax.random.PRNGKey(3), jcfg), seed=4)
    x = points(2, 200, seed=5, resolutions=jgrid.level_resolutions)
    want = jingp.gigapixel_apply(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(x))
    params = tingp.gigapixel_from_numpy(tree)
    got = tingp.gigapixel_apply(params, tcfg, torch.as_tensor(x))
    close(got, np.asarray(want, np.float32), **(BF16 if bf16 else FP32))
    back = tingp.gigapixel_to_numpy(params)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, tree))


def test_model_init_shapes_match_jax():
    jcfg, tcfg = ingp_cfgs()
    jtree = jingp.nerf_ingp_init(jax.random.PRNGKey(0), jcfg)
    want = {k: np.shape(v) for k, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = tingp.nerf_ingp_to_numpy(tingp.nerf_ingp_init(torch.Generator().manual_seed(0), tcfg))
    assert {k: np.shape(v) for k, v in jax.tree_util.tree_flatten_with_path(got)[0]} == want
