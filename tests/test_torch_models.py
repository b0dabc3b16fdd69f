"""Parity of the port's encodings, NerfMLP and flagship render with the JAX
package on the CPU, on weights converted from the JAX pytree.

`flagship_render` on a CPU tensor is its plain version
(`flagship_render_reference`); it is held both to the JAX plain path
(`_eval_model` + `render_full`, the oracle of `tests/test_train_megakernel.py`)
and to the JAX Pallas kernel `_render_kernel` in interpret mode.
Tolerances: fp32 rtol=1e-5, atol=1e-6 (a chain of matmuls: rtol=1e-4 where
stated); bf16 atol=2e-2 (both round every matmul operand to bf16; the JAX
kernel keeps density and colour logits fp32 where the plain path rounds them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.encodings import fourier as jfourier
from nerf_experiments_tpu.models import nerf_mlp as jmlp
from nerf_experiments_tpu.ops import render as jrender
from nerf_experiments_tpu.ops import sampling as jsampling
from nerf_experiments_tpu.ops.train_megakernel import flagship_render as jflagship_render
from nerf_experiments_tpu.systems.barf import NerfMLPDef, _eval_model
from nerf_experiments_tpu_torch.encodings import fourier as tfourier
from nerf_experiments_tpu_torch.models import common as tcommon
from nerf_experiments_tpu_torch.models import nerf_mlp as tmlp
from nerf_experiments_tpu_torch.ops import train_megakernel as tmega

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=0.0, atol=2e-2)


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref, np.float32),
                               **(tol or FP32))


def configs(n_hidden=2, hidden_dim=32, lv_pos=4, lv_dir=2, bf16=False, n_segments=2,
            include_identity=True):
    """The same NerfMLP config in both packages."""
    enc = dict(scale=1.0, include_identity=include_identity)
    j = jmlp.NerfMLPConfig(
        position_encoder=jfourier.Barf(levels=lv_pos, **enc),
        direction_encoder=jfourier.Barf(levels=lv_dir, **enc),
        n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=n_segments,
        compute_dtype=jnp.bfloat16 if bf16 else None)
    t = tmlp.NerfMLPConfig(
        position_encoder=tfourier.Barf(levels=lv_pos, **enc),
        direction_encoder=tfourier.Barf(levels=lv_dir, **enc),
        n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=n_segments,
        compute_dtype=torch.bfloat16 if bf16 else None)
    return j, t


def params_pair(jcfg, tcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init(jax.random.PRNGKey(seed), jcfg))
    return tree, tmlp.from_numpy(tree, tcfg)


def rays(n, s, seed=1):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    ts, te = jsampling.sample_stratified(None, n, s, 2.0, 6.0, "equidistant", 0.0)
    return o, d, np.asarray(ts), np.asarray(te)


@pytest.mark.parametrize("alpha", [0.0, 2.3, 4.0, None])
@pytest.mark.parametrize("identity", [True, False])
def test_barf_encoding_matches_jax(alpha, identity):
    x = np.random.default_rng(2).normal(size=(10, 3)).astype(np.float32) * 3.0
    je = jfourier.Barf(levels=4, scale=1.0, include_identity=identity)
    te = tfourier.Barf(levels=4, scale=1.0, include_identity=identity)
    assert te.output_dim == je.output_dim
    got = te(torch.as_tensor(x), alpha=alpha)
    close(got, je(jnp.asarray(x), alpha=None if alpha is None else jnp.asarray(alpha)))
    assert got.shape == (10, te.output_dim)


def test_fourier_identity_and_alpha_schedule_match_jax():
    x = np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)
    close(tfourier.Fourier(levels=3)(torch.as_tensor(x)),
          jfourier.Fourier(levels=3)(jnp.asarray(x)))
    close(tfourier.Identity()(torch.as_tensor(x)), x)
    for epoch in (0.0, 0.3, 0.75, 2.0):
        assert tfourier.barf_alpha_schedule(epoch, 10, 0.0, 0.2, 1.0) == pytest.approx(
            float(jfourier.barf_alpha_schedule(jnp.asarray(epoch), 10, 0.0, 0.2, 1.0)),
            rel=1e-6)


def test_converter_round_trip_and_names():
    jcfg, tcfg = configs()
    tree, mod = params_pair(jcfg, tcfg)
    back = tmlp.to_numpy(mod)
    flat_a = jax.tree_util.tree_leaves(tree)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    names = set(dict(mod.named_parameters()))
    assert "segments.1.layers.2.w" in names and "color.1.b" in names


def test_init_shapes_and_bounds_match_jax():
    jcfg, tcfg = configs(n_hidden=3, hidden_dim=16)
    mod = tmlp.init(torch.Generator().manual_seed(0), tcfg)
    tree = jmlp.init(jax.random.PRNGKey(0), jcfg)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(tmlp.to_numpy(mod))):
        assert a.shape == b.shape
    for layer in mod.color:
        bound = 1.0 / np.sqrt(layer.w.shape[0])
        assert layer.w.abs().max() <= bound and layer.b.abs().max() <= bound
    again = tmlp.init(torch.Generator().manual_seed(0), tcfg)
    assert torch.equal(again.color[0].w, mod.color[0].w)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("arch", ["flagship", "proposal", "naive"])
def test_nerf_mlp_apply_matches_jax(bf16, arch):
    kw = {"flagship": {}, "proposal": dict(n_segments=1, n_hidden=1),
          "naive": dict(n_segments=3)}[arch]
    jcfg, tcfg = configs(bf16=bf16, **kw)
    if arch == "naive":
        jcfg = jcfg.__class__(**{**jcfg.__dict__, "delayed_direction": False,
                                 "delayed_density": True})
        tcfg = tcfg.__class__(**{**tcfg.__dict__, "delayed_direction": False,
                                 "delayed_density": True})
    tree, mod = params_pair(jcfg, tcfg)
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(40, 3)).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    dens_t, rgb_t = tmlp.apply(mod, tcfg, torch.as_tensor(pos), torch.as_tensor(d),
                               alpha_pos=2.5, alpha_dir=1.5)
    dens_j, rgb_j = jmlp.apply(tree, jcfg, jnp.asarray(pos), jnp.asarray(d),
                               alpha_pos=jnp.asarray(2.5), alpha_dir=jnp.asarray(1.5))
    tol = BF16 if bf16 else dict(rtol=1e-4, atol=1e-5)
    close(dens_t, dens_j, **tol)
    close(rgb_t, rgb_j, **tol)


@pytest.mark.parametrize("n_hidden", [1, 2])
def test_flagship_render_matches_jax_plain_path(n_hidden):
    jcfg, tcfg = configs(n_hidden=n_hidden)
    tree, mod = params_pair(jcfg, tcfg)
    o, d, ts, te = rays(8, 16)
    got = tmega.flagship_render(mod, tcfg, *map(torch.as_tensor, (o, d, ts, te)),
                                2.5, 1.25, return_weights=True)
    dens, rgb_s = _eval_model(NerfMLPDef(jcfg), tree, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(ts), jnp.asarray(te), jnp.full((8, 1), 1e-3),
                              jnp.asarray(2.5), jnp.asarray(1.25), "middle")
    rgb, opac, depth, extras = jrender.render_full(dens, rgb_s, jnp.asarray(ts), jnp.asarray(te))
    for a, b in zip(got, (rgb, opac, depth, extras["weights"])):
        close(a, b)


@pytest.mark.parametrize("bf16", [False, True])
def test_flagship_render_matches_jax_pallas_kernel(bf16):
    jcfg, tcfg = configs(n_hidden=1, hidden_dim=32, bf16=bf16)
    tree, mod = params_pair(jcfg, tcfg)
    o, d, ts, te = rays(8, 8)
    got = tmega.flagship_render(mod, tcfg, *map(torch.as_tensor, (o, d, ts, te)),
                                3.0, 1.5, return_weights=True)
    ref = jflagship_render(tree, jcfg, *map(jnp.asarray, (o, d, ts, te)),
                           jnp.asarray(3.0), jnp.asarray(1.5), tile_rays=4,
                           interpret=True, return_weights=True)
    for a, b in zip(got, ref):
        close(a, b, **(BF16 if bf16 else FP32))


def test_flagship_render_ragged_ray_count_matches_jax_padding():
    """7 rays: the JAX wrapper pads to its tile, the port needs no padding."""
    jcfg, tcfg = configs(n_hidden=1)
    tree, mod = params_pair(jcfg, tcfg)
    o, d, ts, te = rays(7, 8, seed=5)
    got = tmega.flagship_render(mod, tcfg, *map(torch.as_tensor, (o, d, ts, te)), 2.0, 2.0)
    ref = jflagship_render(tree, jcfg, *map(jnp.asarray, (o, d, ts, te)),
                           jnp.asarray(2.0), jnp.asarray(2.0), tile_rays=4, interpret=True)
    assert got[0].shape == (7, 3)
    for a, b in zip(got, ref):
        close(a, b)


def test_flagship_render_cpu_launches_nothing_and_rejects_other_configs():
    jcfg, tcfg = configs(include_identity=False)
    _, mod = params_pair(*configs())
    o, d, ts, te = map(torch.as_tensor, rays(4, 8))
    with pytest.raises(ValueError):
        tmega.flagship_render(mod, tcfg, o, d, ts, te)
    before = tmega.flagship_render.launches
    tmega.flagship_render(mod, configs()[1], o, d, ts, te)
    assert tmega.flagship_render.launches == before


def test_softplus8_matches_jax():
    from nerf_experiments_tpu.models.common import softplus8

    x = np.linspace(-30, 30, 121).astype(np.float32)
    close(tcommon.softplus8(torch.as_tensor(x)), softplus8(jnp.asarray(x)))
