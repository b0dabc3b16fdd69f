"""The port's GARF modules against the JAX package on the CPU: the activation
family (forward and gradient), the radiance and proposal nets in fp32 and
bf16, the proposal estimator and interlevel loss, the GARF render kernel's
plain version (against the JAX kernel in interpret mode and against the XLA
path) and the system forward.

Inputs come from numpy with a seed; weights cross with `garf.from_numpy`;
TF32 is off. Each tolerance is stated where it is used."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.encodings import activations as jact
from nerf_experiments_tpu.models import garf as jgarf
from nerf_experiments_tpu.ops import garf_megakernel as jgm
from nerf_experiments_tpu.ops import proposal as jproposal
from nerf_experiments_tpu.ops import render as jrender
from nerf_experiments_tpu.ops import sampling as jsampling
from nerf_experiments_tpu.systems import garf_system as jsys
from nerf_experiments_tpu_torch.encodings import activations as tact
from nerf_experiments_tpu_torch.models import garf as tgarf
from nerf_experiments_tpu_torch.ops import garf_megakernel as tgm
from nerf_experiments_tpu_torch.ops import proposal as tproposal
from nerf_experiments_tpu_torch.ops import sampling as tsampling
from nerf_experiments_tpu_torch.systems import garf_system as tsys

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FAMILIES = [("gauss", 1.0), ("gabor", 1.0), ("gabor", 0.37), ("sarf", 1.0), ("sarf", 0.37)]


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach().float() if torch.is_tensor(port)
                                          else port),
                               np.asarray(jnp.asarray(ref, jnp.float32)), **tol)


def cfgs(activation, bf16=False):
    """The same GarfConfig in both packages (garf_main's init ranges)."""
    lo = 0.0 if activation == "gabor" else 0.5
    kw = dict(activation=activation, init_min=lo, init_max=2.0)
    return (jgarf.GarfConfig(compute_dtype=jnp.bfloat16 if bf16 else None, **kw),
            tgarf.GarfConfig(compute_dtype=torch.bfloat16 if bf16 else None, **kw))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def radiance_pair(activation, bf16=False, seed=0):
    jcfg, tcfg = cfgs(activation, bf16)
    tree = numpy_tree(jgarf.radiance_init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, tree, tgarf.from_numpy(tree, tcfg)


def rays(n, seed):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (rng.normal(size=(n, 3)) * 0.3).astype(np.float32), dirs.astype(np.float32)


def lindisp_bins(n, s, near=2.0, far=6.0):
    edges = np.asarray(jsampling.lindisp_edges(n, s, near, far, stratified=False))
    return edges[:, :-1].copy(), edges[:, 1:].copy()


# ---------------------------------------------------------------- activations


@pytest.mark.parametrize("activation,anneal", FAMILIES)
def test_activation_and_gradient_match_jax(activation, anneal):
    """Forward and the gradient of <g, act(x)> in x and the parameters
    (the Gauss / Gabor custom VJPs vs the autograd Functions): 1e-6 / 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 8)).astype(np.float32) * 1.5
    x[0, :3] = [0.0, -0.0, 1e-5]  # the sign-safe shift's corner
    p1 = rng.uniform(0.5, 2.0, size=8).astype(np.float32)
    p2 = rng.uniform(0.0, 6.0, size=8).astype(np.float32)
    g = rng.normal(size=(6, 8)).astype(np.float32)

    def jfn(x, p1, p2):
        if activation == "gauss":
            return jact.gauss_from_isd(x, p1)
        if activation == "gabor":
            return jact.gabor_from_isd(x, p1, p2, anneal)
        return jact.sarf_act(x, p1, anneal)

    def tfn(x, p1, p2):
        if activation == "gauss":
            return tact.gauss_from_isd(x, p1)
        if activation == "gabor":
            return tact.gabor_from_isd(x, p1, p2, anneal)
        return tact.sarf_act(x, p1, anneal)

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, p1, p2)))
    want_grads = vjp(jnp.asarray(g))
    tx, t1, t2 = (torch.tensor(v, requires_grad=True) for v in (x, p1, p2))
    got = tfn(tx, t1, t2)
    close(got, want, rtol=1e-6, atol=1e-7)
    got_grads = torch.autograd.grad(got, (tx, t1, t2), torch.as_tensor(g), allow_unused=True)
    for name, a, b in zip(("x", "p1", "p2"), got_grads, want_grads):
        if a is None:
            assert not np.any(np.asarray(b)), name
        else:
            close(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


def test_sign_safe_and_sinc_match_jax():
    x = np.array([-2.0, -0.0, 0.0, 1e-6, 0.3, 4.0], np.float32)
    f = np.float32(1.7)
    close(tact._sign_safe(torch.as_tensor(x)), jact._sign_safe(jnp.asarray(x)), rtol=0, atol=0)
    close(tact.sarf_sinc_act(torch.as_tensor(x), torch.tensor(f)),
          jact.sarf_sinc_act(jnp.asarray(x), f), rtol=1e-6)


# ---------------------------------------------------------------- networks


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("activation", ["gauss", "gabor", "sarf"])
def test_radiance_apply_matches_jax(activation, bf16):
    """(rgb, density) at the fixed GARF width: fp32 1e-5; bf16 2e-2 (both
    round the same operands; the sums run in another order, and a one-ulp
    bf16 difference in a layer output moves the next layer)."""
    jcfg, tcfg, tree, params = radiance_pair(activation, bf16)
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(32, 3)).astype(np.float32)
    dirs = rng.normal(size=(32, 3)).astype(np.float32)
    for anneal in (1.0, 0.37):
        want = jgarf.radiance_apply(jax_tree(tree), jcfg, jnp.asarray(pos), jnp.asarray(dirs),
                                    anneal)
        got = tgarf.radiance_apply(params, tcfg, torch.as_tensor(pos), torch.as_tensor(dirs),
                                   anneal)
        tol = dict(rtol=0, atol=2e-2) if bf16 else dict(rtol=1e-5, atol=1e-5)
        close(got[0], want[0], **tol)
        close(got[1], want[1], **tol)
        assert got[0].dtype == got[1].dtype == torch.float32


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("activation", ["gauss", "gabor", "sarf"])
def test_proposal_apply_matches_jax(activation, bf16):
    """Density of the proposal net: fp32 1e-5; bf16 2e-2 (as above)."""
    jcfg, tcfg = cfgs(activation, bf16)
    tree = numpy_tree(jgarf.proposal_init(jax.random.PRNGKey(3), jcfg))
    params = tgarf.from_numpy(tree, tcfg)
    pos = np.random.default_rng(4).normal(size=(40, 3)).astype(np.float32)
    want = jgarf.proposal_apply(jax_tree(tree), jcfg, jnp.asarray(pos), 0.5)
    got = tgarf.proposal_apply(params, tcfg, torch.as_tensor(pos), 0.5)
    tol = dict(rtol=0, atol=2e-2) if bf16 else dict(rtol=1e-5, atol=1e-5)
    close(got, want, **tol)


def test_converters_labels_and_init():
    _, tcfg, tree, params = radiance_pair("gabor")
    back = tgarf.to_numpy(params)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])
    labels = tgarf.param_labels(params, "lin", "act")
    assert labels["density1.act.0.spread"] == "act" and labels["color.linear.1.w"] == "lin"
    assert sum(v == "act" for v in labels.values()) == 16  # 8 layers x (isd, spread)
    fresh = tgarf.radiance_init(torch.Generator().manual_seed(0), tcfg)
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {
        k: v.shape for k, v in params.state_dict().items()}
    assert float(fresh.density1.act[0].isd.detach().min()) >= 0.0
    assert float(fresh.density1.act[0].spread.detach().max()) <= 2 * np.pi


# ---------------------------------------------------------------- proposal estimator


def test_s_to_t_and_lindisp_edges_match_jax():
    s = np.linspace(0.0, 1.0, 9, dtype=np.float32)[None].repeat(3, 0)
    for kind in ("lindisp", "uniform"):
        close(tproposal.s_to_t(torch.as_tensor(s), 2.0, 6.0, kind),
              jproposal.s_to_t(jnp.asarray(s), 2.0, 6.0, kind), rtol=1e-6)
    close(tsampling.lindisp_edges(3, 8, 2.0, 6.0, False),
          jsampling.lindisp_edges(3, 8, 2.0, 6.0, False), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    e = tsampling.lindisp_edges(50, 8, 2.0, 6.0, True, gen)
    assert torch.all(e[:, 1:] > e[:, :-1])
    assert torch.allclose(e[:, 0], torch.tensor(2.0)) and torch.allclose(e[:, -1],
                                                                         torch.tensor(6.0))
    with pytest.raises(ValueError):
        tsampling.lindisp_edges(2, 4, 2.0, 6.0, True)


def prop_fns(activation="gauss"):
    jcfg, tcfg = cfgs(activation)
    tree = numpy_tree(jgarf.proposal_init(jax.random.PRNGKey(5), jcfg))
    tparams = tgarf.from_numpy(tree, tcfg)
    origs, dirs = rays(6, 6)

    def jfn(ts, te):
        tm = (ts + te)[..., None] / 2.0
        pos = (jnp.asarray(origs)[:, None] + jnp.asarray(dirs)[:, None] * tm).reshape(-1, 3)
        return jgarf.proposal_apply(jax_tree(tree), jcfg, pos).reshape(ts.shape)

    def tfn(ts, te):
        tm = (ts + te)[..., None] / 2.0
        pos = (torch.as_tensor(origs)[:, None] + torch.as_tensor(dirs)[:, None] * tm)
        return tgarf.proposal_apply(tparams, tcfg, pos.reshape(-1, 3)).reshape(ts.shape)

    return jfn, tfn


def test_sampling_matches_jax_deterministic():
    """stratified=False: t bins, recorded histograms and the final s edges
    (1e-5; the inverse CDF is a searchsorted here, one-hot matmuls there)."""
    jfn, tfn = prop_fns()
    want = jproposal.sampling([jfn], [8], 12, 6, 2.0, 6.0, "lindisp", stratified=False)
    got = tproposal.sampling([tfn], [8], 12, 6, 2.0, 6.0, "lindisp", stratified=False)
    close(got[0], want[0], rtol=1e-5, atol=1e-6)
    close(got[1], want[1], rtol=1e-5, atol=1e-6)
    close(got[2].s_edges[0], want[2].s_edges[0], rtol=0, atol=1e-7)
    close(got[2].weights[0], want[2].weights[0], rtol=1e-5, atol=1e-7)
    close(got[2].final_s_edges, want[2].final_s_edges, rtol=1e-5, atol=1e-6)
    assert not got[0].requires_grad and got[2].weights[0].requires_grad


def test_sampling_stratified_with_a_generator():
    """Sorted bins, pinned ends, interior initial edges within half a cell of
    the grid, and the same draws from the same seed."""
    _, tfn = prop_fns()
    out = [tproposal.sampling([tfn], [8], 12, 6, 2.0, 6.0, "lindisp", stratified=True,
                              generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    ts, te, aux = out[0]
    assert torch.all(te > ts) and torch.all(ts[:, 1:] >= ts[:, :-1] - 1e-6)
    assert torch.all(ts >= 2.0) and torch.all(te <= 6.0 + 1e-6)
    s0 = aux.s_edges[0]
    grid = torch.linspace(0.0, 1.0, 9)
    assert torch.all(s0[:, 0] == 0.0) and torch.all(s0[:, -1] == 1.0)
    assert torch.all((s0 - grid).abs() <= 0.5 / 8 + 1e-7)
    assert torch.all(s0[:, 1:] > s0[:, :-1])
    assert torch.equal(out[0][0], out[1][0]) and not torch.equal(out[0][0], out[2][0])
    with pytest.raises(ValueError):
        tproposal.sampling([tfn], [8], 12, 6, 2.0, 6.0, stratified=True)


def test_compute_loss_matches_jax():
    """Random histograms: the loss and its gradient in the proposal weights
    (1e-5); the final weights get no gradient."""
    jfn, tfn = prop_fns("sarf")
    _, _, jaux = jproposal.sampling([jfn], [8], 12, 6, 2.0, 6.0, stratified=False)
    _, _, taux = tproposal.sampling([tfn], [8], 12, 6, 2.0, 6.0, stratified=False)
    final = np.random.default_rng(7).uniform(size=(6, 12)).astype(np.float32) / 6.0
    w_prop = np.asarray(jaux.weights[0])
    jl, jg = jax.value_and_grad(lambda w: jproposal.compute_loss(
        jaux._replace(weights=(w,)), jnp.asarray(final)))(jnp.asarray(w_prop))
    tw = torch.tensor(w_prop, requires_grad=True)
    tf = torch.tensor(final, requires_grad=True)
    tl = tproposal.compute_loss(taux._replace(weights=(tw,)), tf)
    tl.backward()
    close(tl, jl, rtol=1e-5)
    close(tw.grad, jg, rtol=1e-5, atol=1e-7)
    assert tf.grad is None


def test_outer_measure_pins_ties():
    """Overlap is inclusive at both ends: a reference interval that ends
    exactly at a query's start, or starts exactly at its end, counts."""
    q = np.array([[0.0, 0.25, 0.5, 0.75, 1.0],
                  [0.0, 0.3, 0.3, 0.9, 1.0]], np.float32)
    r = np.array([[0.0, 0.25, 0.5, 0.6, 0.75, 1.0],
                  [0.0, 0.1, 0.3, 0.5, 0.9, 1.0]], np.float32)
    w = np.array([[0.1, 0.2, 0.3, 0.15, 0.25],
                  [0.05, 0.4, 0.2, 0.3, 0.05]], np.float32)
    want = jproposal._outer_measure(jnp.asarray(q), jnp.asarray(r), jnp.asarray(w))
    got = tproposal._outer_measure(*map(torch.as_tensor, (q, r, w)))
    close(got, want, rtol=1e-6, atol=1e-7)
    # [0.25, 0.5] touches [0, 0.25] and [0.5, 0.6]: all three count
    assert got[0, 1] == pytest.approx(0.1 + 0.2 + 0.3)
    # the empty query [0.3, 0.3] touches [0.1, 0.3] and [0.3, 0.5]
    assert got[1, 1] == pytest.approx(0.4 + 0.2)


# ---------------------------------------------------------------- GARF render (K6 plain)


def render_inputs(n=4, s=8, seed=8):
    origs, dirs = rays(n, seed)
    ts, te = lindisp_bins(n, s)
    return origs, dirs, ts, te


@pytest.mark.parametrize("activation,anneal", [("gauss", 1.0), ("gabor", 1.0), ("sarf", 1.0),
                                               ("sarf", 0.37)])
def test_render_reference_matches_jax_kernel(activation, anneal):
    """`garf_radiance_render_reference` (and the wrapper on CPU tensors,
    without a launch) against the TPU kernel in interpret mode, one grid
    step: 1e-5 on rgb / opacity / depth (summation order only)."""
    jcfg, tcfg, tree, params = radiance_pair(activation, seed=1)
    origs, dirs, ts, te = render_inputs()
    want = jgm.garf_radiance_render(jax_tree(tree), jcfg, *map(jnp.asarray, (
        origs, dirs, ts, te)), act_anneal=anneal, tile_rays=4, interpret=True)
    args = (params, tcfg, *map(torch.as_tensor, (origs, dirs, ts, te)), anneal)
    got = tgm.garf_radiance_render_reference(*args)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-6)
    before = tgm.garf_radiance_render.launches
    wrapped = tgm.garf_radiance_render(*args)
    assert tgm.garf_radiance_render.launches == before
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


@pytest.mark.parametrize("activation,anneal,bf16", [("gabor", 0.37, False), ("sarf", 1.0, False),
                                                    ("gauss", 1.0, True)])
def test_render_reference_matches_jax_xla_path(activation, anneal, bf16):
    """Against JAX's radiance_apply + render_full at S = 13 (not a multiple
    of 32): fp32 1e-5, bf16 2e-2."""
    jcfg, tcfg, tree, params = radiance_pair(activation, bf16, seed=2)
    origs, dirs, ts, te = render_inputs(5, 13, seed=9)
    tq = (ts + te)[..., None] / 2.0
    pos = (origs[:, None] + dirs[:, None] * tq).reshape(-1, 3)
    dirs_rep = np.broadcast_to(dirs[:, None], (5, 13, 3)).reshape(-1, 3)
    rgb_s, dens_s = jgarf.radiance_apply(jax_tree(tree), jcfg, jnp.asarray(pos),
                                         jnp.asarray(dirs_rep), anneal)
    want = jrender.render_full(dens_s.reshape(5, 13), rgb_s.reshape(5, 13, 3),
                               jnp.asarray(ts), jnp.asarray(te))[:3]
    got = tgm.garf_radiance_render_reference(params, tcfg, *map(torch.as_tensor, (
        origs, dirs, ts, te)), anneal)
    tol = dict(rtol=0, atol=2e-2) if bf16 else dict(rtol=1e-5, atol=1e-6)
    for g, w in zip(got, want):
        close(g, w, **tol)


# ---------------------------------------------------------------- system forward


def system_cfgs(activation="gauss", **kw):
    jnet, tnet = cfgs(activation)
    common = dict(n_train_images=3, near=2.0, far=6.0, proposal_samples_per_ray=4,
                  radiance_samples_per_ray=8, **kw)
    return (jsys.GarfSystemConfig(net=jnet, **common),
            tsys.GarfSystemConfig(net=tnet, **common))


def system_params(jcfg, tcfg, seed=0):
    tree = numpy_tree(jsys.init(jax.random.PRNGKey(seed), jcfg).params)
    rng = np.random.default_rng(seed)
    tree["camera"] = {k: (rng.normal(size=(3, 3)) * 0.05).astype(np.float32)
                      for k in ("rotation", "translation")}
    return tree, tsys.params_from_numpy(tree, tcfg)


@pytest.mark.parametrize("activation,fused", [("gauss", False), ("gabor", True)])
def test_system_forward_matches_jax(activation, fused):
    """The deterministic eval path (no generator): rgb / opacity / depth
    against the JAX system's plain forward, 1e-5 (fused=True on CPU tensors
    is the kernel's plain version)."""
    jcfg, tcfg = system_cfgs(activation)
    tree, params = system_params(jcfg, tcfg)
    origs, dirs = rays(5, 10)
    want = jsys.forward(jax_tree(tree), jcfg, None, jnp.asarray(origs), jnp.asarray(dirs),
                        stratified=False, act_anneal=0.6)
    with torch.no_grad():
        got = tsys.forward(params, tcfg, None, torch.as_tensor(origs), torch.as_tensor(dirs),
                           stratified=False, act_anneal=0.6, fused=fused)
    for g, w in zip(got[:3], want[:3]):
        close(g, w, rtol=1e-5, atol=1e-6)
    assert "proposal_aux" in got[3]
    assert ("weights" in got[3]) != fused
    assert not tsys.use_fused_render(tcfg, "cpu") and tsys.use_fused_render(tcfg, "cuda")


def test_act_anneal_schedule_matches_jax():
    for start, end in ((100, 300), (0, 0), (5, 5), (0, 7)):
        jcfg = jsys.GarfSystemConfig(act_anneal_start_step=start, act_anneal_end_step=end)
        tcfg = tsys.GarfSystemConfig(act_anneal_start_step=start, act_anneal_end_step=end)
        for step in (0, 1, 3, 99, 100, 150, 200, 299, 300, 1000):
            got = tcfg.act_anneal_at(step)
            assert isinstance(got, float)
            assert got == float(jcfg.act_anneal_at(step)), (start, end, step)
