"""The occupancy grid in the BARF system, block-coarse training (BARF and
GARF) and block-coarse serving in the port, against the JAX package on the
CPU; the trainer's aligned blocks; and the entry points that take these
flags.

Inputs come from numpy with a seed; parameters from the JAX package's init,
converted; TF32 off. On the CPU the fused steps run the train kernels' plain
versions, against the JAX kernels in interpret mode (as
`tests/test_torch_train.py` does). The occupancy grid's training bins are
always jittered: the port is handed the JAX package's uniforms (the
resampling's from the step key's split, the refresh's jitter from
`fold_in(key, 0x0CC)`) through `occgrid.sample_intervals(u=)` and
`occgrid.update_grid(u=)`. GARF's proposal stage is stratified in its fused
step: both packages' draws are all 0.5 there, a zero jitter, as in
`tests/test_torch_garf_train.py`. Tolerances:
  * eval renders (`forward`, `render_block_coarse`): rgb atol 1e-5;
  * one train step: metrics rtol 1e-5; parameters after Adam, the refreshed
    grid included, rtol 1e-4 / atol 1e-6 (the JAX package's own fused-vs-
    plain tolerance);
  * `render_block_coarse` with block 1 against the port's own deterministic
    `forward`: bitwise.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.encodings.fourier import Barf as JBarf
from nerf_experiments_tpu.models import garf as jgarf
from nerf_experiments_tpu.models import nerf_mlp as jmlp
from nerf_experiments_tpu.ops import occgrid as jocc
from nerf_experiments_tpu.systems import barf as jbarf
from nerf_experiments_tpu.systems import garf_system as jgsys
from nerf_experiments_tpu_torch.data import sampler as tsampler
from nerf_experiments_tpu_torch.data import synthetic as tsynthetic
from nerf_experiments_tpu_torch.encodings.fourier import Barf as TBarf
from nerf_experiments_tpu_torch.experiments import garf_main, render_views, run_barf
from nerf_experiments_tpu_torch.models import garf as tgarf
from nerf_experiments_tpu_torch.models import nerf_mlp as tmlp
from nerf_experiments_tpu_torch.ops import occgrid as tocc
from nerf_experiments_tpu_torch.systems import barf as tbarf
from nerf_experiments_tpu_torch.systems import garf_system as tgsys
from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager
from nerf_experiments_tpu_torch.training.loggers import MetricLogger
from nerf_experiments_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **tol)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def mlp_cfgs(n_hidden=2, hidden_dim=32, n_segments=2):
    """The same small flagship-shaped NerfMLP config in both packages."""
    kw = dict(n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=n_segments,
              delayed_direction=True, delayed_density=False)
    enc = dict(scale=1.0, include_identity=True)
    return (jmlp.NerfMLPConfig(position_encoder=JBarf(levels=4, **enc),
                               direction_encoder=JBarf(levels=2, **enc), **kw),
            tmlp.NerfMLPConfig(position_encoder=TBarf(levels=4, **enc),
                               direction_encoder=TBarf(levels=2, **enc), **kw))


def named_mlp(tree, prefix):
    out = {}
    for i, seg in enumerate(tree["segments"]):
        for j, layer in enumerate(seg["layers"]):
            for k in ("w", "b"):
                out[f"{prefix}segments.{i}.layers.{j}.{k}"] = layer[k]
    for c, layer in enumerate(tree["color"]):
        for k in ("w", "b"):
            out[f"{prefix}color.{c}.{k}"] = layer[k]
    return out


def named_params(tree):
    """JAX BARF params {"radiance", ["proposal"], ["occ"], "camera"} -> the
    port's state_dict names."""
    out = named_mlp(tree["radiance"], "radiance.")
    if "proposal" in tree:
        out.update(named_mlp(tree["proposal"], "proposal."))
    if "occ" in tree:
        out["occ"] = tree["occ"]
    out.update({f"camera.{k}": v for k, v in tree["camera"].items()})
    return out


OCC = dict(resolution=8, aabb_half=2.0, n_coarse=16, update_every=2)


def barf_cfgs(coarse, strategy="equidistant", block=1):
    """(JAX, port) BarfConfig with an occupancy grid ("occ") or a small
    proposal net ("proposal") as the coarse stage."""
    jrad, trad = mlp_cfgs()
    kw = dict(n_training_images=4, near=2.0, far=6.0, samples_per_ray_radiance=8,
              uniform_sampling_strategy=strategy, uniform_sampling_offset_size=0.0,
              train_coarse_block=block)
    if coarse == "occ":
        return (jbarf.BarfConfig(radiance=jrad, occ=jocc.OccGridConfig(**OCC), **kw),
                tbarf.BarfConfig(radiance=trad, occ=tocc.OccGridConfig(**OCC), **kw))
    jprop, tprop = mlp_cfgs(n_hidden=1, hidden_dim=16, n_segments=1)
    return (jbarf.BarfConfig(radiance=jrad, proposal=jprop, samples_per_ray_proposal=8, **kw),
            tbarf.BarfConfig(radiance=trad, proposal=tprop, samples_per_ray_proposal=8, **kw))


def occupied_grid(seed):
    """An occupancy grid with empty, sparse and dense cells (0 to 50)."""
    rng = np.random.default_rng(seed)
    n = OCC["resolution"] ** 3
    return (rng.uniform(0.0, 50.0, size=n) * (rng.uniform(size=n) < 0.4)).astype(np.float32)


def system_tree(jcfg, seed=0):
    """JAX init, a camera away from zero and, with an occupancy grid, an
    occupied grid, as numpy."""
    tree = numpy_tree(jbarf.init(jax.random.PRNGKey(seed), jcfg).params)
    rng = np.random.default_rng(seed + 100)
    tree["camera"] = {k: (rng.normal(size=(4, 3)) * 0.05).astype(np.float32)
                      for k in ("rotation", "translation")}
    if "occ" in tree:
        tree["occ"] = occupied_grid(seed + 1)
    return tree


def rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3)) * 0.4 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def step_batch(n=16, seed=1):
    rng = np.random.default_rng(seed)
    origs, dirs = rays(n, seed)
    return {"origs_raw": origs, "origs_noisy": origs, "dirs_raw": dirs, "dirs_noisy": dirs,
            "colors": rng.uniform(size=(n, 2, 3)).astype(np.float32),
            "img_idx": rng.integers(0, 4, size=n).astype(np.int32),
            "pixel_width": np.full((n, 1), 1e-3, np.float32)}


def torch_batch(batch):
    return {k: torch.as_tensor(v).long() if k == "img_idx" else torch.as_tensor(v)
            for k, v in batch.items()}


# ---------------------------------------------------------------- parameters


def test_params_from_numpy_carry_the_grid_as_a_buffer(tmp_path):
    """The grid is a buffer: in `state_dict` (so in checkpoints), not among
    the parameters; the optimizer keeps the JAX package's frozen lr-0 `occ`
    row with no parameter in it."""
    jcfg, tcfg = barf_cfgs("occ")
    tree = system_tree(jcfg)
    params = tbarf.params_from_numpy(tree, tcfg)
    assert torch.equal(params.occ, torch.as_tensor(tree["occ"]))
    assert "occ" in params.state_dict()
    assert all(p is not params.occ for p in params.parameters())
    assert torch.equal(tbarf.init(torch.Generator().manual_seed(0), tcfg).occ,
                       torch.full((512,), 1.0))
    groups, by_label = tbarf.make_groups(tcfg, params)
    assert by_label["occ"] == [] and groups["occ"].learning_rate_start == 0.0
    rows_t, rows_j = tbarf.lr_fn(tcfg, params)(0), jbarf.lr_fn(jcfg, tree)(0)
    assert rows_t["lr_occ"] == 0.0 and rows_t == pytest.approx(rows_j, rel=1e-6)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params)
    fresh = mgr.restore(tbarf.init(torch.Generator().manual_seed(1), tcfg))
    assert torch.equal(fresh.occ, params.occ)
    with pytest.raises(ValueError):
        tbarf.init(torch.Generator(), dataclasses.replace(tcfg, samples_per_ray_proposal=8))


# ---------------------------------------------------------------- eval and serving


@torch.no_grad()
def test_occ_forward_at_eval_matches_jax():
    jcfg, tcfg = barf_cfgs("occ")
    tree = system_tree(jcfg, seed=2)
    params = tbarf.params_from_numpy(tree, tcfg)
    o, d = rays(24, seed=3)
    pw = np.full((24, 1), 1e-3, np.float32)
    want, _ = jbarf.forward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, None,
                            jnp.asarray(o), jnp.asarray(d), jnp.asarray(pw), 4.0, 2.0,
                            stratified=False)
    got, coarse = tbarf.forward(params, tcfg, None, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(pw), 4.0, 2.0, stratified=False)
    assert coarse is None
    close(got, want, rtol=0.0, atol=1e-5)


@pytest.mark.parametrize("coarse", ["occ", "proposal"])
@pytest.mark.parametrize("block", [1, 4])
@torch.no_grad()
def test_render_block_coarse_matches_jax(coarse, block):
    """Against the JAX `render_block_coarse` (plain path on the CPU in both);
    with block 1 also bitwise equal to the port's deterministic `forward`."""
    jcfg, tcfg = barf_cfgs(coarse)
    tree = system_tree(jcfg, seed=4)
    params = tbarf.params_from_numpy(tree, tcfg)
    o, d = rays(32, seed=5)
    want = jbarf.render_block_coarse(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                     jnp.asarray(o), jnp.asarray(d), 4.0, 2.0, block=block,
                                     pixel_width=1e-3)
    got = tbarf.render_block_coarse(params, tcfg, torch.as_tensor(o), torch.as_tensor(d),
                                    4.0, 2.0, block=block, pixel_width=1e-3)
    close(got, want, rtol=0.0, atol=1e-5)
    if block == 1:
        ref, _ = tbarf.forward(params, tcfg, None, torch.as_tensor(o), torch.as_tensor(d),
                               torch.full((32, 1), 1e-3), 4.0, 2.0, stratified=False)
        assert torch.equal(got, ref)
    else:  # each block shares its first ray's bins: the render differs
        ref, _ = tbarf.forward(params, tcfg, None, torch.as_tensor(o), torch.as_tensor(d),
                               torch.full((32, 1), 1e-3), 4.0, 2.0, stratified=False)
        assert not torch.allclose(got, ref)


def test_render_block_coarse_refuses_a_ragged_chunk():
    _, tcfg = barf_cfgs("occ")
    params = tbarf.init(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError):
        tbarf.render_block_coarse(params, tcfg, torch.zeros((6, 3)), torch.ones((6, 3)),
                                  block=4)


# ---------------------------------------------------------------- train steps


def jax_state(jcfg, tree):
    tx = jbarf.make_optimizer(jcfg, tree)
    return tx, jbarf.TrainState(params=jax.tree_util.tree_map(jnp.asarray, tree),
                                opt_state=tx.init(tree), step=jnp.asarray(0))


def inject_jax_uniforms(monkeypatch, key, jcfg, n_rep):
    """Hand the port's occupancy functions the draws the JAX step makes from
    `key`: the resampling's (and the stratified coarse bins') uniforms, and
    the refresh's jitter from fold_in(key, 0x0CC). Returns the calls seen."""
    occ = jcfg.occ
    k_coarse, k_pdf = jax.random.split(key)
    u = torch.as_tensor(np.array(jax.random.uniform(
        k_pdf, (n_rep, jcfg.samples_per_ray_radiance))))
    u_coarse = None
    if jcfg.uniform_sampling_strategy == "stratified_uniform":
        u_coarse = torch.as_tensor(np.array(jax.random.uniform(
            jax.random.split(k_coarse)[1], (n_rep, occ.n_coarse))))
    jitter = torch.as_tensor(np.array(jax.random.uniform(
        jax.random.fold_in(key, 0x0CC), (occ.n_cells, 3))))
    calls = {"sample": 0, "update": 0}
    sample, update = tocc.sample_intervals, tocc.update_grid

    def sample_with(*a, generator=None, **kw):
        assert generator is not None  # a training draw, which the JAX step jitters
        calls["sample"] += 1
        return sample(*a, u=u, u_coarse=u_coarse, **kw)

    def update_with(grid, cfg, density_fn, generator=None):
        calls["update"] += 1
        return update(grid, cfg, density_fn, u=jitter)

    monkeypatch.setattr(tocc, "sample_intervals", sample_with)
    monkeypatch.setattr(tocc, "update_grid", update_with)
    return calls


def compare_step(metrics, state, jm, js, keys):
    for k in keys:
        close(metrics[k], jm[k], rtol=1e-5, err_msg=k)
    want = named_params(numpy_tree(js.params))
    got = state.params.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        close(v, want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("strategy", ["equidistant", "stratified_uniform"])
def test_occ_train_steps_match_jax(fused, strategy, monkeypatch):
    """`train_step` / `train_step_fused` with an occupancy grid against the
    JAX package's from the same parameters, batch and draws; step 0
    refreshes the grid after the update (it changes, and matches)."""
    jcfg, tcfg = barf_cfgs("occ", strategy)
    tree = system_tree(jcfg, seed=6)
    tx, jstate = jax_state(jcfg, tree)
    batch = step_batch(seed=7)
    key = jax.random.PRNGKey(8)
    scalars = (2.0, 1.0, 0.0)
    jstep = jbarf.train_step_fused if fused else jbarf.train_step
    js, jm = jstep(jstate, jcfg, tx, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                   *scalars)
    calls = inject_jax_uniforms(monkeypatch, key, jcfg, 16)
    state = tbarf.init_state(tcfg, tbarf.params_from_numpy(tree, tcfg))
    state, metrics = tbarf.make_train_step(tcfg, fused=fused)(
        state, torch_batch(batch), torch.Generator().manual_seed(9), *scalars)
    assert state.step == 1 and bool(metrics["grads_finite"])
    assert calls == {"sample": 1, "update": 1}
    assert not torch.equal(state.params.occ, torch.as_tensor(tree["occ"]))
    compare_step(metrics, state, jm, js, ("loss", "loss_fine", "psnr"))


def test_occ_refresh_follows_its_cadence():
    """update_every 2: the grid moves at steps 0 and 2, not at 1 and 3; the
    refresh's draws depend on the step generator's seed only."""
    _, tcfg = barf_cfgs("occ")
    state = tbarf.init_state(tcfg, tbarf.init(torch.Generator().manual_seed(0), tcfg))
    step = tbarf.make_train_step(tcfg, fused=True)
    batch = torch_batch(step_batch(seed=10))
    grids = [state.params.occ.clone()]
    for i in range(4):
        state, _ = step(state, batch, torch.Generator().manual_seed(100 + i), 2.0, 1.0, 0.0)
        grids.append(state.params.occ.clone())
    moved = [not torch.equal(a, b) for a, b in zip(grids, grids[1:])]
    assert moved == [True, False, True, False]
    with pytest.raises(ValueError):  # the grid's training bins need a generator
        step(state, batch, None, 2.0, 1.0, 0.0)


@pytest.mark.parametrize("coarse", ["proposal", "occ"])
def test_block_coarse_fused_step_matches_jax(coarse, monkeypatch):
    """`train_step_fused` with train_coarse_block 4 against the JAX
    package's: the coarse stage on rays 0, 4, 8, 12, their bins shared by
    each block, the coarse loss over those rays, the coarse stage's ray
    gradients scattered back into the camera's."""
    jcfg, tcfg = barf_cfgs(coarse, block=4)
    tree = system_tree(jcfg, seed=11)
    tx, jstate = jax_state(jcfg, tree)
    batch = step_batch(seed=12)
    key = jax.random.PRNGKey(13)
    js, jm = jbarf.train_step_fused(jstate, jcfg, tx,
                                    {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                    2.0, 1.0, 0.0)
    if coarse == "occ":
        inject_jax_uniforms(monkeypatch, key, jcfg, 4)
    state = tbarf.init_state(tcfg, tbarf.params_from_numpy(tree, tcfg))
    state, metrics = tbarf.make_train_step(tcfg, fused=True)(
        state, torch_batch(batch), torch.Generator().manual_seed(14), 2.0, 1.0, 0.0)
    keys = ("loss", "loss_fine", "psnr") + (("loss_coarse",) if coarse == "proposal" else ())
    compare_step(metrics, state, jm, js, keys)
    with pytest.raises(ValueError):  # 4 must divide the batch
        tbarf.make_train_step(tcfg, fused=True)(
            state, torch_batch(step_batch(n=18, seed=12)), torch.Generator(), 2.0, 1.0, 0.0)


def garf_cfgs(block):
    kw = dict(n_train_images=3, near=2.0, far=6.0, proposal_samples_per_ray=4,
              radiance_samples_per_ray=8, camera_learning_rate_start=4e-3,
              camera_learning_rate_stop=8e-4, train_coarse_block=block)
    net = dict(activation="gabor", init_min=0.5, init_max=2.0, weight_decay=1e-3)
    prop = dict(activation="gabor", init_min=0.5, init_max=2.0, weight_decay=1e-2,
                learning_rate_start=5e-4)
    return (jgsys.GarfSystemConfig(net=jgarf.GarfConfig(**net),
                                   proposal_net=jgarf.GarfConfig(**prop), **kw),
            tgsys.GarfSystemConfig(net=tgarf.GarfConfig(**net),
                                   proposal_net=tgarf.GarfConfig(**prop), **kw))


def garf_named(tree, prefix=""):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[prefix + ".".join(keys)] = leaf
    return out


@pytest.mark.parametrize("interlevel", [True, False])
def test_garf_block_coarse_fused_step_matches_jax(interlevel, monkeypatch):
    """GARF's `train_step_fused` with train_coarse_block 4 against the JAX
    package's, both proposal stages' draws all 0.5: the interlevel loss
    against each block's mean fine weights, the proposal stage's ray
    gradients scattered back (or detached, interlevel_camera_grads False)."""
    jcfg, tcfg = garf_cfgs(4)
    jcfg = dataclasses.replace(jcfg, interlevel_camera_grads=interlevel)
    tcfg = dataclasses.replace(tcfg, interlevel_camera_grads=interlevel)
    tree = numpy_tree(jgsys.init(jax.random.PRNGKey(0), jcfg).params)
    rng = np.random.default_rng(15)
    tree["camera"] = {k: (rng.normal(size=(3, 3)) * 0.05).astype(np.float32)
                      for k in ("rotation", "translation")}
    o, d = rays(16, seed=16)
    batch = {"origs_noisy": o, "dirs_noisy": d,
             "colors": rng.uniform(size=(16, 1, 3)).astype(np.float32),
             "img_idx": rng.integers(0, 3, size=16).astype(np.int32)}

    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, **kw: jnp.full(shape, 0.5, dtype))
    monkeypatch.setattr(torch, "rand", lambda size, generator=None, dtype=None, device=None:
                        torch.full(size, 0.5, dtype=dtype or torch.float32, device=device))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jgsys.make_optimizer(jcfg, params)
    js, jm = jgsys.train_step_fused(
        jgsys.TrainState(params=params, opt_state=tx.init(params), step=jnp.asarray(0)),
        jcfg, tx, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1), 0.7)
    state = tgsys.init_state(tcfg, tgsys.params_from_numpy(tree, tcfg))
    state, metrics = tgsys.make_train_step_fused(tcfg)(
        state, torch_batch(batch), torch.Generator(), 0.7)
    assert state.step == 1 and bool(metrics["grads_finite"])
    for k in ("loss", "proposal_loss", "radiance_loss", "psnr"):
        close(metrics[k], jm[k], rtol=1e-5, err_msg=k)
    want = garf_named(numpy_tree(js.params))
    got = state.params.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        close(v, want[k], rtol=1e-4, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- the trainer's blocks


def raster_store(n_images=4, hw=16):
    """A store whose origins_raw[:, 0] is the ray's index, so a batch tells
    which rays it took."""
    n = n_images * hw
    idx = torch.arange(n, dtype=torch.float32)
    return tsampler.RayStore(
        origins_raw=torch.stack([idx, idx, idx], 1), origins_noisy=torch.zeros((n, 3)),
        dirs_raw=torch.zeros((n, 3)), dirs_noisy=torch.zeros((n, 3)),
        colors=torch.zeros((n, 2, 3)), img_idx=torch.arange(n) // hw, pixel_width=0.01,
        gaussian_blur_sigmas=(0.0, 0.0), camera_origins_raw=torch.zeros((n_images, 3)),
        camera_origins_noisy=torch.zeros((n_images, 3)), hw=hw)


@pytest.mark.parametrize("block", [1, 4, 8])
def test_batch_block_runs_are_aligned_within_one_image_and_replayed(block, tmp_path):
    """Each run of `block` rays starts on a multiple of the block, is
    raster-consecutive and stays in one image; `regen_batch` gives each
    step's batch again (rollback and post-mortem replay)."""
    seen = []

    def step_fn(state, batch, gen):
        seen.append(batch["origs_raw"][:, 0].clone())
        state.step += 1
        return state, {}

    @dataclasses.dataclass
    class State:
        params: dict
        step: int = 0

    tr = Trainer(cfg=TrainerConfig(max_steps=6, batch_size=16, log_every_n_steps=100,
                                   val_every_n_epochs=1e9, batch_block=block,
                                   rollback_enabled=False),
                 train_store=raster_store(), step_fn=step_fn, scalar_fn=lambda s, e: (),
                 metric_logger=MetricLogger(str(tmp_path)))
    tr.fit(State({}))
    assert len(seen) == 6
    for step, got in enumerate(seen):
        runs = got.long().reshape(-1, block)
        assert bool((runs[:, 0] % block == 0).all())
        assert torch.equal(runs - runs[:, :1], torch.arange(block).expand_as(runs))
        assert bool(((runs // 16) == (runs[:, :1] // 16)).all())
        assert torch.equal(tr.regen_batch(step)["origs_raw"][:, 0], got)


def test_batch_block_refuses_runs_across_images(tmp_path):
    for store, batch in ((raster_store(hw=18), 16), (raster_store(), 18)):
        with pytest.raises(ValueError):
            Trainer(cfg=TrainerConfig(batch_size=batch, batch_block=4), train_store=store,
                    step_fn=None, scalar_fn=None, metric_logger=MetricLogger(str(tmp_path)))


# ---------------------------------------------------------------- entry points


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("block_scene"))
    tsynthetic.generate_dataset(path, n_train=6, n_val=2, n_test=2, image_size=16, n_samples=32)
    return path


SMALL = ["--image_size", "16", "--batch_size", "128", "--samples_per_ray", "8",
         "--hidden_dim", "32", "--n_hidden", "1", "--device", "cpu",
         "--camera_origin_noise_sigma", "0.1"]
OCC_FLAGS = ["--occ_grid_resolution", "16", "--occ_grid_coarse", "16",
             "--occ_grid_update_every", "4"]
PROPOSAL_FLAGS = ["--samples_per_ray_proposal", "8", "--proposal_hidden_dim", "16"]


def rows(out):
    return [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]


@pytest.mark.parametrize("fused", [False, True])
def test_run_barf_with_an_occupancy_grid_resumes_bitwise(scene, tmp_path, fused):
    """`run_barf --occ_grid_resolution 16`: 6 steps, a checkpoint holding the
    grid, `--resume` to 10, against 10 steps in one go (both refresh at
    steps 0, 4 and 8)."""
    flags = SMALL + OCC_FLAGS + ["--scene_path", scene, "--log_every_n_steps", "2"] + (
        ["--fused_kernel"] if fused else [])
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    first = run_barf.main(flags + ["--out_dir", a, "--max_steps", "6",
                                   "--checkpoint_every_n_epochs", "100"])
    blob = torch.load(os.path.join(a, "ckpt", "ckpt_6.pt"), weights_only=True)
    assert torch.equal(blob["params"]["occ"], first.params.occ)
    assert not torch.equal(first.params.occ, torch.ones(16 ** 3))
    resumed = run_barf.main(flags + ["--out_dir", a, "--max_steps", "10", "--resume"])
    straight = run_barf.main(flags + ["--out_dir", b, "--max_steps", "10"])
    assert resumed.step == straight.step == 10
    for (k, x), y in zip(resumed.params.state_dict().items(),
                         straight.params.state_dict().values()):
        assert torch.equal(x, y), k
    assert all(np.isfinite(r["loss"]) for r in rows(b) if "loss" in r)
    assert any(r.get("lr_occ") == 0.0 for r in rows(b))


@pytest.mark.parametrize("coarse", ["occ", "proposal"])
def test_run_barf_block_coarse_trains_and_serves(scene, tmp_path, coarse):
    """`run_barf --train_coarse_block 4` trains a few steps (and resumes);
    `render_views --serve_block 4` serves its checkpoint, and `--serve_block
    1` too, with chunks that need padding to a multiple of the block."""
    coarse_flags = OCC_FLAGS if coarse == "occ" else PROPOSAL_FLAGS
    out = str(tmp_path / "run")
    flags = SMALL + coarse_flags + ["--scene_path", scene, "--fused_kernel",
                                    "--train_coarse_block", "4", "--out_dir", out,
                                    "--log_every_n_steps", "2"]
    state = run_barf.main(flags + ["--max_steps", "4", "--checkpoint_every_n_epochs", "100"])
    assert state.step == 4
    state = run_barf.main(flags + ["--max_steps", "6", "--resume"])
    assert state.step == 6
    assert all(np.isfinite(r["loss"]) for r in rows(out) if "loss" in r)
    serve = ["--ckpt_dir", os.path.join(out, "ckpt"), "--scene_path", scene,
             "--image_size", "16", "--samples_per_ray", "8", "--hidden_dim", "32",
             "--n_hidden", "1", "--device", "cpu", "--n_images", "1", "--chunk", "90",
             "--camera_origin_noise_sigma", "0.1"] + coarse_flags
    psnr = {}
    for block in (1, 4):
        summary = render_views.main(serve + ["--serve_block", str(block), "--out_dir",
                                             str(tmp_path / f"render{block}")])
        assert summary["serve_block"] == block and summary["ckpt_step"] == 6
        psnr[block] = summary["mean_psnr"]
    assert all(np.isfinite(v) for v in psnr.values())


def test_run_barf_refuses_block_coarse_without_its_needs(scene, tmp_path):
    base = SMALL + ["--scene_path", scene, "--out_dir", str(tmp_path), "--max_steps", "1",
                    "--train_coarse_block", "4"]
    with pytest.raises(ValueError):  # the plain step has no block-coarse path
        run_barf.main(base + OCC_FLAGS)
    with pytest.raises(ValueError):  # no coarse stage to share
        run_barf.main(base + ["--fused_kernel"])


def test_garf_main_block_coarse_trains(scene, tmp_path):
    argv = ["--scene_path", scene, "--image_size", "16", "--batch_size", "64",
            "--proposal_samples_per_ray", "8", "--radiance_samples_per_ray", "8",
            "--log_every_n_steps", "2", "--device", "cpu", "--train_coarse_block", "4",
            "--max_steps", "4"]
    state = garf_main.main(argv + ["--fused_kernel", "--out_dir", str(tmp_path / "g")])
    assert state.step == 4
    assert all(np.isfinite(r["loss"]) for r in rows(str(tmp_path / "g")) if "loss" in r)
    with pytest.raises(ValueError):
        garf_main.main(argv + ["--out_dir", str(tmp_path / "h")])


@pytest.mark.parametrize("entry", ["run_barf", "garf_main"])
def test_entry_points_take_the_batch_block_from_the_system(scene, tmp_path, entry):
    """The trainer's `batch_block` and the system's `train_coarse_block` are
    one decision: each entry point builds its trainer from the system's."""
    if entry == "run_barf":
        exp = run_barf.build(run_barf.parse_args(
            SMALL + OCC_FLAGS + ["--scene_path", scene, "--fused_kernel",
                                 "--train_coarse_block", "4", "--out_dir", str(tmp_path)]))
        system_block, trainer = exp.cfg.train_coarse_block, exp.trainer
    else:
        cfg, _, trainer = garf_main.build(garf_main.parse_args(
            ["--scene_path", scene, "--image_size", "16", "--batch_size", "64",
             "--proposal_samples_per_ray", "8", "--radiance_samples_per_ray", "8",
             "--device", "cpu", "--fused_kernel", "--train_coarse_block", "4",
             "--out_dir", str(tmp_path)]))
        system_block = cfg.train_coarse_block
    assert system_block == trainer.cfg.batch_block == 4
