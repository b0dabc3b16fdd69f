"""The port's training slice against the JAX package on the CPU: the plain
version of the flagship train kernel, one train step (plain and fused) for
the dense and proposal configs, the optimizer, the schedules, the sampler,
the trainer's monitoring and rollback, and `run_barf` end to end with a
bitwise resume.

Inputs are made with numpy from a seed (parameters from the JAX package's
init, converted), TF32 is off, and the sampling is `equidistant` wherever
the two packages are compared, so no random stream is involved. Tolerances:
  * train kernel (plain version vs the JAX kernel in interpret mode, as
    `tests/test_train_megakernel.py` holds the JAX kernel to XLA): rgb and
    weights rtol 1e-5 / atol 1e-6, d_origs / d_dirs rtol 1e-4 / atol 1e-6,
    every dW/db rtol 2e-4 / atol 1e-6 (fp32, summation order);
  * one train step: losses rtol 1e-5, parameters after Adam rtol 1e-4 /
    atol 1e-6 (the JAX package's own fused-vs-plain tolerance);
  * optimizer over 5 steps rtol 1e-5 / atol 1e-7; schedules rtol 1e-6;
    blurred colours atol 1e-6 (all fp32 rounding only).
"""
import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_experiments_tpu.data import sampler as jsampler
from nerf_experiments_tpu.encodings.fourier import Barf as JBarf
from nerf_experiments_tpu.models import common as jcommon
from nerf_experiments_tpu.models import nerf_mlp as jmlp
from nerf_experiments_tpu.ops import sampling as jsampling
from nerf_experiments_tpu.ops.train_megakernel import flagship_train_grads as jtrain_grads
from nerf_experiments_tpu.systems import barf as jbarf
from nerf_experiments_tpu.training import optim as joptim
from nerf_experiments_tpu.training import schedules as jschedules
from nerf_experiments_tpu_torch.data import sampler as tsampler
from nerf_experiments_tpu_torch.data import synthetic as tsynthetic
from nerf_experiments_tpu_torch.encodings.fourier import Barf as TBarf
from nerf_experiments_tpu_torch.experiments import run_barf
from nerf_experiments_tpu_torch.models import nerf_mlp as tmlp
from nerf_experiments_tpu_torch.models.common import ParamGroup
from nerf_experiments_tpu_torch.ops import train_megakernel as ttrain
from nerf_experiments_tpu_torch.systems import barf as tbarf
from nerf_experiments_tpu_torch.training import optim as toptim
from nerf_experiments_tpu_torch.training import schedules as tschedules
from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager
from nerf_experiments_tpu_torch.training.loggers import MetricLogger
from nerf_experiments_tpu_torch.training.trainer import Trainer, TrainerConfig, mix_seed

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **tol)


def mlp_cfgs(n_hidden=2, hidden_dim=32, n_segments=2):
    """The same small flagship-shaped NerfMLP config in both packages."""
    kw = dict(n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=n_segments,
              delayed_direction=True, delayed_density=False)
    enc = dict(scale=1.0, include_identity=True)
    return (jmlp.NerfMLPConfig(position_encoder=JBarf(levels=4, **enc),
                               direction_encoder=JBarf(levels=2, **enc), **kw),
            tmlp.NerfMLPConfig(position_encoder=TBarf(levels=4, **enc),
                               direction_encoder=TBarf(levels=2, **enc), **kw))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def named_mlp(tree, prefix=""):
    """JAX NerfMLP pytree -> {port parameter name: array}."""
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
    """JAX BARF params {"radiance", ["proposal"], "camera"} -> port names."""
    out = named_mlp(tree["radiance"], "radiance.")
    if "proposal" in tree:
        out.update(named_mlp(tree["proposal"], "proposal."))
    out.update({f"camera.{k}": v for k, v in tree["camera"].items()})
    return out


def rays(n, seed):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (rng.normal(size=(n, 3)) * 0.3).astype(np.float32), dirs.astype(np.float32)


# ---------------------------------------------------------------- train kernel (plain)


@pytest.mark.parametrize("n_hidden,alpha,loss_scale,with_weights",
                         [(2, 2.5, 1.0, False), (1, 1.0, 0.25, True), (4, 4.0, 1.0, True)])
def test_train_grads_reference_matches_jax_kernel(n_hidden, alpha, loss_scale, with_weights):
    jcfg, tcfg = mlp_cfgs(n_hidden=n_hidden)
    tree = numpy_tree(jmlp.init(jax.random.PRNGKey(n_hidden), jcfg))
    origs, dirs = rays(8, seed=n_hidden)
    targets = np.random.default_rng(5).uniform(size=(8, 3)).astype(np.float32)
    ts, te = map(np.array, jsampling.sample_stratified(None, 8, 8, 2.0, 6.0, "equidistant"))
    a_pos, a_dir = alpha, alpha / 2.0

    want = jtrain_grads(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, *map(
        jnp.asarray, (origs, dirs, ts, te, targets)), a_pos, a_dir, tile_rays=4,
        interpret=True, loss_scale=loss_scale, return_weights=with_weights)
    params = tmlp.from_numpy(tree, tcfg)
    args = (params, tcfg, *map(torch.as_tensor, (origs, dirs, ts, te, targets)), a_pos, a_dir,
            loss_scale, with_weights)
    got = ttrain.flagship_train_grads_reference(*args)

    close(got[0], want[0], rtol=1e-5, atol=1e-6)
    close(got[2], want[2], rtol=1e-4, atol=1e-6)
    close(got[3], want[3], rtol=1e-4, atol=1e-6)
    want_grads = named_mlp(want[1])
    assert set(got[1]) == set(want_grads)
    for name, g in got[1].items():
        close(g, want_grads[name], rtol=2e-4, atol=1e-6, err_msg=name)
    if with_weights:
        close(got[4], want[4], rtol=1e-5, atol=1e-6)
    # the wrapper takes the plain version for CPU tensors, and no kernel
    before = ttrain.flagship_train_grads.launches
    wrapped = ttrain.flagship_train_grads(*args)
    assert ttrain.flagship_train_grads.launches == before
    assert torch.equal(wrapped[0], got[0]) and torch.equal(wrapped[2], got[2])
    assert all(torch.equal(wrapped[1][k], v) for k, v in got[1].items())
    assert all(p.grad is None for p in params.parameters())


def test_train_grads_loss_scale_is_linear():
    _, tcfg = mlp_cfgs()
    params = tmlp.init(torch.Generator().manual_seed(0), tcfg)
    origs, dirs = map(torch.as_tensor, rays(6, seed=9))
    ts, te = (torch.as_tensor(np.array(x)) for x in jsampling.sample_stratified(
        None, 6, 8, 2.0, 6.0, "equidistant"))
    targets = torch.rand((6, 3), generator=torch.Generator().manual_seed(1))
    _, g1, o1, d1 = ttrain.flagship_train_grads(params, tcfg, origs, dirs, ts, te, targets,
                                                2.0, 1.0)
    _, g2, o2, d2 = ttrain.flagship_train_grads(params, tcfg, origs, dirs, ts, te, targets,
                                                2.0, 1.0, loss_scale=0.25)
    close(o2, 0.25 * o1, rtol=1e-5, atol=1e-8)
    close(d2, 0.25 * d1, rtol=1e-5, atol=1e-8)
    for k in g1:
        close(g2[k], 0.25 * g1[k], rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------- one train step


STEP_CONFIGS = {
    "dense": dict(),
    "proposal": dict(proposal=1, samples_per_ray_proposal=4),
    "shared": dict(share_proposal_net=True, samples_per_ray_proposal=4,
                   coarse_loss_weight=0.1),
}


def step_configs(name):
    kw = dict(STEP_CONFIGS[name])
    jrad, trad = mlp_cfgs()
    prop = kw.pop("proposal", None)
    jprop, tprop = mlp_cfgs(n_hidden=1, hidden_dim=16, n_segments=1) if prop else (None, None)
    common = dict(n_training_images=4, near=2.0, far=6.0, samples_per_ray_radiance=8,
                  uniform_sampling_strategy="equidistant", uniform_sampling_offset_size=0.0,
                  **kw)
    return (jbarf.BarfConfig(radiance=jrad, proposal=jprop, **common),
            tbarf.BarfConfig(radiance=trad, proposal=tprop, **common))


def step_batch(n=16, seed=1):
    rng = np.random.default_rng(seed)
    origs, dirs = rays(n, seed)
    return {"origs_raw": origs, "origs_noisy": origs, "dirs_raw": dirs, "dirs_noisy": dirs,
            "colors": rng.uniform(size=(n, 2, 3)).astype(np.float32),
            "img_idx": rng.integers(0, 4, size=n).astype(np.int32),
            "pixel_width": np.full((n, 1), 1e-3, np.float32)}


@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_train_steps_match_jax(name):
    """`train_step` and `train_step_fused` (CPU: the kernel's plain version)
    against the JAX package's `train_step` and `train_step_fused` (interpret
    mode) after one step from the same parameters and batch."""
    jcfg, tcfg = step_configs(name)
    jstate = jbarf.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(2)
    camera = {k: (rng.normal(size=(4, 3)) * 0.05).astype(np.float32)
              for k in ("rotation", "translation")}
    tree = numpy_tree(dict(jstate.params, camera=camera))
    tx = jbarf.make_optimizer(jcfg, tree)
    jstate = jbarf.TrainState(params=jax.tree_util.tree_map(jnp.asarray, tree),
                              opt_state=tx.init(tree), step=jnp.asarray(0))
    batch = step_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v).long() if k == "img_idx" else torch.as_tensor(v)
              for k, v in batch.items()}
    scalars = (2.0, 1.0, 0.0)

    jax_out = [jbarf.train_step(jstate, jcfg, tx, jbatch, jax.random.PRNGKey(3), *scalars),
               jbarf.train_step_fused(jstate, jcfg, tx, jbatch, jax.random.PRNGKey(3),
                                      *scalars)]
    for fused, (js, jm) in zip((False, True), jax_out):
        state = tbarf.init_state(tcfg, tbarf.params_from_numpy(tree, tcfg))
        state, metrics = tbarf.make_train_step(tcfg, fused=fused)(state, tbatch, None,
                                                                  *scalars)
        assert state.step == 1 and bool(metrics["grads_finite"])
        for k in ("loss", "loss_fine", "psnr") + (("loss_coarse",) if name != "dense"
                                                    else ()):
            close(metrics[k], jm[k], rtol=1e-5, err_msg=f"fused={fused} {k}")
        want = named_params(numpy_tree(js.params))
        got = state.params.state_dict()
        assert set(got) == set(want)
        for k, v in got.items():
            close(v, want[k], rtol=1e-4, atol=1e-6, err_msg=f"fused={fused} {k}")


def test_loss_fn_validation_path_matches_jax():
    jcfg, tcfg = step_configs("proposal")
    tree = numpy_tree(jbarf.init(jax.random.PRNGKey(4), jcfg).params)
    params = tbarf.params_from_numpy(tree, tcfg)
    batch = step_batch(seed=6)
    raw = np.random.default_rng(7).normal(size=(4, 3)).astype(np.float32)
    noisy = (raw + 0.05).astype(np.float32)
    jgauge = jbarf.val_gauge(tree, jnp.asarray(raw), jnp.asarray(noisy))
    _, jm = jbarf.loss_fn(tree, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, None,
                          4.0, 2.0, 0.0, train=False, val_gauge=jgauge)
    tgauge = tbarf.val_gauge(params, torch.as_tensor(raw), torch.as_tensor(noisy))
    with torch.no_grad():
        _, tm = tbarf.loss_fn(params, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()},
                              None, 4.0, 2.0, 0.0, train=False, val_gauge=tgauge)
    for k in ("loss_fine", "loss_coarse", "psnr"):
        close(tm[k], jm[k], rtol=1e-4, err_msg=k)


def test_fused_step_needs_a_flagship_config():
    _, tcfg = step_configs("dense")
    enc = TBarf(levels=2, scale=1.0)
    cfg = dataclasses.replace(tcfg, radiance=tmlp.NerfMLPConfig(
        position_encoder=enc, direction_encoder=enc, n_hidden=1, hidden_dim=8, n_segments=1))
    with pytest.raises(ValueError):
        tbarf.make_train_step(cfg, fused=True)


# ---------------------------------------------------------------- optimizer and schedules


def test_multi_group_adam_matches_optax():
    """5 scheduled steps: a decaying group, a camera group with its own Adam
    eps and a freeze window over steps 1-2, a frozen (lr 0) group, and one
    non-finite gradient at step 3 that the guard zeroes (Adam still runs)."""
    groups = {
        "net": ParamGroup(1e-2, 1e-3, 4),
        "camera": ParamGroup(1e-2, 1e-4, 10, adam_eps=1e-2, freeze_start_step=1,
                             freeze_end_step=3),
        "frozen": ParamGroup(0.0, 0.0, 0),
    }
    jgroups = {k: jcommon.ParamGroup(**dataclasses.asdict(g)) for k, g in groups.items()}
    rng = np.random.default_rng(0)
    init = {"net": rng.normal(size=(3, 4)), "camera": rng.normal(size=(5, 3)),
            "frozen": rng.normal(size=(2,))}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(5)]
    grads[3]["net"][1, 2] = np.inf

    tx = joptim.multi_group_adam(jgroups, {k: k for k in init}, eps=1e-5)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.as_tensor(v).clone()) for k, v in init.items()}
    opt = toptim.multi_group_adam(groups, {k: [p] for k, p in tparams.items()}, eps=1e-5)
    for i, g in enumerate(grads):
        jg, jok = joptim.guard_nonfinite({k: jnp.asarray(v) for k, v in g.items()})
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.as_tensor(g[k]).clone()
        ok = toptim.guard_nonfinite(tparams.values())
        opt.step()
        assert bool(ok) == bool(jok) == (i != 3)
        for k, p in tparams.items():
            close(p, jparams[k], rtol=1e-5, atol=1e-7, err_msg=f"step {i} {k}")
    assert torch.equal(tparams["frozen"], torch.as_tensor(init["frozen"]))


@pytest.mark.parametrize("kind", ["le_nice", "garf_exponential", "quantized_exponential"])
def test_lr_schedules_match_jax(kind):
    groups = {"a": ParamGroup(5e-4, 1e-5, 100), "b": ParamGroup(1e-3, 1e-5, 0),
              "c": ParamGroup(1e-2, 1e-3, 50, freeze_start_step=10, freeze_end_step=20)}
    jgroups = {k: jcommon.ParamGroup(**dataclasses.asdict(g)) for k, g in groups.items()}
    rows_t = toptim.lr_row_fn(groups, kind, scheduler_steps_per_period=7)
    rows_j = joptim.lr_row_fn(jgroups, kind, scheduler_steps_per_period=7)
    for step in (0, 1, 9, 10, 19, 20, 49, 50, 99, 100, 150):
        want = rows_j(step)
        for k, v in rows_t(step).items():
            assert v == pytest.approx(want[k], rel=1e-6, abs=0.0), (kind, step, k)


def test_sigma_schedules_match_jax():
    for sigma_max in (0.0, 1.0, 8.0):
        for alpha in (0.0, 0.5, 1.0, 2.0, 3.3, 10.0):
            assert tschedules.barf_sigma_alpha(alpha, sigma_max) == pytest.approx(
                float(jschedules.barf_sigma_alpha(jnp.asarray(alpha), sigma_max)), rel=1e-6)
    for step in (0, 5, 10, 15, 20, 25):
        assert tschedules.mip_sigma_schedule(step, 5, 20, 4.0, 2.0) == pytest.approx(
            float(jschedules.mip_sigma_schedule(step, 5, 20, 4.0, 2.0)), rel=1e-6)
    for s in (0.0, 0.2, 0.25, 3.0):
        assert tschedules.sigma_floor(s) == float(jschedules.sigma_floor(jnp.asarray(s)))
    assert tschedules.epoch_fraction(30, 128, 4096) == jschedules.epoch_fraction(30, 128, 4096)


@pytest.mark.parametrize("sigma", [0.0, 0.2, 0.25, 0.3, 0.5, 0.75, 1.0, 1.5, 3.0, 7.9, 8.0,
                                   9.0])
def test_blurred_pixel_colors_matches_jax(sigma):
    sigmas = (8.0, 4.0, 2.0, 1.0, 0.5, 0.0)
    colors = np.random.default_rng(3).uniform(size=(10, len(sigmas), 3)).astype(np.float32)
    got = tsampler.blurred_pixel_colors(torch.as_tensor(colors), sigmas, sigma)
    want = jsampler.blurred_pixel_colors(jnp.asarray(colors), sigmas, jnp.asarray(sigma))
    close(got, want, rtol=0.0, atol=1e-6)


def test_blurred_pixel_colors_refuses_ascending_sigmas():
    with pytest.raises(ValueError):
        tsampler.blurred_pixel_colors(torch.zeros((2, 2, 3)), (0.0, 1.0), 0.5)


# ---------------------------------------------------------------- sampler and checkpoints


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    tsynthetic.generate_dataset(path, n_train=6, n_val=2, n_test=2, image_size=32, n_samples=32)
    return path


def test_ray_store_and_batch_gather_match_jax(scene):
    from nerf_experiments_tpu.data import blender as jblender
    from nerf_experiments_tpu_torch.data import blender as tblender

    kw = dict(scene_path=scene, image_width=32, image_height=32, space_transform_scale=1.0,
              rotation_noise_sigma=0.1, translation_noise_sigma=0.1, camera_noise_seed=3,
              gaussian_blur_sigmas=(1.0, 0.0))
    jdm = jblender.DataModule(space_transform_translate=jnp.zeros(3), **kw)
    tdm = tblender.DataModule(space_transform_translate=np.zeros(3), **kw)
    jdm.setup("fit")
    tdm.setup("fit")
    jstore = jsampler.make_ray_store(jdm.dataset_train)
    tstore = tsampler.make_ray_store(tdm.dataset_train)
    assert tstore.n_rays == jstore.n_rays and tstore.hw == jstore.hw == 32 * 32
    assert tstore.pixel_width == jstore.pixel_width
    idx = np.random.default_rng(4).integers(0, tstore.n_rays, size=64)
    got = tsampler.gather_batch_arrays(tstore.arrays(), tstore.pixel_width, torch.as_tensor(idx))
    want = jsampler.gather_batch_arrays(jstore.arrays(), jstore.pixel_width, jnp.asarray(idx))
    assert set(got) == set(want)
    for k in got:
        close(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    close(tstore.camera_origins_noisy, jstore.camera_origins_noisy, rtol=1e-6, atol=1e-6)


def test_checkpoint_holds_the_optimizer_state(tmp_path):
    _, tcfg = step_configs("proposal")
    params = tbarf.init(torch.Generator().manual_seed(0), tcfg)
    state = tbarf.init_state(tcfg, params)
    batch = {k: torch.as_tensor(v).long() if k == "img_idx" else torch.as_tensor(v)
             for k, v in step_batch().items()}
    step = tbarf.make_train_step(tcfg)
    for _ in range(2):
        state, _ = step(state, batch, None, 2.0, 1.0, 0.0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state)
    mgr.save(7, state.params)  # a params-only file, as the serving tests write
    saved = {k: v.clone() for k, v in state.params.state_dict().items()}

    other = tbarf.init_state(tcfg, tbarf.init(torch.Generator().manual_seed(1), tcfg))
    mgr.restore(other, step=2)
    assert other.step == 2 and other.optimizer.count == 2
    for k, v in other.params.state_dict().items():
        assert torch.equal(v, saved[k]), k
    sa, sb = state.optimizer.state_dict()["adam"], other.optimizer.state_dict()["adam"]
    for pid, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][pid][k]), k
    # both continue identically
    state, _ = step(state, batch, None, 2.0, 1.0, 0.0)
    other, _ = step(other, batch, None, 2.0, 1.0, 0.0)
    for a, b in zip(state.params.parameters(), other.params.parameters()):
        assert torch.equal(a, b)

    # a params-only file restores a state's parameters and step, and a full
    # file restores bare parameters (the serving path)
    fresh = tbarf.init_state(tcfg, tbarf.init(torch.Generator().manual_seed(2), tcfg))
    mgr.restore(fresh, step=7)
    serving = mgr.restore(tbarf.init(torch.Generator().manual_seed(3), tcfg), step=2)
    assert fresh.step == 7 and fresh.optimizer.count == 0
    for k, v in saved.items():
        assert torch.equal(fresh.params.state_dict()[k], v), k
        assert torch.equal(serving.state_dict()[k], v), k


# ---------------------------------------------------------------- trainer


@dataclasses.dataclass
class TinyState:
    params: dict
    step: int = 0


def tiny_store(n_rays=64, n_images=2):
    g = torch.Generator().manual_seed(0)
    return tsampler.RayStore(
        origins_raw=torch.randn((n_rays, 3), generator=g),
        origins_noisy=torch.randn((n_rays, 3), generator=g),
        dirs_raw=torch.randn((n_rays, 3), generator=g),
        dirs_noisy=torch.randn((n_rays, 3), generator=g),
        colors=torch.rand((n_rays, 2, 3), generator=g),
        img_idx=torch.zeros((n_rays,), dtype=torch.int64),
        pixel_width=0.01,
        gaussian_blur_sigmas=(0.0, 0.0),
        camera_origins_raw=torch.zeros((n_images, 3)),
        camera_origins_noisy=torch.zeros((n_images, 3)),
    )


def rows_of(tmp_path):
    return [json.loads(line) for line in open(os.path.join(str(tmp_path), "metrics.jsonl"))]


def tiny_trainer(tmp_path, step_fn, cfg=None, scalar_fn=lambda step, ef: (), **kw):
    cfg = cfg or TrainerConfig(max_steps=10, batch_size=8, log_every_n_steps=5,
                               val_every_n_epochs=1e9)
    return Trainer(cfg=cfg, train_store=tiny_store(), step_fn=step_fn, scalar_fn=scalar_fn,
                   metric_logger=MetricLogger(str(tmp_path)), **kw)


def counting_step(loss_fn=lambda state, batch: batch["colors"].mean()):
    def step_fn(state, batch, gen):
        return TinyState(state.params, state.step + 1), {"loss": loss_fn(state, batch)}
    return step_fn


def test_lr_rows_logged(tmp_path):
    groups = {"radiance": ParamGroup(5e-4, 1e-5, 100), "camera": ParamGroup(1e-3, 1e-5, 100)}
    tr = tiny_trainer(tmp_path, counting_step(), lr_fn=toptim.lr_row_fn(groups))
    tr.fit(TinyState({"w": torch.zeros(3)}))
    rows = rows_of(tmp_path)
    lr_rows = [r for r in rows if "lr_radiance" in r]
    assert lr_rows and all("lr_camera" in r for r in lr_rows)
    for r in lr_rows:
        s = r["step"] - 1
        expected = 5e-4 * np.exp((np.log(1e-5) - np.log(5e-4)) / 100 * min(s, 100))
        assert r["lr_radiance"] == pytest.approx(expected, rel=1e-6)
    assert lr_rows[-1]["lr_radiance"] < lr_rows[0]["lr_radiance"]
    walls = [r["wall_s"] for r in rows if "train_rays_per_sec" in r]
    assert walls and all(b >= a for a, b in zip(walls, walls[1:]))


def test_postmortem_dump_on_first_nonfinite(tmp_path):
    bad_step = 7  # not a log step: the buffered scan must still catch it

    def step_fn(state, batch, gen):
        bad = state.step == bad_step
        loss = torch.tensor(float("nan")) if bad else batch["colors"].mean()
        return (TinyState(state.params, state.step + 1),
                {"loss": loss, "grads_finite": torch.tensor(not bad)})

    tr = tiny_trainer(tmp_path, step_fn,
                      cfg=TrainerConfig(max_steps=20, batch_size=8, log_every_n_steps=5,
                                        val_every_n_epochs=1e9))
    tr.fit(TinyState({"w": torch.zeros(3)}))
    dumps = glob.glob(os.path.join(str(tmp_path), "postmortem_*.npz"))
    assert [os.path.basename(d) for d in dumps] == [f"postmortem_{bad_step}.npz"]
    z = np.load(dumps[0])
    assert int(z["step"]) == bad_step
    # the dumped batch is the exact batch of the offending step
    np.testing.assert_array_equal(z["batch_colors"], tr.regen_batch(bad_step)["colors"].numpy())
    assert int(z["seed"]) == mix_seed(mix_seed(tr.cfg.seed), bad_step)
    assert any(r.get("postmortem_step") == float(bad_step) for r in rows_of(tmp_path))


def test_no_postmortem_when_finite(tmp_path):
    def step_fn(state, batch, gen):
        return (TinyState(state.params, state.step + 1),
                {"loss": batch["colors"].mean(), "grads_finite": torch.tensor(True)})

    tiny_trainer(tmp_path, step_fn).fit(TinyState({"w": torch.zeros(3)}))
    assert not glob.glob(os.path.join(str(tmp_path), "postmortem_*.npz"))


def rollback_cfg(**kw):
    base = dict(max_steps=60, batch_size=8, log_every_n_steps=5, val_every_n_epochs=1e9,
                rollback_enabled=True, rollback_spike_factor=20.0, rollback_patience=3,
                rollback_snapshot_every_n_steps=10, rollback_max=2, rollback_warmup_steps=5)
    base.update(kw)
    return TrainerConfig(**base)


def cliff_step(state, batch, gen):
    # deterministic loss cliff: past 30 steps the loss jumps 1e-3 -> 1.0
    w = state.params["w"] + 1.0
    loss = torch.tensor(1.0 if float(w) > 30.0 else 1e-3)
    return TinyState({"w": w}, state.step + 1), {"loss": loss}


def test_rollback_on_sustained_spike(tmp_path):
    tr = tiny_trainer(tmp_path, cliff_step, cfg=rollback_cfg())
    final = tr.fit(TinyState({"w": torch.tensor(0.0)}))
    rb = [r for r in rows_of(tmp_path) if "rollback" in r]
    # the cliff is deterministic, so every replay re-dives: exactly
    # rollback_max rollbacks, to the last healthy snapshot (step 30)
    assert [r["rollback"] for r in rb] == [1.0, 2.0]
    assert all(r["rollback_to_step"] == 30.0 for r in rb)
    assert all(r["rollback_from_step"] >= 33.0 for r in rb)
    assert tr._base_seed != mix_seed(tr.cfg.seed)  # the seed stream was perturbed
    assert final.step == 60


def test_no_rollback_on_healthy_run(tmp_path):
    def step_fn(state, batch, gen):
        loss = 1e-2 / (1.0 + 0.1 * state.params["w"]) + 1e-4 * batch["colors"].mean()
        return TinyState({"w": state.params["w"] + 1.0}, state.step + 1), {"loss": loss}

    tr = tiny_trainer(tmp_path, step_fn, cfg=rollback_cfg())
    final = tr.fit(TinyState({"w": torch.tensor(0.0)}))
    assert not [r for r in rows_of(tmp_path) if "rollback" in r]
    assert final.step == 60 and tr._rollbacks == 0


def test_rollback_disabled(tmp_path):
    tr = tiny_trainer(tmp_path, cliff_step, cfg=rollback_cfg(rollback_enabled=False))
    final = tr.fit(TinyState({"w": torch.tensor(0.0)}))
    assert not [r for r in rows_of(tmp_path) if "rollback" in r]
    assert final.step == 60 and float(final.params["w"]) == 60.0


def test_val_fn_receives_live_schedule_scalars(tmp_path):
    def step_fn(state, batch, gen, anneal):
        return TinyState(state.params, state.step + 1), {"loss": batch["colors"].mean() * anneal}

    def val_fn(params, batch, anneal):
        return {"psnr": torch.tensor(anneal * 2.0)}

    store = tiny_store()
    tr = Trainer(cfg=TrainerConfig(max_steps=16, batch_size=8, log_every_n_steps=5,
                                   val_every_n_epochs=1.0, val_batches=1),
                 train_store=store, step_fn=step_fn, scalar_fn=lambda step, ef: (0.25 * step,),
                 metric_logger=MetricLogger(str(tmp_path)), val_store=store, val_fn=val_fn)
    tr.fit(TinyState({"w": torch.zeros(3)}))
    rows = [r for r in rows_of(tmp_path) if "val_psnr" in r]
    assert rows, "validation never ran"
    for r in rows:  # the scalars of the train step it follows (step - 1)
        assert abs(r["val_psnr"] - 2 * 0.25 * (r["step"] - 1)) < 1e-6, r


def test_val_fn_without_scalars_still_works(tmp_path):
    store = tiny_store()
    tr = Trainer(cfg=TrainerConfig(max_steps=16, batch_size=8, log_every_n_steps=5,
                                   val_every_n_epochs=1.0, val_batches=1),
                 train_store=store, step_fn=counting_step(), scalar_fn=lambda step, ef: (),
                 metric_logger=MetricLogger(str(tmp_path)), val_store=store,
                 val_fn=lambda params, batch: {"psnr": torch.tensor(1.0)})
    tr.fit(TinyState({"w": torch.zeros(3)}))
    assert any("val_psnr" in r for r in rows_of(tmp_path))


def test_step_streams_depend_on_seed_and_step_only(tmp_path):
    tr = tiny_trainer(tmp_path, counting_step())
    a = tr.regen_batch(3)["colors"]
    tr.regen_batch(5)
    assert torch.equal(tr.regen_batch(3)["colors"], a)
    assert not torch.equal(tr.regen_batch(4)["colors"], a)
    assert len({mix_seed(0, s) for s in range(1000)}) == 1000


# ---------------------------------------------------------------- run_barf end to end


def barf_argv(scene, out_dir, *extra):
    return ["--scene_path", scene, "--image_size", "32", "--device", "cpu",
            "--camera_origin_noise_sigma", "0.0", "--camera_rotation_noise_sigma", "0.0",
            "--no-optimize_camera", "--alpha_decay_start_step", "0",
            "--alpha_decay_end_step", "1", "--fused_kernel", "--out_dir", out_dir, *extra]


def test_run_barf_trains_on_synthetic_scene(scene, tmp_path):
    """`tests/test_end_to_end.py:107-132` through the port's fused step."""
    out = str(tmp_path / "run")
    state = run_barf.main(barf_argv(
        scene, out, "--batch_size", "256", "--max_steps", "300", "--samples_per_ray", "32",
        "--hidden_dim", "64", "--n_hidden", "1", "--checkpoint_every_n_epochs", "0"))
    assert state.step == 300
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    psnrs = [r["psnr"] for r in rows if "psnr" in r and np.isfinite(r["psnr"])]
    assert len(psnrs) >= 2
    assert psnrs[-1] > psnrs[0] + 1.0 and psnrs[-1] > 10.0, psnrs
    assert any("val_psnr" in r for r in rows) and any("pose_error" in r for r in rows)
    assert glob.glob(os.path.join(out, "images", "*.png"))


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(scene, tmp_path):
    """30 steps, then --resume to 50, against 50 steps in one go
    (`tests/test_experiments.py:178-181`), proposal config with camera
    optimisation and pose noise."""
    flags = ["--batch_size", "128", "--samples_per_ray", "8", "--samples_per_ray_proposal", "8",
             "--proposal_hidden_dim", "16", "--hidden_dim", "32", "--n_hidden", "1",
             "--checkpoint_every_n_epochs", "1"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    argv = lambda out: [x for x in barf_argv(scene, out, *flags)
                        if x not in ("--no-optimize_camera",)]
    noise = ["--camera_origin_noise_sigma", "0.1"]
    first = run_barf.main(argv(a) + noise + ["--max_steps", "30"])
    assert first.step == 30
    resumed = run_barf.main(argv(a) + noise + ["--max_steps", "50", "--resume"])
    straight = run_barf.main(argv(b) + noise + ["--max_steps", "50"])
    assert resumed.step == straight.step == 50
    for (k, x), y in zip(resumed.params.state_dict().items(),
                         straight.params.state_dict().values()):
        assert torch.equal(x, y), k
    assert resumed.optimizer.count == straight.optimizer.count == 50
