"""The port's Instant-NGP training slice against the JAX package on the CPU:
one train step of the run_3d_ingp system (coarse + fine hash NeRFs), the
plateau scale of run_2d_ingp against optax, and both entry points end to end
with `render_views --entry ingp` serving the trained checkpoint.

Inputs are made with numpy from a seed (parameters from the JAX package's
init, converted, tables redrawn U(-0.1, 0.1)), TF32 is off and the sampling
is `equidistant`, so no random stream is involved. Tolerances: the loss rtol
1e-5; every gradient rtol 1e-4 with atol 1e-6 of the tensor's largest
magnitude (fp32 summation order: the scatter-add and the matmuls add in
another order); the plateau scale exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_experiments_tpu.encodings.fourier import Fourier as JFourier
from nerf_experiments_tpu.experiments.run_3d_ingp import IngpModelDef as JIngpModelDef
from nerf_experiments_tpu.models import ingp as jingp
from nerf_experiments_tpu.ops import hashgrid as jhash
from nerf_experiments_tpu.systems import barf as jbarf
from nerf_experiments_tpu_torch.data import synthetic as tsynthetic
from nerf_experiments_tpu_torch.encodings.fourier import Fourier as TFourier
from nerf_experiments_tpu_torch.experiments import render_views, run_2d_ingp, run_3d_ingp
from nerf_experiments_tpu_torch.models import ingp as tingp
from nerf_experiments_tpu_torch.ops import hashgrid as thash
from nerf_experiments_tpu_torch.systems import barf as tbarf
from nerf_experiments_tpu_torch.training.optim import ReduceOnPlateau

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **tol)


def step_configs(bf16=False, encoder="fused"):
    """run_3d_ingp's system at a small size in both packages."""
    grid = dict(dim=3, n_levels=4, table_size=1024, resolution_min=4, resolution_max=32)
    model = dict(n_hidden=1, hidden_dim=16, encoder=encoder)
    jdef = JIngpModelDef(cfg=jingp.NerfINGPConfig(
        grid=jhash.HashGridConfig(**grid), direction_encoder=JFourier(levels=4, scale=1.0),
        compute_dtype=jnp.bfloat16 if bf16 else None, **model))
    tdef = run_3d_ingp.IngpModelDef(cfg=tingp.NerfINGPConfig(
        grid=thash.HashGridConfig(**grid), direction_encoder=TFourier(levels=4, scale=1.0),
        compute_dtype=torch.bfloat16 if bf16 else None, **model))
    common = dict(n_training_images=4, near=2.0, far=6.0, samples_per_ray_radiance=8,
                  samples_per_ray_proposal=4, uniform_sampling_strategy="equidistant",
                  optimize_camera=False, adam_eps=1e-15, adam_b2=0.99,
                  gaussian_blur_sigmas=(0.0,))
    return (jbarf.BarfConfig(radiance=jdef, proposal=jdef, **common),
            tbarf.BarfConfig(radiance=tdef, proposal=tdef, **common))


def named(tree):
    """A JAX pytree -> {port parameter name: array}."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def step_batch(n=16, seed=1):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origs = rng.normal(size=(n, 3)) * 0.3
    f32 = lambda a: a.astype(np.float32)
    return {"origs_raw": f32(origs), "origs_noisy": f32(origs), "dirs_raw": f32(dirs),
            "dirs_noisy": f32(dirs), "colors": f32(rng.uniform(size=(n, 1, 3))),
            "img_idx": rng.integers(0, 4, size=n).astype(np.int32),
            "pixel_width": np.full((n, 1), 1e-3, np.float32)}


@pytest.mark.parametrize("encoder", ["fused", "rolled"])
def test_ingp_train_step_matches_jax(encoder):
    """One `train_step` of the coarse + fine hash NeRFs from the same
    parameters and batch: the loss and every gradient handed to the
    optimizer (tables, MLPs, and the camera's, which run through the
    coordinate gradient of the encoding)."""
    jcfg, tcfg = step_configs(encoder=encoder)
    rng = np.random.default_rng(2)
    tree = jax.tree_util.tree_map(np.asarray, jbarf.init(jax.random.PRNGKey(0), jcfg).params)
    for net in ("radiance", "proposal"):
        shape = tree[net]["grid"]["table"].shape
        tree[net]["grid"]["table"] = rng.uniform(-0.1, 0.1, size=shape).astype(np.float32)
    tree["camera"] = {k: (rng.normal(size=(4, 3)) * 0.05).astype(np.float32)
                      for k in ("rotation", "translation")}
    batch = step_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)

    (_, jm), jgrads = jax.value_and_grad(
        lambda p: jbarf.loss_fn(p, jcfg, jbatch, None, 0.0, 0.0, 0.0), has_aux=True)(jtree)
    tx = jbarf.make_optimizer(jcfg, jtree)
    jstate = jbarf.TrainState(params=jtree, opt_state=tx.init(jtree), step=jnp.asarray(0))
    _, jm_step = jbarf.train_step(jstate, jcfg, tx, jbatch, None, 0.0, 0.0, 0.0)

    state = tbarf.init_state(tcfg, tbarf.params_from_numpy(tree, tcfg))
    grads = {}
    adam_step = state.optimizer.step

    def capture_then_step():
        grads.update({k: p.grad.clone() for k, p in state.params.named_parameters()})
        adam_step()

    state.optimizer.step = capture_then_step
    tbatch = {k: torch.as_tensor(v).long() if k == "img_idx" else torch.as_tensor(v)
              for k, v in batch.items()}
    state, metrics = tbarf.make_train_step(tcfg)(state, tbatch, None, 0.0, 0.0, 0.0)
    assert state.step == 1 and bool(metrics["grads_finite"])
    for k in ("loss", "loss_fine", "loss_coarse", "psnr"):
        close(metrics[k], jm_step[k], rtol=1e-5, err_msg=k)
    close(metrics["loss_fine"], jm["loss_fine"], rtol=1e-5)
    want = named(jgrads)
    assert set(grads) == set(want)
    assert float(np.abs(want["camera.rotation"]).max()) > 0  # d_x reaches the camera
    for k, g in grads.items():
        close(g, want[k], rtol=1e-4, atol=1e-6 * float(np.abs(want[k]).max()), err_msg=k)


# ---------------------------------------------------------------- plateau scale


@pytest.mark.parametrize("kw", [dict(), dict(patience=1, accumulation_size=10)])
def test_reduce_on_plateau_matches_optax(kw):
    """600 steps of a noisy loss that is lowest in its first 100 steps and
    then creeps up (windows of 100 plateau from the second on; windows of 10
    improve now and then early on): the scale handed to each step's update
    equals optax's, at run_2d_ingp's settings (the defaults: factor 0.5,
    patience 5, windows of 100) and at short windows."""
    rng = np.random.default_rng(0)
    t = np.arange(600)
    loss = (0.5 + 0.1 * (t >= 100) + t / 5000 + 0.005 * rng.normal(size=600)).astype(np.float32)
    tx = optax.contrib.reduce_on_plateau(**{**dict(factor=0.5, patience=5,
                                                   accumulation_size=100), **kw})
    update = jax.jit(lambda s, v: tx.update({"p": jnp.ones(())}, s, value=v))
    state = tx.init({"p": jnp.zeros(())})
    plateau = ReduceOnPlateau(**kw)
    scales = []
    for v in loss:
        upd, state = update(state, jnp.asarray(v))
        got = plateau.update(torch.tensor(v))
        assert got == float(upd["p"]), len(scales)
        scales.append(got)
    assert len(set(scales)) > 1  # the scale moved


# ---------------------------------------------------------------- entry points


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    tsynthetic.generate_dataset(path, n_train=6, n_val=2, n_test=2, image_size=16, n_samples=32)
    return path


INGP_SIZE = ["--n_levels", "2", "--table_size", "512", "--resolution_max", "16"]


def test_run_3d_ingp_trains_and_render_views_serves_it(scene, tmp_path):
    """`tests/test_experiments.py:test_3d_ingp` through the port, with
    checkpoints, then the serving entry on the trained checkpoint."""
    out = str(tmp_path / "ingp")
    state = run_3d_ingp.main(
        ["--scene_path", scene, "--image_size", "16", "--batch_size", "64", "--max_steps", "30",
         "--samples_per_ray_fine", "8", "--samples_per_ray_coarse", "4",
         "--checkpoint_every_n_epochs", "1", "--device", "cpu", "--out_dir", out] + INGP_SIZE)
    assert state.step == 30
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert losses and all(np.isfinite(v) for v in losses)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["ckpt_25.pt", "ckpt_30.pt"]

    summary = render_views.main(
        ["--entry", "ingp", "--ckpt_dir", os.path.join(out, "ckpt"), "--scene_path", scene,
         "--image_size", "16", "--split", "test", "--n_images", "1", "--chunk", "100",
         "--samples_per_ray", "8", "--samples_per_ray_proposal", "4", "--hidden_dim", "64",
         "--n_hidden", "2", "--ingp_n_levels", "2", "--ingp_table_size", "512",
         "--ingp_resolution_max", "16", "--device", "cpu", "--out_dir", str(tmp_path / "r")])
    assert summary["ckpt_step"] == 30 and np.isfinite(summary["mean_psnr"])
    assert os.path.exists(str(tmp_path / "r" / "renders" / "test_r_0.png"))


def test_run_2d_ingp_fits_the_test_image(tmp_path):
    """`tests/test_experiments.py:test_2d_reconstruction_and_ingp_quick`
    through the port: val PSNR above 12 dB, and --save_image's files."""
    out = str(tmp_path / "g2d")
    params, cfg, result = run_2d_ingp.main(
        ["--image_size", "32", "--steps", "300", "--batch_size", "1024", "--n_levels", "4",
         "--table_size", "2048", "--resolution_max", "32", "--device", "cpu",
         "--save_image", "--out_dir", out])
    assert result["val_psnr"] > 12.0, result
    assert np.isfinite(result["full_image_psnr"])
    assert os.path.exists(os.path.join(out, "recon.png"))
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == result
