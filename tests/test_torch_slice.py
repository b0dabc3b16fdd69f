"""The port's serving slice against the JAX package on the CPU: cameras and
the Kabsch gauge, the Blender data module's noisy poses, and
`render_views` end to end for a dense and a north-star (proposal) config on
a tiny generated scene, from a checkpoint of converted parameters.

Tolerances: cameras and gauge atol=1e-5 (an SVD in each framework);
per-pixel rgb atol=2e-5 and mean PSNR rtol=1e-5 (the gauge, then chains of
matmuls, in fp32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.cameras import calibration as jcal
from nerf_experiments_tpu.data import blender as jblender
from nerf_experiments_tpu.data import synthetic as jsynthetic
from nerf_experiments_tpu.encodings.fourier import Barf as JBarf
from nerf_experiments_tpu.models import nerf_mlp as jmlp
from nerf_experiments_tpu.systems import barf as jbarf
from nerf_experiments_tpu_torch.cameras import calibration as tcal
from nerf_experiments_tpu_torch.cameras import extrinsics as text
from nerf_experiments_tpu_torch.data import blender as tblender
from nerf_experiments_tpu_torch.experiments import render_views
from nerf_experiments_tpu_torch.systems import barf as tbarf
from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CAM = dict(rtol=1e-5, atol=1e-5)
IMAGE = 16
SEED = 11


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **tol)


def camera_tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"rotation": (rng.normal(size=(n, 3)) * 0.05).astype(np.float32),
            "translation": (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)}


def test_cameras_and_gauge_match_jax():
    rng = np.random.default_rng(1)
    n = 12
    cam = camera_tree(n)
    raw = rng.normal(size=(n, 3)).astype(np.float32)
    noisy = (raw + rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    tcam = text.Extrinsics(torch.tensor(cam["rotation"]), torch.tensor(cam["translation"]))
    jcam = {k: jnp.asarray(v) for k, v in cam.items()}
    T = torch.as_tensor

    close(tcal.predicted_train_origins(tcam, T(noisy)),
          jcal.predicted_train_origins(jcam, jnp.asarray(noisy)), **CAM)
    gauge_t = tcal.post_transform_params(tcam, T(raw), T(noisy))
    gauge_j = jcal.post_transform_params(jcam, jnp.asarray(raw), jnp.asarray(noisy))
    for a, b in zip(gauge_t, gauge_j):
        close(a, b, **CAM)
    o = rng.normal(size=(20, 3)).astype(np.float32)
    d = rng.normal(size=(20, 3)).astype(np.float32)
    for a, b in zip(tcal.validation_transform_rays(T(o), T(d), gauge_t),
                    jcal.validation_transform_rays(jnp.asarray(o), jnp.asarray(d), gauge_j)):
        close(a, b, **CAM)
    idx = rng.integers(0, n, size=20)
    for a, b in zip(tcal.training_transform_rays(tcam, T(idx), T(o), T(d)),
                    jcal.training_transform_rays(jcam, jnp.asarray(idx), jnp.asarray(o),
                                                 jnp.asarray(d))):
        close(a, b, **CAM)
    close(tcal.compute_pose_error(tcam, T(raw), T(noisy)),
          jcal.compute_pose_error(jcam, jnp.asarray(raw), jnp.asarray(noisy)), **CAM)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    jsynthetic.generate_dataset(path, n_train=6, n_val=2, n_test=2, image_size=IMAGE,
                                n_samples=32)
    return path


def data_modules(scene, stage):
    kw = dict(scene_path=scene, image_width=IMAGE, image_height=IMAGE,
              space_transform_scale=1.0, rotation_noise_sigma=0.15,
              translation_noise_sigma=0.15, camera_noise_seed=SEED,
              gaussian_blur_sigmas=(0.0, 0.0), validation_fraction=0.06,
              validation_fraction_shuffle=1234)
    jdm = jblender.DataModule(space_transform_translate=jnp.zeros(3), **kw)
    tdm = tblender.DataModule(space_transform_translate=np.zeros(3), **kw)
    jdm.setup(stage)
    tdm.setup(stage)
    return jdm, tdm


@pytest.mark.parametrize("stage", ["fit", "test"])
def test_blender_data_module_matches_jax(scene, stage):
    jdm, tdm = data_modules(scene, stage)
    splits = ["dataset_train", "dataset_val" if stage == "fit" else "dataset_test"]
    for split in splits:
        j, t = getattr(jdm, split), getattr(tdm, split)
        assert j.image_index_to_name == t.image_index_to_name
        np.testing.assert_array_equal(j.images, t.images)
        np.testing.assert_array_equal(j.camera_origins, t.camera_origins)
        # rays: the JAX loader may take its native C++ path (same math, fp32
        # rounding in another order); the port always takes the numpy path
        for field in ("ray_origins", "ray_directions", "camera_origins_noisy",
                      "camera_directions_noisy", "ray_origins_noisy", "ray_directions_noisy"):
            close(getattr(t, field), getattr(j, field), rtol=1e-6, atol=1e-6)
        assert t.pixel_width == j.pixel_width


# the two configs of the slice, cut to a narrow width, and the dense one with
# 6 direction levels: render_views serves at a direction alpha of 4.0, as the
# JAX package's does, not with every level on
CONFIGS = {
    "dense": ["--samples_per_ray", "16", "--n_hidden", "2", "--hidden_dim", "32"],
    "dense_dir6": ["--samples_per_ray", "16", "--n_hidden", "2", "--hidden_dim", "32",
                   "--fourier_levels_dir", "6"],
    "northstar": ["--samples_per_ray", "8", "--samples_per_ray_proposal", "16",
                  "--proposal_hidden_dim", "16", "--proposal_n_hidden", "1",
                  "--n_hidden", "2", "--hidden_dim", "32"],
}


def jax_config(flags, n_train):
    """The JAX BarfConfig `run_barf.build` makes for these flags."""
    f = dict(zip(flags[::2], flags[1::2]))
    enc = dict(include_identity=True, scale=1.0)

    def mlp(n_hidden, hidden_dim, n_segments):
        return jmlp.NerfMLPConfig(
            position_encoder=JBarf(levels=10, **enc),
            direction_encoder=JBarf(levels=int(f.get("--fourier_levels_dir", 4)), **enc),
            n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=n_segments)

    proposal = None
    n_prop = int(f.get("--samples_per_ray_proposal", 0))
    if n_prop:
        proposal = mlp(int(f["--proposal_n_hidden"]), int(f["--proposal_hidden_dim"]), 1)
    return jbarf.BarfConfig(
        radiance=mlp(int(f["--n_hidden"]), int(f["--hidden_dim"]), 2), proposal=proposal,
        n_training_images=n_train, near=2.0, far=8.0,
        samples_per_ray_radiance=int(f["--samples_per_ray"]),
        samples_per_ray_proposal=n_prop,
        uniform_sampling_strategy="equidistant", uniform_sampling_offset_size=-1.0)


def jax_render(params, cfg, dm, chunk, n_images):
    """The JAX package's `render_views._render` flow, without orbax."""
    ds = dm.dataset_test
    raw = jnp.asarray(dm.dataset_train.camera_origins)
    noisy = jnp.asarray(dm.dataset_train.camera_origins_noisy)
    gauge = jbarf.val_gauge(params, raw, noisy)

    @jax.jit
    def render_chunk(o, d, pw):
        o, d = jcal.validation_transform_rays(o, d, gauge)
        rgb, _ = jbarf.forward(params, cfg, None, o, d, pw, jnp.asarray(10.0),
                               jnp.asarray(4.0), stratified=False)
        return jnp.clip(rgb, 0.0, 1.0)

    images, psnrs = [], []
    for i in range(n_images):
        out = np.concatenate([
            np.asarray(render_chunk(jnp.asarray(ds.ray_origins[i][lo:lo + chunk]),
                                    jnp.asarray(ds.ray_directions[i][lo:lo + chunk]),
                                    jnp.full((len(ds.ray_origins[i][lo:lo + chunk]), 1),
                                             ds.pixel_width)))
            for lo in range(0, IMAGE * IMAGE, chunk)])
        target = ds.images[i, :, :, -1, :].reshape(-1, 3)
        psnrs.append(-10.0 * np.log10(np.mean((out - target) ** 2)))
        images.append(out)
    return images, float(np.mean(psnrs))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_views_matches_jax_flow(scene, tmp_path, name):
    flags = CONFIGS[name]
    jdm, tdm = data_modules(scene, "test")
    n_train = jdm.dataset_train.n_images
    cfg = jax_config(flags, n_train)
    k_rad, k_prop = jax.random.split(jax.random.PRNGKey(3))
    tree = {"radiance": jmlp.init(k_rad, cfg.radiance), "camera": camera_tree(n_train, 4)}
    if cfg.proposal is not None:
        tree["proposal"] = jmlp.init(k_prop, cfg.proposal)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    chunk = 100  # 256 rays: two full chunks and a ragged one

    want_images, want_psnr = jax_render(
        jax.tree_util.tree_map(jnp.asarray, tree), cfg, jdm, chunk, n_images=2)

    argv_cfg = ["--scene_path", scene, "--image_size", str(IMAGE), "--seed", str(SEED)] + flags
    from nerf_experiments_tpu_torch.experiments import run_barf

    exp = run_barf.build(run_barf.parse_args(argv_cfg), device="cpu")
    params = tbarf.params_from_numpy(tree, exp.cfg)
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(5, params)
    summary = render_views.main(["--ckpt_dir", ckpt, "--split", "test", "--n_images", "2",
                                 "--chunk", str(chunk), "--device", "cpu",
                                 "--out_dir", str(tmp_path / "out")] + argv_cfg)
    assert summary["ckpt_step"] == 5 and summary["split"] == "test"
    assert len(summary["per_image"]) == 2
    np.testing.assert_allclose(summary["mean_psnr"], want_psnr, rtol=1e-5)
    assert os.path.exists(tmp_path / "out" / "render_summary.json")

    raw = torch.as_tensor(tdm.dataset_train.camera_origins)
    noisy = torch.as_tensor(tdm.dataset_train.camera_origins_noisy)
    gauge = tbarf.val_gauge(params, raw, noisy)
    for i in range(2):
        got = render_views.render_image(
            params, exp.cfg, tdm.dataset_test.ray_origins[i], tdm.dataset_test.ray_directions[i],
            gauge, tdm.dataset_test.pixel_width, chunk, "cpu", 10.0, 4.0)
        np.testing.assert_allclose(got, want_images[i], rtol=0.0, atol=2e-5)


@pytest.mark.parametrize("start,n", [(0.0, 10), (0.2, 10), (2.0, 2), (4.0, 10), (16.0, 6)])
def test_blur_sigma_ladder_matches_jax(start, n):
    from nerf_experiments_tpu.experiments import common as jcommon
    from nerf_experiments_tpu_torch.experiments import common as tcommon

    assert tcommon.blur_sigmas_from_start(start, n) == jcommon.blur_sigmas_from_start(start, n)
