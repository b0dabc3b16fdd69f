"""The port's Mip-NeRF / Mip-BARF slice against the JAX package on the CPU:
the integrated encodings, the NerfMLP with them, the flagship render on
equidistant bins with per-ray offsets (`ops/render_megakernel.py`, K11's
plain version), the `run_mip_nerf` and `run_bip_barf` builds and one train
step from converted weights, their training with `--resume`, `render_views
--entry mip|bip`, and the thin entry points built on them.

Inputs are made with numpy from a seed; the train steps compare with
`equidistant` sampling (no random stream). Tolerances: encodings rtol 1e-5 /
atol 1e-6 (fp32 rounding); the MLP rtol 1e-5 / atol 1e-5 (a chain of
matmuls), bf16 atol 2e-2; K11's plain version rtol 1e-5 / atol 1e-5 against
the JAX kernel in interpret mode (summation order), bf16 atol 2e-2; one
train step: losses rtol 1e-5, parameters after Adam rtol 1e-4 / atol 1e-6
(as `test_torch_train.py`).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.encodings import fourier as jfourier
from nerf_experiments_tpu.experiments import run_bip_barf as jbip
from nerf_experiments_tpu.experiments import run_mip_nerf as jmip
from nerf_experiments_tpu.models import nerf_mlp as jmlp
from nerf_experiments_tpu.ops import render_megakernel as jrm
from nerf_experiments_tpu.systems import barf as jbarf
from nerf_experiments_tpu_torch.data import synthetic as tsynthetic
from nerf_experiments_tpu_torch.encodings import fourier as tfourier
from nerf_experiments_tpu_torch.experiments import render_views
from nerf_experiments_tpu_torch.experiments import run_bip_barf as tbip
from nerf_experiments_tpu_torch.experiments import run_mip_nerf as tmip
from nerf_experiments_tpu_torch.models import nerf_mlp as tmlp
from nerf_experiments_tpu_torch.ops import render_megakernel as trm
from nerf_experiments_tpu_torch.systems import barf as tbarf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ENC = dict(rtol=1e-5, atol=1e-6)
MLP = {False: dict(rtol=1e-5, atol=1e-5), True: dict(rtol=0.0, atol=2e-2)}


def close(port, ref, **tol):
    np.testing.assert_allclose(
        np.asarray(port.detach() if torch.is_tensor(port) else port, np.float32),
        np.asarray(ref, np.float32), **tol)


def frusta(n, seed):
    """Sample positions, unit directions, pixel widths and bins (t_start, t_end)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    x = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    pw = rng.uniform(1e-3, 4e-3, size=(n, 1)).astype(np.float32)
    ts = rng.uniform(0.1, 0.3, size=(n, 1)).astype(np.float32)
    te = (ts + rng.uniform(1e-3, 5e-3, size=(n, 1))).astype(np.float32)
    return x, d, pw, ts, te


# ---------------------------------------------------------------- encodings


@pytest.mark.parametrize("sigma", [0.0, 0.2, 3.0])
@pytest.mark.parametrize("distribute_variance", [False, True])
@pytest.mark.parametrize("identity", [True, False])
def test_integrated_encoding_matches_jax(identity, distribute_variance, sigma):
    """Mip-NeRF's IPE, with the extra-blur `pixel_width_sigma` (it counts only
    above 1/4: 0.2 is no blur)."""
    kw = dict(levels=4, scale=1.0, include_identity=identity,
              distribute_variance=distribute_variance)
    je, te = jfourier.Integrated(**kw), tfourier.Integrated(**kw)
    assert te.output_dim == je.output_dim
    arrays = frusta(24, 0)
    want = je(*(jnp.asarray(a) for a in arrays), pixel_width_sigma=sigma)
    got = te(*(torch.as_tensor(a) for a in arrays), pixel_width_sigma=sigma)
    close(got, want, **ENC)


@pytest.mark.parametrize("alpha", [None, 0.0, 2.3])
@pytest.mark.parametrize("sigma", [0.0, 3.0])
@pytest.mark.parametrize("identity", [True, False])
def test_integrated_barf_encoding_matches_jax(identity, sigma, alpha):
    kw = dict(levels=4, scale=1.0, include_identity=identity, alpha_start=0.5,
              alpha_increase_start_epoch=0.2, alpha_increase_end_epoch=2.0)
    je, te = jfourier.IntegratedBarf(**kw), tfourier.IntegratedBarf(**kw)
    assert te.output_dim == je.output_dim
    arrays = frusta(24, 1)
    want = je(*(jnp.asarray(a) for a in arrays), pixel_width_sigma=sigma,
              alpha=None if alpha is None else jnp.asarray(alpha))
    got = te(*(torch.as_tensor(a) for a in arrays), pixel_width_sigma=sigma, alpha=alpha)
    close(got, want, **ENC)
    for epoch in (0.0, 0.7, 1.5, 3.0):
        close(te.alpha_at(epoch), je.alpha_at(epoch), rtol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("sigma", [0.0, 3.0])
def test_nerf_mlp_with_integrated_encoding_matches_jax(sigma, bf16):
    """`NerfMLPDef.apply` hands `pixel_width_sigma` to the integrated
    position encoder, as the JAX package does."""
    kw = dict(n_hidden=2, hidden_dim=32, n_segments=2, delayed_direction=True,
              delayed_density=False)
    jcfg = jmlp.NerfMLPConfig(
        position_encoder=jfourier.Integrated(levels=4, scale=1.0),
        direction_encoder=jfourier.Fourier(levels=2, scale=1.0),
        compute_dtype=jnp.bfloat16 if bf16 else None, **kw)
    tcfg = tmlp.NerfMLPConfig(
        position_encoder=tfourier.Integrated(levels=4, scale=1.0),
        direction_encoder=tfourier.Fourier(levels=2, scale=1.0),
        compute_dtype=torch.bfloat16 if bf16 else None, **kw)
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init(jax.random.PRNGKey(1), jcfg))
    tdef = tbarf.NerfMLPDef(tcfg)
    params = tdef.from_numpy(tree)
    arrays = frusta(32, 2)
    want = jbarf.NerfMLPDef(jcfg).apply(tree, *(jnp.asarray(a) for a in arrays), 0.0, 0.0,
                                        pixel_width_sigma=sigma)
    got = tdef.apply(params, *(torch.as_tensor(a) for a in arrays), 0.0, 0.0,
                     pixel_width_sigma=sigma)
    for a, b in zip(got, want):
        close(a, b, **MLP[bf16])


# ---------------------------------------------------------------- K11's plain version


def flagship_cfgs(bf16=False, **kw):
    enc = dict(scale=1.0, include_identity=True)
    arch = dict(n_hidden=2, hidden_dim=32, n_segments=2, delayed_direction=True,
                delayed_density=False)
    arch.update(kw)
    return (jmlp.NerfMLPConfig(position_encoder=jfourier.Barf(levels=4, **enc),
                               direction_encoder=jfourier.Barf(levels=2, **enc),
                               compute_dtype=jnp.bfloat16 if bf16 else None, **arch),
            tmlp.NerfMLPConfig(position_encoder=tfourier.Barf(levels=4, **enc),
                               direction_encoder=tfourier.Barf(levels=2, **enc),
                               compute_dtype=torch.bfloat16 if bf16 else None, **arch))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [16, 37])
def test_render_megakernel_plain_version_matches_jax_kernel(n, bf16):
    """`render_megakernel.flagship_render` on CPU tensors (its plain version)
    against the JAX `flagship_render` (K11) in interpret mode, with per-ray
    offsets in [-interval, 0) and a ragged ray count."""
    jcfg, tcfg = flagship_cfgs(bf16)
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init(jax.random.PRNGKey(2), jcfg))
    params = tmlp.from_numpy(tree, tcfg)
    rng = np.random.default_rng(3)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    s, near, far = 12, 2.0, 6.0
    offsets = (-rng.uniform(size=(n, 1)) * (far - near) / s).astype(np.float32)
    want = jrm.flagship_render(tree, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(offsets),
                               3.0, 1.5, s, near, far, interpret=True)
    got = trm.flagship_render(params, tcfg, torch.as_tensor(o), torch.as_tensor(d),
                              torch.as_tensor(offsets), 3.0, 1.5, s, near, far)
    assert got.shape == (n, 3)
    close(got, want, **MLP[bf16])
    same = trm.render_megakernel_reference(params, tcfg, torch.as_tensor(o), torch.as_tensor(d),
                                           torch.as_tensor(offsets), 3.0, 1.5, s, near, far)
    assert torch.equal(got, same)


def test_equidistant_bins_end_at_far():
    offsets = torch.tensor([[0.0], [-0.25]])
    ts, te = trm.equidistant_bins(offsets, 4, 2.0, 6.0)
    torch.testing.assert_close(ts, torch.tensor([[2.0, 3.0, 4.0, 5.0], [1.75, 2.75, 3.75, 4.75]]))
    torch.testing.assert_close(te, torch.tensor([[3.0, 4.0, 5.0, 6.0], [2.75, 3.75, 4.75, 6.0]]))


@pytest.mark.parametrize("change", [dict(delayed_density=True), dict(n_segments=3),
                                    dict(delayed_direction=False)])
def test_render_megakernel_refuses_other_configs_as_jax_does(change):
    jcfg, tcfg = flagship_cfgs(**change)
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init(jax.random.PRNGKey(4), jcfg))
    params = tmlp.from_numpy(tree, tcfg)
    o, d, off = np.zeros((4, 3), np.float32), np.tile([[0.0, 0.0, 1.0]], (4, 1)).astype(
        np.float32), np.zeros((4, 1), np.float32)
    with pytest.raises(ValueError, match="canonical BARF config"):
        jrm.flagship_render(tree, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(off), 3.0,
                            1.5, 8, 2.0, 6.0, interpret=True)
    with pytest.raises(ValueError, match="canonical BARF config"):
        trm.flagship_render(params, tcfg, *(torch.as_tensor(a) for a in (o, d, off)), 3.0, 1.5,
                            8, 2.0, 6.0)


# ---------------------------------------------------------------- the entry points


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    tsynthetic.generate_dataset(path, n_train=6, n_val=2, n_test=2, image_size=16, n_samples=32)
    return path


# the model flags, which `render_views` takes too
ENTRY_FLAGS = {
    "mip": ["--hidden_dim", "16", "--n_hidden", "1", "--samples_per_ray", "8",
            "--samples_per_ray_proposal", "4"],
    "bip": ["--hidden_dim", "16", "--n_hidden", "1", "--samples_per_ray", "8"],
}


def assert_same_config(j, t, path="cfg"):
    """Field by field of the port's config (the JAX one also has the options
    that are not ported: the occupancy grid); encoders and MLP configs by
    class name and fields."""
    if dataclasses.is_dataclass(j):
        assert type(j).__name__ == type(t).__name__, path
        for f in dataclasses.fields(t):
            assert_same_config(getattr(j, f.name), getattr(t, f.name), f"{path}.{f.name}")
    elif f"{j}".startswith("<class 'jax.numpy") or j is jnp.bfloat16:
        assert t == torch.bfloat16, path
    elif isinstance(j, (tuple, list)):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same_config(a, b, f"{path}[{i}]")
    elif isinstance(j, float) or isinstance(t, float):
        assert j == pytest.approx(t, rel=1e-12), path
    else:
        assert j == t, path


def named(tree, prefix):
    out = {}
    for i, seg in enumerate(tree["segments"]):
        for j, layer in enumerate(seg["layers"]):
            out.update({f"{prefix}segments.{i}.layers.{j}.{k}": layer[k] for k in ("w", "b")})
    for c, layer in enumerate(tree["color"]):
        out.update({f"{prefix}color.{c}.{k}": layer[k] for k in ("w", "b")})
    return out


@pytest.mark.parametrize("entry", ["mip", "bip"])
def test_entry_builds_and_one_step_match_jax(entry, scene, tmp_path):
    """The JAX entry point's experiment and the port's: the same config, the
    same per-step scalars (BIP: the Mip sigma schedule in place of the
    alpha schedule), and one plain train step from the same converted
    weights and batch (equidistant bins, so no random stream) gives the same
    loss and parameters."""
    jmod, tmod = {"mip": (jmip, tmip), "bip": (jbip, tbip)}[entry]
    argv = (["--scene_path", scene, "--image_size", "16", "--batch_size", "16", "--max_steps",
             "10"] + ENTRY_FLAGS[entry])
    jexp = jmod.build(jmod.parse_args(argv + ["--out_dir", str(tmp_path / "j")]))
    texp = tmod.build(tmod.parse_args(argv + ["--out_dir", str(tmp_path / "t"),
                                              "--device", "cpu"]))
    assert_same_config(jexp.cfg, texp.cfg)
    for step in (0, 2500, 60_000, 150_000):
        ef = step * 16 / (6 * 16 * 16)
        for a, b in zip(jexp.trainer.scalar_fn(step, ef), texp.trainer.scalar_fn(step, ef)):
            assert float(b) == pytest.approx(float(a), rel=1e-6, abs=1e-7), step

    jcfg, tcfg = (dataclasses.replace(c, uniform_sampling_strategy="equidistant",
                                      uniform_sampling_offset_size=0.0)
                  for c in (jexp.cfg, texp.cfg))
    tree = jax.tree_util.tree_map(np.asarray, jexp.state.params)
    rng = np.random.default_rng(5)
    n_img = jcfg.n_training_images
    tree["camera"] = {k: (rng.normal(size=(n_img, 3)) * 0.02).astype(np.float32)
                      for k in ("rotation", "translation")}
    tx = jbarf.make_optimizer(jcfg, tree)
    jstate = jbarf.TrainState(params=jax.tree_util.tree_map(jnp.asarray, tree),
                              opt_state=tx.init(tree), step=jnp.asarray(0))
    n = 16
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (-3.0 * d + rng.normal(size=(n, 3)) * 0.05).astype(np.float32) * (
        0.05 if entry == "mip" else 1.0)
    batch = {"origs_raw": o, "origs_noisy": o, "dirs_raw": d, "dirs_noisy": d,
             "colors": rng.uniform(size=(n, len(jcfg.gaussian_blur_sigmas), 3)).astype(
                 np.float32),
             "img_idx": rng.integers(0, n_img, size=n).astype(np.int32),
             "pixel_width": np.full((n, 1), 2e-3, np.float32)}
    scalars = tuple(float(v) for v in jexp.trainer.scalar_fn(2500, 0.5))
    js, jm = jbarf.train_step(jstate, jcfg, tx, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(3), *scalars)
    state = tbarf.init_state(tcfg, tbarf.params_from_numpy(tree, tcfg))
    tbatch = {k: torch.as_tensor(v).long() if k == "img_idx" else torch.as_tensor(v)
              for k, v in batch.items()}
    state, tm = tbarf.make_train_step(tcfg)(state, tbatch, None, *scalars)
    assert bool(tm["grads_finite"])
    for k in ("loss", "loss_fine") + (("loss_coarse",) if "loss_coarse" in jm else ()):
        close(tm[k], jm[k], rtol=1e-5)
    want = named(jax.tree_util.tree_map(np.asarray, js.params["radiance"]), "radiance.")
    want.update({f"camera.{k}": np.asarray(v) for k, v in js.params["camera"].items()})
    got = state.params.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        close(v, want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def psnrs(out):
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    return [r["psnr"] for r in rows if "psnr" in r and np.isfinite(r["psnr"])]


@pytest.mark.parametrize("entry", ["mip", "bip"])
def test_entry_trains_resumes_and_render_views_serves_it(entry, scene, tmp_path):
    """A short run with checkpoints, `--resume` to a later step, then
    `render_views --entry mip|bip` on the checkpoint, all on the CPU."""
    tmod = {"mip": tmip, "bip": tbip}[entry]
    out = str(tmp_path / entry)
    argv = (["--scene_path", scene, "--image_size", "16", "--batch_size", "16", "--device",
             "cpu", "--out_dir", out, "--checkpoint_every_n_epochs", "0.5"] + ENTRY_FLAGS[entry])
    first = tmod.main(argv + ["--max_steps", "6"])
    assert first.step == 6 and psnrs(out)
    resumed = tmod.main(argv + ["--max_steps", "9", "--resume"])
    assert resumed.step == 9
    summary = render_views.main(
        ["--ckpt_dir", os.path.join(out, "ckpt"), "--entry", entry, "--scene_path", scene,
         "--image_size", "16", "--split", "test", "--n_images", "1", "--device", "cpu",
         "--out_dir", str(tmp_path / "render")] + ENTRY_FLAGS[entry])
    assert summary["ckpt_step"] == 9 and np.isfinite(summary["mean_psnr"])


@pytest.mark.parametrize("entry,extra", [
    ("run_mip_blur_test", ["--hidden_dim", "16", "--n_hidden", "1", "--samples_per_ray", "8"]),
    ("run_vanilla_as_barf", ["--hidden_dim", "16", "--n_hidden", "1", "--samples_per_ray", "8"]),
    ("run_naive_as_barf", ["--hidden_dim", "16", "--n_hidden", "1", "--samples_per_ray", "8"]),
    ("run_naive_to_vanilla", ["--hidden_dim", "16", "--n_hidden", "1",
                              "--samples_per_ray_coarse", "4", "--samples_per_ray_fine", "8"]),
])
def test_thin_entry_points_train(entry, extra, scene, tmp_path):
    import importlib

    module = importlib.import_module(f"nerf_experiments_tpu_torch.experiments.{entry}")
    state = module.main(["--scene_path", scene, "--image_size", "16", "--batch_size", "16",
                         "--max_steps", "3", "--checkpoint_every_n_epochs", "0", "--device",
                         "cpu", "--out_dir", str(tmp_path)] + extra)
    assert state.step == 3 and psnrs(str(tmp_path))


def test_sampling_grid_runs_its_cells(scene, tmp_path):
    from nerf_experiments_tpu_torch.experiments import run_sampling_test

    results = run_sampling_test.main(
        ["--scene_path", scene, "--image_size", "16", "--batch_size", "16", "--hidden_dim",
         "16", "--n_hidden", "1", "--steps_per_cell", "2", "--integrations", "left",
         "--device", "cpu", "--out_dir", str(tmp_path)])
    assert [r["cell"] for r in results] == ["stratified_uniform_left_off0.0",
                                            "equidistant_left_off0.0",
                                            "equidistant_left_off-1.0"]
    assert all(np.isfinite(r["final_psnr"]) for r in results)
    assert json.load(open(tmp_path / "summary.json")) == results
