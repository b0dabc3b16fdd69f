"""The port's tools and studies against the JAX package on the CPU: the
presets (`utils/config.py`), the sweep launcher, the profiling hooks and the
four studies.

Inputs are made with numpy from a seed; the iterative studies start from the
JAX package's own starting points (`init=`). Tolerances: the closed-form
alignment 1e-5; SGD from the same start 1e-5 (loss curve and A); the
Gauss-MLP fits after 40 Adam steps 1e-4 relative (the custom-gradient
activation's exponentials in another order); the PE-mask weights 1e-5.
"""
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.experiments import sweep as jsweep
from nerf_experiments_tpu.experiments.studies import bulge as jbulge
from nerf_experiments_tpu.experiments.studies import camera_similarity as jcs
from nerf_experiments_tpu.experiments.studies import visualise_pe_mask as jpe
from nerf_experiments_tpu.ops.lie import so3_exp as jso3_exp
from nerf_experiments_tpu.utils import config as jconfig
from nerf_experiments_tpu_torch.experiments import sweep
from nerf_experiments_tpu_torch.experiments.studies import (bulge, camera_similarity,
                                                             rotation_check, visualise_pe_mask)
from nerf_experiments_tpu_torch.utils import config, profiling


@pytest.fixture(autouse=True)
def one_thread():
    """Small ops: one intra-op thread each (six test workers share the
    host's cores; spinning thread pools would slow every worker)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- presets


def test_presets_match_jax_names_and_argv():
    assert list(config.PRESETS) == list(jconfig.PRESETS)
    for name, p in config.PRESETS.items():
        j = jconfig.PRESETS[name]
        assert (p.name, p.module, p.argv) == (j.name, j.module, j.argv)
    assert "siren_lego_400" in config.PRESETS


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_preset_parses_with_the_port_entry(name):
    """Every preset's argv parses with the port's entry point, to the values
    the JAX entry parses (the port adds --device, on the card by default)."""
    p = config.PRESETS[name]
    args = p.parse()
    assert p.entry().__name__ == f"nerf_experiments_tpu_torch.experiments.{p.module}"
    assert args.device == "cuda"
    want = vars(importlib.import_module(
        f"nerf_experiments_tpu.experiments.{p.module}").parse_args(list(p.argv)))
    got = vars(args)
    for k, v in want.items():
        if k in got:
            assert got[k] == v, (name, k)


# ---------------------------------------------------------------- sweep


def test_sweep_writes_the_jax_scripts_for_the_port(tmp_path):
    argv = ["--module", "run_barf", "--grid", "start_blur_sigma=0,20", "seed=1,2",
            "--extra", "--device cpu"]
    scripts = sweep.main(argv + ["--out_dir", str(tmp_path / "t")])
    jscripts = jsweep.main(argv + ["--out_dir", str(tmp_path / "j")])
    assert [os.path.basename(s) for s in scripts] == [os.path.basename(s) for s in jscripts]
    for s, j in zip(scripts, jscripts):
        body, jbody = open(s).read(), open(j).read()
        assert body == jbody.replace("nerf_experiments_tpu.", "nerf_experiments_tpu_torch.") \
            .replace(str(tmp_path / "j"), str(tmp_path / "t"))
        assert "-m nerf_experiments_tpu_torch.experiments.run_barf" in body
        assert os.access(s, os.X_OK)
    assert "--start_blur_sigma 0 --seed 1 --device cpu" in open(scripts[0]).read()


def test_sweep_grid_and_product_match_jax():
    items = ["a=1,2,3", "b=x,y", "c=z"]
    assert sweep.parse_grid(items) == jsweep.parse_grid(items)
    got = list(sweep.combinations(sweep.parse_grid(items)))
    assert got == list(jsweep.combinations(jsweep.parse_grid(items))) and len(got) == 6


def test_sweep_runs_in_process(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(sweep.subprocess, "run", lambda cmd, check: calls.append(cmd))
    sweep.main(["--module", "run_2d_reconstruction", "--grid", "steps=1,2", "--run",
                "--extra", "--device cpu", "--out_dir", str(tmp_path)])
    assert [c[:3] for c in calls] == [[sys.executable, "-m",
                                       "nerf_experiments_tpu_torch.experiments."
                                       "run_2d_reconstruction"]] * 2
    assert calls[1][3:7] == ["--steps", "2", "--device", "cpu"]


# ---------------------------------------------------------------- profiling


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("netpu_step"):
            (x @ x).sum()
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "netpu_step" for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


# ---------------------------------------------------------------- studies


def test_bulge_matches_jax():
    assert bulge.bulge_study() == jbulge.bulge_study()
    out = bulge.bulge_study()
    assert out["const_z_line_linear_residual"] < 1e-9 and out["const_x_depth_nonlinearity"] > 1e-2


def test_rotation_conventions_hold(tmp_path):
    checks = rotation_check.convention_checks()
    assert all(checks.values()) and len(checks) == 5
    frames = rotation_check.render_teapot_frames(4)
    assert len(frames) == 4 and np.allclose(frames[0], frames[0] @ np.eye(3))
    np.testing.assert_allclose(frames[1][0], [1, -1, -1], atol=1e-6)  # (-1,-1,-1) turned 90


def test_pe_mask_weights_match_jax(tmp_path):
    ts, got = visualise_pe_mask.pe_mask_weights(levels=6, alphas=(0.0, 2.5, 6.0), n_t=8)
    jts, want = jpe.pe_mask_weights(levels=6, alphas=(0.0, 2.5, 6.0), n_t=8)
    np.testing.assert_array_equal(ts, jts)
    for a in (0.0, 2.5, 6.0):
        np.testing.assert_allclose(got[a], np.asarray(want[a]), rtol=0, atol=1e-5)
    assert got[0.0].max() < 1e-6 and got[6.0].sum() > got[2.5].sum() > 0
    path = visualise_pe_mask.main(["--out_dir", str(tmp_path), "--levels", "4"])
    assert set(np.load(path).files) == {"t", "alpha_0.0", "alpha_2.5", "alpha_5.0",
                                        "alpha_10.0"}


def similarity_problem(seed=0, n=40):
    pts = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    R = np.asarray(jso3_exp(jnp.array([0.4, -0.2, 0.9])))
    target = (pts @ R.T * 1.3 + np.array([1.0, 2.0, -0.5])).astype(np.float32)
    return pts, target


def test_closed_form_align_matches_jax():
    pts, target = similarity_problem()
    got = camera_similarity.closed_form_align(torch.as_tensor(pts), torch.as_tensor(target))
    want = jcs.closed_form_align(jnp.asarray(pts), jnp.asarray(target))
    for k in ("R", "t", "c"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-5)
    assert got["residual"] < 1e-4 and want["residual"] < 1e-4


@pytest.mark.parametrize("reg", [0.0, 0.1])
def test_iterative_align_from_the_same_start_matches_jax(reg):
    pts, target = similarity_problem(1, 60)
    target = target - target.mean(0)
    A0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (3, 3)))
    want = jcs.iterative_align(jnp.asarray(pts), jnp.asarray(target), reg=reg, lr=0.05,
                               max_iter=200)
    got = camera_similarity.iterative_align(torch.as_tensor(pts), torch.as_tensor(target),
                                            reg=reg, lr=0.05, max_iter=200, init=A0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["rot_penalty"], want["rot_penalty"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["A"], want["A"], rtol=1e-5, atol=1e-6)
    assert got["loss"][-1] < 0.1 * got["loss"][0]


def test_scale_response_from_the_same_start_matches_jax(monkeypatch):
    init = jax.tree_util.tree_map(np.asarray, jcs.gauss_mlp_init(
        jax.random.PRNGKey(0), jcs.GaussMLPConfig(init_min=0.5, init_max=2.0)))
    kw = dict(scales=(1.0, 4.0), n_points=64, steps=40)
    got = camera_similarity.scale_response_study(init=init, **kw)
    # the JAX study draws its start from a key: hand it the same one
    monkeypatch.setattr(jcs, "gauss_mlp_init",
                        lambda key, cfg: jax.tree_util.tree_map(jnp.asarray, init))
    want = jcs.scale_response_study(**kw)
    assert set(got) == set(want)
    for s in got:
        for k in ("final_loss", "mean_abs_isd"):
            assert got[s][k] == pytest.approx(want[s][k], rel=1e-4), (s, k)
    fresh = camera_similarity.scale_response_study(scales=(1.0,), n_points=32, steps=3)
    assert np.isfinite(fresh[1.0]["final_loss"])
