"""The port's 2-D reconstruction slice against the JAX package on the CPU:
the Nerf2d forward on converted weights, N steps of Adam with the plateau
scale against optax's chain, the plateau's state across a restore, and the
entry point (its PSNR gate, `tests/test_end_to_end.py:Test2DReconstruction`,
and a bitwise resume).

Inputs are made with numpy from a seed. Tolerances: the forward rtol 1e-5
(atol 1e-6); the parameters after the steps rtol 1e-5 (atol 1e-6: Adam's
arithmetic and the matmuls' summation order differ in the last bits); the
plateau scale of every step exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_experiments_tpu.models import nerf2d as jnerf2d
from nerf_experiments_tpu_torch.experiments import run_2d_reconstruction
from nerf_experiments_tpu_torch.models import nerf2d as tnerf2d
from nerf_experiments_tpu_torch.training.optim import ReduceOnPlateau

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def one_thread():
    """Small ops: one intra-op thread each (six test workers share the
    host's cores; spinning thread pools would slow every worker)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(port, ref, **tol):
    np.testing.assert_allclose(
        np.asarray(port.detach() if torch.is_tensor(port) else port, np.float32),
        np.asarray(ref, np.float32), **tol)


def configs(levels=4, hidden=32):
    return (jnerf2d.Nerf2dConfig(fourier_levels=levels, hidden_dim=hidden),
            tnerf2d.Nerf2dConfig(fourier_levels=levels, hidden_dim=hidden))


@pytest.mark.parametrize("levels,hidden", [(10, 256), (3, 16)])
def test_nerf2d_forward_matches_jax(levels, hidden):
    jcfg, tcfg = configs(levels, hidden)
    tree = jax.tree_util.tree_map(np.asarray, jnerf2d.init(jax.random.PRNGKey(0), jcfg))
    params = tnerf2d.from_numpy(tree)
    assert tcfg.encoder.output_dim == jcfg.encoder.output_dim == 4 * levels
    x = np.random.default_rng(1).uniform(size=(300, 2)).astype(np.float32)
    close(tnerf2d.apply(params, tcfg, torch.as_tensor(x)),
          jnerf2d.apply(tree, jcfg, jnp.asarray(x)), rtol=1e-5, atol=1e-6)
    moved = tnerf2d.from_numpy(tnerf2d.to_numpy(params))
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), moved.parameters()))
    fresh = tnerf2d.init(torch.Generator().manual_seed(0), tcfg)
    assert [p.shape for p in fresh.parameters()] == [p.shape for p in params.parameters()]


def test_adam_with_plateau_matches_optax_chain():
    """12 steps of Adam + the plateau scale (windows of 3, patience 1, factor
    0.5) on batches whose loss stops improving: the scale falls inside the
    test, on the same steps as optax's, and the parameters stay within
    1e-5 of optax's."""
    jcfg, tcfg = configs(3, 16)
    tree = jax.tree_util.tree_map(np.asarray, jnerf2d.init(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(3)
    batches = [(rng.uniform(size=(64, 2)).astype(np.float32),
                rng.uniform(size=(64, 3)).astype(np.float32)) for _ in range(12)]

    tx = optax.chain(optax.adam(1e-2),
                     optax.contrib.reduce_on_plateau(factor=0.5, patience=1,
                                                     accumulation_size=3))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(jparams)

    @jax.jit
    def jstep(p, state, x, y):
        loss, grads = jax.value_and_grad(
            lambda p: jnp.mean((jnerf2d.apply(p, jcfg, x) - y) ** 2))(p)
        updates, state = tx.update(grads, state, p, value=loss)
        return optax.apply_updates(p, updates), state

    jscales = []
    for x, y in batches:
        jparams, opt_state = jstep(jparams, opt_state, x, y)
        jscales.append(float(opt_state[1].scale))

    params = tnerf2d.from_numpy(tree)
    state = run_2d_reconstruction.Fit2dState(
        params, run_2d_reconstruction.PlateauAdam(params.parameters(), 1e-2, 0.5, 1, 3))
    scales = [run_2d_reconstruction.train_step(state, tcfg, torch.as_tensor(x),
                                               torch.as_tensor(y))[1] for x, y in batches]
    assert scales == jscales and len(set(scales)) > 1, (scales, jscales)
    for got, want in zip(params.layers, jparams["layers"]):
        close(got.w, want["w"], rtol=1e-5, atol=1e-6)
        close(got.b, want["b"], rtol=1e-5, atol=1e-6)


def test_plateau_state_restores_within_a_window():
    """A plateau restored from `state_dict` after any step takes the scales
    of the one that never stopped (the window's running average included)."""
    losses = (0.5 + 0.01 * np.sin(np.arange(40)) + np.arange(40) / 400).astype(np.float32)
    whole = ReduceOnPlateau(factor=0.5, patience=1, accumulation_size=4)
    want = [whole.update(torch.tensor(v)) for v in losses]
    assert len(set(want)) > 1
    for cut in (5, 13, 22):
        first = ReduceOnPlateau(factor=0.5, patience=1, accumulation_size=4)
        got = [first.update(torch.tensor(v)) for v in losses[:cut]]
        second = ReduceOnPlateau(factor=0.5, patience=1, accumulation_size=4)
        second.load_state_dict(first.state_dict())
        got += [second.update(torch.tensor(v)) for v in losses[cut:]]
        assert got == want, cut


SMALL = ["--image_size", "32", "--batch_size", "1024", "--hidden_dim", "64",
         "--fourier_levels", "6", "--device", "cpu"]


def test_run_2d_reconstruction_psnr_rises(tmp_path):
    """The JAX package's gate at its test size: val PSNR above 15 dB after
    600 steps; --save_image's files."""
    params, cfg, result = run_2d_reconstruction.main(
        SMALL + ["--steps", "600", "--out_dir", str(tmp_path), "--save_image"])
    assert result["val_psnr"] > 15.0, result
    assert os.path.exists(tmp_path / "recon.png")
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == result


def test_run_2d_reconstruction_resumes_bit_for_bit(tmp_path):
    """250 steps with patience 1 (two window ends), against 150 steps (in
    the middle of a window), then --resume to 250: the same parameters bit
    for bit."""
    argv = ["--image_size", "16", "--batch_size", "256", "--hidden_dim", "32",
            "--fourier_levels", "4", "--lr_decay_patience", "1", "--device", "cpu"]
    whole, _, _ = run_2d_reconstruction.main(argv + ["--steps", "250", "--out_dir",
                                                     str(tmp_path / "a")])
    out = str(tmp_path / "b")
    run_2d_reconstruction.main(argv + ["--steps", "150", "--checkpoint_every_n_steps", "100",
                                       "--out_dir", out])
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["ckpt_100.pt", "ckpt_150.pt"]
    resumed, _, _ = run_2d_reconstruction.main(argv + ["--steps", "250", "--resume",
                                                       "--out_dir", out])
    for a, b in zip(whole.parameters(), resumed.parameters()):
        assert torch.equal(a, b)
