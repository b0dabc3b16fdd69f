"""The port's SIREN NeRF against the JAX package on the CPU: the model on
converted weights, its omega buffers, the BARF system's weight carry-over,
one plain train step of run_nerf_siren's system, and the entry point.

Inputs are made with numpy from a seed; the parameters come from the JAX
package's init, converted. The step draws stratified coarse bins: the JAX
package's `sample_stratified` draws its uniforms from a fixed key, and the
same draw is handed to the port's (`u=`), since threefry and Philox never
agree; the fine bins come from the deterministic inverse-CDF resample. Tolerances: the
forward in fp32 rtol 1e-5 (atol 1e-6; omega 30 multiplies the positions
before the first product, so a summation-order difference grows 30-fold
through the sine); the step's loss rtol 1e-5 and its parameters rtol 1e-4
(atol 1e-6).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.experiments.run_nerf_siren import SirenModelDef as JSirenModelDef
from nerf_experiments_tpu.models import siren as jsiren
from nerf_experiments_tpu.ops import sampling as jsampling
from nerf_experiments_tpu.systems import barf as jbarf
from nerf_experiments_tpu_torch.data import synthetic as tsynthetic
from nerf_experiments_tpu_torch.experiments import common, run_nerf_siren
from nerf_experiments_tpu_torch.models import siren as tsiren
from nerf_experiments_tpu_torch.ops import sampling as tsampling
from nerf_experiments_tpu_torch.systems import barf as tbarf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def named(tree, prefix=""):
    """A JAX pytree -> {port parameter name: array}."""
    return {prefix + ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def points(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return pos, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("input_scale", [30.0, 1.0])
def test_siren_forward_matches_jax(input_scale):
    """`from_numpy` parameters give the density and rgb of `siren.apply`."""
    tree = numpy_tree(jsiren.init(jax.random.PRNGKey(3), jsiren.SirenConfig(input_scale)))
    params = tsiren.from_numpy(tree, tsiren.SirenConfig(input_scale))
    pos, d = points(257, 1)
    jd, jrgb = jsiren.apply(tree, jsiren.SirenConfig(input_scale), jnp.asarray(pos),
                            jnp.asarray(d))
    td, trgb = tsiren.apply(params, tsiren.SirenConfig(input_scale), torch.as_tensor(pos),
                            torch.as_tensor(d))
    assert td.dtype == trgb.dtype == torch.float32
    close(td, jd, rtol=1e-5, atol=1e-6)
    close(trgb, jrgb, rtol=1e-5, atol=1e-6)
    assert float(np.std(np.asarray(jd))) > 1e-3  # the net is not flat at these inputs


def test_siren_parameters_omegas_and_init():
    """The JAX package's names and shapes; the omega vectors are buffers
    that neither the parameters nor the state dict (checkpoints) hold; the
    init's bounds are SIREN's."""
    cfg = tsiren.SirenConfig(30.0)
    params = tsiren.init(torch.Generator().manual_seed(0), cfg)
    want = named(numpy_tree(jsiren.init(jax.random.PRNGKey(0), jsiren.SirenConfig(30.0))))
    got = {k: p.shape for k, p in params.named_parameters()}
    assert got == {k: v.shape for k, v in want.items()}
    assert set(params.state_dict()) == set(want)
    buffers = dict(params.named_buffers())
    assert len(buffers) == 8 and not any(k in got for k in buffers)
    assert torch.equal(params.omega("density1", 0), torch.full((3,), 30.0))
    assert torch.equal(params.omega("density2", 0)[-4:], torch.tensor([1.0, 30.0, 30.0, 30.0]))
    assert float(params.density1[0].w.abs().max()) <= 1.0 / 3
    bound = np.sqrt(6.0 / 259) / 30.0
    assert float(params.density2[0].w[256:].abs().max()) <= bound
    assert float(params.density2[0].w[:256].abs().max()) > bound
    moved = tsiren.from_numpy(tsiren.to_numpy(params), cfg)
    for (ka, a), (kb, b) in zip(params.state_dict().items(), moved.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def step_configs(n_images=4):
    """run_nerf_siren's system at a small sampling size in both packages."""
    jdef = JSirenModelDef(cfg=jsiren.SirenConfig(input_scale=30.0))
    tdef = run_nerf_siren.SirenModelDef(cfg=tsiren.SirenConfig(input_scale=30.0))
    common = dict(n_training_images=n_images, near=2.0, far=6.0, samples_per_ray_radiance=8,
                  samples_per_ray_proposal=6, uniform_sampling_strategy="stratified_uniform",
                  optimize_camera=False, gaussian_blur_sigmas=(0.0,))
    return (jbarf.BarfConfig(radiance=jdef, proposal=jdef, **common),
            tbarf.BarfConfig(radiance=tdef, proposal=tdef, **common))


def test_params_from_numpy_takes_siren_radiance_and_proposal():
    jcfg, tcfg = step_configs()
    tree = numpy_tree(jbarf.init(jax.random.PRNGKey(1), jcfg).params)
    params = tbarf.params_from_numpy(tree, tcfg)
    assert isinstance(params.radiance, tsiren.Siren) and isinstance(params.proposal, tsiren.Siren)
    want = named({k: tree[k] for k in ("radiance", "proposal")})
    want.update({f"camera.{k}": v for k, v in tree["camera"].items()})
    got = params.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.array_equal(v.numpy(), want[k]), k


def test_siren_train_step_matches_jax(monkeypatch):
    """One plain `train_step` of the coarse + fine SIRENs from the same
    parameters, batch and stratified uniforms: the losses and every
    parameter after the Adam update."""
    jcfg, tcfg = step_configs()
    tree = numpy_tree(jbarf.init(jax.random.PRNGKey(2), jcfg).params)
    rng = np.random.default_rng(4)
    n = 16
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (-4.0 * d + rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    batch = {"origs_raw": o, "origs_noisy": o, "dirs_raw": d, "dirs_noisy": d,
             "colors": rng.uniform(size=(n, 1, 3)).astype(np.float32),
             "img_idx": rng.integers(0, 4, size=n).astype(np.int32),
             "pixel_width": np.full((n, 1), 1e-3, np.float32)}

    # the stratified bins' uniforms: the JAX package's own draw from a fixed
    # key (jitted, so the step compiles once), handed to the port
    key = jax.random.PRNGKey(5)
    jax_stratified = jsampling.sample_stratified
    monkeypatch.setattr(jsampling, "sample_stratified",
                        lambda _, *args, **kw: jax_stratified(key, *args, **kw))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jbarf.make_optimizer(jcfg, jtree)
    jstate = jbarf.TrainState(params=jtree, opt_state=tx.init(jtree), step=jnp.asarray(0))
    js, jm = jax.jit(lambda st, b: jbarf.train_step(st, jcfg, tx, b, key, 0.0, 0.0, 0.0))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    handed = [torch.as_tensor(np.array(jax.random.uniform(jax.random.split(key)[1], (n, 6))))]
    torch_stratified = tsampling.sample_stratified

    def handing(generator, n_rays, n_samples, near, far, strategy="stratified_uniform",
                offset_size=0.0, device=None, u=None):
        if strategy == "stratified_uniform":
            u = handed.pop(0)
        return torch_stratified(generator, n_rays, n_samples, near, far, strategy,
                                offset_size, device=device, u=u)

    monkeypatch.setattr(tsampling, "sample_stratified", handing)
    state = tbarf.init_state(tcfg, tbarf.params_from_numpy(tree, tcfg))
    tbatch = {k: torch.as_tensor(v).long() if k == "img_idx" else torch.as_tensor(v)
              for k, v in batch.items()}
    state, tm = tbarf.make_train_step(tcfg)(state, tbatch, torch.Generator(), 0.0, 0.0, 0.0)
    assert not handed and state.step == 1 and bool(tm["grads_finite"])
    for k in ("loss", "loss_fine", "loss_coarse", "psnr"):
        close(tm[k], jm[k], rtol=1e-5, err_msg=k)
    want = named({k: numpy_tree(js.params[k]) for k in ("radiance", "proposal")})
    want.update({f"camera.{k}": np.asarray(v) for k, v in js.params["camera"].items()})
    got = state.params.state_dict()
    assert set(got) == set(want)
    moved = 0
    for k, v in got.items():
        close(v, want[k], rtol=1e-4, atol=1e-6, err_msg=k)
        moved += not np.array_equal(v.numpy(), named(tree)[k] if not k.startswith("camera")
                                    else tree["camera"][k.split(".")[1]])
    assert moved >= 2 * 18  # every SIREN parameter took the update


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    tsynthetic.generate_dataset(path, n_train=6, n_val=2, n_test=2, image_size=16, n_samples=32)
    return path


def test_run_nerf_siren_trains_with_checkpoints(scene, tmp_path):
    """The entry point at SIREN's fixed width and a small sampling size, with
    checkpoints, which hold every parameter and no omega buffer; restored
    into a fresh experiment, the omegas come from its config."""
    out = str(tmp_path / "siren")
    argv = ["--scene_path", scene, "--image_size", "16", "--batch_size", "32",
            "--samples_per_ray_coarse", "4", "--samples_per_ray_fine", "8",
            "--checkpoint_every_n_epochs", "1", "--device", "cpu", "--out_dir", out]
    state = run_nerf_siren.main(argv + ["--max_steps", "6"])
    assert state.step == 6
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r for r in rows if "loss" in r] and all(
        np.isfinite(r["loss"]) for r in rows if "loss" in r)
    ckpt = sorted(os.listdir(os.path.join(out, "ckpt")))
    assert ckpt and all(f.startswith("ckpt_") for f in ckpt)
    saved = torch.load(os.path.join(out, "ckpt", ckpt[-1]), weights_only=True)
    assert saved["step"] == 6 and not any("omega" in k for k in saved["params"])
    assert set(saved["params"]) == set(state.params.state_dict())
    exp = run_nerf_siren.build(run_nerf_siren.parse_args(argv + ["--max_steps", "6"]))
    exp = common.resume_latest(exp, out)
    for k, v in state.params.state_dict().items():
        assert torch.equal(exp.state.params.state_dict()[k], v), k
    assert torch.equal(exp.state.params.radiance.omega("color_sine")[-3:],
                       torch.full((3,), 30.0))
