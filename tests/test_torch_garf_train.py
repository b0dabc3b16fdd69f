"""GARF training in the port against the JAX package on the CPU: the GARF
train kernel's plain version (against the JAX kernel in interpret mode and
against JAX autodiff), the optimizer's weight decay against optax, one plain
train step against a JAX gradient, the fused step against the plain one, and
`garf_main` end to end with a bitwise resume.

Inputs come from numpy with a seed; weights cross with `from_numpy`; TF32 is
off. Each tolerance is stated where it is used."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_experiments_tpu.cameras import calibration as jcal
from nerf_experiments_tpu.models import garf as jgarf
from nerf_experiments_tpu.models.common import ParamGroup as JParamGroup
from nerf_experiments_tpu.ops import garf_megakernel as jgm
from nerf_experiments_tpu.ops import proposal as jproposal
from nerf_experiments_tpu.ops import render as jrender
from nerf_experiments_tpu.ops import sampling as jsampling
from nerf_experiments_tpu.systems import garf_system as jsys
from nerf_experiments_tpu.training import optim as joptim
from nerf_experiments_tpu_torch.data import synthetic as tsynthetic
from nerf_experiments_tpu_torch.experiments import gaborf_main, garf_main, sarf_main
from nerf_experiments_tpu_torch.models import garf as tgarf
from nerf_experiments_tpu_torch.models.common import ParamGroup
from nerf_experiments_tpu_torch.ops import garf_megakernel as tgm
from nerf_experiments_tpu_torch.systems import garf_system as tsys
from nerf_experiments_tpu_torch.training import optim as toptim

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **tol)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def named(tree, prefix=""):
    """A JAX pytree -> {the port's parameter name: leaf}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[prefix + ".".join(keys)] = leaf
    return out


def net_cfgs(activation, **kw):
    lo = 0.0 if activation == "gabor" else 0.5
    kw = dict(activation=activation, init_min=lo, init_max=2.0, **kw)
    return jgarf.GarfConfig(**kw), tgarf.GarfConfig(**kw)


def rays(n, seed):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (rng.normal(size=(n, 3)) * 0.3).astype(np.float32), dirs.astype(np.float32)


def kernel_inputs(n, s, seed):
    origs, dirs = rays(n, seed)
    edges = np.asarray(jsampling.lindisp_edges(n, s, 2.0, 6.0, stratified=False))
    targets = np.random.default_rng(seed + 1).uniform(size=(n, 3)).astype(np.float32)
    return origs, dirs, edges[:, :-1].copy(), edges[:, 1:].copy(), targets


def check_train_grads(got, want_rgb, want_w, want_grads, want_do, want_dd, rtol_g):
    close(got[0], want_rgb, rtol=1e-5, atol=1e-6)
    close(got[1], want_w, rtol=1e-5, atol=1e-6)
    close(got[3], want_do, rtol=1e-4, atol=1e-6)
    close(got[4], want_dd, rtol=1e-4, atol=1e-6)
    assert set(got[2]) == set(want_grads)
    for name, g in got[2].items():
        close(g, want_grads[name], rtol=rtol_g, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- train kernel (plain)


@pytest.mark.parametrize("activation,anneal", [("gauss", 1.0), ("gabor", 1.0), ("sarf", 1.0),
                                               ("gabor", 0.37)])
def test_train_grads_reference_matches_jax_kernel(activation, anneal):
    """`garf_radiance_train_grads_reference` against the TPU kernel in
    interpret mode (one grid step): rgb and weights 1e-5, d_origs / d_dirs
    1e-4, every dW / db / d(activation parameter) 2e-4 (the JAX package's own
    kernel-vs-autodiff tolerances); on CPU tensors the wrapper is the plain
    version and launches nothing."""
    jcfg, tcfg = net_cfgs(activation)
    tree = numpy_tree(jgarf.radiance_init(jax.random.PRNGKey(11), jcfg))
    params = tgarf.from_numpy(tree, tcfg)
    inputs = kernel_inputs(4, 8, seed=12)
    rgb, w, grads, do, dd = jgm.garf_radiance_train_grads(
        jax_tree(tree), jcfg, *map(jnp.asarray, inputs), tile_rays=4, interpret=True,
        act_anneal=anneal)
    args = (params, tcfg, *map(torch.as_tensor, inputs), anneal)
    got = tgm.garf_radiance_train_grads_reference(*args)
    check_train_grads(got, rgb, w, named(grads), do, dd, rtol_g=2e-4)
    before = tgm.garf_radiance_train_grads.launches
    wrapped = tgm.garf_radiance_train_grads(*args)
    assert tgm.garf_radiance_train_grads.launches == before
    assert torch.equal(wrapped[0], got[0]) and torch.equal(wrapped[4], got[4])
    assert all(torch.equal(wrapped[2][k], v) for k, v in got[2].items())
    assert all(p.grad is None for p in params.parameters())


@pytest.mark.parametrize("activation,anneal,s", [("sarf", 0.37, 13), ("gauss", 1.0, 33)])
def test_train_grads_reference_matches_jax_autodiff(activation, anneal, s):
    """Against jax.grad of JAX's radiance_apply + render_full at a ragged S:
    1e-5 / 1e-4 / 2e-4 as above."""
    jcfg, tcfg = net_cfgs(activation)
    tree = numpy_tree(jgarf.radiance_init(jax.random.PRNGKey(13), jcfg))
    origs, dirs, ts, te, targets = kernel_inputs(3, s, seed=14)

    def loss(p, o, d):
        tq = (jnp.asarray(ts) + jnp.asarray(te))[..., None] / 2.0
        pos = (o[:, None] + d[:, None] * tq).reshape(-1, 3)
        rep = jnp.broadcast_to(d[:, None], (3, s, 3)).reshape(-1, 3)
        rgb_s, dens_s = jgarf.radiance_apply(p, jcfg, pos, rep, anneal)
        rgb, _, _, ex = jrender.render_full(dens_s.reshape(3, s), rgb_s.reshape(3, s, 3),
                                            jnp.asarray(ts), jnp.asarray(te))
        return jnp.mean((rgb - targets) ** 2), (rgb, ex["weights"])

    (_, (rgb, w)), (gp, go, gd) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jax_tree(tree), jnp.asarray(origs), jnp.asarray(dirs))
    got = tgm.garf_radiance_train_grads_reference(
        tgarf.from_numpy(tree, tcfg), tcfg, *map(torch.as_tensor, (origs, dirs, ts, te,
                                                                   targets)), anneal)
    check_train_grads(got, rgb, w, named(gp), go, gd, rtol_g=2e-4)


@pytest.mark.parametrize("activation", ["gauss", "gabor", "sarf"])
def test_train_layout_counts_every_parameter(activation):
    """The kernel's flat gradient holds exactly the parameters, in the names
    `_unflatten` gives them; bf16 halves the activation workspace."""
    _, tcfg = net_cfgs(activation)
    params = tgarf.radiance_init(torch.Generator().manual_seed(0), tcfg)
    lay = tgm.train_layout(tcfg)
    assert lay["grads"] == sum(p.numel() for p in params.parameters())
    flat = torch.arange(lay["grads"], dtype=torch.float32)
    grads = tgm._unflatten(flat, params, tcfg)
    assert {k: v.shape for k, v in grads.items()} == {
        k: p.shape for k, p in params.named_parameters()}
    fp32 = tgm.train_workspace_bytes(tcfg, 64, 192)
    bf16 = tgm.train_workspace_bytes(dataclasses.replace(tcfg, compute_dtype=torch.bfloat16),
                                     64, 192)
    assert bf16 < fp32 and fp32 > 64 * 192 * lay["act"] * 4


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("kind", ["garf_exponential", "quantized_exponential"])
def test_multi_group_adamw_matches_optax(kind):
    """6 steps of multi-group Adam with weight decay (optax's
    add_decayed_weights after scale_by_adam), a group with decay and a
    freeze window over steps 2-3, a group without decay, and a non-finite
    gradient at step 4 that the guard zeroes (Adam and the decay still
    run): 1e-5."""
    groups = {
        "lin": ParamGroup(1e-2, 1e-3, 5, weight_decay=0.3),
        "act": ParamGroup(5e-2, 5e-3, 5, weight_decay=0.05, freeze_start_step=2,
                          freeze_end_step=4),
        "camera": ParamGroup(1e-2, 1e-4, 10, adam_eps=1e-2),
    }
    jgroups = {k: JParamGroup(**dataclasses.asdict(g)) for k, g in groups.items()}
    rng = np.random.default_rng(0)
    init = {"lin": rng.normal(size=(3, 4)), "act": rng.normal(size=(5,)),
            "camera": rng.normal(size=(2, 3))}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(6)]
    grads[4]["lin"][0, 1] = np.nan

    tx = joptim.multi_group_adam(jgroups, {k: k for k in init}, schedule_kind=kind,
                                 scheduler_steps_per_period=2)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.as_tensor(v).clone()) for k, v in init.items()}
    opt = toptim.multi_group_adam(groups, {k: [p] for k, p in tparams.items()},
                                  schedule_kind=kind, scheduler_steps_per_period=2)
    for i, g in enumerate(grads):
        jg, jok = joptim.guard_nonfinite({k: jnp.asarray(v) for k, v in g.items()})
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.as_tensor(g[k]).clone()
        ok = toptim.guard_nonfinite(tparams.values())
        opt.step()
        assert bool(ok) == bool(jok) == (i != 4)
        for k, p in tparams.items():
            close(p, jparams[k], rtol=1e-5, atol=1e-7, err_msg=f"step {i} {k}")


# ---------------------------------------------------------------- one train step


def system_cfgs(activation, **kw):
    jnet, tnet = net_cfgs(activation, weight_decay=1e-3)
    jprop, tprop = net_cfgs(activation, weight_decay=1e-2, learning_rate_start=5e-4)
    common = dict(n_train_images=3, near=2.0, far=6.0, proposal_samples_per_ray=4,
                  radiance_samples_per_ray=8, camera_learning_rate_start=4e-3,
                  camera_learning_rate_stop=8e-4, **kw)
    return (jsys.GarfSystemConfig(net=jnet, proposal_net=jprop, **common),
            tsys.GarfSystemConfig(net=tnet, proposal_net=tprop, **common))


def system_tree(jcfg, seed=0):
    tree = numpy_tree(jsys.init(jax.random.PRNGKey(seed), jcfg).params)
    rng = np.random.default_rng(seed)
    tree["camera"] = {k: (rng.normal(size=(3, 3)) * 0.05).astype(np.float32)
                      for k in ("rotation", "translation")}
    return tree


def step_batch(n=6, seed=1):
    rng = np.random.default_rng(seed)
    origs, dirs = rays(n, seed)
    return {"origs_noisy": origs, "dirs_noisy": dirs,
            "colors": rng.uniform(size=(n, 1, 3)).astype(np.float32),
            "img_idx": rng.integers(0, 3, size=n).astype(np.int32)}


def torch_batch(batch):
    return {k: torch.as_tensor(v).long() if k == "img_idx" else torch.as_tensor(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("activation", ["gauss", "gabor", "sarf"])
def test_train_step_matches_jax_gradient(activation, monkeypatch):
    """One plain `train_step` against a JAX step built from the package's
    public functions with stratified=False (training_transform_rays ->
    garf_system.forward -> compute_loss + MSE -> guard -> make_optimizer).
    threefry and Philox cannot agree, so the port's draws are all 0.5: a
    zero jitter of the initial edges and the midpoint quantiles, which is
    exactly stratified=False. Metrics 1e-5, parameters after the update
    1e-4 (Adam normalises each gradient, weight decay on)."""
    jcfg, tcfg = system_cfgs(activation)
    tree = system_tree(jcfg)
    batch = step_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    anneal = 0.6

    def jloss(params):
        o, d = jcal.training_transform_rays(params["camera"], jb["img_idx"],
                                            jb["origs_noisy"], jb["dirs_noisy"])
        rgb, _, _, ex = jsys.forward(params, jcfg, None, o, d, stratified=False,
                                     act_anneal=anneal)
        ploss = jproposal.compute_loss(ex["proposal_aux"], ex["weights"])
        rloss = jnp.mean((rgb - jb["colors"][:, -1]) ** 2)
        return rloss + ploss, (ploss, rloss)

    params = jax_tree(tree)
    (loss, (ploss, rloss)), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    grads, _ = joptim.guard_nonfinite(grads)
    tx = jsys.make_optimizer(jcfg, params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = named(numpy_tree(optax.apply_updates(params, updates)))

    monkeypatch.setattr(torch, "rand", lambda size, generator=None, dtype=None, device=None:
                        torch.full(size, 0.5, dtype=dtype or torch.float32, device=device))
    state = tsys.init_state(tcfg, tsys.params_from_numpy(tree, tcfg))
    state, metrics = tsys.make_train_step(tcfg)(state, torch_batch(batch),
                                                torch.Generator(), anneal)
    assert state.step == 1 and bool(metrics["grads_finite"])
    for k, v in (("loss", loss), ("proposal_loss", ploss), ("radiance_loss", rloss)):
        close(metrics[k], v, rtol=1e-5, err_msg=k)
    got = state.params.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        close(v, want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("activation,interlevel", [("gauss", True), ("sarf", False)])
def test_fused_step_matches_plain_step(activation, interlevel):
    """`train_step_fused` (CPU: the kernel's plain version) against
    `train_step` from the same parameters, batch and generator seed: GARF's
    loss factors, so the two agree to rounding (metrics and parameters
    1e-5)."""
    jcfg, tcfg = system_cfgs(activation, interlevel_camera_grads=interlevel)
    tree = system_tree(jcfg, seed=2)
    batch = torch_batch(step_batch(seed=3))
    out = []
    for make in (tsys.make_train_step, tsys.make_train_step_fused):
        state = tsys.init_state(tcfg, tsys.params_from_numpy(tree, tcfg))
        state, metrics = make(tcfg)(state, batch, torch.Generator().manual_seed(4), 0.8)
        out.append((metrics, state.params.state_dict()))
    for k in ("loss", "proposal_loss", "radiance_loss", "psnr", "grads_finite"):
        close(out[1][0][k], out[0][0][k], rtol=1e-5, err_msg=k)
    for k, v in out[0][1].items():
        close(out[1][1][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_groups_and_lr_rows_match_jax():
    jcfg, tcfg = system_cfgs("gabor", scheduler_steps_per_period=3)
    tree = system_tree(jcfg)
    params = tsys.params_from_numpy(tree, tcfg)
    groups, by_label, kind = tsys.make_groups(tcfg, params)
    assert kind == "quantized_exponential"
    assert sum(len(v) for v in by_label.values()) == len(list(params.parameters()))
    assert len(by_label["radiance_act"]) == 16 and len(by_label["proposal_act"]) == 6
    opt = tsys.make_optimizer(tcfg, params)
    decay = {g["label"]: g["weight_decay"] for g in opt.adam.param_groups}
    assert decay == {"proposal_lin": 1e-2, "proposal_act": 1e-2, "radiance_lin": 1e-3,
                     "radiance_act": 1e-3, "camera": 0.0}
    rows_t, rows_j = tsys.lr_fn(tcfg, params), jsys.lr_fn(jcfg, jax_tree(tree))
    for step in (0, 1, 2, 3, 7, 100):
        want = rows_j(step)
        for k, v in rows_t(step).items():
            assert v == pytest.approx(want[k], rel=1e-6), (step, k)


# ---------------------------------------------------------------- entry point


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("garf_scene"))
    tsynthetic.generate_dataset(path, n_train=6, n_val=2, n_test=2, image_size=16,
                                n_samples=32)
    return path


def garf_argv(scene, out_dir, *extra):
    return ["--scene_path", scene, "--image_size", "16", "--batch_size", "64",
            "--proposal_samples_per_ray", "8", "--radiance_samples_per_ray", "8",
            "--log_every_n_steps", "4", "--device", "cpu", "--out_dir", str(out_dir),
            *extra]


def test_garf_main_trains_on_synthetic_scene(scene, tmp_path):
    """16 steps of 128 rays: an epoch is 12 steps (6 images of 16^2), so
    validation runs once."""
    state = garf_main.main(garf_argv(scene, tmp_path, "--fused_kernel", "--max_steps", "16",
                                     "--batch_size", "128", "--checkpoint_every_n_epochs",
                                     "100"))
    assert state.step == 16
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert any("lr_radiance_act" in r for r in rows) and any("val_psnr" in r for r in rows)
    assert os.listdir(tmp_path / "images") and os.listdir(tmp_path / "rays")
    assert os.path.exists(tmp_path / "ckpt" / "ckpt_16.pt")


def test_garf_resume_is_bitwise_equal(scene, tmp_path):
    """6 steps, a checkpoint, `--resume` to 10, against 10 steps in one go."""
    flags = ("--activation", "gabor", "--bf16", "--fused_kernel")
    whole = garf_main.main(garf_argv(scene, tmp_path / "whole", *flags, "--max_steps", "10"))
    garf_main.main(garf_argv(scene, tmp_path / "split", *flags, "--max_steps", "6",
                             "--checkpoint_every_n_epochs", "100"))
    resumed = garf_main.main(garf_argv(scene, tmp_path / "split", *flags, "--max_steps", "10",
                                       "--resume"))
    assert resumed.step == whole.step == 10
    for (k, a), (_, b) in zip(whole.params.state_dict().items(),
                              resumed.params.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("entry,param", [(gaborf_main, "spread"), (sarf_main, "freq")])
def test_family_entry_points(entry, param, scene, tmp_path):
    state = entry.main(garf_argv(scene, tmp_path, "--max_steps", "2"))
    assert state.step == 2
    assert hasattr(state.params.radiance.density1.act[0], param)
