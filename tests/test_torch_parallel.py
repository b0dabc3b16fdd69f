"""The port's multi-device layer (`parallel/mesh.py`, `parallel/shard.py`)
against one device and against the JAX package, on the CPU with gloo.

The ranks are processes (`parallel/launch.py:run_ranks`, a file store in the
test's temporary directory, no ports); their side lives in
`tests/torch_parallel_workers.py`, which imports no jax. This process makes
the inputs from numpy seeds, computes the single-device references (the port
in-process, the JAX package for one step) and reads back what each rank
wrote; it never joins a process group itself. Every spawn is bounded (120 s,
each group 60 s) and raises on a rank's failure or a hang.

Config: `tests/test_parallel.py:_cfg` (2 segments of 1 x 32, 16 samples,
equidistant bins unless stated), a global batch of 64 rays. Tolerances:
  * a data-parallel step against the single-device port on the same global
    batch: parameters atol 2e-5 after 2-3 steps (the JAX package's own
    `tests/test_parallel.py`), losses rtol 1e-6 (a mean of shard means
    against one mean: fp32 order only);
  * one data-parallel step against the JAX package's single-device step:
    loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6
    (`tests/test_torch_train.py`);
  * `sharded_render` against `forward`: atol 2e-5;
  * a one-rank mesh against no mesh: bitwise.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from nerf_experiments_tpu.encodings.fourier import Barf as JBarf
from nerf_experiments_tpu.models import nerf_mlp as jmlp
from nerf_experiments_tpu.parallel import mesh as jmesh
from nerf_experiments_tpu.systems import barf as jbarf
from nerf_experiments_tpu_torch.data import synthetic as tsynthetic
from nerf_experiments_tpu_torch.experiments import run_barf
from nerf_experiments_tpu_torch.ops import sampling
from nerf_experiments_tpu_torch.parallel import launch, mesh as mesh_lib
from nerf_experiments_tpu_torch.systems import barf, garf_system
from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 64
TIMING_KEYS = ("train_rays_per_sec", "wall_s")


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def jax_cfg():
    enc = dict(scale=1.0, include_identity=True)
    return jbarf.BarfConfig(
        radiance=jmlp.NerfMLPConfig(
            position_encoder=JBarf(levels=4, **enc), direction_encoder=JBarf(levels=2, **enc),
            n_hidden=1, hidden_dim=32, n_segments=2, learning_rate_decay_end=1000),
        n_training_images=W.N_IMAGES, samples_per_ray_radiance=16,
        uniform_sampling_strategy="equidistant")


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
    out = named_mlp(tree["radiance"], "radiance.")
    out.update({f"camera.{k}": v for k, v in tree["camera"].items()})
    return out


def scene_argv(scene, out_dir):
    """A short `run_barf` on the 16^2 scene: pose noise on, 6 steps, every
    log and a checkpoint at the end."""
    return ["--scene_path", scene, "--image_size", "16", "--device", "cpu",
            "--batch_size", "64", "--max_steps", "6", "--samples_per_ray", "8",
            "--hidden_dim", "16", "--n_hidden", "1", "--log_every_n_steps", "2",
            "--camera_origin_noise_sigma", "0.05", "--camera_rotation_noise_sigma", "0.05",
            "--checkpoint_every_n_epochs", "1", "--image_log_period_epochs", "0.1",
            "--out_dir", out_dir]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    scene = str(root / "scene")
    tsynthetic.generate_dataset(scene, n_train=6, n_val=2, n_test=2, image_size=16,
                                n_samples=16)
    tree = jax.tree_util.tree_map(np.asarray, jbarf.init(jax.random.PRNGKey(0),
                                                         jax_cfg()).params)
    return {"tree": {k: v for k, v in tree.items() if k != "camera"},
            "camera": W.camera(2), "batch": W.make_batch(BATCH, seed=1),
            "render_batch": W.make_batch(W.RENDER_RAYS, seed=5),
            "garf_batch": W.make_batch(8, seed=3, n_images=3, n_sigmas=1),
            "scene": scene, "root": root,
            "run_barf_argv": ["--fused_kernel"] + scene_argv(scene, str(root / "mesh_run")),
            "model_argv": scene_argv(scene, str(root / "model_run")) + ["--hidden_dim", "256"],
            "from_single": str(root / "from_single")}


def spawn(inputs, name, world, cases):
    workdir = inputs["root"] / name
    workdir.mkdir()
    np.save(workdir / "inputs.npy", {k: v for k, v in inputs.items() if k != "root"},
            allow_pickle=True)
    launch.run_ranks(W.worker, world, (str(workdir), cases),
                     init_file=str(workdir / "store"), timeout_s=120.0, group_timeout_s=60.0)
    return workdir


def read(workdir, case, rank):
    arrays = np.load(workdir / f"{case}_r{rank}.npz")
    with open(workdir / f"{case}_r{rank}.json") as f:
        meta = json.load(f)
    steps = sorted({int(k.split("/")[0]) for k in arrays.files})
    params = [{k.split("/", 1)[1]: arrays[k] for k in arrays.files
               if k.startswith(f"{i}/")} for i in steps]
    return params, meta


@pytest.fixture(scope="module")
def two_ranks(inputs):
    return spawn(inputs, "two", 2, ["shapes", "plain_equidistant", "plain_stratified",
                                    "fused", "shard_map", "garf", "run_barf"])


@pytest.fixture(scope="module")
def four_ranks(inputs):
    # a one-device run's step-4 checkpoint, which the 2 x 2 mesh resumes
    single = inputs["root"] / "single_first"
    run_barf.main(inputs["model_argv"] + ["--max_steps", "4", "--out_dir", str(single)])
    (inputs["root"] / "from_single" / "ckpt").mkdir(parents=True)
    shutil.copy(single / "ckpt" / "ckpt_4.pt", inputs["root"] / "from_single" / "ckpt")
    return spawn(inputs, "four", 4, ["shapes", "plain_equidistant", "host", "render",
                                     "model", "run_barf_model"])


def single_device(inputs, strategy, n_steps, fused=False):
    cfg = W.barf_cfg(strategy)
    state = W._barf_state(inputs, cfg)
    step = barf.make_train_step(cfg, fused=fused)
    return W.run_steps(state, step, W.torch_batch(inputs["batch"]), n_steps)


def assert_ranks_equal(workdir, case, world):
    """Replicated parameters: every rank holds rank 0's bits."""
    ref, _ = read(workdir, case, 0)
    for r in range(1, world):
        got, _ = read(workdir, case, r)
        for a, b in zip(ref, got):
            for k in a:
                assert np.array_equal(a[k], b[k]), f"rank {r} {case} {k}"


# ---------------------------------------------------------------- (1) shapes and specs


@pytest.mark.parametrize("shape", [(64, 256), (3, 256), (256, 257), (4, 256, 512), (256,),
                                   (512, 12), (128, 384)])
@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_param_spec_matches_jax(shape, n_model):
    assert mesh_lib.param_spec(shape, n_model) == tuple(jmesh.param_spec(shape, n_model))


@pytest.mark.parametrize("world,key,shape,axes", [
    (2, "1x2x1", {"data": 2, "model": 1}, ["data"]),
    (4, "1x2x2", {"data": 2, "model": 2}, ["data"]),
    (4, "2x2x1", {"host": 2, "data": 2, "model": 1}, ["host", "data"]),
    (4, "1x4x1", {"data": 4, "model": 1}, ["data"])])
def test_mesh_shapes_and_groups(world, key, shape, axes, two_ranks, four_ranks):
    workdir = {2: two_ranks, 4: four_ranks}[world]
    n_model = shape["model"]
    for rank in range(world):
        got = read(workdir, "shapes", rank)[1]["meshes"][key]
        assert got["shape"] == shape and got["data_axes"] == axes
        assert got["model_size"] == n_model and got["data_size"] == world // n_model
        # host-major data index: rank = data_rank * M + model_rank
        assert got["data_rank"] == rank // n_model and got["model_rank"] == rank % n_model
        assert got["data_group"] == list(range(rank % n_model, world, n_model))


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_size_mismatch_raises(world, two_ranks, four_ranks):
    """As JAX `test_16_virtual_devices_unsupported_gracefully`, with its
    message."""
    workdir = {2: two_ranks, 4: four_ranks}[world]
    assert read(workdir, "shapes", 0)[1]["meshes"]["mismatch"] == f"mesh 1x16x1 != {world} devices"
    with pytest.raises(AssertionError, match="mesh 1x16x1 != 1 devices"):
        mesh_lib.make_mesh(n_data=16, device="cpu")  # before any group is made


def test_make_mesh_refuses_a_rank_without_its_card(monkeypatch):
    """`cuda` means cuda:LOCAL_RANK, which must exist: never a second rank
    on a shared card, never the CPU instead (this machine has no card), and
    no group is left behind."""
    import torch.distributed as dist

    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match=r"torch.cuda.device_count\(\) is 0: one card "
                                           r"holds at most one NCCL rank"):
        mesh_lib.make_mesh(device="cuda")
    assert not dist.is_initialized()


def test_shard_batch_keeps_the_rank_rows_of_whole_blocks():
    class FakeMesh:
        data_size = 4
        data_rank = 2

    x = torch.arange(32)
    assert torch.equal(mesh_lib.shard_batch(x, FakeMesh()), torch.arange(16, 24))
    assert torch.equal(mesh_lib.shard_batch({"a": x}, FakeMesh(), block=4)["a"],
                       torch.arange(16, 24))
    with pytest.raises(ValueError, match="whole 16-ray blocks"):
        mesh_lib.shard_batch(x, FakeMesh(), block=16)


@pytest.mark.parametrize("rank,world", [(0, 2), (1, 2), (3, 4)])
def test_row_shard_draws_the_rank_rows_of_the_global_draw(rank, world):
    """Each rank's uniforms are its rows of the single-device draw, and its
    generator ends where the single device's does."""
    g = torch.Generator().manual_seed(7)
    want = sampling.sample_stratified(g, 8 * world, 5, 2.0, 6.0, offset_size=-1.0)
    after = torch.rand(3, generator=g)
    shard = sampling.RowShard(torch.Generator().manual_seed(7), rank, world)
    got = sampling.sample_stratified(shard, 8, 5, 2.0, 6.0, offset_size=-1.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b[rank * 8:(rank + 1) * 8])
    assert torch.equal(torch.rand(3, generator=shard.generator), after)
    assert shard.initial_seed() == 7


# ---------------------------------------------------------------- (2) the plain DP step


@pytest.mark.parametrize("world,strategy", [(2, "equidistant"), (4, "equidistant"),
                                            (2, "stratified_uniform")])
def test_plain_dp_step_matches_single_device(world, strategy, two_ranks, four_ranks):
    workdir = {2: two_ranks, 4: four_ranks}[world]
    case = f"plain_{strategy}"
    want_params, want_metrics = single_device(W.load_inputs(workdir), strategy, 3)
    for rank in range(world):
        params, meta = read(workdir, case, rank)
        assert len(params) == 3
        for i in range(3):
            for k in ("loss", "loss_fine", "psnr"):
                close(meta["metrics"][i][k], want_metrics[i][k], rtol=1e-6,
                      err_msg=f"rank {rank} step {i} {k}")
            assert meta["metrics"][i]["grads_finite"] == 1.0
        for k, v in params[-1].items():
            close(v, want_params[-1][k], atol=2e-5, err_msg=f"rank {rank} {k}")
    assert_ranks_equal(workdir, case, world)


@pytest.mark.parametrize("world", [2, 4])
def test_plain_dp_step_matches_jax_single_device(world, inputs, two_ranks, four_ranks):
    workdir = {2: two_ranks, 4: four_ranks}[world]
    jcfg = jax_cfg()
    tree = dict(inputs["tree"], camera=inputs["camera"])
    tx = jbarf.make_optimizer(jcfg, tree)
    jstate = jbarf.TrainState(params=jax.tree_util.tree_map(jnp.asarray, tree),
                              opt_state=tx.init(tree), step=jnp.asarray(0))
    jbatch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    js, jm = jax.jit(lambda s, b: jbarf.train_step(s, jcfg, tx, b, jax.random.PRNGKey(0),
                                                   *W.SCALARS))(jstate, jbatch)
    want = named_params(jax.tree_util.tree_map(np.asarray, js.params))
    params, meta = read(workdir, "plain_equidistant", 0)
    for k in ("loss", "loss_fine", "psnr"):
        close(meta["metrics"][0][k], jm[k], rtol=1e-5, err_msg=k)
    assert set(params[0]) == set(want)
    for k, v in params[0].items():
        close(v, want[k], rtol=1e-4, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- (3) the fused DP step


def test_fused_dp_step_matches_single_device(two_ranks):
    """Every rank runs the flagship train kernel (its plain version here) on
    its 32 rays; the reduced gradients give the single-device fused step."""
    want_params, want_metrics = single_device(W.load_inputs(two_ranks), "equidistant", 2,
                                              fused=True)
    for rank in range(2):
        params, meta = read(two_ranks, "fused", rank)
        for i in range(2):
            for k in ("loss", "loss_fine", "psnr"):
                close(meta["metrics"][i][k], want_metrics[i][k], rtol=1e-6, err_msg=k)
        for k, v in params[-1].items():
            close(v, want_params[-1][k], atol=2e-5, err_msg=f"rank {rank} {k}")
    assert_ranks_equal(two_ranks, "fused", 2)


def test_shard_map_step_matches_single_device(two_ranks):
    """`shard_map_train_step` over the port's `loss_fn`: the metrics gain
    the reduced loss and `grads_finite`, and 2 steps meet the single device's
    plain step (JAX `test_shard_map_step_runs`, held to the trajectory)."""
    want_params, want_metrics = single_device(W.load_inputs(two_ranks), "equidistant", 2)
    for rank in range(2):
        params, meta = read(two_ranks, "shard_map", rank)
        for i in range(2):
            assert meta["metrics"][i]["grads_finite"] == 1.0
            for k in ("loss", "loss_fine", "psnr"):
                close(meta["metrics"][i][k], want_metrics[i][k], rtol=1e-6, err_msg=k)
        for k, v in params[-1].items():
            close(v, want_params[-1][k], atol=2e-5, err_msg=f"rank {rank} {k}")
    assert_ranks_equal(two_ranks, "shard_map", 2)


def test_trainer_refuses_a_batch_that_does_not_split_into_whole_blocks(tmp_path):
    from nerf_experiments_tpu_torch.data import sampler
    from nerf_experiments_tpu_torch.training.loggers import MetricLogger
    from nerf_experiments_tpu_torch.training.trainer import Trainer, TrainerConfig

    class FakeMesh:
        rank = 0
        data_size = 3

    n = 48
    store = sampler.RayStore(
        origins_raw=torch.zeros((n, 3)), origins_noisy=torch.zeros((n, 3)),
        dirs_raw=torch.zeros((n, 3)), dirs_noisy=torch.zeros((n, 3)),
        colors=torch.zeros((n, 2, 3)), img_idx=torch.zeros((n,), dtype=torch.int64),
        pixel_width=0.01, gaussian_blur_sigmas=(0.0, 0.0),
        camera_origins_raw=torch.zeros((2, 3)), camera_origins_noisy=torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="does not split into 3 shards"):
        Trainer(TrainerConfig(batch_size=8), store, lambda *a: a, lambda *a: (),
                MetricLogger(str(tmp_path)), mesh=FakeMesh())


# ---------------------------------------------------------------- (4) the render


def test_sharded_render_pads_and_matches_forward(four_ranks):
    inputs = W.load_inputs(four_ranks)
    cfg = W.barf_cfg()
    state = W._barf_state(inputs, cfg)
    b = W.torch_batch(inputs["render_batch"])
    with torch.no_grad():
        want = W.render_forward(cfg)(state.params, b["origs_raw"], b["dirs_raw"],
                                     b["pixel_width"])
    for rank in range(4):
        got = read(four_ranks, "render", rank)[0][0]["rgb"]
        assert got.shape == (W.RENDER_RAYS, 3)
        close(got, want.numpy(), atol=2e-5, err_msg=f"rank {rank}")


# ---------------------------------------------------------------- (5) host and model axes


def test_host_axis_step_matches_single_device(four_ranks):
    """`TestHostAxis`: rays over host x data (2 x 2) jointly."""
    want_params, want_metrics = single_device(W.load_inputs(four_ranks), "equidistant", 1)
    for rank in range(4):
        params, meta = read(four_ranks, "host", rank)
        close(meta["metrics"][0]["loss"], want_metrics[0]["loss"], rtol=1e-6)
        for k, v in params[0].items():
            close(v, want_params[0][k], atol=2e-5, err_msg=f"rank {rank} {k}")


def test_model_axis_step_matches_single_device(four_ranks):
    """The 256-wide config on a 2 x 2 (data x model) mesh: each rank holds
    half the columns of the leaves `param_spec` splits (the 257-wide segment
    head stays whole) and updates them; the gathered trajectory is the
    single-device one (JAX `test_tensor_parallel_compiles`, `TestHostAxis`)."""
    inputs = W.load_inputs(four_ranks)
    cfg, state = W.wide_state(inputs)
    want_params, want_metrics = W.run_steps(state, barf.make_train_step(cfg),
                                            W.torch_batch(inputs["batch"]), 2)
    for rank in range(4):
        params, meta = read(four_ranks, "model", rank)
        assert meta["shards"] == {
            name: [shape[:-1] + [shape[-1] // 2], (rank % 2) * shape[-1] // 2,
                   (rank % 2 + 1) * shape[-1] // 2]
            for name, shape in ((n, list(p.shape)) for n, p in state.params.named_parameters())
            if mesh_lib.param_spec(tuple(shape), 2)}
        assert sorted(meta["shards"]) == ["radiance.segments.0.layers.0.w",
                                          "radiance.segments.0.layers.1.w",
                                          "radiance.segments.1.layers.0.w"]
        for i in range(2):
            close(meta["metrics"][i]["loss"], want_metrics[i]["loss"], rtol=1e-6)
        for k, v in params[-1].items():
            close(v, want_params[-1][k], atol=2e-5, err_msg=f"rank {rank} {k}")
    assert_ranks_equal(four_ranks, "model", 4)


def test_model_axis_checkpoint_holds_full_moments(four_ranks):
    """The gathered optimizer state of the 2 x 2 run has the one-device
    layout and moments (fp32 reduction order only: rtol 1e-4, atol 1e-9);
    loaded back and resharded, every rank gets its own moments bit for
    bit."""
    inputs = W.load_inputs(four_ranks)
    cfg, state = W.wide_state(inputs)
    W.run_steps(state, barf.make_train_step(cfg), W.torch_batch(inputs["batch"]), 2)
    want = state.optimizer.state_dict()["adam"]["state"]
    for rank in range(4):
        got = np.load(four_ranks / f"model_moments_r{rank}.npz")
        assert len(got.files) == 2 * len(want)
        for i, st in want.items():
            for k in ("exp_avg", "exp_avg_sq"):
                close(got[f"{i}.{k}"], st[k].numpy(), rtol=1e-4, atol=1e-9,
                      err_msg=f"rank {rank} {i} {k}")
        assert read(four_ranks, "model", rank)[1]["roundtrip"]


def test_model_axis_run_checkpoints_and_resumes_across_layouts(inputs, four_ranks, tmp_path):
    """`run_barf --mesh 2x2`: its step-6 checkpoint restores on one device
    to the mesh's parameters with whole moments, and one device resumed from
    it to step 8 meets the mesh's own resume; the mesh resumed from a
    one-device checkpoint (step 4) to 6 meets the one device's own run to 6
    (atol 2e-5)."""
    first, resumed, from_single = read(four_ranks, "run_barf_model", 0)[0]
    ckpt = inputs["root"] / "model_run" / "ckpt"
    exp = run_barf.build(run_barf.parse_args(inputs["model_argv"]))
    CheckpointManager(str(ckpt)).restore(exp.state, step=6)
    for k, v in first.items():
        assert np.array_equal(exp.state.params.state_dict()[k].numpy(), v), k
    params = list(exp.state.params.parameters())
    for i, st in exp.state.optimizer.state_dict()["adam"]["state"].items():
        assert st["exp_avg"].shape == params[i].shape, i
    single = tmp_path / "single"
    (single / "ckpt").mkdir(parents=True)
    shutil.copy(ckpt / "ckpt_6.pt", single / "ckpt" / "ckpt_6.pt")
    state = run_barf.main(inputs["model_argv"] + ["--max_steps", "8", "--resume",
                                                  "--out_dir", str(single)])
    assert state.step == 8 and read(four_ranks, "run_barf_model", 3)[1]["step"] == 8
    for k, v in resumed.items():
        close(state.params.state_dict()[k].numpy(), v, atol=2e-5, err_msg=k)
    straight = run_barf.main(inputs["model_argv"] + ["--out_dir", str(tmp_path / "straight")])
    for k, v in from_single.items():
        close(straight.params.state_dict()[k].numpy(), v, atol=2e-5, err_msg=k)
    assert_ranks_equal(four_ranks, "run_barf_model", 4)


# ---------------------------------------------------------------- (6) GARF


def test_garf_plain_dp_step_matches_single_device(two_ranks):
    """The GARF plain step, stratified lindisp bins drawn for the global
    batch (`RowShard`), at 2 ranks against one device."""
    inputs = W.load_inputs(two_ranks)
    cfg = W.garf_cfg()
    state = garf_system.init_state(cfg, garf_system.init(torch.Generator().manual_seed(0), cfg))
    want_params, want_metrics = W.run_steps(state, garf_system.make_train_step(cfg),
                                            W.torch_batch(inputs["garf_batch"]), 2,
                                            scalars=(0.8,))
    for rank in range(2):
        params, meta = read(two_ranks, "garf", rank)
        for i in range(2):
            for k in ("loss", "radiance_loss", "proposal_loss", "psnr"):
                close(meta["metrics"][i][k], want_metrics[i][k], rtol=1e-5, err_msg=k)
        for k, v in params[-1].items():
            close(v, want_params[-1][k], atol=2e-5, err_msg=f"rank {rank} {k}")
    assert_ranks_equal(two_ranks, "garf", 2)


# ---------------------------------------------------------------- (7) checkpoints


def test_mesh_checkpoint_restores_on_one_device(inputs, two_ranks):
    """`run_barf --mesh auto --fused_kernel` at 2 ranks: one set of files
    (rank 0's), a checkpoint of the full parameters and Adam state that a
    single-device run restores, and replicated parameters."""
    out = inputs["root"] / "mesh_run"
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    steps = [r["step"] for r in rows if "loss" in r]
    assert steps == [2, 4, 6]  # one writer: each row once
    assert list((out / "images").iterdir())
    assert_ranks_equal(two_ranks, "run_barf", 2)
    params, meta = read(two_ranks, "run_barf", 0)
    assert meta["step"] == 6 and meta["count"] == 6
    args = run_barf.parse_args(inputs["run_barf_argv"])
    exp = run_barf.build(args)
    CheckpointManager(str(out / "ckpt")).restore(exp.state, step=6)
    assert exp.state.step == 6 and exp.state.optimizer.count == 6
    got = exp.state.params.state_dict()
    assert set(got) == set(params[0])
    for k, v in params[0].items():
        assert np.array_equal(got[k].numpy(), v), k
    moments = exp.state.optimizer.state_dict()["adam"]["state"]
    assert len(moments) == len(list(exp.state.params.parameters()))


# ---------------------------------------------------------------- (8) one rank


def test_one_rank_mesh_is_bitwise_the_run_without(inputs, tmp_path):
    """`run_barf --mesh auto` with no launcher (a one-rank group of its own,
    gone when the entry point ends) against the same run without --mesh,
    fused and plain: the logged rows and the parameters bit for bit."""
    argv = scene_argv(inputs["scene"], "unused")[:-2]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    code = ("import sys, torch_parallel_workers as w; "
            "w.one_rank_runs(sys.argv[1], sys.argv[2])")
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(argv), str(tmp_path)],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for name in ("fused", "plain"):
        rows = [[{k: v for k, v in json.loads(line).items() if k not in TIMING_KEYS}
                 for line in open(tmp_path / run / "metrics.jsonl")]
                for run in (name, f"{name}_mesh")]
        assert rows[0] == rows[1] and any("loss" in r for r in rows[0])
        a, b = np.load(tmp_path / f"{name}.npz"), np.load(tmp_path / f"{name}_mesh.npz")
        for k in a.files:
            assert np.array_equal(a[k], b[k]), f"{name} {k}"


# ---------------------------------------------------------------- the launcher


def test_run_ranks_reraises_a_rank_failure(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch.run_ranks(W.failing_worker, 2, init_file=str(tmp_path / "store"),
                         timeout_s=60.0, group_timeout_s=30.0)


def test_run_ranks_bounds_a_hang(tmp_path):
    with pytest.raises(TimeoutError, match="did not finish within"):
        launch.run_ranks(W.sleeping_worker, 2, init_file=str(tmp_path / "store"),
                         timeout_s=8.0)
