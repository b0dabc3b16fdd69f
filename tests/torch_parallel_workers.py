"""The ranks' side of `tests/test_torch_parallel.py`: torch and the port only,
so that no spawned rank imports jax.

The test process writes the inputs (`inputs.npy`: the parameters as a numpy
tree, the batch, the camera) into a work directory, starts the ranks with
`parallel/launch.py:run_ranks` (gloo over a file store) and reads what each
rank wrote back (`<case>_r<rank>.npz`, `<case>_r<rank>.json`). The configs are
built here, and by the test process from the same functions, so both sides
hold the same ones.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from nerf_experiments_tpu_torch.encodings.fourier import Barf
from nerf_experiments_tpu_torch.models import garf, nerf_mlp
from nerf_experiments_tpu_torch.parallel import mesh as mesh_lib
from nerf_experiments_tpu_torch.parallel import shard as shard_lib
from nerf_experiments_tpu_torch.systems import barf, garf_system
from nerf_experiments_tpu_torch.utils.seeds import mix_seed

N_IMAGES = 4
SCALARS = (4.0, 2.0, 0.0)  # alpha_pos, alpha_dir, blur sigma (tests/test_parallel.py)
RENDER_RAYS = 102  # no multiple of 4 ranks: the padding is exercised


def barf_cfg(strategy: str = "equidistant", hidden_dim: int = 32) -> barf.BarfConfig:
    """`tests/test_parallel.py:_cfg` in the port: 2 segments of 1 x 32, 16
    samples, flagship encoders (so the fused step takes it too); 256 wide
    for the model axis, whose rule splits only leaves 256 wide or more."""
    enc = dict(scale=1.0, include_identity=True)
    return barf.BarfConfig(
        radiance=nerf_mlp.NerfMLPConfig(
            position_encoder=Barf(levels=4, **enc), direction_encoder=Barf(levels=2, **enc),
            n_hidden=1, hidden_dim=hidden_dim, n_segments=2, learning_rate_decay_end=1000),
        n_training_images=N_IMAGES, samples_per_ray_radiance=16,
        uniform_sampling_strategy=strategy)


def garf_cfg() -> garf_system.GarfSystemConfig:
    net = garf.GarfConfig(activation="gauss", init_min=0.5, init_max=2.0, weight_decay=1e-3)
    prop = garf.GarfConfig(activation="gauss", init_min=0.5, init_max=2.0, weight_decay=1e-2,
                           learning_rate_start=5e-4)
    return garf_system.GarfSystemConfig(
        net=net, proposal_net=prop, n_train_images=3, near=2.0, far=6.0,
        proposal_samples_per_ray=4, radiance_samples_per_ray=8,
        camera_learning_rate_start=4e-3, camera_learning_rate_stop=8e-4)


def make_batch(n: int, seed: int, n_images: int = N_IMAGES, n_sigmas: int = 2) -> dict:
    """A batch of n rays from a numpy seed (the JAX test's keys and shapes)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origs = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    return {"origs_raw": origs, "origs_noisy": origs.copy(),
            "dirs_raw": dirs.astype(np.float32), "dirs_noisy": dirs.astype(np.float32),
            "colors": rng.uniform(size=(n, n_sigmas, 3)).astype(np.float32),
            "img_idx": rng.integers(0, n_images, size=n).astype(np.int64),
            "pixel_width": np.full((n, 1), 0.005, np.float32)}


def camera(seed: int, n_images: int = N_IMAGES) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(n_images, 3)) * 0.05).astype(np.float32)
            for k in ("rotation", "translation")}


def torch_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def step_generator(i: int) -> torch.Generator:
    return torch.Generator().manual_seed(mix_seed(42, i))


def named_arrays(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def run_steps(state, step_fn, batch: dict, n_steps: int, scalars=SCALARS):
    """n steps on the same batch, step i from `step_generator(i)`: the
    parameters after each step and the metrics of each."""
    params, metrics = [], []
    for i in range(n_steps):
        state, m = step_fn(state, batch, step_generator(i), *scalars)
        params.append(named_arrays(state.params))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, metrics


def save(workdir: str, case: str, rank: int, params: list, metrics: list, **extra) -> None:
    arrays = {f"{i}/{k}": v for i, p in enumerate(params) for k, v in p.items()}
    np.savez(os.path.join(workdir, f"{case}_r{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"{case}_r{rank}.json"), "w") as f:
        json.dump({"metrics": metrics, **extra}, f)


def load_inputs(workdir: str) -> dict:
    return np.load(os.path.join(workdir, "inputs.npy"), allow_pickle=True).item()


# ---------------------------------------------------------------- the cases


def case_shapes(workdir, rank, world, inputs):
    """Mesh shapes, data axes and groups of every layout of this world, and
    the size mismatch's assertion."""
    layouts = {2: [(None, 1, 1)], 4: [(2, 2, 1), (2, 1, 2), (None, 1, 1)]}[world]
    out = {}
    for n_data, n_model, n_hosts in layouts:
        m = mesh_lib.make_mesh(n_data, n_model, n_hosts, device="cpu")
        key = f"{n_hosts}x{m.shape['data']}x{n_model}"
        out[key] = {"shape": m.shape, "data_axes": list(mesh_lib.data_axes(m)),
                    "data_rank": m.data_rank, "data_size": m.data_size,
                    "model_rank": m.model_rank, "model_size": m.model_size,
                    "data_group": dist.get_process_group_ranks(m.data_group)}
    try:
        mesh_lib.make_mesh(n_data=16, n_model=1, device="cpu")
        out["mismatch"] = None
    except AssertionError as e:
        out["mismatch"] = str(e)
    save(workdir, "shapes", rank, [], [], meshes=out)


def _barf_state(inputs, cfg):
    tree = dict(inputs["tree"], camera=inputs["camera"])
    return barf.init_state(cfg, barf.params_from_numpy(tree, cfg))


def wide_state(inputs):
    """The 256-wide config's state: the port's init from a seed, the
    inputs' camera."""
    cfg = barf_cfg(hidden_dim=256)
    params = barf.init(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        for k, v in inputs["camera"].items():
            getattr(params.camera, k).copy_(torch.as_tensor(v))
    return cfg, barf.init_state(cfg, params)


def case_plain(workdir, rank, world, inputs, strategy="equidistant", n_hosts=1):
    """The plain data-parallel step (`pjit_train_step`) over 3 steps on the
    global batch, this rank holding its shard. Every rank but 0 starts from
    perturbed parameters: `shard_state` must hand it rank 0's."""
    cfg = barf_cfg(strategy)
    m = mesh_lib.make_mesh(None, 1, n_hosts, device="cpu")
    state = _barf_state(inputs, cfg)
    if rank:
        with torch.no_grad():
            for p in state.params.parameters():
                p.add_(0.1)
    shard_lib.shard_state(state, m)
    batch = mesh_lib.shard_batch(torch_batch(inputs["batch"]), m)
    params, metrics = run_steps(state, barf.make_train_step(cfg, mesh=m), batch,
                                1 if n_hosts > 1 else 3)
    name = f"plain_{strategy}" if n_hosts == 1 else "host"
    save(workdir, name, rank, params, metrics)


def case_fused(workdir, rank, world, inputs):
    """`shard_map_train_step_fused` (K4's plain version on the CPU) over 2
    steps."""
    cfg = barf_cfg()
    m = mesh_lib.make_mesh(device="cpu")
    state = _barf_state(inputs, cfg)
    batch = mesh_lib.shard_batch(torch_batch(inputs["batch"]), m)
    params, metrics = run_steps(state, shard_lib.shard_map_train_step_fused(cfg, m), batch, 2)
    save(workdir, "fused", rank, params, metrics)


def case_shard_map(workdir, rank, world, inputs):
    """`shard_map_train_step` over `barf.loss_fn` (per-shard draws; the
    equidistant bins draw nothing) over 2 steps."""
    cfg = barf_cfg()
    m = mesh_lib.make_mesh(device="cpu")
    state = shard_lib.shard_state(_barf_state(inputs, cfg), m)
    batch = mesh_lib.shard_batch(torch_batch(inputs["batch"]), m)

    def loss_fn(params, batch, generator, a_pos, a_dir, sigma):
        return barf.loss_fn(params, cfg, batch, generator, a_pos, a_dir, sigma)

    params, metrics = run_steps(state, shard_lib.shard_map_train_step(loss_fn, m), batch, 2)
    save(workdir, "shard_map", rank, params, metrics)


def render_forward(cfg):
    def fwd(params, o, d, pw):
        return barf.forward(params, cfg, None, o, d, pw, SCALARS[0], SCALARS[1],
                            stratified=False)[0]
    return fwd


def case_render(workdir, rank, world, inputs):
    cfg = barf_cfg()
    m = mesh_lib.make_mesh(device="cpu")
    state = _barf_state(inputs, cfg)
    b = torch_batch(inputs["render_batch"])
    with torch.no_grad():
        rgb = shard_lib.sharded_render(render_forward(cfg), m)(
            state.params, b["origs_raw"], b["dirs_raw"], b["pixel_width"])
    save(workdir, "render", rank, [{"rgb": rgb.numpy()}], [])


def case_model(workdir, rank, world, inputs):
    """The plain step of the 256-wide config on a 2 x 2 (data x model)
    mesh over 2 steps: each rank updates its columns of the split leaves.
    Also the gathered optimizer state (what a checkpoint holds), and that
    loading it back and resharding gives each rank its own moments."""
    cfg, state = wide_state(inputs)
    m = mesh_lib.make_mesh(2, 2, device="cpu")
    shard_lib.shard_state(state, m)
    batch = mesh_lib.shard_batch(torch_batch(inputs["batch"]), m)
    params, metrics = run_steps(state, barf.make_train_step(cfg, mesh=m), batch, 2)
    shards = state.optimizer.model_shards
    full = shard_lib.full_optimizer_state(state.optimizer, m)
    np.savez(os.path.join(workdir, f"model_moments_r{rank}.npz"),
             **{f"{i}.{k}": v.numpy() for i, st in full["adam"]["state"].items()
                for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")})
    own = [{k: v.clone() for k, v in state.optimizer.adam.state[s.shard].items()}
           for s in shards]
    state.optimizer.load_state_dict(full)
    shard_lib.reshard(state)
    roundtrip = all(torch.equal(state.optimizer.adam.state[s.shard][k], v)
                    for s, st in zip(shards, own) for k, v in st.items())
    save(workdir, "model", rank, params, metrics, roundtrip=roundtrip,
         shards={n: [list(s.shard.shape), s.lo, s.hi] for n, p in state.params.named_parameters()
                 for s in shards if s.full is p})


def case_garf(workdir, rank, world, inputs):
    """The plain GARF step (stratified lindisp bins: the global draws) over
    2 steps."""
    cfg = garf_cfg()
    m = mesh_lib.make_mesh(device="cpu")
    state = shard_lib.shard_state(
        garf_system.init_state(cfg, garf_system.init(torch.Generator().manual_seed(0), cfg)), m)
    batch = mesh_lib.shard_batch(torch_batch(inputs["garf_batch"]), m)
    params, metrics = run_steps(state, garf_system.make_train_step(cfg, mesh=m), batch, 2,
                                scalars=(0.8,))
    save(workdir, "garf", rank, params, metrics)


def case_run_barf(workdir, rank, world, inputs):
    """`run_barf.main --mesh auto --fused_kernel` on every rank: each writes
    its final parameters; rank 0 alone writes the run's files."""
    from nerf_experiments_tpu_torch.experiments import run_barf

    state = run_barf.main(inputs["run_barf_argv"] + ["--mesh", "auto"])
    save(workdir, "run_barf", rank, [named_arrays(state.params)], [], step=state.step,
         count=state.optimizer.count)


def case_run_barf_model(workdir, rank, world, inputs):
    """`run_barf --mesh 2x2` (the 256-wide net: its split leaves' moments
    gathered into the checkpoint) for 6 steps, then `--resume` to 8 (the
    checkpoint resharded); and `--resume` from a one-device run's
    checkpoint at step 4 to 6."""
    from nerf_experiments_tpu_torch.experiments import run_barf

    argv = inputs["model_argv"] + ["--mesh", "2x2"]
    first = named_arrays(run_barf.main(argv).params)
    state = run_barf.main(argv + ["--max_steps", "8", "--resume"])
    from_single = run_barf.main(argv + ["--resume", "--out_dir", inputs["from_single"]])
    save(workdir, "run_barf_model", rank, [first, named_arrays(state.params),
                                          named_arrays(from_single.params)], [],
         step=state.step)


CASES = {"shapes": case_shapes, "plain_equidistant": case_plain,
         "plain_stratified": lambda *a: case_plain(*a, strategy="stratified_uniform"),
         "host": lambda *a: case_plain(*a, n_hosts=2), "fused": case_fused,
         "render": case_render, "shard_map": case_shard_map, "model": case_model, "garf": case_garf,
         "run_barf": case_run_barf, "run_barf_model": case_run_barf_model}


def worker(rank: int, world: int, workdir: str, cases) -> None:
    """A rank: run the named cases in order (every rank the same ones)."""
    torch.set_num_threads(1)
    inputs = load_inputs(workdir)
    for case in cases:
        CASES[case](workdir, rank, world, inputs)


def failing_worker(rank: int, world: int) -> None:
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def sleeping_worker(rank: int, world: int) -> None:
    time.sleep(600)


def one_rank_runs(argv_json: str, workdir: str) -> None:
    """In a process with no launcher: `run_barf.main` with and without
    `--mesh auto`, fused and plain; each run's final parameters saved."""
    from nerf_experiments_tpu_torch.experiments import run_barf

    torch.set_num_threads(1)
    argv = json.loads(argv_json)
    for name, extra in (("fused", ["--fused_kernel"]), ("fused_mesh", ["--fused_kernel",
                                                                       "--mesh", "auto"]),
                        ("plain", []), ("plain_mesh", ["--mesh", "auto"])):
        out = os.path.join(workdir, name)
        state = run_barf.main(argv + extra + ["--out_dir", out])
        assert not dist.is_initialized(), "the one-rank group outlived its entry point"
        np.savez(os.path.join(workdir, f"{name}.npz"), **named_arrays(state.params))
