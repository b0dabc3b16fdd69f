"""Hygiene of the PyTorch port: it imports no JAX, its kernel build fails
clearly without nvcc (also when a CUDA tensor reaches a kernel wrapper), its
checkpoints round-trip, its entry points default to the card and refuse what
they cannot run (a mesh larger than the ranks there are; --mesh where the JAX
entry point ignores it)."""
import dataclasses
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import nerf_experiments_tpu_torch
from nerf_experiments_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        nerf_experiments_tpu_torch.__path__, "nerf_experiments_tpu_torch."))


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter (the test
    process already holds jax through tests/conftest.py)."""
    mods = all_modules()
    assert {"nerf_experiments_tpu_torch.experiments.render_views",
            "nerf_experiments_tpu_torch.experiments.run_barf",
            "nerf_experiments_tpu_torch.data.sampler",
            "nerf_experiments_tpu_torch.training.optim",
            "nerf_experiments_tpu_torch.training.schedules",
            "nerf_experiments_tpu_torch.training.loggers",
            "nerf_experiments_tpu_torch.training.trainer",
            "nerf_experiments_tpu_torch.experiments.garf_main",
            "nerf_experiments_tpu_torch.experiments.gaborf_main",
            "nerf_experiments_tpu_torch.experiments.sarf_main",
            "nerf_experiments_tpu_torch.experiments.run_garf_test",
            "nerf_experiments_tpu_torch.systems.garf_system",
            "nerf_experiments_tpu_torch.ops.garf_megakernel",
            "nerf_experiments_tpu_torch.ops.proposal",
            "nerf_experiments_tpu_torch.models.garf",
            "nerf_experiments_tpu_torch.encodings.activations",
            "nerf_experiments_tpu_torch.ops.hashgrid",
            "nerf_experiments_tpu_torch.models.ingp",
            "nerf_experiments_tpu_torch.data.single_image",
            "nerf_experiments_tpu_torch.experiments.run_3d_ingp",
            "nerf_experiments_tpu_torch.experiments.run_2d_ingp",
            "nerf_experiments_tpu_torch.ops.fused_mlp",
            "nerf_experiments_tpu_torch.ops.render_megakernel",
            "nerf_experiments_tpu_torch.experiments.run_mip_nerf",
            "nerf_experiments_tpu_torch.experiments.run_bip_barf",
            "nerf_experiments_tpu_torch.experiments.run_mip_blur_test",
            "nerf_experiments_tpu_torch.experiments.run_vanilla_as_barf",
            "nerf_experiments_tpu_torch.experiments.run_naive_as_barf",
            "nerf_experiments_tpu_torch.experiments.run_naive_to_vanilla",
            "nerf_experiments_tpu_torch.experiments.run_sampling_test",
            "nerf_experiments_tpu_torch.ops.image_blur",
            "nerf_experiments_tpu_torch.models.siren",
            "nerf_experiments_tpu_torch.experiments.run_nerf_siren",
            "nerf_experiments_tpu_torch.models.nerf2d",
            "nerf_experiments_tpu_torch.experiments.run_2d_reconstruction",
            "nerf_experiments_tpu_torch.data.synthetic_fast",
            "nerf_experiments_tpu_torch.data.native",
            "nerf_experiments_tpu_torch.utils.config",
            "nerf_experiments_tpu_torch.utils.profiling",
            "nerf_experiments_tpu_torch.utils.precision",
            "nerf_experiments_tpu_torch.experiments.sweep",
            "nerf_experiments_tpu_torch.experiments.studies.bulge",
            "nerf_experiments_tpu_torch.experiments.studies.rotation_check",
            "nerf_experiments_tpu_torch.experiments.studies.visualise_pe_mask",
            "nerf_experiments_tpu_torch.experiments.studies.camera_similarity",
            "nerf_experiments_tpu_torch.parallel",
            "nerf_experiments_tpu_torch.parallel.mesh",
            "nerf_experiments_tpu_torch.parallel.shard",
            "nerf_experiments_tpu_torch.parallel.launch"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', 'orbax', "
        "'nerf_experiments_tpu') or m.startswith(('jax.', 'flax.', 'optax.', 'orbax.', "
        "'jaxlib', 'nerf_experiments_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build()


def test_kernel_sources_and_entry_points():
    cu, headers = cuda_build._sources()
    assert {f.name for f in cu} >= {"render.cu", "flagship_render.cu", "flagship_train.cu",
                                    "garf_render.cu", "garf_render_gauss.cu",
                                    "garf_render_gabor.cu", "garf_render_sarf.cu",
                                    "garf_train.cu", "garf_train_gauss.cu",
                                    "garf_train_gabor.cu", "garf_train_sarf.cu", "hashgrid.cu",
                                    "fused_mlp.cu", "proposal_bins.cu"}
    assert {f.name for f in headers} >= {"flagship_common.cuh", "garf_common.cuh",
                                         "train_common.cuh", "garf_train.cuh",
                                         "garf_render.cuh"}
    assert set(cuda_build.SIGNATURES) == {"netpu_render_fwd", "netpu_flagship_render",
                                          "netpu_render_bwd", "netpu_flagship_train",
                                          "netpu_garf_render", "netpu_garf_train",
                                          "netpu_hash_encode_fwd", "netpu_hash_encode_bwd",
                                          "netpu_fused_mlp_fwd", "netpu_fused_mlp_bwd",
                                          "netpu_proposal_bins"}


class FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough to reach a wrapper's
    kernel branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def fake_cuda(*shape):
    return torch.Tensor._make_subclass(FakeCuda, torch.rand(shape))


def kernel_calls():
    """Every kernel wrapper, called the way the port's callers call it."""
    from nerf_experiments_tpu_torch.ops import render
    from nerf_experiments_tpu_torch.ops.render_cuda import render_bwd_cuda
    from nerf_experiments_tpu_torch.ops.train_megakernel import (
        flagship_render, flagship_train_grads)
    from nerf_experiments_tpu_torch.models import garf, nerf_mlp
    from nerf_experiments_tpu_torch.ops.garf_megakernel import (
        garf_radiance_render, garf_radiance_train_grads)
    from nerf_experiments_tpu_torch.ops import (
        fused_mlp, hashgrid, proposal_bins, render_megakernel)

    n, s = 4, 8
    cfg = dataclasses.replace(mlp_cfg(8, 2), n_hidden=1)
    params = nerf_mlp.init(torch.Generator().manual_seed(0), cfg)
    gcfg = garf.GarfConfig(activation="gabor")
    gparams = garf.radiance_init(torch.Generator().manual_seed(0), gcfg)
    rays = lambda: (fake_cuda(n, 3), fake_cuda(n, 3), fake_cuda(n, s), fake_cuda(n, s))
    hcfg = hashgrid.HashGridConfig(dim=3, n_levels=2, table_size=64, resolution_max=32)
    pcfg = dataclasses.replace(mlp_cfg(32, 1), compute_dtype=torch.bfloat16)
    pparams = nerf_mlp.init(torch.Generator().manual_seed(0), pcfg)
    table = lambda: fake_cuda(2, 64, 2)
    return {
        "render_rays": lambda: render.render_rays_auto(fake_cuda(n, s), fake_cuda(n, s, 3),
                                                       fake_cuda(n, s)),
        "render_full": lambda: render.render_full_auto(fake_cuda(n, s), fake_cuda(n, s, 3),
                                                       fake_cuda(n, s), fake_cuda(n, s)),
        "render_bwd": lambda: render_bwd_cuda(*(fake_cuda(n, s) for _ in range(2)), None,
                                              fake_cuda(n, s, 3), fake_cuda(n, s),
                                              fake_cuda(n, s), fake_cuda(n, 5), 1.0),
        "flagship_render": lambda: flagship_render(params, cfg, *rays()),
        "flagship_train": lambda: flagship_train_grads(params, cfg, *rays(), fake_cuda(n, 3),
                                                       1.0, 1.0),
        "garf_render": lambda: garf_radiance_render(gparams, gcfg, *rays(), 0.5),
        "garf_train": lambda: garf_radiance_train_grads(gparams, gcfg, *rays(),
                                                        fake_cuda(n, 3), 0.5),
        "hash_encode": lambda: hashgrid.encode(hashgrid.HashGrid(table()), hcfg,
                                               fake_cuda(n, 3)),
        "hash_encode_bwd": lambda: hashgrid.hash_encode_bwd_cuda(
            table(), fake_cuda(n, 3), fake_cuda(n, 4), hcfg),
        "fused_chain": lambda: fused_mlp.fused_chain(fake_cuda(n, params.color[0].w.shape[0]),
                                                     params.color),
        "fused_mlp_bwd": lambda: fused_mlp.fused_mlp_bwd_cuda(
            fake_cuda(n, params.color[0].w.shape[0]), params.color, fake_cuda(n, 3), False),
        "render_megakernel": lambda: render_megakernel.flagship_render(
            params, cfg, fake_cuda(n, 3), fake_cuda(n, 3), fake_cuda(n, 1), 1.0, 1.0, s, 2.0,
            6.0),
        "proposal_bins": lambda: proposal_bins.proposal_bins(
            pparams, pcfg, fake_cuda(n, 3), fake_cuda(n, 3), 2.0, 6.0, 16, s),
    }


@pytest.mark.parametrize("entry", ["flagship_render", "flagship_train", "render_bwd",
                                   "render_full", "render_rays", "garf_render",
                                   "garf_train", "hash_encode", "hash_encode_bwd",
                                   "fused_chain", "fused_mlp_bwd", "render_megakernel",
                                   "proposal_bins"])
def test_cuda_tensor_without_nvcc_raises_the_nvcc_error(entry, tmp_path, monkeypatch):
    """A CUDA tensor goes to the kernel or the call raises: never a silent
    fall back to the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    cuda_build.library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel_calls()[entry]()


def mlp_cfg(hidden_dim, n_segments):
    from nerf_experiments_tpu_torch.encodings.fourier import Barf
    from nerf_experiments_tpu_torch.models import nerf_mlp

    return nerf_mlp.NerfMLPConfig(
        position_encoder=Barf(levels=2, scale=1.0), direction_encoder=Barf(levels=1, scale=1.0),
        n_hidden=1, hidden_dim=hidden_dim, n_segments=n_segments)


def test_checkpoint_round_trip(tmp_path):
    from nerf_experiments_tpu_torch.systems import barf
    from nerf_experiments_tpu_torch.training.checkpoints import CheckpointManager

    cfg = barf.BarfConfig(radiance=mlp_cfg(8, 2), proposal=mlp_cfg(4, 1),
                          n_training_images=3, samples_per_ray_proposal=4)
    a = barf.init(torch.Generator().manual_seed(0), cfg)
    b = barf.init(torch.Generator().manual_seed(1), cfg)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, a, metadata={"seed": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    mgr.restore(b)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert "proposal.color.1.w" in a.state_dict() and "camera.rotation" in a.state_dict()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(b)


@pytest.mark.parametrize("argv", [["--entry", "mip", "--serve_block", "4"],
                                  ["--serve_block", "4"],
                                  ["--entry", "bip", "--serve_block", "2"]])
def test_render_views_refuses_what_is_not_ported(argv, tmp_path):
    """Block-coarse serving is ported for every entry: these flags no longer
    refuse, and the run goes on to the checkpoint, which an empty directory
    does not have (`tests/test_torch_block_coarse.py` serves trained ones)."""
    from nerf_experiments_tpu_torch.experiments import render_views

    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        render_views.main(["--ckpt_dir", str(tmp_path), "--device", "cpu",
                           "--image_size", "16", "--out_dir", str(tmp_path)] + argv)


# what each entry refuses, and why: a 4x2 mesh needs 8 ranks, and a process
# without a launcher is one (the JAX `make_mesh` assert and its message);
# block-coarse training needs the fused step and a coarse stage (the JAX
# package's asserts)
REFUSALS = {"--mesh": (AssertionError, "mesh 1x4x2 != 1 devices"),
            "--occ_grid_resolution": (ValueError, "requires --fused_kernel"),
            "--train_coarse_block": (ValueError, "requires --fused_kernel|needs a coarse stage")}


@pytest.mark.parametrize("argv", [["--mesh", "4x2"],
                                  ["--occ_grid_resolution", "32", "--train_coarse_block", "4"],
                                  ["--train_coarse_block", "4", "--fused_kernel"]])
def test_training_entry_refuses_what_it_cannot_run(argv):
    """`run_barf.main` trains, the occupancy grid, block-coarse and
    multi-device training included; a mesh larger than the ranks there are
    refuses with the JAX `make_mesh` assertion, and block-coarse training
    without the fused step or a coarse stage refuses as the JAX package's
    asserts do, before any data is generated."""
    from nerf_experiments_tpu_torch.experiments import run_barf

    error, match = REFUSALS[argv[0]]
    with pytest.raises(error, match=match):
        run_barf.main(argv)


@pytest.mark.parametrize("argv", [["--mesh", "4x2"], ["--train_coarse_block", "4"]])
def test_garf_entry_refuses_what_it_cannot_run(argv):
    """`garf_main.main` trains, block-coarse, the target blur
    (`--conv_blur`, `tests/test_torch_image_blur.py`) and multi-device
    training included; a mesh larger than the ranks there are refuses with
    the JAX `make_mesh` assertion, and block-coarse training without the
    fused step as the JAX package's assert does, before any data is
    generated."""
    from nerf_experiments_tpu_torch.experiments import garf_main

    error, match = REFUSALS[argv[0]]
    with pytest.raises(error, match=match):
        garf_main.main(argv)


@pytest.mark.parametrize("entry,argv", [
    ("run_3d_ingp", []), ("run_nerf_siren", []), ("run_mip_nerf", []), ("run_bip_barf", []),
    ("run_mip_blur_test", []), ("run_naive_to_vanilla", []), ("run_sampling_test", []),
    ("render_views", ["--ckpt_dir", "unused"])])
def test_entry_refuses_the_mesh_its_jax_counterpart_ignores(entry, argv):
    """A recorded divergence (ROADMAP): these JAX entry points parse --mesh
    and train or serve on one device all the same; the port refuses the
    flag, before any data is generated, rather than run on one device under
    a flag that asks for more."""
    import importlib

    module = importlib.import_module(f"nerf_experiments_tpu_torch.experiments.{entry}")
    with pytest.raises(ValueError, match="parses --mesh and ignores it"):
        module.main(argv + ["--mesh", "auto", "--device", "cpu"])


@pytest.mark.parametrize("entry", ["run_barf", "garf_main", "render_views", "run_3d_ingp",
                                   "run_2d_ingp", "run_mip_nerf", "run_bip_barf",
                                   "run_mip_blur_test", "run_vanilla_as_barf",
                                   "run_naive_as_barf", "run_naive_to_vanilla",
                                   "run_sampling_test", "run_nerf_siren",
                                   "run_2d_reconstruction"])
def test_device_defaults_to_cuda(entry):
    """Every entry point runs on the card unless --device says otherwise,
    with no fallback to the CPU when CUDA is missing."""
    import importlib

    module = importlib.import_module(f"nerf_experiments_tpu_torch.experiments.{entry}")
    argv = ["--ckpt_dir", "unused"] if entry == "render_views" else []
    assert module.parse_args(argv).device == "cuda"
    assert module.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_fused_forward_needs_a_flagship_config():
    from nerf_experiments_tpu_torch.systems import barf

    cfg = barf.BarfConfig(radiance=mlp_cfg(4, 1), n_training_images=2,
                          samples_per_ray_radiance=4)
    assert not barf.can_fuse_train_step(cfg)
    assert not barf.use_fused_render(cfg, "cuda")
    params = barf.init(torch.Generator().manual_seed(0), cfg)
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    with pytest.raises(ValueError):
        barf.forward(params, cfg, None, o, d, torch.full((2, 1), 1e-3), stratified=False,
                     fused=True)
