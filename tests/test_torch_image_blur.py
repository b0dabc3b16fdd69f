"""The port's decaying target blur (`ops/image_blur.py`,
`Trainer.swap_train_colors`, `garf_main --conv_blur`) against the JAX
package on the CPU.

Inputs are made with numpy from a seed. Tolerances: the taps and every
blurred value 1e-6 absolute (the port builds the taps and the band matrices
in float64 and rounds them to fp32 once, the JAX package computes them in
fp32; the products are fp32 in both); the reflect folding and the Dirac case
exactly; a resumed run's targets bit for bit.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.ops import image_blur as jblur
from nerf_experiments_tpu_torch.data import sampler
from nerf_experiments_tpu_torch.data import synthetic as tsynthetic
from nerf_experiments_tpu_torch.experiments import garf_main
from nerf_experiments_tpu_torch.ops import image_blur as tblur
from nerf_experiments_tpu_torch.training.loggers import MetricLogger
from nerf_experiments_tpu_torch.training.trainer import Trainer, TrainerConfig

ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """Small ops: one intra-op thread each (six test workers share the
    host's cores; spinning thread pools would slow every worker)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def images(n=3, h=16, w=16, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("kernel_size,rel,side", [(81, 0.015, 400), (81, 0.05, 16),
                                                  (81, 0.3, 16), (7, 0.2, 9), (80, 0.01, 100),
                                                  (81, 0.0, 16), (81, 1e-9, 16)])
def test_taps_match_jax(kernel_size, rel, side):
    """exp(-x^2 / 2 sigma^2) at linspace(-K/2, K/2, K), normalised; a Dirac
    at sigma_abs <= 1e-7 max_side."""
    got = tblur.gaussian_kernel(kernel_size, rel, side).numpy()
    want = np.asarray(jblur.gaussian_kernel(kernel_size, rel, side))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.sum() == pytest.approx(1.0, abs=1e-12)
    if rel * side <= 1e-7 * side:
        assert np.array_equal(got, np.eye(kernel_size)[kernel_size // 2])


@pytest.mark.parametrize("n,kernel_size", [(16, 81), (1, 5), (2, 81), (100, 81), (9, 7)])
def test_reflect_folding_matches_jax(n, kernel_size):
    """The periodic fold holds for a half width beyond the image side; the
    band matrix's rows sum to the taps' sum."""
    i = np.arange(-3 * kernel_size, 3 * kernel_size)
    assert np.array_equal(tblur.reflect_index(i, n), jblur._reflect_index(i, n))
    if n > 1:
        inner = np.arange(-(n - 1), 2 * n - 1)  # where np.pad's reflect is defined
        want = np.pad(np.arange(n), n - 1, mode="reflect")
        assert np.array_equal(tblur.reflect_index(inner, n), want)
    k = tblur.gaussian_kernel(kernel_size, 0.1, max(n, 4))
    m = tblur.blur_matrix(n, k).numpy()
    np.testing.assert_allclose(m, np.asarray(jblur.blur_matrix(n, jnp.asarray(k.numpy(),
                                                                              jnp.float32))),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("shape,rel", [((3, 16, 16), 0.05), ((2, 16, 12), 0.3),
                                       ((1, 5, 7), 0.2)])
def test_blurred_stack_matches_jax_with_81_taps(shape, rel):
    """At 16^2 and below, the 81-tap half width (40) is more than the side:
    the folded reflect of the JAX band matrices, where F.pad would refuse."""
    img = images(*shape, seed=1)
    k = tblur.gaussian_kernel(81, rel, max(shape[1:]))
    got = tblur.separable_gaussian_blur(torch.as_tensor(img), k)
    want = jblur.separable_gaussian_blur(jnp.asarray(img), jnp.asarray(k.numpy(), jnp.float32))
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert float((got - torch.as_tensor(img)).abs().max()) > 1e-2  # it blurred


def test_blur_matches_direct_reflect_convolution():
    """Where np.pad's reflect is defined (half width < side), the separable
    blur is the direct 2-D convolution of the reflect-padded image."""
    img = images(1, 11, 9, seed=2)[0].astype(np.float64)
    k = tblur.gaussian_kernel(7, 0.25, 11).numpy()
    pad = np.pad(img, ((3, 3), (3, 3), (0, 0)), mode="reflect")
    want = np.zeros_like(img)
    for j in range(7):
        for i in range(7):
            want += k[j] * k[i] * pad[j:j + 11, i:i + 9]
    got = tblur.separable_gaussian_blur(torch.as_tensor(img, dtype=torch.float32),
                                        torch.as_tensor(k))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_dirac_blur_is_the_identity():
    img = images(2, 16, 16, seed=3)
    got = tblur.separable_gaussian_blur(torch.as_tensor(img), tblur.gaussian_kernel(81, 0.0, 16))
    assert torch.equal(got, torch.as_tensor(img))


@pytest.mark.parametrize("slots", [1, 2])
def test_flat_colors_after_milestones_and_sync_match_jax(slots):
    """The ladder (sigma0 decay^n at every period) through the callback and
    through `sync_to`: the same sigma and the same flat colours (R, slots,
    3) as the JAX ConvBlurTargets, raw colours in the earlier slots."""
    img = images(3, 16, 16, seed=4)
    kw = dict(kernel_size=81, relative_sigma_start=0.05, relative_sigma_decay=0.5,
              epoch_fraction_period=0.1, n_sigma_slots=slots)
    jt = jblur.ConvBlurTargets(img, **kw)
    tt = tblur.ConvBlurTargets(torch.as_tensor(img), **kw)

    class Swaps:
        def __init__(self):
            self.colors = []

        def swap_train_colors(self, c):
            self.colors.append(c)

    jrec, trec = Swaps(), Swaps()
    for step, ef in enumerate([0.05, 0.1, 0.15, 0.31, 0.32, 0.45]):
        jt(jrec, None, step, ef)
        tt(trec, None, step, ef)
        assert tt.sigma == pytest.approx(jt.sigma, rel=1e-12) and tt.n_applied == jt._n_applied
    assert len(trec.colors) == len(jrec.colors) == 3  # milestones 1, 3 and 4
    for got, want in zip(trec.colors, jrec.colors):
        assert got.shape == (3 * 256, slots, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        assert torch.equal(got[:, :-1], torch.as_tensor(img).reshape(-1, 1, 3).expand(
            -1, slots - 1, 3))
    for ef in (0.0, 0.27, 1.3):
        jt.sync_to(ef)
        tt.sync_to(ef)
        np.testing.assert_allclose(tt.flat_colors().numpy(), np.asarray(jt.flat_colors()),
                                   rtol=0, atol=ATOL)


def small_store(n_images=2, hw=16, slots=1):
    rng = np.random.default_rng(5)
    r = n_images * hw

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    return sampler.RayStore(
        origins_raw=t(r, 3), origins_noisy=t(r, 3), dirs_raw=t(r, 3), dirs_noisy=t(r, 3),
        colors=torch.as_tensor(rng.uniform(size=(r, slots, 3)).astype(np.float32)),
        img_idx=torch.arange(n_images).repeat_interleave(hw), pixel_width=1e-3,
        gaussian_blur_sigmas=(0.0,) * slots, camera_origins_raw=t(n_images, 3),
        camera_origins_noisy=t(n_images, 3), hw=hw)


@pytest.mark.parametrize("block", [1, 4])
def test_swap_train_colors_reaches_every_batch(block, tmp_path):
    """The step's batch, `regen_batch` (the post-mortem's replay) and
    block-coarse batches all gather the swapped targets; a swap of another
    shape, dtype or device refuses."""
    store = small_store()
    trainer = Trainer(TrainerConfig(batch_size=8, batch_block=block), store,
                      step_fn=None, scalar_fn=lambda s, e: (), metric_logger=MetricLogger(
                          str(tmp_path)))
    before = trainer.regen_batch(3)
    new = store.colors + 10.0
    trainer.swap_train_colors(new)
    after = trainer.regen_batch(3)
    assert torch.equal(after["origs_raw"], before["origs_raw"])
    assert torch.equal(after["colors"], before["colors"] + 10.0)
    assert torch.equal(trainer._batch(trainer.step_generator(trainer._base_seed, 3))["colors"],
                       after["colors"])
    assert torch.equal(store.colors + 10.0, new)  # the store itself is untouched
    for bad in (new[:-1], new.double(), new[:, :, :2]):
        with pytest.raises(ValueError, match="swap_train_colors"):
            trainer.swap_train_colors(bad)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("blur_scene"))
    tsynthetic.generate_dataset(path, n_train=6, n_val=2, n_test=2, image_size=16,
                                n_samples=32)
    return path


def blur_argv(scene, out_dir, *extra):
    return ["--scene_path", scene, "--image_size", "16", "--batch_size", "64",
            "--proposal_samples_per_ray", "8", "--radiance_samples_per_ray", "8",
            "--activation", "gabor", "--conv_blur", "--blur_relative_sigma_start", "0.2",
            "--log_every_n_steps", "2",
            "--device", "cpu", "--out_dir", str(out_dir), *extra]


def run(argv):
    """garf_main's build and fit: (state, trainer, the ConvBlurTargets)."""
    args = garf_main.parse_args(argv)
    _, state, trainer = garf_main.build(args)
    blur = next(cb for cb in trainer.callbacks if isinstance(cb, tblur.ConvBlurTargets))
    return trainer.fit(state), trainer, blur


def test_garf_main_conv_blur_trains_and_resumes_bitwise(scene, tmp_path):
    """`garf_main --conv_blur` on the CPU at 16^2 (81 taps): the targets start
    blurred at sigma0 (0.2 of the side here: the default 0.015 is a quarter
    pixel at 16^2), swap as sigma decays (an epoch is 24 steps, a period
    0.02 epochs), the loss is finite; 3 steps, a checkpoint and --resume to
    6 give the targets of 6 steps in one go, bit for bit, also at the resume
    point."""
    whole, trainer, blur = run(blur_argv(scene, tmp_path / "whole", "--max_steps", "6"))
    assert whole.step == 6 and blur.n_applied == blur.milestones(trainer.epoch_fraction(5))
    assert blur.n_applied >= 10 and blur.sigma == pytest.approx(0.2 * 0.99 ** blur.n_applied)
    raw = trainer.train_store.colors
    colors = trainer._train_arrays["colors"]
    assert colors.shape == raw.shape and float((colors - raw).abs().max()) > 1e-3
    want = blur.flat_colors()
    assert torch.equal(colors, want)
    rows = [json.loads(line) for line in open(tmp_path / "whole" / "metrics.jsonl")]
    assert all(np.isfinite(r["loss"]) for r in rows if "loss" in r)

    split = tmp_path / "split"
    _, first, _ = run(blur_argv(scene, split, "--max_steps", "3", "--resume"))
    args = garf_main.parse_args(blur_argv(scene, split, "--max_steps", "6", "--resume"))
    _, state, resumed = garf_main.build(args)
    assert state.step == 3
    assert torch.equal(resumed._train_arrays["colors"], first._train_arrays["colors"])
    resumed.fit(state)
    assert torch.equal(resumed._train_arrays["colors"], colors)
