"""`render_views.render_image` copies a view's rays to the device once and
its rgb back once: the rgb equals, bit for bit, the per-chunk loop that
copied each chunk's rays to the device and its rgb back to the host, with a
chunk that divides the view and one that leaves a short last chunk, with
serve_block 1 and 4; `render_image.host_transfers` counts three copies a
view, whatever the chunk count.

The tests marked `cuda` need an NVIDIA card and skip elsewhere. On the card
they also check that a view makes no synchronizing call beyond the copies
it counts, which needs the BARF encoding's mask to take a host alpha
without copying it to the card (bitwise as a copied alpha). The file
imports no JAX, so on a machine with a card and without JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_transfers.py -q
"""
import math
import warnings

import numpy as np
import pytest
import torch

from nerf_experiments_tpu_torch.cameras import calibration
from nerf_experiments_tpu_torch.encodings import fourier
from nerf_experiments_tpu_torch.encodings.fourier import Barf
from nerf_experiments_tpu_torch.experiments import render_views
from nerf_experiments_tpu_torch.models import nerf_mlp
from nerf_experiments_tpu_torch.systems import barf

ALPHAS = (4.0, 2.0)  # every position and direction level on
PIXEL_WIDTH = 1e-3
SYNC_WARNING = "called a synchronizing CUDA operation"


def config(name):
    """A small flagship-shaped config: `northstar` with a proposal stage in
    bf16, `dense` with equidistant samples alone in fp32."""
    northstar = name == "northstar"
    enc = dict(scale=1.0, include_identity=True)

    def mlp(n_hidden, hidden_dim, n_segments):
        return nerf_mlp.NerfMLPConfig(
            position_encoder=Barf(levels=4, **enc), direction_encoder=Barf(levels=2, **enc),
            n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=n_segments,
            delayed_direction=True, delayed_density=False,
            compute_dtype=torch.bfloat16 if northstar else None)

    return barf.BarfConfig(
        radiance=mlp(2, 64, 2), proposal=mlp(1, 32, 1) if northstar else None,
        n_training_images=4, near=2.0, far=6.0,
        samples_per_ray_radiance=16 if northstar else 32,
        samples_per_ray_proposal=16 if northstar else 0,
        uniform_sampling_strategy="equidistant", uniform_sampling_offset_size=-1.0)


def rays(n, seed=5):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 3.0])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (rng.normal(size=(n, 3)) * 0.3).astype(np.float32), dirs.astype(np.float32)


def gauge(device):
    """A rotation of 0.3 rad about z, a shift and a scale, as `val_gauge` gives."""
    c, s = math.cos(0.3), math.sin(0.3)
    R = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], device=device)
    return R, torch.tensor([[0.1, -0.05, 0.2]], device=device), torch.tensor(1.05, device=device)


def setup(name, device):
    cfg = config(name)
    params = barf.init(torch.Generator().manual_seed(0), cfg).to(device)
    return params, cfg, gauge(device)


def per_chunk_loop(params, cfg, origs, dirs, gauge, pixel_width, chunk, device, alpha_pos,
                   alpha_dir, serve_block=1):
    """The serving loop as it was: each chunk's rays copied to the device,
    its rgb copied back to the host."""
    fused = barf.use_fused_render(cfg, device)
    out = np.empty((origs.shape[0], 3), np.float32)
    for lo in range(0, origs.shape[0], chunk):
        hi = min(lo + chunk, origs.shape[0])
        pad = (lo - hi) % serve_block
        o_c, d_c = origs[lo:hi], dirs[lo:hi]
        if pad:
            o_c = np.concatenate([o_c, origs[hi - pad:hi]])
            d_c = np.concatenate([d_c, dirs[hi - pad:hi]])
        o, d = calibration.validation_transform_rays(
            torch.as_tensor(o_c, device=device), torch.as_tensor(d_c, device=device), gauge)
        with torch.no_grad():
            if serve_block > 1:
                rgb = barf.render_block_coarse(params, cfg, o, d, alpha_pos, alpha_dir,
                                               block=serve_block, pixel_width=pixel_width)
            else:
                pw = torch.full((hi - lo, 1), pixel_width, device=device)
                rgb, _ = barf.forward(params, cfg, None, o, d, pw, alpha_pos, alpha_dir,
                                      stratified=False, fused=fused)
        out[lo:hi] = torch.clamp(rgb[:hi - lo], 0.0, 1.0).cpu().numpy()
    return out


def served(params, cfg, origs, dirs, g, chunk, device, serve_block=1):
    """(rgb, copies counted) of one `render_image` call."""
    before = render_views.render_image.host_transfers
    rgb = render_views.render_image(params, cfg, origs, dirs, g, PIXEL_WIDTH, chunk, device,
                                    *ALPHAS, serve_block)
    return rgb, render_views.render_image.host_transfers - before


def assert_bitwise(name, chunk, serve_block, n_rays, device):
    params, cfg, g = setup(name, device)
    origs, dirs = rays(n_rays)
    want = per_chunk_loop(params, cfg, origs, dirs, g, PIXEL_WIDTH, chunk, device, *ALPHAS,
                          serve_block)
    got, copies = served(params, cfg, origs, dirs, g, chunk, device, serve_block)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (n_rays, 3) and np.isfinite(got).all()
    assert np.array_equal(got, want)
    assert math.ceil(n_rays / chunk) >= 3 and copies == 3


# (config, chunk, serve_block): at 96 rays, chunk 32 divides the view; chunk
# 30 leaves a last chunk of 6, and with serve_block 4 pads every chunk
CPU_CASES = [("northstar", 32, 1), ("northstar", 30, 1), ("northstar", 32, 4),
             ("northstar", 30, 4), ("dense", 32, 1), ("dense", 30, 1)]


@pytest.mark.parametrize("name,chunk,serve_block", CPU_CASES)
def test_one_copy_each_way_matches_the_per_chunk_loop_bitwise(name, chunk, serve_block):
    assert_bitwise(name, chunk, serve_block, 96, "cpu")


@pytest.mark.parametrize("chunk", [8, 30, 96, 200])
def test_host_transfers_count_three_a_view_whatever_the_chunks(chunk):
    params, cfg, g = setup("dense", "cpu")
    origs, dirs = rays(96)
    rgb, copies = served(params, cfg, origs, dirs, g, chunk, "cpu")
    assert rgb.shape == (96, 3) and copies == 3


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the render kernel and the host's copies")
    return torch.device("cuda", 0)


# at 4096 rays, chunk 1024 divides the view into 4; chunk 1000 leaves a last
# chunk of 96 and starts each slice off the allocator's 512-byte alignment
CUDA_CASES = [("northstar", 1024, 1), ("northstar", 1000, 1), ("northstar", 1000, 4),
              ("dense", 1024, 1), ("dense", 1000, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,chunk,serve_block", CUDA_CASES)
def test_on_the_card_matches_the_per_chunk_loop_bitwise(card, name, chunk, serve_block):
    assert barf.use_fused_render(config(name), card)
    assert_bitwise(name, chunk, serve_block, 4096, card)


def synchronizing_calls(fn):
    """(fn's result, the synchronizing CUDA calls it made) under the sync
    debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, sum(SYNC_WARNING in str(w.message) for w in caught)


@pytest.mark.cuda
@pytest.mark.parametrize("name,serve_block", [("northstar", 1), ("northstar", 4), ("dense", 1)])
def test_on_the_card_a_view_syncs_only_for_its_counted_copies(card, name, serve_block):
    params, cfg, g = setup(name, card)
    origs, dirs = rays(4096)
    chunk = 1024
    view = lambda: served(params, cfg, origs, dirs, g, chunk, card, serve_block)  # noqa: E731
    view()  # builds and packs the kernel's weights
    (_, copies), syncs = synchronizing_calls(view)
    _, loop_syncs = synchronizing_calls(lambda: per_chunk_loop(
        params, cfg, origs, dirs, g, PIXEL_WIDTH, chunk, card, *ALPHAS, serve_block))
    assert copies == 3 and syncs <= copies
    assert loop_syncs >= 3 * (4096 // chunk)  # the mode sees each chunk's copies


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_the_card_the_barf_mask_takes_a_host_alpha_bitwise(card, dtype):
    x = torch.zeros((), dtype=dtype, device=card)
    for alpha in (0.0, 0.3, 2.5, 3.7, 7.123456789, 10.0):
        on_card = torch.tensor(alpha, dtype=dtype, device=card)
        want = fourier._barf_mask(10, 3, on_card, x)
        got, syncs = synchronizing_calls(lambda: fourier._barf_mask(10, 3, alpha, x))
        assert got.device == x.device and got.dtype == dtype
        assert torch.equal(got, want) and syncs == 0
