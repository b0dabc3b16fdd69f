"""The port's data tools against the JAX package on the CPU: the scene
generator (`data/synthetic_fast.py`) and the native data kernels' bindings
(`data/native.py`).

Tolerances: the port's scene render against the JAX package's fast render
at least 0.999 of the pixels within 1/255 (both fp32; the scene's hard
density edges can flip a boundary pixel); `validate` holds its own gate; the
native rays 1e-6 (origins) / 1e-5 (directions) against the torch and JAX
ray ops, as the JAX package's own native tests; the blur 1e-4 against a
numpy clamp-to-edge separable blur.
"""
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_experiments_tpu.data import native as jnative
from nerf_experiments_tpu.data import synthetic_fast as jfast
from nerf_experiments_tpu.ops import rays as jrays
from nerf_experiments_tpu.ops.lie import so3_exp as jso3_exp
from nerf_experiments_tpu_torch.data import native, synthetic, synthetic_fast
from nerf_experiments_tpu_torch.ops import rays as trays
from nerf_experiments_tpu_torch.ops.lie import so3_exp


@pytest.fixture(autouse=True)
def one_thread():
    """Small ops: one intra-op thread each (six test workers share the
    host's cores; spinning thread pools would slow every worker)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def c2w_at(position):
    return synthetic.look_at_c2w(np.asarray(position, float), np.zeros(3),
                                 np.array([0.0, 0.0, 1.0]))


@pytest.mark.parametrize("position,h,w,n", [((2.5, 2.0, 2.2), 40, 48, 64),
                                            ((-3.0, 1.0, 2.5), 33, 17, 96)])
def test_fast_render_matches_jax_fast_render(position, h, w, n):
    c2w = c2w_at(position)
    got = synthetic_fast.render_image(c2w, w, h, n_samples=n, device="cpu")
    want = jfast.render_image(c2w, w, h, n_samples=n)
    assert got.shape == want.shape == (h, w, 4) and got.dtype == np.float64
    same = (np.abs(got - want).max(axis=-1) < 1.0 / 255.0).mean()
    assert same >= 0.999, same
    assert got[..., 3].max() > 0.5 and got[..., 3].min() < 0.5  # the view holds the scene


def test_validate_passes_and_states_its_gate(monkeypatch):
    frac_same, mean_err = synthetic_fast.validate(device="cpu")
    assert frac_same >= synthetic_fast.GATE_FRAC_SAME and mean_err < synthetic_fast.GATE_MEAN_ERR
    # a transposed render fails, and the message says against what
    real = synthetic_fast.render_image
    monkeypatch.setattr(synthetic_fast, "render_image",
                        lambda *a, **k: real(*a, **k).transpose(1, 0, 2)[::-1])
    with pytest.raises(AssertionError, match=r"gate >= 0.98.*gate < 1e-03"):
        synthetic_fast.validate(device="cpu")


def test_generate_dataset_keeps_the_numpy_path_poses_and_layout(tmp_path):
    """The same transforms JSON byte for byte, the same files, and images
    that agree with the numpy marcher's; `render_fn` is passed, not patched
    into the module."""
    a, b = str(tmp_path / "numpy"), str(tmp_path / "fast")
    kw = dict(n_train=2, n_val=1, n_test=1, image_size=16, n_samples=16)
    synthetic.generate_dataset(a, **kw)
    synthetic_fast.generate_dataset(b, device="cpu", **kw)
    assert synthetic.render_image.__module__ == "nerf_experiments_tpu_torch.data.synthetic"
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        ta = open(os.path.join(a, f"transforms_{split}.json")).read()
        assert ta == open(os.path.join(b, f"transforms_{split}.json")).read()
        assert len(json.loads(ta)["frames"]) == n
        assert sorted(os.listdir(os.path.join(a, split))) == sorted(os.listdir(
            os.path.join(b, split)))
        for name in os.listdir(os.path.join(a, split)):
            ia, ib = (np.asarray(Image.open(os.path.join(d, split, name)), np.float32) / 255.0
                      for d in (a, b))
            assert (np.abs(ia - ib).max(axis=-1) <= 2.0 / 255.0).mean() >= 0.97


def test_generate_dataset_writes_nothing_when_validate_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(synthetic_fast, "render_image", lambda *a, **k: np.zeros((64, 64, 4)))
    with pytest.raises(AssertionError, match="numpy oracle"):
        synthetic_fast.generate_dataset(str(tmp_path / "scene"), device="cpu", n_train=1)
    assert not os.path.exists(tmp_path / "scene")


# ---------------------------------------------------------------- native


def lib_digest():
    with open(native.COMMITTED_LIB, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def random_c2w(n, seed):
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c2w[:, :3, :3] = so3_exp(torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)).numpy()
    c2w[:, :3, 3] = rng.normal(size=(n, 3)).astype(np.float32)
    return c2w


def test_native_loads_the_committed_library_read_only():
    before = lib_digest()
    assert native.available() and native.library_path() == native.COMMITTED_LIB
    native.compute_rays(random_c2w(1, 0), 4, 4, 5.0)
    assert lib_digest() == before


def test_native_compute_rays_matches_torch_and_jax_ray_ops():
    n, h, w, focal = 3, 16, 20, 25.0
    c2w = random_c2w(n, 1)
    origs, dirs = native.compute_rays(c2w, h, w, focal)
    assert origs.shape == dirs.shape == (n, h * w, 3)
    t_o, t_d = trays.rays_from_c2w(trays.directions_meshgrid(h, w, focal), torch.as_tensor(c2w))
    np.testing.assert_allclose(origs, t_o.numpy(), atol=1e-6)
    np.testing.assert_allclose(dirs, t_d.numpy(), atol=1e-5)
    j_o, j_d = jrays.rays_from_c2w(jrays.directions_meshgrid(h, w, focal), jnp.asarray(c2w))
    np.testing.assert_allclose(origs, np.asarray(j_o), atol=1e-6)
    np.testing.assert_allclose(dirs, np.asarray(j_d), atol=1e-5)
    j_nat = jnative.compute_rays(c2w, h, w, focal)  # the JAX package's binding, same source
    assert np.array_equal(origs, j_nat[0]) and np.array_equal(dirs, j_nat[1])


def clamp_blur(img, sigma):
    """numpy separable Gaussian blur with clamp-to-edge, radius ceil(3 sigma)."""
    radius = int(np.ceil(3 * sigma))
    k = np.exp(-np.arange(-radius, radius + 1) ** 2 / (2 * sigma ** 2))
    k /= k.sum()
    h, w = img.shape[:2]
    rows = np.clip(np.arange(h)[:, None] + np.arange(-radius, radius + 1), 0, h - 1)
    cols = np.clip(np.arange(w)[:, None] + np.arange(-radius, radius + 1), 0, w - 1)
    tmp = np.einsum("k,hwkc->hwc", k, img[:, cols])
    return np.einsum("k,hkwc->hwc", k, tmp[rows])


def test_native_blur_pyramid_matches_numpy_reference():
    img = np.random.default_rng(2).random((2, 24, 20, 3)).astype(np.float32)
    out = native.blur_pyramid(img, [2.0, 0.7, 0.0])
    assert out.shape == (2, 24, 20, 3, 3)
    for s, sigma in enumerate((2.0, 0.7)):
        for i in range(2):
            np.testing.assert_allclose(out[i, :, :, s], clamp_blur(img[i], sigma), atol=1e-4)
    assert np.array_equal(out[..., 2, :], img)  # sigma <= 0.25 copies
    assert np.array_equal(out, jnative.blur_pyramid(img, [2.0, 0.7, 0.0]))


def test_native_pose_noise_matches_torch_and_numpy():
    rng = np.random.default_rng(4)
    n, hw = 3, 50
    origs = rng.normal(size=(n, hw, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, hw, 3)).astype(np.float32)
    w = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    rot = np.asarray(jso3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(so3_exp(torch.as_tensor(w)).numpy(), rot, atol=1e-6)
    trans = rng.normal(size=(n, 3)).astype(np.float32)
    oo, od = native.apply_pose_noise(origs, dirs, rot, trans)
    np.testing.assert_allclose(oo, origs + trans[:, None], atol=1e-6)
    np.testing.assert_allclose(od, np.einsum("nij,npj->npi", rot, dirs), atol=1e-5)
    want = torch.einsum("nij,npj->npi", torch.as_tensor(rot), torch.as_tensor(dirs))
    np.testing.assert_allclose(od, want.numpy(), atol=1e-5)


def test_native_builds_the_source_when_the_library_will_not_load(tmp_path, monkeypatch):
    """A missing library is compiled with g++ into the build directory, never
    with `make` and never over the committed file."""
    before = lib_digest()
    commands = []
    real_run = native.subprocess.run

    def recording(cmd, **kw):
        commands.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", recording)
    monkeypatch.setattr(native, "COMMITTED_LIB", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_path", None)
    monkeypatch.setattr(native, "_failed", False)
    assert native.available()
    assert native.library_path() == str(tmp_path / "build" / "libnetpu_data.so")
    assert len(commands) == 1 and commands[0][0] == "g++" and "make" not in commands[0]
    assert commands[0][1:6] == native.CXX_FLAGS
    origs, dirs = native.compute_rays(random_c2w(2, 5), 4, 6, 7.0)
    np.testing.assert_allclose(dirs, trays.rays_from_c2w(
        trays.directions_meshgrid(4, 6, 7.0), torch.as_tensor(random_c2w(2, 5)))[1].numpy(),
        atol=1e-5)
    monkeypatch.undo()
    assert lib_digest() == before
