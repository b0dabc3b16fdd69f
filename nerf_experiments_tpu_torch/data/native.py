"""ctypes bindings for the native C++ data-pipeline kernels.

Port of the JAX package's `data/native.py` over the same C++ source
(`native/data_kernels.cpp`, OpenMP across images):
  * compute_rays(c2w, H, W, focal) -> (origins, dirs), each (N, H*W, 3);
  * blur_pyramid(images, sigmas) -> (N, H, W, n_sigmas, C), clamp-to-edge;
  * apply_pose_noise(origs, dirs, rot, trans) -> (origins + trans, rot dirs).

The committed `native/libnetpu_data.so` is loaded as it is (read only). When
it is missing or will not load on this machine, the source is compiled with
`g++ -O3 -fPIC -shared -std=c++17 -fopenmp` into `build/native/` (ignored by
git), never over the committed file. `available()` says whether either
worked; the numpy / torch paths of `data/blender.py` and `ops/rays.py` do not
need this module.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "data_kernels.cpp")
COMMITTED_LIB = os.path.join(_REPO, "native", "libnetpu_data.so")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None
_failed = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _open(path: str) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.compute_rays.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, _f32p, _f32p]
    lib.blur_pyramid.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, _f32p, ctypes.c_int, _f32p]
    lib.apply_pose_noise.argtypes = [_f32p, _f32p, ctypes.c_int, ctypes.c_int, _f32p, _f32p,
                                     _f32p, _f32p]
    return lib


def _build() -> Optional[str]:
    """Compile the source into BUILD_DIR; the library's path, or None."""
    out = os.path.join(BUILD_DIR, "libnetpu_data.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_path, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if os.path.exists(COMMITTED_LIB):
            _lib, _lib_path = _open(COMMITTED_LIB), COMMITTED_LIB
        if _lib is None:
            _lib_path = _build()
            _lib = _open(_lib_path) if _lib_path is not None else None
        _failed = _lib is None
        if _failed:
            _lib_path = None
        return _lib


def available() -> bool:
    return _load() is not None


def library_path() -> Optional[str]:
    """The library in use (the committed one or the build), None if none."""
    _load()
    return _lib_path


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native data library is unavailable: {COMMITTED_LIB} does not "
                           f"load and g++ could not build {SOURCE}")
    return lib


def compute_rays(c2w: np.ndarray, height: int, width: int,
                 focal: float) -> Tuple[np.ndarray, np.ndarray]:
    """World-space rays of every pixel of every camera: c2w (N, 4, 4) ->
    origins, unit directions (N, H*W, 3), pixel (i, j) at row i W + j."""
    lib = _require()
    c2w = np.ascontiguousarray(c2w, np.float32)
    n = c2w.shape[0]
    origs = np.empty((n, height * width, 3), np.float32)
    dirs = np.empty((n, height * width, 3), np.float32)
    lib.compute_rays(c2w, n, height, width, float(focal), origs, dirs)
    return origs, dirs


def blur_pyramid(images: np.ndarray, sigmas: Sequence[float]) -> np.ndarray:
    """images (N, H, W, C) float32 -> (N, H, W, n_sigmas, C); sigma <= 0.25
    copies the image."""
    lib = _require()
    images = np.ascontiguousarray(images, np.float32)
    n, h, w, c = images.shape
    sig = np.asarray(list(sigmas), np.float32)
    out = np.empty((n, h, w, len(sig), c), np.float32)
    lib.blur_pyramid(images, n, h, w, c, sig, len(sig), out)
    return out


def apply_pose_noise(origs: np.ndarray, dirs: np.ndarray, rot: np.ndarray,
                     trans: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """origs, dirs (N, HW, 3); rot (N, 3, 3), trans (N, 3) -> (origs + trans,
    rot @ dirs) per camera."""
    lib = _require()
    origs = np.ascontiguousarray(origs, np.float32)
    dirs = np.ascontiguousarray(dirs, np.float32)
    n, hw, _ = origs.shape
    out_o = np.empty_like(origs)
    out_d = np.empty_like(dirs)
    lib.apply_pose_noise(origs, dirs, n, hw, np.ascontiguousarray(rot, np.float32),
                         np.ascontiguousarray(trans, np.float32), out_o, out_d)
    return out_o, out_d
