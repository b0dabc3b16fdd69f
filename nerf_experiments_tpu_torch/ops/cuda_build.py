"""Build and load the port's hand-written CUDA kernels.

All sources in `nerf_experiments_tpu_torch/csrc/` are compiled by `nvcc` for
Hopper (`sm_90a`), one `nvcc -c` per source, all started together, and linked
into one shared library with a plain C interface, loaded with `ctypes`. The
build happens at first use, into `build/kernels/` at the repository root; the
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.

Every C entry point launches on the stream it is given, allocates nothing,
and returns `cudaGetLastError()`; `check` raises on a non-zero code. The
helpers at the end (`check_tensor`, `check_rays`, `is_bf16`, `pointers`)
prepare the arguments the wrappers pass.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argument types of every C entry point (pointers and the stream as void*)
SIGNATURES = {
    # dens, dists, tmid (nullable), colors, weights, trans, stats, n, s,
    # density_scale, stream
    "netpu_render_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    # origs, dirs, t_start, t_end, wf_ptrs, b_ptrs, w_density, n_layers, bf16,
    # tile_rows, n_rays, S, n_hidden, D, C, levels_pos, levels_dir, scale,
    # alpha_pos, alpha_dir, density_scale, out, weights_out (nullable), stream
    "netpu_flagship_render": [_P] * 7 + [_I] * 10 + [_F] * 4 + [_P] * 3,
    # dens, dists, tmid (nullable), colors, gw, gt, gstats, ddens, ddists,
    # dcolors, n, s, density_scale, stream
    "netpu_render_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    # origs, dirs, t_start, t_end, targets, wf_ptrs, wb_ptrs, b_ptrs, w_density,
    # n_layers, bf16, tile_rows, n_rays, S, n_hidden, D, C, levels_pos,
    # levels_dir, scale, alpha_pos, alpha_dir, density_scale, grad_scale, act,
    # cot, aux, masks, act_width, cot_width, part, splits, grads, rgb_out,
    # d_origs, d_dirs, weights_out (nullable), stream
    "netpu_flagship_train": [_P] * 9 + [_I] * 10 + [_F] * 5 + [_P] * 4 + [_I, _I, _P, _I]
                            + [_P] * 6,
    # origs, dirs, t_start, t_end, wf_ptrs, b_ptrs, w0, w_density, p1_ptrs,
    # p2_ptrs, activation, bf16, tile_rows, n_rays, S, gamma, density_scale,
    # out, stream
    "netpu_garf_render": [_P] * 10 + [_I] * 5 + [_F] * 2 + [_P] * 2,
    # origs, dirs, t_start, t_end, targets, wf_ptrs, wb_ptrs, b_ptrs, w0,
    # w_density, p1_ptrs, p2_ptrs, activation, bf16, tile_rows, n_rays, S,
    # gamma, density_scale, grad_scale, act, cot, aux, block_part, act_width,
    # cot_width, part_width, part, splits, grads, rgb_out, weights_out,
    # d_origs, d_dirs, stream
    "netpu_garf_train": [_P] * 12 + [_I] * 5 + [_F] * 3 + [_P] * 4 + [_I] * 3
                        + [_P, _I] + [_P] * 6,
    # table, x, out, level_info (host), n_levels, table_size, n_features, dim,
    # n, additive, bf16, stream
    "netpu_hash_encode_fwd": [_P] * 4 + [_I] * 7 + [_P],
    # table, x, g, d_table, d_x (nullable), acc, gmax, level_info (host),
    # n_levels, table_size, n_features, dim, n, additive, bf16, stream
    "netpu_hash_encode_bwd": [_P] * 8 + [_I] * 7 + [_P],
    # x, wf_ptrs, b_ptrs, dims (host), n_layers, bf16, tile_rows, n_rows, y,
    # stream
    "netpu_fused_mlp_fwd": [_P] * 4 + [_I, _I, _I, _L, _P, _P],
    # x, g, wf_ptrs, wb_ptrs, b_ptrs, dims (host), n_layers, bf16, tile_rows,
    # n_rows, act, cot, act_width, cot_width, part, splits, dx, grads, stream
    "netpu_fused_mlp_bwd": [_P] * 6 + [_I, _I, _I, _L, _P, _P, _I, _I, _P, _I, _P, _P, _P],
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an existing build was reused
    log: str        # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "of nerf_experiments_tpu_torch are compiled at first use and need the "
        "CUDA toolkit")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def build() -> BuildResult:
    """Compile csrc/*.cu into build/kernels/libnetpu_kernels_<hash>.so."""
    cu, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + headers:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out = BUILD_DIR / f"libnetpu_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [out.with_name(f"{out.stem}.{f.stem}.{os.getpid()}.o") for f in cu]
    t0 = time.perf_counter()
    # one compiler per source, all at once: the build counts against the
    # callers' time limits, and the flagship kernels take the longest
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for f, o in zip(cu, objs)]
    # each compiler's output and wall time, read by a thread a process
    outputs, ends = {}, {}

    def wait(i):
        outputs[i] = procs[i].communicate()[0]
        ends[i] = time.perf_counter()

    threads = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    logs = [f"== {f.name} ({ends[i] - t0:.1f} s)\n{outputs[i]}" for i, f in enumerate(cu)]
    failed = [f.name for f, p in zip(cu, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed = ["link"]
    for o in objs:
        o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return BuildResult(out, seconds, log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with argtypes set."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.netpu_error_string.argtypes = [ctypes.c_int]
    lib.netpu_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        msg = library().netpu_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg}) at launch")


def check_tensor(name: str, t: torch.Tensor, shape, dev) -> None:
    """Refuse a tensor that is not a contiguous fp32 one of `shape` on `dev`."""
    if t.dtype != torch.float32 or t.device != dev:
        raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_rays(n: int, s: int, dev, **tensors) -> None:
    """Refuse a ray tensor that is not a contiguous fp32 one of its shape on
    `dev`: origs, dirs, targets (n, 3); t_start, t_end (n, s)."""
    shapes = {"origs": (n, 3), "dirs": (n, 3), "targets": (n, 3),
              "t_start": (n, s), "t_end": (n, s)}
    for name, t in tensors.items():
        check_tensor(name, t, shapes[name], dev)


def is_bf16(cfg) -> bool:
    """Whether a config's `compute_dtype` asks for bf16 (None is fp32)."""
    if cfg.compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype {cfg.compute_dtype} is not supported")
    return cfg.compute_dtype == torch.bfloat16


def pointers(tensors) -> ctypes.c_void_p:
    """A C array of the tensors' device pointers (None -> null)."""
    arr = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    return ctypes.cast(arr, ctypes.c_void_p)
