"""Multiresolution hash-grid encoding (Instant-NGP style), 2-D and 3-D.

Port of `nerf_experiments_tpu/ops/hashgrid.py`. Semantics from
`2d-ingp/model.py:13-115` and `3d-ingp/model.py:14-121`:
  * one stacked (L, T, F) table, init U(-1e-4, 1e-4);
  * BIJECTIVE dense indexing on levels with T >= (res+1)^d (corners clipped
    to [0, res], index = sum(corner_i * (res+1)^i)), otherwise the spatial
    hash xor(pi_i * corner_i) mod T with primes (1, 2654435761, 805459861),
    in uint32 arithmetic;
  * 2^d corner gather with multilinear weights prod(1 - |x*res - corner|)
    over the unclipped corners;
  * geometric level progression floor(r_min * b^l).

`encode(..., hash="xor")` is the JAX package's `encode`, `encode_fused` and
`encode_matmul` (the one-hot matmul is a TPU lowering of the same row
fetch); `hash="additive"` is `encode_rolled`, whose pre-rolled table
computes corner row (base + delta_c) mod t_eff. `gather_dtype=bf16` rounds
each gathered table row to bf16 before the fp32 weighting; the table and
its gradient stay fp32.

`encode` on a CUDA tensor is the autograd function `HashEncode`: its
forward is the kernel `netpu_hash_encode_fwd` (K7) and its backward
`netpu_hash_encode_bwd` (K8) (`csrc/hashgrid.cu`, wrappers
`hash_encode_fwd_cuda` / `hash_encode_bwd_cuda`), which replace the TPU
kernels `ops/hashgrid_pallas.py:_fwd_kernel` (the row fetch) and
`_dtable_kernel` (the table gradient). K8 sums d_table in int64 fixed point,
up to four words a term (at run_3d_ingp's shapes every fp32 term exactly,
so d_table is the exact sum, rounded once), so it is bitwise repeatable;
`dtable_fixed_point_reference` emulates it. On
a CPU tensor `encode` is the plain version, `encode_reference` (per-level
gather, weighted sum) under torch autograd, whose backward scatter-adds
into the table.

The gradient of |u| at u = 0 is +1, as `jax.grad(jnp.abs)(0.0)` gives
(torch's `abs` gives 0): a point on a grid vertex is common (pixel centres
k/256 at resolution 16, positions clipped to 0), so the plain version writes
|u| as `where(u >= 0, u, -u)` and the kernel uses the same sign.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nerf_experiments_tpu_torch.ops import cuda_build

DEFAULT_PRIMES = (1, 2654435761, 805459861)
MAX_LEVELS = 32  # `kMaxLevels` of csrc/hashgrid.cu
_U32 = 0xFFFF_FFFF


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    dim: int  # 2 or 3
    resolution_min: int = 16
    resolution_max: int = 512
    table_size: int = 2**16
    n_features: int = 2
    n_levels: int = 16
    primes: Tuple[int, ...] = DEFAULT_PRIMES

    @property
    def output_dim(self) -> int:
        return self.n_features * self.n_levels

    @property
    def level_resolutions(self) -> Tuple[int, ...]:
        if self.n_levels == 1:
            return (self.resolution_min,)
        b = math.exp(
            (math.log(self.resolution_max) - math.log(self.resolution_min))
            / (self.n_levels - 1)
        )
        return tuple(int(math.floor(self.resolution_min * b**l)) for l in range(self.n_levels))

    def bijective(self, resolution: int) -> bool:
        return self.table_size >= (resolution + 1) ** self.dim


class HashGrid(nn.Module):
    """The grid's one parameter, `table` (L, T, F)."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = nn.Parameter(table)


def init(generator: torch.Generator, cfg: HashGridConfig, device=None) -> HashGrid:
    """One stacked table (L, T, F), U(-1e-4, 1e-4). Bijective levels use only
    their first (res+1)^d rows; every level is padded to T rows."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features), generator=generator,
                   device=device)
    return HashGrid(u * 2e-4 - 1e-4)


def from_numpy(tree: Dict, device=None) -> HashGrid:
    """The JAX package's {"table": (L, T, F)} -> HashGrid."""
    return HashGrid(torch.tensor(np.asarray(tree["table"], np.float32), device=device))


def to_numpy(grid: HashGrid) -> Dict:
    return {"table": grid.table.detach().cpu().numpy()}


def _corner_offsets(dim: int, device=None) -> torch.Tensor:
    """(2^d, d) binary corner offsets in the reference's idx_list order: bit
    (d-1-i) of corner c is its offset along axis i."""
    c = torch.arange(2**dim, device=device)[:, None]
    shifts = torch.arange(dim - 1, -1, -1, device=device)[None, :]
    return (c >> shifts) & 1


def _effective_rows(cfg: HashGridConfig, resolution: int) -> int:
    return min((resolution + 1) ** cfg.dim, cfg.table_size) \
        if cfg.bijective(resolution) else cfg.table_size


def _level_indices(corners: torch.Tensor, resolution: int, cfg: HashGridConfig) -> torch.Tensor:
    """corners (..., d) int64 -> xor-hash table rows (...) int64, equal to
    the JAX package's uint32 arithmetic: every product is masked to 32 bits
    (corners <= 2048 and primes < 2^32 keep it below 2^44, exact in int64)."""
    if cfg.bijective(resolution):
        corners = torch.clamp(corners, 0, resolution)
        strides = [(resolution + 1) ** i for i in range(cfg.dim)]
        return sum(corners[..., i] * strides[i] for i in range(cfg.dim))
    acc = ((corners[..., 0] & _U32) * cfg.primes[0]) & _U32
    for i in range(1, cfg.dim):
        acc = acc ^ (((corners[..., i] & _U32) * cfg.primes[i]) & _U32)
    return acc % cfg.table_size


def _rolled_level_base_and_deltas(cfg: HashGridConfig, resolution: int,
                                  x_floor: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
    """x_floor (B, d) int64 -> (base (B,) int64, deltas per corner): the
    additive index of `encode_rolled`, corner row (base + delta_c) mod t_eff."""
    def bit(c, i):
        return (c >> (cfg.dim - 1 - i)) & 1

    if cfg.bijective(resolution):
        strides = [(resolution + 1) ** i for i in range(cfg.dim)]
        base = sum(x_floor[:, i] * strides[i] for i in range(cfg.dim))
        deltas = [sum(bit(c, i) * strides[i] for i in range(cfg.dim))
                  for c in range(2 ** cfg.dim)]
        return base, deltas
    T = cfg.table_size  # a power of two: the uint32 wrap is compatible with mod T
    acc = ((x_floor[:, 0] & _U32) * cfg.primes[0]) & _U32
    for i in range(1, cfg.dim):
        acc = (acc + (((x_floor[:, i] & _U32) * cfg.primes[i]) & _U32)) & _U32
    deltas = [sum(bit(c, i) * cfg.primes[i] for i in range(cfg.dim)) % T
              for c in range(2 ** cfg.dim)]
    return acc % T, deltas


def _abs(u: torch.Tensor) -> torch.Tensor:
    """|u| with the JAX package's gradient convention (+1 at u = 0)."""
    return torch.where(u >= 0, u, -u)


def _level_rows_and_offsets(cfg: HashGridConfig, resolution: int, x: torch.Tensor,
                            hash: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, d) -> (rows (B, 2^d) int64 into the level's table,
    u (B, 2^d, d) = x*res - corner over the unclipped corners)."""
    xs = x * resolution
    xf = torch.floor(xs).long()
    corners = xf[:, None, :] + _corner_offsets(cfg.dim, x.device)[None]
    u = xs[:, None, :] - corners.to(x.dtype)
    if hash == "xor":
        return _level_indices(corners, resolution, cfg), u
    base, deltas = _rolled_level_base_and_deltas(cfg, resolution, xf)
    rows = (base[:, None] + torch.tensor(deltas, device=x.device)[None]) \
        % _effective_rows(cfg, resolution)
    return rows, u


def _gather(table_l: torch.Tensor, rows: torch.Tensor, gather_dtype) -> torch.Tensor:
    """table_l (T, F), rows (B, C) -> (B, C, F) fp32 rows, rounded to
    gather_dtype when it is set. The rounding passes the gradient through
    unchanged (r = f + (round(f) - f) with the difference detached; both
    steps are exact in fp32), so autograd scatters an fp32 table gradient, as
    the JAX package's `_gather_interp_bwd` does; `index_select`'s backward
    is the `index_add_` scatter."""
    f = torch.index_select(table_l, 0, rows.reshape(-1)).reshape(*rows.shape,
                                                                  table_l.shape[-1])
    if gather_dtype is None:
        return f
    return f + (f.to(gather_dtype).float() - f).detach()


def encode_reference(table: torch.Tensor, cfg: HashGridConfig, x: torch.Tensor,
                     hash: str = "xor", gather_dtype=None) -> torch.Tensor:
    """Plain version: x (B, d) in [0,1]^d -> (B, L*F) fp32, level-major. Its
    autograd backward is the plain table and coordinate gradient. The weight
    multiplies its d factors out: `torch.prod`'s backward runs a cumprod over
    the size-d axis, which takes nearly all of the backward's time on CUDA."""
    outs = []
    for res, table_l in zip(cfg.level_resolutions, table.unbind(0)):
        rows, u = _level_rows_and_offsets(cfg, res, x, hash)
        fac = 1.0 - _abs(u)
        w = fac[..., 0]
        for i in range(1, cfg.dim):
            w = w * fac[..., i]
        outs.append(torch.sum(_gather(table_l, rows, gather_dtype) * w[..., None], dim=1))
    return torch.cat(outs, dim=-1)


# ----------------------------------------------------------------- kernels

SHIFT_RANGE = (-126, 126)  # K8's fixed-point shift, clamped so 2^s is a normal fp32


def fixed_point_shift(max_abs_g: float, n: int, dim: int) -> int:
    """K8's scale 2^s for a launch of n points whose cotangent has max |g| =
    m 2^e (m in [0.5, 1)): s = 62 - d - ceil(log2 n) - e. A row takes at most
    2^d n contributions w g with w <= 1, each quantised to |q| <= 2^(e+s) +
    1/2, so no int64 sum of the first word reaches 2^63. Clamped to
    `SHIFT_RANGE`."""
    if not max_abs_g > 0.0:
        return 0
    e = math.frexp(max_abs_g)[1]
    return max(SHIFT_RANGE[0], min(SHIFT_RANGE[1], 62 - dim - (n - 1).bit_length() - e))


def fixed_point_lo_shift(n: int, dim: int) -> int:
    """K8's scale 2^K between its words: the remainder r = v - rint(v) of a
    term's scaled value v (|r| <= 1/2, exact in fp32) goes into the next
    int64 word as rint(r 2^K). K = 63 - d - ceil(log2 n): 2^d n such words of
    |q| <= 2^(K-1) stay inside int64."""
    return 63 - dim - (n - 1).bit_length()


MAX_WORDS = 4  # `kMaxWords` of csrc/hashgrid.cu


def fixed_point_words(s: int, k: int) -> int:
    """The int64 words K8 keeps a term at scales 2^s, 2^(s+K), ...: enough to
    reach 2^-149, fp32's smallest step (s + (W-1) K >= 149), at most
    `MAX_WORDS`. When s >= 0 and that is reached, every fp32 term is
    represented exactly; the last quantum 2^-(s+(W-1)K) bounds it otherwise
    (a term below half of it adds 0)."""
    return min(MAX_WORDS, 1 + (149 - s + k - 1) // k)


def dtable_terms(cfg: HashGridConfig, x: torch.Tensor, g: torch.Tensor, hash: str = "xor"):
    """K8's terms, level by level: (flat rows into the (L*T, F) table (B*2^d,),
    contributions w g (B*2^d, F) fp32, w the plain version's product)."""
    F, T = cfg.n_features, cfg.table_size
    for l, res in enumerate(cfg.level_resolutions):
        rows, u = _level_rows_and_offsets(cfg, res, x, hash)
        fac = 1.0 - _abs(u)
        w = fac[..., 0]
        for i in range(1, cfg.dim):
            w = w * fac[..., i]
        c = w[..., None] * g[:, None, l * F:(l + 1) * F]
        yield (rows + l * T).reshape(-1), c.reshape(-1, F)


def dtable_fixed_point_reference(cfg: HashGridConfig, x: torch.Tensor,
                                 g: torch.Tensor, hash: str = "xor") -> torch.Tensor:
    """Emulation of K8's table gradient: every term c of `dtable_terms` as v
    = c 2^s in fp32 cut into `fixed_point_words` words, word i = rint(v_i)
    with v_0 = v and v_(i+1) = (v_i - word i) 2^K (half to even, as
    `rintf`; every step exact in fp32), each summed by `index_add_` in int64
    and converted as the sum over i of word i 2^-(s+iK) in float64, in the
    order of i, then fp32. Integer sums do not depend on the order of the
    points, so this gives K8's bits. All NaN when g holds a non-finite
    value. The rows' bf16 rounding does not reach d_table. For the tests; no
    path of the port calls it."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    n = x.shape[0]
    gmax = float(g.abs().max()) if g.numel() else 0.0
    if not math.isfinite(gmax):
        return torch.full((L, T, F), float("nan"), dtype=torch.float32, device=x.device)
    s = fixed_point_shift(gmax, n, cfg.dim)
    k = fixed_point_lo_shift(n, cfg.dim)
    words = fixed_point_words(s, k)
    up = torch.tensor(2.0 ** s, dtype=torch.float32, device=x.device)
    up_lo = torch.tensor(2.0 ** k, dtype=torch.float32, device=x.device)
    acc = torch.zeros((words, L * T, F), dtype=torch.int64, device=x.device)
    for rows, c in dtable_terms(cfg, x, g, hash):
        v = c * up
        for i in range(words):
            q = torch.round(v)
            acc[i].index_add_(0, rows, q.double().long())
            v = (v - q) * up_lo
    total = torch.zeros((L * T, F), dtype=torch.float64, device=x.device)
    for i in range(words):
        total = total + acc[i].double() * 2.0 ** -(s + i * k)
    return total.float().reshape(L, T, F)


def level_info(cfg: HashGridConfig) -> List[int]:
    """The kernels' per-level host array: [res, t_eff, bijective] * L +
    primes[:3] (`make_levels` in csrc/hashgrid.cu reads it)."""
    info = []
    for res in cfg.level_resolutions:
        info += [res, _effective_rows(cfg, res), int(cfg.bijective(res))]
    return info + (list(cfg.primes) + [0, 0, 0])[:3]


def _kernel_args(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig, hash: str,
                 gather_dtype):
    """Check the kernels' inputs and pack `level_info` as uint32."""
    L, T, F = table.shape
    n, d = x.shape
    dev = x.device
    cuda_build.check_tensor("table", table, (L, T, F), dev)
    cuda_build.check_tensor("x", x, (n, d), dev)
    if (d != cfg.dim or d not in (2, 3) or F not in (1, 2, 4, 8) or L != cfg.n_levels
            or L > MAX_LEVELS or T != cfg.table_size or hash not in ("xor", "additive")
            or gather_dtype not in (None, torch.bfloat16)):
        raise ValueError(
            f"hash-grid kernels take d in (2, 3), F in (1, 2, 4, 8), L <= {MAX_LEVELS} "
            f"as the config says, hash xor/additive and gather_dtype None/bf16; got "
            f"table {tuple(table.shape)}, x {tuple(x.shape)}, {cfg}, {hash}, {gather_dtype}")
    if table.data_ptr() % 16:
        raise ValueError("table: the kernels' vector loads need 16-byte alignment")
    if 16 * n * L >= 2**31:
        raise ValueError(f"hash-grid kernels index (point, level, lane) in int32; got {n} x {L}")
    info = level_info(cfg)
    arr = (ctypes.c_uint32 * len(info))(*info)
    return L, T, F, n, d, dev, arr


def hash_encode_fwd_cuda(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig,
                         hash: str = "xor", gather_dtype=None) -> torch.Tensor:
    """One launch of the forward kernel (K7): (B, L*F) fp32."""
    L, T, F, n, d, dev, info = _kernel_args(table, x, cfg, hash, gather_dtype)
    lib = cuda_build.library()
    out = torch.empty((n, L * F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_hash_encode_fwd(
            table.data_ptr(), x.data_ptr(), out.data_ptr(), ctypes.cast(info, ctypes.c_void_p),
            L, T, F, d, n, int(hash == "additive"), int(gather_dtype is not None), stream)
    cuda_build.check(code, "netpu_hash_encode_fwd")
    hash_encode_fwd_cuda.launches += 1
    return out


hash_encode_fwd_cuda.launches = 0


def hash_encode_bwd_cuda(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                         cfg: HashGridConfig, hash: str = "xor", gather_dtype=None,
                         need_dx: bool = True):
    """One launch of the backward kernels (K8): (d_table (L, T, F) fp32, d_x
    (B, d) or None). d_table is summed in int64 fixed point, up to four words
    an element, and is bitwise repeatable (`dtable_fixed_point_reference`
    gives its bits); d_x is summed per point in a fixed order."""
    L, T, F, n, d, dev, info = _kernel_args(table, x, cfg, hash, gather_dtype)
    cuda_build.check_tensor("g", g, (n, L * F), dev)
    if g.data_ptr() % 16:
        raise ValueError("g: the kernels' vector loads need 16-byte alignment")
    lib = cuda_build.library()
    d_table = torch.empty((L, T, F), dtype=torch.float32, device=dev)
    acc = torch.empty((MAX_WORDS, L, T, F), dtype=torch.int64, device=dev)  # word i of each
    gmax = torch.empty((1,), dtype=torch.int32, device=dev)
    d_x = torch.empty((n, d), dtype=torch.float32, device=dev) if need_dx else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.netpu_hash_encode_bwd(
            table.data_ptr(), x.data_ptr(), g.data_ptr(), d_table.data_ptr(),
            None if d_x is None else d_x.data_ptr(), acc.data_ptr(), gmax.data_ptr(),
            ctypes.cast(info, ctypes.c_void_p), L, T, F, d, n, int(hash == "additive"),
            int(gather_dtype is not None), stream)
    cuda_build.check(code, "netpu_hash_encode_bwd")
    hash_encode_bwd_cuda.launches += 1
    return d_table, d_x


hash_encode_bwd_cuda.launches = 0


class HashEncode(torch.autograd.Function):
    """(table (L, T, F), x (B, d)) -> (B, L*F) on CUDA tensors: the forward
    kernel, and the backward kernel for the gradients."""

    @staticmethod
    def forward(ctx, table, x, cfg, hash, gather_dtype):
        ctx.save_for_backward(table, x)
        ctx.args = (cfg, hash, gather_dtype)
        return hash_encode_fwd_cuda(table, x, cfg, hash, gather_dtype)

    @staticmethod
    def backward(ctx, g):
        table, x = ctx.saved_tensors
        d_table, d_x = hash_encode_bwd_cuda(table, x, g.contiguous(), *ctx.args,
                                            need_dx=ctx.needs_input_grad[1])
        return d_table, d_x, None, None, None


def encode(params: HashGrid, cfg: HashGridConfig, x: torch.Tensor, hash: str = "xor",
           gather_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (B, d) in [0,1]^d -> (B, L*F) fp32 level features (the contract of
    the JAX package's `encode_fused`). hash "xor" (`encode`, `encode_fused`,
    `encode_matmul`) or "additive" (`encode_rolled`, power-of-two T only)."""
    T = params.table.shape[1]
    if hash == "additive" and T & (T - 1):
        raise ValueError(
            "the additive hash needs a power-of-two table_size (uint32 index "
            f"arithmetic is exact only when table_size | 2^32); got {T}")
    if hash not in ("xor", "additive"):
        raise ValueError(f"unknown hash {hash!r}")
    if x.device.type == "cuda":
        return HashEncode.apply(params.table, x.contiguous(), cfg, hash, gather_dtype)
    return encode_reference(params.table, cfg, x, hash, gather_dtype)
