// Multiresolution hash-grid encoding (Instant-NGP), forward and backward, for
// one NVIDIA H100.
//
// The forward replaces the TPU kernel
// `nerf_experiments_tpu/ops/hashgrid_pallas.py:_fwd_kernel` (the per-level row
// fetch feats[r] = table[idx_r], run there as a one-hot matmul on the MXU), the
// backward its `_dtable_kernel` (the table gradient dT[t] = sum_{idx_r = t} c_r,
// accumulated there across the sequential grid). Both are fused here with the
// index and interpolation arithmetic around them (`ops/hashgrid.py`):
//   per level l of resolution res, for a point x in [0,1]^d and each of its 2^d
//   corners k = floor(x res) + bit(c): row = hash(k) (xor of k_i * prime_i mod
//   T, or the strided index on bijective levels with k clipped to [0, res]; the
//   additive hash of `encode_rolled` gives (base + delta_c) mod t_eff), weight
//   w = prod_i (1 - |x_i res - k_i|), and out[l] = sum_c w_c table[l, row_c].
//   All index arithmetic is uint32, which wraps as the JAX package's does.
//
// What bounds it on the H100: memory. A point reads d coordinates and writes
// L*F features (the output is the largest stream: 64 MB at 524,288 points, L 16,
// F 2); the 2^d corner rows per level are random 4-32 byte reads of a table of
// at most a few MB a level, which stays in the 50 MB L2. The TPU's one-hot
// matmul and its packed (R, 8) ids are not carried over: a gather is cheap here.
// Forward: one thread per (point, level), level fastest, so a warp writes a
// contiguous run of the (B, L*F) output in F-wide vector stores; the per-level
// constants sit in shared memory.
//
// Backward: one thread per point walks the levels, recomputes rows and weights,
// and adds w_c g into d_table with fp32 atomics (the TPU's accumulator carried
// across sequential grid steps cannot run on concurrent blocks). Contention is
// highest on the bijective low-resolution levels (at res 16 in 3-D, 4,913 rows
// take 8 contributions from every point); privatising such a level in shared
// memory is left for later. Atomics add in no fixed order, so d_table differs
// between launches in the last bits. d_x is summed per point in a fixed order,
// with d|u|/du = +1 at u = 0 (the JAX package's convention) and the gathered
// (bf16-rounded when asked) rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct Levels {
  int res[kMaxLevels];
  unsigned t_eff[kMaxLevels];
  int bijective[kMaxLevels];
  unsigned primes[3];
  int n_levels;
  int table_size;
  int n;
  int additive;
  int bf16;
};

struct SharedLevels {
  int res[kMaxLevels];
  unsigned t_eff[kMaxLevels];
  int bijective[kMaxLevels];
};

__device__ __forceinline__ void load_levels(const Levels& p, SharedLevels& s) {
  for (int l = threadIdx.x; l < p.n_levels; l += blockDim.x) {
    s.res[l] = p.res[l];
    s.t_eff[l] = p.t_eff[l];
    s.bijective[l] = p.bijective[l];
  }
  __syncthreads();
}

template <int D>
__device__ __forceinline__ int corner_bit(int c, int i) {
  return (c >> (D - 1 - i)) & 1;
}

// One level's cell around a point: per axis the lower corner, the factors
// 1 - |u| of the lower and upper corner, and the signs of u (+1 at u = 0).
template <int D>
struct Cell {
  int lo[D];
  float f0[D], f1[D];
  float s0[D], s1[D];
};

template <int D>
__device__ __forceinline__ Cell<D> make_cell(const float (&x)[D], int res) {
  Cell<D> cell;
  const float r = static_cast<float>(res);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float xs = __fmul_rn(x[i], r);  // one rounding, seen by floor and by u
    cell.lo[i] = static_cast<int>(floorf(xs));
    const float u0 = xs - static_cast<float>(cell.lo[i]);
    const float u1 = xs - static_cast<float>(cell.lo[i] + 1);
    cell.f0[i] = 1.f - fabsf(u0);
    cell.f1[i] = 1.f - fabsf(u1);
    cell.s0[i] = u0 >= 0.f ? 1.f : -1.f;
    cell.s1[i] = u1 >= 0.f ? 1.f : -1.f;
  }
  return cell;
}

template <int D>
__device__ __forceinline__ float corner_weight(const Cell<D>& cell, int c) {
  float w = 1.f;
#pragma unroll
  for (int i = 0; i < D; ++i) w *= corner_bit<D>(c, i) ? cell.f1[i] : cell.f0[i];
  return w;
}

// The table row of corner c (ops/hashgrid.py: _level_indices for xor,
// _rolled_level_base_and_deltas for additive).
template <int D>
__device__ __forceinline__ unsigned corner_row(const Cell<D>& cell, int c, int res,
                                               unsigned t_eff, bool bijective, bool additive,
                                               const unsigned* primes, unsigned table_size) {
  if (bijective) {
    unsigned base = 0, delta = 0, stride = 1;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int bit = corner_bit<D>(c, i);
      if (additive) {
        base += static_cast<unsigned>(cell.lo[i]) * stride;
        delta += static_cast<unsigned>(bit) * stride;
      } else {
        const int k = min(max(cell.lo[i] + bit, 0), res);
        base += static_cast<unsigned>(k) * stride;
      }
      stride *= static_cast<unsigned>(res + 1);
    }
    return additive ? static_cast<unsigned>(
                          (static_cast<unsigned long long>(base) + delta) % t_eff)
                    : base;
  }
  if (additive) {
    unsigned base = 0, delta = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      base += static_cast<unsigned>(cell.lo[i]) * primes[i];
      delta += static_cast<unsigned>(corner_bit<D>(c, i)) * primes[i];
    }
    base %= table_size;
    delta %= table_size;
    return static_cast<unsigned>((static_cast<unsigned long long>(base) + delta) % t_eff);
  }
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
    acc ^= static_cast<unsigned>(cell.lo[i] + corner_bit<D>(c, i)) * primes[i];
  return acc % table_size;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// F features of one row (16-byte aligned table: F-wide vector loads).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&v)[F], bool bf16) {
  if constexpr (F == 1) {
    v[0] = __ldg(p);
  } else if constexpr (F == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = t.x;
      v[k + 1] = t.y;
      v[k + 2] = t.z;
      v[k + 3] = t.w;
    }
  }
  if (bf16) {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = round_bf16(v[f]);
  }
}

template <int F>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float (&v)[F]) {
  if constexpr (F == 1) {
    *p = v[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

// One thread per (point, level), level fastest: out (n, L*F).
template <int D, int F>
__global__ void __launch_bounds__(kThreads)
hash_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                float* __restrict__ out, const Levels p) {
  __shared__ SharedLevels s;
  load_levels(p, s);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(p.n) * p.n_levels) return;
  const long long pt = t / p.n_levels;
  const int l = static_cast<int>(t - pt * p.n_levels);
  const unsigned primes[3] = {p.primes[0], p.primes[1], p.primes[2]};

  float xp[D];
#pragma unroll
  for (int i = 0; i < D; ++i) xp[i] = __ldg(x + pt * D + i);
  const int res = s.res[l];
  const Cell<D> cell = make_cell<D>(xp, res);
  const float* tl = table + static_cast<size_t>(l) * p.table_size * F;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    const unsigned row = corner_row<D>(cell, c, res, s.t_eff[l], s.bijective[l], p.additive,
                                       primes, static_cast<unsigned>(p.table_size));
    float v[F];
    load_row<F>(tl + static_cast<size_t>(row) * F, v, p.bf16);
    const float w = corner_weight<D>(cell, c);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += w * v[f];
  }
  store_row<F>(out + t * F, acc);
}

// One thread per point, levels in turn: d_table by atomics, d_x (nullable) in
// registers.
template <int D, int F>
__global__ void __launch_bounds__(kThreads)
hash_bwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                const float* __restrict__ g, float* __restrict__ d_table,
                float* __restrict__ d_x, const Levels p) {
  __shared__ SharedLevels s;
  load_levels(p, s);
  const long long pt = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pt >= p.n) return;
  const unsigned primes[3] = {p.primes[0], p.primes[1], p.primes[2]};

  float xp[D], dx[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    xp[i] = __ldg(x + pt * D + i);
    dx[i] = 0.f;
  }
  const float* gp = g + pt * p.n_levels * F;
  for (int l = 0; l < p.n_levels; ++l) {
    const int res = s.res[l];
    const Cell<D> cell = make_cell<D>(xp, res);
    float gl[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gl[f] = __ldg(gp + l * F + f);
    const size_t level = static_cast<size_t>(l) * p.table_size * F;
    float dxs[D];
#pragma unroll
    for (int i = 0; i < D; ++i) dxs[i] = 0.f;
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      const unsigned row = corner_row<D>(cell, c, res, s.t_eff[l], s.bijective[l],
                                         p.additive, primes,
                                         static_cast<unsigned>(p.table_size));
      const size_t at = level + static_cast<size_t>(row) * F;
      const float w = corner_weight<D>(cell, c);
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(d_table + at + f, w * gl[f]);
      if (d_x != nullptr) {
        float v[F];
        load_row<F>(table + at, v, p.bf16);
        float dot = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) dot += v[f] * gl[f];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float others = 1.f;
#pragma unroll
          for (int j = 0; j < D; ++j)
            if (j != i) others *= corner_bit<D>(c, j) ? cell.f1[j] : cell.f0[j];
          const float sign = corner_bit<D>(c, i) ? cell.s1[i] : cell.s0[i];
          dxs[i] -= dot * sign * others;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) dx[i] += static_cast<float>(res) * dxs[i];
  }
  if (d_x != nullptr) {
#pragma unroll
    for (int i = 0; i < D; ++i) d_x[pt * D + i] = dx[i];
  }
}

// info: [res, t_eff, bijective] per level, then three primes.
bool make_levels(const unsigned* info, int n_levels, int table_size, int n, int additive,
                 int bf16, Levels* p) {
  if (n_levels < 1 || n_levels > kMaxLevels || table_size < 1 || n < 0) return false;
  *p = Levels{};
  for (int l = 0; l < n_levels; ++l) {
    p->res[l] = static_cast<int>(info[3 * l]);
    p->t_eff[l] = info[3 * l + 1];
    p->bijective[l] = static_cast<int>(info[3 * l + 2]);
  }
  for (int i = 0; i < 3; ++i) p->primes[i] = info[3 * n_levels + i];
  p->n_levels = n_levels;
  p->table_size = table_size;
  p->n = n;
  p->additive = additive;
  p->bf16 = bf16;
  return true;
}

#define NETPU_HASH_CASES(KERNEL, BLOCKS, STREAM, ...)                                  \
  switch (dim * 16 + n_features) {                                                     \
    case 2 * 16 + 1: KERNEL<2, 1><<<BLOCKS, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 2 * 16 + 2: KERNEL<2, 2><<<BLOCKS, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 2 * 16 + 4: KERNEL<2, 4><<<BLOCKS, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 2 * 16 + 8: KERNEL<2, 8><<<BLOCKS, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 3 * 16 + 1: KERNEL<3, 1><<<BLOCKS, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 3 * 16 + 2: KERNEL<3, 2><<<BLOCKS, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 3 * 16 + 4: KERNEL<3, 4><<<BLOCKS, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    case 3 * 16 + 8: KERNEL<3, 8><<<BLOCKS, kThreads, 0, STREAM>>>(__VA_ARGS__); break; \
    default: return static_cast<int>(cudaErrorInvalidValue);                           \
  }

}  // namespace

// table (L, T, F), x (n, dim) in [0,1]^dim, out (n, L*F); level_info is a host
// array of 3 L + 3 uint32 (see make_levels). dim in {2, 3}, F in {1, 2, 4, 8};
// table and out 16-byte aligned.
extern "C" int netpu_hash_encode_fwd(const float* table, const float* x, float* out,
                                     const unsigned* level_info, int n_levels,
                                     int table_size, int n_features, int dim, int n,
                                     int additive, int bf16, void* stream) {
  Levels p;
  if (!make_levels(level_info, n_levels, table_size, n, additive, bf16, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const long long total = static_cast<long long>(n) * n_levels;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    NETPU_HASH_CASES(hash_fwd_kernel, blocks, s, table, x, out, p)
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward of netpu_hash_encode_fwd for the cotangent g (n, L*F): adds into
// d_table (L, T, F), which the caller zeroes, and writes d_x (n, dim) unless it
// is null.
extern "C" int netpu_hash_encode_bwd(const float* table, const float* x, const float* g,
                                     float* d_table, float* d_x, const unsigned* level_info,
                                     int n_levels, int table_size, int n_features, int dim,
                                     int n, int additive, int bf16, void* stream) {
  Levels p;
  if (!make_levels(level_info, n_levels, table_size, n, additive, bf16, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    NETPU_HASH_CASES(hash_bwd_kernel, blocks, s, table, x, g, d_table, d_x, p)
  }
  return static_cast<int>(cudaGetLastError());
}
