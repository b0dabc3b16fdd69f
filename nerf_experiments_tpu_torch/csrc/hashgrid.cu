// Multiresolution hash-grid encoding (Instant-NGP), forward and backward, for
// one NVIDIA H100.
//
// The forward (K7) replaces the TPU kernel
// `nerf_experiments_tpu/ops/hashgrid_pallas.py:_fwd_kernel` (the per-level row
// fetch feats[r] = table[idx_r], run there as a one-hot matmul on the MXU), the
// backward (K8) its `_dtable_kernel` (the table gradient dT[t] = sum_{idx_r = t}
// c_r, accumulated there across the sequential grid). Both are fused here with
// the index and interpolation arithmetic around them (`ops/hashgrid.py`):
//   per level l of resolution res, for a point x in [0,1]^d and each of its 2^d
//   corners k = floor(x res) + bit(c): row = hash(k) (xor of k_i * prime_i mod
//   T, or the strided index on bijective levels with k clipped to [0, res]; the
//   additive hash of `encode_rolled` gives (base + delta_c) mod t_eff), weight
//   w = prod_i (1 - |x_i res - k_i|), and out[l] = sum_c w_c table[l, row_c].
//   All index arithmetic is uint32, which wraps as the JAX package's does.
//
// What bounds them on the H100. Neither is bound by HBM (the output, 64 MB at
// 524,288 points, L 16, F 2, is the largest stream: 0.02 ms) but by the L2:
// the forward's 2^d random row reads a (point, level), each a 32-byte sector
// of a table that stays in the 50 MB L2, and the backward's 2^d F random adds
// into the table gradient, which the L2 serves a sector request at a time.
// The TPU's one-hot matmul and its packed (R, 8) ids are not carried over: a
// gather and an atomic add are cheap here.
//
// Forward (`hash_fwd_kernel`): one wave of blocks, each owning a run of points
// and all their levels; one thread a (point, level), level fastest, so a warp
// writes a contiguous run of the (B, L*F) output in F-wide vector stores. The
// two x-corners of a cell (the corner's top bit; primes[0] = 1) fall on rows h
// and h^1 of a hashed level, or on base and base + 1 of a bijective one: when
// the two rows are such an aligned pair (F <= 2) and the level starts on a
// pair boundary (l T even: always for an even table size), one 8- or 16-byte
// load serves both. The small bijective levels stay on chip in the L1 by
// themselves: staging levels 0 and 1 in shared memory took that space from the
// L1 and was slower, so the kernel has no stage.
//
// Backward: d_table is bitwise repeatable and exact. Each contribution w_c g
// is cut into up to four int64 words at per-launch scales and added with
// 64-bit integer atomics; integer addition is associative, so any order of
// the atomics gives the same bits (the TPU kernel gets one answer from its
// sequential grid), and `ops/hashgrid.py:dtable_fixed_point_reference` gives
// them too.
//   1. `abs_max_kernel`: max |g| (as the bits of a non-negative float, one
//      atomicMax a block). s = 62 - d - ceil(log2 n) - e, where max|g| = m 2^e,
//      m in [0.5, 1): a row takes at most 2^d n terms of |q| <= 2^(e+s) + 1/2,
//      so no sum reaches 2^63 (`ops/hashgrid.py:fixed_point_shift`, clamped
//      to [-126, 126]). A non-finite g gives an all-NaN d_table, so the
//      trainer's finite guard still sees it.
//   2. `hash_bwd_global_kernel`: every level, 2F lanes a (point, level), one
//      a (x bit, feature), so that one instruction adds a corner pair's F
//      features: for an aligned pair of rows its 2F words share one 32-byte
//      sector, and the L2 takes one request where one lane a corner would send
//      2F. g is read coalesced. Summing the small bijective levels in shared
//      memory first saved 0-2 % of K8 at 262,144 points and went.
//      A term v = c 2^s (exact in fp32) goes in as word 0 = rint(v), then
//      word i = rint(v_i) of the remainder v_i = (v_(i-1) - word (i-1)) 2^K:
//      each remainder is the fraction of an fp32 value, exact, at most 1/2,
//      and K = 63 - d - ceil(log2 n) keeps 2^d n words of |q| <= 2^(K-1)
//      inside int64 (`ops/hashgrid.py:fixed_point_lo_shift`). A word that is
//      0 is not added, so a term takes one atomic per nonzero word: the
//      first alone for terms above ~2^-17 max|g|, where the fraction is 0.
//   3. `fixed_to_float_kernel`: every element to fp32 as the sum over i of
//      word i 2^-(s+iK) in float64, untouched rows included, so d_table
//      needs no zeroing.
// The words a launch keeps (`fixed_point_words`) reach 2^-149, fp32's
// smallest step, whenever s >= 0 and s + 3K >= 149 (at 524,288 3-D points:
// any max|g| below 2^14): every fp32 term is then represented exactly and
// d_table is its exact sum, rounded once (in float64, then to fp32). A
// single word's quantum 2^-s zeroed 0.13-0.44 % of a trained INGP step's
// nonzero elements, two words 4 elements of 1.4 million, at 9e-27 max|g|
// (PERF.md). The accumulator holds four words an element (64 MiB at L16 F2
// T 2^16).
// d_x (`hash_dx_kernel`, only when asked): one thread a (point, level) forms
// the level's term with the forward's paired loads, then one thread a point
// adds the L terms in level order, with d|u|/du = +1 at u = 0 (the JAX
// package's convention) and the gathered (bf16-rounded when asked) rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kFwdThreads = 512;
constexpr int kFwdBlocks = 264;  // two blocks an SM on the H100's 132 SMs
constexpr int kShiftMin = -126, kShiftMax = 126;  // 2^s a normal fp32

struct Levels {
  int res[kMaxLevels];
  unsigned t_eff[kMaxLevels];
  int bijective[kMaxLevels];
  unsigned primes[3];
  int n_levels;
  int table_size;
  int n;
  int ceil_log2_n;
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

// prod_i of the corner's factors, left to right as the plain version's
// fac[..., 0] * fac[..., 1] * ...: the backward's emulation
// (`dtable_fixed_point_reference`) relies on the same fp32 product.
template <int D>
__device__ __forceinline__ float corner_weight(const Cell<D>& cell, int c) {
  float w = 1.f;
#pragma unroll
  for (int i = 0; i < D; ++i) w = __fmul_rn(w, corner_bit<D>(c, i) ? cell.f1[i] : cell.f0[i]);
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

// Rows a and b (F <= 2) with one load when they are the aligned pair
// {2k, 2k+1} and tl, the level's first row, is a pair boundary (one 2F-float
// vector load is then aligned), else with two.
template <int F>
__device__ __forceinline__ void load_row_pair(const float* __restrict__ tl, bool tl_paired,
                                              unsigned a, unsigned b, float (&va)[F],
                                              float (&vb)[F], bool bf16) {
  if (tl_paired && (a ^ b) == 1u) {
    const unsigned even = a & ~1u;
    float lo[F], hi[F];
    if constexpr (F == 1) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(tl + even));
      lo[0] = t.x;
      hi[0] = t.y;
    } else {
      const float4 t = __ldg(reinterpret_cast<const float4*>(tl + 2 * static_cast<size_t>(even)));
      lo[0] = t.x;
      lo[1] = t.y;
      hi[0] = t.z;
      hi[1] = t.w;
    }
    const bool a_odd = a & 1u;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      va[f] = bf16 ? round_bf16(a_odd ? hi[f] : lo[f]) : (a_odd ? hi[f] : lo[f]);
      vb[f] = bf16 ? round_bf16(a_odd ? lo[f] : hi[f]) : (a_odd ? lo[f] : hi[f]);
    }
  } else {
    load_row<F>(tl + static_cast<size_t>(a) * F, va, bf16);
    load_row<F>(tl + static_cast<size_t>(b) * F, vb, bf16);
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

// Level l's rows start on a pair boundary (with a 16-byte aligned table) when
// l T is even.
__device__ __forceinline__ bool paired_level(int l, int table_size) {
  return ((static_cast<long long>(l) * table_size) & 1) == 0;
}

template <int D>
__device__ __forceinline__ void load_point(const float* __restrict__ x, long long pt,
                                           float (&xp)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) xp[i] = __ldg(x + pt * D + i);
}

// ---------------------------------------------------------------- forward

// A block owns points [blockIdx.x * pts, +pts) and all their levels; out
// (n, L*F).
template <int D, int F>
__global__ void __launch_bounds__(kFwdThreads, 2)
hash_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                float* __restrict__ out, const Levels p, int pts) {
  __shared__ SharedLevels s;
  load_levels(p, s);
  const int L = p.n_levels;
  const int p0 = blockIdx.x * pts;
  const int items = (min(p0 + pts, p.n) - p0) * L;
  const unsigned primes[3] = {p.primes[0], p.primes[1], p.primes[2]};
  constexpr int kHalf = 1 << (D - 1);  // corners c and c + kHalf differ along x
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int q = i / L;
    const long long pt = p0 + q;
    const int l = i - q * L;
    float xp[D];
    load_point<D>(x, pt, xp);
    const int res = s.res[l];
    const Cell<D> cell = make_cell<D>(xp, res);
    const unsigned t_eff = s.t_eff[l];
    const bool bij = s.bijective[l];
    const float* tl = table + static_cast<size_t>(l) * p.table_size * F;
    unsigned rows[1 << D];
#pragma unroll
    for (int c = 0; c < (1 << D); ++c)
      rows[c] = corner_row<D>(cell, c, res, t_eff, bij, p.additive, primes,
                              static_cast<unsigned>(p.table_size));
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      float va[F], vb[F];
      if constexpr (F <= 2) {
        load_row_pair<F>(tl, paired_level(l, p.table_size), rows[c], rows[c + kHalf], va, vb,
                         p.bf16);
      } else {
        load_row<F>(tl + static_cast<size_t>(rows[c]) * F, va, p.bf16);
        load_row<F>(tl + static_cast<size_t>(rows[c + kHalf]) * F, vb, p.bf16);
      }
      const float wa = corner_weight<D>(cell, c), wb = corner_weight<D>(cell, c + kHalf);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += wa * va[f] + wb * vb[f];
    }
    store_row<F>(out + (pt * L + l) * F, acc);
  }
}

// ---------------------------------------------------------------- backward

// max |g| over `count` floats (16-byte aligned) into *out (zeroed by the
// caller), as the bits of a non-negative float: their unsigned order is the
// floats' order, and a NaN's bits exceed +inf's.
__global__ void __launch_bounds__(kThreads)
abs_max_kernel(const float* __restrict__ g, long long count, unsigned* __restrict__ out) {
  unsigned m = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = first; i < count / 4; i += stride) {
    const float4 v = __ldg(g4 + i);
    m = max(m, max(max(__float_as_uint(fabsf(v.x)), __float_as_uint(fabsf(v.y))),
                   max(__float_as_uint(fabsf(v.z)), __float_as_uint(fabsf(v.w)))));
  }
  for (long long i = count / 4 * 4 + first; i < count; i += stride)
    m = max(m, __float_as_uint(fabsf(__ldg(g + i))));
  __shared__ unsigned warp_max[kThreads / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = __reduce_max_sync(0xffffffffu, threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u);
    if (threadIdx.x == 0 && m != 0) atomicMax(out, m);  // one atomic a block
  }
}

// The fixed-point scales of a launch (ops/hashgrid.py:fixed_point_shift,
// fixed_point_lo_shift and fixed_point_words).
constexpr int kMaxWords = 4;

struct Scale {
  float up;                 // 2^s: a contribution c becomes v = c 2^s
  float up_lo;              // 2^K: the next word's scale on the remainder
  double down[kMaxWords];   // 2^-(s+iK), word i's weight
  int words;                // the words this launch adds
  bool finite;
};

__device__ __forceinline__ Scale load_scale(const unsigned* gmax, int dim, int ceil_log2_n) {
  const unsigned bits = *gmax;
  const int k = 63 - dim - ceil_log2_n;
  Scale sc;
  sc.finite = bits < 0x7f800000u;
  sc.up_lo = ldexpf(1.f, k);
  int s = 0;
  if (bits != 0 && sc.finite) {
    int e;
    frexpf(__uint_as_float(bits), &e);
    s = min(max(62 - dim - ceil_log2_n - e, kShiftMin), kShiftMax);
  }
  sc.up = ldexpf(1.f, s);
  sc.words = min(kMaxWords, 1 + (149 - s + k - 1) / k);
  for (int i = 0; i < kMaxWords; ++i) sc.down[i] = ldexp(1.0, -s - i * k);
  return sc;
}

// add(i, q) for each nonzero word q of c: q_0 = rint(c 2^s), then the
// remainder scaled by 2^K and rounded, each step exact in fp32 (half to
// even, as torch.round); the remainder is 0 after the last nonzero word.
template <typename Add>
__device__ __forceinline__ void quantise(float c, const Scale& sc, Add add) {
  float v = __fmul_rn(c, sc.up);
  for (int i = 0; i < sc.words && v != 0.f; ++i) {
    const float q = rintf(v);
    if (q != 0.f) add(i, static_cast<unsigned long long>(__float2ll_rn(q)));
    v = __fmul_rn(__fsub_rn(v, q), sc.up_lo);
  }
}

// The backward's lanes: 2F a (point, level), one a (x bit, feature). A group
// adds the F features of the two x-corners of a cell in one instruction, and
// when the two rows are an aligned pair (h and h^1, or base and base + 1 with
// base even) its 2F words are adjacent: for F = 2 one 32-byte sector, which the
// L2 serves as one request where 2F separate adds would take 2F.
template <int F>
struct GroupLane {
  static constexpr int kSize = 2 * F;
  int xbit, f;
  __device__ explicit GroupLane(int t) : xbit((t % kSize) / F), f(t % F) {}
};

// The 2^(d-1) corners of lane.xbit: add(element, i, q) for each nonzero word
// q (the i-th) of w_c g_f, element row_c F + f of the level.
template <int D, int F, typename Add>
__device__ __forceinline__ void add_corners(const Cell<D>& cell, GroupLane<F> lane, float gf,
                                            const Scale& sc, int res, unsigned t_eff,
                                            bool bijective, bool additive, const unsigned* primes,
                                            unsigned table_size, Add add) {
  constexpr int kHalf = 1 << (D - 1);
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    const int corner = c + lane.xbit * kHalf;
    const unsigned row =
        corner_row<D>(cell, corner, res, t_eff, bijective, additive, primes, table_size);
    const unsigned element = row * F + lane.f;
    quantise(__fmul_rn(corner_weight<D>(cell, corner), gf), sc,
             [&](int i, unsigned long long q) { add(element, i, q); });
  }
}

// A group of 2F lanes a (point, level), level fastest: g read coalesced,
// every nonzero word of a contribution one global 64-bit atomic, word i at
// i L T F words into the accumulator.
template <int D, int F>
__global__ void __launch_bounds__(kThreads)
hash_bwd_global_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       unsigned long long* __restrict__ acc, const unsigned* __restrict__ gmax,
                       const Levels p) {
  __shared__ SharedLevels s;
  load_levels(p, s);
  const Scale sc = load_scale(gmax, D, p.ceil_log2_n);
  if (!sc.finite) return;
  constexpr int G = GroupLane<F>::kSize;
  const int L = p.n_levels;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int item = t / G;
  if (item >= p.n * L) return;
  const GroupLane<F> lane(t);
  const int q = item / L;
  const int l = item - q * L;
  const unsigned primes[3] = {p.primes[0], p.primes[1], p.primes[2]};
  float xp[D];
  load_point<D>(x, q, xp);
  const int res = s.res[l];
  const float gf = __ldg(g + (static_cast<size_t>(q) * p.n_levels + l) * F + lane.f);
  const size_t words = static_cast<size_t>(L) * p.table_size * F;
  unsigned long long* dst = acc + static_cast<size_t>(l) * p.table_size * F;
  add_corners<D, F>(make_cell<D>(xp, res), lane, gf, sc, res, s.t_eff[l], s.bijective[l],
                    p.additive, primes, static_cast<unsigned>(p.table_size),
                    [&](unsigned element, int i, unsigned long long word) {
                      atomicAdd(dst + i * words + element, word);
                    });
}

// d_table = sum over the launch's words of word i 2^-(s+iK), in float64 in
// the order of i (each product exact), rounded to fp32; NaN everywhere for a
// non-finite g.
__global__ void __launch_bounds__(kThreads)
fixed_to_float_kernel(const long long* __restrict__ acc, float* __restrict__ out,
                      long long count, const unsigned* __restrict__ gmax, int dim,
                      int ceil_log2_n) {
  const Scale sc = load_scale(gmax, dim, ceil_log2_n);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    double sum = 0.0;
    for (int w = 0; w < sc.words; ++w)
      sum = __dadd_rn(sum, __dmul_rn(__ll2double_rn(acc[w * count + i]), sc.down[w]));
    out[i] = sc.finite ? __double2float_rn(sum) : __int_as_float(0x7fc00000);
  }
}

// d_x (n, dim): one thread a (point, level) forms the level's term res * sum_c
// (...) with the forward's paired row loads; then one thread a point adds the
// L terms in level order, so d_x is the same sum at every launch.
template <int D, int F>
__global__ void __launch_bounds__(kThreads)
hash_dx_kernel(const float* __restrict__ table, const float* __restrict__ x,
               const float* __restrict__ g, float* __restrict__ d_x, const Levels p) {
  __shared__ SharedLevels s;
  __shared__ float part[kThreads][D];
  load_levels(p, s);
  const int L = p.n_levels;
  const int per_block = kThreads / L;  // points a block
  const int q = threadIdx.x / L, l = threadIdx.x - q * L;
  const int pt = blockIdx.x * per_block + q;
  float term[D];
#pragma unroll
  for (int i = 0; i < D; ++i) term[i] = 0.f;
  if (q < per_block && pt < p.n) {
    const unsigned primes[3] = {p.primes[0], p.primes[1], p.primes[2]};
    constexpr int kHalf = 1 << (D - 1);
    float xp[D];
    load_point<D>(x, pt, xp);
    const int res = s.res[l];
    const Cell<D> cell = make_cell<D>(xp, res);
    float gl[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gl[f] = __ldg(g + (static_cast<size_t>(pt) * L + l) * F + f);
    const float* tl = table + static_cast<size_t>(l) * p.table_size * F;
    float v[1 << D][F];
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      const unsigned ra = corner_row<D>(cell, c, res, s.t_eff[l], s.bijective[l], p.additive,
                                        primes, static_cast<unsigned>(p.table_size));
      const unsigned rb = corner_row<D>(cell, c + kHalf, res, s.t_eff[l], s.bijective[l],
                                        p.additive, primes, static_cast<unsigned>(p.table_size));
      if constexpr (F <= 2) {
        load_row_pair<F>(tl, paired_level(l, p.table_size), ra, rb, v[c], v[c + kHalf],
                         p.bf16);
      } else {
        load_row<F>(tl + static_cast<size_t>(ra) * F, v[c], p.bf16);
        load_row<F>(tl + static_cast<size_t>(rb) * F, v[c + kHalf], p.bf16);
      }
    }
    float dxs[D];
#pragma unroll
    for (int i = 0; i < D; ++i) dxs[i] = 0.f;
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      float dot = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) dot += v[c][f] * gl[f];
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
#pragma unroll
    for (int i = 0; i < D; ++i) term[i] = static_cast<float>(res) * dxs[i];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) part[threadIdx.x][i] = term[i];
  __syncthreads();
  const int own = blockIdx.x * per_block + threadIdx.x;
  if (threadIdx.x < per_block && own < p.n) {
    float dx[D];
#pragma unroll
    for (int i = 0; i < D; ++i) dx[i] = 0.f;
    for (int k = 0; k < L; ++k)
#pragma unroll
      for (int i = 0; i < D; ++i) dx[i] += part[threadIdx.x * L + k][i];
#pragma unroll
    for (int i = 0; i < D; ++i) d_x[static_cast<size_t>(own) * D + i] = dx[i];
  }
}

// info: [res, t_eff, bijective] per level, then three primes. Indices of
// (point, level, lane) stay below 2^31.
bool make_levels(const unsigned* info, int n_levels, int table_size, int n, int additive,
                 int bf16, Levels* p) {
  if (n_levels < 1 || n_levels > kMaxLevels || table_size < 1 || n < 0 ||
      16ll * n * n_levels >= (1ll << 31))
    return false;
  *p = Levels{};
  for (int l = 0; l < n_levels; ++l) {
    const unsigned* row = info + 3 * l;
    p->res[l] = static_cast<int>(row[0]);
    p->t_eff[l] = row[1];
    p->bijective[l] = static_cast<int>(row[2]);
    if (row[1] < 1 || row[1] > static_cast<unsigned>(table_size)) return false;
  }
  for (int i = 0; i < 3; ++i) p->primes[i] = info[3 * n_levels + i];
  p->n_levels = n_levels;
  p->table_size = table_size;
  p->n = n;
  int c = 0;
  while ((1ll << c) < n) ++c;
  p->ceil_log2_n = c;
  p->additive = additive;
  p->bf16 = bf16;
  return true;
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, cudaStream_t stream,
                   const void* const* args) {
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, threads,
                          const_cast<void**>(args), 0, stream);
}

// The instance of KERNEL<dim, F> for the runtime (dim, n_features), or null.
#define NETPU_HASH_PICK(OUT, KERNEL)                                 \
  switch (dim * 16 + n_features) {                                   \
    case 2 * 16 + 1: OUT = KERNEL<2, 1>; break;                      \
    case 2 * 16 + 2: OUT = KERNEL<2, 2>; break;                      \
    case 2 * 16 + 4: OUT = KERNEL<2, 4>; break;                      \
    case 2 * 16 + 8: OUT = KERNEL<2, 8>; break;                      \
    case 3 * 16 + 1: OUT = KERNEL<3, 1>; break;                      \
    case 3 * 16 + 2: OUT = KERNEL<3, 2>; break;                      \
    case 3 * 16 + 4: OUT = KERNEL<3, 4>; break;                      \
    case 3 * 16 + 8: OUT = KERNEL<3, 8>; break;                      \
    default: return static_cast<int>(cudaErrorInvalidValue);         \
  }

}  // namespace

// table (L, T, F), x (n, dim) in [0,1]^dim, out (n, L*F); level_info is a host
// array of 3 L + 3 uint32 (see make_levels). dim in {2, 3}, F in {1, 2, 4, 8};
// table and out 16-byte aligned; any table size.
extern "C" int netpu_hash_encode_fwd(const float* table, const float* x, float* out,
                                     const unsigned* level_info, int n_levels,
                                     int table_size, int n_features, int dim, int n,
                                     int additive, int bf16, void* stream) {
  Levels p;
  if (!make_levels(level_info, n_levels, table_size, n, additive, bf16, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    void (*kernel)(const float*, const float*, float*, const Levels, int);
    NETPU_HASH_PICK(kernel, hash_fwd_kernel)
    // one wave of kFwdBlocks blocks, a multiple of 32 points each
    int pts = (n + kFwdBlocks - 1) / kFwdBlocks;
    pts = (pts + 31) / 32 * 32;
    const unsigned blocks = static_cast<unsigned>((n + pts - 1) / pts);
    const void* args[] = {&table, &x, &out, &p, &pts};
    const cudaError_t e =
        launch(kernel, dim3(blocks), kFwdThreads, static_cast<cudaStream_t>(stream), args);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward of netpu_hash_encode_fwd for the cotangent g (n, L*F): writes
// every element of d_table (L, T, F), and d_x (n, dim) unless it is null.
// acc (4 L*T*F int64: word 0 of every element, then word 1, ...) and gmax
// (one uint32) are the caller's scratch.
extern "C" int netpu_hash_encode_bwd(const float* table, const float* x, const float* g,
                                     float* d_table, float* d_x, long long* acc,
                                     unsigned* gmax, const unsigned* level_info,
                                     int n_levels, int table_size, int n_features, int dim,
                                     int n, int additive, int bf16, void* stream) {
  Levels p;
  if (!make_levels(level_info, n_levels, table_size, n, additive, bf16, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = static_cast<long long>(n_levels) * table_size * n_features;
  if (n == 0) return static_cast<int>(cudaMemsetAsync(d_table, 0, words * 4, s));
  cudaError_t e = cudaMemsetAsync(acc, 0, kMaxWords * words * 8, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(gmax, 0, 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long g_count = static_cast<long long>(n) * n_levels * n_features;
  abs_max_kernel<<<static_cast<unsigned>(min((g_count / 4 + kThreads - 1) / kThreads + 1,
                                             1024ll)),
                   kThreads, 0, s>>>(g, g_count, gmax);
  unsigned long long* uacc = reinterpret_cast<unsigned long long*>(acc);
  {
    void (*kernel)(const float*, const float*, unsigned long long*, const unsigned*,
                   const Levels);
    NETPU_HASH_PICK(kernel, hash_bwd_global_kernel)
    const long long total = 2ll * n_features * n * n_levels;
    const void* args[] = {&x, &g, &uacc, &gmax, &p};
    e = launch(kernel, dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads)),
               kThreads, s, args);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fixed_to_float_kernel<<<static_cast<unsigned>(min((words + kThreads - 1) / kThreads, 8192ll)),
                          kThreads, 0, s>>>(acc, d_table, words, gmax, dim, p.ceil_log2_n);
  if (d_x != nullptr) {
    void (*kernel)(const float*, const float*, const float*, float*, const Levels);
    NETPU_HASH_PICK(kernel, hash_dx_kernel)
    const int per_block = kThreads / n_levels;
    const void* args[] = {&table, &x, &g, &d_x, &p};
    e = launch(kernel, dim3(static_cast<unsigned>((n + per_block - 1) / per_block)), kThreads,
               s, args);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
