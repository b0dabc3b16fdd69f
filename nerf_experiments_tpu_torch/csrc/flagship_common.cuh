// Device helpers shared by the flagship BARF radiance kernels
// (`flagship_render.cu`: K2, which K11 launches too; `flagship_train.cu`: K4),
// the GARF kernels (`garf_common.cuh`: K5, K6) and the fused MLP chain
// (`fused_mlp.cu`: K9, K10).
//
// K2, K4 (bf16; in fp32 its g W^T), K5, K6, K9 (bf16) and K10 run their
// matrix products on the tensor cores through the tile at the end of this
// file (`tile_gemm`; the GARF kernels and the chain bring their own
// epilogues and row tiles; the fp32 forwards of K4 and K9 run on the CUDA
// cores over the same tiles, `fma_tile.cuh`):
//   * row tile: a block of kThreads = 256 threads (8 warps) owns kR = 64 sample
//     rows; rays are packed kR / S to a block when S <= kR, so the north-star
//     shape (S = 32) fills a tile with two rays. Layers wide enough that a
//     64-row tile passes the block's 227 KB of shared memory take kR = 32
//     (the wrapper picks: `train_megakernel.tile_rows`; the flagship width
//     takes 64);
//   * activations stay in shared memory in the compute type (bf16 or fp32),
//     each layer's K and N zero-padded to a multiple of 16 there only (P = 63,
//     Q = 27, D + 1 = 257 and the 3 logits are the flagship's odd widths; any
//     hidden width D and colour width C are padded the same way), rows padded
//     by 16 bytes so the 8 rows of a fragment load fall on distinct banks;
//   * products: `mma.sync` (m16n8k16 bf16, or m16n8k8 tf32), fp32 accumulators
//     in registers; warp w owns n8 tiles 4w.. (+ 32 a pass) over all kR rows,
//     a kR x 32 block of kR accumulators. `mma.sync`, not `wgmma`: the
//     warpgroup instruction wants its B tile in shared memory behind matrix
//     descriptors, a rewrite left for a later change;
//   * weights: the wrapper packs each layer's B operand in fragment order
//     (`train_megakernel.pack_b`): one (n8 tile, k-step) fragment is 32 lanes
//     x 8 (bf16) or 16 (fp32 hi / lo) contiguous bytes. Each fragment feeds one
//     warp only (the warps split the columns), so there is no block-wide
//     stage and no TMA: each lane cp.asyncs its own share of its warp's
//     fragments from L2 (1.3 MB in bf16, 5.3 MB as fp32 hi / lo pairs;
//     resident) into a per-warp ring in shared memory, 3 (bf16) or 2 (fp32)
//     k-steps ahead (a prefetch of one k-step into registers instead left the
//     train kernel slower);
//   * bf16: operands bf16, fp32 accumulation, as the TPU kernel's
//     `dot_general(..., preferred_element_type=f32)`;
//   * fp32: 3xTF32. x = hi + lo with hi = tf32(x), lo = tf32(x - hi) (round to
//     nearest, `cvt.rna`), acc += lo hi' + hi lo' + hi hi'; the dropped lo lo'
//     term and lo's own rounding leave a relative error near 2^-22 a product,
//     fp32's order. The wrapper splits the weights once a call; activations
//     are split as their fragments are loaded;
//   * epilogue: bias, ReLU and the rounding to the compute type (`cde`) at the
//     points where the TPU kernel rounds; the density column D of the last
//     segment layer is a dot product on the CUDA cores, fp32 and unrounded.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace netpu {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float load_w(const float* w, size_t i) { return __ldg(w + i); }
__device__ __forceinline__ float load_w(const __nv_bfloat16* w, size_t i) {
  return __bfloat162float(w[i]);
}

__device__ __forceinline__ void store_act(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_act(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <bool kBf16>
__device__ __forceinline__ float cde(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

// The BARF window of every level: (1 - cos(clamp(alpha - l, 0, 1) pi)) / 2,
// position levels then direction levels.
__device__ __forceinline__ void barf_window(float* mask, int Lp, int Ld, float alpha_pos,
                                            float alpha_dir) {
  for (int l = threadIdx.x; l < Lp + Ld; l += blockDim.x) {
    const float a = l < Lp ? alpha_pos - l : alpha_dir - (l - Lp);
    mask[l] = (1.f - cosf(fminf(fmaxf(a, 0.f), 1.f) * kPi)) / 2.f;
  }
}

// One coordinate of the BARF encoding of x: identity at [c], cos block at
// 3 + c*levels + l, sin block at 3 + 3*levels + c*levels + l (channel-major).
// Rounded to the compute type; `row` is fp32 or bf16.
template <bool kBf16, typename RT>
__device__ void encode(float x, int c, int levels, const float* mask, float scale, RT* row) {
  store_act(row + c, cde<kBf16>(x));
  for (int l = 0; l < levels; ++l) {
    float s, co;
    sincosf(x * ldexpf(scale, l), &s, &co);
    store_act(row + 3 + c * levels + l, cde<kBf16>(mask[l] * co));
    store_act(row + 3 + 3 * levels + c * levels + l, cde<kBf16>(mask[l] * s));
  }
}

// d/dx of the encoding of one coordinate, given the encoding's cotangent g in
// the same layout as `encode` writes.
__device__ __forceinline__ float encode_bwd(float x, int c, int levels, const float* mask,
                                            float scale, const float* g) {
  float d = g[c];
  for (int l = 0; l < levels; ++l) {
    const float f = ldexpf(scale, l);
    float s, co;
    sincosf(x * f, &s, &co);
    d += f * mask[l] * (g[3 + 3 * levels + c * levels + l] * co - g[3 + c * levels + l] * s);
  }
  return d;
}

__device__ __forceinline__ float softplus8(float x) {
  if (x > 8.f) return x;
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Per-row workspace layout of the train kernel (K4). Activations (compute
// type), row width act_width():
//   [pos_enc P | dir_enc Q | seg-1 outputs L x D | seg-2 ReLU outputs (L-1) x D |
//    hidden D | colour hidden C]
// Cotangents of each layer's pre-activation (fp32), row width cot_width():
// layer l at g(l), widths D for l < 2L-1, D + 1 for the last segment layer, C, 3.
// ReLU masks, one 32-bit word per (32-row half tile, column), bit r for the
// half's row r, mask_width() words per half: [seg-1 L x D | seg-2 (L-1) x D |
// colour hidden C].
struct Layout {
  int P, Q, D, C, L;
  __host__ __device__ int h1(int i) const { return P + Q + i * D; }
  __host__ __device__ int h2(int i) const { return P + Q + (L + i) * D; }
  __host__ __device__ int hid() const { return P + Q + (2 * L - 1) * D; }
  __host__ __device__ int c0() const { return P + Q + 2 * L * D; }
  __host__ __device__ int act_width() const { return c0() + C; }
  __host__ __device__ int g(int l) const {
    return l <= 2 * L - 1 ? l * D : (l == 2 * L ? 2 * L * D + 1 : 2 * L * D + 1 + C);
  }
  __host__ __device__ int cot_width() const { return 2 * L * D + 1 + C + 3; }
  __host__ __device__ int m_h1(int i) const { return i * D; }
  __host__ __device__ int m_h2(int i) const { return (L + i) * D; }
  __host__ __device__ int m_c0() const { return (2 * L - 1) * D; }
  __host__ __device__ int mask_width() const { return (2 * L - 1) * D + C; }
};

// ---- the tensor-core tile ----

constexpr int kWarpN = 4;  // n8 tiles of a warp
// The most dynamic shared memory a block may have on the H100 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

// Rays a block (kR / S when S <= kR, else 1) and kR-row tiles a block.
__host__ __device__ inline int rays_per_block(int S, int kR) { return imax(1, kR / S); }
__host__ __device__ inline int tiles_per_block(int S, int kR) {
  return (rays_per_block(S, kR) * S + kR - 1) / kR;
}

// One cp.async of sizeof(T) bytes (8 or 16) from global to shared memory, and
// its group bookkeeping.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem),
               "n"(sizeof(T)));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Fragments of one mma.sync. lane = 4 g + t. A (m16 x kK, row-major) and B
// (kK x n8, "col") as the PTX ISA lays them out; the accumulator c[e] holds
// C[g + 8 (e >> 1)][2 t + (e & 1)].
template <bool kBf16>
struct Mma;

template <>
struct Mma<true> {
  using ET = __nv_bfloat16;
  static constexpr int kK = 16;    // k of one instruction
  static constexpr int kPad = 8;   // row padding of shared tiles (elements, 16 bytes)
  static constexpr int kStages = 4;  // B fragments in flight a warp, in k-steps
  using Frag = uint2;              // a lane's share of a packed B fragment
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  // A[row0.., k0..] from a row-major shared tile
  __device__ static void load_a(A& a, const ET* base, int ld, int row0, int k0, int lane) {
    const ET* p = base + (row0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    a.r[0] = *reinterpret_cast<const uint32_t*>(p);
    a.r[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
    a.r[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a.r[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
  }
  // a packed B fragment (n8 tile, k-step) as the lane's 8 bytes of it
  __device__ static void load_b(B& b, const Frag& v) {
    b.r[0] = v.x;
    b.r[1] = v.y;
  }
  // B[k0.., n0..] from a shared tile that holds B transposed, [n][k] row-major
  __device__ static void load_bt(B& b, const ET* base, int ld, int n0, int k0, int lane) {
    const ET* p = base + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    b.r[0] = *reinterpret_cast<const uint32_t*>(p);
    b.r[1] = *reinterpret_cast<const uint32_t*>(p + 8);
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
};

template <>
struct Mma<false> {
  using ET = float;
  static constexpr int kK = 8;
  static constexpr int kPad = 4;   // 4 words, 16 bytes
  static constexpr int kStages = 3;
  using Frag = float4;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  __device__ static void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
  __device__ static void load_a(A& a, const ET* base, int ld, int row0, int k0, int lane) {
    const ET* p = base + (row0 + (lane >> 2)) * ld + k0 + (lane & 3);
    split(p[0], a.hi[0], a.lo[0]);
    split(p[8 * ld], a.hi[1], a.lo[1]);
    split(p[4], a.hi[2], a.lo[2]);
    split(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  // packed as (b0 hi, b1 hi, b0 lo, b1 lo): 16 bytes a lane
  __device__ static void load_b(B& b, const Frag& v) {
    b.hi[0] = __float_as_uint(v.x);
    b.hi[1] = __float_as_uint(v.y);
    b.lo[0] = __float_as_uint(v.z);
    b.lo[1] = __float_as_uint(v.w);
  }
  __device__ static void mma1(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // 3xTF32: the small terms first
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    mma1(d, a.lo, b.hi);
    mma1(d, a.hi, b.lo);
    mma1(d, a.hi, b.hi);
  }
};

// `tile_gemm`'s kFlush for the fp32 routes that need it (the GARF kernels, K up
// to 1024, and the g W^T of the fused MLP chain's and the flagship train
// kernel's backward): each 8-k-step chain of the
// tensor cores' accumulator added into the result by fp32 adds.
template <bool kBf16>
constexpr int kFlushK = kBf16 ? 0 : 8;

// C = A B over a tile's kR rows. A comes from shared memory in up to two parts
// (a1: s1 k-steps of Mma::kK columns, then a2: s2), zero-padded to whole
// k-steps; B is one of the wrapper's packed operands, (s1 + s2) k-steps x
// n_tiles n8 tiles. Warp w computes n8 tiles 4w..4w+3 (then + 32 a pass) over
// all rows and hands each finished n8 tile to epi(n_tile, c), c[i][e] =
// C[16 i + g + 8 (e >> 1)][8 n_tile + 2 t + (e & 1)] for i < kR / 16; all 32
// lanes call epi.
// B streams from L2 through `ring` (kRingFrags fragments a warp in shared
// memory): each lane cp.asyncs its own share of the warp's fragments
// Mma::kStages - 1 k-steps ahead and reads back only what it copied, so no
// barrier is needed, only its own cp.async.wait_group.
// kFlush > 0: the tensor cores add each product into their accumulator with
// truncation, so a long k-chain drifts (a bias of ~2^-24 an add); the chain
// runs kFlush k-steps at a time in its own registers, each added into the
// result by ordinary fp32 adds (the GARF kernels' fp32 route, K up to 1024).
template <bool kBf16, int kR, int kFlush = 0, typename Epi>
__device__ __forceinline__ void tile_gemm(const typename Mma<kBf16>::ET* a1, int ld1, int s1,
                                          const typename Mma<kBf16>::ET* a2, int ld2, int s2,
                                          const void* packed, typename Mma<kBf16>::Frag* ring,
                                          int n_tiles, const Epi& epi) {
  using M = Mma<kBf16>;
  using F = typename M::Frag;
  constexpr int kMT = kR / 16;  // m16 tiles of the tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int steps = s1 + s2;
  F* mine = ring + warp * M::kStages * kWarpN * 32 + lane;
  const F* pk = static_cast<const F*>(packed) + lane;
  for (int nt0 = warp * kWarpN; nt0 < n_tiles; nt0 += kWarps * kWarpN) {
    // k-step ks of this warp's n8 tiles into stage ks % kStages; one group a k-step
    auto issue = [&](int ks) {
      if (ks < steps) {
#pragma unroll
        for (int j = 0; j < kWarpN; ++j)
          if (nt0 + j < n_tiles)
            cp_async(mine + ((ks % M::kStages) * kWarpN + j) * 32,
                     pk + (static_cast<size_t>(nt0 + j) * steps + ks) * 32);
      }
      cp_async_commit();
    };
    float acc[kWarpN][kMT][4], run[kWarpN][kMT][4];  // run: the chain, with kFlush
#pragma unroll
    for (int j = 0; j < kWarpN; ++j)
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][i][e] = run[j][i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < M::kStages - 1; ++ks) issue(ks);
    for (int ks = 0; ks < steps; ++ks) {
      issue(ks + M::kStages - 1);
      cp_async_wait<M::kStages - 1>();  // k-step ks has landed
      typename M::B b[kWarpN];
#pragma unroll
      for (int j = 0; j < kWarpN; ++j)
        if (nt0 + j < n_tiles) M::load_b(b[j], mine[((ks % M::kStages) * kWarpN + j) * 32]);
      const bool first = ks < s1;
      const typename M::ET* a = first ? a1 : a2;
      const int ld = first ? ld1 : ld2;
      const int k0 = (first ? ks : ks - s1) * M::kK;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        typename M::A af;
        M::load_a(af, a, ld, 16 * i, k0, lane);
#pragma unroll
        for (int j = 0; j < kWarpN; ++j)
          if (nt0 + j < n_tiles) M::mma(kFlush > 0 ? run[j][i] : acc[j][i], af, b[j]);
      }
      if (kFlush > 0 && ((ks + 1) % imax(kFlush, 1) == 0 || ks + 1 == steps)) {
#pragma unroll
        for (int j = 0; j < kWarpN; ++j)
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[j][i][e] += run[j][i][e];
              run[j][i][e] = 0.f;
            }
      }
    }
#pragma unroll
    for (int j = 0; j < kWarpN; ++j)
      if (nt0 + j < n_tiles) epi(nt0 + j, acc[j]);
  }
}

// Epilogue of a forward layer: columns n < width get the bias, the ReLU and,
// for n < n_round, the rounding to the compute type, and go to the next
// layer's input `buf`; columns [width, round16(width)) are written 0 there
// (the next product's K padding). With `mask`, bit (row & 31) of
// mask[(row >> 5) * mask_ld + n] records value > 0 for live rows (the ReLU
// mask). The workspace copy of `buf` is `copy_rows`', after the barrier.
// (Each epilogue's operator() takes the c[kR / 16][4] of any row tile.)
template <bool kBf16>
struct FwdEpi {
  typename Mma<kBf16>::ET* buf;
  int ld, width, n_round;
  bool relu;
  const float* bias;
  int rows;
  unsigned* mask;
  int mask_ld;

  template <int kMT>
  __device__ void operator()(int nt, const float (&c)[kMT][4]) const {
    constexpr int kH = kMT / 2;  // 32-row halves of the tile
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int col0 = nt * 8 + 2 * t;
    unsigned bits[kH][2] = {};  // [32-row half][column parity]
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * i + g + 8 * (e >> 1), col = col0 + (e & 1);
        float v = 0.f;
        if (col < width) {
          float z = c[i][e] + __ldg(bias + col);
          if (relu) z = fmaxf(z, 0.f);
          v = col < n_round ? cde<kBf16>(z) : z;
          if (row < rows && v > 0.f) bits[i >> 1][e & 1] |= 1u << (row & 31);
        }
        store_act(buf + row * ld + col, v);
      }
    if (mask != nullptr) {  // uniform over the warp
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          unsigned w = bits[h][p];  // OR over the 8 lanes that share t
          w |= __shfl_xor_sync(kFull, w, 4);
          w |= __shfl_xor_sync(kFull, w, 8);
          w |= __shfl_xor_sync(kFull, w, 16);
          if (g == 0 && col0 + p < width) mask[h * mask_ld + col0 + p] = w;
        }
    }
  }
};

// Epilogue of the colour logits: logits[row * 3 + n] = C + b[n] for n < 3, fp32.
struct LogitEpi {
  float* logits;
  const float* bias;
  template <int kMT>
  __device__ void operator()(int nt, const float (&c)[kMT][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * i + g + 8 * (e >> 1), col = nt * 8 + 2 * t + (e & 1);
        if (col < 3) logits[row * 3 + col] = c[i][e] + __ldg(bias + col);
      }
  }
};

// Epilogue of a backward product g W^T, whose columns are a layer's inputs in
// two parts. Part 1, columns n < k1 (the layer's width w1 padded to 16, or 0):
// the cotangent of the previous layer's output, masked by its ReLU mask words
// when `mask` is given (as FwdEpi writes them; the padding columns n >= w1,
// which hold 0, read none), kept fp32 in the shared staging tile `stg` (row
// stride sld; null: not kept) for `store_cot` to copy to the workspace, and
// rounded to the compute type into `buf` (the next product's input). Part 2,
// columns k1 + m for m < k2: an encoding's cotangent, fp32, written or (add)
// added into enc[row * eld + m].
template <bool kBf16>
struct BwdEpi {
  int k1, w1;
  typename Mma<kBf16>::ET* buf;
  int ld;
  float* stg;
  int sld;
  const unsigned* mask;
  int mask_ld;
  float* enc;
  int eld, k2;
  bool add;
  int rows;

  template <int kMT>
  __device__ void operator()(int nt, const float (&c)[kMT][4]) const {
    constexpr int kH = kMT / 2;  // 32-row halves of the tile
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int col0 = nt * 8 + 2 * t;
    if (nt * 8 < k1) {
      unsigned m[kH][2];  // [32-row half][column parity]
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          m[h][p] = mask == nullptr ? kFull
                                    : (col0 + p < w1 ? mask[h * mask_ld + col0 + p] : 0u);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + g + 8 * (e >> 1), col = col0 + (e & 1);
          const float v = (m[i >> 1][e & 1] >> (row & 31)) & 1u ? c[i][e] : 0.f;
          if (stg != nullptr) stg[row * sld + col] = v;
          store_act(buf + row * ld + col, v);
        }
    } else {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + g + 8 * (e >> 1), col = col0 + (e & 1) - k1;
          if (col < k2) {
            float* p = enc + row * eld + col;
            *p = add ? *p + c[i][e] : c[i][e];
          }
        }
    }
  }
};

// Copy a tile's columns [0, width) of its live rows from shared memory
// (`src`, row stride ld) to workspace rows (`dst`, row stride dld): a warp a
// row, its lanes on consecutive columns, so each store writes one contiguous
// run of the row.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, size_t dld, const T* src, int ld, int width,
                                          int rows) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps)
    for (int c = lane; c < width; c += 32) dst[r * dld + c] = src[r * ld + c];
}

// The weights of the tile kernels, per layer in the order segment 1, segment
// 2, colour head: the forward product's B and the backward product's B
// (K4 only), packed by the wrapper, and the fp32 bias; w_density is the
// density column W[:, D] of the last segment layer in the compute type.
struct TileWeights {
  const void* fwd[kMaxLayers];
  const void* bwd[kMaxLayers];
  const float* b[kMaxLayers];
  const void* w_density;
};

// The tile kernels' shared memory for a tile of `rows` rows: four
// compute-type tiles (two ping-pong activation buffers, the position and
// direction encodings), the warps' B rings, then fp32 arrays that each kernel
// lays out itself from f32_offset(). `train_megakernel.tile_smem_bytes`
// computes the same sizes.
template <bool kBf16>
struct TileSmem {
  using ET = typename Mma<kBf16>::ET;
  int rows;
  int ldb, ldp, ldq;  // row strides (elements)
  __host__ __device__ TileSmem(int P, int Q, int D, int C, int rows_)
      : rows(rows_),
        ldb(round16(imax(D + 1, C)) + Mma<kBf16>::kPad),
        ldp(round16(P) + Mma<kBf16>::kPad),
        ldq(round16(Q) + Mma<kBf16>::kPad) {}
  __host__ __device__ size_t et_bytes() const {
    const size_t b = static_cast<size_t>(rows) * (2 * ldb + ldp + ldq) * sizeof(ET);
    return (b + 15) & ~static_cast<size_t>(15);
  }
  static constexpr size_t kRingBytes = static_cast<size_t>(kWarps) * Mma<kBf16>::kStages *
                                       kWarpN * 32 * sizeof(typename Mma<kBf16>::Frag);
  __host__ __device__ size_t f32_offset() const { return et_bytes() + kRingBytes; }
};

// The views of a tile kernel's shared memory that the forward chain uses.
template <bool kBf16>
struct TileBufs {
  typename Mma<kBf16>::ET *buf0, *buf1, *encp, *encd;
  typename Mma<kBf16>::Frag* ring;
  int rows, ldb, ldp, ldq;
  float* dens;    // rows: the raw density column
  float* logits;  // rows x 3
  __device__ TileBufs(const TileSmem<kBf16>& lay, unsigned char* smem, float* dens_,
                      float* logits_)
      : rows(lay.rows), ldb(lay.ldb), ldp(lay.ldp), ldq(lay.ldq), dens(dens_), logits(logits_) {
    buf0 = reinterpret_cast<typename Mma<kBf16>::ET*>(smem);
    buf1 = buf0 + rows * ldb;
    encp = buf1 + rows * ldb;
    encd = encp + rows * ldp;
    ring = reinterpret_cast<typename Mma<kBf16>::Frag*>(smem + lay.et_bytes());
  }
  // zero every compute-type tile: the encodings' K padding columns are never
  // written again (the layers' padding columns are, by their epilogues)
  __device__ void zero() const {
    const int n = rows * (2 * ldb + ldp + ldq);
    for (int i = threadIdx.x; i < n; i += blockDim.x) store_act(buf0 + i, 0.f);
  }
};

// Where K4's forward stores a tile: the workspace row of the tile's first row
// (act, row stride AW; its element type is the compute type) and the tile's
// mask words (two halves of MW words). Null act: K2, nothing is stored.
template <typename AT>
struct TileStore {
  AT* act;
  size_t AW;
  unsigned* masks;
  int MW;
};

// The flagship forward chain on one tile whose encodings are in s.encp /
// s.encd: segment 1 (ReLU after every layer), segment 2 ([z | pos_enc] in,
// ReLU layers, then D + 1 outputs with no ReLU: hidden columns rounded, the
// density column fp32 into s.dens), the colour head ([hidden | dir_enc] -> C,
// ReLU, -> 3 logits into s.logits). Each layer's output is copied to the
// workspace (st.act) after its barrier, while the next product reads it.
// Widths D and C run on the tensor cores padded to Dp = round16(D) and Cp =
// round16(C) (the packed B operands are padded the same way). Ends with
// __syncthreads.
template <bool kBf16, int kR>
__device__ void forward_tile(const Layout& lay, const TileWeights& w, const TileBufs<kBf16>& s,
                             int rows, const TileStore<typename Mma<kBf16>::ET>& st) {
  using M = Mma<kBf16>;
  using ET = typename M::ET;
  const int D = lay.D, C = lay.C, L = lay.L;
  const int Dp = round16(D), Cp = round16(C);
  const int sp = round16(lay.P) / M::kK, sq = round16(lay.Q) / M::kK;
  const int sd = Dp / M::kK, sc = Cp / M::kK;
  auto epi = [&](ET* out, int l, int width, bool relu, int mask_col) {
    return FwdEpi<kBf16>{out, s.ldb, width, width, relu, w.b[l], rows,
                         st.act != nullptr && mask_col >= 0 ? st.masks + mask_col : nullptr,
                         st.MW};
  };
  auto store = [&](const ET* out, int width, int act_col) {
    if (st.act != nullptr) copy_rows(st.act + act_col, st.AW, out, s.ldb, width, rows);
  };
  ET* cur = s.buf0;
  ET* nxt = s.buf1;
  tile_gemm<kBf16, kR>(s.encp, s.ldp, sp, nullptr, 0, 0, w.fwd[0], s.ring, Dp / 8,
                   epi(cur, 0, D, true, lay.m_h1(0)));
  __syncthreads();
  store(cur, D, lay.h1(0));
  for (int i = 1; i < L; ++i) {
    tile_gemm<kBf16, kR>(cur, s.ldb, sd, nullptr, 0, 0, w.fwd[i], s.ring, Dp / 8,
                     epi(nxt, i, D, true, lay.m_h1(i)));
    __syncthreads();
    store(nxt, D, lay.h1(i));
    ET* t = cur; cur = nxt; nxt = t;
  }
  tile_gemm<kBf16, kR>(cur, s.ldb, sd, s.encp, s.ldp, sp, w.fwd[L], s.ring, Dp / 8,
                   epi(nxt, L, D, true, lay.m_h2(0)));
  __syncthreads();
  store(nxt, D, lay.h2(0));
  { ET* t = cur; cur = nxt; nxt = t; }
  for (int i = 1; i < L - 1; ++i) {
    tile_gemm<kBf16, kR>(cur, s.ldb, sd, nullptr, 0, 0, w.fwd[L + i], s.ring, Dp / 8,
                     epi(nxt, L + i, D, true, lay.m_h2(i)));
    __syncthreads();
    store(nxt, D, lay.h2(i));
    ET* t = cur; cur = nxt; nxt = t;
  }
  // last segment layer: the hidden columns on the tensor cores ...
  tile_gemm<kBf16, kR>(cur, s.ldb, sd, nullptr, 0, 0, w.fwd[2 * L - 1], s.ring, Dp / 8,
                   epi(nxt, 2 * L - 1, D, false, -1));
  {  // ... and the density column D on the CUDA cores, kTpr threads a row
    constexpr int kTpr = kThreads / kR;
    const int r = threadIdx.x / kTpr, q = threadIdx.x % kTpr;
    const ET* wd = static_cast<const ET*>(w.w_density);
    float acc = 0.f;
    for (int k = q; k < D; k += kTpr) acc = fmaf(to_f(cur[r * s.ldb + k]), to_f(wd[k]), acc);
#pragma unroll
    for (int off = 1; off < kTpr; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (q == 0) s.dens[r] = acc + __ldg(w.b[2 * L - 1] + D);
  }
  __syncthreads();
  store(nxt, D, lay.hid());
  { ET* t = cur; cur = nxt; nxt = t; }
  tile_gemm<kBf16, kR>(cur, s.ldb, sd, s.encd, s.ldq, sq, w.fwd[2 * L], s.ring, Cp / 8,
                   epi(nxt, 2 * L, C, true, lay.m_c0()));
  __syncthreads();
  store(nxt, C, lay.c0());
  tile_gemm<kBf16, kR>(nxt, s.ldb, sc, nullptr, 0, 0, w.fwd[2 * L + 1], s.ring, 2,
                   LogitEpi{s.logits, w.b[2 * L + 1]});
  __syncthreads();
}

}  // namespace netpu
