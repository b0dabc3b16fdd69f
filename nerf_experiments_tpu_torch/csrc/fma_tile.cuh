// Dense layers on the CUDA cores, in the order of a plain GEMM, for a row tile
// in shared memory: the fp32 forwards of the fused MLP chain (`fused_mlp.cu`,
// K9 and K10's row pass) and of the flagship train kernel's tile
// (`flagship_train.cu`, K4 in fp32).
//
// Every z[r][c] is (fmaf(in[r][0], W[0][c], 0) -> fmaf(in[r][1], W[1][c], .)
// -> ...) + b[c]: the products added in the order k = 0, 1, ... from 0, then
// the bias, as cuBLAS's fp32 SGEMM without split-K and then torch's bias add
// compute it. A layer whose input is two parts ([z | pos_enc] in K4) adds the
// first part's products, then the second's, in that order. So each ReLU is
// decided as the plain chain decides it, which fp32's gates need: 3xTF32 on
// the tensor cores decides a few units in 10^7 the other way (PERF.md section
// 6), and each such unit moves a row's gradient by its whole cotangent. A
// thread owns R rows x 8 columns (R = 8, or 4 where 8 leaves threads idle;
// the warp's lanes side by side along the columns, so the activations they
// read are one broadcast), up to 64 FMAs for 8 loads; the last N % 8 columns
// go one column a thread over 8 rows. A thread reads its 8 columns of a W
// row as two float4s; lanes 4-7 of every 8 read the upper one first
// (`fma_col`), so the 8 lanes of a shared-memory phase hit 8 distinct groups
// of 4 banks: in order, at 32-byte strides, they fell on 4 groups, each read
// of W took twice the wavefronts, and the fp32 flagship train tile's forward
// ran ~1 ms slower a 1024 x 128 step on the H100. W streams through shared
// memory (the tensor-core route's ring space, unused in this forward) in
// chunks of up to 16 rows, two in flight by cp.async, its row stride
// round4(N) as the wrappers pad it, so every copy and read is a float4.
#pragma once

#include "flagship_common.cuh"

namespace netpu {

constexpr int kFmaC = 8;
constexpr int kWRows = 16;  // W rows a staged chunk, at most

// W rows a chunk for outputs ldw wide in `bytes` of staging (two chunks), a
// multiple of 4: at least 8 in the ring's 49,152 bytes, as a block's 227 KB
// hold no fp32 tile wider than 712 columns.
__device__ inline int fma_chunk_rows(int ldw, size_t bytes) {
  const int rows = static_cast<int>(bytes / (2 * sizeof(float) * ldw)) & ~3;
  return rows < kWRows ? rows : kWRows;
}

// The column of acc[.][j] in a thread's block of C columns from c0: for C =
// 8, its two halves swapped on lanes 4-7 of every 8 (see the note above).
template <int C>
__device__ __forceinline__ int fma_col(int c0, int j) {
  return C == 8 ? c0 + (j ^ (threadIdx.x & 4)) : c0 + j;
}

// acc[r][j] += in[r0 + r][k] W[k][fma_col<C>(c0, j)] for k = k0, k0 + 1, ...
// < k1, in that order; w holds W's rows k0.. (row stride ldw, c0 a multiple
// of 8 when C = 8), k0 a multiple of 4.
template <int R, int C>
__device__ __forceinline__ void fma_block(const float* in, int ld, int k0, int k1,
                                          const float* w, int ldw, int r0, int c0,
                                          float (&acc)[R][C]) {
  const float* a = in + r0 * ld;
  auto row = [&](float (&v)[C], int k) {
    const float* p = w + (k - k0) * ldw + c0;
    if constexpr (C == 8) {
      const int sw = threadIdx.x & 4;
      const float4 lo = *reinterpret_cast<const float4*>(p + sw);
      const float4 hi = *reinterpret_cast<const float4*>(p + (sw ^ 4));
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] = p[j];
    }
  };
  auto step4 = [&](int k) {  // k, k + 1, k + 2, k + 3
    float v[4][C];
#pragma unroll
    for (int q = 0; q < 4; ++q) row(v[q], k + q);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(a + r * ld + k);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        acc[r][j] = fmaf(x.x, v[0][j], acc[r][j]);
        acc[r][j] = fmaf(x.y, v[1][j], acc[r][j]);
        acc[r][j] = fmaf(x.z, v[2][j], acc[r][j]);
        acc[r][j] = fmaf(x.w, v[3][j], acc[r][j]);
      }
    }
  };
  if (k1 - k0 == kWRows) {  // a whole chunk, unrolled
#pragma unroll
    for (int q = 0; q < kWRows; q += 4) step4(k0 + q);
    return;
  }
  const int k4 = k0 + ((k1 - k0) & ~3);
  for (int k = k0; k < k4; k += 4) step4(k);
  for (int k = k4; k < k1; ++k) {
    float v[C];
    row(v, k);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = a[r * ld + k];
#pragma unroll
      for (int j = 0; j < C; ++j) acc[r][j] = fmaf(x, v[j], acc[r][j]);
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[r][j] = 0.f;
}

// One layer for a kR-row tile whose input is in the shared tile `in1` (row
// stride ld1, K1 columns) and, when K2 > 0, then in `in2` (ld2, K2 columns),
// W (K1 + K2, N) with the row stride round4(N) in global memory, staged
// through `stage` (`stage_bytes`; a chunk holds rows of one part only):
// out(r0, c0, acc) receives each thread's block of sums before the bias,
// acc[r][j] for rows r0 + r and columns fma_col<C>(c0, j) < N. Every thread
// of the block calls it; it ends with a barrier.
template <int kR, int R, typename Out>
__device__ void fma_items(const float* in1, int ld1, int K1, const float* in2, int ld2, int K2,
                          const float* __restrict__ W, int N, float* stage, size_t stage_bytes,
                          const Out& out) {
  const int ldw = round4(N), CG = N / kFmaC, nt = N - CG * kFmaC;
  const int wk = fma_chunk_rows(ldw, stage_bytes);
  const int n_main = kR / R * CG, n_items = n_main + kR / 8 * nt;
  const int c1 = (K1 + wk - 1) / wk, chunks = c1 + (K2 + wk - 1) / wk;
  // chunk q: rows [k0, k1) of its part's input, which are W's rows from the
  // returned one
  auto span = [&](int q, int& k0, int& k1) {
    if (q < c1) {
      k0 = q * wk;
      k1 = min(K1, k0 + wk);
      return k0;
    }
    k0 = (q - c1) * wk;
    k1 = min(K2, k0 + wk);
    return K1 + k0;
  };
  // chunk q of W's rows into stage buffer q & 1: one cp.async group a chunk
  auto issue = [&](int q) {
    if (q < chunks) {
      int k0, k1;
      const int w0 = span(q, k0, k1), n4 = (k1 - k0) * ldw / 4;
      float* dst = stage + (q & 1) * wk * ldw;
      const float* src = W + static_cast<size_t>(w0) * ldw;
      for (int e = threadIdx.x; e < n4; e += blockDim.x)
        cp_async(reinterpret_cast<float4*>(dst) + e, reinterpret_cast<const float4*>(src) + e);
    }
    cp_async_commit();
  };
  for (int base = 0; base < n_items; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const bool is_main = item < n_main, is_tail = !is_main && item < n_items;
    int r0 = 0, c0 = 0;
    if (is_main) {
      r0 = item / CG * R;
      c0 = item % CG * kFmaC;
    } else if (is_tail) {
      r0 = (item - n_main) / nt * 8;
      c0 = CG * kFmaC + (item - n_main) % nt;
    }
    float acc[R][kFmaC], tacc[8][1];
    zero(acc);
    zero(tacc);
    issue(0);
    for (int q = 0; q < chunks; ++q) {
      issue(q + 1);
      cp_async_wait<1>();  // chunk q has landed (this thread's part) ...
      __syncthreads();     // ... and every thread's
      int k0, k1;
      span(q, k0, k1);
      const float* in = q < c1 ? in1 : in2;
      const int ld = q < c1 ? ld1 : ld2;
      const float* w = stage + (q & 1) * wk * ldw;
      if (is_main)
        fma_block(in, ld, k0, k1, w, ldw, r0, c0, acc);
      else if (is_tail)
        fma_block(in, ld, k0, k1, w, ldw, r0, c0, tacc);
      __syncthreads();  // buffer q & 1 is written again by chunk q + 2
    }
    if (is_main)
      out(r0, c0, acc);
    else if (is_tail)
      out(r0, c0, tacc);
  }
}

template <int kR, typename Out>
__device__ void fma_layer(const float* in1, int ld1, int K1, const float* in2, int ld2, int K2,
                          const float* __restrict__ W, int N, float* stage, size_t stage_bytes,
                          const Out& out) {
  if (kR / 8 * (N / kFmaC) >= kThreads)
    fma_items<kR, 8>(in1, ld1, K1, in2, ld2, K2, W, N, stage, stage_bytes, out);
  else
    fma_items<kR, 4>(in1, ld1, K1, in2, ld2, K2, W, N, stage, stage_bytes, out);
}

// A layer of one input part.
template <int kR, typename Out>
__device__ void fma_layer(const float* in, int ld, int K, const float* __restrict__ W, int N,
                          float* stage, size_t stage_bytes, const Out& out) {
  fma_layer<kR>(in, ld, K, nullptr, 0, 0, W, N, stage, stage_bytes, out);
}

}  // namespace netpu
