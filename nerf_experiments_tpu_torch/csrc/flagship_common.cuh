// Device helpers shared by the flagship BARF radiance kernels:
// `flagship_render.cu` (forward only) and `flagship_train.cu` (forward +
// backward). One block owns one ray and walks its samples in chunks of kRows;
// each thread owns output columns of a layer and keeps kRows accumulators in
// registers, so one weight load feeds kRows FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace netpu {

constexpr int kRows = 32;      // samples per chunk (= one warp for compositing)
constexpr int kThreads = 256;
constexpr int kMaxLayers = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;

struct Layers {
  const void* w[kMaxLayers];   // (in, out) row-major, fp32 or bf16
  const float* b[kMaxLayers];  // (out,) fp32
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float load_w(const float* w, size_t i) { return __ldg(w + i); }
__device__ __forceinline__ float load_w(const __nv_bfloat16* w, size_t i) {
  return __bfloat162float(w[i]);
}

__device__ __forceinline__ void store_act(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_act(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <bool kBf16>
__device__ __forceinline__ float cde(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

// acc[r] += sum_k in[r * ld + k] * W[(k0 + k) * n_out + j] for k < K.
// `in` is 16-byte aligned and ld % 4 == 0, so rows are read as float4.
template <typename WT>
__device__ __forceinline__ void accumulate(float (&acc)[kRows], const float* in, int ld,
                                           int K, const WT* W, int k0, int n_out, int j) {
  const int K4 = K & ~3;
  for (int k = 0; k < K4; k += 4) {
    const float w0 = load_w(W, static_cast<size_t>(k0 + k) * n_out + j);
    const float w1 = load_w(W, static_cast<size_t>(k0 + k + 1) * n_out + j);
    const float w2 = load_w(W, static_cast<size_t>(k0 + k + 2) * n_out + j);
    const float w3 = load_w(W, static_cast<size_t>(k0 + k + 3) * n_out + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(in + r * ld + k);
      acc[r] = fmaf(x.x, w0, acc[r]);
      acc[r] = fmaf(x.y, w1, acc[r]);
      acc[r] = fmaf(x.z, w2, acc[r]);
      acc[r] = fmaf(x.w, w3, acc[r]);
    }
  }
  for (int k = K4; k < K; ++k) {
    const float w = load_w(W, static_cast<size_t>(k0 + k) * n_out + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(in[r * ld + k], w, acc[r]);
  }
}

// out[r][j] = act(in1[r] . W[0:K1, j] + in2[r] . W[K1:K1+K2, j] + b[j]) for the
// chunk's live rows; columns j < n_round are rounded to the compute type.
// With `store`, columns j < n_store are also written to store[r * sld + j]
// (the training kernel's activation workspace), and with `mask_out` bit r of
// mask_out[j] records out[r][j] > 0 (its ReLU mask, one word per column).
template <typename WT, bool kBf16, typename AT>
__device__ void dense(const float* in1, int ld1, int K1, const float* in2, int ld2, int K2,
                      const void* W_, const float* bias, int n_out, float* out, int ldo,
                      int rows, bool relu, int n_round, AT* store, size_t sld, int n_store,
                      unsigned* mask_out) {
  const WT* W = static_cast<const WT*>(W_);
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    accumulate(acc, in1, ld1, K1, W, 0, n_out, j);
    if (K2 > 0) accumulate(acc, in2, ld2, K2, W, K1, n_out, j);
    const float bj = __ldg(bias + j);
    unsigned bits = 0u;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        float z = acc[r] + bj;
        if (relu) z = fmaxf(z, 0.f);
        const float v = j < n_round ? cde<kBf16>(z) : z;
        out[r * ldo + j] = v;
        if (store != nullptr && j < n_store) store_act(store + r * sld + j, v);
        if (v > 0.f) bits |= 1u << r;
      }
    }
    if (mask_out != nullptr) mask_out[j] = bits;
  }
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
template <bool kBf16>
__device__ void encode(float x, int c, int levels, const float* mask, float scale,
                       float* row) {
  row[c] = cde<kBf16>(x);
  for (int l = 0; l < levels; ++l) {
    float s, co;
    sincosf(x * ldexpf(scale, l), &s, &co);
    row[3 + c * levels + l] = cde<kBf16>(mask[l] * co);
    row[3 + 3 * levels + c * levels + l] = cde<kBf16>(mask[l] * s);
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

}  // namespace netpu
