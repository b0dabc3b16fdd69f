// Volume-rendering forward (alpha compositing) for one NVIDIA H100.
//
// Replaces the TPU kernel `nerf_experiments_tpu/ops/render_pallas.py:_fwd_kernel`
// (Pallas, reached through `render_full_pallas` / `render_rays_pallas`).
// Per ray of S samples:
//   b_i = -sigma_i * delta_i * scale,  a_i = 1 - exp(b_i),
//   T_i = exp(sum_{j<i} b_j),          w_i = T_i * a_i,
//   rgb = sum w_i c_i, opacity = sum w_i, depth = sum w_i t_mid_i.
//
// What bounds it on the H100: memory bandwidth. Per sample it reads density,
// dist, t_mid and three colours and writes the weight and transmittance: about
// 9 fp32 values, against ~10 flops. The TPU kernel ran the exclusive prefix sum
// as an (S, S) triangular matmul on the MXU; here one warp owns one ray and the
// prefix sum is a shuffle scan inside the warp, 32 samples a step, with the
// running sum carried between steps, so any S works and every read and write is
// coalesced across the lanes. Nothing is staged in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rays per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
render_fwd_kernel(const float* __restrict__ dens, const float* __restrict__ dists,
                  const float* __restrict__ tmid, const float* __restrict__ colors,
                  float* __restrict__ weights, float* __restrict__ trans,
                  float* __restrict__ stats, int n, int s, float density_scale) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray >= n) return;  // whole warps leave together
  const size_t row = static_cast<size_t>(ray) * s;

  float carry = 0.f;  // sum of b over the samples before this step
  float r = 0.f, g = 0.f, b = 0.f, opacity = 0.f, depth = 0.f;
  for (int base = 0; base < s; base += 32) {
    const int i = base + lane;
    const bool live = i < s;
    float blk = 0.f, t = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    if (live) {
      blk = -dens[row + i] * dists[row + i] * density_scale;
      t = tmid ? tmid[row + i] : 0.f;
      const float* c = colors + (row + i) * 3;
      c0 = c[0];
      c1 = c[1];
      c2 = c[2];
    }
    float incl = blk;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float T = expf(carry + excl);
    const float w = T * (1.f - expf(blk));
    if (live) {
      weights[row + i] = w;
      trans[row + i] = T;
      r += w * c0;
      g += w * c1;
      b += w * c2;
      opacity += w;
      depth += w * t;
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r += __shfl_xor_sync(kFull, r, off);
    g += __shfl_xor_sync(kFull, g, off);
    b += __shfl_xor_sync(kFull, b, off);
    opacity += __shfl_xor_sync(kFull, opacity, off);
    depth += __shfl_xor_sync(kFull, depth, off);
  }
  if (lane == 0) {
    float* out = stats + static_cast<size_t>(ray) * 5;
    out[0] = r;
    out[1] = g;
    out[2] = b;
    out[3] = opacity;
    out[4] = depth;
  }
}

}  // namespace

// dens, dists (n, s); tmid (n, s) or null (depth 0); colors (n, s, 3);
// outputs weights, trans (n, s) and stats (n, 5) = [r, g, b, opacity, depth].
extern "C" int netpu_render_fwd(const float* dens, const float* dists,
                                const float* tmid, const float* colors,
                                float* weights, float* trans, float* stats,
                                int n, int s, float density_scale, void* stream) {
  if (n > 0 && s > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    render_fwd_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        dens, dists, tmid, colors, weights, trans, stats, n, s, density_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* netpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
