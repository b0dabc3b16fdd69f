// Volume rendering (alpha compositing), forward and backward, for one NVIDIA
// H100.
//
// The forward replaces the TPU kernel
// `nerf_experiments_tpu/ops/render_pallas.py:_fwd_kernel`, the backward its
// `_bwd_kernel` (Pallas, reached through `render_full_pallas` /
// `render_rays_pallas` and their custom VJP `_render_core`).
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
//
// Backward, from the cotangents gw, gT (N, S) and g_stats (N, 5):
//   gw'_i = gw_i + c_i . g_rgb + g_opacity + t_i g_depth,
//   db_j  = sum_{i>j} (gw'_i w_i + gT_i T_i) - gw'_j T_j exp(b_j),
//   d_sigma = db (-delta scale), d_delta = db (-sigma scale), d_c = w g_rgb.
// The TPU kernel ran the suffix sum as a second triangular matmul. Here the
// same warp walks the ray twice: forward, keeping only the exclusive prefix of
// b at the start of each 32-sample step (in shared memory); then backward from
// the end of the ray, recomputing each step's scan, T and w, with the suffix
// sum a reverse shuffle scan carried from the later steps. Also memory-bound
// (~14 fp32 values per sample).
#include "flagship_common.cuh"

namespace {

using netpu::kFull;
using netpu::warp_scan;

constexpr int kWarps = 8;  // rays per block

// b = -sigma delta scale of sample i of the ray starting at `row` (0 past the end).
__device__ __forceinline__ float blocking(const float* dens, const float* dists, size_t row,
                                          int i, bool live, float density_scale) {
  return live ? -dens[row + i] * dists[row + i] * density_scale : 0.f;
}

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
      blk = blocking(dens, dists, row, i, true, density_scale);
      t = tmid ? tmid[row + i] : 0.f;
      const float* c = colors + (row + i) * 3;
      c0 = c[0];
      c1 = c[1];
      c2 = c[2];
    }
    const float incl = warp_scan(blk, lane);
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


// One warp per ray; carries[kWarps * n_steps] (dynamic shared memory) keeps
// each warp's exclusive prefix of b at every 32-sample step.
__global__ void __launch_bounds__(kWarps * 32)
render_bwd_kernel(const float* __restrict__ dens, const float* __restrict__ dists,
                  const float* __restrict__ tmid, const float* __restrict__ colors,
                  const float* __restrict__ gw, const float* __restrict__ gt,
                  const float* __restrict__ gstats, float* __restrict__ ddens,
                  float* __restrict__ ddists, float* __restrict__ dcolors, int n, int s,
                  float density_scale) {
  extern __shared__ float carries[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= n) return;  // whole warps leave together; no block barrier follows
  const int n_steps = (s + 31) / 32;
  float* carry_at = carries + warp * n_steps;
  const size_t row = static_cast<size_t>(ray) * s;

  float carry = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const int i = step * 32 + lane;
    const float incl = warp_scan(blocking(dens, dists, row, i, i < s, density_scale), lane);
    if (lane == 0) carry_at[step] = carry;
    carry += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();

  const float* g = gstats + static_cast<size_t>(ray) * 5;
  const float g_r = g[0], g_g = g[1], g_b = g[2], g_o = g[3], g_d = g[4];
  float tail = 0.f;  // sum of gw' w + gT T over the samples after this step
  for (int step = n_steps - 1; step >= 0; --step) {
    const int i = step * 32 + lane;
    const bool live = i < s;
    const float blk = blocking(dens, dists, row, i, live, density_scale);
    const float incl = warp_scan(blk, lane);
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float T = expf(carry_at[step] + excl);
    const float e = expf(blk);
    const float w = T * (1.f - e);
    float gw_all = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, src = 0.f;
    if (live) {
      const float* c = colors + (row + i) * 3;
      c0 = c[0];
      c1 = c[1];
      c2 = c[2];
      gw_all = gw[row + i] + c0 * g_r + c1 * g_g + c2 * g_b + g_o +
               (tmid ? tmid[row + i] * g_d : 0.f);
      src = gw_all * w + gt[row + i] * T;
    }
    float sfx = src;  // reverse inclusive scan: sum over lanes >= this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(kFull, sfx, off);
      if (lane + off < 32) sfx += y;
    }
    float after = __shfl_down_sync(kFull, sfx, 1);
    if (lane == 31) after = 0.f;
    if (live) {
      const float db = (tail + after) - gw_all * T * e;
      ddens[row + i] = db * (-dists[row + i] * density_scale);
      ddists[row + i] = db * (-dens[row + i] * density_scale);
      float* dc = dcolors + (row + i) * 3;
      dc[0] = w * g_r;
      dc[1] = w * g_g;
      dc[2] = w * g_b;
    }
    tail += __shfl_sync(kFull, sfx, 0);
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

// The backward of netpu_render_fwd. dens, dists (n, s); tmid (n, s) or null;
// colors (n, s, 3); cotangents gw, gt (n, s) of weights and trans and g_stats
// (n, 5) of [r, g, b, opacity, depth]; outputs ddens, ddists (n, s), dcolors
// (n, s, 3). tmid gets no gradient.
extern "C" int netpu_render_bwd(const float* dens, const float* dists, const float* tmid,
                                const float* colors, const float* gw, const float* gt,
                                const float* gstats, float* ddens, float* ddists,
                                float* dcolors, int n, int s, float density_scale,
                                void* stream) {
  if (n > 0 && s > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    const size_t bytes = static_cast<size_t>(kWarps) * ((s + 31) / 32) * sizeof(float);
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          render_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    render_bwd_kernel<<<blocks, kWarps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
        dens, dists, tmid, colors, gw, gt, gstats, ddens, ddists, dcolors, n, s,
        density_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* netpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
