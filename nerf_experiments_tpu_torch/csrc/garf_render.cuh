// Forward-only render of the GARF / GaborF / SARF radiance field for one
// NVIDIA H100 (K6): rays + t-bins -> rgb, opacity, depth.
//
// Replaces the TPU kernel `nerf_experiments_tpu/ops/garf_megakernel.py:
// _render_kernel` (Pallas, entry `garf_radiance_render`). For every sample at
// the middle of its bin: the radiance net of `garf_common.cuh` with the
// family's activation (gauss, gabor or sarf, a template parameter; gamma scales
// the gabor / sarf oscillation), density softplus8(z - 1), sigmoid colour, and
// middle-point compositing along the ray (`render.render_full` conventions).
//
// What bounds it on the H100: arithmetic, 596,096 multiply-adds a sample:
// 1.90 ms at 8192 rays x 192 samples at the bf16 tensor-core rate, 11.37 ms
// for fp32's three TF32 products (3xTF32) at the TF32 rate; then ~2.7 K
// activations a sample (one or two transcendentals each) on the CUDA cores.
// The TPU keeps a tile of rows and every weight in VMEM; here a block of 8
// warps owns a row tile (64 rows in bf16, 32 in fp32) whose activations stay
// in shared memory, every product but layer 0's runs on the tensor cores
// (`garf_common.cuh`: mma.sync, weights streamed from L2 through per-warp
// cp.async rings, layer 0 streamed into layer 1's accumulators), and one
// warp a ray composites with a shuffle scan whose transmittance and colour
// sums carry from tile to tile in shared memory. Any S: a ragged tile
// computes its idle rows and stores none of them.
// With bf16, products take bf16 operands and accumulate in fp32, and every
// layer's pre-activation and output are rounded to bf16 (`cde`); density and
// colour logits stay fp32.
#pragma once

#include "garf_common.cuh"

namespace netpu {
namespace garf {
namespace {

template <bool kBf16, int kAct>
__global__ void __launch_bounds__(kThreads, 1)
garf_render_kernel(const float* __restrict__ origs, const float* __restrict__ dirs,
                   const float* __restrict__ t_start, const float* __restrict__ t_end,
                   GarfWeights W, int n_rays, int S, float gamma, float density_scale,
                   float* __restrict__ out) {
  using L = GarfSmem<kBf16>;
  constexpr int kR = L::kR, kComp = L::kComp;
  extern __shared__ __align__(16) unsigned char smem[];
  const GarfBufs<kBf16> s(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const BlockRows br(n_rays, S, kR);
  s.zero();
  for (int tb = 0; tb < br.rows; tb += kR) {
    const int rows = min(kR, br.rows - tb);
    load_tile<kBf16>(origs, dirs, t_start, t_end, br, S, tb, rows, s);  // also publishes zero()
    forward_tile<kBf16, kAct>(W, gamma, s, rows, nullptr, 0);

    // compositing: warp w takes the tile's rays w, w + 8, ...
    const int j_first = tb / S, j_last = (tb + rows - 1) / S;
    for (int j = j_first + warp; j <= j_last; j += kWarps) {
      const int lo = max(tb, j * S) - tb, hi = min(tb + rows, (j + 1) * S) - tb;
      float* st = s.comp + j * kComp;
      float carry = st[0], ar = 0.f, ag = 0.f, ab = 0.f, ao = 0.f, ad = 0.f;
      for (int c0 = lo; c0 < hi; c0 += 32) {
        const int r = c0 + lane;
        const bool live = r < hi;
        float blk = 0.f, t = 0.f, k0 = 0.f, k1 = 0.f, k2 = 0.f;
        if (live) {
          blk = -softplus8(s.dens[r] - 1.f) * s.dist[r] * density_scale;
          t = s.tq[r];
          k0 = 1.f / (1.f + expf(-s.logits[r * 3 + 0]));
          k1 = 1.f / (1.f + expf(-s.logits[r * 3 + 1]));
          k2 = 1.f / (1.f + expf(-s.logits[r * 3 + 2]));
        }
        const float incl = warp_scan(blk, lane);
        float excl = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) excl = 0.f;
        const float w = expf(carry + excl) * (1.f - expf(blk));
        if (live) {
          ar += w * k0;
          ag += w * k1;
          ab += w * k2;
          ao += w;
          ad += w * t;
        }
        carry += __shfl_sync(kFull, incl, 31);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ar += __shfl_xor_sync(kFull, ar, off);
        ag += __shfl_xor_sync(kFull, ag, off);
        ab += __shfl_xor_sync(kFull, ab, off);
        ao += __shfl_xor_sync(kFull, ao, off);
        ad += __shfl_xor_sync(kFull, ad, off);
      }
      if (lane == 0) {
        st[0] = carry;
        st[1] += ar;
        st[2] += ag;
        st[3] += ab;
        st[4] += ao;
        st[5] += ad;
        if (tb + hi == (j + 1) * S) {  // the ray's last sample
          float* o5 = out + static_cast<size_t>(br.ray0 + j) * 5;
          for (int k = 0; k < 5; ++k) o5[k] = st[1 + k];
        }
      }
    }
    __syncthreads();  // the next tile overwrites tq, dist, dens, logits and the tiles
  }
}

template <bool kBf16, int kAct>
cudaError_t launch_render(const RenderArgs& a) {
  using L = GarfSmem<kBf16>;
  static_assert(L::kBytes <= kMaxSmemBytes, "the render tile must fit in shared memory");
  auto kernel = garf_render_kernel<kBf16, kAct>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const int rpb = rays_per_block(a.S, L::kR);
  const unsigned blocks = static_cast<unsigned>((a.n_rays + rpb - 1) / rpb);
  kernel<<<blocks, kThreads, L::kBytes, a.stream>>>(a.origs, a.dirs, a.t_start, a.t_end, a.W,
                                                    a.n_rays, a.S, a.gamma, a.density_scale,
                                                    a.out);
  return cudaGetLastError();
}

template <int kAct>
cudaError_t render_family(const RenderArgs& a, bool bf16) {
  return bf16 ? launch_render<true, kAct>(a) : launch_render<false, kAct>(a);
}

}  // namespace
}  // namespace garf
}  // namespace netpu
