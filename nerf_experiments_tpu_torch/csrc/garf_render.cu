// Forward-only render of the GARF / GaborF / SARF radiance field for one
// NVIDIA H100: rays + t-bins -> rgb, opacity, depth.
//
// Replaces the TPU kernel `nerf_experiments_tpu/ops/garf_megakernel.py:
// _render_kernel` (Pallas, entry `garf_radiance_render`). For every sample at
// the middle of its bin: the radiance net of `garf_common.cuh` with the
// family's activation (gauss, gabor or sarf, a template parameter; gamma scales
// the gabor / sarf oscillation), density softplus8(z - 1), sigmoid colour, and
// middle-point compositing along the ray (`render.render_full` conventions).
//
// What bounds it on the H100: arithmetic, ~0.6 M multiply-adds and ~2.7 K
// activations per sample. The TPU keeps a tile of rows and every weight in
// VMEM; here one block owns one ray, walks it in 32-sample chunks with the
// activations in shared memory (layer 0 streamed into layer 1, see
// `garf_common.cuh`), streams the weights from L2, and composites in warp 0
// with a shuffle scan whose transmittance carries from chunk to chunk. Any S:
// the last chunk of a ray may be short. Not carried over from the TPU: the
// split GEMMs for the 131-wide inputs, the 129 -> 256 merged density head,
// the 3 -> 128 padded colour head, the E/F selectors and the triangular
// matmul. With bf16, weights arrive in bf16 and matmul operands are rounded
// where the TPU kernel rounds (`cde`), with fp32 accumulation.
// This is the simple design: FMA loops on the CUDA cores.
#include "garf_common.cuh"

namespace {

using namespace netpu;
using namespace netpu::garf;

template <typename WT, bool kBf16, int kAct>
__global__ void __launch_bounds__(kThreads, 1)
garf_render_kernel(const float* __restrict__ origs, const float* __restrict__ dirs,
                   const float* __restrict__ t_start, const float* __restrict__ t_end,
                   Weights W, int S_, float gamma, float density_scale,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const Smem S(smem);
  const int ray = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ray_row = static_cast<size_t>(ray) * S_;
  float o[3], d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = __ldg(origs + ray * 3 + c);
    d[c] = __ldg(dirs + ray * 3 + c);
  }

  float carry = 0.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_o = 0.f, acc_d = 0.f;
  for (int base = 0; base < S_; base += kRows) {
    const int rows = min(kRows, S_ - base);
    load_chunk<kBf16>(t_start, t_end, ray_row + base, rows, o, d, S);
    forward_chunk<WT, kBf16, kAct, float>(W, gamma, S, rows, nullptr, 0);
    if (warp == 0) {
      float blk = 0.f, t = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
      if (lane < rows) {
        blk = -softplus8(S.Q[lane * kLdQ + 128] - 1.f) * S.dist[lane] * density_scale;
        t = S.tq[lane];
        c0 = 1.f / (1.f + expf(-S.logits[lane * kLd4 + 0]));
        c1 = 1.f / (1.f + expf(-S.logits[lane * kLd4 + 1]));
        c2 = 1.f / (1.f + expf(-S.logits[lane * kLd4 + 2]));
      }
      const float incl = warp_scan(blk, lane);
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float w = expf(carry + excl) * (1.f - expf(blk));
      if (lane < rows) {
        acc_r += w * c0;
        acc_g += w * c1;
        acc_b += w * c2;
        acc_o += w;
        acc_d += w * t;
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncthreads();  // the next chunk overwrites the buffers
  }
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc_r += __shfl_xor_sync(kFull, acc_r, off);
      acc_g += __shfl_xor_sync(kFull, acc_g, off);
      acc_b += __shfl_xor_sync(kFull, acc_b, off);
      acc_o += __shfl_xor_sync(kFull, acc_o, off);
      acc_d += __shfl_xor_sync(kFull, acc_d, off);
    }
    if (lane == 0) {
      float* o5 = out + static_cast<size_t>(ray) * 5;
      o5[0] = acc_r;
      o5[1] = acc_g;
      o5[2] = acc_b;
      o5[3] = acc_o;
      o5[4] = acc_d;
    }
  }
}

template <typename WT, bool kBf16, int kAct>
cudaError_t launch(const float* origs, const float* dirs, const float* t_start,
                   const float* t_end, const Weights& W, int n_rays, int S, float gamma,
                   float density_scale, float* out, cudaStream_t stream) {
  const int bytes = kSmemTotal * static_cast<int>(sizeof(float));
  auto kernel = garf_render_kernel<WT, kBf16, kAct>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<n_rays, kThreads, bytes, stream>>>(origs, dirs, t_start, t_end, W, S, gamma,
                                              density_scale, out);
  return cudaGetLastError();
}

template <typename WT, bool kBf16>
cudaError_t dispatch(int activation, const float* origs, const float* dirs,
                     const float* t_start, const float* t_end, const Weights& W, int n_rays,
                     int S, float gamma, float density_scale, float* out, cudaStream_t st) {
  switch (activation) {
    case kGauss:
      return launch<WT, kBf16, kGauss>(origs, dirs, t_start, t_end, W, n_rays, S, gamma,
                                       density_scale, out, st);
    case kGabor:
      return launch<WT, kBf16, kGabor>(origs, dirs, t_start, t_end, W, n_rays, S, gamma,
                                       density_scale, out, st);
    case kSarf:
      return launch<WT, kBf16, kSarf>(origs, dirs, t_start, t_end, W, n_rays, S, gamma,
                                      density_scale, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// origs, dirs (n_rays, 3); t_start, t_end (n_rays, S); w_ptrs / b_ptrs: the 10
// linear layers of `garf_common.cuh`, weights (in, out) in bf16 when bf16 != 0
// else fp32, biases fp32; p1_ptrs / p2_ptrs: the 8 activation layers'
// per-feature parameters (p2 null unless gabor); activation 0 gauss, 1 gabor,
// 2 sarf; out (n_rays, 5) = [r, g, b, opacity, depth].
extern "C" int netpu_garf_render(const float* origs, const float* dirs, const float* t_start,
                                 const float* t_end, const void* const* w_ptrs,
                                 const float* const* b_ptrs, const float* const* p1_ptrs,
                                 const float* const* p2_ptrs, int activation, int bf16,
                                 int n_rays, int S, float gamma, float density_scale,
                                 float* out, void* stream) {
  if (activation == kGabor) {
    for (int i = 0; i < kActs; ++i)
      if (p2_ptrs[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  Weights W{};
  for (int i = 0; i < kLayers; ++i) {
    W.w[i] = w_ptrs[i];
    W.b[i] = b_ptrs[i];
  }
  for (int i = 0; i < kActs; ++i) {
    W.p1[i] = p1_ptrs[i];
    W.p2[i] = activation == kGabor ? p2_ptrs[i] : nullptr;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16, true>(activation, origs, dirs, t_start, t_end, W, n_rays,
                                          S, gamma, density_scale, out, st)
           : dispatch<float, false>(activation, origs, dirs, t_start, t_end, W, n_rays, S,
                                    gamma, density_scale, out, st);
  return static_cast<int>(err);
}
