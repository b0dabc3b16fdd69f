// Entry point of the GARF / GaborF / SARF render kernel K6 for one NVIDIA
// H100 (replaces the TPU kernel `nerf_experiments_tpu/ops/garf_megakernel.py:
// _render_kernel`; entry `garf_radiance_render`). The kernel is in
// `garf_render.cuh`, compiled once per activation family
// (`garf_render_gauss.cu`, `garf_render_gabor.cu`, `garf_render_sarf.cu`);
// this file checks the arguments and dispatches.
#include "garf_common.cuh"

using namespace netpu;
using namespace netpu::garf;

// origs, dirs (n_rays, 3); t_start, t_end (n_rays, S); wf_ptrs: the 10 linear
// layers' forward B operands packed by `garf_megakernel.packed_weights`
// (entry 0 unused: linear 0 runs on the CUDA cores), bf16 when bf16 != 0
// else fp32 TF32 hi / lo pairs; b_ptrs: the biases, fp32; w0: linear 0's W
// (3, 1024) and w_density: linear 7's W[:, 128], both in the compute type;
// p1_ptrs / p2_ptrs: the 8 activation layers' per-feature parameters (p2
// null unless gabor); activation 0 gauss, 1 gabor, 2 sarf; tile_rows: the row
// tile, 64 in bf16 and 32 in fp32 (`garf_megakernel.tile_rows`); out (n_rays,
// 5) = [r, g, b, opacity, depth].
extern "C" int netpu_garf_render(const float* origs, const float* dirs, const float* t_start,
                                 const float* t_end, const void* const* wf_ptrs,
                                 const float* const* b_ptrs, const void* w0,
                                 const void* w_density, const float* const* p1_ptrs,
                                 const float* const* p2_ptrs, int activation, int bf16,
                                 int tile_rows, int n_rays, int S, float gamma,
                                 float density_scale, float* out, void* stream) {
  if (tile_rows != (bf16 ? GarfSmem<true>::kR : GarfSmem<false>::kR) || activation < kGauss ||
      activation > kSarf)
    return static_cast<int>(cudaErrorInvalidValue);
  if (activation == kGabor) {
    for (int i = 0; i < kActs; ++i)
      if (p2_ptrs[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  GarfWeights W{};
  for (int i = 0; i < kLayers; ++i) {
    W.fwd[i] = wf_ptrs[i];
    W.b[i] = b_ptrs[i];
  }
  W.w0 = w0;
  W.w_density = w_density;
  for (int i = 0; i < kActs; ++i) {
    W.p1[i] = p1_ptrs[i];
    W.p2[i] = activation == kGabor ? p2_ptrs[i] : nullptr;
  }
  const RenderArgs a{origs, dirs, t_start, t_end, W, n_rays, S, gamma, density_scale, out,
                     static_cast<cudaStream_t>(stream)};
  const cudaError_t err = activation == kGauss   ? render_gauss(a, bf16 != 0)
                          : activation == kGabor ? render_gabor(a, bf16 != 0)
                                                 : render_sarf(a, bf16 != 0);
  return static_cast<int>(err);
}
