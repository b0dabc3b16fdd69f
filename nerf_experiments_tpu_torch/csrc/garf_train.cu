// Entry point of the GARF / GaborF / SARF train kernel K5 for one NVIDIA H100
// (replaces the TPU kernel `nerf_experiments_tpu/ops/garf_megakernel.py:_kernel`;
// entry `garf_radiance_train_grads`). The kernels are in `garf_train.cuh`, one
// source per activation family (`garf_train_gauss.cu`, `garf_train_gabor.cu`,
// `garf_train_sarf.cu`); this file checks the arguments and dispatches.
#include "garf_common.cuh"

using namespace netpu;
using namespace netpu::garf;

// Inputs: origs, dirs, targets (n_rays, 3); t_start, t_end (n_rays, S);
// wf_ptrs / wb_ptrs: the 10 linear layers' forward (W) and backward (W^T) B
// operands packed by `garf_megakernel.packed_weights` (entry 0 unused: linear
// 0 runs on the CUDA cores), bf16 when bf16 != 0 else fp32 TF32 hi / lo
// pairs; b_ptrs: the biases, fp32; w0: linear 0's W (3, 1024) and w_density:
// linear 7's W[:, 128], both in the compute type; p1_ptrs / p2_ptrs: the 8
// activation layers' parameters (p2 only for gabor); tile_rows: the row tile,
// 64 in bf16 and 32 in fp32 (`garf_megakernel.tile_rows`); grad_scale = 2 /
// (n_rays 3). Workspaces: act (n_rays S, act_width) in the compute type, cot
// (n_rays S, cot_width) fp32, aux (n_rays S, 6) fp32, block_part (blocks,
// part_width) fp32 with blocks = ceil(n_rays / rays_per_block(S, tile_rows)),
// part (splits, n_w + n_b - 3 * 1024 - 1024) fp32, with n_w / n_b the net's
// weight / bias counts; the three widths are checked against `ActLayout`,
// `kCotWidth` and `block_part_width`. Outputs: grads (n_grads) = every linear
// layer's dW (in, out) in layer order, every db, then for each activation
// layer its p1 gradient (and p2's for gabor); rgb_out, d_origs, d_dirs
// (n_rays, 3); weights_out (n_rays, S).
extern "C" int netpu_garf_train(
    const float* origs, const float* dirs, const float* t_start, const float* t_end,
    const float* targets, const void* const* wf_ptrs, const void* const* wb_ptrs,
    const float* const* b_ptrs, const void* w0, const void* w_density,
    const float* const* p1_ptrs, const float* const* p2_ptrs, int activation, int bf16,
    int tile_rows, int n_rays, int S, float gamma, float density_scale, float grad_scale,
    void* act, float* cot, float* aux, float* block_part, int act_width, int cot_width,
    int part_width, float* part, int splits, float* grads, float* rgb_out, float* weights_out,
    float* d_origs, float* d_dirs, void* stream) {
  const bool widths_ok =
      act_width == ActLayout::total() && cot_width == kCotWidth &&
      (activation == kGauss   ? part_width == block_part_width<kGauss>()
       : activation == kGabor ? part_width == block_part_width<kGabor>()
       : activation == kSarf  ? part_width == block_part_width<kSarf>()
                              : false);
  if (splits < 1 || !widths_ok ||
      tile_rows != (bf16 ? GarfSmem<true>::kR : GarfSmem<false>::kR))
    return static_cast<int>(cudaErrorInvalidValue);
  if (activation == kGabor) {
    for (int i = 0; i < kActs; ++i)
      if (p2_ptrs[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  GarfWeights W{};
  for (int i = 0; i < kLayers; ++i) {
    W.fwd[i] = wf_ptrs[i];
    W.bwd[i] = wb_ptrs[i];
    W.b[i] = b_ptrs[i];
  }
  W.w0 = w0;
  W.w_density = w_density;
  for (int i = 0; i < kActs; ++i) {
    W.p1[i] = p1_ptrs[i];
    W.p2[i] = activation == kGabor ? p2_ptrs[i] : nullptr;
  }
  const TrainArgs a{origs, dirs, t_start, t_end, targets, W, n_rays, S, gamma, density_scale,
                    grad_scale, act, cot, aux, block_part, part, splits, grads, rgb_out,
                    weights_out, d_origs, d_dirs, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = activation == kGauss   ? train_gauss(a, bf16 != 0)
                          : activation == kGabor ? train_gabor(a, bf16 != 0)
                                                 : train_sarf(a, bf16 != 0);
  return static_cast<int>(err);
}
