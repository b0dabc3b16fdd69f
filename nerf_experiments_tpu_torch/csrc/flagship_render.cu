// Forward-only render of the flagship BARF radiance field for one NVIDIA H100:
// rays + t-bins -> rgb, opacity, depth and (optionally) per-sample weights.
//
// Replaces the TPU kernel `nerf_experiments_tpu/ops/train_megakernel.py:
// _render_kernel` (Pallas, entry `flagship_render`). For every sample it
// computes the BARF-masked Fourier encodings of position and direction (identity
// included), the 2-segment ReLU MLP (the position encoding re-enters the second
// segment), the density head with softplus-8, the colour head with the direction
// encoding and a sigmoid, and middle-point alpha compositing along the ray.
//
// What bounds it on the H100: arithmetic. Each sample costs ~0.6 M multiply-adds
// at the flagship width (4x256, 2 segments), so 8192 rays x 128 samples are
// ~6e11 FMAs; the weights (2.6 MB fp32, 1.3 MB bf16) stay in L2. The TPU design
// holds a 2048-row tile and every weight in 24 MB of VMEM; a Hopper block has
// at most 227 KB of shared memory, so here:
//   * one block owns one ray and walks its samples in chunks of kRows = 32;
//   * the chunk's activations live in shared memory as two ping-pong buffers
//     (32 x 260 fp32 each) beside the chunk's encodings; about 78 KB in all at
//     the flagship width, set with cudaFuncSetAttribute;
//   * the weights are streamed from global memory / L2 one layer at a time: each
//     thread owns output columns and keeps 32 row accumulators in registers, so
//     one weight load feeds 32 FMAs, and the activations are read from shared
//     memory as float4 broadcasts;
//   * compositing runs in warp 0 as a shuffle scan over the chunk, with the
//     running transmittance carried from chunk to chunk, so the ray finishes
//     inside the block and no per-sample value goes back to device memory;
//   * there is no padding: a ray whose S is not a multiple of 32 ends with a
//     short chunk whose idle rows are never stored.
// With bf16 the weights arrive in bf16 and every matmul operand (encodings,
// post-ReLU activations, the hidden part of the last segment layer) is rounded
// to bf16 at the points where the TPU kernel rounds (`cde`); products accumulate
// in fp32. Density and colour logits stay fp32.
// This is the simple design: FMA loops on the CUDA cores. wgmma/TMA are later work.
#include "flagship_common.cuh"

namespace {

using namespace netpu;

constexpr float* kNoStore = nullptr;  // the render kernel keeps no workspace

template <typename WT, bool kBf16>
__global__ void __launch_bounds__(kThreads)
flagship_render_kernel(const float* __restrict__ origs, const float* __restrict__ dirs,
                       const float* __restrict__ t_start, const float* __restrict__ t_end,
                       Layers layers, int S, int n_hidden, int D, int C, int Lp, int Ld,
                       float scale, float alpha_pos, float alpha_dir, float density_scale,
                       float* __restrict__ out, float* __restrict__ weights_out) {
  extern __shared__ __align__(16) float smem[];
  const int P = 3 + 6 * Lp, Q = 3 + 6 * Ld;
  const int lda = round4(D + 1), ldp = round4(P), ldq = round4(Q);
  float* buf0 = smem;                 // kRows x lda
  float* buf1 = buf0 + kRows * lda;   // kRows x lda
  float* enc_p = buf1 + kRows * lda;  // kRows x ldp
  float* enc_d = enc_p + kRows * ldp; // kRows x ldq
  float* tq = enc_d + kRows * ldq;    // kRows
  float* dist = tq + kRows;           // kRows
  float* logits = dist + kRows;       // kRows x 3
  float* mask = logits + 3 * kRows;   // Lp + Ld

  const int L = n_hidden + 1;  // layers per segment
  const int ray = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ray_row = static_cast<size_t>(ray) * S;

  barf_window(mask, Lp, Ld, alpha_pos, alpha_dir);
  float o[3], d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = __ldg(origs + ray * 3 + c);
    d[c] = __ldg(dirs + ray * 3 + c);
  }

  // compositing state, live in warp 0
  float carry = 0.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_o = 0.f, acc_d = 0.f;

  for (int base = 0; base < S; base += kRows) {
    const int rows = min(kRows, S - base);
    for (int r = tid; r < rows; r += blockDim.x) {
      const float ts = t_start[ray_row + base + r], te = t_end[ray_row + base + r];
      tq[r] = (ts + te) / 2.f;
      dist[r] = te - ts;
    }
    __syncthreads();  // also publishes mask on the first chunk
    for (int idx = tid; idx < rows * 3; idx += blockDim.x) {
      const int r = idx / 3, c = idx % 3;
      const float p = __fadd_rn(o[c], __fmul_rn(tq[r], d[c]));
      encode<kBf16>(p, c, Lp, mask, scale, enc_p + r * ldp);
      encode<kBf16>(d[c], c, Ld, mask + Lp, scale, enc_d + r * ldq);
    }
    __syncthreads();

    // segment 1: every layer ReLU (the last one is the inter-segment ReLU)
    float* cur = buf0;
    float* nxt = buf1;
    dense<WT, kBf16>(enc_p, ldp, P, nullptr, 0, 0, layers.w[0], layers.b[0], D,
                     cur, lda, rows, true, D, kNoStore, 0, 0, nullptr);
    __syncthreads();
    for (int i = 1; i < L; ++i) {
      dense<WT, kBf16>(cur, lda, D, nullptr, 0, 0, layers.w[i], layers.b[i], D,
                       nxt, lda, rows, true, D, kNoStore, 0, 0, nullptr);
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    // segment 2: [z | pos_enc] in, ReLU layers, then D -> D + 1 with no ReLU
    dense<WT, kBf16>(cur, lda, D, enc_p, ldp, P, layers.w[L], layers.b[L], D,
                     nxt, lda, rows, true, D, kNoStore, 0, 0, nullptr);
    __syncthreads();
    { float* t = cur; cur = nxt; nxt = t; }
    for (int i = 1; i < L - 1; ++i) {
      dense<WT, kBf16>(cur, lda, D, nullptr, 0, 0, layers.w[L + i], layers.b[L + i], D,
                       nxt, lda, rows, true, D, kNoStore, 0, 0, nullptr);
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    dense<WT, kBf16>(cur, lda, D, nullptr, 0, 0, layers.w[2 * L - 1], layers.b[2 * L - 1],
                     D + 1, nxt, lda, rows, false, D, kNoStore, 0, 0, nullptr);
    __syncthreads();
    { float* t = cur; cur = nxt; nxt = t; }
    // cur[r][0:D] = hidden features, cur[r][D] = raw density (fp32)
    // colour head: [hidden | dir_enc] -> C (ReLU) -> 3 logits
    dense<WT, kBf16>(cur, lda, D, enc_d, ldq, Q, layers.w[2 * L], layers.b[2 * L], C,
                     nxt, lda, rows, true, C, kNoStore, 0, 0, nullptr);
    __syncthreads();
    dense<WT, kBf16>(nxt, lda, C, nullptr, 0, 0, layers.w[2 * L + 1], layers.b[2 * L + 1], 3,
                     logits, 3, rows, false, 0, kNoStore, 0, 0, nullptr);
    __syncthreads();

    if (warp == 0) {
      float blk = 0.f, t = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
      if (lane < rows) {
        const float sigma = softplus8(cur[lane * lda + D]);
        blk = -sigma * dist[lane] * density_scale;
        t = tq[lane];
        c0 = 1.f / (1.f + expf(-logits[lane * 3 + 0]));
        c1 = 1.f / (1.f + expf(-logits[lane * 3 + 1]));
        c2 = 1.f / (1.f + expf(-logits[lane * 3 + 2]));
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
        if (weights_out) weights_out[ray_row + base + lane] = w;
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncthreads();  // the next chunk overwrites tq, dist and the buffers
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

template <typename WT, bool kBf16>
cudaError_t launch(const float* origs, const float* dirs, const float* t_start,
                   const float* t_end, const Layers& layers, int n_rays, int S,
                   int n_hidden, int D, int C, int Lp, int Ld, float scale,
                   float alpha_pos, float alpha_dir, float density_scale, float* out,
                   float* weights_out, cudaStream_t stream) {
  const int P = 3 + 6 * Lp, Q = 3 + 6 * Ld;
  const size_t floats = static_cast<size_t>(kRows) *
                            (2 * round4(D + 1) + round4(P) + round4(Q) + 5) +
                        Lp + Ld;
  const size_t bytes = floats * sizeof(float);
  auto kernel = flagship_render_kernel<WT, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<n_rays, kThreads, bytes, stream>>>(origs, dirs, t_start, t_end, layers, S,
                                              n_hidden, D, C, Lp, Ld, scale, alpha_pos,
                                              alpha_dir, density_scale, out, weights_out);
  return cudaGetLastError();
}

}  // namespace

// origs, dirs (n_rays, 3); t_start, t_end (n_rays, S); w_ptrs / b_ptrs: the
// 2 (n_hidden + 1) + 2 layers in the order segment 1, segment 2, colour head,
// weights (in, out) in bf16 when bf16 != 0 else fp32, biases fp32;
// out (n_rays, 5) = [r, g, b, opacity, depth]; weights_out (n_rays, S) or null.
extern "C" int netpu_flagship_render(const float* origs, const float* dirs,
                                     const float* t_start, const float* t_end,
                                     const void* const* w_ptrs, const float* const* b_ptrs,
                                     int n_layers, int bf16, int n_rays, int S, int n_hidden,
                                     int D, int C, int Lp, int Ld, float scale,
                                     float alpha_pos, float alpha_dir, float density_scale,
                                     float* out, float* weights_out, void* stream) {
  if (n_hidden < 1 || n_layers != 2 * (n_hidden + 1) + 2 || n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  Layers layers;
  for (int i = 0; i < n_layers; ++i) {
    layers.w[i] = w_ptrs[i];
    layers.b[i] = b_ptrs[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16, true>(origs, dirs, t_start, t_end, layers, n_rays, S,
                                         n_hidden, D, C, Lp, Ld, scale, alpha_pos,
                                         alpha_dir, density_scale, out, weights_out, st)
           : launch<float, false>(origs, dirs, t_start, t_end, layers, n_rays, S, n_hidden,
                                  D, C, Lp, Ld, scale, alpha_pos, alpha_dir, density_scale,
                                  out, weights_out, st);
  return static_cast<int>(err);
}
