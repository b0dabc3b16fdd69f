// Training step of the flagship BARF radiance field for one NVIDIA H100:
// rays + t-bins + targets -> rgb, the gradient of
//   loss = loss_scale * mean((rgb - target)^2)   (over n_rays * 3)
// with respect to every weight and bias (fp32), the per-ray geometry
// gradients d_origs / d_dirs, and optionally the per-sample weights.
//
// Replaces the TPU kernel `nerf_experiments_tpu/ops/train_megakernel.py:_kernel`
// (Pallas, entry `flagship_train_grads`). Forward as in `flagship_render.cu`
// (BARF-windowed encodings, the 2-segment ReLU MLP, softplus-8 density,
// sigmoid colour, middle-point compositing), then the MSE gradient, the
// compositing backward and the full MLP backward.
//
// What bounds it on the H100: arithmetic (about 3x the forward's 0.66 M FMAs
// per sample at the flagship width) and the activation workspace. The TPU
// keeps a 1024-row tile's activations in ~24 MB of VMEM from forward through
// backward; one flagship sample row stores ~2.8 K activations (11 KB in fp32)
// and a Hopper block has at most 227 KB. So the work is split in two phases:
//   * phase A, one block per ray (K2's structure, 32-row chunks): the forward
//     writes every layer's output to a global workspace (bf16 when the compute
//     type is bf16) and each ReLU layer's mask, taken from that stored value
//     (so exact in bf16 too), as one 32-bit word per (chunk, column); warp 0
//     composites with a shuffle scan and then, walking the chunks backwards,
//     runs the compositing backward as a reverse scan with the suffix sum
//     carried from the end of the ray; the chunks are then walked again and
//     the row cotangents are carried back layer by layer (g <- (g W^T) * mask,
//     with W^T passed transposed so the loads coalesce) and stored per layer;
//     the encoding backward gives d_pos / d_dirs, summed per ray in a fixed
//     order;
//   * phase B (`train_common.cuh`, shared with the GARF train kernel): dW =
//     A^T G and db = sum G for every layer, a tiled GEMM over the rows on the
//     CUDA cores, split over the rows into fixed partials that a third kernel
//     adds in a fixed order. No atomics: two launches give bitwise equal
//     gradients.
// With bf16, matmul operands (weights, activations, cotangents) are rounded to
// bf16 and products accumulate in fp32 where the TPU kernel rounds (`cde`);
// the bias gradients sum the fp32 cotangents.
// This is the simple design: FMA loops on the CUDA cores. Tensor cores
// (mma.sync / wgmma), TMA, and keeping activations on chip are later work.
#include "train_common.cuh"

namespace {

using namespace netpu;

constexpr int kAux = 6;        // per-row compositing record: raw density, rgb, T, w
constexpr int kGradRows = 96;  // threads holding a (row, coordinate) geometry partial

struct Transposed {
  const void* w[kMaxLayers];  // (out, in) row-major copies of the weights
};

// Per-row workspace layout. Activations (compute type), row width AW:
//   [pos_enc P | dir_enc Q | seg-1 outputs L x D | seg-2 ReLU outputs (L-1) x D |
//    hidden D | colour hidden C]
// Cotangents of each layer's pre-activation (fp32), row width GW: layer l at
// g(l), widths D for l < 2L-1, D + 1 for the last segment layer, C, 3.
// ReLU masks, one 32-bit word per (chunk, column), bit r for the chunk's row
// r, width MW per chunk: [seg-1 L x D | seg-2 (L-1) x D | colour hidden C].
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

// Backward through one dense layer for the chunk's rows: t[r][k] =
// sum_n g[r][n] * Wt[n][k] for k < K1 + K2, Wt the (n_in, K1 + K2) transposed
// weight. Outputs k < K1 (the cotangent of a hidden layer's pre-activation)
// are masked by the ReLU mask words mask1[k] when given, stored fp32 to glob1
// and rounded to the compute type into dst1 (the next matmul's input);
// outputs k >= K1 (an encoding's cotangent) are written or added, fp32, into
// dst2.
template <typename WT, bool kBf16>
__device__ void dense_bwd(const float* g, int ldg, int n_in, const void* Wt_, int K1,
                          float* dst1, int ld1, float* glob1, size_t gld,
                          const unsigned* mask1, int K2, float* dst2, int ld2, bool add2,
                          int rows) {
  const WT* Wt = static_cast<const WT*>(Wt_);
  const int K = K1 + K2;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    accumulate(acc, g, ldg, n_in, Wt, 0, K, k);
    if (k < K1) {
      const unsigned bits = mask1 != nullptr ? mask1[k] : 0xffffffffu;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float v = (bits >> r) & 1u ? acc[r] : 0.f;
          glob1[r * gld + k] = v;
          dst1[r * ld1 + k] = cde<kBf16>(v);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          float* p = dst2 + r * ld2 + (k - K1);
          *p = add2 ? *p + acc[r] : acc[r];
        }
      }
    }
  }
}

// Two blocks per SM (the shared memory allows two): without the bound ptxas
// takes ~200 registers and one block fits, which measured 1.5x slower.
template <typename WT, bool kBf16, typename AT>
__global__ void __launch_bounds__(kThreads, 2)
flagship_train_kernel(const float* __restrict__ origs, const float* __restrict__ dirs,
                      const float* __restrict__ t_start, const float* __restrict__ t_end,
                      const float* __restrict__ targets, Layers layers, Transposed wt,
                      int S, int n_hidden, int D, int C, int Lp, int Ld, float scale,
                      float alpha_pos, float alpha_dir, float density_scale, float grad_scale,
                      AT* act, float* cot, float* aux, unsigned* masks,
                      float* __restrict__ rgb_out,
                      float* __restrict__ d_origs, float* __restrict__ d_dirs,
                      float* __restrict__ weights_out) {
  extern __shared__ __align__(16) float smem[];
  const int P = 3 + 6 * Lp, Q = 3 + 6 * Ld;
  const int L = n_hidden + 1;  // layers per segment
  const Layout lay{P, Q, D, C, L};
  const size_t AW = lay.act_width(), GW = lay.cot_width(), MW = lay.mask_width();
  const int n_chunks = (S + kRows - 1) / kRows;
  const int lda = round4(D + 1), ldp = round4(P), ldq = round4(Q);
  float* mask = smem;                          // Lp + Ld
  float* red = mask + round4(Lp + Ld);         // 2 x kGradRows
  float* tq = red + 2 * kGradRows;             // kRows
  float* dist = tq + kRows;                    // kRows
  float* buf0 = dist + kRows;                  // kRows x lda: activations / cotangents
  float* buf1 = buf0 + kRows * lda;            // kRows x lda
  float* enc_p = buf1 + kRows * lda;           // kRows x ldp: encoding / its cotangent
  float* enc_d = enc_p + kRows * ldp;          // kRows x ldq
  float* logits = enc_d + kRows * ldq;         // kRows x 3

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

  // ---- forward, chunk by chunk; compositing state lives in warp 0 ----
  float carry = 0.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  for (int base = 0; base < S; base += kRows) {
    const int rows = min(kRows, S - base);
    const size_t row0 = ray_row + base;
    AT* a0 = act + row0 * AW;
    unsigned* m0 = masks + (static_cast<size_t>(ray) * n_chunks + base / kRows) * MW;
    for (int r = tid; r < rows; r += blockDim.x) {
      const float ts = t_start[row0 + r], te = t_end[row0 + r];
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
    for (int idx = tid; idx < rows * P; idx += blockDim.x)
      store_act(a0 + (idx / P) * AW + idx % P, enc_p[(idx / P) * ldp + idx % P]);
    for (int idx = tid; idx < rows * Q; idx += blockDim.x)
      store_act(a0 + (idx / Q) * AW + P + idx % Q, enc_d[(idx / Q) * ldq + idx % Q]);

    float* cur = buf0;
    float* nxt = buf1;
    dense<WT, kBf16>(enc_p, ldp, P, nullptr, 0, 0, layers.w[0], layers.b[0], D, cur, lda,
                     rows, true, D, a0 + lay.h1(0), AW, D, m0 + lay.m_h1(0));
    __syncthreads();
    for (int i = 1; i < L; ++i) {
      dense<WT, kBf16>(cur, lda, D, nullptr, 0, 0, layers.w[i], layers.b[i], D, nxt, lda,
                       rows, true, D, a0 + lay.h1(i), AW, D, m0 + lay.m_h1(i));
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    dense<WT, kBf16>(cur, lda, D, enc_p, ldp, P, layers.w[L], layers.b[L], D, nxt, lda, rows,
                     true, D, a0 + lay.h2(0), AW, D, m0 + lay.m_h2(0));
    __syncthreads();
    { float* t = cur; cur = nxt; nxt = t; }
    for (int i = 1; i < L - 1; ++i) {
      dense<WT, kBf16>(cur, lda, D, nullptr, 0, 0, layers.w[L + i], layers.b[L + i], D, nxt,
                       lda, rows, true, D, a0 + lay.h2(i), AW, D, m0 + lay.m_h2(i));
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    dense<WT, kBf16>(cur, lda, D, nullptr, 0, 0, layers.w[2 * L - 1], layers.b[2 * L - 1],
                     D + 1, nxt, lda, rows, false, D, a0 + lay.hid(), AW, D, nullptr);
    __syncthreads();
    { float* t = cur; cur = nxt; nxt = t; }
    // cur[r][0:D] = hidden features, cur[r][D] = raw density (fp32)
    dense<WT, kBf16>(cur, lda, D, enc_d, ldq, Q, layers.w[2 * L], layers.b[2 * L], C, nxt,
                     lda, rows, true, C, a0 + lay.c0(), AW, C, m0 + lay.m_c0());
    __syncthreads();
    dense<WT, kBf16>(nxt, lda, C, nullptr, 0, 0, layers.w[2 * L + 1], layers.b[2 * L + 1], 3,
                     logits, 3, rows, false, 0, static_cast<AT*>(nullptr), 0, 0, nullptr);
    __syncthreads();

    if (warp == 0) {
      float raw = 0.f, blk = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
      if (lane < rows) {
        raw = cur[lane * lda + D];
        blk = -softplus8(raw) * dist[lane] * density_scale;
        c0 = 1.f / (1.f + expf(-logits[lane * 3 + 0]));
        c1 = 1.f / (1.f + expf(-logits[lane * 3 + 1]));
        c2 = 1.f / (1.f + expf(-logits[lane * 3 + 2]));
      }
      const float incl = warp_scan(blk, lane);
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float T = expf(carry + excl);
      const float w = T * (1.f - expf(blk));
      if (lane < rows) {
        acc_r += w * c0;
        acc_g += w * c1;
        acc_b += w * c2;
        float* x = aux + (row0 + lane) * kAux;
        x[0] = raw; x[1] = c0; x[2] = c1; x[3] = c2; x[4] = T; x[5] = w;
        if (weights_out) weights_out[row0 + lane] = w;
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncthreads();  // the next chunk overwrites tq, dist and the buffers
  }

  // ---- loss gradient and compositing backward (warp 0) ----
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc_r += __shfl_xor_sync(kFull, acc_r, off);
      acc_g += __shfl_xor_sync(kFull, acc_g, off);
      acc_b += __shfl_xor_sync(kFull, acc_b, off);
    }
    if (lane == 0) {
      rgb_out[ray * 3 + 0] = acc_r;
      rgb_out[ray * 3 + 1] = acc_g;
      rgb_out[ray * 3 + 2] = acc_b;
    }
    const float g0 = grad_scale * (acc_r - __ldg(targets + ray * 3 + 0));
    const float g1 = grad_scale * (acc_g - __ldg(targets + ray * 3 + 1));
    const float g2 = grad_scale * (acc_b - __ldg(targets + ray * 3 + 2));
    float tail = 0.f;  // sum of g_w * w over the samples after this chunk
    for (int base = ((S - 1) / kRows) * kRows; base >= 0; base -= kRows) {
      const int i = base + lane;
      const bool live = i < S;
      const size_t row = ray_row + i;
      float raw = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, T = 0.f, w = 0.f, dt = 0.f;
      if (live) {
        const float* x = aux + row * kAux;
        raw = x[0]; c0 = x[1]; c1 = x[2]; c2 = x[3]; T = x[4]; w = x[5];
        dt = t_end[row] - t_start[row];
      }
      const float gw = g0 * c0 + g1 * c1 + g2 * c2;  // dL/dw of this sample
      float sfx = gw * w;                           // reverse inclusive scan
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_down_sync(kFull, sfx, off);
        if (lane + off < 32) sfx += y;
      }
      float after = __shfl_down_sync(kFull, sfx, 1);
      if (lane == 31) after = 0.f;
      if (live) {
        const float blk = -softplus8(raw) * dt * density_scale;
        const float d_blk = -gw * T * expf(blk) + (tail + after);
        const float d_sigma = d_blk * (-dt * density_scale);
        const float sp = raw > 8.f ? 1.f : 1.f / (1.f + expf(-raw));
        float* g = cot + row * GW;
        g[lay.g(2 * L - 1) + D] = d_sigma * sp;
        g[lay.g(2 * L + 1) + 0] = g0 * w * c0 * (1.f - c0);
        g[lay.g(2 * L + 1) + 1] = g1 * w * c1 * (1.f - c1);
        g[lay.g(2 * L + 1) + 2] = g2 * w * c2 * (1.f - c2);
      }
      tail += __shfl_sync(kFull, sfx, 0);
    }
  }
  __syncthreads();  // warp 0's cotangents are visible to the block

  // ---- MLP backward, chunk by chunk ----
  float geo_o = 0.f, geo_d = 0.f;  // this thread's (row, coordinate) partials
  for (int base = 0; base < S; base += kRows) {
    const int rows = min(kRows, S - base);
    const size_t row0 = ray_row + base;
    const unsigned* m0 = masks + (static_cast<size_t>(ray) * n_chunks + base / kRows) * MW;
    float* cot0 = cot + row0 * GW;
    for (int r = tid; r < rows; r += blockDim.x)
      tq[r] = (t_start[row0 + r] + t_end[row0 + r]) / 2.f;
    for (int idx = tid; idx < rows * 3; idx += blockDim.x)
      buf0[(idx / 3) * lda + idx % 3] =
          cde<kBf16>(cot0[(idx / 3) * GW + lay.g(2 * L + 1) + idx % 3]);
    __syncthreads();
    // colour head, C -> 3: masked by the colour hidden layer's ReLU
    dense_bwd<WT, kBf16>(buf0, lda, 3, wt.w[2 * L + 1], C, buf1, lda, cot0 + lay.g(2 * L), GW,
                         m0 + lay.m_c0(), 0, nullptr, 0, false, rows);
    __syncthreads();
    // colour head, [hidden | dir_enc] -> C: the hidden part has no ReLU
    dense_bwd<WT, kBf16>(buf1, lda, C, wt.w[2 * L], D, buf0, lda, cot0 + lay.g(2 * L - 1), GW,
                         nullptr, Q, enc_d, ldq, false, rows);
    // the density column of the last segment layer, from the compositing pass
    for (int r = tid; r < rows; r += blockDim.x)
      buf0[r * lda + D] = cde<kBf16>(cot0[r * GW + lay.g(2 * L - 1) + D]);
    __syncthreads();
    // last segment layer, D -> D + 1
    dense_bwd<WT, kBf16>(buf0, lda, D + 1, wt.w[2 * L - 1], D, buf1, lda,
                         cot0 + lay.g(2 * L - 2), GW, m0 + lay.m_h2(L - 2), 0, nullptr, 0,
                         false, rows);
    __syncthreads();
    float* cur = buf1;
    float* nxt = buf0;
    for (int l = 2 * L - 2; l >= L + 1; --l) {
      dense_bwd<WT, kBf16>(cur, lda, D, wt.w[l], D, nxt, lda, cot0 + lay.g(l - 1), GW,
                           m0 + lay.m_h2(l - 1 - L), 0, nullptr, 0, false, rows);
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    // first layer of segment 2, [z | pos_enc] -> D: the inter-segment ReLU
    dense_bwd<WT, kBf16>(cur, lda, D, wt.w[L], D, nxt, lda, cot0 + lay.g(L - 1), GW,
                         m0 + lay.m_h1(L - 1), P, enc_p, ldp, false, rows);
    __syncthreads();
    { float* t = cur; cur = nxt; nxt = t; }
    for (int l = L - 1; l >= 1; --l) {
      dense_bwd<WT, kBf16>(cur, lda, D, wt.w[l], D, nxt, lda, cot0 + lay.g(l - 1), GW,
                           m0 + lay.m_h1(l - 1), 0, nullptr, 0, false, rows);
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    // first layer, pos_enc -> D
    dense_bwd<WT, kBf16>(cur, lda, D, wt.w[0], 0, nullptr, 0, nullptr, 0, nullptr, P, enc_p,
                         ldp, true, rows);
    __syncthreads();
    // encoding backward: d_origs = sum_s d_pos, d_dirs = sum_s (t_q d_pos + d_dir)
    if (tid < rows * 3) {
      const int r = tid / 3, c = tid % 3;
      const float p = __fadd_rn(o[c], __fmul_rn(tq[r], d[c]));
      const float dp = encode_bwd(p, c, Lp, mask, scale, enc_p + r * ldp);
      const float dd = encode_bwd(d[c], c, Ld, mask + Lp, scale, enc_d + r * ldq);
      geo_o += dp;
      geo_d += tq[r] * dp + dd;
    }
    __syncthreads();  // the next chunk overwrites tq and the buffers
  }
  if (tid < kGradRows) {
    red[tid] = geo_o;
    red[kGradRows + tid] = geo_d;
  }
  __syncthreads();
  if (tid < 3) {
    float so = 0.f, sd = 0.f;
    for (int t = tid; t < kGradRows; t += 3) {
      so += red[t];
      sd += red[kGradRows + t];
    }
    d_origs[ray * 3 + tid] = so;
    d_dirs[ray * 3 + tid] = sd;
  }
}

// ---- phase B: dW = A^T G, db = sum_rows G (train_common.cuh) ----

template <typename AT, bool kBf16>
__global__ void __launch_bounds__(256)
dw_partial_kernel(const AT* __restrict__ act, const float* __restrict__ cot, GemmPlan plan,
                  float* __restrict__ part) {
  __shared__ __align__(16) DwSmem sm;
  dw_tile_stored<kBf16>(act, cot, plan, DwTile(plan), sm, part);
}

GemmPlan make_plan(const Layout& lay, long long rows, int splits) {
  GemmPlan plan(lay.act_width(), lay.cot_width(), rows, splits);
  const int L = lay.L, D = lay.D;
  for (int l = 0; l < 2 * L + 2; ++l) {
    const int n = l < 2 * L - 1 ? D : (l == 2 * L - 1 ? D + 1 : (l == 2 * L ? lay.C : 3));
    if (l == 0) {
      plan.add(0, lay.P, 0, 0, lay.g(l), n);                        // pos_enc
    } else if (l < L) {
      plan.add(lay.h1(l - 1), D, 0, 0, lay.g(l), n);
    } else if (l == L) {
      plan.add(lay.h1(L - 1), D, 0, lay.P, lay.g(l), n);            // [z | pos_enc]
    } else if (l <= 2 * L - 1) {
      plan.add(lay.h2(l - L - 1), D, 0, 0, lay.g(l), n);
    } else if (l == 2 * L) {
      plan.add(lay.hid(), D, lay.P, lay.Q, lay.g(l), n);            // [hidden | dir_enc]
    } else {
      plan.add(lay.c0(), lay.C, 0, 0, lay.g(l), n);
    }
  }
  return plan;
}

template <typename WT, bool kBf16, typename AT>
cudaError_t launch(const float* origs, const float* dirs, const float* t_start,
                   const float* t_end, const float* targets, const Layers& layers,
                   const Transposed& wt, int n_rays, int S, int n_hidden, int D, int C, int Lp,
                   int Ld, float scale, float alpha_pos, float alpha_dir, float density_scale,
                   float grad_scale, void* act, float* cot, float* aux, unsigned* masks,
                   float* part, int splits, float* grads, float* rgb_out, float* d_origs,
                   float* d_dirs, float* weights_out, cudaStream_t stream) {
  const int P = 3 + 6 * Lp, Q = 3 + 6 * Ld;
  const Layout lay{P, Q, D, C, n_hidden + 1};
  const size_t floats = round4(Lp + Ld) + 2 * kGradRows + 2 * kRows +
                        static_cast<size_t>(kRows) *
                            (2 * round4(D + 1) + round4(P) + round4(Q) + 3);
  const size_t bytes = floats * sizeof(float);
  auto kernel = flagship_train_kernel<WT, kBf16, AT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<n_rays, kThreads, bytes, stream>>>(
      origs, dirs, t_start, t_end, targets, layers, wt, S, n_hidden, D, C, Lp, Ld, scale,
      alpha_pos, alpha_dir, density_scale, grad_scale, static_cast<AT*>(act), cot, aux,
      masks, rgb_out, d_origs, d_dirs, weights_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const GemmPlan plan = make_plan(lay, static_cast<long long>(n_rays) * S, splits);
  dim3 grid(plan.tiles, splits);
  dw_partial_kernel<AT, kBf16><<<grid, 256, 0, stream>>>(static_cast<const AT*>(act), cot,
                                                         plan, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Segments all{};
  all.n = 1;
  all.begin[1] = plan.wtot + plan.btot;
  return reduce(part, splits, all, grads, stream);
}

}  // namespace

// Inputs: origs, dirs, targets (n_rays, 3); t_start, t_end (n_rays, S); w_ptrs /
// b_ptrs: the 2 (n_hidden + 1) + 2 layers in the order segment 1, segment 2,
// colour head, weights (in, out) in bf16 when bf16 != 0 else fp32, biases fp32;
// wt_ptrs: the same weights transposed to (out, in). grad_scale = 2 loss_scale /
// (n_rays 3). Workspaces: act (n_rays S, act_width) in the compute type, cot
// (n_rays S, cot_width) fp32, aux (n_rays S, 6) fp32, masks (n_rays
// ceil(S / 32), mask_width) 32-bit words, part (splits, n_grads) fp32, with
// act_width / cot_width / mask_width as `Layout` computes them. Outputs: grads
// (n_grads) = every layer's dW (in, out) in layer order, then every db;
// rgb_out, d_origs, d_dirs (n_rays, 3); weights_out (n_rays, S) or null.
extern "C" int netpu_flagship_train(
    const float* origs, const float* dirs, const float* t_start, const float* t_end,
    const float* targets, const void* const* w_ptrs, const float* const* b_ptrs,
    const void* const* wt_ptrs, int n_layers, int bf16, int n_rays, int S, int n_hidden,
    int D, int C, int Lp, int Ld, float scale, float alpha_pos, float alpha_dir,
    float density_scale, float grad_scale, void* act, float* cot, float* aux, unsigned* masks,
    int act_width, int cot_width, float* part, int splits, float* grads, float* rgb_out,
    float* d_origs,
    float* d_dirs, float* weights_out, void* stream) {
  const Layout lay{3 + 6 * Lp, 3 + 6 * Ld, D, C, n_hidden + 1};
  if (n_hidden < 1 || n_layers != 2 * (n_hidden + 1) + 2 || n_layers > kMaxLayers ||
      act_width != lay.act_width() || cot_width != lay.cot_width() || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  Layers layers;
  Transposed wt;
  for (int i = 0; i < n_layers; ++i) {
    layers.w[i] = w_ptrs[i];
    layers.b[i] = b_ptrs[i];
    wt.w[i] = wt_ptrs[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16, true, __nv_bfloat16>(
                 origs, dirs, t_start, t_end, targets, layers, wt, n_rays, S, n_hidden, D, C,
                 Lp, Ld, scale, alpha_pos, alpha_dir, density_scale, grad_scale, act, cot, aux,
                 masks, part, splits, grads, rgb_out, d_origs, d_dirs, weights_out, st)
           : launch<float, false, float>(
                 origs, dirs, t_start, t_end, targets, layers, wt, n_rays, S, n_hidden, D, C,
                 Lp, Ld, scale, alpha_pos, alpha_dir, density_scale, grad_scale, act, cot, aux,
                 masks, part, splits, grads, rgb_out, d_origs, d_dirs, weights_out, st);
  return static_cast<int>(err);
}
