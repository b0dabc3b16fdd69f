// Training step of the GARF / GaborF / SARF radiance field for one NVIDIA
// H100: rays + t-bins + targets -> rgb, the compositing weights, the gradient
// of loss = mean((rgb - target)^2) (over n_rays * 3) with respect to every
// weight, bias and activation parameter (fp32), and d_origs / d_dirs.
//
// Replaces the TPU kernel `nerf_experiments_tpu/ops/garf_megakernel.py:_kernel`
// (Pallas, entry `garf_radiance_train_grads`). Forward as in `garf_render.cu`,
// then the MSE gradient, the compositing backward and the backward of the net,
// activation parameters (isd, spread, freq) included.
//
// What bounds it on the H100: arithmetic (~3x the forward's 0.6 M
// multiply-adds per sample) and the workspace. The TPU keeps a 768-row tile in
// ~26 MB of VMEM from forward through backward; a Hopper block has 227 KB. So,
// as in `flagship_train.cu`:
//   * phase A, one block per ray in 32-row chunks (`garf_common.cuh`): the
//     forward stores each activation layer's output a and pre-activation x
//     (gabor / sarf also their exp and cos factors) to a device workspace in
//     the compute type; the 1024-wide layer 0 is not stored but recomputed
//     from the position, as the TPU does. Warp 0 composites with a shuffle
//     scan, then walks the chunks back to front for the compositing backward
//     (reverse scan, suffix carried from the end of the ray, the TPU's `ut`
//     matmul). The chunks are walked again and the row cotangents carried back
//     layer by layer (g <- act_bwd((g W^T)), W^T passed transposed so the loads
//     coalesce) and stored fp32 for phase B. Each thread owns a column, so it
//     also sums that column's activation-parameter gradients over the chunk;
//     those, and layer 0's dW / db, go to the ray's own slice of a partials
//     buffer (written by this block only, chunk by chunk in order). d_origs /
//     d_dirs are summed per ray in a fixed order;
//   * phase B (`train_common.cuh`): dW = A^T G and db = sum G for linear
//     layers 1..9, a tiled GEMM over the rows on the CUDA cores (layer 1's
//     input, the 1024-wide layer-0 activation, recomputed while loading its
//     tiles), split over the rows into fixed partials;
//   * two reductions add the row splits and the rays' partials in a fixed
//     order. No atomics: two launches give bitwise-equal gradients.
// With bf16, matmul operands (weights, activations, cotangents) are rounded to
// bf16 and products accumulate in fp32 where the TPU kernel rounds (`cde`);
// the stored tuple is bf16 as the TPU stores it; bias and activation-parameter
// gradients sum fp32 values.
// This is the simple design: FMA loops on the CUDA cores, one block per SM.
//
// The kernels are templates over the weight type, the activation family and
// the workspace type; each family's source (garf_train_<family>.cu) includes
// this header and instantiates its own, and `garf_train.cu` holds the entry
// point.
#pragma once

#include "garf_common.cuh"
#include "train_common.cuh"

namespace netpu {
namespace garf {
namespace {

constexpr int kAux = 6;        // per-row compositing record: raw density, rgb, T, w
constexpr int kGradRows = 96;  // threads holding a (row, coordinate) geometry partial

// Backward through one linear layer for the chunk's rows, then through the
// activation before it: t[r][k] = sum_n g[r][n] Wt[n][k] for k < K1 + K2 (Wt
// the (n_in, K1 + K2) transposed weight). Outputs k < K1: add1[r][k] is added
// when given, then (kAct >= 0) the activation backward with the stored record
// `rec` (width K1); the result, the cotangent of the previous layer's output,
// is stored fp32 to glob, rounded into dst1 and, with raw1, copied fp32 there.
// The chunk's sums of the activation-parameter gradients go to part1 / part2
// (set on the first chunk, added after). Outputs k >= K1 are written to dst2.
template <typename WT, bool kBf16, int kAct, typename AT>
__device__ void bwd_dense(const float* g, int ldg, int n_in, const void* Wt_, int K1, int K2,
                          const float* add1, int ld_add, const AT* rec, size_t AW,
                          const float* p1, const float* p2, float gamma, float* glob,
                          size_t GW, float* dst1, int ld1, float* raw1, int ld_raw,
                          float* part1, float* part2, bool first, float* dst2, int ld2,
                          int rows) {
  const WT* Wt = static_cast<const WT*>(Wt_);
  const int K = K1 + K2;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    accumulate(acc, g, ldg, n_in, Wt, 0, K, k);
    if (k >= K1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) dst2[r * ld2 + (k - K1)] = acc[r];
      continue;
    }
    float q1 = 0.f, q2 = 0.f, s1 = 0.f, s2 = 0.f;
    if constexpr (kAct >= 0) {
      q1 = __ldg(p1 + k);
      q2 = p2 != nullptr ? __ldg(p2 + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        float v = acc[r];
        if (add1 != nullptr) v += add1[r * ld_add + k];
        if constexpr (kAct >= 0) {
          const AT* e = rec + r * AW + k;
          const bool four = act_record<kAct>() == 4;
          v = act_bwd<kAct>(v, load_act(e), load_act(e + K1), four ? load_act(e + 2 * K1) : 0.f,
                            four ? load_act(e + 3 * K1) : 0.f, q1, q2, gamma, s1, s2);
        }
        glob[r * GW + k] = v;
        dst1[r * ld1 + k] = cde<kBf16>(v);
        if (raw1 != nullptr) raw1[r * ld_raw + k] = v;
      }
    }
    if constexpr (kAct >= 0) {
      float fa, fb;
      param_factors<kAct>(q1, gamma, fa, fb);
      part1[k] = first ? fa * s1 : part1[k] + fa * s1;
      if (part2 != nullptr) part2[k] = first ? fb * s2 : part2[k] + fb * s2;
    }
  }
}

// Backward through linear 1 into layer 0 (its 1024 outputs recomputed from the
// positions, never stored), in four passes of 256 columns, with layer 0's dW,
// db and activation-parameter sums into the ray's partials and its position
// cotangent added to S.dpos. The cotangent of linear 1 is in Q.
template <typename WT, bool kBf16, int kAct>
__device__ void bwd_layer0(const Weights& W, float gamma, const Smem& S, int rows,
                           float* part, bool first) {
  const WT* W0 = static_cast<const WT*>(W.w[0]);
  const WT* W1t = static_cast<const WT*>(W.wt[1]);  // (256, 1024)
  const int tid = threadIdx.x;
  float* G = S.P;  // 32 x 256 rounded cotangents of layer 0's output
  for (int pass = 0; pass < 4; ++pass) {
    const int k = pass * 256 + tid;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    accumulate(acc, S.Q, kLdQ, 256, W1t, 0, 1024, k);
    const float q1 = __ldg(W.p1[0] + k), q2 = W.p2[0] != nullptr ? __ldg(W.p2[0] + k) : 0.f;
    float s1 = 0.f, s2 = 0.f, dw0 = 0.f, dw1 = 0.f, dw2 = 0.f, db = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float gr = 0.f;
      if (r < rows) {
        const float* p = S.pos + r * kLd4;
        // the forward's pre-activation (rounded), activation and factors
        const float x = cde<kBf16>(layer0_x(p, W0, W.b[0], k));
        float f1, f2;
        const float a = cde<kBf16>(act_fwd<kAct>(x, q1, q2, gamma, f1, f2));
        const float gx = act_bwd<kAct>(acc[r], a, x, cde<kBf16>(f1), cde<kBf16>(f2), q1, q2,
                                       gamma, s1, s2);
        db += gx;
        gr = cde<kBf16>(gx);
        dw0 = fmaf(p[0], gr, dw0);
        dw1 = fmaf(p[1], gr, dw1);
        dw2 = fmaf(p[2], gr, dw2);
      }
      G[r * 256 + tid] = gr;
    }
    float fa, fb;
    param_factors<kAct>(q1, gamma, fa, fb);
    float* pw = part;  // dW0 (3 x 1024) | db0 (1024) | act 0 params
    if (first) {
      pw[k] = dw0;
      pw[1024 + k] = dw1;
      pw[2048 + k] = dw2;
      pw[3072 + k] = db;
      pw[4096 + k] = fa * s1;
      if (kAct == kGabor) pw[5120 + k] = fb * s2;
    } else {
      pw[k] += dw0;
      pw[1024 + k] += dw1;
      pw[2048 + k] += dw2;
      pw[3072 + k] += db;
      pw[4096 + k] += fa * s1;
      if (kAct == kGabor) pw[5120 + k] += fb * s2;
    }
    __syncthreads();
    if (tid < rows * 3) {  // d pos += g_x0 W0^T over this pass's 256 columns
      const int r = tid / 3, c = tid % 3;
      float s = 0.f;
      for (int kk = 0; kk < 256; ++kk)
        s = fmaf(G[r * 256 + kk], load_w(W0, c * 1024 + pass * 256 + kk), s);
      S.dpos[r * kLd4 + c] += s;
    }
    __syncthreads();
  }
}

template <typename WT, bool kBf16, int kAct, typename AT>
__global__ void __launch_bounds__(kThreads, 1)
garf_train_kernel(const float* __restrict__ origs, const float* __restrict__ dirs,
                  const float* __restrict__ t_start, const float* __restrict__ t_end,
                  const float* __restrict__ targets, Weights W, int S_, float gamma,
                  float density_scale, float grad_scale, AT* act, float* cot, float* aux,
                  float* ray_part, float* __restrict__ rgb_out,
                  float* __restrict__ weights_out, float* __restrict__ d_origs,
                  float* __restrict__ d_dirs) {
  extern __shared__ __align__(16) float smem[];
  const Smem S(smem);
  using Lay = ActLayout<kAct>;
  const size_t AW = Lay::total(), GW = kCotWidth;
  const int ray = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ray_row = static_cast<size_t>(ray) * S_;
  float* part = ray_part + static_cast<size_t>(ray) * ray_part_width<kAct>();
  auto part1 = [&](int i) { return part + aofs<kAct>(i); };
  auto part2 = [&](int i) {
    return kAct == kGabor ? part + aofs<kAct>(i) + Lay::width(i) : nullptr;
  };
  float o[3], d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = __ldg(origs + ray * 3 + c);
    d[c] = __ldg(dirs + ray * 3 + c);
  }

  // ---- forward, chunk by chunk; compositing state lives in warp 0 ----
  float carry = 0.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  for (int base = 0; base < S_; base += kRows) {
    const int rows = min(kRows, S_ - base);
    const size_t row0 = ray_row + base;
    AT* rb = act + row0 * AW;
    load_chunk<kBf16>(t_start, t_end, row0, rows, o, d, S);
    for (int idx = tid; idx < rows * 3; idx += blockDim.x) {
      const int r = idx / 3, c = idx % 3;
      store_act(rb + r * AW + c, S.pos[r * kLd4 + c]);
      store_act(rb + r * AW + 3 + c, S.dir[r * kLd4 + c]);
    }
    forward_chunk<WT, kBf16, kAct, AT>(W, gamma, S, rows, rb, AW);
    if (warp == 0) {
      float raw = 0.f, blk = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
      if (lane < rows) {
        raw = S.Q[lane * kLdQ + 128];
        blk = -softplus8(raw - 1.f) * S.dist[lane] * density_scale;
        c0 = 1.f / (1.f + expf(-S.logits[lane * kLd4 + 0]));
        c1 = 1.f / (1.f + expf(-S.logits[lane * kLd4 + 1]));
        c2 = 1.f / (1.f + expf(-S.logits[lane * kLd4 + 2]));
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
        weights_out[row0 + lane] = w;
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncthreads();  // the next chunk overwrites the buffers
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
    for (int base = ((S_ - 1) / kRows) * kRows; base >= 0; base -= kRows) {
      const int i = base + lane;
      const bool live = i < S_;
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
        const float z = raw - 1.f;
        const float blk = -softplus8(z) * dt * density_scale;
        const float d_blk = -gw * T * expf(blk) + (tail + after);
        const float d_sigma = d_blk * (-dt * density_scale);
        const float sp = z > 8.f ? 1.f : 1.f / (1.f + expf(-z));
        float* g = cot + row * GW;
        g[gofs(7) + 128] = d_sigma * sp;
        g[gofs(9) + 0] = g0 * w * c0 * (1.f - c0);
        g[gofs(9) + 1] = g1 * w * c1 * (1.f - c1);
        g[gofs(9) + 2] = g2 * w * c2 * (1.f - c2);
      }
      tail += __shfl_sync(kFull, sfx, 0);
    }
  }
  __syncthreads();  // warp 0's cotangents are visible to the block

  // ---- the net's backward, chunk by chunk ----
  float geo_o = 0.f, geo_d = 0.f;  // this thread's (row, coordinate) partials
  for (int base = 0; base < S_; base += kRows) {
    const int rows = min(kRows, S_ - base);
    const size_t row0 = ray_row + base;
    const bool first = base == 0;
    const AT* rb = act + row0 * AW;
    float* cb = cot + row0 * GW;
    load_chunk<kBf16>(t_start, t_end, row0, rows, o, d, S);
    for (int idx = tid; idx < kRows * 3; idx += blockDim.x) {
      const int r = idx / 3, c = idx % 3;
      S.logits[r * kLd4 + c] = r < rows ? cde<kBf16>(cb[r * GW + gofs(9) + c]) : 0.f;
    }
    __syncthreads();
    // colour head 256 -> 3, through the colour activation (layer 7)
    bwd_dense<WT, kBf16, kAct, AT>(S.logits, kLd4, 3, W.wt[9], 256, 0, nullptr, 0,
                                   rb + Lay::rec(7), AW, W.p1[7], W.p2[7], gamma,
                                   cb + gofs(8), GW, S.P, kLdP, nullptr, 0, part1(7), part2(7),
                                   first, nullptr, 0, rows);
    __syncthreads();
    // colour input [ci | dir]: the ci part is the cotangent of z2[:, :128]
    // (rounded into Q for the next matmul, fp32 into Z for z1's skip); the dir
    // part goes to S.ddir
    bwd_dense<WT, kBf16, -1, AT>(S.P, kLdP, 256, W.wt[8], 128, 3, nullptr, 0, nullptr, AW,
                                 nullptr, nullptr, gamma, cb + gofs(7), GW, S.Q, kLdQ, S.Z,
                                 kLdZ, nullptr, nullptr, first, S.ddir, kLd4, rows);
    for (int r = tid; r < rows; r += blockDim.x)
      S.Q[r * kLdQ + 128] = cde<kBf16>(cb[r * GW + gofs(7) + 128]);  // the density column
    __syncthreads();
    bwd_dense<WT, kBf16, kAct, AT>(S.Q, kLdQ, 129, W.wt[7], 128, 0, nullptr, 0,
                                   rb + Lay::rec(6), AW, W.p1[6], W.p2[6], gamma,
                                   cb + gofs(6), GW, S.P, kLdP, nullptr, 0, part1(6), part2(6),
                                   first, nullptr, 0, rows);
    __syncthreads();
    bwd_dense<WT, kBf16, kAct, AT>(S.P, kLdP, 128, W.wt[6], 256, 0, nullptr, 0,
                                   rb + Lay::rec(5), AW, W.p1[5], W.p2[5], gamma,
                                   cb + gofs(5), GW, S.Q, kLdQ, nullptr, 0, part1(5), part2(5),
                                   first, nullptr, 0, rows);
    __syncthreads();
    bwd_dense<WT, kBf16, kAct, AT>(S.Q, kLdQ, 256, W.wt[5], 512, 0, nullptr, 0,
                                   rb + Lay::rec(4), AW, W.p1[4], W.p2[4], gamma,
                                   cb + gofs(4), GW, S.P, kLdP, nullptr, 0, part1(4), part2(4),
                                   first, nullptr, 0, rows);
    __syncthreads();
    // density-2 input [z1 | pos]: z1 also feeds the colour input (+ g_ci), then
    // through z1's activation (layer 3); the pos part goes to S.dpos
    bwd_dense<WT, kBf16, kAct, AT>(S.P, kLdP, 512, W.wt[4], 128, 3, S.Z, kLdZ,
                                   rb + Lay::rec(3), AW, W.p1[3], W.p2[3], gamma,
                                   cb + gofs(3), GW, S.Q, kLdQ, nullptr, 0, part1(3), part2(3),
                                   first, S.dpos, kLd4, rows);
    __syncthreads();
    bwd_dense<WT, kBf16, kAct, AT>(S.Q, kLdQ, 128, W.wt[3], 128, 0, nullptr, 0,
                                   rb + Lay::rec(2), AW, W.p1[2], W.p2[2], gamma,
                                   cb + gofs(2), GW, S.P, kLdP, nullptr, 0, part1(2), part2(2),
                                   first, nullptr, 0, rows);
    __syncthreads();
    bwd_dense<WT, kBf16, kAct, AT>(S.P, kLdP, 128, W.wt[2], 256, 0, nullptr, 0,
                                   rb + Lay::rec(1), AW, W.p1[1], W.p2[1], gamma,
                                   cb + gofs(1), GW, S.Q, kLdQ, nullptr, 0, part1(1), part2(1),
                                   first, nullptr, 0, rows);
    __syncthreads();
    bwd_layer0<WT, kBf16, kAct>(W, gamma, S, rows, part, first);
    // d_origs = sum_s d_pos, d_dirs = sum_s (t_q d_pos + d_dir)
    if (tid < rows * 3) {
      const int r = tid / 3, c = tid % 3;
      const float dp = S.dpos[r * kLd4 + c];
      geo_o += dp;
      geo_d += S.tq[r] * dp + S.ddir[r * kLd4 + c];
    }
    __syncthreads();  // the next chunk overwrites the buffers
  }
  if (tid < kGradRows) {
    S.red[tid] = geo_o;
    S.red[kGradRows + tid] = geo_d;
  }
  __syncthreads();
  if (tid < 3) {
    float so = 0.f, sd = 0.f;
    for (int t = tid; t < kGradRows; t += 3) {
      so += S.red[t];
      sd += S.red[kGradRows + t];
    }
    d_origs[ray * 3 + tid] = so;
    d_dirs[ray * 3 + tid] = sd;
  }
}

// ---- phase B: dW = A^T G, db = sum_rows G for linear layers 1..9 ----

// Linear 1's input is layer 0's activation, recomputed from the stored
// position while loading the tile; the other layers' inputs are stored.
template <typename WT, typename AT, bool kBf16, int kAct>
__global__ void __launch_bounds__(256)
dw_partial_kernel(const AT* __restrict__ act, const float* __restrict__ cot, GemmPlan plan,
                  Weights W, float gamma, float* __restrict__ part) {
  __shared__ __align__(16) DwSmem sm;
  const DwTile t(plan);
  if (t.li != 0) {
    dw_tile_stored<kBf16>(act, cot, plan, t, sm, part);
    return;
  }
  const int ka = t.k0 + static_cast<int>(threadIdx.x) % kTile;
  const bool live_k = ka < 1024;
  const WT* W0 = static_cast<const WT*>(W.w[0]);
  const float q1 = live_k ? __ldg(W.p1[0] + ka) : 0.f;
  const float q2 = live_k && W.p2[0] != nullptr ? __ldg(W.p2[0] + ka) : 0.f;
  dw_tile<kBf16>(
      plan, t, cot,
      [&](long long row) {
        if (!live_k) return 0.f;
        const AT* pr = act + row * plan.AW;
        const float p[3] = {load_act(pr), load_act(pr + 1), load_act(pr + 2)};
        float f1, f2;
        return cde<kBf16>(
            act_fwd<kAct>(cde<kBf16>(layer0_x(p, W0, W.b[0], ka)), q1, q2, gamma, f1, f2));
      },
      sm, part);
}

__host__ __device__ constexpr int lin_in(int l) {
  return l == 0 ? 3 : l == 1 ? 1024 : l == 2 ? 256 : l == 3 ? 128 : l == 4 ? 131
       : l == 5 ? 512 : l == 6 ? 256 : l == 7 ? 128 : l == 8 ? 131 : 256;
}
__host__ __device__ constexpr int lin_out(int l) {
  return l == 0 ? 1024 : l == 1 ? 256 : l == 2 ? 128 : l == 3 ? 128 : l == 4 ? 512
       : l == 5 ? 256 : l == 6 ? 128 : l == 7 ? 129 : l == 8 ? 256 : 3;
}

template <int kAct>
GemmPlan make_plan(long long rows, int splits) {
  using Lay = ActLayout<kAct>;
  GemmPlan plan(Lay::total(), kCotWidth, rows, splits);
  for (int l = 1; l < kLayers; ++l) {
    if (l == 4) {
      plan.add(Lay::rec(3), 128, 0, 3, gofs(l), lin_out(l));         // [z1 | pos]
    } else if (l == 8) {
      plan.add(Lay::ci(), 128, 3, 3, gofs(l), lin_out(l));           // [ci | dir]
    } else {
      // linear l's input is the output a of the activation after linear l - 1
      // (activation layer 7 for linear 9), the first block of its record;
      // linear 1's is recomputed, so its column 0 is unused
      const int a1 = l == 1 ? 0 : l == 9 ? Lay::rec(7) : Lay::rec(l - 1);
      plan.add(a1, lin_in(l), 0, 0, gofs(l), lin_out(l));
    }
  }
  return plan;
}

constexpr int kW0 = 3 * 1024;  // layer 0's dW

template <typename WT, bool kBf16, int kAct, typename AT>
cudaError_t launch(const TrainArgs& a) {
  const int bytes = kSmemTotal * static_cast<int>(sizeof(float));
  auto kernel = garf_train_kernel<WT, kBf16, kAct, AT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<a.n_rays, kThreads, bytes, a.stream>>>(
      a.origs, a.dirs, a.t_start, a.t_end, a.targets, a.W, a.S, a.gamma, a.density_scale,
      a.grad_scale, static_cast<AT*>(a.act), a.cot, a.aux, a.ray_part, a.rgb_out,
      a.weights_out, a.d_origs, a.d_dirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const GemmPlan plan = make_plan<kAct>(static_cast<long long>(a.n_rays) * a.S, a.splits);
  dim3 grid(plan.tiles, a.splits);
  dw_partial_kernel<WT, AT, kBf16, kAct><<<grid, 256, 0, a.stream>>>(
      static_cast<const AT*>(a.act), a.cot, plan, a.W, a.gamma, a.part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the flat output: every dW (in, out) in layer order, every db, then the
  // activation parameters as the ray partials hold them
  const long long wtot = kW0 + plan.wtot, btot = 1024 + plan.btot;
  Segments by_split{};  // phase B: layers 1..9
  by_split.n = 2;
  by_split.begin[1] = plan.wtot;
  by_split.begin[2] = plan.wtot + plan.btot;
  by_split.dst[0] = kW0;
  by_split.dst[1] = wtot + 1024;
  err = reduce(a.part, a.splits, by_split, a.grads, a.stream);
  if (err != cudaSuccess) return err;
  Segments by_ray{};  // layer 0's dW and db, every activation parameter
  by_ray.n = 3;
  by_ray.begin[1] = kW0;
  by_ray.begin[2] = kW0 + 1024;
  by_ray.begin[3] = ray_part_width<kAct>();
  by_ray.dst[1] = wtot;
  by_ray.dst[2] = wtot + btot;
  return reduce(a.ray_part, a.n_rays, by_ray, a.grads, a.stream);
}

template <int kAct>
cudaError_t train_family(const TrainArgs& a, bool bf16) {
  return bf16 ? launch<__nv_bfloat16, true, kAct, __nv_bfloat16>(a)
              : launch<float, false, kAct, float>(a);
}

}  // namespace
}  // namespace garf
}  // namespace netpu
