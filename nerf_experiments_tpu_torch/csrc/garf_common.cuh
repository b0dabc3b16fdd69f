// Device code shared by the GARF radiance kernels: `garf_render.cu` (forward
// only) and `garf_train.cu` (forward + backward). The radiance net has one
// width (`models/garf.py`):
//   linear 0..3  (density 1): 3 -> 1024 -> 256 -> 128 -> 128, an activation after each
//   linear 4..7  (density 2): [z1 | pos] 131 -> 512 -> 256 -> 128 -> 129, activations
//                after 4..6; column 128 of linear 7 is the raw density
//   linear 8..9  (colour):    [ci | dir] 131 -> 256 -> 3, an activation after 8;
//                ci = z1 + z2[:, :128]
// Activation layer i = 0..7 follows linear 0, 1, 2, 3, 4, 5, 6, 8.
// With bf16, every activation is evaluated on the pre-activation rounded to
// bf16: the value the TPU kernel stores for its backward and the one the
// model (`models/garf.py`, bf16 linear outputs) evaluates; the TPU kernel's
// forward evaluates it on the unrounded value. A rounded pre-activation keeps
// forward and backward on the same value; for gabor / sarf at gamma 1 the
// difference is a phase error of up to spread * |x| * 2^-9.
// As in the flagship kernels, one block owns one ray and walks its samples in
// chunks of kRows = 32; a thread owns output columns and keeps 32 row
// accumulators in registers, so one weight load feeds 32 FMAs. The 1024-wide
// layer 0 is never held whole: it is streamed in 32-column tiles straight into
// layer 1's accumulators (3 FMAs and one activation per element), so the
// widest buffer is layer 4's 512 columns. Shared memory per block:
//   P 32 x 512 | Q 32 x 256 | Z 32 x 128 | T 32 x 32 | per-row pos, dir, t, ...
// about 120 KB, one block per SM.
#pragma once

#include "flagship_common.cuh"

namespace netpu {
namespace garf {

constexpr int kLayers = 10;
constexpr int kActs = 8;
constexpr int kTile0 = 32;  // layer-0 columns per streamed tile
constexpr int kLdP = 512, kLdQ = 256, kLdZ = 128, kLdT = kTile0, kLd4 = 4;
constexpr int kSmemFloats = kRows * (kLdP + kLdQ + kLdZ + kLdT + 6 * kLd4) + 4 * kRows;
enum Activation { kGauss = 0, kGabor = 1, kSarf = 2 };

struct Weights {
  const void* w[kLayers];   // (in, out) row-major, fp32 or bf16
  const float* b[kLayers];  // (out,)
  const void* wt[kLayers];  // (out, in) transposed copies (training only)
  const float* p1[kActs];   // per-feature isd (gauss, gabor) or freq (sarf)
  const float* p2[kActs];   // per-feature spread (gabor), else null
};

// Shared-memory carve-up, the same in both kernels.
struct Smem {
  float *P, *Q, *Z, *T, *pos, *dir, *logits, *dpos, *ddir, *aux4, *tq, *dist, *red;
  __device__ explicit Smem(float* s) {
    P = s;                       // 32 x 512
    Q = P + kRows * kLdP;        // 32 x 256
    Z = Q + kRows * kLdQ;        // 32 x 128
    T = Z + kRows * kLdZ;        // 32 x 32
    pos = T + kRows * kLdT;      // 32 x 4: sample positions, rounded like a matmul operand
    dir = pos + kRows * kLd4;    // 32 x 4: the ray direction on every row, rounded
    logits = dir + kRows * kLd4; // 32 x 4
    dpos = logits + kRows * kLd4;  // 32 x 4: d loss / d pos
    ddir = dpos + kRows * kLd4;    // 32 x 4: d loss / d dir, per row
    aux4 = ddir + kRows * kLd4;    // 32 x 4: spare
    tq = aux4 + kRows * kLd4;    // 32
    dist = tq + kRows;           // 32
    red = dist + kRows;          // 2 x 96 (the geometry reduction, training)
  }
};
constexpr int kSmemTotal = kSmemFloats + 2 * 96;

// ---- the activation family (models/garf.py; formulas of the TPU kernels) ----
// Forward from the fp32 pre-activation x: returns the activation and sets the
// two factors the backward reuses (gabor: exp, cos; sarf: exp, cos; unused
// for gauss).
template <int kAct>
__device__ __forceinline__ float act_fwd(float x, float p1, float p2, float gamma, float& f1,
                                         float& f2) {
  if (kAct == kGauss) {
    const float v = p1 * p1 + 1e-6f;
    f1 = f2 = 0.f;
    return expf(-(x * x) * v);
  } else if (kAct == kGabor) {
    const float v = p1 * p1 + 1e-6f;
    f1 = expf(-v * x * x);
    f2 = cosf(p2 * gamma * x);
    return f1 * f2;
  } else {
    const float xs = fabsf(x) + 1e-4f;  // the sign-safe shift; its sign cancels in xs^2
    const float u = xs * xs;
    f1 = expf(-u);
    f2 = cosf(gamma * p1 / (u + 1.f / (p1 * p1)));
    return f2 * f1;
  }
}

// Backward: g is the cotangent of the activation's output, (a, x, f1, f2) the
// stored forward values. Returns the cotangent of x and adds this element's
// share of the parameter gradients to d1 / d2, before their per-feature
// factor (`param_factors`). Gabor and sarf recompute one sin.
template <int kAct>
__device__ __forceinline__ float act_bwd(float g, float a, float x, float f1, float f2,
                                         float p1, float p2, float gamma, float& d1,
                                         float& d2) {
  if (kAct == kGauss) {
    const float v = p1 * p1 + 1e-6f;
    const float ga = g * a;
    d1 += -ga * x * x;
    return ga * (-2.f * v) * x;
  } else if (kAct == kGabor) {
    const float v = p1 * p1 + 1e-6f;
    const float sp = p2 * gamma;
    const float s = sinf(sp * x);
    const float gme = -g * f1;
    d1 += gme * x * x * f2;
    d2 += gme * x * s;
    return gme * (2.f * f2 * v * x + sp * s);
  } else {
    // the TPU train kernel's sign convention: x' = -(x + eps) for x >= 0 (0
    // included), |x| + eps for x < 0; dx'/dx = -1
    const float xs = (x < 0.f ? 1.f : -1.f) * (fabsf(x) + 1e-4f);
    const float u = xs * xs;
    const float f2i = 1.f / (p1 * p1);
    const float denom = u + f2i;
    const float sth = sinf(gamma * p1 / denom);
    const float dd = denom * denom;
    d1 += -g * gamma * sth * (u + 3.f * f2i) / dd * f1;
    return g * (f1 * (gamma * sth * p1 / dd - f2)) * (-2.f * xs);
  }
}

// d(param) = factor * (sum of act_bwd's d1 / d2): gauss and gabor d isd carry
// 2 isd (v = isd^2 + 1e-6), gabor d spread carries gamma, sarf d freq none.
template <int kAct>
__device__ __forceinline__ void param_factors(float p1, float gamma, float& f1, float& f2) {
  f1 = kAct == kSarf ? 1.f : 2.f * p1;
  f2 = gamma;
}

// Stored values per activation layer: a and x, plus the two factors for
// gabor and sarf.
template <int kAct>
__host__ __device__ constexpr int act_record() { return kAct == kGauss ? 2 : 4; }

// Layer 0's pre-activation for column k from one row's position (3 values,
// already rounded like a matmul operand).
template <typename WT>
__device__ __forceinline__ float layer0_x(const float* p, const WT* W0, const float* b0,
                                          int k) {
  float x = p[0] * load_w(W0, k);
  x = fmaf(p[1], load_w(W0, 1024 + k), x);
  x = fmaf(p[2], load_w(W0, 2048 + k), x);
  return x + __ldg(b0 + k);
}

// out[r][j] = act(in1[r] . W[0:K1, j] + in2[r] . W[K1:K1+K2, j] + b[j]), the
// pre-activation and the output rounded to the compute type, for the chunk's
// live rows; with `rec`, also stored to
// the activation workspace: a at rec[r * sld + j], x at + F, and gabor/sarf
// factors at + 2F, + 3F (each in the workspace type). With kAct < 0 there is
// no activation and the output stays fp32 (linear 7 and 9).
template <typename WT, bool kBf16, int kAct, typename AT>
__device__ void act_dense(const float* in1, int ld1, int K1, const float* in2, int ld2, int K2,
                          const void* W_, const float* bias, const float* p1, const float* p2,
                          float gamma, int n_out, float* out, int ldo, int rows, AT* rec,
                          size_t sld) {
  const WT* W = static_cast<const WT*>(W_);
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    accumulate(acc, in1, ld1, K1, W, 0, n_out, j);
    if (K2 > 0) accumulate(acc, in2, ld2, K2, W, K1, n_out, j);
    const float bj = __ldg(bias + j);
    if (kAct < 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) out[r * ldo + j] = acc[r] + bj;
      continue;
    }
    const float q1 = __ldg(p1 + j), q2 = p2 != nullptr ? __ldg(p2 + j) : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const float x = cde<kBf16>(acc[r] + bj);
        float f1, f2;
        const float a = cde<kBf16>(act_fwd<(kAct < 0 ? 0 : kAct)>(x, q1, q2, gamma, f1, f2));
        out[r * ldo + j] = a;
        if (rec != nullptr) {
          AT* p = rec + r * sld + j;
          store_act(p, a);
          store_act(p + n_out, x);
          if (act_record<(kAct < 0 ? 0 : kAct)>() == 4) {
            store_act(p + 2 * n_out, f1);
            store_act(p + 3 * n_out, f2);
          }
        }
      }
    }
  }
}

// Offsets of the per-row activation workspace (training), in elements of the
// workspace type: pos 3, dir 3, then one record per activation layer 1..7 (layer
// 0 is recomputed), then ci 128.
template <int kAct>
struct ActLayout {
  static constexpr int R = act_record<kAct>();
  __host__ __device__ static constexpr int width(int i) {
    return i == 0 ? 1024 : i == 1 ? 256 : i == 2 ? 128 : i == 3 ? 128
         : i == 4 ? 512 : i == 5 ? 256 : i == 6 ? 128 : 256;
  }
  // record of activation layer i (1..7)
  __host__ __device__ static constexpr int rec(int i) {
    int off = 6;
    for (int k = 1; k < i; ++k) off += R * width(k);
    return off;
  }
  __host__ __device__ static constexpr int ci() { return rec(8); }
  __host__ __device__ static constexpr int total() { return ci() + 128; }
};

// Per-row cotangent workspace (fp32, training): the cotangent of linear l's
// output (pre-activation) for l = 1..9, widths 256 128 128 512 256 128 129 256 3.
__host__ __device__ constexpr int gofs(int l) {
  return l == 1 ? 0 : l == 2 ? 256 : l == 3 ? 384 : l == 4 ? 512 : l == 5 ? 1024
       : l == 6 ? 1280 : l == 7 ? 1408 : l == 8 ? 1537 : 1793;
}
constexpr int kCotWidth = 1796;

// Per-ray partials (fp32, training): dW0 (3 x 1024), db0 (1024), then each
// activation layer's parameter gradients [p1 (F) | p2 (F) for gabor].
template <int kAct>
__host__ __device__ constexpr int aofs(int i) {
  int off = 4096;
  for (int k = 0; k < i; ++k) off += (kAct == kGabor ? 2 : 1) * ActLayout<kAct>::width(k);
  return off;
}
template <int kAct>
__host__ __device__ constexpr int ray_part_width() { return aofs<kAct>(kActs); }

// One launch of the train kernel; `netpu_garf_train` (garf_train.cu) documents
// each buffer.
struct TrainArgs {
  const float *origs, *dirs, *t_start, *t_end, *targets;
  Weights W;
  int n_rays, S;
  float gamma, density_scale, grad_scale;
  void* act;
  float *cot, *aux, *ray_part, *part;
  int splits;
  float *grads, *rgb_out, *weights_out, *d_origs, *d_dirs;
  cudaStream_t stream;
};

// The train kernel's launches (phase A, phase B, the reductions) for one
// family, fp32 or bf16: each in its own source, garf_train_<family>.cu, so
// that nvcc compiles the three in parallel.
cudaError_t train_gauss(const TrainArgs& a, bool bf16);
cudaError_t train_gabor(const TrainArgs& a, bool bf16);
cudaError_t train_sarf(const TrainArgs& a, bool bf16);

// The forward of one chunk: positions and directions in S.pos / S.dir (rows
// 0..rows-1, rounded), `rec_base` the chunk's first row of the activation
// workspace (or null). Leaves linear 7's output (fp32, raw density in column
// 128) in Q and the colour logits in S.logits.
template <typename WT, bool kBf16, int kAct, typename AT>
__device__ void forward_chunk(const Weights& W, float gamma, const Smem& S, int rows,
                              AT* rec_base, size_t AW) {
  using Lay = ActLayout<kAct>;
  const int tid = threadIdx.x;
  auto rec = [&](int i) -> AT* { return rec_base ? rec_base + Lay::rec(i) : nullptr; };
  // linear 0 streamed into linear 1: thread `tid` owns column tid of the 256
  {
    const WT* W0 = static_cast<const WT*>(W.w[0]);
    const WT* W1 = static_cast<const WT*>(W.w[1]);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int kt = 0; kt < 1024; kt += kTile0) {
      for (int idx = tid; idx < kRows * kTile0; idx += blockDim.x) {
        const int r = idx / kTile0, k = kt + idx % kTile0;
        float a = 0.f;
        if (r < rows) {
          float f1, f2;
          a = cde<kBf16>(act_fwd<kAct>(cde<kBf16>(layer0_x(S.pos + r * kLd4, W0, W.b[0], k)),
                                       __ldg(W.p1[0] + k),
                                       W.p2[0] != nullptr ? __ldg(W.p2[0] + k) : 0.f, gamma,
                                       f1, f2));
        }
        S.T[idx] = a;
      }
      __syncthreads();
      if (tid < 256) accumulate(acc, S.T, kLdT, kTile0, W1, kt, 256, tid);
      __syncthreads();
    }
    if (tid < 256) {
      const float bj = __ldg(W.b[1] + tid);
      const float q1 = __ldg(W.p1[1] + tid), q2 = W.p2[1] ? __ldg(W.p2[1] + tid) : 0.f;
      AT* r1 = rec(1);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float x = cde<kBf16>(acc[r] + bj);
          float f1, f2;
          const float a = cde<kBf16>(act_fwd<kAct>(x, q1, q2, gamma, f1, f2));
          S.Q[r * kLdQ + tid] = a;
          if (r1 != nullptr) {
            AT* p = r1 + r * AW + tid;
            store_act(p, a);
            store_act(p + 256, x);
            if (Lay::R == 4) {
              store_act(p + 512, f1);
              store_act(p + 768, f2);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  act_dense<WT, kBf16, kAct>(S.Q, kLdQ, 256, nullptr, 0, 0, W.w[2], W.b[2], W.p1[2], W.p2[2],
                             gamma, 128, S.P, kLdP, rows, rec(2), AW);
  __syncthreads();
  act_dense<WT, kBf16, kAct>(S.P, kLdP, 128, nullptr, 0, 0, W.w[3], W.b[3], W.p1[3], W.p2[3],
                             gamma, 128, S.Z, kLdZ, rows, rec(3), AW);  // z1
  __syncthreads();
  act_dense<WT, kBf16, kAct>(S.Z, kLdZ, 128, S.pos, kLd4, 3, W.w[4], W.b[4], W.p1[4],
                             W.p2[4], gamma, 512, S.P, kLdP, rows, rec(4), AW);
  __syncthreads();
  act_dense<WT, kBf16, kAct>(S.P, kLdP, 512, nullptr, 0, 0, W.w[5], W.b[5], W.p1[5], W.p2[5],
                             gamma, 256, S.Q, kLdQ, rows, rec(5), AW);
  __syncthreads();
  act_dense<WT, kBf16, kAct>(S.Q, kLdQ, 256, nullptr, 0, 0, W.w[6], W.b[6], W.p1[6], W.p2[6],
                             gamma, 128, S.P, kLdP, rows, rec(6), AW);
  __syncthreads();
  act_dense<WT, kBf16, -1, AT>(S.P, kLdP, 128, nullptr, 0, 0, W.w[7], W.b[7], nullptr, nullptr,
                               gamma, 129, S.Q, kLdQ, rows, nullptr, 0);  // z2, fp32
  __syncthreads();
  // ci = z1 + z2[:, :128], rounded, into P's first 128 columns
  for (int idx = tid; idx < rows * 128; idx += blockDim.x) {
    const int r = idx / 128, j = idx % 128;
    const float c = cde<kBf16>(S.Z[r * kLdZ + j] + S.Q[r * kLdQ + j]);
    S.P[r * kLdP + j] = c;
    if (rec_base) store_act(rec_base + r * AW + Lay::ci() + j, c);
  }
  __syncthreads();
  // colour hidden layer into P's columns 256..511 (its input is columns 0..127)
  act_dense<WT, kBf16, kAct>(S.P, kLdP, 128, S.dir, kLd4, 3, W.w[8], W.b[8], W.p1[7], W.p2[7],
                             gamma, 256, S.P + 256, kLdP, rows, rec(7), AW);
  __syncthreads();
  act_dense<WT, kBf16, -1, AT>(S.P + 256, kLdP, 256, nullptr, 0, 0, W.w[9], W.b[9], nullptr,
                               nullptr, gamma, 3, S.logits, kLd4, rows, nullptr, 0);
  __syncthreads();
}

// Rows of the chunk: t_q, dists and the rounded positions / directions.
template <bool kBf16>
__device__ void load_chunk(const float* t_start, const float* t_end, size_t row0, int rows,
                           const float (&o)[3], const float (&d)[3], const Smem& S) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float ts = t_start[row0 + r], te = t_end[row0 + r];
    S.tq[r] = (ts + te) / 2.f;
    S.dist[r] = te - ts;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * 3; idx += blockDim.x) {
    const int r = idx / 3, c = idx % 3;
    S.pos[r * kLd4 + c] = r < rows ? cde<kBf16>(__fadd_rn(o[c], __fmul_rn(S.tq[r], d[c]))) : 0.f;
    S.dir[r * kLd4 + c] = cde<kBf16>(d[c]);
  }
  __syncthreads();
}

}  // namespace garf
}  // namespace netpu
