// Device code shared by the GARF radiance kernels: `garf_render.cuh` (K6,
// forward only) and `garf_train.cuh` (K5, forward + backward). The radiance
// net has one width (`models/garf.py`):
//   linear 0..3  (density 1): 3 -> 1024 -> 256 -> 128 -> 128, an activation after each
//   linear 4..7  (density 2): [z1 | pos] 131 -> 512 -> 256 -> 128 -> 129, activations
//                after 4..6; column 128 of linear 7 is the raw density
//   linear 8..9  (colour):    [ci | dir] 131 -> 256 -> 3, an activation after 8;
//                ci = z1 + z2[:, :128]
// Activation layer i = 0..7 follows linear 0, 1, 2, 3, 4, 5, 6, 8. 596,096
// multiply-adds a sample through the ten linears.
// With bf16, every activation is evaluated on the pre-activation rounded to
// bf16: the value the TPU kernel stores for its backward and the one the
// model (`models/garf.py`, bf16 linear outputs) evaluates; the TPU kernel's
// forward evaluates it on the unrounded value. A rounded pre-activation keeps
// forward and backward on the same value; for gabor / sarf at gamma 1 the
// difference is a phase error of up to spread * |x| * 2^-9.
//
// The products run on the tensor cores through `flagship_common.cuh`'s
// `tile_gemm` (mma.sync m16n8k16 bf16, or 3xTF32 m16n8k8 in fp32; weights
// packed in fragment order by the wrapper and streamed from L2 through the
// warps' cp.async rings):
//   * row tile: kR sample rows a block of 8 warps, 64 in bf16 and 32 in fp32
//     (fp32 operands take twice the shared memory, and 3xTF32 keeps them
//     fp32); rays are packed kR / S to a block when S <= kR, else one ray
//     walks ceil(S / kR) tiles, idle rows of a ragged tile never stored;
//   * layer 0 (K = 3) runs on the CUDA cores, streamed: a 64-column chunk of
//     its activation is computed into shared memory while layer 1's product
//     runs over the previous chunk (two chunk buffers, one barrier a chunk),
//     and layer 1's 256 columns (8 warps x 4 n8 tiles, one pass) keep their
//     accumulators in registers across the 16 chunks, so the 1024-wide
//     activation is never held whole;
//   * the [z1 | pos] and [ci | dir] inputs are tile_gemm's two-part A, pos
//     and dir zero-padded to 16 columns; column 128 of linear 7 (the raw
//     density) is a dot product on the CUDA cores, fp32, as the flagship's;
//     ci = z1 + z2 is formed in linear 7's epilogue, in place over z1;
//   * the epilogues apply the family's activation to the accumulator plus
//     bias (`GarfFwdEpi`), rounding pre-activation and output to the compute
//     type, and K5's also store a and x to the activation workspace.
// Shared memory (`GarfSmem`, mirrored by `garf_megakernel.tile_smem_bytes`):
// compute-type tiles P (kR x 512), Q (kR x 256), Z (kR x 128), two layer-0
// chunks (kR x 64), the positions and directions (kR x 16), the warps' weight
// rings, then fp32 per-row arrays: 190,464 bytes in bf16, 195,584 in fp32,
// one block an SM.
#pragma once

#include "flagship_common.cuh"

namespace netpu {
namespace garf {

constexpr int kLayers = 10;
constexpr int kActs = 8;
constexpr int kChunk0 = 64;  // layer-0 columns a streamed chunk
enum Activation { kGauss = 0, kGabor = 1, kSarf = 2 };

// ---- the activation family (models/garf.py; formulas of the TPU kernels) ----

// Forward from the fp32 pre-activation x (p1: isd or freq, p2: spread).
template <int kAct>
__device__ __forceinline__ float act_fwd(float x, float p1, float p2, float gamma) {
  if (kAct == kGauss) {
    const float v = p1 * p1 + 1e-6f;
    return expf(-(x * x) * v);
  } else if (kAct == kGabor) {
    const float v = p1 * p1 + 1e-6f;
    return expf(-v * x * x) * cosf(p2 * gamma * x);
  } else {
    const float xs = fabsf(x) + 1e-4f;  // the sign-safe shift; its sign cancels in xs^2
    const float u = xs * xs;
    return cosf(gamma * p1 / (u + 1.f / (p1 * p1))) * expf(-u);
  }
}

// Backward from the stored (rounded) pre-activation x alone: g is the
// cotangent of the activation's output. The forward's factors are recomputed
// and rounded as the forward rounds them (the TPU kernel stores them rounded;
// its layer 0 recomputes them the same way), and gabor / sarf take the sin
// they need from the same sincosf. Returns the cotangent of x and adds this
// element's share of the parameter gradients to d1 / d2, before their
// per-feature factor (`param_factors`).
template <int kAct, bool kBf16>
__device__ __forceinline__ float act_bwd_x(float g, float x, float p1, float p2, float gamma,
                                           float& d1, float& d2) {
  if (kAct == kGauss) {
    const float v = p1 * p1 + 1e-6f;
    const float ga = g * cde<kBf16>(expf(-(x * x) * v));
    d1 += -ga * x * x;
    return ga * (-2.f * v) * x;
  } else if (kAct == kGabor) {
    const float v = p1 * p1 + 1e-6f;
    const float sp = p2 * gamma;
    float sn, cs;
    sincosf(sp * x, &sn, &cs);
    const float f1 = cde<kBf16>(expf(-v * x * x)), f2 = cde<kBf16>(cs);
    const float gme = -g * f1;
    d1 += gme * x * x * f2;
    d2 += gme * x * sn;
    return gme * (2.f * f2 * v * x + sp * sn);
  } else {
    // the TPU train kernel's sign convention: x' = -(x + eps) for x >= 0 (0
    // included), |x| + eps for x < 0; dx'/dx = -1
    const float xs = (x < 0.f ? 1.f : -1.f) * (fabsf(x) + 1e-4f);
    const float u = xs * xs;
    const float f2i = 1.f / (p1 * p1);
    const float denom = u + f2i;
    float sth, cth;
    sincosf(gamma * p1 / denom, &sth, &cth);
    const float f1 = cde<kBf16>(expf(-u)), f2 = cde<kBf16>(cth);
    const float dd = denom * denom;
    d1 += -g * gamma * sth * (u + 3.f * f2i) / dd * f1;
    return g * (f1 * (gamma * sth * p1 / dd - f2)) * (-2.f * xs);
  }
}

// d(param) = factor * (sum of act_bwd_x's d1 / d2): gauss and gabor d isd carry
// 2 isd (v = isd^2 + 1e-6), gabor d spread carries gamma, sarf d freq none.
template <int kAct>
__device__ __forceinline__ void param_factors(float p1, float gamma, float& f1, float& f2) {
  f1 = kAct == kSarf ? 1.f : 2.f * p1;
  f2 = gamma;
}

// Layer 0's pre-activation for column k from one row's position (3 values,
// already rounded like a matmul operand); W0 (3, 1024) in the compute type.
template <typename WT>
__device__ __forceinline__ float layer0_x(const float* p, const WT* W0, const float* b0,
                                          int k) {
  float x = p[0] * load_w(W0, k);
  x = fmaf(p[1], load_w(W0, 1024 + k), x);
  x = fmaf(p[2], load_w(W0, 2048 + k), x);
  return x + __ldg(b0 + k);
}

// Two neighbouring elements (the accumulator pairs of a fragment row).
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The per-row activation workspace (training), in the compute type: pos 3,
// dir 3, then for activation layers 1..7 (layer 0 is recomputed) the output a
// and the rounded pre-activation x, then ci 128. Every offset is even, so the
// epilogues store pairs.
struct ActLayout {
  __host__ __device__ static constexpr int width(int i) {
    return i == 0 ? 1024 : i == 1 ? 256 : i == 2 ? 128 : i == 3 ? 128
         : i == 4 ? 512 : i == 5 ? 256 : i == 6 ? 128 : 256;
  }
  // a of activation layer i (1..7); its x follows at + width(i)
  __host__ __device__ static constexpr int rec(int i) {
    int off = 6;
    for (int k = 1; k < i; ++k) off += 2 * width(k);
    return off;
  }
  __host__ __device__ static constexpr int ci() { return rec(8); }
  __host__ __device__ static constexpr int total() { return ci() + 128; }
};

// Per-row cotangent workspace (fp32, training): the cotangent of linear l's
// output (pre-activation) for l = 1..9, widths 256 128 128 512 256 128 129 256
// 3; linear 7's block is padded to 130 so that every offset is even.
__host__ __device__ constexpr int gofs(int l) {
  return l == 1 ? 0 : l == 2 ? 256 : l == 3 ? 384 : l == 4 ? 512 : l == 5 ? 1024
       : l == 6 ? 1280 : l == 7 ? 1408 : l == 8 ? 1538 : 1794;
}
constexpr int kCotWidth = 1798;

// Per-block partials (fp32, training): dW0 (3 x 1024), db0 (1024), then each
// activation layer's parameter gradients [p1 (F) | p2 (F) for gabor].
template <int kAct>
__host__ __device__ constexpr int aofs(int i) {
  int off = 4096;
  for (int k = 0; k < i; ++k) off += (kAct == kGabor ? 2 : 1) * ActLayout::width(k);
  return off;
}
template <int kAct>
__host__ __device__ constexpr int block_part_width() { return aofs<kAct>(kActs); }

// The kernels' weights: per linear l = 1..9 the forward product's B (W; for
// linear 7 without its density column) and, for K5, the backward product's B
// (W^T), packed by `garf_megakernel.packed_weights`; fp32 biases; linear 0's
// W (3, 1024) and linear 7's density column W[:, 128] in the compute type;
// the activation layers' per-feature isd (gauss, gabor) or freq (sarf), and
// gabor's spread.
struct GarfWeights {
  const void* fwd[kLayers];
  const void* bwd[kLayers];
  const float* b[kLayers];
  const void* w0;
  const void* w_density;
  const float* p1[kActs];
  const float* p2[kActs];
};

// Shared memory of both kernels for one row tile.
template <bool kBf16>
struct GarfSmem {
  using M = Mma<kBf16>;
  using ET = typename M::ET;
  static constexpr int kR = kBf16 ? 64 : 32;
  // per-ray state: carry, rgb, then opacity, depth (K6) or d_origs, d_dirs (K5)
  static constexpr int kComp = 16;
  static constexpr int ldP = 512 + M::kPad, ldQ = 256 + M::kPad, ldZ = 128 + M::kPad;
  static constexpr int ldT = kChunk0 + M::kPad, ldE = 16 + M::kPad;
  static constexpr size_t kEtBytes =
      (static_cast<size_t>(kR) * (ldP + ldQ + ldZ + 2 * ldT + 2 * ldE) * sizeof(ET) + 15) &
      ~static_cast<size_t>(15);
  static constexpr size_t kRingBytes = static_cast<size_t>(kWarps) * M::kStages * kWarpN * 32 *
                                       sizeof(typename M::Frag);
  // dens, logits (3), tq, dist, dpos (4), ddir (4), geo (6), comp, red (kWarps x 3)
  static constexpr int kFloats = kR * (1 + 3 + 1 + 1 + 4 + 4 + 6 + kComp + kWarps * 3);
  static constexpr size_t kBytes = kEtBytes + kRingBytes + kFloats * sizeof(float);
};

template <bool kBf16>
struct GarfBufs {
  using L = GarfSmem<kBf16>;
  using ET = typename L::ET;
  static constexpr int kR = L::kR;
  ET *P, *Q, *Z, *T0, *T1, *E, *D;  // E: positions, D: directions (3 columns, zero-padded to 16)
  typename Mma<kBf16>::Frag* ring;
  float *dens, *logits, *tq, *dist, *dpos, *ddir, *geo, *comp, *red;
  __device__ explicit GarfBufs(unsigned char* smem) {
    P = reinterpret_cast<ET*>(smem);
    Q = P + kR * L::ldP;
    Z = Q + kR * L::ldQ;
    T0 = Z + kR * L::ldZ;
    T1 = T0 + kR * L::ldT;
    E = T1 + kR * L::ldT;
    D = E + kR * L::ldE;
    ring = reinterpret_cast<typename Mma<kBf16>::Frag*>(smem + L::kEtBytes);
    dens = reinterpret_cast<float*>(smem + L::kEtBytes + L::kRingBytes);
    logits = dens + kR;
    tq = logits + 3 * kR;
    dist = tq + kR;
    dpos = dist + kR;
    ddir = dpos + 4 * kR;
    geo = ddir + 4 * kR;
    comp = geo + 6 * kR;
    red = comp + kR * L::kComp;
  }
  // zero the compute-type tiles (the padding columns of E and D are never
  // written again) and the per-ray state
  __device__ void zero() const {
    const int n = kR * (L::ldP + L::ldQ + L::ldZ + 2 * L::ldT + 2 * L::ldE);
    for (int i = threadIdx.x; i < n; i += blockDim.x) store_act(P + i, 0.f);
    for (int i = threadIdx.x; i < kR * L::kComp; i += blockDim.x) comp[i] = 0.f;
  }
};

// The block's rays: kR / S of them when S <= kR, else one; its tiles walk its
// rows ray after ray.
struct BlockRows {
  int ray0, nr, rows;  // first ray, rays, rows of the block
  size_t row0;         // the block's first sample row
  __device__ BlockRows(int n_rays, int S, int kR) {
    const int rpb = rays_per_block(S, kR);
    ray0 = blockIdx.x * rpb;
    nr = min(rpb, n_rays - ray0);
    rows = nr * S;
    row0 = static_cast<size_t>(ray0) * S;
  }
};

// Rows tb.. of the block (`rows` of them live): t_q, dists and the rounded
// positions and directions into E / D. Ends with __syncthreads.
template <bool kBf16>
__device__ void load_tile(const float* origs, const float* dirs, const float* t_start,
                          const float* t_end, const BlockRows& br, int S, int tb, int rows,
                          const GarfBufs<kBf16>& s) {
  using L = GarfSmem<kBf16>;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float ts = t_start[br.row0 + tb + r], te = t_end[br.row0 + tb + r];
    s.tq[r] = (ts + te) / 2.f;
    s.dist[r] = te - ts;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * 3; idx += blockDim.x) {
    const int r = idx / 3, c = idx % 3;
    const int ray = br.ray0 + (tb + r) / S;
    const float o = __ldg(origs + ray * 3 + c), d = __ldg(dirs + ray * 3 + c);
    store_act(s.E + r * L::ldE + c, cde<kBf16>(__fadd_rn(o, __fmul_rn(s.tq[r], d))));
    store_act(s.D + r * L::ldE + c, cde<kBf16>(d));
  }
  __syncthreads();
}

// Epilogue of a forward layer with an activation: x = rounded(acc + b), a =
// rounded(act(x)) into the next product's input `buf`; with `rec` (K5) a
// and x also go to the workspace row (a at rec[row * AW + col], x at + width)
// for the tile's live rows. For gabor and sarf the epilogues (these and the
// backward ones) are not inlined: the slow paths of cosf / sincosf would be
// copied into every unrolled element of every call site, and nvcc took
// minutes a kernel (gauss: inline). Inlining them with a sin / cos kept to
// its fast path measured no better (PERF.md).
template <bool kBf16, int kAct>
struct GarfFwdEpi {
  using ET = typename Mma<kBf16>::ET;
  ET* buf;
  int ld;
  const float *bias, *p1, *p2;
  float gamma;
  ET* rec;
  size_t AW;
  int width, rows;

  // gabor / sarf out of line (see `GarfFwdEpi`); gauss inline
  template <int kMT>
  __device__ __forceinline__ void operator()(int nt, const float (&c)[kMT][4]) const {
    if constexpr (kAct == kGabor || kAct == kSarf)
      out_of_line(nt, c);
    else
      body(nt, c);
  }
  template <int kMT>
  __device__ __noinline__ void out_of_line(int nt, const float (&c)[kMT][4]) const {
    body(nt, c);
  }
  template <int kMT>
  __device__ __forceinline__ void body(int nt, const float (&c)[kMT][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int col0 = nt * 8 + 2 * t;
    float b[2], q1[2], q2[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      b[p] = __ldg(bias + col0 + p);
      q1[p] = __ldg(p1 + col0 + p);
      q2[p] = kAct == kGabor ? __ldg(p2 + col0 + p) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        float x[2], a[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          x[p] = cde<kBf16>(c[i][2 * h + p] + b[p]);
          a[p] = cde<kBf16>(act_fwd<kAct>(x[p], q1[p], q2[p], gamma));
        }
        store_pair(buf + row * ld + col0, a[0], a[1]);
        if (rec != nullptr && row < rows) {
          store_pair(rec + row * AW + col0, a[0], a[1]);
          store_pair(rec + row * AW + width + col0, x[0], x[1]);
        }
      }
  }
};

// Epilogue of linear 7's 128 z2 columns: ci = rounded(z1 + z2) over z1 in
// `z` (same element, same lane: in place), and with `rec` (K5) to the
// workspace's ci columns.
template <bool kBf16>
struct CiEpi {
  using ET = typename Mma<kBf16>::ET;
  ET* z;
  int ld;
  const float* bias;
  ET* rec;
  size_t AW;
  int rows;

  template <int kMT>
  __device__ void operator()(int nt, const float (&c)[kMT][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int col0 = nt * 8 + 2 * t;
    const float b0 = __ldg(bias + col0), b1 = __ldg(bias + col0 + 1);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        const float2 z1 = load_pair(z + row * ld + col0);
        const float c0 = cde<kBf16>(z1.x + (c[i][2 * h] + b0));
        const float c1 = cde<kBf16>(z1.y + (c[i][2 * h + 1] + b1));
        store_pair(z + row * ld + col0, c0, c1);
        if (rec != nullptr && row < rows) store_pair(rec + row * AW + col0, c0, c1);
      }
  }
};

// Layer 1's product over the streamed layer 0 (see the file note): A chunks
// of kChunk0 columns computed on the CUDA cores into T0 / T1, B = linear 1's
// packed W from the warps' rings, 256 columns in one pass; epi receives each
// warp's 4 n8 tiles at the end. Ends after the last chunk's barrier.
template <bool kBf16, int kAct, typename Epi>
__device__ void layer01(const GarfWeights& w, float gamma, const GarfBufs<kBf16>& s, int rows,
                        const Epi& epi) {
  using M = Mma<kBf16>;
  using F = typename M::Frag;
  using ET = typename M::ET;
  using L = GarfSmem<kBf16>;
  constexpr int kR = L::kR, kMT = kR / 16;
  constexpr int kSteps = 1024 / M::kK, kChunkSteps = kChunk0 / M::kK;
  constexpr int kChunks = 1024 / kChunk0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt0 = warp * kWarpN;
  F* mine = s.ring + warp * M::kStages * kWarpN * 32 + lane;
  const F* pk = static_cast<const F*>(w.fwd[1]) + lane;
  auto issue = [&](int ks) {
    if (ks < kSteps) {
#pragma unroll
      for (int j = 0; j < kWarpN; ++j)
        cp_async(mine + ((ks % M::kStages) * kWarpN + j) * 32,
                 pk + (static_cast<size_t>(nt0 + j) * kSteps + ks) * 32);
    }
    cp_async_commit();
  };
  const ET* W0 = static_cast<const ET*>(w.w0);
  // layer 0's activation of chunk ch into T[ch & 1]: a thread keeps one
  // column and walks the rows; idle rows are 0
  auto fill = [&](int ch) {
    ET* T = ch & 1 ? s.T1 : s.T0;
    const int col = threadIdx.x % kChunk0, k = ch * kChunk0 + col;
    const float q1 = __ldg(w.p1[0] + k), q2 = kAct == kGabor ? __ldg(w.p2[0] + k) : 0.f;
#pragma unroll 2
    for (int r = threadIdx.x / kChunk0; r < kR; r += kThreads / kChunk0) {
      float a = 0.f;
      if (r < rows) {
        const float p[3] = {to_f(s.E[r * L::ldE]), to_f(s.E[r * L::ldE + 1]),
                            to_f(s.E[r * L::ldE + 2])};
        a = cde<kBf16>(act_fwd<kAct>(cde<kBf16>(layer0_x(p, W0, w.b[0], k)), q1, q2, gamma));
      }
      store_act(T + r * L::ldT + col, a);
    }
  };
  // acc: the result; run: fp32's chain over one chunk (see kFlushK)
  float acc[kWarpN][kMT][4], run[kWarpN][kMT][4];
#pragma unroll
  for (int j = 0; j < kWarpN; ++j)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = run[j][i][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < M::kStages - 1; ++ks) issue(ks);
  fill(0);
  __syncthreads();
  for (int ch = 0; ch < kChunks; ++ch) {
    if (ch + 1 < kChunks) fill(ch + 1);  // the other buffer: its readers passed the last barrier
    const ET* T = ch & 1 ? s.T1 : s.T0;
    for (int kc = 0; kc < kChunkSteps; ++kc) {
      const int ks = ch * kChunkSteps + kc;
      issue(ks + M::kStages - 1);
      cp_async_wait<M::kStages - 1>();  // k-step ks has landed
      typename M::B b[kWarpN];
#pragma unroll
      for (int j = 0; j < kWarpN; ++j)
        M::load_b(b[j], mine[((ks % M::kStages) * kWarpN + j) * 32]);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        typename M::A af;
        M::load_a(af, T, L::ldT, 16 * i, kc * M::kK, lane);
#pragma unroll
        for (int j = 0; j < kWarpN; ++j) M::mma(kBf16 ? acc[j][i] : run[j][i], af, b[j]);
      }
    }
    if (!kBf16) {
#pragma unroll
      for (int j = 0; j < kWarpN; ++j)
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[j][i][e] += run[j][i][e];
            run[j][i][e] = 0.f;
          }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kWarpN; ++j) epi(nt0 + j, acc[j]);
}

// The GARF forward chain on one tile whose positions and directions are in E
// / D (`load_tile`). With `act` (K5: the workspace row of the tile's first
// row, row stride AW) every activation layer's a and x and ci are stored for
// the live rows. Leaves the raw density (fp32) in s.dens and the colour
// logits (fp32) in s.logits. Ends with __syncthreads.
template <bool kBf16, int kAct>
__device__ void forward_tile(const GarfWeights& w, float gamma, const GarfBufs<kBf16>& s,
                             int rows, typename Mma<kBf16>::ET* act, size_t AW) {
  using M = Mma<kBf16>;
  using ET = typename M::ET;
  using L = GarfSmem<kBf16>;
  using Lay = ActLayout;
  constexpr int kR = L::kR, kF = kFlushK<kBf16>;
  constexpr int s16 = 16 / M::kK;  // k-steps of a 16-column part
  auto epi = [&](ET* out, int ld, int i, int width) {
    return GarfFwdEpi<kBf16, kAct>{out, ld, w.b[i < 7 ? i : 8], w.p1[i], w.p2[i], gamma,
                                   act != nullptr ? act + Lay::rec(i) : nullptr, AW, width,
                                   rows};
  };
  layer01<kBf16, kAct>(w, gamma, s, rows, epi(s.Q, L::ldQ, 1, 256));
  __syncthreads();
  tile_gemm<kBf16, kR, kF>(s.Q, L::ldQ, 256 / M::kK, nullptr, 0, 0, w.fwd[2], s.ring, 128 / 8,
                       epi(s.P, L::ldP, 2, 128));
  __syncthreads();
  tile_gemm<kBf16, kR, kF>(s.P, L::ldP, 128 / M::kK, nullptr, 0, 0, w.fwd[3], s.ring, 128 / 8,
                       epi(s.Z, L::ldZ, 3, 128));  // z1
  __syncthreads();
  tile_gemm<kBf16, kR, kF>(s.Z, L::ldZ, 128 / M::kK, s.E, L::ldE, s16, w.fwd[4], s.ring, 512 / 8,
                       epi(s.P, L::ldP, 4, 512));
  __syncthreads();
  tile_gemm<kBf16, kR, kF>(s.P, L::ldP, 512 / M::kK, nullptr, 0, 0, w.fwd[5], s.ring, 256 / 8,
                       epi(s.Q, L::ldQ, 5, 256));
  __syncthreads();
  tile_gemm<kBf16, kR, kF>(s.Q, L::ldQ, 256 / M::kK, nullptr, 0, 0, w.fwd[6], s.ring, 128 / 8,
                       epi(s.P, L::ldP, 6, 128));
  __syncthreads();
  // linear 7: z2 on the tensor cores into ci (over z1) ...
  tile_gemm<kBf16, kR, kF>(s.P, L::ldP, 128 / M::kK, nullptr, 0, 0, w.fwd[7], s.ring, 128 / 8,
                       CiEpi<kBf16>{s.Z, L::ldZ, w.b[7],
                                    act != nullptr ? act + Lay::ci() : nullptr, AW, rows});
  {  // ... and the density column on the CUDA cores, kTpr threads a row
    constexpr int kTpr = kThreads / kR;
    const int r = threadIdx.x / kTpr, q = threadIdx.x % kTpr;
    const ET* wd = static_cast<const ET*>(w.w_density);
    float acc = 0.f;
    for (int k = q; k < 128; k += kTpr) acc = fmaf(to_f(s.P[r * L::ldP + k]), to_f(wd[k]), acc);
#pragma unroll
    for (int off = 1; off < kTpr; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (q == 0) s.dens[r] = acc + __ldg(w.b[7] + 128);
  }
  __syncthreads();
  // colour hidden layer, [ci | dir] -> 256, activation layer 7
  tile_gemm<kBf16, kR, kF>(s.Z, L::ldZ, 128 / M::kK, s.D, L::ldE, s16, w.fwd[8], s.ring, 256 / 8,
                       epi(s.Q, L::ldQ, 7, 256));
  __syncthreads();
  tile_gemm<kBf16, kR, kF>(s.Q, L::ldQ, 256 / M::kK, nullptr, 0, 0, w.fwd[9], s.ring, 2,
                       LogitEpi{s.logits, w.b[9]});
  __syncthreads();
}

// The train and render kernels' entry points dispatch per activation
// family; each family's kernels are compiled in their own source
// (garf_render_<family>.cu, garf_train_<family>.cu), so nvcc builds them in
// parallel.
struct RenderArgs {
  const float *origs, *dirs, *t_start, *t_end;
  GarfWeights W;
  int n_rays, S;
  float gamma, density_scale;
  float* out;
  cudaStream_t stream;
};
cudaError_t render_gauss(const RenderArgs& a, bool bf16);
cudaError_t render_gabor(const RenderArgs& a, bool bf16);
cudaError_t render_sarf(const RenderArgs& a, bool bf16);

struct TrainArgs {
  const float *origs, *dirs, *t_start, *t_end, *targets;
  GarfWeights W;
  int n_rays, S;
  float gamma, density_scale, grad_scale;
  void* act;
  float *cot, *aux, *block_part, *part;
  int splits;
  float *grads, *rgb_out, *weights_out, *d_origs, *d_dirs;
  cudaStream_t stream;
};
cudaError_t train_gauss(const TrainArgs& a, bool bf16);
cudaError_t train_gabor(const TrainArgs& a, bool bf16);
cudaError_t train_sarf(const TrainArgs& a, bool bf16);

}  // namespace garf
}  // namespace netpu
