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
// What bounds it on the H100: arithmetic, three times the forward's 658,944
// multiply-adds a sample (forward, g W^T, A^T G): 4.15 TFLOP at 8192 x 128,
// 4.19 ms at the bf16 tensor-core rate, 61.9 ms at fp32's 67 TFLOP/s on the
// CUDA cores; then the activation workspace. The TPU keeps a 1024-row tile's
// activations in ~24 MB of VMEM from forward through backward; one flagship
// sample row stores 2,778 activations and 2,698 cotangents (16.3 KB a row in
// bf16) and a Hopper block has at most 227 KB. So the work is split in two
// phases, on a row tile in both compute types; the compute type picks the
// forward's route.
//
// The tile (`flagship_train_kernel<kBf16, kR>`), both compute types:
//   * phase A, a block of kR / S rays (S <= kR) or one ray, walking kR-row
//     tiles (`flagship_common.cuh`; kR = 64, or 32 where a 64-row tile's
//     block would pass 227 KB: the wrapper picks, `train_megakernel.tile_rows`;
//     any hidden / colour width runs padded to 16 on the tensor cores, the
//     workspace keeping the true widths): the forward writes every layer's
//     output to the workspace in the compute type and each ReLU layer's mask,
//     taken from the stored value (so exact), as one 32-bit word per (32-row
//     part of the tile, column), so the backward reads kR / 32 words a column
//     and not the activations; one warp a ray composites with a shuffle scan,
//     and after the last tile runs the compositing backward as a reverse scan
//     with the suffix sum carried from the end of the ray; the tiles are then
//     walked again and the row cotangents go back layer by layer, g <- (g
//     W^T) * mask on the tensor cores (`tile_gemm`, B = W^T packed by the
//     wrapper), each stored fp32 to the workspace; the encoding backward gives
//     d_pos / d_dirs, summed per ray in a fixed order;
//   * bf16: the forward on the tensor cores too (`forward_tile`: mma.sync
//     m16n8k16, weights streamed from L2 through per-warp cp.async rings).
//     Matmul operands (weights, activations, cotangents) are bf16 and
//     products accumulate in fp32, rounding where the TPU kernel rounds
//     (`cde`); the bias gradients sum the fp32 cotangents, as the TPU kernel
//     does, so the workspace keeps them fp32 (bf16 cotangents with db summed
//     in phase A halve their bytes; one development trial of that made phase
//     B slower, PERF.md section 7);
//   * fp32: the forward runs register-tiled on the CUDA cores (`fma_layer` of
//     `fma_tile.cuh`: a thread owns R rows x 8 columns, W staged into shared
//     memory by cp.async) and adds every output as a plain fp32 GEMM adds it:
//     k = 0, 1, ... of the first input, then of the second, then the bias (the
//     density column and the logits one thread a (row, column), `narrow`), so
//     each ReLU is decided as the plain version decides it. The forward
//     stays off the tensor cores: 3xTF32 products carry ~2^-21 relative error
//     against fp32's 2^-24, enough to flip the ReLU of a few units whose
//     pre-activation is within that of 0, and one flipped unit moves the
//     gradients of the first layers by ~1e-4 relative norm, the fp32
//     tolerance (`scripts/tf32_relu_flips.py` on the CPU; PERF.md section 6).
//     Only g W^T is 3xTF32 (m16n8k8, the truncating accumulator flushed into
//     fp32 every 8 k-steps, `kFlushK`; g and W^T split into TF32 hi / lo to
//     nearest, as every fp32 tensor-core product here), as the fused MLP
//     chain's backward does: there the masks are already fixed by the stored
//     forward. The encodings' cotangents take the encodings' own tiles and a
//     layer's fp32 cotangent stays in its layer tile, so the flagship width
//     fits a 64-row tile: one block an SM, 8 warps. What bounds it now
//     (PERF.md section 6): phase A takes ~14 ms a 1024 x 128 step against the
//     5.2 ms its two products need at 67 TFLOP/s; the forward's products ~6
//     ms, g W^T ~6.5 ms (mma.sync at 8 warps an SM), the workspace stores ~1
//     ms;
//   * phase B (`train_common.cuh`): dW = A^T G and db = sum G for every
//     layer, a GEMM over the rows (bf16 on the tensor cores, `dw_tile_tc`;
//     fp32 FMA loops, `dw_tile`; A and G staged transposed into shared
//     memory, since the rows are the reduction), split over the rows into
//     fixed partials that a third kernel adds in a fixed order. No atomics:
//     two launches give bitwise equal gradients.

#include "fma_tile.cuh"
#include "train_common.cuh"

namespace {

using namespace netpu;

constexpr int kAux = 6;        // per-row compositing record: raw density, rgb, T, w
constexpr int kComp = 16;      // per-ray state: carry, rgb, d_origs (3), d_dirs (3)

// fp32 arrays after the compute-type tiles, in this order: dens, logits, tq,
// dist, comp, then bf16: the encodings' fp32 cotangents, geo, the staging
// tile of a layer's fp32 cotangent; fp32: geo, the compositing lanes' partial
// sums, a layer's ReLU mask words (kR / 32 x max(D, C); the encodings'
// cotangents take the encodings' tiles and a layer's the layer tiles); then
// the BARF window. `train_megakernel.tile_smem_bytes` computes the same sizes.
__host__ __device__ int stg_ld(int D, int C) { return imax(round16(D), round16(C)) + 4; }
__host__ __device__ size_t train_floats(bool bf16, int P, int Q, int D, int C, int Lp, int Ld,
                                        int kR) {
  if (!bf16)
    return static_cast<size_t>(kR) * (6 + kComp + 6) + 3 * 32 + kR / 32 * imax(D, C) +
           round4(Lp + Ld);
  return static_cast<size_t>(kR) * (6 + kComp + round16(P) + round16(Q) + 6 + stg_ld(D, C)) +
         round4(Lp + Ld);
}

// A layer's outputs in the fp32 tile's forward: acc + b, then the ReLU when
// `relu`, into the shared tile. With `words`, bit
// (row & 31) of words[(row >> 5) * wld + col] is set where the stored value
// is > 0, for the tile's live rows (its ReLU mask words, zero before the
// layer; a thread's R rows lie in one 32-row part, and up to 32 / R threads
// share a word).
struct LayerOut {
  float* out;
  int ld;
  const float* bias;
  bool relu;
  unsigned* words;
  int wld, rows;
  template <int R, int C>
  __device__ void operator()(int r0, int c0, const float (&acc)[R][C]) const {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = fma_col<C>(c0, j);
      const float bj = __ldg(bias + col);
      unsigned bits = 0u;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float z = acc[r][j] + bj;
        if (relu) z = fmaxf(z, 0.f);
        out[(r0 + r) * ld + col] = z;
        if (z > 0.f && r0 + r < rows) bits |= 1u << r;
      }
      if (words != nullptr && bits != 0u)
        atomicOr(words + (r0 >> 5) * wld + col, bits << (r0 & 31));
    }
  }
};

// out[r * ldo + j] = in[r] . W[:, j] + b[j] for the tile's kR rows and j < N,
// W (K, N) with the row stride ldw in global memory: the narrow outputs (the
// density column, the 3 logits), a thread a (row, column), fmaf over k = 0,
// 1, ... from 0 and then the bias, the order of `fma_layer`. `in` is 16-byte
// aligned and ld % 4 == 0.
template <int kR>
__device__ void narrow(const float* in, int ld, int K, const float* __restrict__ W, int ldw,
                       const float* __restrict__ bias, int N, float* out, int ldo) {
  const int K4 = K & ~3;
  for (int idx = threadIdx.x; idx < kR * N; idx += blockDim.x) {
    const int r = idx % kR, j = idx / kR;
    const float* a = in + r * ld;
    float acc = 0.f;
    for (int k = 0; k < K4; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(a + k);
      acc = fmaf(x.x, __ldg(W + static_cast<size_t>(k) * ldw + j), acc);
      acc = fmaf(x.y, __ldg(W + static_cast<size_t>(k + 1) * ldw + j), acc);
      acc = fmaf(x.z, __ldg(W + static_cast<size_t>(k + 2) * ldw + j), acc);
      acc = fmaf(x.w, __ldg(W + static_cast<size_t>(k + 3) * ldw + j), acc);
    }
    for (int k = K4; k < K; ++k) acc = fmaf(a[k], __ldg(W + static_cast<size_t>(k) * ldw + j), acc);
    out[r * ldo + j] = acc + __ldg(bias + j);
  }
}

// The flagship forward chain of the fp32 tile, on the CUDA cores, for a tile
// whose encodings are in s.encp / s.encd: the layers `forward_tile` runs, each
// by `fma_layer` with W (K, N) fp32 at the row stride round4(N) (the last
// segment layer's D hidden columns only) staged through the ring's bytes;
// the density column (into s.dens) and the logits (into s.logits) by
// `narrow`. A ReLU layer's mask words gather in `words` (zero on entry,
// kR / 32 x wld). Each layer's output and mask words go to the workspace
// after its barrier, while the next layer reads it (the words then zeroed for
// the next layer's epilogue, which follows a barrier of its own; spreading
// the copy among the next layer's chunks instead measured slower). Ends with
// __syncthreads. Forced inline: called, it gave the kernel a 1.7 KB stack
// frame (the weight pointers copied to local memory), and phase A ran 2.2 ms
// slower at 1024 x 128 on the H100.
template <int kR>
__device__ __forceinline__ void forward_fma(const Layout& lay, const TileWeights& w,
                                            const TileBufs<false>& s, int rows,
                                            const TileStore<float>& st, unsigned* words) {
  constexpr int kH = kR / 32;
  const int D = lay.D, C = lay.C, L = lay.L, wld = imax(D, C);
  float* stage = reinterpret_cast<float*>(s.ring);
  constexpr size_t kStage = TileSmem<false>::kRingBytes;
  auto weights = [&](int l) { return static_cast<const float*>(w.fwd[l]); };
  auto layer = [&](const float* in1, int ld1, int K1, const float* in2, int ld2, int K2, int l,
                   int N, float* out, bool relu) {
    fma_layer<kR>(in1, ld1, K1, in2, ld2, K2, weights(l), N, stage, kStage,
                  LayerOut{out, s.ldb, w.b[l], relu, relu ? words : nullptr, wld, rows});
    __syncthreads();
  };
  auto keep = [&](const float* out, int width, int act_col, int mask_col) {
    copy_rows(st.act + act_col, st.AW, out, s.ldb, width, rows);
    if (mask_col >= 0)
      for (int item = threadIdx.x; item < kH * width; item += blockDim.x) {
        const int h = item / width, j = item % width;
        st.masks[h * st.MW + mask_col + j] = words[h * wld + j];
        words[h * wld + j] = 0u;
      }
  };
  float* cur = s.buf0;
  float* nxt = s.buf1;
  layer(s.encp, s.ldp, lay.P, nullptr, 0, 0, 0, D, cur, true);
  keep(cur, D, lay.h1(0), lay.m_h1(0));
  for (int i = 1; i < L; ++i) {
    layer(cur, s.ldb, D, nullptr, 0, 0, i, D, nxt, true);
    keep(nxt, D, lay.h1(i), lay.m_h1(i));
    float* t = cur; cur = nxt; nxt = t;
  }
  layer(cur, s.ldb, D, s.encp, s.ldp, lay.P, L, D, nxt, true);
  keep(nxt, D, lay.h2(0), lay.m_h2(0));
  { float* t = cur; cur = nxt; nxt = t; }
  for (int i = 1; i < L - 1; ++i) {
    layer(cur, s.ldb, D, nullptr, 0, 0, L + i, D, nxt, true);
    keep(nxt, D, lay.h2(i), lay.m_h2(i));
    float* t = cur; cur = nxt; nxt = t;
  }
  // last segment layer: the hidden columns, no ReLU, and the density column
  layer(cur, s.ldb, D, nullptr, 0, 0, 2 * L - 1, D, nxt, false);
  narrow<kR>(cur, s.ldb, D, static_cast<const float*>(w.w_density), 1, w.b[2 * L - 1] + D, 1,
             s.dens, 1);
  keep(nxt, D, lay.hid(), -1);
  __syncthreads();  // the colour head writes the tile the density column read
  { float* t = cur; cur = nxt; nxt = t; }
  layer(cur, s.ldb, D, s.encd, s.ldq, lay.Q, 2 * L, C, nxt, true);
  keep(nxt, C, lay.c0(), lay.m_c0());
  narrow<kR>(nxt, s.ldb, C, weights(2 * L + 1), round4(3), w.b[2 * L + 1], 3, s.logits, 3);
  __syncthreads();
}

// The tile route, kR-row tiles (64, or 32 for wide layers; see the file note).
template <bool kBf16, int kR>
__global__ void __launch_bounds__(kThreads, 1)
flagship_train_kernel(const float* __restrict__ origs, const float* __restrict__ dirs,
                      const float* __restrict__ t_start, const float* __restrict__ t_end,
                      const float* __restrict__ targets, TileWeights wts, int n_rays, int S,
                      int n_hidden, int D, int C, int Lp, int Ld, float scale, float alpha_pos,
                      float alpha_dir, float density_scale, float grad_scale,
                      typename Mma<kBf16>::ET* act, float* cot, float* aux, unsigned* masks,
                      float* __restrict__ rgb_out, float* __restrict__ d_origs,
                      float* __restrict__ d_dirs, float* __restrict__ weights_out) {
  using M = Mma<kBf16>;
  using ET = typename M::ET;
  constexpr int kH = kR / 32;  // 32-row mask halves of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = 3 + 6 * Lp, Q = 3 + 6 * Ld;
  const int L = n_hidden + 1;  // layers per segment
  const Layout lay{P, Q, D, C, L};
  const size_t AW = lay.act_width(), GW = lay.cot_width();
  const int MW = lay.mask_width();
  const int Dp = round16(D), Cp = round16(C);  // the widths on the tensor cores
  const int Pp = round16(P), Qp = round16(Q);
  const TileSmem<kBf16> tl(P, Q, D, C, kR);
  float* f = reinterpret_cast<float*>(smem + tl.f32_offset());
  float* dens = f;                   // kR
  float* logits = dens + kR;         // kR x 3
  float* tq = logits + 3 * kR;       // kR
  float* dist = tq + kR;             // kR
  float* comp = dist + kR;           // kR x kComp
  const TileBufs<kBf16> s(tl, smem, dens, logits);
  float *gencp, *gencd;    // the pos_enc / dir_enc cotangents
  float *geo, *mask;       // kR x 6: d_pos, t d_pos + d_dir; the BARF window
  float* stg = nullptr;    // bf16: kR x sld, a layer's fp32 cotangent
  float* lanes = nullptr;  // fp32: 3 x 32, each lane's partial rgb sums of a ray that goes on
  unsigned* words = nullptr;  // fp32: kR / 32 x max(D, C), a layer's ReLU mask words
  int ldgp, ldgq, sld = 0;
  if constexpr (kBf16) {
    ldgp = Pp;
    ldgq = Qp;
    sld = stg_ld(D, C);
    gencp = comp + kR * kComp;
    gencd = gencp + kR * ldgp;
    geo = gencd + kR * ldgq;
    stg = geo + kR * 6;
    mask = stg + kR * sld;
  } else {  // the encodings' tiles are free once the forward is done
    ldgp = s.ldp;
    ldgq = s.ldq;
    gencp = s.encp;
    gencd = s.encd;
    geo = comp + kR * kComp;
    lanes = geo + kR * 6;
    words = reinterpret_cast<unsigned*>(lanes + 3 * 32);
    mask = reinterpret_cast<float*>(words + kH * imax(D, C));
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rpb = rays_per_block(S, kR);
  const int ray0 = blockIdx.x * rpb;
  const int nr = min(rpb, n_rays - ray0);
  const int block_rows = nr * S;
  const size_t row_base = static_cast<size_t>(ray0) * S;
  unsigned* mblock = masks + static_cast<size_t>(blockIdx.x) * tiles_per_block(S, kR) * kH * MW;

  s.zero();
  barf_window(mask, Lp, Ld, alpha_pos, alpha_dir);
  for (int i = tid; i < kR * kComp; i += blockDim.x) comp[i] = 0.f;
  if constexpr (!kBf16)
    for (int i = tid; i < kH * imax(D, C); i += blockDim.x) words[i] = 0u;

  // ---- forward, tile by tile; one warp composites each ray ----
  for (int tb = 0; tb < block_rows; tb += kR) {
    const int rows = min(kR, block_rows - tb);
    const size_t row0 = row_base + tb;
    ET* a0 = act + row0 * AW;
    for (int r = tid; r < rows; r += blockDim.x) {
      const float ts = t_start[row0 + r], te = t_end[row0 + r];
      tq[r] = (ts + te) / 2.f;
      dist[r] = te - ts;
    }
    __syncthreads();  // also publishes the zeroed tiles, mask and comp on the first tile
    for (int idx = tid; idx < rows * 3; idx += blockDim.x) {
      const int r = idx / 3, c = idx % 3;
      const int ray = ray0 + (tb + r) / S;
      const float o = __ldg(origs + ray * 3 + c), d = __ldg(dirs + ray * 3 + c);
      const float p = __fadd_rn(o, __fmul_rn(tq[r], d));
      encode<kBf16>(p, c, Lp, mask, scale, s.encp + r * s.ldp);
      encode<kBf16>(d, c, Ld, mask + Lp, scale, s.encd + r * s.ldq);
    }
    __syncthreads();
    for (int idx = tid; idx < rows * P; idx += blockDim.x)
      a0[(idx / P) * AW + idx % P] = s.encp[(idx / P) * s.ldp + idx % P];
    for (int idx = tid; idx < rows * Q; idx += blockDim.x)
      a0[(idx / Q) * AW + P + idx % Q] = s.encd[(idx / Q) * s.ldq + idx % Q];
    const TileStore<ET> st{a0, AW, mblock + static_cast<size_t>(tb / kR) * kH * MW, MW};
    if constexpr (kBf16)
      forward_tile<true, kR>(lay, wts, s, rows, st);
    else
      forward_fma<kR>(lay, wts, s, rows, st, words);

    const int j_first = tb / S, j_last = (tb + rows - 1) / S;
    for (int j = j_first + warp; j <= j_last; j += kWarps) {
      const int lo = max(tb, j * S) - tb, hi = min(tb + rows, (j + 1) * S) - tb;
      float* sj = comp + j * kComp;
      float carry = sj[0], ar = 0.f, ag = 0.f, ab = 0.f;
      if constexpr (!kBf16) {
        // fp32 sums rgb in a fixed order whatever the tile: each lane over
        // all of the ray's 32-row chunks, then across the lanes. A ray that
        // spans tiles is its block's only one, so warp 0's
        if (tb + lo > j * S) {
          ar = lanes[lane];
          ag = lanes[32 + lane];
          ab = lanes[64 + lane];
        }
      }
      for (int c0 = lo; c0 < hi; c0 += 32) {
        const int r = c0 + lane;
        const bool live = r < hi;
        float raw = 0.f, blk = 0.f, k0 = 0.f, k1 = 0.f, k2 = 0.f;
        if (live) {
          raw = dens[r];
          blk = -softplus8(raw) * dist[r] * density_scale;
          k0 = 1.f / (1.f + expf(-logits[r * 3 + 0]));
          k1 = 1.f / (1.f + expf(-logits[r * 3 + 1]));
          k2 = 1.f / (1.f + expf(-logits[r * 3 + 2]));
        }
        const float incl = warp_scan(blk, lane);
        float excl = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) excl = 0.f;
        const float T = expf(carry + excl);
        const float w = T * (1.f - expf(blk));
        if (live) {
          ar += w * k0;
          ag += w * k1;
          ab += w * k2;
          float* x = aux + (row0 + r) * kAux;
          x[0] = raw; x[1] = k0; x[2] = k1; x[3] = k2; x[4] = T; x[5] = w;
          if (weights_out) weights_out[row0 + r] = w;
        }
        carry += __shfl_sync(kFull, incl, 31);
      }
      const bool ends = tb + hi == (j + 1) * S;
      if constexpr (kBf16) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          ar += __shfl_xor_sync(kFull, ar, off);
          ag += __shfl_xor_sync(kFull, ag, off);
          ab += __shfl_xor_sync(kFull, ab, off);
        }
        if (lane == 0) {
          sj[0] = carry;
          sj[1] += ar;
          sj[2] += ag;
          sj[3] += ab;
          if (ends)
            for (int k = 0; k < 3; ++k) rgb_out[(ray0 + j) * 3 + k] = sj[1 + k];
        }
      } else if (!ends) {
        lanes[lane] = ar;
        lanes[32 + lane] = ag;
        lanes[64 + lane] = ab;
        if (lane == 0) sj[0] = carry;
      } else {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          ar += __shfl_xor_sync(kFull, ar, off);
          ag += __shfl_xor_sync(kFull, ag, off);
          ab += __shfl_xor_sync(kFull, ab, off);
        }
        if (lane == 0) {
          sj[0] = carry;
          sj[1] = ar;
          sj[2] = ag;
          sj[3] = ab;
          for (int k = 0; k < 3; ++k) rgb_out[(ray0 + j) * 3 + k] = sj[1 + k];
        }
      }
    }
    __syncthreads();  // the next tile overwrites tq, dist, dens, logits and the tiles
  }

  // ---- loss gradient and compositing backward, one warp a ray ----
  for (int j = warp; j < nr; j += kWarps) {
    const int ray = ray0 + j;
    const size_t ray_row = static_cast<size_t>(ray) * S;
    const float g0 = grad_scale * (comp[j * kComp + 1] - __ldg(targets + ray * 3 + 0));
    const float g1 = grad_scale * (comp[j * kComp + 2] - __ldg(targets + ray * 3 + 1));
    const float g2 = grad_scale * (comp[j * kComp + 3] - __ldg(targets + ray * 3 + 2));
    float tail = 0.f;  // sum of g_w * w over the samples after this chunk
    for (int base = ((S - 1) / 32) * 32; base >= 0; base -= 32) {
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
  __syncthreads();  // the seeded cotangents are visible to the block

  // ---- MLP backward, tile by tile: g <- (g W^T) * mask on the tensor cores ----
  const int sd = Dp / M::kK;
  for (int tb = 0; tb < block_rows; tb += kR) {
    const int rows = min(kR, block_rows - tb);
    const size_t row0 = row_base + tb;
    float* cot0 = cot + row0 * GW;
    const unsigned* mt = mblock + static_cast<size_t>(tb / kR) * kH * MW;
    // part 1 of width w1 (D, C or 0) padded to 16; part 2 an encoding's k2 columns
    auto epi = [&](int w1, ET* out, const unsigned* m, float* enc, int eld, int k2, bool add) {
      return BwdEpi<kBf16>{round16(w1), w1, out, s.ldb, w1 > 0 ? stg : nullptr, sld, m, MW,
                           enc, eld, k2, add, rows};
    };
    // g W^T of layer l for the tile's cotangent g (steps k-steps) into n_tiles
    // n8 tiles; fp32 flushes the tensor cores' chain every kFlushK k-steps
    auto gemm = [&](const ET* g, int steps, int l, int n_tiles, const BwdEpi<kBf16>& e) {
      tile_gemm<kBf16, kR, kFlushK<kBf16>>(g, s.ldb, steps, nullptr, 0, 0, wts.bwd[l], s.ring,
                                           n_tiles, e);
    };
    // after a product's barrier: its fp32 cotangent (width k1) to the
    // workspace columns of layer l. bf16: from stg, then a barrier before stg
    // is written again; fp32: from the product's output tile, which the next
    // product only reads
    auto store_cot = [&](int l, int k1, const ET* out) {
      if constexpr (kBf16) {
        copy_rows(cot0 + lay.g(l), GW, stg, sld, k1, rows);
        __syncthreads();
      } else {
        copy_rows(cot0 + lay.g(l), GW, out, s.ldb, k1, rows);
      }
    };
    for (int r = tid; r < rows; r += blockDim.x)
      tq[r] = (t_start[row0 + r] + t_end[row0 + r]) / 2.f;
    // the logits' cotangent, K zero-padded to 16
    for (int idx = tid; idx < kR * 16; idx += blockDim.x) {
      const int r = idx >> 4, c = idx & 15;
      const float v = c < 3 && r < rows ? cot0[r * GW + lay.g(2 * L + 1) + c] : 0.f;
      store_act(s.buf0 + r * s.ldb + c, v);
    }
    __syncthreads();
    // colour head, C -> 3: masked by the colour hidden layer's ReLU
    gemm(s.buf0, 16 / M::kK, 2 * L + 1, Cp / 8,
         epi(C, s.buf1, mt + lay.m_c0(), nullptr, 0, 0, false));
    __syncthreads();
    store_cot(2 * L, C, s.buf1);
    // colour head, [hidden | dir_enc] -> C: the hidden part has no ReLU
    gemm(s.buf1, Cp / M::kK, 2 * L, (Dp + Qp) / 8, epi(D, s.buf0, nullptr, gencd, ldgq, Q, false));
    __syncthreads();  // buf0's padding columns [D, Dp) are written by that epilogue
    // the density column's cotangent from the compositing pass at column D,
    // zeros up to the last segment layer's padded K, round16(D + 1)
    const int kd = round16(D + 1) - D;
    for (int idx = tid; idx < kR * kd; idx += blockDim.x) {
      const int r = idx / kd, c = idx % kd;
      const float v = c == 0 && r < rows ? cot0[r * GW + lay.g(2 * L - 1) + D] : 0.f;
      store_act(s.buf0 + r * s.ldb + D + c, v);
    }
    store_cot(2 * L - 1, D, s.buf0);
    if constexpr (!kBf16) __syncthreads();  // the density column is the next product's input
    // last segment layer, D -> D + 1
    gemm(s.buf0, round16(D + 1) / M::kK, 2 * L - 1, Dp / 8,
         epi(D, s.buf1, mt + lay.m_h2(L - 2), nullptr, 0, 0, false));
    __syncthreads();
    store_cot(2 * L - 2, D, s.buf1);
    ET* cur = s.buf1;
    ET* nxt = s.buf0;
    for (int l = 2 * L - 2; l >= L + 1; --l) {
      gemm(cur, sd, l, Dp / 8, epi(D, nxt, mt + lay.m_h2(l - 1 - L), nullptr, 0, 0, false));
      __syncthreads();
      store_cot(l - 1, D, nxt);
      ET* t = cur; cur = nxt; nxt = t;
    }
    // first layer of segment 2, [z | pos_enc] -> D: the inter-segment ReLU
    gemm(cur, sd, L, (Dp + Pp) / 8, epi(D, nxt, mt + lay.m_h1(L - 1), gencp, ldgp, P, false));
    __syncthreads();
    store_cot(L - 1, D, nxt);
    { ET* t = cur; cur = nxt; nxt = t; }
    for (int l = L - 1; l >= 1; --l) {
      gemm(cur, sd, l, Dp / 8, epi(D, nxt, mt + lay.m_h1(l - 1), nullptr, 0, 0, false));
      __syncthreads();
      store_cot(l - 1, D, nxt);
      ET* t = cur; cur = nxt; nxt = t;
    }
    // first layer, pos_enc -> D
    gemm(cur, sd, 0, Pp / 8, epi(0, nxt, nullptr, gencp, ldgp, P, true));
    __syncthreads();
    // encoding backward per (row, coordinate): d_pos and t_q d_pos + d_dir
    if (tid < rows * 3) {
      const int r = tid / 3, c = tid % 3;
      const int ray = ray0 + (tb + r) / S;
      const float o = __ldg(origs + ray * 3 + c), d = __ldg(dirs + ray * 3 + c);
      const float p = __fadd_rn(o, __fmul_rn(tq[r], d));
      const float dp = encode_bwd(p, c, Lp, mask, scale, gencp + r * ldgp);
      const float dd = encode_bwd(d, c, Ld, mask + Lp, scale, gencd + r * ldgq);
      geo[r * 6 + c] = dp;
      geo[r * 6 + 3 + c] = tq[r] * dp + dd;
    }
    __syncthreads();
    // per-ray sums over the tile's rows, in row order
    const int j_first = tb / S, j_last = (tb + rows - 1) / S;
    for (int idx = tid; idx < (j_last - j_first + 1) * 6; idx += blockDim.x) {
      const int j = j_first + idx / 6, q = idx % 6;
      const int lo = max(tb, j * S) - tb, hi = min(tb + rows, (j + 1) * S) - tb;
      float sum = 0.f;
      for (int r = lo; r < hi; ++r) sum += geo[r * 6 + q];
      comp[j * kComp + 4 + q] += sum;
    }
    __syncthreads();  // the next tile overwrites tq, geo and the tiles
  }
  for (int idx = tid; idx < nr * 6; idx += blockDim.x) {
    const int j = idx / 6, q = idx % 6;
    float* dst = q < 3 ? d_origs : d_dirs;
    dst[(ray0 + j) * 3 + q % 3] = comp[j * kComp + 4 + q];
  }
}

// ---- phase B: dW = A^T G, db = sum_rows G (train_common.cuh) ----

__global__ void __launch_bounds__(256)
dw_partial_kernel(const __nv_bfloat16* __restrict__ act, const float* __restrict__ cot,
                  GemmPlan plan, float* __restrict__ part) {
  __shared__ __align__(16) DwTcSmem sm;
  dw_tile_stored_tc(act, cot, plan, DwTile(plan), sm, part);
}

__global__ void __launch_bounds__(256)
dw_partial_fma_kernel(const float* __restrict__ act, const float* __restrict__ cot,
                      GemmPlan plan, float* __restrict__ part) {
  __shared__ __align__(16) DwSmem sm;
  dw_tile_stored<false>(act, cot, plan, DwTile(plan), sm, part);
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

template <bool kBf16, int kR>
cudaError_t launch_tc(const float* origs, const float* dirs, const float* t_start,
                      const float* t_end, const float* targets, const TileWeights& wts,
                      int n_rays, int S, int n_hidden, int D, int C, int Lp, int Ld, float scale,
                      float alpha_pos, float alpha_dir, float density_scale, float grad_scale,
                      void* act, float* cot, float* aux, unsigned* masks, float* part,
                      int splits, float* grads, float* rgb_out, float* d_origs, float* d_dirs,
                      float* weights_out, cudaStream_t stream) {
  using ET = typename Mma<kBf16>::ET;
  const int P = 3 + 6 * Lp, Q = 3 + 6 * Ld;
  const Layout lay{P, Q, D, C, n_hidden + 1};
  const size_t bytes = TileSmem<kBf16>(P, Q, D, C, kR).f32_offset() +
                       train_floats(kBf16, P, Q, D, C, Lp, Ld, kR) * sizeof(float);
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = flagship_train_kernel<kBf16, kR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int rpb = rays_per_block(S, kR);
  const unsigned blocks = static_cast<unsigned>((n_rays + rpb - 1) / rpb);
  auto* a = static_cast<ET*>(act);
  kernel<<<blocks, kThreads, bytes, stream>>>(
      origs, dirs, t_start, t_end, targets, wts, n_rays, S, n_hidden, D, C, Lp, Ld, scale,
      alpha_pos, alpha_dir, density_scale, grad_scale, a, cot, aux, masks, rgb_out, d_origs,
      d_dirs, weights_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const GemmPlan plan = make_plan(lay, static_cast<long long>(n_rays) * S, splits);
  dim3 grid(plan.tiles, splits);
  if constexpr (kBf16)
    dw_partial_kernel<<<grid, 256, 0, stream>>>(a, cot, plan, part);
  else
    dw_partial_fma_kernel<<<grid, 256, 0, stream>>>(a, cot, plan, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Segments all{};
  all.n = 1;
  all.begin[1] = plan.wtot + plan.btot;
  return reduce(part, splits, all, grads, stream);
}

}  // namespace

// Inputs: origs, dirs, targets (n_rays, 3); t_start, t_end (n_rays, S); the 2
// (n_hidden + 1) + 2 layers in the order segment 1, segment 2, colour head;
// tile_rows is the row tile kR, 64 or 32 (`train_megakernel.tile_rows`); any
// other value is refused. wb_ptrs are the backward B operands W^T packed by
// `train_megakernel.pack_b` (bf16, or fp32 TF32 hi / lo pairs); wf_ptrs the
// forward B operands packed the same way in bf16, in fp32 the weights (in,
// out) as they are with the row stride round4(out); w_density is W[:, D] of
// the last segment layer in the compute type, which the forward operand of
// that layer leaves out. b_ptrs: the biases, fp32. grad_scale = 2
// loss_scale / (n_rays 3). Workspaces: act (n_rays S, act_width) in the
// compute type, cot (n_rays S, cot_width) fp32, aux (n_rays S, 6) fp32, masks
// (halves, mask_width) 32-bit words with halves = blocks x
// tiles_per_block(S, kR) x kR / 32, blocks = ceil(n_rays /
// rays_per_block(S, kR)), part (splits, n_grads) fp32, with act_width /
// cot_width / mask_width as `Layout` computes them. Outputs: grads (n_grads) = every layer's dW (in,
// out) in layer order, then every db; rgb_out, d_origs, d_dirs (n_rays, 3);
// weights_out (n_rays, S) or null.
extern "C" int netpu_flagship_train(
    const float* origs, const float* dirs, const float* t_start, const float* t_end,
    const float* targets, const void* const* wf_ptrs, const void* const* wb_ptrs,
    const float* const* b_ptrs, const void* w_density, int n_layers, int bf16, int tile_rows,
    int n_rays, int S, int n_hidden, int D, int C, int Lp, int Ld, float scale, float alpha_pos,
    float alpha_dir, float density_scale, float grad_scale, void* act, float* cot, float* aux,
    unsigned* masks, int act_width, int cot_width, float* part, int splits, float* grads,
    float* rgb_out, float* d_origs, float* d_dirs, float* weights_out, void* stream) {
  const Layout lay{3 + 6 * Lp, 3 + 6 * Ld, D, C, n_hidden + 1};
  if (n_hidden < 1 || n_layers != 2 * (n_hidden + 1) + 2 || n_layers > kMaxLayers ||
      act_width != lay.act_width() || cot_width != lay.cot_width() || splits < 1 ||
      (tile_rows != 64 && tile_rows != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  TileWeights wts{};
  for (int i = 0; i < n_layers; ++i) {
    wts.fwd[i] = wf_ptrs[i];
    wts.bwd[i] = wb_ptrs[i];
    wts.b[i] = b_ptrs[i];
  }
  wts.w_density = w_density;
  auto tc = bf16 ? (tile_rows == 64 ? launch_tc<true, 64> : launch_tc<true, 32>)
                 : (tile_rows == 64 ? launch_tc<false, 64> : launch_tc<false, 32>);
  return static_cast<int>(tc(origs, dirs, t_start, t_end, targets, wts, n_rays, S, n_hidden, D,
                             C, Lp, Ld, scale, alpha_pos, alpha_dir, density_scale, grad_scale,
                             act, cot, aux, masks, part, splits, grads, rgb_out, d_origs, d_dirs,
                             weights_out, st));
}
