// Training step of the GARF / GaborF / SARF radiance field for one NVIDIA
// H100 (K5): rays + t-bins + targets -> rgb, the compositing weights, the
// gradient of loss = mean((rgb - target)^2) (over n_rays * 3) with respect to
// every weight, bias and activation parameter (fp32), and d_origs / d_dirs.
//
// Replaces the TPU kernel `nerf_experiments_tpu/ops/garf_megakernel.py:_kernel`
// (Pallas, entry `garf_radiance_train_grads`). Forward as in `garf_render.cuh`,
// then the MSE gradient, the compositing backward and the backward of the net,
// activation parameters (isd, spread, freq) included.
//
// What bounds it on the H100: arithmetic, three times the forward's 596,096
// multiply-adds a sample (forward, g W^T, A^T G): 2.84 ms at 4096 rays x 192
// samples at the bf16 tensor-core rate, 17.05 ms for fp32's three TF32
// products a product; then the workspace (a and x of every activation layer,
// 6.8 KB a row in bf16, and the fp32 cotangents, 7.2 KB). The TPU keeps a
// 768-row tile in ~26 MB of VMEM from forward through backward; a Hopper block
// has 227 KB. So the work is split in two phases, both on the tensor cores:
//   * phase A, a block of kR / S rays (S <= kR) or one ray walking kR-row
//     tiles (`garf_common.cuh`: 64 rows bf16, 32 fp32): the forward tile
//     stores each activation layer's output a and rounded pre-activation x
//     to the workspace in the compute type (layer 0 is recomputed from the
//     position, as the TPU does; the backward recomputes the activation's
//     factors from x rather than storing them); one warp a ray composites
//     with a shuffle scan and, after the block's last tile, runs the
//     compositing backward as a reverse scan with the suffix carried from the
//     end of the ray. The tiles are walked again and the row cotangents go
//     back layer by layer, g <- act_bwd(g W^T), the same tile product with
//     B = W^T packed by the wrapper; the epilogue (`GarfBwdEpi`) applies the
//     activation backward, stores the cotangent fp32 for phase B, and sums
//     the activation-parameter gradients over its rows (a warp owns its n8
//     tiles over every row: registers, then shuffles over the 8 row groups)
//     into the block's own partials, tile after tile. Linear 1's backward
//     into layer 0 (`L0Epi`) recomputes layer 0's pre-activation per column
//     and yields layer 0's dW / db and parameter sums the same way, and d_pos
//     from row sums held in registers. d_origs / d_dirs are summed per ray in
//     a fixed order;
//   * phase B (`train_common.cuh`): dW = A^T G and db = sum G for linears
//     1..9, on the tensor cores in bf16 (`dw_tile_tc`, A and G staged
//     transposed) and on the CUDA cores in fp32 (`dw_tile`, see
//     `dw_partial_kernel`); linear 1's input, the 1024-wide layer-0
//     activation, is recomputed while its tiles are loaded; split over the
//     rows into fixed partials;
//   * two reductions add the row splits and the blocks' partials in a fixed
//     order. No atomics: two launches give bitwise-equal gradients.
// With bf16, matmul operands (weights, activations, cotangents) are bf16 and
// products accumulate in fp32, rounding where the TPU kernel rounds (`cde`);
// the bias and activation-parameter gradients sum fp32 values. In fp32 phase
// A's products are 3xTF32, the accumulator flushed into fp32 every 8
// k-steps (`kFlushK`): the net has no ReLU whose mask a 2^-21 product error
// could flip (the flagship's K4 keeps FMA loops for that), and
// `tests/test_torch_garf_tc.py` holds emulated 3xTF32 gradients within the
// fp32 tolerance of the JAX kernel for every family.
//
// The kernels are templates over the compute type and the activation family;
// each family's source (garf_train_<family>.cu) includes this header and
// instantiates its own, and `garf_train.cu` holds the entry point.
#pragma once

#include "garf_common.cuh"
#include "train_common.cuh"

namespace netpu {
namespace garf {
namespace {

constexpr int kAux = 6;  // per-row compositing record: raw density, rgb, T, w

// Epilogue of a backward product g W^T whose columns are a layer's inputs in
// two parts. Part 1, columns < k1: the cotangent of the previous layer's
// output; `add` (fp32, row stride GW) is added to it, then with kAct >= 0
// (kAct < 0: no activation) the
// activation backward from the stored pre-activation `xrec` (row stride AW)
// gives the cotangent of that layer's pre-activation, which goes fp32 to the
// cotangent workspace `cot` (row stride GW) for the live rows and rounded into
// `buf`, the next product's A; the tile's sums of the activation-parameter
// gradients over its live rows go to part1 / part2 (set on the block's first
// tile, added after). Part 2, columns k1 + m for m < k2: an input's cotangent
// (d pos, d dir), written into enc[row * eld + m].
template <bool kBf16, int kAct>
struct GarfBwdEpi {
  using ET = typename Mma<kBf16>::ET;
  int k1;
  ET* buf;
  int ld;
  float* cot;
  const float* add;
  const ET* xrec;
  size_t AW, GW;
  const float *p1, *p2;
  float gamma;
  float *part1, *part2;
  bool first;
  float* enc;
  int eld, k2, rows;

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
    if (nt * 8 >= k1) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + g + 8 * (e >> 1), col = col0 + (e & 1) - k1;
          if (col < k2) enc[row * eld + col] = c[i][e];
        }
      return;
    }
    float q1[2] = {0.f, 0.f}, q2[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    if constexpr (kAct >= 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        q1[p] = __ldg(p1 + col0 + p);
        q2[p] = kAct == kGabor ? __ldg(p2 + col0 + p) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        float v[2] = {0.f, 0.f};
        if (row < rows) {
          v[0] = c[i][2 * h];
          v[1] = c[i][2 * h + 1];
          if (add != nullptr) {
            const float2 ad = load_pair(add + row * GW + col0);
            v[0] += ad.x;
            v[1] += ad.y;
          }
          if constexpr (kAct >= 0) {
            const float2 x = load_pair(xrec + row * AW + col0);
            v[0] = act_bwd_x<kAct, kBf16>(v[0], x.x, q1[0], q2[0], gamma, s1[0], s2[0]);
            v[1] = act_bwd_x<kAct, kBf16>(v[1], x.y, q1[1], q2[1], gamma, s1[1], s2[1]);
          }
          store_pair(cot + row * GW + col0, v[0], v[1]);
        }
        store_pair(buf + row * ld + col0, v[0], v[1]);  // rounds to the compute type
      }
    if constexpr (kAct >= 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[p] += __shfl_xor_sync(kFull, s1[p], off);
          s2[p] += __shfl_xor_sync(kFull, s2[p], off);
        }
      if (g == 0) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float fa, fb;
          param_factors<kAct>(q1[p], gamma, fa, fb);
          const int k = col0 + p;
          part1[k] = first ? fa * s1[p] : part1[k] + fa * s1[p];
          if (kAct == kGabor) part2[k] = first ? fb * s2[p] : part2[k] + fb * s2[p];
        }
      }
    }
  }
};

// Epilogue of linear 1's backward product g1 W1^T (1024 columns, layer 0's
// outputs): per element, layer 0's pre-activation recomputed from the tile's
// rounded position (as the forward computed it), its activation backward,
// then over the live rows: per column the sums of d(pre-activation) (db0),
// position x rounded d(pre-activation) (dW0) and the parameter gradients,
// reduced over the warp's row groups by shuffles into the block's partials
// (set on its first tile, added after); per row the thread's share of d pos =
// rounded d(pre-activation) W0^T, kept in the caller's dp over every column.
template <bool kBf16, int kAct>
struct L0Epi {
  using ET = typename Mma<kBf16>::ET;
  const ET* pos;  // E, row stride GarfSmem::ldE
  const ET* w0;
  const float *b0, *p1, *p2;
  float gamma;
  float* part;
  bool first;
  int rows;
  float (*dp)[2][3];  // [kR / 16][2][3]: the thread's rows 16 i + g + 8 h

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
    constexpr int ldE = GarfSmem<kBf16>::ldE;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int col0 = nt * 8 + 2 * t;
    float q1[2], q2[2], w[2][3];
    float sdw[2][3] = {}, sdb[2] = {}, s1[2] = {}, s2[2] = {};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      q1[p] = __ldg(p1 + col0 + p);
      q2[p] = kAct == kGabor ? __ldg(p2 + col0 + p) : 0.f;
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) w[p][cc] = load_w(w0, cc * 1024 + col0 + p);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        if (row < rows) {
          const float ps[3] = {to_f(pos[row * ldE]), to_f(pos[row * ldE + 1]),
                               to_f(pos[row * ldE + 2])};
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const float x = cde<kBf16>(layer0_x(ps, w0, b0, col0 + p));
            const float gx =
                act_bwd_x<kAct, kBf16>(c[i][2 * h + p], x, q1[p], q2[p], gamma, s1[p], s2[p]);
            sdb[p] += gx;
            const float gr = cde<kBf16>(gx);
#pragma unroll
            for (int cc = 0; cc < 3; ++cc) {
              sdw[p][cc] = fmaf(ps[cc], gr, sdw[p][cc]);
              dp[i][h][cc] = fmaf(gr, w[p][cc], dp[i][h][cc]);
            }
          }
        }
      }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) sdw[p][cc] += __shfl_xor_sync(kFull, sdw[p][cc], off);
        sdb[p] += __shfl_xor_sync(kFull, sdb[p], off);
        s1[p] += __shfl_xor_sync(kFull, s1[p], off);
        s2[p] += __shfl_xor_sync(kFull, s2[p], off);
      }
    if (g == 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float fa, fb;
        param_factors<kAct>(q1[p], gamma, fa, fb);
        const int k = col0 + p;
        const float v[6] = {sdw[p][0], sdw[p][1], sdw[p][2], sdb[p], fa * s1[p], fb * s2[p]};
#pragma unroll
        for (int q = 0; q < (kAct == kGabor ? 6 : 5); ++q) {
          float* dst = part + q * 1024 + k;  // dW0 rows 0..2 | db0 | p1 | p2 (gabor)
          *dst = first ? v[q] : *dst + v[q];
        }
      }
    }
  }
};

template <bool kBf16, int kAct>
__global__ void __launch_bounds__(kThreads, 1)
garf_train_kernel(const float* __restrict__ origs, const float* __restrict__ dirs,
                  const float* __restrict__ t_start, const float* __restrict__ t_end,
                  const float* __restrict__ targets, GarfWeights W, int n_rays, int S,
                  float gamma, float density_scale, float grad_scale,
                  typename Mma<kBf16>::ET* act, float* cot, float* aux, float* block_part,
                  float* __restrict__ rgb_out, float* __restrict__ weights_out,
                  float* __restrict__ d_origs, float* __restrict__ d_dirs) {
  using M = Mma<kBf16>;
  using ET = typename M::ET;
  using L = GarfSmem<kBf16>;
  using Lay = ActLayout;
  constexpr int kR = L::kR, kMT = kR / 16, kComp = L::kComp, kF = kFlushK<kBf16>;
  constexpr int s16 = 16 / M::kK;  // k-steps of a 16-column part
  extern __shared__ __align__(16) unsigned char smem[];
  const GarfBufs<kBf16> s(smem);
  const size_t AW = Lay::total(), GW = kCotWidth;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const BlockRows br(n_rays, S, kR);
  float* part = block_part + static_cast<size_t>(blockIdx.x) * block_part_width<kAct>();
  s.zero();

  // ---- forward, tile by tile; one warp composites each ray ----
  for (int tb = 0; tb < br.rows; tb += kR) {
    const int rows = min(kR, br.rows - tb);
    const size_t row0 = br.row0 + tb;
    ET* a0 = act + row0 * AW;
    load_tile<kBf16>(origs, dirs, t_start, t_end, br, S, tb, rows, s);
    for (int idx = tid; idx < rows * 6; idx += blockDim.x) {
      const int r = idx / 6, c = idx % 6;
      a0[r * AW + c] = c < 3 ? s.E[r * L::ldE + c] : s.D[r * L::ldE + c - 3];
    }
    forward_tile<kBf16, kAct>(W, gamma, s, rows, a0, AW);

    const int j_first = tb / S, j_last = (tb + rows - 1) / S;
    for (int j = j_first + warp; j <= j_last; j += kWarps) {
      const int lo = max(tb, j * S) - tb, hi = min(tb + rows, (j + 1) * S) - tb;
      float* sj = s.comp + j * kComp;
      float carry = sj[0], ar = 0.f, ag = 0.f, ab = 0.f;
      for (int c0 = lo; c0 < hi; c0 += 32) {
        const int r = c0 + lane;
        const bool live = r < hi;
        float raw = 0.f, blk = 0.f, k0 = 0.f, k1 = 0.f, k2 = 0.f;
        if (live) {
          raw = s.dens[r];
          blk = -softplus8(raw - 1.f) * s.dist[r] * density_scale;
          k0 = 1.f / (1.f + expf(-s.logits[r * 3 + 0]));
          k1 = 1.f / (1.f + expf(-s.logits[r * 3 + 1]));
          k2 = 1.f / (1.f + expf(-s.logits[r * 3 + 2]));
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
          weights_out[row0 + r] = w;
        }
        carry += __shfl_sync(kFull, incl, 31);
      }
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
        if (tb + hi == (j + 1) * S)
          for (int k = 0; k < 3; ++k) rgb_out[(br.ray0 + j) * 3 + k] = sj[1 + k];
      }
    }
    __syncthreads();  // the next tile overwrites tq, dist, dens, logits and the tiles
  }

  // ---- loss gradient and compositing backward, one warp a ray ----
  for (int j = warp; j < br.nr; j += kWarps) {
    const int ray = br.ray0 + j;
    const size_t ray_row = static_cast<size_t>(ray) * S;
    const float g0 = grad_scale * (s.comp[j * kComp + 1] - __ldg(targets + ray * 3 + 0));
    const float g1 = grad_scale * (s.comp[j * kComp + 2] - __ldg(targets + ray * 3 + 1));
    const float g2 = grad_scale * (s.comp[j * kComp + 3] - __ldg(targets + ray * 3 + 2));
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
  __syncthreads();  // the seeded cotangents are visible to the block

  // ---- the net's backward, tile by tile: g <- act_bwd(g W^T) ----
  for (int tb = 0; tb < br.rows; tb += kR) {
    const int rows = min(kR, br.rows - tb);
    const size_t row0 = br.row0 + tb;
    const bool first = tb == 0;
    const ET* a0 = act + row0 * AW;
    float* c0 = cot + row0 * GW;
    // through activation layer i (1..7), which follows linear i (linear 8 for i = 7)
    auto epi = [&](int i, int k1, ET* out, int ld, float* enc, int k2, const float* add) {
      return GarfBwdEpi<kBf16, kAct>{
          k1, out, ld, c0 + gofs(i < 7 ? i : 8), add, a0 + Lay::rec(i) + Lay::width(i), AW,
          GW, W.p1[i], W.p2[i], gamma, part + aofs<kAct>(i),
          part + aofs<kAct>(i) + Lay::width(i), first, enc, 4, k2, rows};
    };
    load_tile<kBf16>(origs, dirs, t_start, t_end, br, S, tb, rows, s);
    // the logits' cotangent, K zero-padded to 16
    for (int idx = tid; idx < kR * 16; idx += blockDim.x) {
      const int r = idx >> 4, c = idx & 15;
      store_act(s.Q + r * L::ldQ + c, c < 3 && r < rows ? c0[r * GW + gofs(9) + c] : 0.f);
    }
    __syncthreads();
    // colour head 256 -> 3, through the colour activation (layer 7)
    tile_gemm<kBf16, kR, kF>(s.Q, L::ldQ, s16, nullptr, 0, 0, W.bwd[9], s.ring, 256 / 8,
                         epi(7, 256, s.P, L::ldP, nullptr, 0, nullptr));
    __syncthreads();
    // colour input [ci | dir]: the ci part is the cotangent of z2[:, :128]
    // (no activation; z1's share is added below), the dir part goes to ddir
    tile_gemm<kBf16, kR, kF>(s.P, L::ldP, 256 / M::kK, nullptr, 0, 0, W.bwd[8], s.ring, 144 / 8,
                         GarfBwdEpi<kBf16, -1>{128, s.Q, L::ldQ, c0 + gofs(7), nullptr,
                                               nullptr, AW, GW, nullptr, nullptr, gamma,
                                               nullptr, nullptr, first, s.ddir, 4, 3, rows});
    // the density column's cotangent at column 128, zeros up to 144
    for (int idx = tid; idx < kR * 16; idx += blockDim.x) {
      const int r = idx >> 4, c = idx & 15;
      store_act(s.Q + r * L::ldQ + 128 + c,
                c == 0 && r < rows ? c0[r * GW + gofs(7) + 128] : 0.f);
    }
    __syncthreads();
    tile_gemm<kBf16, kR, kF>(s.Q, L::ldQ, 144 / M::kK, nullptr, 0, 0, W.bwd[7], s.ring, 128 / 8,
                         epi(6, 128, s.P, L::ldP, nullptr, 0, nullptr));
    __syncthreads();
    tile_gemm<kBf16, kR, kF>(s.P, L::ldP, 128 / M::kK, nullptr, 0, 0, W.bwd[6], s.ring, 256 / 8,
                         epi(5, 256, s.Q, L::ldQ, nullptr, 0, nullptr));
    __syncthreads();
    tile_gemm<kBf16, kR, kF>(s.Q, L::ldQ, 256 / M::kK, nullptr, 0, 0, W.bwd[5], s.ring, 512 / 8,
                         epi(4, 512, s.P, L::ldP, nullptr, 0, nullptr));
    __syncthreads();
    // density-2 input [z1 | pos]: z1 also fed the colour input (+ g_ci, the
    // fp32 cotangent stored above), then z1's activation (layer 3); the pos
    // part goes to dpos
    tile_gemm<kBf16, kR, kF>(s.P, L::ldP, 512 / M::kK, nullptr, 0, 0, W.bwd[4], s.ring, 144 / 8,
                         epi(3, 128, s.Q, L::ldQ, s.dpos, 3, c0 + gofs(7)));
    __syncthreads();
    tile_gemm<kBf16, kR, kF>(s.Q, L::ldQ, 128 / M::kK, nullptr, 0, 0, W.bwd[3], s.ring, 128 / 8,
                         epi(2, 128, s.P, L::ldP, nullptr, 0, nullptr));
    __syncthreads();
    tile_gemm<kBf16, kR, kF>(s.P, L::ldP, 128 / M::kK, nullptr, 0, 0, W.bwd[2], s.ring, 256 / 8,
                         epi(1, 256, s.Q, L::ldQ, nullptr, 0, nullptr));
    __syncthreads();
    // linear 1 into layer 0: 1024 columns, 4 passes of the warps
    float dp[kMT][2][3] = {};
    tile_gemm<kBf16, kR, kF>(
        s.Q, L::ldQ, 256 / M::kK, nullptr, 0, 0, W.bwd[1], s.ring, 1024 / 8,
        L0Epi<kBf16, kAct>{s.E, static_cast<const ET*>(W.w0), W.b[0], W.p1[0], W.p2[0], gamma,
                           part, first, rows, dp});
    {  // d pos: the warp's row sums over its columns, then over the warps in order
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) {
            float v = dp[i][h][cc];
            v += __shfl_xor_sync(kFull, v, 1);
            v += __shfl_xor_sync(kFull, v, 2);
            if (t == 0) s.red[(warp * kR + 16 * i + g + 8 * h) * 3 + cc] = v;
          }
    }
    __syncthreads();
    if (tid < rows * 3) {  // d_origs = sum_s d_pos, d_dirs = sum_s (t_q d_pos + d_dir)
      const int r = tid / 3, c = tid % 3;
      float sum = s.dpos[r * 4 + c];
      for (int wp = 0; wp < kWarps; ++wp) sum += s.red[(wp * kR + r) * 3 + c];
      s.geo[r * 6 + c] = sum;
      s.geo[r * 6 + 3 + c] = s.tq[r] * sum + s.ddir[r * 4 + c];
    }
    __syncthreads();
    // per-ray sums over the tile's rows, in row order
    const int j_first = tb / S, j_last = (tb + rows - 1) / S;
    for (int idx = tid; idx < (j_last - j_first + 1) * 6; idx += blockDim.x) {
      const int j = j_first + idx / 6, q = idx % 6;
      const int lo = max(tb, j * S) - tb, hi = min(tb + rows, (j + 1) * S) - tb;
      float sum = 0.f;
      for (int r = lo; r < hi; ++r) sum += s.geo[r * 6 + q];
      s.comp[j * kComp + 4 + q] += sum;
    }
    __syncthreads();  // the next tile overwrites tq, geo and the tiles
  }
  for (int idx = tid; idx < br.nr * 6; idx += blockDim.x) {
    const int j = idx / 6, q = idx % 6;
    float* dst = q < 3 ? d_origs : d_dirs;
    dst[(br.ray0 + j) * 3 + q % 3] = s.comp[j * kComp + 4 + q];
  }
}

// ---- phase B: dW = A^T G, db = sum_rows G for linear layers 1..9 ----

// Linear 1's input is layer 0's activation, recomputed from the stored
// position while loading the tile; the other layers' inputs are stored. bf16
// on the tensor cores (`dw_tile_tc`); fp32 on the CUDA cores (`dw_tile`): a
// 3xTF32 variant of the tensor-core tile measured slower and, summing a
// split's rows in the tensor cores' truncating accumulator, missed the fp32
// tolerance on two dW (PERF.md).
template <bool kBf16, int kAct>
__global__ void __launch_bounds__(256)
dw_partial_kernel(const typename Mma<kBf16>::ET* __restrict__ act,
                  const float* __restrict__ cot, GemmPlan plan, GarfWeights W, float gamma,
                  float* __restrict__ part) {
  using ET = typename Mma<kBf16>::ET;
  const DwTile t(plan);
  const int ka = t.k0 + static_cast<int>(threadIdx.x) % kTile;  // < 1024: whole k-tiles
  const ET* W0 = static_cast<const ET*>(W.w0);
  const bool l1 = t.li == 0;
  const float q1 = l1 ? __ldg(W.p1[0] + ka) : 0.f;
  const float q2 = l1 && kAct == kGabor ? __ldg(W.p2[0] + ka) : 0.f;
  auto layer0 = [&](long long row) {
    const ET* pr = act + row * plan.AW;
    const float p[3] = {load_act(pr), load_act(pr + 1), load_act(pr + 2)};
    return cde<kBf16>(act_fwd<kAct>(cde<kBf16>(layer0_x(p, W0, W.b[0], ka)), q1, q2, gamma));
  };
  if constexpr (kBf16) {
    __shared__ __align__(16) DwTcSmem sm;
    if (l1)
      dw_tile_tc(plan, t, cot, layer0, sm, part);
    else
      dw_tile_stored_tc(act, cot, plan, t, sm, part);
  } else {
    __shared__ __align__(16) DwSmem sm;
    if (l1)
      dw_tile<false>(plan, t, cot, layer0, sm, part);
    else
      dw_tile_stored<false>(act, cot, plan, t, sm, part);
  }
}

__host__ __device__ constexpr int lin_in(int l) {
  return l == 0 ? 3 : l == 1 ? 1024 : l == 2 ? 256 : l == 3 ? 128 : l == 4 ? 131
       : l == 5 ? 512 : l == 6 ? 256 : l == 7 ? 128 : l == 8 ? 131 : 256;
}
__host__ __device__ constexpr int lin_out(int l) {
  return l == 0 ? 1024 : l == 1 ? 256 : l == 2 ? 128 : l == 3 ? 128 : l == 4 ? 512
       : l == 5 ? 256 : l == 6 ? 128 : l == 7 ? 129 : l == 8 ? 256 : 3;
}

GemmPlan make_plan(long long rows, int splits) {
  using Lay = ActLayout;
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

template <bool kBf16, int kAct>
cudaError_t launch_train(const TrainArgs& a) {
  using L = GarfSmem<kBf16>;
  using ET = typename Mma<kBf16>::ET;
  static_assert(L::kBytes <= kMaxSmemBytes, "the train tile must fit in shared memory");
  auto kernel = garf_train_kernel<kBf16, kAct>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const int rpb = rays_per_block(a.S, L::kR);
  const int blocks = (a.n_rays + rpb - 1) / rpb;
  ET* act = static_cast<ET*>(a.act);
  kernel<<<blocks, kThreads, L::kBytes, a.stream>>>(
      a.origs, a.dirs, a.t_start, a.t_end, a.targets, a.W, a.n_rays, a.S, a.gamma,
      a.density_scale, a.grad_scale, act, a.cot, a.aux, a.block_part, a.rgb_out, a.weights_out,
      a.d_origs, a.d_dirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const GemmPlan plan = make_plan(static_cast<long long>(a.n_rays) * a.S, a.splits);
  dim3 grid(plan.tiles, a.splits);
  dw_partial_kernel<kBf16, kAct><<<grid, 256, 0, a.stream>>>(act, a.cot, plan, a.W, a.gamma,
                                                            a.part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the flat output: every dW (in, out) in layer order, every db, then the
  // activation parameters as the block partials hold them
  const long long wtot = kW0 + plan.wtot, btot = 1024 + plan.btot;
  Segments by_split{};  // phase B: layers 1..9
  by_split.n = 2;
  by_split.begin[1] = plan.wtot;
  by_split.begin[2] = plan.wtot + plan.btot;
  by_split.dst[0] = kW0;
  by_split.dst[1] = wtot + 1024;
  err = reduce(a.part, a.splits, by_split, a.grads, a.stream);
  if (err != cudaSuccess) return err;
  Segments by_block{};  // layer 0's dW and db, every activation parameter
  by_block.n = 3;
  by_block.begin[1] = kW0;
  by_block.begin[2] = kW0 + 1024;
  by_block.begin[3] = block_part_width<kAct>();
  by_block.dst[1] = wtot;
  by_block.dst[2] = wtot + btot;
  return reduce(a.block_part, blocks, by_block, a.grads, a.stream);
}

template <int kAct>
cudaError_t train_family(const TrainArgs& a, bool bf16) {
  return bf16 ? launch_train<true, kAct>(a) : launch_train<false, kAct>(a);
}

}  // namespace
}  // namespace garf
}  // namespace netpu
