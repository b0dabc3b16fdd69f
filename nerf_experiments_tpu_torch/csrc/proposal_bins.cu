// The serving proposal stage of a hierarchical BARF config in one launch, for
// one NVIDIA H100: rays -> the proposal net's composited rgb and the fine bins.
//
// Replaces no Pallas kernel: the JAX package leaves this stage to XLA
// (`nerf_experiments_tpu/systems/barf.py`, forward's coarse stage). It fuses
// that stage with the compositing forward of K1 (`render.cu`). For each ray
// and each of its B equidistant coarse bins: the midpoint, the BARF-masked
// Fourier encodings of position and direction (identity included), the
// proposal NerfMLP (one segment, delayed direction: P -> D, D -> D ...,
// D -> D + 1, then [hidden | dir] -> C -> 3), softplus-8 density and sigmoid
// rgb, alpha compositing, and inverse-CDF resampling of S fine bins
// (`sampling.sample_pdf` without a generator), written as (t_start, t_end).
//
// What bounds it on the H100: operations. A point costs 11,200
// multiply-adds at the north-star proposal (64x1, encodings 10 / 4): 11.7
// GFLOP a chunk of 8192 rays x 64 bins, 12 us at the bf16 tensor-core rate;
// its bytes (rays in, bins and rgb out, 2.4 MB) take 0.7 us. Run eagerly the
// stage is tens of launches a chunk whose intermediates (60-260 MB each) go
// to HBM and back. Here:
//   * one warp owns one ray at a time (a grid sized to the card, rays strided
//     over its warps), so compositing and resampling are shuffles inside the
//     warp and no block barrier follows the weights' load;
//   * the weights (the wrapper's packed B operands, `train_megakernel.pack_b`
//     order, ~25 KB at 64x1) and biases sit in shared memory, loaded once a
//     block;
//   * the warp encodes 16 of its ray's points at a time into a staging tile
//     in shared memory (the direction once a ray: its value is the same for
//     every point); each layer is a 16 x N product on `mma.sync` (bf16
//     operands, fp32 accumulators) whose accumulators, plus bias, ReLU and the
//     round to bf16 where `linear_apply` rounds, are repacked in registers as
//     the next layer's A fragments, so no activation leaves the registers;
//   * the arithmetic around the products follows the plain stage's: positions
//     o + t d and the encodings' arguments rounded as its separate tensor ops,
//     `sincosf` (accurate: the arguments reach 2^9 |x| scale), K1's shuffle
//     scan, and the resample's reciprocal quantile step, which PyTorch's CUDA
//     division by a host scalar takes. Only the products' order of adds
//     differs (the tensor cores' against cuBLAS's), so a bf16 rounding can flip.
#include "flagship_common.cuh"

namespace {

using netpu::kFull;
using netpu::round16;
using netpu::round4;
using netpu::warp_scan;
using M = netpu::Mma<true>;
using Frag = M::Frag;
using BF = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kEps = 1e-8f;  // `sampling.sample_pdf`'s eps

// Each layer's B operand (packed in fragment order) and fp32 bias, in the
// order segment layers 0..n_hidden, colour layers 0, 1.
struct Weights {
  const Frag* w[netpu::kMaxLayers];
  const float* b[netpu::kMaxLayers];
};

// Shared memory: every layer's B fragments, the biases (each padded to 4),
// the B + 1 coarse edges and the BARF window of both encodings; then per warp
// the position staging tile (16 rows), the direction row, and the ray's
// density (then weights), rgb, cdf and fine t. `proposal_bins.smem_bytes`
// computes the same total.
struct Layout {
  int D, n_hidden, P, Q, B, S, Lp, Ld;
  __host__ __device__ int C() const { return D / 2; }
  __host__ __device__ int n_layers() const { return n_hidden + 3; }
  __host__ __device__ int width(int l) const {
    if (l < n_hidden) return D;
    if (l == n_hidden) return D + 1;  // the density column last
    return l == n_hidden + 1 ? C() : 3;
  }
  __host__ __device__ int ksteps(int l) const {
    if (l == 0) return round16(P) / 16;
    if (l <= n_hidden) return D / 16;
    if (l == n_hidden + 1) return D / 16 + round16(Q) / 16;
    return C() / 16;
  }
  __host__ __device__ int frags(int l) const { return round16(width(l)) / 8 * ksteps(l) * 32; }
  __host__ __device__ int ldp() const { return round16(P) + M::kPad; }
  __host__ __device__ size_t weight_bytes() const {
    size_t n = 0;
    for (int l = 0; l < n_layers(); ++l) n += frags(l);
    return n * sizeof(Frag);
  }
  __host__ __device__ int bias_floats() const {
    int n = 0;
    for (int l = 0; l < n_layers(); ++l) n += round4(width(l));
    return n;
  }
  __host__ __device__ size_t block_bytes() const {
    return weight_bytes() +
           4 * static_cast<size_t>(bias_floats() + round4(B + 1) + round4(Lp + Ld));
  }
  __host__ __device__ size_t warp_bytes() const {
    return 2 * static_cast<size_t>(16 * ldp() + round16(Q)) +
           4 * static_cast<size_t>(4 * B + round4(B + 1) + round4(S));
  }
  __host__ __device__ size_t bytes() const { return block_bytes() + kWarps * warp_bytes(); }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulators of n8 tiles 0..2K (c[j][e] = C[g + 8 (e >> 1)][8 j + 2 t +
// (e & 1)]) plus bias, ReLU when asked and the round to bf16, as the A
// fragments of the next product's K k-steps: k-step ks takes n8 tiles 2 ks
// (its columns 0..7) and 2 ks + 1 (8..15), rows g and g + 8.
template <int K>
__device__ __forceinline__ void to_a(const float (&c)[2 * K][4], const float* bias, bool relu,
                                     uint32_t (&a)[K][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < K; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * ks + 8 * h + 2 * t;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = c[2 * ks + h][e] + bias[col + (e & 1)];
        if (relu) v[e] = fmaxf(v[e], 0.f);
      }
      a[ks][2 * h] = pack_bf16(v[0], v[1]);
      a[ks][2 * h + 1] = pack_bf16(v[2], v[3]);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc[j] += A B[:, n8 tile nt0 + j] over K k-steps of A held in registers;
// w is the layer's packed B (ks_total k-steps a tile), read from k-step ks0.
template <int K, int N>
__device__ __forceinline__ void gemm_regs(float (&acc)[N][4], const uint32_t (&a)[K][4],
                                          const Frag* w, int ks_total, int ks0, int nt0,
                                          int lane) {
#pragma unroll
  for (int ks = 0; ks < K; ++ks) {
    const M::A af{{a[ks][0], a[ks][1], a[ks][2], a[ks][3]}};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      M::B b;
      M::load_b(b, w[((nt0 + j) * ks_total + ks0 + ks) * 32 + lane]);
      M::mma(acc[j], af, b);
    }
  }
}

// The same with A from a shared tile (row stride ld; 0 repeats its one row)
// over `steps` k-steps.
template <int N>
__device__ __forceinline__ void gemm_smem(float (&acc)[N][4], const BF* a, int ld, int steps,
                                          const Frag* w, int ks_total, int ks0, int lane) {
  for (int ks = 0; ks < steps; ++ks) {
    M::A af;
    M::load_a(af, a, ld, 0, 16 * ks, lane);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      M::B b;
      M::load_b(b, w[(j * ks_total + ks0 + ks) * 32 + lane]);
      M::mma(acc[j], af, b);
    }
  }
}

__device__ __forceinline__ float softplus8(float x) {  // as `models.common.softplus8`
  return x > 8.f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float pick(float x, float y, float z, int c) {
  return c == 0 ? x : (c == 1 ? y : z);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
proposal_bins_kernel(const float* __restrict__ origs, const float* __restrict__ dirs,
                     const float* __restrict__ edges_in, Weights wts, Layout lay, int n_rays,
                     float scale_pos, float scale_dir, float alpha_pos, float alpha_dir,
                     float density_scale, float far, float* __restrict__ t_start,
                     float* __restrict__ t_end, float* __restrict__ rgb_out) {
  constexpr int C = D / 2, NT = D / 8, KD = D / 16, NC = C / 8, KC = C / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H = lay.n_hidden, B = lay.B, S = lay.S, Lp = lay.Lp, Ld = lay.Ld;
  const int Q = lay.Q, ldp = lay.ldp();
  const int kp = round16(lay.P) / 16, kq = round16(Q) / 16;

  // the block's part: each layer's weights and bias, the edges, the window
  unsigned char* at = smem;
  float* f = reinterpret_cast<float*>(smem + lay.weight_bytes());
  for (int l = 0; l < lay.n_layers(); ++l) {
    const uint4* src = reinterpret_cast<const uint4*>(wts.w[l]);
    uint4* dst = reinterpret_cast<uint4*>(at);
    for (int i = tid; i < lay.frags(l) / 2; i += kThreads) dst[i] = src[i];
    for (int i = tid; i < lay.width(l); i += kThreads) f[i] = wts.b[l][i];
    at += static_cast<size_t>(lay.frags(l)) * sizeof(Frag);
    f += round4(lay.width(l));
  }
  float* edges = f;
  for (int i = tid; i <= B; i += kThreads) edges[i] = edges_in[i];
  float* mask = edges + round4(B + 1);
  netpu::barf_window(mask, Lp, Ld, alpha_pos, alpha_dir);
  const float* mask_d = mask + Lp;
  // layer 0, the hidden layers 1..H-1, the last segment layer H, the colour head
  const Frag* w_in = reinterpret_cast<const Frag*>(smem);
  const Frag* w_mid = w_in + lay.frags(0);
  const Frag* w_last = w_mid + (H - 1) * NT * KD * 32;
  const Frag* w_c0 = w_last + lay.frags(H);
  const Frag* w_c1 = w_c0 + lay.frags(H + 1);
  const float* b_in = reinterpret_cast<const float*>(smem + lay.weight_bytes());
  const float* b_mid = b_in + D;
  const float* b_last = b_mid + (H - 1) * D;
  const float* b_c0 = b_last + round4(D + 1);
  const float* b_c1 = b_c0 + C;

  // the warp's part
  unsigned char* mine = smem + lay.block_bytes() + warp * lay.warp_bytes();
  BF* ps = reinterpret_cast<BF*>(mine);  // 16 x ldp: the points' position encodings
  BF* qs = ps + 16 * ldp;                // round16(Q): the ray's direction encoding
  float* dens = reinterpret_cast<float*>(qs + round16(Q));  // B: density, then weights
  float* rgb = dens + B;                                      // B x 3
  float* cdf = rgb + 3 * B;                                   // B + 1
  float* ts = cdf + round4(B + 1);                            // S
  // the padding columns of both encodings stay 0
  for (int i = lane; i < 16 * ldp + round16(Q); i += 32) ps[i] = __float2bfloat16(0.f);
  __syncthreads();

  const float u_step = 1.f / static_cast<float>(S);
  for (int ray = blockIdx.x * kWarps + warp; ray < n_rays; ray += gridDim.x * kWarps) {
    const float o0 = origs[ray * 3], o1 = origs[ray * 3 + 1], o2 = origs[ray * 3 + 2];
    const float d0 = dirs[ray * 3], d1 = dirs[ray * 3 + 1], d2 = dirs[ray * 3 + 2];
    // the direction encoding: identity, cos block, sin block (channel-major)
    if (lane < 3) qs[lane] = __float2bfloat16(pick(d0, d1, d2, lane));
    for (int i = lane; i < 3 * Ld; i += 32) {
      const int c = i / Ld, l = i % Ld;
      float s, co;
      sincosf(__fmul_rn(pick(d0, d1, d2, c), ldexpf(scale_dir, l)), &s, &co);
      qs[3 + i] = __float2bfloat16(__fmul_rn(mask_d[l], co));
      qs[3 + 3 * Ld + i] = __float2bfloat16(__fmul_rn(mask_d[l], s));
    }

    for (int m = 0; m < B; m += 16) {  // 16 of the ray's points at a time
      // position encodings of points m..m+15 into ps
      auto pos = [&](int r, int c) {
        const float tq = (edges[m + r] + edges[m + r + 1]) / 2.f;
        return __fadd_rn(pick(o0, o1, o2, c), __fmul_rn(tq, pick(d0, d1, d2, c)));
      };
      for (int i = lane; i < 48; i += 32)
        ps[(i / 3) * ldp + i % 3] = __float2bfloat16(pos(i / 3, i % 3));
      for (int i = lane; i < 48 * Lp; i += 32) {
        const int r = i / (3 * Lp), c = (i / Lp) % 3, l = i % Lp;
        float s, co;
        sincosf(__fmul_rn(pos(r, c), ldexpf(scale_pos, l)), &s, &co);
        BF* row = ps + r * ldp + 3 + c * Lp + l;
        row[0] = __float2bfloat16(__fmul_rn(mask[l], co));
        row[3 * Lp] = __float2bfloat16(__fmul_rn(mask[l], s));
      }
      __syncwarp();

      // segment: P -> D (ReLU), D -> D (ReLU) ..., D -> D + 1 (no ReLU)
      float acc[NT][4];
      uint32_t h[KD][4];
      zero(acc);
      gemm_smem(acc, ps, ldp, kp, w_in, kp, 0, lane);
      to_a<KD>(acc, b_in, true, h);
      for (int l = 1; l < H; ++l) {
        zero(acc);
        gemm_regs(acc, h, w_mid + (l - 1) * NT * KD * 32, KD, 0, 0, lane);
        to_a<KD>(acc, b_mid + (l - 1) * D, true, h);
      }
      float dacc[1][4];
      zero(acc);
      zero(dacc);
      gemm_regs(acc, h, w_last, KD, 0, 0, lane);
      gemm_regs(dacc, h, w_last, KD, 0, NT, lane);  // n8 tile NT: the density column D
      to_a<KD>(acc, b_last, false, h);
      if (t == 0) {  // column D of rows g and g + 8
        const float bd = b_last[D];
        dens[m + g] = softplus8(__bfloat162float(__float2bfloat16(dacc[0][0] + bd)));
        dens[m + g + 8] = softplus8(__bfloat162float(__float2bfloat16(dacc[0][2] + bd)));
      }
      // colour head: [hidden | dir] -> C (ReLU), C -> 3
      float cacc[NC][4];
      uint32_t hc[KC][4];
      zero(cacc);
      gemm_regs(cacc, h, w_c0, KD + kq, 0, 0, lane);
      gemm_smem(cacc, qs, 0, kq, w_c0, KD + kq, KD, lane);
      to_a<KC>(cacc, b_c0, true, hc);
      float lacc[1][4];
      zero(lacc);
      gemm_regs(lacc, hc, w_c1, KC, 0, 0, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * t + (e & 1), r = g + 8 * (e >> 1);
        if (col < 3) {
          const float logit = __bfloat162float(__float2bfloat16(lacc[0][e] + b_c1[col]));
          rgb[(m + r) * 3 + col] = 1.f / (1.f + expf(-logit));
        }
      }
      __syncwarp();  // the next points overwrite ps
    }

    // compositing, as K1's forward: 32 samples a step, the prefix carried
    float carry = 0.f, ar = 0.f, ag = 0.f, ab = 0.f;
    for (int base = 0; base < B; base += 32) {
      const int i = base + lane;
      const bool live = i < B;
      float blk = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
      if (live) {
        blk = -dens[i] * (edges[i + 1] - edges[i]) * density_scale;
        c0 = rgb[i * 3];
        c1 = rgb[i * 3 + 1];
        c2 = rgb[i * 3 + 2];
      }
      const float incl = warp_scan(blk, lane);
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float T = expf(carry + excl);
      const float wt = T * (1.f - expf(blk));
      if (live) {
        dens[i] = wt;
        ar += wt * c0;
        ag += wt * c1;
        ab += wt * c2;
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
      rgb_out[ray * 3] = ar;
      rgb_out[ray * 3 + 1] = ag;
      rgb_out[ray * 3 + 2] = ab;
    }

    // resampling, as `sampling.sample_pdf` without a generator: pdf of
    // w + eps, cdf with a leading 0, quantiles (k + 0.5) / S, the last bin
    // whose lower cdf edge is <= u, and its linear placement
    float total = 0.f;
    for (int i = lane; i < B; i += 32) total += dens[i] + kEps;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(kFull, total, off);
    carry = 0.f;
    if (lane == 0) cdf[0] = 0.f;
    for (int base = 0; base < B; base += 32) {
      const int i = base + lane;
      const float incl = warp_scan(i < B ? (dens[i] + kEps) / total : 0.f, lane);
      if (i < B) cdf[i + 1] = carry + incl;
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
    for (int k = lane; k < S; k += 32) {
      const float u = __fmul_rn(static_cast<float>(k) + 0.5f, u_step);
      int lo = 0, hi = B + 1;  // the first cdf entry above u
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cdf[mid] > u) hi = mid; else lo = mid + 1;
      }
      const int idx = min(max(lo - 1, 0), B - 1);
      const float d_cdf = cdf[idx + 1] - cdf[idx];
      const float k_slope = (edges[idx + 1] - edges[idx]) / (d_cdf < kEps ? 1.f : d_cdf);
      const float base = __fsub_rn(edges[idx], __fmul_rn(cdf[idx], k_slope));
      ts[k] = __fadd_rn(base, __fmul_rn(u, k_slope));
    }
    __syncwarp();
    const size_t row = static_cast<size_t>(ray) * S;
    for (int k = lane; k < S; k += 32) {
      t_start[row + k] = ts[k];
      t_end[row + k] = k + 1 < S ? ts[k + 1] : far;
    }
    __syncwarp();  // the next ray overwrites qs, dens, rgb, cdf and ts
  }
}

template <int D>
cudaError_t launch(const float* origs, const float* dirs, const float* edges, const Weights& wts,
                   const Layout& lay, int n_rays, float scale_pos, float scale_dir,
                   float alpha_pos, float alpha_dir, float density_scale, float far,
                   float* t_start, float* t_end, float* rgb, cudaStream_t stream) {
  const size_t bytes = lay.bytes();
  if (bytes > netpu::kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = proposal_bins_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  // every resident warp takes a ray, then the next one a grid's warps on
  const int wanted = (n_rays + kWarps - 1) / kWarps;
  const int blocks = wanted < per_sm * sms ? wanted : (per_sm > 0 ? per_sm : 1) * sms;
  kernel<<<blocks, kThreads, bytes, stream>>>(origs, dirs, edges, wts, lay, n_rays, scale_pos,
                                              scale_dir, alpha_pos, alpha_dir, density_scale,
                                              far, t_start, t_end, rgb);
  return cudaGetLastError();
}

}  // namespace

// origs, dirs (n_rays, 3); edges (B + 1): the coarse bins' edges from near to
// far; w_ptrs / b_ptrs: the n_hidden + 3 layers' B operands packed by
// `train_megakernel.pack_b` (bf16; the last segment layer with its density
// column) and fp32 biases, in the order segment, colour head; D the hidden
// width (32, 64 or 128), Lp / Ld the encodings' levels. Outputs t_start,
// t_end (n_rays, S) and rgb (n_rays, 3).
extern "C" int netpu_proposal_bins(const float* origs, const float* dirs, const float* edges,
                                   const void* const* w_ptrs, const float* const* b_ptrs,
                                   int n_layers, int n_rays, int B, int S, int D, int n_hidden,
                                   int Lp, int Ld, float scale_pos, float scale_dir,
                                   float alpha_pos, float alpha_dir, float density_scale,
                                   float far, float* t_start, float* t_end, float* rgb,
                                   void* stream) {
  const Layout lay{D, n_hidden, 3 + 6 * Lp, 3 + 6 * Ld, B, S, Lp, Ld};
  if (n_hidden < 1 || n_layers != lay.n_layers() || n_layers > netpu::kMaxLayers || B < 16 ||
      B % 16 != 0 || S < 1 || Lp < 0 || Ld < 0 || (D != 32 && D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaGetLastError());
  Weights wts{};
  for (int l = 0; l < n_layers; ++l) {
    wts.w[l] = static_cast<const Frag*>(w_ptrs[l]);
    wts.b[l] = b_ptrs[l];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto launch_fn) {
    return static_cast<int>(launch_fn(origs, dirs, edges, wts, lay, n_rays, scale_pos, scale_dir,
                                      alpha_pos, alpha_dir, density_scale, far, t_start, t_end,
                                      rgb, st));
  };
  if (D == 32) return go(launch<32>);
  return D == 64 ? go(launch<64>) : go(launch<128>);
}
