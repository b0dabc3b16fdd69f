// Forward-only render of the flagship BARF radiance field for one NVIDIA H100:
// rays + t-bins -> rgb, opacity, depth and (optionally) per-sample weights.
//
// Replaces the TPU kernel `nerf_experiments_tpu/ops/train_megakernel.py:
// _render_kernel` (Pallas, entry `flagship_render`); K11
// (`ops/render_megakernel.py`) launches it too. For every sample it computes
// the BARF-masked Fourier encodings of position and direction (identity
// included), the 2-segment ReLU MLP (the position encoding re-enters the second
// segment), the density head with softplus-8, the colour head with the direction
// encoding and a sigmoid, and middle-point alpha compositing along the ray.
//
// What bounds it on the H100: arithmetic. Each sample costs 658,944
// multiply-adds at the flagship width (4x256, 2 segments), 1.38 TFLOP at 8192
// rays x 128 samples: 1.40 ms at the bf16 tensor-core rate (989 TFLOP/s),
// 2.8 ms at the TF32 rate (3xTF32 does three products, 8.4 ms). The TPU design
// holds a 2048-row tile and every weight in 24 MB of VMEM; a Hopper block has
// at most 227 KB of shared memory, so here:
//   * a block owns kR / S rays when S <= kR, else one ray, and walks their
//     samples in kR-row tiles (`flagship_common.cuh`; kR = 64, or 32 for
//     layers too wide for a 64-row tile): the tile's activations stay in
//     shared memory in the compute type, beside the warps' cp.async rings of
//     weight fragments (120 KB bf16, 216 KB fp32 at the flagship width; one
//     block per SM), and every product runs on the tensor cores (`tile_gemm`:
//     mma.sync, weights streamed from L2);
//   * compositing: one warp a ray (warp j % 8 for the tile's ray j) runs a
//     shuffle scan over the ray's samples in the tile, 32 at a time, with the
//     transmittance and the colour sums carried in shared memory from tile to
//     tile, so the ray finishes inside the block and no per-sample value goes
//     to device memory unless the weights are asked for;
//   * ragged edges: a tile past the end of the block's rows (S = 100: 64 + 36)
//     computes its idle rows and stores none of them; hidden and colour
//     widths that are not multiples of 16 run zero-padded.
// With bf16 the products take bf16 operands and accumulate in fp32, and every
// layer output is rounded to bf16 where the TPU kernel rounds (`cde`); density
// and colour logits stay fp32.
#include "flagship_common.cuh"

namespace {

using namespace netpu;

constexpr int kComp = 8;  // per-ray compositing state: carry, r, g, b, opacity, depth

// fp32 arrays after the compute-type tiles, in this order
__host__ __device__ size_t render_floats(int Lp, int Ld, int kR) {
  return static_cast<size_t>(kR) * 6 + round4(Lp + Ld) + kR * kComp;
}

template <bool kBf16, int kR>
__global__ void __launch_bounds__(kThreads, 1)
flagship_render_kernel(const float* __restrict__ origs, const float* __restrict__ dirs,
                       const float* __restrict__ t_start, const float* __restrict__ t_end,
                       TileWeights wts, int n_rays, int S, int n_hidden, int D, int C, int Lp,
                       int Ld, float scale, float alpha_pos, float alpha_dir,
                       float density_scale, float* __restrict__ out,
                       float* __restrict__ weights_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = 3 + 6 * Lp, Q = 3 + 6 * Ld;
  const Layout lay{P, Q, D, C, n_hidden + 1};
  const TileSmem<kBf16> tl(P, Q, D, C, kR);
  float* f = reinterpret_cast<float*>(smem + tl.f32_offset());
  float* dens = f;                        // kR
  float* logits = dens + kR;              // kR x 3
  float* tq = logits + 3 * kR;            // kR
  float* dist = tq + kR;                  // kR
  float* mask = dist + kR;                // Lp + Ld
  float* comp = mask + round4(Lp + Ld);   // kR x kComp
  const TileBufs<kBf16> s(tl, smem, dens, logits);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rpb = rays_per_block(S, kR);
  const int ray0 = blockIdx.x * rpb;
  const int nr = min(rpb, n_rays - ray0);
  const int block_rows = nr * S;
  const size_t row_base = static_cast<size_t>(ray0) * S;

  s.zero();
  barf_window(mask, Lp, Ld, alpha_pos, alpha_dir);
  for (int i = tid; i < kR * kComp; i += blockDim.x) comp[i] = 0.f;
  const TileStore<typename Mma<kBf16>::ET> none{nullptr, 0, nullptr, 0};

  for (int tb = 0; tb < block_rows; tb += kR) {
    const int rows = min(kR, block_rows - tb);
    for (int r = tid; r < rows; r += blockDim.x) {
      const float ts = t_start[row_base + tb + r], te = t_end[row_base + tb + r];
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
    forward_tile<kBf16, kR>(lay, wts, s, rows, none);

    // compositing: warp w takes the tile's rays w, w + 8, ...
    const int j_first = tb / S, j_last = (tb + rows - 1) / S;
    for (int j = j_first + warp; j <= j_last; j += kWarps) {
      const int lo = max(tb, j * S) - tb, hi = min(tb + rows, (j + 1) * S) - tb;
      float* st = comp + j * kComp;
      float carry = st[0], ar = 0.f, ag = 0.f, ab = 0.f, ao = 0.f, ad = 0.f;
      for (int c0 = lo; c0 < hi; c0 += 32) {
        const int r = c0 + lane;
        const bool live = r < hi;
        float blk = 0.f, t = 0.f, k0 = 0.f, k1 = 0.f, k2 = 0.f;
        if (live) {
          blk = -softplus8(dens[r]) * dist[r] * density_scale;
          t = tq[r];
          k0 = 1.f / (1.f + expf(-logits[r * 3 + 0]));
          k1 = 1.f / (1.f + expf(-logits[r * 3 + 1]));
          k2 = 1.f / (1.f + expf(-logits[r * 3 + 2]));
        }
        const float incl = warp_scan(blk, lane);
        float excl = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) excl = 0.f;
        const float w = expf(carry + excl) * (1.f - expf(blk));
        if (live) {
          ar += w * k0;
          ag += w * k1;
          ab += w * k2;
          ao += w;
          ad += w * t;
          if (weights_out) weights_out[row_base + tb + r] = w;
        }
        carry += __shfl_sync(kFull, incl, 31);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ar += __shfl_xor_sync(kFull, ar, off);
        ag += __shfl_xor_sync(kFull, ag, off);
        ab += __shfl_xor_sync(kFull, ab, off);
        ao += __shfl_xor_sync(kFull, ao, off);
        ad += __shfl_xor_sync(kFull, ad, off);
      }
      if (lane == 0) {
        st[0] = carry;
        st[1] += ar;
        st[2] += ag;
        st[3] += ab;
        st[4] += ao;
        st[5] += ad;
        if (tb + hi == (j + 1) * S) {  // the ray's last sample
          float* o5 = out + static_cast<size_t>(ray0 + j) * 5;
          for (int k = 0; k < 5; ++k) o5[k] = st[1 + k];
        }
      }
    }
    __syncthreads();  // the next tile overwrites tq, dist, dens, logits and the tiles
  }
}

template <bool kBf16, int kR>
cudaError_t launch(const float* origs, const float* dirs, const float* t_start,
                   const float* t_end, const TileWeights& wts, int n_rays, int S,
                   int n_hidden, int D, int C, int Lp, int Ld, float scale,
                   float alpha_pos, float alpha_dir, float density_scale, float* out,
                   float* weights_out, cudaStream_t stream) {
  const int P = 3 + 6 * Lp, Q = 3 + 6 * Ld;
  const size_t bytes =
      TileSmem<kBf16>(P, Q, D, C, kR).f32_offset() + render_floats(Lp, Ld, kR) * sizeof(float);
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = flagship_render_kernel<kBf16, kR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int rpb = rays_per_block(S, kR);
  const unsigned blocks = static_cast<unsigned>((n_rays + rpb - 1) / rpb);
  kernel<<<blocks, kThreads, bytes, stream>>>(origs, dirs, t_start, t_end, wts, n_rays, S,
                                              n_hidden, D, C, Lp, Ld, scale, alpha_pos,
                                              alpha_dir, density_scale, out, weights_out);
  return cudaGetLastError();
}

}  // namespace

// origs, dirs (n_rays, 3); t_start, t_end (n_rays, S); wf_ptrs: the 2 (n_hidden
// + 1) + 2 layers' forward B operands in the order segment 1, segment 2,
// colour head, packed by `train_megakernel.pack_b` (bf16 when bf16 != 0, else
// fp32 hi / lo pairs); b_ptrs: the biases, fp32; w_density: W[:, D] of the last
// segment layer in the compute type; tile_rows: the row tile kR, 64 or 32
// (`train_megakernel.tile_rows`: the largest whose shared memory fits).
// out (n_rays, 5) = [r, g, b, opacity, depth]; weights_out (n_rays, S) or null.
extern "C" int netpu_flagship_render(const float* origs, const float* dirs,
                                     const float* t_start, const float* t_end,
                                     const void* const* wf_ptrs, const float* const* b_ptrs,
                                     const void* w_density, int n_layers, int bf16,
                                     int tile_rows, int n_rays, int S, int n_hidden, int D,
                                     int C, int Lp, int Ld, float scale, float alpha_pos,
                                     float alpha_dir, float density_scale, float* out,
                                     float* weights_out, void* stream) {
  if (n_hidden < 1 || n_layers != 2 * (n_hidden + 1) + 2 || n_layers > kMaxLayers ||
      (tile_rows != 64 && tile_rows != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  TileWeights wts{};
  for (int i = 0; i < n_layers; ++i) {
    wts.fwd[i] = wf_ptrs[i];
    wts.b[i] = b_ptrs[i];
  }
  wts.w_density = w_density;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto launch_fn) {
    return static_cast<int>(launch_fn(origs, dirs, t_start, t_end, wts, n_rays, S, n_hidden, D,
                                      C, Lp, Ld, scale, alpha_pos, alpha_dir, density_scale, out,
                                      weights_out, st));
  };
  if (bf16) return tile_rows == 64 ? go(launch<true, 64>) : go(launch<true, 32>);
  return tile_rows == 64 ? go(launch<false, 64>) : go(launch<false, 32>);
}
