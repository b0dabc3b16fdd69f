// Phase B of the training kernels (`flagship_train.cu`, `garf_train.cuh`,
// `fused_mlp.cu`): dW = A^T G and db = sum_rows G for a chain of linear layers,
// with A read from the activation workspace (fp32 or bf16) and G from the fp32
// cotangent workspace that phase A wrote. A tiled GEMM split over the rows
// into fixed partials; `reduce` adds the partials in a fixed order. No
// atomics: two launches give bitwise-equal gradients. Two tile bodies:
// `dw_tile` on the CUDA cores (the fp32 routes of the flagship and GARF train
// kernels, the fused MLP chain) and `dw_tile_tc` on the tensor cores (the
// flagship and GARF train kernels in bf16).
#pragma once

#include "flagship_common.cuh"

namespace netpu {

constexpr int kTile = 128;  // phase B output tile (k x n)
constexpr int kChunk = 32;  // phase B rows per shared-memory stage
constexpr int kMaxSegs = 3;

__device__ __forceinline__ float load_act(const float* p) { return *p; }
__device__ __forceinline__ float load_act(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct GemmLayer {
  int a1, k1, a2, k2;  // input columns: act[a1 : a1 + k1] then act[a2 : a2 + k2]
  int g, n;            // cotangent columns cot[g : g + n]
  int w_off, b_off;    // offsets of dW (k1 + k2, n) and db (n) in a split's slice
  int tiles_n, first_tile;

  // the workspace column of input ka, or -1 past the layer's inputs
  __device__ int a_col(int ka) const {
    return ka < k1 ? a1 + ka : (ka < k1 + k2 ? a2 + ka - k1 : -1);
  }
};

struct GemmPlan {
  GemmLayer layer[kMaxLayers];
  int n_layers, tiles, wtot, btot;
  int AW, GW;
  long long rows, rows_per_split;

  GemmPlan(int act_width, int cot_width, long long n_rows, int splits)
      : n_layers(0), tiles(0), wtot(0), btot(0), AW(act_width), GW(cot_width), rows(n_rows),
        rows_per_split((n_rows + splits - 1) / splits) {}

  // Appends a layer; its dW and db follow the previous layer's in a split's slice.
  void add(int a1, int k1, int a2, int k2, int g, int n) {
    const int tiles_n = (n + kTile - 1) / kTile;
    layer[n_layers++] = GemmLayer{a1, k1, a2, k2, g, n, wtot, btot, tiles_n, tiles};
    wtot += (k1 + k2) * n;
    btot += n;
    tiles += ((k1 + k2 + kTile - 1) / kTile) * tiles_n;
  }
};

// The tile of this block: layer li of the plan (copied out of the kernel's
// parameters once, not indexed in the loops), dW rows k0.. and columns n0..,
// over the rows of split blockIdx.y.
struct DwTile {
  int li, k0, n0;
  GemmLayer ly;
  long long r_begin, r_end;

  __device__ explicit DwTile(const GemmPlan& plan) {
    li = 0;
    while (li + 1 < plan.n_layers &&
           static_cast<int>(blockIdx.x) >= plan.layer[li + 1].first_tile)
      ++li;
    ly = plan.layer[li];
    const int t = blockIdx.x - ly.first_tile;
    k0 = (t / ly.tiles_n) * kTile;
    n0 = (t % ly.tiles_n) * kTile;
    r_begin = static_cast<long long>(blockIdx.y) * plan.rows_per_split;
    r_end = min(plan.rows, r_begin + plan.rows_per_split);
  }
};

struct DwSmem {
  float A[kChunk][kTile];
  float G[kChunk][kTile];
  float red[256];
};

// One kTile x kTile tile of dW over the tile's rows, by a block of 256 threads.
// Each thread owns an 8 x 8 block of the tile (two 4-wide groups on each axis,
// so the shared-memory reads are conflict-free float4 broadcasts) and loads the
// column k0 + threadIdx.x % kTile of A, whose value on a row `load_a(row)`
// returns. Blocks of the first k-tile also sum the fp32 cotangents for db.
// Writes the split's slice of `part`.
template <bool kBf16, typename LoadA>
__device__ __forceinline__ void dw_tile(const GemmPlan& plan, const DwTile& t,
                                        const float* __restrict__ cot, LoadA load_a,
                                        DwSmem& sm, float* __restrict__ part) {
  const GemmLayer& ly = t.ly;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int col = tid & (kTile - 1);  // the column this thread loads
  const int ng = t.n0 + col;
  const int K = ly.k1 + ly.k2;
  const bool g_live = ng < ly.n;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float db = 0.f;
  for (long long r0 = t.r_begin; r0 < t.r_end; r0 += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += 256) {
      const int rr = e / kTile;
      const long long row = r0 + rr;
      const bool live = row < t.r_end;
      sm.A[rr][col] = live ? load_a(row) : 0.f;
      const float g = (live && g_live) ? cot[row * plan.GW + ly.g + ng] : 0.f;
      db += g;
      sm.G[rr][col] = cde<kBf16>(g);
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kChunk; ++rr) {
      const float4 al = *reinterpret_cast<const float4*>(&sm.A[rr][ty * 4]);
      const float4 ah = *reinterpret_cast<const float4*>(&sm.A[rr][64 + ty * 4]);
      const float4 gl = *reinterpret_cast<const float4*>(&sm.G[rr][tx * 4]);
      const float4 gh = *reinterpret_cast<const float4*>(&sm.G[rr][64 + tx * 4]);
      const float a[8] = {al.x, al.y, al.z, al.w, ah.x, ah.y, ah.z, ah.w};
      const float g[8] = {gl.x, gl.y, gl.z, gl.w, gh.x, gh.y, gh.z, gh.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * (plan.wtot + plan.btot);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = t.k0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = t.n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (k < K && n < ly.n) out[ly.w_off + k * ly.n + n] = acc[i][j];
    }
  }
  if (t.k0 == 0) {  // uniform over the block
    sm.red[tid] = db;
    __syncthreads();
    if (tid < kTile && g_live) out[plan.wtot + ly.b_off + ng] = sm.red[tid] + sm.red[tid + kTile];
  }
}

// A tile whose A columns are stored in the workspace, as the plan lays them out.
template <bool kBf16, typename AT>
__device__ __forceinline__ void dw_tile_stored(const AT* __restrict__ act,
                                               const float* __restrict__ cot,
                                               const GemmPlan& plan, const DwTile& t, DwSmem& sm,
                                               float* __restrict__ part) {
  const int a_col = t.ly.a_col(t.k0 + static_cast<int>(threadIdx.x) % kTile);
  dw_tile<kBf16>(
      plan, t, cot,
      [&](long long row) { return a_col >= 0 ? load_act(act + row * plan.AW + a_col) : 0.f; },
      sm, part);
}

// The tensor-core tile's staging: a kChunk-row slice of A and of G, each
// stored transposed ([column][row]) in bf16, since the rows are the GEMM's
// reduction and mma.sync reads its A and B fragments along k.
struct DwTcSmem {
  static constexpr int kLd = kChunk + Mma<true>::kPad;
  __nv_bfloat16 A[kTile][kLd];
  __nv_bfloat16 G[kTile][kLd];
  float red[256];
};

// `dw_tile` on the tensor cores for bf16 (`flagship_common.cuh`: mma.sync
// m16n8k16): the same tile, rows, db and output, with G rounded to bf16 as in
// `dw_tile`. Warp w owns dW rows 32 (w % 4).. and columns 64 (w / 4).. of the
// tile: 2 m16 x 8 n8 fragments.
template <typename LoadA>
__device__ __forceinline__ void dw_tile_tc(const GemmPlan& plan, const DwTile& t,
                                           const float* __restrict__ cot, LoadA load_a,
                                           DwTcSmem& sm, float* __restrict__ part) {
  using M = Mma<true>;
  constexpr int kLd = DwTcSmem::kLd;
  const GemmLayer& ly = t.ly;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid & (kTile - 1);  // the column this thread loads
  const int ng = t.n0 + col;
  const int K = ly.k1 + ly.k2;
  const bool g_live = ng < ly.n;
  const int wm = warp & 3, wn = warp >> 2;

  float acc[8][2][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;
  float db = 0.f;
  for (long long r0 = t.r_begin; r0 < t.r_end; r0 += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += 256) {
      const int rr = e / kTile;
      const long long row = r0 + rr;
      const bool live = row < t.r_end;
      store_act(&sm.A[col][rr], live ? load_a(row) : 0.f);
      const float g = (live && g_live) ? cot[row * plan.GW + ly.g + ng] : 0.f;
      db += g;
      store_act(&sm.G[col][rr], cde<true>(g));
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += M::kK) {
      typename M::A af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) M::load_a(af[i], &sm.A[0][0], kLd, 32 * wm + 16 * i, k0, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        typename M::B bf;
        M::load_bt(bf, &sm.G[0][0], kLd, 64 * wn + 8 * j, k0, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) M::mma(acc[j][i], af[i], bf);
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * (plan.wtot + plan.btot);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = t.k0 + 32 * wm + 16 * i + g + 8 * (e >> 1);
        const int n = t.n0 + 64 * wn + 8 * j + 2 * tq + (e & 1);
        if (k < K && n < ly.n) out[ly.w_off + k * ly.n + n] = acc[j][i][e];
      }
  if (t.k0 == 0) {  // uniform over the block
    sm.red[tid] = db;
    __syncthreads();
    if (tid < kTile && g_live) out[plan.wtot + ly.b_off + ng] = sm.red[tid] + sm.red[tid + kTile];
  }
}

template <typename AT>
__device__ __forceinline__ void dw_tile_stored_tc(const AT* __restrict__ act,
                                                  const float* __restrict__ cot,
                                                  const GemmPlan& plan, const DwTile& t,
                                                  DwTcSmem& sm, float* __restrict__ part) {
  const int a_col = t.ly.a_col(t.k0 + static_cast<int>(threadIdx.x) % kTile);
  dw_tile_tc(
      plan, t, cot,
      [&](long long row) { return a_col >= 0 ? load_act(act + row * plan.AW + a_col) : 0.f; },
      sm, part);
}

// Where each index range of a partials row goes in the output.
struct Segments {
  long long begin[kMaxSegs + 1];  // begin[n] = the row's width
  long long dst[kMaxSegs];
  int n;
};

// out[seg.dst[s] + i - seg.begin[s]] = sum over p < count of part[p][i], in p order.
static __global__ void reduce_kernel(const float* __restrict__ part, int count, Segments seg,
                                     float* __restrict__ out) {
  const long long total = seg.begin[seg.n];
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < count; ++p) s += part[static_cast<size_t>(p) * total + i];
  int k = 0;
  while (k + 1 < seg.n && i >= seg.begin[k + 1]) ++k;
  out[seg.dst[k] + i - seg.begin[k]] = s;
}

static inline cudaError_t reduce(const float* part, int count, const Segments& seg, float* out,
                                 cudaStream_t stream) {
  const long long total = seg.begin[seg.n];
  reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(part, count, seg,
                                                                                out);
  return cudaGetLastError();
}

}  // namespace netpu
