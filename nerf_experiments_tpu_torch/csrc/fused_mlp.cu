// The fused ReLU MLP chain y = W_L(...relu(W_1 x + b_1)...) + b_L for one NVIDIA
// H100: forward (K9, `netpu_fused_mlp_fwd`) and backward (K10, `netpu_fused_mlp_bwd`).
//
// Replaces the TPU kernels `nerf_experiments_tpu/ops/fused_mlp.py:_fwd_kernel`
// (forward) and `_bwd_kernel` (backward), entry `fused_chain`. The chain has no
// ReLU after its last layer. With bf16 every product rounds its operands to bf16
// and accumulates in fp32, and each hidden activation is stored rounded to bf16
// after its ReLU; the output, the biases and the running cotangent stay fp32, and
// the backward rounds the cotangent only inside its two products, as the TPU
// kernel does (`_dot_general`).
//
// What bounds it on the H100: arithmetic. At run_mip_nerf's widths a row costs
// ~0.66 M multiply-adds over the three chains, and the weights (at most 0.4 M a
// chain) stay in L2. The TPU design holds a 512-row tile's whole chain of
// activations in VMEM and adds dW into output blocks that every tile of a
// sequential grid revisits. A Hopper block has at most 227 KB of shared memory
// and blocks run concurrently, so here:
//   * row tile: a block of 8 warps owns kR = 64 rows, or 32 where a 64-row
//     block would pass 227 KB (`fused_mlp.tile_rows` in the wrapper picks);
//     the tile's activations live in shared memory in the compute type,
//     ping-ponged between two tiles of kR x (round16(widest width) + 16 bytes),
//     every width zero-padded to 16 there only; a ragged last tile computes its
//     idle rows and stores none of them. The tile's input rows are one
//     contiguous run of global memory, loaded as float4s several at a time
//     (`load_tile`);
//   * bf16, each layer is one `tile_gemm` of `flagship_common.cuh` (the
//     tensor-core tile of K2, K4, K5 and K6): mma.sync m16n8k16, B packed by
//     the wrapper in fragment order (`train_megakernel.pack_layers`, one
//     gather for the whole chain) and streamed from L2 through the warps'
//     cp.async rings; a hidden layer ends in `FwdEpi` (bias, ReLU, rounding
//     into the other tile), the last in `OutEpi`, which writes fp32 y to
//     global memory;
//   * fp32, each forward layer is a GEMM on the CUDA cores that adds the
//     products of every output in the order k = 0, 1, ... and then the bias
//     (`fma_layer`), the order of a plain fp32 GEMM, so its values equal the
//     plain chain's and every ReLU falls as there. 3xTF32 on the tensor cores
//     (13.5 ms for run_mip_nerf's chains at 262,144 rows, against 15.5 here;
//     PERF.md section 6) decided 42 of 2.7e8 ReLUs of segment 1 the
//     other way; each moves its row's gradient by a whole cotangent, and the
//     gradients missed the 1e-4 gate by 13x, the Mip step's camera gradient
//     (through the ReLU between the segments) by 1.9x;
//   * backward, phase A (one block a tile): the same forward, every layer's
//     input copied to the `act` workspace in the compute type and each ReLU's
//     mask kept in shared memory as 32-bit words (from the stored value, as
//     the TPU kernel's `acts[i] > 0`); then g <- (round(g) W_i^T) * mask on
//     the tensor-core tile with W^T packed (3xTF32 m16n8k8 in fp32, the
//     activations split into hi / lo as their fragments are loaded and the
//     truncating accumulator flushed into fp32 every 8 k-steps, as the GARF
//     kernels do), each cotangent stored fp32 to the `cot` workspace
//     (`BwdEpi`), and dx from layer 0 (`OutEpi`);
//   * backward, phase B (`train_common.cuh`, shared with the train kernels):
//     dW_i = a_i^T round(g_i) and db_i = sum g_i, a GEMM over the rows on the
//     tensor cores in bf16 (`dw_tile_stored_tc`) and FMA loops in fp32
//     (`dw_tile_stored`: a 3xTF32 dW GEMM was slower and outside the
//     tolerance in K5), split over the rows into partials (`fused_mlp.dw_splits`,
//     from the shapes alone) added in a fixed order. No atomics: two launches
//     give bitwise-equal gradients, and rows past the end add nothing.
#include "fma_tile.cuh"
#include "train_common.cuh"

namespace {

using namespace netpu;

constexpr int kMaxChain = 16;  // layers in one chain

struct TileChain {
  // W_i (dims[i], dims[i + 1]): bf16, packed as `pack_b` packs it; fp32, as
  // it is with the row stride round4(dims[i + 1])
  const void* fwd[kMaxChain];
  const void* bwd[kMaxChain];  // W_i^T packed by `pack_b` (backward only)
  const float* b[kMaxChain];   // (dims[i + 1],) fp32
  int dims[kMaxChain + 1];
  int a_off[kMaxChain];  // act columns of layer i's input
  int g_off[kMaxChain];  // cot columns of layer i's output cotangent
  int m_off[kMaxChain];  // mask words (per 32-row half) of hidden layer i's output
  int n_layers, AW, GW, MW;
  int ld;   // row stride of the shared tiles (elements)
  int sld;  // row stride of the fp32 cotangent staging tile (bf16 backward)
};

// A block's shared memory for a kR-row tile: two compute-type tiles, the
// warps' weight rings (in fp32's forward on the CUDA cores, the staging of
// W) and, in the backward, the fp32 staging tile of a cotangent (bf16 only:
// in fp32 the tile itself holds it) and the mask words of every hidden
// layer. `fused_mlp.tile_smem_bytes` computes the same sizes.
template <bool kBf16>
struct ChainSmem {
  size_t tiles, ring, stg, masks;
  __host__ __device__ ChainSmem(const TileChain& c, int rows, bool backward)
      : tiles((2 * static_cast<size_t>(rows) * c.ld * sizeof(typename Mma<kBf16>::ET) + 15) &
              ~static_cast<size_t>(15)),
        ring(TileSmem<kBf16>::kRingBytes),
        stg(backward && kBf16 && c.n_layers > 1
                ? static_cast<size_t>(rows) * c.sld * sizeof(float)
                : 0),
        masks(backward ? static_cast<size_t>(rows / 32) * c.MW * sizeof(unsigned) : 0) {}
  __host__ __device__ size_t total() const { return tiles + ring + stg + masks; }
};

// Epilogue of a chain's output (y, with the bias) or of dx (no bias): fp32 to
// out[row * ld + col] for the tile's live rows and columns col < width.
struct OutEpi {
  float* out;  // the tile's first row
  int ld, width;
  const float* bias;  // null: none
  int rows;

  template <int kMT>
  __device__ void operator()(int nt, const float (&c)[kMT][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * i + g + 8 * (e >> 1), col = nt * 8 + 2 * t + (e & 1);
        if (row < rows && col < width)
          out[static_cast<size_t>(row) * ld + col] =
              bias != nullptr ? c[i][e] + __ldg(bias + col) : c[i][e];
      }
  }
};

// The tile's rows of src (n_rows, width; src points at the tile's first row)
// into the shared tile dst, rounded to the compute type; columns [width,
// round16(width)) and idle rows are 0. With `keep`, the live fp32 values also
// go to keep[r * kld + k] (the output cotangent's workspace columns). The
// tile's live rows are one contiguous run of src: each thread loads kLoads
// float4s of it before it stores any (a loop that stored each value before
// loading the next would wait out one memory latency a value).
template <bool kBf16, int kR>
__device__ void load_tile(const float* __restrict__ src, int width, int rows,
                          typename Mma<kBf16>::ET* dst, int ld, float* keep, size_t kld) {
  constexpr int kLoads = 4;
  const int n = rows * width;
  auto put = [&](int f, float v) {
    const int r = f / width, k = f - r * width;
    store_act(dst + r * ld + k, cde<kBf16>(v));
    if (keep != nullptr) keep[r * kld + k] = v;
  };
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int q0 = threadIdx.x; q0 < n4; q0 += kLoads * blockDim.x) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int q = q0 + u * blockDim.x;
        if (q < n4) v[u] = __ldg(s4 + q);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int q = q0 + u * blockDim.x;
        if (q < n4) {
          put(4 * q, v[u].x);
          put(4 * q + 1, v[u].y);
          put(4 * q + 2, v[u].z);
          put(4 * q + 3, v[u].w);
        }
      }
    }
    for (int f = 4 * n4 + threadIdx.x; f < n; f += blockDim.x) put(f, __ldg(src + f));
  } else {
    for (int f = threadIdx.x; f < n; f += blockDim.x) put(f, __ldg(src + f));
  }
  // zero the K padding of the live rows and every column of the idle rows
  const int wp = round16(width), pad = wp - width;
  for (int e = threadIdx.x; e < rows * pad; e += blockDim.x)
    store_act(dst + (e / pad) * ld + width + e % pad, 0.f);
  for (int e = threadIdx.x; e < (kR - rows) * wp; e += blockDim.x)
    store_act(dst + (rows + e / wp) * ld + e % wp, 0.f);
}

// The hidden layers on one tile whose layer-0 input is in `cur`: layer i <
// L - 1 writes relu(a W_i + b_i), rounded, into the other tile. With `act`,
// every layer's input is copied to the workspace row of the tile's first row
// (after its product's barrier, while the next product reads it), and with
// `masks` each hidden output's ReLU mask words are kept there. Returns the
// tile that holds the last layer's input.
template <bool kBf16, int kR>
__device__ typename Mma<kBf16>::ET* forward_hidden(const TileChain& c,
                                                   typename Mma<kBf16>::ET* cur,
                                                   typename Mma<kBf16>::ET* nxt,
                                                   typename Mma<kBf16>::Frag* ring, int rows,
                                                   typename Mma<kBf16>::ET* act,
                                                   unsigned* masks) {
  using M = Mma<kBf16>;
  using ET = typename M::ET;
  constexpr int kH = kR / 32;  // 32-row halves of the tile
  if (act != nullptr) copy_rows(act + c.a_off[0], c.AW, cur, c.ld, c.dims[0], rows);
  for (int i = 0; i + 1 < c.n_layers; ++i) {
    const int K = c.dims[i], N = c.dims[i + 1];
    unsigned* m = masks != nullptr ? masks + kH * c.m_off[i] : nullptr;
    tile_gemm<kBf16, kR, kFlushK<kBf16>>(cur, c.ld, round16(K) / M::kK, nullptr, 0, 0, c.fwd[i],
                                         ring, round16(N) / 8,
                                         FwdEpi<kBf16>{nxt, c.ld, N, N, true, c.b[i], rows, m, N});
    __syncthreads();
    if (act != nullptr) copy_rows(act + c.a_off[i + 1], c.AW, nxt, c.ld, N, rows);
    ET* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// ---- fp32: the forward on the CUDA cores, in the order of a plain GEMM ----
// (`fma_layer` of fma_tile.cuh; W's rows padded to round4(N) by
// `fused_mlp.pack_chain`)

// A hidden layer's outputs: relu(acc + b) into the shared tile.
struct ReluOut {
  float* out;
  int ld;
  const float* bias;
  template <int R, int C>
  __device__ void operator()(int r0, int c0, const float (&acc)[R][C]) const {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = fma_col<C>(c0, j);
      const float bj = __ldg(bias + col);
#pragma unroll
      for (int r = 0; r < R; ++r) out[(r0 + r) * ld + col] = fmaxf(acc[r][j] + bj, 0.f);
    }
  }
};

// The last layer's outputs: acc + b to y (the tile's first row, row stride
// N) for the live rows.
struct YOut {
  float* y;
  int N, rows;
  const float* bias;
  template <int R, int C>
  __device__ void operator()(int r0, int c0, const float (&acc)[R][C]) const {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = fma_col<C>(c0, j);
      const float bj = __ldg(bias + col);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r0 + r < rows) y[static_cast<size_t>(r0 + r) * N + col] = acc[r][j] + bj;
    }
  }
};

// The hidden layers of fp32 on one tile whose layer-0 input is in `cur`, as
// `forward_hidden` (with `act`, the workspace copies and the mask words, one
// a (32-row half, column) from the stored values), W staged through
// `stage`. Returns the tile that holds the last layer's input.
template <int kR>
__device__ float* forward_hidden_fma(const TileChain& c, float* cur, float* nxt, float* stage,
                                     size_t stage_bytes, int rows, float* act,
                                     unsigned* masks) {
  constexpr int kH = kR / 32;
  if (act != nullptr) copy_rows(act + c.a_off[0], c.AW, cur, c.ld, c.dims[0], rows);
  for (int i = 0; i + 1 < c.n_layers; ++i) {
    const int N = c.dims[i + 1];
    fma_layer<kR>(cur, c.ld, c.dims[i], static_cast<const float*>(c.fwd[i]), N, stage,
                  stage_bytes, ReluOut{nxt, c.ld, c.b[i]});
    __syncthreads();
    if (act != nullptr) {
      copy_rows(act + c.a_off[i + 1], c.AW, nxt, c.ld, N, rows);
      for (int item = threadIdx.x; item < kH * N; item += blockDim.x) {
        const int h = item / N, j = item % N;
        unsigned bits = 0u;
        for (int r = 0; r < 32 && h * 32 + r < rows; ++r)
          if (nxt[(h * 32 + r) * c.ld + j] > 0.f) bits |= 1u << r;
        masks[kH * c.m_off[i] + h * N + j] = bits;
      }
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

template <bool kBf16, int kR>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_fwd_kernel(const float* __restrict__ x, TileChain c, long long n_rows,
                     float* __restrict__ y) {
  using M = Mma<kBf16>;
  using ET = typename M::ET;
  extern __shared__ __align__(16) unsigned char smem[];
  const ChainSmem<kBf16> lay(c, kR, false);
  ET* buf0 = reinterpret_cast<ET*>(smem);
  ET* buf1 = buf0 + kR * c.ld;
  const long long row0 = static_cast<long long>(blockIdx.x) * kR;
  const int rows = static_cast<int>(min(static_cast<long long>(kR), n_rows - row0));
  const int L = c.n_layers, DL = c.dims[L];

  load_tile<kBf16, kR>(x + row0 * c.dims[0], c.dims[0], rows, buf0, c.ld, nullptr, 0);
  __syncthreads();
  if constexpr (kBf16) {
    auto* ring = reinterpret_cast<typename M::Frag*>(smem + lay.tiles);
    ET* last = forward_hidden<kBf16, kR>(c, buf0, buf1, ring, rows, nullptr, nullptr);
    tile_gemm<kBf16, kR>(last, c.ld, round16(c.dims[L - 1]) / M::kK, nullptr, 0, 0,
                         c.fwd[L - 1], ring, round16(DL) / 8,
                         OutEpi{y + row0 * DL, DL, DL, c.b[L - 1], rows});
  } else {
    float* stage = reinterpret_cast<float*>(smem + lay.tiles);
    float* last = forward_hidden_fma<kR>(c, buf0, buf1, stage, lay.ring, rows, nullptr, nullptr);
    fma_layer<kR>(last, c.ld, c.dims[L - 1], static_cast<const float*>(c.fwd[L - 1]), DL,
                  stage, lay.ring, YOut{y + row0 * DL, DL, rows, c.b[L - 1]});
  }
}

// Phase A of the backward for one kR-row tile (see the header).
template <bool kBf16, int kR>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          TileChain c, long long n_rows, typename Mma<kBf16>::ET* __restrict__ act,
                          float* __restrict__ cot, float* __restrict__ dx) {
  using M = Mma<kBf16>;
  using ET = typename M::ET;
  constexpr int kH = kR / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const ChainSmem<kBf16> lay(c, kR, true);
  ET* buf0 = reinterpret_cast<ET*>(smem);
  ET* buf1 = buf0 + kR * c.ld;
  auto* ring = reinterpret_cast<typename M::Frag*>(smem + lay.tiles);
  float* stg = reinterpret_cast<float*>(smem + lay.tiles + lay.ring);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + lay.tiles + lay.ring + lay.stg);
  const long long row0 = static_cast<long long>(blockIdx.x) * kR;
  const int rows = static_cast<int>(min(static_cast<long long>(kR), n_rows - row0));
  const int L = c.n_layers, DL = c.dims[L];
  ET* act_t = act + row0 * c.AW;
  float* cot_t = cot + row0 * c.GW;

  // forward: layer i's input goes to act[:, a_off[i]:], x (rounded) included
  load_tile<kBf16, kR>(x + row0 * c.dims[0], c.dims[0], rows, buf0, c.ld, nullptr, 0);
  __syncthreads();
  ET* nb;
  if constexpr (kBf16)
    nb = forward_hidden<kBf16, kR>(c, buf0, buf1, ring, rows, act_t, masks);
  else
    nb = forward_hidden_fma<kR>(c, buf0, buf1, reinterpret_cast<float*>(ring), lay.ring, rows,
                                act_t, masks);
  ET* gb = nb == buf0 ? buf1 : buf0;

  // the output cotangent: fp32 to cot, rounded into the free tile
  load_tile<kBf16, kR>(g + row0 * DL, DL, rows, gb, c.ld, cot_t + c.g_off[L - 1], c.GW);
  __syncthreads();  // also ends every warp's copy of the tile nb, which is written next
  for (int i = L - 1; i >= 1; --i) {
    const int K = c.dims[i + 1], N = c.dims[i];
    tile_gemm<kBf16, kR, kFlushK<kBf16>>(
        gb, c.ld, round16(K) / M::kK, nullptr, 0, 0, c.bwd[i], ring, round16(N) / 8,
        BwdEpi<kBf16>{round16(N), N, nb, c.ld, kBf16 ? stg : nullptr, c.sld,
                      masks + kH * c.m_off[i - 1], N, nullptr, 0, 0, false, rows});
    __syncthreads();
    // the fp32 cotangent of layer i - 1's output to the workspace: from the
    // staging tile in bf16, from the tile itself in fp32 (it holds the same)
    if constexpr (kBf16) {
      copy_rows(cot_t + c.g_off[i - 1], c.GW, stg, c.sld, N, rows);
      __syncthreads();  // the next epilogue writes stg again
    } else {
      copy_rows(cot_t + c.g_off[i - 1], c.GW, nb, c.ld, N, rows);
    }
    ET* t = gb;
    gb = nb;
    nb = t;
  }
  const int D0 = c.dims[0];
  tile_gemm<kBf16, kR, kFlushK<kBf16>>(gb, c.ld, round16(c.dims[1]) / M::kK, nullptr, 0, 0,
                                       c.bwd[0], ring, round16(D0) / 8,
                                       OutEpi{dx + row0 * D0, D0, D0, nullptr, rows});
}

// Phase B: dW = A^T G, db = sum_rows G (train_common.cuh).
__global__ void __launch_bounds__(256)
fused_mlp_dw_tc_kernel(const __nv_bfloat16* __restrict__ act, const float* __restrict__ cot,
                       GemmPlan plan, float* __restrict__ part) {
  __shared__ __align__(16) DwTcSmem sm;
  dw_tile_stored_tc(act, cot, plan, DwTile(plan), sm, part);
}

__global__ void __launch_bounds__(256)
fused_mlp_dw_fma_kernel(const float* __restrict__ act, const float* __restrict__ cot,
                        GemmPlan plan, float* __restrict__ part) {
  __shared__ __align__(16) DwSmem sm;
  dw_tile_stored<false>(act, cot, plan, DwTile(plan), sm, part);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool kBf16, int kR>
cudaError_t launch_fwd(const float* x, const TileChain& c, long long n_rows, float* y,
                       cudaStream_t stream) {
  const size_t bytes = ChainSmem<kBf16>(c, kR, false).total();
  auto kernel = fused_mlp_fwd_kernel<kBf16, kR>;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n_rows + kR - 1) / kR);
  kernel<<<blocks, kThreads, bytes, stream>>>(x, c, n_rows, y);
  return cudaGetLastError();
}

template <bool kBf16, int kR>
cudaError_t launch_bwd(const float* x, const float* g, const TileChain& c, long long n_rows,
                       void* act, float* cot, float* part, int splits, float* dx, float* grads,
                       cudaStream_t stream) {
  using ET = typename Mma<kBf16>::ET;
  const size_t bytes = ChainSmem<kBf16>(c, kR, true).total();
  auto kernel = fused_mlp_bwd_rows_kernel<kBf16, kR>;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n_rows + kR - 1) / kR);
  ET* a = static_cast<ET*>(act);
  kernel<<<blocks, kThreads, bytes, stream>>>(x, g, c, n_rows, a, cot, dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmPlan plan(c.AW, c.GW, n_rows, splits);
  for (int i = 0; i < c.n_layers; ++i)
    plan.add(c.a_off[i], c.dims[i], 0, 0, c.g_off[i], c.dims[i + 1]);
  if constexpr (kBf16)
    fused_mlp_dw_tc_kernel<<<dim3(plan.tiles, splits), 256, 0, stream>>>(a, cot, plan, part);
  else
    fused_mlp_dw_fma_kernel<<<dim3(plan.tiles, splits), 256, 0, stream>>>(a, cot, plan, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Segments all{};
  all.n = 1;
  all.begin[1] = plan.wtot + plan.btot;
  return reduce(part, splits, all, grads, stream);
}

// Fills `c` from the host arrays; false when the chain is out of range.
bool make_chain(const void* const* wf_ptrs, const void* const* wb_ptrs,
                const float* const* b_ptrs, const int* dims, int n_layers, bool bf16,
                TileChain& c) {
  if (n_layers < 1 || n_layers > kMaxChain) return false;
  int widest = 0, hidden = 0, a = 0, gcol = 0, m = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1) return false;
    c.dims[i] = dims[i];
    widest = imax(widest, round16(dims[i]));
  }
  for (int i = 0; i < n_layers; ++i) {
    c.fwd[i] = wf_ptrs[i];
    c.bwd[i] = wb_ptrs == nullptr ? nullptr : wb_ptrs[i];
    c.b[i] = b_ptrs[i];
    c.a_off[i] = a;
    c.g_off[i] = gcol;
    c.m_off[i] = m;
    a += dims[i];
    gcol += dims[i + 1];
    if (i + 1 < n_layers) {
      m += dims[i + 1];
      hidden = imax(hidden, round16(dims[i + 1]));
    }
  }
  c.n_layers = n_layers;
  c.AW = a;
  c.GW = gcol;
  c.MW = m;
  c.ld = widest + (bf16 ? Mma<true>::kPad : Mma<false>::kPad);
  c.sld = hidden + 4;
  return true;
}

}  // namespace

// x (n_rows, dims[0]) fp32; wf_ptrs: the n_layers layers' weights W_i
// (dims[i], dims[i + 1]) as `fused_mlp.pack_chain` gives them: with bf16 !=
// 0 packed in bf16 by `train_megakernel.pack_b`, else fp32 with the row
// stride round4(dims[i + 1]); b_ptrs: the biases, fp32; dims: a host array
// of n_layers + 1 widths; tile_rows: the row tile kR, 64 or 32
// (`fused_mlp.tile_rows`); y (n_rows, dims[n_layers]) fp32.
extern "C" int netpu_fused_mlp_fwd(const float* x, const void* const* wf_ptrs,
                                   const float* const* b_ptrs, const int* dims, int n_layers,
                                   int bf16, int tile_rows, long long n_rows, float* y,
                                   void* stream) {
  TileChain c;
  if (!make_chain(wf_ptrs, nullptr, b_ptrs, dims, n_layers, bf16 != 0, c) ||
      (tile_rows != 64 && tile_rows != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = bf16 ? (tile_rows == 64 ? launch_fwd<true, 64> : launch_fwd<true, 32>)
                     : (tile_rows == 64 ? launch_fwd<false, 64> : launch_fwd<false, 32>);
  return static_cast<int>(launch(x, c, n_rows, y, st));
}

// As the forward, plus: g (n_rows, dims[n_layers]) the output cotangent;
// wb_ptrs the backward B operands W_i^T packed by `pack_b` (bf16, or fp32
// TF32 hi / lo pairs); workspaces act (n_rows, act_width) in the compute type
// and cot (n_rows, cot_width) fp32, act_width = dims[0] + ... + dims[n_layers
// - 1], cot_width = dims[1] + ... + dims[n_layers]; part (splits, n_grads)
// fp32. Outputs: dx (n_rows, dims[0]); grads (n_grads) =
// every dW (in, out) in layer order, then every db.
extern "C" int netpu_fused_mlp_bwd(const float* x, const float* g, const void* const* wf_ptrs,
                                   const void* const* wb_ptrs, const float* const* b_ptrs,
                                   const int* dims, int n_layers, int bf16, int tile_rows,
                                   long long n_rows, void* act, float* cot, int act_width,
                                   int cot_width, float* part, int splits, float* dx,
                                   float* grads, void* stream) {
  TileChain c;
  if (wb_ptrs == nullptr || !make_chain(wf_ptrs, wb_ptrs, b_ptrs, dims, n_layers, bf16 != 0, c) ||
      act_width != c.AW || cot_width != c.GW || splits < 1 ||
      (tile_rows != 64 && tile_rows != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = bf16 ? (tile_rows == 64 ? launch_bwd<true, 64> : launch_bwd<true, 32>)
                     : (tile_rows == 64 ? launch_bwd<false, 64> : launch_bwd<false, 32>);
  return static_cast<int>(launch(x, g, c, n_rows, act, cot, part, splits, dx, grads, st));
}
