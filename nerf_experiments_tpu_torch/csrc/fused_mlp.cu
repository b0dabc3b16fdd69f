// The fused ReLU MLP chain y = W_L(...relu(W_1 x + b_1)...) + b_L for one NVIDIA
// H100: forward (`netpu_fused_mlp_fwd`) and backward (`netpu_fused_mlp_bwd`).
//
// Replaces the TPU kernels `nerf_experiments_tpu/ops/fused_mlp.py:_fwd_kernel`
// (forward) and `_bwd_kernel` (backward), entry `fused_chain`. The chain has no
// ReLU after its last layer. With bf16 every product rounds its operands to bf16
// and accumulates in fp32, and each hidden activation is stored rounded to bf16
// after its ReLU; the output, the biases and the running cotangent stay fp32, and
// the backward rounds the cotangent only inside its two products, as the TPU
// kernel does (`_dot_general`).
//
// What bounds it on the H100: arithmetic. At the flagship widths a row costs
// ~0.66 M multiply-adds over the three chains, and the weights (at most 0.4 M
// floats a chain) stay in L2. The TPU design holds a 512-row tile's whole chain
// of activations in VMEM and adds dW into output blocks that every tile of a
// sequential grid revisits. A Hopper block has at most 227 KB of shared memory
// and blocks run concurrently, so here:
//   * forward: one block of 256 threads owns kRows = 32 rows; the tile's current
//     activations live in shared memory, ping-ponged between two buffers of 32 x
//     round4(widest layer) floats (80 KB at 319 wide); each thread owns output
//     columns and keeps 32 row accumulators in registers, so one weight load from
//     L2 feeds 32 FMAs (`accumulate` of `flagship_common.cuh`, as the flagship
//     render kernel does); the last layer writes fp32 straight to y. A ragged
//     last tile masks its idle rows: no padding.
//   * backward, phase A (one block per 32-row tile): recompute the forward,
//     writing every layer's input to a device workspace (`act`), then walk the
//     layers back: g <- (round(g) W_i^T) * (a_i > 0) from the transposed weights,
//     writing every layer's output cotangent (fp32) to a second workspace (`cot`)
//     and dx for layer 0;
//   * backward, phase B (`train_common.cuh`, shared with the train kernels): dW_i =
//     a_i^T round(g_i) and db_i = sum g_i as a tiled GEMM split over the rows into
//     fixed partials, added in a fixed order. No atomics: two launches give
//     bitwise-equal gradients, and rows past the end add nothing.
// This is the simple design: FMA loops on the CUDA cores. Tensor cores (mma.sync
// / wgmma, TMA) are later work.
#include "train_common.cuh"

namespace {

using namespace netpu;

constexpr int kMaxChain = 16;  // layers in one chain

struct Chain {
  const void* w[kMaxChain];   // (dims[i], dims[i + 1]) row-major, fp32 or bf16
  const void* wt[kMaxChain];  // the same transposed (backward only)
  const float* b[kMaxChain];  // (dims[i + 1],) fp32
  int dims[kMaxChain + 1];
  int a_off[kMaxChain];       // act columns of layer i's input
  int g_off[kMaxChain];       // cot columns of layer i's output cotangent
  int n_layers, ld, AW, GW;
};

// One layer for the tile's first `rows` rows: z = in . W[:, j] + b[j]. A hidden
// layer writes cde(relu(z)) to `out` (shared memory) and, with `store`, to the
// activation workspace; the last layer (y != nullptr) writes z in fp32 to y.
template <typename WT, bool kBf16, typename AT>
__device__ void forward_layer(const float* in, int ld, int K, const void* W_, const float* bias,
                              int N, float* out, AT* store, int sld, float* y, int rows) {
  const WT* W = static_cast<const WT*>(W_);
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    accumulate(acc, in, ld, K, W, 0, N, j);
    const float bj = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const float z = acc[r] + bj;
        if (y != nullptr) {
          y[static_cast<size_t>(r) * N + j] = z;
        } else {
          const float v = cde<kBf16>(fmaxf(z, 0.f));
          out[r * ld + j] = v;
          if (store != nullptr) store_act(store + static_cast<size_t>(r) * sld + j, v);
        }
      }
    }
  }
}

// Copies the tile's rows of src (n_rows, width) into shared memory, rounded to
// the compute type, idle rows zero.
template <bool kBf16>
__device__ void load_tile(const float* __restrict__ src, int width, long long row0, int rows,
                          float* dst, int ld) {
  for (int e = threadIdx.x; e < kRows * width; e += blockDim.x) {
    const int r = e / width, k = e % width;
    dst[r * ld + k] = r < rows ? cde<kBf16>(src[(row0 + r) * width + k]) : 0.f;
  }
}

template <typename WT, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fwd_kernel(const float* __restrict__ x, Chain chain, long long n_rows,
                     float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  float* buf[2] = {smem, smem + kRows * chain.ld};
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n_rows - row0));
  const int L = chain.n_layers;
  load_tile<kBf16>(x, chain.dims[0], row0, rows, buf[0], chain.ld);
  __syncthreads();
  for (int i = 0; i < L; ++i) {
    float* yt = i == L - 1 ? y + row0 * chain.dims[L] : nullptr;
    forward_layer<WT, kBf16, float>(buf[i & 1], chain.ld, chain.dims[i], chain.w[i],
                                    chain.b[i], chain.dims[i + 1], buf[(i + 1) & 1], nullptr, 0,
                                    yt, rows);
    __syncthreads();
  }
}

// Phase A of the backward for one 32-row tile (see the header).
template <typename WT, bool kBf16, typename AT>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          Chain chain, long long n_rows, AT* __restrict__ act,
                          float* __restrict__ cot, float* __restrict__ dx) {
  extern __shared__ __align__(16) float smem[];
  float* buf[2] = {smem, smem + kRows * chain.ld};
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n_rows - row0));
  const int L = chain.n_layers, ld = chain.ld;
  AT* act_t = act + row0 * chain.AW;
  float* cot_t = cot + row0 * chain.GW;

  // forward: layer i's input goes to act[:, a_off[i]:], x (rounded) included
  const int D0 = chain.dims[0];
  load_tile<kBf16>(x, D0, row0, rows, buf[0], ld);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * D0; e += blockDim.x) {
    const int r = e / D0, k = e % D0;
    store_act(act_t + static_cast<size_t>(r) * chain.AW + chain.a_off[0] + k, buf[0][r * ld + k]);
  }
  for (int i = 0; i + 1 < L; ++i) {
    forward_layer<WT, kBf16, AT>(buf[i & 1], ld, chain.dims[i], chain.w[i], chain.b[i],
                                 chain.dims[i + 1], buf[(i + 1) & 1], act_t + chain.a_off[i + 1],
                                 chain.AW, nullptr, rows);
    __syncthreads();
  }
  __syncthreads();  // a one-layer chain still reads buf[0] above

  // backward: the output cotangent (fp32 to cot, rounded in shared memory)
  const int DL = chain.dims[L];
  float* gb = buf[0];
  float* nb = buf[1];
  for (int e = threadIdx.x; e < kRows * DL; e += blockDim.x) {
    const int r = e / DL, k = e % DL;
    const float gv = r < rows ? g[(row0 + r) * DL + k] : 0.f;
    gb[r * ld + k] = cde<kBf16>(gv);
    if (r < rows) cot_t[static_cast<size_t>(r) * chain.GW + chain.g_off[L - 1] + k] = gv;
  }
  __syncthreads();
  for (int i = L - 1; i >= 0; --i) {
    const int K = chain.dims[i + 1], N = chain.dims[i];
    const WT* Wt = static_cast<const WT*>(chain.wt[i]);  // (K, N)
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      accumulate(acc, gb, ld, K, Wt, 0, N, n);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          if (i == 0) {
            dx[(row0 + r) * N + n] = acc[r];
          } else {
            // ReLU' from the stored post-activation, as the TPU kernel does
            const size_t rr = static_cast<size_t>(r);
            const float v =
                load_act(act_t + rr * chain.AW + chain.a_off[i] + n) > 0.f ? acc[r] : 0.f;
            cot_t[rr * chain.GW + chain.g_off[i - 1] + n] = v;
            nb[r * ld + n] = cde<kBf16>(v);
          }
        }
      }
    }
    __syncthreads();
    float* t = gb;
    gb = nb;
    nb = t;
  }
}

template <typename AT, bool kBf16>
__global__ void __launch_bounds__(256)
fused_mlp_dw_kernel(const AT* __restrict__ act, const float* __restrict__ cot, GemmPlan plan,
                    float* __restrict__ part) {
  __shared__ __align__(16) DwSmem sm;
  dw_tile_stored<kBf16>(act, cot, plan, DwTile(plan), sm, part);
}

size_t smem_bytes(const Chain& chain) { return 2 * kRows * chain.ld * sizeof(float); }

template <typename WT, bool kBf16>
cudaError_t launch_fwd(const float* x, const Chain& chain, long long n_rows, float* y,
                       cudaStream_t stream) {
  const size_t bytes = smem_bytes(chain);
  auto kernel = fused_mlp_fwd_kernel<WT, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n_rows + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, bytes, stream>>>(x, chain, n_rows, y);
  return cudaGetLastError();
}

template <typename WT, bool kBf16, typename AT>
cudaError_t launch_bwd(const float* x, const float* g, const Chain& chain, long long n_rows,
                       void* act, float* cot, float* part, int splits, float* dx, float* grads,
                       cudaStream_t stream) {
  const size_t bytes = smem_bytes(chain);
  auto kernel = fused_mlp_bwd_rows_kernel<WT, kBf16, AT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n_rows + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, bytes, stream>>>(x, g, chain, n_rows, static_cast<AT*>(act), cot,
                                              dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmPlan plan(chain.AW, chain.GW, n_rows, splits);
  for (int i = 0; i < chain.n_layers; ++i)
    plan.add(chain.a_off[i], chain.dims[i], 0, 0, chain.g_off[i], chain.dims[i + 1]);
  fused_mlp_dw_kernel<AT, kBf16><<<dim3(plan.tiles, splits), 256, 0, stream>>>(
      static_cast<const AT*>(act), cot, plan, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Segments all{};
  all.n = 1;
  all.begin[1] = plan.wtot + plan.btot;
  return reduce(part, splits, all, grads, stream);
}

// Fills `chain` from the host arrays; false when the chain does not fit.
bool make_chain(const void* const* w_ptrs, const void* const* wt_ptrs,
                const float* const* b_ptrs, const int* dims, int n_layers, Chain& chain) {
  if (n_layers < 1 || n_layers > kMaxChain) return false;
  int widest = 0, a = 0, gcol = 0;
  chain.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1) return false;
    chain.dims[i] = dims[i];
    widest = dims[i] > widest ? dims[i] : widest;
  }
  for (int i = 0; i < n_layers; ++i) {
    chain.w[i] = w_ptrs[i];
    chain.wt[i] = wt_ptrs == nullptr ? nullptr : wt_ptrs[i];
    chain.b[i] = b_ptrs[i];
    chain.a_off[i] = a;
    chain.g_off[i] = gcol;
    a += dims[i];
    gcol += dims[i + 1];
  }
  chain.ld = round4(widest);
  chain.AW = a;
  chain.GW = gcol;
  return smem_bytes(chain) <= 227 * 1024;
}

}  // namespace

// x (n_rows, dims[0]) fp32; w_ptrs / b_ptrs: the n_layers layers, weights
// (dims[i], dims[i + 1]) in bf16 when bf16 != 0 else fp32, biases fp32; dims: a
// host array of n_layers + 1 widths; y (n_rows, dims[n_layers]) fp32.
extern "C" int netpu_fused_mlp_fwd(const float* x, const void* const* w_ptrs,
                                   const float* const* b_ptrs, const int* dims, int n_layers,
                                   int bf16, long long n_rows, float* y, void* stream) {
  Chain chain;
  if (!make_chain(w_ptrs, nullptr, b_ptrs, dims, n_layers, chain))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_fwd<__nv_bfloat16, true>(x, chain, n_rows, y, st)
                               : launch_fwd<float, false>(x, chain, n_rows, y, st));
}

// As the forward, plus: g (n_rows, dims[n_layers]) the output cotangent; wt_ptrs
// the weights transposed to (dims[i + 1], dims[i]); workspaces act (n_rows,
// act_width) in the compute type and cot (n_rows, cot_width) fp32, act_width =
// dims[0] + ... + dims[n_layers - 1], cot_width = dims[1] + ... + dims[n_layers];
// part (splits, n_grads) fp32. Outputs: dx (n_rows, dims[0]); grads (n_grads) =
// every dW (in, out) in layer order, then every db.
extern "C" int netpu_fused_mlp_bwd(const float* x, const float* g, const void* const* w_ptrs,
                                   const void* const* wt_ptrs, const float* const* b_ptrs,
                                   const int* dims, int n_layers, int bf16, long long n_rows,
                                   void* act, float* cot, int act_width, int cot_width,
                                   float* part, int splits, float* dx, float* grads,
                                   void* stream) {
  Chain chain;
  if (!make_chain(w_ptrs, wt_ptrs, b_ptrs, dims, n_layers, chain) ||
      act_width != chain.AW || cot_width != chain.GW || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_bwd<__nv_bfloat16, true, __nv_bfloat16>(x, g, chain, n_rows, act, cot, part,
                                                            splits, dx, grads, st)
           : launch_bwd<float, false, float>(x, g, chain, n_rows, act, cot, part, splits, dx,
                                             grads, st);
  return static_cast<int>(err);
}
