// Grouped GEMMs of the MoE expert MLP for Hopper (sm_90a): one matrix product
// per group of rows, each group with its own expert weight.
//
// Replaces two TPU kernels of `llmd_tpu/ops/grouped_gemm.py`:
//   * K2, `ragged_grouped_gemm` (Pallas `_rgg_kernel`), the default `sorted`
//     dispatch: x [nb, bc, D] token-sorted blocks, w [S, D, F] expert-slot bank,
//     block_slot [nb] / block_rows [nb] int32 on the device.
//     out[b] = x[b] @ w[block_slot[b]]; a block with block_rows[b] == 0 writes
//     zeros; otherwise ALL bc rows are multiplied (dead rows included), as on
//     the TPU, so the kernel and its plain version agree on any input.
//   * K4, `grouped_gemm` (Pallas `_gg_kernel`), the legacy capacity-einsum
//     path: x [G, C, D], w [G, D, F], counts [G] int32.
//     out[g] = x[g] @ w[g]; a group with counts[g] == 0 writes zeros.
// Both: f32 or bf16 inputs (x and w alike), f32 accumulation, output in x's
// type. Any D and F (no tile multiple needed), any bc / C >= 1. The output is
// allocated uninitialised by the wrapper, so every element is written here.
//
// Design (simple and correct first): one kernel serves both ops. A thread
// block owns one (group, 32-row chunk, 64-column tile of F); the group's
// weight slot is read on the device, so the grid is sized from the static
// group count and nothing is read back to the host. 256 threads walk D in
// 32-deep steps: the [32, 32] activation tile and the [32, 64] weight tile are
// staged in shared memory as f32 (loads coalesced along D and along F), and
// each thread keeps a 2 x 4 block of f32 accumulators in registers, summed in
// order of D with fmaf. CUDA-core FMAs only: mma.sync / wgmma tensor-core
// tiles and TMA staging are later work.
//
// Bound on the card: decode is weight-bound. A layer's two launches must read
// sum over the distinct slots hit of D*F*sizeof(T) bytes of weights, plus the
// activations in and out, over the HBM rate (3.35 TB/s on an H100 SXM); the
// flops (2*rows*D*F) are far below the ~295 flop/byte ridge. Prefill at 2048
// tokens (8192 routed copies at k 4) adds 2*rows*D*F flops per launch, which
// on the bf16 tensor-core peak (989 TFLOP/s) is the larger term. This kernel
// runs on CUDA cores in f32 and re-reads a weight tile once per 32-row chunk,
// so it sits far above both bounds at prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;   // rows per thread block
constexpr int kBN = 64;   // output columns per thread block
constexpr int kBK = 32;   // depth per shared-memory stage
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kBM / 16;  // 2: rows ty, ty + 16
constexpr int kColsPerThread = kBN / 16;  // 4: columns tx + 16 j

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// out[g] = x[g] @ w[slot(g)] for rows m0 .. m0+31 and columns n0 .. n0+63 of
// group g = blockIdx.x; slot(g) = group_slot[g] (K2) or g (K4, group_slot null).
template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ group_slot,
                    const int* __restrict__ live, T* __restrict__ out, int rows,
                    int D, int F) {
  __shared__ float xs[kBK][kBM + 1];  // +1: the transposed store is conflict-free
  __shared__ float ws[kBK][kBN];

  const int g = blockIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m_here = min(kBM, rows - m0);
  T* o = out + ((size_t)g * rows + m0) * F;

  if (live[g] == 0) {  // empty block / group: zeros, no product
    for (int i = tid; i < m_here * kBN; i += kThreads) {
      const int c = n0 + i % kBN;
      if (c < F) o[(size_t)(i / kBN) * F + c] = from_float<T>(0.f);
    }
    return;
  }
  const int slot = group_slot != nullptr ? group_slot[g] : g;
  const T* xg = x + ((size_t)g * rows + m0) * D;
  const T* wg = w + (size_t)slot * D * F;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {  // activations, along D
      const int idx = tid + i * kThreads;
      const int m = idx / kBK;
      const int kk = idx % kBK;
      const int d = k0 + kk;
      xs[kk][m] = (m < m_here && d < D) ? to_float(xg[(size_t)m * D + d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {  // weights, along F
      const int idx = tid + i * kThreads;
      const int kk = idx / kBN;
      const int n = idx % kBN;
      const int d = k0 + kk;
      const int c = n0 + n;
      ws[kk][n] = (d < D && c < F) ? to_float(wg[(size_t)d * F + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + 16 * i;
    if (r >= m_here) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < F) o[(size_t)r * F + c] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* group_slot,
                   const int* live, void* out, int groups, int rows, int D, int F,
                   cudaStream_t stream) {
  const dim3 grid(groups, (rows + kBM - 1) / kBM, (F + kBN - 1) / kBN);
  grouped_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), group_slot, live,
      static_cast<T*>(out), rows, D, F);
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, const void* x, const void* w, const int* group_slot,
                     const int* live, void* out, int groups, int rows, int D, int F,
                     void* stream) {
  if (groups <= 0 || rows <= 0 || F <= 0) return cudaSuccess;
  if (D < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, group_slot, live, out, groups, rows, D, F, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, group_slot, live, out, groups, rows, D, F, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launch.
// K2: block_slot[b] must lie in [0, S).
extern "C" int llmd_ragged_grouped_gemm(const void* x, const void* w,
                                        const int* block_slot, const int* block_rows,
                                        void* out, int nb, int bc, int D, int F,
                                        int dtype, void* stream) {
  return dispatch(dtype, x, w, block_slot, block_rows, out, nb, bc, D, F, stream);
}

// K4.
extern "C" int llmd_grouped_gemm(const void* x, const void* w, const int* counts,
                                 void* out, int G, int C, int D, int F, int dtype,
                                 void* stream) {
  return dispatch(dtype, x, w, nullptr, counts, out, G, C, D, F, stream);
}
