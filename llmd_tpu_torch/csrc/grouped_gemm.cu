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
// Both: f32 accumulation, rounded once to the output type (x's). The output is
// allocated uninitialised by the wrapper, so every element is written here.
// The group's weight slot is read on the device in the block's prologue, so
// the grid is sized from the static group count and nothing is read back to
// the host. A dead group issues no loads and writes zeros.
//
// Two instances; the wrapper picks one from the dtype and the widths alone
// (`ops/grouped_gemm._instance`) and passes it in:
//
// * wgmma (bfloat16, D % 8 == 0, F % 8 == 0: every registry model). The
//   product is taken transposed, out^T[F tile, rows] = w^T[F tile, D] ·
//   x^T[D, rows] ("swap AB"): the weight is always wgmma's A operand, 64 F
//   columns per consumer warpgroup (M = 64), read MN-major straight from its
//   [D, F] layout (transpose bit, legal for 16-bit types); the group's rows
//   are the B operand (N = 8, 16, 32, 64 or 128, the smallest that holds the
//   rows; more rows take several row tiles of 128), read K-major from
//   [rows, D]. D is walked in steps of 64, one 128-byte swizzle row of bf16.
//   One producer warp keeps a ring of 3-4 shared-memory stages filled with TMA
//   copies (`cp.async.bulk.tensor`, 128-byte swizzle, zero fill past D, F and
//   the group's rows; completion on a `full` mbarrier per stage), and the
//   consumer warpgroups run `wgmma.mma_async` m64nNk16 on each stage that has
//   arrived, keeping one wgmma group in flight and releasing the stage before
//   it through its `empty` mbarrier, so the copies of the next stages run
//   under the product of this one. The f32 accumulators stay in registers;
//   the epilogue rounds them once to bf16, stages the tile in shared memory
//   and writes it with coalesced 16-byte stores, predicated on the group's
//   rows and on F. The tensor maps are encoded on the host per launch through
//   the CUDA driver API's `cuTensorMapEncodeTiled` (fetched with
//   `cudaGetDriverEntryPoint`, so the library needs no -lcuda) and passed as
//   `__grid_constant__` parameters. The two encodes are a small part of a
//   launch's host time (`tools/profile_engine.py` times the C call of each
//   instance; the simt one encodes nothing), so the maps are not cached.
// * simt (float32, and bf16 at widths that are not multiples of 8): one thread
//   block per (group, 32-row chunk, 64-column tile of F), 256 threads walk D
//   in 32-deep steps, both tiles staged in shared memory as f32, FMAs on the
//   CUDA cores. Tensor cores would take f32 in TF32, which the float32 checks
//   (1e-4 per product, 1e-3 per forward) do not allow.
//
// Bounds on the card (H100 SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 dense), at
// moe-wide-sim's shapes (wi launch: D 1024 -> F 1024; S 32 slots of 2 MB):
// * decode (K2 bc 8 over 48 blocks, K4 C 5): bytes. The launch streams the
//   distinct weight slots its live groups hit (up to 64 MB) and does ~2 flops
//   per weight byte read, far under the ~295 flop/byte ridge: ~0.015-0.019 ms.
//   Swap AB puts the tensor core on the weights, the rows fill N = 8 (a 32-row
//   tile would waste 3/4 of the product), and a grid of blocks x F/64 (768
//   blocks for K2's wi launch) with 4 stages of 8 KB each keeps enough bytes in
//   flight to fill HBM.
// * prefill (K2 bc 128 over 96 blocks, K4 C 320): bytes and, nearly as much,
//   flops (~26 GFLOP: ~0.026 ms at peak). Each weight tile is read once per
//   128-row tile (not once per 32 rows), wgmma m64n128k16 runs at the tensor
//   cores' rate, and two blocks of 96 KB share an SM so one block's prologue
//   and epilogue run under the other's main loop. (A persistent grid of one
//   block per SM, or 256-column tiles, measured slower or no faster.)

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSimt = 0;
constexpr int kWgmma = 1;

// ---------------------------------------------------------------------------
// simt instance
// ---------------------------------------------------------------------------

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
grouped_gemm_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
cudaError_t launch_simt(const void* x, const void* w, const int* group_slot,
                        const int* live, void* out, int groups, int rows, int D, int F,
                        cudaStream_t stream) {
  const dim3 grid(groups, (rows + kBM - 1) / kBM, (F + kBN - 1) / kBN);
  grouped_gemm_simt_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), group_slot, live,
      static_cast<T*>(out), rows, D, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma instance: PTX wrappers
// ---------------------------------------------------------------------------

constexpr int kTileK = 64;                        // D per stage: 128 bytes of bf16
constexpr int kTileF = 64;                        // F per consumer warpgroup (wgmma M)
constexpr int kWTileBytes = kTileK * kTileF * 2;  // one weight tile, 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spins until the phase of the given parity has completed. A wait of more
// than ~2^36 cycles (tens of seconds) can only be a broken pipeline: it traps,
// so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 36)) __trap();
}

// One TMA copy of a box of `map` at element coordinates (c0, c1, c2),
// innermost first, into shared memory at `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle layout
// that TMA writes: 128-byte rows, 8-row atoms of 1024 bytes (1024-aligned).
// For the K-major B operand the rows are N rows and the stride between 8-row
// groups (SBO) is 1024 bytes; for the MN-major A operand the rows are k rows
// of 64 F values, and the stride between 8-k groups is again 1024 bytes. A is
// one swizzle atom wide (M = 64), so the leading offset (LBO, the stride
// between MN atoms) is never used; both fields hold 1024.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across wgmma
// boundaries (the asynchronous product owns the registers in between).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] (shared memory, MN-major) · B[16 x N] (shared
// memory, K-major), bf16 in, f32 accumulators: thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and column pairs
// 8 j + 2 (t % 4) of N-chunk j in d[4 j .. 4 j + 3].
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// wgmma instance: the kernel
// ---------------------------------------------------------------------------

// BN: rows per tile (wgmma N); WG: consumer warpgroups (64 columns of F
// each, wgmma M); STAGES: depth of the shared-memory ring.
template <int BN, int WG, int STAGES>
struct WgmmaCfg {
  static constexpr int kThreads = WG * 128 + 32;  // + one producer warp
  static constexpr int kCols = WG * kTileF;
  static constexpr int kXBytes = BN * kTileK * 2;
  static constexpr int kStageBytes = WG * kWTileBytes + kXBytes;  // a multiple of 1024
  static constexpr int kRingBytes = STAGES * kStageBytes;
  // ring + full/empty mbarriers + slack to align the ring to 1024 bytes
  static constexpr int kSmem = kRingBytes + 2 * STAGES * 8 + 1024;
  static constexpr int kOutPitch = kCols + 8;  // staged output row, +16 bytes
  static constexpr int kChunks = kCols / 8;    // 16-byte chunks of a tile row
  static_assert(BN * kOutPitch * 2 <= kRingBytes, "the output tile must fit the ring");
};

// out[g][m0 + r][n0 + c] for the tile of group g = blockIdx.x, rows m0 =
// blockIdx.y * BN, columns n0 = blockIdx.z * 64 WG; x_map views x as
// [groups][rows][D], w_map views w as [S][D][F] (both bf16, innermost last).
template <int BN, int WG, int STAGES, int MINB>
__global__ void __launch_bounds__(WG * 128 + 32, MINB)
grouped_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const int* __restrict__ group_slot, const int* __restrict__ live,
                          __nv_bfloat16* __restrict__ out, int rows, int D, int F) {
  using C = WgmmaCfg<BN, WG, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const int g = blockIdx.x;
  const int m0 = blockIdx.y * BN;
  const int n0 = blockIdx.z * C::kCols;
  const int tid = threadIdx.x;
  const int m_here = min(BN, rows - m0);
  __nv_bfloat16* o = out + ((size_t)g * rows + m0) * F;

  if (live[g] == 0) {  // empty block / group: zeros, no load, no product
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int q = tid; q < m_here * C::kChunks; q += C::kThreads) {
      const int c = n0 + (q % C::kChunks) * 8;
      if (c < F) *reinterpret_cast<uint4*>(o + (size_t)(q / C::kChunks) * F + c) = zero;
    }
    return;
  }
  const int slot = group_slot != nullptr ? group_slot[g] : g;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  // stage s: WG weight tiles [64 k][64 F] (F contiguous), then the row tile
  // [BN rows][64 k] (k contiguous), all in the 128-byte swizzle layout
  const uint32_t full = ring + C::kRingBytes;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * STAGES;    // empty[s] at empty + 8 s
  const int num_k = (D + kTileK - 1) / kTileK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);             // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, WG * 128);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32;
  if (warp == WG * 4) {  // the producer warp: one lane issues every copy
    if (tid % 32 == 0) {
      for (int i = 0; i < num_k; ++i) {
        const int s = i % STAGES;
        const uint32_t stage = ring + s * C::kStageBytes;
        mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, C::kStageBytes);
#pragma unroll
        for (int a = 0; a < WG; ++a)
          tma_load_3d(stage + a * kWTileBytes, &w_map, full + 8 * s, n0 + a * kTileF,
                      i * kTileK, slot);
        tma_load_3d(stage + WG * kWTileBytes, &x_map, full + 8 * s, i * kTileK, m0, g);
      }
    }
    return;
  }

  // consumer warpgroup wg: F columns n0 + 64 wg .. + 63 of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  for (int i = 0; i < num_k; ++i) {
    const int s = i % STAGES;
    const uint32_t a_tile = ring + s * C::kStageBytes + wg * kWTileBytes;
    const uint32_t b_tile = ring + s * C::kStageBytes + WG * kWTileBytes;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)  // 16 k rows of A = 2 atoms; 32 bytes of B rows
      Wgmma<BN>::mma(acc, sw128_desc(a_tile + kk * 2048), sw128_desc(b_tile + kk * 32));
    wgmma_commit();
    fence_acc(acc);
    // The group of step i - 1 is done: release its stage. The last step
    // waits for its own group here, inside the loop: after the loop, ptxas
    // hoists the epilogue's reads of the accumulators above a final
    // wait_group 0 (seen in the SASS), which then read a product in flight.
    if (i + 1 < num_k)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    if (i > 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
  }
  fence_acc(acc);

  // Epilogue: every consumer is done with the ring (and every copy landed),
  // so the tile is staged there as bf16 [BN rows][kOutPitch], then stored.
  named_sync(1, WG * 128);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem_raw + (ring - raw));
  const int lane = tid % 32;
  const int f = wg * kTileF + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = j * 8 + (lane % 4) * 2;
    cs[n * C::kOutPitch + f] = __float2bfloat16_rn(acc[4 * j]);
    cs[(n + 1) * C::kOutPitch + f] = __float2bfloat16_rn(acc[4 * j + 1]);
    cs[n * C::kOutPitch + f + 8] = __float2bfloat16_rn(acc[4 * j + 2]);
    cs[(n + 1) * C::kOutPitch + f + 8] = __float2bfloat16_rn(acc[4 * j + 3]);
  }
  named_sync(1, WG * 128);
  for (int q = tid; q < m_here * C::kChunks; q += WG * 128) {
    const int r = q / C::kChunks;
    const int c = (q % C::kChunks) * 8;
    if (n0 + c < F)
      *reinterpret_cast<uint4*>(o + (size_t)r * F + n0 + c) =
          *reinterpret_cast<const uint4*>(cs + r * C::kOutPitch + c);
  }
}

// ---------------------------------------------------------------------------
// wgmma instance: host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor map over [d2][d1][d0] (d0 contiguous), box {64, box1, 1},
// 128-byte swizzle; elements past any edge read as zeros.
bool encode_3d(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
               uint32_t box1) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kTileK), box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int BN, int WG, int STAGES, int MINB>
cudaError_t launch_wgmma(const void* x, const void* w, const int* group_slot, const int* live,
                         void* out, int groups, int rows, int D, int F, int S,
                         cudaStream_t stream) {
  using C = WgmmaCfg<BN, WG, STAGES>;
  const auto kernel = grouped_gemm_wgmma_kernel<BN, WG, STAGES, MINB>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap x_map, w_map;
  if (!encode_3d(&x_map, x, D, rows, groups, BN) || !encode_3d(&w_map, w, F, D, S, kTileK))
    return cudaErrorInvalidValue;
  const dim3 grid(groups, (rows + BN - 1) / BN, (F + C::kCols - 1) / C::kCols);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(x_map, w_map, group_slot, live,
                                                  static_cast<__nv_bfloat16*>(out), rows, D, F);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

cudaError_t dispatch(int dtype, int instance, const void* x, const void* w,
                     const int* group_slot, const int* live, void* out, int groups, int rows,
                     int D, int F, int S, void* stream) {
  if (groups <= 0 || rows <= 0 || F <= 0) return cudaSuccess;
  if (D < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == kSimt) {
    if (dtype == 0)
      return launch_simt<float>(x, w, group_slot, live, out, groups, rows, D, F, s);
    if (dtype == 1)
      return launch_simt<__nv_bfloat16>(x, w, group_slot, live, out, groups, rows, D, F, s);
    return cudaErrorInvalidValue;
  }
  if (instance != kWgmma || dtype != 1 || D == 0 || D % 8 != 0 || F % 8 != 0 || S <= 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out))
    return cudaErrorInvalidValue;
  // the smallest N that holds the rows; two consumer warpgroups from 64 rows
  if (rows <= 8)
    return launch_wgmma<8, 1, 4, 4>(x, w, group_slot, live, out, groups, rows, D, F, S, s);
  if (rows <= 16)
    return launch_wgmma<16, 1, 4, 4>(x, w, group_slot, live, out, groups, rows, D, F, S, s);
  if (rows <= 32)
    return launch_wgmma<32, 1, 4, 4>(x, w, group_slot, live, out, groups, rows, D, F, S, s);
  if (rows <= 64)
    return launch_wgmma<64, 2, 4, 2>(x, w, group_slot, live, out, groups, rows, D, F, S, s);
  return launch_wgmma<128, 2, 3, 1>(x, w, group_slot, live, out, groups, rows, D, F, S, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; instance: 0 = simt, 1 = wgmma (bf16, D
// and F multiples of 8, 16-byte aligned pointers). Each returns the
// cudaError_t of its launch. K2: block_slot[b] must lie in [0, S).
extern "C" int llmd_ragged_grouped_gemm(const void* x, const void* w,
                                        const int* block_slot, const int* block_rows,
                                        void* out, int nb, int bc, int D, int F, int S,
                                        int dtype, int instance, void* stream) {
  return dispatch(dtype, instance, x, w, block_slot, block_rows, out, nb, bc, D, F, S, stream);
}

// K4.
extern "C" int llmd_grouped_gemm(const void* x, const void* w, const int* counts,
                                 void* out, int G, int C, int D, int F, int dtype,
                                 int instance, void* stream) {
  return dispatch(dtype, instance, x, w, nullptr, counts, out, G, C, D, F, G, stream);
}
