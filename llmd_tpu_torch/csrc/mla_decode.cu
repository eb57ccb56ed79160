// Absorbed-MLA latent decode attention for Hopper (sm_90a): one query row per
// sequence, every head attending over the sequence's single-plane latent pages.
//
// Replaces the TPU kernel `llmd_tpu/ops/mla_decode.py::mla_decode_pallas`
// (`_decode_kernel`). Semantics, as there:
//   * q [B, H, D]: sequence b's one query row for each of its H heads, at the
//     latent width D = rank + rope (160 on moe-wide-mla, 80 on tiny-mla).
//   * pool [P, ps, 1, D]: one latent row [c_kv ; k_rope] per token, which is
//     both the key and the value of every head (absorbed attention).
//   * page_tables [B, max_pages] lists sequence b's pages in order (layer offset
//     applied); only the first kv_lens[b] tokens are read, so entries past them
//     are never touched. A sequence with kv_len 0 gets exact zeros.
//   * q is scaled by sm_scale and rounded back to its type before the scores,
//     as the reference pre-scales it; softmax runs online over the keys in f32
//     and the P.V sum accumulates in f32. Inputs are f32 or bf16.
//
// Bound on the card: the kernel reads each latent row once,
// sum_b kv_len_b * D * sizeof(T) bytes (plus q, page tables and out), and does
// 4*H*D flops per key; at H 16 and D 160 that is 32 flops per bf16 byte, far
// below the ~295 flop/byte ridge of an H100, so it is bound by device memory.
//
// Design (simple and correct first), for what K3 computes: all heads share
// one latent row, so each row is brought on chip ONCE and used by every head.
//   * One block per sequence, 256 threads. Keys go in tiles of KEYS = 256/H
//     (16 at H 16, 64 at H 4), gathered through the page table row by row
//     (any page size), 16-byte loads, converted to f32 into shared memory with
//     a padded row stride (D+1: conflict-free column reads). The next tile's
//     loads are issued into registers before the current tile is scored, so
//     their latency hides behind the arithmetic.
//   * Scores: thread (h, t) takes the dot of head h's pre-scaled query with
//     key t (H x KEYS = 256 dots a tile).
//   * Online softmax: one warp per head updates (m, l) from the tile's scores
//     and leaves the probabilities and the rescale factor in shared memory.
//   * P.V: the 256/H threads of head h own the output dims j, j + 256/H, ...
//     and accumulate p[h][t] * row[t][d] in registers.
//   * o = acc / l, or exact zeros when l is 0 (kv_len 0).
// Later work: split-KV across blocks for small batches (one block per sequence
// fills 64 of 132 SMs at B 64), cp.async/TMA double buffering, wgmma for the
// score and P.V products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// One tile's latent rows into registers: vector i = threadIdx.x + j*kThreads
// is (key i/VPR of the tile, 16-byte part i%VPR), gathered through the page
// table. Keys at or past kv_len load zeros and are never weighed.
template <typename T, int D, int KEYS, int LOADS>
__device__ __forceinline__ void load_tile(uint4 (&stage)[LOADS], const T* __restrict__ pool,
                                          const int* __restrict__ pt, int tile, int kv_len,
                                          int page_size) {
  constexpr int VPR = D / (16 / sizeof(T));
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int i = threadIdx.x + j * kThreads;
    stage[j] = make_uint4(0, 0, 0, 0);
    if (i < KEYS * VPR) {
      const int pos = tile * KEYS + i / VPR;
      if (pos < kv_len) {
        const int page = __ldg(pt + pos / page_size);
        const uint4* src = reinterpret_cast<const uint4*>(
            pool + ((size_t)page * page_size + pos % page_size) * D);
        stage[j] = __ldg(src + i % VPR);
      }
    }
  }
}

template <typename T, int D, int H>
__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                  const int* __restrict__ page_tables,
                  const int* __restrict__ kv_lens, T* __restrict__ out,
                  int page_size, int max_pages, float scale) {
  static_assert(kThreads % H == 0, "heads must divide the block");
  constexpr int KEYS = kThreads / H;     // keys per tile
  constexpr int TPH = kThreads / H;      // P.V threads per head
  constexpr int EPT = (D + TPH - 1) / TPH;  // output dims per thread
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  static_assert(D % VEC == 0, "latent width must fill whole 16-byte vectors");
  constexpr int VPR = D / VEC;           // vectors per latent row
  constexpr int LOADS = (KEYS * VPR + kThreads - 1) / kThreads;  // per thread per tile
  constexpr int LD = D + 1;              // padded shared row stride

  __shared__ float row_s[KEYS * LD];
  __shared__ float q_s[H * LD];
  __shared__ float p_s[H][KEYS];
  __shared__ float m_s[H];     // running max per head
  __shared__ float l_s[H];     // running softmax denominator per head
  __shared__ float corr_s[H];  // this tile's rescale of the accumulator

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  T* o = out + (size_t)b * H * D;
  const int kv_len = min(__ldg(kv_lens + b), max_pages * page_size);

  // q pre-scaled and rounded to T, as the reference does before its kernel
  const T* qb = q + (size_t)b * H * D;
  for (int i = tid; i < H * D; i += kThreads)
    q_s[(i / D) * LD + i % D] = to_float(from_float<T>(to_float(qb[i]) * scale));
  if (tid < H) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int* pt = page_tables + (size_t)b * max_pages;
  const int n_tiles = (kv_len + KEYS - 1) / KEYS;

  uint4 stage[LOADS];  // one tile's rows in registers, between global and shared
  // P.V ownership: head ph, dims pj + TPH*e
  const int ph = tid / TPH;
  const int pj = tid % TPH;
  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;

  if (n_tiles > 0) load_tile<T, D, KEYS, LOADS>(stage, pool, pt, 0, kv_len, page_size);
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // the previous tile's P.V is done with row_s and p_s
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * kThreads;
      if (i < KEYS * VPR) {
        const T* e = reinterpret_cast<const T*>(&stage[j]);
        float* dst = row_s + (i / VPR) * LD + (i % VPR) * VEC;
#pragma unroll
        for (int k = 0; k < VEC; ++k) dst[k] = to_float(e[k]);
      }
    }
    __syncthreads();
    if (tile + 1 < n_tiles)  // in flight during the math below
      load_tile<T, D, KEYS, LOADS>(stage, pool, pt, tile + 1, kv_len, page_size);

    {  // scores: thread (h, t)
      const int h = tid / KEYS;
      const int t = tid % KEYS;
      const float* qh = q_s + h * LD;
      const float* kt = row_s + t * LD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qh[d], kt[d], s);
      p_s[h][t] = tile * KEYS + t < kv_len ? s : -INFINITY;
    }
    __syncthreads();

    // online softmax: warp w updates heads w, w + kWarps, ...
    for (int h = warp; h < H; h += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < KEYS; t += 32) mx = fmaxf(mx, p_s[h][t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      // every tile holds at least one key below kv_len: m_new is finite
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < KEYS; t += 32) {
        const float p = expf(p_s[h][t] - m_new);  // 0 for masked keys (-inf)
        p_s[h][t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      __syncwarp();  // every lane has read m_s[h] before lane 0 moves it
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);  // 0 on the first tile
        corr_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // P.V
    const float c = corr_s[ph];
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[e] *= c;
#pragma unroll 4
    for (int t = 0; t < KEYS; ++t) {
      const float p = p_s[ph][t];
      const float* kt = row_s + t * LD + pj;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        if (D % TPH != 0 && pj + TPH * e >= D) break;
        acc[e] = fmaf(p, kt[TPH * e], acc[e]);
      }
    }
  }
  __syncthreads();

  const float l = l_s[ph];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int d = pj + TPH * e;
    if (D % TPH != 0 && d >= D) break;
    o[ph * D + d] = from_float<T>(l > 0.f ? acc[e] / l : 0.f);
  }
}

template <typename T, int D, int H>
cudaError_t launch(const void* q, const void* pool, const int* page_tables,
                   const int* kv_lens, void* out, int batch, int page_size,
                   int max_pages, float scale, cudaStream_t stream) {
  mla_decode_kernel<T, D, H><<<batch, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), page_tables, kv_lens,
      static_cast<T*>(out), page_size, max_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int num_heads, int latent_dim, const void* q, const void* pool,
                     const int* page_tables, const int* kv_lens, void* out, int batch,
                     int page_size, int max_pages, float scale, cudaStream_t stream) {
  if (num_heads == 16 && latent_dim == 160)  // moe-wide-mla
    return launch<T, 160, 16>(q, pool, page_tables, kv_lens, out, batch, page_size,
                              max_pages, scale, stream);
  if (num_heads == 4 && latent_dim == 80)  // tiny-mla
    return launch<T, 80, 4>(q, pool, page_tables, kv_lens, out, batch, page_size,
                            max_pages, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a (heads, latent width) without an instance).
extern "C" int llmd_mla_decode(const void* q, const void* pool, const int* page_tables,
                               const int* kv_lens, void* out, int batch, int num_heads,
                               int latent_dim, int page_size, int max_pages, float scale,
                               int dtype, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(num_heads, latent_dim, q, pool, page_tables, kv_lens, out,
                           batch, page_size, max_pages, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(num_heads, latent_dim, q, pool, page_tables, kv_lens,
                                   out, batch, page_size, max_pages, scale, s);
  return cudaErrorInvalidValue;
}
