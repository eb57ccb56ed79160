// Ragged paged attention for Hopper (sm_90a): mixed prefill + decode GQA
// attention over the layer-folded paged KV pool, one flat batch of query tokens.
//
// Replaces the TPU kernel `llmd_tpu/ops/paged_attention.py::paged_attention_tpu`
// (JAX's Pallas `ragged_paged_attention`). Semantics, as there:
//   * q [N, H, D] holds the query tokens of num_seqs sequences back to back;
//     sequence b owns rows cu_q_lens[b] .. cu_q_lens[b+1]-1. num_seqs is read on
//     the device (a host read would force a sync every layer). Rows at or past
//     cu_q_lens[num_seqs] are padding and are written as zeros.
//   * Queries are each sequence's LAST q_len tokens, so query i of sequence b
//     sits at position kv_len - q_len + i and attends keys 0 .. kv_len-q_len+i
//     (causal).
//   * pool [P, ps, 2*Hk, D]: K of kv head g at plane 2g, V at plane 2g+1.
//     Single-plane mode (MLA's latent pool [P, ps, 1, D], absorbed attention):
//     every head attends over the same row, which is both K and V; this is the
//     card-side form of the reference's unified MLA attention
//     (`llmd_tpu/models/transformer.py::ragged_paged_attention_xla` with one
//     plane), at the unpadded latent width D = rank + rope (160, 80).
//     page_tables [B, max_pages] lists a sequence's pages in order (layer offset
//     already applied by the caller); -1 entries are never read.
//   * Softmax runs online in f32 with sm_scale; inputs are f32 or bf16.
//
// Design (simple and correct first):
//   * One block per (query token n, head group g), 4 warps. A GQA block serves
//     the qpk = H/Hk query heads of kv head g, so every K/V row it reads is used
//     qpk times. A single-plane block serves QPK of the H heads (8 at D 160, 4
//     at D 80: QPK x D floats of accumulator per lane stay in registers and
//     the static shared arrays under 48 KB); the H/QPK blocks of a token read
//     the same latent rows, the later ones mostly from L2.
//   * Warps take 32-key tiles in turn. In a tile, lane j scores key j against
//     all qpk heads (its K row read with 16-byte loads; q pre-scaled in shared
//     memory, read by broadcast). One warp max per head updates the running
//     max; each lane keeps a partial softmax denominator. For P.V, the tile's
//     probabilities are broadcast key by key and lane j accumulates output
//     dims j, j+32, ... (ceil(D/32) of them, the last ones masked when 32 does
//     not divide D), reading each V row as one coalesced warp load.
//   * Each warp's (m, l, acc) meet in shared memory at the end; o = acc / l.
//
// Bound on the card: decode reads sum_b kv_len_b * 2*Hk*D*sizeof(T) bytes of KV
// per layer (1*D for the latent pool; plus q, page tables and out), and does
// 4*H*D flops per key — far below the ~295 flop/byte ridge of an H100, so the
// kernel is bound by device memory bandwidth. Later work: query tiling for
// prefill chunks (each query token re-reads its sequence's KV here), wgmma/TMA,
// split-KV for long contexts at small batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // keys per warp tile: one per lane
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

// s[h] = dot(q_s[h], k_row) for the qpk heads; k_row read as 16-byte vectors.
template <typename T, int D, int QPK>
__device__ __forceinline__ void qk_dot(const T* __restrict__ k_row,
                                       const float* __restrict__ q_s,
                                       float (&s)[QPK]) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(D % kPer == 0, "head dim must fill whole 16-byte vectors");
  const uint4* vec = reinterpret_cast<const uint4*>(k_row);
#pragma unroll
  for (int h = 0; h < QPK; ++h) s[h] = 0.f;
#pragma unroll
  for (int i = 0; i < D / kPer; ++i) {
    const uint4 u = __ldg(vec + i);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float kf = to_float(e[j]);
#pragma unroll
      for (int h = 0; h < QPK; ++h) s[h] = fmaf(q_s[h * D + i * kPer + j], kf, s[h]);
    }
  }
}

template <typename T, int D, int QPK>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                       const int* __restrict__ page_tables,
                       const int* __restrict__ kv_lens,
                       const int* __restrict__ cu_q_lens,
                       const int* __restrict__ num_seqs_ptr, T* __restrict__ out,
                       int num_heads, int num_planes, int page_size,
                       int max_pages, float scale) {
  constexpr int EPL = (D + 31) / 32;  // output dims owned by each lane: lane + 32*e
  __shared__ float q_s[QPK * D];
  __shared__ float m_s[kWarps][QPK];
  __shared__ float l_s[kWarps][QPK];
  __shared__ float acc_s[kWarps][QPK][D];

  const int n = blockIdx.x;  // query token
  const int g = blockIdx.y;  // kv head, or head group of a single-plane pool
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t head_off = ((size_t)n * num_heads + (size_t)g * QPK) * D;
  T* o = out + head_off;

  // Owning sequence and causal limit (same value in every thread).
  const int num_seqs = __ldg(num_seqs_ptr);
  const int total = num_seqs > 0 ? __ldg(cu_q_lens + num_seqs) : 0;
  int b = 0;
  int limit = 0;  // keys 0 .. limit-1 are attended
  if (n < total) {
    int lo = 1, hi = num_seqs;  // first i in [1, num_seqs] with cu[i] > n
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(cu_q_lens + mid) > n) hi = mid; else lo = mid + 1;
    }
    b = lo - 1;
    const int q_start = __ldg(cu_q_lens + b);
    const int q_len = __ldg(cu_q_lens + b + 1) - q_start;
    const int kv_len = __ldg(kv_lens + b);
    limit = min(kv_len - q_len + (n - q_start) + 1, max_pages * page_size);
  }
  if (limit <= 0) {  // padding row, or nothing to attend
    for (int i = tid; i < QPK * D; i += kThreads) o[i] = from_float<T>(0.f);
    return;
  }

  const T* qp = q + head_off;
  for (int i = tid; i < QPK * D; i += kThreads) q_s[i] = to_float(qp[i]) * scale;
  __syncthreads();

  const int* pt = page_tables + (size_t)b * max_pages;
  const bool single_plane = num_planes == 1;  // the latent row is K and V
  const size_t row = (size_t)num_planes * D;  // elements per token slot
  const size_t k_off = single_plane ? 0 : (size_t)(2 * g) * D;
  const size_t v_off = (single_plane ? 0 : k_off + D) + lane;

  float m[QPK], l[QPK], acc[QPK][EPL];
#pragma unroll
  for (int h = 0; h < QPK; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[h][e] = 0.f;
  }

  const int n_tiles = (limit + kTile - 1) / kTile;
  for (int tile = warp; tile < n_tiles; tile += kWarps) {
    const int t = tile * kTile + lane;  // this lane's key
    long long slot = -1;
    if (t < limit) {
      const int page = __ldg(pt + t / page_size);
      if (page >= 0) slot = (long long)page * page_size + t % page_size;
    }
    float s[QPK];
    if (slot >= 0) {
      qk_dot<T, D, QPK>(pool + (size_t)slot * row + k_off, q_s, s);
    } else {
#pragma unroll
      for (int h = 0; h < QPK; ++h) s[h] = -INFINITY;
    }
    float p[QPK];
#pragma unroll
    for (int h = 0; h < QPK; ++h) {
      float mx = s[h];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[h], mx);
      if (m_new == -INFINITY) {  // every key so far masked: nothing to add
        p[h] = 0.f;
        continue;
      }
      const float corr = expf(m[h] - m_new);  // 0 when m[h] is -inf
      p[h] = expf(s[h] - m_new);              // 0 for masked keys
      l[h] = l[h] * corr + p[h];              // lane-partial denominator
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[h][e] *= corr;
      m[h] = m_new;
    }
    const int n_keys = min(kTile, limit - tile * kTile);
#pragma unroll 4
    for (int j = 0; j < n_keys; ++j) {
      const long long sj = __shfl_sync(kFull, slot, j);
      float pj[QPK];
#pragma unroll
      for (int h = 0; h < QPK; ++h) pj[h] = __shfl_sync(kFull, p[h], j);
      if (sj < 0) continue;  // warp-uniform: unmapped or past the limit
      const T* v_row = pool + (size_t)sj * row + v_off;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        if (D % 32 != 0 && lane + 32 * e >= D) break;
        const float v = to_float(v_row[32 * e]);
#pragma unroll
        for (int h = 0; h < QPK; ++h) acc[h][e] = fmaf(pj[h], v, acc[h][e]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < QPK; ++h) {
    float sum = l[h];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) {
      m_s[warp][h] = m[h];
      l_s[warp][h] = sum;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      if (D % 32 != 0 && lane + 32 * e >= D) break;
      acc_s[warp][h][lane + 32 * e] = acc[h][e];
    }
  }
  __syncthreads();

  for (int i = tid; i < QPK * D; i += kThreads) {
    const int h = i / D;
    const int d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][h]);
    float den = 0.f, num = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (m_s[w][h] == -INFINITY) continue;  // warp saw no key
        const float c = expf(m_s[w][h] - mx);
        den += l_s[w][h] * c;
        num += acc_s[w][h][d] * c;
      }
    }
    o[i] = from_float<T>(den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int D, int QPK>
cudaError_t launch(const void* q, const void* pool, const int* page_tables,
                   const int* kv_lens, const int* cu_q_lens, const int* num_seqs,
                   void* out, int num_tokens, int num_heads, int num_planes,
                   int page_size, int max_pages, float scale, cudaStream_t stream) {
  const dim3 grid(num_tokens, num_heads / QPK);
  paged_attention_kernel<T, D, QPK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), page_tables, kv_lens,
      cu_q_lens, num_seqs, static_cast<T*>(out), num_heads, num_planes,
      page_size, max_pages, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_qpk(int qpk, const void* q, const void* pool,
                         const int* page_tables, const int* kv_lens,
                         const int* cu_q_lens, const int* num_seqs, void* out,
                         int num_tokens, int num_heads, int num_planes,
                         int page_size, int max_pages, float scale,
                         cudaStream_t stream) {
#define LLMD_QPK(QPK)                                                          \
  case QPK:                                                                    \
    return launch<T, D, QPK>(q, pool, page_tables, kv_lens, cu_q_lens,         \
                             num_seqs, out, num_tokens, num_heads, num_planes, \
                             page_size, max_pages, scale, stream);
  switch (qpk) {
    LLMD_QPK(1)
    LLMD_QPK(2)
    LLMD_QPK(4)
    LLMD_QPK(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef LLMD_QPK
}

template <typename T>
cudaError_t dispatch(int num_planes, int qpk, int head_dim, const void* q,
                     const void* pool, const int* page_tables, const int* kv_lens,
                     const int* cu_q_lens, const int* num_seqs, void* out,
                     int num_tokens, int num_heads, int page_size, int max_pages,
                     float scale, cudaStream_t stream) {
  if (num_planes == 1) {  // single-plane latent pool: (width, heads per block)
    if (head_dim == 160 && qpk == 8)
      return launch<T, 160, 8>(q, pool, page_tables, kv_lens, cu_q_lens, num_seqs,
                               out, num_tokens, num_heads, 1, page_size,
                               max_pages, scale, stream);
    if (head_dim == 80 && qpk == 4)
      return launch<T, 80, 4>(q, pool, page_tables, kv_lens, cu_q_lens, num_seqs,
                              out, num_tokens, num_heads, 1, page_size,
                              max_pages, scale, stream);
    return cudaErrorInvalidValue;
  }
#define LLMD_D(D)                                                              \
  case D:                                                                      \
    return dispatch_qpk<T, D>(qpk, q, pool, page_tables, kv_lens, cu_q_lens,   \
                              num_seqs, out, num_tokens, num_heads,            \
                              num_planes, page_size, max_pages, scale, stream);
  switch (head_dim) {
    LLMD_D(32)
    LLMD_D(64)
    LLMD_D(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef LLMD_D
}

}  // namespace

// num_planes: 2*Hk for a K/V pool, 1 for the single-plane latent pool.
// heads_per_block: H/Hk for a K/V pool; for a latent pool, the query heads one
// block serves (8 at width 160, 4 at width 80). dtype: 0 = float32, 1 =
// bfloat16. Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// shape without an instance).
extern "C" int llmd_paged_attention(const void* q, const void* pool,
                                    const int* page_tables, const int* kv_lens,
                                    const int* cu_q_lens, const int* num_seqs,
                                    void* out, int num_tokens, int num_heads,
                                    int num_planes, int heads_per_block,
                                    int head_dim, int page_size, int max_pages,
                                    float scale, int dtype, void* stream) {
  if (num_tokens <= 0) return 0;
  if (heads_per_block <= 0 || num_heads % heads_per_block != 0) return cudaErrorInvalidValue;
  if (num_planes != 1 && (num_planes % 2 != 0 || num_planes / 2 * heads_per_block != num_heads))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(num_planes, heads_per_block, head_dim, q, pool, page_tables,
                           kv_lens, cu_q_lens, num_seqs, out, num_tokens, num_heads,
                           page_size, max_pages, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(num_planes, heads_per_block, head_dim, q, pool,
                                   page_tables, kv_lens, cu_q_lens, num_seqs, out,
                                   num_tokens, num_heads, page_size, max_pages,
                                   scale, s);
  return cudaErrorInvalidValue;
}
