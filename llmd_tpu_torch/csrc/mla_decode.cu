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
//     and the P.V sum accumulates in f32. q and out are f32 or bf16; the pool
//     is q's type or float8_e4m3 at unit scale beside either (the reference's
//     adapter upcasts an fp8 latent pool at use, `mla_paged_attention_latent`
//     :195-199; here the kernel reads the fp8 pages itself, so the layer's
//     pool is never copied).
//
// Bound on the card: the kernel reads each latent row once,
// sum_b kv_len_b * D * sizeof(T) bytes (plus q, page tables and out), and does
// 4*H*D flops per key; at H 16 and D 160 that is 32 flops per bf16 byte, far
// below the ~295 flop/byte ridge of an H100, so it is bound by device memory;
// an fp8 pool halves the latent bytes.
//
// Two instances; the wrapper picks one (`ops/mla_decode._instance`) and passes
// it in.
//
// * mma (bfloat16 at (H, D) = (16, 160), moe-wide-mla's; at tiny-mla's (4, 80)
//   the same template spills, and simt serves it). The work item is
//   (sequence b, KV split s); the grid is splits x B, sized on the host from B,
//   the table width and the page size alone (`ops/mla_decode._plan`, no read
//   of kv_lens): the keys are split when the batch alone would not fill the
//   card (decode at small batch, long contexts).
//   - The latent through shared memory: 64-key stages (a key's D elements,
//     padded by 16 bytes: 336 bytes at D 160, an odd multiple of 16, so the 8
//     rows of an ldmatrix hit 8 bank groups) in a ring of 3 stages filled by
//     16-byte `cp.async` copies, so each latent row comes on chip once. The
//     next stage's pool slots come from the page table into a small
//     shared-memory ring a stage ahead, so a stage's copies never wait on a
//     page-table load. Keys at or past kv_len, and past the split, are
//     zero-filled and never read.
//   - Tensor cores, `mma.sync.m16n8k16` (bf16 in, f32 accumulators), keys on M
//     ("swap AB"): S^T = L . Q^T has the H heads of the one query row on N
//     (two n8 fragments at H 16; D/16 k16 steps), and O^T += L^T . P^T reads
//     the SAME stage with ldmatrix.trans (D/16 m16 fragments): the row is K
//     and V. q sits in registers for the whole item, scaled and rounded to
//     bf16 as the reference does, so the reference's q is the mma operand.
//   - P = bf16(P) + bf16(P - bf16(P)), two mmas into one f32 accumulator (P
//     rounded once reads one rounding unit off the f32 plain version).
//   - The 4 warps take the 4 16-key sub-tiles of each stage and merge their
//     (m, l, o) in shared memory at the end.
//   - With more than one split, each item writes its partial (m, l, o/l) in
//     f32 to scratch allocated by the wrapper, and a second kernel launched
//     from the same entry point merges them. A split that holds no key of its
//     sequence marks its partials empty (m = -inf) and exits before it loads
//     anything, so an idle row (kv_len 0) has every split empty and the merge
//     writes exact zeros.
//   - fp8 pool (KT = __nv_fp8_e4m3): raw e4m3 stages in the ring (10
//     16-byte copies a latent row at width 160, not 20); each warp converts
//     its own 16-key sub-tile into one bf16 compute stage of the layout above
//     before it reads it (a warp barrier, not a block one): the bf16
//     instance's result on the upcast pool, bit for bit.
//   The ring, the copies, the conversion, the fragments' helpers and the
//   merge are mma_attention.cuh's, shared with paged_attention.cu.
// * simt (float32, which the tensor cores would take in TF32, and (4, 80)): one block per
//   sequence, 256 threads. Keys go in tiles of KEYS = 256/H (16 at H 16, 64 at
//   H 4), gathered through the page table row by row (any page size), 16-byte
//   loads, converted to f32 into shared memory with a padded row stride (D+1:
//   conflict-free column reads). The next tile's loads are issued into
//   registers before the current tile is scored, so their latency hides
//   behind the arithmetic.
//   - Scores: thread (h, t) takes the dot of head h's pre-scaled query with
//     key t (H x KEYS = 256 dots a tile).
//   - Online softmax: one warp per head updates (m, l) from the tile's scores
//     and leaves the probabilities and the rescale factor in shared memory.
//   - P.V: the 256/H threads of head h own the output dims j, j + 256/H, ...
//     and accumulate p[h][t] * row[t][d] in registers.
//   - o = acc / l, or exact zeros when l is 0 (kv_len 0).
//   An fp8 pool (KT = __nv_fp8_e4m3) loads 16 elements a 16-byte load and
//   converts them to f32 into the same shared rows.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_attention.cuh"

namespace {

using namespace llmd_attn;

constexpr int kSimt = 0;
constexpr int kMma = 1;
constexpr int kThreads = 256;  // simt instance
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// simt instance
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_float<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return e4m3x2_to_float2(x.__x).x;  // exact: unit scale
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

template <typename T, typename KT, int D, int H>
__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const T* __restrict__ q, const KT* __restrict__ pool,
                  const int* __restrict__ page_tables,
                  const int* __restrict__ kv_lens, T* __restrict__ out,
                  int page_size, int max_pages, float scale) {
  static_assert(kThreads % H == 0, "heads must divide the block");
  constexpr int KEYS = kThreads / H;     // keys per tile
  constexpr int TPH = kThreads / H;      // P.V threads per head
  constexpr int EPT = (D + TPH - 1) / TPH;  // output dims per thread
  constexpr int VEC = 16 / sizeof(KT);   // pool elements per 16-byte load
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

  if (n_tiles > 0) load_tile<KT, D, KEYS, LOADS>(stage, pool, pt, 0, kv_len, page_size);
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // the previous tile's P.V is done with row_s and p_s
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * kThreads;
      if (i < KEYS * VPR) {
        float* dst = row_s + (i / VPR) * LD + (i % VPR) * VEC;
        if constexpr (sizeof(KT) == 1) {  // e4m3: unpacked by shifts, in registers
          float f[VEC];
          e4m3x16_to_float(stage[j], f);
#pragma unroll
          for (int k = 0; k < VEC; ++k) dst[k] = f[k];
        } else {
          const KT* e = reinterpret_cast<const KT*>(&stage[j]);
#pragma unroll
          for (int k = 0; k < VEC; ++k) dst[k] = to_float(e[k]);
        }
      }
    }
    __syncthreads();
    if (tile + 1 < n_tiles)  // in flight during the math below
      load_tile<KT, D, KEYS, LOADS>(stage, pool, pt, tile + 1, kv_len, page_size);

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

template <typename T, typename KT, int D, int H>
cudaError_t launch_simt(const void* q, const void* pool, const int* page_tables,
                        const int* kv_lens, void* out, int batch, int page_size,
                        int max_pages, float scale, cudaStream_t stream) {
  mla_decode_kernel<T, KT, D, H><<<batch, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(pool), page_tables, kv_lens,
      static_cast<T*>(out), page_size, max_pages, scale);
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t dispatch_simt(int num_heads, int latent_dim, const void* q, const void* pool,
                          const int* page_tables, const int* kv_lens, void* out, int batch,
                          int page_size, int max_pages, float scale, cudaStream_t stream) {
  if (num_heads == 16 && latent_dim == 160)  // moe-wide-mla
    return launch_simt<T, KT, 160, 16>(q, pool, page_tables, kv_lens, out, batch, page_size,
                                       max_pages, scale, stream);
  if (num_heads == 4 && latent_dim == 80)  // tiny-mla
    return launch_simt<T, KT, 80, 4>(q, pool, page_tables, kv_lens, out, batch, page_size,
                                     max_pages, scale, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// mma instance
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps: one 16-key sub-tile of each stage apiece
constexpr int kMmaWarps = kMmaThreads / 32;

template <int D, typename KT>
using LatentCfg = StageCfg<D, 1, kMmaThreads, KT>;

template <int D, int H, typename KT>
__global__ void __launch_bounds__(kMmaThreads)
mla_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const KT* __restrict__ pool,
                      const int* __restrict__ page_tables, const int* __restrict__ kv_lens,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
                      float2* __restrict__ part_ml, int batch, int page_size, int max_pages,
                      float scale, int n_splits, int split_keys) {
  using C = LatentCfg<D, KT>;
  constexpr int NF = H / 8;  // n8 fragments of heads
  static_assert(H % 8 == 0 && H <= 16, "the heads fill one or two n8 fragments");
  static_assert(kMmaWarps * H * (D + 2) * 4 <= C::kStageBytes, "epilogue does not fit");
  extern __shared__ __align__(16) unsigned char smem[];  // ring (+ compute stage), slot tables
  int* slot_tab = reinterpret_cast<int*>(smem + C::kStageBytes);  // [kSlotTables][64]

  const int sp = blockIdx.x;  // KV split: a sequence's splits run side by side
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group

  const int kv_len = min(__ldg(kv_lens + b), max_pages * page_size);
  const int k_lo = sp * split_keys;
  const int k_hi = min(k_lo + split_keys, kv_len);
  if (k_lo >= k_hi) {  // no key of this split: load nothing
    if (n_splits > 1) {  // its partials say so; the merge skips them
      for (int h = tid; h < H; h += kMmaThreads)
        part_ml[((size_t)sp * batch + b) * H + h] = make_float2(-INFINITY, 0.f);
    } else {  // kv_len 0: exact zeros
      for (int i = tid * 8; i < H * D; i += kMmaThreads * 8)
        *reinterpret_cast<uint4*>(out + (size_t)b * H * D + i) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // Q^T as the B operand: lane holds head f*8 + gid at dims ks*16 + tig*2 (+1)
  // and + 8, scaled and rounded to bf16 as the reference pre-scales q.
  uint32_t qf[NF][C::kSteps][2];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const unsigned* qr =
        reinterpret_cast<const unsigned*>(q + ((size_t)b * H + f * 8 + gid) * D + tig * 2);
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const unsigned u = __ldg(qr + (ks * 16 + half * 8) / 2);
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&u);
        qf[f][ks][half] =
            bits(__floats2bfloat162_rn(__low2float(x) * scale, __high2float(x) * scale));
      }
  }

  float acc[C::kSteps][NF][4];  // O^T: d on M (m16 tile mt), heads on N
  float m[NF][2], l[NF][2];     // running max (log2 domain) and lane-partial sum per head
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[f][j] = -INFINITY;
      l[f][j] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < C::kSteps; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][f][c] = 0.f;
  }

  const int* pt = page_tables + (size_t)b * max_pages;
  const int n_st = (k_hi - k_lo + kStageKeys - 1) / kStageKeys;
  // slot tables of the first kStages stages, one round trip to the page table
  for (int i = tid; i < C::kStages * kStageKeys; i += kMmaThreads)
    slot_tab[i] = key_slot(pt, k_lo + i, k_hi, page_size);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_st)
      load_stage<D, 1, kMmaThreads>(smem + s * C::kRingStage, slot_tab + s * kStageKeys,
                                    pool, D, 0);
    cp_async_commit();
  }

  // ldmatrix row addresses (elements into a 16-key sub-tile). L, A of S^T:
  // matrices (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7, d 8-15), (keys
  // 8-15, d 8-15). L^T (the same rows transposed on load), A of O^T: (d 0-7,
  // keys 0-7), (d 8-15, keys 0-7), (d 0-7, keys 8-15), (d 8-15, keys 8-15).
  const int mi = lane >> 3, mr = lane & 7;
  const int k_ld = (mr + (mi & 1) * 8) * C::kRow + (mi >> 1) * 8;
  const int v_ld = (mr + (mi >> 1) * 8) * C::kRow + (mi & 1) * 8;

  for (int it = 0; it < n_st; ++it) {
    cp_async_wait<C::kStages - 2>();  // stage it has landed (this thread's copies) ...
    __syncthreads();                  // ... everyone's, and stage it-1 is consumed
    {
      const int s = it + C::kStages - 1;
      if (s < n_st)
        load_stage<D, 1, kMmaThreads>(smem + (s % C::kStages) * C::kRingStage,
                                      slot_tab + (s % C::kSlotTables) * kStageKeys, pool, D,
                                      0);
      cp_async_commit();
    }
    // the slot of key tid of stage it + kStages: stored after this stage's
    // compute, so the page-table load lands under it
    const int next_key = k_lo + (it + C::kStages) * kStageKeys + tid;
    const int fetched = tid < kStageKeys ? key_slot(pt, next_key, k_hi, page_size) : -1;

    // fp8: each warp converts the sub-tile it reads, no block barrier
    const uint32_t sub_addr =
        compute_stage<D, 1, kMmaThreads, KT, 16>(smem, it) + warp * 16 * C::kRow * 2;
    const int* fl = slot_tab + (it % C::kSlotTables) * kStageKeys + warp * 16;  // -1: no key
    float s[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[f][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sub_addr + (k_ld + ks * 16) * 2);
#pragma unroll
      for (int f = 0; f < NF; ++f) mma_bf16(s[f], a, qf[f][ks][0], qf[f][ks][1]);
    }
    // S^T fragment: s[f][j] is key gid, s[f][j + 2] key gid + 8, of head f*8 + tig*2 + j.
    const bool ok0 = fl[gid] >= 0;
    const bool ok1 = fl[gid + 8] >= 0;
    uint32_t ph[NF][2], pl[NF][2];  // P^T as the B operand: keys 0-7, keys 8-15
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x0 = ok0 ? s[f][j] * kLog2e : -INFINITY;
        const float x1 = ok1 ? s[f][j + 2] * kLog2e : -INFINITY;
        float mx = fmaxf(x0, x1);
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
        const float m_new = fmaxf(m[f][j], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key yet: all terms 0
        const float corr = exp2f(m[f][j] - m_use);
        p[j] = exp2f(x0 - m_use);
        p[j + 2] = exp2f(x1 - m_use);
        l[f][j] = l[f][j] * corr + p[j] + p[j + 2];
        m[f][j] = m_new;
#pragma unroll
        for (int mt = 0; mt < C::kSteps; ++mt) {
          acc[mt][f][j] *= corr;
          acc[mt][f][j + 2] *= corr;
        }
      }
      uint32_t hi01, lo01, hi23, lo23;
      split_bf16(p[0], p[1], hi01, lo01);  // key gid, heads tig*2, tig*2+1
      split_bf16(p[2], p[3], hi23, lo23);  // key gid + 8
      ph[f][0] = trans8x8(hi01);
      ph[f][1] = trans8x8(hi23);
      pl[f][0] = trans8x8(lo01);
      pl[f][1] = trans8x8(lo23);
    }
#pragma unroll
    for (int mt = 0; mt < C::kSteps; ++mt) {
      uint32_t a[4];
      ldsm_x4_trans(a, sub_addr + (v_ld + mt * 16) * 2);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        mma_bf16(acc[mt][f], a, ph[f][0], ph[f][1]);
        mma_bf16(acc[mt][f], a, pl[f][0], pl[f][1]);
      }
    }
    if (tid < kStageKeys)
      slot_tab[((it + C::kStages) % C::kSlotTables) * kStageKeys + tid] = fetched;
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: the warps' (o, m, l) go there

  float* sm_o = reinterpret_cast<float*>(smem);  // [warp][H heads][D]
  float* sm_m = sm_o + kMmaWarps * H * D;        // [warp][H heads]
  float* sm_l = sm_m + kMmaWarps * H;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float sum = l[f][j];
      sum += __shfl_xor_sync(kFull, sum, 4);
      sum += __shfl_xor_sync(kFull, sum, 8);
      sum += __shfl_xor_sync(kFull, sum, 16);
      if (gid == 0) {
        sm_m[warp * H + f * 8 + tig * 2 + j] = m[f][j];
        sm_l[warp * H + f * 8 + tig * 2 + j] = sum;
      }
    }
#pragma unroll
  for (int mt = 0; mt < C::kSteps; ++mt)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sm_o[(warp * H + f * 8 + tig * 2 + (c & 1)) * D + mt * 16 + gid + (c >> 1) * 8] =
            acc[mt][f][c];
  __syncthreads();

  for (int i = tid; i < H * (D / 8); i += kMmaThreads) {
    const int r = i / (D / 8);  // head
    const int d0 = (i % (D / 8)) * 8;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, sm_m[w * H + r]);
    float den = 0.f, o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      if (sm_m[w * H + r] == -INFINITY) continue;  // this warp saw no key
      const float c = exp2f(sm_m[w * H + r] - mx);
      den += sm_l[w * H + r] * c;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] += sm_o[(w * H + r) * D + d0 + e] * c;
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
    if (n_splits == 1) {
      uint4 v;
      v.x = bits(__floats2bfloat162_rn(o[0] * inv, o[1] * inv));
      v.y = bits(__floats2bfloat162_rn(o[2] * inv, o[3] * inv));
      v.z = bits(__floats2bfloat162_rn(o[4] * inv, o[5] * inv));
      v.w = bits(__floats2bfloat162_rn(o[6] * inv, o[7] * inv));
      *reinterpret_cast<uint4*>(out + ((size_t)b * H + r) * D + d0) = v;
    } else {
      const size_t pn = ((size_t)sp * batch + b) * H + r;  // (split, sequence, head)
      float4* po = reinterpret_cast<float4*>(part_o + pn * D + d0);
      po[0] = make_float4(o[0] * inv, o[1] * inv, o[2] * inv, o[3] * inv);
      po[1] = make_float4(o[4] * inv, o[5] * inv, o[6] * inv, o[7] * inv);
      if (d0 == 0) part_ml[pn] = make_float2(den > 0.f ? mx : -INFINITY, den);
    }
  }
}

// The merge of the KV splits, one thread per 4 elements of a sequence's
// [H, D]: every split of every row was written (m = -inf where it held no
// key), so all the partials are loaded at once; a row no split saw (kv_len
// 0) is exact zeros.
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
mla_decode_split_combine(const float* __restrict__ part_o, const float2* __restrict__ part_ml,
                         __nv_bfloat16* __restrict__ out, int batch, int num_heads,
                         int latent_dim, int n_splits) {
  const int b = blockIdx.x;
  const int c4 = latent_dim / 4;
  const int i = blockIdx.y * kMergeThreads + threadIdx.x;  // float4 chunk of the sequence
  if (i >= num_heads * c4) return;
  const size_t pn = (size_t)b * num_heads + i / c4;  // (sequence, head) of split 0
  const size_t stride = (size_t)batch * num_heads;   // between splits
  reinterpret_cast<uint2*>(out)[pn * c4 + i % c4] =
      to_bf16x4(merge_splits(part_o, part_ml, pn, stride, c4, i % c4, n_splits));
}

struct MmaArgs {
  const void* q;
  const void* pool;
  const int* page_tables;
  const int* kv_lens;
  void* out;
  float* scratch;
  int batch, page_size, max_pages;
  float scale;
  int n_splits, split_keys;
  cudaStream_t stream;
};

template <typename KT, int D, int H>
cudaError_t launch_mma(const MmaArgs& a) {
  using C = LatentCfg<D, KT>;
  const auto kernel = mla_decode_mma_kernel<D, H, KT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const size_t parts = (size_t)a.n_splits * a.batch * H;
  float* part_o = a.scratch;
  float2* part_ml = reinterpret_cast<float2*>(a.scratch + parts * D);
  kernel<<<dim3(a.n_splits, a.batch), kMmaThreads, C::kSmem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KT*>(a.pool),
      a.page_tables, a.kv_lens, static_cast<__nv_bfloat16*>(a.out), part_o, part_ml, a.batch,
      a.page_size, a.max_pages, a.scale, a.n_splits, a.split_keys);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  const dim3 merge_grid(a.batch, (H * D / 4 + kMergeThreads - 1) / kMergeThreads);
  mla_decode_split_combine<<<merge_grid, kMergeThreads, 0, a.stream>>>(
      part_o, part_ml, static_cast<__nv_bfloat16*>(a.out), a.batch, H, D, a.n_splits);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename KT>
cudaError_t dispatch_mma(int num_heads, int latent_dim, const MmaArgs& a) {
  // the splits cover the table; more than one: whole stages, and partials
  if (a.batch > 65535 || a.n_splits <= 0 || a.n_splits > kMaxSplits ||
      (long long)a.n_splits * a.split_keys < (long long)a.max_pages * a.page_size ||
      (a.n_splits > 1 && (a.scratch == nullptr || a.split_keys % kStageKeys != 0)) ||
      !aligned16(a.q) || !aligned16(a.pool) || !aligned16(a.out))
    return cudaErrorInvalidValue;
  if (num_heads == 16 && latent_dim == 160) return launch_mma<KT, 160, 16>(a);  // moe-wide-mla
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. kv_dtype (the pool): dtype's
// code, or 2 = float8_e4m3 beside either. instance: 0 = simt, 1 = mma (bf16 q; then
// n_splits KV splits of split_keys keys each, a multiple of 64 covering
// max_pages * page_size, and with n_splits > 1 scratch holds n_splits * batch
// * num_heads * (latent_dim + 2) floats). Returns the cudaError_t of the
// launches (cudaErrorInvalidValue for a shape without an instance).
extern "C" int llmd_mla_decode(const void* q, const void* pool, const int* page_tables,
                               const int* kv_lens, void* out, void* scratch, int batch,
                               int num_heads, int latent_dim, int page_size, int max_pages,
                               float scale, int dtype, int kv_dtype, int instance,
                               int n_splits, int split_keys, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == kMma) {
    if (dtype != 1) return cudaErrorInvalidValue;
    const MmaArgs a{q, pool, page_tables, kv_lens, out, static_cast<float*>(scratch), batch,
                    page_size, max_pages, scale, n_splits, split_keys, s};
    if (kv_dtype == 1) return dispatch_mma<__nv_bfloat16>(num_heads, latent_dim, a);
    if (kv_dtype == 2) return dispatch_mma<__nv_fp8_e4m3>(num_heads, latent_dim, a);
    return cudaErrorInvalidValue;
  }
  if (instance != kSimt) return cudaErrorInvalidValue;
  if (dtype == 0 && kv_dtype == 0)
    return dispatch_simt<float, float>(num_heads, latent_dim, q, pool, page_tables, kv_lens,
                                       out, batch, page_size, max_pages, scale, s);
  if (dtype == 1 && kv_dtype == 1)
    return dispatch_simt<__nv_bfloat16, __nv_bfloat16>(num_heads, latent_dim, q, pool,
                                                       page_tables, kv_lens, out, batch,
                                                       page_size, max_pages, scale, s);
  if (dtype == 0 && kv_dtype == 2)
    return dispatch_simt<float, __nv_fp8_e4m3>(num_heads, latent_dim, q, pool, page_tables,
                                               kv_lens, out, batch, page_size, max_pages,
                                               scale, s);
  if (dtype == 1 && kv_dtype == 2)
    return dispatch_simt<__nv_bfloat16, __nv_fp8_e4m3>(num_heads, latent_dim, q, pool,
                                                       page_tables, kv_lens, out, batch,
                                                       page_size, max_pages, scale, s);
  return cudaErrorInvalidValue;
}
