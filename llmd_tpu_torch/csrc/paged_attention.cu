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
//   * Softmax runs online in f32 with sm_scale; q and out are f32 or bf16.
//     The pool is q's type, or float8_e4m3 at unit scales (the reference's
//     fp8 pool, `paged_attention_tpu`'s k_scale = v_scale = 1.0 branch,
//     :133-141; the engine's write_kv clamps to +-448 before the cast), which
//     every instance reads beside a q of either type.
//
// Bound on the card: a launch reads each attended key's K and V row once
// (sum_b kv_len_b * 2*Hk*D*sizeof(T) bytes at decode; 1*D for the latent pool)
// plus q, the page tables and out, and does 4*H*D flops per attended key. At
// decode that is 4*qpk*D flops per 4*D bytes of K/V, about qpk flop/byte, far
// below the ~295 flop/byte ridge of an H100 in bf16: the kernel is bound by
// device memory bandwidth, and a long prefill chunk only becomes compute-heavy
// if each K/V tile is reused across its query rows. An fp8 pool halves the
// K/V bytes against bf16 for the same flops.
//
// Two instances; the wrapper picks one (`ops/paged_attention._instance`) and
// passes it in.
//
// * mma (bfloat16: K/V pools at D in {32, 64, 128}, qpk in {1, 2, 4, 8}; the
//   single-plane latent pool at width 160 with 16 heads, all in one tile, qpk
//   = H; at width 80, tiny-mla's, the same template spills and simt serves
//   it). The
//   work item is (query tile, kv head g, KV split): a tile is up to TQ = 64/qpk
//   consecutive tokens of one sequence, and its rows are those tokens x the qpk
//   query heads of g, token-major (at most 64 rows), so each K/V row read from
//   memory serves every query row of the tile (a 512-token chunk reads its KV
//   512/TQ times, not 512 times). The grid is sized on the host from N, B and
//   max_pages alone: Hk x (ceil(N/TQ) + B tile slots) x splits, the kv heads
//   fastest (a K/V row of the pool holds every head's K and V: the heads of
//   a tile read the same DRAM pages at the same time); sequence b's
//   tiles sit at slots b + cu_q_lens[b]/TQ onwards, so each block finds its
//   sequence and first token from cu_q_lens on the device (one warp-wide
//   search) and a slot between two sequences' tiles exits.
//   - K/V through shared memory: 64-key stages (the key's K row then its V
//     row, 2*D contiguous elements of the pool, padded by 16 bytes so that
//     ldmatrix reads no two rows from one bank group; on one plane the
//     latent row alone, D elements + 16 bytes, brought on chip once and read
//     as K by ldmatrix and as V by ldmatrix.trans) in a ring of 3 stages
//     filled with `cp.async` 16-byte copies, so the copies of the next two
//     stages run while the current one is computed (3 stages, not 4: at D 64
//     four 53 KB blocks share an SM, and decode B=64's grid runs in one wave). The keys' pool slots come from
//     the page table one stage ahead into a small shared-memory ring, so a
//     stage's copies never wait on a page-table load. Keys past the item's
//     range or on an unmapped page are zero-filled, never read.
//   - Tensor cores: S^T = K . Q^T and O^T += V^T . P^T on `mma.sync.m16n8k16`
//     (bf16 in, f32 accumulators) with the keys on M and the tile's query rows
//     on N ("swap AB"): a decode tile of qpk <= 8 rows fills one n8 fragment
//     instead of a padded m16. Operands come from shared memory through
//     `ldmatrix` (`.trans` for V); q sits in registers for the whole item. The
//     scale multiplies the f32 scores (q is bf16, the products are exact).
//     On the latent pool a tile is 4 tokens x 16 heads (64 rows), so a
//     128-token chunk reads its latent 32 times, not once per token and head
//     group as the simt instance does.
//     `mma.sync` and not `wgmma`: the instance is bound by memory, not by the
//     tensor cores; wgmma's 64-row M and warpgroup-wide operands would pad a
//     decode tile 8x and need a key layout TMA could only gather page by page,
//     while mma.sync only has to take the scalar FMA chain off the CUDA cores.
//   - P is not rounded to bf16 once (that alone is one rounding unit off the
//     f32 plain version): P = P_hi + P_lo with P_hi = bf16(P) and P_lo =
//     bf16(P - P_hi), two mmas into the same f32 accumulator. The score
//     fragment (keys on M) is turned into the B operand of P^T (keys on K)
//     with `movmatrix.trans`, one per 8x8 block.
//   - Warps: up to 8 fragments of 8 rows, two per warp; when the tile has
//     fewer rows (a decode tile has one fragment), the warps of a row group
//     split each stage's 16-key sub-tiles among them and merge their (m, l,
//     o) in shared memory at the end.
//   - Split-KV: the host splits the keys into chunks of a whole number of
//     stages and pages when tiles x Hk alone would not fill the card (decode
//     at small batch, long contexts). Each item then writes its partial (m,
//     l, o/l) in f32 to a scratch buffer allocated by the wrapper, and a
//     second kernel launched from the same entry point merges the splits and
//     writes every row (padding zeros included). An item past its tile's
//     causal limit only marks its rows' partials empty (m = -inf) and exits,
//     so the merge loads every split's partials at once, with no search for
//     the row's sequence; it skips the empty ones, so (-inf) - (-inf) never
//     occurs. At most 16 splits (the merge keeps them in registers).
//   - fp8 pool (the same instance with KT = __nv_fp8_e4m3): the ring holds
//     raw e4m3 stages (a 16-byte copy carries 16 elements of a row instead of
//     8), and once a stage lands the block converts it into one bf16 compute
//     stage of the layout above (`compute_stage`, one more barrier a stage);
//     scores, softmax, the P split and the merge are the bf16 instance's, so
//     it returns the bf16 instance's result on the pool upcast to bf16, bit
//     for bit, under the same plan. A later design converts in registers.
//   The ring, the copies, the conversion, the fragments' helpers and the
//   merge live in mma_attention.cuh, shared with mla_decode.cu's mma
//   instance.
// * simt (float32, and bf16 latent pools at width 80): one block per (query
//   token n, head group g), 4 warps. A GQA block serves the qpk = H/Hk query
//   heads of kv head g, so every K/V row it reads is used qpk times. A
//   single-plane block serves QPK of the H heads (8 at D 160, 4 at D 80: QPK x
//   D floats of accumulator per lane stay in registers and the static shared
//   arrays under 48 KB); the H/QPK blocks of a token read the same latent
//   rows, the later ones mostly from L2. Warps take 32-key tiles in turn. In a
//   tile, lane j scores key j against all qpk heads (its K row read with
//   16-byte loads; q pre-scaled in shared memory, read by broadcast). One warp
//   max per head updates the running max; each lane keeps a partial softmax
//   denominator. For P.V, the tile's probabilities are broadcast key by key
//   and lane j accumulates output dims j, j+32, ... (ceil(D/32) of them, the
//   last ones masked when 32 does not divide D), reading each V row as one
//   coalesced warp load. Each warp's (m, l, acc) meet in shared memory at the
//   end; o = acc / l. float32 stays off the tensor cores, which would take it
//   in TF32. An fp8 pool (KT = __nv_fp8_e4m3) is read the same way, 16
//   elements a 16-byte load, each converted to f32 as it is used.

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
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // keys per warp tile: one per lane

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

// ---------------------------------------------------------------------------
// simt instance
// ---------------------------------------------------------------------------

// s[h] = dot(q_s[h], k_row) for the qpk heads; k_row (pool type KT) read as
// 16-byte vectors.
template <typename KT, int D, int QPK>
__device__ __forceinline__ void qk_dot(const KT* __restrict__ k_row,
                                       const float* __restrict__ q_s,
                                       float (&s)[QPK]) {
  constexpr int kPer = 16 / sizeof(KT);
  static_assert(D % kPer == 0, "head dim must fill whole 16-byte vectors");
  const uint4* vec = reinterpret_cast<const uint4*>(k_row);
#pragma unroll
  for (int h = 0; h < QPK; ++h) s[h] = 0.f;
#pragma unroll
  for (int i = 0; i < D / kPer; ++i) {
    const uint4 u = __ldg(vec + i);
    float kf[kPer];
    if constexpr (sizeof(KT) == 1) {  // e4m3: unpacked by shifts, u stays in registers
      e4m3x16_to_float(u, kf);
    } else {
      const KT* e = reinterpret_cast<const KT*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) kf[j] = to_float(e[j]);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
#pragma unroll
      for (int h = 0; h < QPK; ++h) s[h] = fmaf(q_s[h * D + i * kPer + j], kf[j], s[h]);
    }
  }
}

template <typename T, typename KT, int D, int QPK>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const KT* __restrict__ pool,
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
      qk_dot<KT, D, QPK>(pool + (size_t)slot * row + k_off, q_s, s);
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
      const KT* v_row = pool + (size_t)sj * row + v_off;
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

// ---------------------------------------------------------------------------
// mma instance
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;  // query rows of a work item: TQ tokens x qpk heads

template <int D, int KV, typename KT>
using MmaCfg = StageCfg<D, KV, kThreads, KT>;

// The last b in [0, count) for which pred(b, v[b]) holds, where pred holds on
// a prefix of [0, count) that includes 0. One warp-wide round trip per 128
// entries instead of a chain of dependent loads; every lane must take part.
template <typename Pred>
__device__ __forceinline__ int last_true(const int* __restrict__ v, int count, Pred pred) {
  const int lane = threadIdx.x & 31;
  int found = 0;
  for (int base = 0; base < count; base += 4 * 32) {
    int x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = base + i * 32 + lane;
      x[i] = b < count ? __ldg(v + b) : 0;
    }
    unsigned all = kFull;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = base + i * 32 + lane;
      const unsigned hit = __ballot_sync(kFull, b < count && pred(b, x[i]));
      if (hit) found = base + i * 32 + 31 - __clz(hit);
      all &= hit;
    }
    if (all != kFull) break;
  }
  return found;
}

template <int D, int QPK, int KV, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const KT* __restrict__ pool,
                           const int* __restrict__ page_tables, const int* __restrict__ kv_lens,
                           const int* __restrict__ cu_q_lens, const int* __restrict__ num_seqs_ptr,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
                           float2* __restrict__ part_ml, int num_tokens, int num_heads,
                           int num_planes, int page_size, int max_pages, float scale_log2,
                           int n_slots, int n_splits, int split_keys) {
  using C = MmaCfg<D, KV, KT>;
  constexpr int TQ = kMmaRows / QPK;  // tokens of a query tile
  extern __shared__ __align__(16) unsigned char smem[];  // ring (+ compute stage), slot tables
  int* slot_tab = reinterpret_cast<int*>(smem + C::kStageBytes);  // [kSlotTables][64]

  const int g = blockIdx.x;  // kv head: a tile's heads run side by side (0 on one plane)
  const int slot = blockIdx.y;
  const int sp = blockIdx.z;  // KV split
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const size_t grp = (size_t)g * QPK * D;  // head g*qpk's offset in a token's [H, D]
  const size_t tok_stride = (size_t)num_heads * D;

  const int ns = __ldg(num_seqs_ptr);
  const int total = ns > 0 ? __ldg(cu_q_lens + ns) : 0;
  if (n_splits == 1) {  // padding rows are zeros (with splits the merge writes them)
    for (int n = total + slot; n < num_tokens; n += n_slots)
      for (int i = tid * 8; i < QPK * D; i += kThreads * 8)
        *reinterpret_cast<uint4*>(out + n * tok_stride + grp + i) = make_uint4(0, 0, 0, 0);
  }
  if (ns <= 0) return;

  // The sequence whose tiles hold this slot: the last b with b + cu[b]/TQ <= slot.
  const int b = last_true(cu_q_lens, ns, [slot](int i, int c) { return i + c / TQ <= slot; });
  const int q_start = __ldg(cu_q_lens + b);
  const int q_len = __ldg(cu_q_lens + b + 1) - q_start;
  const int kv_len = __ldg(kv_lens + b);
  const int t0 = (slot - b - q_start / TQ) * TQ;  // the tile's first token in the sequence
  if (t0 >= q_len) return;                        // a slot between two sequences' tiles
  const int ntok = min(TQ, q_len - t0);
  const int max_keys = max_pages * page_size;
  const int lim0 = kv_len - q_len + t0 + 1;  // token t of the tile attends keys < lim0 + t
  const int tile_lim = min(lim0 + ntok - 1, max_keys);
  const int k_lo = sp * split_keys;
  const int k_hi = min(k_lo + split_keys, tile_lim);
  if (n_splits > 1 && k_lo >= k_hi) {  // no key of this split: its partials say so
    for (int r = tid; r < ntok * QPK; r += kThreads)
      part_ml[((size_t)sp * num_tokens + q_start + t0 + r / QPK) * num_heads + g * QPK +
              r % QPK] = make_float2(-INFINITY, 0.f);
    return;
  }

  // Rows: 8-row fragments, two per warp. Fewer than 8 fragments: the warps of
  // a 16-row group split each stage's sub-tiles (kg of wk).
  const int rows = ntok * QPK;
  const int nf = (rows + 7) / 8;
  const int n_rg = (nf + 1) / 2;
  const int wk = n_rg == 1 ? 4 : (n_rg == 2 ? 2 : 1);
  const int rg = warp / wk;
  const int kg = warp % wk;
  const bool active = rg < n_rg;
  bool live[2];
  uint32_t qf[2][C::kSteps][2];  // Q^T as the B operand, one row (n = gid) per lane
  int lim[2][2];                 // causal limit of rows tig*2 + j (C fragment columns)
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    live[f] = active && rg * 2 + f < nf;
    const int r = rg * 16 + f * 8 + gid;
    const int t = r / QPK;
    const bool ok = live[f] && t < ntok;
    const __nv_bfloat16* qr = q + (size_t)(q_start + t0 + t) * tok_stride + grp + (r % QPK) * D;
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) {
      qf[f][ks][0] = ok ? __ldg(reinterpret_cast<const unsigned*>(qr + ks * 16 + tig * 2)) : 0u;
      qf[f][ks][1] =
          ok ? __ldg(reinterpret_cast<const unsigned*>(qr + ks * 16 + 8 + tig * 2)) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tt = (rg * 16 + f * 8 + tig * 2 + j) / QPK;
      lim[f][j] = live[f] && tt < ntok ? min(lim0 + tt, max_keys) : 0;
    }
  }

  float acc[C::kSteps][2][4];  // O^T: d on M (m16 tile mt), rows on N
  float m[2][2], l[2][2];      // running max (log2 domain) and lane-partial sum per row
#pragma unroll
  for (int f = 0; f < 2; ++f) {
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
  const size_t row = (size_t)num_planes * D;
  const size_t kv_off = KV == 2 ? (size_t)(2 * g) * D : 0;  // one plane: the latent row
  const int n_st = k_hi > k_lo ? (k_hi - k_lo + kStageKeys - 1) / kStageKeys : 0;
  // slot tables of the first kStages stages, one round trip to the page table
  for (int i = tid; i < C::kStages * kStageKeys; i += kThreads)
    slot_tab[i] = key_slot(pt, k_lo + i, k_hi, page_size);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_st)
      load_stage<D, KV, kThreads>(smem + s * C::kRingStage, slot_tab + s * kStageKeys, pool,
                                  row, kv_off);
    cp_async_commit();
  }

  // ldmatrix row addresses (elements into a 16-key sub-tile). K, A of S^T:
  // matrices (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7, d 8-15), (keys
  // 8-15, d 8-15). V^T (transposed on load), A of O^T: (d 0-7, keys 0-7),
  // (d 8-15, keys 0-7), (d 0-7, keys 8-15), (d 8-15, keys 8-15). On one
  // plane V is K: both read the same smem row.
  const int mi = lane >> 3, mr = lane & 7;
  const int k_ld = (mr + (mi & 1) * 8) * C::kRow + (mi >> 1) * 8;
  const int v_ld = (mr + (mi >> 1) * 8) * C::kRow + C::kVOff + (mi & 1) * 8;

  for (int it = 0; it < n_st; ++it) {
    cp_async_wait<C::kStages - 2>();  // stage it has landed (this thread's copies) ...
    __syncthreads();                  // ... everyone's, and stage it-1 is consumed
    {
      const int s = it + C::kStages - 1;
      if (s < n_st)
        load_stage<D, KV, kThreads>(smem + (s % C::kStages) * C::kRingStage,
                                    slot_tab + (s % C::kSlotTables) * kStageKeys, pool, row,
                                    kv_off);
      cp_async_commit();
    }
    // the slot of key tid of stage it + kStages: stored after this stage's
    // compute, so the page-table load lands under it
    const int next_key = k_lo + (it + C::kStages) * kStageKeys + tid;
    const int fetched = tid < kStageKeys ? key_slot(pt, next_key, k_hi, page_size) : -1;
    const uint32_t st = compute_stage<D, KV, kThreads, KT>(smem, it);  // fp8: converted here
    if (active) {
      const int* fl = slot_tab + (it % C::kSlotTables) * kStageKeys;  // -1: zero-filled key
      for (int sub = kg; sub < kStageKeys / 16; sub += wk) {
        const uint32_t sub_addr = st + sub * 16 * C::kRow * 2;
        float s[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[f][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < C::kSteps; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, sub_addr + (k_ld + ks * 16) * 2);
#pragma unroll
          for (int f = 0; f < 2; ++f)
            if (live[f]) mma_bf16(s[f], a, qf[f][ks][0], qf[f][ks][1]);
        }
        // S^T fragment: s[f][j] is key gid, s[f][j + 2] key gid + 8, of row tig*2 + j.
        const int key = k_lo + it * kStageKeys + sub * 16 + gid;
        const bool ok0 = fl[sub * 16 + gid] >= 0;
        const bool ok1 = fl[sub * 16 + gid + 8] >= 0;
        uint32_t ph[2][2], pl[2][2];  // P^T as the B operand: keys 0-7, keys 8-15
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if (!live[f]) continue;
          float p[4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x0 = ok0 && key < lim[f][j] ? s[f][j] * scale_log2 : -INFINITY;
            const float x1 = ok1 && key + 8 < lim[f][j] ? s[f][j + 2] * scale_log2 : -INFINITY;
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
          split_bf16(p[0], p[1], hi01, lo01);  // key gid, rows tig*2, tig*2+1
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
          for (int f = 0; f < 2; ++f) {
            if (!live[f]) continue;
            mma_bf16(acc[mt][f], a, ph[f][0], ph[f][1]);
            mma_bf16(acc[mt][f], a, pl[f][0], pl[f][1]);
          }
        }
      }
    }
    if (tid < kStageKeys)
      slot_tab[((it + C::kStages) % C::kSlotTables) * kStageKeys + tid] = fetched;
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: the warps' (o, m, l) go there

  float* sm_o = reinterpret_cast<float*>(smem);  // [warp][16 rows][D]
  float* sm_m = sm_o + 4 * 16 * D;               // [warp][16 rows]
  float* sm_l = sm_m + 4 * 16;
  if (active) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float sum = l[f][j];
        sum += __shfl_xor_sync(kFull, sum, 4);
        sum += __shfl_xor_sync(kFull, sum, 8);
        sum += __shfl_xor_sync(kFull, sum, 16);
        if (gid == 0) {
          sm_m[warp * 16 + f * 8 + tig * 2 + j] = m[f][j];
          sm_l[warp * 16 + f * 8 + tig * 2 + j] = sum;
        }
      }
#pragma unroll
    for (int mt = 0; mt < C::kSteps; ++mt)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sm_o[(warp * 16 + f * 8 + tig * 2 + (c & 1)) * D + mt * 16 + gid + (c >> 1) * 8] =
              acc[mt][f][c];
  }
  __syncthreads();

  for (int i = tid; i < rows * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int d0 = (i % (D / 8)) * 8;
    const int w0 = (r >> 4) * wk;  // first warp of the row's group
    const int lr = r & 15;
    float mx = -INFINITY;
    for (int k = 0; k < wk; ++k) mx = fmaxf(mx, sm_m[(w0 + k) * 16 + lr]);
    float den = 0.f, o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = 0.f;
    if (mx != -INFINITY) {
      for (int k = 0; k < wk; ++k) {
        const int w = (w0 + k) * 16 + lr;
        if (sm_m[w] == -INFINITY) continue;  // this warp saw no key of the row
        const float c = exp2f(sm_m[w] - mx);
        den += sm_l[w] * c;
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] += sm_o[w * D + d0 + e] * c;
      }
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
    const size_t n = (size_t)(q_start + t0 + r / QPK);
    const size_t off = grp + (r % QPK) * D + d0;
    if (n_splits == 1) {
      uint4 v;
      v.x = bits(__floats2bfloat162_rn(o[0] * inv, o[1] * inv));
      v.y = bits(__floats2bfloat162_rn(o[2] * inv, o[3] * inv));
      v.z = bits(__floats2bfloat162_rn(o[4] * inv, o[5] * inv));
      v.w = bits(__floats2bfloat162_rn(o[6] * inv, o[7] * inv));
      *reinterpret_cast<uint4*>(out + n * tok_stride + off) = v;
    } else {
      const size_t pn = (size_t)sp * num_tokens + n;  // partials of token n in split sp
      float4* po = reinterpret_cast<float4*>(part_o + pn * tok_stride + off);
      po[0] = make_float4(o[0] * inv, o[1] * inv, o[2] * inv, o[3] * inv);
      po[1] = make_float4(o[4] * inv, o[5] * inv, o[6] * inv, o[7] * inv);
      if (d0 == 0)
        part_ml[pn * num_heads + g * QPK + r % QPK] =
            make_float2(den > 0.f ? mx : -INFINITY, den);
    }
  }
}

// The merge of the KV splits: out = sum_s w_s o_s / sum_s w_s with w_s =
// l_s * 2^(m_s - max m), one thread per 4 elements of a token's [H, D]. Every
// split of every valid row was written (m = -inf: no key there, skipped), so
// all the partials are loaded at once, with no search for the row's
// sequence. Padding rows (never written) and rows with no key are zeros.
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
paged_attention_split_combine(const float* __restrict__ part_o,
                              const float2* __restrict__ part_ml,
                              __nv_bfloat16* __restrict__ out,
                              const int* __restrict__ cu_q_lens,
                              const int* __restrict__ num_seqs_ptr, int num_tokens,
                              int num_heads, int head_dim, int n_splits) {
  const int n = blockIdx.x;
  const int c4 = head_dim / 4;
  const int i = blockIdx.y * kMergeThreads + threadIdx.x;  // float4 chunk of the token
  if (i >= num_heads * c4) return;
  const size_t pn = (size_t)n * num_heads + i / c4;     // (token, head) of split 0
  const size_t stride = (size_t)num_tokens * num_heads;  // between splits
  const float4 v = merge_splits(part_o, part_ml, pn, stride, c4, i % c4, n_splits);
  const int ns = __ldg(num_seqs_ptr);
  const bool pad = ns <= 0 || n >= __ldg(cu_q_lens + ns);
  const uint2 o = pad ? make_uint2(0u, 0u) : to_bf16x4(v);
  reinterpret_cast<uint2*>(out)[pn * c4 + i % c4] = o;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* pool;
  const int* page_tables;
  const int* kv_lens;
  const int* cu_q_lens;
  const int* num_seqs;
  void* out;
  float* scratch;
  int num_tokens, num_heads, num_planes, page_size, max_pages;
  float scale;
  int n_slots, n_splits, split_keys;
  cudaStream_t stream;
};

template <typename T, typename KT, int D, int QPK>
cudaError_t launch_simt(const Args& a) {
  const dim3 grid(a.num_tokens, a.num_heads / QPK);
  paged_attention_kernel<T, KT, D, QPK><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.pool), a.page_tables, a.kv_lens,
      a.cu_q_lens, a.num_seqs, static_cast<T*>(a.out), a.num_heads, a.num_planes,
      a.page_size, a.max_pages, a.scale);
  return cudaGetLastError();
}

template <typename T, typename KT, int D>
cudaError_t dispatch_simt_qpk(int qpk, const Args& a) {
  switch (qpk) {
    case 1: return launch_simt<T, KT, D, 1>(a);
    case 2: return launch_simt<T, KT, D, 2>(a);
    case 4: return launch_simt<T, KT, D, 4>(a);
    case 8: return launch_simt<T, KT, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KT>
cudaError_t dispatch_simt(int qpk, int head_dim, const Args& a) {
  if (a.num_planes == 1) {  // single-plane latent pool: (width, heads per block)
    if (head_dim == 160 && qpk == 8) return launch_simt<T, KT, 160, 8>(a);
    if (head_dim == 80 && qpk == 4) return launch_simt<T, KT, 80, 4>(a);
    return cudaErrorInvalidValue;
  }
  switch (head_dim) {
    case 32: return dispatch_simt_qpk<T, KT, 32>(qpk, a);
    case 64: return dispatch_simt_qpk<T, KT, 64>(qpk, a);
    case 128: return dispatch_simt_qpk<T, KT, 128>(qpk, a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KT, int D, int QPK, int KV = 2>
cudaError_t launch_mma(const Args& a) {
  using C = MmaCfg<D, KV, KT>;
  const auto kernel = paged_attention_mma_kernel<D, QPK, KV, KT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const size_t parts = (size_t)a.n_splits * a.num_tokens * a.num_heads;
  float* part_o = a.scratch;
  float2* part_ml = reinterpret_cast<float2*>(a.scratch + parts * D);
  const dim3 grid(a.num_heads / QPK, a.n_slots, a.n_splits);
  kernel<<<grid, kThreads, C::kSmem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KT*>(a.pool),
      a.page_tables, a.kv_lens, a.cu_q_lens, a.num_seqs, static_cast<__nv_bfloat16*>(a.out),
      part_o, part_ml, a.num_tokens, a.num_heads, a.num_planes, a.page_size, a.max_pages,
      a.scale * kLog2e, a.n_slots, a.n_splits, a.split_keys);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  const dim3 merge_grid(a.num_tokens, (a.num_heads * D / 4 + kMergeThreads - 1) / kMergeThreads);
  paged_attention_split_combine<<<merge_grid, kMergeThreads, 0, a.stream>>>(
      part_o, part_ml, static_cast<__nv_bfloat16*>(a.out), a.cu_q_lens, a.num_seqs,
      a.num_tokens, a.num_heads, D, a.n_splits);
  return cudaGetLastError();
}

template <typename KT, int D>
cudaError_t dispatch_mma_qpk(int qpk, const Args& a) {
  switch (qpk) {
    case 1: return launch_mma<KT, D, 1>(a);
    case 2: return launch_mma<KT, D, 2>(a);
    case 4: return launch_mma<KT, D, 4>(a);
    case 8: return launch_mma<KT, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename KT>
cudaError_t dispatch_mma(int qpk, int head_dim, int tq, const Args& a) {
  // the splits cover every key; more than one: whole stages, and partials
  if (tq * qpk != kMmaRows || a.n_slots <= 0 || a.n_slots > 65535 ||
      a.n_splits <= 0 || a.n_splits > kMaxSplits ||
      (long long)a.n_splits * a.split_keys < (long long)a.max_pages * a.page_size ||
      (a.n_splits > 1 && (a.scratch == nullptr || a.split_keys % kStageKeys != 0)) ||
      !aligned16(a.q) || !aligned16(a.pool) || !aligned16(a.out))
    return cudaErrorInvalidValue;
  if (a.num_planes == 1)  // latent pool: all 16 heads of moe-wide-mla's plane in a tile
    return head_dim == 160 && qpk == 16 ? launch_mma<KT, 160, 16, 1>(a) : cudaErrorInvalidValue;
  switch (head_dim) {
    case 32: return dispatch_mma_qpk<KT, 32>(qpk, a);
    case 64: return dispatch_mma_qpk<KT, 64>(qpk, a);
    case 128: return dispatch_mma_qpk<KT, 128>(qpk, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// num_planes: 2*Hk for a K/V pool, 1 for the single-plane latent pool.
// heads_per_block: H/Hk for a K/V pool; for a latent pool, the query heads one
// block serves (simt: 8 at width 160, 4 at width 80; mma: all 16 at width
// 160). dtype (q and out): 0 = float32, 1 = bfloat16. kv_dtype (the pool):
// dtype's code, or 2 = float8_e4m3 beside either. instance: 0 = simt,
// 1 = mma (bf16 q; then tq = 64 / heads_per_block tokens per query tile,
// n_slots tile slots, n_splits KV
// splits of split_keys keys each, a multiple of 64, and with n_splits > 1
// scratch holds n_splits * num_tokens * num_heads * (head_dim + 2) floats).
// Returns the cudaError_t of the launches (cudaErrorInvalidValue for a shape
// without an instance).
extern "C" int llmd_paged_attention(const void* q, const void* pool, const int* page_tables,
                                    const int* kv_lens, const int* cu_q_lens,
                                    const int* num_seqs, void* out, void* scratch,
                                    int num_tokens, int num_heads, int num_planes,
                                    int heads_per_block, int head_dim, int page_size,
                                    int max_pages, float scale, int dtype, int kv_dtype,
                                    int instance,
                                    int tq, int n_slots, int n_splits, int split_keys,
                                    void* stream) {
  if (num_tokens <= 0) return 0;
  if (heads_per_block <= 0 || num_heads % heads_per_block != 0) return cudaErrorInvalidValue;
  if (num_planes != 1 && (num_planes % 2 != 0 || num_planes / 2 * heads_per_block != num_heads))
    return cudaErrorInvalidValue;
  const Args a{q, pool, page_tables, kv_lens, cu_q_lens, num_seqs, out,
               static_cast<float*>(scratch), num_tokens, num_heads, num_planes, page_size,
               max_pages, scale, n_slots, n_splits, split_keys,
               static_cast<cudaStream_t>(stream)};
  if (instance == kMma) {
    if (dtype != 1) return cudaErrorInvalidValue;
    if (kv_dtype == 1) return dispatch_mma<__nv_bfloat16>(heads_per_block, head_dim, tq, a);
    if (kv_dtype == 2) return dispatch_mma<__nv_fp8_e4m3>(heads_per_block, head_dim, tq, a);
    return cudaErrorInvalidValue;
  }
  if (instance != kSimt) return cudaErrorInvalidValue;
  if (dtype == 0 && kv_dtype == 0) return dispatch_simt<float, float>(heads_per_block, head_dim, a);
  if (dtype == 1 && kv_dtype == 1)
    return dispatch_simt<__nv_bfloat16, __nv_bfloat16>(heads_per_block, head_dim, a);
  if (dtype == 0 && kv_dtype == 2)
    return dispatch_simt<float, __nv_fp8_e4m3>(heads_per_block, head_dim, a);
  if (dtype == 1 && kv_dtype == 2)
    return dispatch_simt<__nv_bfloat16, __nv_fp8_e4m3>(heads_per_block, head_dim, a);
  return cudaErrorInvalidValue;
}
