// Tensor-core attention building blocks for Hopper (sm_90a), shared by the
// bf16 `mma` instances of ragged paged attention (paged_attention.cu, K1) and
// of MLA latent decode (mla_decode.cu, K3).
//
// Both kernels stream a sequence's keys through a shared-memory ring of
// 64-key stages filled by 16-byte `cp.async` copies gathered through the page
// table, and multiply on `mma.sync.m16n8k16` (bf16 in, f32 accumulators) with
// the keys on M ("swap AB"): S^T = K.Q^T reads a stage with `ldmatrix`, and
// O^T += V^T.P^T reads V with `ldmatrix.trans`. On a single-plane (latent)
// pool K and V are the same row, so both products read the same stage.
// Splits of the keys write partial (m, l, o/l) rows in f32; `merge_splits`
// folds them back together.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace llmd_attn {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStageKeys = 64;  // keys per shared-memory stage: four 16-key sub-tiles
constexpr int kMaxSplits = 16;  // KV splits the merge holds in registers

// The stage ring of a pool whose key slot holds KV rows of width D read
// together (KV 2: a kv head's K row then its V row; KV 1: the latent row,
// which is both K and V), for a block of kThreads threads.
template <int D, int KV, int kThreads>
struct StageCfg {
  static constexpr int kRow = KV * D + 8;  // smem elements per key, padded by 16 bytes
  static constexpr int kVOff = (KV - 1) * D;  // V's column in a key's smem row
  static constexpr int kChunks = KV * D / 8;  // 16-byte copies per key
  static constexpr int kCopies = kStageKeys * kChunks;  // a stage's copies
  static constexpr int kSteps = D / 16;  // k16 steps of Q.K^T, m16 tiles of V^T
  static constexpr int kStages = 3;  // two stages in flight under the third's compute
  static constexpr int kStageElems = kStageKeys * kRow;
  static constexpr int kStageBytes = kStages * kStageElems * 2;
  // a stage's pool slots are fetched one iteration before its copies are
  // issued and read until it is computed: kStages + 1 tables
  static constexpr int kSlotTables = kStages + 1;
  static constexpr int kSmem = kStageBytes + kSlotTables * kStageKeys * 4;
  static_assert(D % 16 == 0, "width must be a multiple of 16");
  static_assert(kCopies % kThreads == 0, "a stage's copies spread evenly over the block");
  // a padded row is an odd number of 16-byte units: the 8 row addresses of
  // an ldmatrix land in 8 distinct bank groups
  static_assert((kRow * 2 / 16) % 2 == 1, "row stride must be an odd multiple of 16 bytes");
  // the epilogue's (o, m, l) of 4 warps x 16 rows reuse the stages
  static_assert(4 * 16 * (D + 2) * 4 <= kStageBytes, "epilogue does not fit");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with bytes == 0 the destination is zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a . b on the tensor cores: a 16x16 (row), b 16x8 (col), bf16; d f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of an 8x8 bf16 block held in fragment layout (thread
// 4*r + c holds row r, columns 2c and 2c+1).
__device__ __forceinline__ uint32_t trans8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as two bf16 pairs: hi = bf16(a, b) and lo = bf16 of what hi leaves
// out, so hi + lo holds a and b to ~16 significant bits. P rounded to bf16
// once is one rounding unit off the f32 plain version by itself; the two
// terms go through two mmas into the same f32 accumulator.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// The pool slot of a key (page * page_size + key % page_size), or -1 past
// k_end or on an unmapped page.
__device__ __forceinline__ int key_slot(const int* __restrict__ pt, int key, int k_end,
                                        int page_size) {
  if (key >= k_end) return -1;
  const int page = __ldg(pt + key / page_size);
  return page >= 0 ? page * page_size + key % page_size : -1;
}

// One 64-key stage: key j's KV*D elements of the pool (from row offset
// kv_off of slot slots[j]) into smem row j, zero-filled where the slot is -1.
// When kChunks divides the block (K/V rows), thread tid copies 16-byte column
// tid % kChunks of keys tid / kChunks + i * kThreads / kChunks: one column a
// thread, its address computed once. Otherwise (a latent row of width 160 is
// 20 copies) copy c = threadIdx.x + i * kThreads is column c % kChunks of key
// c / kChunks.
template <int D, int KV, int kThreads>
__device__ __forceinline__ void load_stage(__nv_bfloat16* st, const int* slots,
                                           const __nv_bfloat16* __restrict__ pool, size_t row,
                                           size_t kv_off) {
  using C = StageCfg<D, KV, kThreads>;
  if constexpr (kThreads % C::kChunks == 0) {
    const int chunk = threadIdx.x % C::kChunks;
    const uint32_t base = smem_u32(st) + chunk * 16;
#pragma unroll
    for (int i = 0; i < C::kCopies / kThreads; ++i) {
      const int j = threadIdx.x / C::kChunks + i * (kThreads / C::kChunks);
      const int slot = slots[j];
      const __nv_bfloat16* src =
          slot >= 0 ? pool + (size_t)slot * row + kv_off + chunk * 8 : pool;
      cp_async16(base + j * C::kRow * 2, src, slot >= 0 ? 16 : 0);
    }
  } else {
    const uint32_t base = smem_u32(st);
#pragma unroll
    for (int i = 0; i < C::kCopies / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int j = c / C::kChunks;
      const int chunk = c % C::kChunks;
      const int slot = slots[j];
      const __nv_bfloat16* src =
          slot >= 0 ? pool + (size_t)slot * row + kv_off + chunk * 8 : pool;
      cp_async16(base + (j * C::kRow + chunk * 8) * 2, src, slot >= 0 ? 16 : 0);
    }
  }
}

// The merge of KV splits for 4 consecutive elements of one (row, head):
// sum_s w_s o_s / sum_s w_s with w_s = l_s * 2^(m_s - max m). part_ml[s *
// stride + pn] is split s's (m, l) of that (row, head), part_o the matching
// o/l rows of c4 float4s; split s with m = -inf saw no key and is skipped,
// so (-inf) - (-inf) never occurs, and a (row, head) no split saw is zeros.
// Every split's partials are loaded at once, before any arithmetic.
__device__ __forceinline__ float4 merge_splits(const float* __restrict__ part_o,
                                               const float2* __restrict__ part_ml, size_t pn,
                                               size_t stride, int c4, int i, int n_splits) {
  float2 ml[kMaxSplits];
  float4 v[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < n_splits) {
      ml[s] = part_ml[s * stride + pn];
      v[s] = reinterpret_cast<const float4*>(part_o)[(s * stride + pn) * c4 + i];
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < n_splits) mx = fmaxf(mx, ml[s].x);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s >= n_splits || ml[s].x == -INFINITY) continue;
    const float w = ml[s].y * exp2f(ml[s].x - mx);
    den += w;
    acc.x += w * v[s].x;
    acc.y += w * v[s].y;
    acc.z += w * v[s].z;
    acc.w += w * v[s].w;
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  return make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

__device__ __forceinline__ uint2 to_bf16x4(float4 v) {
  return make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)),
                    bits(__floats2bfloat162_rn(v.z, v.w)));
}

}  // namespace llmd_attn
