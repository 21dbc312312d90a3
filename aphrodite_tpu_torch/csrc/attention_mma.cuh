// Building blocks shared by the two attention kernels
// (ragged_paged_attention.cuh, paged_decode_attention.cuh): the bf16
// tensor-core product mma.sync.m16n8k16 (f32 sums), ldmatrix, cp.async, the
// staging of one 64-key K/V tile from the paged cache into shared memory,
// and the online softmax of one warp's 16 query rows.
//
// Why mma.sync and not wgmma: a warp owns 16 query rows and runs its own
// softmax between the two products, with P handed from the S accumulator to
// the A fragments of the P.V product in registers. wgmma (64 rows a
// warpgroup, B from shared memory in its own swizzled layout) reaches the
// card's full bf16 rate, but ragged tiles are small (a decode token of a
// mixed step fills QG rows of a tile) and at these shapes the kernels are
// far from that rate; mma.sync runs at about half of it and keeps the row
// map and masks of the earlier kernels. wgmma with TMA loads is the next
// step (ROADMAP).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
//   A (16 x 16, row major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 =
//     (g, 8+2t..), a3 = (g+8, 8+2t..), two bf16 a register.
//   B (16 x 8, "col"): b0 = (k 2t..2t+1, n g), b1 = (k 8+2t.., n g).
//   C (16 x 8, f32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// So the C fragments of two adjacent 8-key blocks of S are, packed to bf16,
// the A fragment of P for those 16 keys.
//
// Shared-memory tiles hold bf16 rows of D values at a stride of D + 8 (an
// odd number of 16-byte units: 9 at head_dim 64, 11 at 80, 13 at 96, 17 at
// 128, 21 at 160, 33 at 256, 49 at 384), so the eight row addresses of
// each ldmatrix are 16-byte aligned and fall on distinct banks. Every loop over D takes
// one k16 step (16 dimensions) at a time, so D 80's five steps and D 160's
// ten need nothing of their own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_page_types.cuh"

namespace attn {

constexpr int kTileKeys = 64;  // keys per K/V tile: four 16-key pages

// bf16 row stride of a shared-memory tile.
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;
  static constexpr size_t kBytes = size_t(kTileKeys) * kStride * 2;  // K or V
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b (16 x 16 bf16 by 16 x 8 bf16, f32 sums).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously; with bytes == 0
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bytes of one 64-key K/V tile as it sits in a stage: bf16 pages go
// straight into the padded bf16 tiles (K then V); narrow pages into a byte
// stage of 64 rows of K then V, 2 * D bytes a key, widened afterwards.
template <class Page, int D>
struct Stage {
  static constexpr bool kNarrow = Page::kValues == 16;
  static constexpr size_t kBytes = kNarrow ? size_t(kTileKeys) * 2 * D : 2 * Tile<D>::kBytes;
};

// Copies of a tile a thread issues (or widens) up to which the loop is
// unrolled whole; past it, in steps of 8. Only the decode kernel's
// 128-thread form on bf16 pages at head_dim 160 (20 copies a thread) and
// 256 (32) passes it: unrolled whole at 256, the 32 copies' addresses stay
// live beside O's 128 registers and spill.
constexpr int kUnrollCopies = 16;

// The 16-byte copies of one tile (K and V rows of kChunks each), and how
// many a thread of kThreads takes: whole where the block's threads divide
// them; else the last round is taken by the first threads only. That is
// narrow pages at head_dim 80 (640 copies) in the 256-thread forms (the
// ragged kernel, the decode kernel's wide form): threads 0-127 take a
// third copy. 640 is a multiple of 32, so the round ends on a warp's edge
// and no warp splits (the page-index shuffles stay whole-warp). At head_dim
// 160 a tile is 2560 copies (bf16) or 1280 (narrow), whole at 128 and at
// 256 threads.
template <int kChunks, int kThreads>
struct TileCopies {
  static constexpr int kTotal = kTileKeys * 2 * kChunks;
  static constexpr bool kWhole = kTotal % kThreads == 0;
  static constexpr int kPerThread = (kTotal + kThreads - 1) / kThreads;
  static_assert(kTotal % 32 == 0, "the last round ends on a warp's edge");
};

// Issues the cp.async copies of keys [tile0, tile0 + 64) of kv head kvh into
// `stage`, zero-filling every key outside [lo, hi): nothing outside is read.
// Each warp reads the page index of each page the tile touches once (lane i
// holds the tile's pages i and 32 + i) and hands it to the lanes that copy
// its rows.
template <class Page, int D, int kThreads>
__device__ __forceinline__ void issue_tile(unsigned char* stage, const unsigned char* kv,
                                           const int* pages, int page_size, int ckv, int kvh,
                                           int tile0, int lo, int hi) {
  constexpr int kVals = Page::kValues;
  constexpr int kChunks = D / kVals;  // 16-byte loads per K (or V) row
  using Copies = TileCopies<kChunks, kThreads>;
  const int lane = threadIdx.x % 32;
  const int p0 = tile0 / page_size;
  int pid_lo = 0;
  int pid_hi = 0;
  if ((p0 + lane) * page_size < hi) pid_lo = __ldg(pages + p0 + lane);
  if ((p0 + 32 + lane) * page_size < hi) pid_hi = __ldg(pages + p0 + 32 + lane);
  constexpr int kCopies = Copies::kPerThread;
#pragma unroll(kCopies > kUnrollCopies ? 8 : kCopies)
  for (int i = 0; i < kCopies; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if constexpr (!Copies::kWhole) {
      if (c >= Copies::kTotal) break;
    }
    const int key = c / (2 * kChunks);
    const int rem = c % (2 * kChunks);
    const int is_v = rem / kChunks;
    const int part = rem % kChunks;
    const int pos = tile0 + key;
    const int rel = pos / page_size - p0;
    const int a = __shfl_sync(0xffffffffu, pid_lo, rel & 31);
    const int b = __shfl_sync(0xffffffffu, pid_hi, rel & 31);
    const int page = rel < 32 ? a : b;
    const bool load = pos >= lo && pos < hi;
    const size_t row = (size_t(page) * page_size + pos % page_size) * ckv + 2 * kvh + is_v;
    const unsigned char* src = load ? kv + (row * kChunks + part) * 16 : kv;
    unsigned char* dst;
    if constexpr (Stage<Page, D>::kNarrow) {
      dst = stage + (size_t(is_v) * kTileKeys + key) * D + part * 16;
    } else {
      dst = stage + is_v * Tile<D>::kBytes + (size_t(key) * Tile<D>::kStride + part * 8) * 2;
    }
    cp_async16(dst, src, load ? 16 : 0);
  }
}

// Narrow pages: widens a byte stage into the padded bf16 K and V tiles at
// `tiles` (every value is exact in bf16, zeros stay zeros).
template <class Page, int D, int kThreads>
__device__ __forceinline__ void widen_tile(__nv_bfloat16* tiles, const unsigned char* stage) {
  constexpr int kChunks = D / 16;
  using Copies = TileCopies<kChunks, kThreads>;
  constexpr int kCopies = Copies::kPerThread;
#pragma unroll(kCopies > kUnrollCopies ? 8 : kCopies)
  for (int i = 0; i < kCopies; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if constexpr (!Copies::kWhole) {
      if (c >= Copies::kTotal) break;
    }
    const int row = c / kChunks;  // is_v * 64 + key
    const int part = c % kChunks;
    const uint4 raw = *reinterpret_cast<const uint4*>(stage + size_t(row) * D + part * 16);
    kv_page::store_chunk_bf16<Page>(raw, tiles + size_t(row) * Tile<D>::kStride + part * 16);
  }
}

// Q's A fragments for 16 query rows (bf16, staged at `rows`, stride D +
// 8). Up to head_dim 128 a warp holds all D / 16 of them in registers,
// loaded once. At 160 and 256 they would take 40 and 64 registers a thread
// beside O's 80 and 128 (and S), so there the rows stay staged in shared
// memory for the whole loop and each k16 step of Q . K^T reads its
// fragment with one ldmatrix.x4.
template <int D>
struct QFrags {
  static constexpr bool kHeld = D <= 128;
  uint32_t f[kHeld ? D / 16 : 1][4];
  const __nv_bfloat16* rows;  // this lane's ldmatrix row at dimension 0
};

template <int D>
__device__ __forceinline__ void load_q(QFrags<D>& q, const __nv_bfloat16* rows) {
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;
  q.rows = rows + ((mi & 1) * 8 + lane % 8) * Tile<D>::kStride + (mi / 2) * 8;
  if constexpr (QFrags<D>::kHeld) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(q.f[kk], q.rows + kk * 16);
  }
}

// s[nb] = Q . K^T for the 8-key blocks nb of the NB * 8 keys from `keys`
// (the K tile's row of the first key).
template <int D, int NB>
__device__ __forceinline__ void qk(float s[NB][4], const QFrags<D>& q,
                                   const __nv_bfloat16* keys) {
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (QFrags<D>::kHeld) {
      a[0] = q.f[kk][0];
      a[1] = q.f[kk][1];
      a[2] = q.f[kk][2];
      a[3] = q.f[kk][3];
    } else {
      ldmatrix_x4(a, q.rows + kk * 16);
    }
#pragma unroll
    for (int p = 0; p < NB / 2; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, keys + (p * 16 + (mi / 2) * 8 + lane % 8) * Tile<D>::kStride + kk * 16 +
                         (mi & 1) * 8);
      mma_bf16(s[2 * p], a, b[0], b[1]);
      mma_bf16(s[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// One online-softmax step of a warp's 16 rows over the NB * 8 scores of a
// tile (masked ones -inf). Each lane holds rows g and g + 8 (r = 0, 1): the
// row maximum m (equal across the quad), its partial sum l (its own
// columns; the quad's are added at the end) and its output fragments o.
// A row that sees no key keeps m = -inf, and o and l stay 0. A row whose
// new scores are all -inf rescales by exp(0) = 1 exactly and adds zeros.
// On return s holds the probabilities.
template <int D, int NB>
__device__ __forceinline__ void softmax_step(float s[NB][4], float m[2], float l[2],
                                             float o[D / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // exp(-inf - 0) = 0
    const float alpha = m[r] == m_new ? 1.f : __expf(m[r] - m_use);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][2 * r] = __expf(s[nb][2 * r] - m_use);
      s[nb][2 * r + 1] = __expf(s[nb][2 * r + 1] - m_use);
      sum += s[nb][2 * r] + s[nb][2 * r + 1];
    }
    l[r] = l[r] * alpha + sum;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][2 * r] *= alpha;
      o[j][2 * r + 1] *= alpha;
    }
  }
}

// o += P . V over the NB * 8 keys from `vals` (the V tile's row of the
// first key, offset to the first of the kCols columns o holds: all D of
// them but in the ragged kernel at head_dim 384, where a warp holds 128),
// with P (the probabilities in s) taken as hi + lo, both bf16
// (hi = P rounded, lo = the rest rounded), in two products: about 2^-17
// of each probability, where hi alone errs by about 2^-9 (24 layers on
// E4M3 pages grew that to 4.8e-2 of a logits row; PERF.md).
template <int D, int NB, int kCols = D>
__device__ __forceinline__ void pv(float o[kCols / 8][4], float s[NB][4],
                                   const __nv_bfloat16* vals) {
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;
#pragma unroll
  for (int j = 0; j < NB / 2; ++j) {
    // The A fragment's pairs: (g, 2t..), (g + 8, 2t..), (g, 8 + 2t..), (g + 8, 8 + 2t..).
    const float p[4][2] = {{s[2 * j][0], s[2 * j][1]},
                           {s[2 * j][2], s[2 * j][3]},
                           {s[2 * j + 1][0], s[2 * j + 1][1]},
                           {s[2 * j + 1][2], s[2 * j + 1][3]}};
    uint32_t a[4];
    uint32_t a_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p[i][0], p[i][1]);
      a[i] = *reinterpret_cast<const uint32_t*>(&hi);
      a_lo[i] = pack_bf16(p[i][0] - __low2float(hi), p[i][1] - __high2float(hi));
    }
#pragma unroll
    for (int dp = 0; dp < kCols / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vals + (j * 16 + (mi & 1) * 8 + lane % 8) * Tile<D>::kStride +
                               dp * 16 + (mi / 2) * 8);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      mma_bf16(o[2 * dp], a_lo, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a_lo, b[2], b[3]);
    }
  }
}

// The full row sums: each lane's partial sums added across its quad.
__device__ __forceinline__ void finish_sums(float l[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

}  // namespace attn
