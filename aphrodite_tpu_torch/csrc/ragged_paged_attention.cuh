// Ragged paged attention (prefill chunks and decode tokens in one flat
// token stream) for Hopper, sm_90a.
//
// Replaces the TPU kernel behind aphrodite_tpu/ops/attention.py:
// _kernel_attention, the Pallas ragged_paged_attention bundled with JAX
// (and the base semantics of its vendored fork
// aphrodite_tpu/ops/rpa_alibi_kernel.py: ragged_paged_attention_alibi).
//
// Work split: one block per (query tile, kv head). A query tile holds
// kRows = 64 query rows = floor(64 / QG) consecutive tokens of ONE
// sequence times the QG query heads that share the kv head, so a tile
// never straddles two sequences; where QG does not divide 64 (3, 5, 6, 7,
// 9-15) the last 64 mod QG rows of every tile are idle. QG = QH / KV is a
// template parameter, instantiated at head_dim 128 for 1, 2, 4 and 8 (a
// tile of 64, 32, 16 or 8 tokens), and 0, which reads QG at run time and
// serves every other QG up to 16, and every QG at head_dim 64: its
// row-to-(token, head) divisions are by a runtime value, the rest is the
// same code. (Each instantiation adds about two seconds of nvcc to every
// build; exact ones for the other shapes would add a minute.) head_dim D
// (64 or 128) is a template parameter too. So are ALiBi and blocksparse,
// so that the
// variant without either is the code it was before they came in: a
// runtime branch in the unrolled row loop slowed that variant on the
// H100. The variants with ALiBi or blocksparse are built for D 128 and QG
// 1, 2, 4 and 8 only, the shapes of the models that use them. The plain variants are built from
// ragged_paged_attention.cu, those with ALiBi from
// ragged_paged_attention_alibi.cu and those with blocksparse from
// ragged_paged_attention_blocksparse.cu: three libraries that nvcc builds
// in parallel (no model has both options; the wrapper raises for the
// pair). Each block finds its (sequence, first token) by walking
// cu_q_lens on the device: the grid is an upper bound on the tile count
// (ceil(T / tokens) + S) and surplus blocks exit, so the launch needs no
// host-side value and no synchronisation.
//
// Bound on the H100: at prefill shapes, operations. A tile does
// 4 * rows * D FLOPs per key it stages, 64 FLOPs per K/V byte at QG = 4,
// so the K/V traffic stays below the memory roofline while the FMA work
// is done on CUDA cores in f32 (about 1/15 of the bf16 tensor-core peak).
// The design keeps the K/V tile in shared memory for all 64 rows, loads
// each K/V row with 16-byte coalesced loads, and visits only the keys the
// tile can see: [max(0, first_row_pos - window + 1), min(kv_len,
// last_row_pos + 1)). Tensor-core (wgmma) QK and PV products are later
// work.
//
// Semantics (same as the plain version in ops/attention.py): row i of
// sequence s sits at absolute position p = kv_len - q_len + i and attends
// keys j with j <= p, j < kv_len and, with a window w, j > p - w, with
// scores cap(q . k * sm_scale), plus, with a slope table (f32[QH], the
// ALiBi option of the vendored fork aphrodite_tpu/ops/rpa_alibi_kernel.py),
// slope[h] * (j - p): the slope times the f32 distance, rounded, then
// added after the soft cap, as the fork does. With blocksparse (the fork's
// blocksparse option, the mask of blocksparse.cuh) each row also masks,
// with its own block p / bsz and its head's phase, the keys that mask
// hides, as the fork does (which masks only and loads every page). Here a
// 32-key tile that no row and head of the query tile can see is skipped
// before it is staged; that leaves every result unchanged, bit for bit,
// since such a tile adds probability 0 and rescales by exactly 1. Nothing
// at or past kv_len is loaded; such slots are zero-filled and get
// probability exactly 0. Tokens past
// cu_q_lens[S] are not written here: the caller zero-fills the output.
//
// Page types: the kernel is a template over the cache's element type
// (kv_page_types.cuh), with one entry point each for bf16, E4M3, E5M2 and
// int8 pages. With fp8 pages it stands for the fp8 path of the vendored
// fork (the JAX package sends fp8 prefill there for its fast fp8 -> bf16
// conversion), with int8 pages for the bundled kernel. A narrow row is
// 128 bytes: the staging loop loads 16 values per 16-byte load and widens
// them to f32 as it stores them into the same shared-memory tiles, so all
// that follows the staging is unchanged and the result equals, bit for
// bit, the bf16 entry point's on those pages widened beforehand.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "blocksparse.cuh"
#include "kv_page_types.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                   // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 32;                   // keys per K/V tile: one per lane
// The largest QH / KV the kernel takes (the wrapper raises above it, and
// for a head_dim other than 64 and 128).
constexpr int kMaxQG = 16;

template <int D>
struct RaggedSmem {
  static constexpr int kKPad = D + 4;  // f32 row stride of the K tile
  static constexpr size_t q = size_t(kRows) * D * 4;
  static constexpr size_t k = size_t(kKeys) * kKPad * 4;
  static constexpr size_t v = size_t(kKeys) * D * 4;
  static constexpr size_t bytes = q + k + v;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// QG: QH / KV, or 0 for the variant that reads it from qg_rt.
template <class Page, int D, int QG, bool ALIBI, bool BLOCKSPARSE>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                              const unsigned char* __restrict__ kv,
                              const int* __restrict__ kv_lens,
                              const int* __restrict__ page_indices,
                              const int* __restrict__ cu_q_lens,
                              const float* __restrict__ alibi_slopes,
                              __nv_bfloat16* __restrict__ out, int num_seqs,
                              int num_kv_heads, int qg_rt, int page_size,
                              int pages_per_seq, float sm_scale, int sliding_window,
                              float soft_cap, Blocksparse bs) {
  static_assert(QG > 0 || !(ALIBI || BLOCKSPARSE), "options are built for a fixed QG");
  using L = RaggedSmem<D>;
  constexpr int kKPad = L::kKPad;
  const int qg = QG > 0 ? QG : qg_rt;
  const int kTokens = kRows / qg;         // query tokens per tile
  constexpr int kQChunks = D / 8;           // 16-byte loads per (bf16) q row
  constexpr int kVals = Page::kValues;      // K/V values per 16-byte load
  constexpr int kChunks = D / kVals;        // 16-byte loads per K (or V) row
  constexpr int kDimsPerLane = D / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = reinterpret_cast<float*>(smem + L::q);
  float* v_s = reinterpret_cast<float*>(smem + L::q + L::k);

  // Which sequence and which token tile is this block's?
  int seq = -1;
  int tile_t0 = 0;
  {
    int tiles_before = 0;
    for (int s = 0; s < num_seqs; ++s) {
      const int q_len = cu_q_lens[s + 1] - cu_q_lens[s];
      const int n_tiles = (q_len + kTokens - 1) / kTokens;
      if (int(blockIdx.x) < tiles_before + n_tiles) {
        seq = s;
        tile_t0 = (int(blockIdx.x) - tiles_before) * kTokens;
        break;
      }
      tiles_before += n_tiles;
    }
  }
  if (seq < 0) return;

  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int num_q_heads = num_kv_heads * qg;
  const int ckv = 2 * num_kv_heads;
  const int q_start = cu_q_lens[seq];
  const int q_len = cu_q_lens[seq + 1] - q_start;
  const int kv_len = min(kv_lens[seq], pages_per_seq * page_size);
  const int n_tok = min(kTokens, q_len - tile_t0);
  const int pos0 = kv_len - q_len + tile_t0;  // absolute position of the tile's first token
  const int* pages = page_indices + size_t(seq) * pages_per_seq;

  // Query rows: row r = token (r / qg), head kvh * qg + r % qg; pre-scaled.
  // Rows past kTokens * qg are idle (t >= kTokens >= n_tok): zeros.
  for (int i = tid; i < kRows * kQChunks; i += kThreads) {
    const int r = i / kQChunks;
    const int part = i % kQChunks;
    const int t = r / qg;
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t < n_tok) {
      const size_t head = size_t(q_start + tile_t0 + t) * num_q_heads + kvh * qg + r % qg;
      const uint4 raw = *reinterpret_cast<const uint4*>(q + head * D + part * 8);
      kv_page::chunk_to_f32<kv_page::Bf16>(raw, vals);
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] *= sm_scale;
    }
    float4* dst = reinterpret_cast<float4*>(q_s + r * D + part * 8);
    dst[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    dst[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
  }

  // Keys this tile can see.
  const int kv_hi = min(kv_len, pos0 + n_tok);
  const int kv_lo = sliding_window > 0 ? max(0, pos0 - sliding_window + 1) : 0;

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDimsPerLane; ++j) acc[i][j] = 0.f;
  }

  // Blocksparse: the phases of this kv head's query heads, for the test of
  // whether any row of the tile may see a key tile.
  int group_phase[QG > 0 ? QG : 1];
  if constexpr (BLOCKSPARSE) {
#pragma unroll
    for (int h = 0; h < QG; ++h) group_phase[h] = bs.offsets[kvh * QG + h];
  }

  for (int tile0 = kv_lo; tile0 < kv_hi; tile0 += kKeys) {
    if constexpr (BLOCKSPARSE) {
      // Lane l's key against the tile's first row (the lowest query block,
      // which sees the most local keys) and every head's phase. The same
      // in every warp, so the whole block skips or none of it.
      const int key = tile0 + lane;
      bool live = false;
#pragma unroll
      for (int h = 0; h < QG; ++h)
        live = live || block_visible(bs, pos0 / bs.block, key / bs.block, group_phase[h]);
      if (!__any_sync(0xffffffffu, live && key < kv_hi)) continue;
    }
    __syncthreads();  // previous tile fully consumed (and q_s written)
    for (int c = tid; c < kKeys * 2 * kChunks; c += kThreads) {
      const int key = c / (2 * kChunks);
      const int rem = c % (2 * kChunks);
      const int is_v = rem / kChunks;
      const int part = rem % kChunks;
      const int pos = tile0 + key;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // zeros in every page type
      if (pos < kv_hi) {
        const int page = pages[pos / page_size];
        const size_t row = (size_t(page) * page_size + pos % page_size) * ckv + 2 * kvh + is_v;
        raw = *reinterpret_cast<const uint4*>(kv + (row * kChunks + part) * 16);
      }
      float* dst = is_v ? v_s + key * D + part * kVals : k_s + key * kKPad + part * kVals;
      kv_page::store_chunk_f32<Page>(raw, dst);
    }
    __syncthreads();

    const int key_pos = tile0 + lane;
    const float* krow = k_s + lane * kKPad;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int t = r / qg;
      if (t >= n_tok) continue;  // warp-uniform
      const int pos = pos0 + t;
      bool valid = key_pos < kv_hi && key_pos <= pos;
      if (sliding_window > 0) valid = valid && key_pos > pos - sliding_window;
      if constexpr (BLOCKSPARSE) {
        // This row's block and its head's phase (one cached load per warp).
        const int phase = __ldg(bs.offsets + kvh * qg + r % qg);
        valid = valid && block_visible(bs, pos / bs.block, key_pos / bs.block, phase);
      }
      const float* qrow = q_s + r * D;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qrow + d);
        const float4 b = *reinterpret_cast<const float4*>(krow + d);
        s += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
      if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      if constexpr (ALIBI) {
        // One cached load for the whole warp, where the bias is added.
        const float slope = __ldg(alibi_slopes + kvh * qg + r % qg);
        s = __fadd_rn(s, __fmul_rn(slope, float(key_pos - pos)));
      }
      const float mx = warp_max(valid ? s : -INFINITY);
      const float m_new = fmaxf(m[i], mx);
      if (m_new == -INFINITY) continue;  // no visible key yet for this row
      const float p = valid ? __expf(s - m_new) : 0.f;
      const float alpha = m[i] == -INFINITY ? 0.f : __expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDimsPerLane; ++j) acc[i][j] *= alpha;
#pragma unroll 4
      for (int k = 0; k < kKeys; ++k) {
        const float pk = __shfl_sync(0xffffffffu, p, k);
        const float* vrow = v_s + k * D + lane * kDimsPerLane;
        if constexpr (kDimsPerLane % 4 == 0) {
#pragma unroll
          for (int j = 0; j < kDimsPerLane; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(vrow + j);
            acc[i][j] += pk * v.x;
            acc[i][j + 1] += pk * v.y;
            acc[i][j + 2] += pk * v.z;
            acc[i][j + 3] += pk * v.w;
          }
        } else {  // D = 64: two dims per lane
          const float2 v = *reinterpret_cast<const float2*>(vrow);
          acc[i][0] += pk * v.x;
          acc[i][1] += pk * v.y;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int t = r / qg;
    if (t >= n_tok) continue;
    const size_t head = size_t(q_start + tile_t0 + t) * num_q_heads + kvh * qg + r % qg;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* dst = out + head * D + lane * kDimsPerLane;
#pragma unroll
    for (int j = 0; j < kDimsPerLane; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + j) =
          __floats2bfloat162_rn(acc[i][j] * inv, acc[i][j + 1] * inv);
  }
}

template <class Page, int D, int QG, bool ALIBI, bool BLOCKSPARSE>
cudaError_t launch(const void* q, const void* kv, const int* kv_lens, const int* page_indices,
                   const int* cu_q_lens, const float* alibi_slopes, void* out, int num_tokens,
                   int num_seqs, int num_kv_heads, int qg, int page_size, int pages_per_seq,
                   float sm_scale, int sliding_window, float soft_cap, Blocksparse bs,
                   cudaStream_t stream) {
  const size_t smem = RaggedSmem<D>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_paged_attention_kernel<Page, D, QG, ALIBI, BLOCKSPARSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tokens = kRows / qg;  // per tile; the kernel maps rows with the same qg
  const dim3 grid((num_tokens + tokens - 1) / tokens + num_seqs, num_kv_heads);
  ragged_paged_attention_kernel<Page, D, QG, ALIBI, BLOCKSPARSE>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const unsigned char*>(kv), kv_lens,
          page_indices, cu_q_lens, alibi_slopes, static_cast<__nv_bfloat16*>(out), num_seqs,
          num_kv_heads, qg, page_size, pages_per_seq, sm_scale, sliding_window, soft_cap, bs);
  return cudaGetLastError();
}

// Launches the instantiation for head_dim D: at D 128 QG 1, 2, 4 and 8
// have their own, every other QG up to 16 (and every QG at D 64) the one
// that reads it at run time. With ALiBi or blocksparse only D 128 and QG
// 1, 2, 4 and 8 are built.
template <class Page, int D, bool ALIBI, bool BLOCKSPARSE>
cudaError_t launch_d(const void* q, const void* kv, const int* kv_lens, const int* page_indices,
                     const int* cu_q_lens, const float* alibi_slopes, void* out,
                     int num_tokens, int num_seqs, int num_kv_heads, int qg, int page_size,
                     int pages_per_seq, float sm_scale, int sliding_window, float soft_cap,
                     Blocksparse bs, cudaStream_t stream) {
#define RAGGED_LAUNCH(qgt)                                                                    \
  launch<Page, D, qgt, ALIBI, BLOCKSPARSE>(q, kv, kv_lens, page_indices, cu_q_lens,          \
                                           alibi_slopes, out, num_tokens, num_seqs,          \
                                           num_kv_heads, qg, page_size, pages_per_seq,       \
                                           sm_scale, sliding_window, soft_cap, bs, stream)
  constexpr bool kOption = ALIBI || BLOCKSPARSE;
  if constexpr (D != 128) {
    if constexpr (kOption) return cudaErrorInvalidValue;
    else return RAGGED_LAUNCH(0);
  } else {
    switch (qg) {
      case 1:
        return RAGGED_LAUNCH(1);
      case 2:
        return RAGGED_LAUNCH(2);
      case 4:
        return RAGGED_LAUNCH(4);
      case 8:
        return RAGGED_LAUNCH(8);
    }
    if constexpr (kOption) return cudaErrorInvalidValue;
    else return RAGGED_LAUNCH(0);
  }
#undef RAGGED_LAUNCH
}

// Checks the shape and launches the variant for pages of type Page,
// head_dim 64 or 128, QG = num_q_heads / num_kv_heads query heads per kv
// head (1 to 16), ALiBi (a slope table given) or not and blocksparse (a
// phase table given) or not.
template <class Page, bool ALIBI, bool BLOCKSPARSE>
int run(const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,
        const void* cu_q_lens, const void* alibi_slopes, void* out, int num_tokens,
        int num_seqs, int num_q_heads, int num_kv_heads, int head_dim, int page_size,
        int pages_per_seq, float sm_scale, int sliding_window, float soft_cap,
        const void* bs_offsets, int bs_block, int bs_local, int bs_vert, void* stream) {
  if (num_tokens <= 0 || num_seqs <= 0) return int(cudaSuccess);
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0 ||
      num_q_heads / num_kv_heads > kMaxQG || ALIBI != (alibi_slopes != nullptr) ||
      BLOCKSPARSE != (bs_offsets != nullptr) ||
      (BLOCKSPARSE && (bs_block <= 0 || bs_local <= 0 || bs_vert <= 0)))
    return int(cudaErrorInvalidValue);
  const int qg = num_q_heads / num_kv_heads;
  const int* lens = static_cast<const int*>(kv_lens);
  const int* pages = static_cast<const int*>(page_indices);
  const int* cu = static_cast<const int*>(cu_q_lens);
  const float* slopes = static_cast<const float*>(alibi_slopes);
  const Blocksparse bs{static_cast<const int*>(bs_offsets), bs_block, bs_local, bs_vert};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return int(launch_d<Page, 64, ALIBI, BLOCKSPARSE>(
          q, kv_pages, lens, pages, cu, slopes, out, num_tokens, num_seqs, num_kv_heads, qg,
          page_size, pages_per_seq, sm_scale, sliding_window, soft_cap, bs, s));
    case 128:
      return int(launch_d<Page, 128, ALIBI, BLOCKSPARSE>(
          q, kv_pages, lens, pages, cu, slopes, out, num_tokens, num_seqs, num_kv_heads, qg,
          page_size, pages_per_seq, sm_scale, sliding_window, soft_cap, bs, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// One entry point: `name`, for pages of type Page, with ALiBi or not and
// blocksparse or not. q bf16[T, QH, D] with D = 64 or 128 and QH = QG * KV
// for QG in 1 to 16 (with ALiBi or blocksparse: D = 128 and QG in {1, 2, 4,
// 8}), kv_pages [P, page_size, 2 * KV, D] of the named type,
// kv_lens i32[S], page_indices i32[S, pages_per_seq], cu_q_lens i32[S + 1],
// alibi_slopes f32[QH] (the ALiBi entry points) or null (the others), out
// bf16[T, QH, D] (zero-filled by the caller). sliding_window <= 0 and
// soft_cap <= 0 mean off. bs_offsets i32[QH] with bs_block, bs_local and
// bs_vert (the blocksparse entry points) or null (the others). Returns the
// CUDA error of the launch (cudaErrorInvalidValue for any other D or QH /
// KV, or a slope or phase table that does not match the entry).
#define RAGGED_ENTRY(name, Page, alibi, blocksparse)                                          \
  extern "C" int name(const void* q, const void* kv_pages, const void* kv_lens,              \
                      const void* page_indices, const void* cu_q_lens,                       \
                      const void* alibi_slopes, void* out, int num_tokens, int num_seqs,     \
                      int num_q_heads, int num_kv_heads, int head_dim, int page_size,        \
                      int pages_per_seq, float sm_scale, int sliding_window,                 \
                      float soft_cap, const void* bs_offsets, int bs_block, int bs_local,    \
                      int bs_vert, void* stream) {                                           \
    return run<Page, alibi, blocksparse>(                                                    \
        q, kv_pages, kv_lens, page_indices, cu_q_lens, alibi_slopes, out, num_tokens,        \
        num_seqs, num_q_heads, num_kv_heads, head_dim, page_size, pages_per_seq, sm_scale,   \
        sliding_window, soft_cap, bs_offsets, bs_block, bs_local, bs_vert, stream);          \
  }
