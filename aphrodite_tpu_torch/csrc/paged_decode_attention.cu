// Paged decode attention (q_len == 1 per sequence) for Hopper, sm_90a.
//
// Replaces the TPU kernel aphrodite_tpu/ops/decode_attention.py:
// paged_decode_attention -> _decode_kernel. The TPU kernel groups G
// sequences into one block-diagonal score matmul because the MXU wants
// wide tiles; that layout is a TPU choice and is not carried over. Here
// one block serves one (sequence, kv head): the QG = QH / KV query heads
// of that kv head share every K/V tile the block stages in shared memory.
// The instantiations are by QG_MAX, a power of two (1, 2, 4, 8, 16), and
// take any QG up to it at run time: QG 1-16 covers MHA (Baichuan-13B),
// Llama-3's 4 and 8, Qwen2.5's 5, 6 and 7 and Llama-3.2-3B's 3. The
// query, score and softmax state, the accumulators and the softmax warps
// are sized by QG_MAX; the heads past QG are padding: their query rows are
// zeros, they run through every loop as the real ones do (so the loops are
// the code of the exact QG = QG_MAX instantiation, and at QG = QG_MAX the
// results are those of the kernel that was built for QG alone), and
// nothing of them is written. At QG 3, 5, 6 and 7 that wastes 1/4, 3/8,
// 1/4 and 1/8 of the score and P.V work; the bytes read are unchanged.
//
// head_dim D is a template parameter too, 64 or 128. The block has D
// threads: in the QK pass each owns one key of a D-key tile, in the P.V
// pass one output dimension of each head. At D = 64 that is two warps and
// 64-key tiles.
//
// Bound on the H100: bytes. Each step reads every live K/V row once
// (2 * kv_len * D bf16 per kv head) and does 4 * QG * D FLOPs per key,
// about QG operations per byte, far below the ~295 FLOP/byte ridge.
// The design reads each K/V row from device memory exactly once per
// (sequence, kv head), with 16-byte coalesced loads (one warp moves one
// token's adjacent K and V rows, 2 * D * 2 bytes, per instruction), and
// skips everything outside [max(0, kv_len - window), kv_len). Tiles are
// loaded, then consumed, with no overlap; split-KV and a cp.async/TMA
// pipeline are later work.
//
// Semantics (same as the plain version in ops/decode_attention.py):
//   out[s, h] = softmax_j(cap(q[s, h] . k[s, j] * sm_scale)
//                         + slope[h] * (j - (kv_len - 1))) . v[s, j]
// over j in [kv_lo, kv_len), kv head h / QG; the ALiBi term is there only
// when a slope table is given (f32[QH], global query head h), and is
// formed as the JAX kernel forms it: the slope times the f32 distance,
// rounded, then added, after the soft cap. Rows with kv_len == 0 are
// dead padding and get zeros. Nothing past kv_len is ever loaded: the
// shared-memory slots of such keys are zero-filled and their
// probabilities are exactly 0, so stale or NaN bytes in unwritten page
// slots cannot reach the output.
//
// Blocksparse (Phi-3-Small's local + vertical-stride mask, blocksparse.cuh,
// the blocksparse option of the TPU kernel), with the query's block bq =
// (kv_len - 1) / bsz, ANDed with the window. It is a template flag,
// BS, so that the instantiations without it are the code they were; the
// wrapper sends a layer whose gate is off to those. The QG heads of one
// block share its K/V tiles but not their phases: each head masks its own
// dead keys (probability exactly 0), and a key is staged only if it is
// visible to some head of the block. When bsz is a multiple of the page
// size, keys whose block no head of the block can see are never loaded:
// a tile with none to load is skipped before it touches the softmax
// state, and such keys in a live tile are zero-filled. The TPU kernel
// skips a page only when no query head at all hits it; here the test is
// per kv head, so on Phi-3-Small (QG 4, vert 8, phases 0..31) half the
// 64-key blocks past the local window are never read. When bsz is not a
// multiple of the page size the kernel masks only, as the TPU does.
//
// Page types: the kernel is a template over the cache's element type
// (kv_page_types.cuh), with one entry point each for bf16, E4M3, E5M2 and
// int8 pages. A narrow row is 128 bytes, not 256: the staging loop loads
// 16 values per 16-byte load and widens them to bf16 as it stores them
// into the same shared-memory tiles, so all that follows the staging is
// the bf16 kernel's, and the result equals, bit for bit, the bf16
// kernel's on those pages widened beforehand. The narrow variants read
// half the K/V bytes; their byte bound is half the bf16 one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "blocksparse.cuh"
#include "kv_page_types.cuh"

namespace {

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

// The largest QH / KV the kernel takes (the wrapper raises above it, and
// for a head_dim other than 64 and 128).
constexpr int kMaxQG = 16;

// D threads a block, D keys a tile: one key per thread in the QK pass,
// one output dimension per thread in the P.V pass.
template <int D, int QG, bool BS>
struct DecodeSmem {
  static constexpr int kThreads = D;
  static constexpr int kTileKeys = D;
  static constexpr int kKPad = D + 8;  // bf16 row stride: an odd number of 16-byte units
  static constexpr size_t k_tile = size_t(kTileKeys) * kKPad * 2;
  static constexpr size_t v_tile = size_t(kTileKeys) * D * 2;
  static constexpr size_t q = size_t(QG) * D * 4;
  static constexpr size_t p = size_t(QG) * kTileKeys * 4;
  static constexpr size_t stats = size_t(3) * QG * 4;
  static constexpr size_t live = BS ? size_t(kTileKeys) : 0;  // blocksparse: key staged?
  static constexpr size_t bytes = k_tile + v_tile + q + p + stats + live;
};

// QG: QG_MAX, the heads the block's state is sized for; qg (<= QG): the
// model's QH / KV.
template <class Page, int D, int QG, bool BS>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const unsigned char* __restrict__ kv,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ page_indices,
                    const float* __restrict__ alibi_slopes,
                    __nv_bfloat16* __restrict__ out, int num_kv_heads, int qg,
                    int page_size, int pages_per_seq, float sm_scale,
                    int sliding_window, float soft_cap, Blocksparse bs) {
  using L = DecodeSmem<D, QG, BS>;
  constexpr int kThreads = L::kThreads;
  constexpr int kTileKeys = L::kTileKeys;
  constexpr int kKPad = L::kKPad;
  constexpr int kVals = Page::kValues;  // values per 16-byte load
  constexpr int kChunks = D / kVals;    // 16-byte loads per K (or V) row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_tile = reinterpret_cast<__nv_bfloat16*>(smem + L::k_tile);
  float* q_s = reinterpret_cast<float*>(smem + L::k_tile + L::v_tile);
  float* p_s = q_s + QG * D;
  float* m_s = p_s + QG * kTileKeys;
  float* l_s = m_s + QG;
  float* alpha_s = l_s + QG;
  unsigned char* live_s = reinterpret_cast<unsigned char*>(alpha_s + QG);  // BS only

  const int seq = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int num_q_heads = num_kv_heads * qg;
  const int ckv = 2 * num_kv_heads;

  const size_t head0 = size_t(seq) * num_q_heads + size_t(kvh) * qg;
  __nv_bfloat16* out_base = out + head0 * D;
  const int kv_len = min(kv_lens[seq], pages_per_seq * page_size);
  if (kv_len <= 0) {
    for (int i = tid; i < qg * D; i += kThreads) out_base[i] = __float2bfloat16(0.f);
    return;
  }
  const int kv_lo = sliding_window > 0 ? max(0, kv_len - sliding_window) : 0;
  const int* pages = page_indices + size_t(seq) * pages_per_seq;

  // The padding heads past qg get zero query rows.
  const __nv_bfloat16* q_base = q + head0 * D;
  for (int i = tid; i < QG * D; i += kThreads)
    q_s[i] = i < qg * D ? __bfloat162float(q_base[i]) * sm_scale : 0.f;
  if (tid < QG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[QG];  // output dim tid of each head
#pragma unroll
  for (int h = 0; h < QG; ++h) acc[h] = 0.f;
  // ALiBi: one slope per head of the group (a branch uniform across the
  // grid: without a table no slope is read and no bias is added).
  const bool alibi = alibi_slopes != nullptr;
  float slope[QG];
#pragma unroll
  for (int h = 0; h < QG; ++h) slope[h] = alibi && h < qg ? alibi_slopes[kvh * qg + h] : 0.f;
  // Blocksparse: the query's block, each head's phase, and whether dead
  // keys are skipped (blocks of whole pages) or only masked.
  int bq = 0;
  int phase[QG];
  bool skip_dead = false;
  if constexpr (BS) {
    bq = (kv_len - 1) / bs.block;
#pragma unroll
    for (int h = 0; h < QG; ++h) phase[h] = bs.offsets[kvh * qg + h];  // qg == QG
    skip_dead = bs.block % page_size == 0;
  }
  for (int tile0 = kv_lo; tile0 < kv_len; tile0 += kTileKeys) {
    if constexpr (BS) {
      if (skip_dead) {
        // Thread tid's key is staged iff some head of this block may see
        // it. A tile with no such key is never loaded and never touches
        // the softmax state; the test is uniform across the block, and
        // its barrier publishes live_s to the staging loop.
        const int pos = tile0 + tid;
        bool live = false;
#pragma unroll
        for (int h = 0; h < QG; ++h)
          live = live || block_visible(bs, bq, pos / bs.block, phase[h]);
        live = live && pos < kv_len;
        live_s[tid] = live;
        if (!__syncthreads_or(live)) continue;
      }
    }
    // Stage K and V rows of keys [tile0, tile0 + kTileKeys); zeros past
    // kv_len (and, with blocksparse on whole pages, at keys no head sees).
    for (int c = tid; c < kTileKeys * 2 * kChunks; c += kThreads) {
      const int key = c / (2 * kChunks);
      const int rem = c % (2 * kChunks);
      const int is_v = rem / kChunks;
      const int part = rem % kChunks;
      const int pos = tile0 + key;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      bool load = pos < kv_len;
      if constexpr (BS) load = load && (!skip_dead || live_s[key]);
      if (load) {
        const int page = pages[pos / page_size];
        const size_t row = (size_t(page) * page_size + pos % page_size) * ckv + 2 * kvh + is_v;
        val = *reinterpret_cast<const uint4*>(kv + (row * kChunks + part) * 16);
      }
      __nv_bfloat16* dst =
          is_v ? v_tile + key * D + part * kVals : k_tile + key * kKPad + part * kVals;
      kv_page::store_chunk_bf16<Page>(val, dst);
    }
    __syncthreads();

    // Scores: thread tid owns key tile0 + tid for all QG heads.
    {
      const bool valid = tile0 + tid < kv_len;
      float s[QG];
#pragma unroll
      for (int h = 0; h < QG; ++h) s[h] = 0.f;
      const __nv_bfloat16* krow = k_tile + tid * kKPad;
#pragma unroll 4
      for (int d = 0; d < D; d += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(k2[i]);
          kf[2 * i] = f.x;
          kf[2 * i + 1] = f.y;
        }
#pragma unroll
        for (int h = 0; h < QG; ++h) {
          const float4 qa = *reinterpret_cast<const float4*>(q_s + h * D + d);
          const float4 qb = *reinterpret_cast<const float4*>(q_s + h * D + d + 4);
          s[h] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                  qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
        }
      }
      // The key's distance back from the query token, exact in f32.
      const float dist = float(tile0 + tid - (kv_len - 1));
#pragma unroll
      for (int h = 0; h < QG; ++h) {
        float v = s[h];
        if (soft_cap > 0.f) v = soft_cap * tanhf(v / soft_cap);
        if (alibi) v = __fadd_rn(v, __fmul_rn(slope[h], dist));
        bool visible = valid;
        if constexpr (BS)
          visible = visible && block_visible(bs, bq, (tile0 + tid) / bs.block, phase[h]);
        p_s[h * kTileKeys + tid] = visible ? v : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: one warp per head. Without blocksparse key tile0 is
    // always valid, so every tile has a finite maximum; with it a head may
    // see no key of a tile (nor of any tile before), and then its maximum
    // stays -inf, every p is 0 and nothing is rescaled.
    for (int h = warp; h < QG; h += kThreads / 32) {
      float* row = p_s + h * kTileKeys;
      float mx = -INFINITY;
      for (int k = lane; k < kTileKeys; k += 32) mx = fmaxf(mx, row[k]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int k = lane; k < kTileKeys; k += 32) {
        const float v = row[k];
        const float p = v == -INFINITY ? 0.f : __expf(v - m_new);
        row[k] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : __expf(m_old - m_new);
        alpha_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // P . V over this tile's valid keys.
    {
#pragma unroll
      for (int h = 0; h < QG; ++h) acc[h] *= alpha_s[h];
      const int n_valid = min(kTileKeys, kv_len - tile0);
      for (int k = 0; k < n_valid; ++k) {
        const float v = __bfloat162float(v_tile[k * D + tid]);
#pragma unroll
        for (int h = 0; h < QG; ++h) acc[h] += p_s[h * kTileKeys + k] * v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < QG; ++h) {
    if (h >= qg) break;
    const float l = l_s[h];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    out_base[h * D + tid] = __float2bfloat16(acc[h] * inv);
  }
}

template <class Page, int D, int QG, bool BS>
cudaError_t launch(const void* q, const void* kv, const int* kv_lens, const int* page_indices,
                   const float* alibi_slopes, void* out, int num_seqs, int num_kv_heads, int qg,
                   int page_size, int pages_per_seq, float sm_scale, int sliding_window,
                   float soft_cap, Blocksparse bs, cudaStream_t stream) {
  using L = DecodeSmem<D, QG, BS>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<Page, D, QG, BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(L::bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(num_seqs, num_kv_heads);
  paged_decode_kernel<Page, D, QG, BS><<<grid, L::kThreads, L::bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const unsigned char*>(kv), kv_lens,
      page_indices, alibi_slopes, static_cast<__nv_bfloat16*>(out), num_kv_heads, qg,
      page_size, pages_per_seq, sm_scale, sliding_window, soft_cap, bs);
  return cudaGetLastError();
}

// The smallest power of two at or above qg (qg in 1..kMaxQG): the QG_MAX
// bucket whose instantiation serves it.
inline int qg_bucket(int qg) {
  int b = 1;
  while (b < qg) b *= 2;
  return b;
}

// Launches the instantiation for head_dim D and QG_MAX = the bucket of
// qg, without blocksparse, or with it (D 128 and QG 1, 2, 4 or 8 only:
// the shapes blocksparse is built for).
template <class Page, int D>
cudaError_t launch_d(const void* q, const void* kv, const int* kv_lens, const int* page_indices,
                     const float* alibi_slopes, void* out, int num_seqs, int num_kv_heads,
                     int qg, int page_size, int pages_per_seq, float sm_scale,
                     int sliding_window, float soft_cap, Blocksparse bs, cudaStream_t stream) {
#define PAGED_DECODE_LAUNCH(qgm, b)                                                           \
  launch<Page, D, qgm, b>(q, kv, kv_lens, page_indices, alibi_slopes, out, num_seqs,         \
                          num_kv_heads, qg, page_size, pages_per_seq, sm_scale, sliding_window, \
                          soft_cap, bs, stream)
  if (bs.offsets != nullptr) {
    if constexpr (D == 128) {
      switch (qg) {
        case 1:
          return PAGED_DECODE_LAUNCH(1, true);
        case 2:
          return PAGED_DECODE_LAUNCH(2, true);
        case 4:
          return PAGED_DECODE_LAUNCH(4, true);
        case 8:
          return PAGED_DECODE_LAUNCH(8, true);
      }
    }
    return cudaErrorInvalidValue;
  }
  switch (qg_bucket(qg)) {
    case 1:
      return PAGED_DECODE_LAUNCH(1, false);
    case 2:
      return PAGED_DECODE_LAUNCH(2, false);
    case 4:
      return PAGED_DECODE_LAUNCH(4, false);
    case 8:
      return PAGED_DECODE_LAUNCH(8, false);
    case 16:
      return PAGED_DECODE_LAUNCH(16, false);
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_DECODE_LAUNCH
}

// Checks the shape and launches the variant for pages of type Page,
// head_dim 64 or 128, QG = num_q_heads / num_kv_heads query heads per kv
// head (1 to 16) and blocksparse (a phase table given) or not.
template <class Page>
int run(const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,
        const void* alibi_slopes, void* out, int num_seqs, int num_q_heads, int num_kv_heads,
        int head_dim, int page_size, int pages_per_seq, float sm_scale, int sliding_window,
        float soft_cap, const void* bs_offsets, int bs_block, int bs_local, int bs_vert,
        void* stream) {
  if (num_seqs <= 0) return int(cudaSuccess);
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0) return int(cudaErrorInvalidValue);
  const int qg = num_q_heads / num_kv_heads;
  if (qg < 1 || qg > kMaxQG) return int(cudaErrorInvalidValue);
  const Blocksparse bs{static_cast<const int*>(bs_offsets), bs_block, bs_local, bs_vert};
  if (bs.offsets != nullptr && (bs_block <= 0 || bs_local <= 0 || bs_vert <= 0))
    return int(cudaErrorInvalidValue);
  const int* lens = static_cast<const int*>(kv_lens);
  const int* pages = static_cast<const int*>(page_indices);
  const float* slopes = static_cast<const float*>(alibi_slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return int(launch_d<Page, 64>(q, kv_pages, lens, pages, slopes, out, num_seqs,
                                    num_kv_heads, qg, page_size, pages_per_seq, sm_scale,
                                    sliding_window, soft_cap, bs, s));
    case 128:
      return int(launch_d<Page, 128>(q, kv_pages, lens, pages, slopes, out, num_seqs,
                                     num_kv_heads, qg, page_size, pages_per_seq, sm_scale,
                                     sliding_window, soft_cap, bs, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// One entry point per page type: paged_decode_attention_{bf16, e4m3, e5m2,
// int8}. q bf16[S, QH, D] with D = 64 or 128 and QH = QG * KV for QG in 1
// to 16 (blocksparse: D = 128, QG in {1, 2, 4, 8}), kv_pages [P, page_size, 2 * KV, D] of the named type (K at even
// and V at odd combined heads), kv_lens i32[S], page_indices i32[S,
// pages_per_seq], alibi_slopes f32[QH] or null (no ALiBi), out bf16[S, QH,
// D]. sliding_window <= 0 and soft_cap <= 0 mean off. bs_offsets i32[QH]
// (each query head's vertical phase) with bs_block, bs_local and bs_vert
// turns blocksparse on; null means off (the others are then unread).
// Returns the CUDA error of the launch (cudaErrorInvalidValue for any other
// D or QH / KV, or blocksparse parameters that are not positive or at a
// shape it is not built for).
#define PAGED_DECODE_ENTRY(suffix, Page)                                                     \
  extern "C" int paged_decode_attention_##suffix(                                            \
      const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,    \
      const void* alibi_slopes, void* out, int num_seqs, int num_q_heads, int num_kv_heads,  \
      int head_dim, int page_size, int pages_per_seq, float sm_scale, int sliding_window,    \
      float soft_cap, const void* bs_offsets, int bs_block, int bs_local, int bs_vert,       \
      void* stream) {                                                                        \
    return run<Page>(q, kv_pages, kv_lens, page_indices, alibi_slopes, out, num_seqs,        \
                     num_q_heads, num_kv_heads, head_dim, page_size, pages_per_seq, sm_scale, \
                     sliding_window, soft_cap, bs_offsets, bs_block, bs_local, bs_vert,      \
                     stream);                                                                \
  }

PAGED_DECODE_ENTRY(bf16, kv_page::Bf16)
PAGED_DECODE_ENTRY(e4m3, kv_page::E4m3)
PAGED_DECODE_ENTRY(e5m2, kv_page::E5m2)
PAGED_DECODE_ENTRY(int8, kv_page::Int8)
