// Paged decode attention (q_len == 1 per sequence) for Hopper, sm_90a:
// split-KV (flash-decoding) with a cp.async-pipelined K/V ring and a
// deterministic second pass.
//
// Built twice, as two libraries that nvcc compiles in parallel: from
// paged_decode_attention.cu (the entry points without T5's bias) and from
// paged_decode_attention_rel.cu (those with it). In one source the
// instantiations were the build's longest compile (117 s of a 120-s
// parallel build of every source, on an NVIDIA H100 host); the launches'
// code is the same in either.
//
// Replaces the TPU kernel aphrodite_tpu/ops/decode_attention.py:
// paged_decode_attention -> _decode_kernel. The TPU kernel groups G
// sequences into one block-diagonal score matmul because the MXU wants
// wide tiles; that layout is a TPU choice and is not carried over.
//
// Work split: the keys of each row are cut into splits, fixed ranges of
// split_keys keys (a multiple of the 64-key tile, so of every page size
// that divides 64), and the grid is (sequence, kv head, slot): the block
// of slot z takes splits z, z + slots, z + 2 slots, ... of its row that
// hold a key of [kv_lo, kv_len), in turn, carrying one online softmax
// from split to split, and writes one partial. The host chooses split_keys
// and the number of slots from host values alone (ops/decode_attention.py:
// plan_decode_splits): the slots so that the grid holds about eight blocks
// an SM, and never more slots than the page table has splits. So the
// longest row no longer sets the time of its (sequence, kv head): at
// Qwen2.5-7B's decode (16 rows of up to 4128 keys, 4 kv heads) the grid
// holds about a thousand blocks for 132 SMs, where one block per
// (sequence, kv head) gave 64. A page table far wider than the rows (the
// engine's spans max_model_len) adds no blocks and no work: a block visits
// only its live splits, and one with none exits at once. A row whose live
// keys all lie in one slot's splits (one split, or one slot) writes its
// output directly; every other row writes one f32 partial per live slot
// (the unnormalised acc[QG, D], the row maximum m and the sum l) to a
// scratch the wrapper allocates, [slots, S, QH], bounded by the grid and
// not by the page table, and the second kernel of this source,
// paged_decode_combine_kernel, merges the live slots of each (sequence,
// query head) in slot order: the same merge as the JAX package's
// merge_attention_partials (aphrodite_tpu/ops/decode_attention.py),
// deterministic from run to run. Both kernels are one call of the entry
// point (one counted launch of the wrapper).
//
// Inside a split the block's four warps share each 64-key K/V tile of a
// two-stage cp.async ring (attention_mma.cuh: tile i + 1 loads while tile
// i is used; narrow pages are copied raw and widened to bf16 in one pass);
// warp w takes keys 16 w .. 16 w + 15 of every tile, with its own online
// softmax, and the four warps' states are merged in shared memory after
// the block's last split. (A ring that runs on from one split to the next
// ran 9-14 % slower on bf16 pages at the timed shapes, where most blocks
// take one split.) Up to QG = QH / KV = 16, the query heads of the kv
// head are the 16 rows of one mma.sync m16n8k16 tile (rows past QG are
// zero padding, never written), so one instantiation takes every QG from
// 1 to 16. Above 16 (Falcon-7B's multi-query 71 on one kv head) they are
// more than one tile's rows, and a second kernel of this source,
// paged_decode_wide_kernel, takes them: its block has eight warps, warp w
// owns the 16 rows of head tile w and takes all 64 keys of every K/V
// tile, so each tile is staged once for up to 128 query heads (8 tiles
// of 16; rows past QG are padding, as above) and no warp holds more than
// one tile's accumulators. Past 128 query heads a kv head's heads are cut
// into groups of 128, one block each (a grid dimension the wrapper's
// plan counts). Its splits, ring, masks, partials and combine are the
// first kernel's; only the warps' share of the work differs. Both
// products run on the tensor cores, Q . K^T and P . V as in the ragged
// kernel, with Q's fragments held in registers (read from the staged rows
// at each k16 step at head_dim 160 and 256, as there). head_dim is a
// template parameter: 64, 80, 96, 128, 160 and 256 are built; 80 (Phi-2,
// Pythia-2.8B, StableLM-3B), 96 (Phi-3-mini), 160 (StableLM-2-12B) and 256
// (Gemma) for models whose decode steps the JAX package sends to the
// ragged kernel or to its jnp reference (its decode kernel takes 64 and
// 128 only; the port keeps one routing for every head_dim). At 80 a narrow
// tile is 640 16-byte copies, which the wide form's 256 threads take in
// two whole rounds and a third of threads 0-127 (attention_mma.cuh:
// TileCopies). At 160 the split form's ring and staged rows take 91392
// bytes with bf16 pages (two blocks an SM) and the wide form's 129024;
// O's 80 registers a thread leave room for the wide form's scores of a
// whole 64-key tile, so it takes each tile in one step, as up to 128.
//
// Bound on the H100: bytes. Each step reads every live K/V row once
// (2 * kv_len * D values per kv head) and does 4 * QG * D FLOPs per key,
// about QG operations per bf16 byte, far below the ~295 FLOP/byte ridge;
// on the tensor cores the products cost a few percent of the time the
// bytes take, and the split and the ring keep enough loads in flight on
// every SM (up to three blocks of two 16 or 32 KB stages each). What is
// left after the split: the page-gather reads themselves (16-byte loads,
// a 64-key tile = four pages), each split's prologue (its first tile is
// not overlapped) and, with more than one slot, the partials (about
// 4 * (D + 2) bytes per slot and query head, written and read once).
//
// Semantics (same as the plain version in ops/decode_attention.py):
//   out[s, h] = softmax_j(cap((q[s, h] . k[s, j]) * sm_scale)
//                         + slope[h] * (j - (kv_len - 1))
//                         + rel[h, min(kv_len - 1 - j, rel_len - 1)]) . v[s, j]
// over j in [kv_lo, kv_len), kv_lo = max(0, kv_len - window) with a window,
// kv head h / QG; the dot product of the bf16 values is summed in f32 and
// then scaled; the ALiBi term is there only when a slope table is given
// (f32[QH], global query head h), and is formed as the JAX kernel forms it:
// the slope times the f32 distance, rounded, then added, after the soft
// cap. The probabilities enter P . V as the sum of two bf16 parts (about
// 2^-17 of each; the second product costs nothing a byte-bound kernel
// notices). Rows with kv_len == 0
// are dead padding and get zeros. Nothing past kv_len is ever loaded: the
// shared-memory slots of such keys are zero-filled and their probabilities
// are exactly 0, so stale or NaN bytes in unwritten page slots cannot
// reach the output.
//
// T5's relative-position bias (the rel_bias option of the TPU kernel):
// the score of key j gains table[h, bucket(kv_len - 1 - j)], added after the
// ALiBi term's place and before the mask, as the JAX kernel adds it. The
// bucket of a distance is a logarithm, truncated, which the card would
// compute per column and might round otherwise than the host. So the
// wrapper gathers the table once a call into columns by distance,
// rel_bias f32[QH, rel_len] (column n = table[h, bucket(n)], for n up to the
// saturation distance rel_len - 1, the first whose bucket is the last; 114
// columns for T5's 32 buckets and max_distance 128), from a bucket-of-
// distance index the host computes once per (buckets, max_distance) with the
// plain version's f32 arithmetic, and each score reads its column through
// the read-only cache (__ldg: one table row is 456 bytes, and a block's rows
// stay in L1). The columns are not staged in shared memory: that would move
// every instantiation's layout (the D 256 one holds 143616 bytes for its one
// block an SM). The bias is a template flag, REL, of both kernel forms (the
// entry point takes it where the table pointer is not null): a runtime test
// of the pointer cost the instantiations without it registers and spills,
// and 7-29 % of their time at the main paths' decode shapes on an H100;
// with the flag they are the code they were. A table with ALiBi or
// blocksparse is refused.
//
// Blocksparse (Phi-3-Small's local + vertical-stride mask, blocksparse.cuh,
// the blocksparse option of the TPU kernel), with the query's block bq =
// (kv_len - 1) / bsz, ANDed with the window. It is a template flag, BS,
// so that the instantiations without it carry no test for it; the wrapper
// sends a layer whose gate is off to those. The QG heads share the K/V
// tiles but not their phases: each head masks its own dead keys
// (probability exactly 0), and a 64-key tile that no head of the kv head
// can see is skipped before it is loaded (at Phi-3-Small's block of 64 a
// tile is a block); that leaves every result
// unchanged. The TPU kernel skips a page only when no query head at all
// hits it; here the test is per kv head, so on Phi-3-Small (QG 4, vert 8,
// phases 0..31) half the 64-key blocks past the local window are never
// read.
//
// Page types: the kernel is a template over the cache's element type
// (kv_page_types.cuh), with one entry point each for bf16, E4M3, E5M2 and
// int8 pages. A narrow row is D bytes, not 2 D: the ring holds the raw
// bytes and one pass widens them into the same bf16 tiles the bf16 pages
// are copied into, so all that follows is the bf16 kernel's, and the
// result equals, bit for bit, the bf16 kernel's on those pages widened
// beforehand. The narrow variants read half the K/V bytes; their byte
// bound is half the bf16 one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "blocksparse.cuh"
#include "kv_page_types.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// The cp.async ring: two stages (on the H100, three or four stages, or a
// register cap for three blocks an SM, ran slower on bf16 pages).
constexpr int kStages = 2;
constexpr int kKeys = attn::kTileKeys;
constexpr int kWarpKeys = kKeys / kWarps;  // keys of each tile a warp takes
// The largest QH / KV the first kernel takes: the rows of one mma tile.
// Above it the wide kernel runs, eight warps of 16 rows each (the wrapper
// raises for a head_dim other than 64, 80, 96, 128, 160 and 256).
constexpr int kTileQG = 16;
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideRows = 16 * kWideWarps;  // query heads a wide block takes

// Dynamic shared memory: the ring (two stages; for narrow pages also the
// bf16 tiles they are widened into), reused after the last tile for the
// four warps' states (o [16, D], m [16], l [16] each). The 16 query rows
// are staged once at the start of the ring (read into registers before
// the first tile lands), or, at head_dim 160 and 256, where the warps read
// their Q fragments at every tile (attn::QFrags), after it: 5376 bytes
// more at 160 (91392 in all with bf16 pages, two blocks an SM), 8448 at
// 256 (143616, one block an SM).
template <class Page, int D>
struct DecodeSmem {
  static constexpr bool kNarrow = attn::Stage<Page, D>::kNarrow;
  static constexpr size_t wide = kNarrow ? 2 * attn::Tile<D>::kBytes : 0;
  static constexpr size_t stage = attn::Stage<Page, D>::kBytes;
  static constexpr size_t ring = wide + kStages * stage;
  static constexpr size_t q = attn::QFrags<D>::kHeld ? 0 : 16 * attn::Tile<D>::kStride * 2;
  static constexpr size_t merge = size_t(kWarps) * 16 * (D + 2) * 4;
  static constexpr size_t bytes = ring + q > merge ? ring + q : merge;
};

// The wide kernel's shared memory: the same ring, with its 128 query rows
// staged once at the start of it (two K/V tiles' bytes, read into
// registers before the first tile lands) or, at head_dim 160 and 256,
// after it (43008 bytes more at 160: 129024 in all with bf16 pages; 67584
// at 256: 202752). No merge region: each warp owns its rows' whole state.
template <class Page, int D>
struct WideSmem {
  static constexpr bool kNarrow = attn::Stage<Page, D>::kNarrow;
  static constexpr size_t wide = kNarrow ? 2 * attn::Tile<D>::kBytes : 0;
  static constexpr size_t stage = attn::Stage<Page, D>::kBytes;
  static constexpr size_t ring = wide + kStages * stage;
  static constexpr size_t rows = size_t(kWideRows) * attn::Tile<D>::kStride * 2;
  static constexpr size_t q = attn::QFrags<D>::kHeld ? 0 : rows;
  static constexpr size_t bytes = ring + q;
  static_assert(!attn::QFrags<D>::kHeld || rows <= ring, "the query rows fit in the ring");
};

// The first split at or after `first` that slot `slot` of `slots` takes
// (slot, slot + slots, ...).
__device__ __forceinline__ int first_split(int slot, int first, int slots) {
  return slot >= first ? slot : slot + (first - slot + slots - 1) / slots * slots;
}

// The column of a T5 bias row for a key `dist` = pos - key positions before
// the query: the distance itself up to the saturation distance rel_len - 1,
// whose bucket every longer distance shares (keys past kv_len, masked
// anyway, give a negative distance and read column 0).
__device__ __forceinline__ int rel_column(int dist, int rel_len) {
  return min(max(dist, 0), rel_len - 1);
}

template <class Page, int D, bool BS, bool REL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const unsigned char* __restrict__ kv,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ page_indices,
                    const float* __restrict__ alibi_slopes,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int num_kv_heads, int qg,
                    int page_size, int pages_per_seq, float sm_scale,
                    int sliding_window, float soft_cap, Blocksparse bs,
                    const float* __restrict__ rel_bias, int rel_len, int split_keys) {
  using L = DecodeSmem<Page, D>;
  constexpr int kStride = attn::Tile<D>::kStride;
  constexpr size_t kTileElems = attn::Tile<D>::kBytes / 2;  // one K or V tile

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stages = smem + L::wide;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(smem);
  // The 16 query rows, staged once, before the first split's loads.
  __nv_bfloat16* q_s =
      attn::QFrags<D>::kHeld ? wide : reinterpret_cast<__nv_bfloat16*>(smem + L::ring);
  float* o_s = reinterpret_cast<float*>(smem);  // the merge: [kWarps][16][D]
  float* m_s = o_s + kWarps * 16 * D;           // [kWarps][16]
  float* l_s = m_s + kWarps * 16;               // [kWarps][16]

  const int seq = blockIdx.x;
  const int kvh = blockIdx.y;
  const int num_seqs = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int num_q_heads = num_kv_heads * qg;
  const int ckv = 2 * num_kv_heads;

  const size_t head0 = size_t(seq) * num_q_heads + size_t(kvh) * qg;
  const int kv_len = min(kv_lens[seq], pages_per_seq * page_size);
  if (kv_len <= 0) {
    if (blockIdx.z == 0)
      for (int i = tid; i < qg * D; i += kThreads) out[head0 * D + i] = __float2bfloat16(0.f);
    return;
  }
  const int kv_lo = sliding_window > 0 ? max(0, kv_len - sliding_window) : 0;
  const int first = kv_lo / split_keys;  // the row's live splits: first..last
  const int last = (kv_len - 1) / split_keys;
  const int slots = gridDim.z;
  const bool direct = slots == 1 || first == last;  // one live slot: no partials
  const int split0 = first_split(blockIdx.z, first, slots);  // this block's first
  if (split0 > last) return;  // no live split here (the combine skips the slot)
  const int pos = kv_len - 1;  // the query token's position
  const int* pages = page_indices + size_t(seq) * pages_per_seq;
  // The 16 query rows: heads 0..qg-1 of the kv head, then zeros.
  for (int i = tid; i < 16 * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int part = i % (D / 8);
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < qg) raw = *reinterpret_cast<const uint4*>(q + (head0 + r) * D + part * 8);
    *reinterpret_cast<uint4*>(q_s + r * kStride + part * 8) = raw;
  }
  __syncthreads();
  attn::QFrags<D> qf;
  attn::load_q<D>(qf, q_s);

  // This lane's two rows (heads g and g + 8); with blocksparse, the
  // query's block, and whether each warp's 16 keys of a tile lie in one
  // key block.
  float slope[2] = {0.f, 0.f};
  int phase[2] = {0, 0};
  // With a T5 bias, each row's columns (rows past qg read head qg - 1's:
  // their scores are never written).
  const float* rb[2] = {nullptr, nullptr};
  const int bq = BS ? pos / bs.block : 0;
  const bool one_block = BS && bs.block % kWarpKeys == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = lane / 4 + 8 * r;
    if (h < qg && alibi_slopes != nullptr) slope[r] = __ldg(alibi_slopes + kvh * qg + h);
    if constexpr (REL) rb[r] = rel_bias + size_t(kvh * qg + min(h, qg - 1)) * rel_len;
    if constexpr (BS) {
      if (h < qg) phase[r] = __ldg(bs.offsets + kvh * qg + h);
    }
  }

  // The block takes its live splits split0, split0 + slots, ..., with one
  // online softmax (each warp's m, l, o) carried through all of them.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int split = split0; split <= last; split += slots) {
    const int k_begin = max(kv_lo, split * split_keys);
    const int k_end = min(kv_len, (split + 1) * split_keys);

    // The first tile at or after t with a key that some head may see:
    // every tile without blocksparse. With it, the test is against every
    // head's phase and is the same in every warp, so the whole block skips
    // a tile or none of it. When a tile lies in one key block (the block a
    // multiple of the tile), lane l tests the tile l tiles on, so one
    // ballot looks 32 tiles ahead; else lane l tests keys t + l and t + 32
    // + l.
    auto next_tile = [&](int t) {
      if constexpr (BS) {
        if (bs.block % kKeys == 0) {
          for (; t < k_end; t += 32 * kKeys) {
            const int mine = t + lane * kKeys;
            bool live = false;
            if (mine < k_end && mine + kKeys > k_begin) {
              for (int h = 0; h < qg; ++h)
                live = live || block_visible(bs, bq, mine / bs.block,
                                             __ldg(bs.offsets + kvh * qg + h));
            }
            const unsigned hits = __ballot_sync(0xffffffffu, live);
            if (hits != 0u) return t + (__ffs(hits) - 1) * kKeys;
          }
          return t;
        }
        for (; t < k_end; t += kKeys) {
          bool live = false;
          for (int k = t + lane; k < t + kKeys; k += 32) {
            if (k < k_begin || k >= k_end) continue;
            for (int h = 0; h < qg; ++h)
              live = live ||
                     block_visible(bs, bq, k / bs.block, __ldg(bs.offsets + kvh * qg + h));
          }
          if (__any_sync(0xffffffffu, live)) break;
        }
      }
      return t;
    };

    // Every warp is done with the query rows, or with the previous split's
    // merge: the ring is free.
    __syncthreads();
    // The ring: the first kStages - 1 tiles now, then one a tile.
    int tile = next_tile(k_begin / kKeys * kKeys);  // the next tile to use
    int ahead = tile;                                // the next tile to load
    for (int st = 0; st < kStages - 1; ++st) {
      if (ahead < k_end) {
        attn::issue_tile<Page, D, kThreads>(stages + st * L::stage, kv, pages, page_size,
                                            ckv, kvh, ahead, k_begin, k_end);
        ahead = next_tile(ahead + kKeys);
      }
      attn::cp_async_commit();
    }

    for (int it = 0; tile < k_end; ++it) {
      const int cur = tile;
      tile = next_tile(cur + kKeys);
      // Tile `cur` has landed, and every warp is done with the previous
      // one: its stage is free for the tile kStages - 1 ahead.
      attn::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (ahead < k_end) {
        attn::issue_tile<Page, D, kThreads>(
            stages + ((it + kStages - 1) % kStages) * L::stage, kv, pages, page_size, ckv,
            kvh, ahead, k_begin, k_end);
        ahead = next_tile(ahead + kKeys);
      }
      attn::cp_async_commit();
      const __nv_bfloat16* k_t;
      if constexpr (L::kNarrow) {
        attn::widen_tile<Page, D, kThreads>(wide, stages + (it % kStages) * L::stage);
        __syncthreads();
        k_t = wide;
      } else {
        k_t = reinterpret_cast<const __nv_bfloat16*>(stages + (it % kStages) * L::stage);
      }
      const int kb = cur + warp * kWarpKeys;  // this warp's first key
      if (kb >= k_end || kb + kWarpKeys <= k_begin) continue;

      float s[kWarpKeys / 8][4];
      attn::qk<D, kWarpKeys / 8>(s, qf, k_t + warp * kWarpKeys * kStride);
      // Blocksparse: when the warp's 16 keys lie in one key block, a row
      // sees all of them or none (one test a row), else the test is one a
      // key.
      bool vis[2] = {true, true};
      if constexpr (BS) {
        if (one_block) {
          vis[0] = block_visible(bs, bq, kb / bs.block, phase[0]);
          vis[1] = block_visible(bs, bq, kb / bs.block, phase[1]);
        }
      }
      const bool edge = kb < k_begin || kb + kWarpKeys > k_end || (BS && !one_block);
#pragma unroll
      for (int nb = 0; nb < kWarpKeys / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const int key = kb + nb * 8 + 2 * (lane % 4) + e % 2;
          float v = s[nb][e] * sm_scale;
          if (soft_cap > 0.f) v = soft_cap * tanhf(v / soft_cap);
          if (alibi_slopes != nullptr)
            v = __fadd_rn(v, __fmul_rn(slope[r], float(key - pos)));
          if constexpr (REL) v = __fadd_rn(v, __ldg(rb[r] + rel_column(pos - key, rel_len)));
          if (edge) {
            bool valid = key >= k_begin && key < k_end;
            if constexpr (BS) {
              if (!one_block) valid = valid && block_visible(bs, bq, key / bs.block, phase[r]);
            }
            if (!valid) v = -INFINITY;
          }
          if constexpr (BS) {
            if (!vis[r]) v = -INFINITY;
          }
          s[nb][e] = v;
        }
      }
      attn::softmax_step<D, kWarpKeys / 8>(s, m, l, o);
      attn::pv<D, kWarpKeys / 8>(o, s, k_t + kTileElems + warp * kWarpKeys * kStride);
    }
  }
  attn::finish_sums(l);

  // Merge the four warps' states (in warp order) in the freed ring; then
  // the output, or this slot's partial.
  attn::cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + lane / 4 + 8 * r;
    if (lane % 4 == 0) {
      m_s[row] = m[r];
      l_s[row] = l[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o_s + row * D + j * 8 + 2 * (lane % 4)) =
          make_float2(o[j][2 * r], o[j][2 * r + 1]);
  }
  __syncthreads();
  const size_t part0 = size_t(blockIdx.z) * num_seqs * num_q_heads + head0;  // head 0's partial
  for (int i = tid; i < qg * D; i += kThreads) {
    const int h = i / D;
    const int d = i % D;
    float m_max = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_max = fmaxf(m_max, m_s[w * 16 + h]);
    float acc = 0.f;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_s[w * 16 + h];
      if (mw == -INFINITY) continue;  // this warp's keys: none visible
      const float c = mw == m_max ? 1.f : __expf(mw - m_max);
      acc += c * o_s[(w * 16 + h) * D + d];
      sum += c * l_s[w * 16 + h];
    }
    if (direct) {
      out[(head0 + h) * D + d] = __float2bfloat16(sum > 0.f ? acc / sum : 0.f);
    } else {
      part_acc[(part0 + h) * D + d] = acc;
      if (d == 0) {
        part_ml[2 * (part0 + h)] = m_max;
        part_ml[2 * (part0 + h) + 1] = sum;
      }
    }
  }
}

// QG above 16: the block of (sequence, kv head and head group, slot)
// takes query heads h0 .. h0 + rows - 1 of its kv head (h0 = 128 times
// the group), warp w the 16 of them from h0 + 16 w; every warp takes all
// keys of every staged tile (at head_dim 256 in two 32-key steps, so that
// the scores take 16 registers beside O's 128, as in the ragged kernel; at
// 160, beside O's 80, in one 64-key step).
// The splits, the ring, the scores and masks, the direct output and the
// partials are those of paged_decode_kernel above.
template <class Page, int D, bool REL>
__global__ void __launch_bounds__(kWideThreads)
paged_decode_wide_kernel(const __nv_bfloat16* __restrict__ q,
                         const unsigned char* __restrict__ kv,
                         const int* __restrict__ kv_lens,
                         const int* __restrict__ page_indices,
                         const float* __restrict__ alibi_slopes,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int num_kv_heads, int qg,
                         int head_groups, int page_size, int pages_per_seq, float sm_scale,
                         int sliding_window, float soft_cap, const float* __restrict__ rel_bias,
                         int rel_len, int split_keys) {
  using L = WideSmem<Page, D>;
  constexpr int kStride = attn::Tile<D>::kStride;
  constexpr size_t kTileElems = attn::Tile<D>::kBytes / 2;  // one K or V tile
  constexpr int kSub = D == 256 ? 32 : kKeys;                // keys of one step

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stages = smem + L::wide;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(smem);
  // The query rows: at the start of the ring (read into registers before
  // the first tile is issued), or after it at head_dim 160 and 256.
  __nv_bfloat16* q_s =
      attn::QFrags<D>::kHeld ? wide : reinterpret_cast<__nv_bfloat16*>(smem + L::ring);

  const int seq = blockIdx.x;
  const int kvh = blockIdx.y / head_groups;
  const int h0 = (blockIdx.y % head_groups) * kWideRows;  // first head, of the kv head's
  const int rows = min(kWideRows, qg - h0);               // live query heads of the block
  const int num_seqs = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int num_q_heads = num_kv_heads * qg;
  const int ckv = 2 * num_kv_heads;

  const size_t head0 = size_t(seq) * num_q_heads + size_t(kvh) * qg + h0;
  const int kv_len = min(kv_lens[seq], pages_per_seq * page_size);
  if (kv_len <= 0) {
    if (blockIdx.z == 0)
      for (int i = tid; i < rows * D; i += kWideThreads) out[head0 * D + i] = __float2bfloat16(0.f);
    return;
  }
  const int kv_lo = sliding_window > 0 ? max(0, kv_len - sliding_window) : 0;
  const int first = kv_lo / split_keys;
  const int last = (kv_len - 1) / split_keys;
  const int slots = gridDim.z;
  const bool direct = slots == 1 || first == last;
  const int split0 = first_split(blockIdx.z, first, slots);
  if (split0 > last) return;
  const int pos = kv_len - 1;
  const int* pages = page_indices + size_t(seq) * pages_per_seq;
  // The block's query rows: heads h0 .. h0 + rows - 1, then zeros.
  for (int i = tid; i < kWideRows * (D / 8); i += kWideThreads) {
    const int r = i / (D / 8);
    const int part = i % (D / 8);
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) raw = *reinterpret_cast<const uint4*>(q + (head0 + r) * D + part * 8);
    *reinterpret_cast<uint4*>(q_s + r * kStride + part * 8) = raw;
  }
  __syncthreads();
  attn::QFrags<D> qf;
  attn::load_q<D>(qf, q_s + warp * 16 * kStride);
  const bool warp_live = warp * 16 < rows;

  // This lane's two rows: heads warp * 16 + g and + 8 of the block's.
  float slope[2] = {0.f, 0.f};
  const float* rb[2] = {nullptr, nullptr};  // each row's T5 columns, as above
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = warp * 16 + lane / 4 + 8 * r;
    if (h < rows && alibi_slopes != nullptr)
      slope[r] = __ldg(alibi_slopes + size_t(kvh) * qg + h0 + h);
    if constexpr (REL)
      rb[r] = rel_bias + (size_t(kvh) * qg + h0 + min(h, max(rows - 1, 0))) * rel_len;
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int split = split0; split <= last; split += slots) {
    const int k_begin = max(kv_lo, split * split_keys);
    const int k_end = min(kv_len, (split + 1) * split_keys);
    // Every warp is done with the query rows, or with the previous split's
    // last tile: the ring is free.
    __syncthreads();
    int tile = k_begin / kKeys * kKeys;  // the next tile to use
    int ahead = tile;                    // the next tile to load
    for (int st = 0; st < kStages - 1; ++st) {
      if (ahead < k_end) {
        attn::issue_tile<Page, D, kWideThreads>(stages + st * L::stage, kv, pages, page_size,
                                                ckv, kvh, ahead, k_begin, k_end);
        ahead += kKeys;
      }
      attn::cp_async_commit();
    }
    for (int it = 0; tile < k_end; ++it) {
      const int cur = tile;
      tile += kKeys;
      // Tile `cur` has landed, and every warp is done with the previous
      // one: its stage is free for the tile kStages - 1 ahead.
      attn::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (ahead < k_end) {
        attn::issue_tile<Page, D, kWideThreads>(
            stages + ((it + kStages - 1) % kStages) * L::stage, kv, pages, page_size, ckv,
            kvh, ahead, k_begin, k_end);
        ahead += kKeys;
      }
      attn::cp_async_commit();
      const __nv_bfloat16* k_t;
      if constexpr (L::kNarrow) {
        attn::widen_tile<Page, D, kWideThreads>(wide, stages + (it % kStages) * L::stage);
        __syncthreads();
        k_t = wide;
      } else {
        k_t = reinterpret_cast<const __nv_bfloat16*>(stages + (it % kStages) * L::stage);
      }
      if (!warp_live) continue;
#pragma unroll
      for (int sub = 0; sub < kKeys; sub += kSub) {
        const int c0 = cur + sub;  // the step's first key
        if (c0 >= k_end || c0 + kSub <= k_begin) continue;
        float s[kSub / 8][4];
        attn::qk<D, kSub / 8>(s, qf, k_t + sub * kStride);
        const bool edge = c0 < k_begin || c0 + kSub > k_end;
#pragma unroll
        for (int nb = 0; nb < kSub / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2;
            const int key = c0 + nb * 8 + 2 * (lane % 4) + e % 2;
            float v = s[nb][e] * sm_scale;
            if (soft_cap > 0.f) v = soft_cap * tanhf(v / soft_cap);
            if (alibi_slopes != nullptr)
              v = __fadd_rn(v, __fmul_rn(slope[r], float(key - pos)));
            if constexpr (REL)
              v = __fadd_rn(v, __ldg(rb[r] + rel_column(pos - key, rel_len)));
            if (edge && (key < k_begin || key >= k_end)) v = -INFINITY;
            s[nb][e] = v;
          }
        }
        attn::softmax_step<D, kSub / 8>(s, m, l, o);
        attn::pv<D, kSub / 8>(o, s, k_t + kTileElems + sub * kStride);
      }
    }
  }
  attn::finish_sums(l);
  attn::cp_async_wait_all();
  if (!warp_live) return;
  // The output, or this slot's partial (the unnormalised acc, m and l of
  // each row).
  const size_t part0 = size_t(blockIdx.z) * num_seqs * num_q_heads + head0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = warp * 16 + lane / 4 + 8 * r;
    if (h >= rows) continue;
    if (direct) {
      __nv_bfloat16* dst = out + (head0 + h) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float a = l[r] > 0.f ? o[j][2 * r] / l[r] : 0.f;
        const float b = l[r] > 0.f ? o[j][2 * r + 1] / l[r] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(a, b);
      }
    } else {
      float* dst = part_acc + (part0 + h) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (lane % 4 == 0) {
        part_ml[2 * (part0 + h)] = m[r];
        part_ml[2 * (part0 + h) + 1] = l[r];
      }
    }
  }
}

// The second pass: one block per (sequence, query head), one thread per
// dimension, merging the live slots of the rows whose keys more than one
// slot took, in slot order (a slot whose keys were all masked, m = -inf,
// weighs nothing).
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml, const int* __restrict__ kv_lens,
                            __nv_bfloat16* __restrict__ out, int page_size, int pages_per_seq,
                            int sliding_window, int split_keys, int slots) {
  const int seq = blockIdx.x;
  const int num_seqs = gridDim.x;
  const int head = blockIdx.y;
  const int num_q_heads = gridDim.y;
  const int d = threadIdx.x;
  const int kv_len = min(kv_lens[seq], pages_per_seq * page_size);
  if (kv_len <= 0) return;
  const int kv_lo = sliding_window > 0 ? max(0, kv_len - sliding_window) : 0;
  const int first = kv_lo / split_keys;
  const int last = (kv_len - 1) / split_keys;
  if (first == last) return;  // written by its one slot
  const size_t stride = size_t(num_seqs) * num_q_heads;
  const size_t p0 = size_t(seq) * num_q_heads + head;
  float m_max = -INFINITY;
  for (int z = 0; z < slots; ++z)
    if (first_split(z, first, slots) <= last)
      m_max = fmaxf(m_max, part_ml[2 * (z * stride + p0)]);
  float acc = 0.f;
  float sum = 0.f;
  for (int z = 0; z < slots; ++z) {
    if (first_split(z, first, slots) > last) continue;
    const size_t p = z * stride + p0;
    const float mi = part_ml[2 * p];
    if (mi == -INFINITY) continue;
    const float c = mi == m_max ? 1.f : __expf(mi - m_max);
    acc += c * part_acc[p * D + d];
    sum += c * part_ml[2 * p + 1];
  }
  out[p0 * D + d] = __float2bfloat16(sum > 0.f ? acc / sum : 0.f);
}

template <class Page, int D, bool BS, bool REL>
cudaError_t launch(const void* q, const void* kv, const int* kv_lens, const int* page_indices,
                   const float* alibi_slopes, void* out, float* part_acc, float* part_ml,
                   int num_seqs, int num_kv_heads, int qg, int page_size, int pages_per_seq,
                   float sm_scale, int sliding_window, float soft_cap, Blocksparse bs,
                   const float* rel_bias, int rel_len, int split_keys, int num_slots,
                   cudaStream_t stream) {
  using L = DecodeSmem<Page, D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<Page, D, BS, REL>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 int(L::bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (qg <= kTileQG) {
    const dim3 grid(num_seqs, num_kv_heads, num_slots);
    paged_decode_kernel<Page, D, BS, REL><<<grid, kThreads, L::bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const unsigned char*>(kv), kv_lens,
        page_indices, alibi_slopes, o, part_acc, part_ml, num_kv_heads, qg, page_size,
        pages_per_seq, sm_scale, sliding_window, soft_cap, bs, rel_bias, rel_len, split_keys);
  } else {
    using W = WideSmem<Page, D>;
    static bool wide_configured = false;
    if (!wide_configured) {
      const cudaError_t err = cudaFuncSetAttribute(paged_decode_wide_kernel<Page, D, REL>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   int(W::bytes));
      if (err != cudaSuccess) return err;
      wide_configured = true;
    }
    const int head_groups = (qg + kWideRows - 1) / kWideRows;
    const dim3 grid(num_seqs, num_kv_heads * head_groups, num_slots);
    paged_decode_wide_kernel<Page, D, REL><<<grid, kWideThreads, W::bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const unsigned char*>(kv), kv_lens,
        page_indices, alibi_slopes, o, part_acc, part_ml, num_kv_heads, qg, head_groups,
        page_size, pages_per_seq, sm_scale, sliding_window, soft_cap, rel_bias, rel_len,
        split_keys);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_slots == 1) return err;
  paged_decode_combine_kernel<D><<<dim3(num_seqs, num_kv_heads * qg), D, 0, stream>>>(
      part_acc, part_ml, kv_lens, o, page_size, pages_per_seq, sliding_window, split_keys,
      num_slots);
  return cudaGetLastError();
}

// Checks the shape and launches the variant for pages of type Page,
// head_dim 64, 80, 96, 128, 160 or 256, QG = num_q_heads / num_kv_heads query
// heads per kv head (any; above 16 the wide kernel) and blocksparse (a
// phase table given; head_dim 128 and QG 1, 2, 4 or 8 only: the shapes
// blocksparse is built for) or not; with T5's bias (REL: a table given)
// or without.
template <class Page, bool REL>
int run(const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,
        const void* alibi_slopes, void* out, void* part_acc, void* part_ml, int num_seqs,
        int num_q_heads, int num_kv_heads, int head_dim, int page_size, int pages_per_seq,
        float sm_scale, int sliding_window, float soft_cap, const void* bs_offsets,
        int bs_block, int bs_local, int bs_vert, const void* rel_bias, int rel_len,
        int split_keys, int num_slots, void* stream) {
  if (num_seqs <= 0) return int(cudaSuccess);
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0) return int(cudaErrorInvalidValue);
  const int qg = num_q_heads / num_kv_heads;
  if (qg < 1) return int(cudaErrorInvalidValue);
  // Splits of whole tiles, and a scratch for the partials whenever there is
  // more than one slot.
  if (split_keys <= 0 || split_keys % kKeys != 0 || num_slots <= 0 ||
      (num_slots > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return int(cudaErrorInvalidValue);
  const Blocksparse bs{static_cast<const int*>(bs_offsets), bs_block, bs_local, bs_vert};
  if (bs.offsets != nullptr &&
      (bs_block <= 0 || bs_local <= 0 || bs_vert <= 0 || head_dim != 128 ||
       (qg != 1 && qg != 2 && qg != 4 && qg != 8)))
    return int(cudaErrorInvalidValue);
  // A T5 bias takes neither ALiBi nor blocksparse beside it, and only the
  // entry points with it take one.
  if (REL != (rel_bias != nullptr) ||
      (REL && (rel_len <= 0 || alibi_slopes != nullptr || bs.offsets != nullptr)))
    return int(cudaErrorInvalidValue);
  const float* rb = static_cast<const float*>(rel_bias);
  const int* lens = static_cast<const int*>(kv_lens);
  const int* pages = static_cast<const int*>(page_indices);
  const float* slopes = static_cast<const float*>(alibi_slopes);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_DECODE_LAUNCH(d, b, r)                                                        \
  launch<Page, d, b, r>(q, kv_pages, lens, pages, slopes, out, acc, ml, num_seqs, num_kv_heads, \
                     qg, page_size, pages_per_seq, sm_scale, sliding_window, soft_cap, bs,   \
                     rb, rel_len, split_keys, num_slots, s)
  switch (head_dim) {
    case 64:
      return int(PAGED_DECODE_LAUNCH(64, false, REL));
    case 80:
      return int(PAGED_DECODE_LAUNCH(80, false, REL));
    case 96:
      return int(PAGED_DECODE_LAUNCH(96, false, REL));
    case 160:
      return int(PAGED_DECODE_LAUNCH(160, false, REL));
    case 256:
      return int(PAGED_DECODE_LAUNCH(256, false, REL));
    case 128:
      if constexpr (REL) return int(PAGED_DECODE_LAUNCH(128, false, true));
      else
        return int(bs.offsets != nullptr ? PAGED_DECODE_LAUNCH(128, true, false)
                                         : PAGED_DECODE_LAUNCH(128, false, false));
    default:
      return int(cudaErrorInvalidValue);
  }
#undef PAGED_DECODE_LAUNCH
}

}  // namespace

// One entry point per page type: paged_decode_attention_{bf16, e4m3, e5m2,
// int8} (paged_decode_attention.cu) and, with T5's bias,
// paged_decode_attention_rel_{bf16, ...} (paged_decode_attention_rel.cu).
// q bf16[S, QH, D] with D = 64, 80, 96, 128, 160 or 256 and QH = QG * KV for any
// QG (blocksparse: D = 128, QG in {1, 2, 4, 8}), kv_pages [P, page_size,
// 2 * KV, D] of the named type (K at even and V at odd combined heads),
// kv_lens i32[S], page_indices i32[S, pages_per_seq], alibi_slopes f32[QH]
// or null (no ALiBi), out bf16[S, QH, D]. sliding_window <= 0 and soft_cap
// <= 0 mean off. bs_offsets i32[QH] (each query head's vertical phase) with
// bs_block, bs_local and bs_vert turns blocksparse on; null means off (the
// others are then unread). rel_bias f32[QH, rel_len] (T5's bias by
// distance, column n for distance n, the last column for every longer one)
// turns the T5 bias on, without ALiBi or blocksparse (the _rel entry
// points take a table and nothing else; the others take none).
// split_keys (a multiple of 64) keys a split,
// num_slots blocks per (sequence, kv head; for QG above 128, per kv head
// and group of 128 query heads) taking the splits in turn; with
// more than one slot, part_acc f32[num_slots, S, QH, D] and part_ml
// f32[num_slots, S, QH, 2] are the scratch of the partials (else they may
// be null).
// Launches the split kernel and, with more than one slot, the combine
// kernel on `stream`. Returns the CUDA error of the launches
// (cudaErrorInvalidValue for any other D, QH not a multiple of KV, blocksparse parameters
// that are not positive or at a shape it is not built for, a T5 bias with
// ALiBi or blocksparse or without columns, a table given to an entry point
// without the bias or none to one with it, a split that is not whole
// tiles, or no scratch where one is needed).
#define PAGED_DECODE_ENTRY(name, Page, rel)                                                  \
  extern "C" int name(                                                                       \
      const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,    \
      const void* alibi_slopes, void* out, void* part_acc, void* part_ml, int num_seqs,      \
      int num_q_heads, int num_kv_heads, int head_dim, int page_size, int pages_per_seq,     \
      float sm_scale, int sliding_window, float soft_cap, const void* bs_offsets,            \
      int bs_block, int bs_local, int bs_vert, const void* rel_bias, int rel_len,            \
      int split_keys, int num_slots, void* stream) {                                         \
    return run<Page, rel>(q, kv_pages, kv_lens, page_indices, alibi_slopes, out, part_acc,   \
                          part_ml, num_seqs, num_q_heads, num_kv_heads, head_dim, page_size, \
                          pages_per_seq, sm_scale, sliding_window, soft_cap, bs_offsets,     \
                          bs_block, bs_local, bs_vert, rel_bias, rel_len, split_keys,        \
                          num_slots, stream);                                                \
  }
