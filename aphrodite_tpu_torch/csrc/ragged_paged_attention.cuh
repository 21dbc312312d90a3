// Ragged paged attention (prefill chunks and decode tokens in one flat
// token stream) for Hopper, sm_90a.
//
// Replaces the TPU kernel behind aphrodite_tpu/ops/attention.py:
// _kernel_attention, the Pallas ragged_paged_attention bundled with JAX
// (and the base semantics of its vendored fork
// aphrodite_tpu/ops/rpa_alibi_kernel.py: ragged_paged_attention_alibi).
//
// Work split: one block per (query tile, kv head). The query rows of a
// sequence and kv head are its (token, query head) pairs, flattened token
// by token: row f is token f / QG and query head f % QG of the QG = QH /
// KV heads that share the kv head. A query tile holds kRows consecutive
// rows of that order (128 at head_dim 80, 96, 128, 160 and 256, 8 warps; 64
// at head_dim 64, 4 warps; 32 at head_dim 384, 6 warps, three a 16-row
// group: RaggedShape) of ONE sequence, so a tile never straddles two
// sequences and every K/V tile it stages serves all of its rows; each
// row carries its own token position for the causal mask, the window and
// the ALiBi distance. Only a sequence's last tile has idle rows. Where QG
// divides kRows a tile is kRows / QG whole tokens; where it does not, a
// tile may begin and end inside a token's heads; and at QG above kRows
// (Falcon-7B's 71 on one kv head, head_dim 64) a token's heads fill more
// than one tile.
// The tiles are taken from the end of the token stream, so that within a
// sequence the tiles that see the most keys start first. QG is a template
// parameter, instantiated at head_dim 128 for 1, 2, 4 and 8, and 0, which
// reads QG at run time and serves every other QG, and every QG at head_dim
// 64, 80, 96, 160, 256 and 384. head_dim D (64, 80, 96, 128, 160, 256 or
// 384) is a template parameter too. So are ALiBi and blocksparse, so that
// the variant without either
// carries no per-score branch for them. ALiBi reads each row's slope by
// its query head, at every D and QG (the fixed instantiations at D 128,
// and the runtime one elsewhere). Blocksparse is built for D 128 and QG
// 1, 2, 4 and 8 only, the shapes of the model that uses it (its per-tile
// skip tests every head's phase from a table of QG entries). The plain variants are built from
// ragged_paged_attention.cu, those with ALiBi from
// ragged_paged_attention_alibi.cu and those with blocksparse from
// ragged_paged_attention_blocksparse.cu, and the plain ones at head_dim 384
// (neither option) from ragged_paged_attention_d384.cu: four libraries
// that nvcc builds in parallel (no model has both options; the wrapper
// raises for the pair). Each block finds its (sequence, first token) by walking
// cu_q_lens on the device: the grid is an upper bound on the tile count
// (ceil(T / tokens) + S) and surplus blocks exit, so the launch needs no
// host-side value and no synchronisation.
//
// Bound on the H100: at prefill shapes, operations (4 * D FLOPs per
// visible (query head, key) pair against 4 * D bytes of K/V per key and kv
// head: 64 FLOPs a byte at QG 4, above the memory ridge only for long
// chunks). The design, FlashAttention-2 style (attention_mma.cuh):
// - both products on the tensor cores, mma.sync m16n8k16 bf16 with f32
//   sums: each warp owns 16 query rows, holds their Q fragments in
//   registers (one ldmatrix per 16 dimensions, loaded once; at head_dim
//   160, 256 and 384, where O alone takes 80, 128 and 192 registers a
//   thread, it reads them from the staged rows at each k16 step instead,
//   at 256 takes each tile in two 32-key steps, and at 384 splits O's
//   columns over three warps), reads K through ldmatrix and V
//   through ldmatrix.trans,
//   and hands P from the S accumulator to the A fragments of P . V in
//   registers;
// - bf16 K/V tiles of 64 keys (four 16-key pages) in shared memory at a
//   padded stride (no bank conflicts for ldmatrix), in a three-stage
//   cp.async ring: tiles i + 1 and i + 2 load while tile i is multiplied,
//   behind one barrier a tile (two stages at head_dim 256 and 384, for
//   room).
//   Narrow pages (E4M3, E5M2, int8) are copied raw into a byte stage and
//   widened to bf16 in one pass before the products;
// - the online softmax in registers (row max and sum across the four
//   lanes of a quad);
// - masks only on the tiles that straddle an edge of a warp's rows
//   (causal, window, kv_len): interior tiles skip the tests, and a warp
//   skips the products of a tile that none of its rows can see;
// - it visits only the keys the tile can see: [max(0, first_row_pos -
//   window + 1), min(kv_len, last_row_pos + 1)), in 64-key tiles aligned
//   to key 0 (keys of an edge tile outside that range are zero-filled,
//   never read).
// mma.sync rather than wgmma: see attention_mma.cuh.
//
// Semantics (same as the plain version in ops/attention.py): row i of
// sequence s sits at absolute position p = kv_len - q_len + i and attends
// keys j with j <= p, j < kv_len and, with a window w, j > p - w, with
// scores cap((q . k) * sm_scale) (the product of the bf16 values summed in
// f32, then scaled in f32), plus, with a slope table (f32[QH], the ALiBi
// option of the vendored fork aphrodite_tpu/ops/rpa_alibi_kernel.py),
// slope[h] * (j - p): the slope times the f32 distance, rounded, then added
// after the soft cap, as the fork does. The probabilities enter P . V as
// the sum of two bf16 parts (about 2^-17 of each, where one bf16 P errs by
// about 2^-9 of a row; PERF.md has what the second product costs); their
// sum is taken in f32. With
// blocksparse (the fork's blocksparse option, the mask of blocksparse.cuh)
// each row also masks, with its own block p / bsz and its head's phase, the
// keys that mask hides, as the fork does (which masks only and loads every
// page). Here a 64-key tile that no row and head of the query tile can see
// is skipped before it is staged (at Phi-3-Small's block of 64 a tile is a
// block); that leaves every result unchanged, bit for bit, since such a
// tile adds probability 0 and rescales by exactly 1. Nothing at or past
// kv_len is loaded; such slots are zero-filled and get probability exactly
// 0. Tokens past cu_q_lens[S] are not written here: the caller zero-fills
// the output.
//
// Page types: the kernel is a template over the cache's element type
// (kv_page_types.cuh), with one entry point each for bf16, E4M3, E5M2 and
// int8 pages. With fp8 pages it stands for the fp8 path of the vendored
// fork (the JAX package sends fp8 prefill there for its fast fp8 -> bf16
// conversion), with int8 pages for the bundled kernel. A narrow row is D
// bytes; the widening pass writes the same bf16 tiles the bf16 pages are
// copied into, so all that follows is the same code and the result equals,
// bit for bit, the bf16 entry point's on those pages widened beforehand.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "blocksparse.cuh"
#include "kv_page_types.cuh"

namespace {

// Warps a block: 8 at head_dim 80, 96, 128, 160 and 256 (128 query rows share
// each K/V tile), 4 at head_dim 64 (on the H100 a block of 8 ran slower
// there: at Qwen2.5-0.5B's two kv heads it leaves too few blocks for 132
// SMs). Each warp owns 16 query rows. At 80 (Phi-2, Pythia-2.8B,
// StableLM-3B: 32 kv heads, so blocks enough at 128 rows) a bf16 stage is
// 22528 bytes, 67584 for the ring (53248 narrow), and the 128 query rows
// fit in one stage as at 96; a narrow tile's 640 copies take two whole
// rounds of the 256 threads and a third of threads 0-127 (attention_mma.cuh:
// TileCopies).
// Stages of the cp.async ring: three, but two at head_dim 256, where a
// bf16 stage (K and V, 64 keys at a stride of 264) is 67584 bytes and the
// query rows stay staged beside the ring (attn::QFrags): 2 x 67584 + 67584
// = 202752 of the 232448 bytes a block may have. At 160 (StableLM-2-12B:
// 8 kv heads) the query rows stay staged beside the ring too, and three
// stages fit: a bf16 stage at a stride of 168 is 43008 bytes, 3 x 43008 +
// 43008 = 172032 (one block an SM, as at 256; narrow pages 147456).
// Keys of one Q . K^T and P . V step: the whole 64-key tile, but two
// halves of 32 at head_dim 256, so that S takes 16 registers a thread
// beside O's 128 (D / 8 fragments of four). At 160, O's 80 registers leave
// room for S's 32 of the whole tile.
// At head_dim 384 (MiniCPM3's latent cache: 256 + 32 padded to 384) a
// warp's O for 16 rows would be 192 registers a thread, so O is split by
// columns: each 16-row group of the tile is served by kColWarps = 3 warps,
// warp c of a group owning O's columns [128 c, 128 c + 128) (64
// registers). Each of the three computes the group's whole S from the
// staged query rows and runs the same online softmax (the same
// instructions on the same values: bit-equal maxima and sums), and takes
// P . V for its own columns only: 5/3 of the tensor-core work of one
// owner, and no exchange through shared memory. Two row groups (32 rows, 6
// warps) a block: a bf16 stage of 64 keys at a stride of 392 is 100352
// bytes, 2 x 100352 + 32 staged rows (25088) = 225792 of the 232448 bytes
// a block may have (narrow pages: 100352 widened + 2 x 49152 raw + 25088 =
// 223744); whole 64-key steps (S's 32 registers beside O's 64).
template <int D>
struct RaggedShape {
  static constexpr int kColWarps = D == 384 ? 3 : 1;  // warps a row group
  static constexpr int kRowGroups = D == 64 ? 4 : D == 384 ? 2 : 8;
  static constexpr int kWarps = kRowGroups * kColWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kRowGroups;  // query rows per block
  static constexpr int kOCols = D / kColWarps;   // O's columns a warp
  static constexpr int kStages = D == 256 || D == 384 ? 2 : 3;
  static constexpr int kSubKeys = D == 256 ? 32 : attn::kTileKeys;
};
constexpr int kKeys = attn::kTileKeys;

// Dynamic shared memory: the stages of the ring (bf16 pages: the padded K
// and V tiles; narrow pages: raw bytes) and, for narrow pages, the one pair
// of bf16 tiles they are widened into. The query rows (kRows of them at
// the tiles' stride: the size of one K and V pair) are staged once, before
// the loop, in the last stage, which the loop fills first (narrow pages:
// in the widened pair); at head_dim 160, 256 and 384, where they are read at
// every tile, in a region of their own after the ring.
template <class Page, int D>
struct RaggedSmem {
  static constexpr bool kNarrow = attn::Stage<Page, D>::kNarrow;
  static constexpr size_t wide = kNarrow ? 2 * attn::Tile<D>::kBytes : 0;
  static constexpr size_t stage = attn::Stage<Page, D>::kBytes;
  static constexpr size_t ring = wide + RaggedShape<D>::kStages * stage;
  static constexpr size_t q =
      attn::QFrags<D>::kHeld ? 0 : size_t(RaggedShape<D>::kRows) * attn::Tile<D>::kStride * 2;
  static constexpr size_t bytes = ring + q;
};

// QG: QH / KV, or 0 for the variant that reads it from qg_rt.
template <class Page, int D, int QG, bool ALIBI, bool BLOCKSPARSE>
__global__ void __launch_bounds__(RaggedShape<D>::kThreads)
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
  static_assert(QG > 0 || !BLOCKSPARSE, "blocksparse is built for a fixed QG");
  using L = RaggedSmem<Page, D>;
  constexpr int kThreads = RaggedShape<D>::kThreads;
  constexpr int kRows = RaggedShape<D>::kRows;
  constexpr int kStages = RaggedShape<D>::kStages;
  constexpr int kSub = RaggedShape<D>::kSubKeys;
  constexpr int kStride = attn::Tile<D>::kStride;
  constexpr size_t kTileElems = attn::Tile<D>::kBytes / 2;  // one K or V tile
  constexpr int kColWarps = RaggedShape<D>::kColWarps;
  constexpr int kOCols = RaggedShape<D>::kOCols;
  const int qg = QG > 0 ? QG : qg_rt;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stages = smem + L::wide;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(smem);
  // The query rows: in their own region (head_dim 160, 256, 384), in the widened
  // pair, or in the last stage (the first that the loop fills).
  __nv_bfloat16* q_s =
      !attn::QFrags<D>::kHeld ? reinterpret_cast<__nv_bfloat16*>(smem + L::ring)
      : L::kNarrow            ? wide
                              : reinterpret_cast<__nv_bfloat16*>(stages + (kStages - 1) * L::stage);

  // Which sequence and which tile of its rows is this block's? Blocks
  // start in the order of blockIdx.x, and a sequence's last tiles see the
  // most keys, so the tiles are taken from the end: the longest start
  // first and the short ones fill the last wave (surplus blocks, past the
  // last tile, start and exit first).
  int seq = -1;
  int tile_f0 = 0;  // the tile's first row, in the sequence's rows
  {
    const int b = int(gridDim.x) - 1 - int(blockIdx.x);
    int tiles_before = 0;
    for (int s = 0; s < num_seqs; ++s) {
      const int q_len = cu_q_lens[s + 1] - cu_q_lens[s];
      const int n_tiles = (q_len * qg + kRows - 1) / kRows;
      if (b < tiles_before + n_tiles) {
        seq = s;
        tile_f0 = (b - tiles_before) * kRows;
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
  // This warp's 16 rows (its row group) and its columns of O (all of them
  // but at head_dim 384).
  const int rg = warp / kColWarps;
  const int col0 = (warp % kColWarps) * kOCols;
  const int num_q_heads = num_kv_heads * qg;
  const int ckv = 2 * num_kv_heads;
  const int q_start = cu_q_lens[seq];
  const int q_len = cu_q_lens[seq + 1] - q_start;
  const int kv_len = min(kv_lens[seq], pages_per_seq * page_size);
  const int n_rows = min(kRows, q_len * qg - tile_f0);  // the tile's live rows
  const int pos_base = kv_len - q_len;  // absolute position of the sequence's first token
  const int pos0 = pos_base + tile_f0 / qg;                  // of the tile's first row
  const int pos_end = pos_base + (tile_f0 + n_rows - 1) / qg;  // and of its last
  const int* pages = page_indices + size_t(seq) * pages_per_seq;

  // Keys this tile can see.
  const int kv_hi = min(kv_len, pos_end + 1);
  const int kv_lo = sliding_window > 0 ? max(0, pos0 - sliding_window + 1) : 0;

  // Blocksparse: the phases of this kv head's query heads, for the test of
  // whether any row of the tile may see a key tile.
  int group_phase[QG > 0 ? QG : 1];
  if constexpr (BLOCKSPARSE) {
#pragma unroll
    for (int h = 0; h < QG; ++h) group_phase[h] = bs.offsets[kvh * QG + h];
  }
  // The first tile at or after t that some row and head may see: every
  // tile without blocksparse. With it, the test is against the tile's first
  // row (the lowest query block, which sees the most local keys) and every
  // head's phase, and is the same in every warp, so the whole block skips
  // a tile or none of it. When a tile lies in one key block (the block a
  // multiple of the tile), lane l tests the tile l tiles on, so one ballot
  // looks 32 tiles ahead; else lane l tests keys t + l and t + 32 + l.
  const int bq0 = BLOCKSPARSE ? pos0 / bs.block : 0;
  auto next_tile = [&](int t) {
    if constexpr (BLOCKSPARSE) {
      if (bs.block % kKeys == 0) {
        for (; t < kv_hi; t += 32 * kKeys) {
          const int mine = t + lane * kKeys;
          bool live = false;
          if (mine < kv_hi && mine + kKeys > kv_lo) {
#pragma unroll
            for (int h = 0; h < QG; ++h)
              live = live || block_visible(bs, bq0, mine / bs.block, group_phase[h]);
          }
          const unsigned hits = __ballot_sync(0xffffffffu, live);
          if (hits != 0u) return t + (__ffs(hits) - 1) * kKeys;
        }
        return t;
      }
      for (; t < kv_hi; t += kKeys) {
        bool live = false;
#pragma unroll
        for (int k = t + lane; k < t + kKeys; k += 32) {
          if (k < kv_lo || k >= kv_hi) continue;
#pragma unroll
          for (int h = 0; h < QG; ++h)
            live = live || block_visible(bs, bq0, k / bs.block, group_phase[h]);
        }
        if (__any_sync(0xffffffffu, live)) break;
      }
    }
    return t;
  };

  // The ring: the first kStages - 1 tiles now, then one a tile.
  int tile = next_tile(kv_lo / kKeys * kKeys);  // the next tile to use
  int ahead = tile;                              // the next tile to load
  for (int st = 0; st < kStages - 1; ++st) {
    if (ahead < kv_hi) {
      attn::issue_tile<Page, D, kThreads>(stages + st * L::stage, kv, pages, page_size, ckv,
                                          kvh, ahead, kv_lo, kv_hi);
      ahead = next_tile(ahead + kKeys);
    }
    attn::cp_async_commit();
  }

  // Query rows: row r = the sequence's row f = tile_f0 + r, token f / qg,
  // head kvh * qg + f % qg, as bf16. Rows past n_rows are idle: zeros,
  // never written.
  for (int i = tid; i < kRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int part = i % (D / 8);
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) {
      const int f = tile_f0 + r;
      const size_t head = size_t(q_start + f / qg) * num_q_heads + kvh * qg + f % qg;
      raw = *reinterpret_cast<const uint4*>(q + head * D + part * 8);
    }
    *reinterpret_cast<uint4*>(q_s + r * kStride + part * 8) = raw;
  }
  __syncthreads();
  attn::QFrags<D> qf;
  attn::load_q<D>(qf, q_s + rg * 16 * kStride);

  // This lane's two rows (g and g + 8 of the warp's 16), and the span of
  // token positions of the warp's live rows.
  int pos[2];
  bool live_row[2];
  float slope[2] = {0.f, 0.f};
  int phase[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rg * 16 + lane / 4 + 8 * r;
    const int f = tile_f0 + row;
    live_row[r] = row < n_rows;
    pos[r] = pos_base + f / qg;
    if constexpr (ALIBI) slope[r] = __ldg(alibi_slopes + kvh * qg + f % qg);
    if constexpr (BLOCKSPARSE) phase[r] = __ldg(bs.offsets + kvh * qg + f % qg);
  }
  // Blocksparse: each row's query block; when a tile lies in one key
  // block (the block a multiple of the tile, as Phi-3-Small's 64) each
  // row's visibility is one test a tile, else one a key.
  int bq[2] = {0, 0};
  bool one_block = false;
  if constexpr (BLOCKSPARSE) {
    bq[0] = pos[0] / bs.block;
    bq[1] = pos[1] / bs.block;
    one_block = bs.block % kKeys == 0;
  }
  const bool warp_live = rg * 16 < n_rows;
  const int w_pos_min = pos_base + (tile_f0 + rg * 16) / qg;
  const int w_pos_max = pos_base + (tile_f0 + min(n_rows - 1, rg * 16 + 15)) / qg;
  const int w_hi = min(kv_hi, w_pos_max + 1);
  const int w_lo = sliding_window > 0 ? max(0, w_pos_min - sliding_window + 1) : 0;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[kOCols / 8][4];
#pragma unroll
  for (int j = 0; j < kOCols / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; tile < kv_hi; ++it) {
    const int cur = tile;
    tile = next_tile(cur + kKeys);
    // Tile `cur` has landed, and every warp is done with the previous one
    // (and with the query rows): its stage is free for the tile kStages - 1
    // ahead.
    attn::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ahead < kv_hi) {
      attn::issue_tile<Page, D, kThreads>(stages + ((it + kStages - 1) % kStages) * L::stage,
                                          kv, pages, page_size, ckv, kvh, ahead, kv_lo, kv_hi);
      ahead = next_tile(ahead + kKeys);
    }
    attn::cp_async_commit();
    unsigned char* stage = stages + (it % kStages) * L::stage;
    const __nv_bfloat16* k_t;
    if constexpr (L::kNarrow) {
      attn::widen_tile<Page, D, kThreads>(wide, stage);
      __syncthreads();
      k_t = wide;
    } else {
      k_t = reinterpret_cast<const __nv_bfloat16*>(stage);
    }
    // Masks key by key only where a step straddles an edge of the warp's
    // rows (causal, window), or, with blocksparse, where the tile spans
    // key blocks; in one key block a row sees all of its keys or none.
    bool vis[2] = {true, true};
    if constexpr (BLOCKSPARSE) {
      if (one_block) {
        const int bk = cur / bs.block;
        vis[0] = block_visible(bs, bq[0], bk, phase[0]);
        vis[1] = block_visible(bs, bq[1], bk, phase[1]);
      }
    }
#pragma unroll
    for (int sub = 0; sub < kKeys; sub += kSub) {
      const int c0 = cur + sub;  // the step's first key
      // A warp whose rows see no key of the step skips it (uniform per warp).
      if (!warp_live || c0 >= w_hi || c0 + kSub <= w_lo) continue;

      float s[kSub / 8][4];
      attn::qk<D, kSub / 8>(s, qf, k_t + sub * kStride);
      const bool edge = c0 + kSub - 1 > w_pos_min ||
                        (sliding_window > 0 && c0 <= w_pos_max - sliding_window) ||
                        (BLOCKSPARSE && !one_block);
#pragma unroll
      for (int nb = 0; nb < kSub / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const int key = c0 + nb * 8 + 2 * (lane % 4) + e % 2;
          float v = s[nb][e] * sm_scale;
          if (soft_cap > 0.f) v = soft_cap * tanhf(v / soft_cap);
          if constexpr (ALIBI) v = __fadd_rn(v, __fmul_rn(slope[r], float(key - pos[r])));
          if (edge) {
            bool valid = key <= pos[r] && key < kv_hi;
            if (sliding_window > 0) valid = valid && key > pos[r] - sliding_window;
            if constexpr (BLOCKSPARSE) {
              if (!one_block)
                valid = valid && block_visible(bs, bq[r], key / bs.block, phase[r]);
            }
            if (!valid) v = -INFINITY;
          }
          if constexpr (BLOCKSPARSE) {
            if (!vis[r]) v = -INFINITY;
          }
          s[nb][e] = v;
        }
      }
      attn::softmax_step<kOCols, kSub / 8>(s, m, l, o);
      attn::pv<D, kSub / 8, kOCols>(o, s, k_t + kTileElems + sub * kStride + col0);
    }
  }

  attn::finish_sums(l);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live_row[r]) continue;
    const int f = tile_f0 + rg * 16 + lane / 4 + 8 * r;
    const size_t head = size_t(q_start + f / qg) * num_q_heads + kvh * qg + f % qg;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* dst = out + head * D + col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kOCols / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

template <class Page, int D, int QG, bool ALIBI, bool BLOCKSPARSE>
cudaError_t launch(const void* q, const void* kv, const int* kv_lens, const int* page_indices,
                   const int* cu_q_lens, const float* alibi_slopes, void* out, int num_tokens,
                   int num_seqs, int num_kv_heads, int qg, int page_size, int pages_per_seq,
                   float sm_scale, int sliding_window, float soft_cap, Blocksparse bs,
                   cudaStream_t stream) {
  const size_t smem = RaggedSmem<Page, D>::bytes;
  constexpr int kThreads = RaggedShape<D>::kThreads;
  constexpr int kRows = RaggedShape<D>::kRows;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_paged_attention_kernel<Page, D, QG, ALIBI, BLOCKSPARSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // At most ceil(T * qg / kRows) + S tiles: a sequence's rows fill all of
  // its tiles but the last (the kernel maps rows with the same qg).
  const dim3 grid((num_tokens * qg + kRows - 1) / kRows + num_seqs, num_kv_heads);
  ragged_paged_attention_kernel<Page, D, QG, ALIBI, BLOCKSPARSE>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const unsigned char*>(kv), kv_lens,
          page_indices, cu_q_lens, alibi_slopes, static_cast<__nv_bfloat16*>(out), num_seqs,
          num_kv_heads, qg, page_size, pages_per_seq, sm_scale, sliding_window, soft_cap, bs);
  return cudaGetLastError();
}

// Launches the instantiation for head_dim D: at D 128 QG 1, 2, 4 and 8
// have their own, every other QG (and every QG at D 64, 80, 96, 160 and 256) the
// one that reads it at run time, with ALiBi too. With blocksparse only D
// 128 and QG 1, 2, 4 and 8 are built.
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
  if constexpr (D != 128) {
    if constexpr (BLOCKSPARSE) return cudaErrorInvalidValue;
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
    if constexpr (BLOCKSPARSE) return cudaErrorInvalidValue;
    else return RAGGED_LAUNCH(0);
  }
#undef RAGGED_LAUNCH
}

// Checks the shape and launches the variant for pages of type Page,
// head_dim 64, 80, 96, 128, 160 or 256 (ONLY_D 0) or ONLY_D alone (384:
// the library of ragged_paged_attention_d384.cu, built apart so that its
// compile runs beside the others'), QG = num_q_heads / num_kv_heads query
// heads per kv head (any), ALiBi (a slope table given) or not and
// blocksparse (a phase table given) or not.
template <class Page, bool ALIBI, bool BLOCKSPARSE, int ONLY_D = 0>
int run(const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,
        const void* cu_q_lens, const void* alibi_slopes, void* out, int num_tokens,
        int num_seqs, int num_q_heads, int num_kv_heads, int head_dim, int page_size,
        int pages_per_seq, float sm_scale, int sliding_window, float soft_cap,
        const void* bs_offsets, int bs_block, int bs_local, int bs_vert, void* stream) {
  if (num_tokens <= 0 || num_seqs <= 0) return int(cudaSuccess);
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0 ||
      ALIBI != (alibi_slopes != nullptr) ||
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
#define RAGGED_LAUNCH_D(d)                                                                  \
  launch_d<Page, d, ALIBI, BLOCKSPARSE>(q, kv_pages, lens, pages, cu, slopes, out, num_tokens, \
                                        num_seqs, num_kv_heads, qg, page_size, pages_per_seq,  \
                                        sm_scale, sliding_window, soft_cap, bs, s)
  if constexpr (ONLY_D != 0) {
    return head_dim == ONLY_D ? int(RAGGED_LAUNCH_D(ONLY_D)) : int(cudaErrorInvalidValue);
  } else {
    switch (head_dim) {
      case 64:
        return int(RAGGED_LAUNCH_D(64));
      case 80:
        return int(RAGGED_LAUNCH_D(80));
      case 96:
        return int(RAGGED_LAUNCH_D(96));
      case 128:
        return int(RAGGED_LAUNCH_D(128));
      case 160:
        return int(RAGGED_LAUNCH_D(160));
      case 256:
        return int(RAGGED_LAUNCH_D(256));
      default:
        return int(cudaErrorInvalidValue);
    }
  }
#undef RAGGED_LAUNCH_D
}

}  // namespace

// One entry point: `name`, for pages of type Page, with ALiBi or not and
// blocksparse or not, and with only_d 0 (D = 64, 80, 96, 128, 160 or 256)
// or only_d alone (384). q bf16[T, QH, D] with QH = QG * KV
// for any QG (with blocksparse: D = 128 and QG in {1, 2, 4, 8}), kv_pages
// [P, page_size, 2 * KV, D] of the named type,
// kv_lens i32[S], page_indices i32[S, pages_per_seq], cu_q_lens i32[S + 1],
// alibi_slopes f32[QH] (the ALiBi entry points) or null (the others), out
// bf16[T, QH, D] (zero-filled by the caller). sliding_window <= 0 and
// soft_cap <= 0 mean off. bs_offsets i32[QH] with bs_block, bs_local and
// bs_vert (the blocksparse entry points) or null (the others). Returns the
// CUDA error of the launch (cudaErrorInvalidValue for any other D or QH /
// KV, or a slope or phase table that does not match the entry).
#define RAGGED_ENTRY(name, Page, alibi, blocksparse) RAGGED_ENTRY_D(name, Page, alibi, blocksparse, 0)
#define RAGGED_ENTRY_D(name, Page, alibi, blocksparse, only_d)                                \
  extern "C" int name(const void* q, const void* kv_pages, const void* kv_lens,              \
                      const void* page_indices, const void* cu_q_lens,                       \
                      const void* alibi_slopes, void* out, int num_tokens, int num_seqs,     \
                      int num_q_heads, int num_kv_heads, int head_dim, int page_size,        \
                      int pages_per_seq, float sm_scale, int sliding_window,                 \
                      float soft_cap, const void* bs_offsets, int bs_block, int bs_local,    \
                      int bs_vert, void* stream) {                                           \
    return run<Page, alibi, blocksparse, only_d>(                                            \
        q, kv_pages, kv_lens, page_indices, cu_q_lens, alibi_slopes, out, num_tokens,        \
        num_seqs, num_q_heads, num_kv_heads, head_dim, page_size, pages_per_seq, sm_scale,   \
        sliding_window, soft_cap, bs_offsets, bs_block, bs_local, bs_vert, stream);          \
  }
