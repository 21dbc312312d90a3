// The decode body: a second implementation of the group-wise and dense
// bodies of both int4 matmul kernels (int4p_matmul.cu, packed nibbles, and
// int4_matmul.cu, one int8 level per byte) for Hopper, sm_90a, for products
// of fewer than 64 tokens with a quantized weight streamed once from device
// memory. The wrappers take it where decode_route (ops/quant_matmul.py)
// picks it, from the card's times; elsewhere the mma.sync kernels of those
// sources run the same arithmetic.
//
//   out[T, N] (f32) = x[T, K] (bf16) @ w[K, N],
//   w[k, n] = (q[k, n] - zero[k / G, n]) * scale[k / G, n]
//
// Replaces, with those kernels, the TPU kernels of
// aphrodite_tpu/ops/quant_matmul.py: _kernel_packed_groupwise of
// int4p_matmul_pallas (form PACKED), _kernel of int4_matmul_pallas (DENSE,
// DENSE_ROWS), _kernel_groupwise of int4_matmul_pallas_groupwise
// (GROUPWISE) and the bodies of int4_matmul_pallas_stacked (a layer view: a
// pointer offset made by the wrapper). The arithmetic is theirs:
//
// - PACKED and GROUPWISE: raw nibbles or levels go to the tensor cores as
//   exact bf16 values and each group's scale and zero are applied to f32
//   partial sums,
//     out += s_g * (x_g @ q_g) - s_g * z_g * rowsum(x_g),
//   so the result follows the exact f32-weight product to the order of the
//   f32 sums (a nibble enters as 128 + q, and 128 leaves with the zero).
// - DENSE (G >= 16) and DENSE_ROWS (G = 1, 2, 4, 8): w = bf16((q - z) * s),
//   formed in f32 as the plain version forms it, then bf16 products with
//   f32 sums.
//
// Bound on the H100: bytes. K * N / 2 packed bytes (K * N levels) and
// 8 * (K / G) * N bytes of scale and zero are read once a call against
// 2 * T * K * N operations: at T = 32 some 64 operations a byte, far under
// the ~295 of the card's ridge. What the design does about it:
//
// - One block an SM with a deep ring. Each block owns 256 weight columns
//   (one strip) of a k range and streams its raw rows through a ring of
//   up to eight 64-row stages, each filled by TMA (two 128-column boxes of
//   the weight in the 128-byte swizzle, the x rows of the stage, the scale
//   and zero rows of its groups, the stage's step sums of x) and handed
//   over by mbarriers: one producer thread keeps 100-200 KB in flight an
//   SM, and the eight consumer warps never meet at a block-wide barrier.
//   Sites with few strips split K over blockIdx.z; the partials go to an
//   f32 scratch buffer that a second kernel adds in a fixed order, so a
//   result does not change from run to run.
// - Tokens are the n dimension of mma.sync m16n8k16: out^T = w^T x^T. The
//   weight is the A operand (16 columns by 16 k a fragment) and x the B
//   operand (ldmatrix), eight tokens a tile, so T = 1-8 costs one n tile
//   and T = 16 two, where x as the A operand pads every T to 16 rows. A
//   block takes 8, 16 or 32 tokens (64 in the unpacked forms); more take
//   more blocks along blockIdx.x, the fastest index, so that the blocks of
//   one strip run together and re-read the strip from L2.
// - x crosses from L2 once per block and stage, shared by the 256 columns:
//   its bytes are T / 64 (packed) or T / 128 of the weight's.
// - rowsum(x_g) is summed once per call: a small kernel writes each
//   token's sum of every 16 columns of x, and the decode kernel, launched
//   behind it as a programmatic dependent, starts while it runs; its
//   producer waits for the sums before the first load of them.
// - Group folds follow a counter of rows left in the open group, so any
//   group that is a multiple of 16 (GGUF Q2_K and Q3_K pack at 16, Q6_K
//   unpacks at 16) folds after the k16 step that ends it, with no runtime
//   division and no extra instantiation.
//
// On the H100 its time did not move with the ring's depth (3 to 8 stages,
// kernel_ab.py sweep --only decode), so it is bound by the consumers' work
// on each stage, not by the bytes in flight; at w13 of Llama-3.1-8B only
// 112 of the 132 SMs have a strip (PERF.md §6).
//
// A nibble becomes the bf16 value 128 + q by or-ing it into the mantissa of
// 128.0; a level becomes bf16 by levels_to_bf16x2 (matmul_common.cuh). The
// dense forms turn a byte into an exact f32 by or-ing it into the mantissa
// of 2^23 (dequant_gemm.cuh).
//
// Shape rules (checked by the entry points): N % 128 == 0 (a block's
// second box past N reads zeros and stores nothing), packed (K / 2) % 32
// (the last stage of a K/2 that is an odd multiple of 32 takes its first
// 32 rows; the rest of its boxes lie past the tensor and arrive as zeros),
// unpacked K % 64, x bf16 with a row stride that is a multiple of 8 and a
// 16-byte aligned start, 16-byte aligned weights.

#pragma once

#include "dequant_gemm.cuh"

namespace dqd {

using dqg::byte_plus_2p23;
using dqg::dequant;
using dqg::lane_of;
using dqg::make_map;
using dqg::mbar_arrive;
using dqg::mbar_expect_tx;
using dqg::mbar_init;
using dqg::mbar_wait;
using dqg::pack_bf16x2;
using dqg::smem_u32;
using dqg::tma_load;

constexpr int COLS = 256;      // weight columns per block
constexpr int BOX_COLS = 128;  // per TMA box of the weight (one 128-byte swizzle row)
constexpr int KS = 64;         // raw weight rows per stage
constexpr int STEPS = KS / 16;
constexpr int WARP_COLS = 32;  // two m16 A tiles of weight columns per consumer warp
constexpr int CONSUMERS = COLS / WARP_COLS;
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr int MAX_STAGES = 8;
constexpr int SMEM_ALIGN = 1024;  // a 128-byte swizzle atom repeats every 8 rows
constexpr int DYNAMIC_SMEM = dqg::SMEM_LIMIT - SMEM_ALIGN;

enum Form { PACKED = 0, GROUPWISE = 1, DENSE = 2, DENSE_ROWS = 3 };

__host__ __device__ constexpr bool folds(int form) { return form == PACKED || form == GROUPWISE; }

struct Params {
  int T, N, group;
  int k_stages_per_split;
  int last_stage;   // the last stage of the whole k range
  int sz_rows;      // scale (and zero) rows per stage and half
  int half_groups;  // packed: group rows of the low half of K
  int half_k;       // packed: K / 2, the first x column of the high half
  int stages;       // depth of the ring
  int stage_bytes;
  const float* scale;  // DENSE_ROWS reads these directly
  const float* zero;
  float* out;  // [splits, T, N]
};

// Bytes of one stage: x boxes, the two weight boxes, scale and zero rows,
// the step sums of x; a multiple of the swizzle alignment.
__host__ __device__ constexpr int stage_bytes(int tt, int form, int sz_rows) {
  const int atoms = form == PACKED ? 2 : 1;
  const int x = atoms * tt * 128;
  const int q = 2 * KS * BOX_COLS;
  const int sz = form == DENSE_ROWS ? 0 : 2 * atoms * sz_rows * COLS * 4;
  const int rs = folds(form) ? atoms * STEPS * tt * 4 : 0;
  return (x + q + sz + rs + SMEM_ALIGN - 1) / SMEM_ALIGN * SMEM_ALIGN;
}

// rs[c][t] (f32 [K / 16, t_pad]) = the sum of x[t, 16c .. 16c + 15], zero
// for the rows T .. t_pad - 1 that pad the last token tile: the step sums of
// x, which the decode body's stages bring beside x by TMA. It lets the
// decode kernel start at once (programmatic dependent launch): that
// kernel's producer waits for these sums before its first load of them.
__global__ void __launch_bounds__(256)
step_sums_kernel(const __nv_bfloat16* __restrict__ x, int x_stride, int T, int K, int t_pad,
                 float* __restrict__ rs) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int chunks = K / 16;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= chunks * t_pad) return;
  const int t = idx / chunks;  // neighbouring threads read neighbouring chunks of a row
  const int c = idx % chunks;
  float pair[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) pair[m] = 0.0f;
  if (t < T) {
    const uint4* src = reinterpret_cast<const uint4*>(x + size_t(t) * x_stride + 16 * c);
    const uint4 v0 = src[0], v1 = src[1];
    const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int m = 0; m < 8; ++m)
      pair[m] = __uint_as_float(w[m] << 16) + __uint_as_float(w[m] & 0xFFFF0000u);
  }
  rs[size_t(c) * t_pad + t] =
      ((pair[0] + pair[1]) + (pair[2] + pair[3])) + ((pair[4] + pair[5]) + (pair[6] + pair[7]));
}

// Four (or two) 8x8 matrices of 16-bit values from shared memory, each
// lane giving the address of one matrix row: the B fragments of two (one)
// n8 tiles.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// NT: n8 tiles of tokens per block (TT = 8 * NT tokens). FORM as above.
//
// Warps 0-7 are consumers, warp 8 the producer, whose lane 0 issues the TMA
// loads. Consumer warp w owns weight columns 32 w .. 32 w + 31 of the block,
// in box w / 4; its thread (lane 4g + t) owns the four columns 4c .. 4c + 3
// of the box, c = 8 (w % 4) + g, as rows of its two m16 A tiles: row g + 8h
// of tile i is column 4c + 2i + h. One 32-bit word of a raw weight row
// holds the thread's four columns, and the A registers take pairs of rows
// k, k + 1 (k = 2t, 2t + 8 of each 16-row step) of one column: the bytes of
// two words, permuted. The accumulators hold out^T: entry (row g + 8h,
// token 2t + e) of tile (i, n tile j) is register 2h + e of [i][j].
//
// Up to 16 tokens a block, two blocks fit an SM where their rings do (the
// registers are held to that).
template <int NT, int FORM>
__global__ void __launch_bounds__(THREADS, NT <= 2 ? 2 : 1)
decode_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap s_map,
                   const __grid_constant__ CUtensorMap z_map,
                   const __grid_constant__ CUtensorMap r_map, const Params p) {
  constexpr int TT = 8 * NT;
  constexpr bool PK = FORM == PACKED;
  constexpr bool FOLDS = folds(FORM);
  constexpr int ATOMS = PK ? 2 : 1;  // x boxes (and scale and step-sum sets) per stage
  constexpr int X_BYTES = ATOMS * TT * 128;
  constexpr int Q_BYTES = 2 * KS * BOX_COLS;
  constexpr int RS_BYTES = FOLDS ? ATOMS * STEPS * TT * 4 : 0;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  unsigned char* smem =
      smem_raw + ((SMEM_ALIGN - (smem_u32(smem_raw) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));

  const int t0 = blockIdx.x * TT;
  const int n_blk = blockIdx.y * COLS;
  const int count = p.k_stages_per_split;
  const int stage0 = blockIdx.z * count;
  const int S = p.stages;
  const int sz_box = p.sz_rows * COLS * 4;
  const int rs_off = X_BYTES + Q_BYTES + (FORM == DENSE_ROWS ? 0 : 2 * ATOMS * sz_box);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // Producer.
    auto issue = [&](int it) {
        const int slot = it % S;
        unsigned char* st = smem + slot * p.stage_bytes;
        uint64_t* bar = &full[slot];
        mbar_expect_tx(bar, rs_off + RS_BYTES);
        const int r0 = (stage0 + it) * KS;  // first raw row: k, or packed row
        tma_load(st, &x_map, bar, r0, t0);
        if constexpr (PK) tma_load(st + TT * 128, &x_map, bar, p.half_k + r0, t0);
        tma_load(st + X_BYTES, &q_map, bar, n_blk, r0);
        tma_load(st + X_BYTES + KS * BOX_COLS, &q_map, bar, n_blk + BOX_COLS, r0);
        if constexpr (FORM != DENSE_ROWS) {
          unsigned char* sz = st + X_BYTES + Q_BYTES;
          const int g0 = r0 / p.group;
          tma_load(sz, &s_map, bar, n_blk, g0);
          tma_load(sz + sz_box, &z_map, bar, n_blk, g0);
          if constexpr (PK) {
            tma_load(sz + 2 * sz_box, &s_map, bar, n_blk, p.half_groups + g0);
            tma_load(sz + 3 * sz_box, &z_map, bar, n_blk, p.half_groups + g0);
          }
        }
        if constexpr (FOLDS) {
          tma_load(st + rs_off, &r_map, bar, t0, r0 / 16);
          if constexpr (PK)
            tma_load(st + rs_off + STEPS * TT * 4, &r_map, bar, t0, (p.half_k + r0) / 16);
        }
    };
    if (lane == 0) {
      // The step sums come from the kernel launched just before this one.
      if constexpr (FOLDS) asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int it = 0; it < S && it < count; ++it) issue(it);
      for (int it = 0; it + S < count; ++it) {
        mbar_wait(&empty[it % S], (it / S) & 1);
        issue(it + S);
      }
    }
    return;
  }

  // Consumers.
  const int g = lane / 4;
  const int t = lane % 4;
  const int box = warp / 4;
  const int c = (warp % 4) * 8 + g;
  const int col = n_blk + box * BOX_COLS + 4 * c;  // first of this thread's columns
  const bool live = col < p.N;

  float acc[2][NT][4];
  float part[FOLDS ? ATOMS : 1][2][NT][4];  // x_g @ q_g of the open group, per half
  float rsum[FOLDS ? ATOMS : 1][NT][2];     // rowsum(x_g) of tokens 2t, 2t + 1 of each tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  auto clear_group = [&]() {
#pragma unroll
    for (int h = 0; h < (FOLDS ? ATOMS : 0); ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        rsum[h][j][0] = 0.0f;
        rsum[h][j][1] = 0.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[h][i][j][e] = 0.0f;
      }
  };
  clear_group();

  // The open group (the one holding the next row) and its rows still to come.
  int cur_group = 0, left = 0;
  if constexpr (FORM != DENSE_ROWS) {
    const int r_start = stage0 * KS;
    cur_group = r_start / p.group;
    left = p.group - (r_start - cur_group * p.group);
  }
  const int group_shift = 31 - __clz(p.group);  // DENSE_ROWS: groups are powers of two

  // Folds the open group's partial sums into acc with its scale and zero
  // row `srow` of the stage, then clears them.
  auto fold = [&](const float* sz, int srow) {
    float4 sv[ATOMS], zv[ATOMS];
#pragma unroll
    for (int h = 0; h < ATOMS; ++h) {
      const float* base = sz + (2 * h * p.sz_rows + srow) * COLS + box * BOX_COLS + 4 * c;
      sv[h] = *reinterpret_cast<const float4*>(base);
      zv[h] = *reinterpret_cast<const float4*>(base + p.sz_rows * COLS);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 2 * i + hh;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = 2 * hh + e;
            if constexpr (PK) {
              const float s_lo = lane_of(sv[0], j), c_lo = 128.0f + lane_of(zv[0], j);
              const float s_hi = lane_of(sv[ATOMS - 1], j),
                          c_hi = 128.0f + lane_of(zv[ATOMS - 1], j);
              acc[i][n][f] += s_lo * (part[0][i][n][f] - c_lo * rsum[0][n][e]) +
                              s_hi * (part[ATOMS - 1][i][n][f] - c_hi * rsum[ATOMS - 1][n][e]);
            } else {
              const float sc = lane_of(sv[0], j);
              const float scz = sc * lane_of(zv[0], j);
              acc[i][n][f] += fmaf(sc, part[0][i][n][f], -(scz * rsum[0][n][e]));
            }
          }
        }
      }
    }
    clear_group();
  };

  constexpr uint32_t kNibbles = 0x000F000Fu;
  constexpr uint32_t kBias = 0x43004300u;  // bf16 128.0 twice
  // ldmatrix rows: lane l gives row l % 8 of matrix l / 8, which holds
  // tokens 8 (j + (l / 8) / 2) .. + 7 (the same row index, so the same
  // swizzle) and k chunk 2s + (l / 8) % 2 of the step.
  const int lm_row = (8 * ((lane / 8) / 2) + lane % 8) * 128;
  const int lm_chunk = (lane / 8) % 2;
  const int lm_swz = lane % 8;

  // One stage: `it` of this block's k range, its first N_STEPS k16 steps.
  auto stage = [&](int it, auto n_steps) {
    constexpr int N_STEPS = decltype(n_steps)::value;
    const int slot = it % S;
    mbar_wait(&full[slot], (it / S) & 1);
    const unsigned char* st = smem + slot * p.stage_bytes;
    const uint32_t xs = smem_u32(st);
    const unsigned char* qs = st + X_BYTES + box * KS * BOX_COLS;
    const float* sz = reinterpret_cast<const float*>(st + X_BYTES + Q_BYTES);
    const int r0 = (stage0 + it) * KS;
    const int sg0 = cur_group;  // the group of row r0: the first of the stage's boxes
    const float* rs = reinterpret_cast<const float*>(st + rs_off);  // [h][step][token]
#pragma unroll
    for (int s = 0; s < N_STEPS; ++s) {
      // Raw rows 16s + 2t + {0, 1, 8, 9}, this thread's four columns; the
      // box came in the 128-byte swizzle (16-byte chunk index ^ row % 8).
      uint32_t w[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = 16 * s + 2 * t + (m & 1) + 8 * (m >> 1);
        w[m] = *reinterpret_cast<const uint32_t*>(qs + r * 128 + ((((c >> 2) ^ r) & 7) << 4) +
                                                  ((c & 3) << 2));
      }
      // B fragments: tokens 8j + g, k 16s + 2t (+ 8) of each x box.
      uint32_t b[ATOMS][NT][2];
#pragma unroll
      for (int h = 0; h < ATOMS; ++h) {
        const uint32_t base =
            xs + h * TT * 128 + lm_row + ((((2 * s + lm_chunk) ^ lm_swz) & 7) << 4);
        if constexpr (NT == 1) {
          ldmatrix_x2(b[h][0][0], b[h][0][1], base);
        } else {
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t r[4];
            ldmatrix_x4(r, base + j * 8 * 128);
            b[h][j][0] = r[0];
            b[h][j][1] = r[1];
            b[h][j + 1][0] = r[2];
            b[h][j + 1][1] = r[3];
          }
        }
      }
      uint32_t A[ATOMS][2][4];
      if constexpr (PK) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint32_t j = 2 * i + hh;
            // Byte j of two rows, 16 bits apart: [row k].j, x, [row k + 1].j, x.
            const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
            const uint32_t t01 = __byte_perm(w[0], w[1], sel);
            const uint32_t t89 = __byte_perm(w[2], w[3], sel);
            A[0][i][hh] = (t01 & kNibbles) | kBias;
            A[0][i][2 + hh] = (t89 & kNibbles) | kBias;
            A[ATOMS - 1][i][hh] = ((t01 >> 4) & kNibbles) | kBias;
            A[ATOMS - 1][i][2 + hh] = ((t89 >> 4) & kNibbles) | kBias;
          }
      } else if constexpr (FORM == GROUPWISE) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint32_t j = 2 * i + hh;
            const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
            A[0][i][hh] = levels_to_bf16x2(__byte_perm(w[0], w[1], sel));
            A[0][i][2 + hh] = levels_to_bf16x2(__byte_perm(w[2], w[3], sel));
          }
      } else {
        // Scale and zero of (row m, column j).
        float4 sv[4], zv[4];
        if constexpr (FORM == DENSE) {
          // The step's 16 rows lie in one group (G is a multiple of 16).
          const float* base = sz + (cur_group - sg0) * COLS + box * BOX_COLS + 4 * c;
          sv[0] = *reinterpret_cast<const float4*>(base);
          zv[0] = *reinterpret_cast<const float4*>(base + p.sz_rows * COLS);
#pragma unroll
          for (int m = 1; m < 4; ++m) {
            sv[m] = sv[0];
            zv[m] = zv[0];
          }
        } else {
          // Groups of 1-8 rows: each row's own, from device memory.
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int k = r0 + 16 * s + 2 * t + (m & 1) + 8 * (m >> 1);
            const size_t at = size_t(k >> group_shift) * p.N + col;
            sv[m] = live ? __ldg(reinterpret_cast<const float4*>(p.scale + at))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
            zv[m] = live ? __ldg(reinterpret_cast<const float4*>(p.zero + at))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        // Each raw word as four exact f32 values plus 2^23 + 128: the
        // offset leaves before the zero.
        uint32_t v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) v[m] = w[m] ^ 0x80808080u;
        auto wt = [&](int m, int j) {
          return dequant(__fsub_rn(byte_plus_2p23(v[m], j), 8388736.0f), lane_of(sv[m], j),
                         lane_of(zv[m], j));
        };
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = 2 * i + hh;
            A[0][i][hh] = pack_bf16x2(wt(0, j), wt(1, j));
            A[0][i][2 + hh] = pack_bf16x2(wt(2, j), wt(3, j));
          }
      }
#pragma unroll
      for (int h = 0; h < ATOMS; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if constexpr (FOLDS) {
              mma_bf16(part[h][i][j], A[h][i], b[h][j][0], b[h][j][1]);
            } else {
              mma_bf16(acc[i][j], A[h][i], b[h][j][0], b[h][j][1]);
            }
          }
      if constexpr (FOLDS) {
#pragma unroll
        for (int h = 0; h < ATOMS; ++h)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
          {
            const float2 r =
                *reinterpret_cast<const float2*>(rs + (h * STEPS + s) * TT + 8 * j + 2 * t);
            rsum[h][j][0] += r.x;
            rsum[h][j][1] += r.y;
          }
      }
      if constexpr (FORM != DENSE_ROWS) {
        left -= 16;
        if (left == 0) {
          if constexpr (FOLDS) fold(sz, cur_group - sg0);
          ++cur_group;
          left = p.group;
        }
      }
    }
    // The end of this block's k range inside a group: fold what it has.
    if constexpr (FOLDS) {
      if (it == count - 1 && left != p.group) fold(sz, cur_group - sg0);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  };
  // The last stage of a packed K/2 that is an odd multiple of 32 takes its
  // first two k16 steps (32 rows) only.
  const bool tail = PK && stage0 + count - 1 == p.last_stage && (p.half_k % KS) != 0;
  for (int it = 0; it < count - tail; ++it) stage(it, std::integral_constant<int, STEPS>{});
  if (tail) stage(count - 1, std::integral_constant<int, STEPS / 2>{});

  if (live) {
    float* dst = p.out + size_t(blockIdx.z) * p.T * p.N + col;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = t0 + 8 * j + 2 * t + e;
        if (row >= p.T) continue;
        *reinterpret_cast<float4*>(dst + size_t(row) * p.N) =
            make_float4(acc[0][j][e], acc[0][j][2 + e], acc[1][j][e], acc[1][j][2 + e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Ring depth for a stage size: as many as fit, up to MAX_STAGES.
inline int stages_for(int sb) {
  const int n = (DYNAMIC_SMEM - SMEM_ALIGN) / sb;
  return n < MAX_STAGES ? n : MAX_STAGES;
}

// out (f32 [T, N]) = x @ dequant(q), token tiles of 8 * NT rows: the step
// sums of x (folding forms, into `rs`, f32 [K / 16, T rounded up to the
// token tile]), the launch and, with splits > 1 (into `partial`, f32
// [splits, T, N]), the fixed-order sum. K counts columns of x (for packed
// weights twice their rows). splits divides the ceil(rows / KS) stages;
// stages is the ring's depth, at least 2 (0: as many as fit). Returns 0, a
// CUDA error code, -1 for arguments this body does not take, or -2 if a
// tensor map could not be made.
template <int NT, int FORM>
int launch(const void* x, int x_stride, const void* q, const float* scale, const float* zero,
           float* out, float* partial, float* rs, int T, int K, int N, int group, int stages,
           int splits, cudaStream_t stream) {
  constexpr int TT = 8 * NT;
  const int rows = FORM == PACKED ? K / 2 : K;
  const int k_stages = (rows + KS - 1) / KS;
  if (rows % (FORM == PACKED ? 32 : KS) || splits < 1 || k_stages % splits || group < 1)
    return -1;
  const int sz_rows = FORM == DENSE_ROWS ? 0 : dqg::group_rows_per_stage(rows, group);
  const int sb = stage_bytes(TT, FORM, sz_rows);
  if (stages == 0) stages = stages_for(sb);
  const int smem = stages * sb + SMEM_ALIGN;
  // The producer refills a slot only once the consumers have left it.
  if (stages < 2 || stages > MAX_STAGES || smem > DYNAMIC_SMEM) return -1;
  const int t_tiles = (T + TT - 1) / TT;
  const int t_pad = t_tiles * TT;
  CUtensorMap xm, qm, sm, zm, rm;
  if (!make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, T, uint64_t(x_stride) * 2, 64, TT,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, rows, N, BOX_COLS, KS,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  sm = xm;
  zm = xm;
  rm = xm;
  if (FORM != DENSE_ROWS &&
      (!make_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, K / group, uint64_t(N) * 4, COLS,
                 sz_rows, CU_TENSOR_MAP_SWIZZLE_NONE) ||
       !make_map(&zm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, zero, N, K / group, uint64_t(N) * 4, COLS,
                 sz_rows, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return -2;
  if (folds(FORM)) {
    if (rs == nullptr) return -1;
    if (!make_map(&rm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rs, t_pad, K / 16, uint64_t(t_pad) * 4,
                  TT, STEPS, CU_TENSOR_MAP_SWIZZLE_NONE))
      return -2;
    const int items = K / 16 * t_pad;
    step_sums_kernel<<<(items + 255) / 256, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), x_stride, T, K, t_pad, rs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = decode_gemm_kernel<NT, FORM>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DYNAMIC_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  Params prm;
  prm.T = T;
  prm.N = N;
  prm.group = group;
  prm.k_stages_per_split = k_stages / splits;
  prm.last_stage = k_stages - 1;
  prm.sz_rows = sz_rows;
  prm.half_groups = FORM == PACKED ? rows / group : 0;
  prm.half_k = FORM == PACKED ? rows : 0;
  prm.stages = stages;
  prm.stage_bytes = sb;
  prm.scale = scale;
  prm.zero = zero;
  prm.out = splits > 1 ? partial : out;
  const dim3 grid(t_tiles, (N + COLS - 1) / COLS, splits);
  cudaError_t err;
  if (folds(FORM)) {
    // After the step sums, start at once: the producer waits for them.
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // The arguments by address: the tensor maps are 64-byte aligned, and
    // are not copied on the way.
    void* args[] = {&xm, &qm, &sm, &zm, &rm, &prm};
    err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  } else {
    kernel<<<grid, THREADS, smem, stream>>>(xm, qm, sm, zm, rm, prm);
    err = cudaSuccess;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && splits > 1) err = launch_split_reduce(partial, out, T, N, splits, stream);
  return static_cast<int>(err);
}

// The launch at a token tile of 8, 16 or 32 rows, or 64 in the DENSE and
// GROUPWISE forms, whose accumulators leave room for it. (DENSE_ROWS at 64
// tokens gave a wrong product in some runs on an H100, which no other form
// or tile did; it is not instantiated.)
template <int FORM>
int launch_tile(int t_tile, const void* x, int x_stride, const void* q, const float* scale,
                const float* zero, float* out, float* partial, float* rs, int T, int K, int N,
                int group, int stages, int splits, cudaStream_t stream) {
  switch (t_tile) {
    case 8:
      return launch<1, FORM>(x, x_stride, q, scale, zero, out, partial, rs, T, K, N, group, stages,
                             splits, stream);
    case 16:
      return launch<2, FORM>(x, x_stride, q, scale, zero, out, partial, rs, T, K, N, group, stages,
                             splits, stream);
    case 32:
      return launch<4, FORM>(x, x_stride, q, scale, zero, out, partial, rs, T, K, N, group, stages,
                             splits, stream);
    case 64:
      if constexpr (FORM == DENSE || FORM == GROUPWISE)
        return launch<8, FORM>(x, x_stride, q, scale, zero, out, partial, rs, T, K, N, group,
                               stages, splits, stream);
      return -1;
    default:
      return -1;
  }
}

}  // namespace dqd
