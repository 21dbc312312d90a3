// The prefill body of both int4 matmul kernels (int4p_matmul.cu, packed
// nibbles, and int4_matmul.cu, one int8 level per byte), for Hopper, sm_90a:
// a mixed-input GEMM on wgmma fed by TMA.
//
//   out[T, N] (f32) = x[T, K] (bf16) @ w[K, N],
//   w[k, n] = bf16((q[k, n] - zero[k / G, n]) * scale[k / G, n]),
//
// the subtraction and the product in f32 and rounded once each, then rounded
// to bf16: the arithmetic of the plain version and of the TPU's dense bodies
// (aphrodite_tpu/ops/quant_matmul.py: _kernel_packed_dense of
// int4p_matmul_pallas, _kernel of int4_matmul_pallas and
// _kernel_stacked_dense of int4_matmul_pallas_stacked), which the JAX
// package takes at T >= 64 because the dequantization of a weight is shared
// by every token row of a block. A third form, PER_COLUMN, is int8
// weight-only (G = K, zero 0): the raw levels, exact in bf16, go to the
// tensor cores and the scale multiplies the f32 sum (the JAX package's
// _int8_matmul).
//
// Bound on the H100: operations, 2 * T * K * N on the tensor cores, from a
// few hundred tokens on (at T = 2048 the w13 site of Llama-3.1-8B needs
// 481 GFLOP and moves 76 MB). What the design does about it:
//
// - The weight is the A operand of wgmma, taken from registers, and x is B,
//   taken from shared memory (the token rows are wgmma's N): out^T = w^T x^T.
//   Each consumer thread turns the raw bytes of its four weight columns into
//   bf16 A fragments itself, so the dequantized weight never goes through
//   shared memory. The two consumer warpgroups take turns on the tensor
//   cores: one dequantizes its next k step while the other's wgmma runs.
//   A nibble or level becomes an exact f32 by or-ing it into the mantissa of
//   2^23 and subtracting (one byte permute and one add) instead of an
//   int-to-float conversion, which runs at a quarter of the f32 rate.
// - A block holds 256 weight columns (two consumer warpgroups of 128, each
//   two m64 wgmma tiles) by BT = 64 or 128 token rows, so each x byte brought
//   from L2 feeds 256 multiply-adds and each weight byte 2 * BT: at the
//   card's 989 TFLOP/s that asks under 4 TB/s of x from L2.
// - A producer warp keeps the ring full with TMA: per stage one (unpacked)
//   or two (packed: columns kp0.. and K/2 + kp0.. of x, the half-split layout)
//   64-column boxes of x in the 128-byte swizzle wgmma reads, the raw weight
//   rows (64 rows of 256 bytes, as two swizzled 128-byte boxes), and the
//   scale and zero rows of the stage's groups (G >= 16). Full and empty
//   mbarriers hand the stages between the roles; setmaxnreg moves registers
//   from the producer warpgroup to the two consumer warpgroups, whose
//   accumulators take BT registers a thread.
// - Sites with few blocks (N = 4096 at T = 64-256: 16-32 blocks) split K
//   across blockIdx.z; the partial sums go to an f32 scratch buffer that a
//   second kernel adds in a fixed order, so the result does not change from
//   run to run.
//
// Groups under 16 rows (act-order GPTQ, G = 1) read their scale and zero
// rows from device memory per k16 step instead: a stage of them would not
// fit in shared memory.
//
// Two other layouts were built and timed on the H100, and were slower at
// the Llama-3.1-8B sites: a dequantization warpgroup writing bf16 B tiles
// to shared memory for two consumer warpgroups that take both wgmma
// operands from there (one warpgroup's instruction stream could not keep up
// with the tile rate), and three consumer warpgroups of 128 columns with
// the loads issued from a consumer thread (ptxas serializes the wgmma
// pipeline around that divergent path, C7518).
//
// Shape rules (checked by the entry points): N % 128 == 0 (a last block of
// 128 columns leaves its second warpgroup's columns unwritten), 64 rows of
// the raw weight per stage (K % 64 unpacked, (K / 2) % 64 packed), groups as
// each kernel's older bodies take them, x bf16 with a row stride that is a
// multiple of 8 and a 16-byte aligned start, every weight pointer 16-byte
// aligned.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "matmul_common.cuh"

namespace dqg {

constexpr int COLS = 256;       // weight columns per block
constexpr int WG_COLS = 128;    // per consumer warpgroup
constexpr int KS = 64;          // raw weight rows per stage (levels or packed bytes)
constexpr int THREADS = 384;    // two consumer warpgroups, then the producer's
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use
constexpr int SMEM_ALIGN = 1024;    // a 128-byte swizzle atom repeats every 8 rows

enum Scales { GROUP_ROWS = 0, ROW_GLOBAL = 1, PER_COLUMN = 2 };

struct Params {
  int T, N, group;
  int k_stages_per_split;
  int sz_rows;      // GROUP_ROWS: scale (and zero) rows per stage and half
  int half_groups;  // packed: group rows of the low half of K
  int stages;       // depth of the ring
  int stage_bytes;
  const float* scale;  // ROW_GLOBAL and PER_COLUMN read these directly
  const float* zero;
  float* out;  // [splits, T, N]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of `bar` with this parity has completed. A wait that
// lasts for seconds traps, so a fault in the hand-off ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t since = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (since == 0) {
        since = now;
      } else if (now - since > 4000000000ull) {  // 4 s
        asm volatile("trap;\n");
      }
    }
  }
}

// One 2-D box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_grow() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_shrink() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Pins an accumulator at this point of the instruction stream: no write of
// it sinks below the first wgmma and no read rises above the
// wgmma.wait_group that completes it.
__device__ __forceinline__ void hold(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// wgmma's descriptor of a K-major operand in the 128-byte swizzle: rows of
// 64 bf16 (128 bytes), 8-row atoms 1024 bytes apart. Advancing the start by
// 32 bytes selects the next 16 values of k.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr) {
  return uint64_t((smem_addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int BT>
__device__ __forceinline__ void wgmma_rs(float (&d)[BT / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (BT == 128) {
    wgmma_m64n128k16_rs(d, a, desc_b);
  } else {
    static_assert(BT == 64, "token rows per block: 64 or 128");
    wgmma_m64n64k16_rs(d, a, desc_b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 2^23 plus byte j of `word`, as an f32 (exact): the byte or-ed into the
// mantissa of 2^23.
__device__ __forceinline__ float byte_plus_2p23(uint32_t word, int j) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | j));
}

// The plain version's dequantization, without contraction: (q - z) * s.
__device__ __forceinline__ float dequant(float q, float s, float z) {
  return __fmul_rn(__fsub_rn(q, z), s);
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// BT: token rows per block (64 or 128). PACKED: half-split nibbles
// [K/2, N] (two 64-column boxes of x per stage, the low and the high half of
// K) or one int8 level per byte [K, N]. SCALES: how scale and zero arrive.
//
// Threads 0-255 are the two consumer warpgroups, 256-383 the producer's
// warpgroup, of which one thread issues the TMA loads. Consumer warpgroup
// `wg` owns weight columns wg * 128 .. + 127 of the block; its thread (warp
// w, lane 4g + t) owns the four columns 4c .. 4c + 3, c = 8w + g, as rows of
// its two m64 wgmma tiles: row 16w + g + 8h of tile i is column 4c + 2i + h.
// So one 32-bit word of a raw weight row holds the thread's four columns,
// and the A fragment registers take pairs of rows k, k + 1 (k = 2t, 2t + 8
// of each 16-row step) of one column: the bytes of two words, permuted. The
// accumulators hold out^T: entry (row 16w + g + 8h, token 8j + 2t + e) of
// tile i is register 4j + 2h + e.
template <int BT, bool PACKED, int SCALES>
__global__ void __launch_bounds__(THREADS, 1)
dequant_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap s_map,
                    const __grid_constant__ CUtensorMap z_map, const Params p, int half_k) {
  constexpr int ATOMS = PACKED ? 2 : 1;  // 64-column boxes of x per stage
  constexpr int X_BYTES = ATOMS * BT * 128;
  constexpr int Q_BYTES = 2 * KS * WG_COLS;
  constexpr int ACC = BT / 2;  // f32 accumulators of one m64 tile, per thread
  static_assert(!PACKED || SCALES == GROUP_ROWS, "packed groups are multiples of 16");

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  unsigned char* smem =
      smem_raw + ((SMEM_ALIGN - (smem_u32(smem_raw) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));

  const int n_blk = blockIdx.x * COLS;
  const int t0 = blockIdx.y * BT;
  const int count = p.k_stages_per_split;
  const int stage0 = blockIdx.z * count;
  const int S = p.stages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // Producer.
    regs_shrink<40>();
    if (threadIdx.x == 2 * 128) {
      for (int it = 0; it < count; ++it) {
        const int slot = it % S;
        if (it >= S) mbar_wait(&empty[slot], (it / S - 1) & 1);
        unsigned char* st = smem + slot * p.stage_bytes;
        uint64_t* bar = &full[slot];
        mbar_expect_tx(bar, p.stage_bytes);
        const int r0 = (stage0 + it) * KS;  // first raw row: k, or packed row
        tma_load(st, &x_map, bar, r0, t0);
        if constexpr (PACKED) tma_load(st + BT * 128, &x_map, bar, half_k + r0, t0);
        tma_load(st + X_BYTES, &q_map, bar, n_blk, r0);
        tma_load(st + X_BYTES + KS * WG_COLS, &q_map, bar, n_blk + WG_COLS, r0);
        if constexpr (SCALES == GROUP_ROWS) {
          unsigned char* sz = st + X_BYTES + Q_BYTES;
          const int box = p.sz_rows * COLS * 4;
          const int g0 = r0 / p.group;
          tma_load(sz, &s_map, bar, n_blk, g0);
          tma_load(sz + box, &z_map, bar, n_blk, g0);
          if constexpr (PACKED) {
            tma_load(sz + 2 * box, &s_map, bar, n_blk, p.half_groups + g0);
            tma_load(sz + 3 * box, &z_map, bar, n_blk, p.half_groups + g0);
          }
        }
      }
    }
  } else {
    // Consumers.
    regs_grow<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int c = warp * 8 + g;
    const int col = n_blk + wg * WG_COLS + 4 * c;  // first of this thread's columns
    const bool live = col < p.N;
    const int group_shift = 31 - __clz(p.group);  // ROW_GLOBAL: groups are powers of two

    float acc[2][ACC];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        acc[i][e] = 0.0f;
        hold(acc[i][e]);
      }
    }
    uint32_t a[2][2 * ATOMS][4];  // [buffer][tile (+ 2: high half)][register]

    for (int it = 0; it < count; ++it) {
      const int slot = it % S;
      mbar_wait(&full[slot], (it / S) & 1);
      const unsigned char* st = smem + slot * p.stage_bytes;
      const uint32_t x_addr = smem_u32(st);
      const unsigned char* qs = st + X_BYTES + wg * KS * WG_COLS;
      const float* sz = reinterpret_cast<const float*>(st + X_BYTES + Q_BYTES) + wg * WG_COLS +
                        4 * c;
      const int r0 = (stage0 + it) * KS;
#pragma unroll
      for (int s = 0; s < KS / 16; ++s) {
        uint32_t(&A)[2 * ATOMS][4] = a[s & 1];
        // Raw rows 16s + 2t + {0, 1, 8, 9}, this thread's four columns; the
        // box came in the 128-byte swizzle (16-byte chunk index ^ row % 8).
        uint32_t w[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int r = 16 * s + 2 * t + (m & 1) + 8 * (m >> 1);
          w[m] = *reinterpret_cast<const uint32_t*>(qs + r * 128 + ((((c >> 2) ^ r) & 7) << 4) +
                                                    ((c & 3) << 2));
        }
        if constexpr (SCALES == PER_COLUMN) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t j = 2 * i + h;
              // Byte j of two rows, 16 bits apart: [row k].j, x, [row k + 1].j, x.
              const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
              A[i][h] = levels_to_bf16x2(__byte_perm(w[0], w[1], sel));
              A[i][2 + h] = levels_to_bf16x2(__byte_perm(w[2], w[3], sel));
            }
          }
        } else {
          // Scale and zero of (half, row m, column j).
          float4 sv[ATOMS][4], zv[ATOMS][4];
          if constexpr (SCALES == GROUP_ROWS) {
            // The step's 16 rows lie in one group (G is a multiple of 16).
            const int srow = (r0 + 16 * s) / p.group - r0 / p.group;
#pragma unroll
            for (int h = 0; h < ATOMS; ++h) {
              const float* base = sz + (2 * h * p.sz_rows + srow) * COLS;
              sv[h][0] = *reinterpret_cast<const float4*>(base);
              zv[h][0] = *reinterpret_cast<const float4*>(base + p.sz_rows * COLS);
#pragma unroll
              for (int m = 1; m < 4; ++m) {
                sv[h][m] = sv[h][0];
                zv[h][m] = zv[h][0];
              }
            }
          } else {
            // Groups of 1-8 rows: each row's own, from device memory.
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int k = r0 + 16 * s + 2 * t + (m & 1) + 8 * (m >> 1);
              const size_t at = size_t(k >> group_shift) * p.N + col;
              sv[0][m] = live ? __ldg(reinterpret_cast<const float4*>(p.scale + at))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
              zv[0][m] = live ? __ldg(reinterpret_cast<const float4*>(p.zero + at))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
#pragma unroll
          for (int h = 0; h < ATOMS; ++h) {
            // Each raw word as four exact f32 values plus 2^23 (and, for
            // signed levels, plus 128): the offset leaves before the zero.
            uint32_t v[4];
            float off;
            if constexpr (PACKED) {
#pragma unroll
              for (int m = 0; m < 4; ++m) v[m] = (h == 0 ? w[m] : w[m] >> 4) & 0x0F0F0F0Fu;
              off = 8388608.0f;  // 2^23
            } else {
#pragma unroll
              for (int m = 0; m < 4; ++m) v[m] = w[m] ^ 0x80808080u;
              off = 8388736.0f;  // 2^23 + 128
            }
            auto wt = [&](int m, int j) {
              return dequant(__fsub_rn(byte_plus_2p23(v[m], j), off), lane_of(sv[h][m], j),
                             lane_of(zv[h][m], j));
            };
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int j = 2 * i + hh;
                A[2 * h + i][hh] = pack_bf16x2(wt(0, j), wt(1, j));
                A[2 * h + i][2 + hh] = pack_bf16x2(wt(2, j), wt(3, j));
              }
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < ATOMS; ++h) {
          const uint64_t desc = sw128_desc(x_addr + h * BT * 128 + 32 * s);
          wgmma_rs<BT>(acc[0], A[2 * h], desc);
          wgmma_rs<BT>(acc[1], A[2 * h + 1], desc);
        }
        wgmma_commit();
        // The step before this one is done: its A registers may be written
        // again, and after the first step of a stage the stage before it
        // may be refilled. (ptxas goes further and waits for this step too,
        // C7513: it does not let an instruction write the A registers of a
        // later wgmma while one is pending. So a warpgroup's dequantization
        // and its products take turns, and the overlap comes from the other
        // consumer warpgroup.)
        wgmma_wait<1>();
        if (s == 0 && it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < ACC; ++e) hold(acc[i][e]);
    }

    if (live) {
      float4 sc = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (SCALES == PER_COLUMN) sc = __ldg(reinterpret_cast<const float4*>(p.scale + col));
      float* dst = p.out + size_t(blockIdx.z) * p.T * p.N + col;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = t0 + 8 * j + 2 * t + e;
          if (row >= p.T) continue;
          float4 o = make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                                 acc[1][4 * j + 2 + e]);
          if constexpr (SCALES == PER_COLUMN) {
            o.x = __fmul_rn(o.x, sc.x);
            o.y = __fmul_rn(o.y, sc.y);
            o.z = __fmul_rn(o.z, sc.z);
            o.w = __fmul_rn(o.w, sc.w);
          }
          *reinterpret_cast<float4*>(dst + size_t(row) * p.N) = o;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime has loaded: the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2-D tensor map of `rows` rows of `cols` elements, `row_bytes` apart,
// read in boxes of box_rows x box_cols; parts of a box outside the tensor
// arrive as zeros and count toward the transaction all the same.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t cols,
                     uint64_t rows, uint64_t row_bytes, uint32_t box_cols, uint32_t box_rows,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Group rows that one stage's KS raw rows touch, at most, in `rows` rows.
inline int group_rows_per_stage(int rows, int group) {
  int most = 0;
  for (int r0 = 0; r0 < rows; r0 += KS) {
    const int n = (r0 + KS - 1) / group - r0 / group + 1;
    most = n > most ? n : most;
  }
  return most;
}

inline int stage_bytes(int bt, bool packed, int scales, int sz_rows) {
  const int atoms = packed ? 2 : 1;
  const int sz = scales == GROUP_ROWS ? 2 * atoms * sz_rows * COLS * 4 : 0;
  return atoms * bt * 128 + 2 * KS * WG_COLS + sz;
}

// Dynamic shared memory a launch may ask for: the limit less the static
// barriers, rounded down to the alignment step.
constexpr int DYNAMIC_SMEM = SMEM_LIMIT - SMEM_ALIGN;

// out (f32 [T, N]) = x @ dequant(q): the launch and, with splits > 1 (into
// `partial`, f32 [splits, T, N]), the fixed-order sum. K counts columns of
// x (for packed weights twice their rows). Returns 0, a CUDA error code, -1
// for arguments this body does not take, or -2 if a tensor map could not be
// made.
template <int BT, bool PACKED, int SCALES>
int launch(const void* x, int x_stride, const void* q, const float* scale, const float* zero,
           float* out, float* partial, int T, int K, int N, int group, int stages, int splits,
           cudaStream_t stream) {
  const int rows = PACKED ? K / 2 : K;
  const int k_stages = rows / KS;
  if (rows % KS || splits < 1 || k_stages % splits || stages < 1 || stages > MAX_STAGES)
    return -1;
  const int sz_rows = SCALES == GROUP_ROWS ? group_rows_per_stage(rows, group) : 0;
  const int sb = stage_bytes(BT, PACKED, SCALES, sz_rows);
  const int smem = stages * sb + SMEM_ALIGN;
  if (smem > DYNAMIC_SMEM) return -1;
  CUtensorMap xm, qm, sm, zm;
  if (!make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, T, uint64_t(x_stride) * 2, 64, BT,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, rows, N, WG_COLS, KS,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  sm = xm;
  zm = xm;
  if (SCALES == GROUP_ROWS &&
      (!make_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, K / group, uint64_t(N) * 4, COLS,
                 sz_rows, CU_TENSOR_MAP_SWIZZLE_NONE) ||
       !make_map(&zm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, zero, N, K / group, uint64_t(N) * 4, COLS,
                 sz_rows, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return -2;
  auto kernel = dequant_gemm_kernel<BT, PACKED, SCALES>;
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
  prm.sz_rows = sz_rows;
  prm.half_groups = PACKED ? rows / group : 0;
  prm.stages = stages;
  prm.stage_bytes = sb;
  prm.scale = scale;
  prm.zero = zero;
  prm.out = splits > 1 ? partial : out;
  const dim3 grid((N + COLS - 1) / COLS, (T + BT - 1) / BT, splits);
  kernel<<<grid, THREADS, smem, stream>>>(xm, qm, sm, zm, prm, rows);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && splits > 1) err = launch_split_reduce(partial, out, T, N, splits, stream);
  return static_cast<int>(err);
}

}  // namespace dqg
