// Matmul on an unpacked grouped container (one int8 level per byte) for
// Hopper, sm_90a.
//
//   out[T, N] (f32) = x[T, K] (bf16) @ w[K, N],
//   w[k, n] = (q[k, n] - zero[k / G, n]) * scale[k / G, n]
//
// q is int8 [K, N] holding any level in -128..127: GGUF Q5/Q6 levels
// (0..31, 0..63), Q8_0's signed bytes, the IQ4 table values, or 0..15 of an
// act-order GPTQ checkpoint whose scales are per row (G = 1). scale and zero
// are f32 [K / G, N]; zero is any float.
//
// Replaces three TPU kernels of aphrodite_tpu/ops/quant_matmul.py:
// int4_matmul_pallas (body _kernel), int4_matmul_pallas_groupwise (body
// _kernel_groupwise) and int4_matmul_pallas_stacked (bodies
// _kernel_stacked_dense and _kernel_stacked_groupwise). The stacked form's
// prefetched layer index is a pointer offset made by the wrapper. The TPU
// grid with its sequential k axis and VMEM accumulator is not carried over:
// the k axis is a loop inside the block over a ring of cp.async stages and
// the accumulators are tensor-core fragments in registers.
//
// Three level bodies. At T >= 64 the wrapper sends the dense body's calls to
// the wgmma body of dequant_gemm.cuh (int4_matmul_dense_wgmma below), with
// the same arithmetic, and int8 per-column containers (G = K, zero 0) to its
// per-column form; the TPU's int4_matmul_dispatch takes its dense body at
// T >= 64 too. This file's two bodies serve T < 64 and calls that name the
// group-wise body, as on the TPU:
//
// - dense: every level is converted to f32, w = (q - zero) * scale is formed
//   in f32 and rounded to bf16, and the tile goes to mma.sync with f32
//   accumulation. This is the plain version's arithmetic, so the two agree to
//   the order of the f32 sums. Takes any G that divides 64 or is a multiple of
//   64. For G < 16 the scale and zero of every row of the tile are staged
//   beside the levels (a 32-row k tile, three stages), so a G = 1 container
//   streams its eight bytes of scale and zero per weight as tiles.
// - group-wise: raw levels go to the tensor cores as bf16 and the group's
//   scale and zero are applied to f32 partial sums,
//     out += s_g * (x_g @ q_g) - (s_g * z_g) * rowsum(x_g),
//   with s_g * z_g formed once in f32 and rowsum(x_g) taken by one more mma
//   of the same bf16 x against ones. It does not round w to bf16, so it
//   agrees with the exact f32-weight product to the order of the sums and
//   with the plain version to that rounding. Takes G = 16, 32, 64 or a
//   multiple of 64.
//
// A level cannot be made bf16 by or-ing it into a mantissa as the packed
// kernel does with a nibble: bf16 has 7 mantissa bits. The group-wise body
// builds 128 + (low 7 bits) that way and subtracts 128 or 256 by the sign bit
// in one bf16x2 subtraction, which is exact: four logic or arithmetic
// instructions per two levels. The dense body pays a conversion, a subtract
// and a multiply per level and a rounding per two.
//
// Each of these two bodies has a second implementation, the decode body of
// decode_gemm.cuh (int4_matmul_decode below: forms DENSE, DENSE_ROWS and
// GROUPWISE, one block an SM, a TMA ring, tokens as the n dimension, with
// the same arithmetic), and the wrapper picks one of the two by shape
// (decode_route). The rest of this note is about the kernel in this file.
//
// Bound on the H100: at small T bytes (K * N level bytes plus 8 * (K / G) * N
// of scale and zero against 2 * T * K * N operations); at large T operations.
// Every level byte is read from device memory once per row block, as full
// 128-byte lines; sites with few 128-column strips split K across blockIdx.z
// and a second kernel adds the partials in a fixed order. The dense body
// takes 64-row blocks so that one conversion serves four row tiles.
//
// Shape rules (checked by the wrapper): N % 128 == 0, K % 64 == 0, G as
// above, x bf16 with unit stride in its last axis and a row stride that is a
// multiple of 8, all pointers 16-byte aligned.
//
// A third body, e4m3, is the FP8 W8A8 product of
// aphrodite_tpu/quantization/qlinear.py: _fp8_w8a8_matmul, which the JAX
// package leaves to XLA (no Pallas kernel): x is the per-token e4m3
// quantizer's output (one byte a value, [T, K]) and q the e4m3 weight [K,
// N], row-major like every other container here; the result is the f32
// sum of the e4m3 products, and the wrapper multiplies act_scale and scale
// after, in f32, as the JAX package does. Both operands are widened from
// e4m3 to f16 in registers, one cvt per two values (every e4m3 value is
// exact in f16, as in bf16), and go to the f16 mma.sync with f32
// accumulators: each product of two 4-bit significands is exact, so the
// result differs from the JAX package's only in the order of its f32
// sums. Hopper's fp8 tensor cores (torch._scaled_mm) keep fewer bits than
// f32 inside each k step; that loss is what this body exists to avoid. It
// reads the same bytes per weight as the level bodies, x at one byte a
// value, and stages no scale or zero rows.
//
// Shape rules of the e4m3 body: N % 128 == 0, K % 64 == 0, x's row stride
// a multiple of 16. It serves the FP8 product under 32 tokens; from there
// the wrapper takes the e4m3 form of the wgmma prefill body
// (fp8_w8a8_matmul_f16 below), on the same arithmetic.

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "decode_gemm.cuh"
#include "dequant_gemm.cuh"
#include "matmul_common.cuh"

namespace {

constexpr int BN = 128;  // output columns per block
constexpr int THREADS = 128;
constexpr int Q_LD = BN + 16;     // bytes per level row in shared memory
constexpr int SZ_LD = 2 * BN + 4; // floats per staged group row: scale, zero, padding

constexpr int GROUPWISE = 0;
constexpr int DENSE = 1;
constexpr int E4M3 = 2;

// A warp owns 32 columns as four 8-column tiles, interleaved: tile j holds
// columns 4 * i + j, so the four level bytes a thread loads as one word
// belong to its four tiles.

__device__ __forceinline__ float level(uint32_t word, int j) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * j)) & 0xFFu));
}

__device__ __forceinline__ float component(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

using dqg::e4m3x2_to_f16x2;

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t dequant_pair(uint32_t w_even, uint32_t w_odd, int j, float s0,
                                                 float z0, float s1, float z1) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn(__fsub_rn(level(w_even, j), z0), s0),
                                                 __fmul_rn(__fsub_rn(level(w_odd, j), z1), s1));
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int FM, int BK, int STAGES, int BODY>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const void* __restrict__ x, const uint8_t* __restrict__ q,
                   const float* __restrict__ scale, const float* __restrict__ zero,
                   float* __restrict__ out, int T, int K, int N, int group, int x_stride,
                   int tiles_per_split, int sz_rows) {
  constexpr int BM = 16 * FM;
  constexpr bool FP8 = BODY == E4M3;
  constexpr int X_SIZE = FP8 ? 1 : 2;      // bytes per x value
  constexpr int X_VEC = 16 / X_SIZE;       // x values per 16-byte copy
  constexpr int X_LD = BK + 16 / X_SIZE;   // x values per row in shared memory
  constexpr int Q_BYTES = BK * Q_LD;
  constexpr int X_BYTES = BM * X_LD * X_SIZE;
  constexpr int STEPS = BK / 16;
  // Scale and zero rows differ inside one 16-row mma step.
  constexpr bool PER_ROW = BODY == DENSE && BK == 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_bytes = Q_BYTES + X_BYTES + sz_rows * SZ_LD * 4;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;    // fragment row (A, C) or column (B)
  const int tig = lane % 4;  // fragment k pair (A, B) or column pair (C)
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int num_tiles = K / BK;
  const int tile_begin = blockIdx.z * tiles_per_split;
  const int tile_end = min(num_tiles, tile_begin + tiles_per_split);
  const int count = max(0, tile_end - tile_begin);
  // A group smaller than the tile is a power of two (it divides 64).
  const bool small_group = group < BK;
  const int group_shift = 31 - __clz(group);

  // Group-wise body, a group of at least one tile: the last tile of a group,
  // or of this block's k range, folds the partial sums into the output.
  auto closes_group = [&](int tile) {
    return ((tile + 1) * BK) % group == 0 || tile == tile_end - 1;
  };

  auto fetch = [&](int tile, int slot) {
    unsigned char* base = smem + slot * stage_bytes;
    const int k0 = tile * BK;
    for (int c = tid; c < BK * (BN / 16); c += THREADS) {
      const int row = c / (BN / 16);
      const int ch = c % (BN / 16);
      cp_async16(base + row * Q_LD + ch * 16, q + size_t(k0 + row) * N + n0 + ch * 16, 16);
    }
    const unsigned char* xb = static_cast<const unsigned char*>(x);
    for (int c = tid; c < BM * (BK / X_VEC); c += THREADS) {
      const int row = c / (BK / X_VEC);
      const int ch = c % (BK / X_VEC);
      const bool live = m0 + row < T;
      // A row at or past T is zero-filled: no byte of it is read.
      cp_async16(base + Q_BYTES + (row * X_LD + ch * X_VEC) * X_SIZE,
                 xb + (size_t(live ? m0 + row : 0) * x_stride + k0 + ch * X_VEC) * X_SIZE,
                 live ? 16 : 0);
    }
    if (!FP8 && (BODY == DENSE || small_group || closes_group(tile))) {
      const int grow0 = k0 / group;
      for (int c = tid; c < sz_rows * (2 * BN / 4); c += THREADS) {
        const int row = c / (2 * BN / 4);
        const int arr = (c / (BN / 4)) % 2;  // scale, zero
        const int ch = c % (BN / 4);
        const float* src = (arr == 0 ? scale : zero) + size_t(grow0 + row) * N + n0 + ch * 4;
        cp_async16(base + Q_BYTES + X_BYTES + (row * SZ_LD + arr * BN + ch * 4) * 4, src, 16);
      }
    }
  };

  float acc[FM][4][4];  // output: [row tile][column tile][fragment]
  // Group-wise body only: x_g @ q_g and rowsum(x_g) of the open group.
  float part[BODY == GROUPWISE ? FM : 1][4][4];
  float rsum[BODY == GROUPWISE ? FM : 1][4];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }
  auto clear_group = [&]() {
#pragma unroll
    for (int i = 0; i < (BODY == GROUPWISE ? FM : 0); ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rsum[i][e] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j][e] = 0.0f;
      }
    }
  };
  clear_group();

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < count) fetch(tile_begin + p, p);
    cp_async_commit();
  }

  constexpr uint32_t kOnes = 0x3F803F80u;  // bf16 1.0 twice

  for (int it = 0; it < count; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` has landed; the slot of tile it - 1 is free
    const int ahead = it + STAGES - 1;
    if (ahead < count) fetch(tile_begin + ahead, ahead % STAGES);
    cp_async_commit();

    const int tile = tile_begin + it;
    const unsigned char* base = smem + (it % STAGES) * stage_bytes;
    const unsigned char* qs = base;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base + Q_BYTES);
    const unsigned char* xs8 = base + Q_BYTES;
    const float* sz = reinterpret_cast<const float*>(base + Q_BYTES + X_BYTES);
    const bool tile_closes = BODY == GROUPWISE && !small_group && closes_group(tile);

#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      // The four level rows this thread's B fragments take, four tiles wide.
      const unsigned char* qrow = qs + (16 * s + tig * 2) * Q_LD + warp * 32 + g * 4;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qrow);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qrow + Q_LD);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(qrow + 8 * Q_LD);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(qrow + 9 * Q_LD);
      uint32_t a[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        if constexpr (FP8) {
          // Two consecutive k of one row per register, widened to f16.
          const unsigned char* xr = xs8 + (i * 16 + g) * X_LD + 16 * s + tig * 2;
          a[i][0] = e4m3x2_to_f16x2(*reinterpret_cast<const uint16_t*>(xr));
          a[i][1] = e4m3x2_to_f16x2(*reinterpret_cast<const uint16_t*>(xr + 8 * X_LD));
          a[i][2] = e4m3x2_to_f16x2(*reinterpret_cast<const uint16_t*>(xr + 8));
          a[i][3] = e4m3x2_to_f16x2(*reinterpret_cast<const uint16_t*>(xr + 8 * X_LD + 8));
        } else {
          const __nv_bfloat16* xr = xs + (i * 16 + g) * X_LD + 16 * s + tig * 2;
          a[i][0] = *reinterpret_cast<const uint32_t*>(xr);
          a[i][1] = *reinterpret_cast<const uint32_t*>(xr + 8 * X_LD);
          a[i][2] = *reinterpret_cast<const uint32_t*>(xr + 8);
          a[i][3] = *reinterpret_cast<const uint32_t*>(xr + 8 * X_LD + 8);
        }
      }
      // The staged scale and zero row of this step's group.
      const int srow = small_group ? (16 * s) >> group_shift : 0;

      if constexpr (FP8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // Byte j of rows k and k + 1, low byte first.
          const uint32_t sel = j | ((4 + j) << 4);
          const uint32_t b0 = e4m3x2_to_f16x2(__byte_perm(w0, w1, sel));
          const uint32_t b1 = e4m3x2_to_f16x2(__byte_perm(w8, w9, sel));
#pragma unroll
          for (int i = 0; i < FM; ++i) mma_f16(acc[i][j], a[i], b0, b1);
        }
      } else if constexpr (BODY == GROUPWISE) {
#pragma unroll
        for (int i = 0; i < FM; ++i) mma_bf16(rsum[i], a[i], kOnes, kOnes);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // Byte j of two rows, 16 bits apart: [row k].j, x, [row k + 1].j, x.
          const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
          const uint32_t b0 = levels_to_bf16x2(__byte_perm(w0, w1, sel));
          const uint32_t b1 = levels_to_bf16x2(__byte_perm(w8, w9, sel));
#pragma unroll
          for (int i = 0; i < FM; ++i) mma_bf16(part[i][j], a[i], b0, b1);
        }
        const bool closes = small_group ? ((16 * (s + 1)) & (group - 1)) == 0
                                        : (s == STEPS - 1 && tile_closes);
        if (closes) {
          const float* szr = sz + srow * SZ_LD;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* col = szr + warp * 32 + 4 * (tig * 2 + e);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float sc = col[j];
              const float scz = sc * col[BN + j];
#pragma unroll
              for (int i = 0; i < FM; ++i) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int f = 2 * h + e;  // fragment element: row g + 8h, column pair e
                  acc[i][j][f] += fmaf(sc, part[i][j][f], -(scz * rsum[i][2 * h]));
                }
              }
            }
          }
          clear_group();
        }
      } else {
        const float* szc = sz + warp * 32 + g * 4;
        float4 sv[4], zv[4];  // rows tig * 2 + {0, 1, 8, 9} of this step
        if constexpr (PER_ROW) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int krow = 16 * s + tig * 2 + (r & 1) + 8 * (r >> 1);
            const float* szr = szc + (krow >> group_shift) * SZ_LD;
            sv[r] = *reinterpret_cast<const float4*>(szr);
            zv[r] = *reinterpret_cast<const float4*>(szr + BN);
          }
        } else {
          sv[0] = *reinterpret_cast<const float4*>(szc + srow * SZ_LD);
          zv[0] = *reinterpret_cast<const float4*>(szc + srow * SZ_LD + BN);
#pragma unroll
          for (int r = 1; r < 4; ++r) {
            sv[r] = sv[0];
            zv[r] = zv[0];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = dequant_pair(w0, w1, j, component(sv[0], j), component(zv[0], j),
                                           component(sv[1], j), component(zv[1], j));
          const uint32_t b1 = dequant_pair(w8, w9, j, component(sv[2], j), component(zv[2], j),
                                           component(sv[3], j), component(zv[3], j));
#pragma unroll
          for (int i = 0; i < FM; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
        }
      }
    }
  }

  float* dst = out + size_t(blockIdx.z) * T * N;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + i * 16 + g + 8 * h;
      if (row >= T) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + warp * 32 + 4 * (tig * 2 + e);
        const int f = 2 * h + e;
        *reinterpret_cast<float4*>(dst + size_t(row) * N + col) =
            make_float4(acc[i][0][f], acc[i][1][f], acc[i][2][f], acc[i][3][f]);
      }
    }
  }
}

template <int FM, int BK, int STAGES, int BODY>
cudaError_t launch(const void* x, const void* q, const void* scale, const void* zero, float* dst,
                   int T, int K, int N, int group, int x_stride, int splits, cudaStream_t stream) {
  constexpr int BM = 16 * FM;
  const int num_tiles = K / BK;
  if (splits > num_tiles) return cudaErrorInvalidValue;
  const int tiles_per_split = (num_tiles + splits - 1) / splits;
  const int sz_rows = BODY == E4M3 ? 0 : group >= BK ? 1 : BK / group;
  constexpr int X_SIZE = BODY == E4M3 ? 1 : 2;
  const int smem = STAGES * (BK * Q_LD + BM * (BK + 16 / X_SIZE) * X_SIZE + sz_rows * SZ_LD * 4);
  auto kernel = int4_matmul_kernel<FM, BK, STAGES, BODY>;
  // The shared memory grows with the scale rows per tile (smaller groups):
  // the limit of this instantiation is raised only when a launch needs more.
  static int configured_smem = 0;
  if (smem > configured_smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured_smem = smem;
  }
  dim3 grid(N / BN, (T + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, smem, stream>>>(
      x, static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<const float*>(zero), dst, T, K, N, group,
      x_stride, tiles_per_split, sz_rows);
  return cudaGetLastError();
}

template <int BK, int STAGES, int BODY>
cudaError_t launch_rows(int block_m, const void* x, const void* q, const void* scale,
                        const void* zero, float* dst, int T, int K, int N, int group,
                        int x_stride, int splits, cudaStream_t stream) {
  switch (block_m) {
    case 16:
      return launch<1, BK, STAGES, BODY>(x, q, scale, zero, dst, T, K, N, group, x_stride, splits,
                                         stream);
    case 32:
      return launch<2, BK, STAGES, BODY>(x, q, scale, zero, dst, T, K, N, group, x_stride, splits,
                                         stream);
    case 64:
      return launch<4, BK, STAGES, BODY>(x, q, scale, zero, dst, T, K, N, group, x_stride, splits,
                                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// body: 0 group-wise, 1 dense. block_m: rows of x per block, 16, 32 or 64.
// splits: how many blocks share the k range of one output tile, counted in k
// tiles of 64 rows (32 for the dense body with G < 16); with splits > 1,
// `partial` is an f32 scratch buffer [splits, T, N] and a second kernel sums
// it into out. Returns the CUDA error code of the launches (0 = success), or
// -1 for arguments the kernel does not take.
extern "C" int int4_matmul_bf16(const void* x, const void* q, const void* scale,
                                const void* zero, void* out, void* partial, int T, int K, int N,
                                int group, int x_stride, int block_m, int splits, int body,
                                void* stream_ptr) {
  if (T < 1 || N % BN != 0 || K % 64 != 0 || group < 1 || x_stride % 8 != 0 || splits < 1)
    return -1;
  const bool tile_group = 64 % group == 0 || group % 64 == 0;
  if (!tile_group || (body == GROUPWISE && group < 16) || (body != GROUPWISE && body != DENSE))
    return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  cudaError_t err;
  if (body == GROUPWISE) {
    err = launch_rows<64, 4, GROUPWISE>(block_m, x, q, scale, zero, dst, T, K, N, group, x_stride,
                                        splits, stream);
  } else if (group >= 16) {
    err = launch_rows<64, 4, DENSE>(block_m, x, q, scale, zero, dst, T, K, N, group, x_stride,
                                    splits, stream);
  } else {
    err = launch_rows<32, 3, DENSE>(block_m, x, q, scale, zero, dst, T, K, N, group, x_stride,
                                    splits, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) err = launch_split_reduce(partial, out, T, N, splits, stream);
  return static_cast<int>(err);
}

// The dense (body 1) or group-wise (body 0) body on the decode body
// (decode_gemm.cuh; a dense call with G < 16 takes its DENSE_ROWS form).
// t_tile: token rows per block, 8, 16, 32 or 64 (more tokens take more
// blocks). stages: the ring's depth (0: as many as fit). splits: how many
// blocks share the k range of one output tile, dividing the K / 64 stages;
// with splits > 1, `partial` is an f32 scratch buffer [splits, T, N] that a
// second kernel sums into out in a fixed order. `rs` (group-wise body) is
// an f32 scratch buffer [K / 16, T rounded up to t_tile] for the step sums
// of x. Returns the CUDA error code of the launches (0 = success), -1 for
// arguments the body does not take, or -2 if a tensor map could not be
// made.
extern "C" int int4_matmul_decode(const void* x, const void* q, const void* scale,
                                  const void* zero, void* out, void* partial, void* rs, int T,
                                  int K, int N, int group, int x_stride, int t_tile, int stages,
                                  int splits, int body, void* stream_ptr) {
  if (T < 1 || N % BN != 0 || K % 64 != 0 || group < 1 || K % group != 0 || x_stride % 8 != 0)
    return -1;
  const bool tile_group = 64 % group == 0 || group % 64 == 0;
  if (!tile_group || (body == GROUPWISE && group < 16) || (body != GROUPWISE && body != DENSE))
    return -1;
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partial);
  float* sums = static_cast<float*>(rs);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (body == GROUPWISE)
    return dqd::launch_tile<dqd::GROUPWISE>(t_tile, x, x_stride, q, s, z, o, part, sums, T, K, N,
                                            group, stages, splits, stream);
  if (group >= 16)
    return dqd::launch_tile<dqd::DENSE>(t_tile, x, x_stride, q, s, z, o, part, nullptr, T, K, N,
                                        group, stages, splits, stream);
  return dqd::launch_tile<dqd::DENSE_ROWS>(t_tile, x, x_stride, q, s, z, o, part, nullptr, T, K, N,
                                           group, stages, splits, stream);
}

// The e4m3 body: out (f32 [T, N]) = the f32 sum of the products of x
// (e4m3 [T, K], row stride x_stride) and q (e4m3 [K, N], row-major), with
// no scale applied. block_m and splits as above, in k tiles of 64 rows.
// Returns the CUDA error code of the launches (0 = success), or -1 for
// arguments the kernel does not take.
extern "C" int fp8_w8a8_matmul_e4m3(const void* x, const void* q, void* out, void* partial, int T,
                                    int K, int N, int x_stride, int block_m, int splits,
                                    void* stream_ptr) {
  if (T < 1 || N % BN != 0 || K % 64 != 0 || x_stride % 16 != 0 || splits < 1) return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  cudaError_t err = launch_rows<64, 4, E4M3>(block_m, x, q, nullptr, nullptr, dst, T, K, N, K,
                                             x_stride, splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) err = launch_split_reduce(partial, out, T, N, splits, stream);
  return static_cast<int>(err);
}

// The wgmma body (dequant_gemm.cuh) for the dense arithmetic, or with
// per_column = 1 for an int8 per-column container (G = K, zero unused,
// scale [1, N] applied to the f32 sums). block_t, stages and splits as for
// int4p_matmul_dense_bf16, splits dividing the K / 64 stages. Returns the
// CUDA error code of the launches (0 = success), -1 for arguments the body
// does not take, or -2 if a tensor map could not be made.
extern "C" int int4_matmul_dense_wgmma(const void* x, const void* q, const void* scale,
                                       const void* zero, void* out, void* partial, int T, int K,
                                       int N, int group, int x_stride, int block_t, int stages,
                                       int splits, int per_column, void* stream_ptr) {
  if (T < 1 || N % BN != 0 || K % dqg::KS != 0 || group < 1 || K % group != 0 ||
      (64 % group != 0 && group % 64 != 0) || x_stride % 8 != 0 || (per_column && group != K))
    return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partial);
  const int scales = per_column ? dqg::PER_COLUMN : group < 16 ? dqg::ROW_GLOBAL
                                                               : dqg::GROUP_ROWS;
#define DQG_LAUNCH(bt, sc)                                                                   \
  dqg::launch<bt, false, sc>(x, x_stride, q, s, z, o, part, T, K, N, group, stages, splits, \
                             stream)
  switch (block_t * 4 + scales) {
    case 64 * 4 + dqg::GROUP_ROWS:
      return DQG_LAUNCH(64, dqg::GROUP_ROWS);
    case 64 * 4 + dqg::ROW_GLOBAL:
      return DQG_LAUNCH(64, dqg::ROW_GLOBAL);
    case 64 * 4 + dqg::PER_COLUMN:
      return DQG_LAUNCH(64, dqg::PER_COLUMN);
    case 128 * 4 + dqg::GROUP_ROWS:
      return DQG_LAUNCH(128, dqg::GROUP_ROWS);
    case 128 * 4 + dqg::ROW_GLOBAL:
      return DQG_LAUNCH(128, dqg::ROW_GLOBAL);
    case 128 * 4 + dqg::PER_COLUMN:
      return DQG_LAUNCH(128, dqg::PER_COLUMN);
    default:
      return -1;
  }
#undef DQG_LAUNCH
}

// The FP8 W8A8 product on f16 wgmma (the E4M3_F16 form of the prefill body,
// dequant_gemm.cuh): xq16 (the quantizer's e4m3 activations as f16 [T, K],
// contiguous) @ q (e4m3 [K, N], row-major), times act_scale (f32 [T]) and
// then scale (f32 [N]) in the store, or in the pass that sums the partials
// of a split K. block_t token rows per block (64 or 128), a ring of
// `stages` stages, splits dividing the K / 64 stages. Returns the CUDA
// error code of the launches (0 = success), -1 for arguments the body does
// not take, or -2 if a tensor map could not be made.
extern "C" int fp8_w8a8_matmul_f16(const void* xq16, const void* q, const void* act_scale,
                                   const void* scale, void* out, void* partial, int T, int K,
                                   int N, int block_t, int stages, int splits, void* stream_ptr) {
  if (T < 1 || N % BN != 0 || K % dqg::KS != 0) return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* as = static_cast<const float*>(act_scale);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partial);
  switch (block_t) {
    case 64:
      return dqg::launch<64, false, dqg::E4M3_F16>(xq16, K, q, sc, nullptr, o, part, T, K, N, K,
                                                   stages, splits, stream, as);
    case 128:
      return dqg::launch<128, false, dqg::E4M3_F16>(xq16, K, q, sc, nullptr, o, part, T, K, N,
                                                    K, stages, splits, stream, as);
    default:
      return -1;
  }
}
