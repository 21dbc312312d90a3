// W4A8 matmul on half-split packed int4 weights, and the per-token
// activation quantizer, for Hopper, sm_90a.
//
//   xq[T, K] (int8), sx[T] = quantize(x[T, K] bf16), per token
//   out[T, N] (f32) = sx[T] * sum_g ( s_g * (xq_g @ q_g) - (s_g * z_g) * rowsum(xq_g) )
//
// Replaces the TPU kernel aphrodite_tpu/ops/quant_matmul.py:
// int4p_matmul_w4a8_pallas (body _kernel_packed_w4a8), and the activation
// quantization around it (quantize_activations_int8, jnp code that XLA fuses
// on the TPU). The storage is the W4A16 kernel's (int4p_matmul.cu), unchanged:
// packed row i of q4p[K/2, N] holds original row i in its low nibble and row
// i + K/2 in its high nibble; scale and zero are f32 [K/G, N]. One container
// serves both kernels.
//
// Arithmetic: the TPU body's. The nibbles (0..15) and xq (-127..127) go to the
// tensor cores as int8 (mma.sync m16n8k32, s8 x s8 -> s32), so each group's
// product xq_g @ q_g is an exact int32, and so is rowsum(xq_g), taken by one
// more mma against a matrix of ones, which leaves it in the register layout of
// the products. Scale and zero are applied to the int32 sums in f32 per group,
// as on the TPU; sx, which the JAX package multiplies in outside its kernel,
// is folded into the store here (and into each partial of a split K, which
// only reorders the f32 rounding), which saves a launch.
//
// B fragments need four consecutive k of one column in each 32-bit register,
// but the weight is [K/2, N] with N contiguous, and on sm_90 ldmatrix moves
// only 16-bit elements (no 8-bit transpose). So each thread reads one word
// from each of four consecutive packed rows (four columns of each row) and
// transposes the 4x4 bytes with six __byte_perm; the nibble planes are then
// split with & 0x0F0F0F0F and (>> 4) & 0x0F0F0F0F, the TPU kernel's own trick
// (masking commutes with the byte transpose): per four weights, 1.5 byte
// permutes and one mask or shift-and-mask per plane. A wgmma form with the
// same A fragments from registers (s8 x s8 -> s32, x by TMA in the 128-byte
// swizzle, the int32 sums of a group folded in f32 with row sums the
// quantizer wrote) was built and timed 1.6-7x slower than this kernel on an
// H100, at every T and group (PERF.md): with the f32 outputs and the open
// group's int32 sums in registers, a 384-thread block's consumers have room
// for 32 or 64 token rows, and their fragment builds, waits and folds left
// the tensor cores idle.
//
// Bound on the H100:
// - small T (decode): bytes. K * N / 2 weight bytes and 8 * (K / G) * N bytes of
//   scale and zero against 2 * T * K * N operations: at T = 32 about 115
//   operations per byte, far below the ~590 of the int8 ridge (1979 TOPS over
//   3.35 TB/s). What the design does: as in the W4A16 kernel, every packed byte
//   is read from device memory once per call (one block per 128-column strip
//   and k range, all T <= 32 rows in that block) as full 128-byte lines through
//   a ring of cp.async stages, and sites with few strips split K across
//   blockIdx.z so that all 132 SMs have blocks; the partials are summed in a
//   fixed order by a second kernel (no atomics). x is read as 1 byte a value
//   (xq) where the W4A16 kernel reads 2, and per four weights the kernel pays
//   about 4 logic operations where W4A16 pays 3.
// - large T (prefill): operations, 2 * T * K * N against the int8 rate of 1979
//   TOPS (twice bf16's 989 TFLOP/s). mma.sync m16n8k32 reaches only part of
//   that rate; there is no TMA, a row block is only 32 rows and each 32-row
//   block reads the strip's packed bytes again (from L2 for the most part).
//   wgmma, TMA and larger row blocks are later work.
//
// A block computes 16 or 32 rows by 128 columns over k tiles of 32 packed rows
// = 64 values of k (32 from the low half of K and 32 from the high half), one
// k32 mma step per plane. Rows at and past T are zero-filled on load and
// masked on store, so any T >= 1 works.
//
// Groups shorter than a k tile: a group whose length is an odd multiple of 16
// (GGUF Q2_K and Q3_K pack at 16) closes inside a tile. Such groups take the
// kernel's HALF instantiation, as in the W4A16 kernel: each plane's k32 step
// is issued as its two k16 halves (mma.sync m16n8k16, s8; the halves of the
// k32 A and B fragments are the k16 fragments as they are), the int32 sums
// are folded into f32 after every 16-row half whose rows end a group, and
// each tile fetches the scale and zero rows of both halves. Groups that are
// multiples of 32 take the other instantiation, whose code is the same as
// before HALF came in, so their results are unchanged bit for bit.
//
// Shape rules (checked by the wrapper, and again here): N % 128 == 0,
// G % 16 == 0, (K / 2) % G == 0, (K / 2) % 32 == 0, xq contiguous [T, K], all
// pointers 16-byte aligned.
//
// The quantizer: one block per token row, two passes over the row (the second
// from L1/L2): amax in f32, then
//   int8: sx = max(amax, 1e-8) / 127, xq = round_half_even(x / sx) clipped to
//         +-127 (quantize_activations_int8);
//   e4m3: s = max(amax / 448, 1e-12), xq = e4m3(x / s), nearest even
//         (_fp8_w8a8_matmul's activation cast; |x / s| <= 448, so saturation
//         never changes a value); e4m3_f16 writes the same values as f16
//         (exact), the x operand of the FP8 product's f16 wgmma body.
// IEEE division (__fdiv_rn; this file is never built with fast math) and
// __float2int_rn keep it bit-equal to the plain PyTorch versions. It is bound
// by bytes: 2 read and 1 written per value.

#include <cuda_fp8.h>

#include "matmul_common.cuh"

namespace {

constexpr int BN = 128;      // output columns per block
constexpr int BKP = 32;      // packed rows per k tile
constexpr int STAGES = 4;
constexpr int Q_LD = BN + 16;       // bytes per packed row in shared memory
constexpr int X_LD = 2 * BKP + 16;  // bytes per xq row: 32 low-half k, 32 high-half k, padding
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k16 half of the same product: A rows g and g + 8 at k 4 * tig .. + 3,
// B column g at the same k.
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A warp owns 32 columns as four 8-column tiles, interleaved as in the W4A16
// kernel: tile j holds columns 4 * i + j, so the four packed bytes a thread
// loads as one word belong to its four tiles.
// FM: 16-row tiles of xq per block. HALF: the group is an odd multiple of 16
// rows (see above).
template <int FM, bool HALF>
__global__ void __launch_bounds__(THREADS)
int4p_matmul_w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                         const uint8_t* __restrict__ q4p, const float* __restrict__ scale,
                         const float* __restrict__ zero, float* __restrict__ out, int T, int K,
                         int N, int group, int tiles_per_split) {
  constexpr int BM = 16 * FM;
  constexpr int Q_BYTES = BKP * Q_LD;
  constexpr int X_BYTES = BM * X_LD;
  constexpr int STEPS = BKP / 16;       // 16-row halves per k tile
  // Scale lo, zero lo, scale hi, zero hi: of the group that the tile closes,
  // or (HALF) of the group of each 16-row half.
  constexpr int SZ_SETS = HALF ? STEPS : 1;
  constexpr int SZ_BYTES = SZ_SETS * 4 * BN * 4;
  constexpr int STAGE_BYTES = Q_BYTES + X_BYTES + SZ_BYTES;
  static_assert(STAGES * STAGE_BYTES <= 48 * 1024, "static shared memory");
  __shared__ __align__(16) unsigned char smem[STAGES * STAGE_BYTES];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;    // fragment row (A, C) or column (B)
  const int tig = lane % 4;  // fragment k quad (A, B) or column pair (C)
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int Kh = K / 2;
  const int half_groups = Kh / group;
  const int num_tiles = Kh / BKP;
  const int tile_begin = blockIdx.z * tiles_per_split;
  const int tile_end = min(num_tiles, tile_begin + tiles_per_split);
  const int count = max(0, tile_end - tile_begin);

  // The last tile of a group, or of this block's k range, carries the
  // group's scale and zero and folds the int32 sums into the output.
  auto closes_group = [&](int tile) {
    return ((tile + 1) * BKP) % group == 0 || tile == tile_end - 1;
  };
  // HALF: the same after 16-row half `step` of the tile.
  auto closes_at_step = [&](int tile, int step) {
    return (tile * BKP + 16 * (step + 1)) % group == 0 ||
           (tile == tile_end - 1 && step == STEPS - 1);
  };

  auto fetch = [&](int tile, int slot) {
    unsigned char* base = smem + slot * STAGE_BYTES;
    const int kp0 = tile * BKP;
#pragma unroll
    for (int i = 0; i < BKP * (BN / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BN / 16);
      const int ch = c % (BN / 16);
      cp_async16(base + row * Q_LD + ch * 16, q4p + size_t(kp0 + row) * N + n0 + ch * 16, 16);
    }
    for (int c = tid; c < BM * 4; c += THREADS) {
      const int row = c / 4;
      const int ch = c % 4;  // 0, 1: low half of K; 2, 3: high half
      const int col = (ch < 2 ? kp0 + ch * 16 : Kh + kp0 + (ch - 2) * 16);
      const bool live = m0 + row < T;
      // A row at or past T is zero-filled: no byte of it is read.
      cp_async16(base + Q_BYTES + row * X_LD + ch * 16,
                 xq + size_t(live ? m0 + row : 0) * K + col, live ? 16 : 0);
    }
    if constexpr (HALF) {
      // The group rows of both 16-row halves, whether or not they close.
#pragma unroll
      for (int step = 0; step < STEPS; ++step) {
        const int arr = tid / 32;  // scale lo, zero lo, scale hi, zero hi
        const int grow = (kp0 + 16 * step) / group + (arr >= 2 ? half_groups : 0);
        const float* src = (arr % 2 == 0 ? scale : zero) + size_t(grow) * N + n0 + lane * 4;
        cp_async16(base + Q_BYTES + X_BYTES + ((step * 4 + arr) * BN + lane * 4) * 4, src, 16);
      }
    } else if (closes_group(tile)) {
      const int arr = tid / 32;  // scale lo, zero lo, scale hi, zero hi
      const int grow = kp0 / group + (arr >= 2 ? half_groups : 0);
      const float* src = (arr % 2 == 0 ? scale : zero) + size_t(grow) * N + n0 + lane * 4;
      cp_async16(base + Q_BYTES + X_BYTES + (arr * BN + lane * 4) * 4, src, 16);
    }
  };

  float acc[FM][4][4];  // output: [row tile][column tile][fragment]
  int p_lo[FM][4][4];   // xq_g @ q_g, low half of K (exact)
  int p_hi[FM][4][4];   // the same, high half of K
  int r_lo[FM][4];      // rowsum(xq_g), low half (every column the same)
  int r_hi[FM][4];
  auto clear_group = [&]() {
#pragma unroll
    for (int i = 0; i < FM; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r_lo[i][e] = 0;
        r_hi[i][e] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p_lo[i][j][e] = 0;
          p_hi[i][j][e] = 0;
        }
      }
    }
  };
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }
  clear_group();
  // Folds the group's int32 sums into acc with its scale and zero rows `sz`
  // (scale lo, zero lo, scale hi, zero hi) and clears them for the next one.
  auto fold = [&](const float* sz) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* col = sz + warp * 32 + 4 * (tig * 2 + e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s_lo = col[j];
        const float sz_lo = s_lo * col[BN + j];
        const float s_hi = col[2 * BN + j];
        const float sz_hi = s_hi * col[3 * BN + j];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = 2 * h + e;  // fragment element: row g + 8h, column pair e
            acc[i][j][f] = acc[i][j][f] + s_lo * static_cast<float>(p_lo[i][j][f]) -
                           sz_lo * static_cast<float>(r_lo[i][2 * h]) +
                           s_hi * static_cast<float>(p_hi[i][j][f]) -
                           sz_hi * static_cast<float>(r_hi[i][2 * h]);
          }
        }
      }
    }
    clear_group();
  };

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < count) fetch(tile_begin + p, p);
    cp_async_commit();
  }

  constexpr uint32_t kLow = 0x0F0F0F0Fu;
  constexpr uint32_t kOnes = 0x01010101u;  // int8 1 four times

  for (int it = 0; it < count; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` has landed; the slot of tile it - 1 is free
    const int ahead = it + STAGES - 1;
    if (ahead < count) fetch(tile_begin + ahead, ahead % STAGES);
    cp_async_commit();

    const int tile = tile_begin + it;
    const unsigned char* base = smem + (it % STAGES) * STAGE_BYTES;
    const unsigned char* qs = base;
    const unsigned char* xs = base + Q_BYTES;

    // A fragments (m16n8k32, row): register 0 holds row g, k 4 * tig .. + 3;
    // 1 row g + 8; 2 and 3 the same rows at k + 16. Low plane k 0..31, high
    // plane 32..63 of the staged row.
    uint32_t a_lo[FM][4], a_hi[FM][4];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      const unsigned char* xr = xs + (i * 16 + g) * X_LD + tig * 4;
      a_lo[i][0] = lds32(xr);
      a_lo[i][1] = lds32(xr + 8 * X_LD);
      a_lo[i][2] = lds32(xr + 16);
      a_lo[i][3] = lds32(xr + 8 * X_LD + 16);
      a_hi[i][0] = lds32(xr + BKP);
      a_hi[i][1] = lds32(xr + BKP + 8 * X_LD);
      a_hi[i][2] = lds32(xr + BKP + 16);
      a_hi[i][3] = lds32(xr + BKP + 8 * X_LD + 16);
      if constexpr (!HALF) {
        mma_s8(r_lo[i], a_lo[i], kOnes, kOnes);
        mma_s8(r_hi[i], a_hi[i], kOnes, kOnes);
      }
    }

    // B fragments (col): register 0 holds k 4 * tig .. + 3 of column g,
    // register 1 k 16 + 4 * tig .. + 3. Packed rows 4 * tig + r and
    // 16 + 4 * tig + r, one word (four tiles' columns) each.
    uint32_t cols[2][4];  // [k half][tile]: four consecutive packed rows, one column
    const unsigned char* qrow = qs + (tig * 4) * Q_LD + warp * 32 + g * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* rows = qrow + 16 * h * Q_LD;
      const uint32_t w0 = lds32(rows);
      const uint32_t w1 = lds32(rows + Q_LD);
      const uint32_t w2 = lds32(rows + 2 * Q_LD);
      const uint32_t w3 = lds32(rows + 3 * Q_LD);
      const uint32_t t01l = __byte_perm(w0, w1, 0x5140);  // w0.0 w1.0 w0.1 w1.1
      const uint32_t t01h = __byte_perm(w0, w1, 0x7362);  // w0.2 w1.2 w0.3 w1.3
      const uint32_t t23l = __byte_perm(w2, w3, 0x5140);
      const uint32_t t23h = __byte_perm(w2, w3, 0x7362);
      cols[h][0] = __byte_perm(t01l, t23l, 0x5410);  // w0.0 w1.0 w2.0 w3.0
      cols[h][1] = __byte_perm(t01l, t23l, 0x7632);  // w0.1 w1.1 w2.1 w3.1
      cols[h][2] = __byte_perm(t01h, t23h, 0x5410);
      cols[h][3] = __byte_perm(t01h, t23h, 0x7632);
    }
    const float* sz = reinterpret_cast<const float*>(base + Q_BYTES + X_BYTES);
    if constexpr (HALF) {
      // Each plane's k32 step as its two k16 halves: registers 0, 1 of the
      // A fragment and 0 of B, then 2, 3 and 1. A group may close after
      // either.
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          mma_s8_k16(r_lo[i], a_lo[i][2 * s], a_lo[i][2 * s + 1], kOnes);
          mma_s8_k16(r_hi[i], a_hi[i][2 * s], a_hi[i][2 * s + 1], kOnes);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b_lo = cols[s][j] & kLow;
          const uint32_t b_hi = (cols[s][j] >> 4) & kLow;
#pragma unroll
          for (int i = 0; i < FM; ++i) {
            mma_s8_k16(p_lo[i][j], a_lo[i][2 * s], a_lo[i][2 * s + 1], b_lo);
            mma_s8_k16(p_hi[i][j], a_hi[i][2 * s], a_hi[i][2 * s + 1], b_hi);
          }
        }
        if (closes_at_step(tile, s)) fold(sz + s * 4 * BN);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b_lo0 = cols[0][j] & kLow;
        const uint32_t b_lo1 = cols[1][j] & kLow;
        const uint32_t b_hi0 = (cols[0][j] >> 4) & kLow;
        const uint32_t b_hi1 = (cols[1][j] >> 4) & kLow;
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          mma_s8(p_lo[i][j], a_lo[i], b_lo0, b_lo1);
          mma_s8(p_hi[i][j], a_hi[i], b_hi0, b_hi1);
        }
      }
      if (closes_group(tile)) fold(sz);
    }
  }

  float* dst = out + size_t(blockIdx.z) * T * N;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + i * 16 + g + 8 * h;
      if (row >= T) continue;
      const float s = sx[row];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + warp * 32 + 4 * (tig * 2 + e);
        const int f = 2 * h + e;
        *reinterpret_cast<float4*>(dst + size_t(row) * N + col) =
            make_float4(acc[i][0][f] * s, acc[i][1][f] * s, acc[i][2][f] * s, acc[i][3][f] * s);
      }
    }
  }
}

template <int FM, bool HALF>
void launch(const void* xq, const void* sx, const void* q4p, const void* scale, const void* zero,
            float* dst, int T, int K, int N, int group, int splits, int tiles_per_split,
            cudaStream_t stream) {
  dim3 grid(N / BN, (T + 16 * FM - 1) / (16 * FM), splits);
  int4p_matmul_w4a8_kernel<FM, HALF><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(q4p), static_cast<const float*>(scale),
      static_cast<const float*>(zero), dst, T, K, N, group, tiles_per_split);
}

// ----------------------------------------------------------------------
// The per-token activation quantizer
// ----------------------------------------------------------------------

constexpr int Q_THREADS = 256;
constexpr int FMT_INT8 = 0;
constexpr int FMT_E4M3 = 1;
constexpr int FMT_E4M3_F16 = 2;  // e4m3 values, each stored as its f16 (exact)

template <int FMT>
__global__ void __launch_bounds__(Q_THREADS)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, uint8_t* __restrict__ xq,
                     float* __restrict__ row_scale, int K, int x_stride) {
  const int row = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + size_t(row) * x_stride);
  const int chunks = K / 8;  // eight bf16 values per 16-byte load
  float amax = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += Q_THREADS) {
    const uint4 v = src[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[Q_THREADS / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < Q_THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float s = FMT == FMT_INT8 ? __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f)
                                  : fmaxf(__fdiv_rn(amax, 448.0f), 1e-12f);
  if (threadIdx.x == 0) row_scale[row] = s;

  constexpr int OUT_BYTES = FMT == FMT_E4M3_F16 ? 2 : 1;
  uint8_t* dst = xq + size_t(row) * K * OUT_BYTES;
  for (int c = threadIdx.x; c < chunks; c += Q_THREADS) {
    const uint4 v = src[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t word[2 * OUT_BYTES] = {};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      const float pair[2] = {f.x, f.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = __fdiv_rn(pair[e], s);
        uint32_t byte;
        if (FMT == FMT_INT8) {
          const int level = min(127, max(-127, __float2int_rn(y)));
          byte = static_cast<uint32_t>(level) & 0xFFu;
        } else {
          byte = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
        }
        const int b = 2 * k + e;  // value b of the eight
        if (FMT == FMT_E4M3_F16) {
          const __half_raw f = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(byte),
                                                       __NV_E4M3);
          word[b / 2] |= uint32_t(f.x) << (16 * (b % 2));
        } else {
          word[b / 4] |= byte << (8 * (b % 4));
        }
      }
    }
    if (FMT == FMT_E4M3_F16) {
      reinterpret_cast<uint4*>(dst)[c] = make_uint4(word[0], word[1], word[2], word[3]);
    } else {
      reinterpret_cast<uint2*>(dst)[c] = make_uint2(word[0], word[1]);
    }
  }
}

}  // namespace

// block_m: rows of xq per block, 16 or 32. splits: how many blocks share the
// k range of one output tile; with splits > 1, `partial` is an f32 scratch
// buffer [splits, T, N] and a second kernel sums it into out. sx is f32 [T].
// Returns the CUDA error code of the launches (0 = success), or -1 for
// arguments the kernel does not take.
extern "C" int int4p_matmul_w4a8(const void* xq, const void* sx, const void* q4p,
                                 const void* scale, const void* zero, void* out, void* partial,
                                 int T, int K, int N, int group, int block_m, int splits,
                                 void* stream_ptr) {
  if (T < 1 || N % BN != 0 || K % 2 != 0 || (K / 2) % BKP != 0 || group % 16 != 0 ||
      (K / 2) % group != 0 || splits < 1)
    return -1;
  const int num_tiles = K / 2 / BKP;
  if (splits > num_tiles) return -1;
  const int tiles_per_split = (num_tiles + splits - 1) / splits;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const bool half = group % BKP != 0;
#define W4A8_LAUNCH(fm, h) \
  launch<fm, h>(xq, sx, q4p, scale, zero, dst, T, K, N, group, splits, tiles_per_split, stream)
  switch (block_m * 2 + int(half)) {
    case 32:
      W4A8_LAUNCH(1, false);
      break;
    case 33:
      W4A8_LAUNCH(1, true);
      break;
    case 64:
      W4A8_LAUNCH(2, false);
      break;
    case 65:
      W4A8_LAUNCH(2, true);
      break;
    default:
      return -1;
  }
#undef W4A8_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) err = launch_split_reduce(partial, out, T, N, splits, stream);
  return static_cast<int>(err);
}

// x bf16 [T, K] with row stride x_stride (elements) -> xq [T, K] (int8,
// e4m3 bytes, or e4m3 values as f16) and row_scale f32 [T]. fmt: 0 int8, 1
// e4m3, 2 e4m3 as f16. Returns the CUDA error code of the launch, or -1 for
// arguments the kernel does not take.
extern "C" int quantize_rows_bf16(const void* x, void* xq, void* row_scale, int T, int K,
                                  int x_stride, int fmt, void* stream_ptr) {
  if (T < 1 || K < 8 || K % 8 != 0 || x_stride % 8 != 0 ||
      (fmt != FMT_INT8 && fmt != FMT_E4M3 && fmt != FMT_E4M3_F16))
    return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* q = static_cast<uint8_t*>(xq);
  auto* s = static_cast<float*>(row_scale);
  if (fmt == FMT_INT8) {
    quantize_rows_kernel<FMT_INT8><<<T, Q_THREADS, 0, stream>>>(xb, q, s, K, x_stride);
  } else if (fmt == FMT_E4M3) {
    quantize_rows_kernel<FMT_E4M3><<<T, Q_THREADS, 0, stream>>>(xb, q, s, K, x_stride);
  } else {
    quantize_rows_kernel<FMT_E4M3_F16><<<T, Q_THREADS, 0, stream>>>(xb, q, s, K, x_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
