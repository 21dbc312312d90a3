// W4A16 matmul on half-split packed int4 weights for Hopper, sm_90a.
//
//   out[T, N] (f32) = x[T, K] (bf16) @ w[K, N],
//   w[k, n] = (q[k, n] - zero[k / G, n]) * scale[k / G, n]
//
// Replaces the TPU kernel aphrodite_tpu/ops/quant_matmul.py:
// int4p_matmul_pallas (bodies _kernel_packed_dense and
// _kernel_packed_groupwise). The storage is the same: packed row i of
// q4p[K/2, N] (int8) holds original row i in its low nibble and row
// i + K/2 in its high nibble; scale and zero are f32 [K/G, N], and zero is
// a float that need not lie in 0..15. The TPU grid (bt, bn, bkp) with a
// sequential k axis and a VMEM accumulator is not carried over: here the k
// axis is a loop inside the block, the accumulators are tensor-core
// fragments in registers, and the layer index of the stacked form is a
// pointer offset made by the wrapper.
//
// Two bodies, chosen by the wrapper as the TPU's int4p_matmul_pallas chooses
// (T < 64: group-wise, else dense):
//
// - group-wise: the form of the TPU's _kernel_packed_groupwise. Raw nibbles
//   go to the tensor cores and the group's scale and zero are applied to
//   f32 partial sums,
//
//     out = sum_g  s_g * (x_g @ q_g)  -  s_g * z_g * rowsum(x_g),
//
//   so it agrees with the exact f32-weight product to the order of the f32
//   sums, and with the plain version (which rounds the dequantized weight to
//   bf16) to that rounding, 2^-9 relative per term. It has two
//   implementations, which the wrapper picks by shape (decode_route): the
//   mma.sync kernel in this file (int4p_matmul_bf16), and the decode body of
//   decode_gemm.cuh (int4p_matmul_decode below: one block an SM, a TMA
//   ring, tokens as the n dimension), which that header describes.
// - dense (int4p_matmul_dense_bf16 below, the body of dequant_gemm.cuh): the
//   TPU's _kernel_packed_dense, each weight dequantized in f32 and rounded to
//   bf16 before a wgmma product fed by TMA, as int4p_matmul_ref does.
//
// The rest of this note is about the group-wise body in this file.
//
// Bound on the H100:
// - small T (decode): bytes. K * N / 2 weight bytes and 8 * (K / G) * N bytes
//   of scale and zero are read once per call, against 2 * T * K * N
//   operations: at T = 32 about 64 operations per byte, below the ~295 of the
//   ridge. What the design does: every packed byte is read from device memory
//   exactly once per call (one block per 128-column strip and k range, all
//   T <= 32 rows in that block), as full 128-byte lines through a ring of
//   cp.async stages; the cost per weight is three logic operations per four
//   weights, where dequantizing pays an int-to-float conversion, a subtract, a
//   multiply and a rounding for each; and sites with few strips (N = 4096
//   gives 32) split K across blockIdx.z so that all 132 SMs have blocks. The
//   partial sums of a split go to an f32 scratch buffer and a second kernel
//   adds them in a fixed order, so the result does not change from run to run
//   (no atomics).
// - large T (prefill): operations, 2 * T * K * N on the tensor cores
//   (mma.sync m16n8k16, bf16 inputs, f32 accumulation). Each 32-row block of x
//   is one more block along blockIdx.y, which reads the strip's packed bytes
//   again (from L2 for the most part). mma.sync reaches only a part of the
//   wgmma rate, there is no TMA and a row block is only 32 rows; those are
//   later work.
//
// A block computes 16 or 32 rows by 128 columns over k tiles of 32 packed
// rows = 64 values of k (32 from the low half of K and 32 from the high
// half). Rows at and past T are zero-filled on load and masked on store, so
// any T >= 1 works.
//
// Groups shorter than a k tile: a group whose length is an odd multiple of
// 16 (GGUF Q2_K and Q3_K pack at 16) closes inside a tile, after one of its
// two 16-row mma steps. Such groups take the kernel's HALF instantiation:
// the partial sums and row sums are folded after every 16-row step whose
// rows end a group, and each tile fetches the scale and zero rows of both
// steps (two per half of K, not one), in a ring of three stages instead of
// four to stay within 48 KB of static shared memory. Groups that are
// multiples of 32 take the other instantiation, whose arithmetic is the
// same as before HALF came in, so their results are unchanged bit for bit.
//
// Shape rules (checked by the wrapper): N % 128 == 0, G % 16 == 0,
// (K / 2) % G == 0, (K / 2) % 32 == 0, x bf16 with unit stride in its last axis and a row
// stride that is a multiple of 8, all pointers 16-byte aligned.

#include "decode_gemm.cuh"
#include "dequant_gemm.cuh"
#include "matmul_common.cuh"

namespace {

constexpr int BN = 128;      // output columns per block
constexpr int BKP = 32;      // packed rows per k tile
constexpr int BK = 2 * BKP;  // k values per tile: low half, then high half

// A nibble q becomes the bf16 value 128 + q by or-ing it into the mantissa of
// 128.0 (0x4300), which is exact; the 128 leaves with the zero:
// x_g @ (128 + q_g) - (128 + z_g) * rowsum(x_g). rowsum comes from one more
// mma against a matrix of ones, so it lies in the same register layout as the
// partial sums.
//
// mma.sync.m16n8k16 fragments are loaded by hand. A warp owns 32 columns as
// four 8-column tiles, interleaved: tile j holds columns 4 * i + j, so that
// the four packed bytes a thread loads as one word belong to its four tiles.
// Packed bytes, x and (with the last tile of a group) scale and zero arrive
// by cp.async through a ring of STAGES tiles in shared memory.

constexpr int Q_LD = BN + 16;  // bytes per packed row in shared memory
constexpr int X_LD = BK + 8;   // bf16 per x row in shared memory
constexpr int THREADS = 128;
constexpr int STEPS = BKP / 16;  // 16-row mma steps per k tile

// Folds one group's partial sums into acc with its scale and zero rows `sz`
// (scale lo, zero lo, scale hi, zero hi, BN floats each), then clears the
// partial sums and row sums for the next group.
template <int FM>
__device__ __forceinline__ void fold_group(float (&acc)[FM][4][4], float (&p_lo)[FM][4][4],
                                           float (&p_hi)[FM][4][4], float (&r_lo)[FM][4],
                                           float (&r_hi)[FM][4], const float* sz, int warp,
                                           int tig) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float* col = sz + warp * 32 + 4 * (tig * 2 + e);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s_lo = col[j];
      const float c_lo = 128.0f + col[BN + j];
      const float s_hi = col[2 * BN + j];
      const float c_hi = 128.0f + col[3 * BN + j];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 2 * h + e;  // fragment element: row g + 8h, column pair e
          acc[i][j][f] += s_lo * (p_lo[i][j][f] - c_lo * r_lo[i][2 * h]) +
                          s_hi * (p_hi[i][j][f] - c_hi * r_hi[i][2 * h]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      r_lo[i][e] = 0.0f;
      r_hi[i][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_lo[i][j][e] = 0.0f;
        p_hi[i][j][e] = 0.0f;
      }
    }
  }
}

// FM: 16-row tiles of x per block. HALF: the group is an odd multiple of 16
// rows, so groups close after 16-row steps and not only at tile ends.
template <int FM, bool HALF>
__global__ void __launch_bounds__(THREADS)
int4p_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q4p,
                       const float* __restrict__ scale, const float* __restrict__ zero,
                       float* __restrict__ out, int T, int K, int N, int group, int x_stride,
                       int tiles_per_split) {
  constexpr int STAGES = HALF ? 3 : 4;
  constexpr int BM = 16 * FM;
  constexpr int Q_BYTES = BKP * Q_LD;
  constexpr int X_BYTES = BM * X_LD * 2;
  // Scale lo, zero lo, scale hi, zero hi: of the tile's closing group, or
  // (HALF) of the group of each 16-row step.
  constexpr int SZ_SETS = HALF ? STEPS : 1;
  constexpr int SZ_BYTES = SZ_SETS * 4 * BN * 4;
  constexpr int STAGE_BYTES = Q_BYTES + X_BYTES + SZ_BYTES;
  static_assert(STAGES * STAGE_BYTES <= 48 * 1024, "static shared memory");
  __shared__ __align__(16) unsigned char smem[STAGES * STAGE_BYTES];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;    // fragment row (A, C) or column (B)
  const int tig = lane % 4;  // fragment k pair (A, B) or column pair (C)
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int Kh = K / 2;
  const int half_groups = Kh / group;
  const int num_tiles = Kh / BKP;
  const int tile_begin = blockIdx.z * tiles_per_split;
  const int tile_end = min(num_tiles, tile_begin + tiles_per_split);
  const int count = max(0, tile_end - tile_begin);

  // The last tile of a group, or of this block's k range, carries the
  // group's scale and zero and folds the partial sums into the output.
  auto closes_group = [&](int tile) {
    return ((tile + 1) * BKP) % group == 0 || tile == tile_end - 1;
  };
  // HALF: the same after 16-row step `step` of the tile.
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
      cp_async16(base + row * Q_LD + ch * 16,
                 q4p + size_t(kp0 + row) * N + n0 + ch * 16, 16);
    }
#pragma unroll
    for (int i = 0; i < BM * (BK / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / 8);
      const int ch = c % (BK / 8);  // 0..3: low half of K, 4..7: high half
      const int col = (ch < BKP / 8 ? kp0 + ch * 8 : Kh + kp0 + (ch - BKP / 8) * 8);
      const bool live = m0 + row < T;
      // A row at or past T is zero-filled: no byte of it is read.
      cp_async16(base + Q_BYTES + (row * X_LD + ch * 8) * 2,
                 x + size_t(live ? m0 + row : 0) * x_stride + col, live ? 16 : 0);
    }
    if constexpr (HALF) {
      // The group rows of both 16-row steps, whether or not they close.
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

  float acc[FM][4][4];    // output: [row tile][column tile][fragment]
  float p_lo[FM][4][4];   // x_g @ (128 + q_g), low half of K
  float p_hi[FM][4][4];   // the same, high half of K
  float r_lo[FM][4];      // rowsum(x_g), low half (every column the same)
  float r_hi[FM][4];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      r_lo[i][e] = 0.0f;
      r_hi[i][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j][e] = 0.0f;
        p_lo[i][j][e] = 0.0f;
        p_hi[i][j][e] = 0.0f;
      }
    }
  }

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < count) fetch(tile_begin + p, p);
    cp_async_commit();
  }

  constexpr uint32_t kNibbles = 0x000F000Fu;
  constexpr uint32_t kBias = 0x43004300u;  // bf16 128.0 twice
  constexpr uint32_t kOnes = 0x3F803F80u;  // bf16 1.0 twice

  for (int it = 0; it < count; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` has landed; the slot of tile it - 1 is free
    const int ahead = it + STAGES - 1;
    if (ahead < count) fetch(tile_begin + ahead, ahead % STAGES);
    cp_async_commit();

    const int tile = tile_begin + it;
    const unsigned char* base = smem + (it % STAGES) * STAGE_BYTES;
    const unsigned char* qs = base;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base + Q_BYTES);
    const float* sz = reinterpret_cast<const float*>(base + Q_BYTES + X_BYTES);

#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      // The four packed rows this thread's B fragments take, four tiles wide.
      const unsigned char* qrow = qs + (16 * s + tig * 2) * Q_LD + warp * 32 + g * 4;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qrow);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qrow + Q_LD);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(qrow + 8 * Q_LD);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(qrow + 9 * Q_LD);
      uint32_t a_lo[FM][4], a_hi[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const __nv_bfloat16* xr = xs + (i * 16 + g) * X_LD + 16 * s + tig * 2;
        a_lo[i][0] = *reinterpret_cast<const uint32_t*>(xr);
        a_lo[i][1] = *reinterpret_cast<const uint32_t*>(xr + 8 * X_LD);
        a_lo[i][2] = *reinterpret_cast<const uint32_t*>(xr + 8);
        a_lo[i][3] = *reinterpret_cast<const uint32_t*>(xr + 8 * X_LD + 8);
        a_hi[i][0] = *reinterpret_cast<const uint32_t*>(xr + BKP);
        a_hi[i][1] = *reinterpret_cast<const uint32_t*>(xr + BKP + 8 * X_LD);
        a_hi[i][2] = *reinterpret_cast<const uint32_t*>(xr + BKP + 8);
        a_hi[i][3] = *reinterpret_cast<const uint32_t*>(xr + BKP + 8 * X_LD + 8);
        mma_bf16(r_lo[i], a_lo[i], kOnes, kOnes);
        mma_bf16(r_hi[i], a_hi[i], kOnes, kOnes);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Byte j of two rows, 16 bits apart: [row k].j, x, [row k + 1].j, x.
        const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
        const uint32_t t01 = __byte_perm(w0, w1, sel);
        const uint32_t t89 = __byte_perm(w8, w9, sel);
        const uint32_t b_lo0 = (t01 & kNibbles) | kBias;
        const uint32_t b_lo1 = (t89 & kNibbles) | kBias;
        const uint32_t b_hi0 = ((t01 >> 4) & kNibbles) | kBias;
        const uint32_t b_hi1 = ((t89 >> 4) & kNibbles) | kBias;
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          mma_bf16(p_lo[i][j], a_lo[i], b_lo0, b_lo1);
          mma_bf16(p_hi[i][j], a_hi[i], b_hi0, b_hi1);
        }
      }
      if constexpr (HALF) {
        if (closes_at_step(tile, s))
          fold_group<FM>(acc, p_lo, p_hi, r_lo, r_hi, sz + s * 4 * BN, warp, tig);
      }
    }

    if constexpr (!HALF) {
      if (closes_group(tile)) fold_group<FM>(acc, p_lo, p_hi, r_lo, r_hi, sz, warp, tig);
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

template <int FM, bool HALF>
void launch(const void* x, const void* q4p, const void* scale, const void* zero,
                      float* dst, int T, int K, int N, int group, int x_stride, int splits,
                      int tiles_per_split, cudaStream_t stream) {
  dim3 grid(N / BN, (T + 16 * FM - 1) / (16 * FM), splits);
  int4p_matmul_kernel<FM, HALF><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4p),
      static_cast<const float*>(scale), static_cast<const float*>(zero), dst, T, K, N, group,
      x_stride, tiles_per_split);
}

}  // namespace

// block_m: rows of x per block, 16 or 32. splits: how many blocks share the k
// range of one output tile; with splits > 1, `partial` is an f32 scratch
// buffer [splits, T, N] and a second kernel sums it into out.
// Returns the CUDA error code of the launches (0 = success), or -1 for
// arguments the kernel does not take.
extern "C" int int4p_matmul_bf16(const void* x, const void* q4p, const void* scale,
                                 const void* zero, void* out, void* partial, int T,
                                 int K, int N, int group, int x_stride, int block_m,
                                 int splits, void* stream_ptr) {
  if (T < 1 || N % BN != 0 || K % 2 != 0 || (K / 2) % BKP != 0 || group % 16 != 0 ||
      (K / 2) % group != 0 || x_stride % 8 != 0 || splits < 1)
    return -1;
  const int num_tiles = K / 2 / BKP;
  if (splits > num_tiles) return -1;
  const int tiles_per_split = (num_tiles + splits - 1) / splits;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const bool half = group % BKP != 0;
#define INT4P_LAUNCH(fm, h)                                                                   \
  launch<fm, h>(x, q4p, scale, zero, dst, T, K, N, group, x_stride, splits, tiles_per_split, \
                stream)
  switch (block_m * 2 + int(half)) {
    case 32:
      INT4P_LAUNCH(1, false);
      break;
    case 33:
      INT4P_LAUNCH(1, true);
      break;
    case 64:
      INT4P_LAUNCH(2, false);
      break;
    case 65:
      INT4P_LAUNCH(2, true);
      break;
    default:
      return -1;
  }
#undef INT4P_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) err = launch_split_reduce(partial, out, T, N, splits, stream);
  return static_cast<int>(err);
}

// The group-wise body on the decode body (decode_gemm.cuh, form PACKED):
// t_tile token rows per block (8, 16 or 32; more tokens take more blocks),
// a ring of `stages` stages (0: as many as fit), and K split `splits` ways
// (dividing the ceil((K / 2) / 64) stages of packed rows; with splits > 1,
// `partial` is an f32 scratch buffer [splits, T, N] that a second kernel
// sums into out in a fixed order). `rs` is an f32 scratch buffer [K / 16, T
// rounded up to t_tile] for the step sums of x. Returns the CUDA error code
// of the launches (0 = success), -1 for arguments the body does not take,
// or -2 if a tensor map could not be made.
extern "C" int int4p_matmul_decode(const void* x, const void* q4p, const void* scale,
                                   const void* zero, void* out, void* partial, void* rs, int T,
                                   int K, int N, int group, int x_stride, int t_tile, int stages,
                                   int splits, void* stream_ptr) {
  if (T < 1 || N % BN != 0 || K % 2 != 0 || (K / 2) % BKP != 0 || group % 16 != 0 ||
      (K / 2) % group != 0 || x_stride % 8 != 0)
    return -1;
  return dqd::launch_tile<dqd::PACKED>(
      t_tile, x, x_stride, q4p, static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<float*>(out), static_cast<float*>(partial), static_cast<float*>(rs), T, K, N,
      group, stages, splits, static_cast<cudaStream_t>(stream_ptr));
}

// The dense body (dequant_gemm.cuh): block_t token rows per block (64 or
// 128), a ring of `stages` stages, and K split `splits` ways (dividing the
// ceil((K / 2) / 64) stages of packed rows; with splits > 1, `partial` is an f32
// scratch buffer [splits, T, N]). Returns the CUDA error code of the
// launches (0 = success), -1 for arguments the body does not take, or -2 if
// a tensor map could not be made.
extern "C" int int4p_matmul_dense_bf16(const void* x, const void* q4p, const void* scale,
                                       const void* zero, void* out, void* partial, int T, int K,
                                       int N, int group, int x_stride, int block_t, int stages,
                                       int splits, void* stream_ptr) {
  if (T < 1 || N % BN != 0 || K % 2 != 0 || (K / 2) % 32 != 0 || group % 16 != 0 ||
      (K / 2) % group != 0 || x_stride % 8 != 0)
    return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partial);
  // A K/2 that is an odd multiple of 32 ends in a 32-row stage: its own
  // instantiations, so that every other shape runs code without it.
#define DQG_PACKED(bt, tail)                                                                  \
  dqg::launch<bt, true, dqg::GROUP_ROWS, tail>(x, x_stride, q4p, s, z, o, part, T, K, N, group, \
                                              stages, splits, stream)
  const bool tail = (K / 2) % dqg::KS != 0;
  switch (block_t * 2 + int(tail)) {
    case 128:
      return DQG_PACKED(64, false);
    case 129:
      return DQG_PACKED(64, true);
    case 256:
      return DQG_PACKED(128, false);
    case 257:
      return DQG_PACKED(128, true);
    default:
      return -1;
  }
#undef DQG_PACKED
}
