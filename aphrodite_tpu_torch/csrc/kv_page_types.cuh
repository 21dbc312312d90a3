// Element types of the paged KV cache, and how the two attention kernels
// widen one 16-byte load of narrow K or V values into bf16 once a tile is
// staged.
//
// The TPU kernels read 8-bit pages raw and rebuild bf16 values by placing
// bits (aphrodite_tpu/ops/decode_attention.py: extract_seq,
// aphrodite_tpu/ops/rpa_alibi_kernel.py: _fp8_to_bf16_fast), because that
// chip has no fp8 conversion. Hopper has one (cvt from e4m3x2 / e5m2x2 to
// f16x2, behind __nv_cvt_fp8x2_to_halfraw2), so here a narrow value goes
// fp8 -> half -> float, or int8 -> float, and from there to the tile's
// type. Every step is exact: half holds every E4M3 and E5M2 value, and
// bf16 holds every value of three or fewer mantissa bits and every
// integer of [-128, 127]. A kernel on narrow pages therefore gives, bit
// for bit, what the same kernel gives on those pages widened to bf16
// beforehand, while it reads half the bytes. Scales never enter a
// kernel: the model folds k_scale into q and v_scale into the output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace kv_page {

// kValues: the values one 16-byte load holds.
struct Bf16 {
  static constexpr int kValues = 8;
};
struct E4m3 {
  static constexpr int kValues = 16;
  static constexpr __nv_fp8_interpretation_t kFormat = __NV_E4M3;
};
struct E5m2 {
  static constexpr int kValues = 16;
  static constexpr __nv_fp8_interpretation_t kFormat = __NV_E5M2;
};
struct Int8 {
  static constexpr int kValues = 16;
};

template <class P>
struct is_fp8 {
  static constexpr bool value = false;
};
template <>
struct is_fp8<E4m3> {
  static constexpr bool value = true;
};
template <>
struct is_fp8<E5m2> {
  static constexpr bool value = true;
};

// The P::kValues values of `raw`, in memory order, as f32.
template <class P>
__device__ __forceinline__ void chunk_to_f32(const uint4& raw, float* dst) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (P::kValues == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  } else if constexpr (is_fp8<P>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int pair_idx = 0; pair_idx < 2; ++pair_idx) {
        const __nv_fp8x2_storage_t pair =
            static_cast<__nv_fp8x2_storage_t>((words[i] >> (16 * pair_idx)) & 0xffffu);
        const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, P::kFormat)));
        dst[4 * i + 2 * pair_idx] = f.x;
        dst[4 * i + 2 * pair_idx + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // Sign-extend byte b of the word.
        dst[4 * i + b] = float(int32_t(words[i] << (24 - 8 * b)) >> 24);
      }
    }
  }
}

// The values of `raw` as bf16 at dst (16-byte aligned). bf16 pages are
// copied as they are.
template <class P>
__device__ __forceinline__ void store_chunk_bf16(const uint4& raw, __nv_bfloat16* dst) {
  if constexpr (P::kValues == 8) {
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
    float f[16];
    chunk_to_f32<P>(raw, f);
    uint4 out[2];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    reinterpret_cast<uint4*>(dst)[0] = out[0];
    reinterpret_cast<uint4*>(dst)[1] = out[1];
  }
}

}  // namespace kv_page
