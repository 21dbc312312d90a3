// What the quantized matmul kernels share: cp.async staging, the bf16
// tensor-core instruction, int8 levels as bf16 and the pass that sums
// split-K partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16 bytes from device to shared memory; with src_bytes = 0 no byte is read
// and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int8 levels, each in the low byte of a 16-bit lane, as two bf16 values.
__device__ __forceinline__ uint32_t levels_to_bf16x2(uint32_t t) {
  const uint32_t mag = (t & 0x007F007Fu) | 0x43004300u;  // 128 + low 7 bits
  const uint32_t off = (t & 0x00800080u) | 0x43004300u;  // 128, or 256 if negative
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                                   *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// out[i] = partial[0][i] + partial[1][i] + ... in that order, so a split-K
// result does not change from run to run (no atomics).
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float4* __restrict__ partial, float4* __restrict__ out,
                    size_t count4, int splits) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  float4 s = partial[i];
  for (int p = 1; p < splits; ++p) {
    const float4 v = partial[size_t(p) * count4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

// Sums partial[splits, T, N] into out[T, N] on the stream; returns the
// launch's error code.
inline cudaError_t launch_split_reduce(const void* partial, void* out, int T, int N, int splits,
                                       cudaStream_t stream) {
  const size_t count4 = size_t(T) * N / 4;
  const unsigned blocks = static_cast<unsigned>((count4 + 255) / 256);
  split_reduce_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(partial),
                                                  static_cast<float4*>(out), count4, splits);
  return cudaGetLastError();
}

// out[t, n] = ((partial[0][t, n] + partial[1][t, n] + ...) * row_scale[t])
// * col_scale[n]: the partials in a fixed order, then the two scales in that
// order (the FP8 W8A8 product's, after the JAX package).
__global__ void __launch_bounds__(256)
split_reduce_scaled_kernel(const float4* __restrict__ partial, float4* __restrict__ out,
                           const float* __restrict__ row_scale,
                           const float4* __restrict__ col_scale, int N4, size_t count4,
                           int splits) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  float4 s = partial[i];
  for (int p = 1; p < splits; ++p) {
    const float4 v = partial[size_t(p) * count4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float r = row_scale[i / N4];
  const float4 c = col_scale[i % N4];
  out[i] = make_float4(__fmul_rn(__fmul_rn(s.x, r), c.x), __fmul_rn(__fmul_rn(s.y, r), c.y),
                       __fmul_rn(__fmul_rn(s.z, r), c.z), __fmul_rn(__fmul_rn(s.w, r), c.w));
}

inline cudaError_t launch_split_reduce_scaled(const void* partial, void* out,
                                              const float* row_scale, const float* col_scale,
                                              int T, int N, int splits, cudaStream_t stream) {
  const size_t count4 = size_t(T) * N / 4;
  const unsigned blocks = static_cast<unsigned>((count4 + 255) / 256);
  split_reduce_scaled_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float4*>(partial), static_cast<float4*>(out), row_scale,
      reinterpret_cast<const float4*>(col_scale), N / 4, count4, splits);
  return cudaGetLastError();
}

}  // namespace
