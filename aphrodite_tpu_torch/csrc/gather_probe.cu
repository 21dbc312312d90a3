// Page-gather bandwidth probe for Hopper, sm_90a.
//
// Replaces the TPU kernel tools/probe_gather_bw.py: gather ->
// _gather_kernel, a probe of what scattered page reads reach: the reads of
// the decode attention kernel without its arithmetic. The TPU kernel walks
// blocks of G = 8 sequences and, for each, DMAs every live page of every
// sequence in waves of C = 8 pages into VMEM; its value is, per block b,
//   out[b, :, :] = sum over waves w of sum_d kv_pages[page_indices[8b, 8w], 0, 0, d]
// (the first row of the first page of each wave of the block's first
// sequence, bf16 widened to f32). Every other page is traffic only.
//
// Here the traffic is the same, every live page of every sequence read
// once, but the blocks are Hopper's: one block per (sequence, slot c of
// the wave), which reads pages c, c + 8, c + 16, ... of its sequence, so
// S * 8 blocks cover the card (1024 at the probe's 128 sequences) and the
// block (8b, 0) meets the pages that enter the value in wave order. Each
// thread reads 16-byte words, 8 in flight, neighbouring threads on
// neighbouring words, and folds every word into an XOR checksum that the
// block writes out (a second output, no part of the value), so no load can
// be elided. The summing block widens the 2 * D bytes of row 0 of each
// such page, sums them in f64 (exact for these values, so in any order)
// and adds that sum, rounded to f32, to its f32 total in wave order. The
// TPU kernel sums each row in f32 in the order of its reduction; the two
// differ by the rounding of that sum only.
//
// Known divergence: with unequal kv lengths inside a block of 8, the TPU
// kernel runs as many waves as the longest sequence needs and, in a wave
// that sequence 8b does not reach, adds the row of a stale buffer slot.
// Here only the waves that sequence 8b reaches are summed. The probe runs
// equal lengths, where the two agree.
//
// Bound on the H100: bytes. Each live page is read once (16 pages of 16
// tokens x 16 combined heads x 128 bf16 = 64 KB at the probe's shapes);
// nothing else moves but the index tensors, the checksums and the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kG = 8;       // sequences per output block
constexpr int kC = 8;       // pages per wave
constexpr int kInFlight = 8;  // 16-byte loads a thread issues before it uses them
constexpr int kOutLanes = 8 * 128;  // out[b] is f32[8, 128]

__global__ void __launch_bounds__(kThreads)
gather_probe_kernel(const int* __restrict__ kv_lens, const int* __restrict__ page_indices,
                    const uint4* __restrict__ kv, float* __restrict__ out,
                    unsigned* __restrict__ checksum, int pages_per_seq, int page_size,
                    int page_words, int row_words) {
  const int seq = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int kv_len = kv_lens[seq];
  const int n_pages = min((kv_len + page_size - 1) / page_size, pages_per_seq);
  const bool sums = seq % kG == 0 && slot == 0;  // uniform across the block
  const int* pages = page_indices + size_t(seq) * pages_per_seq;

  unsigned check = 0u;
  float acc = 0.f;  // the summing block's total (thread 0)
  for (int p = slot; p < n_pages; p += kC) {
    const uint4* page = kv + size_t(pages[p]) * page_words;
    uint4 first = make_uint4(0u, 0u, 0u, 0u);  // word tid of the page
    for (int w0 = 0; w0 < page_words; w0 += kThreads * kInFlight) {
      uint4 v[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int w = w0 + i * kThreads + tid;
        v[i] = w < page_words ? page[w] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) check ^= v[i].x ^ v[i].y ^ v[i].z ^ v[i].w;
      if (w0 == 0) first = v[0];
    }
    if (sums && tid < 32) {
      // Row 0 of the page (combined head 0: the first 2 * D bytes) lies in
      // words 0 .. row_words - 1, which threads 0 .. row_words - 1 hold.
      double part = 0.0;
      if (tid < row_words) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&first);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h[k]);
          part += double(f.x) + double(f.y);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (tid == 0) acc = acc + float(part);
    }
  }

  __shared__ unsigned warp_check[kThreads / 32];
  __shared__ float total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) check ^= __shfl_xor_sync(0xffffffffu, check, o);
  if (tid % 32 == 0) warp_check[tid / 32] = check;
  if (tid == 0) total = acc;
  __syncthreads();
  if (tid == 0) {
    unsigned all = 0u;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) all ^= warp_check[w];
    checksum[size_t(seq) * kC + slot] = all;
  }
  if (sums) {
    float* dst = out + size_t(seq / kG) * kOutLanes;
    for (int i = tid; i < kOutLanes; i += kThreads) dst[i] = total;
  }
}

}  // namespace

// kv_lens i32[S] (S a multiple of 8), page_indices i32[S, pages_per_seq],
// kv_pages bf16[P, page_size, 2 * KV, D] as raw bytes, page_bytes = its
// bytes per page (a multiple of 16), head_dim D (2 * D a multiple of 16, at
// most 256). out f32[S / 8, 8, 128]; checksum u32[S, 8], written whole.
// Returns the CUDA error of the launch, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int gather_probe(const void* kv_lens, const void* page_indices, const void* kv_pages,
                            void* out, void* checksum, int num_seqs, int pages_per_seq,
                            int page_size, int page_bytes, int head_dim, void* stream) {
  if (num_seqs <= 0 || num_seqs % kG != 0 || pages_per_seq <= 0 || page_size <= 0 ||
      page_bytes % 16 != 0 || (2 * head_dim) % 16 != 0 || 2 * head_dim > 32 * 16 ||
      2 * head_dim > page_bytes)
    return int(cudaErrorInvalidValue);
  const dim3 grid(num_seqs, kC);
  gather_probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(kv_lens), static_cast<const int*>(page_indices),
      static_cast<const uint4*>(kv_pages), static_cast<float*>(out),
      static_cast<unsigned*>(checksum), pages_per_seq, page_size, page_bytes / 16,
      2 * head_dim / 16);
  return int(cudaGetLastError());
}
