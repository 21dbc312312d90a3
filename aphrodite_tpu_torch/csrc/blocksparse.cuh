// The blocksparse mask of Phi-3-Small (local blocks plus a vertical stride
// with a per-head phase), shared by both attention kernels. It stands for
// the blocksparse option of the TPU kernels
// aphrodite_tpu/ops/decode_attention.py: _decode_kernel and
// aphrodite_tpu/ops/rpa_alibi_kernel.py: ragged_paged_attention_kernel.
//
// With b(x) = x / block, key j is visible to a query at position p for
// query head h iff
//   b(p) - b(j) < local  or  (b(j) + offsets[h] + 1) % vert == 0,
// ANDed with the causal mask and the window. The remainder is C's, which
// is 0 exactly where the JAX package's is.

#pragma once

namespace {

// The blocksparse parameters of a launch.
struct Blocksparse {
  const int* offsets;  // i32[QH]: the vertical phase of each (global) query head
  int block;           // keys per block
  int local;           // local blocks
  int vert;            // vertical stride, in blocks
};

// Whether a query in block bq with vertical phase `phase` may see key block bk.
__device__ __forceinline__ bool block_visible(const Blocksparse& bs, int bq, int bk, int phase) {
  return bq - bk < bs.local || (bk + phase + 1) % bs.vert == 0;
}

}  // namespace
