// Ragged paged attention at head_dim 384, without ALiBi or blocksparse:
// the entry points ragged_paged_attention_d384_{bf16, e4m3, e5m2, int8},
// one per page type. MiniCPM3's latent cache (a kv_lora_rank of 256 and a
// rope key of 32, padded to 384) is one such head shared by all 40 query
// heads. The kernel, its design at 384 (O split by columns over three
// warps a row group) and its semantics are in ragged_paged_attention.cuh;
// these instantiations are a library of their own, which nvcc builds in
// parallel with the others.

#include "ragged_paged_attention.cuh"

RAGGED_ENTRY_D(ragged_paged_attention_d384_bf16, kv_page::Bf16, false, false, 384)
RAGGED_ENTRY_D(ragged_paged_attention_d384_e4m3, kv_page::E4m3, false, false, 384)
RAGGED_ENTRY_D(ragged_paged_attention_d384_e5m2, kv_page::E5m2, false, false, 384)
RAGGED_ENTRY_D(ragged_paged_attention_d384_int8, kv_page::Int8, false, false, 384)
