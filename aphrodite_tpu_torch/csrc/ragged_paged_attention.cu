// Ragged paged attention without ALiBi: the entry points
// ragged_paged_attention_{bf16, e4m3, e5m2, int8}, one per page type. The
// kernel, its design and its semantics are in ragged_paged_attention.cuh;
// the entry points with ALiBi are in ragged_paged_attention_alibi.cu.

#include "ragged_paged_attention.cuh"

RAGGED_ENTRY(ragged_paged_attention_bf16, kv_page::Bf16, false, false)
RAGGED_ENTRY(ragged_paged_attention_e4m3, kv_page::E4m3, false, false)
RAGGED_ENTRY(ragged_paged_attention_e5m2, kv_page::E5m2, false, false)
RAGGED_ENTRY(ragged_paged_attention_int8, kv_page::Int8, false, false)
