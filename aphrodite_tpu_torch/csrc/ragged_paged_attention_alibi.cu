// Ragged paged attention with ALiBi: the entry points
// ragged_paged_attention_alibi_{bf16, e4m3, e5m2, int8}, one per page type,
// each taking an f32[QH] slope table. The kernel, its design and its
// semantics are in ragged_paged_attention.cuh.

#include "ragged_paged_attention.cuh"

RAGGED_ENTRY(ragged_paged_attention_alibi_bf16, kv_page::Bf16, true, false)
RAGGED_ENTRY(ragged_paged_attention_alibi_e4m3, kv_page::E4m3, true, false)
RAGGED_ENTRY(ragged_paged_attention_alibi_e5m2, kv_page::E5m2, true, false)
RAGGED_ENTRY(ragged_paged_attention_alibi_int8, kv_page::Int8, true, false)
