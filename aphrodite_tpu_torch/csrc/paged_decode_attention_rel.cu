// The decode attention entry points with T5's relative-position bias
// (paged_decode_attention.cuh): paged_decode_attention_rel_{bf16, e4m3,
// e5m2, int8}.

#include "paged_decode_attention.cuh"

PAGED_DECODE_ENTRY(paged_decode_attention_rel_bf16, kv_page::Bf16, true)
PAGED_DECODE_ENTRY(paged_decode_attention_rel_e4m3, kv_page::E4m3, true)
PAGED_DECODE_ENTRY(paged_decode_attention_rel_e5m2, kv_page::E5m2, true)
PAGED_DECODE_ENTRY(paged_decode_attention_rel_int8, kv_page::Int8, true)
