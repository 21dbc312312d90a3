// The decode attention entry points without T5's bias
// (paged_decode_attention.cuh): paged_decode_attention_{bf16, e4m3, e5m2,
// int8}.

#include "paged_decode_attention.cuh"

PAGED_DECODE_ENTRY(paged_decode_attention_bf16, kv_page::Bf16, false)
PAGED_DECODE_ENTRY(paged_decode_attention_e4m3, kv_page::E4m3, false)
PAGED_DECODE_ENTRY(paged_decode_attention_e5m2, kv_page::E5m2, false)
PAGED_DECODE_ENTRY(paged_decode_attention_int8, kv_page::Int8, false)
