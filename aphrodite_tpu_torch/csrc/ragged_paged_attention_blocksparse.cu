// Ragged paged attention with blocksparse: the entry points
// ragged_paged_attention_blocksparse_{bf16, e4m3, e5m2, int8}, one per page
// type, each taking an i32[QH] table of vertical phases and the block
// size, local blocks and vertical stride. The kernel, its design and its
// semantics are in ragged_paged_attention.cuh, the mask in blocksparse.cuh.

#include "ragged_paged_attention.cuh"

RAGGED_ENTRY(ragged_paged_attention_blocksparse_bf16, kv_page::Bf16, false, true)
RAGGED_ENTRY(ragged_paged_attention_blocksparse_e4m3, kv_page::E4m3, false, true)
RAGGED_ENTRY(ragged_paged_attention_blocksparse_e5m2, kv_page::E5m2, false, true)
RAGGED_ENTRY(ragged_paged_attention_blocksparse_int8, kv_page::Int8, false, true)
