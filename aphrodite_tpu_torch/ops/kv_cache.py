"""Paged KV cache write (counterpart of aphrodite_tpu/ops/kv_cache.py,
bf16 and f32 caches; quantize-on-write comes with the quantized caches).

Cache layout: kv_pages [num_pages, page_size, 2 * num_kv_heads, head_dim],
flat slot = page_id * page_size + offset_in_page. The runner reserves the
last page as a trash page and points every padding token there: torch
indexing has no out-of-range "drop" mode, so every slot must be in range.
"""

import torch


def write_kv(
    kv_pages: torch.Tensor,  # [num_pages, page_size, 2*K, D]
    new_k: torch.Tensor,  # [T, K, D]
    new_v: torch.Tensor,  # [T, K, D]
    slot_mapping: torch.Tensor,  # i32[T] flat slots; padding -> trash slots
) -> torch.Tensor:
    """Scatter new K/V into the paged cache in place; returns the cache."""
    num_pages, page_size, num_combined, head_dim = kv_pages.shape
    num_tokens, num_kv_heads, _ = new_k.shape
    if num_combined != 2 * num_kv_heads:
        raise ValueError(f"cache has {num_combined} combined heads for "
                         f"{num_kv_heads} kv heads")
    # Interleave K/V on the combined-head axis: [T, 2K, D].
    kv = torch.stack([new_k, new_v], dim=2).reshape(num_tokens, num_combined,
                                                    head_dim)
    flat = kv_pages.view(num_pages * page_size, num_combined, head_dim)
    flat.index_copy_(0, slot_mapping.long(), kv.to(kv_pages.dtype))
    return kv_pages
