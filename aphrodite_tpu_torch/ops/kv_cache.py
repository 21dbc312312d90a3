"""Paged KV cache write with quantize-on-write (counterpart of
aphrodite_tpu/ops/kv_cache.py). Plain PyTorch, as the JAX package leaves
it to XLA: no TPU kernel stands behind it.

Cache layout: kv_pages [num_pages, page_size, 2 * num_kv_heads, head_dim],
flat slot = page_id * page_size + offset_in_page. The runner reserves the
last page as a trash page and points every padding token there: torch
indexing has no out-of-range "drop" mode, so every slot must be in range.

A cache of a narrow type (float8_e4m3fn, float8_e5m2, int8) stores
value / scale: the new rows are divided by the layer's scale in f32,
rounded to nearest-even and clipped for int8, and cast. The attention
kernels read such pages raw; the model folds k_scale into q and v_scale
into the attention output. In-range values give the bytes the JAX package
writes. Out of range the two differ by design: the JAX cast turns an
overflow into NaN (E4M3) or inf (E5M2), which poisons every row that
attends to it; here the value is clamped to the format's largest finite
number first, on every device and PyTorch version alike.
"""

from typing import Optional

import torch

# Largest finite value of each fp8 cache type.
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def quantize_kv(x: torch.Tensor, scale: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """x (/ scale, in f32) as the cache type. ``scale`` is a 0-dim f32
    tensor on x's device: dividing by a Python number would go through
    its reciprocal on a card and miss the true quotient by an ulp."""
    if scale is not None:
        x = x.float() / scale
    if dtype == torch.int8:
        x = x.round().clamp(-128, 127)
    elif dtype in FP8_MAX:
        x = x.float().clamp(-FP8_MAX[dtype], FP8_MAX[dtype])
    return x.to(dtype)


def write_kv(
    kv_pages: torch.Tensor,  # [num_pages, page_size, 2*K, D]
    new_k: torch.Tensor,  # [T, K, D]
    new_v: torch.Tensor,  # [T, K, D]
    slot_mapping: torch.Tensor,  # i32[T] flat slots; padding -> trash slots
    k_scale: Optional[torch.Tensor] = None,  # 0-dim f32
    v_scale: Optional[torch.Tensor] = None,  # 0-dim f32
) -> torch.Tensor:
    """Scatter new K/V into the paged cache in place; returns the cache."""
    num_pages, page_size, num_combined, head_dim = kv_pages.shape
    num_tokens, num_kv_heads, _ = new_k.shape
    if num_combined != 2 * num_kv_heads:
        raise ValueError(f"cache has {num_combined} combined heads for "
                         f"{num_kv_heads} kv heads")
    flat = kv_pages.view(num_pages * page_size, num_combined, head_dim)
    new_kv = [quantize_kv(new_k, k_scale, kv_pages.dtype),
              quantize_kv(new_v, v_scale, kv_pages.dtype)]
    if kv_pages.dtype.itemsize == 1:
        # stack and index_copy_ have no fp8 kernels on every device: move
        # bytes.
        flat = flat.view(torch.uint8)
        new_kv = [t.view(torch.uint8) for t in new_kv]
    # Interleave K/V on the combined-head axis: [T, 2K, D].
    kv = torch.stack(new_kv, dim=2).reshape(num_tokens, num_combined,
                                            head_dim)
    flat.index_copy_(0, slot_mapping.long(), kv)
    return kv_pages
