"""What the encoder-decoder models (models/t5.py, models/bart.py) share:
the token-to-sequence map of a step and the cross-attention read.

The cross cache has the self cache's layout, [L, P + 1, page_size, 2H, D]
(K at even and V at odd combined heads), and its own pages: the runner
allocates it beside the self cache, the block manager hands each sequence
its cross pages, and the encoder pass writes them once; decoder steps only
read them. Cross-attention is full (not causal) over the sequence's
encoder length. In the JAX package it is XLA code (the models' dense
masked gather), so here it is plain PyTorch.
"""

import torch

from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.ops.decode_attention import MASK_VALUE


def sequence_of_tokens(batch: ForwardBatch) -> torch.Tensor:
    """The batch row of each of the T tokens (i64[T]): from cu_q_lens, or
    the identity in a pure-decode batch; padding tokens take the last
    row, as in the JAX models."""
    T = batch.token_ids.shape[0]
    S = batch.kv_lens.shape[0]
    tokens = torch.arange(T, device=batch.token_ids.device)
    if batch.cu_q_lens is None:
        return tokens
    seq_of = torch.searchsorted(batch.cu_q_lens[1:].long(), tokens,
                                right=True)
    return seq_of.clamp(max=S - 1)


def cross_attention(q: torch.Tensor, cross_pages: torch.Tensor,
                    batch: ForwardBatch, seq_of: torch.Tensor) -> torch.Tensor:
    """Each token's attention over its sequence's encoder K/V: q f32
    [T, H, D] (any scale already in it); cross_pages one
    layer's cross cache [P, page_size, 2H, D]; the sequence's cross pages
    and encoder length from ``batch.cross_page_indices`` and
    ``batch.cross_kv_lens``. Every page of the batch's cross table is
    gathered (its width is bucketed on the batch's longest encoder) and
    keys past the encoder length are masked, as in the JAX models. f32
    [T, H, D]."""
    S = batch.cross_page_indices.shape[0]
    H, D = q.shape[1], q.shape[2]
    index = batch.cross_page_indices.long()
    if cross_pages.dtype.itemsize == 1:
        # One-byte page types are gathered as bytes (indexing has no fp8
        # kernel on every device).
        kv = cross_pages.view(torch.uint8)[index].view(cross_pages.dtype)
    else:
        kv = cross_pages[index]
    kv = kv.float().reshape(S, -1, 2 * H, D)
    k = kv[:, :, 0::2].index_select(0, seq_of)  # [T, N, H, D]
    v = kv[:, :, 1::2].index_select(0, seq_of)
    scores = torch.einsum("thd,tnhd->thn", q, k)
    keys = torch.arange(k.shape[1], device=q.device)
    visible = keys[None, :] < batch.cross_kv_lens.index_select(
        0, seq_of)[:, None]  # [T, N]
    scores = torch.where(visible[:, None, :], scores, MASK_VALUE)
    return torch.einsum("thn,tnhd->thd", torch.softmax(scores, dim=-1), v)

