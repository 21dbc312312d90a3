"""Model <-> runner interface types."""

from typing import NamedTuple, Optional

import torch


class ForwardBatch(NamedTuple):
    """Flat inputs for one step (T padded tokens, S padded sequences), as
    device tensors. Counterpart of aphrodite_tpu/models/interface.py
    without the LoRA, multimodal and M-RoPE fields, which later slices
    bring."""

    # [T] token ids (padding: 0).
    token_ids: torch.Tensor
    # [T] absolute position of each token in its sequence (padding: 0).
    positions: torch.Tensor
    # [T] flat KV slot (= page * page_size + offset); padding rows point
    # into the reserved trash page.
    slot_mapping: torch.Tensor
    # [S] post-step KV length per sequence (padding: 0).
    kv_lens: torch.Tensor
    # [S, pages_per_seq] physical page ids per sequence (padding: 0).
    page_indices: torch.Tensor
    # [S+1] cumulative query lengths (padding: repeated last value), or
    # None for a pure-decode batch (q_len == 1 per row).
    cu_q_lens: Optional[torch.Tensor]
    # [1] actual number of sequences.
    num_seqs: torch.Tensor
    # [S] index into [T] of the last token of each sequence (for logits
    # extraction; padding: 0).
    logits_indices: torch.Tensor
    # Encoder-decoder models: each sequence's cross-attention pages (the
    # encoder's K/V, written once by the encoder pass) and encoder length;
    # None for a decoder-only model.
    cross_page_indices: Optional[torch.Tensor] = None  # i32[S, enc_pages]
    cross_kv_lens: Optional[torch.Tensor] = None  # i32[S]
    # A pure-decode batch's cu_q_lens for the ragged kernel, i32[S + 1] =
    # arange(S + 1): a head_dim the decode kernel does not take (MLA's
    # latent 384) attends through the ragged kernel over it. The decode
    # window's static buffer, so its CUDA graph holds it; None elsewhere.
    decode_cu_q_lens: Optional[torch.Tensor] = None
