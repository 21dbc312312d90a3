"""Ragged paged attention.

Counterpart of aphrodite_tpu/ops/attention.py: one flat stream of query
tokens (prefill chunks and decode tokens, split by ``cu_q_lens``) over the
paged KV cache.

- ``ref_ragged_paged_attention``: the plain PyTorch version. The CPU path
  and the reference the CUDA kernel is held against.
- ``ragged_paged_attention``: the dispatching wrapper. ``cu_q_lens=None``
  marks a pure-decode batch and goes to ``paged_decode_attention``, or, at
  a head_dim the decode kernel does not take (384: MiniCPM3's latent MLA
  head), to this kernel over cu_q_lens = arange(S + 1), one token a
  sequence, as the JAX package routes it (its decode kernel takes only 64
  and 128); the arange is the decode window's static buffer
  (``decode_cu_q_lens``), so its CUDA graph holds it and no host value is
  read. Else
  CPU tensors take the plain version, and CUDA tensors launch the
  hand-written Hopper kernel ``csrc/ragged_paged_attention.cuh`` (which
  replaces the TPU kernel behind aphrodite_tpu/ops/attention.py:
  _kernel_attention) or raise. At prefill shapes the kernel is bound by
  operations; its source says what its design does about that. With
  float8 pages it also stands for the fp8 path of the vendored fork
  aphrodite_tpu/ops/rpa_alibi_kernel.py: ragged_paged_attention_alibi,
  where the JAX package sends fp8 prefill; int8 pages go to the bundled
  kernel there and to the same source here. Page types and their entry
  points: ops/decode_attention.py.

With an ALiBi slope table both this kernel and the decode one add the
distance bias in their loops; the JAX package sends ALiBi prefill to its
vendored fork (ragged_paged_attention_alibi), whose ALiBi option this
source also stands for. So is it with blocksparse (Phi-3-Small's mask,
ops/decode_attention.py): the JAX package sends blocksparse prefill to
the fork, whose blocksparse option this source's third library stands
for.

Cache layout: [num_pages, page_size, 2 * num_kv_heads, head_dim], K at
even and V at odd combined-head indices.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.decode_attention import (BLOCKSPARSE_ARGTYPES,
                                                      DECODE_HEAD_DIMS,
                                                      KERNEL_PAGE_TYPES,
                                                      RAGGED_HEAD_DIMS,
                                                      RAGGED_ONLY_HEAD_DIMS,
                                                      attend,
                                                      blocksparse_args,
                                                      check_kernel_inputs,
                                                      gather_kv,
                                                      launch_shape,
                                                      paged_decode_attention,
                                                      slopes_ptr)
from aphrodite_tpu_torch.ops.launches import count_launch


def ref_ragged_paged_attention(
    q: torch.Tensor,  # [T, QH, D]
    kv_pages: torch.Tensor,  # [P, page_size, 2*KV, D]
    kv_lens: torch.Tensor,  # i32[S] post-write kv length
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor,  # i32[S+1]
    num_seqs: Optional[torch.Tensor] = None,
    *,
    sm_scale: float = 1.0,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # f32[QH]
    blocksparse: Optional[Tuple[int, int, int]] = None,
    bs_head_offsets: Optional[torch.Tensor] = None,  # i32[QH]
    bs_on: bool = True,
    rel_bias: Optional[torch.Tensor] = None,  # f32[QH, NB]
    rel_bias_meta: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Plain ragged paged attention, one sequence at a time.

    Token i of sequence s sits at absolute position kv_len - q_len + i.
    Tokens past cu_q_lens[S] (padding) get zeros; the JAX reference
    leaves garbage there, which callers ignore either way. rel_bias: T5's
    causal bucket bias (``attend``), which the ragged kernel does not take:
    the T5 model's prefill is this plain version, as it is XLA code in the
    JAX package.
    """
    del num_seqs
    if not bs_on:
        blocksparse = None
    out = torch.zeros_like(q)
    cu = cu_q_lens.tolist()
    for s, kv_len in enumerate(kv_lens.tolist()):
        q_len = cu[s + 1] - cu[s]
        if q_len <= 0 or kv_len <= 0:
            continue
        k, v = gather_kv(kv_pages, page_indices[s], kv_len)
        pos = torch.arange(kv_len - q_len, kv_len, device=q.device)
        out[cu[s]:cu[s + 1]] = attend(
            q[cu[s]:cu[s + 1]], k, v, pos, sm_scale=sm_scale,
            sliding_window=sliding_window, soft_cap=soft_cap,
            alibi_slopes=alibi_slopes, blocksparse=blocksparse,
            bs_head_offsets=bs_head_offsets, rel_bias=rel_bias,
            rel_bias_meta=rel_bias_meta).to(q.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _kernel(page_type: str, alibi: bool, blocksparse: bool, head_dim: int):
    # The variants with ALiBi, those with blocksparse and those at head_dim
    # 384 are libraries of their own (built in parallel with the plain one).
    name = ("ragged_paged_attention" + ("_alibi" if alibi else "")
            + ("_blocksparse" if blocksparse else "")
            + (f"_d{head_dim}" if head_dim in RAGGED_ONLY_HEAD_DIMS else ""))
    fn = getattr(cuda_build.load(name), f"{name}_{page_type}")
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
                   + BLOCKSPARSE_ARGTYPES + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ragged_paged_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: Optional[torch.Tensor],
    num_seqs: torch.Tensor,
    *,
    sm_scale: float = 1.0,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    blocksparse: Optional[Tuple[int, int, int]] = None,
    bs_head_offsets: Optional[torch.Tensor] = None,
    bs_on: bool = True,
    decode_cu_q_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """decode_cu_q_lens: with cu_q_lens None, arange(S + 1) as i32 on q's
    device (the decode window's static buffer), which a head_dim the
    decode kernel does not take launches this kernel over; made here if
    not given."""
    kwargs = dict(sm_scale=sm_scale, sliding_window=sliding_window,
                  soft_cap=soft_cap, alibi_slopes=alibi_slopes,
                  blocksparse=blocksparse, bs_head_offsets=bs_head_offsets,
                  bs_on=bs_on)
    if cu_q_lens is None:
        if q.shape[-1] in DECODE_HEAD_DIMS:
            return paged_decode_attention(q, kv_pages, kv_lens, page_indices,
                                          num_seqs, **kwargs)
        cu_q_lens = decode_cu_q_lens
        if cu_q_lens is None:
            cu_q_lens = torch.arange(q.shape[0] + 1, dtype=torch.int32,
                                     device=q.device)
    if q.device.type == "cpu":
        return ref_ragged_paged_attention(q, kv_pages, kv_lens,
                                          page_indices, cu_q_lens, **kwargs)
    bs = blocksparse_args(blocksparse, bs_head_offsets, bs_on)
    check_kernel_inputs(q, kv_pages, (kv_lens, page_indices, cu_q_lens),
                        alibi_slopes,
                        None if bs[0] is None else bs_head_offsets,
                        head_dims=RAGGED_HEAD_DIMS)
    num_tokens, num_q_heads, head_dim = q.shape
    num_seqs_padded = kv_lens.shape[0]
    if (cu_q_lens.shape != (num_seqs_padded + 1,)
            or page_indices.shape[0] != num_seqs_padded):
        raise ValueError("cu_q_lens needs S+1 entries and page_indices S "
                         "rows for S = len(kv_lens)")
    _, page_size, ckv, _ = kv_pages.shape
    # Tokens past cu_q_lens[S] belong to no sequence; the kernel leaves
    # them alone.
    out = torch.zeros_like(q)
    page_type = KERNEL_PAGE_TYPES[kv_pages.dtype]
    err = _kernel(page_type, alibi_slopes is not None, bs[0] is not None,
                  head_dim)(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(), cu_q_lens.data_ptr(),
        slopes_ptr(alibi_slopes), out.data_ptr(), num_tokens,
        num_seqs_padded, num_q_heads, ckv // 2, head_dim, page_size,
        page_indices.shape[1], float(sm_scale),
        int(sliding_window or 0), float(soft_cap or 0.0), *bs,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention kernel: CUDA error {err}")
    count_launch(ragged_paged_attention, dtype=page_type,
                 shape=launch_shape(num_q_heads, ckv // 2, head_dim,
                                    alibi_slopes, bs[0] is not None))
    return out


# Launches of the kernel: the total, per page type, and per QH / KV and
# head_dim with ALiBi, blocksparse or neither.
ragged_paged_attention.launches = 0
ragged_paged_attention.launches_by_dtype = {}
ragged_paged_attention.launches_by_shape = {}
