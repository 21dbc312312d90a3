"""Paged decode attention: one query token per sequence.

Counterpart of aphrodite_tpu/ops/decode_attention.py. The fused
multi-step decode window sends every step here (``cu_q_lens=None`` in
``ops/attention.ragged_paged_attention``).

- ``ref_paged_decode_attention``: the plain PyTorch version. The CPU path
  and the reference the CUDA kernel is held against.
- ``paged_decode_attention``: the dispatching wrapper. CPU tensors take
  the plain version; CUDA tensors launch the hand-written Hopper kernel
  ``csrc/paged_decode_attention.cuh`` (built as
  ``paged_decode_attention.cu`` and, with T5's bias,
  ``paged_decode_attention_rel.cu``; it replaces the TPU kernel
  aphrodite_tpu/ops/decode_attention.py: paged_decode_attention ->
  _decode_kernel) or raise. The kernel is bound by bytes (each live K/V
  row is read once per step); it splits each row's keys into fixed ranges
  (``plan_decode_splits``, from host values alone), spreads them over
  blocks of (sequence, kv head, slot), and merges the splits' partials in
  a second pass; its source says more.
- ``ref_decode_partials`` and ``ref_merge_partials``: the plain split-KV
  pair, what the kernel's two passes compute (per-split flash partials
  over page-aligned key ranges, and their merge in split order);
  ``ref_split_decode_attention`` chains them. The tests and chip_smoke.py
  hold them against the JAX package and the kernel; nothing on the serving
  path calls them.

Cache layout (shared with the TPU package and both kernels):
  kv_pages: [num_pages, page_size, 2 * num_kv_heads, head_dim],
  K at even and V at odd combined-head indices.

Pages are bf16 or one of three narrow types (float8_e4m3fn, float8_e5m2,
int8). Narrow pages are read raw, one byte per value, and widened to bf16
inside the kernel (every such value is exact in bf16); each page type has
its own entry point of the same source. Scales never enter: the model
folds k_scale into q and v_scale into the output (models/llama.py).

Both kernels take head_dim 64, 80, 96, 128 or 256 with any number of query
heads per kv head (the instantiation is chosen at the launch; the decode
kernel takes more than 16 in a kernel of its own, ``decode_head_groups``),
and, at every one of those shapes, an optional ALiBi slope table
f32[QH]: score + slope[h] * (key position - query position), added after
the soft cap and before the mask, as the JAX package adds it. Or, at
head_dim 128 with 1, 2, 4 or 8 query heads per kv head and instead of
ALiBi, Phi-3-Small's blocksparse mask:
``blocksparse=(block_size, local_blocks, vert_stride)`` with
``bs_head_offsets`` (a contiguous i32[QH] tensor on q's device, each
global query head's vertical phase) and ``bs_on`` (a Python bool, the
layer's gate; False launches the instantiation without blocksparse).
With b(x) = x // block_size, key j is visible to a query at position p
for head h iff b(p) - b(j) < local_blocks or (b(j) + offsets[h] + 1) %
vert_stride == 0, ANDed with the causal mask and the window.

The decode kernel also takes T5's relative-position bias, at every shape
it takes and on every page type, but neither with ALiBi nor with
blocksparse: ``rel_bias`` f32[QH, NB] (one table shared by every layer)
and ``rel_bias_meta`` (num_buckets, max_distance). The score of key j
gains table[h, bucket(p - j)] (``t5_relative_bucket``, causal), after the
soft cap and the ALiBi term's place and before the mask, as the JAX kernel
adds it. The wrapper hands the kernel the table's columns by distance
(``rel_bias_columns``), so the card computes no logarithm.
"""

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.launches import count_launch

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# The shapes both CUDA kernels are built for: head_dim 64, 80 (Phi-2,
# Pythia-2.8B, StableLM-3B), 96 (Phi-3-mini), 128 or 256 (Gemma, Gemma2,
# Gemma3), the head_dims of the JAX-bundled ragged kernel and those the JAX
# package sends to its jnp reference (80), at every QH / KV, from 1 (MHA:
# Baichuan-13B, Bloom, MPT, JAIS) to Falcon-7B's 71 (multi-query), with or
# without ALiBi.
# Blocksparse is built for head_dim 128 at QH / KV 1, 2, 4 or 8 only
# (Phi-3-Small's 4).
KERNEL_HEAD_DIMS = (64, 80, 96, 128, 256)
BLOCKSPARSE_HEAD_DIM = 128
BLOCKSPARSE_QUERIES_PER_KV = (1, 2, 4, 8)
# Up to this QH / KV the decode kernel holds a kv head's query heads as
# the rows of one mma tile; above it its wide kernel takes them, 128 query
# heads a block (a block per group of 128 past that).
DECODE_TILE_QUERIES = 16
DECODE_WIDE_QUERIES = 128
# Page types the CUDA kernels read, and the suffix of each one's entry
# point (also its key in ``launches_by_dtype``).
KERNEL_PAGE_TYPES = {torch.bfloat16: "bf16", torch.float8_e4m3fn: "e4m3",
                     torch.float8_e5m2: "e5m2", torch.int8: "int8"}


def gather_kv(kv_pages: torch.Tensor, pages: torch.Tensor, kv_len: int):
    """The first kv_len K and V rows of one sequence: f32 [kv_len, KV, D]
    each. Reads nothing past kv_len."""
    _, page_size, ckv, head_dim = kv_pages.shape
    n_pages = -(-kv_len // page_size)
    # One-byte page types are gathered as bytes: indexing has no fp8
    # kernel on every device.
    narrow = kv_pages.dtype.itemsize == 1
    raw = kv_pages.view(torch.uint8) if narrow else kv_pages
    rows = raw[pages[:n_pages].long()].reshape(-1, ckv, head_dim)[:kv_len]
    rows = rows.view(kv_pages.dtype).float()
    return rows[:, 0::2], rows[:, 1::2]


def t5_relative_bucket(rel: torch.Tensor, bidirectional: bool,
                       num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's relative-position bucket of rel = key position - query
    position (an integer tensor), HF T5Attention._relative_position_bucket:
    a copy of aphrodite_tpu/models/t5.py: _rel_bucket, whose f32 arithmetic
    it repeats (the logarithm of the distance over max_exact, divided by the
    f32 log(max_distance / max_exact), times the buckets left, truncated),
    so that it gives the JAX package's bucket at every distance. The causal
    form (the decoder's) puts every key at or after the query in bucket 0."""
    f32 = torch.float32
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(rel.dtype) * num_buckets
        n = rel.abs()
    else:
        n = -rel.clamp(max=0)
    max_exact = num_buckets // 2
    logv = torch.log(n.clamp(min=1).to(f32)
                     / torch.tensor(max_exact, dtype=f32))
    large = max_exact + (
        logv / torch.tensor(math.log(max_distance / max_exact), dtype=f32)
        * torch.tensor(num_buckets - max_exact, dtype=f32)).to(rel.dtype)
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


@functools.lru_cache(maxsize=None)
def rel_bias_distances(num_buckets: int, max_distance: int) -> torch.Tensor:
    """The causal bucket of each distance 0, 1, ..., N (an int64 CPU
    tensor), N the saturation distance: the first whose bucket is the last
    (num_buckets - 1), which every longer distance shares. Computed once per
    (num_buckets, max_distance) by ``t5_relative_bucket``; N is at most
    max(max_distance, num_buckets)."""
    n = torch.arange(max(max_distance, num_buckets) + 1)
    buckets = t5_relative_bucket(-n, False, num_buckets, max_distance)
    last = (buckets == num_buckets - 1).nonzero()
    if not len(last):
        raise ValueError(f"T5 buckets ({num_buckets}, {max_distance}) never "
                         "reach the last bucket")
    return buckets[:int(last[0]) + 1].long()


@functools.lru_cache(maxsize=None)
def _distances_on(num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    return rel_bias_distances(num_buckets, max_distance).to(device)


def rel_bias_columns(rel_bias: torch.Tensor,
                     rel_bias_meta: Tuple[int, int]) -> torch.Tensor:
    """What the decode kernel reads of a T5 table f32[QH, NB]: its
    columns by distance, f32[QH, N + 1] (column n = table[:, bucket(n)],
    ``rel_bias_distances``), contiguous on the table's device; a gather,
    so each column holds the table's value bit for bit."""
    idx = _distances_on(*(int(x) for x in rel_bias_meta), rel_bias.device)
    return rel_bias.float().index_select(1, idx).contiguous()


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, *, sm_scale: float,
           sliding_window: Optional[int], soft_cap: Optional[float],
           alibi_slopes: Optional[torch.Tensor] = None,
           blocksparse: Optional[Tuple[int, int, int]] = None,
           bs_head_offsets: Optional[torch.Tensor] = None,
           rel_bias: Optional[torch.Tensor] = None,
           rel_bias_meta: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Attention of n query rows q [n, QH, D] at absolute positions q_pos
    over keys k/v [L, KV, D] at positions 0..L-1 (f32 result).

    Query head h reads kv head h // (QH / KV). Key j is visible to the row
    at position p iff j <= p and, with a window w, j > p - w, and, with
    blocksparse (block_size, local, vert) and phases bs_head_offsets
    (i32[QH]), p // block_size - j // block_size < local or
    (j // block_size + offsets[h] + 1) % vert == 0. With ALiBi slopes
    (f32[QH]) the capped score of head h gains slope[h] * (j - p), the
    product rounded to f32 before the sum; with a T5 table rel_bias
    (f32[QH, NB], rel_bias_meta = (num_buckets, max_distance)) it gains
    rel_bias[h, bucket(j - p)], the causal ``t5_relative_bucket``, after
    that. Masked scores take MASK_VALUE (as in the JAX reference), not
    -inf.
    """
    n, num_q_heads, head_dim = q.shape
    num_kv_heads = k.shape[1]
    qg = num_q_heads // num_kv_heads
    qf = q.float().reshape(n, num_kv_heads, qg, head_dim) * sm_scale
    scores = torch.einsum("ngkd,lgd->gknl", qf, k)  # [KV, QG, n, L]
    if soft_cap is not None:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    kv_pos = torch.arange(k.shape[0], device=q.device)
    if alibi_slopes is not None:
        rel = (kv_pos[None, :] - q_pos[:, None]).float()  # [n, L]
        slopes = alibi_slopes.float().reshape(num_kv_heads, qg, 1, 1)
        scores = scores + slopes * rel
    if rel_bias is not None:
        bucket = t5_relative_bucket(kv_pos[None, :] - q_pos[:, None], False,
                                    *rel_bias_meta)  # [n, L]
        scores = scores + rel_bias.float()[:, bucket].reshape(
            num_kv_heads, qg, *bucket.shape)
    mask = kv_pos[None, :] <= q_pos[:, None]
    if sliding_window is not None:
        mask &= kv_pos[None, :] > (q_pos[:, None] - sliding_window)
    if blocksparse is not None:
        block, local, vert = blocksparse
        bk = kv_pos // block  # [L]
        local_ok = (q_pos[:, None] // block - bk[None, :]) < local  # [n, L]
        offsets = bs_head_offsets.to(q.device).long().reshape(
            num_kv_heads, qg, 1, 1)
        vert_ok = (bk + offsets + 1) % vert == 0  # [KV, QG, 1, L]
        mask = mask & (local_ok | vert_ok)  # [KV, QG, n, L]
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("gknl,lgd->ngkd", probs, v)
    return out.reshape(n, num_q_heads, head_dim)


def ref_paged_decode_attention(
    q: torch.Tensor,  # [S, QH, D]: row s = the one new token of sequence s
    kv_pages: torch.Tensor,  # [P, page_size, 2*KV, D]
    kv_lens: torch.Tensor,  # i32[S] post-write kv length (0 = dead row)
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
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
    """Plain decode attention; dead rows (kv_len == 0) get zeros, as the
    TPU kernel writes them."""
    if not bs_on:
        blocksparse = None
    out = torch.zeros_like(q)
    for s, kv_len in enumerate(kv_lens.tolist()):
        if kv_len <= 0:
            continue
        k, v = gather_kv(kv_pages, page_indices[s], kv_len)
        pos = torch.tensor([kv_len - 1], device=q.device)
        out[s] = attend(q[s:s + 1], k, v, pos, sm_scale=sm_scale,
                        sliding_window=sliding_window, soft_cap=soft_cap,
                        alibi_slopes=alibi_slopes, blocksparse=blocksparse,
                        bs_head_offsets=bs_head_offsets, rel_bias=rel_bias,
                        rel_bias_meta=rel_bias_meta)[0].to(q.dtype)
    return out


# Split-KV decode. The kernel's tile is 64 keys; a split is a whole number
# of tiles (and of pages). The grid holds DECODE_BLOCKS_PER_SM blocks an SM
# where there are splits enough, each block (slot) taking every slots-th
# split of its row.
DECODE_TILE_KEYS = 64
DECODE_SPLIT_KEYS = 256
DECODE_BLOCKS_PER_SM = 8


def decode_head_groups(queries_per_kv: int) -> int:
    """The decode kernel's blocks per (row, kv head, slot): one up to
    DECODE_WIDE_QUERIES query heads per kv head, else one per group of
    that many."""
    if queries_per_kv <= DECODE_TILE_QUERIES:
        return 1
    return -(-queries_per_kv // DECODE_WIDE_QUERIES)


def plan_decode_splits(num_seqs: int, num_kv_heads: int, max_keys: int,
                       page_size: int, num_sms: int,
                       head_groups: int = 1) -> Tuple[int, int, int]:
    """(split_keys, num_splits, num_slots) for a decode call of num_seqs
    rows and num_kv_heads kv heads, each taken by head_groups blocks
    (``decode_head_groups``), whose page table holds max_keys =
    pages_per_seq * page_size keys a row, on a card of num_sms SMs: host
    values only, no read of kv_lens. split_keys is a multiple of the tile
    and of the page (whole pages for page sizes that divide or are
    multiples of 64), num_splits * split_keys covers max_keys, and
    num_slots (blocks per row, kv head and head group) is at most
    num_splits."""
    pairs = max(1, num_seqs * num_kv_heads * head_groups)
    unit = DECODE_TILE_KEYS * page_size // math.gcd(DECODE_TILE_KEYS,
                                                    page_size)
    split = -(-DECODE_SPLIT_KEYS // unit) * unit
    num_splits = -(-max(1, max_keys) // split)
    num_slots = min(num_splits, -(-DECODE_BLOCKS_PER_SM * num_sms // pairs))
    return split, num_splits, num_slots


@functools.lru_cache(maxsize=None)
def device_sms(device_index: int) -> int:
    """The SM count of CUDA device `device_index`."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_split_ranges(kv_len: int, split_keys: int, num_splits: int,
                        sliding_window: Optional[int] = None
                        ) -> List[Tuple[int, int]]:
    """The key range [lo, hi) of each split of one row: split i covers
    [i * split_keys, (i + 1) * split_keys) cut to [kv_lo, kv_len), empty
    (lo >= hi) where they do not meet."""
    kv_lo = max(0, kv_len - sliding_window) if sliding_window else 0
    return [(max(kv_lo, i * split_keys), min(kv_len, (i + 1) * split_keys))
            for i in range(num_splits)]


def decode_scratch(num_slots: int, num_seqs: int, num_q_heads: int,
                   head_dim: int, device) -> Tuple[Optional[torch.Tensor],
                                                   Optional[torch.Tensor]]:
    """The kernel's scratch for the partials, one per slot (the merge of
    that block's splits): acc f32[num_slots, S, QH, D] and (m, l)
    f32[num_slots, S, QH, 2]; none with one slot (every row then writes its
    output directly). Its size follows the grid, not the page table."""
    if num_slots == 1:
        return None, None
    shape = (num_slots, num_seqs, num_q_heads)
    return (torch.empty((*shape, head_dim), dtype=torch.float32,
                        device=device),
            torch.empty((*shape, 2), dtype=torch.float32, device=device))


def ref_decode_partials(
    q: torch.Tensor,  # [S, QH, D]
    kv_pages: torch.Tensor,  # [P, page_size, 2*KV, D]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    split_keys: int,
    num_splits: int,
    *,
    sm_scale: float = 1.0,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    blocksparse: Optional[Tuple[int, int, int]] = None,
    bs_head_offsets: Optional[torch.Tensor] = None,
    bs_on: bool = True,
    rel_bias: Optional[torch.Tensor] = None,
    rel_bias_meta: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain per-split flash partials of decode attention (the kernel's
    block merges the splits of its slot as it goes, into one partial per
    slot, in its online softmax): for split i of row s over its keys
    (``decode_split_ranges``), with scores as ``attend`` forms them and
    masked ones at -inf, m = their maximum, p = exp(score - m), l = sum(p)
    and acc = p . v, unnormalised. Returns acc f32[num_splits, S, QH, D],
    m and l f32[num_splits, S, QH]; a split with no visible key (past
    kv_len, before the window, or all masked) has m = -inf, l = 0, acc =
    0. Reads nothing past kv_len."""
    if not bs_on:
        blocksparse = None
    num_seqs, num_q_heads, head_dim = q.shape
    num_kv_heads = kv_pages.shape[2] // 2
    qg = num_q_heads // num_kv_heads
    dev = q.device
    acc = torch.zeros((num_splits, num_seqs, num_q_heads, head_dim),
                      device=dev)
    m = torch.full((num_splits, num_seqs, num_q_heads), -math.inf,
                   device=dev)
    l = torch.zeros((num_splits, num_seqs, num_q_heads), device=dev)
    for s, kv_len in enumerate(kv_lens.tolist()):
        if kv_len <= 0:
            continue
        k, v = gather_kv(kv_pages, page_indices[s], kv_len)
        pos = kv_len - 1
        qf = q[s].float().reshape(num_kv_heads, qg, head_dim) * sm_scale
        ranges = decode_split_ranges(kv_len, split_keys, num_splits,
                                     sliding_window)
        for i, (lo, hi) in enumerate(ranges):
            if lo >= hi:
                continue
            keys = torch.arange(lo, hi, device=dev)
            scores = torch.einsum("gkd,lgd->gkl", qf, k[lo:hi])
            if soft_cap is not None:
                scores = soft_cap * torch.tanh(scores / soft_cap)
            if alibi_slopes is not None:
                scores = scores + (alibi_slopes.float().to(dev).reshape(
                    num_kv_heads, qg, 1) * (keys - pos).float())
            if rel_bias is not None:
                bucket = t5_relative_bucket(keys - pos, False, *rel_bias_meta)
                scores = scores + rel_bias.float().to(dev)[:, bucket].reshape(
                    num_kv_heads, qg, -1)
            if blocksparse is not None:
                block, local, vert = blocksparse
                bk = keys // block
                offsets = bs_head_offsets.to(dev).long().reshape(
                    num_kv_heads, qg, 1)
                visible = ((pos // block - bk) < local) | (
                    (bk + offsets + 1) % vert == 0)
                scores = torch.where(visible, scores, -math.inf)
            mx = scores.amax(-1)  # [KV, QG]
            p = torch.where(mx[..., None] == -math.inf,
                            torch.zeros_like(scores),
                            torch.exp(scores - mx[..., None]))
            m[i, s] = mx.reshape(num_q_heads)
            l[i, s] = p.sum(-1).reshape(num_q_heads)
            acc[i, s] = torch.einsum("gkl,lgd->gkd", p, v[lo:hi]).reshape(
                num_q_heads, head_dim)
    return acc, m, l


def ref_merge_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """Plain merge of flash partials over their first axis (the kernel's
    second pass, and the JAX package's merge_attention_partials): with m*
    the largest m, out = sum(w acc) / sum(w l), w = exp(m - m*), where
    partials with m = -inf weigh 0 and a row with none is 0."""
    m_max = m.amax(0)
    w = torch.where(m == -math.inf, torch.zeros_like(m),
                    torch.exp(m - m_max))
    l_tot = (w * l).sum(0)
    num = (w[..., None] * acc).sum(0)
    return (num / torch.where(l_tot == 0, torch.ones_like(l_tot),
                              l_tot)[..., None]).to(out_dtype)


def ref_split_decode_attention(q, kv_pages, kv_lens, page_indices,
                               split_keys: int, num_splits: int,
                               **kw) -> torch.Tensor:
    """Plain split-KV decode: ``ref_decode_partials``, then
    ``ref_merge_partials``; dead rows (kv_len == 0) get zeros."""
    return ref_merge_partials(*ref_decode_partials(
        q, kv_pages, kv_lens, page_indices, split_keys, num_splits, **kw),
        q.dtype)


# The blocksparse arguments of both kernels' entry points: the phase table
# (NULL: off), block size, local blocks, vertical stride.
BLOCKSPARSE_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 3
# The decode kernel's T5 arguments: the columns by distance (NULL: off) and
# their number.
REL_BIAS_ARGTYPES = [ctypes.c_void_p, ctypes.c_int]


@functools.lru_cache(maxsize=None)
def _kernel(page_type: str, rel: bool):
    # The entry points with T5's bias are a library of their own (built in
    # parallel with the one without it).
    name = "paged_decode_attention" + ("_rel" if rel else "")
    fn = getattr(cuda_build.load(name), f"{name}_{page_type}")
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
                   + BLOCKSPARSE_ARGTYPES + REL_BIAS_ARGTYPES
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def blocksparse_args(blocksparse: Optional[Tuple[int, int, int]],
                     bs_head_offsets: Optional[torch.Tensor],
                     bs_on: bool) -> Tuple[Optional[int], int, int, int]:
    """The blocksparse arguments of one launch: the phase table's address
    and the three sizes, or None (NULL) and zeros where it is off."""
    if blocksparse is None or not bs_on:
        return None, 0, 0, 0
    return (bs_head_offsets.data_ptr(), *(int(n) for n in blocksparse))


def check_kernel_inputs(q, kv_pages, index_tensors, alibi_slopes=None,
                        bs_head_offsets=None, rel_bias=None):
    """Raise unless the tensors are what the CUDA attention kernels take.
    bs_head_offsets: the phase table of a launch with blocksparse on;
    rel_bias: a T5 table (the decode kernel's), which takes neither ALiBi
    nor blocksparse beside it."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype != torch.bfloat16 or kv_pages.dtype not in KERNEL_PAGE_TYPES:
        raise ValueError(
            "attention kernel takes bf16 q and kv pages of bfloat16, "
            "float8_e4m3fn, float8_e5m2 or int8, got "
            f"{q.dtype} and {kv_pages.dtype}")
    num_q_heads, head_dim = q.shape[1], q.shape[2]
    num_kv_heads = kv_pages.shape[2] // 2
    if (head_dim not in KERNEL_HEAD_DIMS or kv_pages.shape[3] != head_dim
            or num_kv_heads < 1 or num_q_heads % num_kv_heads):
        raise ValueError(
            f"attention kernel takes head_dim in {KERNEL_HEAD_DIMS} and QH "
            f"a multiple of KV; got q {tuple(q.shape)}, kv pages "
            f"{tuple(kv_pages.shape)}")
    qg = num_q_heads // num_kv_heads
    if bs_head_offsets is not None and (
            head_dim != BLOCKSPARSE_HEAD_DIM
            or qg not in BLOCKSPARSE_QUERIES_PER_KV):
        raise ValueError(
            f"attention kernel takes blocksparse at head_dim "
            f"{BLOCKSPARSE_HEAD_DIM} and QH/KV in "
            f"{BLOCKSPARSE_QUERIES_PER_KV}; got head_dim {head_dim}, "
            f"QH/KV {qg}")
    if alibi_slopes is not None and (
            alibi_slopes.device != q.device
            or alibi_slopes.dtype != torch.float32
            or alibi_slopes.shape != (num_q_heads,)
            or not alibi_slopes.is_contiguous()):
        raise ValueError(
            "attention kernel takes ALiBi slopes as a contiguous f32 "
            f"[{num_q_heads}] tensor on q's device, got "
            f"{alibi_slopes.dtype} {tuple(alibi_slopes.shape)} on "
            f"{alibi_slopes.device}")
    if bs_head_offsets is not None:
        if alibi_slopes is not None:
            raise ValueError("attention kernels take ALiBi or blocksparse, "
                             "not both")
        if (bs_head_offsets.device != q.device
                or bs_head_offsets.dtype != torch.int32
                or bs_head_offsets.shape != (num_q_heads,)
                or not bs_head_offsets.is_contiguous()):
            raise ValueError(
                "attention kernel takes blocksparse head offsets as a "
                f"contiguous int32 [{num_q_heads}] tensor on q's device, got "
                f"{bs_head_offsets.dtype} {tuple(bs_head_offsets.shape)} on "
                f"{bs_head_offsets.device}")
    if rel_bias is not None:
        if alibi_slopes is not None or bs_head_offsets is not None:
            raise ValueError("the decode kernel takes a T5 bias without ALiBi "
                             "and without blocksparse")
        if (rel_bias.device != q.device or rel_bias.dtype != torch.float32
                or len(rel_bias.shape) != 2
                or rel_bias.shape[0] != num_q_heads):
            raise ValueError(
                "the decode kernel takes a T5 bias as an f32 "
                f"[{num_q_heads}, num_buckets] tensor on q's device, got "
                f"{rel_bias.dtype} {tuple(rel_bias.shape)} on "
                f"{rel_bias.device}")
    for t in (q, kv_pages):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel needs contiguous, 16-byte "
                             "aligned q and kv pages")
    for t in index_tensors:
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("attention kernel needs contiguous int32 "
                             "index tensors on the same device as q")


def paged_decode_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    num_seqs: Optional[torch.Tensor] = None,
    *,
    sm_scale: float = 1.0,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    blocksparse: Optional[Tuple[int, int, int]] = None,
    bs_head_offsets: Optional[torch.Tensor] = None,
    bs_on: bool = True,
    rel_bias: Optional[torch.Tensor] = None,
    rel_bias_meta: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Decode attention over the paged cache. num_seqs is unused:
    kv_lens == 0 marks the dead padded rows. On the card one call is one
    counted launch: the split kernel and, with more than one slot, the
    combine kernel; the split plan it launched is kept in
    ``paged_decode_attention.last_plan``."""
    del num_seqs
    if (rel_bias is None) != (rel_bias_meta is None):
        raise ValueError("rel_bias and rel_bias_meta go together")
    if q.device.type == "cpu":
        return ref_paged_decode_attention(
            q, kv_pages, kv_lens, page_indices, sm_scale=sm_scale,
            sliding_window=sliding_window, soft_cap=soft_cap,
            alibi_slopes=alibi_slopes, blocksparse=blocksparse,
            bs_head_offsets=bs_head_offsets, bs_on=bs_on, rel_bias=rel_bias,
            rel_bias_meta=rel_bias_meta)
    bs = blocksparse_args(blocksparse, bs_head_offsets, bs_on)
    check_kernel_inputs(q, kv_pages, (kv_lens, page_indices), alibi_slopes,
                        None if bs[0] is None else bs_head_offsets, rel_bias)
    rel = (None if rel_bias is None
           else rel_bias_columns(rel_bias, rel_bias_meta))
    num_seqs, num_q_heads, head_dim = q.shape
    if kv_lens.shape != (num_seqs,) or page_indices.shape[0] != num_seqs:
        raise ValueError("kv_lens and page_indices need one row per query")
    _, page_size, ckv, _ = kv_pages.shape
    out = torch.empty_like(q)
    head_groups = decode_head_groups(num_q_heads // (ckv // 2))
    split_keys, num_splits, num_slots = plan_decode_splits(
        num_seqs, ckv // 2, page_indices.shape[1] * page_size, page_size,
        device_sms(q.device.index if q.device.index is not None
                else torch.cuda.current_device()), head_groups)
    part_acc, part_ml = decode_scratch(num_slots, num_seqs, num_q_heads,
                                       head_dim, q.device)
    page_type = KERNEL_PAGE_TYPES[kv_pages.dtype]
    err = _kernel(page_type, rel is not None)(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(), slopes_ptr(alibi_slopes), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        num_seqs, num_q_heads,
        ckv // 2, head_dim, page_size, page_indices.shape[1],
        float(sm_scale), int(sliding_window or 0), float(soft_cap or 0.0),
        *bs, None if rel is None else rel.data_ptr(),
        0 if rel is None else rel.shape[1], split_keys, num_slots,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel: CUDA error {err}")
    paged_decode_attention.last_plan = dict(
        split_keys=split_keys, splits=num_splits, slots=num_slots,
        blocks=num_seqs * (ckv // 2) * head_groups * num_slots)
    count_launch(paged_decode_attention, dtype=page_type,
                 shape=launch_shape(num_q_heads, ckv // 2, head_dim,
                                    alibi_slopes, bs[0] is not None,
                                    rel is not None))
    return out


def slopes_ptr(alibi_slopes: Optional[torch.Tensor]) -> Optional[int]:
    """The slope table's address for a kernel, or None (NULL: no ALiBi)."""
    return None if alibi_slopes is None else alibi_slopes.data_ptr()


def launch_shape(num_q_heads: int, num_kv_heads: int, head_dim: int,
                 alibi_slopes: Optional[torch.Tensor],
                 blocksparse: bool = False, rel_bias: bool = False) -> str:
    """The shape and option of a launch, as the key of
    ``launches_by_shape``: "qg<QH/KV> d<head_dim>", then " alibi" with a
    slope table, " blocksparse" with blocksparse on or " rel_bias" with a
    T5 table."""
    qg = num_q_heads // num_kv_heads
    return (f"qg{qg} d{head_dim}"
            + (" alibi" if alibi_slopes is not None else "")
            + (" blocksparse" if blocksparse else "")
            + (" rel_bias" if rel_bias else ""))


# Launches of the kernel: the total, per page type, and per QH / KV and
# head_dim with ALiBi, blocksparse, a T5 bias or none.
paged_decode_attention.launches = 0
paged_decode_attention.launches_by_dtype = {}
paged_decode_attention.launches_by_shape = {}
# The split plan of the last launch: split_keys, splits (of the page
# table), slots (blocks per row, kv head and head group), blocks (the
# grid).
paged_decode_attention.last_plan = None
