"""The port's plain split-KV decode against the JAX package, on the CPU.

The decode kernel of aphrodite_tpu_torch splits each row's keys into fixed,
page-aligned ranges; each block takes every slots-th split of its row into
one flash partial, and a second pass merges the blocks' partials
(csrc/paged_decode_attention.cuh). Its plain counterparts in
ops/decode_attention.py (``ref_decode_partials``, ``ref_merge_partials``,
``plan_decode_splits``) are held here, on the same numpy inputs, against
the JAX package's merge (``merge_attention_partials``), its per-shard
partials (``_partial_decode_ref``, with the pages outside a split marked
remote) and its jnp attention reference; the kernel itself is held
against them on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu.ops.decode_attention import (_partial_decode_ref,
                                                merge_attention_partials)
from aphrodite_tpu_torch.models.layers import get_alibi_slopes
from aphrodite_tpu_torch.ops.decode_attention import (
    DECODE_BLOCKS_PER_SM, DECODE_TILE_KEYS, decode_scratch,
    decode_split_ranges,
    plan_decode_splits, ref_decode_partials, ref_merge_partials,
    ref_paged_decode_attention, ref_split_decode_attention)
from tests.test_torch_cuda import PS, paged_batch

# The JAX package marks a partial with no visible key by m = -3e38; the
# port by m = -inf.
JAX_EMPTY_M = -3.0e38
E4M3_SCALE = 0.02


def test_plain_merge_matches_jax_merge():
    """Random partials over 5 splits, some of them empty (one row empty in
    every split): the port's merge against merge_attention_partials, 1e-6
    of the largest output."""
    rng = np.random.default_rng(0)
    R, S, QH, D = 5, 4, 6, 8
    acc = rng.standard_normal((R, S, QH, D)).astype(np.float32) * 3
    m = rng.standard_normal((R, S, QH)).astype(np.float32) * 4
    l = rng.uniform(0.5, 9.0, (R, S, QH)).astype(np.float32)
    dead = rng.random((R, S, QH)) < 0.3
    dead[:, 2, 1] = True  # a row that no split sees
    acc[dead] = 0.0
    l[dead] = 0.0
    m_port = np.where(dead, -np.inf, m).astype(np.float32)
    m_jax = np.where(dead, JAX_EMPTY_M, m).astype(np.float32)
    want = np.asarray(merge_attention_partials(
        jnp.asarray(acc), jnp.asarray(m_jax)[..., None],
        jnp.asarray(l)[..., None], jnp.float32))
    got = ref_merge_partials(torch.from_numpy(acc), torch.from_numpy(m_port),
                             torch.from_numpy(l), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert not got[2, 1].any()


@pytest.mark.parametrize("split_keys", [16, 64, 512])
def test_plain_partials_match_jax_partial_ref(split_keys):
    """Each split's partials (acc, m, l) against _partial_decode_ref with
    the pages outside the split set to -1 (remote), 1e-5 of the largest
    value; empty splits (past kv_len) have m = -inf here and -3e38
    there."""
    rng = np.random.default_rng(split_keys)
    lens = [1, split_keys, 2 * split_keys, split_keys - 3, 200, 0,
            3 * split_keys + 5]
    lens = [max(0, n) for n in lens]
    seqs = [(1, max(n, 1)) for n in lens]
    q, kv, _, pages, _ = paged_batch(rng, seqs, 4, 2, 16,
                                     padded_seqs=len(seqs),
                                     padded_tokens=len(seqs))
    kv_lens = np.asarray(lens, np.int32)
    split, n_splits = split_keys, -(-pages.shape[1] * PS // split_keys)
    acc, m, l = ref_decode_partials(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv_lens),
        torch.from_numpy(pages), split, n_splits, sm_scale=0.3)
    pages_per_split = split // PS
    for i in range(n_splits):
        local = np.full_like(pages, -1)
        sl = slice(i * pages_per_split, (i + 1) * pages_per_split)
        local[:, sl] = pages[:, sl]
        j_acc, j_m, j_l = (np.asarray(a) for a in _partial_decode_ref(
            jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv_lens),
            jnp.asarray(local), sm_scale=0.3))
        j_m, j_l = j_m[..., 0], j_l[..., 0]
        empty = j_m == JAX_EMPTY_M
        np.testing.assert_array_equal(m[i].numpy() == -np.inf, empty)
        np.testing.assert_allclose(m[i].numpy()[~empty], j_m[~empty],
                                   rtol=0, atol=1e-5 * np.abs(j_m).max())
        np.testing.assert_allclose(l[i].numpy(), j_l, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(j_l).max()))
        np.testing.assert_allclose(acc[i].numpy(), j_acc, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(j_acc).max()))
        assert not acc[i].numpy()[empty].any() and not l[i].numpy()[empty].any()


# (name, query heads, kv heads, head_dim, options, page type)
CASES = {
    "plain": (4, 2, 16, {}, "f32"),
    "window": (4, 2, 16, dict(sliding_window=37), "f32"),
    "soft_cap": (4, 2, 16, dict(soft_cap=5.0), "f32"),
    "alibi_qg1": (3, 3, 16, dict(alibi=True), "f32"),
    "blocksparse_qg4": (8, 2, 16, dict(blocksparse=(16, 2, 3)), "f32"),
    "qg7_d64": (14, 2, 64, dict(sliding_window=300, soft_cap=8.0), "f32"),
    "e4m3": (4, 2, 16, dict(sliding_window=90), "e4m3"),
}


def _pages(kv, page_type):
    """f32 values as f32 or E4M3 pages (value / E4M3_SCALE): numpy for JAX
    and a tensor of the same bytes for the port, with the scale to fold
    into sm_scale."""
    if page_type == "f32":
        return jnp.asarray(kv), torch.from_numpy(kv), 1.0
    jkv = jnp.asarray(kv / E4M3_SCALE, jnp.float8_e4m3fn)
    raw = np.asarray(jkv).view(np.uint8).copy()
    return jkv, torch.from_numpy(raw).view(torch.float8_e4m3fn), E4M3_SCALE


@pytest.mark.parametrize("split_keys", [16, 64, 512])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_split_decode_matches_jax_reference(case, split_keys):
    """Partials, then merge, against the JAX jnp reference (one query
    token a sequence) and the port's one-pass plain decode, 1e-5 of the
    largest output, over rows shorter than one split, rows that end on a
    split boundary, rows of many splits and a dead row (kv_len 0)."""
    qh, kvh, d, opts, page_type = CASES[case]
    rng = np.random.default_rng(7 + split_keys + len(case))
    lens = [split_keys, 2 * split_keys, max(1, split_keys - 5), 1, 0,
            3 * split_keys + 7, 150]
    seqs = [(1, max(n, 1)) for n in lens]
    q, kv, _, pages, _ = paged_batch(rng, seqs, qh, kvh, d,
                                     padded_seqs=len(seqs),
                                     padded_tokens=len(seqs))
    kv_lens = np.asarray(lens, np.int32)
    jkv, kvt, scale = _pages(kv, page_type)
    kw = dict(sm_scale=d**-0.5 * scale)
    jkw = dict(kw)
    for k in ("sliding_window", "soft_cap"):
        if k in opts:
            kw[k] = jkw[k] = opts[k]
    if opts.get("alibi"):
        slopes = get_alibi_slopes(qh)
        kw["alibi_slopes"] = torch.from_numpy(slopes)
        jkw["alibi_slopes"] = jnp.asarray(slopes)
    if "blocksparse" in opts:
        block, local, vert = opts["blocksparse"]
        offsets = (np.arange(qh) * max(1, vert // qh)).astype(np.int32)
        kw.update(blocksparse=opts["blocksparse"],
                  bs_head_offsets=torch.from_numpy(offsets))
        jkw.update(blocksparse=opts["blocksparse"],
                   bs_head_offsets=jnp.asarray(offsets))
    S = len(seqs)
    cu = np.arange(S + 1, dtype=np.int32)
    want = np.asarray(jax_ref(jnp.asarray(q), jkv, jnp.asarray(kv_lens),
                              jnp.asarray(pages), jnp.asarray(cu),
                              jnp.asarray([S], np.int32), **jkw))
    idx = (torch.from_numpy(kv_lens), torch.from_numpy(pages))
    n_splits = -(-pages.shape[1] * PS // split_keys)
    got = ref_split_decode_attention(torch.from_numpy(q), kvt, *idx,
                                     split_keys, n_splits, **kw).numpy()
    live = kv_lens > 0
    atol = 1e-5 * np.abs(want[live]).max()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=atol)
    assert not got[~live].any()  # dead row: zeros
    one_pass = ref_paged_decode_attention(torch.from_numpy(q), kvt, *idx,
                                          **kw).numpy()
    np.testing.assert_allclose(got, one_pass, rtol=0, atol=atol)


@pytest.mark.parametrize("window", [None, 1, 100, 513])
@pytest.mark.parametrize("split_keys", [64, 256, 1024])
def test_split_ranges_cover_each_key_once(split_keys, window):
    """Every key of [kv_lo, kv_len) lies in exactly one split's range, the
    ranges are page- and tile-aligned, and nothing outside is covered."""
    max_keys = 3000
    n = -(-max_keys // split_keys)
    for kv_len in (1, 63, 64, 65, split_keys, split_keys + 1, 2999, 3000):
        ranges = decode_split_ranges(kv_len, split_keys, n, window)
        kv_lo = max(0, kv_len - window) if window else 0
        hits = np.zeros(max_keys, np.int64)
        for i, (lo, hi) in enumerate(ranges):
            if lo < hi:
                assert lo == max(kv_lo, i * split_keys)
                hits[lo:hi] += 1
        assert (hits[kv_lo:kv_len] == 1).all()
        assert not hits[:kv_lo].any() and not hits[kv_len:].any()


@pytest.mark.parametrize("page_size", [8, 16, 32, 128])
@pytest.mark.parametrize("num_seqs,num_kv_heads,max_keys", [
    (16, 4, 4144),   # Qwen2.5-7B decode: 16 rows of up to 4128 keys
    (16, 4, 32768),  # the same rows in the engine's page table
    (32, 4, 4176),
    (32, 2, 4176),   # Qwen2.5-0.5B
    (32, 8, 1072),   # Llama-3.1-8B, prompts up to 1024
    (32, 40, 1072),  # Baichuan2-13B
    (1, 1, 16),
    (256, 8, 131072),
])
def test_decode_split_planner(num_seqs, num_kv_heads, max_keys, page_size):
    """The planner's splits are whole tiles and pages, cover the page
    table, at most one block slot per split, and its scratch has one
    partial per slot, row and query head, bounded by the grid whatever the
    page table's width; at Qwen2.5-7B's decode shape the grid holds at
    least 2 x 132 blocks on an H100 SXM (132 SMs)."""
    sms = 132
    max_keys = -(-max_keys // page_size) * page_size
    split, n, slots = plan_decode_splits(num_seqs, num_kv_heads, max_keys,
                                         page_size, sms)
    assert split % DECODE_TILE_KEYS == 0 and split % page_size == 0
    assert n * split >= max_keys > (n - 1) * split
    assert 1 <= slots <= n
    pairs = num_seqs * num_kv_heads
    acc, ml = decode_scratch(slots, num_seqs, 7 * num_kv_heads, 64, "cpu")
    if slots == 1:
        assert acc is None and ml is None
    else:
        assert acc.shape == (slots, num_seqs, 7 * num_kv_heads, 64)
        assert ml.shape == (slots, num_seqs, 7 * num_kv_heads, 2)
        assert acc.dtype == ml.dtype == torch.float32
        assert slots * pairs < 2 * DECODE_BLOCKS_PER_SM * sms
    wider = plan_decode_splits(num_seqs, num_kv_heads, 8 * max_keys,
                               page_size, sms)
    assert wider[2] >= slots
    if slots < n:  # the grid, not the page table, sets the slots
        assert wider[2] == slots
    if (num_seqs, num_kv_heads) == (16, 4):
        assert pairs * slots >= 2 * sms
    assert math.gcd(split, page_size) == page_size
