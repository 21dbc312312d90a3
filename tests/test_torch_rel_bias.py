"""T5's relative-position bias in the port's decode attention against the
JAX package, on the CPU.

The host side of the decode kernel's T5 bias: the bucket of each
distance (``t5_relative_bucket``, ``rel_bias_distances``) against the JAX
package's ``_rel_bucket`` at every distance from 0 to 4 x max_distance,
exactly, and the columns by distance the kernel reads. The plain decode
attention with ``rel_bias`` against the JAX decode kernel under the Pallas
interpreter (about 15 s a call, so two cases), and against the JAX
package's dense T5 attention (its jnp branch, written out here in numpy
on its ``_rel_bucket``) at QH/KV 1 and 2, head_dim 64 and 128, on bf16 and E4M3
pages; the split-KV plain pair (the kernel's two passes) against it; and
the kernels' rules for the option. The CUDA kernel is held against the
plain version by tests/test_torch_cuda.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.models.t5 import _rel_bucket
from aphrodite_tpu.ops.decode_attention import \
    paged_decode_attention as jax_decode
from aphrodite_tpu_torch.ops.decode_attention import (
    check_kernel_inputs, launch_shape, paged_decode_attention,
    plan_decode_splits, ref_paged_decode_attention,
    ref_split_decode_attention, rel_bias_columns, rel_bias_distances,
    t5_relative_bucket)
from tests.test_torch_cuda import paged_batch
from tests.test_torch_gemma import _OnCard
from tests.test_torch_qwen import _pages

# (num_buckets, max_distance): T5's and Flan-T5's, a small table, and a
# long reach.
METAS = [(32, 128), (8, 32), (32, 256)]


@pytest.mark.parametrize("meta", METAS, ids=lambda m: f"nb{m[0]}-md{m[1]}")
def test_bucket_of_each_distance_matches_jax(meta):
    """The causal bucket at every distance from 0 to 4 x max_distance
    through the kernel's table (the distance itself up to the saturation
    distance N, N beyond) and directly, and the bidirectional bucket (the
    encoder's) at every relative position in that reach: equal to the JAX
    package's _rel_bucket, exactly. N is the first distance of the last
    bucket (113 for T5's 32 buckets up to 128)."""
    nb, md = meta
    n = np.arange(4 * md + 1, dtype=np.int32)
    want = np.asarray(_rel_bucket(jnp.asarray(-n), False, nb, md))
    table = rel_bias_distances(nb, md)
    N = len(table) - 1
    assert table[N] == nb - 1 and (N == 0 or table[N - 1] < nb - 1)
    assert (want[N:] == nb - 1).all()
    np.testing.assert_array_equal(table[np.minimum(n, N)].numpy(), want)
    np.testing.assert_array_equal(
        t5_relative_bucket(torch.from_numpy(-n), False, nb, md).numpy(),
        want)
    rel = np.arange(-4 * md, 4 * md + 1, dtype=np.int32)
    np.testing.assert_array_equal(
        t5_relative_bucket(torch.from_numpy(rel), True, nb, md).numpy(),
        np.asarray(_rel_bucket(jnp.asarray(rel), True, nb, md)))
    if meta == (32, 128):
        assert N == 113


def test_columns_by_distance_gather_the_table():
    """Column n of rel_bias_columns is table[:, bucket(n)], bit for bit."""
    table = torch.randn(5, 32)
    cols = rel_bias_columns(table, (32, 128))
    assert cols.shape == (5, 114) and cols.is_contiguous()
    assert torch.equal(cols, table[:, rel_bias_distances(32, 128)])


def _dense_t5_decode(q, kv, kv_lens, pages, table, meta):
    """The JAX package's dense T5 attention (models/t5.py, its decoder's
    jnp branch) for one query token a row, in numpy f32: the row's keys'
    scores plus table[h, _rel_bucket(key - query position)] (the JAX
    package's buckets, computed once over every distance), softmax."""
    kv = np.asarray(jnp.asarray(kv).astype(jnp.float32))
    S, QH, D = q.shape
    KV = kv.shape[2] // 2
    reach = int(kv_lens.max())
    buckets = np.asarray(_rel_bucket(-jnp.arange(reach), False, *meta))
    out = np.zeros((S, QH, D), np.float32)
    for s in range(S):
        L = int(kv_lens[s])
        if L == 0:
            continue
        rows = kv[pages[s]].reshape(-1, 2 * KV, D)[:L]
        k = np.repeat(rows[:, 0::2], QH // KV, axis=1)
        v = np.repeat(rows[:, 1::2], QH // KV, axis=1)
        scores = np.einsum("hd,lhd->hl", q[s], k)
        scores = scores + table[:, buckets[L - 1 - np.arange(L)]]
        p = np.exp(scores - scores.max(-1, keepdims=True))
        out[s] = np.einsum("hl,lhd->hd", p / p.sum(-1, keepdims=True), v)
    return out


def _case(seed, qh, kvh, head_dim, page_type, max_kv=300):
    """8 rows (one dead) of q at std 3 and K/V at std 0.5 on pages of the
    type (E4M3 pages hold the values over the cache scale, which is not
    folded back: T5's attention is unscaled, and so are these, whose
    scores reach the hundreds), a bias table at std 2."""
    rng = np.random.default_rng(seed)
    seqs = [(1, int(n)) for n in rng.integers(1, max_kv, size=7)]
    seqs[0] = (1, max_kv)  # past the saturation distance
    q, kv, kv_lens, pages, _ = paged_batch(rng, seqs, qh, kvh, head_dim,
                                           padded_seqs=8, padded_tokens=8)
    table = (2 * rng.standard_normal((qh, 32))).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16)
    jkv, kv_t, _ = _pages(kv, page_type)
    q_t = torch.from_numpy(np.asarray(jq, np.float32)).to(torch.bfloat16)
    return dict(jq=jq, jkv=jkv, q=q_t, kv=kv_t,
                kv_lens=kv_lens, pages=pages, table=table,
                idx=(torch.from_numpy(kv_lens), torch.from_numpy(pages)))


def _plain(c, meta=(32, 128)):
    return ref_paged_decode_attention(
        c["q"], c["kv"], *c["idx"], sm_scale=1.0,
        rel_bias=torch.from_numpy(c["table"]),
        rel_bias_meta=meta).float().numpy()


@pytest.mark.parametrize("qh,head_dim,page_type", [
    (1, 64, "bf16"), (2, 128, "e4m3")], ids=["qg1-d64-bf16", "qg2-d128-e4m3"])
def test_ref_decode_rel_bias_matches_jax_kernel_interpret(qh, head_dim,
                                                          page_type):
    """The JAX decode kernel with its T5 table under the Pallas interpreter
    (one kv head, rows of up to 300 keys: past the saturation distance):
    the plain version within 1 % of the largest output (the TPU kernel
    rounds the probabilities to bf16 in P . V, the plain version keeps
    f32); the wrapper takes the plain version on the CPU."""
    c = _case(40 + qh, qh, 1, head_dim, page_type)
    want = np.asarray(jax_decode(
        c["jq"], c["jkv"], jnp.asarray(c["kv_lens"]),
        jnp.asarray(c["pages"]), jnp.asarray([7], jnp.int32),
        sm_scale=1.0, rel_bias=jnp.asarray(c["table"]),
        rel_bias_meta=(32, 128), interpret=True), np.float32)
    got = _plain(c)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    assert not got[7].any() and not want[7].any()  # dead row: zeros
    np.testing.assert_array_equal(paged_decode_attention(
        c["q"], c["kv"], *c["idx"], sm_scale=1.0,
        rel_bias=torch.from_numpy(c["table"]),
        rel_bias_meta=(32, 128)).float().numpy(), got)


@pytest.mark.parametrize("page_type", ["bf16", "e4m3"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("qg", [1, 2])
def test_ref_decode_rel_bias_matches_jax_dense(qg, head_dim, page_type):
    """The plain version against the JAX package's dense T5 attention on
    the same pages, 2 kv heads: f32 sums in another order only (the output
    is rounded to bf16 on both sides here), so one bf16 ulp of the largest
    output. And the plain split-KV pair at the kernel's split plan and at
    64-key splits (which cut rows across the saturation distance) against
    the plain version: 1e-5."""
    c = _case(10 * head_dim + qg, 2 * qg, 2, head_dim, page_type)
    want = _dense_t5_decode(np.asarray(c["jq"], np.float32), c["jkv"],
                          c["kv_lens"], c["pages"], c["table"], (32, 128))
    want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
    got = _plain(c)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2**-7 * np.abs(want).max())
    kw = dict(sm_scale=1.0, rel_bias=torch.from_numpy(c["table"]),
              rel_bias_meta=(32, 128))
    split, n, _ = plan_decode_splits(8, 2, c["pages"].shape[1] * 16, 16, 132)
    for keys, splits in ((split, n), (64, -(-c["pages"].shape[1] * 16 // 64))):
        np.testing.assert_allclose(
            ref_split_decode_attention(c["q"], c["kv"], *c["idx"], keys,
                                       splits, **kw).float().numpy(), got,
            rtol=0, atol=1e-5 * np.abs(got).max())


def test_kernel_rules_for_the_t5_bias():
    """check_kernel_inputs (the wrapper's rules on a card) takes an f32
    [QH, NB] table at every head_dim and QH/KV the kernel takes, and
    refuses it beside ALiBi or blocksparse, off q's device, in another
    type or shape; the launch key names it."""
    for head_dim in (64, 96, 128, 256):
        for qh in (2, 4, 32, 142):
            q = _OnCard((4, qh, head_dim), torch.bfloat16)
            pages = _OnCard((3, 16, 4, head_dim), torch.float8_e5m2)
            check_kernel_inputs(q, pages, (),
                                rel_bias=_OnCard((qh, 32), torch.float32))
    q = _OnCard((4, 8, 128), torch.bfloat16)
    pages = _OnCard((3, 16, 4, 128), torch.bfloat16)
    table = _OnCard((8, 32), torch.float32)
    with pytest.raises(ValueError, match="without ALiBi"):
        check_kernel_inputs(q, pages, (), rel_bias=table,
                            alibi_slopes=_OnCard((8,), torch.float32))
    with pytest.raises(ValueError, match="without blocksparse"):
        check_kernel_inputs(q, pages, (), rel_bias=table,
                            bs_head_offsets=_OnCard((8,), torch.int32))
    for bad in (torch.zeros(8, 32), _OnCard((8, 32), torch.bfloat16),
                _OnCard((4, 32), torch.float32)):
        with pytest.raises(ValueError, match="T5 bias as an f32"):
            check_kernel_inputs(q, pages, (), rel_bias=bad)
    assert launch_shape(8, 8, 64, None, rel_bias=True) == "qg1 d64 rel_bias"
    with pytest.raises(ValueError, match="go together"):
        paged_decode_attention(torch.zeros(1, 1, 64), torch.zeros(1, 16, 2, 64),
                               torch.ones(1, dtype=torch.int32),
                               torch.zeros(1, 1, dtype=torch.int32),
                               rel_bias=torch.zeros(1, 32))
