"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Without one every test here skips: a CUDA kernel has no CPU or
interpret mode. This file imports neither JAX nor the JAX package, so on
the card it runs without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.models.layers import get_alibi_slopes
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    paged_decode_attention, ref_paged_decode_attention)
from aphrodite_tpu_torch.ops.kv_cache import quantize_kv, write_kv
from aphrodite_tpu_torch.ops.quant_matmul import (dequantize_int4,
                                                  fp8_w8a8_matmul,
                                                  fp8_w8a8_matmul_ref,
                                                  int4_matmul,
                                                  int4_matmul_ref,
                                                  int4p_matmul,
                                                  int4p_matmul_ref,
                                                  int4p_matmul_w4a8,
                                                  int4p_matmul_w4a8_ref,
                                                  int8_matmul,
                                                  int8_matmul_ref,
                                                  pack_int4_rows,
                                                  quantize_activations,
                                                  quantize_activations_e4m3,
                                                  quantize_activations_int8,
                                                  unpack_int4_rows)
from aphrodite_tpu_torch.quantization import fp8, int4, int8
from aphrodite_tpu_torch.sampling.metadata import (SamplerInputRow,
                                                   build_sampling_tensors)
from aphrodite_tpu_torch.sampling.sampler import sample, tensors_to_device

PS = 16  # page size
# Row by row (the D values of one token and query head): |kernel - plain|
# <= ROW_TOL * max|plain row|. Both sides accumulate in f32 from the same
# bf16 inputs and round to bf16 (ulp <= 2^-7 of the value); this allows
# two ulps of the row's largest element. q at std 3 against K at std 0.5
# makes each softmax peaked, so a missed rescale or a dropped key tile
# shows.
ROW_TOL = 2.0**-6


def paged_batch(rng, seqs, num_q_heads, num_kv_heads, head_dim, *,
                padded_seqs, padded_tokens, dtype=np.float32):
    """Random q, a random cache and page tables for (q_len, kv_len) per
    live sequence; padded sequences have kv_len 0 and q_len 0."""
    pps = max(-(-kv // PS) for _, kv in seqs) + 1
    num_pages = sum(-(-kv // PS) for _, kv in seqs) + 3
    perm = rng.permutation(num_pages)
    pages = np.zeros((padded_seqs, pps), np.int32)
    kv_lens = np.zeros((padded_seqs,), np.int32)
    cu = np.zeros((padded_seqs + 1,), np.int32)
    j = 0
    for i, (q_len, kv_len) in enumerate(seqs):
        npg = -(-kv_len // PS)
        pages[i, :npg] = perm[j:j + npg]
        j += npg
        kv_lens[i] = kv_len
        cu[i + 1] = cu[i] + q_len
    cu[len(seqs) + 1:] = cu[len(seqs)]
    q = (rng.standard_normal((padded_tokens, num_q_heads, head_dim))
         * 3.0).astype(dtype)
    kv = (rng.standard_normal((num_pages, PS, 2 * num_kv_heads, head_dim))
          * 0.5).astype(dtype)
    return q, kv, kv_lens, pages, cu


# ----------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions.
# ----------------------------------------------------------------------


def assert_rows_close(got, want):
    got, want = got.float(), want.float()
    assert got.isfinite().all()
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    assert (err <= ROW_TOL * scale).all(), float((err / scale).max())


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "or interpret mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"sliding_window": 40, "soft_cap": 20.0}])
def test_ragged_kernel_matches_plain_on_card(kw):
    _card_or_skip()
    rng = np.random.default_rng(4)
    seqs = [(1, 90), (70, 70), (33, 150), (1, 17), (1, 1300), (40, 1040)]
    tokens = sum(q for q, _ in seqs)
    arrays = paged_batch(rng, seqs, 32, 8, 128, padded_seqs=8,
                    padded_tokens=tokens + 5)
    q, kv = (torch.from_numpy(a).cuda().to(torch.bfloat16)
             for a in arrays[:2])
    idx = [torch.from_numpy(a).cuda() for a in arrays[2:]]
    ns = torch.tensor([len(seqs)], dtype=torch.int32, device="cuda")
    got = ragged_paged_attention(q, kv, *idx, ns, sm_scale=0.09, **kw)
    want = ref_ragged_paged_attention(q, kv, *idx, ns, sm_scale=0.09, **kw)
    torch.cuda.synchronize()
    assert_rows_close(got[:tokens], want[:tokens])
    assert not got[tokens:].float().any()  # padding tokens: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"sliding_window": 40, "soft_cap": 20.0}])
def test_decode_kernel_matches_plain_on_card(kw):
    _card_or_skip()
    rng = np.random.default_rng(5)
    lens = rng.integers(1, 400, size=12)
    lens[:2] = (1200, 1030)
    seqs = [(1, int(n)) for n in lens]
    arrays = paged_batch(rng, seqs, 32, 8, 128, padded_seqs=16,
                    padded_tokens=16)
    q, kv = (torch.from_numpy(a).cuda().to(torch.bfloat16)
             for a in arrays[:2])
    kv_lens, pages = (torch.from_numpy(a).cuda() for a in arrays[2:4])
    got = paged_decode_attention(q, kv, kv_lens, pages, sm_scale=0.09, **kw)
    want = ref_paged_decode_attention(q, kv, kv_lens, pages, sm_scale=0.09,
                                      **kw)
    torch.cuda.synchronize()
    assert_rows_close(got[:12], want[:12])
    assert not got[12:].float().any()  # dead rows: zeros


NARROW = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
          "int8": torch.int8}


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ragged", "decode"])
@pytest.mark.parametrize("name", sorted(NARROW))
def test_narrow_page_kernels_match_plain_and_bf16_kernel_on_card(name, op):
    """Each variant that reads 8-bit pages against its plain version on
    the same pages (row by row, ROW_TOL) and against the bf16 kernel on
    those pages widened to bf16 beforehand: the variants widen while they
    stage and share everything after, so the bits are equal."""
    _card_or_skip()
    rng = np.random.default_rng(7)
    if op == "ragged":
        seqs = [(1, 90), (70, 70), (33, 150), (1, 17), (1, 1300), (40, 1040)]
        rows = sum(q for q, _ in seqs)
        padded_seqs, padded_tokens = 8, rows + 5
    else:
        lens = rng.integers(1, 400, size=12)
        lens[:2] = (1200, 1030)
        seqs = [(1, int(n)) for n in lens]
        rows, padded_seqs, padded_tokens = 12, 16, 16
    arrays = paged_batch(rng, seqs, 32, 8, 128, padded_seqs=padded_seqs,
                         padded_tokens=padded_tokens)
    q = torch.from_numpy(arrays[0]).cuda().to(torch.bfloat16)
    # K/V at std 0.5 stored as value / 0.02: int8 uses its whole range
    # (and clips a few values), the fp8 types their mantissas.
    scale = torch.tensor(0.02, device="cuda")
    pages = quantize_kv(torch.from_numpy(arrays[1]).cuda(), scale,
                        NARROW[name])
    widened = pages.to(torch.bfloat16)
    assert torch.equal(widened.float(), pages.float())  # exact in bf16
    kv_lens, page_idx, cu = (torch.from_numpy(a).cuda() for a in arrays[2:])
    ns = torch.tensor([len(seqs)], dtype=torch.int32, device="cuda")
    kw = dict(sm_scale=0.09 * 0.02, sliding_window=900)
    if op == "ragged":
        fn, ref = ragged_paged_attention, ref_ragged_paged_attention
        args = (kv_lens, page_idx, cu, ns)
    else:
        fn, ref = paged_decode_attention, ref_paged_decode_attention
        args = (kv_lens, page_idx)
    before = (fn.launches, fn.launches_by_dtype.get(name, 0))
    got = fn(q, pages, *args, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_by_dtype[name]) == (before[0] + 1,
                                                         before[1] + 1)
    assert_rows_close(got[:rows], ref(q, pages, *args, **kw)[:rows])
    assert torch.equal(got, fn(q, widened, *args, **kw))
    assert not got[rows:].float().any()  # padding tokens, dead rows: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf16", *sorted(NARROW)])
@pytest.mark.parametrize("alibi", [False, True], ids=["no_alibi", "alibi"])
@pytest.mark.parametrize("qg", [1, 2, 4, 8])
@pytest.mark.parametrize("op", ["ragged", "decode"])
def test_attention_kernels_every_qg_and_alibi_on_card(op, qg, alibi, name):
    """Each kernel at 1, 2, 4 and 8 query heads per kv head (4 kv heads),
    with and without the model's slope table, on each page type, against
    its plain version row by row (ROW_TOL), over rows of 1000+ keys where
    the distance bias of the steep heads reaches -1000. The narrow variants
    equal the bf16 kernel on the widened pages, all-zero slopes equal no
    ALiBi (bit for bit), and each launch is counted under its shape."""
    _card_or_skip()
    rng = np.random.default_rng(40 + qg)
    kvh = 4
    if op == "ragged":
        seqs = [(1, 90), (70, 70), (33, 150), (1, 17), (1, 1300), (40, 1040)]
        rows = sum(q for q, _ in seqs)
        padded_seqs, padded_tokens = 8, rows + 5
        fn, ref = ragged_paged_attention, ref_ragged_paged_attention
    else:
        lens = rng.integers(1, 400, size=12)
        lens[:2] = (1200, 1030)
        seqs = [(1, int(n)) for n in lens]
        rows, padded_seqs, padded_tokens = 12, 16, 16
        fn, ref = paged_decode_attention, ref_paged_decode_attention
    arrays = paged_batch(rng, seqs, qg * kvh, kvh, 128,
                         padded_seqs=padded_seqs, padded_tokens=padded_tokens)
    q = torch.from_numpy(arrays[0]).cuda().to(torch.bfloat16)
    values = torch.from_numpy(arrays[1]).cuda()
    kw = dict(sm_scale=0.09, soft_cap=30.0)
    if name == "bf16":
        pages = values.to(torch.bfloat16)
    else:
        pages = quantize_kv(values, torch.tensor(0.02, device="cuda"),
                            NARROW[name])
        kw["sm_scale"] *= 0.02
    kv_lens, page_idx, cu = (torch.from_numpy(a).cuda() for a in arrays[2:])
    ns = torch.tensor([len(seqs)], dtype=torch.int32, device="cuda")
    args = (kv_lens, page_idx, cu, ns) if op == "ragged" else (kv_lens,
                                                                page_idx)
    if alibi:
        kw["alibi_slopes"] = torch.from_numpy(
            get_alibi_slopes(qg * kvh)).cuda()
    shape = f"qg{qg} d128" + (" alibi" if alibi else "")
    before = fn.launches_by_shape.get(shape, 0)
    got = fn(q, pages, *args, **kw)
    torch.cuda.synchronize()
    assert fn.launches_by_shape[shape] == before + 1
    assert_rows_close(got[:rows], ref(q, pages, *args, **kw)[:rows])
    assert not got[rows:].float().any()  # padding tokens, dead rows: zeros
    if name != "bf16":
        assert torch.equal(got, fn(q, pages.to(torch.bfloat16), *args, **kw))
    if alibi:
        zero = dict(kw, alibi_slopes=torch.zeros_like(kw["alibi_slopes"]))
        off = {k: v for k, v in kw.items() if k != "alibi_slopes"}
        assert torch.equal(fn(q, pages, *args, **zero),
                           fn(q, pages, *args, **off))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf16", *sorted(NARROW)])
@pytest.mark.parametrize("head_dim", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("qg", [1, 3, 5, 6, 7, 8, 12, 16])
@pytest.mark.parametrize("op", ["ragged", "decode"])
def test_attention_kernels_head_dim_and_every_qg_on_card(op, qg, head_dim,
                                                        name):
    """Each kernel at head_dim 64, 80 (Phi-2, whose narrow tiles take a
    copy round of half the threads in the 256-thread forms), 96
    (Phi-3-mini), 128 and 256 (Gemma)
    and QH/KV from 1 to 16 (2 kv heads), among them Qwen2.5's 5, 6 and 7
    and Llama-3.2-3B's 3, which the decode kernel serves as rows of one
    mma tile and the ragged one from its runtime-QG instantiation (tiles
    that end inside a token's heads), on each page type, with a window and a soft cap, against
    its plain version row by row (ROW_TOL); the narrow variants equal the
    bf16 kernel on the widened pages, and each launch is counted under its
    shape."""
    _card_or_skip()
    rng = np.random.default_rng(400 + 10 * qg + head_dim)
    kvh = 2
    if op == "ragged":
        seqs = [(1, 90), (70, 70), (33, 150), (1, 17), (1, 1300), (40, 1040)]
        rows = sum(q for q, _ in seqs)
        padded_seqs, padded_tokens = 8, rows + 5
        fn, ref = ragged_paged_attention, ref_ragged_paged_attention
    else:
        lens = rng.integers(1, 400, size=12)
        lens[:2] = (1200, 1030)
        seqs = [(1, int(n)) for n in lens]
        rows, padded_seqs, padded_tokens = 12, 16, 16
        fn, ref = paged_decode_attention, ref_paged_decode_attention
    arrays = paged_batch(rng, seqs, qg * kvh, kvh, head_dim,
                         padded_seqs=padded_seqs, padded_tokens=padded_tokens)
    q = torch.from_numpy(arrays[0]).cuda().to(torch.bfloat16)
    values = torch.from_numpy(arrays[1]).cuda()
    kw = dict(sm_scale=head_dim**-0.5, sliding_window=700, soft_cap=30.0)
    if name == "bf16":
        pages = values.to(torch.bfloat16)
    else:
        pages = quantize_kv(values, torch.tensor(0.02, device="cuda"),
                            NARROW[name])
        kw["sm_scale"] *= 0.02
    kv_lens, page_idx, cu = (torch.from_numpy(a).cuda() for a in arrays[2:])
    ns = torch.tensor([len(seqs)], dtype=torch.int32, device="cuda")
    args = (kv_lens, page_idx, cu, ns) if op == "ragged" else (kv_lens,
                                                                page_idx)
    shape = f"qg{qg} d{head_dim}"
    before = fn.launches_by_shape.get(shape, 0)
    got = fn(q, pages, *args, **kw)
    torch.cuda.synchronize()
    assert fn.launches_by_shape[shape] == before + 1
    assert_rows_close(got[:rows], ref(q, pages, *args, **kw)[:rows])
    assert not got[rows:].float().any()  # padding tokens, dead rows: zeros
    if name != "bf16":
        assert torch.equal(got, fn(q, pages.to(torch.bfloat16), *args, **kw))


def _attention_case(op, rng, qg, kvh, head_dim, name, **kw):
    """A ragged batch (a decode row among prefill chunks, rows of 1000+
    keys) or a decode batch (12 live rows of up to 1200 keys among 16), on
    pages of `name` (narrow pages hold value / 0.02, folded into
    sm_scale): (fn, ref, q, pages, args, kw, rows)."""
    if op == "ragged":
        seqs = [(1, 90), (70, 70), (33, 150), (1, 17), (1, 1300), (40, 1040)]
        rows = sum(q for q, _ in seqs)
        padded_seqs, padded_tokens = 8, rows + 5
        fn, ref = ragged_paged_attention, ref_ragged_paged_attention
    else:
        lens = rng.integers(1, 400, size=12)
        lens[:2] = (1200, 1030)
        seqs = [(1, int(n)) for n in lens]
        rows, padded_seqs, padded_tokens = 12, 16, 16
        fn, ref = paged_decode_attention, ref_paged_decode_attention
    arrays = paged_batch(rng, seqs, qg * kvh, kvh, head_dim,
                         padded_seqs=padded_seqs, padded_tokens=padded_tokens)
    q = torch.from_numpy(arrays[0]).cuda().to(torch.bfloat16)
    values = torch.from_numpy(arrays[1]).cuda()
    kw = dict(kw, sm_scale=head_dim**-0.5)
    if name == "bf16":
        pages = values.to(torch.bfloat16)
    else:
        pages = quantize_kv(values, torch.tensor(0.02, device="cuda"),
                            NARROW[name])
        kw["sm_scale"] *= 0.02
    kv_lens, page_idx, cu = (torch.from_numpy(a).cuda() for a in arrays[2:])
    ns = torch.tensor([len(seqs)], dtype=torch.int32, device="cuda")
    args = (kv_lens, page_idx, cu, ns) if op == "ragged" else (kv_lens,
                                                                page_idx)
    return fn, ref, q, pages, args, kw, rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf16", *sorted(NARROW)])
@pytest.mark.parametrize("head_dim", [64, 80, 128])
@pytest.mark.parametrize("qg,kvh", [(17, 2), (71, 1), (71, 2), (130, 1)],
                         ids=["qg17", "qg71_kv1", "qg71_kv2", "qg130"])
@pytest.mark.parametrize("op", ["ragged", "decode"])
def test_attention_kernels_many_queries_per_kv_on_card(op, qg, kvh, head_dim,
                                                       name):
    """Each kernel above 16 query heads per kv head: Falcon-7B's 71 on one
    and on two kv heads, 17 (two head tiles), and 130 (the decode kernel's
    two head groups of 128), where the decode kernel runs its wide form
    (eight warps, one head tile each) and the ragged one tiles the
    flattened (token, head) rows, a tile ending inside a token's heads; on
    each page type, with a window and a soft cap, against its plain
    version row by row (ROW_TOL); the narrow variants equal the bf16
    kernel on the widened pages, and each launch is counted under its
    shape."""
    _card_or_skip()
    rng = np.random.default_rng(700 + qg + head_dim + kvh)
    fn, ref, q, pages, args, kw, rows = _attention_case(
        op, rng, qg, kvh, head_dim, name, sliding_window=700, soft_cap=30.0)
    shape = f"qg{qg} d{head_dim}"
    before = fn.launches_by_shape.get(shape, 0)
    got = fn(q, pages, *args, **kw)
    torch.cuda.synchronize()
    assert fn.launches_by_shape[shape] == before + 1
    assert_rows_close(got[:rows], ref(q, pages, *args, **kw)[:rows])
    assert not got[rows:].float().any()  # padding tokens, dead rows: zeros
    if name != "bf16":
        assert torch.equal(got, fn(q, pages.to(torch.bfloat16), *args, **kw))
    if op == "decode":
        plan = paged_decode_attention.last_plan
        groups = -(-qg // 128)
        assert plan["blocks"] == 16 * kvh * groups * plan["slots"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf16", *sorted(NARROW)])
@pytest.mark.parametrize("head_dim", [64, 80, 96, 256])
@pytest.mark.parametrize("qg", [1, 2, 71])
@pytest.mark.parametrize("op", ["ragged", "decode"])
def test_attention_kernels_alibi_every_head_dim_on_card(op, qg, head_dim,
                                                        name):
    """ALiBi off head_dim 128 (Bloom's and Falcon-RW's 64, and 80, 96 and
    256)
    at 1, 2 and 71 query heads per kv head (2 kv heads), with the model's
    slope table and a soft cap, on each page type, against the plain
    version row by row (ROW_TOL), over rows of 1000+ keys where the bias
    of the steep heads reaches -1000; all-zero slopes equal no ALiBi bit
    for bit, the narrow variants equal the bf16 kernel on the widened
    pages, and each launch is counted under its shape."""
    _card_or_skip()
    rng = np.random.default_rng(800 + qg + head_dim)
    kvh = 2
    fn, ref, q, pages, args, kw, rows = _attention_case(
        op, rng, qg, kvh, head_dim, name, soft_cap=30.0,
        alibi_slopes=torch.from_numpy(get_alibi_slopes(qg * kvh)).cuda())
    shape = f"qg{qg} d{head_dim} alibi"
    before = fn.launches_by_shape.get(shape, 0)
    got = fn(q, pages, *args, **kw)
    torch.cuda.synchronize()
    assert fn.launches_by_shape[shape] == before + 1
    assert_rows_close(got[:rows], ref(q, pages, *args, **kw)[:rows])
    assert not got[rows:].float().any()
    if name != "bf16":
        assert torch.equal(got, fn(q, pages.to(torch.bfloat16), *args, **kw))
    zero = dict(kw, alibi_slopes=torch.zeros_like(kw["alibi_slopes"]))
    off = {k: v for k, v in kw.items() if k != "alibi_slopes"}
    assert torch.equal(fn(q, pages, *args, **zero), fn(q, pages, *args, **off))



# SHA-256 of the ALiBi outputs of the fixed-QG instantiations (head_dim
# 128, QG 1, 2, 4 and 8) on kernel_ab's seeded calls, as the build before
# the ragged kernel's rows were flattened gave them (kernel_ab run on an
# NVIDIA H100 80GB HBM3; the same call's two runs, before and after,
# agreed on all 866 outputs): (op, page type, QG) -> digest.
ALIBI_D128_DIGESTS = {
    ("decode", "bf16", 1): "9cb81455452ebdf97f180e71613fc06d20e51c17b5ee7183cabec2d532f64af1",
    ("decode", "bf16", 2): "62ea0404f8bf171c5ff12fb7cee230c103206c99574e8860a5a9404fd78f5516",
    ("decode", "bf16", 4): "163dc27bfc9f82d65c8d9242e151320f885a79578032a9dd567ba8bc6d054fdc",
    ("decode", "bf16", 8): "440860646b5e8cf2499e8159d6933965253a81427ecaccc9d0dda26b9a71c892",
    ("decode", "e4m3", 1): "69a51fc907d3c74dd5b84ae341f02bf646b510f4e7b0417aad7841e462183dce",
    ("decode", "e4m3", 2): "1832bec9999fd4ab628dc890ec527a20800eb9f7d4cd75326be763639b72e960",
    ("decode", "e4m3", 4): "330f1a69f895b4c8b8e2a37e5a50db140dc72fceb5a7368ca7fc356995d7c8d8",
    ("decode", "e4m3", 8): "c933e9a5545d577c3c017db4a4fa7d92b71eec1c9fa62eef1bf22e90269bcacc",
    ("decode", "e5m2", 1): "1da65419b0266e57b69d7a666bafcb76ee0462ec7cb40b83f8931263121ab2b6",
    ("decode", "e5m2", 2): "c0eb2c2c56af03599819ea96dc90f2d22ed78a56584b84bf0811399ca3ee8ae8",
    ("decode", "e5m2", 4): "50ac3487fd99e2899d41b5ddaa034992e953845a9ee153f92b2ccf7ff894895f",
    ("decode", "e5m2", 8): "3f9120031d3148f8e964ba5bb6b51c603c58cfadcc2e89ae4421fb88ff49d70f",
    ("decode", "int8", 1): "48316b9c45c94deb7b00573f97df82e2fe0355017472a8cc5a081784ff166d74",
    ("decode", "int8", 2): "66e927f0d9a3830c627d4164ddf2b83c85d675e8ed8a6f896e74373fd3c8ee76",
    ("decode", "int8", 4): "329883d118614dadbdd9b214a23bfb403e7d830e0cbbe98a7efd80629273d980",
    ("decode", "int8", 8): "019fc5abf709155f3d357a8694a24ce0f4839e67c81da6e4018005e20737095e",
    ("ragged", "bf16", 1): "da04b820a97a6771f2e0ba4b1d21c0dcc52075536748a2ef423bfd604b7ec383",
    ("ragged", "bf16", 2): "4b8bb667058d67ba4d9c9ed8975697ae53eb51d7e25eb3fe2daad6b72a1b622c",
    ("ragged", "bf16", 4): "1959403a16cd3b0c2d54331bf0d0e18eabd3698c6f21d98f4f12003f23148593",
    ("ragged", "bf16", 8): "d0f293b7dc5d1a52a8a5bf804523c0b9b0fd9065f7dac7b8e99683776a0fbe39",
    ("ragged", "e4m3", 1): "8a2af794b02d807b8b1fff116d9f434c3e20bd24e6ebbee85b1599a0acdaab85",
    ("ragged", "e4m3", 2): "8bd1201b142246b5ad7536003a0ef5c4a0bc6a95ef497e0de86e32f74ebde1be",
    ("ragged", "e4m3", 4): "885cec8adc705226812d57b871b99d5d1ac4dd86f5860c7b2a95f5eb23d2c24c",
    ("ragged", "e4m3", 8): "be0ca51a1d49f824c8659783d8f45d53013388f534ede9e8be656885db58a2d1",
    ("ragged", "e5m2", 1): "41919adf1798f6650238359448f1cbb3e333e225249ea7b70f4091f0557ce5aa",
    ("ragged", "e5m2", 2): "aeadc9c71ec3b0bfa6ef5de144c39c37fa0fdae1d4a5801cdc1885b7bce3ed33",
    ("ragged", "e5m2", 4): "1dd0aab4ab7130db3edbf1de781ba2e314cade643d82ebee596ded7b889ac993",
    ("ragged", "e5m2", 8): "b88cf3d760bb2abad5898a5c6a01e6055b541a8edb770d7d7d8cc47eb0c59f88",
    ("ragged", "int8", 1): "c7e8343f380b20f2db04f09ab86cd5066f9cb948754405f0b835b17052dba2b5",
    ("ragged", "int8", 2): "6a795aa6c1f8222f71c5f0dfefd3e37a3de2f79e84a6a51d49347742be5b3d56",
    ("ragged", "int8", 4): "7890bf0b80da043e0d8406fd05ac49f5733a6119e83d1ae6bcd6a0fa160baf44",
    ("ragged", "int8", 8): "3c36f4b42b56d9fb5911d2b098a32c588cbb3d749512f3b74ed955e6e51a1a97",
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf16", *sorted(NARROW)])
@pytest.mark.parametrize("qg", [1, 2, 4, 8])
@pytest.mark.parametrize("op", ["ragged", "decode"])
def test_alibi_d128_fixed_qg_outputs_unchanged_on_card(op, qg, name):
    """The ALiBi variants Baichuan and bench.py's 1.4B geometry run (head_dim
    128, QG 1, 2, 4, 8, every page type) give, bit for bit, the outputs the
    build before this slice gave on the same seeded calls."""
    _card_or_skip()
    from aphrodite_tpu_torch.tools.kernel_ab import attention_call, digest

    got, _ = attention_call(op, name, qg, 128, "alibi")
    torch.cuda.synchronize()
    assert digest(got) == ALIBI_D128_DIGESTS[(op, name, qg)]

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf16", *sorted(NARROW)])
@pytest.mark.parametrize("head_dim", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("qg", [1, 2, 71])
def test_decode_kernel_t5_bias_on_card(qg, head_dim, name):
    """The decode kernel with T5's bias table (32 buckets up to distance
    128, at std 3) at 1, 2 and 71 query heads per kv head (2 kv heads: the
    wide form at 71) and every head_dim, on each page type, unscaled as T5
    attends (sm_scale 1: scores reach the hundreds), against the plain
    version row by row (ROW_TOL) over rows of up to 1200 keys (far past the
    saturation distance, 113); an all-zero table equals no bias and the
    narrow variants equal the bf16 kernel on the widened pages, bit for
    bit; each launch is counted under its shape."""
    _card_or_skip()
    rng = np.random.default_rng(900 + qg + head_dim)
    kvh = 2
    fn, ref, q, pages, args, kw, rows = _attention_case(
        "decode", rng, qg, kvh, head_dim, name)
    table = torch.from_numpy(
        3 * rng.standard_normal((qg * kvh, 32)).astype(np.float32)).cuda()
    kw = dict(kw, sm_scale=kw["sm_scale"] * head_dim**0.5, rel_bias=table,
              rel_bias_meta=(32, 128))
    shape = f"qg{qg} d{head_dim} rel_bias"
    before = fn.launches_by_shape.get(shape, 0)
    got = fn(q, pages, *args, **kw)
    torch.cuda.synchronize()
    assert fn.launches_by_shape[shape] == before + 1
    assert_rows_close(got[:rows], ref(q, pages, *args, **kw)[:rows])
    assert not got[rows:].float().any()
    if name != "bf16":
        assert torch.equal(got, fn(q, pages.to(torch.bfloat16), *args, **kw))
    zero = dict(kw, rel_bias=torch.zeros_like(table))
    off = {k: v for k, v in kw.items() if not k.startswith("rel_bias")}
    assert torch.equal(fn(q, pages, *args, **zero), fn(q, pages, *args, **off))


@pytest.mark.cuda
def test_decode_kernel_refuses_t5_bias_beside_alibi_or_blocksparse():
    """A T5 table with ALiBi slopes or with blocksparse raises before any
    launch, as the ALiBi-and-blocksparse pair does."""
    _card_or_skip()
    rng = np.random.default_rng(950)
    fn, _, q, pages, args, kw, _ = _attention_case("decode", rng, 4, 2, 128,
                                                   "bf16")
    kw = dict(kw, rel_bias=torch.zeros((8, 32), device="cuda"),
              rel_bias_meta=(32, 128))
    before = fn.launches
    with pytest.raises(ValueError, match="without ALiBi"):
        fn(q, pages, *args, alibi_slopes=torch.zeros(8, device="cuda"), **kw)
    with pytest.raises(ValueError, match="without blocksparse"):
        fn(q, pages, *args, blocksparse=(64, 4, 8),
           bs_head_offsets=torch.zeros(8, dtype=torch.int32, device="cuda"),
           **kw)
    assert fn.launches == before


# SHA-256 of the decode kernel's outputs without the T5 bias on kernel_ab's
# seeded calls (head_dim 64 at QG 1, T5's and BART's shape, and at QG 2;
# head_dim 128 at QG 4), as the build before the bias came gave them
# (kernel_ab's attention_call on an NVIDIA H100 80GB HBM3; the same call's
# kernel_ab runs, before and after, agreed on all 866 outputs):
# (page type, QG, head_dim) -> digest.
DECODE_NO_BIAS_DIGESTS = {
    ("bf16", 1, 64): "897f11c535fa48442e8818d3a939d4acc45539c33bf5bed9c5bec5db45edbdb8",
    ("bf16", 2, 64): "64a49cec449093319e00e9025c34184eab67b5fead2784d0a10a9191902e3af5",
    ("bf16", 4, 128): "0b999889eadee2e382f8086fd59f8e51b9df994a8a7918ab1159668ed6115a3a",
    ("e4m3", 1, 64): "ea5d8c8cdc88cf995782d23a70a65e8634585f201e154a4cbee9ff6e0e9dd586",
    ("e4m3", 2, 64): "bd53f818d806ecc8364b8509a66fa7e517090a644c48180267f2ebd8aacc03a3",
    ("e4m3", 4, 128): "094328a5447618d38b45ed6d30c80cd4c84d1bf84e52fdc666148a42f055ecdd",
    ("e5m2", 1, 64): "3e95d982418621ea6d0518820258587621b640a5b3f5c1bd3bf6cee1b62c3858",
    ("e5m2", 2, 64): "01f47ca0cb03f3c68faca615d3fcb013964aa5fb92fabd99550de6e2174b5bf0",
    ("e5m2", 4, 128): "bdbb18c0496b6bb0f999d7d3f664f33d38e2a4ab7085ea4d9264926c5b738301",
    ("int8", 1, 64): "119d0afef024ff4657e3d8e271c3cba816cf61dec32bea498c2a22425b193aa4",
    ("int8", 2, 64): "b1d548f43b48ffe43ac7de85dd2015b69fcc0de8f8ef3d12adb7c82407a70f2c",
    ("int8", 4, 128): "1fe8e6b98fe839b7a99af4ec81c184140175346a013acd594a36252f72e2140e",
}


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(DECODE_NO_BIAS_DIGESTS),
                         ids=lambda k: "-".join(map(str, k)))
def test_decode_outputs_without_t5_bias_unchanged_on_card(key):
    """The decode kernel's launches without the T5 bias give, bit for bit,
    the outputs the build before the bias gave on the same seeded
    calls."""
    _card_or_skip()
    from aphrodite_tpu_torch.tools.kernel_ab import attention_call, digest

    name, qg, head_dim = key
    got, _ = attention_call("decode", name, qg, head_dim, "plain")
    torch.cuda.synchronize()
    assert digest(got) == DECODE_NO_BIAS_DIGESTS[key]


# Phi-3-Small's blocksparse parameters (block 64, 16 local blocks, stride
# 8) cut to 4 local blocks so that rows of 1000+ keys reach far past the
# window, and a block under a page (the kernels then mask only).
BLOCKSPARSE = {"block64": (64, 4, 8), "block8": (8, 3, 5)}


@pytest.mark.cuda
@pytest.mark.parametrize("block", sorted(BLOCKSPARSE))
@pytest.mark.parametrize("name", ["bf16", *sorted(NARROW)])
@pytest.mark.parametrize("qg", [1, 2, 4, 8])
@pytest.mark.parametrize("op", ["ragged", "decode"])
def test_attention_kernels_blocksparse_on_card(op, qg, name, block):
    """Each kernel with blocksparse at 1, 2, 4 and 8 query heads per kv
    head (4 kv heads, Phi-3-Small's hetero phases: arange(QH) * max(1,
    vert // QH)), on each page type, against its plain version row by row
    (ROW_TOL), over rows of 1000+ keys, far past the local window; at QG 1
    and 2 the first 128 keys (two 64-key tiles) of some kv heads are dead
    for all of their heads. The narrow variants equal the bf16 kernel on the widened pages,
    each launch is counted under its shape, and the gate off equals, bit
    for bit, the kernel without blocksparse."""
    _card_or_skip()
    rng = np.random.default_rng(60 + qg)
    kvh = 4
    bs = BLOCKSPARSE[block]
    if op == "ragged":
        seqs = [(1, 90), (70, 70), (33, 150), (1, 17), (1, 1300), (40, 1040),
                (300, 1500)]
        rows = sum(q for q, _ in seqs)
        padded_seqs, padded_tokens = 8, rows + 5
        fn, ref = ragged_paged_attention, ref_ragged_paged_attention
    else:
        lens = rng.integers(1, 900, size=12)
        lens[:3] = (1200, 1030, 2100)
        seqs = [(1, int(n)) for n in lens]
        rows, padded_seqs, padded_tokens = 12, 16, 16
        fn, ref = paged_decode_attention, ref_paged_decode_attention
    qh = qg * kvh
    arrays = paged_batch(rng, seqs, qh, kvh, 128, padded_seqs=padded_seqs,
                         padded_tokens=padded_tokens)
    q = torch.from_numpy(arrays[0]).cuda().to(torch.bfloat16)
    values = torch.from_numpy(arrays[1]).cuda()
    kw = dict(sm_scale=0.09)
    if name == "bf16":
        pages = values.to(torch.bfloat16)
    else:
        pages = quantize_kv(values, torch.tensor(0.02, device="cuda"),
                            NARROW[name])
        kw["sm_scale"] *= 0.02
    kv_lens, page_idx, cu = (torch.from_numpy(a).cuda() for a in arrays[2:])
    ns = torch.tensor([len(seqs)], dtype=torch.int32, device="cuda")
    args = (kv_lens, page_idx, cu, ns) if op == "ragged" else (kv_lens,
                                                                page_idx)
    offsets = (torch.arange(qh, dtype=torch.int32, device="cuda")
               * max(1, bs[2] // qh))
    sparse = dict(kw, blocksparse=bs, bs_head_offsets=offsets)
    shape = f"qg{qg} d128 blocksparse"
    before = fn.launches_by_shape.get(shape, 0)
    got = fn(q, pages, *args, **sparse)
    torch.cuda.synchronize()
    assert fn.launches_by_shape[shape] == before + 1
    want = ref(q, pages, *args, **sparse)
    assert_rows_close(got[:rows], want[:rows])
    assert not got[rows:].float().any()  # padding tokens, dead rows: zeros
    # The mask moves the result: dense attention lands far off.
    dense = fn(q, pages, *args, **kw)
    assert (dense[:rows].float() - want[:rows].float()).abs().max() > 0.1
    if name != "bf16":
        assert torch.equal(got, fn(q, pages.to(torch.bfloat16), *args,
                                   **sparse))
    before = fn.launches_by_shape.get(f"qg{qg} d128", 0)
    assert torch.equal(fn(q, pages, *args, bs_on=False, **sparse), dense)
    assert fn.launches_by_shape[f"qg{qg} d128"] == before + 1


# Decode batches at the edges of the split-KV kernel's key ranges: rows of
# 8000+ keys (many splits), one row 16 times longer than the rest, rows
# that end exactly on a split or a 64-key tile boundary (split_keys is 256
# here), and long rows among many dead padded ones, so that each block
# takes several splits of its row. Each: the live rows' lengths and the
# number of dead rows after them.
DECODE_EDGES = {
    "many_splits": ([8191, 8000, 8192, 5000, 300, 8193], 2),
    "one_long_row": ([4096, 256, 250, 240, 230, 256, 200, 180], 2),
    "boundaries": ([64, 128, 256, 512, 1024, 2048, 63, 65, 1023, 1025, 2047,
                    2049, 1, 3000], 2),
    "splits_per_block": ([8191, 5000, 3001, 2048, 257], 59),
}


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 333], ids=["full", "window333"])
@pytest.mark.parametrize("name", ["bf16", *sorted(NARROW)])
@pytest.mark.parametrize("edge", sorted(DECODE_EDGES))
def test_decode_kernel_split_edges_on_card(edge, name, window):
    """The split-KV decode kernel (QG 7 on 4 kv heads, Qwen2.5-7B's ratio)
    at the edges of its splits and tiles, on each page type, against the
    plain version row by row (ROW_TOL) and the plain split pair; the
    narrow variants equal the bf16 kernel on the widened pages, and two
    calls are equal bit for bit (each block and the merge run in a fixed
    order)."""
    from aphrodite_tpu_torch.ops.decode_attention import (
        plan_decode_splits, ref_split_decode_attention)

    _card_or_skip()
    lens, dead = DECODE_EDGES[edge]
    rng = np.random.default_rng(80 + len(lens))
    seqs = [(1, n) for n in lens]
    rows = len(seqs)
    arrays = paged_batch(rng, seqs, 28, 4, 128, padded_seqs=rows + dead,
                         padded_tokens=rows + dead)
    q = torch.from_numpy(arrays[0]).cuda().to(torch.bfloat16)
    values = torch.from_numpy(arrays[1]).cuda()
    kw = dict(sm_scale=128**-0.5, sliding_window=window)
    if name == "bf16":
        pages = values.to(torch.bfloat16)
    else:
        pages = quantize_kv(values, torch.tensor(0.02, device="cuda"),
                            NARROW[name])
        kw["sm_scale"] *= 0.02
    kv_lens, page_idx = (torch.from_numpy(a).cuda() for a in arrays[2:4])
    got = paged_decode_attention(q, pages, kv_lens, page_idx, **kw)
    torch.cuda.synchronize()
    want = ref_paged_decode_attention(q, pages, kv_lens, page_idx, **kw)
    assert_rows_close(got[:rows], want[:rows])
    split, n, slots = plan_decode_splits(
        rows + dead, 4, page_idx.shape[1] * PS, PS,
        torch.cuda.get_device_properties(0).multi_processor_count)
    assert paged_decode_attention.last_plan["slots"] == slots
    if edge == "splits_per_block":
        assert slots < -(-max(lens) // split)  # a block takes several
    assert_rows_close(got[:rows], ref_split_decode_attention(
        q, pages, kv_lens, page_idx, split, n, **kw)[:rows])
    assert not got[rows:].float().any()  # dead rows: zeros
    assert torch.equal(got, paged_decode_attention(q, pages, kv_lens,
                                                   page_idx, **kw))
    if name != "bf16":
        assert torch.equal(got, paged_decode_attention(
            q, pages.to(torch.bfloat16), kv_lens, page_idx, **kw))


# Ragged batches at the edges of the kernel's 64-key tiles: chunks that
# start mid-page and are not multiples of a tile (on cached prefixes),
# decode tokens mixed with prefill chunks, and windows whose edges fall
# inside a tile.
RAGGED_EDGES = {
    "mid_page_chunks": ([(37, 53), (101, 1130), (70, 133), (129, 1000),
                         (5, 77)], None),
    "decode_mixed_with_prefill": ([(1, 700), (64, 64), (1, 65), (200, 1300),
                                   (1, 1), (1, 4097), (63, 190)], None),
    "window_inside_tiles": ([(90, 1090), (1, 1500), (150, 150), (33, 97),
                             (1, 300)], 77),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bf16", *sorted(NARROW)])
@pytest.mark.parametrize("qg", [4, 7])
@pytest.mark.parametrize("edge", sorted(RAGGED_EDGES))
def test_ragged_kernel_tile_edges_on_card(edge, qg, name):
    """The tensor-core ragged kernel at the edges of its 64-key tiles and
    its 64-row query tiles, QG 4 (an exact instantiation) and 7 (the
    runtime one), on each page type, against the plain version row by row
    (ROW_TOL); the narrow variants equal the bf16 kernel on the widened
    pages, and padding tokens stay zero."""
    _card_or_skip()
    seqs, window = RAGGED_EDGES[edge]
    rng = np.random.default_rng(90 + qg)
    rows = sum(q for q, _ in seqs)
    arrays = paged_batch(rng, seqs, qg * 4, 4, 128, padded_seqs=8,
                         padded_tokens=rows + 9)
    q = torch.from_numpy(arrays[0]).cuda().to(torch.bfloat16)
    values = torch.from_numpy(arrays[1]).cuda()
    kw = dict(sm_scale=128**-0.5, sliding_window=window)
    if name == "bf16":
        pages = values.to(torch.bfloat16)
    else:
        pages = quantize_kv(values, torch.tensor(0.02, device="cuda"),
                            NARROW[name])
        kw["sm_scale"] *= 0.02
    idx = [torch.from_numpy(a).cuda() for a in arrays[2:]]
    ns = torch.tensor([len(seqs)], dtype=torch.int32, device="cuda")
    got = ragged_paged_attention(q, pages, *idx, ns, **kw)
    torch.cuda.synchronize()
    assert_rows_close(got[:rows],
                      ref_ragged_paged_attention(q, pages, *idx, ns,
                                                 **kw)[:rows])
    assert not got[rows:].float().any()  # padding tokens: zeros
    if name != "bf16":
        assert torch.equal(got, ragged_paged_attention(
            q, pages.to(torch.bfloat16), *idx, ns, **kw))


@pytest.mark.cuda
def test_attention_kernels_refuse_what_they_do_not_take():
    _card_or_skip()
    idx = torch.ones((4,), dtype=torch.int32, device="cuda")
    table = torch.zeros((4, 2), dtype=torch.int32, device="cuda")
    q = torch.zeros((4, 32, 128), dtype=torch.bfloat16, device="cuda")
    for bad in (torch.float16, torch.uint8, torch.float32):
        pages = torch.zeros((3, PS, 16, 128), device="cuda").to(bad)
        with pytest.raises(ValueError, match="float8_e4m3fn"):
            paged_decode_attention(q, pages, idx, table)
    pages = torch.zeros((3, PS, 16, 128), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="bf16 q"):
        paged_decode_attention(q.float(), pages, idx, table)
    with pytest.raises(ValueError, match="multiple of KV"):  # 3 heads over 8
        paged_decode_attention(q[:, :3].contiguous(), pages, idx, table)
    for slopes in (torch.ones(32, dtype=torch.bfloat16, device="cuda"),
                   torch.ones(16, device="cuda"),
                   torch.ones(64, device="cuda")[::2]):
        with pytest.raises(ValueError, match="ALiBi"):
            paged_decode_attention(q, pages, idx, table, alibi_slopes=slopes)
    for d in (72, 192, 512):  # head_dims no instantiation takes
        with pytest.raises(ValueError, match="head_dim"):
            paged_decode_attention(
                torch.zeros((4, 32, d), dtype=torch.bfloat16, device="cuda"),
                torch.zeros((3, PS, 16, d), dtype=torch.int8, device="cuda"),
                idx, table)
    # Blocksparse is built for head_dim 128 at QH/KV 1, 2, 4, 8.
    with pytest.raises(ValueError, match="blocksparse at head_dim 128"):
        paged_decode_attention(
            q[:, :24].contiguous(), pages, idx, table, blocksparse=(64, 4, 8),
            bs_head_offsets=torch.zeros(24, dtype=torch.int32, device="cuda"))
    for d in (96, 256):  # built without it
        qd = torch.zeros((4, 32, d), dtype=torch.bfloat16, device="cuda")
        pd = torch.zeros((3, PS, 16, d), dtype=torch.int8, device="cuda")
        with pytest.raises(ValueError, match="blocksparse at head_dim 128"):
            ragged_paged_attention(
                qd, pd, idx, table, torch.arange(5, dtype=torch.int32,
                                                 device="cuda"), idx[:1],
                blocksparse=(64, 4, 8),
                bs_head_offsets=torch.zeros(32, dtype=torch.int32,
                                            device="cuda"))
    with pytest.raises(ValueError, match="blocksparse at head_dim 128"):
        paged_decode_attention(
            q[..., :64].contiguous(), pages[..., :64].contiguous(), idx,
            table, blocksparse=(64, 4, 8),
            bs_head_offsets=torch.zeros(32, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="aligned"):
        paged_decode_attention(q, pages.view(-1)[8:8 + 2 * PS * 16 * 128]
                               .view(2, PS, 16, 128), idx, table)
    offsets = torch.zeros(32, dtype=torch.int32, device="cuda")
    for bad in (offsets.long(), offsets[:16], offsets.cpu()):
        with pytest.raises(ValueError, match="blocksparse"):
            paged_decode_attention(q, pages, idx, table, blocksparse=(64, 4, 8),
                                   bs_head_offsets=bad)
    with pytest.raises(ValueError, match="not both"):
        paged_decode_attention(q, pages, idx, table, blocksparse=(64, 4, 8),
                               bs_head_offsets=offsets,
                               alibi_slopes=torch.ones(32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(NARROW))
def test_write_kv_bytes_on_card_equal_the_cpu(name, in_dtype):
    """Quantize-on-write on the card gives the CPU's bytes (which the CPU
    tests hold to the JAX package's): the scale is a 0-dim tensor, so
    the division is a true one on both, and values past the format's
    range saturate on both."""
    _card_or_skip()
    rng = np.random.default_rng(8)
    num_pages, kvh, d, T = 40, 8, 128, 300
    k, v = (torch.from_numpy(rng.standard_normal((T, kvh, d))
                             .astype(np.float32) * 4).to(in_dtype)
            for _ in range(2))
    k[0, 0, :4] = torch.tensor([1e6, -1e6, 30.0, -30.0])  # overflow at /0.05
    slots = torch.from_numpy(rng.permutation(num_pages * PS)[:T]
                             .astype(np.int32))
    caches = []
    for device in ("cpu", "cuda"):
        cache = torch.zeros((num_pages + 1, PS, 2 * kvh, d),
                            dtype=NARROW[name], device=device)
        scales = [torch.tensor(s, device=device) for s in (0.05, 0.03)]
        write_kv(cache, k.to(device), v.to(device), slots.to(device),
                 *scales)
        caches.append(cache.view(torch.uint8).cpu())
    assert torch.equal(*caches)
    assert caches[0].any()
    assert caches[0].view(NARROW[name]).float().isfinite().all()


@pytest.mark.cuda
def test_bf16_logits_and_logprobs_match_f32_on_card():
    """bf16 hidden rows times the bf16 LM head at Llama-3.1-8B width give
    f32 logits (not rounded to bf16) and the sampler's logprobs, against
    the same product and log-softmax in f64 on the card."""
    _card_or_skip()
    hf = dict(architectures=["LlamaForCausalLM"], hidden_size=4096,
              intermediate_size=14336, num_hidden_layers=1,
              num_attention_heads=32, num_key_value_heads=8, head_dim=128,
              vocab_size=128256, max_position_embeddings=256,
              tie_word_embeddings=False)
    model = LlamaForCausalLM(ModelConfig(model="unused", dtype="bfloat16",
                                         hf_config=hf),
                             device=torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    S, H, V = 32, 4096, 128256
    hidden = (torch.randn((S, H), generator=gen, device="cuda")
              * 3).to(torch.bfloat16)
    head = (torch.randn((H, V), generator=gen, device="cuda")
            * H**-0.5).to(torch.bfloat16)
    logits = model.compute_logits({"lm_head": head}, hidden)
    want = hidden.double() @ head.double()
    assert logits.dtype == torch.float32
    # f32 accumulation of 4096 exact products errs by about 1e-6 of the
    # row's largest logit; rounding to bf16 would move the largest logits
    # by up to 2^-9 of their size, about 60 times this bound.
    scale = want.abs().amax(-1, keepdim=True)
    assert ((logits.double() - want).abs() <= 3e-5 * scale).all()
    rows = [SamplerInputRow(params=SamplingParams(temperature=0.0,
                                                  logprobs=5),
                            token_ids=[1], prompt_len=1, generated_len=0,
                            seed=0)] * S
    t, flags, _, _ = build_sampling_tensors(rows, S, V)
    out = sample(logits, tensors_to_device(t, torch.device("cuda")), flags)
    want_lp = torch.log_softmax(want, dim=-1)
    # Greedy rows: the sampled token's logprob is the row's largest.
    torch.testing.assert_close(out.sampled_logprob.double(),
                               want_lp.amax(-1), rtol=0, atol=5e-4)
    torch.testing.assert_close(out.topk_logprobs.double(),
                               want_lp.topk(5, dim=-1).values, rtol=0,
                               atol=5e-4)


# ----------------------------------------------------------------------
# int4 weights
# ----------------------------------------------------------------------


def _int4_case(rng, L, K, N, group, T, wide_zero=False):
    """Random packed container [L, K/2, N] and x [T, K] at std 1."""
    q = rng.integers(0, 16, size=(L, K, N), dtype=np.int8)
    scale = (rng.random((L, K // group, N), dtype=np.float32) * 0.02 + 0.001)
    zero = rng.integers(-3 if wide_zero else 0, 20 if wide_zero else 16,
                        size=(L, K // group, N)).astype(np.float32)
    x = rng.standard_normal((T, K), dtype=np.float32)
    return (torch.from_numpy(x).cuda().to(torch.bfloat16),
            torch.from_numpy(pack_int4_rows(q)).cuda(),
            torch.from_numpy(scale).cuda(), torch.from_numpy(zero).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 2048])
@pytest.mark.parametrize("K,N", [(4096, 6144), (14336, 4096)])
def test_int4p_kernel_matches_plain_on_card(T, K, N):
    """Llama-3.1-8B wqkv and down sites, stacked weights with a layer
    index, zeros outside 0..15. Under 64 tokens (the group-wise body) row
    by row against the exact f32 dequantized product (the kernel
    multiplies raw nibbles and scales f32 partial sums, so only the order
    of the sums differs: 2^-14 of the row's largest element) and against
    the plain version (which rounds w to bf16, 2^-9 relative per term,
    adding up as a random walk over K: far inside ROW_TOL). From 64 tokens
    on (the dense body, which rounds w to bf16 as the plain version does)
    the two references swap their tolerances."""
    _card_or_skip()
    rng = np.random.default_rng(K + T)
    x, q4p, scale, zero = _int4_case(rng, 2, K, N, 128, T, wide_zero=True)
    before = int4p_matmul.launches
    got = int4p_matmul(x, q4p, scale, zero, 128, layer_idx=1)
    torch.cuda.synchronize()
    assert int4p_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (T, N)
    want = int4p_matmul_ref(x, q4p[1], scale[1], zero[1], 128)
    exact = x.float() @ dequantize_int4(unpack_int4_rows(q4p[1]), scale[1],
                                        zero[1], 128)
    assert got.isfinite().all()
    tols = ((want, ROW_TOL), (exact, 2.0**-14)) if T < 64 else \
        ((want, 2.0**-14), (exact, ROW_TOL))
    for ref, tol in tols:
        err = (got - ref).abs().amax(-1)
        bound = tol * ref.abs().amax(-1)
        assert (err <= bound).all(), float((err / bound).max())
    # The other layer of the stack gives another product.
    other = int4p_matmul(x, q4p, scale, zero, 128, layer_idx=0)
    assert not torch.equal(other, got)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 33, 2048])
@pytest.mark.parametrize("K,N", [(4096, 6144), (4096, 28672)])
def test_int4p_kernel_group16_on_card(T, K, N):
    """Group 16 (GGUF Q2_K and Q3_K): each 16-row mma step closes a group.
    At Llama-3.1-8B's wqkv and w13 sites, T from one token to a prefill
    step, with split K (wqkv at T <= 33) and without (w13, and T 2048):
    against the plain version at ROW_TOL and the exact f32-weight product
    at 2^-14 of a row, the two tolerances swapped from 64 tokens on (the
    dense body)."""
    from aphrodite_tpu_torch.ops.quant_matmul import kernel_plan

    _card_or_skip()
    rng = np.random.default_rng(T + N)
    x, q4p, scale, zero = _int4_case(rng, 1, K, N, 16, T, wide_zero=True)
    before = int4p_matmul.launches
    got = int4p_matmul(x, q4p[0], scale[0], zero[0], 16)
    torch.cuda.synchronize()
    assert int4p_matmul.launches == before + 1
    split = kernel_plan(T, K, N)[1] > 1
    assert split == (N == 6144 and T <= 33)
    want = int4p_matmul_ref(x, q4p[0], scale[0], zero[0], 16)
    exact = x.float() @ dequantize_int4(unpack_int4_rows(q4p[0]), scale[0],
                                        zero[0], 16)
    assert got.isfinite().all()
    tols = ((want, ROW_TOL), (exact, 2.0**-14)) if T < 64 else \
        ((want, 2.0**-14), (exact, ROW_TOL))
    for ref, tol in tols:
        err = (got - ref).abs().amax(-1)
        bound = tol * ref.abs().amax(-1)
        assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("group,K", [(32, 1024), (64, 1920), (128, 1024),
                                     (16, 1024), (48, 1536)])
def test_int4p_kernel_group_sizes_on_card(group, K):
    """Groups of 32 (every k tile closes a group), 64 and 128, and of 16
    and 48 (groups close after 16-row steps inside a tile), at T below and
    above one row block; at K 1920 the split of K ends inside a group.
    Against the exact f32-weight product."""
    _card_or_skip()
    rng = np.random.default_rng(group)
    for T in (5, 40):
        x, q4p, scale, zero = _int4_case(rng, 1, K, 256, group, T,
                                         wide_zero=True)
        got = int4p_matmul(x, q4p[0], scale[0], zero[0], group)
        exact = x.float() @ dequantize_int4(unpack_int4_rows(q4p[0]),
                                            scale[0], zero[0], group)
        err = (got - exact).abs().amax(-1)
        bound = 2.0**-14 * exact.abs().amax(-1)
        assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.cuda
def test_int4p_kernel_refuses_what_it_does_not_take():
    _card_or_skip()
    rng = np.random.default_rng(0)
    x, q4p, scale, zero = _int4_case(rng, 1, 256, 256, 64, 4)
    args = (q4p[0], scale[0], zero[0], 64)
    int4p_matmul(x, *args)  # group 64, T 4: taken
    with pytest.raises(ValueError, match="bf16"):
        int4p_matmul(x.float(), *args)
    with pytest.raises(ValueError, match="multiple of 128"):
        int4p_matmul(x, q4p[0, :, :192].contiguous(),
                     scale[0, :, :192].contiguous(),
                     zero[0, :, :192].contiguous(), 64)
    with pytest.raises(ValueError, match="group"):  # under 16 rows
        int4p_matmul(x, q4p[0], scale[0].repeat_interleave(8, 0),
                     zero[0].repeat_interleave(8, 0), 8)
    with pytest.raises(ValueError, match="layer_idx"):
        int4p_matmul(x, q4p, scale, zero, 64)


# The unpacked form (one int8 level per byte). Against the exact
# f32-weight product only the order of the f32 sums differs for the
# group-wise body: 2^-14 of the row's largest element. The dense body
# rounds w to bf16 exactly as the plain version does, so it is held to the
# plain version at that tolerance, and to the exact product at ROW_TOL
# (2^-9 relative per term, adding up as a random walk over K); the
# group-wise body to the plain version at ROW_TOL.
SAME_TOL = 2.0**-14
# (levels low, high (exclusive), zero low, high (exclusive), signed scales)
LEVELS = {"q6_k": (0, 64, 32, 33, True), "q8_0": (-128, 128, 0, 1, False),
          "q5_k": (0, 32, -3, 40, False), "gptq": (0, 16, 0, 17, False)}


def _q4_case(rng, L, K, N, group, T, kind):
    """Random unpacked container [L, K, N] and x [T, K] at std 1."""
    lo, hi, zlo, zhi, signed = LEVELS[kind]
    q = rng.integers(lo, hi, size=(L, K, N)).astype(np.int8)
    scale = (rng.random((L, K // group, N), dtype=np.float32) * 0.02 + 0.001)
    if signed:
        scale *= rng.choice(np.float32([-1.0, 1.0]), size=scale.shape)
    zero = rng.integers(zlo, zhi, size=scale.shape).astype(np.float32)
    x = rng.standard_normal((T, K), dtype=np.float32)
    return (torch.from_numpy(x).cuda().to(torch.bfloat16),
            torch.from_numpy(q).cuda(), torch.from_numpy(scale).cuda(),
            torch.from_numpy(zero).cuda())


def _assert_int4_close(got, x, q4, scale, zero, group, body):
    want = int4_matmul_ref(x, q4, scale, zero, group)
    exact = x.float() @ dequantize_int4(q4, scale, zero, group)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.isfinite().all()
    dense = body in ("dense", "dense_wgmma")  # the prefill body's too
    tols = ((want, SAME_TOL), (exact, ROW_TOL)) if dense else \
        ((want, ROW_TOL), (exact, SAME_TOL))
    for ref, tol in tols:
        err = (got - ref).abs().amax(-1)
        bound = tol * ref.abs().amax(-1)
        assert (err <= bound).all(), (body, tol, float((err / bound).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 8, 64, 2048])
@pytest.mark.parametrize("K,N", [(4096, 6144), (14336, 4096)])
def test_int4_kernel_bodies_match_plain_on_card(T, K, N):
    """Llama-3.1-8B wqkv and down sites, stacked levels with a layer
    index, both bodies: Q6_K-like (0..63, group 16, zero 32, signed
    scales) and Q8_0-like (signed bytes, group 32)."""
    _card_or_skip()
    rng = np.random.default_rng(K + T)
    for kind, group in (("q6_k", 16), ("q8_0", 32)):
        x, q4, scale, zero = _q4_case(rng, 2, K, N, group, T, kind)
        for body in ("groupwise", "dense"):
            before = int4_matmul.launches
            got = int4_matmul(x, q4, scale, zero, group, layer_idx=1,
                              body=body)
            torch.cuda.synchronize()
            assert int4_matmul.launches == before + 1
            _assert_int4_close(got, x, q4[1], scale[1], zero[1], group, body)
            other = int4_matmul(x, q4, scale, zero, group, layer_idx=0,
                                body=body)
            assert not torch.equal(other, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(LEVELS))
@pytest.mark.parametrize("group,K", [(1, 1024), (8, 1024), (16, 1024),
                                     (32, 1024), (64, 1920), (128, 1024),
                                     (1920, 1920)])
def test_int4_kernel_group_sizes_on_card(group, K, kind):
    """Groups from one row (act-order GPTQ) to a whole column, signed and
    unsigned levels, 2-D containers, T below and above one row block; at K
    1920 the split of K ends inside a group. Groups under 16 rows take
    the dense body only; the wrapper's own choice of body runs too."""
    _card_or_skip()
    rng = np.random.default_rng(group)
    for T in (5, 70):
        x, q4, scale, zero = _q4_case(rng, 1, K, 256, group, T, kind)
        args = (q4[0], scale[0], zero[0], group)
        bodies = ("dense",) if group < 16 else ("groupwise", "dense")
        for body in bodies:
            got = int4_matmul(x, *args, body=body)
            _assert_int4_close(got, x, *args, body)
        counts = dict(int4_matmul.launches_by_body)
        got = int4_matmul(x, *args)
        (body,) = [b for b, n in int4_matmul.launches_by_body.items()
                   if n != counts.get(b, 0)]
        _assert_int4_close(got, x, *args, body)


@pytest.mark.cuda
def test_int4_kernel_large_zero_with_tiny_scale_on_card():
    """A group whose scale is 2^-20 and whose zero is offset * 2^20 (how a
    GGUF min offset with a zero group scale is stored): w is -offset to
    within 2^-15. In the group-wise form s * part and (s * z) * rowsum
    are far apart in size; s * z is formed once in f32, so the result
    still follows the exact product."""
    _card_or_skip()
    rng = np.random.default_rng(3)
    x, q4, scale, zero = _q4_case(rng, 1, 1024, 256, 32, 20, "q5_k")
    offset = torch.from_numpy(
        rng.random((8, 256), dtype=np.float32)).cuda() * 0.5
    scale[0, ::4] = 2.0**-20
    zero[0, ::4] = offset * 2.0**20
    for body in ("groupwise", "dense"):
        got = int4_matmul(x, q4[0], scale[0], zero[0], 32, body=body)
        _assert_int4_close(got, x, q4[0], scale[0], zero[0], 32, body)


@pytest.mark.cuda
def test_int4_kernel_refuses_what_it_does_not_take():
    from aphrodite_tpu_torch.quantization.qlinear import qmatmul

    _card_or_skip()
    rng = np.random.default_rng(0)
    x, q4, scale, zero = _q4_case(rng, 2, 256, 256, 64, 4, "q8_0")
    args = (q4[0], scale[0], zero[0], 64)
    before = int4_matmul.launches
    qmatmul(x, {"q4": q4, "scale": scale, "zero": zero}, layer=1)
    assert int4_matmul.launches == before + 1  # the kernel, not the plain
    with pytest.raises(ValueError, match="bf16"):
        int4_matmul(x.float(), *args)
    with pytest.raises(ValueError, match="multiple of 128"):
        int4_matmul(x, q4[0, :, :192].contiguous(),
                    scale[0, :, :192].contiguous(),
                    zero[0, :, :192].contiguous(), 64)
    with pytest.raises(ValueError, match="group-wise body"):
        int4_matmul(x, q4[0], scale[0].repeat_interleave(8, 0),
                    zero[0].repeat_interleave(8, 0), 8, body="groupwise")
    with pytest.raises(ValueError, match="straddle"):
        int4_matmul(x[:, :192].contiguous(), q4[0, :192],
                    scale[0, :2], zero[0, :2], 96)
    with pytest.raises(ValueError, match="layer_idx"):
        int4_matmul(x, q4, scale, zero, 64)
    with pytest.raises(ValueError, match="body"):
        int4_matmul(x, *args, body="wmma")
    # An int8 per-channel container launches the group-wise body at G = K.
    groupwise = int4_matmul.launches_by_body.get("groupwise", 0)
    qmatmul(x, {"q": q4[0], "scale": scale[0, :1]})
    assert int4_matmul.launches_by_body["groupwise"] == groupwise + 1


# The decode body (csrc/decode_gemm.cuh) of both kernels: each form, at
# groups from one row to 128 (48, an odd multiple of 16, packed only), at
# a packed K/2 that is an odd multiple of 32 where the group divides it
# (K 2112: K/2 = 1056, a 32-row last stage), N 384 (the second box of the
# last block lies past N; K split where a divisor of its stages pays), on
# the layer view of a stack.
DECODE_T = (1, 7, 8, 9, 16, 17, 33, 63)
DECODE_CASES = [("packed", 16, 2112), ("packed", 32, 2112),
                ("packed", 48, 2112), ("packed", 128, 4096),
                ("groupwise", 16, 2112), ("groupwise", 32, 2112),
                ("groupwise", 128, 4096), ("dense", 1, 2112),
                ("dense", 8, 2112), ("dense", 16, 2112), ("dense", 32, 2112),
                ("dense", 128, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,group,K", DECODE_CASES)
def test_decode_body_on_card(fmt, group, K):
    """Every form of the decode body (named with decode=True: at these
    sizes decode_route picks the mma.sync kernels) at every token tile (T
    1-63, one and two tiles, ragged and full): against the plain version
    and the exact f32-weight product (group-wise arithmetic: 2^-14 of a
    row from the exact one, ROW_TOL from the plain one; dense: the other
    way round), the same bits from two runs (split K sums in a fixed
    order), and another layer of the stack giving another product."""
    from aphrodite_tpu_torch.ops.quant_matmul import decode_plan

    _card_or_skip()
    N = 384
    rng = np.random.default_rng(group + K)
    for T in DECODE_T:
        if fmt == "packed":
            x, q, scale, zero = _int4_case(rng, 2, K, N, group, T,
                                           wide_zero=True)
            run = lambda l: int4p_matmul(x, q, scale, zero, group,  # noqa
                                         layer_idx=l, decode=True)
            w = dequantize_int4(unpack_int4_rows(q[1]), scale[1], zero[1],
                                group)
            plain = int4p_matmul_ref(x, q[1], scale[1], zero[1], group)
            wrapper = int4p_matmul
        else:
            x, q, scale, zero = _q4_case(rng, 2, K, N, group, T, "q5_k")
            run = lambda l: int4_matmul(x, q, scale, zero, group,  # noqa
                                        layer_idx=l, body=fmt, decode=True)
            w = dequantize_int4(q[1], scale[1], zero[1], group)
            plain = int4_matmul_ref(x, q[1], scale[1], zero[1], group)
            wrapper = int4_matmul
        got = run(1)
        torch.cuda.synchronize()
        assert wrapper.last_plan == decode_plan(T, K, N, group, fmt)
        exact = x.float() @ w
        assert got.isfinite().all() and got.shape == (T, N)
        tols = ((plain, SAME_TOL), (exact, ROW_TOL)) if fmt == "dense" else \
            ((plain, ROW_TOL), (exact, SAME_TOL))
        for ref, tol in tols:
            err = (got - ref).abs().amax(-1)
            bound = tol * ref.abs().amax(-1)
            assert (err <= bound).all(), (T, tol, float((err / bound).max()))
        assert torch.equal(run(1), got)
        assert not torch.equal(run(0), got)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [128, 64])
def test_quantize_from_float_on_card_matches_numpy(group):
    _card_or_skip()
    w = np.random.default_rng(6).standard_normal((2, 512, 256)).astype(
        np.float32)
    want = int4.quantize_from_float(w, group)
    got = int4.quantize_from_float(torch.from_numpy(w).cuda(), group)
    assert set(got) == set(want) == {"q4p", "scale", "zero"}
    for k in want:
        assert got[k].device.type == "cuda"
        np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])


# ----------------------------------------------------------------------
# The prefill body (csrc/dequant_gemm.cuh) of both int4 kernels
# ----------------------------------------------------------------------

# Llama-3.1-8B's wqkv, w13 and down sites, and T from the switch (64) to a
# prefill step, 100 and 257 leaving ragged token tiles.
DENSE_SITES = {"wqkv": (4096, 6144), "w13": (4096, 28672),
               "down": (14336, 4096)}
DENSE_T = (64, 100, 257, 2048)
# Unpacked containers: (kind of LEVELS, group).
DENSE_CONTAINERS = {"q6_k": ("q6_k", 16), "q8_0": ("q8_0", 32),
                    "act_order": ("gptq", 1), "gptq_g128": ("gptq", 128)}


def _by_body(wrapper, body):
    return wrapper.launches_by_body.get(body, 0)


def _bf16_x(rng, T, K):
    return torch.from_numpy(rng.standard_normal((T, K), dtype=np.float32)).to(
        torch.bfloat16).cuda()


@pytest.mark.cuda
def test_dense_body_identity_weights_on_card():
    """Scale 1 and zero 0 make each weight its level, so the prefill body
    must give torch.matmul's product of x and the levels up to the order
    of the f32 sums, in both formats: a check of the TMA boxes, the
    swizzle and wgmma's descriptors apart from the dequantization."""
    _card_or_skip()
    rng = np.random.default_rng(11)
    K, N, T = 1024, 512, 200
    q = rng.integers(0, 16, size=(K, N), dtype=np.int8)
    x = _bf16_x(rng, T, K)
    ones = torch.ones((K // 128, N), device="cuda")
    zeros = torch.zeros_like(ones)
    levels = torch.from_numpy(q).cuda()
    want = x.float() @ levels.float()
    packed = int4p_matmul(x, torch.from_numpy(pack_int4_rows(q)).cuda(), ones,
                          zeros, 128)
    unpacked = int4_matmul(x, levels, ones, zeros, 128)
    torch.cuda.synchronize()
    _assert_rows_within(packed, want, SAME_TOL)
    _assert_rows_within(unpacked, want, SAME_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [16, 32, 64, 128])
@pytest.mark.parametrize("site", sorted(DENSE_SITES))
def test_int4p_dense_body_on_card(site, group):
    """The packed prefill body on a layer of a stack, zeros outside 0..15:
    against the plain version at SAME_TOL (the same bf16 weights, f32 sums
    in another order) and the exact f32-weight product at ROW_TOL."""
    _card_or_skip()
    K, N = DENSE_SITES[site]
    rng = np.random.default_rng(N + group)
    _, q4p, scale, zero = _int4_case(rng, 2, K, N, group, 1, wide_zero=True)
    want_w = dequantize_int4(unpack_int4_rows(q4p[1]), scale[1], zero[1],
                             group)
    for T in DENSE_T:
        x = _bf16_x(rng, T, K)
        before = _by_body(int4p_matmul, "dense_wgmma")
        got = int4p_matmul(x, q4p, scale, zero, group, layer_idx=1)
        torch.cuda.synchronize()
        assert _by_body(int4p_matmul, "dense_wgmma") == before + 1
        _assert_rows_within(
            got, int4p_matmul_ref(x, q4p[1], scale[1], zero[1], group),
            SAME_TOL)
        _assert_rows_within(got, x.float() @ want_w, ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("container", sorted(DENSE_CONTAINERS))
@pytest.mark.parametrize("site", sorted(DENSE_SITES))
def test_int4_dense_body_on_card(site, container):
    """The unpacked prefill body (the dense body's calls from 64 tokens on)
    on Q6_K-like, Q8_0-like, act-order (G = 1: each row's scale and zero
    read from device memory) and GPTQ group-128 containers: against the
    plain version at SAME_TOL and the exact f32-weight product at
    ROW_TOL."""
    _card_or_skip()
    K, N = DENSE_SITES[site]
    kind, group = DENSE_CONTAINERS[container]
    rng = np.random.default_rng(N + group)
    _, q4, scale, zero = _q4_case(rng, 1, K, N, group, 1, kind)
    for T in DENSE_T:
        x = _bf16_x(rng, T, K)
        before = _by_body(int4_matmul, "dense_wgmma")
        got = int4_matmul(x, q4[0], scale[0], zero[0], group)
        torch.cuda.synchronize()
        assert _by_body(int4_matmul, "dense_wgmma") == before + 1
        _assert_int4_close(got, x, q4[0], scale[0], zero[0], group,
                           "dense_wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(DENSE_SITES))
def test_int8_per_column_body_on_card(site):
    """int8 per-channel weights through the prefill body's per-column form
    (raw levels on the tensor cores, the scale on the f32 sum) against
    int8_matmul_ref: the order of the f32 sums differs only."""
    _card_or_skip()
    K, N = DENSE_SITES[site]
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy(rng.standard_normal((1, K, N), dtype=np.float32))
    c = {k: v.cuda() for k, v in int8.quantize_from_float(w).items()}
    for T in DENSE_T:
        x = _bf16_x(rng, T, K)
        before = _by_body(int4_matmul, "per_column_wgmma")
        got = int8_matmul(x, c["q"], c["scale"], layer_idx=0)
        torch.cuda.synchronize()
        assert _by_body(int4_matmul, "per_column_wgmma") == before + 1
        _assert_rows_within(got, int8_matmul_ref(x, c["q"][0], c["scale"][0]),
                            SAME_TOL)


@pytest.mark.cuda
def test_dense_body_edges_and_refusals_on_card():
    """body="dense" takes any T (token rows past T are masked); an N that
    is an odd multiple of 128 leaves the last block one warpgroup of
    columns; K/2 an odd multiple of 32 takes the prefill body from 64
    tokens on (its last stage runs 32 packed rows) and the group-wise body
    under 64."""
    _card_or_skip()
    rng = np.random.default_rng(12)
    x, q4p, scale, zero = _int4_case(rng, 1, 1024, 384, 64, 70)
    args = (q4p[0], scale[0], zero[0], 64)
    for T in (1, 5, 70):
        got = int4p_matmul(x[:T], *args, body="dense")
        _assert_rows_within(got, int4p_matmul_ref(x[:T], *args), SAME_TOL)
    x, q4p, scale, zero = _int4_case(rng, 1, 1088, 256, 32, 70)
    args = (q4p[0], scale[0], zero[0], 32)
    before = _by_body(int4p_matmul, "dense_wgmma")
    got = int4p_matmul(x, *args)
    assert _by_body(int4p_matmul, "dense_wgmma") == before + 1
    _assert_rows_within(got, int4p_matmul_ref(x, *args), SAME_TOL)
    got = int4p_matmul(x[:20], *args)  # the group-wise body
    exact = x[:20].float() @ dequantize_int4(unpack_int4_rows(q4p[0]),
                                             scale[0], zero[0], 32)
    _assert_rows_within(got, exact, SAME_TOL)
    with pytest.raises(ValueError, match="body"):
        int4p_matmul(x, *args, body="wmma")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 200])
@pytest.mark.parametrize("group", [16, 32])
def test_int4p_prefill_body_32_row_tail_on_card(T, group):
    """K 1088 (K/2 = 544, an odd multiple of 32): the prefill body's last
    stage takes 32 packed rows; against the plain version at SAME_TOL (the
    same bf16-rounded weights, f32 sums in another order), with the split
    of K the plan chooses and with none."""
    _card_or_skip()
    rng = np.random.default_rng(T + group)
    x, q4p, scale, zero = _int4_case(rng, 2, 1088, 512, group, T,
                                     wide_zero=True)
    want = int4p_matmul_ref(x, q4p[1], scale[1], zero[1], group)
    before = _by_body(int4p_matmul, "dense_wgmma")
    got = int4p_matmul(x, q4p, scale, zero, group, layer_idx=1)
    torch.cuda.synchronize()
    assert _by_body(int4p_matmul, "dense_wgmma") == before + 1
    assert int4p_matmul.last_plan["k_stages"] == 9
    _assert_rows_within(got, want, SAME_TOL)
    from aphrodite_tpu_torch.ops.quant_matmul import _dense_product
    for splits in (1, 3, 9):
        got = _dense_product(int4p_matmul, x, q4p[1], scale[1], zero[1],
                             group, "packed", splits=splits)
        _assert_rows_within(got, want, SAME_TOL)


# ----------------------------------------------------------------------
# W4A8, the activation quantizer, int8 weight-only and FP8 W8A8
# ----------------------------------------------------------------------


def _assert_rows_within(got, want, tol):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.isfinite().all()
    err = (got - want).abs().amax(-1)
    bound = tol * want.abs().amax(-1)
    assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,N,group", [
    (1, 4096, 256, 128), (16, 4096, 6144, 128), (33, 1024, 128, 32),
    (100, 14336, 512, 128), (2048, 4096, 256, 64), (1, 4096, 256, 16),
    (33, 1024, 128, 16), (100, 14336, 512, 16), (2048, 4096, 256, 16),
    (64, 3072, 256, 48), (200, 1088, 256, 32), (33, 1088, 384, 16)])
def test_w4a8_kernel_matches_plain_on_card(T, K, N, group):
    """Stacked container with a layer index, wide zeros; T = 1 and 33
    leave a row block partly dead, K = 14336 at small T splits K; groups
    of 16 and 48 close inside a k tile (the HALF instantiation). The
    int8 activations are bit-equal on both sides and every group's product
    is an exact int32, so only the order of the f32 sums differs."""
    _card_or_skip()
    rng = np.random.default_rng(T + K)
    x, q4p, scale, zero = _int4_case(rng, 2, K, N, group, T, wide_zero=True)
    before = int4p_matmul_w4a8.launches, quantize_activations.launches
    got = int4p_matmul_w4a8(x, q4p, scale, zero, group, layer_idx=1)
    torch.cuda.synchronize()
    assert (int4p_matmul_w4a8.launches, quantize_activations.launches) == (
        before[0] + 1, before[1] + 1)
    want = int4p_matmul_w4a8_ref(x, q4p[1], scale[1], zero[1], group)
    _assert_rows_within(got, want, SAME_TOL)
    # And within the JAX package's bound on a8 error against the W4A16
    # product (tests/test_quantization.py: under 2 % of the largest).
    a16 = int4p_matmul_ref(x.float(), q4p[1], scale[1], zero[1], group)
    assert float((got - a16).abs().max() / a16.abs().max()) < 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "e4m3", "e4m3_f16"])
@pytest.mark.parametrize("K", [8, 4096, 14336])
def test_quantize_activations_kernel_bytes_equal_the_plain_on_card(fmt, K):
    """bf16 rows at scales from e^-8 to e^6, an all-zero row, a row with
    one large value, and a row of exact .5 steps (sx = 1): the kernel's
    bytes and scales equal the plain version's, on the card and on the
    CPU."""
    _card_or_skip()
    rng = np.random.default_rng(K)
    x = rng.standard_normal((70, K)).astype(np.float32)
    x *= np.exp(rng.uniform(-8, 6, (70, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] *= 1e-3
    x[1, K // 2] = 300.0
    x[2] = (np.arange(K) % 255 - 127).astype(np.float32) * 0.5
    x[2, 0] = 127.0
    xc = torch.from_numpy(x).to(torch.bfloat16)
    plain = (quantize_activations_int8 if fmt == "int8"
             else quantize_activations_e4m3)
    before = quantize_activations.launches
    got_q, got_s = quantize_activations(xc.cuda(), fmt)
    torch.cuda.synchronize()
    assert quantize_activations.launches == before + 1
    wants = [plain(xc), plain(xc.cuda())]
    if fmt == "e4m3_f16":
        wants = [(q.to(torch.float16), s) for q, s in wants]
    for want_q, want_s in wants:
        assert got_q.dtype == want_q.dtype
        assert torch.equal(got_q.view(torch.uint8).cpu(),
                           want_q.view(torch.uint8).cpu())
        assert torch.equal(got_s.cpu(), want_s.cpu())


@pytest.mark.cuda
def test_w4a8_kernel_refuses_what_it_does_not_take():
    from aphrodite_tpu_torch.quantization.qlinear import qmatmul

    _card_or_skip()
    rng = np.random.default_rng(0)
    x, q4p, scale, zero = _int4_case(rng, 2, 512, 256, 64, 16)
    int4p_matmul_w4a8(x, q4p, scale, zero, 64, layer_idx=0)  # taken
    with pytest.raises(ValueError, match="bf16"):
        int4p_matmul_w4a8(x.float(), q4p, scale, zero, 64, layer_idx=0)
    with pytest.raises(ValueError, match="multiple of 128"):
        int4p_matmul_w4a8(x, q4p[..., :192].contiguous(),
                          scale[..., :192].contiguous(),
                          zero[..., :192].contiguous(), 64, layer_idx=0)
    # Group 16 (GGUF Q2_K / Q3_K) is taken and equals the plain version as
    # every group does; group 8 is not.
    s16, z16 = scale.repeat_interleave(4, 1), zero.repeat_interleave(4, 1)
    _assert_rows_within(
        int4p_matmul_w4a8(x, q4p, s16, z16, 16, layer_idx=0),
        int4p_matmul_w4a8_ref(x, q4p[0], s16[0], z16[0], 16), SAME_TOL)
    with pytest.raises(ValueError, match="group"):
        int4p_matmul_w4a8(x, q4p, scale.repeat_interleave(8, 1),
                          zero.repeat_interleave(8, 1), 8, layer_idx=0)
    with pytest.raises(ValueError, match="layer_idx"):
        int4p_matmul_w4a8(x, q4p, scale, zero, 64)
    # With the switch, a stacked container at T >= 16 launches W4A8; at
    # T < 16, or with no layer, W4A16.
    w = {"q4p": q4p, "scale": scale, "zero": zero}
    old = os.environ.get("APHRODITE_W4_A8")
    os.environ["APHRODITE_W4_A8"] = "1"
    try:
        counts = lambda: (int4p_matmul_w4a8.launches,  # noqa: E731
                          int4p_matmul.launches)
        start = counts()
        qmatmul(x, w, layer=1)
        qmatmul(x[:15], w, layer=1)
        qmatmul(x, {k: v[0] for k, v in w.items()})
        assert counts() == (start[0] + 1, start[1] + 2)
    finally:
        if old is None:
            del os.environ["APHRODITE_W4_A8"]
        else:
            os.environ["APHRODITE_W4_A8"] = old


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 32, 300])
@pytest.mark.parametrize("K,N", [(4096, 6144), (14336, 4096)])
def test_int8_container_groupwise_body_on_card(T, K, N):
    """int8 per-channel weights through the group-wise body at G = K under
    64 tokens (the group spans the split-K partitions at small T; on the
    mma.sync kernel or the decode body, as decode_route picks by shape),
    and through the prefill body's per-column form from there. Against the
    plain version (the JAX package's arithmetic: exact products, f32
    sums, the scale on the sum), the order of the sums differs only."""
    from aphrodite_tpu_torch.ops.quant_matmul import decode_route

    _card_or_skip()
    rng = np.random.default_rng(T + K)
    w = torch.from_numpy(rng.standard_normal((2, K, N), dtype=np.float32))
    c = {k: v.cuda() for k, v in int8.quantize_from_float(w).items()}
    x = torch.from_numpy(rng.standard_normal((T, K), dtype=np.float32)).to(
        torch.bfloat16).cuda()
    route = "groupwise" if T < 64 else "per_column_wgmma"
    if T < 64 and decode_route(T, K, N, K, "groupwise") == "decode":
        route = "groupwise_decode"
    before = int4_matmul.launches_by_body.get(route, 0)
    got = int8_matmul(x, c["q"], c["scale"], layer_idx=1)
    torch.cuda.synchronize()
    assert int4_matmul.launches_by_body[route] == before + 1
    _assert_rows_within(got, int8_matmul_ref(x, c["q"][1], c["scale"][1]),
                        SAME_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 32, 64, 2048])
def test_fp8_w8a8_matches_plain_on_card(T):
    """The quantizer kernel and the body fp8_route picks against the plain
    version: the same e4m3 operands, exact products and f32 sums in
    another order (SAME_TOL), on a stacked row-major weight made on the
    card; a witness of the plain version (the operands widened to bf16, a
    bf16 product with f32 sums) at the same tolerance."""
    from aphrodite_tpu_torch.ops.quant_matmul import fp8_route

    _card_or_skip()
    rng = np.random.default_rng(T)
    K, N = 4096, 6144
    w = torch.from_numpy(rng.standard_normal((2, K, N), dtype=np.float32))
    c = fp8.quantize_from_float(w.cuda())
    q, scale = c["q"][1], c["scale"][1]
    assert q.is_contiguous()
    x = torch.from_numpy(rng.standard_normal((T, K), dtype=np.float32)).to(
        torch.bfloat16).cuda()
    route = fp8_route(T)
    before = (fp8_w8a8_matmul.launches, quantize_activations.launches,
              _by_body(fp8_w8a8_matmul, route))
    got = fp8_w8a8_matmul(x, c["q"], c["scale"], layer_idx=1)
    torch.cuda.synchronize()
    assert (fp8_w8a8_matmul.launches, quantize_activations.launches,
            _by_body(fp8_w8a8_matmul, route)) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    want = fp8_w8a8_matmul_ref(x, q, scale)
    _assert_rows_within(got, want, SAME_TOL)
    xq, act_scale = quantize_activations_e4m3(x)
    widened = torch.mm(xq.to(torch.bfloat16), q.to(torch.bfloat16),
                       out_dtype=torch.float32)
    _assert_rows_within(widened * act_scale * scale, want, SAME_TOL)
    with pytest.raises(ValueError, match="contiguous"):
        fp8_w8a8_matmul(x, q.mT.contiguous().mT, scale)
    with pytest.raises(ValueError, match="multiple of 128"):
        fp8_w8a8_matmul(x, q[:, :200].contiguous(), scale[:, :200])


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,N", [(1, 4160, 384), (40, 4160, 384),
                                   (200, 1024, 256), (130, 14336, 512)])
def test_fp8_bodies_and_splits_on_card(T, K, N):
    """The f16 wgmma body and the e4m3 mma.sync body at K 4160 (65 stages
    of 64 rows), N an odd multiple of 128, T below and above one token
    block, and the f16 body at every split of K that divides its stages up
    to 4 (the scales go into the pass that sums the partials): each
    against the plain version at SAME_TOL."""
    _card_or_skip()
    rng = np.random.default_rng(T + K + N)
    w = torch.from_numpy(rng.standard_normal((1, K, N), dtype=np.float32))
    c = fp8.quantize_from_float(w.cuda())
    x = torch.from_numpy(rng.standard_normal((T, K), dtype=np.float32)).to(
        torch.bfloat16).cuda()
    want = fp8_w8a8_matmul_ref(x, c["q"][0], c["scale"][0])
    for body in ("f16_wgmma", "e4m3_mma"):
        _assert_rows_within(fp8_w8a8_matmul(x, c["q"], c["scale"],
                                            layer_idx=0, body=body),
                            want, SAME_TOL)
    stages = K // 64
    for splits in (d for d in (1, 2, 3, 4) if stages % d == 0):
        got = fp8_w8a8_matmul(x, c["q"], c["scale"], layer_idx=0,
                              body="f16_wgmma", splits=splits)
        assert fp8_w8a8_matmul.last_plan["splits"] == splits
        _assert_rows_within(got, want, SAME_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [192, 256])
def test_fp8_wgmma_fragment_layout_on_card(K):
    """The FP8 product's wgmma body on a known weight, q[k, n] = (k + 3 n)
    mod 16, and one-hot activations, x[t, k] = 1 where k = t: each output
    is one product, so the kernel must equal the plain version bit for
    bit, and an e4m3 pair widened into the wrong k or column of the A
    fragment shows as a wrong value at its place. T = K: two to four
    token blocks, three or four 64-row stages."""
    _card_or_skip()
    N = 256
    k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    q = torch.from_numpy(((k + 3 * n) % 16).astype(np.float32)).cuda()
    c = {"q": q.to(torch.float8_e4m3fn)[None],
         "scale": torch.ones((1, 1, N), device="cuda")}
    x = torch.eye(K, dtype=torch.bfloat16).cuda()
    got = fp8_w8a8_matmul(x, c["q"], c["scale"], layer_idx=0,
                          body="f16_wgmma")
    want = fp8_w8a8_matmul_ref(x, c["q"][0], c["scale"][0])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# The page-gather probe (tools/probe_gather_bw.py)
# ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len,sequential", [(192, False), (192, True),
                                               (1, False), (1000, False)])
def test_gather_probe_equals_plain_on_card(kv_len, sequential):
    """The probe's kernel against its plain version at the probe's shapes
    (S 128, 8 kv heads, D 128, page 16, 4096 pages): equal, bit for bit
    (each row sum is exact in f64 on both sides, and the waves add up in
    f32 in the same order), with the launch counted; a page-sized kv
    length and one that spans eight waves."""
    from aphrodite_tpu_torch.tools import probe_gather_bw as probe

    _card_or_skip()
    old = probe.KV_LEN, os.environ.get("PROBE_SEQ")
    probe.KV_LEN = kv_len
    os.environ["PROBE_SEQ"] = "1" if sequential else "0"
    try:
        kv_lens, pages, kv, _ = probe.make_inputs("cuda", seed=kv_len)
    finally:
        probe.KV_LEN = old[0]
        if old[1] is None:
            del os.environ["PROBE_SEQ"]
        else:
            os.environ["PROBE_SEQ"] = old[1]
    before = probe.gather.launches
    got = probe.gather(kv_lens, pages, kv)
    torch.cuda.synchronize()
    assert probe.gather.launches == before + 1
    want = probe.ref_gather(kv_lens, pages, kv)
    assert got.shape == (probe.S // 8, 8, 128)
    assert torch.equal(got, want)
    assert want.abs().max() > 0
    with pytest.raises(ValueError, match="multiple of 8"):
        probe.gather(kv_lens[:12], pages[:12], kv)


# ----------------------------------------------------------------------
# The fused decode window as a CUDA graph (worker/model_runner.py)
# ----------------------------------------------------------------------

# Llama-3.1-8B's widths at two layers.
LLAMA_8B_2L = dict(
    architectures=["LlamaForCausalLM"], hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=2, num_attention_heads=32,
    num_key_value_heads=8, head_dim=128, vocab_size=128256,
    max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=500000.0,
    tie_word_embeddings=False, torch_dtype="bfloat16")
# One narrow layer and a vocabulary of 256.
TINY_CARD_LLAMA = dict(LLAMA_8B_2L, hidden_size=512, intermediate_size=1024,
                       num_hidden_layers=1, num_attention_heads=4,
                       num_key_value_heads=4, vocab_size=256)


def _dummy_runner(path, config, **kw):
    """The runner of an engine on dummy weights of `config`, bf16, 2048
    KV pages of 16 tokens, windows of 8 steps."""
    import json

    from aphrodite_tpu_torch import LLM

    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    llm = LLM(model=str(path), load_format="dummy", dtype="bfloat16",
              seed=0, block_size=PS, num_scheduler_steps=8,
              num_device_blocks_override=2048, skip_tokenizer_init=True,
              device="cuda", **kw)
    return llm.engine.runner


def _q6_k_params(runner, seed):
    """Replace the four projections of every layer with Q6_K-like
    unpacked containers (group 16): the decode body's DENSE form."""
    rng = np.random.default_rng(seed)
    lp, L = runner.params["layers"], runner.model.num_layers
    for name in ("wqkv", "wo", "w13", "down"):
        K, N = lp[name].shape[-2:]
        _, q, scale, zero = _q4_case(rng, L, K, N, 16, 1, "q6_k")
        lp[name] = {"q4": q, "scale": scale, "zero": zero}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gptq+fp8_e4m3", "q6_k"])
def test_graphed_window_equals_eager_on_card(kind, tmp_path):
    """A 2-layer model at 8B widths: the captured window's packed outputs
    and carry equal the eager window's bit for bit on the same cache,
    carry and tensors, and three replays in a row equal three eager
    windows. The window's int4 products take the decode body (packed, or
    the unpacked DENSE form). The wrappers count the warm-up's launches,
    none at capture and none in replays; a traced replay launches the
    port's kernels of an eager window by name and count, one decode
    attention kernel per layer and step among them."""
    from aphrodite_tpu_torch.tools.window_check import (WindowCase,
                                                        equal_windows,
                                                        kernel_base,
                                                        trace_launches)

    _card_or_skip()
    kw = (dict(quantization="gptq", kv_cache_dtype="fp8_e4m3")
          if kind != "q6_k" else {})
    runner = _dummy_runner(tmp_path, LLAMA_8B_2L, **kw)
    if kind == "q6_k":
        _q6_k_params(runner, 3)
        wrapper, body = int4_matmul, "dense_decode"
    else:
        wrapper, body = int4p_matmul, "groupwise_decode"
    case = WindowCase(runner, 8, [300, 17, 129, 1000, 64], W=8, seed=1)
    decode_bodies = wrapper.launches_by_body.get(body, 0)
    launched = wrapper.launches
    eager = case.windows("eager", 3)
    decode_per_window = (wrapper.launches_by_body.get(body, 0)
                         - decode_bodies) // 3
    assert decode_per_window > 0
    # Four products a layer and step, 2 layers, 8 steps.
    per_window = 4 * 2 * 8
    assert wrapper.launches == launched + 3 * per_window
    launched = wrapper.launches
    case.capture()  # a warm-up window, then the capture
    assert wrapper.launches == launched + per_window
    graphed = case.windows("graphed", 3)
    assert wrapper.launches == launched + per_window
    assert equal_windows(eager, graphed)
    assert not equal_windows(eager[:1], eager[1:2])
    (key,) = runner.graph_stats()
    stats = runner.graph_stats()[key]
    assert stats["captures"] == 1 and stats["replays"] >= 3
    trace = trace_launches(runner, key)
    assert trace["replay"] == trace["eager"]
    assert sum(n for name, n in trace["replay"].items()
               if kernel_base(name) == "paged_decode_kernel") == 2 * 8
    assert sum(n for name, n in trace["replay"].items()
               if kernel_base(name) == "decode_gemm_kernel") == \
        decode_per_window


@pytest.mark.cuda
def test_graphed_window_draws_fresh_noise_on_card(tmp_path):
    """A stochastic window: the final norm is zeroed, so every row's
    logits are 0 and top_k 5 leaves tokens 0-4 equally likely. Each row
    draws from its own key: a replay from the same carry draws the same
    tokens, the next window (the carry's step offset W on) other ones,
    and 40 windows in a row follow the uniform distribution over the five
    (each count within 5 standard deviations of its mean)."""
    from aphrodite_tpu_torch.tools.window_check import WindowCase

    _card_or_skip()
    runner = _dummy_runner(tmp_path, TINY_CARD_LLAMA)
    with torch.inference_mode():
        runner.params["final_norm"].zero_()
    S, W, n, windows = 8, 8, 8, 40
    case = WindowCase(runner, S, [40] * n, W=W, seed=2, temperature=1.0,
                      top_k=5, windows=windows)
    first, again = case.windows("graphed", 1), case.windows("graphed", 1)
    assert np.array_equal(first[0][0], again[0][0])
    run = case.windows("graphed", windows)
    assert np.array_equal(run[0][0], first[0][0])
    assert not np.array_equal(run[0][0], run[1][0])
    counts = np.zeros(runner.model.vocab_size, np.int64)
    for packed, _ in run:
        counts += np.bincount(packed[:W * S].reshape(W, S)[:, :n].ravel(),
                              minlength=runner.model.vocab_size)
    draws = windows * W * n
    assert counts[5:].sum() == 0
    mean, std = draws / 5, (draws * 0.2 * 0.8) ** 0.5
    assert (np.abs(counts[:5] - mean) < 5 * std).all(), counts[:5]


# Every history-free stage, a different mix a row (two rows with a
# sampler_priority; temperature_last on one).
def _history_free_params(n):
    from aphrodite_tpu_torch.common.sampling_params import SamplerID

    mixes = [
        dict(temperature=0.8, dynatemp_min=0.5, dynatemp_max=1.5),
        dict(temperature=1.0, top_k=50, top_p=0.9),
        dict(temperature=0.9, min_p=0.05, top_a=0.1),
        dict(temperature=1.1, tfs=0.95, eta_cutoff=2.0),
        dict(temperature=1.0, epsilon_cutoff=2.0, typical_p=0.9),
        dict(temperature=1.0, smoothing_factor=0.3, nsigma=2.0),
        dict(temperature=1.0, xtc_probability=0.5, xtc_threshold=0.001,
             skew=0.5),
        dict(temperature=0.7, top_k=100, min_p=0.02, temperature_last=True),
    ]
    out = [SamplingParams(max_tokens=64, **mixes[i % len(mixes)])
           for i in range(n)]
    out[0].sampler_priority = [SamplerID.MIN_P, SamplerID.TEMPERATURE,
                               SamplerID.TOP_P_TOP_K]
    return out


@pytest.mark.cuda
def test_graphed_window_with_every_history_free_stage_equals_eager_on_card(
        tmp_path):
    """A 2-layer model at 8B widths (vocabulary 128256) with every
    history-free stage on, a different mix a row: the graphed window's
    outputs and carry equal the eager window's bit for bit, two windows
    in a row, and its replays launch no host value (the capture holds)."""
    from aphrodite_tpu_torch.tools.window_check import (WindowCase,
                                                        equal_windows)

    _card_or_skip()
    runner = _dummy_runner(tmp_path, LLAMA_8B_2L, quantization="gptq",
                           kv_cache_dtype="fp8_e4m3")
    case = WindowCase(runner, 32, [300, 17, 129, 1000, 64, 40, 500, 8] * 2,
                      W=8, seed=5, params=_history_free_params(16))
    flags = case.flags
    assert all((flags.do_temperatures, flags.do_top_p_top_k, flags.do_min_p,
                flags.do_top_as, flags.do_tfss, flags.do_eta_cutoffs,
                flags.do_epsilon_cutoffs, flags.do_typical_ps,
                flags.do_quadratic, flags.do_xtc, flags.do_nsigmas,
                flags.do_skew)) and not flags.all_greedy
    eager = case.windows("eager", 2)
    graphed = case.windows("graphed", 2)
    assert equal_windows(eager, graphed)
    assert not equal_windows(eager[:1], eager[1:2])
    assert runner.has_window_graph(case.buf, flags, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 8])
def test_seeded_row_is_batch_independent_on_card(tmp_path, steps):
    """A seeded request draws the same tokens alone and inside a batch of
    other seeded, unseeded and greedy requests (another sequence bucket,
    chunked prefill mixed with decodes, windows of 8). The final norm is
    zeroed, so the logits are 0 whatever the batch and the draws are the
    noise's alone (the forward's bits depend on the batch's shapes)."""
    import json

    from aphrodite_tpu_torch import LLM

    _card_or_skip()
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(TINY_CARD_LLAMA, f)
    llm = LLM(model=str(tmp_path), load_format="dummy", dtype="bfloat16",
              seed=0, block_size=PS, num_scheduler_steps=steps,
              max_num_batched_tokens=64, num_device_blocks_override=512,
              skip_tokenizer_init=True, device="cuda")
    with torch.inference_mode():
        llm.engine.runner.params["final_norm"].zero_()
    kw = dict(temperature=1.0, top_k=40, xtc_probability=0.5,
              xtc_threshold=0.01, max_tokens=24, ignore_eos=True,
              detokenize=False)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in (20, 50, 90, 7)]

    def tokens(outs):
        return [o.outputs[0].token_ids for o in outs]

    seeded = SamplingParams(seed=1234, **kw)
    alone = tokens(llm.generate(prompt_token_ids=prompts[:1],
                                sampling_params=seeded))[0]
    batch = tokens(llm.generate(
        prompt_token_ids=prompts,
        sampling_params=[seeded, SamplingParams(seed=7, **kw),
                         SamplingParams(**kw),
                         SamplingParams(temperature=0.0, max_tokens=24,
                                        ignore_eos=True, detokenize=False)]))
    assert batch[0] == alone
    assert batch[1] != alone


@pytest.mark.cuda
def test_host_read_in_window_raises_under_capture_on_card(tmp_path,
                                                          monkeypatch):
    """A forward that reads a device value on the host runs eagerly in the
    warm-up window, and its capture raises: the window is not run
    eagerly instead, and no graph is kept."""
    from aphrodite_tpu_torch.tools.window_check import WindowCase

    _card_or_skip()
    runner = _dummy_runner(tmp_path, TINY_CARD_LLAMA)
    logits = runner.model.compute_logits

    def host_read(params, hidden):
        float(hidden.float().sum())
        return logits(params, hidden)

    monkeypatch.setattr(runner.model, "compute_logits", host_read)
    case = WindowCase(runner, 8, [40, 41], W=2, seed=3)
    case.graphed().numpy()  # the warm-up, eagerly
    replays = sum(s["replays"] for s in runner.graph_stats().values())
    with pytest.raises(RuntimeError, match="capturing the decode window"):
        case.graphed()
    assert not runner.has_window_graph(case.buf, case.flags, case.W)
    assert sum(s["replays"] for s in runner.graph_stats().values()) == \
        replays
    monkeypatch.setattr(runner.model, "compute_logits", logits)
    case.restore()
    assert case.eager().numpy().shape == (3 * 2 * 8,)


# Each built form of the decode body, at Llama-3.1-8B's down site (16
# strips of 256 columns: K split in 8, so the reduce pass runs): PACKED at
# groups 128 and 16, GROUPWISE, DENSE and DENSE_ROWS (G < 16), at T 1, 16,
# 32 and 48 (one tile of 8, 16 or 32 rows; two of 32, or one of 64 where
# the form takes it).
GRAPH_FORMS = [("packed", 128), ("packed", 16), ("groupwise", 32),
               ("dense", 16), ("dense", 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 32, 48])
@pytest.mark.parametrize("fmt,group", GRAPH_FORMS)
def test_decode_body_bits_over_graph_replays_on_card(fmt, group, T):
    """The decode body in a CUDA graph (its step-sum pass a programmatic
    dependent of the group-wise forms, and the split-K reduce): 200
    replays on fixed inputs, each equal bit for bit to the eager launch."""
    _card_or_skip()
    rng = np.random.default_rng(group * 100 + T)
    K, N = 14336, 4096
    if fmt == "packed":
        x, q, scale, zero = _int4_case(rng, 1, K, N, group, T)
        wrapper = int4p_matmul
        run = lambda: int4p_matmul(x, q, scale, zero, group,  # noqa: E731
                                   layer_idx=0, decode=True)
    else:
        x, q, scale, zero = _q4_case(rng, 1, K, N, group, T,
                                     "q8_0" if fmt == "groupwise" else "q6_k")
        wrapper = int4_matmul
        run = lambda: int4_matmul(x, q, scale, zero, group,  # noqa: E731
                                  layer_idx=0, body=fmt, decode=True)
    want = run()
    plan = wrapper.last_plan
    assert plan["splits"] > 1
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    for i in range(200):
        graph.replay()
        assert torch.equal(got, want), (i, plan)


# ----------------------------------------------------------------------
# Beam-search page copies (worker/model_runner.py _apply_block_copies)
# ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache_dtype", ["auto", "fp8_e4m3", "int8"])
def test_block_copies_equal_index_copy_on_card(kv_cache_dtype, tmp_path):
    """A beam fork's copy-on-write copies: every layer's page of each
    (src, dst) pair moves as raw bytes, equal byte for byte to a plain
    index_copy of the same pages, on bf16, E4M3 and int8 pages."""
    _card_or_skip()
    config = dict(TINY_CARD_LLAMA, num_hidden_layers=3)
    runner = _dummy_runner(tmp_path, config, kv_cache_dtype=kv_cache_dtype)
    raw = runner.kv_cache.view(torch.uint8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    raw.copy_(torch.randint(0, 256, raw.shape, dtype=torch.uint8,
                            device="cuda", generator=gen))
    pairs = [(3, 700), (3, 701), (1500, 9), (42, 43), (2047, 0)]
    src = torch.tensor([p[0] for p in pairs], device="cuda")
    dst = torch.tensor([p[1] for p in pairs], device="cuda")
    want = raw.clone()
    want.index_copy_(1, dst, raw.index_select(1, src))
    runner._apply_block_copies(pairs)
    torch.cuda.synchronize()
    assert torch.equal(raw, want)
    assert runner.kv_cache.dtype == {"auto": torch.bfloat16,
                                     "fp8_e4m3": torch.float8_e4m3fn,
                                     "int8": torch.int8}[kv_cache_dtype]


# ----------------------------------------------------------------------
# The MoE grouped expert product (ops/moe.py, plain PyTorch on the card)
# ----------------------------------------------------------------------

# The five MoE paths' expert widths: (H, F, E, k, routing).
MOE_WIDTHS = {
    "qwen3-30b-a3b": (2048, 768, 128, 8, "topk renormalized"),
    "mixtral-8x7b": (4096, 14336, 8, 2, "topk renormalized"),
    "qwen1.5-moe-a2.7b": (2048, 1408, 60, 4, "topk"),
    "olmoe-1b-7b": (2048, 1024, 64, 8, "topk"),
    "phi-3.5-moe": (4096, 6400, 16, 2, "sparsemixer"),
}
# Row by row against the plain per-token product (f32, silu(gate) * up
# rounded to bf16, the result not rounded): the forms round their result
# to bf16, up to 2^-8 of a value; 2^-7 allows that twice.
MOE_ROW_TOL = 2.0**-7


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MOE_WIDTHS))
def test_moe_forms_match_plain_product_on_card(name):
    """At each MoE path's widths, bf16 experts and x from a seed, routed
    by the path's router kind: the capacity form at 32 tokens (a decode
    bucket) and the loop form at 2048 (a prefill step), each against
    moe.plain_expert_mlp within MOE_ROW_TOL of a row; the capacity form
    captured into a CUDA graph and replayed on new x equals it eagerly
    bit for bit."""
    from aphrodite_tpu_torch.ops import moe

    _card_or_skip()
    H, F, E, k, routing = MOE_WIDTHS[name]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(torch.bfloat16)

    w1, w3 = randn(E, H, F, std=H**-0.5), randn(E, H, F, std=H**-0.5)
    w2 = randn(E, F, H, std=F**-0.5)
    router = randn(H, E, std=H**-0.5)

    def route(x):
        logits = moe.router_logits(x, router)
        if routing == "sparsemixer":
            return moe.sparsemixer_routing(logits)
        return moe.topk_routing(logits, k, routing.endswith("renormalized"))

    for T, form in ((32, moe.capacity_expert_mlp),
                    (2048, moe.loop_expert_mlp)):
        x = randn(T, H)
        weights, ids = route(x)
        got = form(x, w1, w3, w2, weights, ids)
        want = moe.plain_expert_mlp(x, w1, w3, w2, weights, ids)
        assert got.dtype == torch.bfloat16 and bool(got.isfinite().all())
        err = (got.float() - want).abs().amax(-1)
        assert bool((err <= MOE_ROW_TOL * want.abs().amax(-1)).all()), (
            form.__name__, float((err / want.abs().amax(-1)).max()))
    x = randn(32, H)
    static = x.clone()
    weights, ids = route(static)
    moe.capacity_expert_mlp(static, w1, w3, w2, weights, ids)  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        w_g, ids_g = route(static)
        out = moe.capacity_expert_mlp(static, w1, w3, w2, w_g, ids_g)
    for _ in range(2):
        x = randn(32, H)
        static.copy_(x)
        graph.replay()
        weights, ids = route(x)
        assert torch.equal(out, moe.capacity_expert_mlp(x, w1, w3, w2,
                                                        weights, ids))
