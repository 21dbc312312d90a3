"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Without one every test here skips: a CUDA kernel has no CPU or
interpret mode. This file imports neither JAX nor the JAX package, so on
the card it runs without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    paged_decode_attention, ref_paged_decode_attention)
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
