"""The PyTorch port end to end against the JAX engine, and its sampler
against the JAX sampler, on the CPU.

End to end: port ``LLM.generate`` (device "cpu", float32) and
the JAX ``LLM.generate`` on the same tiny checkpoint must give identical
greedy tokens, with chunked prefill and multi-step decode windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu import LLM as JaxLLM
from aphrodite_tpu import SamplingParams as JaxSamplingParams
from aphrodite_tpu.sampling.metadata import \
    build_sampling_tensors as jax_build_tensors
from aphrodite_tpu.sampling.metadata import SamplerInputRow as JaxRow
from aphrodite_tpu.sampling.sampler import sample as jax_sample
from aphrodite_tpu.sampling.sampler import \
    shaped_logprobs as jax_shaped_logprobs
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.sampling.metadata import (SamplerInputRow,
                                                   build_sampling_tensors)
from aphrodite_tpu_torch.sampling.sampler import (sample, shaped_logprobs,
                                                  tensors_to_device)

PROMPTS = [
    "the quick brown fox",
    "hello world, this is",
    "one two three four five",
]
# tests/test_engine.py's chunked-prefill settings: a 16-token budget
# splits the prompts into chunks mixed with decodes.
ENGINE_KW = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
                 num_device_blocks_override=128, block_size=8)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tests.utils import make_tiny_llama_checkpoint

    path = tmp_path_factory.mktemp("tiny_llama_torch")
    make_tiny_llama_checkpoint(str(path))
    return str(path)


@pytest.mark.parametrize("steps", [1, 4])
def test_greedy_tokens_match_jax_engine(model_dir, steps):
    kw = dict(ENGINE_KW, num_scheduler_steps=steps)
    want = JaxLLM(model=model_dir, **kw).generate(
        PROMPTS, JaxSamplingParams(temperature=0.0, max_tokens=12,
                                   ignore_eos=True))
    got = LLM(model=model_dir, device="cpu", **kw).generate(
        PROMPTS, SamplingParams(temperature=0.0, max_tokens=12,
                                ignore_eos=True))
    for g, w in zip(got, want):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
        assert g.outputs[0].text == w.outputs[0].text
        assert g.outputs[0].finish_reason == "length"


def test_greedy_rows_unaffected_by_sampled_rows(model_dir):
    llm = LLM(model=model_dir, device="cpu", num_scheduler_steps=4,
              **ENGINE_KW)
    greedy = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    sampled = SamplingParams(temperature=0.8, top_p=0.9, top_k=20,
                             min_p=0.05, max_tokens=10, ignore_eos=True,
                             logprobs=2)
    alone = llm.generate(PROMPTS, greedy)
    mixed = llm.generate(PROMPTS, [greedy, sampled, greedy])
    for i in (0, 2):
        assert mixed[i].outputs[0].token_ids == alone[i].outputs[0].token_ids
    out = mixed[1].outputs[0]
    assert len(out.token_ids) == 10 and len(out.logprobs) == 10
    assert all(0 <= t < 256 for t in out.token_ids)


def test_prefix_caching_repeats_tokens(model_dir):
    llm = LLM(model=model_dir, device="cpu", enable_prefix_caching=True,
              **ENGINE_KW)
    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)
    prompt = "the quick brown fox jumps over the lazy dog"
    first = llm.generate([prompt], sp)[0].outputs[0].token_ids
    second = llm.generate([prompt], sp)[0].outputs[0].token_ids
    assert first == second
    assert llm.engine.scheduler.block_manager.get_prefix_cache_hit_rate() > 0


def test_cuda_device_without_card_raises(model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLM(model=model_dir, **ENGINE_KW)


def test_unported_request_features_raise(model_dir):
    llm = LLM(model=model_dir, device="cpu", **ENGINE_KW)
    with pytest.raises(NotImplementedError, match="beam"):
        llm.generate(["hi"], SamplingParams(use_beam_search=True, best_of=2,
                                            temperature=0.0, max_tokens=4))
    # Beam search is the one request feature left: the sampler's stages,
    # prompt logprobs, logits processors and guided decoding run.
    out = llm.generate(["hi"], SamplingParams(
        presence_penalty=0.5, prompt_logprobs=2, guided_regex="[ab]+",
        logits_processors=[lambda ids, row: row], max_tokens=4))
    assert len(out[0].prompt_logprobs) == len(out[0].prompt_token_ids)
    # The engine recovers for later requests.
    out = llm.generate(["hi"], SamplingParams(temperature=0.0, max_tokens=3))
    assert len(out[0].outputs[0].token_ids) == 3


# ----------------------------------------------------------------------
# Sampler
# ----------------------------------------------------------------------

SAMPLER_CASES = {
    "greedy": dict(temperature=0.0),
    "temperature": dict(temperature=0.7),
    "low_temperature": dict(temperature=0.05),
    "top_k_top_p": dict(temperature=1.0, top_k=7, top_p=0.8),
    "min_p": dict(temperature=1.3, min_p=0.1),
    "temperature_last": dict(temperature=0.6, top_p=0.7, min_p=0.05,
                             temperature_last=True),
    "dynatemp": dict(temperature=1.0, dynatemp_min=0.5, dynatemp_max=1.5),
}


def _tensors(case, vocab, S=4):
    kw = SAMPLER_CASES[case]
    rows = [SamplerInputRow(params=SamplingParams(logprobs=3, **kw),
                            token_ids=[1, 2], prompt_len=2, generated_len=0,
                            seed=i) for i in range(3)]
    jrows = [JaxRow(params=JaxSamplingParams(logprobs=3, **kw),
                    token_ids=[1, 2], prompt_len=2, generated_len=0, seed=i)
             for i in range(3)]
    t, flags, _, _ = build_sampling_tensors(rows, S, vocab)
    jt, jflags, _, _ = jax_build_tensors(jrows, S, vocab)
    assert tuple(flags) == tuple(jflags)
    return tensors_to_device(t, torch.device("cpu")), flags, type(jt)(*map(jnp.asarray, jt)), jflags


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(case):
    vocab = 64
    logits = np.random.default_rng(1).standard_normal((4, vocab)).astype(
        np.float32) * 3
    t, flags, jt, jflags = _tensors(case, vocab)
    got = shaped_logprobs(torch.from_numpy(logits), t, flags).numpy()
    want = np.asarray(jax_shaped_logprobs(jnp.asarray(logits), jt, jflags))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5,
                               atol=1e-5)
    out = sample(torch.from_numpy(logits), t, flags)
    jout = jax_sample(jnp.asarray(logits), jt, jflags)
    np.testing.assert_allclose(out.topk_logprobs.numpy(),
                               np.asarray(jout.topk_logprobs), rtol=1e-5,
                               atol=1e-5)
    # Ids of finite top-k entries match; among -inf ties (tokens a
    # filter removed) the order is arbitrary.
    kept = np.isfinite(np.asarray(jout.topk_logprobs))
    np.testing.assert_array_equal(out.topk_ids.numpy()[kept],
                                  np.asarray(jout.topk_ids)[kept])
    if flags.all_greedy:
        # Greedy rows: identical tokens, logprobs and ranks.
        np.testing.assert_array_equal(out.sampled.numpy(),
                                      np.asarray(jout.sampled))
        np.testing.assert_array_equal(out.sampled_rank.numpy(),
                                      np.asarray(jout.sampled_rank))
        np.testing.assert_allclose(out.sampled_logprob.numpy(),
                                   np.asarray(jout.sampled_logprob),
                                   rtol=1e-5, atol=1e-5)
    else:
        # Random rows draw other noise than threefry: the sampled token
        # must be one the shaped distribution allows, with its logprob.
        tok = out.sampled.numpy()
        lp = got[np.arange(4), tok]
        assert np.isfinite(lp).all()
        np.testing.assert_allclose(out.sampled_logprob.numpy(), lp)
        np.testing.assert_array_equal(
            out.sampled_rank.numpy(), (got > lp[:, None]).sum(-1) + 1)


def test_gumbel_sampling_follows_the_distribution():
    """Empirical token frequencies of a stochastic row against its
    shaped probabilities: 40k draws, 3-sigma bound per token."""
    vocab, S, calls = 6, 4000, 10
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]]).repeat(S, 1)
    counts = np.zeros(vocab)
    for call in range(calls):
        # Each row's stream is its key's: a seed a row, a step a call.
        rows = [SamplerInputRow(params=SamplingParams(temperature=1.0),
                                token_ids=[1], prompt_len=1,
                                generated_len=call, seed=i)
                for i in range(S)]
        t, flags, _, _ = build_sampling_tensors(rows, S, vocab)
        t = tensors_to_device(t, torch.device("cpu"))
        toks = sample(logits, t, flags).sampled.numpy()
        counts += np.bincount(toks, minlength=vocab)
    n = S * calls
    probs = torch.softmax(logits[0], -1).numpy()
    sigma = np.sqrt(probs * (1 - probs) / n)
    assert (np.abs(counts / n - probs) <= 3 * sigma + 1e-4).all(), (
        counts / n, probs)
