"""The port's engine with every sampler option it serves against the JAX
engine, on the CPU: both run the same tiny float32 checkpoint.

Greedy tokens must be equal under penalties, DRY, no-repeat-ngram,
min_tokens, banned tokens, host logits processors and guided decoding,
with one-step and 8-step scheduling (the history stages take the
single-step path in both packages); prompt logprobs and perplexity agree
within 1e-4. A seeded request draws the same tokens alone and inside a
batch.
"""

import json
import re

import numpy as np
import pytest

from aphrodite_tpu import LLM as JaxLLM
from aphrodite_tpu import SamplingParams as JaxSamplingParams
from aphrodite_tpu.tools.perplexity import \
    evaluate_perplexity as jax_perplexity
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.tools.perplexity import evaluate_perplexity

PROMPTS = ["the quick brown fox", "hello world, this is",
           "one two three four five six seven eight nine ten one two"]
# A 16-token budget splits the longest prompt into chunks mixed with
# decodes.
ENGINE_KW = dict(dtype="float32", max_num_seqs=4, max_num_batched_tokens=16,
                 num_device_blocks_override=128, block_size=8)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tests.utils import make_tiny_llama_checkpoint

    path = tmp_path_factory.mktemp("tiny_llama_sampling")
    make_tiny_llama_checkpoint(str(path))
    return str(path)


@pytest.fixture(scope="module")
def engines(model_dir):
    """(JAX LLM, port LLM) by num_scheduler_steps, made on first use."""
    made = {}

    def get(steps):
        if steps not in made:
            kw = dict(ENGINE_KW, num_scheduler_steps=steps)
            made[steps] = (JaxLLM(model=model_dir, **kw),
                           LLM(model=model_dir, device="cpu", **kw))
        return made[steps]

    return get


def _tokens(outs):
    return [o.outputs[0].token_ids for o in outs]


GREEDY_CASES = {
    "penalties": dict(repetition_penalty=1.3, frequency_penalty=0.5,
                      presence_penalty=0.4),
    "dry": dict(dry_multiplier=0.8, dry_allowed_length=1,
                dry_sequence_breaker_ids=[11]),
    "no_repeat_ngram": dict(no_repeat_ngram_size=2),
    "min_tokens": dict(min_tokens=10, stop_token_ids=[5, 6]),
    "banned_tokens": dict(custom_token_bans=[5, 6, 7, 40]),
    "all": dict(repetition_penalty=1.2, dry_multiplier=0.5,
                no_repeat_ngram_size=3, min_tokens=4,
                custom_token_bans=[9]),
}


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_tokens_match_jax(engines, case, steps):
    jax_llm, llm = engines(steps)
    kw = dict(temperature=0.0, max_tokens=16, **GREEDY_CASES[case])
    want = _tokens(jax_llm.generate(PROMPTS, JaxSamplingParams(**kw)))
    got = _tokens(llm.generate(PROMPTS, SamplingParams(**kw)))
    assert got == want
    plain = _tokens(llm.generate(PROMPTS, SamplingParams(
        temperature=0.0, max_tokens=16)))
    if case != "min_tokens":
        # The stage changed the tokens of some row.
        assert got != plain
    if "custom_token_bans" in kw:
        assert not set(kw["custom_token_bans"]) & {t for r in got for t in r}
    if case == "min_tokens":
        assert all(len(r) >= 10 for r in got)


@pytest.mark.parametrize("num", [1, 3])
def test_prompt_logprobs_match_jax(engines, num):
    """Every prompt position's entry: the target's logprob within 1e-4,
    ranks and the top ids equal; the longest prompt is prefilled in
    chunks."""
    jax_llm, llm = engines(8)
    kw = dict(temperature=0.0, max_tokens=3, prompt_logprobs=num)
    want = jax_llm.generate(PROMPTS, JaxSamplingParams(**kw))
    got = llm.generate(PROMPTS, SamplingParams(**kw))
    assert _tokens(got) == _tokens(want)
    for g, w in zip(got, want):
        assert len(g.prompt_logprobs) == len(w.prompt_logprobs) == len(
            g.prompt_token_ids)
        assert g.prompt_logprobs[0] is None and w.prompt_logprobs[0] is None
        for ge, we in zip(g.prompt_logprobs[1:], w.prompt_logprobs[1:]):
            assert list(ge) == list(we)
            for tid in we:
                assert ge[tid].rank == we[tid].rank
                assert abs(ge[tid].logprob - we[tid].logprob) <= 1e-4


def _force_two(out_ids, logits):
    """Allow two tokens, the second's logit by the history's length."""
    out = np.full_like(logits, -1e9)
    out[5] = 1.0
    out[6] = 0.5 + 0.2 * len(out_ids)
    return out


def _by_prompt(prompt_ids, out_ids, logits):
    """A token chosen by the prompt's length and the history's."""
    out = np.full_like(logits, -1e9)
    out[(len(prompt_ids) + 3 * len(out_ids)) % 50 + 3] = 0.0
    return out


@pytest.mark.parametrize("steps", [1, 8])
def test_logits_processors_match_jax(engines, steps):
    """A 2-argument and a 3-argument processor on two rows, a row without:
    the same tokens in both packages, and the processors' tokens."""
    jax_llm, llm = engines(steps)
    outs = {}
    for name, pkg, SP in (("jax", jax_llm, JaxSamplingParams),
                          ("port", llm, SamplingParams)):
        sps = [SP(temperature=0.0, max_tokens=6, ignore_eos=True,
                  logits_processors=[_force_two]),
               SP(temperature=0.0, max_tokens=6, ignore_eos=True,
                  logits_processors=[_by_prompt]),
               SP(temperature=0.0, max_tokens=6, ignore_eos=True)]
        outs[name] = _tokens(pkg.generate(PROMPTS, sps))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == [5, 5, 5, 6, 6, 6]
    n = len(llm.get_tokenizer().encode(PROMPTS[1]))
    assert outs["port"][1] == [(n + 3 * k) % 50 + 3 for k in range(6)]


GUIDED_CASES = {
    "choice": (dict(guided_choice=["yes", "no", "maybe"]),
               lambda text: text in ("yes", "no", "maybe")),
    "regex": (dict(guided_regex=r"[0-9]{3}-[0-9]{4}"),
              lambda text: re.fullmatch(r"[0-9]{3}-[0-9]{4}", text)),
    "json_schema": (dict(guided_json={
        "type": "object", "properties": {"ok": {"type": "boolean"}},
        "required": ["ok"]}),
        lambda text: isinstance(json.loads(text)["ok"], bool)),
    "json_object": (dict(guided_json_object=True),
                    lambda text: isinstance(json.loads(text), dict)),
}


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("case", sorted(GUIDED_CASES))
def test_guided_outputs_match_jax(engines, case, steps):
    """tests/test_guided.py's greedy cases: the same text and tokens in
    both packages, and the text in the spec's language."""
    kw, check = GUIDED_CASES[case]
    jax_llm, llm = engines(steps)
    sp = dict(temperature=0.0, max_tokens=32, **kw)
    prompts = ["answer:", "result: "]
    want = jax_llm.generate(prompts, JaxSamplingParams(**sp))
    got = llm.generate(prompts, SamplingParams(**sp))
    assert _tokens(got) == _tokens(want)
    for g, w in zip(got, want):
        assert g.outputs[0].text == w.outputs[0].text
        if g.outputs[0].finish_reason == "stop":
            assert check(g.outputs[0].text), g.outputs[0].text


def test_perplexity_matches_jax(engines):
    texts = ["the quick brown fox jumps over the lazy dog",
             "hello world, this is a tiny tokenizer"]
    jax_llm, llm = engines(1)
    want = jax_perplexity(jax_llm, texts)
    got = evaluate_perplexity(llm, texts)
    assert abs(got - want) <= 1e-4 * want


@pytest.mark.parametrize("steps", [1, 8])
def test_seeded_request_is_batch_independent(engines, steps):
    """A seeded request draws the same tokens alone and inside a batch
    (other seeded and unseeded rows around it, another bucket), with a
    stage that reads its coin (XTC) on; another seed draws others."""
    _, llm = engines(steps)
    kw = dict(temperature=1.0, top_k=40, xtc_probability=0.5,
              xtc_threshold=0.05, max_tokens=20, ignore_eos=True)
    seeded = SamplingParams(seed=1234, **kw)
    alone = _tokens(llm.generate(PROMPTS[:1], seeded))[0]
    assert _tokens(llm.generate(PROMPTS[:1], seeded))[0] == alone
    batch = llm.generate(
        PROMPTS + ["one two", "the lazy dog"],
        [seeded, SamplingParams(seed=7, **kw), SamplingParams(**kw),
         SamplingParams(temperature=0.0, max_tokens=20, ignore_eos=True),
         SamplingParams(seed=99, **kw)])
    assert _tokens(batch)[0] == alone
    other = _tokens(llm.generate(PROMPTS[:1],
                                 SamplingParams(seed=4321, **kw)))[0]
    assert other != alone
