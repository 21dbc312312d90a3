"""Beam search in the PyTorch port against the JAX engine, on the CPU.

The same tiny checkpoint through the JAX ``LLM`` and the port's
(device "cpu", float32): every hypothesis's token ids equal and its
cumulative logprob within 1e-5, over beam widths, n, length penalties and
early stopping. The tokenizer's EOS is set to a token the beams of the
first prompt reach, so that some hypotheses end early and the length
penalty and early stopping decide between hypotheses of unequal length.
"""

import json
import os
import shutil

import pytest

from aphrodite_tpu import LLM as JaxLLM
from aphrodite_tpu import SamplingParams as JaxSamplingParams
from aphrodite_tpu_torch import LLM, SamplingParams

PROMPTS = ["the quick brown", "hello world"]
# Pages of 32 tokens: no beam here reaches a page boundary, where the
# JAX block manager lets beams share the page they write
# (test_beam_search_across_page_boundaries).
ENGINE_KW = dict(dtype="float32", max_num_seqs=8,
                 num_device_blocks_override=256, block_size=32)
# A token that the first prompt's beams choose at their second step on
# the tiny checkpoint of seed 0: the EOS of the tokenizer below.
EOS_ID = 106
CUM_TOL = 1e-5


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from tests.utils import make_tiny_llama_checkpoint

    model = str(tmp_path_factory.mktemp("tiny_llama_beam_torch"))
    make_tiny_llama_checkpoint(model)
    tok = str(tmp_path_factory.mktemp("tiny_tokenizer_eos"))
    shutil.copy(os.path.join(model, "tokenizer.json"), tok)
    with open(os.path.join(model, "tokenizer.json")) as f:
        vocab = json.load(f)["model"]["vocab"]
    eos = next(t for t, i in vocab.items() if i == EOS_ID)
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        with open(os.path.join(model, name)) as f:
            cfg = json.load(f)
        cfg["eos_token"] = eos
        with open(os.path.join(tok, name), "w") as f:
            json.dump(cfg, f)
    return model, tok


@pytest.fixture(scope="module")
def engines(dirs):
    model, tok = dirs
    jax_llm = JaxLLM(model=model, tokenizer=tok, **ENGINE_KW)
    llm = LLM(model=model, tokenizer=tok, device="cpu", **ENGINE_KW)
    assert llm.get_tokenizer().eos_token_id == EOS_ID
    return jax_llm, llm


def _same_hypotheses(got, want):
    assert len(got.outputs) == len(want.outputs)
    for g, w in zip(got.outputs, want.outputs):
        assert g.token_ids == w.token_ids
        assert abs(g.cumulative_logprob - w.cumulative_logprob) <= CUM_TOL
        assert g.finish_reason == w.finish_reason
        assert g.text == w.text


@pytest.mark.parametrize("early_stopping", [True, False])
@pytest.mark.parametrize("length_penalty", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("best_of", [2, 4])
def test_beam_hypotheses_match_jax(engines, best_of, n, length_penalty,
                                   early_stopping):
    jax_llm, llm = engines
    kw = dict(use_beam_search=True, best_of=best_of, n=n, temperature=0.0,
              max_tokens=8, length_penalty=length_penalty,
              early_stopping=early_stopping)
    want = jax_llm.generate(PROMPTS, JaxSamplingParams(**kw))
    got = llm.generate(PROMPTS, SamplingParams(**kw))
    for g, w in zip(got, want):
        _same_hypotheses(g, w)


def test_beam_hypotheses_end_early_at_eos(engines):
    """The tokenizer's EOS makes hypotheses of unequal length: the length
    penalty orders them, as in the JAX engine (below 1 it favours the
    short ones)."""
    jax_llm, llm = engines
    kw = dict(use_beam_search=True, best_of=4, n=4, temperature=0.0,
              max_tokens=8, length_penalty=0.5)
    want = jax_llm.generate(PROMPTS[:1], JaxSamplingParams(**kw))[0]
    got = llm.generate(PROMPTS[:1], SamplingParams(**kw))[0]
    _same_hypotheses(got, want)
    assert len({len(c.token_ids) for c in got.outputs}) > 1
    assert "stop" in {c.finish_reason for c in got.outputs}


def test_beam_beside_greedy_rows(engines):
    """A beam request in one batch with greedy ones: the beams match the
    JAX engine's in the same batch, and the greedy rows equal the same
    requests run alone."""
    jax_llm, llm = engines
    beam = dict(use_beam_search=True, best_of=3, n=1, temperature=0.0,
                max_tokens=6, ignore_eos=True)
    greedy = dict(temperature=0.0, max_tokens=6, ignore_eos=True)
    prompts = ["one two three", *PROMPTS]
    want = jax_llm.generate(prompts, [JaxSamplingParams(**beam),
                                      JaxSamplingParams(**greedy),
                                      JaxSamplingParams(**greedy)])
    got = llm.generate(prompts, [SamplingParams(**beam),
                                 SamplingParams(**greedy),
                                 SamplingParams(**greedy)])
    alone = llm.generate(PROMPTS, SamplingParams(**greedy))
    _same_hypotheses(got[0], want[0])
    for g, w, a in zip(got[1:], want[1:], alone):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
        assert g.outputs[0].token_ids == a.outputs[0].token_ids


def test_beam_search_across_page_boundaries(dirs):
    """Beams that cross page boundaries, with and without the slots the
    scheduler reserves ahead for decode windows: the port's hypotheses do
    not depend on the page size or the scheduler steps (each beam writes
    its tokens into pages of its own) and equal the JAX engine's at a page
    size that no beam crosses. The JAX block manager unshares only a
    table's last page, and only when it is not full: at 8-token pages its
    beams write into one shared slot, and its hypotheses change."""
    model, tok = dirs
    kw = dict(use_beam_search=True, best_of=4, n=2, temperature=0.0,
              max_tokens=20, ignore_eos=True)
    prompts = ["the quick brown fox jumps", "hello world"]

    def ids(outs):
        return [[c.token_ids for c in o.outputs] for o in outs]

    engine_kw = dict(ENGINE_KW, tokenizer=tok)
    want = JaxLLM(model=model, **dict(engine_kw, block_size=64)).generate(
        prompts, JaxSamplingParams(**kw))
    for block_size, steps in ((64, 1), (8, 1), (8, 8)):
        llm = LLM(model=model, device="cpu", **dict(
            engine_kw, block_size=block_size, num_scheduler_steps=steps))
        got = llm.generate(prompts, SamplingParams(**kw))
        for g, w in zip(got, want):
            _same_hypotheses(g, w)
    jax_at_8 = JaxLLM(model=model, **dict(engine_kw, block_size=8))
    assert ids(jax_at_8.generate(prompts, JaxSamplingParams(**kw))) != \
        ids(want)
