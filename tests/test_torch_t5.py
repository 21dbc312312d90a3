"""T5 / Flan-T5 in the port against the JAX package, on the CPU.

Tiny checkpoints in transformers' layout (2 + 2 layers, 2 heads of
head_dim 64, 8 buckets up to distance 32, weights drawn from a seed so
that the greedy tokens vary), gated-gelu with a tied head and relu with an
untied one, go through both packages: the config answers, the host trees
(byte for byte), the encoder pass's cross pages, the decoder's prefill and
mixed steps in f32 (1e-4 of a row), its pure-decode step (which the port
sends to the decode kernel's T5 bias with q rounded to bf16, the JAX
package's kernel branch) at twice the floor that rounding sets, and greedy
tokens of ``LLM.generate`` at one and eight scheduler steps, with and
without ``decoder_prompt_token_ids``. The floor is measured on the JAX
package itself: its forward with the kernel branch (the Pallas kernel
under the interpreter) against its dense branch on the same inputs.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aphrodite_tpu.ops.decode_attention as jax_decode_mod
import aphrodite_tpu_torch.models.t5 as t5_mod
from aphrodite_tpu import LLM as JaxLLM
from aphrodite_tpu import SamplingParams as JaxSamplingParams
from aphrodite_tpu.common.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader.weights import \
    load_hf_params_to_host as jax_load_hf
from aphrodite_tpu.models.interface import ForwardBatch as JaxBatch
from aphrodite_tpu.models.t5 import T5ForConditionalGeneration as JaxT5
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (load_hf_params_to_host,
                                                params_from_jax)
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.models.registry import get_model_class
from tests.test_torch_falcon import compare_trees

VOCAB = 256
PS = 8  # page size (the JAX decode kernel takes multiples of 8)
NUM_PAGES = 24  # + one trash page
PPS = 4  # pages per sequence
ROW_TOL = 1e-4
# Published configs (google/flan-t5-xxl, google-t5/t5-small config.json).
PUBLISHED = {
    "flan-t5-xxl": dict(architectures=["T5ForConditionalGeneration"],
                        d_model=4096, d_ff=10240, d_kv=64, num_heads=64,
                        num_layers=24, num_decoder_layers=24,
                        feed_forward_proj="gated-gelu",
                        tie_word_embeddings=False, vocab_size=32128,
                        relative_attention_num_buckets=32,
                        relative_attention_max_distance=128, n_positions=512,
                        decoder_start_token_id=0),
    "t5-small": dict(architectures=["T5ForConditionalGeneration"],
                     d_model=512, d_ff=2048, d_kv=64, num_heads=8,
                     num_layers=6, feed_forward_proj="relu",
                     vocab_size=32128, relative_attention_num_buckets=32,
                     n_positions=512, decoder_start_token_id=0),
}
STYLES = {"gated_tied": (True, True), "relu_untied": (False, False)}


def write_t5(path, gated: bool, tie: bool, seed: int = 0) -> str:
    """A tiny T5 checkpoint as transformers saves one (its tensor names,
    [out, in] Linear weights, config.json keys), the weights drawn from the
    seed with numpy (norms near one, each matrix at std 1/sqrt(its last
    dim), so that its logits are not flat). Written directly: importing
    transformers' T5 classes takes some 15 s."""
    from safetensors.numpy import save_file

    cfg = dict(architectures=["T5ForConditionalGeneration"],
               model_type="t5", vocab_size=VOCAB, d_model=64, d_kv=64,
               d_ff=128, num_layers=2, num_decoder_layers=2, num_heads=2,
               relative_attention_num_buckets=8,
               relative_attention_max_distance=32, layer_norm_epsilon=1e-6,
               feed_forward_proj="gated-gelu" if gated else "relu",
               tie_word_embeddings=tie, decoder_start_token_id=0,
               pad_token_id=0, eos_token_id=1, n_positions=512,
               torch_dtype="float32")
    rng = np.random.default_rng(seed)
    D, inner, F = 64, 128, 128

    def w(rows, cols):
        return (rng.standard_normal((rows, cols))
                * cols**-0.5).astype(np.float32)

    def norm():
        return (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    t = {"shared.weight": w(VOCAB, D)}
    for stack in ("encoder", "decoder"):
        t[f"{stack}.final_layer_norm.weight"] = norm()
        t[f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias."
          "weight"] = w(8, 2)
        for i in range(2):
            b = f"{stack}.block.{i}.layer."
            attn = ["0.SelfAttention"] + (["1.EncDecAttention"]
                                          if stack == "decoder" else [])
            for a in attn:
                for n in "qkv":
                    t[f"{b}{a}.{n}.weight"] = w(inner, D)
                t[f"{b}{a}.o.weight"] = w(D, inner)
                t[f"{b}{a[0]}.layer_norm.weight"] = norm()
            ff = "2" if stack == "decoder" else "1"
            for n in (("wi_0", "wi_1") if gated else ("wi",)):
                t[f"{b}{ff}.DenseReluDense.{n}.weight"] = w(F, D)
            t[f"{b}{ff}.DenseReluDense.wo.weight"] = w(D, F)
            t[f"{b}{ff}.layer_norm.weight"] = norm()
    if not tie:
        t["lm_head.weight"] = w(VOCAB, D)
    save_file(t, str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return {style: write_t5(tmp_path_factory.mktemp(style), *flags, seed=3)
            for style, flags in STYLES.items()}


def _models(model_dir):
    jax_model = JaxT5(JaxModelConfig(model=model_dir, dtype="float32"))
    config = ModelConfig(model=model_dir, dtype="float32")
    return jax_model, get_model_class(config)(config)


def _params(jax_model, model_dir):
    host = jax_load_hf(jax_model, model_dir)
    return (jax.tree.map(jnp.asarray, host),
            params_from_jax(jax.tree.map(np.asarray, host)))


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_config_and_model_answers_match_jax(name):
    """The accessors both ModelConfigs share, and what each model reads
    from the config (the encoder's and decoder's depths among them)."""
    hf = PUBLISHED[name]
    jax_cfg = JaxModelConfig(model="unused", dtype="float32",
                             hf_config=dict(hf))
    cfg = ModelConfig(model="unused", dtype="float32", hf_config=dict(hf))
    for accessor in ("get_hidden_size", "get_num_layers",
                     "get_num_attention_heads", "get_total_num_kv_heads",
                     "get_head_size", "get_vocab_size"):
        assert getattr(cfg, accessor)() == getattr(jax_cfg, accessor)(), \
            accessor
    assert cfg.max_model_len == jax_cfg.max_model_len == 512
    jax_model, model = JaxT5(jax_cfg), get_model_class(cfg)(cfg)
    assert type(model).__name__ == "T5ForConditionalGeneration"
    assert cfg.get_num_encoder_layers() == jax_model.enc_layers
    assert cfg.get_num_decoder_layers() == jax_model.num_layers
    for attr in ("enc_layers", "num_layers", "num_heads", "head_dim", "ffn",
                 "gated", "act", "tie_word_embeddings", "num_buckets",
                 "max_distance", "decoder_start_token_id", "hidden_size",
                 "kv_cache_shape_suffix", "cross_kv_cache_shape_suffix"):
        assert getattr(model, attr) == getattr(jax_model, attr), attr
    assert model.param_shapes() == jax_model.param_shapes()


# ----------------------------------------------------------------------
# Checkpoints
# ----------------------------------------------------------------------


@pytest.mark.parametrize("style", sorted(STYLES))
def test_host_tree_matches_jax(checkpoints, style):
    """The encoder stack (hf_aux_mappings), the decoder's, both bias
    tables and the head, byte for byte."""
    jax_model, model = _models(checkpoints[style])
    compare_trees(jax_load_hf(jax_model, checkpoints[style]),
                  load_hf_params_to_host(model, checkpoints[style]))


def _encode(jax_model, model, jparams, params, seqs, cross_shape):
    """Both encoders over each (encoder ids, cross pages) of seqs, padded
    to 16 tokens (the rest at the trash page's slots), into zeroed f32
    cross caches; returns both."""
    jcross = jnp.zeros(cross_shape, jnp.float32)
    cross = torch.zeros(cross_shape)
    for ids, pages in seqs:
        E, Ep = len(ids), 16
        tokens = np.zeros((Ep,), np.int32)
        tokens[:E] = ids
        pos = np.arange(Ep, dtype=np.int32)
        pos[E:] = 0
        slots = NUM_PAGES * PS + np.arange(Ep, dtype=np.int32) % PS
        p = np.arange(E)
        slots[:E] = np.asarray(pages)[p // PS] * PS + p % PS
        jcross = jax_model.encode_and_write_cross(
            jparams, jcross, jnp.asarray(tokens), jnp.asarray(pos),
            jnp.asarray(slots), jnp.asarray([E], np.int32))
        model.encode_and_write_cross(params, cross, torch.from_numpy(tokens),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(slots), E)
    return jcross, cross


ENC = [(list(range(20, 31)), [20, 21]), (list(range(40, 46)), [23])]


def test_encoder_cross_pages_match_jax(checkpoints):
    """Every decoder layer's cross K/V of two encoder passes (11 and 6
    tokens, each padded to 16), written into the cross pages: within 1e-5
    of the JAX package's encode_and_write_cross, nothing else written but
    the trash page."""
    model_dir = checkpoints["gated_tied"]
    jax_model, model = _models(model_dir)
    jparams, params = _params(jax_model, model_dir)
    shape = (model.num_layers, NUM_PAGES + 1, PS,
             *model.cross_kv_cache_shape_suffix)
    jcross, cross = _encode(jax_model, model, jparams, params, ENC, shape)
    np.testing.assert_allclose(cross[:, :NUM_PAGES].numpy(),
                               np.asarray(jcross[:, :NUM_PAGES]), rtol=1e-5,
                               atol=1e-5)
    written = {p for _, pages in ENC for p in pages}
    untouched = [p for p in range(NUM_PAGES) if p not in written]
    assert not cross[:, untouched].any()


def _batch(rows, T, S, decode=False):
    """Both packages' batches for rows = [(token_ids, first_pos, pages,
    encoder row)], with the encoder rows' cross pages and lengths."""
    token_ids = np.zeros((T,), np.int32)
    positions = np.zeros((T,), np.int32)
    slots = NUM_PAGES * PS + np.arange(T, dtype=np.int32) % PS
    kv_lens = np.zeros((S,), np.int32)
    pages = np.zeros((S, PPS), np.int32)
    cu = np.zeros((S + 1,), np.int32)
    last = np.zeros((S,), np.int32)
    cross_pages = np.zeros((S, 4), np.int32)
    cross_lens = np.zeros((S,), np.int32)
    off = 0
    for i, (ids, first, table, enc) in enumerate(rows):
        n = len(ids)
        pos = np.arange(first, first + n)
        token_ids[off:off + n] = ids
        positions[off:off + n] = pos
        slots[off:off + n] = np.asarray(table)[pos // PS] * PS + pos % PS
        kv_lens[i] = first + n
        pages[i, :len(table)] = table
        cu[i + 1] = cu[i] + n
        off += n
        last[i] = off - 1
        cross_pages[i, :len(ENC[enc][1])] = ENC[enc][1]
        cross_lens[i] = len(ENC[enc][0])
    cu[len(rows) + 1:] = cu[len(rows)]
    fields = dict(token_ids=token_ids, positions=positions,
                  slot_mapping=slots, kv_lens=kv_lens, page_indices=pages,
                  cu_q_lens=cu, num_seqs=np.asarray([len(rows)], np.int32),
                  logits_indices=last, cross_page_indices=cross_pages,
                  cross_kv_lens=cross_lens)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = ForwardBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
    if decode:
        jb = jb._replace(cu_q_lens=None)
        tb = tb._replace(cu_q_lens=None)
    return jb, tb


RNG = np.random.default_rng(5)
A, B = (RNG.integers(0, VOCAB, n).tolist() for n in (9, 7))
PA, PB = [0, 1], [2, 3]
# A prefill of two decoder prompts; a mixed step (A's next token beside the
# rest of B's prompt); a pure-decode step (8 rows: the JAX kernel takes
# groups of 8).
STEPS = [
    ([(A, 0, PA, 0), (B[:4], 0, PB, 1)], 16, 4, False),
    ([(A[:1], 9, PA, 0), (B[4:], 4, PB, 1)], 8, 4, False),
    ([(A[1:2], 10, PA, 0), (B[1:2], 7, PB, 1)], 8, 8, True),
]


def _run_steps(jax_model, model, jparams, params, kv_dtype):
    """The encoder passes, then STEPS through both models on caches of
    kv_dtype; each step's logits of both packages, and what the JAX
    forward of the last step took (its params, cache, batch and cross
    cache)."""
    shape = (model.num_layers, NUM_PAGES + 1, PS,
             *model.kv_cache_shape_suffix)
    jcross, cross = _encode(jax_model, model, jparams, params, ENC, shape)
    jkv = jnp.zeros(shape, {torch.float32: jnp.float32,
                            torch.bfloat16: jnp.bfloat16}[kv_dtype])
    kv = torch.zeros(shape, dtype=kv_dtype)
    out = []
    for rows, T, S, decode in STEPS:
        jb, tb = _batch(rows, T, S, decode)
        last = (jparams, jkv, jb, jcross)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb, cross_kv=jcross)
        hidden = model.forward(params, kv, tb, cross_kv=cross)
        n = len(rows)
        jlogits = np.asarray(jax_model.compute_logits(
            jparams, jhidden[jb.logits_indices]))[:n]
        logits = model.compute_logits(
            params, hidden[tb.logits_indices[:n]]).numpy()
        out.append((logits, jlogits))
    return out, last


def _row_err(got, want):
    return (np.abs(got - want).max(-1) / np.abs(want).max(-1)).max()


@pytest.mark.parametrize("style", sorted(STYLES))
def test_prefill_and_mixed_logits_match_jax(checkpoints, style):
    """The prefill and mixed steps (the dense causal path with the bias,
    the cross read) on an f32 cache: logits within 1e-4 of each row's
    largest, argmax equal."""
    model_dir = checkpoints[style]
    jax_model, model = _models(model_dir)
    jparams, params = _params(jax_model, model_dir)
    for logits, jlogits in _run_steps(jax_model, model, jparams, params,
                                      torch.float32)[0][:2]:
        assert _row_err(logits, jlogits) <= ROW_TOL
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()


def test_decode_logits_within_twice_the_bf16_q_floor(checkpoints,
                                                     monkeypatch):
    """The pure-decode step on bf16 pages. The JAX package sends it to its
    decode kernel (q rounded to bf16, the probabilities to bf16 in P . V)
    on a TPU only; here its forward is run twice on the same inputs: its
    dense branch, and its kernel branch with the Pallas kernel under the
    interpreter. Their distance is the floor the rounding sets; the port,
    which takes the kernel's T5 bias on every device (its plain version on
    the CPU, with q rounded to bf16), must lie within twice that floor of
    the dense branch, and pick its tokens."""
    model_dir = checkpoints["gated_tied"]
    jax_model, model = _models(model_dir)
    jparams, params = _params(jax_model, model_dir)
    steps, (p, jkv, jb, jcross) = _run_steps(jax_model, model, jparams,
                                             params, torch.bfloat16)
    logits, want = steps[2]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_decode_mod, "paged_decode_attention",
                        functools.partial(jax_decode_mod.paged_decode_attention,
                                          interpret=True))
    _, jhidden = jax_model.forward(p, jkv, jb, cross_kv=jcross)
    jkernel = np.asarray(jax_model.compute_logits(
        p, jhidden[jb.logits_indices]))[:len(STEPS[2][0])]
    floor = _row_err(jkernel, want)
    assert 0 < floor < 1e-2, floor
    assert _row_err(logits, want) <= 2 * floor, (_row_err(logits, want),
                                                 floor)
    assert (logits.argmax(-1) == want.argmax(-1)).all()


# ----------------------------------------------------------------------
# Engines
# ----------------------------------------------------------------------

ENGINE = dict(dtype="float32", max_num_seqs=4, max_num_batched_tokens=64,
              num_device_blocks_override=128, block_size=8,
              skip_tokenizer_init=True)
PROMPTS = [RNG.integers(2, VOCAB, n).tolist() for n in (9, 23, 4)]
DECODER_PROMPT = [0, 17, 42]
# The decode step's q rounding (above) moves a logit by at most about 1e-3
# of its row: a token whose JAX logprob lies within this of the JAX pick's
# may be picked instead, and the rows after it then differ.
DECIDED = 0.02


def _held_tokens(got, want, label):
    """Equal tokens, or, from the first that differs on, a JAX pick the
    bf16 rounding of q may move: the port's token among JAX's top two,
    DECIDED or less behind."""
    g, w = got.outputs[0], want.outputs[0]
    assert len(g.token_ids) == len(w.token_ids), label
    for i, (a, b) in enumerate(zip(g.token_ids, w.token_ids)):
        if a == b:
            continue
        top = w.logprobs[i]
        assert a in top and top[b].logprob - top[a].logprob <= DECIDED, (
            label, i, a, b)
        return


@pytest.mark.parametrize("decoder_prompt", [False, True],
                         ids=["start_token", "decoder_prompt"])
@pytest.mark.parametrize("steps", [1, 8])
def test_greedy_tokens_match_jax_engine(checkpoints, steps, decoder_prompt):
    """Three encoder prompts (one past the token budget with its encoder,
    so prefills spread over steps) through both engines, greedy, 10 tokens
    each; with eight scheduler steps the port still runs single decode
    steps (no window for an encoder-decoder model)."""
    model_dir = checkpoints["gated_tied"]
    prompts = [{"prompt_token_ids": p} for p in PROMPTS]
    if decoder_prompt:
        for p in prompts:
            p["decoder_prompt_token_ids"] = DECODER_PROMPT
    sp = dict(temperature=0.0, max_tokens=10, ignore_eos=True,
              detokenize=False)
    want = JaxLLM(model=model_dir, num_scheduler_steps=steps,
                  **ENGINE).generate(
        prompts, JaxSamplingParams(logprobs=2, **sp))
    llm = LLM(model=model_dir, device="cpu", num_scheduler_steps=steps,
              **ENGINE)
    got = llm.generate(prompts, SamplingParams(**sp))
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g.outputs[0].token_ids) == 10
        assert g.prompt_token_ids == w.prompt_token_ids == (
            DECODER_PROMPT if decoder_prompt else [0])
        _held_tokens(g, w, f"request {i}")
    runner = llm.engine.runner
    assert runner.encoder_passes == len(PROMPTS)
    assert runner.encoder_tokens == sum(len(p) for p in PROMPTS)


def test_runner_sizes_the_cross_cache_and_runs_no_window(checkpoints,
                                                         monkeypatch):
    """Prefix caching off even when asked for, a page's bytes counting the
    cross cache beside the self cache, the cross cache of the self
    cache's shape, and pure-decode batches at eight scheduler steps never
    reaching the decode window but taking the decode attention with the
    T5 bias (one call a layer and step)."""
    model_dir = checkpoints["relu_untied"]
    llm = LLM(model=model_dir, device="cpu", num_scheduler_steps=8,
              enable_prefix_caching=True, **ENGINE)
    runner = llm.engine.runner
    assert runner.is_encdec
    assert not runner.cache_config.enable_prefix_caching
    assert not llm.engine.scheduler.block_manager.enable_prefix_caching
    assert runner.cross_kv.shape == runner.kv_cache.shape
    self_bytes = runner.kv_cache[:, 0].numel() * 4
    assert runner._kv_page_bytes() == 2 * self_bytes

    def no_window(*args, **kwargs):
        raise AssertionError("an encoder-decoder batch reached the window")

    monkeypatch.setattr(runner, "decode_window", no_window)
    # Pure-decode steps are marked as such: self-attention takes the decode
    # attention with the T5 bias, once a layer.
    decode_calls = []
    inner = t5_mod.paged_decode_attention

    def counted(*args, **kwargs):
        decode_calls.append(kwargs["rel_bias_meta"])
        return inner(*args, **kwargs)

    monkeypatch.setattr(t5_mod, "paged_decode_attention", counted)
    out = llm.generate([{"prompt_token_ids": p} for p in PROMPTS],
                       SamplingParams(temperature=0.0, max_tokens=12,
                                      ignore_eos=True, detokenize=False))
    assert all(len(o.outputs[0].token_ids) == 12 for o in out)
    steps = llm.engine.get_phase_timings()["decode_iterations"]
    assert steps > 0
    assert decode_calls == [(8, 32)] * (runner.model.num_layers * steps)


def test_decoder_prompt_on_a_decoder_only_model_raises(tmp_path):
    from tests.test_torch_falcon import write_falcon_checkpoint

    llm = LLM(model=write_falcon_checkpoint(tmp_path, "rw"), device="cpu",
              **ENGINE)
    with pytest.raises(ValueError, match="encoder-decoder"):
        llm.generate([{"prompt_token_ids": [3, 4, 5],
                       "decoder_prompt_token_ids": [0]}])
