"""BART and mBART in the port against the JAX package, on the CPU.

Tiny checkpoints in transformers' layout (2 + 2 layers, 4 heads of
head_dim 16, learned positions up to 128), BART's post-norm and mBART's
pre-norm (with its final LayerNorms and scaled embeddings, and no
final_logits_bias, which then reads as zeros), go through both packages:
the config answers, the host trees (byte for byte), the encoder pass's
cross pages, the decoder's prefill, mixed and pure-decode steps in f32
(1e-4 of a row: BART's self-attention is the port's ragged and decode
attention, their plain versions here), and greedy tokens of
``LLM.generate`` at one and eight scheduler steps, with and without
``decoder_prompt_token_ids``. The step batches and encoder passes are
tests/test_torch_t5.py's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu import LLM as JaxLLM
from aphrodite_tpu import SamplingParams as JaxSamplingParams
from aphrodite_tpu.common.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader.weights import \
    load_hf_params_to_host as jax_load_hf
from aphrodite_tpu.models.bart import BartForConditionalGeneration as JaxBart
from aphrodite_tpu.models.bart import \
    MBartForConditionalGeneration as JaxMBart
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (load_hf_params_to_host,
                                                params_from_jax)
from aphrodite_tpu_torch.models.registry import get_model_class
from tests import test_torch_t5 as t5_case
from tests.test_torch_falcon import compare_trees

VOCAB = t5_case.VOCAB
# Published configs (facebook/bart-large-cnn, facebook/mbart-large-cc25
# config.json).
PUBLISHED = {
    "bart-large-cnn": dict(
        architectures=["BartForConditionalGeneration"], d_model=1024,
        encoder_layers=12, decoder_layers=12, num_hidden_layers=12,
        encoder_attention_heads=16, decoder_attention_heads=16,
        encoder_ffn_dim=4096, decoder_ffn_dim=4096, vocab_size=50264,
        max_position_embeddings=1024, scale_embedding=False,
        activation_function="gelu", decoder_start_token_id=2),
    "mbart-large-cc25": dict(
        architectures=["MBartForConditionalGeneration"], d_model=1024,
        encoder_layers=12, decoder_layers=12, num_hidden_layers=12,
        encoder_attention_heads=16, decoder_attention_heads=16,
        encoder_ffn_dim=4096, decoder_ffn_dim=4096, vocab_size=250027,
        max_position_embeddings=1024, scale_embedding=True,
        activation_function="gelu"),
}
JAX_CLASSES = {"BartForConditionalGeneration": JaxBart,
               "MBartForConditionalGeneration": JaxMBart}
STYLES = ("bart", "mbart")


def write_bart(path, style: str, seed: int = 0) -> str:
    """A tiny BART ("bart") or mBART ("mbart") checkpoint as transformers
    saves one (its tensor names, [out, in] Linear weights, config.json
    keys), the weights drawn from the seed with numpy: each matrix at std
    1/sqrt(its last dim), LayerNorm weights near one and biases near
    zero. The mBART one carries no final_logits_bias."""
    from safetensors.numpy import save_file

    mbart = style == "mbart"
    D, F, P = 64, 128, 128
    cfg = dict(architectures=["MBartForConditionalGeneration" if mbart
                              else "BartForConditionalGeneration"],
               model_type=style, vocab_size=VOCAB, d_model=D,
               encoder_layers=2, decoder_layers=2, num_hidden_layers=2,
               encoder_attention_heads=4, decoder_attention_heads=4,
               encoder_ffn_dim=F, decoder_ffn_dim=F,
               max_position_embeddings=P, scale_embedding=mbart,
               activation_function="gelu", bos_token_id=0, pad_token_id=1,
               eos_token_id=2, decoder_start_token_id=2,
               torch_dtype="float32")
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-1]**-0.5).astype(
            np.float32)

    def ln(name):
        t[name + ".weight"] = (1 + 0.1 * rng.standard_normal(D)).astype(
            np.float32)
        t[name + ".bias"] = (0.1 * rng.standard_normal(D)).astype(np.float32)

    t = {"model.shared.weight": w(VOCAB, D)}
    if not mbart:
        t["final_logits_bias"] = w(1, VOCAB)
    for stack in ("encoder", "decoder"):
        m = f"model.{stack}."
        t[m + "embed_positions.weight"] = w(P + 2, D)
        ln(m + "layernorm_embedding")
        if mbart:
            ln(m + "layer_norm")
        for i in range(2):
            b = f"{m}layers.{i}."
            for attn in ["self_attn"] + (["encoder_attn"]
                                         if stack == "decoder" else []):
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    t[f"{b}{attn}.{proj}.weight"] = w(D, D)
                    t[f"{b}{attn}.{proj}.bias"] = w(D) * 0.1
                ln(f"{b}{attn}_layer_norm")
            t[b + "fc1.weight"], t[b + "fc1.bias"] = w(F, D), w(F) * 0.1
            t[b + "fc2.weight"], t[b + "fc2.bias"] = w(D, F), w(D) * 0.1
            ln(b + "final_layer_norm")
    save_file(t, str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return {style: write_bart(tmp_path_factory.mktemp(style), style, seed=4)
            for style in STYLES}


def _models(model_dir):
    jax_config = JaxModelConfig(model=model_dir, dtype="float32")
    config = ModelConfig(model=model_dir, dtype="float32")
    return (JAX_CLASSES[jax_config.architecture](jax_config),
            get_model_class(config)(config))


def _params(jax_model, model_dir):
    host = jax_load_hf(jax_model, model_dir)
    return (jax.tree.map(jnp.asarray, host),
            params_from_jax(jax.tree.map(np.asarray, host)))


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
    assert cfg.max_model_len == jax_cfg.max_model_len == 1024
    jax_model = JAX_CLASSES[hf["architectures"][0]](jax_cfg)
    model = get_model_class(cfg)(cfg)
    assert type(model).__name__ == hf["architectures"][0]
    assert cfg.get_num_encoder_layers() == jax_model.enc_layers
    assert cfg.get_num_decoder_layers() == jax_model.num_layers
    for attr in ("enc_layers", "num_layers", "num_heads", "enc_heads",
                 "head_dim", "enc_ffn", "dec_ffn", "max_position",
                 "scale_embedding", "decoder_start_token_id", "pre_norm",
                 "sm_scale", "pos_offset", "kv_cache_shape_suffix",
                 "cross_kv_cache_shape_suffix"):
        assert getattr(model, attr) == getattr(jax_model, attr), attr
    assert model.param_shapes() == jax_model.param_shapes()


@pytest.mark.parametrize("style", STYLES)
def test_host_tree_matches_jax(checkpoints, style):
    """The encoder stack (hf_aux_mappings), the decoder's, the shared
    embedding and final_logits_bias ([1, V] flattened, or zeros where the
    checkpoint has none: finalize_params), byte for byte."""
    jax_model, model = _models(checkpoints[style])
    host = load_hf_params_to_host(model, checkpoints[style])
    compare_trees(jax_load_hf(jax_model, checkpoints[style]), host)
    assert host["logits_bias"].shape == (VOCAB,)
    if style == "mbart":
        assert not host["logits_bias"].any()


def test_encoder_cross_pages_match_jax(checkpoints):
    """Every decoder layer's cross K/V of two encoder passes, written into
    the cross pages: within 1e-5 of the JAX package's
    encode_and_write_cross, nothing else written but the trash page."""
    model_dir = checkpoints["bart"]
    jax_model, model = _models(model_dir)
    jparams, params = _params(jax_model, model_dir)
    shape = (model.num_layers, t5_case.NUM_PAGES + 1, t5_case.PS,
             *model.cross_kv_cache_shape_suffix)
    jcross, cross = t5_case._encode(jax_model, model, jparams, params,
                                    t5_case.ENC, shape)
    n = t5_case.NUM_PAGES
    np.testing.assert_allclose(cross[:, :n].numpy(),
                               np.asarray(jcross[:, :n]), rtol=1e-5,
                               atol=1e-5)
    written = {p for _, pages in t5_case.ENC for p in pages}
    assert not cross[:, [p for p in range(n) if p not in written]].any()


@pytest.mark.parametrize("style", STYLES)
def test_forward_logits_match_jax(checkpoints, style):
    """A prefill step (the ragged attention), a mixed step and a
    pure-decode step (the decode attention) on an f32 cache: logits within
    1e-4 of each row's largest, argmax equal."""
    model_dir = checkpoints[style]
    jax_model, model = _models(model_dir)
    jparams, params = _params(jax_model, model_dir)
    steps, _ = t5_case._run_steps(jax_model, model, jparams, params,
                                  torch.float32)
    for logits, jlogits in steps:
        assert t5_case._row_err(logits, jlogits) <= t5_case.ROW_TOL
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()


@pytest.mark.parametrize("style,steps,decoder_prompt", [
    ("bart", 1, False), ("bart", 8, True), ("mbart", 8, False)])
def test_greedy_tokens_match_jax_engine(checkpoints, style, steps,
                                        decoder_prompt):
    """Three encoder prompts through both engines, greedy, 10 tokens each,
    equal; with a decoder prompt (BART's forced-BOS convention [eos, bos])
    the decoder continues it."""
    model_dir = checkpoints[style]
    prompts = [{"prompt_token_ids": p} for p in t5_case.PROMPTS]
    if decoder_prompt:
        for p in prompts:
            p["decoder_prompt_token_ids"] = [2, 0]
    sp = dict(temperature=0.0, max_tokens=10, ignore_eos=True,
              detokenize=False)
    want = JaxLLM(model=model_dir, num_scheduler_steps=steps,
                  **t5_case.ENGINE).generate(prompts, JaxSamplingParams(**sp))
    got = LLM(model=model_dir, device="cpu", num_scheduler_steps=steps,
              **t5_case.ENGINE).generate(prompts, SamplingParams(**sp))
    for g, w in zip(got, want):
        assert g.prompt_token_ids == w.prompt_token_ids == (
            [2, 0] if decoder_prompt else [2])
        assert len(g.outputs[0].token_ids) == 10
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
