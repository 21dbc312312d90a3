"""Partial and interleaved rotary, the dynamic and YaRN scalings, head_dim
80 in the plain attention versions, and the GPT-NeoX, Phi, StableLM,
Persimmon, GPT-J, Cohere, Nemotron, GLM-4 and ChatGLM checkpoints, in the
port against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: compute_rope_tables with the dynamic, yarn and
deepseek_yarn scalings at odd half-widths; apply_rope in both pairings
over partial widths; the plain ragged and decode attention at head_dim 80
against the JAX jnp reference (the JAX package takes d80 to no Pallas
kernel); the ModelConfig answers on each family's published keys; and
tiny checkpoints of each family written here from a seed: host trees byte
for byte, a prefill, a mixed and a decode forward on the JAX host tree
carried over by params_from_jax, and greedy tokens of ``LLM.generate``.
Each JAX model is built once per module. On the CPU the port's attention
wrappers take their plain versions; the CUDA kernels at head_dim 80 are
held against those by tests/test_torch_cuda.py on the card.
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
from aphrodite_tpu.models import layers as jlayers
from aphrodite_tpu.models.registry import \
    get_model_class as jax_model_class
from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (
    load_hf_params_to_host, load_quantized_hf_params_to_host,
    params_from_jax)
from aphrodite_tpu_torch.models import layers
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops.attention import ref_ragged_paged_attention
from aphrodite_tpu_torch.ops.decode_attention import (
    check_kernel_inputs, paged_decode_attention)
from tests import test_torch_llama as llama_case
from tests.test_torch_cuda import paged_batch
from tests.test_torch_falcon import compare_trees
from tests.test_torch_gemma import _case
from tests.test_torch_qwen import _pages

# ----------------------------------------------------------------------
# Rotary tables and the rotation
# ----------------------------------------------------------------------

SCALINGS = {
    "dynamic": lambda f: {"type": "dynamic", "factor": f},
    "dynamic_orig": lambda f: {"rope_type": "dynamic", "factor": f,
                               "original_max_position_embeddings": 64},
    "yarn": lambda f: {"type": "yarn", "factor": f,
                       "original_max_position_embeddings": 64},
    "deepseek_yarn": lambda f: {
        "type": "deepseek_yarn", "factor": f,
        "original_max_position_embeddings": 64, "beta_fast": 32,
        "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
}


@pytest.mark.parametrize("rotary_dim", [20, 24])
@pytest.mark.parametrize("factor", [2.0, 40.0])
@pytest.mark.parametrize("kind", sorted(SCALINGS))
def test_rope_tables_match_jax(kind, factor, rotary_dim):
    """(cos, sin) of the port's compute_rope_tables against the JAX
    function's, to 1e-6, at rotary widths with odd and even halves (10,
    12: StableLM-3B's 20 of 80 is the first), two factors each (at 40 the
    dynamic base and YaRN's ramp and attention factor move far), served at
    256 positions; and the scaling changes the tables."""
    scaling = SCALINGS[kind](factor)
    cos, sin = layers.compute_rope_tables(rotary_dim, 256, base=10000.0,
                                          rope_scaling=scaling)
    jcos, jsin = jlayers.compute_rope_tables(rotary_dim, 256, base=10000.0,
                                             rope_scaling=scaling)
    assert cos.shape == (256, rotary_dim // 2) and cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0,
                               atol=1e-6)
    plain, _ = layers.compute_rope_tables(rotary_dim, 256, base=10000.0)
    assert (cos - plain).abs().max() > 1e-3


@pytest.mark.parametrize("rotary_dim", [6, 10, 16])
@pytest.mark.parametrize("neox", [True, False], ids=["neox", "gptj"])
def test_apply_rope_matches_jax(neox, rotary_dim):
    """The rotation of the leading rotary_dim of 16 dims (an odd half at
    6 and 10; the whole head at 16), the rest passed through unchanged, in
    NeoX's rotate-half and GPT-J's interleaved pairing, in f32 on bf16
    heads: the JAX apply_rope's values to 1e-6 of the largest, and the two
    pairings differ."""
    rng = np.random.default_rng(rotary_dim)
    x = rng.standard_normal((7, 3, 16)).astype(np.float32)
    cos, sin = layers.compute_rope_tables(rotary_dim, 32)
    pos = rng.integers(0, 32, 7)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.apply_rope(xt, cos[pos], sin[pos], neox).float().numpy()
    want = np.asarray(jlayers.apply_rope(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos.numpy()[pos]),
        jnp.asarray(sin.numpy()[pos]), is_neox_style=neox), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * abs(want).max())
    np.testing.assert_array_equal(got[..., rotary_dim:],
                                  xt.float().numpy()[..., rotary_dim:])
    other = layers.apply_rope(xt, cos[pos], sin[pos], not neox).float()
    assert (other.numpy() != got).any()


# ----------------------------------------------------------------------
# Plain attention at head_dim 80
# ----------------------------------------------------------------------


@pytest.mark.parametrize("page_type", ["bf16", "e4m3"])
@pytest.mark.parametrize("qg", [1, 4])
def test_ref_attention_at_head_dim_80_matches_jax_reference(qg, page_type):
    """The plain ragged version (prefill, a chunk on a cached prefix,
    decode rows) and the plain decode version (one row a sequence) at
    Phi-2's head_dim, 2 kv heads, against the JAX package's jnp reference
    (where it sends d80: no Pallas kernel takes it) on the same pages,
    without and with a window and soft cap: f32 sums in another order
    only, so 1e-5 of the largest output."""
    rng = np.random.default_rng(80 + qg)
    qh, kvh, D = 2 * qg, 2, 80
    seqs = [(1, 23), (9, 9), (7, 40), (1, 31)]
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages, cu = paged_batch(rng, seqs, qh, kvh, D,
                                            padded_seqs=6,
                                            padded_tokens=tokens + 3)
    jkv, kvt, scale = _pages(kv, page_type)
    ns = np.asarray([len(seqs)], np.int32)
    idx = [torch.from_numpy(a) for a in (kv_lens, pages, cu, ns)]
    last = cu[1:len(seqs) + 1] - 1
    qd = np.zeros((6, qh, D), np.float32)
    qd[:len(seqs)] = q[last]
    dcu = np.minimum(np.arange(7), len(seqs)).astype(np.int32)
    for extra in ({}, {"sliding_window": 7, "soft_cap": 2.0}):
        kw = dict(sm_scale=D**-0.5 * scale, **extra)
        want = np.asarray(jax_ref(jnp.asarray(q), jkv, jnp.asarray(kv_lens),
                                  jnp.asarray(pages), jnp.asarray(cu),
                                  jnp.asarray(ns), **kw))
        got = ref_ragged_paged_attention(torch.from_numpy(q), kvt, *idx,
                                         **kw).numpy()
        np.testing.assert_allclose(got[:tokens], want[:tokens], rtol=0,
                                   atol=1e-5 * np.abs(want[:tokens]).max())
        assert not got[tokens:].any()
        want_d = np.asarray(jax_ref(
            jnp.asarray(qd), jkv, jnp.asarray(kv_lens), jnp.asarray(pages),
            jnp.asarray(dcu), jnp.asarray(ns), **kw))
        got_d = paged_decode_attention(torch.from_numpy(qd), kvt, idx[0],
                                       idx[1], **kw).numpy()
        np.testing.assert_allclose(got_d[:len(seqs)], want_d[:len(seqs)],
                                   rtol=0, atol=1e-5 * np.abs(want_d).max())
        assert not got_d[len(seqs):].any()


def test_kernel_rules_take_head_dim_80():
    """check_kernel_inputs (both wrappers' rules on a card) takes head_dim
    80 at QH/KV 1 to 71, with ALiBi; blocksparse stays at 128."""
    for qh in (2, 4, 32, 142):
        check_kernel_inputs(*_case(80, qh=qh), ())
        check_kernel_inputs(*_case(80, qh=qh), (),
                            alibi_slopes=_case(80, qh=qh)[0].__class__(
                                (qh,), torch.float32))
    with pytest.raises(ValueError, match="blocksparse at head_dim 128"):
        check_kernel_inputs(*_case(80), (), bs_head_offsets=_case(80)[0]
                            .__class__((8,), torch.int32))


# ----------------------------------------------------------------------
# The nine families' checkpoints
# ----------------------------------------------------------------------

VOCAB = 512
# Tiny configs with each family's own keys (2 layers, 4 query heads),
# among them: GPT-NeoX's rotary_pct 0.25 and a dynamic scaling, Phi's
# 0.4 of head_dim 20 with its shared q/k LayerNorm, StableLM-Epoch's
# rope_pct (6 of 24: an odd half), norm_eps, use_qkv_bias and a YaRN
# scaling, GPT-J's absolute rotary_dim, Cohere's per-head q/k norm and
# logit scale, ChatGLM's own key names and rope_ratio.
CONFIGS = {
    "gpt_neox": dict(architectures=["GPTNeoXForCausalLM"], hidden_size=64,
                     num_attention_heads=4, num_hidden_layers=2,
                     intermediate_size=128, rotary_pct=0.25,
                     use_parallel_residual=True, layer_norm_eps=1e-5,
                     max_position_embeddings=128,
                     rope_scaling={"type": "dynamic", "factor": 2.0}),
    "phi": dict(architectures=["PhiForCausalLM"], hidden_size=80,
                num_attention_heads=4, num_key_value_heads=4,
                num_hidden_layers=2, intermediate_size=160,
                partial_rotary_factor=0.4, qk_layernorm=True,
                layer_norm_eps=1e-5, hidden_act="gelu_new",
                max_position_embeddings=128),
    "stablelm": dict(architectures=["StableLMEpochForCausalLM"],
                     hidden_size=96, num_attention_heads=4,
                     num_key_value_heads=2, num_hidden_layers=2,
                     intermediate_size=160, rope_pct=0.25, norm_eps=1e-5,
                     use_qkv_bias=True, max_position_embeddings=128,
                     rope_scaling={"type": "yarn", "factor": 4.0,
                                   "original_max_position_embeddings": 32}),
    "persimmon": dict(architectures=["PersimmonForCausalLM"], hidden_size=64,
                      num_attention_heads=4, num_hidden_layers=2,
                      intermediate_size=128, partial_rotary_factor=0.5,
                      qk_layernorm=True, layer_norm_eps=1e-5,
                      rope_theta=25000.0, max_position_embeddings=128),
    "gptj": dict(architectures=["GPTJForCausalLM"], n_embd=64, n_head=4,
                 n_layer=2, n_inner=None, rotary_dim=8, n_positions=128,
                 layer_norm_epsilon=1e-5),
    "cohere": dict(architectures=["CohereForCausalLM"], hidden_size=64,
                   num_attention_heads=4, num_key_value_heads=2,
                   num_hidden_layers=2, intermediate_size=96,
                   use_qk_norm=True, logit_scale=0.25, layer_norm_eps=1e-5,
                   rope_theta=8000.0, max_position_embeddings=128),
    "nemotron": dict(architectures=["NemotronForCausalLM"], hidden_size=64,
                     num_attention_heads=4, num_key_value_heads=2,
                     head_dim=16, num_hidden_layers=2, intermediate_size=96,
                     partial_rotary_factor=0.5, norm_eps=1e-5,
                     max_position_embeddings=128),
    "glm": dict(architectures=["GlmForCausalLM"], hidden_size=64,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                num_hidden_layers=2, intermediate_size=96,
                partial_rotary_factor=0.5, attention_bias=True,
                rms_norm_eps=1e-5, max_position_embeddings=128),
    "chatglm": dict(architectures=["ChatGLMModel"], hidden_size=64,
                    num_attention_heads=4, kv_channels=16, num_layers=2,
                    ffn_hidden_size=96, multi_query_attention=True,
                    multi_query_group_num=2, add_qkv_bias=True,
                    add_bias_linear=False, rmsnorm=True, rope_ratio=2.0,
                    layernorm_epsilon=1e-5, seq_length=128),
}


def _hf_tensors(family, cfg, rng):
    """The family's checkpoint tensors with HF's names and layouts: Linear
    weights [out, in], fused q|k|v head-major (GPT-NeoX, Persimmon) or
    [Q; K; V] (ChatGLM), gate|up fused [gate; up] (GLM, ChatGLM); norms
    near one, biases near zero."""
    H = cfg.get("hidden_size") or cfg["n_embd"]
    NH = cfg.get("num_attention_heads") or cfg["n_head"]
    KV = (cfg.get("num_key_value_heads") or cfg.get("multi_query_group_num")
          or NH)
    D = cfg.get("head_dim") or cfg.get("kv_channels") or H // NH
    F = (cfg.get("intermediate_size") or cfg.get("ffn_hidden_size")
         or 4 * H)
    L = cfg.get("num_hidden_layers") or cfg.get("n_layer") or cfg["num_layers"]

    def w(rows, cols):
        return (rng.standard_normal((rows, cols))
                * cols**-0.5).astype(np.float32)

    def vec(*shape, center=0.0):
        return (center + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    def ln(name, n, bias=True):
        out = {name + ".weight": vec(n, center=1.0)}
        if bias:
            out[name + ".bias"] = vec(n)
        return out

    t = {}
    for i in range(L):
        if family in ("gpt_neox", "persimmon"):
            p = (f"gpt_neox.layers.{i}." if family == "gpt_neox"
                 else f"model.layers.{i}.")
            attn = "attention." if family == "gpt_neox" else "self_attn."
            t.update(ln(p + "input_layernorm", H))
            t.update(ln(p + "post_attention_layernorm", H))
            t.update({p + attn + "query_key_value.weight": w(3 * H, H),
                      p + attn + "query_key_value.bias": vec(3 * H),
                      p + attn + "dense.weight": w(H, H),
                      p + attn + "dense.bias": vec(H),
                      p + "mlp.dense_h_to_4h.weight": w(F, H),
                      p + "mlp.dense_h_to_4h.bias": vec(F),
                      p + "mlp.dense_4h_to_h.weight": w(H, F),
                      p + "mlp.dense_4h_to_h.bias": vec(H)})
            if family == "persimmon":
                t.update(ln(p + "self_attn.q_layernorm", D))
                t.update(ln(p + "self_attn.k_layernorm", D))
        elif family == "phi":
            p = f"model.layers.{i}."
            t.update(ln(p + "input_layernorm", H))
            for n in "qkv":
                t[p + f"self_attn.{n}_proj.weight"] = w(H, H)
                t[p + f"self_attn.{n}_proj.bias"] = vec(H)
            t.update(ln(p + "self_attn.q_layernorm", D))
            t.update(ln(p + "self_attn.k_layernorm", D))
            t.update({p + "self_attn.dense.weight": w(H, H),
                      p + "self_attn.dense.bias": vec(H),
                      p + "mlp.fc1.weight": w(F, H), p + "mlp.fc1.bias": vec(F),
                      p + "mlp.fc2.weight": w(H, F), p + "mlp.fc2.bias": vec(H)})
        elif family == "gptj":
            p = f"transformer.h.{i}."
            t.update(ln(p + "ln_1", H))
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                t[p + f"attn.{n}.weight"] = w(H, H)
            t.update({p + "mlp.fc_in.weight": w(F, H),
                      p + "mlp.fc_in.bias": vec(F),
                      p + "mlp.fc_out.weight": w(H, F),
                      p + "mlp.fc_out.bias": vec(H)})
        elif family == "chatglm":
            p = f"transformer.encoder.layers.{i}."
            t.update(ln(p + "input_layernorm", H, bias=False))
            t.update(ln(p + "post_attention_layernorm", H, bias=False))
            t.update({
                p + "self_attention.query_key_value.weight":
                    w((NH + 2 * KV) * D, H),
                p + "self_attention.query_key_value.bias":
                    vec((NH + 2 * KV) * D),
                p + "self_attention.dense.weight": w(H, NH * D),
                p + "mlp.dense_h_to_4h.weight": w(2 * F, H),
                p + "mlp.dense_4h_to_h.weight": w(H, F)})
        else:  # Llama names: stablelm, cohere, nemotron, glm
            p = f"model.layers.{i}."
            bias = family in ("stablelm", "nemotron")
            t.update(ln(p + "input_layernorm", H, bias))
            if family != "cohere":
                t.update(ln(p + "post_attention_layernorm", H, bias))
            t.update({p + "self_attn.q_proj.weight": w(NH * D, H),
                      p + "self_attn.k_proj.weight": w(KV * D, H),
                      p + "self_attn.v_proj.weight": w(KV * D, H),
                      p + "self_attn.o_proj.weight": w(H, NH * D)})
            if family in ("stablelm", "glm"):
                for n, width in (("q", NH * D), ("k", KV * D), ("v", KV * D)):
                    t[p + f"self_attn.{n}_proj.bias"] = vec(width)
            if family == "cohere":
                t[p + "self_attn.q_norm.weight"] = vec(NH, D, center=1.0)
                t[p + "self_attn.k_norm.weight"] = vec(KV, D, center=1.0)
            if family == "nemotron":
                t[p + "mlp.up_proj.weight"] = w(F, H)
            elif family == "glm":
                t[p + "mlp.gate_up_proj.weight"] = w(2 * F, H)
            else:
                t[p + "mlp.gate_proj.weight"] = w(F, H)
                t[p + "mlp.up_proj.weight"] = w(F, H)
            t[p + "mlp.down_proj.weight"] = w(H, F)
    if family == "gpt_neox":
        t["gpt_neox.embed_in.weight"] = w(VOCAB, H)
        t.update(ln("gpt_neox.final_layer_norm", H))
        t["embed_out.weight"] = w(VOCAB, H)
    elif family == "gptj":
        t["transformer.wte.weight"] = w(VOCAB, H)
        t.update(ln("transformer.ln_f", H))
        t.update({"lm_head.weight": w(VOCAB, H), "lm_head.bias": vec(VOCAB)})
    elif family == "chatglm":
        t["transformer.embedding.word_embeddings.weight"] = w(VOCAB, H)
        t.update(ln("transformer.encoder.final_layernorm", H, bias=False))
        t["transformer.output_layer.weight"] = w(VOCAB, H)
    else:
        t["model.embed_tokens.weight"] = w(VOCAB, H)
        final = ("model.final_layernorm" if family in ("phi", "persimmon")
                 else "model.norm")
        t.update(ln(final, H, family not in ("cohere", "glm")))
        if family != "cohere":  # Cohere ties its head
            t["lm_head.weight"] = w(VOCAB, H)
        if family == "phi":
            t["lm_head.bias"] = vec(VOCAB)
    return t


def write_checkpoint(path, family: str, seed: int = 0) -> str:
    """A checkpoint of one family from a seed (config.json and one
    safetensors file)."""
    from safetensors.numpy import save_file

    vocab_key = "padded_vocab_size" if family == "chatglm" else "vocab_size"
    cfg = dict(CONFIGS[family], torch_dtype="float32", **{vocab_key: VOCAB})
    save_file(_hf_tensors(family, cfg, np.random.default_rng(seed)),
              str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return {family: write_checkpoint(tmp_path_factory.mktemp(family), family)
            for family in CONFIGS}


@pytest.fixture(scope="module")
def built(checkpoints):
    """(JAX model, port model, JAX host tree, fused JAX params, port
    params) per family, each built once."""
    cache = {}

    def get(family):
        if family not in cache:
            model_dir = checkpoints[family]
            jcfg = JaxModelConfig(model=model_dir, dtype="float32")
            jax_model = jax_model_class(jcfg)(jcfg)
            config = ModelConfig(model=model_dir, dtype="float32")
            model = get_model_class(config)(config)
            host = jax_load_hf(jax_model, model_dir)
            jparams = jax_model.fuse_projections(
                jax.tree.map(jnp.asarray, host))
            params = params_from_jax(jax.tree.map(np.asarray, jparams))
            cache[family] = (jax_model, model, host, jparams, params)
        return cache[family]

    return get


HOOKS = ("num_heads", "num_kv_heads", "head_dim", "intermediate_size",
         "rotary_dim", "rope_style", "rope_theta", "rms_eps", "norm_type",
         "norm_bias", "norm_weight_offset", "gated_mlp", "ungated_act",
         "mlp_bias", "attention_bias", "o_proj_bias", "parallel_residual",
         "single_norm", "lm_head_bias", "tie_word_embeddings", "sm_scale")


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_host_tree_and_hooks_match_jax(checkpoints, built, family):
    """The host tree (fused tensors split at load), byte for byte, the
    rotary tables and the hooks both packages read from the config."""
    jax_model, model, host, _, _ = built(family)
    assert type(model).__name__ == type(jax_model).__name__
    compare_trees(host, load_hf_params_to_host(model, checkpoints[family]))
    for hook in HOOKS:
        assert getattr(model, hook) == getattr(jax_model, hook), hook
    np.testing.assert_array_equal(model._cos.numpy(),
                                  np.asarray(jax_model._cos))
    np.testing.assert_array_equal(model._sin.numpy(),
                                  np.asarray(jax_model._sin))
    assert (getattr(model, "logit_scale", None) or 1.0) == (
        getattr(jax_model, "logit_scale", None) or 1.0)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_forward_logits_match_jax(built, family):
    """A prefill step, a mixed step on a cached prefix and a pure decode
    step through both models on the same parameters, in f32 on an f32
    cache: logits within 1e-4 of each row's largest (f32 sums in another
    order), argmax equal, and the cache's rows within 1e-5."""
    jax_model, model, _, jparams, params = built(family)
    shape = (jax_model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    jkv = jnp.zeros(shape, jnp.float32)
    kv = torch.zeros(shape)
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, VOCAB, n).tolist() for n in (11, 10, 5))
    pa, pb, pc = [0, 1, 2, 3], [5, 7, 9], [11, 12]
    steps = [
        ([(a, 0, pa), (b[:6], 0, pb)], 24, 4, False),
        ([(a[:1], 11, pa), (b[6:], 6, pb), (c, 0, pc)], 16, 4, False),
        ([(a[:1], 12, pa), (b[:1], 10, pb), (c[:1], 5, pc)], 4, 4, True),
    ]
    for rows, T, S, decode in steps:
        jb, tb, _ = llama_case._batch(rows, T, S, decode)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb)
        hidden = model.forward(params, kv, tb)
        jlogits = np.asarray(jax_model.compute_logits(
            jparams, jhidden[jb.logits_indices]))[:len(rows)]
        logits = model.compute_logits(
            params, hidden[tb.logits_indices[:len(rows)]]).numpy()
        err = np.abs(logits - jlogits).max(-1)
        assert (err <= 1e-4 * np.abs(jlogits).max(-1)).all(), err
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()
        np.testing.assert_allclose(
            kv[:, :llama_case.NUM_PAGES].numpy(),
            np.asarray(jkv[:, :llama_case.NUM_PAGES]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_greedy_tokens_match_jax_engine(checkpoints, family):
    """Chunked prefill (a 16-token budget) mixed with decodes, then 8-step
    decode windows: the same greedy tokens as the JAX engine."""
    model_dir = checkpoints[family]
    kw = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
              num_device_blocks_override=128, block_size=8,
              num_scheduler_steps=8, skip_tokenizer_init=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (5, 19, 11)]
    sp = dict(temperature=0.0, max_tokens=10, ignore_eos=True,
              detokenize=False)
    want = JaxLLM(model=model_dir, **kw).generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    got = LLM(model=model_dir, device="cpu", **kw).generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(**sp))
    for g, w in zip(got, want):
        assert len(g.outputs[0].token_ids) == 10
        assert g.outputs[0].token_ids == w.outputs[0].token_ids


@pytest.mark.parametrize("family", ["gpt_neox", "persimmon", "chatglm",
                                    "glm"])
def test_quantized_checkpoint_of_a_fused_model_raises(checkpoints, built,
                                                      family):
    """GPTQ/AWQ checkpoints of the families that fuse tensors are not
    loaded: the message names the model."""
    model = built(family)[1]
    with pytest.raises(NotImplementedError,
                       match=f"{type(model).__name__} stores fused tensors"):
        load_quantized_hf_params_to_host(model, checkpoints[family], "gptq")


# ----------------------------------------------------------------------
# Published configs and the registry
# ----------------------------------------------------------------------

# Each family's published config.json keys that the accessors and the
# Llama body read (EleutherAI/gpt-neox-20b, microsoft/phi-2,
# stabilityai/stablelm-3b-4e1t, adept/persimmon-8b-base, EleutherAI/gpt-j-6b,
# CohereForAI/c4ai-command-r-plus, nvidia/Minitron-8B-Base,
# THUDM/glm-4-9b-chat-hf, THUDM/chatglm3-6b).
PUBLISHED = {
    "gpt-neox-20b": dict(
        architectures=["GPTNeoXForCausalLM"], hidden_size=6144,
        intermediate_size=24576, num_attention_heads=64,
        num_hidden_layers=44, rotary_pct=0.25, rotary_emb_base=10000,
        max_position_embeddings=2048, layer_norm_eps=1e-5,
        use_parallel_residual=True, vocab_size=50432,
        tie_word_embeddings=False),
    "phi-2": dict(
        architectures=["PhiForCausalLM"], hidden_size=2560,
        intermediate_size=10240, num_attention_heads=32,
        num_key_value_heads=32, num_hidden_layers=32,
        partial_rotary_factor=0.4, rope_theta=10000.0,
        max_position_embeddings=2048, layer_norm_eps=1e-5,
        hidden_act="gelu_new", qk_layernorm=False, vocab_size=51200,
        tie_word_embeddings=False),
    "stablelm-3b-4e1t": dict(
        architectures=["StableLMEpochForCausalLM"], hidden_size=2560,
        intermediate_size=6912, num_attention_heads=32,
        num_key_value_heads=32, num_hidden_layers=32, rope_pct=0.25,
        rope_theta=10000, max_position_embeddings=4096, norm_eps=1e-5,
        use_qkv_bias=False, vocab_size=50304, tie_word_embeddings=False),
    "persimmon-8b": dict(
        architectures=["PersimmonForCausalLM"], hidden_size=4096,
        intermediate_size=16384, num_attention_heads=64,
        num_hidden_layers=36, partial_rotary_factor=0.5, rope_theta=25000.0,
        max_position_embeddings=16384, layer_norm_eps=1e-5,
        qk_layernorm=True, hidden_act="relu2", vocab_size=262144,
        tie_word_embeddings=False),
    "gpt-j-6b": dict(
        architectures=["GPTJForCausalLM"], n_embd=4096, n_head=16, n_layer=28,
        n_inner=None, n_positions=2048, rotary_dim=64,
        layer_norm_epsilon=1e-5, activation_function="gelu_new",
        vocab_size=50400, tie_word_embeddings=False),
    "command-r-plus": dict(
        architectures=["CohereForCausalLM"], hidden_size=12288,
        intermediate_size=33792, num_attention_heads=96,
        num_key_value_heads=8, num_hidden_layers=64, layer_norm_eps=1e-5,
        logit_scale=0.8333333333333334, max_position_embeddings=8192,
        rope_theta=75000000.0, use_qk_norm=True, vocab_size=256000),
    "minitron-8b": dict(
        architectures=["NemotronForCausalLM"], hidden_size=4096,
        intermediate_size=16384, num_attention_heads=48,
        num_key_value_heads=8, head_dim=128, num_hidden_layers=32,
        partial_rotary_factor=0.5, rope_theta=10000,
        max_position_embeddings=4096, norm_eps=1e-5, hidden_act="relu2",
        vocab_size=256000, tie_word_embeddings=False),
    "glm-4-9b": dict(
        architectures=["GlmForCausalLM"], hidden_size=4096,
        intermediate_size=13696, num_attention_heads=32,
        num_key_value_heads=2, head_dim=128, num_hidden_layers=40,
        partial_rotary_factor=0.5, rope_theta=10000.0,
        max_position_embeddings=8192, rms_norm_eps=1.5625e-07,
        attention_bias=True, vocab_size=151552, tie_word_embeddings=False),
    "chatglm3-6b": dict(
        architectures=["ChatGLMModel"], hidden_size=4096,
        ffn_hidden_size=13696, num_attention_heads=32, kv_channels=128,
        num_layers=28, multi_query_attention=True, multi_query_group_num=2,
        padded_vocab_size=65024, seq_length=8192, layernorm_epsilon=1e-5,
        add_qkv_bias=True, add_bias_linear=False, rmsnorm=True,
        apply_residual_connection_post_layernorm=False,
        original_rope=True, post_layer_norm=True, tie_word_embeddings=False),
}
ANSWERS = ("get_hidden_size", "get_num_layers", "get_num_attention_heads",
           "get_total_num_kv_heads", "get_head_size", "get_vocab_size",
           "get_sliding_window")


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_model_config_answers_match_jax(name):
    """The port's ModelConfig on a family's published keys, before any
    model is built, against the JAX ModelConfig after its model is built
    (its model classes fill the family's keys then): every accessor the
    cache sizing reads, and max_model_len; then the built models' rotary
    width, pairing, base and norm epsilon."""
    jcfg = JaxModelConfig(model="unused", dtype="bfloat16",
                          hf_config=json.loads(json.dumps(PUBLISHED[name])))
    jax_model = jax_model_class(jcfg)(jcfg)
    config = ModelConfig(model="unused", dtype="bfloat16",
                         hf_config=json.loads(json.dumps(PUBLISHED[name])))
    got = {a: getattr(config, a)() for a in ANSWERS}
    assert got == {a: getattr(jcfg, a)() for a in ANSWERS}
    assert config.max_model_len == jcfg.max_model_len
    model = get_model_class(config)(config)
    for hook in ("rotary_dim", "rope_style", "rope_theta", "rms_eps",
                 "num_kv_heads", "intermediate_size", "attention_bias"):
        assert getattr(model, hook) == getattr(jax_model, hook), hook


ARCHITECTURES = ("GPTNeoXForCausalLM", "PhiForCausalLM", "StableLmForCausalLM",
                 "StableLMEpochForCausalLM", "StablelmForCausalLM",
                 "PersimmonForCausalLM", "GPTJForCausalLM",
                 "CohereForCausalLM", "NemotronForCausalLM", "GlmForCausalLM",
                 "ChatGLMModel", "ChatGLMForConditionalGeneration")


def test_registry_serves_the_families_and_names_what_waits():
    """get_model_class returns the JAX registry's class (by name) for each
    of the twelve names; the dense architectures still to port raise,
    naming the queue item they wait for."""
    for arch in ARCHITECTURES:
        hf = {"architectures": [arch], "hidden_size": 64,
              "num_attention_heads": 4, "num_hidden_layers": 1,
              "vocab_size": VOCAB}
        cls = get_model_class(ModelConfig(model="unused", hf_config=hf))
        jcls = jax_model_class(JaxModelConfig(model="unused",
                                              hf_config=dict(hf)))
        assert cls.__name__ == jcls.__name__
    for arch, item in (("GPT2LMHeadModel", "item 3"),
                       ("GraniteForCausalLM", "item 3"),
                       ("MambaForCausalLM", "item 10")):
        hf = {"architectures": [arch], "hidden_size": 64,
              "num_attention_heads": 4, "num_hidden_layers": 1,
              "vocab_size": VOCAB}
        with pytest.raises(NotImplementedError, match=item):
            get_model_class(ModelConfig(model="unused", hf_config=hf))
