"""Head_dim 160 in the plain attention versions, the Llama body's
learned-position, post-norm, residual-multiplier, NoPE, non-parametric-norm
and q|k|v-clip hooks, and the GPT-2, GPTBigCode, OPT (both norm orders),
Granite, SmolLM3, DeciLM, StarCoder2, Orion, OLMo, EXAONE, InternLM2 and
StableLM-2 (head_dim 160) checkpoints, in the port against the JAX
package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: the plain ragged and decode attention at head_dim 160
against the JAX jnp reference (no Pallas kernel of the JAX package takes
160); the ModelConfig answers on each family's published keys; the
learned-position bound; GGUF files of every family the port does not map
refused by name; and tiny checkpoints of each family written here from a
seed: host trees byte for byte, a prefill, a mixed and a decode forward on
the JAX host tree carried over by params_from_jax, and greedy tokens of
``LLM.generate``. Each JAX model is built once per module; the tiny
head_dims send the JAX package to its jnp attention reference (no Pallas
interpreter runs here). On the CPU the port's attention wrappers take
their plain versions; the CUDA kernels at head_dim 160 are held against
those by tests/test_torch_cuda.py on the card.
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
from aphrodite_tpu.models.registry import \
    get_model_class as jax_model_class
from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader import gguf as tgguf
from aphrodite_tpu_torch.loader.weights import (
    load_hf_params_to_host, load_quantized_hf_params_to_host,
    params_from_jax)
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops.attention import ref_ragged_paged_attention
from aphrodite_tpu_torch.ops.decode_attention import (
    DECODE_HEAD_DIMS, check_kernel_inputs, paged_decode_attention)
from tests import gguf_writer as W
from tests import test_torch_llama as llama_case
from tests.test_torch_cuda import paged_batch
from tests.test_torch_falcon import compare_trees
from tests.test_torch_gemma import _case
from tests.test_torch_qwen import _pages

# ----------------------------------------------------------------------
# Plain attention at head_dim 160
# ----------------------------------------------------------------------


@pytest.mark.parametrize("page_type", ["bf16", "e4m3"])
@pytest.mark.parametrize("qg", [1, 4])
def test_ref_attention_at_head_dim_160_matches_jax_reference(qg, page_type):
    """The plain ragged version (prefill, a chunk on a cached prefix,
    decode rows) and the plain decode version (one row a sequence) at
    StableLM-2-12B's head_dim, 2 kv heads, against the JAX package's jnp
    reference (where it sends d160: no Pallas kernel takes it) on the same
    pages, without and with a window and soft cap: f32 sums in another
    order only, so 1e-5 of the largest output."""
    rng = np.random.default_rng(160 + qg)
    qh, kvh, D = 2 * qg, 2, 160
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


def test_kernel_rules_take_head_dim_160():
    """check_kernel_inputs (both wrappers' rules on a card) takes head_dim
    160 at QH/KV 1 to 71, with ALiBi; blocksparse stays at 128, and the
    head_dims beside 160 still raise, naming those the kernels take."""
    assert 160 in DECODE_HEAD_DIMS
    for qh in (2, 4, 8, 40, 142):
        check_kernel_inputs(*_case(160, qh=qh), ())
        check_kernel_inputs(*_case(160, qh=qh), (),
                            alibi_slopes=_case(160, qh=qh)[0].__class__(
                                (qh,), torch.float32))
    with pytest.raises(ValueError, match="blocksparse at head_dim 128"):
        check_kernel_inputs(*_case(160), (), bs_head_offsets=_case(160)[0]
                            .__class__((8,), torch.int32))
    for bad in (144, 152, 168, 176):
        with pytest.raises(ValueError, match=r"head_dim in \(64, 80, 96, "
                                             r"128, 160, 256\)"):
            check_kernel_inputs(*_case(bad), ())


# ----------------------------------------------------------------------
# The families' checkpoints
# ----------------------------------------------------------------------

VOCAB = 512
# Tiny configs with each family's own keys (2 layers), among them: GPT-2's
# n_* names and n_inner null, GPTBigCode's multi-query c_attn, OPT with
# both norm orders (OPT-350m's post-norm, no final norm and a word
# projection narrower than hidden), Granite's four multipliers, a SmolLM3
# NoPE layer, DeciLM's kv heads per layer (2 and 1), StarCoder2's window
# (6, shorter than the prompts), OLMo's clip (0.5: it clamps), EXAONE's
# num_layers, InternLM2's grouped wqkv at QH/KV 2, and StableLM-2 at
# head_dim 160 (2 query heads on 1 kv head).
CONFIGS = {
    "gpt2": dict(architectures=["GPT2LMHeadModel"], n_embd=64, n_head=4,
                 n_layer=2, n_inner=None, n_positions=128,
                 layer_norm_epsilon=1e-5, activation_function="gelu_new"),
    "gpt_bigcode": dict(architectures=["GPTBigCodeForCausalLM"], n_embd=64,
                        n_head=4, n_layer=2, n_inner=96, multi_query=True,
                        n_positions=128, layer_norm_epsilon=1e-5),
    "opt": dict(architectures=["OPTForCausalLM"], hidden_size=64,
                num_attention_heads=4, num_hidden_layers=2, ffn_dim=96,
                max_position_embeddings=128, do_layer_norm_before=True,
                word_embed_proj_dim=64, activation_function="relu"),
    "opt_350m": dict(architectures=["OPTForCausalLM"], hidden_size=64,
                     num_attention_heads=4, num_hidden_layers=2, ffn_dim=96,
                     max_position_embeddings=128,
                     do_layer_norm_before=False, word_embed_proj_dim=32,
                     activation_function="relu"),
    "granite": dict(architectures=["GraniteForCausalLM"], hidden_size=64,
                    num_attention_heads=4, num_key_value_heads=2,
                    num_hidden_layers=2, intermediate_size=96,
                    rms_norm_eps=1e-5, max_position_embeddings=128,
                    embedding_multiplier=12.0, residual_multiplier=0.22,
                    attention_multiplier=0.0625, logits_scaling=8.0,
                    tie_word_embeddings=True),
    "smollm3": dict(architectures=["SmolLM3ForCausalLM"], hidden_size=64,
                    num_attention_heads=4, num_key_value_heads=2,
                    num_hidden_layers=2, intermediate_size=96,
                    rms_norm_eps=1e-6, max_position_embeddings=128,
                    rope_theta=5000000.0, no_rope_layers=[1, 0]),
    "decilm": dict(architectures=["DeciLMForCausalLM"], hidden_size=64,
                   num_attention_heads=4, num_key_value_heads_per_layer=[2, 1],
                   num_hidden_layers=2, intermediate_size=96,
                   rms_norm_eps=1e-5, max_position_embeddings=128),
    "starcoder2": dict(architectures=["Starcoder2ForCausalLM"],
                       hidden_size=64, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2,
                       intermediate_size=96, norm_epsilon=1e-5,
                       use_bias=True, sliding_window=6,
                       max_position_embeddings=128),
    "orion": dict(architectures=["OrionForCausalLM"], hidden_size=64,
                  num_attention_heads=4, num_key_value_heads=4,
                  num_hidden_layers=2, intermediate_size=96,
                  rms_norm_eps=1e-5, max_position_embeddings=128),
    "olmo": dict(architectures=["OlmoForCausalLM"], hidden_size=64,
                 num_attention_heads=4, num_key_value_heads=4,
                 num_hidden_layers=2, intermediate_size=96, clip_qkv=0.5,
                 max_position_embeddings=128, tie_word_embeddings=False),
    "exaone": dict(architectures=["ExaoneForCausalLM"], hidden_size=64,
                   num_attention_heads=4, num_key_value_heads=2, num_layers=2,
                   intermediate_size=96, layer_norm_epsilon=1e-5,
                   rope_theta=500000.0, max_position_embeddings=128,
                   tie_word_embeddings=False),
    "internlm2": dict(architectures=["InternLM2ForCausalLM"], hidden_size=64,
                      num_attention_heads=4, num_key_value_heads=2,
                      num_hidden_layers=2, intermediate_size=96,
                      rms_norm_eps=1e-5, max_position_embeddings=128,
                      tie_word_embeddings=False),
    "stablelm2": dict(architectures=["StableLmForCausalLM"], hidden_size=320,
                      num_attention_heads=2, num_key_value_heads=1,
                      num_hidden_layers=2, intermediate_size=192,
                      partial_rotary_factor=0.25, use_parallel_residual=True,
                      layer_norm_eps=1e-5, max_position_embeddings=128),
}


def _hf_tensors(family, cfg, rng):
    """The family's checkpoint tensors with HF's names and layouts: Linear
    weights [out, in], GPT-2's Conv1D [in, out], fused q|k|v as each
    family fuses it; norms near one, biases near zero."""
    H = cfg.get("hidden_size") or cfg["n_embd"]
    NH = cfg.get("num_attention_heads") or cfg["n_head"]
    KV = cfg.get("num_key_value_heads") or (
        1 if cfg.get("multi_query") else NH)
    D = H // NH
    F = cfg.get("intermediate_size") or cfg.get("ffn_dim") or cfg.get(
        "n_inner") or 4 * H
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
        if family in ("gpt2", "gpt_bigcode"):
            p = f"transformer.h.{i}."
            qkv = (NH + 2 * KV) * D
            t.update(ln(p + "ln_1", H))
            t.update(ln(p + "ln_2", H))
            t.update({p + "attn.c_attn.bias": vec(qkv),
                      p + "attn.c_proj.bias": vec(H),
                      p + "mlp.c_fc.bias": vec(F),
                      p + "mlp.c_proj.bias": vec(H)})
            if family == "gpt2":  # Conv1D: [in, out]
                t.update({p + "attn.c_attn.weight": w(qkv, H).T.copy(),
                          p + "attn.c_proj.weight": w(H, H).T.copy(),
                          p + "mlp.c_fc.weight": w(F, H).T.copy(),
                          p + "mlp.c_proj.weight": w(H, F).T.copy()})
            else:
                t.update({p + "attn.c_attn.weight": w(qkv, H),
                          p + "attn.c_proj.weight": w(H, NH * D),
                          p + "mlp.c_fc.weight": w(F, H),
                          p + "mlp.c_proj.weight": w(H, F)})
        elif family.startswith("opt"):
            p = f"model.decoder.layers.{i}."
            t.update(ln(p + "self_attn_layer_norm", H))
            t.update(ln(p + "final_layer_norm", H))
            for n in "qkv":
                t[p + f"self_attn.{n}_proj.weight"] = w(H, H)
                t[p + f"self_attn.{n}_proj.bias"] = vec(H)
            t.update({p + "self_attn.out_proj.weight": w(H, H),
                      p + "self_attn.out_proj.bias": vec(H),
                      p + "fc1.weight": w(F, H), p + "fc1.bias": vec(F),
                      p + "fc2.weight": w(H, F), p + "fc2.bias": vec(H)})
        elif family == "exaone":
            p = f"transformer.h.{i}."
            t.update(ln(p + "ln_1", H, bias=False))
            t.update(ln(p + "ln_2", H, bias=False))
            t.update({p + "attn.attention.q_proj.weight": w(NH * D, H),
                      p + "attn.attention.k_proj.weight": w(KV * D, H),
                      p + "attn.attention.v_proj.weight": w(KV * D, H),
                      p + "attn.attention.out_proj.weight": w(H, NH * D),
                      p + "mlp.c_fc_0.weight": w(F, H),
                      p + "mlp.c_fc_1.weight": w(F, H),
                      p + "mlp.c_proj.weight": w(H, F)})
        elif family == "internlm2":
            p = f"model.layers.{i}."
            t.update(ln(p + "attention_norm", H, bias=False))
            t.update(ln(p + "ffn_norm", H, bias=False))
            t.update({p + "attention.wqkv.weight": w((NH + 2 * KV) * D, H),
                      p + "attention.wo.weight": w(H, NH * D),
                      p + "feed_forward.w1.weight": w(F, H),
                      p + "feed_forward.w3.weight": w(F, H),
                      p + "feed_forward.w2.weight": w(H, F)})
        else:  # Llama names
            p = f"model.layers.{i}."
            layernorm = family in ("starcoder2", "orion", "stablelm2")
            if family != "olmo":
                t.update(ln(p + "input_layernorm", H, layernorm))
                t.update(ln(p + "post_attention_layernorm", H, layernorm))
            kv = (cfg["num_key_value_heads_per_layer"][i]
                  if family == "decilm" else KV)
            t.update({p + "self_attn.q_proj.weight": w(NH * D, H),
                      p + "self_attn.k_proj.weight": w(kv * D, H),
                      p + "self_attn.v_proj.weight": w(kv * D, H),
                      p + "self_attn.o_proj.weight": w(H, NH * D)})
            if family == "starcoder2":
                for n, width in (("q", NH * D), ("k", KV * D), ("v", KV * D),
                                 ("o", H)):
                    t[p + f"self_attn.{n}_proj.bias"] = vec(width)
                t.update({p + "mlp.c_fc.weight": w(F, H),
                          p + "mlp.c_fc.bias": vec(F),
                          p + "mlp.c_proj.weight": w(H, F),
                          p + "mlp.c_proj.bias": vec(H)})
            else:
                t.update({p + "mlp.gate_proj.weight": w(F, H),
                          p + "mlp.up_proj.weight": w(F, H),
                          p + "mlp.down_proj.weight": w(H, F)})
    if family in ("gpt2", "gpt_bigcode"):
        t["transformer.wte.weight"] = w(VOCAB, H)
        t["transformer.wpe.weight"] = w(cfg["n_positions"], H)
        t.update(ln("transformer.ln_f", H))
    elif family.startswith("opt"):
        d = "model.decoder."
        wd = cfg["word_embed_proj_dim"]
        t[d + "embed_tokens.weight"] = w(VOCAB, wd)
        t[d + "embed_positions.weight"] = w(
            cfg["max_position_embeddings"] + 2, H)
        if wd != H:
            t[d + "project_in.weight"] = w(H, wd)
            t[d + "project_out.weight"] = w(wd, H)
        if cfg["do_layer_norm_before"]:
            t.update(ln(d + "final_layer_norm", H))
    elif family == "exaone":
        t["transformer.wte.weight"] = w(VOCAB, H)
        t.update(ln("transformer.ln_f", H, bias=False))
        t["lm_head.weight"] = w(VOCAB, H)
    elif family == "internlm2":
        t["model.tok_embeddings.weight"] = w(VOCAB, H)
        t.update(ln("model.norm", H, bias=False))
        t["output.weight"] = w(VOCAB, H)
    else:
        t["model.embed_tokens.weight"] = w(VOCAB, H)
        if family != "olmo":
            t.update(ln("model.norm", H,
                        family in ("starcoder2", "orion", "stablelm2")))
        if not cfg.get("tie_word_embeddings",
                       family in ("smollm3", "starcoder2")):
            t["lm_head.weight"] = w(VOCAB, H)
    return t


def write_checkpoint(path, family: str, seed: int = 0) -> str:
    """A checkpoint of one family from a seed (config.json and one
    safetensors file)."""
    from safetensors.numpy import save_file

    cfg = dict(CONFIGS[family], torch_dtype="float32", vocab_size=VOCAB)
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
         "rotary_dim", "rope_theta", "rms_eps", "norm_type", "norm_bias",
         "norm_parametric", "gated_mlp", "ungated_act", "mlp_bias",
         "attention_bias", "o_proj_bias", "parallel_residual", "use_rope",
         "learned_positions", "pos_offset", "postnorm_residual",
         "embedding_multiplier", "residual_multiplier", "qkv_clip",
         "tie_word_embeddings", "sm_scale", "sliding_window")
# OPT-350m's head and table are products folded at load: numpy's and
# torch's f32 matmuls sum in their own orders.
FOLDED = ("embed", "lm_head")


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_host_tree_and_hooks_match_jax(checkpoints, built, family):
    """The host tree (fused tensors split and kv heads replicated at
    load), byte for byte (OPT-350m's folded head and table within 1e-6 of
    their largest), and the hooks both packages read from the config."""
    jax_model, model, host, _, _ = built(family)
    assert type(model).__name__ == type(jax_model).__name__
    got = load_hf_params_to_host(model, checkpoints[family])
    if family == "opt_350m":
        for key in FOLDED:
            want = np.asarray(host.pop(key))
            np.testing.assert_allclose(got.pop(key).numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    compare_trees(host, got)
    for hook in HOOKS:
        assert getattr(model, hook) == getattr(jax_model, hook), hook
    assert bool(getattr(model, "skip_final_norm", False)) == bool(
        getattr(jax_model, "skip_final_norm", False))
    assert (model.logit_scale or 1.0) == (
        getattr(jax_model, "logit_scale", None) or 1.0)
    jmask = getattr(jax_model, "rope_layer_mask", None)
    assert model.rope_layer_mask == (
        None if jmask is None else [bool(v) for v in np.asarray(jmask)])


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


@pytest.mark.parametrize("family", ["gpt2", "gpt_bigcode", "internlm2"])
def test_quantized_checkpoint_of_a_fused_model_raises(checkpoints, built,
                                                      family):
    """GPTQ/AWQ checkpoints of the families that fuse q|k|v are not
    loaded: the message names the model."""
    model = built(family)[1]
    with pytest.raises(NotImplementedError,
                       match=f"{type(model).__name__} stores fused tensors"):
        load_quantized_hf_params_to_host(model, checkpoints[family], "gptq")


def test_hooks_move_the_result(built):
    """Each hook that this slice adds changes the forward when turned off
    (so the tests above see it): the learned positions, OPT-350m's norm
    order, Granite's residual multiplier, SmolLM3's NoPE layer and OLMo's
    clip."""
    def prefill(model, params):
        jb, tb, _ = llama_case._batch(
            [(list(range(3, 14)), 0, [0, 1, 2, 3])], 16, 2)
        shape = (model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
                 *model.kv_cache_shape_suffix)
        return model.forward(params, torch.zeros(shape), tb)[:11]

    for family, hook, off in (("gpt2", "pos_offset", 1),
                              ("opt_350m", "postnorm_residual", False),
                              ("smollm3", "rope_layer_mask", None),
                              ("olmo", "qkv_clip", 0.0)):
        model, params = built(family)[1], built(family)[4]
        before = prefill(model, params)
        saved = getattr(model, hook)
        setattr(model, hook, off)
        try:
            assert (prefill(model, params) - before).abs().max() > 1e-3, hook
        finally:
            setattr(model, hook, saved)
    model, params = built("granite")[1], built("granite")[4]
    before = prefill(model, params)
    saved, model._residual_scale = model._residual_scale, None
    try:
        assert (prefill(model, params) - before).abs().max() > 1e-3
    finally:
        model._residual_scale = saved


# ----------------------------------------------------------------------
# Published configs, the learned-position bound, GGUF refusals, registry
# ----------------------------------------------------------------------

# Each family's published config.json keys that the accessors and the
# Llama body read (stabilityai/stablelm-2-12b, openai-community/gpt2-xl,
# bigcode/starcoder, facebook/opt-6.7b, facebook/opt-350m,
# ibm-granite/granite-3.1-8b-instruct, HuggingFaceTB/SmolLM3-3B,
# bigcode/starcoder2-7b, OrionStarAI/Orion-14B-Base, allenai/OLMo-7B-hf,
# LGAI-EXAONE/EXAONE-3.0-7.8B-Instruct, internlm/internlm2_5-7b-chat), and
# DeciLM-7B's widths with a schedule of 4 and 2 kv heads a layer.
PUBLISHED = {
    "stablelm-2-12b": dict(
        architectures=["StableLmForCausalLM"], hidden_size=5120,
        intermediate_size=13824, num_attention_heads=32,
        num_key_value_heads=8, num_hidden_layers=40,
        partial_rotary_factor=0.25, rope_theta=10000,
        max_position_embeddings=4096, layer_norm_eps=1e-5,
        use_parallel_residual=True, qk_layernorm=True, use_qkv_bias=False,
        vocab_size=100352, tie_word_embeddings=False),
    "gpt2-xl": dict(
        architectures=["GPT2LMHeadModel"], n_embd=1600, n_head=25,
        n_layer=48, n_inner=None, n_positions=1024, n_ctx=1024,
        layer_norm_epsilon=1e-5, activation_function="gelu_new",
        vocab_size=50257),
    "starcoder": dict(
        architectures=["GPTBigCodeForCausalLM"], n_embd=6144, n_head=48,
        n_layer=40, n_inner=24576, n_positions=8192, multi_query=True,
        layer_norm_epsilon=1e-5, activation_function="gelu_pytorch_tanh",
        vocab_size=49152),
    "opt-6.7b": dict(
        architectures=["OPTForCausalLM"], hidden_size=4096,
        num_attention_heads=32, num_hidden_layers=32, ffn_dim=16384,
        max_position_embeddings=2048, word_embed_proj_dim=4096,
        do_layer_norm_before=True, activation_function="relu",
        vocab_size=50272),
    "opt-350m": dict(
        architectures=["OPTForCausalLM"], hidden_size=1024,
        num_attention_heads=16, num_hidden_layers=24, ffn_dim=4096,
        max_position_embeddings=2048, word_embed_proj_dim=512,
        do_layer_norm_before=False, activation_function="relu",
        vocab_size=50272),
    "granite-3.1-8b": dict(
        architectures=["GraniteForCausalLM"], hidden_size=4096,
        intermediate_size=12800, num_attention_heads=32,
        num_key_value_heads=8, num_hidden_layers=40,
        max_position_embeddings=131072, rope_theta=10000000.0,
        rms_norm_eps=1e-5, embedding_multiplier=12.0,
        residual_multiplier=0.22, attention_multiplier=0.0078125,
        logits_scaling=16.0, attention_bias=False, vocab_size=49155,
        tie_word_embeddings=True),
    "smollm3-3b": dict(
        architectures=["SmolLM3ForCausalLM"], hidden_size=2048,
        intermediate_size=11008, num_attention_heads=16,
        num_key_value_heads=4, num_hidden_layers=36,
        max_position_embeddings=65536, rope_theta=5000000.0,
        rms_norm_eps=1e-6, no_rope_layer_interval=4, vocab_size=128256,
        tie_word_embeddings=True),
    "decilm-7b": dict(
        architectures=["DeciLMForCausalLM"], hidden_size=4096,
        intermediate_size=14336, num_attention_heads=32,
        num_hidden_layers=32,
        num_key_value_heads_per_layer=[4] * 16 + [2] * 16,
        max_position_embeddings=8192, rms_norm_eps=1e-6,
        rope_theta=10000.0, vocab_size=32000, tie_word_embeddings=False),
    "starcoder2-7b": dict(
        architectures=["Starcoder2ForCausalLM"], hidden_size=4608,
        intermediate_size=18432, num_attention_heads=36,
        num_key_value_heads=4, num_hidden_layers=32,
        max_position_embeddings=16384, sliding_window=4096,
        rope_theta=1000000, norm_epsilon=1e-5, use_bias=True,
        vocab_size=49152),
    "orion-14b": dict(
        architectures=["OrionForCausalLM"], hidden_size=5120,
        intermediate_size=15360, num_attention_heads=40,
        num_key_value_heads=40, num_hidden_layers=40,
        max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000,
        vocab_size=84608, tie_word_embeddings=False),
    "olmo-7b": dict(
        architectures=["OlmoForCausalLM"], hidden_size=4096,
        intermediate_size=11008, num_attention_heads=32,
        num_key_value_heads=32, num_hidden_layers=32,
        max_position_embeddings=2048, clip_qkv=None, rope_theta=10000.0,
        vocab_size=50304, tie_word_embeddings=False),
    "exaone-3.0-7.8b": dict(
        architectures=["ExaoneForCausalLM"], hidden_size=4096,
        intermediate_size=14336, num_attention_heads=32,
        num_key_value_heads=8, num_layers=32, max_position_embeddings=4096,
        layer_norm_epsilon=1e-5, rope_theta=500000.0, vocab_size=102400,
        tie_word_embeddings=False),
    "internlm2.5-7b": dict(
        architectures=["InternLM2ForCausalLM"], hidden_size=4096,
        intermediate_size=14336, num_attention_heads=32,
        num_key_value_heads=8, num_hidden_layers=32,
        max_position_embeddings=32768, rms_norm_eps=1e-5,
        rope_theta=1000000, rope_scaling={"type": "dynamic", "factor": 2.0},
        bias=False, vocab_size=92544, tie_word_embeddings=False),
}
ANSWERS = ("get_hidden_size", "get_num_layers", "get_num_attention_heads",
           "get_total_num_kv_heads", "get_head_size", "get_vocab_size",
           "get_sliding_window")


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_model_config_answers_match_jax(name):
    """The port's ModelConfig on a family's published keys, before any
    model is built, against the JAX ModelConfig after its model is built
    (its model classes fill the family's keys then): every accessor the
    cache sizing reads, and max_model_len; then the built models' hooks."""
    jcfg = JaxModelConfig(model="unused", dtype="bfloat16",
                          hf_config=json.loads(json.dumps(PUBLISHED[name])))
    jax_model = jax_model_class(jcfg)(jcfg)
    config = ModelConfig(model="unused", dtype="bfloat16",
                         hf_config=json.loads(json.dumps(PUBLISHED[name])))
    got = {a: getattr(config, a)() for a in ANSWERS}
    assert got == {a: getattr(jcfg, a)() for a in ANSWERS}
    assert config.max_model_len == jcfg.max_model_len
    model = get_model_class(config)(config)
    for hook in ("rotary_dim", "rope_theta", "rms_eps", "num_kv_heads",
                 "intermediate_size", "attention_bias", "sm_scale",
                 "tie_word_embeddings", "learned_positions", "pos_offset",
                 "residual_multiplier", "embedding_multiplier"):
        assert getattr(model, hook) == getattr(jax_model, hook), hook
    if model.learned_positions:
        assert (model.param_shapes()["embed_pos"]
                == jax_model.param_shapes()["embed_pos"])


@pytest.mark.parametrize("name", ["gpt2-xl", "starcoder", "opt-350m"])
def test_learned_positions_past_the_table_raise_at_init(name):
    """A max_model_len past the learned-position table raises when the
    model is built (a CUDA gather past the table would end in a device-side
    assert; the JAX package warns and clamps); up to the table it builds."""
    hf = json.loads(json.dumps(PUBLISHED[name]))
    rows = hf.get("n_positions") or hf["max_position_embeddings"]
    config = ModelConfig(model="unused", dtype="bfloat16", hf_config=hf,
                         max_model_len=rows + 1)
    with pytest.raises(ValueError, match=f"{rows} learned positions"):
        get_model_class(config)(config)
    config = ModelConfig(model="unused", dtype="bfloat16",
                         hf_config=json.loads(json.dumps(PUBLISHED[name])),
                         max_model_len=rows)
    assert get_model_class(config)(config).num_positions == rows


# The llama.cpp names of the families the port serves or lists as waiting
# whose tensors it does not map.
REFUSED_GGUF = ("gptneox", "phi2", "stablelm", "gptj", "persimmon",
                "command-r", "nemotron", "chatglm", "gpt2", "starcoder",
                "starcoder2", "granite", "olmo", "orion", "internlm2",
                "exaone", "deci", "gemma", "gemma2", "phi3", "falcon",
                "bloom", "mpt", "jais", "qwen3", "olmo2", "minicpm",
                "qwen2moe", "mamba")


def test_gguf_files_of_unmapped_families_raise_by_name(tmp_path):
    """A GGUF file (metadata only, no tensors) of each of these
    architectures raises when its config is read, naming the architecture
    and the ROADMAP item, where the JAX package's gguf_to_hf_config reads it
    as Llama; llama, mistral and qwen2 files still read."""
    for arch in REFUSED_GGUF:
        path = str(tmp_path / f"{arch}.gguf")
        W.write_gguf(path, {"general.architecture": arch,
                            f"{arch}.block_count": 2}, [])
        with pytest.raises(NotImplementedError,
                           match=f"architecture '{arch}'.*item"):
            ModelConfig(model=path)
        with pytest.raises(NotImplementedError, match=f"'{arch}'"):
            tgguf.load_gguf_params_to_host(None, path)
    for arch, name in (("llama", "LlamaForCausalLM"),
                       ("mistral", "MistralForCausalLM"),
                       ("qwen2", "Qwen2ForCausalLM")):
        path = str(tmp_path / f"{arch}.gguf")
        W.write_gguf(path, {"general.architecture": arch}, [])
        assert tgguf.gguf_to_hf_config(path)["architectures"] == [name]


ARCHITECTURES = ("GPT2LMHeadModel", "GPTBigCodeForCausalLM", "OPTForCausalLM",
                 "GraniteForCausalLM", "SmolLM3ForCausalLM",
                 "DeciLMForCausalLM", "Starcoder2ForCausalLM",
                 "OrionForCausalLM", "OlmoForCausalLM", "ExaoneForCausalLM",
                 "InternLM2ForCausalLM")


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_registry_serves_the_architecture(arch):
    """get_model_class returns the JAX registry's class (by name)."""
    hf = {"architectures": [arch], "hidden_size": 64,
          "num_attention_heads": 4, "num_hidden_layers": 1,
          "intermediate_size": 96, "vocab_size": VOCAB}
    cls = get_model_class(ModelConfig(model="unused", hf_config=dict(hf)))
    jcls = jax_model_class(JaxModelConfig(model="unused", hf_config=dict(hf)))
    assert cls.__name__ == jcls.__name__
