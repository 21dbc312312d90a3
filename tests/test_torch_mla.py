"""Head_dim 384 in the plain attention versions and their pure-decode
route, the DeepSeek body's multi-head latent attention (MLA) on the dense
stack with MiniCPM3 in both of its forms, and OLMo2, MiniCPM and
MiniCPM-MoE, in the port against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: the plain ragged attention at head_dim 384, and a
pure-decode batch (cu_q_lens None), which at 384 takes the ragged version
over arange(S + 1) in both packages, against the JAX jnp reference. Both
TPU kernels refuse 384 here: the JAX-bundled kernel under
``pltpu.force_tpu_interpret_mode()`` raises in the interpreter
(AttributeError in its RefReshaper, as at 96 and 256), and the vendored
fork, where the JAX package sends fp8 pages, refuses one kv head ("can
not be XLA fully tiled") before it runs; so the jnp reference is the
yardstick. Then tiny checkpoints written here from a seed: MiniCPM3 with
kv_lora_rank 256 and qk_rope_head_dim 32, so that its latent head pads
288 to 384 as on the card, with LongRoPE factors; OLMo2; MiniCPM and its
MoE variant: host trees byte for byte, the hooks both packages read, a
prefill, a mixed and a decode forward on the JAX host tree carried over by
params_from_jax (MiniCPM3 under either value of APHRODITE_MLA_LATENT, each
against the JAX model built under the same value), MiniCPM3's greedy
tokens through ``LLM.generate`` in both forms, the registry, and the
kernels' rules at 384. The CUDA kernel at 384 is held against the plain
version by tests/test_torch_cuda.py on the card.
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
from aphrodite_tpu_torch.loader.weights import (load_hf_params_to_host,
                                                params_from_jax)
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    DECODE_HEAD_DIMS, RAGGED_HEAD_DIMS, check_kernel_inputs)
from tests import test_torch_llama as llama_case
from tests.test_torch_cuda import paged_batch
from tests.test_torch_falcon import compare_trees
from tests.test_torch_gemma import _case, _OnCard
from tests.test_torch_qwen import _pages

# ----------------------------------------------------------------------
# Plain attention at head_dim 384, and the pure-decode route there
# ----------------------------------------------------------------------


@pytest.mark.parametrize("page_type", ["bf16", "e4m3"])
@pytest.mark.parametrize("qg", [40, 4])
def test_ref_attention_at_head_dim_384_matches_jax_reference(qg, page_type):
    """The plain ragged version (prefill, a chunk on a cached prefix,
    decode rows) at head_dim 384 on one kv head, QH/KV 40 (MiniCPM3-4B's)
    and 4, against the JAX package's jnp reference on the same pages,
    without and with a window and soft cap; and a pure-decode batch
    (cu_q_lens None) through the wrapper, which at 384 takes the ragged
    version over arange(S + 1), as the JAX package routes it, against the
    reference on that arange. f32 sums in another order only: 1e-5 of the
    largest output."""
    rng = np.random.default_rng(384 + qg)
    qh, kvh, D = qg, 1, 384
    seqs = [(1, 23), (9, 9), (7, 40), (1, 31)]
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages, cu = paged_batch(rng, seqs, qh, kvh, D,
                                            padded_seqs=6,
                                            padded_tokens=tokens + 3)
    jkv, kvt, scale = _pages(kv, page_type)
    ns = np.asarray([len(seqs)], np.int32)
    idx = [torch.from_numpy(a) for a in (kv_lens, pages, cu, ns)]
    qd = np.zeros((6, qh, D), np.float32)
    qd[:len(seqs)] = q[cu[1:len(seqs) + 1] - 1]
    dcu = np.arange(7, dtype=np.int32)
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
        got_d = ragged_paged_attention(torch.from_numpy(qd), kvt, idx[0],
                                       idx[1], None, idx[3], **kw).numpy()
        np.testing.assert_allclose(got_d[:len(seqs)], want_d[:len(seqs)],
                                   rtol=0, atol=1e-5 * np.abs(want_d).max())
        assert not got_d[len(seqs):].any()  # dead rows: zeros


def test_kernel_rules_at_head_dim_384():
    """check_kernel_inputs on objects that claim a CUDA device: the ragged
    kernel's rules take head_dim 384 at QH/KV 1 to 40 and refuse ALiBi and
    blocksparse there by name; the decode kernel's rules, its default,
    refuse 384 (a pure-decode batch at 384 never reaches it)."""
    assert 384 in RAGGED_HEAD_DIMS and 384 not in DECODE_HEAD_DIMS
    for qh in (1, 4, 40):
        check_kernel_inputs(*_case(384, qh=qh, kvh=1), (),
                            head_dims=RAGGED_HEAD_DIMS)
    with pytest.raises(ValueError, match="no ALiBi at head_dim 384"):
        check_kernel_inputs(*_case(384, qh=40, kvh=1), (),
                            alibi_slopes=_OnCard((40,), torch.float32),
                            head_dims=RAGGED_HEAD_DIMS)
    with pytest.raises(ValueError, match="blocksparse at head_dim 128"):
        check_kernel_inputs(*_case(384, qh=8, kvh=1), (),
                            bs_head_offsets=_OnCard((8,), torch.int32),
                            head_dims=RAGGED_HEAD_DIMS)
    with pytest.raises(ValueError, match=r"head_dim in \(64, 80, 96, 128, "
                                         r"160, 256\)"):
        check_kernel_inputs(*_case(384, qh=40, kvh=1), ())
    for bad in (320, 448, 512, 640):
        with pytest.raises(ValueError, match="head_dim in"):
            check_kernel_inputs(*_case(bad), (), head_dims=RAGGED_HEAD_DIMS)


# ----------------------------------------------------------------------
# The families' checkpoints
# ----------------------------------------------------------------------

VOCAB = 512
# MiniCPM3's stand-in LongRoPE factors (qk_rope_head_dim / 2 of them),
# served past the original 64 positions, so the long ones and the
# attention factor apply. head_dim (hidden / heads) equals the rope dim
# here: the JAX Llama init builds a head_dim table from the same factors
# (ROADMAP.md §3).
_FACTORS = [1.0 + 0.25 * i for i in range(16)]
CONFIGS = {
    "minicpm3": dict(
        architectures=["MiniCPM3ForCausalLM"], hidden_size=128,
        num_attention_heads=4, num_key_value_heads=4, num_hidden_layers=2,
        intermediate_size=96, q_lora_rank=48, kv_lora_rank=256,
        qk_nope_head_dim=16, qk_rope_head_dim=32, v_head_dim=24,
        rms_norm_eps=1e-5, max_position_embeddings=128, scale_emb=12,
        scale_depth=1.4, dim_model_base=32, tie_word_embeddings=False,
        rope_scaling={"type": "longrope", "long_factor": _FACTORS,
                      "short_factor": _FACTORS[::-1],
                      "original_max_position_embeddings": 64}),
    "olmo2": dict(architectures=["Olmo2ForCausalLM"], hidden_size=64,
                  num_attention_heads=4, num_key_value_heads=2,
                  num_hidden_layers=2, intermediate_size=96,
                  rms_norm_eps=1e-6, rope_theta=500000.0,
                  max_position_embeddings=128, tie_word_embeddings=False),
    "minicpm": dict(architectures=["MiniCPMForCausalLM"], hidden_size=64,
                    num_attention_heads=4, num_key_value_heads=4,
                    num_hidden_layers=2, intermediate_size=96,
                    rms_norm_eps=1e-5, max_position_embeddings=128,
                    scale_emb=12, scale_depth=1.4, dim_model_base=16,
                    tie_word_embeddings=True),
    "minicpm_moe": dict(architectures=["MiniCPMForCausalLM"], hidden_size=64,
                        num_attention_heads=4, num_key_value_heads=4,
                        num_hidden_layers=2, intermediate_size=48,
                        rms_norm_eps=1e-5, max_position_embeddings=128,
                        scale_emb=12, scale_depth=1.4, dim_model_base=16,
                        num_experts=4, num_experts_per_tok=2,
                        tie_word_embeddings=False),
}


def _hf_tensors(family, cfg, rng):
    """The family's checkpoint tensors with HF's names and layouts (Linear
    weights [out, in]); norms near one."""
    H, NH = cfg["hidden_size"], cfg["num_attention_heads"]
    KV, L = cfg["num_key_value_heads"], cfg["num_hidden_layers"]
    F, D = cfg["intermediate_size"], H // NH

    def w(rows, cols):
        return (rng.standard_normal((rows, cols))
                * cols**-0.5).astype(np.float32)

    def norm(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    t = {}
    for i in range(L):
        p = f"model.layers.{i}."
        if family == "minicpm3":
            r, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
            nope, v = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
            qr = cfg["q_lora_rank"]
            t.update({p + "self_attn.q_a_proj.weight": w(qr, H),
                      p + "self_attn.q_a_layernorm.weight": norm(qr),
                      p + "self_attn.q_b_proj.weight": w(NH * (nope + rope),
                                                         qr),
                      p + "self_attn.kv_a_proj_with_mqa.weight": w(r + rope,
                                                                   H),
                      p + "self_attn.kv_a_layernorm.weight": norm(r),
                      p + "self_attn.kv_b_proj.weight": w(NH * (nope + v), r),
                      p + "self_attn.o_proj.weight": w(H, NH * v)})
        else:
            t.update({p + "self_attn.q_proj.weight": w(NH * D, H),
                      p + "self_attn.k_proj.weight": w(KV * D, H),
                      p + "self_attn.v_proj.weight": w(KV * D, H),
                      p + "self_attn.o_proj.weight": w(H, NH * D)})
        t[p + "post_attention_layernorm.weight"] = norm(H)
        if family == "olmo2":
            t.update({p + "post_feedforward_layernorm.weight": norm(H),
                      p + "self_attn.q_norm.weight": norm(NH * D),
                      p + "self_attn.k_norm.weight": norm(KV * D)})
        else:
            t[p + "input_layernorm.weight"] = norm(H)
        if family == "minicpm_moe":
            E = cfg["num_experts"]
            t[p + "mlp.gate.weight"] = w(E, H)
            for e in range(E):
                q = f"{p}mlp.experts.{e}."
                t.update({q + "w1.weight": w(F, H), q + "w3.weight": w(F, H),
                          q + "w2.weight": w(H, F)})
        else:
            t.update({p + "mlp.gate_proj.weight": w(F, H),
                      p + "mlp.up_proj.weight": w(F, H),
                      p + "mlp.down_proj.weight": w(H, F)})
    t["model.embed_tokens.weight"] = w(VOCAB, H)
    t["model.norm.weight"] = norm(H)
    if not cfg["tie_word_embeddings"]:
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


# The forward cases: (family, APHRODITE_MLA_LATENT) or the family alone.
CASES = {"minicpm3": ("minicpm3", "1"),
         "minicpm3_materialized": ("minicpm3", "0"),
         "olmo2": ("olmo2", None), "minicpm": ("minicpm", None),
         "minicpm_moe": ("minicpm_moe", None)}


def _build(model_dir, latent, monkeypatch):
    """(JAX model, port model, JAX host tree, fused JAX params, port
    params), both models built under the same APHRODITE_MLA_LATENT."""
    if latent is not None:
        monkeypatch.setenv("APHRODITE_MLA_LATENT", latent)
    jcfg = JaxModelConfig(model=model_dir, dtype="float32")
    jax_model = jax_model_class(jcfg)(jcfg)
    config = ModelConfig(model=model_dir, dtype="float32")
    model = get_model_class(config)(config)
    host = jax_load_hf(jax_model, model_dir)
    jparams = jax_model.fuse_projections(jax.tree.map(jnp.asarray, host))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jax_model, model, host, jparams, params


HOOKS = ("num_heads", "num_kv_heads", "head_dim", "intermediate_size",
         "rms_eps", "embedding_multiplier", "residual_multiplier",
         "tie_word_embeddings", "sm_scale",
         "kv_cache_shape_suffix")
MLA_HOOKS = ("q_rank", "kv_rank", "rope_dim", "nope_dim", "v_dim", "qk_dim",
             "head_eff", "mla_latent", "rope_interleave", "num_dense")


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_tree_hooks_and_logits_match_jax(checkpoints, monkeypatch,
                                              case):
    """The host tree byte for byte, the hooks both packages read from the
    config (MiniCPM3's latent head 288 padded to 384 and its MLA rotary
    tables), and a prefill step, a mixed step on a cached prefix and a
    pure decode step (cu_q_lens None: at 384 the ragged version over the
    arange) through both models on the same parameters, in f32 on an f32
    cache: logits within 1e-4 of each row's largest (f32 sums in another
    order), argmax equal, and the cache's rows within 1e-5."""
    family, latent = CASES[case]
    jax_model, model, host, jparams, params = _build(
        checkpoints[family], latent, monkeypatch)
    # (The port's MiniCPM MoE variant is a class of its own.)
    assert type(model).__name__ == (
        "MiniCPMMoEForCausalLM" if family == "minicpm_moe"
        else type(jax_model).__name__)
    compare_trees(host, load_hf_params_to_host(model, checkpoints[family]))
    hooks = HOOKS + (MLA_HOOKS if family == "minicpm3" else ())
    for hook in hooks:
        assert getattr(model, hook) == getattr(jax_model, hook), hook
    assert (model.logit_scale or 1.0) == (
        getattr(jax_model, "logit_scale", None) or 1.0)
    if family == "minicpm3":
        assert model.head_eff == 384 and model.mla_latent == (latent == "1")
        for mine, theirs in ((model._cos, jax_model._cos),
                             (model._sin, jax_model._sin)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       rtol=0, atol=1e-6)
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_jax_engine(checkpoints, monkeypatch, case):
    """Each case through both engines: chunked prefill (a 16-token budget)
    mixed with decodes, then 8-step decode windows (on MiniCPM3's latent
    cache every decode step attends at head_dim 384 through the ragged
    version): the same greedy tokens as the JAX engine, MiniCPM3's under
    the same APHRODITE_MLA_LATENT, on a cache of its form's geometry."""
    family, latent = CASES[case]
    if latent is not None:
        monkeypatch.setenv("APHRODITE_MLA_LATENT", latent)
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
    llm = LLM(model=model_dir, device="cpu", **kw)
    got = llm.generate(prompt_token_ids=prompts,
                       sampling_params=SamplingParams(**sp))
    if family == "minicpm3":
        assert tuple(llm.engine.runner.kv_cache.shape[-2:]) == (
            (2, 384) if latent == "1" else (8, 48))
    for g, w in zip(got, want):
        assert len(g.outputs[0].token_ids) == 10
        assert g.outputs[0].token_ids == w.outputs[0].token_ids


def test_minicpm3_published_longrope_builds_where_jax_raises():
    """MiniCPM3-4B's published LongRoPE lists qk_rope_head_dim / 2 = 16
    factors a list, while hidden / heads is 64. The JAX Llama init builds a
    head_dim table from them first and raises (numpy cannot broadcast 32
    frequencies against 16 factors; ROADMAP.md §3); the port's MLA body
    builds only its rope-dim table, the one the JAX MLA init builds, equal
    to the JAX function's to 1e-6."""
    from aphrodite_tpu.models.layers import \
        compute_rope_tables as jax_tables

    hf = dict(CONFIGS["minicpm3"], vocab_size=VOCAB, num_attention_heads=2,
              num_key_value_heads=2)
    assert hf["hidden_size"] // 2 == 2 * hf["qk_rope_head_dim"]
    jcfg = JaxModelConfig(model="unused", dtype="float32",
                          hf_config=dict(hf))
    with pytest.raises(ValueError, match="broadcast"):
        jax_model_class(jcfg)(jcfg)
    config = ModelConfig(model="unused", dtype="float32", hf_config=hf)
    model = get_model_class(config)(config)
    jcos, jsin = jax_tables(32, model.max_position, base=model.rope_theta,
                            rope_scaling=hf["rope_scaling"])
    np.testing.assert_allclose(model._cos.numpy(), np.asarray(jcos),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(model._sin.numpy(), np.asarray(jsin),
                               rtol=0, atol=1e-6)


def test_registry_serves_the_three_and_deepseek_waits(monkeypatch):
    """get_model_class returns the JAX registry's class (by name) for
    OLMo2, MiniCPM (its MoE variant where the config names experts) and
    MiniCPM3; the DeepSeek architectures still raise, naming item 7, and
    the MLA body refuses a config with routed experts by name."""
    base = {"hidden_size": 64, "num_attention_heads": 4,
            "num_hidden_layers": 1, "vocab_size": VOCAB}
    for arch, extra, name in (
            ("Olmo2ForCausalLM", {}, "Olmo2ForCausalLM"),
            ("MiniCPMForCausalLM", {}, "MiniCPMForCausalLM"),
            ("MiniCPMForCausalLM", {"num_experts": 4}, "MiniCPMMoEForCausalLM"),
            ("MiniCPM3ForCausalLM", {}, "MiniCPM3ForCausalLM")):
        hf = dict(base, architectures=[arch], **extra)
        cls = get_model_class(ModelConfig(model="unused", hf_config=hf))
        assert cls.__name__ == name
        jcls = jax_model_class(JaxModelConfig(model="unused",
                                              hf_config=dict(hf)))
        assert jcls.__name__ == arch
    for arch in ("DeepseekForCausalLM", "DeepseekV2ForCausalLM",
                 "DeepseekV3ForCausalLM"):
        hf = dict(base, architectures=[arch])
        with pytest.raises(NotImplementedError, match="item 7"):
            get_model_class(ModelConfig(model="unused", hf_config=hf))
    hf = dict(CONFIGS["minicpm3"], vocab_size=VOCAB, n_routed_experts=8)
    cls = get_model_class(ModelConfig(model="unused", hf_config=hf))
    with pytest.raises(NotImplementedError, match="item 7"):
        cls(ModelConfig(model="unused", dtype="float32", hf_config=hf))
