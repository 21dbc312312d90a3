"""Bloom, MPT and JAIS, and ALiBi at head_dim 64, in the port against the
JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: both ALiBi slope schedules (Bloom's, MPT's) byte for
byte, the plain decode and ragged attention with ALiBi at head_dim 64 and
2 and 4 query heads per kv head (against the JAX decode kernel and the
vendored ALiBi fork under the Pallas interpreter, which takes head_dim 128
only, and the jnp reference),
and tiny Bloom, MPT and JAIS checkpoints written here from a seed: the host
trees (Bloom's head-major q|k|v, MPT's and JAIS's [Q; K; V], JAIS's Conv1D
layout; byte for byte), forwards with an f32, a bf16 and an E4M3 cache, and
greedy tokens of ``LLM.generate``. Quantized checkpoints of these fused
models raise, and so do quantized weights whose widths the card's products
do not take. On the CPU the port's attention wrappers take their plain
versions; the CUDA kernels with ALiBi at every head_dim are held against
those by tests/test_torch_cuda.py on the card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aphrodite_tpu.ops.rpa_alibi_kernel as jax_fork
from aphrodite_tpu import LLM as JaxLLM
from aphrodite_tpu import SamplingParams as JaxSamplingParams
from aphrodite_tpu.common.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader.weights import \
    load_hf_params_to_host as jax_load_hf
from aphrodite_tpu.models.bloom import BloomForCausalLM as JaxBloom
from aphrodite_tpu.models.bloom import get_alibi_slopes as jax_slopes
from aphrodite_tpu.models.jais import JAISLMHeadModel as JaxJais
from aphrodite_tpu.models.mpt import MPTForCausalLM as JaxMpt
from aphrodite_tpu.models.mpt import get_mpt_alibi_slopes as jax_mpt_slopes
from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu.ops.decode_attention import \
    paged_decode_attention as jax_decode
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (
    check_kernel_shapes, load_hf_params_to_host,
    load_quantized_hf_params_to_host, params_from_jax)
from aphrodite_tpu_torch.models.bloom import get_alibi_slopes
from aphrodite_tpu_torch.models.mpt import get_mpt_alibi_slopes
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    paged_decode_attention, ref_paged_decode_attention)
from aphrodite_tpu_torch.quantization import get_quantization_method
from tests import test_torch_llama as llama_case
from tests.test_torch_cuda import PS, paged_batch
from tests.test_torch_falcon import compare_trees, write_falcon_checkpoint


@pytest.mark.parametrize("schedule", ["bloom", "mpt8", "mpt16"])
def test_alibi_slopes_match_jax(schedule):
    """Bloom's schedule (geometric, with the non-power-of-two correction)
    and MPT's (exponents over the head count rounded up to a power of two,
    the remainder interleaved; alibi_bias_max 8 and 16), heads 1-71."""
    for heads in range(1, 72):
        if schedule == "bloom":
            got, want = get_alibi_slopes(heads), jax_slopes(heads)
        else:
            bias_max = int(schedule[3:])
            got = get_mpt_alibi_slopes(heads, bias_max)
            want = jax_mpt_slopes(heads, bias_max)
        assert got.dtype == np.float32 and got.shape == (heads,)
        assert got.tobytes() == want.tobytes(), heads


# ----------------------------------------------------------------------
# Plain attention with ALiBi at head_dim 64
# ----------------------------------------------------------------------

# (query heads, kv heads) at head_dim 64: two and four query heads per kv
# head (few heads: the interpreter's time grows with them).
GEOMETRIES = {"qg2": (4, 2), "qg4": (8, 2)}


def _interpreted(monkeypatch, module):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interpreted(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(module.pl, "pallas_call", interpreted)


@pytest.mark.parametrize("geometry,kw", [
    ("qg2", {}), ("qg4", {"sliding_window": 30, "soft_cap": 5.0})],
    ids=["qg2-alibi", "qg4-alibi_window_softcap"])
def test_ref_decode_alibi_d64_matches_jax_kernel_interpret(geometry, kw):
    """bf16, head_dim 64, 8 sequences (one dead), page 16, the model's
    slope schedule, under the Pallas interpreter (one case per geometry):
    within 1 % of the largest output (the TPU kernel rounds q * sm_scale
    and the probabilities to bf16, the plain version keeps f32); the bias
    moves the result, and the wrapper takes the plain version on the
    CPU."""
    qh, kvh = GEOMETRIES[geometry]
    rng = np.random.default_rng(31)
    seqs = [(1, int(n)) for n in rng.integers(1, 64, size=7)]
    q, kv, kv_lens, pages, _ = paged_batch(rng, seqs, qh, kvh, 64,
                                           padded_seqs=8, padded_tokens=8)
    slopes = get_alibi_slopes(qh)
    qb = jnp.asarray(q, jnp.bfloat16)
    kvb = jnp.asarray(kv, jnp.bfloat16)
    want = np.asarray(jax_decode(qb, kvb, jnp.asarray(kv_lens),
                                 jnp.asarray(pages),
                                 jnp.asarray([7], jnp.int32),
                                 sm_scale=0.125, interpret=True,
                                 alibi_slopes=jnp.asarray(slopes), **kw),
                      np.float32)
    qt = torch.from_numpy(np.asarray(qb, np.float32)).to(torch.bfloat16)
    kvt = torch.from_numpy(np.asarray(kvb, np.float32)).to(torch.bfloat16)
    idx = (torch.from_numpy(kv_lens), torch.from_numpy(pages))
    alibi = torch.from_numpy(slopes)
    got = ref_paged_decode_attention(qt, kvt, *idx, sm_scale=0.125,
                                     alibi_slopes=alibi, **kw).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    assert not got[7].any() and not want[7].any()  # dead row: zeros
    plain = ref_paged_decode_attention(qt, kvt, *idx, sm_scale=0.125,
                                       **kw).float().numpy()
    assert np.abs(plain - want).max() > 0.05 * np.abs(want).max()
    np.testing.assert_array_equal(paged_decode_attention(
        qt, kvt, *idx, sm_scale=0.125, alibi_slopes=alibi,
        **kw).float().numpy(), got)


def _fork_case(rng, qh, kvh, D):
    T, S, pps = 24, 3, 6
    q = jnp.asarray(rng.standard_normal((T, qh, D)) * 0.3, jnp.bfloat16)
    kv = jnp.asarray(rng.standard_normal((S * pps + 2, PS, 2 * kvh, D))
                     * 0.3, jnp.bfloat16)
    kv_lens = np.asarray([10, 37, 8], np.int32)
    pages = np.arange(S * pps, dtype=np.int32).reshape(S, pps)
    cu = np.asarray([0, 1, 16, 24], np.int32)
    ns = np.asarray([S], np.int32)
    return q, kv, kv_lens, pages, cu, ns


def test_jax_fork_takes_no_head_dim_64(monkeypatch):
    """The vendored ALiBi fork (where the JAX package sends ALiBi prefill;
    its gate, _kernel_supports, passes head_dim 64 on 16-token pages)
    broadcasts its softmax stats over 128 lanes and asserts at head_dim 64
    (aphrodite_tpu/ops/rpa_alibi_kernel.py: broadcast_to_shape). So
    Bloom-560m's prefill is held against the jnp reference below, and the
    fork at head_dim 128 (test_ref_ragged_alibi_matches_jax_fork_interpret
    here and in tests/test_torch_alibi.py)."""
    _interpreted(monkeypatch, jax_fork)
    q, kv, kv_lens, pages, cu, ns = _fork_case(np.random.default_rng(32),
                                               4, 2, 64)
    with pytest.raises(AssertionError):
        jax_fork.ragged_paged_attention_alibi(
            q, kv, jnp.asarray(kv_lens), jnp.asarray(pages),
            jnp.asarray(cu), jnp.asarray(ns),
            jnp.asarray(get_alibi_slopes(4)), sm_scale=0.25,
            num_kv_pages_per_block=2, num_queries_per_block=8)


def test_ref_ragged_alibi_matches_jax_fork_interpret(monkeypatch):
    """Against the vendored ALiBi fork under the interpreter at head_dim
    128 (the fork takes no 64, above) and four query heads per kv head (one
    and two are in tests/test_torch_alibi.py): a decode row, a prefill and
    a chunk on a cached prefix, within 1 % of the largest output."""
    _interpreted(monkeypatch, jax_fork)
    qh, kvh = GEOMETRIES["qg4"]
    rng = np.random.default_rng(32)
    q, kv, kv_lens, pages, cu, ns = _fork_case(rng, qh, kvh, 128)
    slopes = get_alibi_slopes(qh)
    want = np.asarray(jax_fork.ragged_paged_attention_alibi(
        q, kv, jnp.asarray(kv_lens), jnp.asarray(pages), jnp.asarray(cu),
        jnp.asarray(ns), jnp.asarray(slopes), sm_scale=0.25,
        num_kv_pages_per_block=2, num_queries_per_block=8), np.float32)
    qt, kvt = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
               for a in (q, kv))
    args = (qt, kvt, *(torch.from_numpy(a) for a in (kv_lens, pages, cu, ns)))
    got = ref_ragged_paged_attention(*args, sm_scale=0.25,
                                     alibi_slopes=torch.from_numpy(slopes))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    torch.testing.assert_close(
        ragged_paged_attention(*args, sm_scale=0.25,
                               alibi_slopes=torch.from_numpy(slopes)),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [{}, {"sliding_window": 7, "soft_cap": 2.0}],
                         ids=["alibi", "alibi_window_softcap"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_ref_ragged_alibi_d64_matches_jax_reference(geometry, kw):
    """f32 against the jnp reference (the JAX package's CPU path): only the
    order of the f32 sums differs (1e-5). Slopes scaled up so that the
    bias dominates distant keys."""
    qh, kvh = GEOMETRIES[geometry]
    seqs = [(1, 23), (9, 9), (7, 40), (6, 6)]
    rng = np.random.default_rng(33)
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages, cu = paged_batch(rng, seqs, qh, kvh, 64,
                                            padded_seqs=8,
                                            padded_tokens=tokens + 4)
    slopes = get_mpt_alibi_slopes(qh) * 4
    ns = np.asarray([len(seqs)], np.int32)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kv),
                              jnp.asarray(kv_lens), jnp.asarray(pages),
                              jnp.asarray(cu), jnp.asarray(ns),
                              sm_scale=0.3, alibi_slopes=jnp.asarray(slopes),
                              **kw))
    got = ref_ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kv, kv_lens, pages, cu, ns)),
        sm_scale=0.3, alibi_slopes=torch.from_numpy(slopes), **kw).numpy()
    np.testing.assert_allclose(got[:tokens], want[:tokens], rtol=1e-5,
                               atol=1e-5)
    assert not got[tokens:].any()


# ----------------------------------------------------------------------
# Bloom, MPT and JAIS checkpoints
# ----------------------------------------------------------------------

VOCAB = 512
# Tiny configs with the published keys of each family: 6 heads (Bloom's and
# JAIS's slopes take their non-power-of-two branch), 5 for MPT (its
# interleaved remainder), head_dim 8.
CONFIGS = {
    "bloom": dict(architectures=["BloomForCausalLM"], hidden_size=48,
                  n_head=6, n_layer=2, layer_norm_epsilon=1e-5),
    "mpt": dict(architectures=["MPTForCausalLM"], d_model=40, n_heads=5,
                n_layers=2, expansion_ratio=4, max_seq_len=128,
                no_bias=True, attn_config={"alibi": True,
                                           "alibi_bias_max": 8}),
    "jais": dict(architectures=["JAISLMHeadModel"], n_embd=48, n_head=6,
                 n_layer=2, n_inner=72, n_positions=128,
                 embeddings_scale=3.0, width_scale=0.5,
                 scale_qk_dot_by_d=True, position_embedding_type="alibi",
                 activation_function="swiglu", layer_norm_epsilon=1e-5),
}
JAX_CLASSES = {"bloom": JaxBloom, "mpt": JaxMpt, "jais": JaxJais}


def write_checkpoint(path, family: str, seed: int = 0) -> str:
    """A checkpoint of one family from a seed, with the tensor names and
    layouts HF stores: Linear weights [out, in] (JAIS's Conv1D [in, out]),
    q|k|v fused (Bloom head-major, MPT and JAIS [Q; K; V]); norms near one
    and biases near zero."""
    from safetensors.numpy import save_file

    cfg = dict(CONFIGS[family], vocab_size=VOCAB, torch_dtype="float32")
    rng = np.random.default_rng(seed)
    H = cfg.get("hidden_size") or cfg.get("d_model") or cfg["n_embd"]
    layers = cfg.get("n_layer") or cfg["n_layers"]

    def w(rows, cols):
        return (rng.standard_normal((rows, cols))
                * cols**-0.5).astype(np.float32)

    def vec(n, center=0.0):
        return (center + 0.1 * rng.standard_normal(n)).astype(np.float32)

    t = {}
    if family == "bloom":
        t.update({"transformer.word_embeddings.weight": w(VOCAB, H),
                  "transformer.word_embeddings_layernorm.weight": vec(H, 1),
                  "transformer.word_embeddings_layernorm.bias": vec(H),
                  "transformer.ln_f.weight": vec(H, 1),
                  "transformer.ln_f.bias": vec(H)})
        for i in range(layers):
            p = f"transformer.h.{i}."
            t.update({
                p + "input_layernorm.weight": vec(H, 1),
                p + "input_layernorm.bias": vec(H),
                p + "self_attention.query_key_value.weight": w(3 * H, H),
                p + "self_attention.query_key_value.bias": vec(3 * H),
                p + "self_attention.dense.weight": w(H, H),
                p + "self_attention.dense.bias": vec(H),
                p + "post_attention_layernorm.weight": vec(H, 1),
                p + "post_attention_layernorm.bias": vec(H),
                p + "mlp.dense_h_to_4h.weight": w(4 * H, H),
                p + "mlp.dense_h_to_4h.bias": vec(4 * H),
                p + "mlp.dense_4h_to_h.weight": w(H, 4 * H),
                p + "mlp.dense_4h_to_h.bias": vec(H)})
    elif family == "mpt":
        F = cfg["expansion_ratio"] * H
        t.update({"transformer.wte.weight": w(VOCAB, H),
                  "transformer.norm_f.weight": vec(H, 1)})
        for i in range(layers):
            p = f"transformer.blocks.{i}."
            t.update({
                p + "norm_1.weight": vec(H, 1),
                p + "attn.Wqkv.weight": w(3 * H, H),
                p + "attn.out_proj.weight": w(H, H),
                p + "norm_2.weight": vec(H, 1),
                p + "ffn.up_proj.weight": w(F, H),
                p + "ffn.down_proj.weight": w(H, F)})
    else:
        F = cfg["n_inner"]
        t.update({"transformer.wte.weight": w(VOCAB, H),
                  "transformer.ln_f.weight": vec(H, 1),
                  "transformer.ln_f.bias": vec(H)})
        for i in range(layers):
            p = f"transformer.h.{i}."
            t.update({
                p + "ln_1.weight": vec(H, 1), p + "ln_1.bias": vec(H),
                p + "attn.c_attn.weight": w(H, 3 * H),
                p + "attn.c_attn.bias": vec(3 * H),
                p + "attn.c_proj.weight": w(H, H),
                p + "attn.c_proj.bias": vec(H),
                p + "ln_2.weight": vec(H, 1), p + "ln_2.bias": vec(H),
                p + "mlp.c_fc.weight": w(H, F), p + "mlp.c_fc.bias": vec(F),
                p + "mlp.c_fc2.weight": w(H, F),
                p + "mlp.c_fc2.bias": vec(F),
                p + "mlp.c_proj.weight": w(F, H),
                p + "mlp.c_proj.bias": vec(H)})
    save_file(t, str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Checkpoint directories by family."""
    return {family: write_checkpoint(tmp_path_factory.mktemp(family), family)
            for family in CONFIGS}


def _models(model_dir, family):
    jax_config = JaxModelConfig(model=model_dir, dtype="float32")
    config = ModelConfig(model=model_dir, dtype="float32")
    return JAX_CLASSES[family](jax_config), get_model_class(config)(config)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_host_tree_and_hooks_match_jax(checkpoints, family):
    """The fused q|k|v splits (and JAIS's untransposed Conv1D tensors), byte
    for byte, and the hooks both packages read from the config: slopes
    (bytes), muP scales, the attention scale, norms and MLP form."""
    jax_model, model = _models(checkpoints[family], family)
    assert type(model).__name__ == type(jax_model).__name__
    compare_trees(jax_load_hf(jax_model, checkpoints[family]),
                  load_hf_params_to_host(model, checkpoints[family]))
    assert (model.alibi_slopes.numpy().tobytes()
            == np.asarray(jax_model.alibi_slopes).tobytes())
    for hook in ("num_heads", "num_kv_heads", "head_dim", "intermediate_size",
                 "sm_scale", "embedding_multiplier", "logit_scale",
                 "use_rope", "gated_mlp", "ungated_act", "norm_bias",
                 "embedding_norm", "mlp_bias", "tie_word_embeddings",
                 "rms_eps"):
        # (The JAX Llama body names no logit_scale unless a model sets
        # one; the port's default is None.)
        assert getattr(model, hook) == getattr(jax_model, hook, None), hook


CACHES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "fp8_e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_forward_logits_match_jax(checkpoints, family, cache):
    """A prefill step, a mixed step on a cached prefix and a pure decode
    step through both models on the same parameters (the JAX host tree,
    fused, carried over by params_from_jax), in f32, on an f32, a bf16
    and an E4M3 cache (the last with per-layer scales folded into q and
    the output): logits within 1e-4 of each row's largest, argmax equal.
    No rotation touches K under ALiBi, so its rows are the same f32
    products on both sides and the E4M3 cache must hold the same bytes
    (the bf16 one within one ulp: see below)."""
    model_dir = checkpoints[family]
    jax_model, model = _models(model_dir, family)
    jparams = jax_model.fuse_projections(jax.tree.map(
        jnp.asarray, jax_load_hf(jax_model, model_dir)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    shape = (jax_model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    tdtype, jdtype = CACHES[cache]
    jkv = jnp.zeros(shape, jdtype)
    kv = torch.zeros(shape, dtype=tdtype)
    np_scales = ((np.asarray([0.05, 0.04], np.float32),
                  np.asarray([0.03, 0.06], np.float32))
                 if cache == "fp8_e4m3" else None)
    jscales = (None if np_scales is None
               else tuple(jnp.asarray(a) for a in np_scales))
    scales = (None if np_scales is None
              else tuple(torch.from_numpy(a) for a in np_scales))
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
        jkv, jhidden = jax_model.forward(jparams, jkv, jb, kv_scales=jscales)
        hidden = model.forward(params, kv, tb, scales)
        jlogits = np.asarray(jax_model.compute_logits(
            jparams, jhidden[jb.logits_indices]))[:len(rows)]
        logits = model.compute_logits(
            params, hidden[tb.logits_indices[:len(rows)]]).numpy()
        err = np.abs(logits - jlogits).max(-1)
        assert (err <= 1e-4 * np.abs(jlogits).max(-1)).all(), err
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()
        live = kv[:, :llama_case.NUM_PAGES]
        jlive = np.asarray(jkv[:, :llama_case.NUM_PAGES])
        if cache == "fp8_e4m3":
            np.testing.assert_array_equal(live.view(torch.uint8).numpy(),
                                          jlive.view(np.uint8))
        else:
            # f32: the order of the f32 sums; bf16 pages: that order's
            # last-bit differences round to one bf16 ulp now and then (one
            # value in 10^4 here), 2^-7 of the value at most.
            np.testing.assert_allclose(
                live.float().numpy(), jlive.astype(np.float32),
                rtol=1e-5 if cache == "float32" else 2.0**-7, atol=1e-5)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_greedy_tokens_match_jax_engine(checkpoints, family):
    """Chunked prefill (a 16-token budget) mixed with decodes, then 8-step
    decode windows, as tests/test_torch_engine.py."""
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


# ----------------------------------------------------------------------
# What raises
# ----------------------------------------------------------------------


@pytest.mark.parametrize("family", [*sorted(CONFIGS), "falcon"])
def test_quantized_checkpoint_of_a_fused_model_raises(checkpoints,
                                                      tmp_path, family):
    """GPTQ/AWQ checkpoints of these models (each fuses q|k|v) are not
    loaded: the message names the model and the queue item."""
    if family == "falcon":
        model_dir = write_falcon_checkpoint(tmp_path, "7b")
        model = get_model_class(ModelConfig(model=model_dir, dtype="float32"))
        model = model(ModelConfig(model=model_dir, dtype="float32"))
    else:
        model_dir = checkpoints[family]
        _, model = _models(model_dir, family)
    with pytest.raises(NotImplementedError,
                       match=f"{type(model).__name__} stores fused tensors"):
        load_quantized_hf_params_to_host(model, model_dir, "gptq")


# Published widths the card's quantized products do not take: Falcon-7B's
# hidden 4544 (N of wo and fc2, and of q|k|v at 73 heads of 64) and
# JAIS-13b's MLP of 13653; Bloom-560m's fit.
WIDTHS = {
    "falcon-7b": (dict(architectures=["FalconForCausalLM"],
                       hidden_size=4544, num_attention_heads=71,
                       num_hidden_layers=2, multi_query=True,
                       parallel_attn=True, vocab_size=65024), True),
    "jais-13b": (dict(architectures=["JAISLMHeadModel"], n_embd=5120,
                      n_head=40, n_layer=2, n_inner=13653,
                      vocab_size=84992), True),
    "bloom-560m": (dict(architectures=["BloomForCausalLM"], hidden_size=1024,
                        n_head=16, n_layer=2, vocab_size=250880), False),
}


@pytest.mark.parametrize("method", ["gptq", "int8", "fp8"])
@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_quantized_weights_off_the_kernels_widths_raise(name, method):
    """On the card a quantized product takes N a multiple of 128 and K of
    64; the loader holds every weight a method quantizes to that before it
    loads anything (check_kernel_shapes), naming the weight."""
    hf, raises = WIDTHS[name]
    config = ModelConfig(model="unused", dtype="bfloat16", hf_config=dict(hf))
    model = get_model_class(config)(config)
    quant = get_quantization_method(method)
    if raises:
        with pytest.raises(NotImplementedError, match="cannot serve"):
            check_kernel_shapes(model, quant)
    else:
        check_kernel_shapes(model, quant)
