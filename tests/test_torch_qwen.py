"""Slice 8 of the port against the JAX package, on the CPU: head_dim 64 and
every QH/KV up to 16 in the plain attention versions, Qwen2 / Qwen2.5,
Qwen3 and Mistral, GGUF qwen2 files, the page-gather probe and W4A8 at
group 16.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: the plain decode and ragged attention at head_dim 64
and QH/KV 3, 5, 6, 7 and 16 (against the JAX decode kernel under the
Pallas interpreter, and the jnp reference), tiny Qwen2ForCausalLM (q|k|v
bias, tied), Qwen3ForCausalLM (the per-head q/k RMSNorm) and
MistralForCausalLM (a window shorter than the prompt) checkpoints written
here from a seed (forwards, then greedy tokens of ``LLM.generate``), a
tiny qwen2 .gguf file with bias tensors, the probe's plain version against
the TPU probe under the TPU interpret mode, and the plain W4A8 product at
group 16 against the Pallas kernel in interpret mode. On the CPU the
port's wrappers take their plain versions; the CUDA kernels at these
shapes are held against those by tests/test_torch_cuda.py on the card.
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
from aphrodite_tpu.loader import gguf as jgguf
from aphrodite_tpu.loader.weights import \
    load_hf_params_to_host as jax_load_hf
from aphrodite_tpu.models.registry import \
    get_model_class as jax_model_class
from aphrodite_tpu.ops import quant_matmul as jqm
from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu.ops.decode_attention import \
    paged_decode_attention as jax_decode
from aphrodite_tpu.quantization import int4 as jint4
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader import gguf as tgguf
from aphrodite_tpu_torch.loader.weights import (load_hf_params_to_host,
                                                params_from_jax)
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops import quant_matmul as tqm
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    paged_decode_attention, ref_paged_decode_attention)
from aphrodite_tpu_torch.tools import probe_gather_bw as tprobe
from tests import gguf_writer as W
from tests import test_torch_llama as llama_case
from tests.test_torch_cuda import paged_batch

# ----------------------------------------------------------------------
# Plain attention at head_dim 64 and QH/KV 3 to 16
# ----------------------------------------------------------------------

E4M3_SCALE = 0.02  # narrow pages hold value / scale; the scale folds into q


def _pages(kv, page_type):
    """f32 values as bf16 or E4M3 pages, as numpy for JAX and as a tensor
    of the same bytes for the port (E4M3: value / E4M3_SCALE)."""
    if page_type == "bf16":
        jkv = jnp.asarray(kv, jnp.bfloat16)
        return jkv, torch.from_numpy(np.asarray(jkv, np.float32)).to(
            torch.bfloat16), 1.0
    jkv = jnp.asarray(kv / E4M3_SCALE, jnp.float8_e4m3fn)
    raw = np.asarray(jkv).view(np.uint8).copy()
    return jkv, torch.from_numpy(raw).view(torch.float8_e4m3fn), E4M3_SCALE


def test_ref_decode_at_head_dim_64_qg7_matches_jax_kernel_interpret():
    """Qwen2.5-0.5B's shape (7 query heads per kv head, head_dim 64) on
    E4M3 pages, as its card path runs, with a window and a soft cap: the
    JAX decode kernel under the Pallas interpreter (about 20 s, so one
    case; the other shapes are held against the jnp reference below)."""
    rng = np.random.default_rng(21)
    seqs = [(1, int(n)) for n in rng.integers(1, 64, size=7)]
    q, kv, kv_lens, pages, _ = paged_batch(rng, seqs, 7, 1, 64,
                                           padded_seqs=8, padded_tokens=8)
    jkv, kvt, scale = _pages(kv, "e4m3")
    qb = jnp.asarray(q, jnp.bfloat16)
    kw = dict(sm_scale=0.125 * scale, sliding_window=20, soft_cap=5.0)
    want = np.asarray(jax_decode(qb, jkv, jnp.asarray(kv_lens),
                                 jnp.asarray(pages),
                                 jnp.asarray([7], jnp.int32), interpret=True,
                                 **kw), np.float32)
    qt = torch.from_numpy(np.asarray(qb, np.float32)).to(torch.bfloat16)
    idx = (torch.from_numpy(kv_lens), torch.from_numpy(pages))
    got = ref_paged_decode_attention(qt, kvt, *idx, **kw).float().numpy()
    # The TPU kernel rounds q * sm_scale and the probabilities to bf16;
    # the plain version keeps f32: 1% of the largest output.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    assert not got[7].any() and not want[7].any()  # dead row: zeros
    np.testing.assert_array_equal(
        paged_decode_attention(qt, kvt, *idx, **kw).float().numpy(), got)


@pytest.mark.parametrize("page_type", ["bf16", "e4m3"])
@pytest.mark.parametrize("window", [None, 7], ids=["full", "window7"])
@pytest.mark.parametrize("qg", [3, 5, 6, 7, 16])
def test_ref_attention_every_qg_at_head_dim_64_matches_jax_reference(
        qg, window, page_type):
    """The plain ragged version (prefill, a chunk on a cached prefix,
    decode rows) and the plain decode version (its rows) at head_dim 64
    and 2 kv heads, against the JAX package's jnp reference on the same
    pages: f32 sums in another order only, so 1e-5 of the largest
    output. The wrappers take the plain versions on the CPU."""
    rng = np.random.default_rng(100 + qg)
    qh, kvh = 2 * qg, 2
    seqs = [(1, 23), (9, 9), (7, 40), (6, 6), (1, 31)]
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages, cu = paged_batch(rng, seqs, qh, kvh, 64,
                                            padded_seqs=8,
                                            padded_tokens=tokens + 4)
    jkv, kvt, scale = _pages(kv, page_type)
    kw = dict(sm_scale=0.3 * scale, sliding_window=window)
    ns = np.asarray([len(seqs)], np.int32)
    want = np.asarray(jax_ref(jnp.asarray(q), jkv, jnp.asarray(kv_lens),
                              jnp.asarray(pages), jnp.asarray(cu),
                              jnp.asarray(ns), **kw))
    qt = torch.from_numpy(q)
    idx = [torch.from_numpy(a) for a in (kv_lens, pages, cu, ns)]
    got = ref_ragged_paged_attention(qt, kvt, *idx, **kw).numpy()
    atol = 1e-5 * np.abs(want[:tokens]).max()
    np.testing.assert_allclose(got[:tokens], want[:tokens], rtol=0,
                               atol=atol)
    assert not got[tokens:].any()
    np.testing.assert_array_equal(
        ragged_paged_attention(qt, kvt, *idx, **kw).numpy(), got)
    # Decode: one row per sequence, its last token, as the JAX reference
    # computes it with one query token per sequence.
    last = cu[1:len(seqs) + 1] - 1
    qd = np.zeros((8, qh, 64), np.float32)
    qd[:len(seqs)] = q[last]
    dcu = np.minimum(np.arange(9), len(seqs)).astype(np.int32)
    want_d = np.asarray(jax_ref(jnp.asarray(qd), jkv, jnp.asarray(kv_lens),
                                jnp.asarray(pages), jnp.asarray(dcu),
                                jnp.asarray(ns), **kw))
    got_d = paged_decode_attention(torch.from_numpy(qd), kvt, idx[0],
                                   idx[1], **kw).numpy()
    np.testing.assert_allclose(got_d[:len(seqs)], want_d[:len(seqs)],
                               rtol=0, atol=1e-5 * np.abs(want_d).max())
    assert not got_d[len(seqs):].any()  # dead rows: zeros


# ----------------------------------------------------------------------
# Qwen2, Qwen3 and Mistral checkpoints
# ----------------------------------------------------------------------

# 7 query heads per kv head at head_dim 16 (Qwen2.5's ratio), a window of 6
# keys for Mistral, shorter than every prompt below.
BASE = dict(hidden_size=56, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=7, num_key_value_heads=1, head_dim=16,
            vocab_size=256, max_position_embeddings=128, rms_norm_eps=1e-6,
            rope_theta=1000000.0, torch_dtype="float32")
CONFIGS = {
    "Qwen2ForCausalLM": dict(BASE, tie_word_embeddings=True,
                             sliding_window=128, use_sliding_window=False),
    "Qwen3ForCausalLM": dict(BASE, tie_word_embeddings=False,
                             attention_bias=False),
    "MistralForCausalLM": dict(BASE, tie_word_embeddings=False,
                               num_attention_heads=4, num_key_value_heads=2,
                               sliding_window=6),
}
ARCHS = sorted(CONFIGS)


def write_checkpoint(path, arch: str, seed: int = 0) -> str:
    """A checkpoint of the architecture's tiny config from a seed, as HF
    stores it: Linear weights [out, in]; Qwen2's q|k|v biases; Qwen3's
    q_norm / k_norm [head_dim]; no lm_head where the embeddings are tied;
    norms near one."""
    from safetensors.numpy import save_file

    cfg = CONFIGS[arch]
    rng = np.random.default_rng(seed)
    H, F, V, D = (cfg[k] for k in ("hidden_size", "intermediate_size",
                                   "vocab_size", "head_dim"))
    NH, NKV = cfg["num_attention_heads"], cfg["num_key_value_heads"]

    def w(rows, cols):
        return (rng.standard_normal((rows, cols))
                * cols**-0.5).astype(np.float32)

    def norm(n=H):
        return (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    def bias(n):
        return (0.1 * rng.standard_normal(n)).astype(np.float32)

    tensors = {"model.embed_tokens.weight": w(V, H),
               "model.norm.weight": norm()}
    if not cfg["tie_word_embeddings"]:
        tensors["lm_head.weight"] = w(V, H)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        tensors.update({
            p + "input_layernorm.weight": norm(),
            p + "self_attn.q_proj.weight": w(NH * D, H),
            p + "self_attn.k_proj.weight": w(NKV * D, H),
            p + "self_attn.v_proj.weight": w(NKV * D, H),
            p + "self_attn.o_proj.weight": w(H, NH * D),
            p + "post_attention_layernorm.weight": norm(),
            p + "mlp.gate_proj.weight": w(F, H),
            p + "mlp.up_proj.weight": w(F, H),
            p + "mlp.down_proj.weight": w(H, F)})
        if arch == "Qwen2ForCausalLM":
            tensors.update({p + "self_attn.q_proj.bias": bias(NH * D),
                            p + "self_attn.k_proj.bias": bias(NKV * D),
                            p + "self_attn.v_proj.bias": bias(NKV * D)})
        if arch == "Qwen3ForCausalLM":
            tensors.update({p + "self_attn.q_norm.weight": norm(D),
                            p + "self_attn.k_norm.weight": norm(D)})
    save_file(tensors, str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump(dict(cfg, architectures=[arch]), f)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return {arch: write_checkpoint(tmp_path_factory.mktemp(arch), arch)
            for arch in ARCHS}


def _models(model_dir):
    jax_config = JaxModelConfig(model=model_dir, dtype="float32")
    config = ModelConfig(model=model_dir, dtype="float32")
    return (jax_model_class(jax_config)(jax_config),
            get_model_class(config)(config))


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_and_host_tree_match_jax(checkpoints, arch):
    """The class the registry picks and what it reads: bias (Qwen2),
    q/k norm (Qwen3), window (Mistral), tied head; host trees byte for
    byte."""
    jax_model, model = _models(checkpoints[arch])
    assert type(model).__name__ == type(jax_model).__name__ == arch
    assert model.attention_bias == (arch == "Qwen2ForCausalLM")
    assert model.attention_bias == jax_model.attention_bias
    assert model.tie_word_embeddings == jax_model.tie_word_embeddings
    assert model.sliding_window == jax_model.sliding_window == (
        6 if arch == "MistralForCausalLM" else None)
    want = jax_load_hf(jax_model, checkpoints[arch])
    got = load_hf_params_to_host(model, checkpoints[arch])
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, a), (_, b) in zip(flat_w, flat_g):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert a.tobytes() == np.ascontiguousarray(b).tobytes(), path
    layers = got["layers"]
    assert ("bq" in layers) == (arch == "Qwen2ForCausalLM")
    assert ("q_norm" in layers) == (arch == "Qwen3ForCausalLM")
    assert ("lm_head" in got) == (arch != "Qwen2ForCausalLM")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(checkpoints, arch):
    """A prefill step, a mixed step on a cached prefix and a pure decode
    step through both models on the same parameters (the JAX host tree,
    fused, carried over by params_from_jax), in f32. The prompts (11 and
    10 tokens) are longer than Mistral's window of 6. Logits within 1e-4
    of each row's largest, argmax equal; the caches equal to 1e-5."""
    jax_model, model = _models(checkpoints[arch])
    jparams = jax_model.fuse_projections(jax.tree.map(
        jnp.asarray, jax_load_hf(jax_model, checkpoints[arch])))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    shape = (jax_model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    jkv = jnp.zeros(shape, jnp.float32)
    kv = torch.zeros(shape)
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, BASE["vocab_size"], n).tolist()
               for n in (11, 10, 5))
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
        np.testing.assert_allclose(kv[:, :llama_case.NUM_PAGES].numpy(),
                                   np.asarray(jkv)[:, :llama_case.NUM_PAGES],
                                   rtol=1e-5, atol=1e-5)


def test_qk_norm_and_window_move_the_result(checkpoints):
    """The hooks are live: Qwen3 without its q/k norm, and Mistral without
    its window, give other logits on the same inputs."""
    for arch, off in (("Qwen3ForCausalLM", "qk_norm"),
                      ("MistralForCausalLM", "window")):
        _, model = _models(checkpoints[arch])
        params = model.fuse_projections(
            load_hf_params_to_host(model, checkpoints[arch]))
        shape = (model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
                 *model.kv_cache_shape_suffix)
        ids = np.random.default_rng(3).integers(0, 256, 20).tolist()
        _, tb, _ = llama_case._batch([(ids, 0, [0, 1, 2, 3, 4])], 24, 2)

        def logits():
            h = model.forward(params, torch.zeros(shape), tb)
            return model.compute_logits(params, h[tb.logits_indices[:1]])

        with_hook = logits()
        if off == "qk_norm":
            model.qk_norm = lambda q, k, lp, layer: (q, k)
        else:
            model.sliding_window = None
        assert (logits() - with_hook).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_engine(checkpoints, arch):
    """Chunked prefill (a 16-token budget) mixed with decodes, then 4-step
    decode windows, as tests/test_torch_engine.py; prompts up to 19
    tokens, three times Mistral's window."""
    kw = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
              num_device_blocks_override=128, block_size=8,
              num_scheduler_steps=4, skip_tokenizer_init=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, BASE["vocab_size"], n).tolist()
               for n in (5, 19, 11)]
    sp = dict(temperature=0.0, max_tokens=10, ignore_eos=True,
              detokenize=False)
    want = JaxLLM(model=checkpoints[arch], **kw).generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    got = LLM(model=checkpoints[arch], device="cpu", **kw).generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(**sp))
    for g, w in zip(got, want):
        assert len(g.outputs[0].token_ids) == 10
        assert g.outputs[0].token_ids == w.outputs[0].token_ids


def test_embedding_aliases_wait_for_the_pooling_runner():
    config = ModelConfig(model="unused", dtype="float32", hf_config=dict(
        BASE, architectures=["MistralModel"]))
    with pytest.raises(ValueError, match="not ported"):
        get_model_class(config)
    for arch in ("AquilaModel", "AquilaForCausalLM", "InternLMForCausalLM",
                 "LLaMAForCausalLM", "XverseForCausalLM"):
        config = ModelConfig(model="unused", dtype="float32",
                             hf_config=dict(BASE, architectures=[arch]))
        assert get_model_class(config).__name__ == "LlamaForCausalLM"


# ----------------------------------------------------------------------
# GGUF qwen2 files
# ----------------------------------------------------------------------


def write_qwen2_gguf(path, hf_dir) -> str:
    """The Qwen2 checkpoint above as a GGUF file of architecture qwen2:
    f32 tensors under llama.cpp's names, the q|k|v biases included, the
    head tied (no output.weight)."""
    from safetensors.numpy import load_file

    cfg = CONFIGS["Qwen2ForCausalLM"]
    hf = load_file(f"{hf_dir}/model.safetensors")
    names = {"model.embed_tokens.weight": "token_embd.weight",
             "model.norm.weight": "output_norm.weight"}
    for i in range(cfg["num_hidden_layers"]):
        p, b = f"model.layers.{i}.", f"blk.{i}."
        names.update({
            p + "input_layernorm.weight": b + "attn_norm.weight",
            p + "post_attention_layernorm.weight": b + "ffn_norm.weight",
            p + "mlp.gate_proj.weight": b + "ffn_gate.weight",
            p + "mlp.up_proj.weight": b + "ffn_up.weight",
            p + "mlp.down_proj.weight": b + "ffn_down.weight",
            p + "self_attn.o_proj.weight": b + "attn_output.weight"})
        for n in "qkv":
            names[p + f"self_attn.{n}_proj.weight"] = b + f"attn_{n}.weight"
            names[p + f"self_attn.{n}_proj.bias"] = b + f"attn_{n}.bias"
    tensors = []
    for hf_name, gg_name in names.items():
        arr = hf[hf_name]
        dims = [arr.shape[1], arr.shape[0]] if arr.ndim == 2 else [
            arr.shape[0]]
        tensors.append((gg_name, dims, tgguf.GGML_F32,
                        arr.astype("<f4").tobytes()))
    metadata = {
        "general.architecture": "qwen2",
        "qwen2.embedding_length": cfg["hidden_size"],
        "qwen2.block_count": cfg["num_hidden_layers"],
        "qwen2.attention.head_count": cfg["num_attention_heads"],
        "qwen2.attention.head_count_kv": cfg["num_key_value_heads"],
        "qwen2.feed_forward_length": cfg["intermediate_size"],
        "qwen2.context_length": cfg["max_position_embeddings"],
        "qwen2.attention.layer_norm_rms_epsilon": cfg["rms_norm_eps"],
        "qwen2.rope.freq_base": cfg["rope_theta"],
        "qwen2.attention.key_length": cfg["head_dim"],
    }
    W.write_gguf(str(path), metadata, tensors)
    return str(path)


def test_qwen2_gguf_matches_jax_gguf_path(checkpoints, tmp_path):
    """A qwen2 .gguf file with bias tensors through both packages' GGUF
    paths: the synthesized config and the host trees equal, and greedy
    tokens of LLM(model=<file>.gguf) equal the JAX engine's."""
    path = write_qwen2_gguf(tmp_path / "qwen2.gguf",
                            checkpoints["Qwen2ForCausalLM"])
    cfg = tgguf.gguf_to_hf_config(path)
    assert cfg == jgguf.gguf_to_hf_config(path)
    assert cfg["architectures"] == ["Qwen2ForCausalLM"]
    assert cfg["tie_word_embeddings"]
    jax_config = JaxModelConfig(model=path, dtype="float32",
                                skip_tokenizer_init=True)
    config = ModelConfig(model=path, dtype="float32",
                         skip_tokenizer_init=True)
    jax_model = jax_model_class(jax_config)(jax_config)
    model = get_model_class(config)(config)
    assert type(model).__name__ == "Qwen2ForCausalLM"
    want = jgguf.load_gguf_params_to_host(jax_model, path)
    got = tgguf.load_gguf_params_to_host(model, path)
    for name in ("bq", "bk", "bv", "wq"):
        np.testing.assert_array_equal(got["layers"][name].numpy(),
                                      np.asarray(want["layers"][name]))
    kw = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
              num_device_blocks_override=128, block_size=8,
              num_scheduler_steps=4, skip_tokenizer_init=True)
    prompts = [np.random.default_rng(5).integers(0, 256, n).tolist()
               for n in (7, 13)]
    sp = dict(temperature=0.0, max_tokens=8, ignore_eos=True,
              detokenize=False)
    want_out = JaxLLM(model=path, **kw).generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    got_out = LLM(model=path, device="cpu", **kw).generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(**sp))
    for g, w in zip(got_out, want_out):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids


# ----------------------------------------------------------------------
# The page-gather probe (TPU kernel row 9)
# ----------------------------------------------------------------------


def test_probe_plain_version_matches_the_tpu_probe_interpreted(monkeypatch):
    """The TPU probe (tools/probe_gather_bw.py: gather) under the TPU
    interpret mode, with the module's globals set small (16 sequences, 2
    kv heads, a 64-page cache; the function itself untouched), against
    the port's plain version on the same pages at equal kv lengths. The
    TPU kernel sums each row in f32 in its reduction's order, the port in
    f64 rounded once, so they differ by that rounding only: 1e-6 of the
    sum of the rows' magnitudes."""
    from jax.experimental.pallas import tpu as pltpu

    from tools import probe_gather_bw as jprobe

    S, NKV, NUM_PAGES, KV_LEN = 16, 2, 64, 150
    for name, value in (("S", S), ("NKV", NKV), ("NUM_PAGES", NUM_PAGES)):
        monkeypatch.setattr(jprobe, name, value)
    rng = np.random.default_rng(0)
    pages = (rng.standard_normal((NUM_PAGES, 16, 2 * NKV, 128))
             * 0.1).astype(np.float32)
    jpages = jnp.asarray(pages, jnp.bfloat16)
    kv_lens = np.full((S,), KV_LEN, np.int32)
    pi = np.zeros((S, jprobe.PPS), np.int32)
    used = -(-KV_LEN // 16)
    for i in range(S):
        pi[i, :used] = rng.choice(NUM_PAGES - 1, size=used, replace=False)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jprobe.gather(jnp.asarray(kv_lens),
                                        jnp.asarray(pi), jpages))
    tpages = torch.from_numpy(np.asarray(jpages, np.float32)).to(
        torch.bfloat16)
    got = tprobe.gather(torch.from_numpy(kv_lens), torch.from_numpy(pi),
                        tpages).numpy()
    assert got.shape == want.shape == (S // 8, 8, 128)
    magnitude = sum(np.abs(np.asarray(jpages[pi[8 * b, 8 * w], 0, 0],
                                      np.float32)).sum()
                    for b in range(S // 8) for w in range(-(-used // 8)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * magnitude)
    assert np.abs(want).max() > 0.1


# ----------------------------------------------------------------------
# W4A8 at group 16 (TPU kernel row 6)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("layers,idx", [(1, None), (2, 1)],
                         ids=["flat", "stacked"])
def test_w4a8_plain_at_group_16_matches_jax_interpret(layers, idx):
    """GGUF Q2_K / Q3_K pack at group 16: the plain W4A8 product against
    the JAX reference and int4p_matmul_w4a8_pallas in interpret mode (1e-5
    of the largest output, the JAX package's own tolerance for its kernel
    against its reference)."""
    rng = np.random.default_rng(16)
    T, K, N, G = 32, 512, 256, 16
    c = jint4.quantize_from_float(
        rng.standard_normal((layers, K, N)).astype(np.float32), group=G)
    if idx is None:
        c = {k: v[0] for k, v in c.items()}
    x = (rng.standard_normal((T, K)) * 0.3).astype(np.float32)
    members = ("q4p", "scale", "zero")
    got = tqm.int4p_matmul_w4a8(torch.from_numpy(x),
                                *(torch.from_numpy(c[k]) for k in members),
                                G, layer_idx=idx).numpy()
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    one = {k: (v if idx is None else v[idx]) for k, v in jc.items()}
    ref = np.asarray(jqm.int4p_matmul_w4a8_ref(
        jnp.asarray(x), *(one[k] for k in members), G))
    kernel = np.asarray(jqm.int4p_matmul_w4a8_pallas(
        jnp.asarray(x), *(jc[k] for k in members), G, layer_idx=idx,
        interpret=True))
    for want in (ref, kernel):
        assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 1e-5
