"""Slice 15 of the port against the JAX package, on the CPU: head_dim 96 and
256 in the plain attention versions, LongRoPE tables, GeGLU and the
(1 + w) norm, and Phi-3, Gemma, Gemma2 and Gemma3 checkpoints.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: the plain decode and ragged attention at head_dim 96
and 256 and QH/KV 1, 2 and 4 (window on and off, a soft cap, bf16 and
E4M3 pages) against the JAX jnp reference; compute_rope_tables with
Phi-3's short and long factors; gelu_and_mul and the Gemma norm; tiny
Phi3ForCausalLM (head_dim 96, LongRoPE with the long factors chosen, a
window of 6), GemmaForCausalLM, Gemma2ForCausalLM (sandwich norms, both
soft caps, query_pre_attn_scalar, local and global layers) and
Gemma3ForCausalLM (two rope bases, the (1 + w) q/k norm, layer_types)
checkpoints written here from a seed, all at head_dim 96 or 256: host
trees byte for byte, forwards, then greedy tokens of ``LLM.generate``. On
the CPU the port's wrappers take their plain versions; the CUDA kernels at
these head_dims are held against those by tests/test_torch_cuda.py on the
card.
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
from aphrodite_tpu_torch.common.config import DeviceConfig, ModelConfig
from aphrodite_tpu_torch.loader import gguf as tgguf
from aphrodite_tpu_torch.loader.weights import (
    load_hf_params_to_host, load_quantized_hf_params_to_host,
    params_from_jax)
from aphrodite_tpu_torch.models import layers
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    check_kernel_inputs, paged_decode_attention)
from tests import gguf_writer as W
from tests import test_torch_llama as llama_case
from tests.test_torch_cuda import paged_batch
from tests.test_torch_qwen import _pages

# ----------------------------------------------------------------------
# Plain attention at head_dim 96 and 256
# ----------------------------------------------------------------------


@pytest.mark.parametrize("page_type", ["bf16", "e4m3"])
@pytest.mark.parametrize("qg", [1, 2, 4])
@pytest.mark.parametrize("head_dim", [96, 256])
def test_ref_attention_at_head_dim_96_and_256_matches_jax_reference(
        head_dim, qg, page_type):
    """The plain ragged version (prefill, a chunk on a cached prefix,
    decode rows) and the plain decode version (its rows) at Phi-3-mini's
    and Gemma's head_dims, 2 kv heads, against the JAX package's jnp
    reference on the same pages, with no window, then a window of 7 with a
    soft cap: f32 sums in another order only, so 1e-5 of the largest
    output. The wrappers take the plain versions on the CPU."""
    rng = np.random.default_rng(10 * head_dim + qg)
    qh, kvh = 2 * qg, 2
    seqs = [(1, 23), (9, 9), (7, 40), (1, 31)]
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages, cu = paged_batch(rng, seqs, qh, kvh, head_dim,
                                            padded_seqs=6,
                                            padded_tokens=tokens + 3)
    jkv, kvt, scale = _pages(kv, page_type)
    ns = np.asarray([len(seqs)], np.int32)
    qt = torch.from_numpy(q)
    idx = [torch.from_numpy(a) for a in (kv_lens, pages, cu, ns)]
    last = cu[1:len(seqs) + 1] - 1
    qd = np.zeros((6, qh, head_dim), np.float32)
    qd[:len(seqs)] = q[last]
    dcu = np.minimum(np.arange(7), len(seqs)).astype(np.int32)
    for extra in ({}, {"sliding_window": 7, "soft_cap": 2.0}):
        kw = dict(sm_scale=head_dim**-0.5 * scale, **extra)
        want = np.asarray(jax_ref(jnp.asarray(q), jkv, jnp.asarray(kv_lens),
                                  jnp.asarray(pages), jnp.asarray(cu),
                                  jnp.asarray(ns), **kw))
        got = ref_ragged_paged_attention(qt, kvt, *idx, **kw).numpy()
        np.testing.assert_allclose(got[:tokens], want[:tokens], rtol=0,
                                   atol=1e-5 * np.abs(want[:tokens]).max())
        assert not got[tokens:].any()
        np.testing.assert_array_equal(
            ragged_paged_attention(qt, kvt, *idx, **kw).numpy(), got)
        # Decode: one row per sequence, its last token.
        want_d = np.asarray(jax_ref(
            jnp.asarray(qd), jkv, jnp.asarray(kv_lens), jnp.asarray(pages),
            jnp.asarray(dcu), jnp.asarray(ns), **kw))
        got_d = paged_decode_attention(torch.from_numpy(qd), kvt, idx[0],
                                       idx[1], **kw).numpy()
        np.testing.assert_allclose(got_d[:len(seqs)], want_d[:len(seqs)],
                                   rtol=0,
                                   atol=1e-5 * np.abs(want_d).max())
        assert not got_d[len(seqs):].any()  # dead rows: zeros


class _OnCard:
    """What the kernels' rules read of a tensor, as if it lay on the card
    (a CUDA tensor cannot be made here)."""

    def __init__(self, shape, dtype):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


def _case(head_dim, qh=8, kvh=2):
    return (_OnCard((4, qh, head_dim), torch.bfloat16),
            _OnCard((3, 16, 2 * kvh, head_dim), torch.float8_e4m3fn))


@pytest.mark.parametrize("head_dim", [96, 256])
def test_kernel_rules_take_96_and_256_but_no_option_there(head_dim):
    """check_kernel_inputs (both wrappers' rules on a card) takes head_dim
    96 and 256 at QH/KV 1 to 16 and above (17, and Falcon-7B's 71), and
    ALiBi there, and still raises for blocksparse there and at any
    head_dim outside 64, 80, 96, 128 and 256 (8 either side of each)."""
    for qh in (2, 4, 8, 32, 34, 142):
        check_kernel_inputs(*_case(head_dim, qh=qh), ())
        check_kernel_inputs(*_case(head_dim, qh=qh), (),
                            alibi_slopes=_OnCard((qh,), torch.float32))
    offsets = _OnCard((8,), torch.int32)
    with pytest.raises(ValueError, match="blocksparse at head_dim 128"):
        check_kernel_inputs(*_case(head_dim), (), bs_head_offsets=offsets)
    for bad in (head_dim - 8, head_dim + 8):
        with pytest.raises(ValueError, match="head_dim in"):
            check_kernel_inputs(*_case(bad), ())


# ----------------------------------------------------------------------
# LongRoPE, GeGLU, the (1 + w) norm
# ----------------------------------------------------------------------

LONGROPE = {"type": "longrope", "original_max_position_embeddings": 32,
            "short_factor": list(np.linspace(1.0, 1.9, 48)),
            "long_factor": list(np.linspace(1.0, 40.0, 48))}


@pytest.mark.parametrize("max_position,factor", [(32, "short"), (96, "long"),
                                                 (96, "su")])
def test_longrope_tables_match_jax(max_position, factor):
    """Phi-3's LongRoPE at head_dim 96: the short factors at the original
    length, the long ones past it with the attention factor (also under
    the older name "su"), against JAX compute_rope_tables at 1e-6."""
    scaling = dict(LONGROPE, type="su" if factor == "su" else "longrope")
    cos, sin = layers.compute_rope_tables(96, max_position, base=10000.0,
                                          rope_scaling=scaling)
    jcos, jsin = jlayers.compute_rope_tables(96, max_position, base=10000.0,
                                             rope_scaling=scaling)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0,
                               atol=1e-6)
    plain, _ = layers.compute_rope_tables(96, max_position, base=10000.0)
    assert (cos - plain).abs().max() > 1e-2  # the factors move the table
    if max_position > 32:  # attention factor past the original length
        assert cos.abs().max() > 1.0


def test_gelu_and_mul_and_gemma_norm_match_jax():
    """gelu_and_mul (the tanh form) in f32 and bf16, and a Gemma model's
    (1 + w) RMSNorm (the sum in the weight's dtype), against the JAX
    package's functions on the same inputs."""
    rng = np.random.default_rng(7)
    gate = (rng.standard_normal((5, 24)) * 2).astype(np.float32)
    up = rng.standard_normal((5, 24)).astype(np.float32)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-6),
                               (torch.bfloat16, jnp.bfloat16, 1e-2)):
        got = layers.gelu_and_mul(torch.from_numpy(gate).to(dtype),
                                  torch.from_numpy(up).to(dtype))
        want = jlayers.gelu_and_mul(jnp.asarray(gate, jdtype),
                                    jnp.asarray(up, jdtype))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
    config = dict(GEMMA_BASE, architectures=["GemmaForCausalLM"])
    model = get_model_class(ModelConfig(
        model="unused", dtype="float32", hf_config=config))(ModelConfig(
            model="unused", dtype="float32", hf_config=dict(config)))
    jax_model = jax_model_class(JaxModelConfig(
        model="unused", dtype="float32", hf_config=dict(config)))(
            JaxModelConfig(model="unused", dtype="float32",
                           hf_config=dict(config)))
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    got = model._norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jax_model._norm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    plain = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    assert np.abs(got - plain.numpy()).max() > 0.5  # the offset is live


# ----------------------------------------------------------------------
# Phi-3, Gemma, Gemma2 and Gemma3 checkpoints
# ----------------------------------------------------------------------

# Windows of 6 keys, shorter than every prompt below. Phi-3: head_dim 96
# (hidden / heads), MHA, LongRoPE with the long factors chosen (the
# served length 64 past the original 32). Gemma: head_dim 256 at QH/KV 1
# (Gemma-7B's ratio); Gemma2 at 2 (Gemma-2-9B's), its even layer local;
# Gemma3 at 4, local and global layers named by layer_types.
GEMMA_BASE = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                  num_attention_heads=2, num_key_value_heads=2, head_dim=256,
                  vocab_size=256, max_position_embeddings=64,
                  rms_norm_eps=1e-6, rope_theta=10000.0,
                  hidden_act="gelu_pytorch_tanh", torch_dtype="float32")
CONFIGS = {
    "Phi3ForCausalLM": dict(
        hidden_size=192, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=2, vocab_size=256,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=6, tie_word_embeddings=False, torch_dtype="float32",
        rope_scaling=LONGROPE),
    "GemmaForCausalLM": dict(GEMMA_BASE),
    "Gemma2ForCausalLM": dict(
        GEMMA_BASE, num_attention_heads=4, attn_logit_softcapping=5.0,
        final_logit_softcapping=10.0, query_pre_attn_scalar=64,
        sliding_window=6),
    "Gemma3ForCausalLM": dict(
        GEMMA_BASE, num_attention_heads=4, num_key_value_heads=1,
        query_pre_attn_scalar=256, sliding_window=6, rope_theta=1000000.0,
        rope_local_base_freq=10000.0,
        layer_types=["full_attention", "sliding_attention"]),
}
ARCHS = sorted(CONFIGS)
GEMMA_NORMS = ("input_layernorm", "post_attention_layernorm",
               "pre_feedforward_layernorm", "post_feedforward_layernorm")


def write_checkpoint(path, arch: str, seed: int = 0) -> str:
    """A checkpoint of the architecture's tiny config from a seed, as HF
    stores it: Linear weights [out, in]; Phi-3's fused qkv_proj and
    gate_up_proj; Gemma's norms as w of (1 + w), near zero, Gemma2's and
    Gemma3's four a layer, Gemma3's q_norm / k_norm [head_dim]; no lm_head
    where the embeddings are tied."""
    from safetensors.numpy import save_file

    cfg = CONFIGS[arch]
    rng = np.random.default_rng(seed)
    H, F, V = (cfg[k] for k in ("hidden_size", "intermediate_size",
                                "vocab_size"))
    NH = cfg["num_attention_heads"]
    NKV = cfg["num_key_value_heads"]
    D = cfg.get("head_dim", H // NH)
    gemma = arch.startswith("Gemma")

    def w(rows, cols):
        return (rng.standard_normal((rows, cols))
                * cols**-0.5).astype(np.float32)

    def norm(n=H):
        return ((0.0 if gemma else 1.0)
                + 0.1 * rng.standard_normal(n)).astype(np.float32)

    tensors = {"model.embed_tokens.weight": w(V, H),
               "model.norm.weight": norm()}
    if not cfg.get("tie_word_embeddings", gemma):
        tensors["lm_head.weight"] = w(V, H)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        tensors[p + "self_attn.o_proj.weight"] = w(H, NH * D)
        tensors[p + "mlp.down_proj.weight"] = w(H, F)
        if arch == "Phi3ForCausalLM":
            tensors[p + "self_attn.qkv_proj.weight"] = w((NH + 2 * NKV) * D,
                                                         H)
            tensors[p + "mlp.gate_up_proj.weight"] = w(2 * F, H)
        else:
            tensors.update({
                p + "self_attn.q_proj.weight": w(NH * D, H),
                p + "self_attn.k_proj.weight": w(NKV * D, H),
                p + "self_attn.v_proj.weight": w(NKV * D, H),
                p + "mlp.gate_proj.weight": w(F, H),
                p + "mlp.up_proj.weight": w(F, H)})
        names = GEMMA_NORMS if arch in ("Gemma2ForCausalLM",
                                        "Gemma3ForCausalLM") \
            else GEMMA_NORMS[:2]
        tensors.update({p + n + ".weight": norm() for n in names})
        if arch == "Gemma3ForCausalLM":
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
    """The class the registry picks and what it reads (head_dim, windows
    per layer, scale, soft caps, tied head, rope tables); host trees byte
    for byte, and params_from_jax carries the new parameters
    (post_attn_norm, post_ff_norm, q_norm, k_norm) over as they are."""
    jax_model, model = _models(checkpoints[arch])
    assert type(model).__name__ == type(jax_model).__name__ == arch
    assert model.head_dim == jax_model.head_dim == (
        96 if arch == "Phi3ForCausalLM" else 256)
    assert model.sm_scale == jax_model.sm_scale
    assert model.tie_word_embeddings == jax_model.tie_word_embeddings
    assert model.attn_softcap == jax_model.attn_softcap
    assert model.logit_softcap == jax_model.logit_softcap
    assert model.norm_weight_offset == jax_model.norm_weight_offset
    if arch in ("Gemma2ForCausalLM", "Gemma3ForCausalLM"):
        local = [bool(v) for v in np.asarray(jax_model._local_layer_mask())]
        assert model.local_layers == local
        assert model.layer_windows == [6 if v else None for v in local]
        assert model.sliding_window is jax_model.sliding_window is None
    else:
        assert model.layer_windows is None
        assert model.sliding_window == jax_model.sliding_window == (
            6 if arch == "Phi3ForCausalLM" else None)
    names = ["_cos", "_sin"]
    if arch == "Gemma3ForCausalLM":
        names += ["_cos_local", "_sin_local"]
        assert model.local_rope_layers == local
    else:
        assert model.local_rope_layers is None
    for name in names:
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(getattr(jax_model, name)))
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
    carried = params_from_jax(jax.tree.map(np.asarray, want))
    for name in ("post_attn_norm", "post_ff_norm", "q_norm", "k_norm"):
        assert (name in got["layers"]) == (
            name in jax_model.param_shapes()["layers"])
        if name in got["layers"]:
            assert torch.equal(carried["layers"][name], got["layers"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(checkpoints, arch):
    """A prefill step, a mixed step on a cached prefix and a pure decode
    step through both models on the same parameters (the JAX host tree,
    fused, carried over by params_from_jax), in f32. The prompts (11 and
    10 tokens) are longer than the windows of 6. Logits within 1e-4 of
    each row's largest, argmax equal; the caches equal to 1e-5."""
    jax_model, model = _models(checkpoints[arch])
    jparams = jax_model.fuse_projections(jax.tree.map(
        jnp.asarray, jax_load_hf(jax_model, checkpoints[arch])))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert "wqkv" in params["layers"] and "w13" in params["layers"]
    shape = (jax_model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    jkv = jnp.zeros(shape, jnp.float32)
    kv = torch.zeros(shape)
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, 256, n).tolist() for n in (11, 10, 5))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_engine(checkpoints, arch):
    """Chunked prefill (a 16-token budget) mixed with decodes, then 4-step
    decode windows, as tests/test_torch_engine.py; prompts up to 19
    tokens, three times the windows."""
    kw = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
              num_device_blocks_override=64, block_size=8,
              num_scheduler_steps=4, skip_tokenizer_init=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 19, 11)]
    sp = dict(temperature=0.0, max_tokens=10, ignore_eos=True,
              detokenize=False)
    want = JaxLLM(model=checkpoints[arch], **kw).generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    got = LLM(model=checkpoints[arch], device="cpu", **kw).generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(**sp))
    for g, w in zip(got, want):
        assert len(g.outputs[0].token_ids) == 10
        assert g.outputs[0].token_ids == w.outputs[0].token_ids


def test_gemma_hooks_move_the_result(checkpoints):
    """The hooks are live: Gemma2 without its soft caps, its sandwich
    norms, its local windows or its query scale, and Gemma3 without its
    local rope table or its q/k norm, give other logits on the same
    inputs."""
    def run(model, params):
        shape = (model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
                 *model.kv_cache_shape_suffix)
        ids = np.random.default_rng(3).integers(0, 256, 20).tolist()
        _, tb, _ = llama_case._batch([(ids, 0, [0, 1, 2, 3, 4])], 24, 2)
        h = model.forward(params, torch.zeros(shape), tb)
        return model.compute_logits(params, h[tb.logits_indices[:1]])

    for arch, off in (("Gemma2ForCausalLM", "attn_softcap"),
                      ("Gemma2ForCausalLM", "logit_softcap"),
                      ("Gemma2ForCausalLM", "sandwich"),
                      ("Gemma2ForCausalLM", "window"),
                      ("Gemma2ForCausalLM", "sm_scale"),
                      ("Gemma3ForCausalLM", "local_rope"),
                      ("Gemma3ForCausalLM", "qk_norm")):
        _, model = _models(checkpoints[arch])
        params = model.fuse_projections(
            load_hf_params_to_host(model, checkpoints[arch]))
        with_hook = run(model, params)
        if off in ("attn_softcap", "logit_softcap"):
            setattr(model, off, 0.0)
        elif off == "sandwich":
            params["layers"].pop("post_attn_norm")
        elif off == "window":
            model.layer_windows = [None] * model.num_layers
        elif off == "sm_scale":
            model.sm_scale = model.head_dim**-0.5  # no query_pre_attn_scalar
        elif off == "local_rope":
            model.local_rope_layers = None
        else:
            model.qk_norm = lambda q, k, lp, layer: (q, k)
        assert (run(model, params) - with_hook).abs().max() > 1e-3, off


# ----------------------------------------------------------------------
# What this slice leaves raising, and the device default
# ----------------------------------------------------------------------


def test_quantized_phi3_and_gemma_gguf_raise(checkpoints, tmp_path):
    """Phi-3's fused tensors keep its quantized checkpoints out, as for
    every model with split mappings; GGUF files of gemma, gemma2 and phi3
    raise in the loader (their tensors have no mapping yet)."""
    _, phi3 = _models(checkpoints["Phi3ForCausalLM"])
    with pytest.raises(NotImplementedError, match="quantized checkpoints"):
        load_quantized_hf_params_to_host(
            phi3, checkpoints["Phi3ForCausalLM"], "gptq")
    _, gemma = _models(checkpoints["GemmaForCausalLM"])
    for arch in ("gemma", "gemma2", "phi3"):
        path = str(tmp_path / f"{arch}.gguf")
        W.write_gguf(path, {"general.architecture": arch},
                     [("token_embd.weight", [64, 256], tgguf.GGML_F32,
                       np.zeros((256, 64), "<f4").tobytes())])
        with pytest.raises(NotImplementedError, match=arch):
            tgguf.load_gguf_params_to_host(gemma, path)


def test_chunked_prompt_near_max_model_len_fits_the_page_table(checkpoints):
    """A prompt whose length plus its first prefill chunk passes
    max_model_len (60 + 16 > 64; Phi-3-mini-4k's prompts of up to 4032
    tokens in chunks of 2048 at 4096 on the card): the scheduler sized the
    block table for the whole prompt plus the chunk, past the runner's
    pages_per_seq, and the JAX engine still raises on it (a ValueError
    while filling the page table). The port caps the slots at the
    model-length ceiling: the tokens equal an unchunked run's."""
    prompt = np.random.default_rng(9).integers(0, 256, 60).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True,
                        detokenize=False)
    runs = []
    for budget in (64, 16):
        llm = LLM(model=checkpoints["Phi3ForCausalLM"], device="cpu",
                  dtype="float32", block_size=8, max_num_seqs=4,
                  max_num_batched_tokens=budget,
                  num_device_blocks_override=64, num_scheduler_steps=1,
                  skip_tokenizer_init=True)
        runs.append(llm.generate(prompt_token_ids=[prompt],
                                 sampling_params=sp)[0].outputs[0].token_ids)
        assert llm.engine.runner.pages_per_seq == 8
    assert len(runs[0]) == 4 and runs[1] == runs[0]


def test_device_defaults_to_the_card():
    """DeviceConfig defaults to "cuda" and never probes: without a card
    the default raises, it does not fall back to the CPU."""
    assert DeviceConfig.__dataclass_fields__["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceConfig()
    assert DeviceConfig("cpu").device == "cpu"
