"""Slice 17 of the port against the JAX package, on the CPU: Mixture-of-
Experts serving (routing, the grouped expert product in both of its
forms, experts_int8) and the Mixtral, Qwen2-MoE, Qwen3-MoE, OLMoE and
PhiMoE models.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: top-k routing in both softmax orders and with and
without renormalization, the sparsemixer, the grouped product (the
capacity and the loop form, each at T 1, 7, 33 and 70, f32 and bf16)
against the JAX ragged_dot product, experts_int8's quantizer byte for
byte; tiny checkpoints of the five models written by transformers
(``tests/utils.py`` make_tiny_checkpoint, as tests/test_model_zoo.py
builds them): the loader's tree against the JAX loader's, dense and with
experts_int8, and forwards (a prefill of more than 64 tokens, which takes
the loop form, a mixed step and a pure-decode step, which take the
capacity form) against the JAX classes through ``params_from_jax``; then
greedy tokens of ``LLM.generate`` against the JAX engine with 8-step
decode windows, dense and with experts_int8. The grouped product is plain
PyTorch on the card too (no kernel of its own); tests/test_torch_cuda.py
holds both forms against a plain per-token product there.
"""

import json
import os

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
from aphrodite_tpu.loader.weights import \
    quantize_params_at_load as jax_quantize_at_load
from aphrodite_tpu.models.registry import \
    get_model_class as jax_model_class
from aphrodite_tpu.ops import moe as jmoe
from aphrodite_tpu.quantization import experts_int8 as jexperts_int8
from aphrodite_tpu.quantization import get_quantization_method as jax_method
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (
    dummy_params, load_hf_params_to_host, load_quantized_hf_params_to_host,
    params_from_jax, quantize_params_at_load)
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.models.mixtral import MixtralForCausalLM
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops import moe
from aphrodite_tpu_torch.quantization import experts_int8
from aphrodite_tpu_torch.quantization import get_quantization_method
from tests import test_torch_llama as llama_case
from tests.utils import make_tiny_checkpoint

# ----------------------------------------------------------------------
# Routing
# ----------------------------------------------------------------------


@pytest.mark.parametrize("renormalize", [True, False])
@pytest.mark.parametrize("pre_softmax", [True, False])
def test_topk_routing_matches_jax(pre_softmax, renormalize):
    """Router logits [70, 8], top 2 and top 8 (k = E): ids equal, weights
    within 1e-6."""
    logits = np.random.default_rng(1).standard_normal((70, 8)).astype(
        np.float32) * 2.0
    for k in (2, 8):
        jw, ji = jmoe.topk_routing(jnp.asarray(logits), k, renormalize,
                                   pre_softmax)
        w, ids = moe.topk_routing(torch.from_numpy(logits), k, renormalize,
                                  pre_softmax)
        assert w.dtype == torch.float32 and ids.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("jitter", [0.01, 0.3])
def test_sparsemixer_routing_matches_jax(jitter):
    """PhiMoE's two masked argmax rounds on logits [70, 16] (bf16 logits
    too, upcast to f32 on both sides): ids equal, weights within 1e-6 and
    not renormalized."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((70, 16)).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jl = jnp.asarray(logits, jdtype)
        jw, ji = jmoe.sparsemixer_routing(jl, jitter)
        tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(dtype)
        w, ids = moe.sparsemixer_routing(tl, jitter)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6)
        # Not renormalized: a pair's weights need not sum to 1.
        assert (w.sum(-1) - 1.0).abs().max() > 0.1


# ----------------------------------------------------------------------
# The grouped expert product
# ----------------------------------------------------------------------


def _experts(rng, E, H, F, T, k):
    x = rng.standard_normal((T, H)).astype(np.float32)
    w1, w3 = ((rng.standard_normal((E, H, F)) * H**-0.5).astype(np.float32)
              for _ in range(2))
    w2 = (rng.standard_normal((E, F, H)) * F**-0.5).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    return x, w1, w3, w2, logits


FORMS = {"capacity": moe.capacity_expert_mlp, "loop": moe.loop_expert_mlp}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7, 33, 70])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_grouped_expert_mlp_matches_jax(form, T, dtype):
    """Both forms against the JAX package's grouped_expert_mlp (sort by
    expert, ragged_dot with f32 sums) on the same inputs and routing, 8
    experts, top 2 (and top 8 = E at T 33): each output row within 1e-5
    (f32) or 1e-2 (bf16, which rounds the activation and the result) of
    its largest magnitude. grouped_expert_mlp picks the capacity form at
    T <= CAPACITY_MAX_T and in decode steps, else the loop form."""
    rng = np.random.default_rng(T)
    k = 8 if T == 33 else 2
    x, w1, w3, w2, logits = _experts(rng, 8, 64, 48, T, k)
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdtype = getattr(torch, dtype)
    jx, jw1, jw3, jw2 = (jnp.asarray(a, jdtype) for a in (x, w1, w3, w2))
    weights, ids = jmoe.topk_routing(jnp.asarray(logits), k)
    want = np.asarray(jmoe.grouped_expert_mlp(jx, jw1, jw3, jw2, weights,
                                              ids), np.float32)

    def port(a):
        return torch.from_numpy(np.array(a, np.float32)).to(tdtype)

    args = ([port(a) for a in (jx, jw1, jw3, jw2)]
            + [torch.from_numpy(np.array(weights)),
               torch.from_numpy(np.array(ids))])
    got = FORMS[form](*args)
    assert got.dtype == tdtype and got.shape == (T, 64)
    tol = 1e-5 if dtype == "float32" else 1e-2
    err = np.abs(got.float().numpy() - want).max(-1)
    assert (err <= tol * np.abs(want).max(-1)).all(), err
    picked = moe.grouped_expert_mlp(*args, decode=(form == "capacity"))
    if form == "capacity" or T > moe.CAPACITY_MAX_T:
        assert torch.equal(picked, got)


def test_routed_experts_and_plain_product_match_jax():
    """The port's router logits, top-k routing and apply_experts against
    the JAX package's moe_mlp on bf16 inputs, within 1e-2 of each row's
    largest; and the plain per-token product the card holds both forms
    against, against the JAX grouped product in f32 within 1e-5 of a
    row."""
    rng = np.random.default_rng(9)
    x, w1, w3, w2, _ = _experts(rng, 6, 64, 32, 40, 3)
    router = (rng.standard_normal((64, 6)) * 0.125).astype(np.float32)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, router, w1, w3, w2)]
    want = np.asarray(jmoe.moe_mlp(*jargs, 3, renormalize=False),
                      np.float32)
    tx, trouter, tw1, tw3, tw2 = (torch.from_numpy(np.array(
        a, np.float32)).to(torch.bfloat16) for a in jargs)
    weights, ids = moe.topk_routing(moe.router_logits(tx, trouter), 3,
                                    renormalize=False)
    got = moe.apply_experts(tx, tw1, tw3, tw2, weights, ids)
    err = np.abs(got.float().numpy() - want).max(-1)
    assert (err <= 1e-2 * np.abs(want).max(-1)).all(), err
    weights, ids = jmoe.topk_routing(jnp.asarray(x @ router), 3)
    want = np.asarray(jmoe.grouped_expert_mlp(
        *(jnp.asarray(a) for a in (x, w1, w3, w2)), weights, ids))
    plain = moe.plain_expert_mlp(
        *(torch.from_numpy(a) for a in (x, w1, w3, w2)),
        torch.from_numpy(np.array(weights)), torch.from_numpy(np.array(ids)))
    err = np.abs(plain.numpy() - want).max(-1)
    assert (err <= 1e-5 * np.abs(want).max(-1)).all(), err


def test_capacity_form_by_static_shape():
    assert moe.capacity_form(moe.CAPACITY_MAX_T, decode=False)
    assert not moe.capacity_form(moe.CAPACITY_MAX_T + 1, decode=False)
    assert moe.capacity_form(256, decode=True)


def test_experts_int8_quantizer_and_materialize_match_jax():
    """experts_int8's quantize_from_float byte for byte against the JAX
    package's numpy one (an all-zero channel, exact .5 steps), and the
    per-layer dequantization equal to JAX materialize_experts."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 4, 32, 24)).astype(np.float32)
    w[1, 2, :, 5] = 0.0
    w[0, 0, :, 0] = np.arange(32) * 0.5 - 8.0
    want = jexperts_int8.quantize_from_float(w)
    got = experts_int8.quantize_from_float(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    for name in ("q", "scale"):
        assert got[name].numpy().tobytes() == want[name].tobytes(), name
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jm = jmoe.materialize_experts(
            {k: jnp.asarray(v[1]) for k, v in want.items()}, jdtype)
        tm = moe.materialize_experts({k: v[1] for k, v in got.items()}, dtype)
        assert tm.dtype == dtype
        np.testing.assert_array_equal(tm.float().numpy(),
                                      np.asarray(jm, np.float32))
    dense = torch.from_numpy(w[0])
    assert moe.materialize_experts(dense, torch.float32) is dense
    method = get_quantization_method("experts_int8")
    assert method is experts_int8
    assert (method.NAME, method.RUNTIME_QUANTIZE, method.EXPERT_ONLY) == (
        jexperts_int8.NAME, jexperts_int8.RUNTIME_QUANTIZE,
        jexperts_int8.EXPERT_ONLY)
    assert jax_method("experts_int8") is jexperts_int8


# ----------------------------------------------------------------------
# The five models
# ----------------------------------------------------------------------

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, tie_word_embeddings=False)
# Phi-3.5-MoE's LongRoPE at the tiny head_dim (16 / 2 factors), the long
# factors chosen: the served 128 positions exceed the original 32.
PHIMOE_ROPE = {"type": "longrope", "original_max_position_embeddings": 32,
               "short_factor": [1.0 + 0.1 * i for i in range(8)],
               "long_factor": [1.0 + 0.7 * i for i in range(8)],
               "short_mscale": 1.0, "long_mscale": 1.0}


def _hf_config(arch):
    """The tiny transformers config of each architecture: E 4 to 8, k 1
    to 4 (k = E on Qwen2-MoE)."""
    import transformers as tf

    if arch == "MixtralForCausalLM":
        return tf.MixtralConfig(intermediate_size=48, num_local_experts=4,
                                num_experts_per_tok=2, **TINY)
    if arch == "Qwen3MoeForCausalLM":
        return tf.Qwen3MoeConfig(intermediate_size=128,
                                 moe_intermediate_size=48, num_experts=8,
                                 num_experts_per_tok=2, head_dim=16,
                                 norm_topk_prob=True, **TINY)
    if arch == "Qwen2MoeForCausalLM":
        return tf.Qwen2MoeConfig(intermediate_size=128,
                                 moe_intermediate_size=32,
                                 shared_expert_intermediate_size=64,
                                 num_experts=4, num_experts_per_tok=4,
                                 decoder_sparse_step=1, **TINY)
    if arch == "OlmoeForCausalLM":
        return tf.OlmoeConfig(intermediate_size=32, num_experts=8,
                              num_experts_per_tok=1, **TINY)
    if arch == "PhimoeForCausalLM":
        return tf.PhimoeConfig(intermediate_size=48, num_local_experts=4,
                               num_experts_per_tok=2, attention_bias=True,
                               lm_head_bias=True, rope_theta=10000.0,
                               router_jitter_noise=0.01,
                               input_jitter_noise=0.0, sliding_window=None,
                               **TINY)
    raise ValueError(arch)


ARCHS = ["MixtralForCausalLM", "OlmoeForCausalLM", "PhimoeForCausalLM",
         "Qwen2MoeForCausalLM", "Qwen3MoeForCausalLM"]


def _perturb(path, seed):
    """Biases and norm weights off their initial zeros and ones (0.1 of
    noise), so that a bias or norm the forward drops shows."""
    from safetensors.numpy import load_file, save_file

    file = os.path.join(path, "model.safetensors")
    tensors = load_file(file)
    rng = np.random.default_rng(seed)
    for name, t in tensors.items():
        if name.endswith(".bias") or "norm" in name:
            tensors[name] = (t + 0.1 * rng.standard_normal(t.shape)).astype(
                t.dtype)
    save_file(tensors, file, metadata={"format": "pt"})


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    out = {}
    for seed, arch in enumerate(ARCHS):
        path = str(tmp_path_factory.mktemp(arch))
        make_tiny_checkpoint(path, _hf_config(arch))
        _perturb(path, seed)
        if arch == "PhimoeForCausalLM":
            with open(os.path.join(path, "config.json")) as f:
                cfg = json.load(f)
            cfg["rope_scaling"] = PHIMOE_ROPE
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(cfg, f)
        out[arch] = path
    return out


def _models(model_dir, quantization=None):
    jax_config = JaxModelConfig(model=model_dir, dtype="float32",
                                quantization=quantization)
    config = ModelConfig(model=model_dir, dtype="float32",
                         quantization=quantization)
    return (jax_model_class(jax_config)(jax_config),
            get_model_class(config)(config))


def _same_tree(want, got):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, a), (_, b) in zip(flat_w, flat_g):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert a.tobytes() == np.ascontiguousarray(b).tobytes(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_and_host_tree_match_jax(checkpoints, arch):
    """The class each package picks and what it reads (experts, top k,
    renormalization, biases, norms); the HF loader's tree against the JAX
    loader's byte for byte (experts stacked [L, E, ...]), then both
    quantized at load with experts_int8: the expert stacks become
    {q, scale} containers equal byte for byte, the rest stays dense."""
    jax_model, model = _models(checkpoints[arch])
    assert type(model).__name__ == type(jax_model).__name__
    for name in ("num_experts", "top_k", "intermediate_size",
                 "attention_bias", "o_proj_bias", "norm_type",
                 "lm_head_bias"):
        assert getattr(model, name) == getattr(jax_model, name), name
    assert model.renormalize == getattr(jax_model, "renormalize", True)
    assert model.expert_weights() == jax_model.expert_weights()
    assert model.quantizable_weights() == jax_model.quantizable_weights()
    np.testing.assert_array_equal(model._cos.numpy(),
                                  np.asarray(jax_model._cos))
    want = jax_load_hf(jax_model, checkpoints[arch])
    got = load_hf_params_to_host(model, checkpoints[arch])
    _same_tree(want, got)
    assert got["layers"]["w2"].shape[:2] == (2, model.num_experts)
    jax_model, model = _models(checkpoints[arch], "experts_int8")
    method = get_quantization_method("experts_int8")
    want = jax_quantize_at_load(jax_model, want, jax_method("experts_int8"))
    got = quantize_params_at_load(model, got, method)
    _same_tree(want, got)
    for name in ("w1", "w3", "w2"):
        assert set(got["layers"][name]) == {"q", "scale"}
    assert isinstance(got["layers"]["router"], torch.Tensor)
    assert isinstance(got["layers"]["wq"], torch.Tensor)


# More pages than tests/test_torch_llama.py's: prompts of up to 40 tokens.
NUM_PAGES, PPS = 48, 16


def _batch(rows, T, S, decode=False):
    jb, tb, _ = llama_case._batch(rows, T, S, decode, num_pages=NUM_PAGES,
                                  pps=PPS)
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(checkpoints, arch, monkeypatch):
    """A prefill of three prompts (86 tokens in a 96-token step: the loop
    form), a mixed step on their cached prefixes (16 tokens: the capacity
    form) and a pure-decode step (the capacity form, as in a decode
    window) through both models on the JAX host tree, fused, carried over
    by params_from_jax, in f32: logits within 1e-5 of each row's largest,
    argmax equal, caches within 1e-5. Each step's form is recorded."""
    jax_model, model = _models(checkpoints[arch])
    jparams = jax_model.fuse_projections(jax.tree.map(
        jnp.asarray, jax_load_hf(jax_model, checkpoints[arch])))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert "wqkv" in params["layers"] and "w13" not in params["layers"]
    forms = []
    for name in ("capacity_expert_mlp", "loop_expert_mlp"):
        fn = getattr(moe, name)
        monkeypatch.setattr(moe, name, lambda *a, _fn=fn, _n=name: (
            forms.append(_n.split("_")[0]), _fn(*a))[1])
    shape = (jax_model.num_layers, NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    jkv = jnp.zeros(shape, jnp.float32)
    kv = torch.zeros(shape)
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, 256, n).tolist() for n in (40, 30, 16))
    pa, pb, pc = list(range(0, 12)), list(range(12, 22)), list(range(22, 28))
    steps = [
        ([(a[:36], 0, pa), (b[:28], 0, pb), (c[:14], 0, pc)], 96, 4, False),
        ([(a[36:], 36, pa), (b[28:], 28, pb), (c[14:], 14, pc)], 16, 4,
         False),
        ([(a[:1], 40, pa), (b[:1], 30, pb), (c[:1], 16, pc)], 4, 4, True),
    ]
    for rows, T, S, decode in steps:
        jb, tb = _batch(rows, T, S, decode)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb)
        hidden = model.forward(params, kv, tb)
        jlogits = np.asarray(jax_model.compute_logits(
            jparams, jhidden[jb.logits_indices]))[:len(rows)]
        logits = model.compute_logits(
            params, hidden[tb.logits_indices[:len(rows)]]).numpy()
        err = np.abs(logits - jlogits).max(-1)
        assert (err <= 1e-5 * np.abs(jlogits).max(-1)).all(), err
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()
        np.testing.assert_allclose(kv[:, :NUM_PAGES].numpy(),
                                   np.asarray(jkv)[:, :NUM_PAGES],
                                   rtol=1e-5, atol=1e-5)
    L = model.num_layers
    assert forms == ["loop"] * L + ["capacity"] * (2 * L)


def test_model_hooks_move_the_result(checkpoints):
    """The MoE parts are live: without Qwen2-MoE's shared expert, OLMoE's
    q/k norm, PhiMoE's LM-head bias or sparsemixer (top-2 softmax routing
    in its place), or Qwen3-MoE's renormalization, the logits change."""
    def run(model, params):
        shape = (model.num_layers, NUM_PAGES + 1, llama_case.PS,
                 *model.kv_cache_shape_suffix)
        ids = np.random.default_rng(3).integers(0, 256, 20).tolist()
        _, tb = _batch([(ids, 0, list(range(5)))], 24, 2)
        h = model.forward(params, torch.zeros(shape), tb)
        return model.compute_logits(params, h[tb.logits_indices[:1]])

    for arch, off in (("Qwen2MoeForCausalLM", "shared"),
                      ("OlmoeForCausalLM", "qk_norm"),
                      ("PhimoeForCausalLM", "lm_head_b"),
                      ("PhimoeForCausalLM", "sparsemixer"),
                      ("Qwen3MoeForCausalLM", "renormalize")):
        _, model = _models(checkpoints[arch])
        params = model.fuse_projections(
            load_hf_params_to_host(model, checkpoints[arch]))
        with_hook = run(model, params)
        if off == "shared":
            params["layers"]["shared_expert_gate"] = torch.full_like(
                params["layers"]["shared_expert_gate"], -1e4)
        elif off == "qk_norm":
            model.qk_norm = lambda q, k, lp, layer: (q, k)
        elif off == "lm_head_b":
            params.pop("lm_head_b")
        elif off == "sparsemixer":
            model.route = lambda router, h: MixtralForCausalLM.route(
                model, router, h)
        else:
            model.renormalize = False
        assert (run(model, params) - with_hook).abs().max() > 1e-5, off


# ----------------------------------------------------------------------
# Engines, registry, dummy weights and what raises
# ----------------------------------------------------------------------


@pytest.mark.parametrize("quantization", [None, "experts_int8"])
def test_greedy_tokens_match_jax_engine(checkpoints, quantization):
    """Tiny Mixtral through both engines: chunked prefill of a 96-token
    budget (a 70-token prompt takes the loop form), then 8-step decode
    windows (the capacity form); dense and with experts_int8 on both
    sides. Greedy tokens equal."""
    kw = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=96,
              num_device_blocks_override=64, block_size=8,
              num_scheduler_steps=8, skip_tokenizer_init=True,
              quantization=quantization)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 70, 11)]
    sp = dict(temperature=0.0, max_tokens=12, ignore_eos=True,
              detokenize=False)
    path = checkpoints["MixtralForCausalLM"]
    want = JaxLLM(model=path, **kw).generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    llm = LLM(model=path, device="cpu", **kw)
    got = llm.generate(prompt_token_ids=prompts,
                       sampling_params=SamplingParams(**sp))
    for g, w in zip(got, want):
        assert len(g.outputs[0].token_ids) == 12
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
    runner = llm.engine.runner
    experts = runner.params["layers"]["w1"]
    assert isinstance(experts, dict) == (quantization is not None)
    assert max(runner.eager_forwards_by_tokens) > moe.CAPACITY_MAX_T


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_resolves_moe_architectures(arch):
    config = ModelConfig(model="unused", dtype="float32",
                         hf_config=dict(_hf_config(arch).to_dict(),
                                        architectures=[arch]))
    cls = get_model_class(config)
    assert cls.__name__ == jax_model_class(JaxModelConfig(
        model="unused", dtype="float32",
        hf_config=dict(config.hf_config))).__name__


@pytest.mark.parametrize("arch", [
    "GraniteMoeForCausalLM", "DbrxForCausalLM", "ArcticForCausalLM",
    "DeepseekForCausalLM", "DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM",
    "QuantMixtralForCausalLM"])
def test_registry_raises_for_moe_architectures_not_ported(arch):
    config = ModelConfig(model="unused", dtype="float32",
                         hf_config=dict(TINY, intermediate_size=48,
                                        architectures=[arch]))
    jax_model_class(JaxModelConfig(model="unused", dtype="float32",
                                   hf_config=dict(config.hf_config)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model_class(config)


def test_dummy_params_quantize_experts_only(checkpoints):
    """Dummy weights with experts_int8: the expert stacks are {q, scale}
    containers at [L, E, ...], drawn and quantized one layer at a time
    from the seed (the same containers again from the same seed); the
    router, attention and norms stay dense."""
    config = ModelConfig(model=checkpoints["Qwen2MoeForCausalLM"],
                         dtype="float32", quantization="experts_int8")
    model = get_model_class(config)(config)
    method = get_quantization_method("experts_int8")
    params = dummy_params(model, 0, torch.device("cpu"), torch.float32,
                          method=method)
    shapes = model.param_shapes()["layers"]
    for name in ("w1", "w3", "w2"):
        w = params["layers"][name]
        assert w["q"].dtype == torch.int8 and tuple(w["q"].shape) == \
            shapes[name]
        assert tuple(w["scale"].shape) == (*shapes[name][:2], 1,
                                           shapes[name][-1])
    for name in ("router", "wq", "shared_gate", "input_norm"):
        assert isinstance(params["layers"][name], torch.Tensor)
    again = dummy_params(model, 0, torch.device("cpu"), torch.float32,
                         method=method)
    assert torch.equal(again["layers"]["w2"]["q"], params["layers"]["w2"]["q"])
    dense = LlamaForCausalLM(ModelConfig(
        model="unused", dtype="float32",
        hf_config=dict(TINY, intermediate_size=48)))
    with pytest.raises(ValueError, match="declares none"):
        dummy_params(dense, 0, torch.device("cpu"), torch.float32,
                     method=method)


def test_quantized_moe_checkpoint_and_layer_mixing_raise(checkpoints):
    """A GPTQ/AWQ checkpoint of an MoE model raises naming the ROADMAP
    item; so do Qwen-MoE configs that mix dense and sparse layers, as in
    the JAX package."""
    _, model = _models(checkpoints["MixtralForCausalLM"])
    with pytest.raises(NotImplementedError, match="item 7"):
        load_quantized_hf_params_to_host(
            model, checkpoints["MixtralForCausalLM"], "gptq")
    for arch in ("Qwen2MoeForCausalLM", "Qwen3MoeForCausalLM"):
        hf = dict(_hf_config(arch).to_dict(), architectures=[arch],
                  mlp_only_layers=[1])
        config = ModelConfig(model="unused", dtype="float32", hf_config=hf)
        with pytest.raises(NotImplementedError, match="mixing"):
            get_model_class(config)(config)
