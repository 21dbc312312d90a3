"""Blocksparse attention and Phi-3-Small in the port against the JAX
package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: the plain decode and ragged attention with
blocksparse (against the JAX decode kernel and the vendored fork under the
Pallas interpreter, and the jnp reference), LayerNorm and the linear RoPE
table, and tiny Phi-3-Small checkpoints from tests/test_phi3small.py: the
host trees (the head-major q|k|v split, the gate/up de-interleave, the
biases, byte for byte), forwards with a float32 and an E4M3 cache, and
greedy tokens of ``LLM.generate``. Also a Llama checkpoint with q|k|v and
MLP biases in its config. On the CPU the port's attention wrappers take
their plain versions; the CUDA kernels with blocksparse are held against
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
from aphrodite_tpu.models.layers import \
    compute_rope_tables as jax_rope_tables
from aphrodite_tpu.models.layers import layer_norm as jax_layer_norm
from aphrodite_tpu.models.llama import LlamaForCausalLM as JaxLlama
from aphrodite_tpu.models.phi3small import \
    Phi3SmallForCausalLM as JaxPhi3Small
from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu.ops.decode_attention import \
    paged_decode_attention as jax_decode
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (
    dummy_params, load_hf_params_to_host, load_quantized_hf_params_to_host,
    params_from_jax)
from aphrodite_tpu_torch.models.layers import compute_rope_tables, layer_norm
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    MASK_VALUE, paged_decode_attention, ref_paged_decode_attention)
from tests import test_phi3small as jax_case
from tests import test_torch_llama as llama_case
from tests.test_torch_alibi import _interpreted
from tests.test_torch_cuda import PS, paged_batch


def test_layer_norm_and_linear_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 48)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = layer_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(w),
                         torch.from_numpy(b), 1e-5).float().numpy()
        want = np.asarray(jax_layer_norm(jnp.asarray(x, jdtype),
                                         jnp.asarray(w), jnp.asarray(b),
                                         1e-5), np.float32)
        # The same f32 arithmetic; rsqrt and the mean's order may differ
        # in the last f32 bit, which bf16 rounding can carry one step.
        tol = 1e-6 if dtype == torch.float32 else 2.0**-7
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    scaling = {"type": "linear", "factor": 2.5}
    cos, sin = compute_rope_tables(16, 96, base=10000.0,
                                   rope_scaling=scaling)
    jcos, jsin = jax_rope_tables(16, 96, base=10000.0, rope_scaling=scaling)
    assert cos.numpy().tobytes() == np.asarray(jcos, np.float32).tobytes()
    assert sin.numpy().tobytes() == np.asarray(jsin, np.float32).tobytes()
    plain, _ = compute_rope_tables(16, 96, base=10000.0)
    assert not torch.equal(plain, cos)


# ----------------------------------------------------------------------
# Plain attention with blocksparse
# ----------------------------------------------------------------------

# (query heads, kv heads): one and four query heads per kv head.
GEOMETRIES = {"qg1": (2, 2), "qg4": (8, 2)}
# (block size, local blocks, vertical stride): a block of two pages and
# one smaller than a page (page 16).
BLOCKS = {"block32": (32, 1, 4), "block8": (8, 2, 3)}


def _offsets(qh, vert, homo, rng):
    """Per-head phases: all 0 (homo) or spread as Phi-3-Small's hetero
    pattern is (several heads per kv head with different phases)."""
    if homo:
        return np.zeros(qh, np.int32)
    return rng.permutation(np.arange(qh) % vert).astype(np.int32)


def _to_torch(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _pages(kv, pages):
    """The same cache as JAX and torch arrays of one page type."""
    if pages == "e4m3":
        kvj = jnp.asarray(kv, jnp.float8_e4m3fn)
        return kvj, torch.from_numpy(
            np.asarray(kvj).view(np.uint8).copy()).view(torch.float8_e4m3fn)
    kvj = jnp.asarray(kv, jnp.bfloat16)
    return kvj, _to_torch(kvj)


def test_ref_decode_blocksparse_matches_jax_kernel_interpret():
    """bf16 q, head_dim 128, four query heads per kv head with hetero
    phases, 8 sequences past the local window, page 16 and a block of two
    pages (the JAX kernel then skips dead pages): the shapes the JAX decode
    kernel takes, under the Pallas interpreter (about 20 s a call, so one
    case; the E4M3 pages, QH/KV 1 and a block under a page are held
    against the fork and the jnp reference below). The gate off equals no
    blocksparse."""
    qh, kvh = GEOMETRIES["qg4"]
    bs = BLOCKS["block32"]
    rng = np.random.default_rng(21)
    lens = rng.integers(33, 80, size=8)
    q, kv, kv_lens, pages_np, _ = paged_batch(
        rng, [(1, int(n)) for n in lens], qh, kvh, 128, padded_seqs=8,
        padded_tokens=8)
    offs = _offsets(qh, bs[2], False, rng)
    qb = jnp.asarray(q * 0.1, jnp.bfloat16)
    kvj, kvt = _pages(kv, "bf16")
    want = np.asarray(jax_decode(
        qb, kvj, jnp.asarray(kv_lens), jnp.asarray(pages_np),
        jnp.asarray([8], jnp.int32), sm_scale=0.125, blocksparse=bs,
        bs_head_offsets=jnp.asarray(offs), bs_on=jnp.asarray(True),
        interpret=True), np.float32)
    qt = _to_torch(qb)
    idx = (torch.from_numpy(kv_lens), torch.from_numpy(pages_np))
    kw = dict(sm_scale=0.125, blocksparse=bs,
              bs_head_offsets=torch.from_numpy(offs))
    got = ref_paged_decode_attention(qt, kvt, *idx, **kw).float().numpy()
    # The TPU kernel rounds q * sm_scale and the probabilities to bf16;
    # the plain version keeps f32: 1% of the largest output.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    # The mask moves the result: dense attention differs by far more.
    dense = ref_paged_decode_attention(qt, kvt, *idx,
                                       sm_scale=0.125).float().numpy()
    assert np.abs(dense - want).max() > 0.05 * np.abs(want).max()
    # The gate off is dense attention, bit for bit; the wrapper takes the
    # plain version on the CPU.
    np.testing.assert_array_equal(ref_paged_decode_attention(
        qt, kvt, *idx, bs_on=False, **kw).float().numpy(), dense)
    np.testing.assert_array_equal(
        paged_decode_attention(qt, kvt, *idx, **kw).float().numpy(), got)


@pytest.mark.parametrize("geometry,block,homo,pages", [
    ("qg4", "block32", False, "bf16"), ("qg1", "block8", True, "e4m3")],
    ids=["qg4-block32-hetero-bf16", "qg1-block8-homo-e4m3"])
def test_ref_ragged_blocksparse_matches_jax_fork_interpret(
        monkeypatch, geometry, block, homo, pages):
    """Against the vendored fork, where the JAX package sends blocksparse
    prefill (and fp8 prefill), under the interpreter: a decode row, a
    prefill and a chunk on a cached prefix, all past the local window."""
    _interpreted(monkeypatch, jax_fork)
    qh, kvh = GEOMETRIES[geometry]
    bs = BLOCKS[block]
    rng = np.random.default_rng(22)
    T, D, S, pps = 56, 128, 3, 6
    q = jnp.asarray(rng.standard_normal((T, qh, D)) * 0.3, jnp.bfloat16)
    kv, kvt = _pages(rng.standard_normal((S * pps + 2, PS, 2 * kvh, D))
                     * 0.3, pages)
    kv_lens = np.asarray([70, 40, 90], np.int32)
    pages_np = np.arange(S * pps, dtype=np.int32).reshape(S, pps)
    cu = np.asarray([0, 1, 41, 56], np.int32)
    ns = np.asarray([S], np.int32)
    offs = _offsets(qh, bs[2], homo, rng)
    want = np.asarray(jax_fork.ragged_paged_attention_alibi(
        q, kv, jnp.asarray(kv_lens), jnp.asarray(pages_np), jnp.asarray(cu),
        jnp.asarray(ns), None, sm_scale=0.25, num_kv_pages_per_block=2,
        num_queries_per_block=8, blocksparse=bs,
        bs_head_offsets=jnp.asarray(offs), bs_on=jnp.asarray(True)),
        np.float32)
    args = (_to_torch(q), kvt,
            *(torch.from_numpy(a) for a in (kv_lens, pages_np, cu, ns)))
    kw = dict(sm_scale=0.25, blocksparse=bs,
              bs_head_offsets=torch.from_numpy(offs))
    got = ref_ragged_paged_attention(*args, **kw)
    # 1% of the largest output, as the fork is held to its jnp reference on
    # bf16 pages. On fp8 pages the fork itself lies 1.2% of the largest
    # output from its jnp reference on these inputs, with blocksparse or
    # without (its fast fp8 -> bf16 conversion): there the fork's own fp8
    # tolerance (3e-2, tests/test_torch_kvquant.py), and the jnp reference
    # on the same pages at 1e-5.
    tol = 0.01 * np.abs(want).max() if pages == "bf16" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    if pages != "bf16":
        jargs = (jnp.asarray(q, jnp.float32), kv.astype(jnp.float32),
                 *(jnp.asarray(a) for a in (kv_lens, pages_np, cu, ns)))
        exact = np.asarray(jax_ref(
            *jargs, sm_scale=0.25, blocksparse=bs,
            bs_head_offsets=jnp.asarray(offs), bs_on=jnp.asarray(True)))
        f32 = ref_ragged_paged_attention(args[0].float(), *args[1:], **kw)
        np.testing.assert_allclose(f32.numpy(), exact, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ragged_paged_attention(*args, **kw), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("bs_on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("homo", [False, True], ids=["hetero", "homo"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_ref_blocksparse_matches_jax_reference(geometry, block, homo, bs_on):
    """f32 against the jnp reference (the JAX package's CPU path), ragged
    and decode (q_len 1 rows through the same reference): only the order
    of the f32 sums differs. A window on top of the mask in half the
    cases."""
    qh, kvh = GEOMETRIES[geometry]
    bs = BLOCKS[block]
    seqs = [(1, 45), (20, 20), (13, 61), (6, 6)]
    rng = np.random.default_rng(23)
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages_np, cu = paged_batch(
        rng, seqs, qh, kvh, 32, padded_seqs=8, padded_tokens=tokens + 4)
    q *= 0.2
    offs = _offsets(qh, bs[2], homo, rng)
    ns = np.asarray([len(seqs)], np.int32)
    window = 30 if homo else None
    jkw = dict(sm_scale=0.3, sliding_window=window, blocksparse=bs,
               bs_head_offsets=jnp.asarray(offs), bs_on=jnp.asarray(bs_on))
    kw = dict(sm_scale=0.3, sliding_window=window, blocksparse=bs,
              bs_head_offsets=torch.from_numpy(offs), bs_on=bs_on)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (
        q, kv, kv_lens, pages_np, cu, ns)), **jkw))
    got = ref_ragged_paged_attention(*(torch.from_numpy(a) for a in (
        q, kv, kv_lens, pages_np, cu, ns)), **kw).numpy()
    np.testing.assert_allclose(got[:tokens], want[:tokens], rtol=1e-5,
                               atol=1e-5)
    # Decode: one query row per sequence at its last position.
    dq = q[:8]
    dcu = np.arange(9, dtype=np.int32)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (
        dq, kv, kv_lens, pages_np, dcu, np.asarray([8], np.int32))), **jkw))
    got = ref_paged_decode_attention(*(torch.from_numpy(a) for a in (
        dq, kv, kv_lens, pages_np)), **kw).numpy()
    live = kv_lens > 0
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# Phi-3-Small checkpoints
# ----------------------------------------------------------------------

# tests/test_phi3small.py's geometry (4 q / 2 kv heads, hidden 64, block 4,
# 2 local blocks, vertical stride 3, hetero phases, dense every 2nd layer,
# muP, gegelu); and the same with a block as large as the engines' page (8).
CONFIGS = {"block4": dict(jax_case.CFG),
           "block_page": dict(jax_case.CFG, blocksparse_block_size=8)}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Checkpoint directories (and their tensors) by config name."""
    out = {}
    for name, cfg in CONFIGS.items():
        path = str(tmp_path_factory.mktemp(name))
        out[name] = (path, jax_case._make_checkpoint(path, cfg))
    return out


def _models(model_dir, jax_cls=JaxPhi3Small):
    jax_model = jax_cls(JaxModelConfig(model=model_dir, dtype="float32"))
    config = ModelConfig(model=model_dir, dtype="float32")
    return jax_model, get_model_class(config)(config)


def _compare_trees(want, got, path=""):
    assert set(want) == set(got), path
    for k in want:
        if isinstance(want[k], dict):
            _compare_trees(want[k], got[k], f"{path}{k}.")
        else:
            a = np.ascontiguousarray(np.asarray(want[k]))
            b = got[k].numpy()
            assert b.shape == a.shape and b.dtype == a.dtype, path + k
            assert b.tobytes() == a.tobytes(), path + k


def test_hooks_match_jax(checkpoints):
    jax_model, model = _models(checkpoints["block4"][0])
    assert type(model).__name__ == "Phi3SmallForCausalLM"
    assert model.sm_scale == jax_model.sm_scale == 1.0 / 16
    assert model.embedding_multiplier == jax_model.embedding_multiplier
    assert model.logit_scale == jax_model.logit_scale
    assert model.blocksparse_params == jax_model.blocksparse_params
    assert (model.bs_head_offsets.numpy().tobytes()
            == np.asarray(jax_model.bs_head_offsets).tobytes())
    assert model.bs_layer_mask == np.asarray(jax_model.bs_layer_mask).tolist()
    assert model.bs_layer_mask == [True, False, True, False]
    assert model.tie_word_embeddings and model.norm_type == "layernorm"
    # Homo heads share phase 0; a position scale sets linear RoPE.
    cfg = dict(CONFIGS["block4"], blocksparse_homo_head_pattern=True,
               rope_position_scale=2.0, architectures=["Phi3SmallForCausalLM"])
    jax_model = JaxPhi3Small(JaxModelConfig(model="unused", dtype="float32",
                                            hf_config=dict(cfg)))
    config = ModelConfig(model="unused", dtype="float32", hf_config=dict(cfg))
    model = get_model_class(config)(config)
    assert not model.bs_head_offsets.any()
    assert model.config.hf_config["rope_scaling"] == {"type": "linear",
                                                      "factor": 2.0}
    assert (model._cos.numpy().tobytes()
            == np.asarray(jax_model._cos, np.float32).tobytes())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_tree_matches_jax(checkpoints, name):
    """The q|k|v split, the gate/up de-interleave and the biases, byte for
    byte; dummy weights have the same keys and shapes."""
    model_dir = checkpoints[name][0]
    jax_model, model = _models(model_dir)
    got = load_hf_params_to_host(model, model_dir)
    _compare_trees(jax_load_hf(jax_model, model_dir), got)
    dummy = dummy_params(model, 0, torch.device("cpu"), torch.float32)
    assert jax.tree.map(np.shape, jax_model.random_params(0)) == \
        jax.tree.map(lambda t: tuple(t.shape), dummy)
    with pytest.raises(NotImplementedError, match="finalize_params"):
        load_quantized_hf_params_to_host(model, model_dir, "gptq")


def _jax_and_port_params(jax_model, model_dir):
    jparams = jax_model.fuse_projections(jax.tree.map(
        jnp.asarray, jax_load_hf(jax_model, model_dir)))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("cache", ["float32", "fp8_e4m3"])
def test_forward_logits_match_jax(checkpoints, cache):
    """A prefill step past the local window, a mixed step on a cached
    prefix and a pure decode step through both models on the same
    parameters (the JAX host tree, fused, carried over by
    params_from_jax), in f32, with a float32 or an E4M3 cache: logits
    within 1e-4 of each row's largest, argmax equal, dummy tokens at the
    mask value."""
    model_dir = checkpoints["block4"][0]
    jax_model, model = _models(model_dir)
    jparams, params = _jax_and_port_params(jax_model, model_dir)
    assert set(params["layers"]) == set(jparams["layers"])
    assert "gate" in params["layers"] and "bqkv" in params["layers"]
    shape = (jax_model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    fp8 = cache == "fp8_e4m3"
    jkv = jnp.zeros(shape, jnp.float8_e4m3fn if fp8 else jnp.float32)
    kv = torch.zeros(shape, dtype=torch.float8_e4m3fn if fp8
                     else torch.float32)
    np_scales = (np.asarray([0.05, 0.04, 0.06, 0.03], np.float32),
                 np.asarray([0.03, 0.06, 0.04, 0.05], np.float32))
    jscales = tuple(jnp.asarray(a) for a in np_scales) if fp8 else None
    scales = tuple(torch.from_numpy(a) for a in np_scales) if fp8 else None
    rng = np.random.default_rng(0)
    vocab = jax_case.CFG["vocab_size"]
    a, b, c = (rng.integers(0, vocab, n).tolist() for n in (23, 17, 5))
    pa, pb, pc = [0, 1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11], [12, 13]
    steps = [
        ([(a, 0, pa), (b[:9], 0, pb)], 40, 4, False),
        ([(a[:1], 23, pa), (b[9:], 9, pb), (c, 0, pc)], 16, 4, False),
        ([(a[:1], 24, pa), (b[:1], 17, pb), (c[:1], 5, pc)], 4, 4, True),
    ]
    for rows, T, S, decode in steps:
        jb, tb, _ = llama_case._batch(rows, T, S, decode)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb, kv_scales=jscales)
        hidden = model.forward(params, kv, tb, scales)
        jlogits = np.asarray(jax_model.compute_logits(
            jparams, jhidden[jb.logits_indices]))[:len(rows)]
        logits = model.compute_logits(
            params, hidden[tb.logits_indices[:len(rows)]]).numpy()
        assert (logits[:, jax_case.CFG["dummy_token_indices"]]
                == np.float32(MASK_VALUE)).all()
        live = np.ones(vocab, bool)
        live[jax_case.CFG["dummy_token_indices"]] = False
        err = np.abs(logits - jlogits)[:, live].max(-1)
        assert (err <= 1e-4 * np.abs(jlogits[:, live]).max(-1)).all(), err
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_tokens_match_jax_engine(checkpoints, name):
    """Prompts longer than the local window, chunked prefill (a 16-token
    budget) mixed with decodes, then 4-step decode windows."""
    model_dir = checkpoints[name][0]
    kw = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
              num_device_blocks_override=64, block_size=8,
              num_scheduler_steps=4, skip_tokenizer_init=True)
    rng = np.random.default_rng(1)
    vocab = jax_case.CFG["vocab_size"]
    prompts = [rng.integers(0, vocab, n).tolist() for n in (13, 31, 22)]
    want = JaxLLM(model=model_dir, **kw).generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(
            temperature=0.0, max_tokens=12, ignore_eos=True,
            detokenize=False))
    got = LLM(model=model_dir, device="cpu", **kw).generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(
            temperature=0.0, max_tokens=12, ignore_eos=True,
            detokenize=False))
    for g, w in zip(got, want):
        assert len(g.outputs[0].token_ids) == 12
        assert g.outputs[0].token_ids == w.outputs[0].token_ids


def test_dummy_tokens_never_sampled(checkpoints):
    model_dir = checkpoints["block4"][0]
    llm = LLM(model=model_dir, device="cpu", dtype="float32", max_num_seqs=4,
              num_device_blocks_override=64, block_size=8,
              skip_tokenizer_init=True)
    outs = llm.generate(
        prompt_token_ids=[[5, 6, 7, 8, 9, 10, 11, 12, 13], [40, 41, 42]],
        sampling_params=SamplingParams(temperature=1.0, seed=3,
                                       max_tokens=24, ignore_eos=True,
                                       detokenize=False))
    dummy = set(jax_case.CFG["dummy_token_indices"])
    for o in outs:
        assert len(o.outputs[0].token_ids) == 24
        assert not set(o.outputs[0].token_ids) & dummy


def test_attention_gets_blocksparse_by_layer(checkpoints, monkeypatch):
    """Every attention call hands the kernels the block parameters, the
    i32 phase table of all query heads and the layer's gate: sparse on
    layers 0 and 2, dense on 1 and 3."""
    import aphrodite_tpu_torch.models.llama as llama_mod

    model_dir = checkpoints["block4"][0]
    _, model = _models(model_dir)
    calls = []

    def checked(q, kv_pages, *args, **kw):
        calls.append((kw["blocksparse"], kw["bs_head_offsets"], kw["bs_on"]))
        return checked.__wrapped__(q, kv_pages, *args, **kw)

    checked.__wrapped__ = llama_mod.ragged_paged_attention
    monkeypatch.setattr(llama_mod, "ragged_paged_attention", checked)
    params = model.fuse_projections(jax.tree.map(
        lambda t: t.float(), load_hf_params_to_host(model, model_dir)))
    shape = (model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *model.kv_cache_shape_suffix)
    _, tb, _ = llama_case._batch([([1, 2, 3, 4, 5], 0, [0, 1])], 8, 2)
    model.forward(params, torch.zeros(shape), tb)
    assert [on for _, _, on in calls] == [True, False, True, False]
    for block, offsets, _ in calls:
        assert block == (4, 2, 3)
        assert offsets.dtype == torch.int32 and offsets.is_contiguous()
        assert offsets.tolist() == [0, 1, 2, 3]


# ----------------------------------------------------------------------
# Llama with bias terms in its config
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama_bias_checkpoint(tmp_path_factory):
    """A tiny Llama whose config sets attention_bias and mlp_bias, with
    q/k/v/o and MLP bias tensors: the JAX package loads the q|k|v biases
    and, as HF's o_proj and MLP biases have no mapping there, leaves those
    out; the port does the same."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(5)
    hf = dict(llama_case.HF, attention_bias=True, mlp_bias=True)
    H, F = hf["hidden_size"], hf["intermediate_size"]
    NH, KV, D = (hf["num_attention_heads"], hf["num_key_value_heads"],
                 hf["head_dim"])
    V = hf["vocab_size"]

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    t = {"model.embed_tokens.weight": w(V, H), "lm_head.weight": w(V, H),
         "model.norm.weight": np.ones(H, np.float32)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": np.ones(H, np.float32),
                  p + "post_attention_layernorm.weight":
                      np.ones(H, np.float32),
                  p + "self_attn.q_proj.weight": w(NH * D, H),
                  p + "self_attn.k_proj.weight": w(KV * D, H),
                  p + "self_attn.v_proj.weight": w(KV * D, H),
                  p + "self_attn.o_proj.weight": w(H, NH * D),
                  p + "self_attn.q_proj.bias": w(NH * D) * 3,
                  p + "self_attn.k_proj.bias": w(KV * D) * 3,
                  p + "self_attn.v_proj.bias": w(KV * D) * 3,
                  p + "self_attn.o_proj.bias": w(H),
                  p + "mlp.gate_proj.weight": w(F, H),
                  p + "mlp.up_proj.weight": w(F, H),
                  p + "mlp.down_proj.weight": w(H, F),
                  p + "mlp.gate_proj.bias": w(F),
                  p + "mlp.up_proj.bias": w(F),
                  p + "mlp.down_proj.bias": w(H)})
    path = tmp_path_factory.mktemp("llama_bias")
    save_file(t, str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump(hf, f)
    return str(path)


def test_llama_with_bias_config_matches_jax(llama_bias_checkpoint):
    """The config's bias flags no longer raise: host trees byte for byte
    (bq, bk, bv and nothing else), then a prefill and a decode step in f32
    against the JAX LlamaForCausalLM, logits within 1e-4 of a row."""
    model_dir = llama_bias_checkpoint
    jax_model, model = _models(model_dir, JaxLlama)
    assert model.attention_bias and not model.mlp_bias
    host = load_hf_params_to_host(model, model_dir)
    _compare_trees(jax_load_hf(jax_model, model_dir), host)
    assert {"bq", "bk", "bv"} <= set(host["layers"])
    jparams, params = _jax_and_port_params(jax_model, model_dir)
    assert "bqkv" in params["layers"]
    shape = (jax_model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    jkv = jnp.zeros(shape, jnp.float32)
    kv = torch.zeros(shape)
    ids = np.random.default_rng(2).integers(0, 256, 11).tolist()
    for rows, T, decode in (([(ids, 0, [0, 1, 2])], 16, False),
                            ([(ids[:1], 11, [0, 1, 2])], 4, True)):
        jb, tb, _ = llama_case._batch(rows, T, 4, decode)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb)
        hidden = model.forward(params, kv, tb)
        jlogits = np.asarray(jax_model.compute_logits(
            jparams, jhidden[jb.logits_indices]))[:1]
        logits = model.compute_logits(
            params, hidden[tb.logits_indices[:1]]).numpy()
        err = np.abs(logits - jlogits).max(-1)
        assert (err <= 1e-4 * np.abs(jlogits).max(-1)).all(), err
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()
