"""ALiBi and the Baichuan models of the port against the JAX package, on
the CPU.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: the slope schedule (bytes), the plain attention
versions with a slope table at one and two query heads per kv head
(against the JAX decode kernel and the vendored ALiBi fork under the
Pallas interpreter, and the jnp reference), and tiny Baichuan checkpoints
written here from a seed: the host trees (the W_pack split and Baichuan2's
NormHead, byte for byte), forwards with a float32 and an E4M3 cache, and
greedy tokens of ``LLM.generate``. On the CPU the port's attention
wrappers take their plain versions; the CUDA kernels with ALiBi at every
QH/KV are held against those by tests/test_torch_cuda.py on the card.
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
from aphrodite_tpu.models import baichuan as jax_baichuan
from aphrodite_tpu.models.bloom import get_alibi_slopes as jax_slopes
from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu.ops.decode_attention import \
    paged_decode_attention as jax_decode
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (
    load_hf_params_to_host, load_quantized_hf_params_to_host, params_from_jax)
from aphrodite_tpu_torch.models import baichuan
from aphrodite_tpu_torch.models.layers import get_alibi_slopes
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    paged_decode_attention, ref_paged_decode_attention)
from tests import test_torch_llama as llama_case
from tests.test_torch_cuda import PS, paged_batch


def test_alibi_slopes_match_jax():
    for num_heads in range(1, 65):
        got = get_alibi_slopes(num_heads)
        want = jax_slopes(num_heads)
        assert got.dtype == np.float32 and got.shape == (num_heads,)
        assert got.tobytes() == want.tobytes(), num_heads


# ----------------------------------------------------------------------
# Plain attention with ALiBi
# ----------------------------------------------------------------------

# (query heads, kv heads): one and two query heads per kv head, few heads
# (the interpreter's time grows with them).
GEOMETRIES = {"qg1": (2, 2), "qg2": (4, 2)}


def _interpreted(monkeypatch, module):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interpreted(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(module.pl, "pallas_call", interpreted)


@pytest.mark.parametrize("geometry,kw", [
    ("qg1", {}), ("qg2", {"sliding_window": 30, "soft_cap": 5.0})],
    ids=["qg1-alibi", "qg2-alibi_window_softcap"])
def test_ref_decode_with_alibi_matches_jax_kernel_interpret(geometry, kw):
    """bf16, head_dim 128, 8 sequences (one dead), page 16: the shapes the
    JAX decode kernel takes, run under the Pallas interpreter (about 15 s a
    call, so one case per geometry), with the model's slope schedule."""
    qh, kvh = GEOMETRIES[geometry]
    rng = np.random.default_rng(12)
    seqs = [(1, int(n)) for n in rng.integers(1, 64, size=7)]
    q, kv, kv_lens, pages, _ = paged_batch(rng, seqs, qh, kvh, 128,
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
    got = ref_paged_decode_attention(qt, kvt, *idx, sm_scale=0.125,
                                     alibi_slopes=torch.from_numpy(slopes),
                                     **kw).float().numpy()
    # The TPU kernel rounds q * sm_scale and the probabilities to bf16;
    # the plain version keeps f32: 1% of the largest output.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    assert not got[7].any() and not want[7].any()  # dead row: zeros
    # The bias moves the result: without it the rows differ by far more.
    plain = ref_paged_decode_attention(qt, kvt, *idx, sm_scale=0.125,
                                       **kw).float().numpy()
    assert np.abs(plain - want).max() > 0.05 * np.abs(want).max()
    # The wrapper takes the plain version on the CPU.
    np.testing.assert_array_equal(paged_decode_attention(
        qt, kvt, *idx, sm_scale=0.125, alibi_slopes=torch.from_numpy(slopes),
        **kw).float().numpy(), got)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_ref_ragged_with_alibi_matches_jax_fork_interpret(monkeypatch,
                                                          geometry):
    """Against the vendored ALiBi fork, where the JAX package sends ALiBi
    prefill, under the interpreter: a decode row, a prefill and a chunk on
    a cached prefix."""
    _interpreted(monkeypatch, jax_fork)
    qh, kvh = GEOMETRIES[geometry]
    rng = np.random.default_rng(13)
    T, D, S, pps = 24, 128, 3, 6
    q = jnp.asarray(rng.standard_normal((T, qh, D)) * 0.3, jnp.bfloat16)
    kv = jnp.asarray(rng.standard_normal((S * pps + 2, PS, 2 * kvh, D))
                     * 0.3, jnp.bfloat16)
    kv_lens = np.asarray([10, 37, 8], np.int32)
    pages = np.arange(S * pps, dtype=np.int32).reshape(S, pps)
    cu = np.asarray([0, 1, 16, 24], np.int32)
    ns = np.asarray([S], np.int32)
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
def test_ref_ragged_with_alibi_matches_jax_reference(geometry, kw):
    """f32 against the jnp reference (the JAX package's CPU path): only the
    order of the f32 sums differs. Slopes scaled up so that the bias
    dominates distant keys."""
    qh, kvh = GEOMETRIES[geometry]
    seqs = [(1, 23), (9, 9), (7, 40), (6, 6)]
    rng = np.random.default_rng(14)
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages, cu = paged_batch(rng, seqs, qh, kvh, 32,
                                            padded_seqs=8,
                                            padded_tokens=tokens + 4)
    slopes = get_alibi_slopes(qh) * 4
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
# Baichuan checkpoints
# ----------------------------------------------------------------------

# 6 MHA heads (the slopes' non-power-of-two branch), hidden 48 != 4096 (so
# BaichuanForCausalLM takes ALiBi), Baichuan2's vocabulary (NormHead).
TINY = dict(hidden_size=48, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=6, vocab_size=baichuan._BAICHUAN2_VOCAB,
            model_max_length=4096, rms_norm_eps=1e-6,
            tie_word_embeddings=False, torch_dtype="float32")
ARCHS = ("BaichuanForCausalLM", "BaiChuanForCausalLM")


def write_baichuan_checkpoint(path, arch: str, seed: int = 0) -> str:
    """A Baichuan checkpoint of the TINY geometry from a seed, as HF stores
    it: Linear weights [out, in], q|k|v fused into W_pack [3H, H]; norms
    near one."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    H, F, V = (TINY[k] for k in ("hidden_size", "intermediate_size",
                                 "vocab_size"))

    def w(rows, cols):
        return (rng.standard_normal((rows, cols))
                * cols**-0.5).astype(np.float32)

    def norm():
        return (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)

    tensors = {"model.embed_tokens.weight": w(V, H),
               "model.norm.weight": norm(), "lm_head.weight": w(V, H)}
    for i in range(TINY["num_hidden_layers"]):
        p = f"model.layers.{i}."
        tensors.update({
            p + "input_layernorm.weight": norm(),
            p + "self_attn.W_pack.weight": w(3 * H, H),
            p + "self_attn.o_proj.weight": w(H, H),
            p + "post_attention_layernorm.weight": norm(),
            p + "mlp.gate_proj.weight": w(F, H),
            p + "mlp.up_proj.weight": w(F, H),
            p + "mlp.down_proj.weight": w(H, F)})
    save_file(tensors, str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump(dict(TINY, architectures=[arch]), f)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Checkpoint directories by architecture."""
    return {arch: write_baichuan_checkpoint(tmp_path_factory.mktemp(arch),
                                            arch) for arch in ARCHS}


def _models(model_dir):
    jax_config = JaxModelConfig(model=model_dir, dtype="float32")
    jax_model = getattr(jax_baichuan, jax_config.hf_config[
        "architectures"][0])(jax_config)
    config = ModelConfig(model=model_dir, dtype="float32")
    return jax_model, get_model_class(config)(config)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_and_position_hooks_match_jax(checkpoints, arch):
    model_dir = checkpoints[arch]
    jax_model, model = _models(model_dir)
    assert type(model).__name__ == arch
    assert model.use_rope == jax_model.use_rope == (arch != ARCHS[0])
    if model.use_rope:
        assert model.alibi_slopes is None and jax_model.alibi_slopes is None
    else:
        assert model.alibi_slopes.dtype == torch.float32
        assert (model.alibi_slopes.numpy().tobytes()
                == np.asarray(jax_model.alibi_slopes).tobytes())
    # Hidden 4096 keeps rotary positions (Baichuan2-7B).
    config = ModelConfig(model="unused", dtype="float32", hf_config=dict(
        TINY, hidden_size=4096, num_attention_heads=32,
        architectures=[ARCHS[0]]))
    assert get_model_class(config)(config).use_rope


@pytest.mark.parametrize("arch", ARCHS)
def test_host_tree_matches_jax(checkpoints, arch):
    """The W_pack split and Baichuan2's NormHead, byte for byte."""
    model_dir = checkpoints[arch]
    jax_model, model = _models(model_dir)
    want = jax_load_hf(jax_model, model_dir)
    got = load_hf_params_to_host(model, model_dir)

    def compare(w, g, path=""):
        assert set(w) == set(g), path
        for k in w:
            if isinstance(w[k], dict):
                compare(w[k], g[k], f"{path}{k}.")
            else:
                a = np.asarray(w[k])
                b = g[k].numpy()
                assert b.shape == a.shape and b.dtype == a.dtype, path + k
                assert b.tobytes() == np.ascontiguousarray(a).tobytes(), \
                    path + k

    compare(want, got)
    norms = np.linalg.norm(got["lm_head"].numpy(), axis=0)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_quantized_checkpoint_of_a_fused_model_raises(checkpoints):
    _, model = _models(checkpoints[ARCHS[1]])
    with pytest.raises(NotImplementedError, match="hf_split_mappings"):
        load_quantized_hf_params_to_host(model, checkpoints[ARCHS[1]], "gptq")


@pytest.mark.parametrize("arch,cache", [(ARCHS[0], "float32"),
                                        (ARCHS[1], "float32"),
                                        (ARCHS[0], "fp8_e4m3")])
def test_forward_logits_match_jax(checkpoints, arch, cache):
    """A prefill step, a mixed step on a cached prefix and a pure decode
    step through both models on the same parameters (the JAX host tree,
    fused, carried over by params_from_jax), in f32; with an E4M3 cache
    (the ALiBi model: its K rows are the same f32 products on both sides,
    where a rotation's last-bit differences can move one byte a step) the
    cache bytes must be equal too. Logits within 1e-4 of each row's
    largest, argmax equal."""
    model_dir = checkpoints[arch]
    jax_model, model = _models(model_dir)
    jparams = jax_model.fuse_projections(jax.tree.map(
        jnp.asarray, jax_load_hf(jax_model, model_dir)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    shape = (jax_model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    fp8 = cache == "fp8_e4m3"
    jkv = jnp.zeros(shape, jnp.float8_e4m3fn if fp8 else jnp.float32)
    kv = torch.zeros(shape, dtype=torch.float8_e4m3fn if fp8
                     else torch.float32)
    np_scales = (np.asarray([0.05, 0.04], np.float32),
                 np.asarray([0.03, 0.06], np.float32)) if fp8 else None
    jscales = (None if np_scales is None
               else tuple(jnp.asarray(a) for a in np_scales))
    scales = (None if np_scales is None
              else tuple(torch.from_numpy(a) for a in np_scales))
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, TINY["vocab_size"], n).tolist()
               for n in (11, 10, 5))
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
        jlive = jkv[:, :llama_case.NUM_PAGES]
        if fp8:
            np.testing.assert_array_equal(live.view(torch.uint8).numpy(),
                                          np.asarray(jlive).view(np.uint8))
        else:
            np.testing.assert_allclose(live.numpy(), np.asarray(jlive),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_gets_the_kernels_layout(checkpoints, arch, monkeypatch):
    """Every attention call of a forward hands the kernels what they take:
    contiguous q (no rotation copies it under ALiBi) and, for the ALiBi
    model, the f32 slope table of all query heads."""
    import aphrodite_tpu_torch.models.llama as llama_mod

    _, model = _models(checkpoints[arch])
    calls = []

    def checked(q, kv_pages, *args, alibi_slopes=None, **kw):
        calls.append((q.is_contiguous(), kv_pages.is_contiguous(),
                      alibi_slopes))
        return llama_mod.ragged_paged_attention.__wrapped__(
            q, kv_pages, *args, alibi_slopes=alibi_slopes, **kw)

    checked.__wrapped__ = llama_mod.ragged_paged_attention
    monkeypatch.setattr(llama_mod, "ragged_paged_attention", checked)
    params = load_hf_params_to_host(model, checkpoints[arch])
    params = model.fuse_projections(params)
    shape = (model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *model.kv_cache_shape_suffix)
    _, tb, _ = llama_case._batch([([1, 2, 3, 4, 5], 0, [0, 1])], 8, 2)
    model.forward(params, torch.zeros(shape), tb)
    assert len(calls) == model.num_layers
    for q_ok, kv_ok, slopes in calls:
        assert q_ok and kv_ok
        if model.use_rope:
            assert slopes is None
        else:
            assert slopes.dtype == torch.float32
            assert slopes.shape == (model.num_heads,)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_engine(checkpoints, arch):
    """Chunked prefill (a 16-token budget) mixed with decodes, then 4-step
    decode windows, as tests/test_torch_engine.py."""
    model_dir = checkpoints[arch]
    kw = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
              num_device_blocks_override=128, block_size=8,
              num_scheduler_steps=4, skip_tokenizer_init=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, TINY["vocab_size"], n).tolist()
               for n in (5, 19, 11)]
    want = JaxLLM(model=model_dir, **kw).generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(
            temperature=0.0, max_tokens=10, ignore_eos=True,
            detokenize=False))
    got = LLM(model=model_dir, device="cpu", **kw).generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(
            temperature=0.0, max_tokens=10, ignore_eos=True,
            detokenize=False))
    for g, w in zip(got, want):
        assert len(g.outputs[0].token_ids) == 10
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
