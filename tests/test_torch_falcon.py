"""Falcon and many query heads per kv head in the port against the JAX
package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: the config accessors' aliases (n_head, n_layer,
d_model, ...), the plain decode and ragged attention at 24 and 71 query
heads per kv head (Falcon-7B's multi-query 71, head_dim 64) against the
JAX decode kernel under the Pallas interpreter and the jnp reference, and
tiny checkpoints of Falcon's three decoder styles written here from a
seed: the host trees (each style's fused query_key_value split, byte for
byte), forwards in f32, and greedy tokens of ``LLM.generate`` with one and
with eight scheduler steps. On the CPU the port's attention wrappers take
their plain versions; the CUDA kernels at these shapes are held against
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
from aphrodite_tpu.models.falcon import FalconForCausalLM as JaxFalcon
from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu.ops.decode_attention import \
    paged_decode_attention as jax_decode
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (load_hf_params_to_host,
                                                params_from_jax)
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    decode_head_groups, paged_decode_attention, plan_decode_splits,
    ref_paged_decode_attention)
from tests import test_torch_llama as llama_case
from tests.test_torch_cuda import paged_batch

# ----------------------------------------------------------------------
# Config aliases
# ----------------------------------------------------------------------

# HF configs that name their sizes otherwise (Falcon's and Bloom's n_head
# and n_layer, MPT's d_model, n_heads and n_layers, OPT-like
# decoder_attention_heads and num_layers) and one that names no head count.
ALIAS_CONFIGS = {
    "falcon": dict(hidden_size=4544, n_head=71, n_layer=32,
                   vocab_size=65024),
    "bloom": dict(hidden_size=1024, n_head=16, n_layer=24,
                  vocab_size=250880),
    "mpt": dict(d_model=4096, n_heads=32, n_layers=32, vocab_size=50432,
                max_seq_len=2048),
    "other": dict(hidden_size=512, decoder_attention_heads=8, num_layers=6,
                  vocab_size=1000),
    "no_heads": dict(hidden_size=256, num_hidden_layers=4, vocab_size=1000),
    "hf": dict(hidden_size=256, num_attention_heads=8, n_head=4,
               num_hidden_layers=3, n_layer=9, vocab_size=1000),
}


@pytest.mark.parametrize("name", sorted(ALIAS_CONFIGS))
def test_config_aliases_match_jax(name):
    hf = ALIAS_CONFIGS[name]
    jax_cfg = JaxModelConfig(model="unused", dtype="float32",
                             hf_config=dict(hf))
    cfg = ModelConfig(model="unused", dtype="float32", hf_config=dict(hf))
    for accessor in ("get_hidden_size", "get_num_layers",
                     "get_num_attention_heads", "get_total_num_kv_heads",
                     "get_head_size", "get_vocab_size"):
        assert getattr(cfg, accessor)() == getattr(jax_cfg, accessor)(), \
            accessor
    assert cfg.max_model_len == jax_cfg.max_model_len


# ----------------------------------------------------------------------
# Plain attention above 16 query heads per kv head
# ----------------------------------------------------------------------

# (query heads, kv heads) at head_dim 64: 24 over one kv head and
# Falcon-7B's 71 over one.
MANY = {"qg24": (24, 1), "qg71": (71, 1)}


@pytest.mark.parametrize("geometry,kw", [
    ("qg24", {}), ("qg71", {"sliding_window": 30, "soft_cap": 5.0})],
    ids=["qg24", "qg71-window_softcap"])
def test_ref_decode_many_heads_matches_jax_kernel_interpret(geometry, kw):
    """bf16 pages and q, head_dim 64, 8 rows (one dead), page 16, under the
    Pallas interpreter (about 15 s a call, so one case per geometry): the
    plain version within 1 % of the largest output
    (the TPU kernel rounds q * sm_scale and the probabilities to bf16, the
    plain version keeps f32); the wrapper takes the plain version on the
    CPU."""
    qh, kvh = MANY[geometry]
    rng = np.random.default_rng(21)
    seqs = [(1, int(n)) for n in rng.integers(1, 48, size=7)]
    q, kv, kv_lens, pages, _ = paged_batch(rng, seqs, qh, kvh, 64,
                                           padded_seqs=8, padded_tokens=8)
    qb = jnp.asarray(q, jnp.bfloat16)
    kvb = jnp.asarray(kv, jnp.bfloat16)
    want = np.asarray(jax_decode(qb, kvb, jnp.asarray(kv_lens),
                                 jnp.asarray(pages),
                                 jnp.asarray([7], jnp.int32),
                                 sm_scale=0.125, interpret=True, **kw),
                      np.float32)
    qt = torch.from_numpy(np.asarray(qb, np.float32)).to(torch.bfloat16)
    kvt = torch.from_numpy(np.asarray(kvb, np.float32)).to(torch.bfloat16)
    idx = (torch.from_numpy(kv_lens), torch.from_numpy(pages))
    got = ref_paged_decode_attention(qt, kvt, *idx, sm_scale=0.125,
                                     **kw).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    assert not got[7].any() and not want[7].any()  # dead row: zeros
    np.testing.assert_array_equal(paged_decode_attention(
        qt, kvt, *idx, sm_scale=0.125, **kw).float().numpy(), got)


@pytest.mark.parametrize("kw", [{}, {"sliding_window": 7, "soft_cap": 2.0}],
                         ids=["plain", "window_softcap"])
@pytest.mark.parametrize("geometry", sorted(MANY))
def test_ref_ragged_many_heads_matches_jax_reference(geometry, kw):
    """f32 against the jnp reference (the JAX package's CPU path), a decode
    row, a prefill and chunks on cached prefixes: only the order of the
    f32 sums differs (1e-5)."""
    qh, kvh = MANY[geometry]
    seqs = [(1, 23), (9, 9), (7, 40), (6, 6)]
    rng = np.random.default_rng(22)
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages, cu = paged_batch(rng, seqs, qh, kvh, 64,
                                            padded_seqs=8,
                                            padded_tokens=tokens + 4)
    ns = np.asarray([len(seqs)], np.int32)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kv),
                              jnp.asarray(kv_lens), jnp.asarray(pages),
                              jnp.asarray(cu), jnp.asarray(ns),
                              sm_scale=0.3, **kw))
    args = [torch.from_numpy(a) for a in (q, kv, kv_lens, pages, cu, ns)]
    got = ref_ragged_paged_attention(*args, sm_scale=0.3, **kw).numpy()
    np.testing.assert_allclose(got[:tokens], want[:tokens], rtol=1e-5,
                               atol=1e-5)
    assert not got[tokens:].any()
    torch.testing.assert_close(
        ragged_paged_attention(*args, sm_scale=0.3, **kw),
        torch.from_numpy(got), rtol=0, atol=0)


def test_decode_plan_counts_head_groups():
    """The decode kernel takes up to 16 query heads per kv head as one
    mma tile and up to 128 in one block of its wide form; past that a kv
    head's heads take one block per 128, and the split plan counts those
    blocks: at Falcon-7B's decode (16 rows, one kv head) the grid still
    holds at least 8 blocks an SM where there are splits enough."""
    assert [decode_head_groups(qg) for qg in (1, 16, 17, 71, 128, 129, 300)
            ] == [1, 1, 1, 1, 1, 2, 3]
    split, n, slots = plan_decode_splits(16, 1, 64 * 1024, 16, 132)
    assert 16 * slots >= 8 * 132 and slots <= n
    _, _, fewer = plan_decode_splits(16, 1, 64 * 1024, 16, 132, 3)
    assert fewer == -(-8 * 132 // (16 * 3))


# ----------------------------------------------------------------------
# Falcon checkpoints
# ----------------------------------------------------------------------

VOCAB = 512
# The three decoder styles, as their configs name them: Falcon-7B's
# multi-query parallel block (24 query heads on one kv head, head_dim 4),
# Falcon-40B's grouped-query block with two norms (8 over 2), and the RW
# one, multi-head and sequential with ALiBi (6 heads: the slopes'
# non-power-of-two branch).
STYLES = {
    "7b": dict(architectures=["FalconForCausalLM"], hidden_size=96,
               num_attention_heads=24, num_hidden_layers=2, multi_query=True,
               parallel_attn=True, new_decoder_architecture=False,
               alibi=False, bias=False),
    "40b": dict(architectures=["FalconForCausalLM"], hidden_size=64,
                num_attention_heads=8, num_kv_heads=2, num_hidden_layers=2,
                new_decoder_architecture=True, parallel_attn=True,
                alibi=False, bias=False),
    "rw": dict(architectures=["RWForCausalLM"], hidden_size=48, n_head=6,
               n_layer=2, multi_query=False, parallel_attn=False,
               new_decoder_architecture=False, alibi=True, bias=False),
}


def write_falcon_checkpoint(path, style: str, seed: int = 0) -> str:
    """A Falcon checkpoint of one style from a seed, as HF stores it:
    Linear weights [out, in], the fused query_key_value in the style's
    layout (its rows are random either way); norms and their biases near
    one and zero."""
    from safetensors.numpy import save_file

    cfg = dict(STYLES[style], vocab_size=VOCAB, layer_norm_epsilon=1e-5,
               torch_dtype="float32")
    rng = np.random.default_rng(seed)
    H = cfg["hidden_size"]
    heads = cfg.get("num_attention_heads") or cfg["n_head"]
    D = H // heads
    kv = (cfg["num_kv_heads"] if cfg["new_decoder_architecture"] else
          1 if cfg["multi_query"] else heads)
    qkv_rows = (heads + 2 * kv) * D
    layers = cfg.get("num_hidden_layers") or cfg["n_layer"]

    def w(rows, cols):
        return (rng.standard_normal((rows, cols))
                * cols**-0.5).astype(np.float32)

    def norm(bias=False):
        if bias:
            return (0.1 * rng.standard_normal(H)).astype(np.float32)
        return (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)

    t = {"transformer.word_embeddings.weight": w(VOCAB, H),
         "transformer.ln_f.weight": norm(), "transformer.ln_f.bias":
         norm(True)}
    for i in range(layers):
        p = f"transformer.h.{i}."
        ln_in = "ln_attn" if cfg["new_decoder_architecture"] else \
            "input_layernorm"
        t.update({
            p + ln_in + ".weight": norm(), p + ln_in + ".bias": norm(True),
            p + "self_attention.query_key_value.weight": w(qkv_rows, H),
            p + "self_attention.dense.weight": w(H, H),
            p + "mlp.dense_h_to_4h.weight": w(4 * H, H),
            p + "mlp.dense_4h_to_h.weight": w(H, 4 * H)})
        if cfg["new_decoder_architecture"]:
            t[p + "ln_mlp.weight"] = norm()
            t[p + "ln_mlp.bias"] = norm(True)
        elif not cfg["parallel_attn"]:
            t[p + "post_attention_layernorm.weight"] = norm()
            t[p + "post_attention_layernorm.bias"] = norm(True)
    save_file(t, str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Checkpoint directories by style."""
    return {style: write_falcon_checkpoint(tmp_path_factory.mktemp(style),
                                           style) for style in STYLES}


def _models(model_dir):
    jax_config = JaxModelConfig(model=model_dir, dtype="float32")
    config = ModelConfig(model=model_dir, dtype="float32")
    return JaxFalcon(jax_config), get_model_class(config)(config)


def compare_trees(want, got, path=""):
    """Byte equality of the port's host tree with the JAX package's."""
    assert set(want) == set(got), path
    for k in want:
        if isinstance(want[k], dict):
            compare_trees(want[k], got[k], f"{path}{k}.")
        else:
            a = np.ascontiguousarray(np.asarray(want[k]))
            b = got[k].numpy()
            assert b.shape == a.shape and b.dtype == a.dtype, path + k
            assert b.tobytes() == a.tobytes(), path + k


@pytest.mark.parametrize("style", sorted(STYLES))
def test_host_tree_and_hooks_match_jax(checkpoints, style):
    """Each style's split of the fused query_key_value, byte for byte, and
    the hooks both packages read from its config."""
    jax_model, model = _models(checkpoints[style])
    assert type(model).__name__ == "FalconForCausalLM"
    compare_trees(jax_load_hf(jax_model, checkpoints[style]),
                  load_hf_params_to_host(model, checkpoints[style]))
    for hook in ("num_heads", "num_kv_heads", "head_dim", "parallel_residual",
                 "single_norm", "use_rope", "new_arch"):
        assert getattr(model, hook) == getattr(jax_model, hook), hook
    if jax_model.alibi_slopes is None:
        assert model.alibi_slopes is None
    else:
        assert (model.alibi_slopes.numpy().tobytes()
                == np.asarray(jax_model.alibi_slopes).tobytes())


@pytest.mark.parametrize("style", sorted(STYLES))
def test_forward_logits_match_jax(checkpoints, style):
    """A prefill step, a mixed step on a cached prefix and a pure decode
    step through both models on the same parameters (the JAX host tree,
    fused, carried over by params_from_jax) on an f32 cache: logits within
    1e-4 of each row's largest, argmax equal, the cache within 1e-5."""
    model_dir = checkpoints[style]
    jax_model, model = _models(model_dir)
    jparams = jax_model.fuse_projections(jax.tree.map(
        jnp.asarray, jax_load_hf(jax_model, model_dir)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    shape = (jax_model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    jkv = jnp.zeros(shape, jnp.float32)
    kv = torch.zeros(shape, dtype=torch.float32)
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


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("style", sorted(STYLES))
def test_greedy_tokens_match_jax_engine(checkpoints, style, steps):
    """Chunked prefill (a 16-token budget) mixed with decodes, then single
    decode steps or 8-step decode windows, as tests/test_torch_engine.py."""
    model_dir = checkpoints[style]
    kw = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
              num_device_blocks_override=128, block_size=8,
              num_scheduler_steps=steps, skip_tokenizer_init=True)
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
