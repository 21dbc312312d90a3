"""The PyTorch port's Llama against the JAX package's, on the CPU in f32.

Both models get the same weights: the JAX package's random parameters,
fused, carried over by ``params_from_jax``. The same numpy batches then
go through both forwards: a prefill step, a mixed step that continues a
chunked prefill on its cached prefix beside a decode token, and a pure
decode step (``cu_q_lens=None``). Hidden states, logits and the KV cache
are compared after each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader.weights import \
    load_hf_params_to_host as jax_load_hf
from aphrodite_tpu.models.interface import ForwardBatch as JaxBatch
from aphrodite_tpu.models.layers import \
    compute_rope_tables as jax_rope_tables
from aphrodite_tpu.models.llama import LlamaForCausalLM as JaxLlama
from aphrodite_tpu_torch.common.config import LoadConfig, ModelConfig
from aphrodite_tpu_torch.loader.weights import (dummy_params,
                                                load_model_params,
                                                params_from_jax)
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.models.layers import compute_rope_tables
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.models.registry import get_model_class
from tests.utils import TINY_LLAMA_KWARGS

PS = 4  # page size
NUM_PAGES = 16  # + one trash page
PPS = 8  # pages per sequence
HF = dict(TINY_LLAMA_KWARGS, architectures=["LlamaForCausalLM"])


def _models():
    jax_model = JaxLlama(JaxModelConfig(model="unused", dtype="float32",
                                       hf_config=dict(HF)))
    model = LlamaForCausalLM(ModelConfig(model="unused", dtype="float32",
                                         hf_config=dict(HF)))
    return jax_model, model


def _batch(rows, T, S, decode=False, num_pages=NUM_PAGES, pps=PPS):
    """numpy batch arrays for rows = [(token_ids, first_pos, pages)], on a
    cache of num_pages pages (+ the trash page) and pps pages a row."""
    token_ids = np.zeros((T,), np.int32)
    positions = np.zeros((T,), np.int32)
    slots = num_pages * PS + np.arange(T, dtype=np.int32) % PS
    kv_lens = np.zeros((S,), np.int32)
    pages = np.zeros((S, pps), np.int32)
    cu = np.zeros((S + 1,), np.int32)
    last = np.zeros((S,), np.int32)
    off = 0
    for i, (ids, first, table) in enumerate(rows):
        n = len(ids)
        pos = np.arange(first, first + n)
        token_ids[off:off + n] = ids
        positions[off:off + n] = pos
        slots[off:off + n] = np.asarray(table)[pos // PS] * PS + pos % PS
        kv_lens[i] = first + n
        pages[i, :len(table)] = table
        cu[i + 1] = cu[i] + n
        off += n
        last[i] = off - 1
    cu[len(rows) + 1:] = cu[len(rows)]
    fields = dict(token_ids=token_ids, positions=positions,
                  slot_mapping=slots, kv_lens=kv_lens, page_indices=pages,
                  cu_q_lens=cu, num_seqs=np.asarray([len(rows)], np.int32),
                  logits_indices=last)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = ForwardBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
    if decode:
        jb = jb._replace(cu_q_lens=None)
        tb = tb._replace(cu_q_lens=None)
    return jb, tb, off


def test_forward_matches_jax():
    jax_model, model = _models()
    jparams = jax_model.fuse_projections(
        jax.tree.map(jnp.asarray, jax_model.random_params(seed=3)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(params["layers"]) == set(jparams["layers"])
    shape = (jax_model.num_layers, NUM_PAGES + 1, PS,
             *jax_model.kv_cache_shape_suffix)
    jkv = jnp.zeros(shape, jnp.float32)
    kv = torch.zeros(shape)
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, HF["vocab_size"], n).tolist()
               for n in (11, 10, 5))
    pa, pb, pc = [0, 1, 2, 3], [5, 7, 9], [11, 12]
    steps = [
        # Prefill of a, first chunk of b.
        ([(a, 0, pa), (b[:6], 0, pb)], 24, 4, False),
        # Decode of a beside b's second chunk on its cached prefix, and
        # all of c.
        ([(a[:1], 11, pa), (b[6:], 6, pb), (c, 0, pc)], 16, 4, False),
        # Pure decode (cu_q_lens=None) with one dead padded row.
        ([(a[:1], 12, pa), (b[:1], 10, pb), (c[:1], 5, pc)], 4, 4, True),
    ]
    for rows, T, S, decode in steps:
        jb, tb, n = _batch(rows, T, S, decode)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb)
        hidden = model.forward(params, kv, tb)
        live = len(rows) if decode else n
        # f32 both sides; matmul and softmax summation orders differ.
        np.testing.assert_allclose(hidden[:live].numpy(),
                                   np.asarray(jhidden)[:live], rtol=1e-4,
                                   atol=1e-4)
        idx = tb.logits_indices[:len(rows)]
        jlogits = jax_model.compute_logits(jparams, jhidden[jb.logits_indices])
        logits = model.compute_logits(params, hidden[idx])
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(jlogits)[:len(rows)],
                                   rtol=1e-4, atol=1e-4)
        assert (logits.argmax(-1).numpy()
                == np.asarray(jlogits)[:len(rows)].argmax(-1)).all()
        # Every page but the trash page holds the same K/V.
        np.testing.assert_allclose(kv[:, :NUM_PAGES].numpy(),
                                   np.asarray(jkv)[:, :NUM_PAGES],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scaling", [None, {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 64}])
def test_rope_tables_match_jax(scaling):
    cos, sin = compute_rope_tables(16, 128, base=500000.0,
                                   rope_scaling=scaling)
    jcos, jsin = jax_rope_tables(16, 128, base=500000.0,
                                 rope_scaling=scaling)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-7)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-7)


@pytest.mark.parametrize("tie", [False, True])
def test_bf16_logits_match_jax_in_f32(tie):
    """bf16 hidden rows and head give f32 logits that are not rounded to
    bf16, as the JAX package's preferred_element_type=f32 product."""
    hf = dict(HF, tie_word_embeddings=tie)
    jax_model = JaxLlama(JaxModelConfig(model="unused", dtype="bfloat16",
                                        hf_config=dict(hf)))
    model = LlamaForCausalLM(ModelConfig(model="unused", dtype="bfloat16",
                                         hf_config=dict(hf)))
    H, V = model.hidden_size, model.vocab_size
    rng = np.random.default_rng(7)
    arrays = {"hidden": rng.standard_normal((5, H)) * 3,
              "embed": rng.standard_normal((V, H)) * H**-0.5,
              "lm_head": rng.standard_normal((H, V)) * H**-0.5}
    tensors = {k: torch.from_numpy(a).to(torch.bfloat16)
               for k, a in arrays.items()}
    jarrays = {k: jnp.asarray(t.float().numpy(), jnp.bfloat16)
               for k, t in tensors.items()}
    hidden, jhidden = tensors.pop("hidden"), jarrays.pop("hidden")
    if tie:
        del tensors["lm_head"], jarrays["lm_head"]
    logits = model.compute_logits(tensors, hidden)
    want = np.asarray(jax_model.compute_logits(jarrays, jhidden))
    assert logits.dtype == torch.float32
    # f32 sums of the same exact bf16 products; only the order differs.
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-5)
    # Rounding to bf16 would move most logits by far more than that.
    rounded = logits.to(torch.bfloat16).float()
    assert (rounded - logits).abs().max().item() > 1e-3


def test_unported_rope_scaling_raises():
    """A scaling type neither package knows raises, as the JAX function
    raises (the yarn and dynamic types are ported)."""
    scaling = {"rope_type": "ntk-by-parts"}
    with pytest.raises(ValueError, match="ntk-by-parts"):
        jax_rope_tables(16, 32, rope_scaling=scaling)
    with pytest.raises(ValueError, match="ntk-by-parts"):
        compute_rope_tables(16, 32, rope_scaling=scaling)


def test_hf_checkpoint_loads_like_jax(tiny_llama_dir):
    jax_model = JaxLlama(JaxModelConfig(model=tiny_llama_dir,
                                        dtype="float32"))
    want = jax_model.fuse_projections(jax_load_hf(jax_model, tiny_llama_dir))
    config = ModelConfig(model=tiny_llama_dir, dtype="float32")
    model = LlamaForCausalLM(config)
    got = model.fuse_projections(load_model_params(
        model, config, LoadConfig(), torch.device("cpu")))

    def compare(w, g, path=""):
        assert set(w) == set(g), path
        for k in w:
            if isinstance(w[k], dict):
                compare(w[k], g[k], f"{path}{k}.")
            else:
                np.testing.assert_array_equal(g[k].numpy(),
                                              np.asarray(w[k]),
                                              err_msg=path + k)

    compare(want, got)


def test_dummy_params_shapes_and_scale():
    _, model = _models()
    params = dummy_params(model, seed=0, device=torch.device("cpu"),
                          dtype=torch.float32)
    shapes = model.param_shapes()
    assert params["layers"]["input_norm"].eq(1).all()
    assert params["final_norm"].eq(1).all()
    for k, shape in shapes["layers"].items():
        assert tuple(params["layers"][k].shape) == shape
    # std 1/sqrt(fan-in side), as the JAX package's random_params.
    embed = params["embed"]
    assert tuple(embed.shape) == shapes["embed"]
    assert abs(embed.std().item() * np.sqrt(embed.shape[-1]) - 1) < 0.05
    again = dummy_params(model, seed=0, device=torch.device("cpu"),
                         dtype=torch.float32)
    assert torch.equal(again["lm_head"], params["lm_head"])  # seeded


def test_registry_raises_for_unported_architecture():
    """An architecture the JAX package serves and the port does not yet
    (Solar) raises naming the queue item it waits for; one neither
    serves, the bare "not ported" ValueError."""
    config = ModelConfig(model="unused", dtype="float32",
                         hf_config=dict(HF, architectures=["SolarForCausalLM"]))
    with pytest.raises(NotImplementedError, match="not ported.*item 3"):
        get_model_class(config)
    config = ModelConfig(model="unused", dtype="float32", hf_config=dict(
        HF, architectures=["NoSuchModelForCausalLM"]))
    with pytest.raises(ValueError, match="not ported"):
        get_model_class(config)
    assert get_model_class(ModelConfig(
        model="unused", dtype="float32", hf_config=dict(HF))) \
        is LlamaForCausalLM
