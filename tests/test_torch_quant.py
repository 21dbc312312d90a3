"""The PyTorch port's int4 (GPTQ / AWQ) path against the JAX package's,
on the CPU: the packed layout, the quantizer, the checkpoint parsers, the
plain int4 product (against the JAX reference and the TPU kernel in
interpret mode), the quantized Llama forward and greedy generation.

On the CPU the port's ``int4p_matmul`` takes its plain version; the CUDA
kernel is held against that version on the card (tests/test_torch_cuda.py
and chip_smoke.py).
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
    load_quantized_hf_params_to_host as jax_load_quantized
from aphrodite_tpu.models.interface import ForwardBatch as JaxBatch
from aphrodite_tpu.models.llama import LlamaForCausalLM as JaxLlama
from aphrodite_tpu.ops import quant_matmul as jqm
from aphrodite_tpu.quantization import get_quantization_method as jax_method
from aphrodite_tpu.quantization import int4 as jint4
from aphrodite_tpu.quantization import qlinear as jqlinear
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import LoadConfig, ModelConfig
from aphrodite_tpu_torch.loader.weights import (dummy_params,
                                                load_model_params,
                                                params_from_jax)
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.ops import quant_matmul as tqm
from aphrodite_tpu_torch.quantization import get_quantization_method, int4
from aphrodite_tpu_torch.quantization import qlinear
from tests.utils import TINY_LLAMA_KWARGS, make_tiny_tokenizer

# Every K of this geometry packs at group 128: K/2 is 128 (hidden 256, and
# 4 heads of 64) or 256 (intermediate 512). The default tiny checkpoint
# (hidden 64) would give unpacked containers.
PACKABLE = dict(TINY_LLAMA_KWARGS, hidden_size=256, intermediate_size=512,
                num_attention_heads=4, num_key_value_heads=2, head_dim=64)
HF = dict(PACKABLE, architectures=["LlamaForCausalLM"])
MEMBERS = ("q4p", "scale", "zero")


def _t(container):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in container.items()}


def _j(container):
    return {k: jnp.asarray(v) for k, v in container.items()}


def _assert_trees_equal(want, got, path=""):
    assert set(want) == set(got), (path, set(want), set(got))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(want[k], got[k], f"{path}{k}.")
        else:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            assert w.dtype == g.dtype, (path + k, w.dtype, g.dtype)
            np.testing.assert_array_equal(g, w, err_msg=path + k)


# ----------------------------------------------------------------------
# Layout and quantizer
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_pack_unpack_match_jax(kind):
    q = np.random.default_rng(0).integers(0, 16, size=(3, 256, 64)).astype(
        np.int8)
    want = jqm.pack_int4_rows(q)
    arg = q if kind == "numpy" else torch.from_numpy(q)
    packed = tqm.pack_int4_rows(arg)
    assert packed.dtype == (np.int8 if kind == "numpy" else torch.int8)
    np.testing.assert_array_equal(np.asarray(packed), want)
    # Bytes with the high bit set exist, so a signed shift would show.
    assert (want < 0).any()
    np.testing.assert_array_equal(np.asarray(tqm.unpack_int4_rows(packed)), q)


@pytest.mark.parametrize("shape,group,kind,got_group", [
    ((2, 256, 128), 128, "q4p", 128),
    ((2, 256, 128), 64, "q4p", 64),
    ((2, 192, 128), 128, "q4", 64),  # 128 does not divide 192: halves
    ((64, 32), 64, "q4", 64),  # K/2 is not a multiple of the group
])
def test_quantize_from_float_matches_jax(shape, group, kind, got_group):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jint4.quantize_from_float(w, group)
    assert kind in want and shape[-2] // want["scale"].shape[-2] == got_group
    _assert_trees_equal(want, int4.quantize_from_float(w, group))
    got = int4.quantize_from_float(torch.from_numpy(w), group)
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    _assert_trees_equal(want, {k: v.numpy() for k, v in got.items()})


# ----------------------------------------------------------------------
# Checkpoint formats
# ----------------------------------------------------------------------


def _pack_rows_int4(q):
    """GPTQ row packing: 8 rows per int32, low nibble = first row."""
    K, N = q.shape
    out = np.zeros((K // 8, N), dtype=np.uint32)
    for i in range(8):
        out |= q[i::8].astype(np.uint32) << (4 * i)
    return out.astype(np.int32)


def _pack_cols_int4(q):
    """Column packing: 8 cols per int32, low nibble = first col."""
    K, N = q.shape
    out = np.zeros((K, N // 8), dtype=np.uint32)
    for i in range(8):
        out |= q[:, i::8].astype(np.uint32) << (4 * i)
    return out.astype(np.int32)


def _awq_pack(arr):
    order = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    return _pack_cols_int4(
        arr.reshape(-1, 8)[:, order].ravel().reshape(arr.shape))


def _random_quantized(rng, K, N, G):
    q = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    zeros = rng.integers(1, 16, size=(K // G, N)).astype(np.uint8)
    scales = (rng.random((K // G, N)) * 0.02 + 0.002).astype(np.float16)
    return q, zeros, scales


@pytest.mark.parametrize("g_idx", ["none", "default", "permuted"])
def test_load_gptq_tensors_matches_jax(g_idx):
    rng = np.random.default_rng(2)
    K, N, G = 256, 64, 32
    q, zeros, scales = _random_quantized(rng, K, N, G)
    gi = {"none": None, "default": np.arange(K, dtype=np.int32) // G,
          "permuted": rng.permutation(np.arange(K, dtype=np.int32) // G)}[
              g_idx]
    args = (_pack_rows_int4(q), _pack_cols_int4(zeros - 1), scales, gi)
    want = jint4.load_gptq_tensors(*args)
    assert ("q4" if g_idx == "permuted" else "q4p") in want
    _assert_trees_equal(want, int4.load_gptq_tensors(*args))


def test_load_awq_tensors_matches_jax():
    q, zeros, scales = _random_quantized(np.random.default_rng(3), 128, 64, 32)
    args = (_awq_pack(q), _awq_pack(zeros), scales)
    want = jint4.load_awq_tensors(*args)
    np.testing.assert_array_equal(jqm.unpack_int4_rows(want["q4p"]), q)
    _assert_trees_equal(want, int4.load_awq_tensors(*args))


# ----------------------------------------------------------------------
# The plain int4 product
# ----------------------------------------------------------------------

MATMUL_CASES = {
    # T, K, N, G, layers, layer_idx, pallas kwargs, zero outside 0..15
    "T8": (8, 512, 256, 64, 1, None, {}, False),
    "T32": (32, 512, 256, 64, 1, None, {}, False),
    "T512": (512, 512, 256, 64, 1, None, {}, False),
    "multi_k_tile": (32, 1024, 128, 64, 1, None, dict(block_kp=128), False),
    "stacked": (32, 512, 256, 128, 3, 1, {}, False),
    "wide_zero": (64, 512, 256, 128, 1, None, {}, True),
}


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
def test_int4p_matmul_matches_jax_ref_and_pallas_interpret(case):
    T, K, N, G, L, idx, kw, wide = MATMUL_CASES[case]
    rng = np.random.default_rng(4)
    w = rng.standard_normal((L, K, N)).astype(np.float32)
    c = jint4.quantize_from_float(w, group=G)
    if wide:
        c["zero"] = c["zero"] + rng.integers(-9, 10, c["zero"].shape).astype(
            np.float32)
        assert c["zero"].min() < 0 and c["zero"].max() > 15
    if idx is None:
        c = {k: v[0] for k, v in c.items()}
    x = (rng.standard_normal((T, K)) * 0.3).astype(np.float32)
    before = tqm.int4p_matmul.launches
    got = tqm.int4p_matmul(torch.from_numpy(x), *(_t(c)[k] for k in MEMBERS),
                           G, layer_idx=idx).numpy()
    assert tqm.int4p_matmul.launches == before  # CPU: no kernel launch
    assert got.dtype == np.float32 and got.shape == (T, N)
    jc = _j(c)
    one = {k: (v if idx is None else v[idx]) for k, v in jc.items()}
    ref = np.asarray(jqm.int4p_matmul_ref(
        jnp.asarray(x), *(one[k] for k in MEMBERS), G))
    kernel = np.asarray(jqm.int4p_matmul_pallas(
        jnp.asarray(x), *(jc[k] for k in MEMBERS), G, layer_idx=idx,
        interpret=True, **kw))
    # f32 all through; the sums differ only in their order (the JAX
    # tests' own tolerance for the kernel against its reference).
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, kernel, rtol=2e-3, atol=2e-3)


def test_bf16_plain_product_rounds_the_weight_like_jax():
    rng = np.random.default_rng(5)
    c = jint4.quantize_from_float(
        rng.standard_normal((256, 128)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(
        np.float32)).to(torch.bfloat16)
    got = tqm.int4p_matmul(x, *(_t(c)[k] for k in MEMBERS), 128)
    want = jqm.int4p_matmul_ref(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                *(_j(c)[k] for k in MEMBERS), 128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_int4p_matmul_refuses_other_devices_and_missing_index():
    x = torch.empty((4, 256), dtype=torch.bfloat16, device="meta")
    q4p = torch.empty((128, 128), dtype=torch.int8, device="meta")
    s = torch.empty((2, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tqm.int4p_matmul(x, q4p, s, s, 128)
    with pytest.raises(ValueError, match="layer_idx"):
        tqm.int4p_matmul(torch.zeros((4, 256)), torch.zeros(
            (2, 128, 128), dtype=torch.int8), torch.zeros((2, 2, 128)),
            torch.zeros((2, 2, 128)), 128)


@pytest.mark.parametrize("T,K,N,want", [
    (32, 4096, 6144, (32, 5)), (32, 4096, 4096, (32, 8)),
    (32, 4096, 28672, (32, 1)), (32, 14336, 4096, (32, 8)),
    (1, 4096, 4096, (16, 8)), (64, 4096, 6144, (32, 2)),
    (100, 4096, 4096, (32, 2)), (2048, 14336, 4096, (32, 1)),
])
def test_kernel_plan_fills_the_card(T, K, N, want):
    block_m, splits = tqm.kernel_plan(T, K, N)
    assert (block_m, splits) == want
    blocks = (N // 128) * -(-T // block_m) * splits
    assert splits == 1 or blocks <= 2 * 132
    # No split is empty: every split gets at least one k tile.
    k_tiles = K // 2 // 32
    assert (splits - 1) * -(-k_tiles // splits) < k_tiles


# ----------------------------------------------------------------------
# qmatmul, dequantize, registry, config
# ----------------------------------------------------------------------


def test_qmatmul_and_dequantize_match_jax():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    packed = jint4.quantize_from_float(w)
    unpacked = {"q4": jqm.unpack_int4_rows(packed["q4p"]),
                "scale": packed["scale"], "zero": packed["zero"]}
    for c in (packed, unpacked):
        assert qlinear.is_quantized(_t(c)) and jqlinear.is_quantized(_j(c))
        np.testing.assert_array_equal(
            qlinear.dequantize(_t(c), torch.float32).numpy(),
            np.asarray(jqlinear.dequantize(_j(c), jnp.float32)))
        got = qlinear.qmatmul(torch.from_numpy(x), _t(c))
        want = jqlinear.qmatmul(jnp.asarray(x), _j(c))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-3)
    # A tensor goes to a plain product; stacked weights take a layer.
    stack = np.stack([w, 2 * w])
    got = qlinear.qmatmul(torch.from_numpy(x), torch.from_numpy(stack), 1)
    want = jqlinear.qmatmul(jnp.asarray(x), jnp.asarray(stack[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert not qlinear.is_quantized(torch.from_numpy(w))
    np.testing.assert_array_equal(
        qlinear.dequantize(torch.from_numpy(w), torch.float32).numpy(), w)
    # An int8 per-channel container multiplies and dequantizes like the
    # JAX package's (tests/test_torch_w4a8.py holds both {q, scale} kinds).
    int8 = jax_method("int8").quantize_from_float(w)
    np.testing.assert_array_equal(
        qlinear.dequantize(_t(int8), torch.float32).numpy(),
        np.asarray(jqlinear.dequantize(_j(int8), jnp.float32)))
    np.testing.assert_allclose(
        qlinear.qmatmul(torch.from_numpy(x), _t(int8)).numpy(),
        np.asarray(jqlinear.qmatmul(jnp.asarray(x), _j(int8))), rtol=2e-3,
        atol=2e-3)


def test_unpacked_container_raises_off_the_cpu():
    q4 = {"q4": torch.empty((64, 128), dtype=torch.int8, device="meta"),
          "scale": torch.empty((1, 128), device="meta"),
          "zero": torch.empty((1, 128), device="meta")}
    # Off the CPU an unpacked container goes to its CUDA kernel's wrapper,
    # which launches or raises and never takes the plain version.
    with pytest.raises(ValueError, match="CUDA tensors"):
        qlinear.qmatmul(torch.empty((4, 64), dtype=torch.bfloat16,
                                    device="meta"), q4)


@pytest.mark.parametrize("name", ["gptq", "awq", "awq_marlin", "gptq_marlin",
                                  "GPTQ"])
def test_registry_maps_int4_methods(name):
    assert get_quantization_method(name) is int4
    assert jax_method(name) is jint4
    assert get_quantization_method(None) is None


@pytest.mark.parametrize("name,module", [
    ("int8", "int8"), ("tpu_int8", "int8"), ("eetq", "int8"),
    ("fp8", "fp8"), ("fbgemm_fp8", "fp8"), ("FP8", "fp8")])
def test_registry_maps_8bit_methods(name, module):
    got = get_quantization_method(name)
    assert got.__name__ == f"aphrodite_tpu_torch.quantization.{module}"
    assert got.NAME == jax_method(name).NAME == module
    assert got.RUNTIME_QUANTIZE and jax_method(name).RUNTIME_QUANTIZE


@pytest.mark.parametrize("name", ["hqq", "modelopt", "deepspeedfp",
                                  "bitsandbytes", "marlin", "quip"])
def test_registry_raises_for_methods_not_ported(name):
    jax_method(name)  # the JAX package knows it
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_quantization_method(name)


def test_registry_raises_for_unknown_method():
    with pytest.raises(ValueError, match="not supported"):
        get_quantization_method("int3")
    with pytest.raises(ValueError):
        jax_method("int3")


def test_model_config_reads_the_quantization_method():
    def make(cls, **kw):
        return cls(model="unused", dtype="float32", **kw)

    qcfg = {"quant_method": "gptq", "bits": 4, "group_size": 128}
    for cls in (ModelConfig, JaxModelConfig):
        assert make(cls, hf_config=dict(HF)).quantization is None
        assert make(cls, hf_config=dict(
            HF, quantization_config=qcfg)).quantization == "gptq"
        assert make(cls, hf_config=dict(HF),
                    quantization="awq").quantization == "awq"
    marlin = dict(qcfg, checkpoint_format="marlin")
    assert make(JaxModelConfig, hf_config=dict(
        HF, quantization_config=marlin)).quantization == "marlin"
    with pytest.raises(NotImplementedError, match="Marlin"):
        make(ModelConfig, hf_config=dict(HF, quantization_config=marlin))
    for name in ("fp8", "int8"):
        assert make(ModelConfig, hf_config=dict(HF),
                    quantization=name).quantization == name
    with pytest.raises(NotImplementedError, match="bitsandbytes"):
        make(ModelConfig, hf_config=dict(HF), quantization="bitsandbytes")
    with pytest.raises(ValueError, match="int3"):
        make(ModelConfig, hf_config=dict(HF), quantization="int3")


# ----------------------------------------------------------------------
# Model: fusion, forward, loading
# ----------------------------------------------------------------------


def _models():
    return (JaxLlama(JaxModelConfig(model="unused", dtype="float32",
                                    hf_config=dict(HF))),
            LlamaForCausalLM(ModelConfig(model="unused", dtype="float32",
                                         hf_config=dict(HF))))


def _quantized_jax_params(jax_model, seed):
    """The JAX package's random parameters with every quantizable weight
    quantized by its numpy quantizer, unfused, as numpy arrays."""
    params = jax.tree.map(np.asarray, jax_model.random_params(seed=seed))
    for path in jax_model.quantizable_weights():
        name = path.split(".")[1]
        params["layers"][name] = jint4.quantize_from_float(
            params["layers"][name])
    return params


def test_fuse_projections_on_containers_matches_jax():
    jax_model, model = _models()
    assert model.quantizable_weights() == jax_model.quantizable_weights()
    host = _quantized_jax_params(jax_model, seed=3)
    assert all("q4p" in host["layers"][p.split(".")[1]]
               for p in model.quantizable_weights())
    params = model.fuse_projections(params_from_jax(host))
    want = jax_model.fuse_projections(jax.tree.map(jnp.asarray, host))
    assert set(params["layers"]["wqkv"]) == set(MEMBERS)
    assert params["layers"]["w13"]["q4p"].dtype == torch.int8
    _assert_trees_equal(jax.tree.map(np.asarray, want),
                        jax.tree.map(lambda t: t.numpy(), params))


def test_fuse_projections_keeps_mixed_kinds_apart():
    _, model = _models()
    params = dummy_params(model, 0, torch.device("cpu"), torch.float32,
                          method=int4)
    lp = params["layers"]
    fused = model.fuse_projections(
        {**params, "layers": dict(params["layers"])})
    assert "wqkv" in fused["layers"]
    lp["wk"] = qlinear.dequantize(lp["wk"], torch.float32)  # dense among q4p
    model.fuse_projections(params)
    assert "wqkv" not in lp and {"wq", "wk", "wv", "w13"} <= set(lp)
    # The forward multiplies the parts it could not fuse one by one.
    shape = (model.num_layers, 5, 4, *model.kv_cache_shape_suffix)
    _, batch, _ = _batch([([3, 1, 4, 1, 5], 0, [0, 1])], 8, 2, 4, 4, 4)
    want = model.forward(fused, torch.zeros(shape), batch)
    got = model.forward(params, torch.zeros(shape), batch)
    torch.testing.assert_close(got[:5], want[:5], rtol=1e-4, atol=1e-4)


def _batch(rows, T, S, page_size, pps, trash_page, decode=False):
    ids = np.zeros((T,), np.int32)
    positions = np.zeros((T,), np.int32)
    slots = trash_page * page_size + np.arange(T, dtype=np.int32) % page_size
    kv_lens = np.zeros((S,), np.int32)
    pages = np.zeros((S, pps), np.int32)
    cu = np.zeros((S + 1,), np.int32)
    last = np.zeros((S,), np.int32)
    off = 0
    for i, (tokens, first, table) in enumerate(rows):
        n = len(tokens)
        pos = np.arange(first, first + n)
        ids[off:off + n] = tokens
        positions[off:off + n] = pos
        slots[off:off + n] = (np.asarray(table)[pos // page_size] * page_size
                              + pos % page_size)
        kv_lens[i] = first + n
        pages[i, :len(table)] = table
        cu[i + 1] = cu[i] + n
        off += n
        last[i] = off - 1
    cu[len(rows) + 1:] = cu[len(rows)]
    fields = dict(token_ids=ids, positions=positions, slot_mapping=slots,
                  kv_lens=kv_lens, page_indices=pages, cu_q_lens=cu,
                  num_seqs=np.asarray([len(rows)], np.int32),
                  logits_indices=last)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = ForwardBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
    if decode:
        jb, tb = jb._replace(cu_q_lens=None), tb._replace(cu_q_lens=None)
    return jb, tb, off


def test_quantized_forward_matches_jax():
    """A prefill step, then a pure decode step, through both models with
    the same int4 containers; hidden states and logits in f32."""
    ps, num_pages, pps = 4, 16, 8
    jax_model, model = _models()
    host = _quantized_jax_params(jax_model, seed=5)
    jparams = jax_model.fuse_projections(jax.tree.map(jnp.asarray, host))
    params = model.fuse_projections(params_from_jax(host))
    shape = (jax_model.num_layers, num_pages + 1, ps,
             *jax_model.kv_cache_shape_suffix)
    jkv, kv = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, HF["vocab_size"], n).tolist() for n in (11, 6))
    pa, pb = [0, 1, 2, 3], [5, 7, 9]
    steps = [([(a, 0, pa), (b, 0, pb)], 32, 4, False),
             ([(a[:1], 11, pa), (b[:1], 6, pb)], 4, 4, True)]
    for rows, T, S, decode in steps:
        jb, tb, n = _batch(rows, T, S, ps, pps, num_pages, decode)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb)
        hidden = model.forward(params, kv, tb)
        live = len(rows) if decode else n
        # The tolerance of test_forward_matches_jax in test_torch_llama.py:
        # f32 both sides, the sums in another order.
        np.testing.assert_allclose(hidden[:live].numpy(),
                                   np.asarray(jhidden)[:live], rtol=1e-4,
                                   atol=1e-4)
        jlogits = np.asarray(jax_model.compute_logits(
            jparams, jhidden[jb.logits_indices]))[:len(rows)]
        logits = model.compute_logits(
            params, hidden[tb.logits_indices[:len(rows)]]).numpy()
        np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()


@pytest.fixture(scope="module")
def dense_dir(tmp_path_factory):
    from tests.utils import make_tiny_llama_checkpoint

    path = tmp_path_factory.mktemp("tiny_llama_packable")
    make_tiny_llama_checkpoint(str(path), **PACKABLE)
    return str(path)


ENGINE_KW = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
                 num_device_blocks_override=128, block_size=8,
                 num_scheduler_steps=4)
PROMPTS = ["the quick brown fox", "hello world, this is"]


def test_gptq_on_a_dense_checkpoint_generates_like_jax(dense_dir):
    """quantization="gptq" on a dense checkpoint quantizes at load; greedy
    tokens equal the JAX engine's, and the weights are packed int4."""
    want = JaxLLM(model=dense_dir, quantization="gptq", **ENGINE_KW).generate(
        PROMPTS, JaxSamplingParams(temperature=0.0, max_tokens=10,
                                   ignore_eos=True))
    llm = LLM(model=dense_dir, quantization="gptq", device="cpu",
              **ENGINE_KW)
    lp = llm.engine.runner.params["layers"]
    for name in ("wqkv", "wo", "w13", "down"):
        assert set(lp[name]) == set(MEMBERS)
        assert lp[name]["q4p"].dtype == torch.int8
        assert lp[name]["scale"].dtype == torch.float32
    got = llm.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=10,
                                               ignore_eos=True))
    for g, w in zip(got, want):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids


def _write_quantized_checkpoint(path, fmt, seed, act_order=False):
    """A tiny checkpoint in GPTQ or AWQ format at the packable geometry:
    random nibbles, zeros and f16 scales packed with numpy; dense f32
    embeddings, norms and lm_head. With act_order (GPTQ) every g_idx is a
    random assignment of rows to groups (desc_act) and the scales vary by
    group, so the assignment shows in the weights."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    H, F, V = HF["hidden_size"], HF["intermediate_size"], HF["vocab_size"]
    NH, NKV, D = (HF["num_attention_heads"], HF["num_key_value_heads"],
                  HF["head_dim"])
    G = 64
    tensors = {
        "model.embed_tokens.weight":
            rng.standard_normal((V, H)).astype(np.float32) * 0.5,
        "model.norm.weight": np.ones((H,), np.float32),
        "lm_head.weight":
            (rng.standard_normal((V, H)) * H**-0.5).astype(np.float32),
    }
    linears = {"self_attn.q_proj": (H, NH * D), "self_attn.k_proj": (H, NKV * D),
               "self_attn.v_proj": (H, NKV * D), "self_attn.o_proj": (NH * D, H),
               "mlp.gate_proj": (H, F), "mlp.up_proj": (H, F),
               "mlp.down_proj": (F, H)}
    for i in range(HF["num_hidden_layers"]):
        base = f"model.layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{base}.{norm}.weight"] = np.ones((H,), np.float32)
        for name, (K, N) in linears.items():
            q, zeros, scales = _random_quantized(rng, K, N, G)
            # Weights centred on zero with std near 1/sqrt(K).
            zeros[:] = 8
            scales = (scales * 0 + K**-0.5 / 4).astype(np.float16)
            g_idx = np.arange(K, dtype=np.int32) // G
            if act_order:
                g_idx = rng.permutation(g_idx)
                scales = (scales * (1 + rng.random((K // G, 1)))).astype(
                    np.float16)
            if fmt == "gptq":
                tensors[f"{base}.{name}.qweight"] = _pack_rows_int4(q)
                tensors[f"{base}.{name}.qzeros"] = _pack_cols_int4(zeros - 1)
                tensors[f"{base}.{name}.g_idx"] = g_idx
            else:
                tensors[f"{base}.{name}.qweight"] = _awq_pack(q)
                tensors[f"{base}.{name}.qzeros"] = _awq_pack(zeros)
            tensors[f"{base}.{name}.scales"] = scales
    os.makedirs(path, exist_ok=True)
    save_file(tensors, os.path.join(path, "model.safetensors"))
    config = dict(HF, model_type="llama", torch_dtype="float32",
                  quantization_config={"quant_method": fmt, "bits": 4,
                                       "group_size": G})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    make_tiny_tokenizer(path, vocab_size=V)


@pytest.mark.parametrize("fmt", ["gptq", "awq"])
def test_quantized_checkpoint_loads_like_jax_and_generates(tmp_path, fmt):
    path = str(tmp_path / fmt)
    _write_quantized_checkpoint(path, fmt, seed=7)
    jax_config = JaxModelConfig(model=path, dtype="float32")
    config = ModelConfig(model=path, dtype="float32")
    assert config.quantization == jax_config.quantization == fmt
    want = jax_load_quantized(JaxLlama(jax_config), path, fmt)
    model = LlamaForCausalLM(config)
    got = load_model_params(model, config, LoadConfig(), torch.device("cpu"))
    assert got["layers"]["down"]["q4p"].shape == (2, 256, 256)
    _assert_trees_equal(want, jax.tree.map(lambda t: t.numpy(), got))
    llm = LLM(model=path, device="cpu", **ENGINE_KW)
    outs = llm.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=6,
                                                ignore_eos=True, logprobs=1))
    for o in outs:
        assert len(o.outputs[0].token_ids) == 6
        assert all(np.isfinite(e.logprob) for lp in o.outputs[0].logprobs
                   for e in lp.values())


def test_dummy_int4_params_are_packed_and_seeded():
    _, model = _models()
    cpu = torch.device("cpu")
    params = dummy_params(model, 0, cpu, torch.float32, method=int4)
    shapes = model.param_shapes()["layers"]
    for path in model.quantizable_weights():
        name = path.split(".")[1]
        L, K, N = shapes[name]
        c = params["layers"][name]
        assert c["q4p"].shape == (L, K // 2, N) and c["q4p"].dtype == torch.int8
        assert c["scale"].shape == c["zero"].shape == (L, K // 128, N)
        w = qlinear.dequantize(c, torch.float32)
        assert abs(w.std().item() * np.sqrt(N) - 1) < 0.1
    assert params["embed"].dtype == torch.float32  # dense leaves stay dense
    again = dummy_params(model, 0, cpu, torch.float32, method=int4)
    assert torch.equal(again["layers"]["down"]["q4p"],
                       params["layers"]["down"]["q4p"])
