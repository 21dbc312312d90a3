"""GGUF serving and the unpacked grouped container (one int8 level per
byte), port against the JAX package: the matmul wrapper's plain version
against the JAX reference and the Pallas kernel in interpret mode, the
copied block decoders on the same raw bytes, the loaded host trees leaf
by leaf, a forward, and greedy generation through both engines on the
same .gguf file. On the CPU the port's wrapper takes its plain version;
the CUDA kernel is held against it on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu import LLM as JaxLLM
from aphrodite_tpu import SamplingParams as JaxSamplingParams
from aphrodite_tpu.common.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader import gguf as jgguf
from aphrodite_tpu.models.llama import LlamaForCausalLM as JaxLlama
from aphrodite_tpu.ops import quant_matmul as jqm
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import LoadConfig, ModelConfig
from aphrodite_tpu_torch.loader import gguf as tgguf
from aphrodite_tpu_torch.loader.weights import (load_model_params,
                                                params_from_jax)
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.ops import quant_matmul as tqm
from aphrodite_tpu_torch.quantization import qlinear
from tests import gguf_writer as W
from tests.test_torch_quant import (ENGINE_KW, PROMPTS, _assert_trees_equal,
                                    _batch, _write_quantized_checkpoint)

# k-quant super-blocks hold 256 values, so every row length of the tiny
# checkpoint is a multiple of 256.
GEOMETRY = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                num_key_value_heads=2, head_dim=64)
QUANTS = ("f32", "q8_0", "q6_k")


# ----------------------------------------------------------------------
# The matmul on unpacked containers (TPU kernel rows 4, 5 and 8)
# ----------------------------------------------------------------------

# name -> (L or None for a 2-D container, K, N, group, T, level range)
MATMUL_CASES = {
    "stacked-g16-T64": (3, 512, 256, 16, 64, (-64, 64)),
    "stacked-g16-T256": (3, 512, 256, 16, 256, (-64, 64)),
    "stacked-g32-signed-T64": (2, 256, 128, 32, 64, (-128, 128)),
    "stacked-g1-T5": (2, 128, 128, 1, 5, (0, 16)),
    "flat-g16-T20": (None, 512, 256, 16, 20, (0, 64)),
    "flat-g32-signed-T100": (None, 256, 128, 32, 100, (-128, 128)),
    "flat-g1-T64": (None, 128, 128, 1, 64, (0, 16)),
}


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
def test_int4_matmul_matches_jax_ref_and_pallas_interpret(case):
    """The port's wrapper on CPU tensors against the JAX package on the
    same numpy inputs: int4_matmul_ref for the 2-D form (rows 4 and 5 have
    no interpret argument), and for the stacked form also
    int4_matmul_pallas_stacked in interpret mode, both of its bodies (T 64
    dense, below group-wise), where the TPU dispatch would take it
    (group > 1). Tolerance rtol = atol = 2e-3, the JAX package's own for
    this kernel against its reference (tests/test_quantization.py)."""
    L, K, N, G, T, (lo, hi) = MATMUL_CASES[case]
    rng = np.random.default_rng(sorted(MATMUL_CASES).index(case))
    lead = () if L is None else (L,)
    q = rng.integers(lo, hi, size=(*lead, K, N)).astype(np.int8)
    scale = rng.random((*lead, K // G, N)).astype(np.float32) * 0.02 + 1e-3
    zero = rng.integers(0, 32, size=(*lead, K // G, N)).astype(np.float32)
    x = (rng.standard_normal((T, K)) * 0.3).astype(np.float32)
    tq, ts, tz = (torch.from_numpy(a) for a in (q, scale, zero))
    for layer in range(L or 1):
        idx = None if L is None else layer
        got = tqm.int4_matmul(torch.from_numpy(x), tq, ts, tz, G,
                              layer_idx=idx).numpy()
        pick = (lambda a: a) if L is None else (lambda a: a[layer])
        want = np.asarray(jqm.int4_matmul_ref(
            jnp.asarray(x), jnp.asarray(pick(q)), jnp.asarray(pick(scale)),
            jnp.asarray(pick(zero)), G))
        assert got.dtype == np.float32 and got.shape == (T, N)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        if L is not None and G > 1:
            kernel = np.asarray(jqm.int4_matmul_pallas_stacked(
                jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                jnp.asarray(zero), G, layer_idx=layer, interpret=True))
            np.testing.assert_allclose(got, kernel, rtol=2e-3, atol=2e-3)


def test_qmatmul_on_an_unpacked_container_matches_jax():
    """qmatmul and dequantize on a layer-stacked full-byte container, the
    way the model calls them."""
    rng = np.random.default_rng(11)
    L, K, N, G = 2, 128, 64, 32
    c = {"q4": rng.integers(-128, 128, size=(L, K, N)).astype(np.int8),
         "scale": rng.random((L, K // G, N)).astype(np.float32) * 0.02,
         "zero": rng.integers(-4, 40, size=(L, K // G, N)).astype(
             np.float32)}
    x = rng.standard_normal((7, K)).astype(np.float32)
    tc = {k: torch.from_numpy(v) for k, v in c.items()}
    want = np.asarray(jqm.int4_matmul_stacked_dispatch(
        jnp.asarray(x), *(jnp.asarray(c[k]) for k in ("q4", "scale", "zero")),
        G, 1))
    got = qlinear.qmatmul(torch.from_numpy(x), tc, layer=1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    w = qlinear.dequantize(tc, torch.float32).numpy()
    np.testing.assert_allclose(x @ w[1], want, rtol=2e-3, atol=2e-3)


def _cuda_like(T, K, N, G):
    """Meta tensors of the kernel's types: the checks read no data."""
    m = dict(device="meta")
    return (torch.empty((T, K), dtype=torch.bfloat16, **m),
            torch.empty((K, N), dtype=torch.int8, **m),
            torch.empty((K // G, N), **m), torch.empty((K // G, N), **m), G)


def test_int4_kernel_input_checks_name_the_reason():
    """What the CUDA kernel does not take raises with the reason, before
    any launch; seen here through check_int4_kernel_inputs, whose device
    check comes after the shape checks."""
    check = tqm.check_int4_kernel_inputs
    with pytest.raises(ValueError, match="CUDA tensors"):
        check(*_cuda_like(4, 128, 128, 32), "dense")  # all else is fine
    with pytest.raises(ValueError, match="multiple of 128"):
        check(*_cuda_like(4, 128, 192, 32), "dense")
    with pytest.raises(ValueError, match="multiple of 64"):
        check(*_cuda_like(4, 96, 128, 32), "dense")
    with pytest.raises(ValueError, match="straddle"):
        check(*_cuda_like(4, 192, 128, 96), "dense")
    with pytest.raises(ValueError, match="group-wise body"):
        check(*_cuda_like(4, 128, 128, 8), "groupwise")
    with pytest.raises(ValueError, match="body"):
        check(*_cuda_like(4, 128, 128, 32), "wmma")
    x, q, s, z, g = _cuda_like(4, 128, 128, 32)
    with pytest.raises(ValueError, match="does not match"):
        check(x, q[:64], s, z, g, "dense")
    with pytest.raises(ValueError, match="K/group"):
        check(x, q, s[:2], z, g, "dense")
    with pytest.raises(ValueError, match="layer_idx"):
        tqm.int4_matmul(torch.zeros((4, 128)), torch.zeros(
            (2, 128, 128), dtype=torch.int8), torch.zeros((2, 4, 128)),
            torch.zeros((2, 4, 128)), 32)


@pytest.mark.parametrize("T,group", [(1, 1), (2048, 8), (8, 16), (2048, 16),
                                     (32, 32), (16, 128), (2048, 128)])
def test_int4_kernel_body_by_rows_and_group(T, group):
    """The wrapper's body, fixed in code from the card's times, is one the
    C entry point takes, and it takes every group a container can have
    (per-row scales and groups under one tensor-core step included): of
    the kernel's checks only the device's, which comes last, refuses
    these operands."""
    assert tqm.INT4_BODY in tqm.INT4_BODIES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tqm.check_int4_kernel_inputs(*_cuda_like(T, 256, 128, group),
                                     tqm.INT4_BODY)


@pytest.mark.parametrize("T,K,N,group,want", [
    (32, 4096, 6144, 16, (32, 5)),     # 48 strips: K split to fill the card
    (32, 4096, 28672, 16, (32, 1)),    # 224 strips: no split
    (1, 14336, 4096, 32, (16, 8)),
    (2048, 4096, 4096, 32, (64, 1)),   # 32 row blocks x 32 strips
    (8, 4096, 4096, 1, (16, 8)),       # G < 16: 32-row k tiles
])
def test_int4_kernel_plan_fills_the_card(T, K, N, group, want):
    block_m, splits = tqm.int4_kernel_plan(T, K, N, group, tqm.INT4_BODY)
    assert (block_m, splits) == want
    k_tiles = K // (32 if group < 16 else 64)
    assert splits <= k_tiles  # the C entry point refuses more


# ----------------------------------------------------------------------
# The loader's copy: block decoders, config, host trees
# ----------------------------------------------------------------------


def _blocks(name, rng):
    """(ggml type, raw block bytes, rows, row length) of random fields
    packed by tests/gguf_writer.py."""
    rows, n = 3, 512
    nsb = n // 256
    u8 = lambda hi, *shape: rng.integers(0, hi, size=shape).astype(  # noqa
        np.uint8)
    d = (rng.random((rows, nsb)) * 0.05 + 0.01).astype(np.float32)
    d32 = (rng.random((rows, n // 32)) * 0.05 + 0.01).astype(np.float32)
    dmin = (rng.random((rows, nsb)) * 0.02).astype(np.float32)
    if name == "q8_0":
        w = rng.standard_normal((rows, n)).astype(np.float32)
        return jgguf.GGML_Q8_0, W.pack_q8_0(w), rows, n
    if name == "q4_k":
        sc = u8(64, rows, nsb, 8)
        sc[0, 0, 0] = 0  # a zero-scale group that keeps its min offset
        return (jgguf.GGML_Q4_K, W.pack_q4_k(
            u8(16, rows, n), d, dmin, sc, u8(64, rows, nsb, 8) | 1), rows, n)
    if name == "q5_k":
        return (jgguf.GGML_Q5_K, W.pack_q5_k(
            u8(32, rows, n), d, dmin, u8(64, rows, nsb, 8),
            u8(64, rows, nsb, 8)), rows, n)
    if name == "q6_k":
        sc = rng.integers(-100, 100, size=(rows, nsb, 16)).astype(np.int8)
        return jgguf.GGML_Q6_K, W.pack_q6_k(u8(64, rows, n), d, sc), rows, n
    if name == "q2_k":
        return (jgguf.GGML_Q2_K, W.pack_q2_k(
            u8(4, rows, n), d, dmin, u8(16, rows, nsb, 16),
            u8(16, rows, nsb, 16)), rows, n)
    if name == "q3_k":
        return (jgguf.GGML_Q3_K, W.pack_q3_k(
            u8(8, rows, n), d, u8(64, rows, nsb, 16)), rows, n)
    if name == "q5_0":
        return jgguf.GGML_Q5_0, W.pack_q5_0(u8(32, rows, n), d32), rows, n
    if name == "iq4_nl":
        return jgguf.GGML_IQ4_NL, W.pack_iq4_nl(u8(16, rows, n), d32), rows, n
    if name == "iq4_xs":
        return (jgguf.GGML_IQ4_XS, W.pack_iq4_xs(
            u8(16, rows, n), d, u8(64, rows, nsb, 8)), rows, n)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["q8_0", "q4_k", "q5_k", "q6_k", "q2_k",
                                  "q3_k", "q5_0", "iq4_nl", "iq4_xs"])
def test_block_decoder_equals_the_jax_packages(name, tmp_path):
    """Each block decoder of the copy on the same raw bytes as the JAX
    package's: levels, scales, zeros and the dequantized tensor equal
    exactly (the same numpy code must give the same bits)."""
    gtype, blob, rows, n = _blocks(name, np.random.default_rng(5))
    path = str(tmp_path / f"{name}.gguf")
    W.write_gguf(path, {}, [("t", [n, rows], gtype, blob)])
    jg, tg = jgguf.GGUFFile(path), tgguf.GGUFFile(path)
    assert tgguf.BLOCK_INFO == jgguf.BLOCK_INFO
    want = jgguf.to_int4_pieces(jg, jg.tensors["t"])
    got = tgguf.to_int4_pieces(tg, tg.tensors["t"])
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tgguf.dequant_tensor(tg, tg.tensors["t"]),
        jgguf.dequant_tensor(jg, jg.tensors["t"]))


@pytest.mark.parametrize("gtype", [tgguf.GGML_F16, tgguf.GGML_BF16],
                         ids=["f16", "bf16"])
def test_half_width_dense_tensor_equals_the_jax_packages(gtype, tmp_path):
    """A dense 16-bit tensor widens to the same f32 bits as in the JAX
    package, for every kind of bit pattern (zeros, subnormals, infinities
    and NaNs among random ones). The copy decodes BF16 with numpy alone."""
    rows, n = 3, 64
    bits = np.random.default_rng(9).integers(
        0, 1 << 16, size=(rows, n)).astype(np.uint16)
    bits[0, :6] = [0x0000, 0x8000, 0x0001, 0x7F80, 0xFF80, 0x7FC0]
    path = str(tmp_path / "half.gguf")
    W.write_gguf(path, {}, [("t", [n, rows], gtype, bits.tobytes())])
    jg, tg = jgguf.GGUFFile(path), tgguf.GGUFFile(path)
    want = jgguf.dequant_tensor(jg, jg.tensors["t"])
    got = tgguf.dequant_tensor(tg, tg.tensors["t"])
    assert got.dtype == want.dtype == np.float32 and got.shape == (rows, n)
    np.testing.assert_array_equal(got.view(np.uint32) >> 31,
                                  want.view(np.uint32) >> 31)  # signs
    np.testing.assert_array_equal(got, want)


def test_iq1_s_decoder_keeps_its_opt_in(tmp_path, monkeypatch):
    """The copy carries the grid tables and the legacy-layout switch."""
    rng = np.random.default_rng(2)
    _, bbytes = tgguf.BLOCK_INFO[tgguf.GGML_IQ1_S]
    raw = rng.integers(0, 256, size=(2, 1, bbytes)).astype(np.uint8)
    raw[:, :, 0:2] = np.frombuffer(np.float16(0.03).tobytes(), np.uint8)
    path = str(tmp_path / "iq1.gguf")
    W.write_gguf(path, {}, [("t", [256, 2], tgguf.GGML_IQ1_S, raw.tobytes())])
    tg, jg = tgguf.GGUFFile(path), jgguf.GGUFFile(path)
    monkeypatch.delenv("APHRODITE_GGUF_IQ1S_LEGACY", raising=False)
    with pytest.raises(ValueError, match="legacy 512-grid"):
        tgguf.to_int4_pieces(tg, tg.tensors["t"])
    monkeypatch.setenv("APHRODITE_GGUF_IQ1S_LEGACY", "1")
    for w, g in zip(jgguf.to_int4_pieces(jg, jg.tensors["t"]),
                    tgguf.to_int4_pieces(tg, tg.tensors["t"])):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny checkpoint directory and one .gguf file of it per quant."""
    from tests.utils import make_tiny_llama_checkpoint

    root = tmp_path_factory.mktemp("tiny_gguf")
    hf_dir = str(root / "hf")
    make_tiny_llama_checkpoint(hf_dir, **GEOMETRY)
    files = {}
    for quant in QUANTS:
        files[quant] = str(root / f"model-{quant}.gguf")
        W.tiny_llama_to_gguf(hf_dir, files[quant], quant=quant)
    return hf_dir, files


def _host_trees(path):
    jconfig = JaxModelConfig(model=path, dtype="float32",
                             skip_tokenizer_init=True)
    config = ModelConfig(model=path, dtype="float32",
                         skip_tokenizer_init=True)
    assert config.hf_config == jconfig.hf_config
    assert config.quantization is None and jconfig.quantization is None
    jax_model, model = JaxLlama(jconfig), LlamaForCausalLM(config)
    want = jgguf.load_gguf_params_to_host(jax_model, path)
    got = tgguf.load_gguf_params_to_host(model, path)
    return jax_model, model, config, want, got


@pytest.mark.parametrize("quant", QUANTS)
def test_gguf_config_and_host_tree_equal_the_jax_packages(tiny, quant):
    """gguf_to_hf_config equal as dicts; the loaded host trees equal leaf
    by leaf: level bytes equal, scale, zero and dense leaves equal f32."""
    _, files = tiny
    path = files[quant]
    assert tgguf.gguf_to_hf_config(path) == jgguf.gguf_to_hf_config(path)
    _, model, config, want, got = _host_trees(path)
    _assert_trees_equal(want, jax.tree.map(lambda t: t.numpy(), got))
    for name in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
        w = got["layers"][name]
        if quant == "f32":
            assert w.dtype == torch.float32
            continue
        assert set(w) == {"q4", "scale", "zero"}  # full bytes: not packed
        assert w["q4"].dtype == torch.int8
        group = w["q4"].shape[-2] // w["scale"].shape[-2]
        assert group == (32 if quant == "q8_0" else 16)
    if quant == "q8_0":
        assert int(got["layers"]["wq"]["q4"].min()) < 0  # signed levels
    # load_model_params picks the format from the file name and keeps the
    # containers' own dtypes when it places them.
    placed = load_model_params(model, config, LoadConfig(),
                               torch.device("cpu"))
    _assert_trees_equal(jax.tree.map(lambda t: t.numpy(), got),
                        jax.tree.map(lambda t: t.numpy(), placed))
    # And the JAX tree carries across leaf for leaf.
    _assert_trees_equal(jax.tree.map(lambda t: t.numpy(), got),
                        jax.tree.map(lambda t: t.numpy(),
                                     params_from_jax(want)))


def test_gguf_layers_of_mixed_kinds_raise(tiny, tmp_path):
    """One layer's wq in Q4_K (packs to q4p) and the other's in Q6_K (one
    level per byte) cannot share a layer stack: the JAX package fails in
    np.stack, the port says why."""
    _, files = tiny
    src = tgguf.GGUFFile(files["q6_k"])
    rng = np.random.default_rng(9)
    tensors = []
    for name, info in src.tensors.items():
        raw = src.raw_blocks(info).tobytes()
        gtype = info.ggml_type
        if name == "blk.0.attn_q.weight":
            n, rows = info.dims
            nsb = n // 256
            u8 = lambda hi, *s: rng.integers(0, hi, size=s).astype(  # noqa
                np.uint8)
            d = np.full((rows, nsb), 0.01, np.float32)
            raw = W.pack_q4_k(u8(16, rows, n), d, d, u8(64, rows, nsb, 8),
                              u8(64, rows, nsb, 8))
            gtype = tgguf.GGML_Q4_K
        tensors.append((name, info.dims, gtype, raw))
    path = str(tmp_path / "mixed.gguf")
    meta = {k: v for k, v in src.metadata.items()
            if k != "general.alignment"}
    W.write_gguf(path, meta, tensors)
    jax_model, model, _, _, _ = _host_trees(files["q6_k"])
    with pytest.raises(ValueError, match="mix weight kinds"):
        tgguf.load_gguf_params_to_host(model, path)
    with pytest.raises(Exception):
        jgguf.load_gguf_params_to_host(jax_model, path)


def test_q6_k_forward_matches_jax(tiny):
    """A prefill step, then a decode step, through both models on the
    Q6_K tree (full-byte containers fused to wqkv and w13, every
    projection with its layer index); hidden states and logits in f32 at
    the tolerance of test_torch_quant.py's forward parity (f32 both sides,
    the sums in another order)."""
    _, files = tiny
    jax_model, model, _, want, got = _host_trees(files["q6_k"])
    jparams = jax_model.fuse_projections(jax.tree.map(jnp.asarray, want))
    params = model.fuse_projections(got)
    for name in ("wqkv", "w13"):
        assert set(params["layers"][name]) == {"q4", "scale", "zero"}
        _assert_trees_equal(
            jax.tree.map(np.asarray, jparams["layers"][name]),
            jax.tree.map(lambda t: t.numpy(), params["layers"][name]))
    ps, num_pages, pps = 4, 16, 8
    shape = (jax_model.num_layers, num_pages + 1, ps,
             *jax_model.kv_cache_shape_suffix)
    jkv, kv = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    rng = np.random.default_rng(0)
    vocab = model.vocab_size
    a, b = (rng.integers(0, vocab, n).tolist() for n in (11, 6))
    pa, pb = [0, 1, 2, 3], [5, 7, 9]
    steps = [([(a, 0, pa), (b, 0, pb)], 32, 4, False),
             ([(a[:1], 11, pa), (b[:1], 6, pb)], 4, 4, True)]
    for rows, T, S, decode in steps:
        jb, tb, n = _batch(rows, T, S, ps, pps, num_pages, decode)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb)
        hidden = model.forward(params, kv, tb)
        live = len(rows) if decode else n
        np.testing.assert_allclose(hidden[:live].numpy(),
                                   np.asarray(jhidden)[:live], rtol=1e-4,
                                   atol=1e-4)
        jlogits = np.asarray(jax_model.compute_logits(
            jparams, jhidden[jb.logits_indices]))[:len(rows)]
        logits = model.compute_logits(
            params, hidden[tb.logits_indices[:len(rows)]]).numpy()
        np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------


@pytest.mark.parametrize("quant", QUANTS)
def test_gguf_generation_matches_jax_engine(tiny, quant):
    """LLM(model=<file>.gguf, tokenizer=<dir>) on the CPU against the JAX
    engine on the same file: greedy token ids equal."""
    hf_dir, files = tiny
    sp = dict(temperature=0.0, max_tokens=10, ignore_eos=True)
    want = JaxLLM(model=files[quant], tokenizer=hf_dir, **ENGINE_KW).generate(
        PROMPTS, JaxSamplingParams(**sp))
    llm = LLM(model=files[quant], tokenizer=hf_dir, device="cpu",
              **ENGINE_KW)
    lp = llm.engine.runner.params["layers"]
    if quant != "f32":
        assert all(set(lp[n]) == {"q4", "scale", "zero"}
                   for n in ("wqkv", "wo", "w13", "down"))
    got = llm.generate(PROMPTS, SamplingParams(**sp))
    for g, w in zip(got, want):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
        assert g.outputs[0].text == w.outputs[0].text


def test_gguf_needs_a_tokenizer(tiny):
    _, files = tiny
    with pytest.raises(ValueError, match="tokenizer"):
        LLM(model=files["f32"], dtype="float32", device="cpu",
            num_device_blocks_override=64)
    # Token ids in, token ids out needs none; load_format passes through.
    llm = LLM(model=files["f32"], load_format="gguf",
              skip_tokenizer_init=True, device="cpu", **ENGINE_KW)
    out = llm.generate(prompt_token_ids=[[5, 6, 7]],
                       sampling_params=SamplingParams(
                           temperature=0.0, max_tokens=3, ignore_eos=True,
                           detokenize=False))
    assert len(out[0].outputs[0].token_ids) == 3


def test_act_order_gptq_checkpoint_generates_like_jax(tmp_path):
    """A GPTQ checkpoint whose g_idx is a permutation (desc_act) loads as
    unpacked containers with one scale row per weight row (G = 1) and
    generates the JAX engine's greedy tokens."""
    path = str(tmp_path / "gptq_act_order")
    _write_quantized_checkpoint(path, "gptq", seed=7, act_order=True)
    sp = dict(temperature=0.0, max_tokens=8, ignore_eos=True)
    want = JaxLLM(model=path, **ENGINE_KW).generate(
        PROMPTS, JaxSamplingParams(**sp))
    llm = LLM(model=path, device="cpu", **ENGINE_KW)
    w = llm.engine.runner.params["layers"]["wqkv"]
    assert set(w) == {"q4", "scale", "zero"}
    assert w["scale"].shape[-2] == w["q4"].shape[-2]  # G = 1
    got = llm.generate(PROMPTS, SamplingParams(**sp))
    for g, w in zip(got, want):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
