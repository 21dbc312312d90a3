"""The port's activation-quantized and 8-bit weight paths of ``qmatmul``
against the JAX package's, on the CPU: the per-token activation
quantizers (byte for byte), the plain W4A8 product (against the JAX
reference and the TPU kernel in interpret mode), the int8 and fp8 weight
quantizers (byte for byte), ``qmatmul`` on ``{q, scale}`` containers, the
W4A8 dispatch, quantized Llama forwards and greedy generation.

The JAX package takes W4A8 only on a TPU backend
(``int4p_matmul_stacked_dispatch``); the slice-level tests put a function
with the same conditions, the backend test lifted, in its place, and it
calls the JAX package's plain W4A8 product on the layer. On the CPU the
port's wrappers take their plain versions; the CUDA kernels are held
against those on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu import LLM as JaxLLM
from aphrodite_tpu import SamplingParams as JaxSamplingParams
from aphrodite_tpu.ops import quant_matmul as jqm
from aphrodite_tpu.quantization import fp8 as jfp8
from aphrodite_tpu.quantization import int4 as jint4
from aphrodite_tpu.quantization import int8 as jint8
from aphrodite_tpu.quantization import qlinear as jqlinear
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import dummy_params, params_from_jax
from aphrodite_tpu_torch.ops import quant_matmul as tqm
from aphrodite_tpu_torch.quantization import fp8, int8, qlinear
from tests.test_torch_quant import (ENGINE_KW, PACKABLE, PROMPTS, _batch,
                                     _models)

MEMBERS = ("q4p", "scale", "zero")


def _bytes(a):
    """The raw bytes of an e4m3 array or tensor (ml_dtypes or torch), or
    the values of any other, as numpy."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            a = a.view(torch.uint8)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _activations(rng, T, K, dtype):
    """Rows of x at several scales, with an all-zero row, a row with one
    large value, and a row of exact .5 steps of its own sx (127 x 0.5 on
    the grid): round half to even shows there."""
    x = rng.standard_normal((T, K)).astype(np.float32)
    x *= np.exp(rng.uniform(-6, 4, (T, 1))).astype(np.float32)
    x[0] = 0.0
    x[1, :] = rng.standard_normal(K) * 1e-3
    x[1, 7] = 300.0
    x[2] = (np.arange(K) % 255 - 127).astype(np.float32) * 0.5
    x[2, 0] = 127.0  # amax 127: sx = 1, so x / sx is exact
    if dtype == "bf16":
        return torch.from_numpy(x).to(torch.bfloat16)
    return torch.from_numpy(x)


def _jax_x(x):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


# ----------------------------------------------------------------------
# Activation quantizers
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_int8_matches_jax_bytes(dtype):
    x = _activations(np.random.default_rng(0), 64, 512, dtype)
    want_q, want_s = jqm.quantize_activations_int8(_jax_x(x))
    before = tqm.quantize_activations.launches
    for xq, sx in (tqm.quantize_activations_int8(x),
                   tqm.quantize_activations(x, "int8")):
        assert xq.dtype == torch.int8 and sx.shape == (64, 1)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(sx.numpy(), np.asarray(want_s))
    assert tqm.quantize_activations.launches == before  # CPU: no kernel
    assert np.asarray(want_s)[0, 0] == np.float32(1e-8) / np.float32(127)
    assert np.abs(np.asarray(want_q)[1]).max() == 127  # the large value
    # The .5 steps of row 2 round half to even.
    np.testing.assert_array_equal(
        xq.numpy()[2, 1:6], np.round(x.float().numpy()[2, 1:6]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_e4m3_matches_jax_bytes(dtype):
    """The activation cast of the JAX package's _fp8_w8a8_matmul, written
    out here with its own jnp expressions (qlinear.py has no function for
    it alone)."""
    x = _activations(np.random.default_rng(1), 64, 512, dtype)
    jx = _jax_x(x)
    absmax = jnp.max(jnp.abs(jx), axis=-1, keepdims=True)
    act_scale = jnp.maximum(absmax.astype(jnp.float32) / 448.0, 1e-12)
    want_q = (jx / act_scale).astype(jnp.float8_e4m3fn)
    for xq, s in (tqm.quantize_activations_e4m3(x),
                  tqm.quantize_activations(x, "e4m3")):
        assert xq.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(_bytes(xq), _bytes(want_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(act_scale))
    with pytest.raises(ValueError, match="format"):
        tqm.quantize_activations(x, "e5m2")


# ----------------------------------------------------------------------
# The plain W4A8 product
# ----------------------------------------------------------------------

W4A8_CASES = {
    # T, K, N, G, layers, layer_idx, pallas kwargs, zero outside 0..15
    "T16": (16, 512, 256, 128, 1, None, {}, False),
    "T32": (32, 512, 256, 64, 1, None, {}, False),
    "T128": (128, 1024, 256, 128, 1, None, dict(block_kp=128), False),
    "stacked": (32, 512, 256, 128, 3, 1, {}, False),
    "wide_zero": (16, 512, 256, 128, 2, 0, {}, True),
}


@pytest.mark.parametrize("case", sorted(W4A8_CASES))
def test_int4p_matmul_w4a8_matches_jax_ref_and_pallas_interpret(case):
    T, K, N, G, L, idx, kw, wide = W4A8_CASES[case]
    rng = np.random.default_rng(2)
    c = jint4.quantize_from_float(
        rng.standard_normal((L, K, N)).astype(np.float32), group=G)
    if wide:
        c["zero"] = c["zero"] + rng.integers(-9, 10, c["zero"].shape).astype(
            np.float32)
        assert c["zero"].min() < 0 and c["zero"].max() > 15
    if idx is None:
        c = {k: v[0] for k, v in c.items()}
    x = (rng.standard_normal((T, K)) * 0.3).astype(np.float32)
    before = tqm.int4p_matmul_w4a8.launches
    got = tqm.int4p_matmul_w4a8(torch.from_numpy(x),
                                *(torch.from_numpy(c[k]) for k in MEMBERS), G,
                                layer_idx=idx).numpy()
    assert tqm.int4p_matmul_w4a8.launches == before
    assert got.dtype == np.float32 and got.shape == (T, N)
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    one = {k: (v if idx is None else v[idx]) for k, v in jc.items()}
    ref = np.asarray(jqm.int4p_matmul_w4a8_ref(
        jnp.asarray(x), *(one[k] for k in MEMBERS), G))
    kernel = np.asarray(jqm.int4p_matmul_w4a8_pallas(
        jnp.asarray(x), *(jc[k] for k in MEMBERS), G, layer_idx=idx,
        interpret=True, **kw))
    # The JAX package's own tolerance for its kernel against its reference
    # (tests/test_quantization.py: test_w4a8_kernel_matches_ref): the same
    # int8 activations on both sides, f32 sums in another order.
    for want in (ref, kernel):
        assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 1e-5


# ----------------------------------------------------------------------
# Weight quantizers, qmatmul, dequantize
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_int8_quantize_from_float_matches_jax_bytes(kind):
    w = np.random.default_rng(3).standard_normal((2, 256, 128)).astype(
        np.float32)
    w[1, :, 5] = 0.0  # a zero column: scale 1e-8
    want = jint8.quantize_from_float(w)
    got = int8.quantize_from_float(w if kind == "numpy"
                                   else torch.from_numpy(w))
    assert set(got) == set(want) == {"q", "scale"}
    for k in want:
        assert np.asarray(got[k]).dtype == want[k].dtype
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_fp8_quantize_from_float_matches_jax_bytes(kind):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((2, 256, 128)).astype(np.float32)
    # Values far under their column's largest: e4m3 subnormals.
    w[0, :16, 3] = np.linspace(-5e-5, 5e-5, 16)
    w[1, :, 5] = 0.0
    want = jfp8.quantize_from_float(w)
    got = fp8.quantize_from_float(w if kind == "numpy"
                                  else torch.from_numpy(w))
    assert got["q"].dtype == torch.float8_e4m3fn
    assert got["q"].is_contiguous()  # the kernel's layout comes at fusion
    np.testing.assert_array_equal(_bytes(got["q"]), _bytes(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    assert (_bytes(want["q"]) & 0x7F).min() == 0  # zeros present
    b = _bytes(want["q"])
    assert (((b & 0x78) == 0) & ((b & 0x07) != 0)).any()  # subnormals


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("layer", [None, 1])
def test_qmatmul_q_scale_containers_match_jax(kind, layer):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 256, 128)).astype(np.float32)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    jmod = {"int8": jint8, "fp8": jfp8}[kind]
    c = jmod.quantize_from_float(w if layer is not None else w[0])
    t = params_from_jax({"w": c})["w"]
    assert qlinear.is_quantized(t)
    one = c if layer is None else {k: v[layer] for k, v in c.items()}
    jc = {k: jnp.asarray(v) for k, v in one.items()}
    want = np.asarray(jqlinear.qmatmul(jnp.asarray(x), jc))
    got = qlinear.qmatmul(torch.from_numpy(x), t, layer)
    assert got.dtype == torch.float32
    # test_qmatmul_and_dequantize_match_jax's tolerance (f32 sums in
    # another order).
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    deq = qlinear.dequantize(t, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy() if layer is None else deq.numpy()[layer],
        np.asarray(jqlinear.dequantize(jc, jnp.float32)))


def test_fp8_members_keep_their_layout_when_fused_and_stacked():
    """Dummy fp8 weights stack per layer as any weight does; fusion keeps
    every fp8 q row-major [K, N] (the layout the card's product reads, as
    every other container's) with the values of the fused members, and the
    scales as they are. A second fusion copies nothing."""
    _, model = _models()
    params = dummy_params(model, 0, torch.device("cpu"), torch.float32,
                          method=fp8)
    lp = params["layers"]
    parts = [lp["gate"], lp["up"]]
    assert parts[0]["q"].is_contiguous()
    want = torch.cat([p["q"].float() for p in parts], dim=-1)
    model.fuse_projections(params)
    for name in ("wqkv", "wo", "w13", "down"):
        q, scale = lp[name]["q"], lp[name]["scale"]
        assert q.dtype == torch.float8_e4m3fn
        assert q.is_contiguous()  # row-major [L, K, N]
        assert scale.is_contiguous()
    assert torch.equal(lp["w13"]["q"].float(), want)
    q = lp["w13"]["q"]
    model.fuse_projections(params)
    assert lp["w13"]["q"].data_ptr() == q.data_ptr()


# ----------------------------------------------------------------------
# The W4A8 dispatch
# ----------------------------------------------------------------------


@pytest.mark.parametrize("switch,T,layer,shape,want", [
    ("0", 16, 1, "ok", "w4a16"),
    ("1", 16, 1, "ok", "w4a8"),
    ("1", 15, 1, "ok", "w4a16"),
    ("1", 16, None, "ok", "w4a16"),
    ("1", 64, 0, "ok", "w4a8"),
    ("1", 16, 1, "n64", "w4a16"),
    ("1", 16, 1, "g1", "w4a16"),
])
def test_w4a8_dispatch_follows_the_jax_conditions(monkeypatch, switch, T,
                                                  layer, shape, want):
    monkeypatch.setenv("APHRODITE_W4_A8", switch)
    K = 256
    N = 64 if shape == "n64" else 128
    rows = K if shape == "g1" else K // 128  # group 1 or 128
    L = 2 if layer is not None else 1
    w = {"q4p": torch.zeros((L, K // 2, N), dtype=torch.int8),
         "scale": torch.ones((L, rows, N)), "zero": torch.zeros((L, rows, N))}
    if layer is None:
        w = {k: v[0] for k, v in w.items()}
    calls = []
    for name, fn in (("w4a16", qlinear.int4p_matmul),
                     ("w4a8", qlinear.int4p_matmul_w4a8)):
        monkeypatch.setattr(
            qlinear, fn.__name__,
            lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    out = qlinear.qmatmul(torch.ones((T, K)), w, layer)
    assert calls == [want] and out.shape == (T, N)


# ----------------------------------------------------------------------
# Slice level: forwards and greedy generation against the JAX package
# ----------------------------------------------------------------------


@pytest.fixture
def jax_w4a8(monkeypatch):
    """The JAX package's stacked packed dispatch with the TPU-backend test
    lifted; counts the W4A8 calls it makes."""
    calls = {"w4a8": 0, "w4a16": 0}

    def dispatch(x, q4p, scale, zero, group, layer_idx):
        if x.ndim > 2:
            lead = x.shape[:-1]
            out = dispatch(x.reshape(-1, x.shape[-1]), q4p, scale, zero,
                           group, layer_idx)
            return out.reshape(*lead, -1)
        T = x.shape[0]
        Kh, N = q4p.shape[-2], q4p.shape[-1]
        args = (x, q4p[layer_idx], scale[layer_idx], zero[layer_idx], group)
        if (N % 128 == 0 and group > 1 and Kh % group == 0 and T >= 16
                and os.environ.get("APHRODITE_W4_A8") == "1"):
            calls["w4a8"] += 1
            return jqm.int4p_matmul_w4a8_ref(*args)
        calls["w4a16"] += 1
        return jqm.int4p_matmul_ref(*args)

    monkeypatch.setattr(jqm, "int4p_matmul_stacked_dispatch", dispatch)
    monkeypatch.setenv("APHRODITE_W4_A8", "1")
    return calls


def _quantized_params(jax_model, method, seed):
    params = jax.tree.map(np.asarray, jax_model.random_params(seed=seed))
    for path in jax_model.quantizable_weights():
        name = path.split(".")[1]
        params["layers"][name] = method.quantize_from_float(
            params["layers"][name])
    return params


@pytest.mark.parametrize("kind", ["gptq_w4a8", "int8", "fp8"])
def test_quantized_forward_matches_jax(request, kind):
    """A prefill step (32 tokens: W4A8 with the switch) and a pure decode
    step (4 tokens: W4A16) through both models with the same containers;
    hidden states and logits in f32."""
    calls = request.getfixturevalue("jax_w4a8") if kind == "gptq_w4a8" \
        else None
    method = {"gptq_w4a8": jint4, "int8": jint8, "fp8": jfp8}[kind]
    ps, num_pages, pps = 4, 16, 8
    jax_model, model = _models()
    host = _quantized_params(jax_model, method, seed=5)
    jparams = jax_model.fuse_projections(jax.tree.map(jnp.asarray, host))
    params = model.fuse_projections(params_from_jax(host))
    assert {"wqkv", "w13"} <= set(params["layers"])
    shape = (jax_model.num_layers, num_pages + 1, ps,
             *jax_model.kv_cache_shape_suffix)
    jkv, kv = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, PACKABLE["vocab_size"], n).tolist()
            for n in (11, 6))
    pa, pb = [0, 1, 2, 3], [5, 7, 9]
    steps = [([(a, 0, pa), (b, 0, pb)], 32, 4, False),
             ([(a[:1], 11, pa), (b[:1], 6, pb)], 4, 4, True)]
    launches = tqm.int4p_matmul_w4a8.launches
    for rows, T, S, decode in steps:
        jb, tb, n = _batch(rows, T, S, ps, pps, num_pages, decode)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb)
        hidden = model.forward(params, kv, tb)
        live = len(rows) if decode else n
        # f32 both sides, sums in another order; the int8 and e4m3
        # activations are bit-equal on both sides, so a sum's order moves a
        # value only where it lands next to a rounding boundary of the next
        # layer's quantizer.
        np.testing.assert_allclose(hidden[:live].numpy(),
                                   np.asarray(jhidden)[:live], rtol=1e-4,
                                   atol=1e-4)
        jlogits = np.asarray(jax_model.compute_logits(
            jparams, jhidden[jb.logits_indices]))[:len(rows)]
        logits = model.compute_logits(
            params, hidden[tb.logits_indices[:len(rows)]]).numpy()
        np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)
        assert (logits.argmax(-1) == jlogits.argmax(-1)).all()
    assert tqm.int4p_matmul_w4a8.launches == launches  # CPU: plain versions
    if calls is not None:
        # The prefill took W4A8, the decode step W4A16 (counted per trace
        # of the JAX package's layer scan).
        assert calls["w4a8"] > 0 and calls["w4a16"] > 0


@pytest.fixture(scope="module")
def dense_dir(tmp_path_factory):
    from tests.utils import make_tiny_llama_checkpoint

    path = tmp_path_factory.mktemp("tiny_llama_w4a8")
    make_tiny_llama_checkpoint(str(path), **PACKABLE)
    return str(path)


@pytest.mark.parametrize("quantization", ["gptq_w4a8", "int8", "fp8"])
def test_quantized_engine_generates_like_jax(request, dense_dir,
                                             quantization):
    """Greedy tokens of LLM(..., device="cpu") equal the JAX engine's on a
    dense checkpoint quantized at load; gptq with APHRODITE_W4_A8=1 and
    the lifted JAX dispatch."""
    calls = None
    if quantization == "gptq_w4a8":
        calls = request.getfixturevalue("jax_w4a8")
        quantization = "gptq"
    sp = dict(temperature=0.0, max_tokens=10, ignore_eos=True)
    want = JaxLLM(model=dense_dir, quantization=quantization,
                  **ENGINE_KW).generate(PROMPTS, JaxSamplingParams(**sp))
    llm = LLM(model=dense_dir, quantization=quantization, device="cpu",
              **ENGINE_KW)
    lp = llm.engine.runner.params["layers"]
    if quantization != "gptq":
        dtype = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[quantization]
        for name in ("wqkv", "wo", "w13", "down"):
            assert set(lp[name]) == {"q", "scale"}
            assert lp[name]["q"].dtype == dtype
    got = llm.generate(PROMPTS, SamplingParams(**sp))
    for g, w in zip(got, want):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
    if calls is not None:
        assert calls["w4a8"] > 0  # the prompts' prefill took W4A8
