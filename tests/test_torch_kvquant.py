"""The port's quantized KV cache (float8_e4m3fn, float8_e5m2, int8 pages)
against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
aphrodite_tpu_torch: quantize-on-write (cache bytes must be equal), the
plain attention versions on narrow pages (against the TPU kernels under
the Pallas interpreter and the jnp reference), the scale loader, a Llama
forward with folded scales, ``LLM.generate`` and the calibration tool. On
the CPU the port's wrappers take their plain versions; the CUDA variants
that read narrow pages are held against those by tests/test_torch_cuda.py
on the card.
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
from aphrodite_tpu.loader.weights import \
    load_kv_cache_scales as jax_load_kv_cache_scales
from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu.ops.decode_attention import \
    paged_decode_attention as jax_decode
from aphrodite_tpu.ops.kv_cache import write_kv as jax_write_kv
from aphrodite_tpu.tools import kv_calibrate as jax_kv_calibrate
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.common.config import CacheConfig
from aphrodite_tpu_torch.loader.weights import (kv_scales_from_jax,
                                                load_kv_cache_scales,
                                                params_from_jax)
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    paged_decode_attention, ref_paged_decode_attention)
from aphrodite_tpu_torch.ops.kv_cache import write_kv
from aphrodite_tpu_torch.tools import kv_calibrate
from tests import test_torch_llama as llama_case
from tests.test_torch_cuda import PS, paged_batch

# name -> (torch type, jnp type)
NARROW = {
    "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
    "e5m2": (torch.float8_e5m2, jnp.float8_e5m2),
    "int8": (torch.int8, jnp.int8),
}


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def _jbytes(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _narrow_pages(kv: np.ndarray, name: str):
    """f32 pages as narrow pages, the same bytes for both frameworks
    (int8: values times 80, as tests/test_decode_kernel_quant.py)."""
    _, jdt = NARROW[name]
    if name == "int8":
        jpages = jnp.clip(jnp.round(jnp.asarray(kv) * 80), -128,
                          127).astype(jnp.int8)
    else:
        jpages = jnp.asarray(kv).astype(jdt)
    pages = torch.from_numpy(_jbytes(jpages).copy()).view(NARROW[name][0])
    return pages, jpages


# ----------------------------------------------------------------------
# write_kv
# ----------------------------------------------------------------------


def _write_case(rng, in_dtype):
    num_pages, num_kv_heads, head_dim, T = 6, 2, 16, 11
    shape = (num_pages + 1, PS, 2 * num_kv_heads, head_dim)
    # |x| <= 20: with scale 0.05 the quotient stays under E4M3's 448.
    k, v = (np.clip(rng.standard_normal((T, num_kv_heads, head_dim)) * 6,
                    -20, 20).astype(np.float32) for _ in range(2))
    if in_dtype == "bfloat16":
        k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in (k, v))
    slots = np.concatenate([
        rng.permutation(num_pages * PS)[:T - 3],
        num_pages * PS + np.arange(3) % PS,  # padding -> trash page
    ]).astype(np.int32)
    return shape, k, v, slots


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("name", sorted(NARROW))
def test_write_kv_bytes_match_jax(name, scaled, in_dtype):
    tdt, jdt = NARROW[name]
    shape, k, v, slots = _write_case(np.random.default_rng(1), in_dtype)
    scales = (0.05, 0.07) if scaled else (None, None)
    if name != "int8" and not scaled:
        k, v = k * 10, v * 10  # use the formats' range: up to 200
    jin = jnp.dtype(in_dtype)
    jscales = {f"{n}_scale": (None if s is None else jnp.float32(s))
               for n, s in zip("kv", scales)}
    want = jax_write_kv(jnp.zeros(shape, jdt), jnp.asarray(k, jin),
                        jnp.asarray(v, jin), jnp.asarray(slots), **jscales)
    cache = torch.zeros(shape, dtype=tdt)
    tin = getattr(torch, in_dtype)
    out = write_kv(cache, torch.from_numpy(k).to(tin),
                   torch.from_numpy(v).to(tin), torch.from_numpy(slots),
                   *(None if s is None else torch.tensor(s, dtype=torch.float32)
                     for s in scales))
    assert out.data_ptr() == cache.data_ptr()  # written in place
    assert cache.dtype == tdt
    np.testing.assert_array_equal(_bytes(cache), _jbytes(want))
    assert _bytes(cache).any()


@pytest.mark.parametrize("name,limit", [("e4m3", 448.0), ("e5m2", 57344.0),
                                        ("int8", 127.0)])
def test_write_kv_overflow_saturates_where_jax_poisons(name, limit):
    """Divergence by design: past the format's range the port writes the
    largest finite value; the JAX cast writes NaN (E4M3) or inf (E5M2),
    which poisons every row that attends to the slot. int8 clips in both."""
    tdt, jdt = NARROW[name]
    shape = (2, PS, 2, 8)
    k = np.zeros((1, 1, 8), np.float32)
    k[0, 0, :4] = (limit * 1.2, -limit * 1.2, 1e9, -1e9)
    k[0, 0, 4] = limit
    v = -k
    slots = np.asarray([3], np.int32)
    cache = torch.zeros(shape, dtype=tdt)
    write_kv(cache, torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(slots))
    got = cache.view(-1, 2, 8)[3].float().numpy()
    lo = -128.0 if name == "int8" else -limit
    np.testing.assert_array_equal(
        got[0], [limit, lo, limit, lo, limit, 0, 0, 0])
    np.testing.assert_array_equal(
        got[1], [lo, limit, lo, limit, -limit, 0, 0, 0])
    want = np.asarray(jax_write_kv(
        jnp.zeros(shape, jdt), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(slots)).reshape(-1, 2, 8)[3], np.float32)
    if name == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert not np.isfinite(want[:, :4]).any()
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])


# ----------------------------------------------------------------------
# Plain attention on narrow pages
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(NARROW))
def test_ref_decode_on_narrow_pages_matches_jax_kernel_interpret(name):
    """bf16 q over 8-bit pages at the shapes the JAX decode kernel takes
    (head_dim 128, 8 sequences, one dead), under the Pallas interpreter."""
    rng = np.random.default_rng(2)
    seqs = [(1, int(n)) for n in rng.integers(1, 64, size=7)]
    q, kv, kv_lens, pages, cu = paged_batch(rng, seqs, 8, 2, 128,
                                            padded_seqs=8, padded_tokens=8)
    kvt, kvj = _narrow_pages(kv, name)
    qb = jnp.asarray(q, jnp.bfloat16)
    want = np.asarray(jax_decode(qb, kvj, jnp.asarray(kv_lens),
                                 jnp.asarray(pages),
                                 jnp.asarray([7], jnp.int32),
                                 sm_scale=0.125, interpret=True), np.float32)
    qt = torch.from_numpy(np.asarray(qb, np.float32)).to(torch.bfloat16)
    idx = (torch.from_numpy(kv_lens), torch.from_numpy(pages))
    got = ref_paged_decode_attention(qt, kvt, *idx, sm_scale=0.125)
    # The tolerance of test_ref_decode_matches_jax_kernel_interpret in
    # test_torch_ops.py: the TPU kernel rounds q * sm_scale and the
    # probabilities to bf16, the plain version keeps f32.
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    assert not got[7].float().any() and not want[7].any()  # dead row
    # The wrapper takes the plain version on the CPU, and the ragged
    # plain version computes the same rows for q_len 1.
    torch.testing.assert_close(
        paged_decode_attention(qt, kvt, *idx, sm_scale=0.125), got,
        rtol=0, atol=0)
    cu[1:8] = np.arange(1, 8)
    cu[8] = 7
    ragged = ref_ragged_paged_attention(
        qt, kvt, *idx, torch.from_numpy(cu), sm_scale=0.125)
    torch.testing.assert_close(ragged[:7], got[:7], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["e4m3", "e5m2"])
def test_ref_ragged_on_fp8_pages_matches_jax_fork_interpret(monkeypatch,
                                                            name):
    """Against the vendored Pallas fork, where the JAX package sends fp8
    prefill, under the interpreter, at the shapes of
    tests/test_alibi_kernel.py: test_fork_fp8_kv_no_alibi."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interpreted(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jax_fork.pl, "pallas_call", interpreted)
    rng = np.random.default_rng(5)
    T, Hq, Hkv, D, S, pps = 24, 4, 2, 128, 3, 6
    q = jnp.asarray(rng.standard_normal((T, Hq, D)) * 0.3, jnp.bfloat16)
    kv = (rng.standard_normal((S * pps + 2, PS, 2 * Hkv, D))
          * 0.3).astype(np.float32)
    kvt, kvj = _narrow_pages(kv, name)
    kv_lens = np.asarray([10, 37, 8], np.int32)
    pages = np.arange(S * pps, dtype=np.int32).reshape(S, pps)
    cu = np.asarray([0, 1, 16, 24], np.int32)
    ns = np.asarray([S], np.int32)
    want = np.asarray(jax_fork.ragged_paged_attention_alibi(
        q, kvj, jnp.asarray(kv_lens), jnp.asarray(pages), jnp.asarray(cu),
        jnp.asarray(ns), None, sm_scale=0.25, num_kv_pages_per_block=2,
        num_queries_per_block=8), np.float32)
    qt = torch.from_numpy(np.asarray(q, np.float32)).to(torch.bfloat16)
    args = (qt, kvt, *(torch.from_numpy(a) for a in (kv_lens, pages, cu, ns)))
    got = ref_ragged_paged_attention(*args, sm_scale=0.25)
    # The fork's own tolerance against its jnp reference.
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)
    torch.testing.assert_close(ragged_paged_attention(*args, sm_scale=0.25),
                               got, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(NARROW))
def test_ref_ragged_on_narrow_pages_matches_jax_reference(name):
    """f32 q over 8-bit pages against the jnp reference (where the JAX
    package's CPU path, and its int8 prefill, end up): only the order of
    the f32 sums differs."""
    seqs = [(1, 23), (9, 9), (7, 40), (6, 6)]
    rng = np.random.default_rng(0)
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages, cu = paged_batch(rng, seqs, 4, 2, 32,
                                            padded_seqs=8,
                                            padded_tokens=tokens + 4)
    if name == "int8":
        q = q / 80  # the int8 pages hold 80 times the values
    kvt, kvj = _narrow_pages(kv, name)
    ns = np.asarray([len(seqs)], np.int32)
    want = np.asarray(jax_ref(jnp.asarray(q), kvj, jnp.asarray(kv_lens),
                              jnp.asarray(pages), jnp.asarray(cu),
                              jnp.asarray(ns), sm_scale=0.3,
                              sliding_window=30))
    got = ref_ragged_paged_attention(
        torch.from_numpy(q), kvt,
        *(torch.from_numpy(a) for a in (kv_lens, pages, cu, ns)),
        sm_scale=0.3, sliding_window=30).numpy()
    scale = np.abs(want[:tokens]).max()
    np.testing.assert_allclose(got[:tokens], want[:tokens], rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))
    assert not got[tokens:].any()


@pytest.mark.parametrize("op", ["ragged", "decode"])
@pytest.mark.parametrize("name", sorted(NARROW))
def test_wrappers_raise_for_narrow_pages_off_cpu_without_kernel(op, name):
    """Narrow pages that lie neither on the CPU nor on a card are refused:
    the wrappers launch a kernel or raise, never fall back."""
    q = torch.empty((4, 4, 128), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((3, PS, 2, 128), dtype=NARROW[name][0], device="meta")
    idx = torch.empty((4,), dtype=torch.int32, device="meta")
    pages = torch.empty((4, 2), dtype=torch.int32, device="meta")
    before = (ragged_paged_attention.launches,
              dict(ragged_paged_attention.launches_by_dtype),
              paged_decode_attention.launches,
              dict(paged_decode_attention.launches_by_dtype))
    with pytest.raises(ValueError, match="CUDA"):
        if op == "ragged":
            ragged_paged_attention(q, kv, idx, pages,
                                   torch.empty((5,), dtype=torch.int32,
                                               device="meta"), idx)
        else:
            paged_decode_attention(q, kv, idx, pages)
    assert before == (ragged_paged_attention.launches,
                      ragged_paged_attention.launches_by_dtype,
                      paged_decode_attention.launches,
                      paged_decode_attention.launches_by_dtype)


# ----------------------------------------------------------------------
# Scales
# ----------------------------------------------------------------------


def _scales_json(path, value, layers=2):
    payload = {"kv_cache": {"scaling_factor": {"0": {
        str(i): value * (i + 1) for i in range(layers)}}}}
    path.write_text(json.dumps(payload))
    return str(path)


@pytest.mark.parametrize("source", ["json", "checkpoint", "default"])
def test_load_kv_cache_scales_matches_jax(source, tmp_path):
    from safetensors.numpy import save_file

    num_layers = 3
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    tensors = {"model.embed_tokens.weight": np.zeros((2, 2), np.float32)}
    path = None
    if source == "json":
        # Layer 7 is out of range and dropped; layer 2 keeps the default.
        path = tmp_path / "scales.json"
        path.write_text(json.dumps({"kv_cache": {"scaling_factor": {
            "0": {"0": 0.25, "1": 0.0625, "7": 3.0}}}}))
        path = str(path)
    elif source == "checkpoint":
        for i, (k, v) in enumerate([(0.5, 0.75), (0.125, 2.0)]):
            prefix = f"model.layers.{i}.self_attn"
            tensors[f"{prefix}.k_scale"] = np.asarray(k, np.float32)
            tensors[f"{prefix}.v_scale"] = np.asarray([v], np.float32)
    save_file(tensors, str(model_dir / "model.safetensors"))
    want = jax_load_kv_cache_scales(str(model_dir), num_layers, path)
    got = load_kv_cache_scales(str(model_dir), num_layers, path)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (num_layers,)
        np.testing.assert_array_equal(g, w)
    if source == "default":
        assert (got[0] == 1).all() and (got[1] == 1).all()
    else:
        assert (got[0] != 1).any()
    k, v = kv_scales_from_jax(want, torch.device("cpu"))
    assert k.dtype == v.dtype == torch.float32
    np.testing.assert_array_equal(k.numpy(), want[0])
    np.testing.assert_array_equal(v.numpy(), want[1])


def test_unknown_kv_cache_dtype_raises(tiny_llama_dir):
    with pytest.raises(ValueError, match="kv cache dtype"):
        CacheConfig(cache_dtype="fp4")
    with pytest.raises(ValueError, match="kv cache dtype"):
        LLM(model=tiny_llama_dir, device="cpu", kv_cache_dtype="float16")
    for name in ("auto", "bfloat16", "fp8", "fp8_e4m3", "fp8_e5m2", "int8"):
        assert CacheConfig(cache_dtype=name).cache_dtype == name


# ----------------------------------------------------------------------
# Llama forward with folded scales
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(NARROW))
def test_forward_with_kv_scales_matches_jax(name):
    """A prefill step, a mixed step and a pure decode step through both
    models with a narrow cache: hidden states as in test_torch_llama.py,
    and the caches byte for byte."""
    tdt, jdt = NARROW[name]
    jax_model, model = llama_case._models()
    jparams = jax_model.fuse_projections(
        jax.tree.map(jnp.asarray, jax_model.random_params(seed=3)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    np_scales = (np.asarray([0.05, 0.04], np.float32),
                 np.asarray([0.03, 0.06], np.float32))
    jscales = tuple(jnp.asarray(a) for a in np_scales)
    scales = kv_scales_from_jax(np_scales, torch.device("cpu"))
    shape = (jax_model.num_layers, llama_case.NUM_PAGES + 1, llama_case.PS,
             *jax_model.kv_cache_shape_suffix)
    jkv = jnp.zeros(shape, jdt)
    kv = torch.zeros(shape, dtype=tdt)
    rng = np.random.default_rng(0)
    vocab = llama_case.HF["vocab_size"]
    a, b, c = (rng.integers(0, vocab, n).tolist() for n in (11, 10, 5))
    pa, pb, pc = [0, 1, 2, 3], [5, 7, 9], [11, 12]
    steps = [
        ([(a, 0, pa), (b[:6], 0, pb)], 24, 4, False),
        ([(a[:1], 11, pa), (b[6:], 6, pb), (c, 0, pc)], 16, 4, False),
        ([(a[:1], 12, pa), (b[:1], 10, pb), (c[:1], 5, pc)], 4, 4, True),
    ]
    for rows, T, S, decode in steps:
        jb, tb, n = llama_case._batch(rows, T, S, decode)
        jkv, jhidden = jax_model.forward(jparams, jkv, jb, kv_scales=jscales)
        hidden = model.forward(params, kv, tb, scales)
        live = len(rows) if decode else n
        np.testing.assert_allclose(hidden[:live].numpy(),
                                   np.asarray(jhidden)[:live], rtol=1e-4,
                                   atol=1e-4)
        assert kv.dtype == tdt and jkv.dtype == jdt
        np.testing.assert_array_equal(
            _bytes(kv[:, :llama_case.NUM_PAGES]),
            _jbytes(jkv[:, :llama_case.NUM_PAGES]))
    assert _bytes(kv).any()


# ----------------------------------------------------------------------
# End to end
# ----------------------------------------------------------------------

# Chunked prefill (a 16-token budget) mixed with decodes, then 4-step
# decode windows, as tests/test_torch_engine.py.
ENGINE_KW = dict(dtype="float32", max_num_seqs=8, max_num_batched_tokens=16,
                 num_device_blocks_override=128, block_size=8,
                 num_scheduler_steps=4)
PROMPTS = ["the quick brown fox", "hello world, this is",
           "one two three four five"]


def _generate_both(model_dir, **kw):
    want = JaxLLM(model=model_dir, **ENGINE_KW, **kw).generate(
        PROMPTS, JaxSamplingParams(temperature=0.0, max_tokens=12,
                                   ignore_eos=True))
    llm = LLM(model=model_dir, device="cpu", **ENGINE_KW, **kw)
    got = llm.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=12,
                                               ignore_eos=True))
    return llm, got, want


@pytest.mark.parametrize("kv_dtype", ["fp8_e4m3", "fp8_e5m2", "int8"])
def test_greedy_tokens_with_a_narrow_cache_match_jax_engine(
        tiny_llama_dir, tmp_path, kv_dtype):
    """Scales 0.05 and 0.1 from a JSON file, as tests/test_kv_cache_quant.py
    gives int8."""
    path = _scales_json(tmp_path / "scales.json", 0.05)
    llm, got, want = _generate_both(tiny_llama_dir, kv_cache_dtype=kv_dtype,
                                    quantization_param_path=path)
    runner = llm.engine.runner
    assert runner.kv_cache.dtype == runner.kv_dtype
    assert runner.kv_cache.dtype.itemsize == 1
    np.testing.assert_allclose(runner.kv_scales[0].numpy(), [0.05, 0.1])
    np.testing.assert_allclose(runner.kv_scales[1].numpy(), [0.05, 0.1])
    for g, w in zip(got, want):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
        assert g.outputs[0].text == w.outputs[0].text


def test_gptq_weights_with_an_fp8_cache_generate_like_jax(tmp_path):
    """The north-star pairing: int4 weights (quantized at load) and an
    E4M3 cache with default scales."""
    from tests.test_torch_quant import PACKABLE
    from tests.utils import make_tiny_llama_checkpoint

    make_tiny_llama_checkpoint(str(tmp_path), **PACKABLE)
    llm, got, want = _generate_both(str(tmp_path), quantization="gptq",
                                    kv_cache_dtype="fp8")
    runner = llm.engine.runner
    assert runner.kv_cache.dtype == torch.float8_e4m3fn
    assert "q4p" in runner.params["layers"]["wqkv"]
    assert runner.kv_scales[0].eq(1).all() and runner.kv_scales[1].eq(1).all()
    for g, w in zip(got, want):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids


def test_narrow_cache_gets_twice_the_pages_of_bf16(tiny_llama_dir):
    """A page of an 8-bit cache takes half the bytes of a bf16 page, and a
    full-precision cache holds no scales."""
    kw = dict(ENGINE_KW, dtype="bfloat16")
    wide = LLM(model=tiny_llama_dir, device="cpu", **kw).engine.runner
    narrow = LLM(model=tiny_llama_dir, device="cpu", kv_cache_dtype="fp8",
                 **kw).engine.runner
    assert wide.kv_scales is None and wide.kv_cache.dtype == torch.bfloat16
    assert wide._kv_page_bytes() == 2 * narrow._kv_page_bytes()
    assert (narrow.kv_cache.nbytes * 2 == wide.kv_cache.nbytes)


def test_kv_calibrate_round_trip_matches_jax_tool(tiny_llama_dir, tmp_path):
    """calibrate -> export -> load, in both packages, on the same
    checkpoint and prompts. Each prompt fills its 16-token step, so no
    padding token writes to the cache (the two packages' attention gives
    padding tokens other values, which no request reads)."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 256, 16).tolist() for _ in range(2)]
    kw = dict(ENGINE_KW, num_scheduler_steps=1)
    jscales = jax_kv_calibrate.calibrate_kv_scales(
        JaxLLM(model=tiny_llama_dir, **kw), prompt_token_ids=prompts)
    llm = LLM(model=tiny_llama_dir, device="cpu", **kw)
    scales = kv_calibrate.calibrate_kv_scales(llm, prompt_token_ids=prompts)
    assert set(scales) == set(jscales) == {0, 1}
    obs = kv_calibrate.observe_kv_absmax(llm)
    amax = np.maximum(obs["k_amax"], obs["v_amax"])
    for layer, s in scales.items():
        assert s == pytest.approx(float(amax[layer]) / 448.0)
        assert s == pytest.approx(jscales[layer], abs=1e-6)
    path = str(tmp_path / "kv_scales.json")
    kv_calibrate.export_kv_params(scales, path)
    jpath = str(tmp_path / "jax_kv_scales.json")
    jax_kv_calibrate.export_kv_params(jscales, jpath)
    with open(path) as f, open(jpath) as jf:
        assert json.load(f).keys() == json.load(jf).keys()
    k_s, v_s = load_kv_cache_scales(tiny_llama_dir, 2, path)
    np.testing.assert_allclose(k_s, [scales[0], scales[1]], rtol=1e-6)
    np.testing.assert_array_equal(k_s, v_s)
    jk_s, _ = jax_load_kv_cache_scales(tiny_llama_dir, 2, jpath)
    np.testing.assert_allclose(k_s, jk_s, rtol=0, atol=1e-6)
    # int8 ranges divide by 127; a narrow cache cannot be calibrated.
    int8 = kv_calibrate.calibrate_kv_scales(llm, prompt_token_ids=prompts,
                                            fmt="int8")
    assert int8[0] == pytest.approx(float(amax[0]) / 127.0)
    narrow = LLM(model=tiny_llama_dir, device="cpu", kv_cache_dtype="int8",
                 quantization_param_path=path, **kw)
    with pytest.raises(ValueError, match="full-precision"):
        kv_calibrate.observe_kv_absmax(narrow)
