"""The host side of the two 8-bit products on the CPU, against the JAX
package where it has a counterpart: the FP8 W8A8 product's plan on the
prefill body's e4m3 form and its route by T (host values only), the
order of its scalings and its f16-widened activations, the W4A8 plain
product against ``int4p_matmul_w4a8_pallas(interpret=True)`` at groups
16, 32 and 128, and the prefill body's plan at a packed K/2 that is an odd
multiple of 32. The kernels are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops import quant_matmul as jqm
from aphrodite_tpu.quantization import fp8 as jfp8
from aphrodite_tpu.quantization import int4 as jint4
from aphrodite_tpu.quantization import qlinear as jqlinear
from aphrodite_tpu_torch.ops import quant_matmul as tqm
from aphrodite_tpu_torch.quantization import fp8

NUM_SMS = 132
SMEM = 232448
SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "w13": (4096, 28672),
         "down": (14336, 4096)}


# ----------------------------------------------------------------------
# Plans and routes
# ----------------------------------------------------------------------


@pytest.mark.parametrize("site", sorted(SITES))
@pytest.mark.parametrize("T", [1, 16, 32, 64, 65, 512, 2048])
def test_fp8_plan_fits_and_fills_the_card(site, T):
    """The FP8 product's plan on the prefill body (fmt "e4m3"): 64 k rows
    a stage, no scale rows staged, the shared memory within the limit with
    at least two stages, splits dividing the stages, 64 token rows up to
    64 tokens and 128 from there, a grid that fills the SMs unsplit and
    one of at most half as many tiles as SMs split."""
    K, N = SITES[site]
    plan = tqm.dequant_gemm_plan(T, K, N, 0, "e4m3")
    assert plan["block_t"] == (64 if T <= 64 else 128)
    assert plan["sz_rows"] == 0 and plan["k_stages"] == K // 64
    assert 2 <= plan["stages"] <= 8
    assert plan["smem"] == plan["stages"] * plan["stage_bytes"] + 1024
    assert plan["smem"] <= SMEM - 1024
    assert plan["stage_bytes"] == plan["block_t"] * 128 + 2 * 64 * 128
    assert plan["k_stages"] % plan["splits"] == 0
    tiles = -(-N // 256) * -(-T // plan["block_t"])
    assert plan["blocks"] == tiles * plan["splits"]
    if tiles >= NUM_SMS:
        assert plan["splits"] == 1
    elif 2 * tiles <= NUM_SMS:
        assert plan["splits"] > 1


@pytest.mark.parametrize("K,N,match", [(4096, 192, "multiple of 128"),
                                       (4128, 256, "multiple of 64")])
def test_fp8_plan_refuses_what_the_body_does_not_take(K, N, match):
    with pytest.raises(ValueError, match=match):
        tqm.dequant_gemm_plan(100, K, N, 0, "e4m3")


@pytest.mark.parametrize("T", [1, 15, 16, 31, 32, 64, 2048])
def test_fp8_route_follows_its_threshold(T):
    assert tqm.fp8_route(T) == ("f16_wgmma" if T >= tqm.FP8_WGMMA_MIN_T
                                else "e4m3_mma")
    for body in tqm.FP8_BODIES:
        assert tqm.fp8_route(T, body) == body
    with pytest.raises(ValueError, match="body"):
        tqm.fp8_route(T, "e4m3_wgmma")


@pytest.mark.parametrize("K,group", [(1088, 32), (1088, 16), (4160, 32),
                                     (2112, 96)])
@pytest.mark.parametrize("T", [64, 300])
def test_prefill_plan_takes_k_half_odd_multiples_of_32(K, group, T):
    """The prefill body plans packed shapes whose K/2 is an odd multiple of
    32 (it used to refuse them): ceil(K/2 / 64) stages, the last of 32
    rows, with splits dividing them and the scale rows of a stage staged."""
    plan = tqm.dequant_gemm_plan(T, K, 512, group, "packed")
    assert plan["k_stages"] == -(-K // 2 // 64) and (K // 2) % 64 == 32
    assert plan["k_stages"] % plan["splits"] == 0
    assert plan["sz_rows"] == max((r0 + 63) // group - r0 // group + 1
                                  for r0 in range(0, K // 2, 64))
    assert plan["smem"] <= SMEM - 1024


# ----------------------------------------------------------------------
# Arithmetic against the JAX package
# ----------------------------------------------------------------------


@pytest.mark.parametrize("layer", [None, 1])
def test_fp8_scalings_follow_jax_order(layer):
    """fp8_w8a8_matmul_ref (what the wgmma body fuses into its store: the
    f32 sum times act_scale, then times scale) against the JAX package's
    _fp8_w8a8_matmul on the same e4m3 weights, and the scaled result equal
    to (sum * act_scale) * scale from the plain sum, bit for bit."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((2, 512, 256)).astype(np.float32)
    jc = jfp8.quantize_from_float(w)
    c = fp8.quantize_from_float(torch.from_numpy(w))
    x = (rng.standard_normal((9, 512)) * np.exp(
        rng.uniform(-4, 3, (9, 1)))).astype(np.float32)
    l = 1 if layer is not None else 0
    want = np.asarray(jqlinear._fp8_w8a8_matmul(
        jnp.asarray(x), {k: v[l] for k, v in jc.items()}))
    got = tqm.fp8_w8a8_matmul(torch.from_numpy(x), c["q"] if layer else
                              c["q"][0], c["scale"] if layer else
                              c["scale"][0], layer_idx=layer).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    xq, act_scale = tqm.quantize_activations_e4m3(torch.from_numpy(x))
    sums = torch.matmul(xq.float(), c["q"][l].float())
    fused = (sums * act_scale) * c["scale"][l]
    assert torch.equal(torch.from_numpy(got), fused)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_e4m3_f16_activations_are_the_jax_e4m3_values(dtype):
    """quantize_activations(x, "e4m3_f16") on the CPU: the JAX package's
    e4m3 activations of _fp8_w8a8_matmul, each stored as f16 (exact: every
    e4m3 value is an f16 value), and the same act_scale."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((13, 512)) * np.exp(
        rng.uniform(-6, 4, (13, 1)))).astype(np.float32)
    x[0] = 0.0
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    absmax = jnp.max(jnp.abs(xj), axis=-1, keepdims=True)
    scale = jnp.maximum(absmax.astype(jnp.float32) / 448.0, 1e-12)
    want = np.asarray((xj / scale).astype(jnp.float8_e4m3fn)).astype(
        np.float32)
    xq, act_scale = tqm.quantize_activations(xt, "e4m3_f16")
    assert xq.dtype == torch.float16
    np.testing.assert_array_equal(xq.float().numpy(), want)
    np.testing.assert_array_equal(act_scale.numpy(), np.asarray(scale))


@pytest.mark.parametrize("group", [16, 32, 128])
def test_w4a8_plain_product_matches_pallas_interpret(group):
    """int4p_matmul_w4a8_ref against the TPU kernel int4p_matmul_w4a8_pallas
    in interpret mode (int8 group products and f32 fix-ups, the arithmetic
    the mma.sync kernel follows) and the JAX reference, at groups 16, 32
    and 128 with zeros outside 0..15: the JAX package's tolerance for its
    kernel against its reference (1e-5 of the largest output)."""
    rng = np.random.default_rng(group + 1)
    T, K, N = 24, 512, 256
    c = jint4.quantize_from_float(
        rng.standard_normal((K, N)).astype(np.float32), group=group)
    c["zero"] = c["zero"] + rng.integers(-4, 5, c["zero"].shape).astype(
        np.float32)
    x = (rng.standard_normal((T, K)) * 0.5).astype(np.float32)
    members = ("q4p", "scale", "zero")
    got = tqm.int4p_matmul_w4a8_ref(
        torch.from_numpy(x), *(torch.from_numpy(c[k]) for k in members),
        group).numpy()
    jc = [jnp.asarray(c[k]) for k in members]
    kernel = np.asarray(jqm.int4p_matmul_w4a8_pallas(
        jnp.asarray(x), *jc, group, block_kp=group, interpret=True))
    ref = np.asarray(jqm.int4p_matmul_w4a8_ref(jnp.asarray(x), *jc, group))
    for want in (kernel, ref):
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
