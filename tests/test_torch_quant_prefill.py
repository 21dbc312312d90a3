"""The int4 kernels' prefill body (csrc/dequant_gemm.cuh), what of it the
CPU can hold: the wrappers' choice of body against the JAX package's own
choice (int4p_matmul_pallas and int4_matmul_dispatch, run here under the
Pallas interpreter) and arithmetic, the planner's tiles, stages, splits and
shared memory, and the refusals at the body's shape limits. The kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from aphrodite_tpu.ops import quant_matmul as jqm
from aphrodite_tpu.quantization import int4 as jint4
from aphrodite_tpu.quantization import int8 as jint8
from aphrodite_tpu.quantization import qlinear as jqlinear
from aphrodite_tpu_torch.ops import quant_matmul as tqm

SWITCH_T = (1, 63, 64, 65, 300)
SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may use
NUM_SMS = 132


def _row_err(got, want):
    """The worst row's max|got - want| over the row's max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


def _x(rng, T, K):
    """x at std 1 as bf16: numpy f32 of the bf16 values, the JAX array and
    the torch tensor."""
    x = torch.from_numpy(rng.standard_normal((T, K), dtype=np.float32)).to(
        torch.bfloat16)
    return x, jnp.asarray(x.float().numpy(), jnp.bfloat16)


def _recording(monkeypatch, module, names):
    """Replace module.<name> by a wrapper that records the name and calls
    the original; returns the record."""
    seen = []
    for name in names:
        original = getattr(module, name)

        def wrapper(*args, _name=name, _original=original, **kw):
            seen.append(_name)
            return _original(*args, **kw)

        monkeypatch.setattr(module, name, wrapper)
    return seen


# A dense (bf16-rounded weight) product and the exact f32-weight one differ
# by about 2^-9 of a row at these sizes; the JAX bodies' results lie within
# f32 order (1e-5 of a row) of the one they compute.
SAME = 1e-5
APART = 1e-4


@pytest.mark.parametrize("T", SWITCH_T)
def test_packed_body_follows_int4p_matmul_pallas(monkeypatch, T):
    """int4p_matmul_pallas picks its body by T (group-wise under 64 rows,
    dense from there): the body the JAX package runs, and its arithmetic,
    are those of the body the port's wrapper takes (``int4p_body``)."""
    rng = np.random.default_rng(T)
    K, N, G = 256, 128, 64
    c = jint4.quantize_from_float(rng.standard_normal((K, N)).astype(
        np.float32), group=G)
    x, xj = _x(rng, T, K)
    seen = _recording(monkeypatch, jqm, ("_kernel_packed_groupwise",
                                         "_kernel_packed_dense"))
    got = np.asarray(jqm.int4p_matmul_pallas(
        xj, *(jnp.asarray(c[k]) for k in ("q4p", "scale", "zero")), G,
        interpret=True))
    body = tqm.int4p_body(T)
    assert set(seen) == {f"_kernel_packed_{body}"}
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in c.items()}
    dense = tqm.int4p_matmul_ref(x, t["q4p"], t["scale"], t["zero"], G)
    exact = x.float() @ tqm.dequantize_int4(tqm.unpack_int4_rows(t["q4p"]),
                                            t["scale"], t["zero"], G)
    same, other = (dense, exact) if body == "dense" else (exact, dense)
    assert _row_err(got, same.numpy()) < SAME
    assert _row_err(got, other.numpy()) > APART
    # On the CPU the wrapper takes the plain version whatever the body.
    np.testing.assert_array_equal(
        tqm.int4p_matmul(x, t["q4p"], t["scale"], t["zero"], G).numpy(),
        dense.numpy())


class _TpuBackend:
    """The jax module as int4_matmul_dispatch sees it on a TPU host (its
    kernels then run under the Pallas interpreter)."""

    def default_backend(self):
        return "tpu"

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.mark.parametrize("T", SWITCH_T)
def test_unpacked_route_follows_int4_matmul_dispatch(monkeypatch, T):
    """int4_matmul_dispatch sends a product to int4_matmul_pallas (the
    dense body) from 64 rows on; the port's wrapper sends the dense body's
    calls to the prefill body from the same T (``int4_route``), and the
    JAX kernel's result there is the plain version's arithmetic."""
    rng = np.random.default_rng(100 + T)
    K, N, G = 256, 128, 16
    q = rng.integers(0, 64, size=(K, N)).astype(np.int8)
    scale = (rng.random((K // G, N), dtype=np.float32) * 0.02 + 0.001)
    zero = np.full((K // G, N), 32.0, np.float32)
    x, xj = _x(rng, T, K)
    monkeypatch.setattr(jqm, "jax", _TpuBackend())
    seen = _recording(monkeypatch, jqm, ("int4_matmul_pallas",
                                         "int4_matmul_pallas_groupwise"))
    with pltpu.force_tpu_interpret_mode():
        got = np.asarray(jqm.int4_matmul_dispatch(
            xj, jnp.asarray(q), jnp.asarray(scale), jnp.asarray(zero), G))
    takes_dense_kernel = seen == ["int4_matmul_pallas"]
    assert takes_dense_kernel == (tqm.int4_route(T) == "dense_wgmma")
    assert tqm.int4_route(T, "groupwise") == "groupwise"
    plain = tqm.int4_matmul_ref(x, *(torch.from_numpy(a) for a in
                                     (q, scale, zero)), G)
    if takes_dense_kernel:
        assert _row_err(got, plain.numpy()) < SAME


@pytest.mark.parametrize("T", SWITCH_T)
def test_int8_route_and_arithmetic_match_jax(T):
    """int8 per-channel weights: the group-wise body under 64 rows, the
    prefill body's per-column form from there; both sum exact products of
    raw levels in f32 and scale the sum, the JAX package's _int8_matmul."""
    rng = np.random.default_rng(200 + T)
    K, N = 256, 128
    c = jint8.quantize_from_float(rng.standard_normal((K, N)).astype(
        np.float32))
    x, xj = _x(rng, T, K)
    want = np.asarray(jqlinear._int8_matmul(
        xj, {k: jnp.asarray(v) for k, v in c.items()}))
    got = tqm.int8_matmul(x, *(torch.from_numpy(np.asarray(c[k]))
                               for k in ("q", "scale")))
    assert _row_err(got.numpy(), want) < SAME
    route = tqm.int4_route(T, "groupwise", per_column=True)
    assert route == ("per_column_wgmma" if T >= 64 else "groupwise")


SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "w13": (4096, 28672),
         "down": (14336, 4096)}
FORMATS = [("packed", 16), ("packed", 32), ("packed", 64), ("packed", 128),
           ("unpacked", 1), ("unpacked", 8), ("unpacked", 16),
           ("unpacked", 32), ("unpacked", 128), ("per_column", None)]


@pytest.mark.parametrize("block_t", [64, 128])
@pytest.mark.parametrize("fmt,group", FORMATS)
@pytest.mark.parametrize("site", sorted(SITES))
def test_plan_fits_every_instantiation(site, fmt, group, block_t):
    """Every instantiation the plan can launch (64 or 128 token rows a
    block) stays inside the block's shared memory with at least two
    stages, and its splits divide the k stages."""
    K, N = SITES[site]
    group = K if group is None else group
    for T in (64, 100, 257, 2048):
        plan = tqm.dequant_gemm_plan(T, K, N, group, fmt, block_t)
        assert plan["block_t"] == block_t
        assert 2 <= plan["stages"] <= 8
        assert plan["smem"] <= SMEM_LIMIT
        assert plan["k_stages"] % plan["splits"] == 0
        assert plan["k_stages"] == (K // 2 if fmt == "packed" else K) // 64


@pytest.mark.parametrize("fmt,K,group,rows", [
    ("packed", 1536, 48, 2),      # groups of 48 straddle 64-row stages
    ("packed", 4096, 16, 4), ("packed", 4096, 128, 1),
    ("unpacked", 4096, 16, 4), ("unpacked", 4608, 192, 1),
    ("unpacked", 4096, 8, 0),     # read from device memory, not staged
    ("per_column", 4096, 4096, 0)])
def test_plan_stages_the_scale_rows_a_stage_touches(fmt, K, group, rows):
    plan = tqm.dequant_gemm_plan(128, K, 256, group, fmt)
    assert plan["sz_rows"] == rows
    atoms = 2 if fmt == "packed" else 1
    assert plan["stage_bytes"] == (atoms * 128 * 128 + 2 * 64 * 128
                                   + 2 * atoms * rows * 256 * 4)
    assert plan["smem"] == plan["stages"] * plan["stage_bytes"] + 1024


@pytest.mark.parametrize("fmt,group", [("packed", 128), ("packed", 16),
                                       ("unpacked", 16)])
def test_plan_fills_the_card_at_few_tiles(fmt, group):
    """At T = 64 on N = 4096 (16 tiles of 256 columns by 64 tokens) K is
    split so that at least 90 % of the SMs get a block in one wave; a grid
    that fills the SMs (T = 2048 at w13) is not split; token rows per
    block follow T (64 up to 64, then 128)."""
    plan = tqm.dequant_gemm_plan(64, 4096, 4096, group, fmt)
    assert plan["block_t"] == 64 and plan["splits"] > 1
    assert 0.9 * NUM_SMS <= plan["blocks"] <= NUM_SMS
    plan = tqm.dequant_gemm_plan(2048, 4096, 28672, group, fmt)
    assert (plan["block_t"], plan["splits"], plan["blocks"]) == (128, 1,
                                                                 112 * 16)
    assert tqm.dequant_gemm_plan(65, 4096, 28672, group, fmt)[
        "block_t"] == 128


@pytest.mark.parametrize("fmt,K,N,group,match", [
    ("packed", 1056, 256, 16, "multiple of 32"),    # K/2 = 528
    ("packed", 1024, 192, 32, "multiple of 128"),   # N
    ("packed", 1024, 256, 8, "multiple of 16"),     # packed group
    ("packed", 1024, 256, 96, "divides K/2"),       # 512 % 96
    ("unpacked", 1056, 256, 32, "multiple of 64"),  # K
    ("unpacked", 1152, 256, 96, "either divides"),  # 64 % 96, 96 % 64
    ("per_column", 1024, 256, 512, "G = K"),
])
def test_plan_refuses_what_the_body_does_not_take(fmt, K, N, group, match):
    with pytest.raises(ValueError, match=match):
        tqm.dequant_gemm_plan(100, K, N, group, fmt)


def test_plan_refuses_bad_overrides_and_formats():
    with pytest.raises(ValueError, match="block_t"):
        tqm.dequant_gemm_plan(100, 1024, 256, 32, "packed", block_t=96)
    with pytest.raises(ValueError, match="splits"):
        tqm.dequant_gemm_plan(100, 1024, 256, 32, "packed", splits=3)
    with pytest.raises(ValueError, match="format"):
        tqm.dequant_gemm_plan(100, 1024, 256, 32, "nibbles")
    with pytest.raises(ValueError, match="body"):
        tqm.int4p_body(100, "wmma")
    with pytest.raises(ValueError, match="body"):
        tqm.int4_route(100, "wmma")


def _meta(*shapes_dtypes):
    return [torch.empty(shape, dtype=dtype, device="meta")
            for shape, dtype in shapes_dtypes]


@pytest.mark.parametrize("T,body", [(64, "dense_wgmma"), (300, "dense_wgmma"),
                                    (63, "groupwise")])
def test_packed_wrapper_takes_k_half_odd_multiples_of_32(monkeypatch, T,
                                                         body):
    """A packed container whose K/2 is an odd multiple of 32 (K 1088, K/2 =
    544, group 32): from 64 tokens on the wrapper launches the prefill body
    with a plan of nine stages, the last of 32 packed rows; under 64 the
    group-wise body. The launches are recorded in place of the card's (meta
    tensors, the device check monkeypatched away)."""
    monkeypatch.setattr(tqm, "_check_device", lambda name, x: None)
    launched = []

    def record(name):
        def launch(*args):
            launched.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(tqm, "_dense_kernel", lambda fmt: record(fmt))
    monkeypatch.setattr(tqm, "_kernel", lambda: record("groupwise"))
    monkeypatch.setattr(tqm.torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    x, q4p, scale, zero = _meta(((T, 1088), torch.bfloat16),
                                ((544, 256), torch.int8),
                                ((34, 256), torch.float32),
                                ((34, 256), torch.float32))
    before = dict(tqm.int4p_matmul.launches_by_body)
    out = tqm.int4p_matmul(x, q4p, scale, zero, 32)
    assert out.shape == (T, 256) and out.dtype == torch.float32
    assert [name for name, _ in launched] == [
        "packed" if body == "dense_wgmma" else "groupwise"]
    assert tqm.int4p_matmul.launches_by_body.get(body, 0) == \
        before.get(body, 0) + 1
    if body == "dense_wgmma":
        plan = tqm.int4p_matmul.last_plan
        assert plan["k_stages"] == 9 and 9 % plan["splits"] == 0
        assert launched[0][1][6:10] == (T, 1088, 256, 32)
