"""The int4 kernels' decode body (csrc/decode_gemm.cuh), what of it the CPU
can hold: its plan (token tiles, split of K, ring depth, shared memory,
grid against the card's SMs) at every T from 1 to 63 at the Llama-3.1-8B
sites and at K 1088, the constants the plan shares with the source, the
instantiations the entry points launch, the wrappers' choice of body
against the JAX package's rules, and the refusals at the body's shape
limits. The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops import quant_matmul as jqm
from aphrodite_tpu_torch.ops import quant_matmul as tqm

SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may use
STATIC_SMEM = 2 * 8 * 8  # the two rings of mbarriers
NUM_SMS = 132
CSRC = Path(tqm.__file__).resolve().parent.parent / "csrc"
SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "w13": (4096, 28672),
         "down": (14336, 4096), "k1088": (1088, 512)}
FORMS = [("packed", 16), ("packed", 32), ("packed", 128),
         ("groupwise", 16), ("groupwise", 32), ("groupwise", 128),
         ("dense", 16), ("dense", 32), ("dense", 128), ("dense", 1)]
DECODE_T = range(1, 64)


def _takes(fmt, group, K):
    """Whether the decode body takes this group at this K."""
    rows = K // 2 if fmt == "packed" else K
    return rows % group == 0


CASES = [(site, fmt, group) for site in SITES for fmt, group in FORMS
         if _takes(fmt, group, SITES[site][0])]


@pytest.mark.parametrize("site,fmt,group", CASES)
def test_decode_plan_at_every_decode_t(site, fmt, group):
    """For every T from 1 to 63: the least token tile that holds T (8, 16,
    32 or, unpacked, 64; packed, 32 and more blocks past it); splits that
    divide the k stages (none empty); a ring of two to eight stages, no
    deeper than the block's own k range, inside the block's shared memory;
    and a grid whose blocks of one token tile fit in one wave of the
    card's 132 SMs, the fraction of a wave stated."""
    K, N = SITES[site]
    rows = K // 2 if fmt == "packed" else K
    for T in DECODE_T:
        plan = tqm.decode_plan(T, K, N, group, fmt)
        tiles = ((8, 16, 32) if fmt == "packed" or group < 16
                 else (8, 16, 32, 64))
        t_tile = next(t for t in tiles if T <= t or t == tiles[-1])
        assert plan["t_tile"] == t_tile
        assert plan["t_tiles"] == -(-T // t_tile)
        assert plan["k_stages"] == -(-rows // 64)
        assert plan["k_stages"] % plan["splits"] == 0
        assert plan["splits"] <= min(16, plan["k_stages"])
        assert plan["strips"] == -(-N // 256)
        assert plan["blocks"] == (plan["t_tiles"] * plan["strips"]
                                  * plan["splits"])
        assert plan["blocks"] // plan["t_tiles"] <= NUM_SMS
        assert plan["waves"] == plan["blocks"] / NUM_SMS
        most = min(8, (SMEM_LIMIT - 2048) // plan["stage_bytes"])
        count = plan["k_stages"] // plan["splits"]
        assert plan["stages"] == min(most, max(2, count))
        assert plan["smem"] == plan["stages"] * plan["stage_bytes"] + 1024
        assert plan["smem"] + STATIC_SMEM <= SMEM_LIMIT


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "decode_gemm.cuh").read_text())
    return int(m.group(1))


def test_plan_shares_the_sources_constants():
    """The plan's stage sizes and limits are the source's: 256 columns a
    block in two 128-column boxes, 64-row stages, at most 8 of them, one
    consumer warp per 32 columns (two m16 tiles)."""
    assert _constant("COLS") == tqm._DQ_COLS == 256
    assert _constant("KS") == tqm._DG_K_STAGE == 64
    assert _constant("MAX_STAGES") == tqm._DG_MAX_STAGES == 8
    assert _constant("BOX_COLS") * 2 == _constant("COLS")
    assert _constant("WARP_COLS") == 32


@pytest.mark.parametrize("fmt,source,form", [
    ("packed", "int4p_matmul.cu", "PACKED"),
    ("groupwise", "int4_matmul.cu", "GROUPWISE"),
    ("dense", "int4_matmul.cu", "DENSE"),
    ("dense", "int4_matmul.cu", "DENSE_ROWS")])
def test_every_planned_instantiation_exists(fmt, source, form):
    """Each entry point launches its form, and launch_tile has a case for
    every token tile the plan can give (64 for the DENSE and GROUPWISE
    forms only)."""
    assert f"dqd::launch_tile<dqd::{form}>" in (CSRC / source).read_text()
    header = (CSRC / "decode_gemm.cuh").read_text()
    tiles = {int(t) for t in re.findall(
        r"case (\d+):\s*\n\s*(?:if constexpr \([^)]*\)\s*)?"
        r"return launch<", header)}
    assert tiles == set(tqm._DQ_TOKEN_TILES) == {8, 16, 32, 64}
    assert "if constexpr (FORM == DENSE || FORM == GROUPWISE)" in header
    group = 1 if form == "DENSE_ROWS" else 16
    for T in DECODE_T:
        t_tile = tqm.decode_plan(T, 4096, 4096, group, fmt)["t_tile"]
        assert t_tile in tiles
        assert t_tile < 64 or form in ("DENSE", "GROUPWISE")
    with pytest.raises(ValueError, match="t_tile"):
        tqm.decode_plan(40, 4096, 4096, 16, "packed", t_tile=64)
    with pytest.raises(ValueError, match="t_tile"):
        tqm.decode_plan(40, 4096, 4096, 1, "dense", t_tile=64)


def _c_params(source, name):
    """The parameter types of an extern "C" entry point, from its source."""
    text = (CSRC / source).read_text()
    m = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S)
    return [p.rsplit(" ", 1)[0].strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("lib,source,name", [
    ("packed", "int4p_matmul.cu", "int4p_matmul_decode"),
    ("unpacked", "int4_matmul.cu", "int4_matmul_decode")])
def test_wrapper_argtypes_follow_the_entry_points(lib, source, name):
    """ctypes passes what it is told: the wrapper's argument types must be
    the C entry point's, pointer for pointer and int for int, or the call
    reads its stream from an int."""
    want = [ctypes.c_int if p == "int" else ctypes.c_void_p
            for p in _c_params(source, name)]
    assert all(p == "int" or p.endswith("*") for p in _c_params(source, name))
    assert tqm.DECODE_ARGTYPES[lib] == want


@pytest.mark.parametrize("fmt,K,group,rows", [
    ("packed", 4096, 16, 4), ("packed", 4096, 128, 1),
    ("packed", 1536, 48, 2),      # groups of 48 straddle 64-row stages
    ("groupwise", 4096, 32, 2), ("groupwise", 4096, 4096, 1),
    ("dense", 4096, 16, 4), ("dense", 4096, 8, 0),  # from device memory
])
def test_plan_stages_the_scale_rows_a_stage_touches(fmt, K, group, rows):
    plan = tqm.decode_plan(16, K, 256, group, fmt)
    assert plan["sz_rows"] == rows
    atoms = 2 if fmt == "packed" else 1
    want = (atoms * 16 * 128 + 2 * 64 * 128 + 2 * atoms * rows * 256 * 4
            + (0 if fmt == "dense" else atoms * 16 * 4 * 4))
    assert plan["stage_bytes"] == -(-want // 1024) * 1024


def test_plan_splits_k_where_the_strips_are_few():
    """w13 (112 strips of 256 columns) is not split; wqkv, wo and down
    (24 and 16 strips) split K so that at least 70 % of the SMs hold a
    block; a given split, tile or depth is taken as given."""
    for T in (1, 16, 32):
        assert tqm.decode_plan(T, 4096, 28672, 128, "packed")["splits"] == 1
        for K, N in ((4096, 6144), (4096, 4096), (14336, 4096)):
            plan = tqm.decode_plan(T, K, N, 128, "packed")
            assert plan["splits"] > 1
            assert 0.7 * NUM_SMS <= plan["blocks"] <= NUM_SMS
    plan = tqm.decode_plan(20, 4096, 4096, 16, "dense", t_tile=8, splits=2,
                           stages=3)
    assert (plan["t_tile"], plan["t_tiles"], plan["splits"],
            plan["stages"]) == (8, 3, 2, 3)


@pytest.mark.parametrize("fmt,K,N,group,match", [
    ("packed", 1056, 256, 16, "multiple of 32"),     # K/2 = 528
    ("packed", 1024, 192, 32, "multiple of 128"),    # N
    ("packed", 1024, 256, 8, "multiple of 16"),      # packed group
    ("packed", 1024, 256, 96, "divides K/2"),        # 512 % 96
    ("dense", 1056, 256, 32, "multiple of 64"),      # K
    ("dense", 1152, 256, 96, "either divides"),      # 64 % 96, 96 % 64
    ("groupwise", 1024, 256, 8, "at least 16"),
])
def test_plan_refuses_what_the_body_does_not_take(fmt, K, N, group, match):
    with pytest.raises(ValueError, match=match):
        tqm.decode_plan(16, K, N, group, fmt)


def test_plan_refuses_bad_overrides_and_formats():
    with pytest.raises(ValueError, match="t_tile"):
        tqm.decode_plan(16, 1024, 256, 32, "packed", t_tile=64)
    with pytest.raises(ValueError, match="splits"):
        tqm.decode_plan(16, 1024, 256, 32, "packed", splits=3)
    with pytest.raises(ValueError, match="stages"):
        tqm.decode_plan(16, 1024, 256, 32, "packed", stages=1)
    with pytest.raises(ValueError, match="stages"):
        tqm.decode_plan(16, 4096, 256, 16, "packed", stages=9)
    with pytest.raises(ValueError, match="format"):
        tqm.decode_plan(16, 1024, 256, 32, "nibbles")


class _TpuBackend:
    """The jax module as the JAX package's dispatch sees it on a TPU
    host."""

    def default_backend(self):
        return "tpu"

    def __getattr__(self, name):
        import jax
        return getattr(jax, name)


class _RecordingPallas:
    """jax.experimental.pallas with pallas_call recording the kernel body
    it is given and returning zeros of the output's shape, so that the
    body int4p_matmul_pallas picks is seen without running it."""

    def __init__(self, seen):
        from jax.experimental import pallas
        self._pallas = pallas
        self._seen = seen

    def pallas_call(self, kernel, out_shape, **kw):
        self._seen.append(kernel.func.__name__)
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

    def __getattr__(self, name):
        return getattr(self._pallas, name)


@pytest.mark.parametrize("T", DECODE_T)
def test_decode_route_follows_the_jax_rules(monkeypatch, T):
    """Under 64 tokens int4p_matmul_pallas takes its group-wise body and
    int4_matmul_dispatch never its dense kernel (int4_matmul_pallas): the
    port's wrappers send the same T to the decode body, packed in the
    group-wise arithmetic, unpacked in the body named or INT4_BODY (never
    the prefill body), int8 per-channel to the group-wise form."""
    K, N, G = 256, 128, 32
    x = jnp.zeros((T, K), jnp.bfloat16)
    seen = []
    monkeypatch.setattr(jqm, "pl", _RecordingPallas(seen))
    jqm.int4p_matmul_pallas(x, jnp.zeros((K // 2, N), jnp.int8),
                            jnp.ones((K // G, N), jnp.float32),
                            jnp.zeros((K // G, N), jnp.float32), G)
    assert seen == ["_kernel_packed_groupwise"]
    assert tqm.int4p_body(T) == "groupwise"
    monkeypatch.setattr(jqm, "jax", _TpuBackend())
    called = []
    for name in ("int4_matmul_pallas", "int4_matmul_pallas_groupwise"):
        monkeypatch.setattr(jqm, name, lambda *a, _n=name, **kw: called.append(
            _n) or jnp.zeros((T, N), jnp.float32))
    jqm.int4_matmul_dispatch(x, jnp.zeros((K, N), jnp.int8),
                             jnp.ones((K // G, N), jnp.float32),
                             jnp.zeros((K // G, N), jnp.float32), G)
    assert "int4_matmul_pallas" not in called
    assert called == (["int4_matmul_pallas_groupwise"] if T >= 16 else [])
    assert tqm.int4_route(T) == tqm.INT4_BODY
    assert tqm.int4_route(T) in tqm.DECODE_FORMATS
    assert tqm.int4_route(T, "groupwise") == "groupwise"
    assert tqm.int4_route(T, "groupwise", per_column=True) == "groupwise"


def _meta(*shapes_dtypes):
    return [torch.empty(shape, dtype=dtype, device="meta")
            for shape, dtype in shapes_dtypes]


def _recording_launches(monkeypatch):
    """The wrappers' C entry points replaced by recorders (meta tensors,
    the device check monkeypatched away): returns the record of (entry,
    args)."""
    monkeypatch.setattr(tqm, "_check_device", lambda name, x: None)
    launched = []

    def record(name):
        def launch(*args):
            launched.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(tqm, "_decode_kernel",
                        lambda fmt: record(f"decode {fmt}"))
    monkeypatch.setattr(tqm, "_kernel", lambda: record("mma packed"))
    monkeypatch.setattr(tqm, "_int4_kernel", lambda: record("mma unpacked"))
    monkeypatch.setattr(tqm.torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    return launched


def _call(body, T, K, N, G, **kw):
    """One wrapper call on meta tensors: (wrapper, its output)."""
    rows = K // 2 if body == "packed" else K
    x, q, scale, zero = _meta(((T, K), torch.bfloat16), ((rows, N), torch.int8),
                              ((K // G, N), torch.float32),
                              ((K // G, N), torch.float32))
    if body == "packed":
        return tqm.int4p_matmul, tqm.int4p_matmul(x, q, scale, zero, G, **kw)
    return tqm.int4_matmul, tqm.int4_matmul(x, q, scale, zero, G, body=body,
                                            **kw)


@pytest.mark.parametrize("T", [1, 16, 48, 63])
@pytest.mark.parametrize("body", ["packed", "groupwise", "dense"])
def test_wrappers_launch_the_decode_body_with_its_plan(monkeypatch, T,
                                                      body):
    """Named (decode=True), each wrapper makes one decode-body launch with
    the plan's token tile, stages and splits (and, unpacked, the body's
    number) and counts it under the body's "_decode" key; the launch is
    recorded in place of the card's."""
    launched = _recording_launches(monkeypatch)
    K, N, G = 4096, 4096, 32
    key = "groupwise_decode" if body == "packed" else f"{body}_decode"
    wrapper = tqm.int4p_matmul if body == "packed" else tqm.int4_matmul
    before = dict(wrapper.launches_by_body)
    wrapper, out = _call(body, T, K, N, G, decode=True)
    assert out.shape == (T, N) and out.dtype == torch.float32
    plan = tqm.decode_plan(T, K, N, G, body)
    assert wrapper.last_plan == plan
    ((name, args),) = launched
    assert name == f"decode {body}"
    assert args[7:15] == (T, K, N, G, K, plan["t_tile"], plan["stages"],
                          plan["splits"])
    if body != "packed":
        assert args[15] == tqm.INT4_BODIES[body]
    assert wrapper.launches_by_body[key] == before.get(key, 0) + 1


ROUTE_SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
               "w13": (4096, 28672), "down": (14336, 4096)}


@pytest.mark.parametrize("site", sorted(ROUTE_SITES))
@pytest.mark.parametrize("fmt,group", [("packed", 128), ("packed", 16),
                                       ("groupwise", 32), ("groupwise", None),
                                       ("dense", 16), ("dense", 1)])
def test_decode_route_by_shape(monkeypatch, site, fmt, group):
    """decode_route, the card's measured rule: the decode body from a
    weight of 2^25 values (w13 and down), not at packed groups that are
    multiples of 32 at 9-16 tokens nor unpacked group-wise past 32 tokens,
    never from 64 tokens; and each wrapper launches the implementation it
    names, under its key."""
    K, N = ROUTE_SITES[site]
    group = K if group is None else group  # int8 weight-only: G = K
    launched = _recording_launches(monkeypatch)
    for T in DECODE_T:
        want = ("decode" if K * N >= 2**25
                and not (fmt == "packed" and group % 32 == 0 and 9 <= T <= 16)
                and not (fmt == "groupwise" and T > 32) else "mma")
        assert tqm.decode_route(T, K, N, group, fmt) == want
        launched.clear()
        _call(fmt, T, K, N, group)
        ((name, _),) = launched
        kind = "packed" if fmt == "packed" else "unpacked"
        assert name == (f"decode {fmt}" if want == "decode"
                        else f"mma {kind}")
    for T in (64, 300):
        assert tqm.decode_route(T, K, N, group, fmt) == "mma"
    with pytest.raises(ValueError, match="format"):
        tqm.decode_route(16, K, N, group, "levels")
