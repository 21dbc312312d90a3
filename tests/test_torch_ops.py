"""The PyTorch port's attention and cache ops against the JAX package.

The same numpy inputs (from a seeded generator) go through the JAX
function and its counterpart in aphrodite_tpu_torch. On the CPU the port's
wrappers take their plain PyTorch versions; the hand-written CUDA kernels
they launch on the card are held against those plain versions by the
tests in test_torch_cuda.py (skipped without a card) and by
chip_smoke.py.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops.attention import ref_ragged_paged_attention as jax_ref
from aphrodite_tpu.ops.decode_attention import \
    paged_decode_attention as jax_decode
from aphrodite_tpu.ops.kv_cache import write_kv as jax_write_kv
from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                               ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.decode_attention import (
    paged_decode_attention, ref_paged_decode_attention)
from aphrodite_tpu_torch.ops.kv_cache import write_kv
from tests.test_torch_cuda import PS, paged_batch as _batch

REPO = Path(__file__).resolve().parent.parent


# Ragged attention: f32, 4 query heads over 2 kv heads, head_dim 32.
# (q_len, kv_len) per live sequence; kv_len - q_len tokens are a cached
# prefix. Every case pads to 8 sequences (dead rows: kv_len 0) and to 4
# extra tokens.
RAGGED_CASES = {
    "mixed_prefill_decode": ([(1, 23), (9, 9), (1, 40), (6, 6)], {}),
    "chunked_prefix": ([(7, 40), (3, 19), (1, 5)], {}),
    "sliding_window": ([(1, 50), (12, 30), (5, 5)],
                       {"sliding_window": 7}),
    "soft_cap": ([(1, 23), (9, 9), (4, 33)], {"soft_cap": 2.0}),
}


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ref_ragged_matches_jax_reference(case):
    seqs, kw = RAGGED_CASES[case]
    rng = np.random.default_rng(0)
    tokens = sum(q for q, _ in seqs)
    q, kv, kv_lens, pages, cu = _batch(rng, seqs, 4, 2, 32, padded_seqs=8,
                                       padded_tokens=tokens + 4)
    ns = np.asarray([len(seqs)], np.int32)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kv),
                              jnp.asarray(kv_lens), jnp.asarray(pages),
                              jnp.asarray(cu), jnp.asarray(ns),
                              sm_scale=0.3, **kw))
    args = [torch.from_numpy(a) for a in (q, kv, kv_lens, pages, cu, ns)]
    got = ref_ragged_paged_attention(*args, sm_scale=0.3, **kw).numpy()
    # f32 both sides; only the summation order differs.
    np.testing.assert_allclose(got[:tokens], want[:tokens], rtol=1e-5,
                               atol=1e-5)
    # Padding tokens belong to no sequence: the port writes zeros there.
    assert not got[tokens:].any()
    # The dispatching wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(
        ragged_paged_attention(*args, sm_scale=0.3, **kw).numpy(), got)


def test_write_kv_matches_jax():
    rng = np.random.default_rng(1)
    num_pages, num_kv_heads, head_dim, T = 6, 2, 16, 11
    cache = rng.standard_normal((num_pages + 1, PS, 2 * num_kv_heads,
                                 head_dim)).astype(np.float32)
    k = rng.standard_normal((T, num_kv_heads, head_dim)).astype(np.float32)
    v = rng.standard_normal((T, num_kv_heads, head_dim)).astype(np.float32)
    slots = np.concatenate([
        rng.permutation(num_pages * PS)[:T - 3],
        num_pages * PS + np.arange(3) % PS,  # padding -> trash page
    ]).astype(np.int32)
    want = np.asarray(jax_write_kv(jnp.asarray(cache), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(slots)))
    got_t = torch.from_numpy(cache.copy())
    out = write_kv(got_t, torch.from_numpy(k), torch.from_numpy(v),
                   torch.from_numpy(slots))
    assert out.data_ptr() == got_t.data_ptr()  # written in place
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("feature", ["plain", "window_softcap"])
def test_ref_decode_matches_jax_kernel_interpret(feature):
    """bf16, head_dim 128, 8 sequences (one dead), page 16: the shapes the
    JAX decode kernel takes, run under the Pallas interpreter."""
    rng = np.random.default_rng(2)
    seqs = [(1, int(n)) for n in rng.integers(1, 64, size=7)]
    q, kv, kv_lens, pages, _ = _batch(rng, seqs, 8, 2, 128, padded_seqs=8,
                                      padded_tokens=8)
    kw = {"plain": {},
          "window_softcap": {"sliding_window": 30, "soft_cap": 5.0}}[feature]
    qb = jnp.asarray(q, jnp.bfloat16)
    kvb = jnp.asarray(kv, jnp.bfloat16)
    want = np.asarray(jax_decode(qb, kvb, jnp.asarray(kv_lens),
                                 jnp.asarray(pages),
                                 jnp.asarray([7], jnp.int32),
                                 sm_scale=0.125, interpret=True, **kw),
                      np.float32)
    qt = torch.from_numpy(np.asarray(qb, np.float32)).to(torch.bfloat16)
    kvt = torch.from_numpy(np.asarray(kvb, np.float32)).to(torch.bfloat16)
    got = ref_paged_decode_attention(
        qt, kvt, torch.from_numpy(kv_lens), torch.from_numpy(pages),
        sm_scale=0.125, **kw).float().numpy()
    # The TPU kernel rounds q * sm_scale and the probabilities to bf16;
    # the plain version keeps f32: 1% of the largest output.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    assert not got[7].any() and not want[7].any()  # dead row: zeros


def test_ref_ragged_matches_jax_pallas_fork_interpret(monkeypatch):
    """Against the vendored Pallas ragged kernel (no ALiBi) under the
    interpreter, at the single-heads-block shapes of
    tests/test_alibi_kernel.py."""
    import jax.experimental.pallas as pl

    import aphrodite_tpu.ops.rpa_alibi_kernel as K

    orig = pl.pallas_call

    def interpreted(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(K.pl, "pallas_call", interpreted)
    rng = np.random.default_rng(0)
    T, Hq, Hkv, D, S, pps = 24, 4, 2, 128, 3, 6
    q = (rng.standard_normal((T, Hq, D)) * 0.3).astype(np.float32)
    kv = (rng.standard_normal((S * pps + 2, PS, 2 * Hkv, D))
          * 0.3).astype(np.float32)
    kv_lens = np.asarray([10, 37, 8], np.int32)
    pages = np.arange(S * pps, dtype=np.int32).reshape(S, pps)
    cu = np.asarray([0, 1, 16, 24], np.int32)
    ns = np.asarray([S], np.int32)
    want = np.asarray(K.ragged_paged_attention_alibi(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv_lens),
        jnp.asarray(pages), jnp.asarray(cu), jnp.asarray(ns), None,
        sm_scale=0.25, num_kv_pages_per_block=2, num_queries_per_block=8))
    got = ref_ragged_paged_attention(
        *[torch.from_numpy(a) for a in (q, kv, kv_lens, pages, cu, ns)],
        sm_scale=0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_decode_route_and_counters_on_cpu():
    """cu_q_lens=None routes to decode attention; CPU tensors launch no
    kernel, so the launch counters do not move."""
    rng = np.random.default_rng(3)
    q, kv, kv_lens, pages, _ = _batch(rng, [(1, 9), (1, 30)], 4, 2, 32,
                                      padded_seqs=4, padded_tokens=4)
    args = [torch.from_numpy(a) for a in (q, kv, kv_lens, pages)]
    before = (ragged_paged_attention.launches,
              paged_decode_attention.launches)
    got = ragged_paged_attention(*args, None, torch.tensor([2]),
                                 sm_scale=0.2)
    want = ref_paged_decode_attention(*args, sm_scale=0.2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (ragged_paged_attention.launches,
            paged_decode_attention.launches) == before


@pytest.mark.parametrize("op", ["ragged", "decode"])
def test_wrappers_raise_off_cpu_without_kernel(op):
    """A tensor that lies neither on the CPU nor on a card is refused:
    the wrappers launch the kernel or raise, never fall back."""
    q = torch.empty((4, 4, 32), device="meta")
    kv = torch.empty((3, PS, 4, 32), device="meta")
    idx = torch.empty((4,), dtype=torch.int32, device="meta")
    pages = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if op == "ragged":
            ragged_paged_attention(q, kv, idx, pages,
                                   torch.empty((5,), dtype=torch.int32,
                                               device="meta"), idx)
        else:
            paged_decode_attention(q, kv, idx, pages)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(["paged_decode_attention"])


def test_library_names_follow_the_source():
    for name in cuda_build.KERNEL_SOURCES:
        assert (cuda_build.CSRC_DIR / f"{name}.cu").is_file()
        path = cuda_build.library_path(name)
        assert path.parent == cuda_build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((REPO / "aphrodite_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    covered = {str(path.relative_to(REPO)) for path in files}
    assert {"aphrodite_tpu_torch/ops/quant_matmul.py",
            "aphrodite_tpu_torch/ops/kv_cache.py",
            "aphrodite_tpu_torch/tools/__init__.py",
            "aphrodite_tpu_torch/tools/kv_calibrate.py",
            "aphrodite_tpu_torch/loader/gguf.py",
            "aphrodite_tpu_torch/models/gemma.py",
            "aphrodite_tpu_torch/models/phi3.py",
            "aphrodite_tpu_torch/models/mixtral.py",
            "aphrodite_tpu_torch/models/olmoe.py",
            "aphrodite_tpu_torch/models/phimoe.py",
            "aphrodite_tpu_torch/models/qwen2_moe.py",
            "aphrodite_tpu_torch/models/qwen3_moe.py",
            "aphrodite_tpu_torch/models/gpt_neox.py",
            "aphrodite_tpu_torch/models/phi.py",
            "aphrodite_tpu_torch/models/stablelm.py",
            "aphrodite_tpu_torch/models/persimmon.py",
            "aphrodite_tpu_torch/models/gptj.py",
            "aphrodite_tpu_torch/models/cohere.py",
            "aphrodite_tpu_torch/models/nemotron.py",
            "aphrodite_tpu_torch/models/glm.py",
            "aphrodite_tpu_torch/models/chatglm.py",
            "aphrodite_tpu_torch/ops/moe.py",
            "aphrodite_tpu_torch/quantization/experts_int8.py",
            "aphrodite_tpu_torch/quantization/__init__.py",
            "aphrodite_tpu_torch/quantization/int4.py",
            "aphrodite_tpu_torch/quantization/qlinear.py"} <= covered
    bad = []
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "aphrodite_tpu", "flax", "optax"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad
