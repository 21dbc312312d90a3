"""Matmul on group-quantized integer weights (GPTQ/AWQ int4, GGUF
levels), counterpart of aphrodite_tpu/ops/quant_matmul.py.

Weights are integer levels with per-group f32 scale and zero along K:

    w[k, n] = (q[k, n] - zero[k // G, n]) * scale[k // G, n]

stored either unpacked (``q4`` int8 [.., K, N], one level per byte: a
nibble, or any int8 level of a GGUF Q5/Q6/Q8/IQ tensor) or, for levels in
0..15, packed two to a byte in
the half-split layout (``q4p`` int8 [.., K/2, N]): packed row i holds
original row i in its low nibble and row i + K/2 in its high nibble, which
needs (K/2) % G == 0.

- ``pack_int4_rows`` / ``unpack_int4_rows``: the layout, for numpy arrays
  and torch tensors.
- ``int4_matmul_ref`` / ``int4p_matmul_ref``: the plain PyTorch versions.
  The CPU path, and what the CUDA kernel is held against.
- ``int4_matmul``: the dispatching wrapper of the unpacked form (``q4``:
  act-order GPTQ with per-row scales, GGUF full-byte levels). CPU tensors
  take the plain version; CUDA tensors launch the hand-written Hopper
  kernel ``csrc/int4_matmul.cu`` (which replaces the TPU kernels
  int4_matmul_pallas, int4_matmul_pallas_groupwise and
  int4_matmul_pallas_stacked) or raise. It has the TPU's two bodies: the
  dense one rounds the dequantized weight to bf16 as the plain version
  does, the group-wise one works as described below for the packed
  kernel. From ``DENSE_MIN_T`` tokens on, the dense body's calls go to the
  prefill body (below).
- ``int4p_matmul``: the dispatching wrapper of the packed form. CPU
  tensors take the plain version; CUDA tensors launch the kernel
  ``csrc/int4p_matmul.cu`` (which replaces the TPU kernel
  aphrodite_tpu/ops/quant_matmul.py: int4p_matmul_pallas) or raise. As
  the TPU kernel it takes a group-wise body under ``DENSE_MIN_T`` tokens
  and a dense one from there (``int4p_body``). The group-wise body is
  bound by weight bytes at decode sizes: raw nibbles go to the tensor
  cores and scale and zero are applied to f32 partial sums, so it agrees
  with the exact f32-weight product to the order of the sums, and with the
  plain version to the bf16 rounding of the weight (2^-9 relative per
  term). The dense body is the prefill body.
- The prefill body (``csrc/dequant_gemm.cuh``, ``dequant_gemm_plan``),
  shared by both kernels: a wgmma product fed by TMA, the weight
  dequantized in f32 and rounded to bf16 as the plain version does, so it
  agrees with the plain version to the order of the f32 sums. It is bound
  by tensor-core operations; the source says what it does about that.
- The decode body (``csrc/decode_gemm.cuh``, ``decode_plan``): a second
  implementation of both kernels' group-wise and dense bodies, with their
  arithmetic: one block an SM streams 256 weight columns of a k range
  through a TMA ring, tokens as the n dimension of the tensor-core
  product. ``decode_route`` picks it or the mma.sync kernel by shape, from
  the card's times (PERF.md). It is bound by the weight's bytes; the
  source says what it does about that.
- ``int4p_matmul_w4a8``: the same packed container times per-token int8
  activations (``quantize_activations_int8``); the plain version is
  ``int4p_matmul_w4a8_ref``. CUDA tensors launch the activation quantizer
  and the W4A8 kernel of ``csrc/int4p_matmul_w4a8.cu`` (which replaces
  the TPU kernel int4p_matmul_w4a8_pallas) or raise.
- ``int8_matmul``: int8 per-channel weight-only, ``{q, scale}``. On the
  card it is the unpacked container at G = K with zero 0: the group-wise
  body of ``csrc/int4_matmul.cu`` under ``DENSE_MIN_T`` tokens, the
  prefill body's per-column form from there.
- ``fp8_w8a8_matmul``: e4m3 weights times per-token e4m3 activations. On
  the card the quantizer kernel, then (``fp8_route``) from
  ``FP8_WGMMA_MIN_T`` tokens on the e4m3 form of the prefill body (f16
  wgmma, the activations widened to f16 by the quantizer, each weight pair
  by one cvt), under it the e4m3 body of ``csrc/int4_matmul.cu``
  (mma.sync, both operands widened to f16 in registers): f32 sums, as the
  JAX package's XLA product sums them (it leaves this product outside any
  Pallas kernel).
- ``quantize_activations``: the per-token quantizer of the activation
  formats (int8, e4m3, and e4m3 values stored as f16), one kernel launch
  on the card, bit-equal to its plain versions
  ``quantize_activations_int8`` and ``quantize_activations_e4m3``.
"""

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.launches import count_launch

# What the CUDA kernels take (see csrc/int4p_matmul.cu, csrc/int4_matmul.cu).
KERNEL_N_MULTIPLE = 128
# Packed groups: both packed kernels (W4A16 and W4A8) fold a group after
# any 16-row mma step (GGUF Q2_K and Q3_K pack at 16).
KERNEL_GROUP_MULTIPLE = 16
_KERNEL_K_TILE = 32  # packed rows per k tile
_NUM_SMS = 132  # H100 SXM
_HBM_BYTES_PER_US = 3.35e6  # H100 SXM
# The unpacked kernel: k rows per tile, and its two bodies by the number
# the C entry point takes.
INT4_K_MULTIPLE = 64
INT4_BODIES = {"groupwise": 0, "dense": 1}
INT4_GROUPWISE_MIN_GROUP = 16  # one m16n8k16 step
# The prefill body (csrc/dequant_gemm.cuh). Both wrappers send a product of
# DENSE_MIN_T tokens or more to it, the threshold at which the JAX package's
# int4p_matmul_pallas and int4_matmul_dispatch take their dense bodies.
DENSE_MIN_T = 64
# "e4m3": the FP8 W8A8 product's form (an e4m3 weight, f16 x, no scale
# rows staged).
DENSE_FORMATS = ("packed", "unpacked", "per_column", "e4m3")
_DG_COLS = 256  # weight columns per block
_DG_K_STAGE = 64  # raw weight rows (levels, or packed bytes) per stage
_DG_TOKEN_ROWS = (64, 128)  # token rows per block, the instantiations
_DG_SMEM = 232448 - 1024  # dynamic shared memory a launch may ask for
_DG_MAX_STAGES = 8
_DG_MAX_SPLITS = 16
# The decode body (csrc/decode_gemm.cuh): its forms by what the wrapper
# names them, the token rows per block of its instantiations, and the
# weight columns a block streams (its raw rows come in stages of
# _DG_K_STAGE, as the prefill body's).
DECODE_FORMATS = ("packed", "groupwise", "dense")
# 64: the unpacked forms with staged scale rows only
_DQ_TOKEN_TILES = (8, 16, 32, 64)
_DQ_COLS = 256


def pack_int4_rows(q4):
    """int8[.., K, N] values 0..15 -> packed int8[.., K/2, N] (numpy array
    or torch tensor; half-split layout)."""
    K = q4.shape[-2]
    if K % 2:
        raise ValueError(f"cannot pack an odd number of rows ({K})")
    lo, hi = q4[..., :K // 2, :], q4[..., K // 2:, :]
    if isinstance(q4, np.ndarray):
        return (lo.astype(np.uint8) | (hi.astype(np.uint8) << 4)).astype(
            np.int8)
    return (lo.to(torch.uint8) | (hi.to(torch.uint8) << 4)).view(torch.int8)


def unpack_int4_rows(q4p):
    """Inverse of pack_int4_rows. The packed bytes are int8, so the high
    nibble is taken from an unsigned view (>> on int8 is arithmetic)."""
    if isinstance(q4p, np.ndarray):
        p = q4p.astype(np.uint8)
        return np.concatenate([(p & 0xF).astype(np.int8),
                               (p >> 4).astype(np.int8)], axis=-2)
    p = q4p.view(torch.uint8)
    return torch.cat([(p & 0xF).view(torch.int8),
                      (p >> 4).view(torch.int8)], dim=-2)


def dequantize_int4(q4: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, group: int) -> torch.Tensor:
    """f32 weights (q - zero) * scale of an unpacked container."""
    K = q4.shape[-2]
    s = scale.repeat_interleave(group, dim=-2)[..., :K, :]
    z = zero.repeat_interleave(group, dim=-2)[..., :K, :]
    return (q4.float() - z) * s


def int4_matmul_ref(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, group: int) -> torch.Tensor:
    """x[T, K] @ dequant(q4[K, N]) -> f32 [T, N]. The weight is dequantized
    in f32 and rounded to x's dtype; the product accumulates in f32."""
    w = dequantize_int4(q4, scale, zero, group).to(x.dtype)
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    # No mixed-dtype mm on the CPU; a product of two bf16 values is exact
    # in f32, so upcasting both operands gives the same sums.
    return torch.matmul(x.float(), w.float())


def int4p_matmul_ref(x: torch.Tensor, q4p: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor, group: int) -> torch.Tensor:
    return int4_matmul_ref(x, unpack_int4_rows(q4p), scale, zero, group)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_build.load("int4p_matmul").int4p_matmul_bf16
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# The decode body's C entry points (int4p_matmul_decode, int4_matmul_decode):
# x, q, scale, zero, out, partial and the step sums' buffer; T, K, N,
# group, x_stride, t_tile, stages, splits (and, unpacked, the body); the
# stream.
DECODE_ARGTYPES = {
    fmt: [ctypes.c_void_p] * 7 + [ctypes.c_int] * (8 if fmt == "packed"
                                                    else 9)
    + [ctypes.c_void_p] for fmt in ("packed", "unpacked")}


@functools.lru_cache(maxsize=None)
def _decode_kernel(fmt: str):
    """The decode body's entry point in the library of its format."""
    lib = "packed" if fmt == "packed" else "unpacked"
    fn = (cuda_build.load("int4p_matmul").int4p_matmul_decode
          if lib == "packed"
          else cuda_build.load("int4_matmul").int4_matmul_decode)
    fn.argtypes = DECODE_ARGTYPES[lib]
    fn.restype = ctypes.c_int
    return fn


def kernel_plan(T: int, K: int, N: int,
                block_m: Optional[int] = None) -> Tuple[int, int]:
    """(block_m, splits) the wrapper launches with: the rows of x per
    block (16 up to T = 16, else 32, unless given; a larger T takes more
    row blocks), and how many blocks share the k range of one output tile
    so that a launch has about two blocks per SM."""
    if block_m is None:
        block_m = 16 if T <= 16 else 32
    blocks = (N // KERNEL_N_MULTIPLE) * -(-T // block_m)
    k_tiles = K // 2 // _KERNEL_K_TILE
    splits = max(1, min(2 * _NUM_SMS // blocks, k_tiles // 4, 16))
    per_split = -(-k_tiles // splits)
    return block_m, -(-k_tiles // per_split)


def _group_rows_per_stage(rows: int, group: int) -> int:
    """Rows of the scale table that one stage's raw rows touch, at most."""
    return max((r0 + _DG_K_STAGE - 1) // group - r0 // group + 1
               for r0 in range(0, rows, _DG_K_STAGE))


def dequant_gemm_plan(T: int, K: int, N: int, group: int, fmt: str,
                      block_t: Optional[int] = None,
                      splits: Optional[int] = None) -> dict:
    """How the prefill body runs a product, or ValueError for a shape it
    does not take. ``fmt``: "packed" (q4p [K/2, N]), "unpacked" (q4 [K, N]),
    "per_column" (int8 per-channel, G = K) or "e4m3" (FP8 W8A8, an e4m3
    weight [K, N]; ``group`` is not read). Keys: ``block_t`` (token
    rows per block: 64 up to T = 64, else 128, unless given), ``stages``
    (the ring's depth: as many as fit the shared memory, up to 8),
    ``splits`` (blocks that share one output tile's k range: 1 where the
    tiles fill the card's SMs, else the divisor of the k stages with the
    least estimated time, the partial sums' pass included),
    ``smem`` (dynamic shared memory bytes), ``stage_bytes``, ``sz_rows``
    (scale rows staged per stage and half), ``k_stages``, ``blocks`` (of
    the whole grid). ``block_t`` and ``splits`` may be given (timing
    sweeps). Host values only, so a launch can go into a CUDA graph."""
    if fmt not in DENSE_FORMATS:
        raise ValueError(f"prefill body format must be one of "
                         f"{DENSE_FORMATS}, got {fmt!r}")
    rows = K // 2 if fmt == "packed" else K
    # Packed stages may end in a 32-row tail (the last stage of a K/2 that
    # is an odd multiple of 32 takes its first two k16 steps only).
    row_multiple = _KERNEL_K_TILE if fmt == "packed" else _DG_K_STAGE
    if T < 1 or N % KERNEL_N_MULTIPLE or rows % row_multiple or (
            fmt == "packed" and K % 2):
        raise ValueError(
            f"the prefill body takes N that is a multiple of "
            f"{KERNEL_N_MULTIPLE} and "
            f"{'K/2' if fmt == 'packed' else 'K'} a multiple of "
            f"{row_multiple}; got T {T}, K {K}, N {N}")
    if fmt == "packed" and (group % KERNEL_GROUP_MULTIPLE or rows % group):
        raise ValueError(f"the prefill body takes a packed group that is a "
                         f"multiple of {KERNEL_GROUP_MULTIPLE} and divides "
                         f"K/2; got group {group}, K {K}")
    if fmt == "unpacked" and (group < 1 or K % group or (
            _DG_K_STAGE % group and group % _DG_K_STAGE)):
        raise ValueError(f"the prefill body takes an unpacked group that "
                         f"divides K and either divides {_DG_K_STAGE} or is "
                         f"a multiple of it; got group {group}, K {K}")
    if fmt == "e4m3":
        group = K
    if fmt == "per_column" and group != K:
        raise ValueError(f"the per-column form takes G = K, got group "
                         f"{group}, K {K}")
    if block_t is None:
        block_t = _DG_TOKEN_ROWS[0] if T <= _DG_TOKEN_ROWS[0] else \
            _DG_TOKEN_ROWS[1]
    if block_t not in _DG_TOKEN_ROWS:
        raise ValueError(f"block_t must be one of {_DG_TOKEN_ROWS}, got "
                         f"{block_t}")
    atoms = 2 if fmt == "packed" else 1
    staged = fmt == "packed" or (fmt == "unpacked"
                                 and group >= INT4_GROUPWISE_MIN_GROUP)
    sz_rows = _group_rows_per_stage(rows, group) if staged else 0
    stage_bytes = (atoms * block_t * 128 + 2 * _DG_K_STAGE * 128
                   + 2 * atoms * sz_rows * _DG_COLS * 4)
    stages = min(_DG_MAX_STAGES, (_DG_SMEM - 1024) // stage_bytes)
    k_stages = -(-rows // _DG_K_STAGE)
    tiles = -(-N // _DG_COLS) * -(-T // block_t)


    def cost_us(d):
        # Waves of blocks times a block's stages (and two for its prologue
        # and epilogue), at about a microsecond a stage on an H100, plus
        # the pass that reads the d partial sums and writes the output.
        waves = -(-tiles * d // _NUM_SMS)
        reduce = (d + 1) * T * N * 4 / 3.35e6 if d > 1 else 0.0
        return waves * (k_stages // d + 2) + reduce

    if splits is not None:
        if splits < 1 or k_stages % splits:
            raise ValueError(f"splits must divide the {k_stages} k stages, "
                             f"got {splits}")
    elif tiles >= _NUM_SMS:  # a grid that fills the SMs is not split
        splits = 1
    else:
        splits = min(
            (d for d in range(1, min(_DG_MAX_SPLITS, k_stages) + 1)
             if k_stages % d == 0), key=lambda d: (cost_us(d), d))
    return dict(block_t=block_t, stages=stages, splits=splits,
                smem=stages * stage_bytes + 1024, stage_bytes=stage_bytes,
                sz_rows=sz_rows, k_stages=k_stages, blocks=tiles * splits)


def _decode_stage_bytes(t_tile: int, fmt: str, sz_rows: int) -> int:
    """Shared memory of one stage of the decode body (decode_gemm.cuh's
    stage_bytes): x boxes, two 128-column weight boxes of 64 rows, scale
    and zero rows, the step sums of x; rounded up to 1024 bytes."""
    atoms = 2 if fmt == "packed" else 1
    nbytes = (atoms * t_tile * 128 + 2 * _DG_K_STAGE * 128
              + 2 * atoms * sz_rows * _DQ_COLS * 4
              + (atoms * 4 * t_tile * 4 if fmt != "dense" else 0))
    return -(-nbytes // 1024) * 1024


def decode_plan(T: int, K: int, N: int, group: int, fmt: str,
                t_tile: Optional[int] = None,
                splits: Optional[int] = None,
                stages: Optional[int] = None) -> dict:
    """How the decode body runs a product, or ValueError for a shape it
    does not take. ``fmt``: "packed" (q4p [K/2, N], group-wise
    arithmetic), "groupwise" or "dense" (q4 [K, N]; "dense" with G < 16
    reads each row's scale and zero from device memory). Keys:
    ``t_tile`` (token rows per block: 8, 16, 32 or, unpacked with G >= 16,
    64, the least that holds T unless given), ``t_tiles`` (blocks along
    the tokens), ``strips`` (of 256 weight columns), ``splits`` (blocks that share one strip's k range:
    the divisor of the k stages, up to 16, that keeps a token tile's
    blocks within one wave of the card's SMs, with the least estimated
    time, the pass that sums the partials included), ``stages`` (the ring's
    depth: as many as fit the shared memory, up to 8, and no more than the
    block's own stages), ``stage_bytes``, ``smem`` (dynamic shared memory
    bytes),
    ``sz_rows`` (scale rows staged per stage and half), ``k_stages``,
    ``blocks`` (of the whole grid) and ``waves`` (blocks over the card's
    SMs: a fraction where the strips are fewer than the SMs and no split
    pays). ``t_tile``, ``splits`` and ``stages`` may be given (timing
    sweeps). Host values only, so a launch can go into a CUDA graph."""
    if fmt not in DECODE_FORMATS:
        raise ValueError(f"decode body format must be one of "
                         f"{DECODE_FORMATS}, got {fmt!r}")
    packed = fmt == "packed"
    rows = K // 2 if packed else K
    row_multiple = _KERNEL_K_TILE if packed else INT4_K_MULTIPLE
    if T < 1 or N % KERNEL_N_MULTIPLE or rows % row_multiple or (
            packed and K % 2):
        raise ValueError(
            f"the decode body takes N that is a multiple of "
            f"{KERNEL_N_MULTIPLE} and {'K/2' if packed else 'K'} a multiple "
            f"of {row_multiple}; got T {T}, K {K}, N {N}")
    if packed and (group % KERNEL_GROUP_MULTIPLE or rows % group):
        raise ValueError(f"the decode body takes a packed group that is a "
                         f"multiple of {KERNEL_GROUP_MULTIPLE} and divides "
                         f"K/2; got group {group}, K {K}")
    if not packed and (group < 1 or K % group or (
            INT4_K_MULTIPLE % group and group % INT4_K_MULTIPLE)):
        raise ValueError(f"the decode body takes an unpacked group that "
                         f"divides K and either divides {INT4_K_MULTIPLE} or "
                         f"is a multiple of it; got group {group}, K {K}")
    if fmt == "groupwise" and group < INT4_GROUPWISE_MIN_GROUP:
        raise ValueError(f"the group-wise form takes groups of at least "
                         f"{INT4_GROUPWISE_MIN_GROUP} rows, got {group}")
    row_scales = fmt == "dense" and group < INT4_GROUPWISE_MIN_GROUP
    token_tiles = (_DQ_TOKEN_TILES[:-1] if packed or row_scales
                   else _DQ_TOKEN_TILES)
    if t_tile is None:
        t_tile = next((t for t in token_tiles if T <= t), token_tiles[-1])
    if t_tile not in token_tiles:
        raise ValueError(f"t_tile must be one of {token_tiles} for the "
                         f"{fmt} form, got {t_tile}")
    sz_rows = 0 if row_scales else _group_rows_per_stage(rows, group)
    stage_bytes = _decode_stage_bytes(t_tile, fmt, sz_rows)
    most = min(_DG_MAX_STAGES, (_DG_SMEM - 1024) // stage_bytes)
    if stages is not None and not 2 <= stages <= most:
        raise ValueError(f"stages must lie in 2..{most}, got {stages}")
    k_stages = -(-rows // _DG_K_STAGE)
    t_tiles = -(-T // t_tile)
    strips = -(-N // _DQ_COLS)
    tiles = t_tiles * strips
    # A stage's bytes at an even share of the card's memory rate (all SMs
    # streaming), in microseconds.
    stage_us = stage_bytes * _NUM_SMS / _HBM_BYTES_PER_US

    def cost_us(d):
        # Waves of blocks (one an SM) times a block's stages and two more
        # for its prologue and epilogue, plus the pass that reads the d
        # partial sums and writes the output, and its launch.
        waves = -(-tiles * d // _NUM_SMS)
        reduce = ((d + 1) * T * N * 4 / _HBM_BYTES_PER_US + 2.0
                  if d > 1 else 0.0)
        return waves * (k_stages // d + 2) * stage_us + reduce

    if splits is not None:
        if splits < 1 or k_stages % splits:
            raise ValueError(f"splits must divide the {k_stages} k stages, "
                             f"got {splits}")
    else:
        # The blocks of one token tile stay within one wave.
        splits = min(
            (d for d in range(1, min(_DG_MAX_SPLITS, k_stages) + 1)
             if k_stages % d == 0 and (d == 1 or strips * d <= _NUM_SMS)),
            key=lambda d: (cost_us(d), d))
    if stages is None:
        # No deeper than the block's own stages, so that a short k range
        # leaves room for a second block on the SM.
        stages = min(most, max(2, k_stages // splits))
    blocks = tiles * splits
    return dict(t_tile=t_tile, t_tiles=t_tiles, strips=strips, splits=splits,
                stages=stages, stage_bytes=stage_bytes,
                smem=stages * stage_bytes + 1024, sz_rows=sz_rows,
                k_stages=k_stages, blocks=blocks, waves=blocks / _NUM_SMS)


def int4p_body(T: int, body: Optional[str] = None) -> str:
    """The body ``int4p_matmul`` launches: the one named, else the JAX
    package's int4p_matmul_pallas rule (group-wise under DENSE_MIN_T
    tokens, dense from there)."""
    if body is None:
        return "groupwise" if T < DENSE_MIN_T else "dense"
    if body not in INT4_BODIES:
        raise ValueError(f"int4p_matmul body must be one of "
                         f"{sorted(INT4_BODIES)}, got {body!r}")
    return body


def int4_route(T: int, body: Optional[str] = None,
               per_column: bool = False) -> str:
    """Where an ``int4_matmul`` call goes, by its key in
    ``launches_by_body``: "groupwise" or "dense" (the bodies of
    csrc/int4_matmul.cu), "dense_wgmma" (the prefill body) or
    "per_column_wgmma" (its int8 per-column form). ``body`` defaults to
    INT4_BODY; from DENSE_MIN_T tokens on the dense body's calls, and
    int8 per-column ones, take the prefill body."""
    if body is None:
        body = INT4_BODY
    if body not in INT4_BODIES:
        raise ValueError(f"int4_matmul body must be one of "
                         f"{sorted(INT4_BODIES)}, got {body!r}")
    if T < DENSE_MIN_T:
        return body
    if per_column:
        return "per_column_wgmma"
    return "dense_wgmma" if body == "dense" else body


# The least weight (K * N) that the decode body runs: under it, the
# mma.sync kernels were faster on an H100 (PERF.md §6).
_DECODE_MIN_WEIGHTS = 2**25


def decode_route(T: int, K: int, N: int, group: int, fmt: str) -> str:
    """Which implementation runs a group-wise or dense body (``fmt``:
    "packed", "groupwise" or "dense") under DENSE_MIN_T tokens: "decode"
    (csrc/decode_gemm.cuh) or "mma" (the mma.sync kernel of
    csrc/int4p_matmul.cu or csrc/int4_matmul.cu, the same arithmetic). From
    the card's times, in turns with the mma.sync kernel's build (PERF.md
    §6): the decode body is faster where the weight is large (K * N of at
    least 2^25: Llama-3.1-8B's w13 and down), except for packed groups that
    are multiples of 32 at 9 to 16 tokens and unpacked group-wise products
    past 32 tokens. Host values only, so a launch can go into a CUDA
    graph."""
    if fmt not in DECODE_FORMATS:
        raise ValueError(f"decode body format must be one of "
                         f"{DECODE_FORMATS}, got {fmt!r}")
    if T >= DENSE_MIN_T or K * N < _DECODE_MIN_WEIGHTS:
        return "mma"
    if fmt == "packed" and group % 32 == 0 and 9 <= T <= 16:
        return "mma"
    if fmt == "groupwise" and T > 32:
        return "mma"
    return "decode"


def _check_device(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got "
                         f"{x.device}")


def _check_types_and_shapes(name, x, q, scale, zero, K, group):
    """What both CUDA int4 kernels ask of their operands' dtypes, of N
    and of the scale and zero shapes."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel takes bf16 x, got {x.dtype}")
    if (q.dtype != torch.int8 or scale.dtype != torch.float32
            or zero.dtype != torch.float32):
        raise ValueError(
            f"{name} kernel takes int8 levels and f32 scale and zero, got "
            f"{q.dtype}, {scale.dtype}, {zero.dtype}")
    N = q.shape[1]
    if N % KERNEL_N_MULTIPLE:
        raise ValueError(f"{name} kernel takes N that is a multiple "
                         f"of {KERNEL_N_MULTIPLE}, got {N}")
    if scale.shape != (K // group, N) or zero.shape != scale.shape:
        raise ValueError(
            f"scale {tuple(scale.shape)} and zero {tuple(zero.shape)} must "
            f"be [K/group, N] = {(K // group, N)}")


def _check_layout(name, x, q, scale, zero):
    """Contiguity and 16-byte alignment. A layer view of a stacked tensor
    is aligned only when one layer's bytes are a multiple of 16, which
    shows here as a misaligned pointer."""
    if x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs x contiguous in its "
                         "last axis with 16-byte aligned rows")
    for t in (q, scale, zero):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs contiguous, 16-byte "
                             "aligned levels, scale and zero on x's device")


def check_kernel_inputs(x, q4p, scale, zero, group, name="int4p_matmul"):
    """Raise unless the tensors are what the packed CUDA int4 kernels
    (W4A16 and W4A8, which share their 32-row k tiles) take."""
    _check_device(name, x)
    T, K = x.shape
    Kh = q4p.shape[0]
    if T < 1 or 2 * Kh != K:
        raise ValueError(f"x {tuple(x.shape)} does not match q4p "
                         f"{tuple(q4p.shape)} (K/2 packed rows)")
    if group % KERNEL_GROUP_MULTIPLE or Kh % group or Kh % _KERNEL_K_TILE:
        raise ValueError(
            f"{name} kernel takes a group that is a multiple of "
            f"{KERNEL_GROUP_MULTIPLE} and divides K/2, and K/2 a multiple of "
            f"{_KERNEL_K_TILE}; got group {group}, K {K}")
    _check_types_and_shapes(name, x, q4p, scale, zero, K, group)
    _check_layout(name, x, q4p, scale, zero)


@functools.lru_cache(maxsize=None)
def _dense_kernel(fmt: str):
    """The prefill body's entry point in the library of its format."""
    if fmt == "packed":
        fn = cuda_build.load("int4p_matmul").int4p_matmul_dense_bf16
        ints = 8
    else:
        fn = cuda_build.load("int4_matmul").int4_matmul_dense_wgmma
        ints = 9  # and per_column
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _dense_product(wrapper, x, q, scale, zero, group, fmt, block_t=None,
                   splits=None):
    """The prefill body on checked operands: f32 [T, N]. ``block_t`` and
    ``splits`` override the plan's (timing sweeps); the plan launched goes
    to ``wrapper.last_plan``."""
    T, K = x.shape
    N = q.shape[1]
    plan = dequant_gemm_plan(T, K, N, group, fmt, block_t, splits)
    splits = plan["splits"]
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, T, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else out)
    args = [x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            out.data_ptr(), partial.data_ptr(), T, K, N, group, x.stride(0),
            plan["block_t"], plan["stages"], splits]
    if fmt != "packed":
        args.append(int(fmt == "per_column"))
    err = _dense_kernel(fmt)(*args,
                             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{wrapper.__name__} prefill body: error {err} (T {T}, K {K}, N "
            f"{N}, group {group}, {fmt}, plan {plan})")
    wrapper.last_plan = plan
    return out


def _decode_product(wrapper, x, q, scale, zero, group, fmt, t_tile=None,
                    splits=None, stages=None):
    """The decode body on checked operands: f32 [T, N]. ``t_tile``,
    ``splits`` and ``stages`` override the plan's (timing sweeps); the plan
    launched goes to ``wrapper.last_plan``."""
    T, K = x.shape
    N = q.shape[1]
    plan = decode_plan(T, K, N, group, fmt, t_tile, splits, stages)
    splits = plan["splits"]
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, T, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else out)
    # The group-wise arithmetic's step sums of x, one per 16 columns of K
    # and token (the last token tile padded with zeros).
    sums = (torch.empty((K // 16, plan["t_tiles"] * plan["t_tile"]),
                        dtype=torch.float32, device=x.device)
            if fmt != "dense" else out)
    args = [x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            out.data_ptr(), partial.data_ptr(), sums.data_ptr(), T, K, N,
            group, x.stride(0), plan["t_tile"], plan["stages"], splits]
    if fmt != "packed":
        args.append(INT4_BODIES[fmt])
    err = _decode_kernel(fmt)(*args,
                              torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{wrapper.__name__} decode body: error {err} (T {T}, K {K}, N "
            f"{N}, group {group}, {fmt}, plan {plan})")
    wrapper.last_plan = plan
    return out


def int4p_matmul(x: torch.Tensor, q4p: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, group: int,
                 layer_idx: Optional[int] = None,
                 block_m: Optional[int] = None,
                 body: Optional[str] = None,
                 decode: Optional[bool] = None,
                 t_tile: Optional[int] = None,
                 splits: Optional[int] = None,
                 stages: Optional[int] = None) -> torch.Tensor:
    """x[T, K] @ dequant(q4p) -> f32 [T, N].

    q4p is int8 [K/2, N], or layer-stacked int8 [L, K/2, N] with
    ``layer_idx`` (a Python int) picking the layer, as the TPU function
    takes it. There the stacked form keeps XLA from materializing the
    scan's per-layer slice; in PyTorch ``w[layer]`` on a leading axis is a
    view that costs nothing, so the "_idx" plumbing of the JAX package's
    wrap_quant_stacked has no counterpart here. The wrapper reads no device
    value, so the launch can go into a CUDA graph. ``body`` ("groupwise" or
    "dense") overrides ``int4p_body``'s choice by T, as int4p_matmul_pallas
    takes it. The group-wise body runs on the mma.sync kernel or on the
    decode body, as ``decode_route`` picks (``decode`` overrides it);
    ``block_m`` overrides ``kernel_plan``'s rows of x per block of the
    former, ``t_tile``, ``splits`` and ``stages`` ``decode_plan``'s plan of
    the latter (timing sweeps). Launches are counted in ``launches`` and,
    by body ("groupwise", "groupwise_decode", "dense_wgmma"), in
    ``launches_by_body``; the plan of the last launch of the decode or the
    prefill body (``decode_plan``, ``dequant_gemm_plan``) in
    ``last_plan``.
    """
    if q4p.dim() == 3:
        if layer_idx is None:
            raise ValueError("layer-stacked q4p needs layer_idx")
        q4p, scale, zero = q4p[layer_idx], scale[layer_idx], zero[layer_idx]
    if x.device.type == "cpu":
        return int4p_matmul_ref(x, q4p, scale, zero, group)
    check_kernel_inputs(x, q4p, scale, zero, group)
    T, K = x.shape
    if int4p_body(T, body) == "dense":
        out = _dense_product(int4p_matmul, x, q4p, scale, zero, group,
                             "packed")
        count_launch(int4p_matmul, body="dense_wgmma")
        return out
    N = q4p.shape[1]
    if decode is None:
        decode = decode_route(T, K, N, group, "packed") == "decode"
    if decode:
        out = _decode_product(int4p_matmul, x, q4p, scale, zero, group,
                              "packed", t_tile, splits, stages)
        count_launch(int4p_matmul, body="groupwise_decode")
        return out
    block_m, splits = kernel_plan(T, K, N, block_m)
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, T, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else out)
    err = _kernel()(
        x.data_ptr(), q4p.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), partial.data_ptr(), T, K, N, group, x.stride(0),
        block_m, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"int4p_matmul kernel: error {err} (T {T}, K {K}, N {N}, group "
            f"{group}, block_m {block_m}, splits {splits})")
    count_launch(int4p_matmul, body="groupwise")
    return out


int4p_matmul.launches = 0
int4p_matmul.launches_by_body = {}
int4p_matmul.last_plan = None


# ----------------------------------------------------------------------
# The unpacked form
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _int4_kernel():
    fn = cuda_build.load("int4_matmul").int4_matmul_bf16
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# The body the wrapper launches when the caller names none: the dense one,
# at every T and group. A group under 16 rows is smaller than one
# tensor-core step, so only the dense body takes it; above, the choice
# follows the card's times (PERF.md): on an H100 the dense body was faster
# or level at all four Llama-3.1-8B sites for T from 8 to 2048 at groups
# of 16, 32 and 128. From DENSE_MIN_T tokens on its calls go to the
# prefill body, which has its arithmetic. The group-wise body is reached
# with body="groupwise".
INT4_BODY = "dense"


def int4_kernel_plan(T: int, K: int, N: int, group: int, body: str,
                     block_m: Optional[int] = None) -> Tuple[int, int]:
    """(block_m, splits) the wrapper launches with: rows of x per block
    (16 up to T = 16, 32 up to 32, else 64, unless given) and how many
    blocks share the k range of one output tile so that a launch has
    about two blocks per SM."""
    if block_m is None:
        block_m = 16 if T <= 16 else 32 if T <= 32 else 64
    k_tile = 32 if group < INT4_GROUPWISE_MIN_GROUP else INT4_K_MULTIPLE
    blocks = (N // KERNEL_N_MULTIPLE) * -(-T // block_m)
    k_tiles = K // k_tile
    splits = max(1, min(2 * _NUM_SMS // blocks, k_tiles // 4, 16))
    per_split = -(-k_tiles // splits)
    return block_m, -(-k_tiles // per_split)


def check_int4_kernel_inputs(x, q4, scale, zero, group, body):
    """Raise unless the tensors are what the unpacked CUDA int4 kernel
    takes with this body."""
    if body not in INT4_BODIES:
        raise ValueError(f"int4_matmul body must be one of "
                         f"{sorted(INT4_BODIES)}, got {body!r}")
    T, K = x.shape
    if T < 1 or q4.shape[0] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match q4 "
                         f"{tuple(q4.shape)}")
    if K % INT4_K_MULTIPLE:
        raise ValueError(f"int4_matmul kernel takes K that is a multiple of "
                         f"{INT4_K_MULTIPLE} (its k tile), got {K}")
    if group < 1 or K % group or (INT4_K_MULTIPLE % group
                                  and group % INT4_K_MULTIPLE):
        raise ValueError(
            f"int4_matmul kernel takes a group that divides K and either "
            f"divides {INT4_K_MULTIPLE} or is a multiple of it (group rows "
            f"must not straddle k tiles); got group {group}, K {K}")
    if body == "groupwise" and group < INT4_GROUPWISE_MIN_GROUP:
        raise ValueError(
            f"the group-wise body takes groups of at least "
            f"{INT4_GROUPWISE_MIN_GROUP} rows (one tensor-core step); group "
            f"{group} takes the dense body")
    _check_types_and_shapes("int4_matmul", x, q4, scale, zero, K, group)
    _check_device("int4_matmul", x)
    _check_layout("int4_matmul", x, q4, scale, zero)


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                zero: torch.Tensor, group: int,
                layer_idx: Optional[int] = None, body: Optional[str] = None,
                block_m: Optional[int] = None,
                decode: Optional[bool] = None,
                t_tile: Optional[int] = None,
                splits: Optional[int] = None,
                stages: Optional[int] = None) -> torch.Tensor:
    """x[T, K] @ dequant(q4) -> f32 [T, N], q4 one int8 level per byte.

    q4 is int8 [K, N], or layer-stacked int8 [L, K, N] with ``layer_idx``
    (a Python int) picking the layer: a view on the leading axis, so the
    offsets inside the kernel stay those of one layer whatever the size of
    the stack. ``body`` ("groupwise" or "dense") overrides ``INT4_BODY``;
    ``int4_route`` says where the call goes (from DENSE_MIN_T tokens on,
    the dense body's calls take the prefill body). Under it each body runs
    on the mma.sync kernel or on the decode body, as ``decode_route`` picks
    (``decode`` overrides it); ``block_m`` overrides ``int4_kernel_plan``'s
    rows of x per block of the former, ``t_tile``, ``splits`` and
    ``stages`` ``decode_plan``'s plan of the latter (card checks and timing
    sweeps). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise. Launches are counted in ``launches`` and, by route
    ("groupwise", "dense", the decode body's "groupwise_decode" and
    "dense_decode", "dense_wgmma", "per_column_wgmma"), in
    ``launches_by_body``; the plan of the last launch of the decode or the
    prefill body in ``last_plan``.
    """
    if q4.dim() == 3:
        if layer_idx is None:
            raise ValueError("layer-stacked q4 needs layer_idx")
        q4, scale, zero = q4[layer_idx], scale[layer_idx], zero[layer_idx]
    if x.device.type == "cpu":
        return int4_matmul_ref(x, q4, scale, zero, group)
    T, K = x.shape
    if body is None:
        body = INT4_BODY
    check_int4_kernel_inputs(x, q4, scale, zero, group, body)
    route = int4_route(T, body)
    if route == "dense_wgmma":
        out = _dense_product(int4_matmul, x, q4, scale, zero, group,
                             "unpacked")
        count_launch(int4_matmul, body=route)
        return out
    N = q4.shape[1]
    if decode is None:
        decode = decode_route(T, K, N, group, body) == "decode"
    if decode:
        out = _decode_product(int4_matmul, x, q4, scale, zero, group, body,
                              t_tile, splits, stages)
        count_launch(int4_matmul, body=f"{body}_decode")
        return out
    block_m, splits = int4_kernel_plan(T, K, N, group, body, block_m)
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, T, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else out)
    err = _int4_kernel()(
        x.data_ptr(), q4.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), partial.data_ptr(), T, K, N, group, x.stride(0),
        block_m, splits, INT4_BODIES[body],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"int4_matmul kernel: error {err} (T {T}, K {K}, N {N}, group "
            f"{group}, body {body}, block_m {block_m}, splits {splits})")
    count_launch(int4_matmul, body=body)
    return out


int4_matmul.launches = 0
int4_matmul.launches_by_body = {}
int4_matmul.last_plan = None


# ----------------------------------------------------------------------
# Per-token activation quantization, W4A8, and the {q, scale} kinds
# ----------------------------------------------------------------------

# The activation formats of the quantizer kernel, by the number its C entry
# point takes, and the dtype of each one's output.
# "e4m3_f16": the e4m3 values stored as f16 (exact), the operand of the FP8
# product's f16 wgmma body.
ACT_FORMATS = {"int8": 0, "e4m3": 1, "e4m3_f16": 2}
_ACT_DTYPES = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn,
               "e4m3_f16": torch.float16}
E4M3_MAX = 448.0  # largest finite float8_e4m3fn


def f32_scalar(value: float, device) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``device``. Dividing by it is IEEE
    division: on the card, a division by a Python scalar multiplies by the
    reciprocal, which rounds differently from the JAX package."""
    return torch.full((), value, dtype=torch.float32, device=device)


def quantize_activations_int8(
        x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 (the JAX package's
    quantize_activations_int8): (xq int8 [T, K], sx f32 [T, 1]) with
    sx = max(amax, 1e-8) / 127 and xq = round(x / sx), half to even,
    clipped to +-127."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    sx = amax.clamp_min(1e-8) / f32_scalar(127.0, x.device)
    return torch.round(xf / sx).clamp_(-127, 127).to(torch.int8), sx


def quantize_activations_e4m3(
        x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token e4m3 of the JAX package's _fp8_w8a8_matmul: (xq
    float8_e4m3fn [T, K], act_scale f32 [T, 1]) with act_scale =
    max(absmax / 448, 1e-12) and xq = x / act_scale rounded to nearest
    even (|x / act_scale| <= 448 by construction, so no cast
    overflows)."""
    xf = x.float()
    absmax = xf.abs().amax(-1, keepdim=True)
    act_scale = (absmax / f32_scalar(E4M3_MAX, x.device)).clamp_min(1e-12)
    return (xf / act_scale).to(torch.float8_e4m3fn), act_scale


@functools.lru_cache(maxsize=None)
def _w4a8_lib() -> ctypes.CDLL:
    lib = cuda_build.load("int4p_matmul_w4a8")
    lib.quantize_rows_bf16.argtypes = ([ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
    lib.quantize_rows_bf16.restype = ctypes.c_int
    lib.int4p_matmul_w4a8.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    lib.int4p_matmul_w4a8.restype = ctypes.c_int
    return lib


def quantize_activations(x: torch.Tensor,
                         fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, K] per token to ``fmt`` ("int8" for W4A8, "e4m3" for FP8
    W8A8, "e4m3_f16" for the same e4m3 values stored as f16, the operand of
    the FP8 product's f16 wgmma body): (xq [T, K], scale f32 [T, 1]). CPU
    tensors take the plain version of the format; CUDA tensors launch the
    quantizer kernel of csrc/int4p_matmul_w4a8.cu, one launch per call and
    bit-equal to the plain version, or raise."""
    if fmt not in ACT_FORMATS:
        raise ValueError(f"activation format must be one of "
                         f"{sorted(ACT_FORMATS)}, got {fmt!r}")
    if x.device.type == "cpu":
        if fmt == "int8":
            return quantize_activations_int8(x)
        xq, scale = quantize_activations_e4m3(x)
        return (xq.to(torch.float16) if fmt == "e4m3_f16" else xq), scale
    _check_device("quantize_activations", x)
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"quantize_activations kernel takes bf16 x [T, K], "
                         f"got {x.dtype} {tuple(x.shape)}")
    T, K = x.shape
    if (T < 1 or K % 8 or x.stride(1) != 1 or x.stride(0) % 8
            or x.data_ptr() % 16):
        raise ValueError(
            "quantize_activations kernel takes K that is a multiple of 8 and "
            "x contiguous in its last axis with 16-byte aligned rows; got "
            f"{tuple(x.shape)} with strides {x.stride()}")
    xq = torch.empty((T, K), dtype=_ACT_DTYPES[fmt], device=x.device)
    scale = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    err = _w4a8_lib().quantize_rows_bf16(
        x.data_ptr(), xq.data_ptr(), scale.data_ptr(), T, K, x.stride(0),
        ACT_FORMATS[fmt], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_activations kernel: error {err} "
                           f"(T {T}, K {K}, format {fmt})")
    count_launch(quantize_activations, format=fmt)
    return xq, scale


quantize_activations.launches = 0
quantize_activations.launches_by_format = {}


# The FP8 W8A8 product's bodies, by its wrapper's key in launches_by_body:
# the e4m3 form of the prefill body (f16 wgmma, dequant_gemm.cuh) and the
# e4m3 mma.sync body of csrc/int4_matmul.cu. The wrapper takes the wgmma
# body from FP8_WGMMA_MIN_T tokens on: on an H100 it was faster at all four
# Llama-3.1-8B sites from 32 tokens on and slower at some under (PERF.md).
FP8_BODIES = ("f16_wgmma", "e4m3_mma")
FP8_WGMMA_MIN_T = 32


def fp8_route(T: int, body: Optional[str] = None) -> str:
    """The body ``fp8_w8a8_matmul`` launches: the one named, else the f16
    wgmma body from FP8_WGMMA_MIN_T tokens on and the e4m3 mma.sync body
    under. Host values only, so a launch can go into a CUDA graph."""
    if body is None:
        return FP8_BODIES[0] if T >= FP8_WGMMA_MIN_T else FP8_BODIES[1]
    if body not in FP8_BODIES:
        raise ValueError(f"fp8_w8a8_matmul body must be one of "
                         f"{FP8_BODIES}, got {body!r}")
    return body


def int4p_matmul_w4a8_ref(x: torch.Tensor, q4p: torch.Tensor,
                          scale: torch.Tensor, zero: torch.Tensor,
                          group: int) -> torch.Tensor:
    """The plain W4A8 product (the JAX package's int4p_matmul_w4a8_ref):
    the per-token int8 quantization of x, an exact f32 product with the
    dequantized weight, times sx. f32 [T, N]."""
    xq, sx = quantize_activations_int8(x)
    w = dequantize_int4(unpack_int4_rows(q4p), scale, zero, group)
    return torch.matmul(xq.float(), w) * sx


def int4p_matmul_w4a8(x: torch.Tensor, q4p: torch.Tensor,
                      scale: torch.Tensor, zero: torch.Tensor, group: int,
                      layer_idx: Optional[int] = None) -> torch.Tensor:
    """quantize(x)[T, K] @ dequant(q4p) * sx -> f32 [T, N].

    The container is the one ``int4p_matmul`` takes: int8 [K/2, N], or
    layer-stacked [L, K/2, N] with ``layer_idx``. CPU tensors take the
    plain version. CUDA tensors launch two kernels or raise: the
    activation quantizer (counted on ``quantize_activations``) and the
    W4A8 product, with the tiles, split of K (``kernel_plan``) and shape
    rules of the W4A16 kernel."""
    if q4p.dim() == 3:
        if layer_idx is None:
            raise ValueError("layer-stacked q4p needs layer_idx")
        q4p, scale, zero = q4p[layer_idx], scale[layer_idx], zero[layer_idx]
    if x.device.type == "cpu":
        return int4p_matmul_w4a8_ref(x, q4p, scale, zero, group)
    check_kernel_inputs(x, q4p, scale, zero, group, "int4p_matmul_w4a8")
    T, K = x.shape
    N = q4p.shape[1]
    xq, sx = quantize_activations(x, "int8")
    block_m, splits = kernel_plan(T, K, N)
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, T, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else out)
    err = _w4a8_lib().int4p_matmul_w4a8(
        xq.data_ptr(), sx.data_ptr(), q4p.data_ptr(), scale.data_ptr(),
        zero.data_ptr(), out.data_ptr(), partial.data_ptr(), T, K, N, group,
        block_m, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"int4p_matmul_w4a8 kernel: error {err} (T {T}, K {K}, N {N}, "
            f"group {group}, block_m {block_m}, splits {splits})")
    count_launch(int4p_matmul_w4a8)
    return out


int4p_matmul_w4a8.launches = 0


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """The JAX package's _int8_matmul: f32 x @ q (exact products: an int8
    level is exact in x's dtype), then * scale [1, N]."""
    return torch.matmul(x.float(), q.float()) * scale


@functools.lru_cache(maxsize=None)
def _zero_row(n: int, device: torch.device) -> torch.Tensor:
    return torch.zeros((1, n), dtype=torch.float32, device=device)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                layer_idx: Optional[int] = None) -> torch.Tensor:
    """x [T, K] @ (q [K, N] * scale [1, N]) -> f32 [T, N], int8
    per-channel weight-only (q and scale may be layer-stacked, with
    ``layer_idx``). CPU tensors take the plain version. An int8
    per-channel container is the unpacked grouped container at G = K with
    zero 0, so CUDA tensors go to ``int4_matmul``'s kernel, counted there
    (``int4_route``): under DENSE_MIN_T tokens its group-wise body, from
    there the prefill body's per-column form. Both multiply raw levels on
    the tensor cores, sum in f32 and apply the scale to the f32 sum: the
    JAX package's arithmetic. The group-wise body takes a zero row made
    once per (N, device); nothing is dequantized to a bf16 copy."""
    if q.dim() == 3:
        if layer_idx is None:
            raise ValueError("layer-stacked q needs layer_idx")
        q, scale = q[layer_idx], scale[layer_idx]
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, scale)
    K, N = q.shape
    zero = _zero_row(N, q.device)
    route = int4_route(x.shape[0], "groupwise", per_column=True)
    if route != "per_column_wgmma":
        return int4_matmul(x, q, scale, zero, K, body="groupwise")
    check_int4_kernel_inputs(x, q, scale, zero, K, "groupwise")
    out = _dense_product(int4_matmul, x, q, scale, zero, K, "per_column")
    count_launch(int4_matmul, body=route)
    return out


def fp8_w8a8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """The JAX package's _fp8_w8a8_matmul: per-token e4m3 activations, an
    f32 product of the e4m3 operands (exact products), then
    out * act_scale * scale in that order."""
    xq, act_scale = quantize_activations_e4m3(x)
    return torch.matmul(xq.float(), q.float()) * act_scale * scale


@functools.lru_cache(maxsize=None)
def _fp8_kernel():
    fn = cuda_build.load("int4_matmul").fp8_w8a8_matmul_e4m3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fp8_f16_kernel():
    fn = cuda_build.load("int4_matmul").fp8_w8a8_matmul_f16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fp8_w8a8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    layer_idx: Optional[int] = None,
                    body: Optional[str] = None,
                    splits: Optional[int] = None,
                    block_t: Optional[int] = None) -> torch.Tensor:
    """x [T, K] @ (q [K, N] e4m3 * scale [1, N]) with x quantized per
    token to e4m3 -> f32 [T, N] (q and scale may be layer-stacked, with
    ``layer_idx``). CPU tensors take the plain version. CUDA tensors
    launch the quantizer kernel, then the body ``fp8_route`` names, each
    summing the exact e4m3 products in f32:

    - "f16_wgmma": the e4m3 form of the prefill body (dequant_gemm.cuh,
      entry fp8_w8a8_matmul_f16 of csrc/int4_matmul.cu, on
      ``dequant_gemm_plan`` with fmt "e4m3"): f16 wgmma on the quantizer's
      values widened to f16 (exact), act_scale then scale multiplied into
      its store;
    - "e4m3_mma": the e4m3 mma.sync body of csrc/int4_matmul.cu, after
      which the wrapper multiplies the two scales in the same order.

    Hopper's 8-bit tensor cores keep fewer bits than f32 inside one k32
    step (8.0e-5 of a row against this product's 2^-14 on an H100, PERF.md),
    so neither body multiplies e4m3 on them. ``splits`` and ``block_t``
    override the wgmma body's plan (timing sweeps). Launches are counted in
    ``launches`` and by body in ``launches_by_body``, the wgmma
    body's plan in ``last_plan``. Raises for what the kernels do not take:
    N % 128, K % 64, a weight that is not contiguous e4m3, non-bf16 x."""
    if q.dim() == 3:
        if layer_idx is None:
            raise ValueError("layer-stacked q needs layer_idx")
        q, scale = q[layer_idx], scale[layer_idx]
    if x.device.type == "cpu":
        return fp8_w8a8_matmul_ref(x, q, scale)
    _check_device("fp8_w8a8_matmul", x)
    T, K = x.shape
    N = q.shape[1]
    if (q.dtype != torch.float8_e4m3fn or q.shape[0] != K
            or not q.is_contiguous() or q.data_ptr() % 16
            or q.device != x.device):
        raise ValueError(
            "fp8_w8a8_matmul kernel takes a contiguous, 16-byte aligned "
            f"float8_e4m3fn weight [K, N] on x's device for x "
            f"{tuple(x.shape)}, got {q.dtype} {tuple(q.shape)} with strides "
            f"{q.stride()}")
    if N % KERNEL_N_MULTIPLE or K % INT4_K_MULTIPLE:
        raise ValueError(
            f"fp8_w8a8_matmul kernel takes N that is a multiple of "
            f"{KERNEL_N_MULTIPLE} and K that is a multiple of "
            f"{INT4_K_MULTIPLE}, got K {K}, N {N}")
    if (scale.dtype != torch.float32 or scale.shape != (1, N)
            or not scale.is_contiguous() or scale.data_ptr() % 16):
        raise ValueError(f"fp8_w8a8_matmul takes a contiguous f32 scale "
                         f"[1, {N}], got {scale.dtype} {tuple(scale.shape)}")
    route = fp8_route(T, body)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    if route == "e4m3_mma":
        xq, act_scale = quantize_activations(x, "e4m3")
        block_m, mma_splits = int4_kernel_plan(T, K, N, K, "groupwise")
        partial = (torch.empty((mma_splits, T, N), dtype=torch.float32,
                               device=x.device) if mma_splits > 1 else out)
        err = _fp8_kernel()(
            xq.data_ptr(), q.data_ptr(), out.data_ptr(), partial.data_ptr(),
            T, K, N, xq.stride(0), block_m, mma_splits, stream)
        if err != 0:
            raise RuntimeError(
                f"fp8_w8a8_matmul kernel: error {err} (T {T}, K {K}, N {N}, "
                f"block_m {block_m}, splits {mma_splits})")
        count_launch(fp8_w8a8_matmul, body=route)
        return out * act_scale * scale
    xq, act_scale = quantize_activations(x, "e4m3_f16")
    plan = dequant_gemm_plan(T, K, N, K, "e4m3", block_t, splits)
    partial = (torch.empty((plan["splits"], T, N), dtype=torch.float32,
                           device=x.device) if plan["splits"] > 1 else out)
    err = _fp8_f16_kernel()(
        xq.data_ptr(), q.data_ptr(), act_scale.data_ptr(), scale.data_ptr(),
        out.data_ptr(), partial.data_ptr(), T, K, N, plan["block_t"],
        plan["stages"], plan["splits"], stream)
    if err != 0:
        raise RuntimeError(
            f"fp8_w8a8_matmul wgmma body: error {err} (T {T}, K {K}, N {N}, "
            f"plan {plan})")
    fp8_w8a8_matmul.last_plan = plan
    count_launch(fp8_w8a8_matmul, body=route)
    return out


fp8_w8a8_matmul.launches = 0
fp8_w8a8_matmul.launches_by_body = {}
fp8_w8a8_matmul.last_plan = None
