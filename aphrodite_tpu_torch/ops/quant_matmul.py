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
  the card the quantizer kernel, then the e4m3 body of
  ``csrc/int4_matmul.cu`` (both operands widened to f16 in registers, f32
  sums, as the JAX package's XLA product sums them; it leaves this product
  outside any Pallas kernel).
- ``quantize_activations``: the per-token quantizer of both activation
  formats, one kernel launch on the card, bit-equal to its plain
  versions ``quantize_activations_int8`` and ``quantize_activations_e4m3``.
"""

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.ops import cuda_build

# What the CUDA kernels take (see csrc/int4p_matmul.cu, csrc/int4_matmul.cu).
KERNEL_N_MULTIPLE = 128
# Packed groups: both packed kernels (W4A16 and W4A8) fold a group after
# any 16-row mma step (GGUF Q2_K and Q3_K pack at 16).
KERNEL_GROUP_MULTIPLE = 16
_KERNEL_K_TILE = 32  # packed rows per k tile
_NUM_SMS = 132  # H100 SXM
# The unpacked kernel: k rows per tile, and its two bodies by the number
# the C entry point takes.
INT4_K_MULTIPLE = 64
INT4_BODIES = {"groupwise": 0, "dense": 1}
INT4_GROUPWISE_MIN_GROUP = 16  # one m16n8k16 step
# The prefill body (csrc/dequant_gemm.cuh). Both wrappers send a product of
# DENSE_MIN_T tokens or more to it, the threshold at which the JAX package's
# int4p_matmul_pallas and int4_matmul_dispatch take their dense bodies.
DENSE_MIN_T = 64
DENSE_FORMATS = ("packed", "unpacked", "per_column")
_DG_COLS = 256  # weight columns per block
_DG_K_STAGE = 64  # raw weight rows (levels, or packed bytes) per stage
_DG_TOKEN_ROWS = (64, 128)  # token rows per block, the instantiations
_DG_SMEM = 232448 - 1024  # dynamic shared memory a launch may ask for
_DG_MAX_STAGES = 8
_DG_MAX_SPLITS = 16


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
    does not take. ``fmt``: "packed" (q4p [K/2, N]), "unpacked" (q4 [K, N])
    or "per_column" (int8 per-channel, G = K). Keys: ``block_t`` (token
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
    if T < 1 or N % KERNEL_N_MULTIPLE or rows % _DG_K_STAGE or (
            fmt == "packed" and K % 2):
        raise ValueError(
            f"the prefill body takes N that is a multiple of "
            f"{KERNEL_N_MULTIPLE} and {_DG_K_STAGE}-row stages of the raw "
            f"weight ({'K/2' if fmt == 'packed' else 'K'} a multiple of "
            f"{_DG_K_STAGE}); got T {T}, K {K}, N {N}")
    if fmt == "packed" and (group % KERNEL_GROUP_MULTIPLE or rows % group):
        raise ValueError(f"the prefill body takes a packed group that is a "
                         f"multiple of {KERNEL_GROUP_MULTIPLE} and divides "
                         f"K/2; got group {group}, K {K}")
    if fmt == "unpacked" and (group < 1 or K % group or (
            _DG_K_STAGE % group and group % _DG_K_STAGE)):
        raise ValueError(f"the prefill body takes an unpacked group that "
                         f"divides K and either divides {_DG_K_STAGE} or is "
                         f"a multiple of it; got group {group}, K {K}")
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
    k_stages = rows // _DG_K_STAGE
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


def _count(wrapper, body: str) -> None:
    wrapper.launches += 1
    wrapper.launches_by_body[body] = wrapper.launches_by_body.get(body, 0) + 1


def int4p_matmul(x: torch.Tensor, q4p: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, group: int,
                 layer_idx: Optional[int] = None,
                 block_m: Optional[int] = None,
                 body: Optional[str] = None) -> torch.Tensor:
    """x[T, K] @ dequant(q4p) -> f32 [T, N].

    q4p is int8 [K/2, N], or layer-stacked int8 [L, K/2, N] with
    ``layer_idx`` (a Python int) picking the layer, as the TPU function
    takes it. There the stacked form keeps XLA from materializing the
    scan's per-layer slice; in PyTorch ``w[layer]`` on a leading axis is a
    view that costs nothing, so the "_idx" plumbing of the JAX package's
    wrap_quant_stacked has no counterpart here. The wrapper reads no device
    value, so the launch can go into a CUDA graph. ``body`` ("groupwise" or
    "dense") overrides ``int4p_body``'s choice by T, as int4p_matmul_pallas
    takes it; ``block_m`` overrides ``kernel_plan``'s rows of x per block
    of the group-wise body (for timing sweeps). Launches are counted in
    ``launches`` and, by body ("groupwise", "dense_wgmma"), in
    ``launches_by_body``; the dense body's plan (``dequant_gemm_plan``) in
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
        _count(int4p_matmul, "dense_wgmma")
        return out
    N = q4p.shape[1]
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
    _count(int4p_matmul, "groupwise")
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
                block_m: Optional[int] = None) -> torch.Tensor:
    """x[T, K] @ dequant(q4) -> f32 [T, N], q4 one int8 level per byte.

    q4 is int8 [K, N], or layer-stacked int8 [L, K, N] with ``layer_idx``
    (a Python int) picking the layer: a view on the leading axis, so the
    offsets inside the kernel stay those of one layer whatever the size of
    the stack. ``body`` ("groupwise" or "dense") overrides ``INT4_BODY``;
    ``int4_route`` says where the call goes (from DENSE_MIN_T tokens on,
    the dense body's calls take the prefill body). ``block_m`` overrides
    ``int4_kernel_plan``'s rows of x per block (for card checks and timing
    sweeps). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise. Launches are counted in ``launches`` and, by route,
    in ``launches_by_body``; the prefill body's plan in ``last_plan``.
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
        _count(int4_matmul, route)
        return out
    N = q4.shape[1]
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
    _count(int4_matmul, body)
    return out


int4_matmul.launches = 0
int4_matmul.launches_by_body = {}
int4_matmul.last_plan = None


# ----------------------------------------------------------------------
# Per-token activation quantization, W4A8, and the {q, scale} kinds
# ----------------------------------------------------------------------

# The activation formats of the quantizer kernel, by the number its C entry
# point takes, and the dtype of each one's output.
ACT_FORMATS = {"int8": 0, "e4m3": 1}
_ACT_DTYPES = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}
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
    W8A8): (xq [T, K], scale f32 [T, 1]). CPU tensors take the plain
    version of the format; CUDA tensors launch the quantizer kernel of
    csrc/int4p_matmul_w4a8.cu, one launch per call and bit-equal to the
    plain version, or raise."""
    if fmt not in ACT_FORMATS:
        raise ValueError(f"activation format must be one of "
                         f"{sorted(ACT_FORMATS)}, got {fmt!r}")
    if x.device.type == "cpu":
        plain = (quantize_activations_int8 if fmt == "int8"
                 else quantize_activations_e4m3)
        return plain(x)
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
    quantize_activations.launches += 1
    quantize_activations.launches_by_format[fmt] = \
        quantize_activations.launches_by_format.get(fmt, 0) + 1
    return xq, scale


quantize_activations.launches = 0
quantize_activations.launches_by_format = {}


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
    int4p_matmul_w4a8.launches += 1
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
    _count(int4_matmul, route)
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


def fp8_w8a8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    layer_idx: Optional[int] = None) -> torch.Tensor:
    """x [T, K] @ (q [K, N] e4m3 * scale [1, N]) with x quantized per
    token to e4m3 -> f32 [T, N] (q and scale may be layer-stacked, with
    ``layer_idx``). CPU tensors take the plain version. CUDA tensors
    launch the quantizer kernel, then the e4m3 body of csrc/int4_matmul.cu
    (counted in ``launches``), which sums the exact e4m3 products in f32;
    both scales are applied after, in f32, in the JAX package's order.
    The tiles and the split of K are ``int4_kernel_plan``'s at one group
    per column. Raises for what the kernel does not take: N % 128, K % 64, a weight
    that is not contiguous e4m3, non-bf16 x."""
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
    if scale.dtype != torch.float32 or scale.shape != (1, N):
        raise ValueError(f"fp8_w8a8_matmul takes an f32 scale [1, {N}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    xq, act_scale = quantize_activations(x, "e4m3")
    block_m, splits = int4_kernel_plan(T, K, N, K, "groupwise")
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, T, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else out)
    err = _fp8_kernel()(
        xq.data_ptr(), q.data_ptr(), out.data_ptr(), partial.data_ptr(), T,
        K, N, xq.stride(0), block_m, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fp8_w8a8_matmul kernel: error {err} (T {T}, K {K}, N {N}, "
            f"block_m {block_m}, splits {splits})")
    fp8_w8a8_matmul.launches += 1
    return out * act_scale * scale


fp8_w8a8_matmul.launches = 0
