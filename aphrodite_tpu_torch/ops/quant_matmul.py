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
  kernel.
- ``int4p_matmul``: the dispatching wrapper of the packed form. CPU
  tensors take the plain version; CUDA tensors launch the kernel
  ``csrc/int4p_matmul.cu`` (which replaces the TPU kernel
  aphrodite_tpu/ops/quant_matmul.py: int4p_matmul_pallas) or raise. It
  is bound by weight bytes at decode sizes and by tensor-core operations
  at prefill sizes; the source says what it does about each. The kernel
  uses the group-wise form (raw nibbles on the tensor cores, scale and
  zero applied to f32 partial sums), so it does not round the dequantized
  weight to bf16 as the plain version does: it agrees with the exact
  f32-weight product to the order of the sums, and with the plain version
  to that rounding (2^-9 relative per term).
"""

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.ops import cuda_build

# What the CUDA kernels take (see csrc/int4p_matmul.cu, csrc/int4_matmul.cu).
KERNEL_N_MULTIPLE = 128
KERNEL_GROUP_MULTIPLE = 32
_KERNEL_K_TILE = 32  # packed rows per k tile
_NUM_SMS = 132  # H100 SXM
# The unpacked kernel: k rows per tile, and its two bodies by the number
# the C entry point takes.
INT4_K_MULTIPLE = 64
INT4_BODIES = {"groupwise": 0, "dense": 1}
INT4_GROUPWISE_MIN_GROUP = 16  # one m16n8k16 step


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


def check_kernel_inputs(x, q4p, scale, zero, group):
    """Raise unless the tensors are what the packed CUDA int4 kernel
    takes."""
    _check_device("int4p_matmul", x)
    T, K = x.shape
    Kh = q4p.shape[0]
    if T < 1 or 2 * Kh != K:
        raise ValueError(f"x {tuple(x.shape)} does not match q4p "
                         f"{tuple(q4p.shape)} (K/2 packed rows)")
    if group % KERNEL_GROUP_MULTIPLE or Kh % group:
        raise ValueError(
            f"int4p_matmul kernel takes a group that is a multiple of "
            f"{KERNEL_GROUP_MULTIPLE} and divides K/2; got group {group}, "
            f"K {K}")
    _check_types_and_shapes("int4p_matmul", x, q4p, scale, zero, K, group)
    _check_layout("int4p_matmul", x, q4p, scale, zero)


def int4p_matmul(x: torch.Tensor, q4p: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, group: int,
                 layer_idx: Optional[int] = None,
                 block_m: Optional[int] = None) -> torch.Tensor:
    """x[T, K] @ dequant(q4p) -> f32 [T, N].

    q4p is int8 [K/2, N], or layer-stacked int8 [L, K/2, N] with
    ``layer_idx`` (a Python int) picking the layer, as the TPU function
    takes it. There the stacked form keeps XLA from materializing the
    scan's per-layer slice; in PyTorch ``w[layer]`` on a leading axis is a
    view that costs nothing, so the "_idx" plumbing of the JAX package's
    wrap_quant_stacked has no counterpart here. The wrapper reads no device
    value, so the launch can go into a CUDA graph. ``block_m`` overrides
    ``kernel_plan``'s choice by T (for timing sweeps).
    """
    if q4p.dim() == 3:
        if layer_idx is None:
            raise ValueError("layer-stacked q4p needs layer_idx")
        q4p, scale, zero = q4p[layer_idx], scale[layer_idx], zero[layer_idx]
    if x.device.type == "cpu":
        return int4p_matmul_ref(x, q4p, scale, zero, group)
    check_kernel_inputs(x, q4p, scale, zero, group)
    T, K = x.shape
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
    int4p_matmul.launches += 1
    return out


int4p_matmul.launches = 0


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
# of 16, 32 and 128. The group-wise body is reached with body="groupwise".
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
    the stack. ``body`` ("groupwise" or "dense") and ``block_m`` override
    ``INT4_BODY`` and ``int4_kernel_plan`` (for card checks and timing
    sweeps). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.
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
    int4_matmul.launches += 1
    int4_matmul.launches_by_body[body] = \
        int4_matmul.launches_by_body.get(body, 0) + 1
    return out


int4_matmul.launches = 0
int4_matmul.launches_by_body = {}
