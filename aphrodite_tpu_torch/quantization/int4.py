"""INT4 group-quantized weight-only (GPTQ / AWQ checkpoint formats);
a copy of aphrodite_tpu/quantization/int4.py plus a torch
``quantize_from_float`` that runs on the weight's device.

The checkpoint's packed int32 tensors are unpacked at load into the
container {q4 int8[K, N] in [0,15], scale f32[K/G, N], zero f32[K/G, N]},
nibble-packed to {q4p int8[K/2, N]} when the group alignment allows
(ops/quant_matmul.py). Dequant convention:

    w[k, n] = (q4[k, n] - zero[k//G, n]) * scale[k//G, n]

Packing formats (HF ecosystem standards):
- GPTQ: qweight int32[K/8, N], 8 nibbles per int32 along K (low->high);
  qzeros int32[K/G, N/8] packed along N **plus 1** (AutoGPTQ bias);
  scales f16[K/G, N]. `desc_act` (g_idx row permutation) is supported by
  materializing the permutation at load.
- AWQ: qweight int32[K, N/8] packed along N with nibble order
  [0, 4, 1, 5, 2, 6, 3, 7]; qzeros int32[K/G, N/8] same order (no +1);
  scales f16[K/G, N].
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from aphrodite_tpu_torch.ops.quant_matmul import pack_int4_rows

NAME = "int4"
RUNTIME_QUANTIZE = False


def maybe_pack(container: Dict[str, Any]) -> Dict[str, Any]:
    """Convert {q4[K, N]} to the 2-nibbles-per-byte {q4p[K/2, N]} form
    (half-split row layout, ops/quant_matmul.py) when group alignment
    allows: the weight bytes a decode step must read halve, which is the
    point of weight-only int4. Takes numpy arrays or torch tensors."""
    q4 = container.get("q4")
    if q4 is None:
        return container
    K = q4.shape[-2]
    G = K // container["scale"].shape[-2]
    if int(q4.min()) < 0 or int(q4.max()) > 15:
        # Full-byte grouped container (gguf q5/q6/q8/iq4 values):
        # nibble-packing would corrupt; serve unpacked int8.
        return container
    if G > 1 and K % 2 == 0 and (K // 2) % G == 0:
        return {"q4p": pack_int4_rows(q4),
                "scale": container["scale"],
                "zero": container["zero"]}
    return container


def quantize_from_float(w, group: int = 128) -> Dict[str, Any]:
    """Asymmetric 4-bit group quantization of a float weight [..., K, N]
    (runtime quant for benches/tests; real use loads GPTQ/AWQ files).

    A numpy array is quantized with numpy and gives numpy members; a torch
    tensor is quantized on its device with the same f32 arithmetic
    (np.round and torch.round both round half to even) and gives tensors.
    """
    if isinstance(w, torch.Tensor):
        return _quantize_from_float_torch(w, group)
    w = np.asarray(w, dtype=np.float32)
    *lead, K, N = w.shape
    while K % group != 0:
        group //= 2
    g = w.reshape(*lead, K // group, group, N)
    wmin = g.min(axis=-2)
    wmax = g.max(axis=-2)
    scale = np.maximum((wmax - wmin) / 15.0, 1e-8)
    zero = np.round(-wmin / scale)
    q = np.round(g / scale[..., None, :] + zero[..., None, :])
    q = np.clip(q, 0, 15).astype(np.int8).reshape(*lead, K, N)
    return maybe_pack({
        "q4": q,
        "scale": scale.astype(np.float32),
        "zero": zero.astype(np.float32),
    })


def _quantize_from_float_torch(w: torch.Tensor, group: int) -> Dict[str, Any]:
    w = w.float()
    *lead, K, N = w.shape
    while K % group != 0:
        group //= 2
    g = w.reshape(*lead, K // group, group, N)
    wmin = g.amin(dim=-2)
    wmax = g.amax(dim=-2)
    # Divide by a tensor on w's device: with a Python scalar the CUDA
    # kernel multiplies by 1/15, which rounds differently.
    levels = torch.full((), 15.0, dtype=torch.float32, device=w.device)
    scale = ((wmax - wmin) / levels).clamp_min(1e-8)
    zero = torch.round(-wmin / scale)
    q = torch.round(g / scale[..., None, :] + zero[..., None, :])
    q = q.clamp_(0, 15).to(torch.int8).reshape(*lead, K, N)
    return maybe_pack({"q4": q, "scale": scale, "zero": zero})


def _unpack_int32_nibbles(packed: np.ndarray, axis: int) -> np.ndarray:
    """int32[...] -> uint8 nibbles expanded 8x along `axis` (low->high)."""
    p = packed.astype(np.uint32)
    shifts = np.arange(8, dtype=np.uint32) * 4
    nibbles = (p[..., None] >> shifts) & 0xF  # [..., 8]
    nibbles = np.moveaxis(nibbles, -1, axis + 1 if axis >= 0 else axis)
    shape = list(packed.shape)
    shape[axis] = shape[axis] * 8
    return nibbles.reshape(shape).astype(np.uint8)


def load_gptq_tensors(
    qweight: np.ndarray,  # int32[K/8, N]
    qzeros: np.ndarray,  # int32[K/G, N/8]
    scales: np.ndarray,  # f16[K/G, N]
    g_idx: Optional[np.ndarray] = None,  # int32[K] (desc_act)
) -> Dict[str, Any]:
    q4 = _unpack_int32_nibbles(qweight, axis=0).astype(np.int8)  # [K, N]
    zeros = _unpack_int32_nibbles(qzeros, axis=1).astype(np.float32)
    zeros = zeros + 1.0  # AutoGPTQ packs zero-1
    scale = np.asarray(scales, dtype=np.float32)
    if g_idx is not None and len(g_idx):
        G = q4.shape[0] // scale.shape[0]
        default = np.arange(q4.shape[0]) // G
        if not np.array_equal(np.asarray(g_idx), default):
            # desc_act: rows of W were quantized under a permuted group
            # order. Keep the matmul layout by permuting rows back and
            # expanding scales/zeros to per-row, then re-grouping is not
            # possible — store per-row (G=1) scales instead.
            gi = np.asarray(g_idx)
            scale = scale[gi]  # [K, N]
            zeros = zeros[gi]
            return {"q4": q4, "scale": scale, "zero": zeros}
    return maybe_pack({"q4": q4, "scale": scale, "zero": zeros})


def load_awq_tensors(
    qweight: np.ndarray,  # int32[K, N/8]
    qzeros: np.ndarray,  # int32[K/G, N/8]
    scales: np.ndarray,  # f16[K/G, N]
) -> Dict[str, Any]:
    q4 = _unpack_int32_nibbles(qweight, axis=1)  # [K, N], interleaved cols
    zeros = _unpack_int32_nibbles(qzeros, axis=1)
    # AWQ interleaves each 8-column block by [0,2,4,6,1,3,5,7] *before*
    # packing; undo it:
    # logical[:, 8j+k] = unpacked[:, 8j + inv[k]], inv = argsort(order).
    N = q4.shape[1]
    inv = np.argsort(np.array([0, 2, 4, 6, 1, 3, 5, 7]))  # [0,4,1,5,2,6,3,7]
    idx = (np.arange(N) // 8) * 8 + inv[np.arange(N) % 8]
    q4 = q4[:, idx].astype(np.int8)
    zeros = zeros[:, idx].astype(np.float32)
    return maybe_pack({
        "q4": q4,
        "scale": np.asarray(scales, dtype=np.float32),
        "zero": zeros,
    })
