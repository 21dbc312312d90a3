"""Quantized-linear core: weight containers and the matmul dispatch
(counterpart of aphrodite_tpu/quantization/qlinear.py).

The models are functions over a params dict, so a quantized weight is a
dict in place of a tensor, and every projection goes through
``qmatmul(x, w)``, which dispatches on the container's keys. Dense and
quantized checkpoints share the model code.

Kinds (implied by which keys are present):
- dense:              torch.Tensor
- int4 grouped:       {q4: int8[.., K, N] (one level per byte: 0..15 of
                       an act-order GPTQ checkpoint, or any int8 level of
                       a GGUF Q5/Q6/Q8/IQ tensor),
                       scale: f32[.., K/G, N], zero: f32[.., K/G, N]}
- int4 packed:        {q4p: int8[.., K/2, N], scale, zero} (half-split
                      rows, ops/quant_matmul.py)
- int8 per-channel and fp8 w8a8 ({q, scale}): not ported yet.

The group size G derives from the shapes (K // scale rows), so a container
holds tensors only. A layer-stacked container [L, ...] is indexed by
``layer``; on a leading axis that is a view, so nothing is copied.
"""

from typing import Any, Dict, Optional, Union

import torch

from aphrodite_tpu_torch.ops.quant_matmul import (dequantize_int4,
                                                  int4_matmul, int4p_matmul,
                                                  unpack_int4_rows)

WeightLike = Union[torch.Tensor, Dict[str, Any]]


def is_quantized(w: WeightLike) -> bool:
    return isinstance(w, dict)


def qmatmul(x: torch.Tensor, w: WeightLike,
            layer: Optional[int] = None) -> torch.Tensor:
    """x[T, K] @ w -> [T, N]. A tensor goes to torch.matmul and keeps x's
    dtype; a container gives f32, as the kernel accumulates.

    ``layer`` picks one layer of a layer-stacked weight [L, ...].
    """
    if not isinstance(w, dict):
        return torch.matmul(x, w if layer is None else w[layer])
    if "q4p" in w:
        q4p = w["q4p"]
        group = 2 * q4p.shape[-2] // w["scale"].shape[-2]
        return int4p_matmul(x, q4p, w["scale"], w["zero"], group,
                            layer_idx=layer)
    if "q4" in w:
        q4 = w["q4"]
        group = q4.shape[-2] // w["scale"].shape[-2]
        return int4_matmul(x, q4, w["scale"], w["zero"], group,
                           layer_idx=layer)
    raise NotImplementedError(
        "int8 and fp8 weight containers are not ported yet (ROADMAP.md, "
        "module queue: the other qmatmul paths)")


def dequantize(w: WeightLike, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the full-precision weight (tests)."""
    if not isinstance(w, dict):
        return w.to(dtype)
    if "q4p" in w:
        return dequantize({"q4": unpack_int4_rows(w["q4p"]),
                           "scale": w["scale"], "zero": w["zero"]}, dtype)
    if "q4" in w:
        group = w["q4"].shape[-2] // w["scale"].shape[-2]
        return dequantize_int4(w["q4"], w["scale"], w["zero"],
                               group).to(dtype)
    raise NotImplementedError(
        "int8 and fp8 weight containers are not ported yet (ROADMAP.md, "
        "module queue: the other qmatmul paths)")
