"""Quantized-linear core: weight containers and the matmul dispatch
(counterpart of aphrodite_tpu/quantization/qlinear.py).

The models are functions over a params dict, so a quantized weight is a
dict in place of a tensor, and every projection goes through
``qmatmul(x, w)``, which dispatches on the container's keys. Dense and
quantized checkpoints share the model code.

Kinds (implied by which keys are present):
- dense:              torch.Tensor
- int4 grouped:       {q4: int8[.., K, N] (values in [0, 15]),
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
                                                  int4_matmul_ref,
                                                  int4p_matmul,
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
        if x.device.type != "cpu":
            raise NotImplementedError(
                "unpacked int4 containers (K/2 not a multiple of the group, "
                "desc_act, or full-byte levels) have no CUDA kernel yet "
                "(ROADMAP.md, kernel queue: int4_matmul_pallas_stacked, "
                "int4_matmul_pallas, int4_matmul_pallas_groupwise)")
        q4, scale, zero = w["q4"], w["scale"], w["zero"]
        if layer is not None:
            q4, scale, zero = q4[layer], scale[layer], zero[layer]
        return int4_matmul_ref(x, q4, scale, zero,
                               q4.shape[-2] // scale.shape[-2])
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
