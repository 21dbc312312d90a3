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
                      rows, ops/quant_matmul.py); with APHRODITE_W4_A8=1
                      a layer-stacked one may take the W4A8 product
- int8 per-channel:   {q: int8[.., K, N], scale: f32[.., 1, N]}
- fp8 w8a8:           {q: float8_e4m3fn[.., K, N], scale: f32[.., 1, N]};
                       activations quantized per token at every product

The group size G derives from the shapes (K // scale rows), so a container
holds tensors only. A layer-stacked container [L, ...] is indexed by
``layer``; on a leading axis that is a view, so nothing is copied.
"""

import os
from typing import Any, Dict, Optional, Union

import torch

from aphrodite_tpu_torch.ops.quant_matmul import (KERNEL_N_MULTIPLE,
                                                  dequantize_int4,
                                                  fp8_w8a8_matmul,
                                                  int4_matmul, int4p_matmul,
                                                  int4p_matmul_w4a8,
                                                  int8_matmul,
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
        if layer is not None and takes_w4a8(x, q4p, group):
            return int4p_matmul_w4a8(x, q4p, w["scale"], w["zero"], group,
                                     layer_idx=layer)
        return int4p_matmul(x, q4p, w["scale"], w["zero"], group,
                            layer_idx=layer)
    if "q4" in w:
        q4 = w["q4"]
        group = q4.shape[-2] // w["scale"].shape[-2]
        return int4_matmul(x, q4, w["scale"], w["zero"], group,
                           layer_idx=layer)
    if w["q"].dtype == torch.float8_e4m3fn:
        return fp8_w8a8_matmul(x, w["q"], w["scale"], layer_idx=layer)
    return int8_matmul(x, w["q"], w["scale"], layer_idx=layer)


def takes_w4a8(x: torch.Tensor, q4p: torch.Tensor, group: int) -> bool:
    """Whether a layer-stacked packed product goes to W4A8: the JAX
    package's test in int4p_matmul_stacked_dispatch, with the switch
    APHRODITE_W4_A8 read at the call. Its other test, a TPU backend, has no
    counterpart: on the CPU the same conditions pick the plain W4A8
    product, so the CPU computes what the card does."""
    Kh, N = q4p.shape[-2], q4p.shape[-1]
    return (os.environ.get("APHRODITE_W4_A8", "0") == "1"
            and N % KERNEL_N_MULTIPLE == 0 and group > 1 and Kh % group == 0
            and x.shape[0] >= 16)


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
    return (w["q"].float() * w["scale"]).to(dtype)
