"""INT8 weight-only quantization with per-output-channel scales (a copy
of aphrodite_tpu/quantization/int8.py plus a torch ``quantize_from_float``
that runs on the weight's device).

Weights are quantized at load from a full-precision checkpoint (or dummy
weights); the matmul keeps int8 levels and folds the dequantization into
one output rescale (ops/quant_matmul.py: int8_matmul).
"""

from typing import Any, Dict

import numpy as np
import torch

from aphrodite_tpu_torch.ops.quant_matmul import f32_scalar

NAME = "int8"
# Weights arrive as full-precision checkpoints; they are quantized at load.
RUNTIME_QUANTIZE = True


def quantize_from_float(w) -> Dict[str, Any]:
    """w[..., K, N] float -> {q: int8, scale: f32[..., 1, N]}, as tensors.

    A numpy array is quantized on the CPU, a torch tensor on its device:
    IEEE division by a 0-d f32 tensor, round half to even, as the JAX
    package's numpy arithmetic."""
    if not isinstance(w, torch.Tensor):
        w = torch.from_numpy(np.asarray(w, dtype=np.float32))
    w = w.float()
    absmax = w.abs().amax(-2, keepdim=True)
    scale = (absmax / f32_scalar(127.0, w.device)).clamp_min(1e-8)
    q = torch.round(w / scale).clamp_(-128, 127).to(torch.int8)
    return {"q": q, "scale": scale}
