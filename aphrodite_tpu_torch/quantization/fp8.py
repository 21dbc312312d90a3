"""FP8 (E4M3) W8A8 quantization with per-channel weight scales (a copy of
aphrodite_tpu/quantization/fp8.py that casts with torch.float8_e4m3fn).

Weights are quantized at load from a full-precision checkpoint (or dummy
weights) and stored row-major [K, N] like every other weight; activations
are quantized per token at every product (ops/quant_matmul.py:
fp8_w8a8_matmul). Loading checkpoints that are
already fp8 (``weight_scale`` tensors) is not ported yet.
"""

from typing import Any, Dict

import numpy as np
import torch

from aphrodite_tpu_torch.ops.quant_matmul import E4M3_MAX, f32_scalar

NAME = "fp8"
RUNTIME_QUANTIZE = True


def quantize_from_float(w) -> Dict[str, Any]:
    """w[..., K, N] float -> {q: float8_e4m3fn[..., K, N], scale:
    f32[..., 1, N]}.

    A numpy array is quantized on the CPU, a torch tensor on its device;
    both give tensors (numpy has no e4m3 type). scale = max(absmax / 448,
    1e-12) by IEEE division, and q = w / scale cast to nearest even: the
    values lie within +-448 by construction, so the bytes equal those of
    the JAX package's ml_dtypes cast. No marker key: the kind is read from
    q's dtype, as in the JAX package."""
    if not isinstance(w, torch.Tensor):
        w = torch.from_numpy(np.asarray(w, dtype=np.float32))
    w = w.float()
    absmax = w.abs().amax(-2, keepdim=True)
    scale = (absmax / f32_scalar(E4M3_MAX, w.device)).clamp_min(1e-12)
    return {"q": (w / scale).to(torch.float8_e4m3fn), "scale": scale}

