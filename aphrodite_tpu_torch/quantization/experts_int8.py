"""experts_int8: load-time int8 quantization of MoE expert weights (a copy
of aphrodite_tpu/quantization/experts_int8.py with a torch
``quantize_from_float`` that runs on the weight's device).

Only the model's ``expert_weights()`` are quantized (``EXPERT_ONLY``):
the expert stacks become {q int8[L, E, K, N], scale f32[L, E, 1, N]}
with one scale per (expert, output channel); attention, router and any
dense MLP stay in the model dtype. The MoE layer dequantizes one layer's
experts at a time (ops/moe.py: materialize_experts), so the card holds
the int8 form.
"""

from aphrodite_tpu_torch.quantization.int8 import quantize_from_float

NAME = "experts_int8"
# Weights arrive as full-precision checkpoints; they are quantized at load.
RUNTIME_QUANTIZE = True
# Only the model's expert_weights() are quantized.
EXPERT_ONLY = True

__all__ = ["NAME", "RUNTIME_QUANTIZE", "EXPERT_ONLY", "quantize_from_float"]
