"""Quantization registry (counterpart of
aphrodite_tpu/quantization/__init__.py).

Maps an HF ``quantization_config.quant_method`` name to the module that
builds its weight containers. Ported: the 4-bit group-quantized
weight-only family (GPTQ / AWQ: packed int4, served by the W4A16 kernel or,
with ``APHRODITE_W4_A8=1``, the W4A8 one), int8 per-channel weight-only
and FP8 W8A8 (both quantized at load), and experts_int8 (the MoE expert
stacks only, quantized at load).
"""

from typing import Optional

_INT4 = ("gptq", "awq", "awq_marlin", "gptq_marlin")
_INT8 = ("int8", "tpu_int8", "eetq")
_FP8 = ("fp8", "fbgemm_fp8")
_PORTED = _INT4 + _INT8 + _FP8 + ("experts_int8",)
# Every other method name the JAX package knows.
_NOT_PORTED = ("bitsandbytes", "squeezellm", "aqlm", "hqq",
               "qqq", "marlin", "gptq_marlin_24", "quant_llm", "fp2", "fp3",
               "fp4", "fp5", "fp6", "fp7", "quip", "modelopt", "deepspeedfp",
               "compressed-tensors")


def get_quantization_method(name: Optional[str]):
    """The quant method module for a config name (None = dense)."""
    if name is None:
        return None
    name = name.lower()
    if name in _INT4:
        from aphrodite_tpu_torch.quantization import int4

        return int4
    if name in _INT8:
        # eetq is int8 weight-only quantized at load, as in the JAX
        # package.
        from aphrodite_tpu_torch.quantization import int8

        return int8
    if name in _FP8:
        from aphrodite_tpu_torch.quantization import fp8

        return fp8
    if name == "experts_int8":
        from aphrodite_tpu_torch.quantization import experts_int8

        return experts_int8
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"quantization method {name!r} is not ported to the PyTorch "
            "package yet (ROADMAP.md, module queue: the other loaders and "
            f"methods); ported: {_PORTED}")
    raise ValueError(
        f"quantization method {name!r} is not supported; ported: {_PORTED}")
