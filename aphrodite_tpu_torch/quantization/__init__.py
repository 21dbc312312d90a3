"""Quantization registry (counterpart of
aphrodite_tpu/quantization/__init__.py).

Maps an HF ``quantization_config.quant_method`` name to the module that
builds its weight containers. Ported so far: the 4-bit group-quantized
weight-only family (GPTQ / AWQ), served by the packed-int4 CUDA kernel.
"""

from typing import Optional

_INT4 = ("gptq", "awq", "awq_marlin", "gptq_marlin")
# Every other method name the JAX package knows.
_NOT_PORTED = ("int8", "tpu_int8", "eetq", "experts_int8", "fp8",
               "fbgemm_fp8", "bitsandbytes", "squeezellm", "aqlm", "hqq",
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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"quantization method {name!r} is not ported to the PyTorch "
            "package yet (ROADMAP.md, module queue: the other qmatmul paths "
            f"and the other loaders); ported: {_INT4}")
    raise ValueError(
        f"quantization method {name!r} is not supported; ported: {_INT4}")
