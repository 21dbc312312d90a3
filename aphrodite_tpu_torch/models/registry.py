"""Model registry (counterpart of aphrodite_tpu/models/registry.py).

Maps HF ``architectures[0]`` to a model class. The PyTorch package ports
Llama, Baichuan and Phi-3-Small so far; any other architecture raises.
"""

from typing import Dict, Type

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.baichuan import (BaiChuanForCausalLM,
                                                 BaichuanForCausalLM)
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.models.phi3small import Phi3SmallForCausalLM

_MODEL_REGISTRY: Dict[str, Type[LlamaForCausalLM]] = {
    "LlamaForCausalLM": LlamaForCausalLM,
    "BaiChuanForCausalLM": BaiChuanForCausalLM,
    "BaichuanForCausalLM": BaichuanForCausalLM,
    "Phi3SmallForCausalLM": Phi3SmallForCausalLM,
}


def get_model_class(model_config: ModelConfig) -> Type[LlamaForCausalLM]:
    arch = model_config.architecture
    if arch not in _MODEL_REGISTRY:
        raise ValueError(
            f"architecture {arch!r} is not ported to the PyTorch package "
            f"yet; it serves {sorted(_MODEL_REGISTRY)}. The JAX package "
            "(aphrodite_tpu) serves the others.")
    return _MODEL_REGISTRY[arch]
