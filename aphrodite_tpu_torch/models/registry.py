"""Model registry (counterpart of aphrodite_tpu/models/registry.py).

Maps HF ``architectures[0]`` to a model class. The PyTorch package ports
Llama (and the checkpoints that reuse its graph: Mistral, Qwen2 and
Qwen2.5, and the JAX registry's Llama aliases), Qwen3, Baichuan,
Phi-3-Small, Phi-3 (mini, medium) and Gemma, Gemma2 and Gemma3 so far;
any other architecture raises. The embedding aliases
(``MistralModel``, ``LlamaModel``) wait for the pooling runner.
"""

from typing import Dict, Type

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.baichuan import (BaiChuanForCausalLM,
                                                 BaichuanForCausalLM)
from aphrodite_tpu_torch.models.gemma import (Gemma2ForCausalLM,
                                              Gemma3ForCausalLM,
                                              GemmaForCausalLM)
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.models.phi3 import Phi3ForCausalLM
from aphrodite_tpu_torch.models.phi3small import Phi3SmallForCausalLM
from aphrodite_tpu_torch.models.qwen3 import Qwen3ForCausalLM


class Qwen2ForCausalLM(LlamaForCausalLM):
    """Qwen2 / Qwen2.5: the Llama topology with q|k|v bias; the small
    variants tie the embeddings (the config's tie_word_embeddings)."""

    attention_bias = True


class MistralForCausalLM(LlamaForCausalLM):
    """Mistral: the Llama topology with the config's sliding window."""


_MODEL_REGISTRY: Dict[str, Type[LlamaForCausalLM]] = {
    "LlamaForCausalLM": LlamaForCausalLM,
    "MistralForCausalLM": MistralForCausalLM,
    "Qwen2ForCausalLM": Qwen2ForCausalLM,
    "Qwen3ForCausalLM": Qwen3ForCausalLM,
    # Checkpoints that reuse the Llama graph and names (Aquila /
    # AquilaChat2, InternLM v1, decapoda LLaMA, XVERSE), as in the JAX
    # registry.
    "AquilaModel": LlamaForCausalLM,
    "AquilaForCausalLM": LlamaForCausalLM,
    "InternLMForCausalLM": LlamaForCausalLM,
    "LLaMAForCausalLM": LlamaForCausalLM,
    "XverseForCausalLM": LlamaForCausalLM,
    "BaiChuanForCausalLM": BaiChuanForCausalLM,
    "BaichuanForCausalLM": BaichuanForCausalLM,
    "Phi3SmallForCausalLM": Phi3SmallForCausalLM,
    "GemmaForCausalLM": GemmaForCausalLM,
    "Gemma2ForCausalLM": Gemma2ForCausalLM,
    "Gemma3ForCausalLM": Gemma3ForCausalLM,
    "Phi3ForCausalLM": Phi3ForCausalLM,
}


def get_model_class(model_config: ModelConfig) -> Type[LlamaForCausalLM]:
    arch = model_config.architecture
    if arch not in _MODEL_REGISTRY:
        raise ValueError(
            f"architecture {arch!r} is not ported to the PyTorch package "
            f"yet; it serves {sorted(_MODEL_REGISTRY)}. The JAX package "
            "(aphrodite_tpu) serves the others.")
    return _MODEL_REGISTRY[arch]
