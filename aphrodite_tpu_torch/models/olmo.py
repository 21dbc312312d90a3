"""OLMo v1 (counterpart of aphrodite_tpu/models/olmo.py: OlmoForCausalLM;
OLMo-1B, OLMo-7B): the Llama topology and names with non-parametric
LayerNorms (no weight or bias anywhere: the Llama body's
``norm_parametric``), q, k and v clamped to the config's ``clip_qkv``, and
an untied head.
"""

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class OlmoForCausalLM(LlamaForCausalLM):
    norm_type = "layernorm"
    norm_parametric = False

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        super().__init__(model_config, device)
        self.qkv_clip = float(model_config.hf_config.get("clip_qkv") or 0.0)
