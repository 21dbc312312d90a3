"""IBM Granite (counterpart of aphrodite_tpu/models/granite.py:
GraniteForCausalLM): the Llama topology with its four muP multipliers:
``embedding_multiplier`` on the token embeddings, ``residual_multiplier`` on
both branches of each residual add, ``attention_multiplier`` as the score
scale itself (not an inverse square root), and ``logits_scaling`` dividing
the logits (``logit_scale`` = 1 / logits_scaling).
"""

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class GraniteForCausalLM(LlamaForCausalLM):

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        # The body makes its scale tensors from these in __init__.
        self.embedding_multiplier = float(hf.get("embedding_multiplier", 1.0))
        self.residual_multiplier = float(hf.get("residual_multiplier", 1.0))
        if hf.get("logits_scaling"):
            self.logit_scale = 1.0 / float(hf["logits_scaling"])
        super().__init__(model_config, device)
        if hf.get("attention_multiplier"):
            self.sm_scale = float(hf["attention_multiplier"])
