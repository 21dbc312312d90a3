"""SmolLM3 (counterpart of aphrodite_tpu/models/smollm3.py:
SmolLM3ForCausalLM): the Llama topology with NoPE layers, which rotate
neither q nor k. The config's ``no_rope_layers`` names them per layer (1:
rotary, 0: NoPE); without it every ``no_rope_layer_interval``-th layer
(default 4) is NoPE. The head is tied by default.
"""

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class SmolLM3ForCausalLM(LlamaForCausalLM):
    tie_word_embeddings_default = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        super().__init__(model_config, device)
        hf = model_config.hf_config
        mask = hf.get("no_rope_layers")
        if mask is None:
            interval = int(hf.get("no_rope_layer_interval", 4))
            mask = [0 if (i + 1) % interval == 0 else 1
                    for i in range(self.num_layers)]
        self.rope_layer_mask = [bool(v) for v in mask]
