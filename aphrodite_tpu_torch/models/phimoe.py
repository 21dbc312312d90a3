"""PhiMoE (Phi-3.5-MoE; counterpart of aphrodite_tpu/models/phimoe.py:
PhiMoEForCausalLM): Mixtral's layout with LayerNorm, q|k|v and o-proj
biases (the config's ``attention_bias``, on by default as in the JAX
package), an LM-head bias (``lm_head_bias``), LongRoPE (models/layers.py:
compute_rope_tables, as for Phi-3) and sparsemixer routing (ops/moe.py:
sparsemixer_routing with ``router_jitter_noise``), whose two weights are
not renormalized.
"""

from typing import List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.mixtral import MixtralForCausalLM
from aphrodite_tpu_torch.ops.moe import router_logits, sparsemixer_routing


class PhiMoEForCausalLM(MixtralForCausalLM):
    norm_type = "layernorm"

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        self.attention_bias = bool(hf.get("attention_bias", True))
        self.o_proj_bias = self.attention_bias
        self.lm_head_bias = bool(hf.get("lm_head_bias", False))
        super().__init__(model_config, device)
        self.router_jitter = float(hf.get("router_jitter_noise", 0.01))

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = super().hf_global_mappings()
        if self.lm_head_bias and not self.tie_word_embeddings:
            maps.append(("lm_head.bias", "lm_head_b", False))
        return maps

    def route(self, router: torch.Tensor,
              h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return sparsemixer_routing(router_logits(h, router),
                                   self.router_jitter)
