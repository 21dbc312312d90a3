"""DeciLM (counterpart of aphrodite_tpu/models/decilm.py:
DeciLMForCausalLM; Deci/DeciLM-7b): Llama with a kv head count per layer
(``num_key_value_heads_per_layer``). As in the JAX package, every layer is
served at the largest count: the loader replicates a layer's kv heads in
place (``maybe_pad_kv_weight_layer``, each head repeated for the query
heads it serves), which is exact, and the cache is sized at that count
(common/config.py: fill_family_keys sets num_key_value_heads to it).
"""

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class DeciLMForCausalLM(LlamaForCausalLM):

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        per_layer = model_config.hf_config.get("num_key_value_heads_per_layer")
        self.kv_per_layer = [int(n) for n in per_layer] if per_layer else None
        super().__init__(model_config, device)

    def maybe_pad_kv_weight_layer(self, our_path: str, arr: torch.Tensor,
                                  layer: int) -> torch.Tensor:
        """Layer ``layer``'s K or V weight ([in, kv * D], after the
        transpose) or bias ([kv * D]) at the model's kv head count, each of
        its own heads repeated in place; anything else as it is."""
        if not self.kv_per_layer or our_path not in (
                "layers.wk", "layers.wv", "layers.bk", "layers.bv"):
            return arr
        kv = self.kv_per_layer[layer]
        reps = self.num_kv_heads // kv
        if reps == 1:
            return arr
        heads = arr.reshape(*arr.shape[:-1], kv, self.head_dim)
        return heads.repeat_interleave(reps, dim=-2).reshape(
            *arr.shape[:-1], self.num_kv_heads * self.head_dim)
