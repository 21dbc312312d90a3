"""Qwen3 (counterpart of aphrodite_tpu/models/qwen3.py: Qwen3ForCausalLM).

The Llama / Qwen2 topology without attention bias, plus a per-head
RMSNorm of q and k over head_dim (``q_norm``, ``k_norm``: one [head_dim]
weight per layer, stacked [L, head_dim]) after the reshape to heads and
before RoPE, with the model's rms_norm_eps.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.models.layers import rms_norm
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class Qwen3ForCausalLM(LlamaForCausalLM):

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        L, D = self.num_layers, self.head_dim
        shapes["layers"]["q_norm"] = (L, D)
        shapes["layers"]["k_norm"] = (L, D)
        return shapes

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        return super().hf_param_mappings() + [
            ("model.layers.{i}.self_attn.q_norm.weight", "layers.q_norm",
             False),
            ("model.layers.{i}.self_attn.k_norm.weight", "layers.k_norm",
             False),
        ]

    def qk_norm(self, q: torch.Tensor, k: torch.Tensor, lp: Dict[str, Any],
                layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return (rms_norm(q, lp["q_norm"][layer], self.rms_eps),
                rms_norm(k, lp["k_norm"][layer], self.rms_eps))
