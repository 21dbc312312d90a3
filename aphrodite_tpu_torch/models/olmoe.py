"""OLMoE (counterpart of aphrodite_tpu/models/olmoe.py: OlmoeForCausalLM):
Mixtral's experts under the checkpoint's ``mlp`` names, the router's
weights renormalized only with ``norm_topk_prob``, and an RMSNorm of q
and k over their full width (all heads together, ``q_norm`` [L, QH * D],
``k_norm`` [L, KV * D]), which HF applies to the projections before the
view into heads; through the ``qk_norm`` hook it is applied to the
flattened heads, which is the same.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.layers import rms_norm
from aphrodite_tpu_torch.models.mixtral import MixtralForCausalLM
from aphrodite_tpu_torch.models.qwen3_moe import (mlp_expert_mappings,
                                                  mlp_experts)


class OlmoeForCausalLM(MixtralForCausalLM):

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        hf.setdefault("num_local_experts", hf.get("num_experts", 64))
        super().__init__(model_config, device)
        self.renormalize = bool(hf.get("norm_topk_prob", False))

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        L, NH, NKV, D = (self.num_layers, self.num_heads, self.num_kv_heads,
                         self.head_dim)
        shapes["layers"]["q_norm"] = (L, NH * D)
        shapes["layers"]["k_norm"] = (L, NKV * D)
        return shapes

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        return mlp_experts(super().hf_param_mappings()) + [
            ("model.layers.{i}.self_attn.q_norm.weight", "layers.q_norm",
             False),
            ("model.layers.{i}.self_attn.k_norm.weight", "layers.k_norm",
             False),
        ]

    def hf_expert_mappings(self) -> List[Tuple[str, str, bool]]:
        return mlp_expert_mappings()

    def qk_norm(self, q: torch.Tensor, k: torch.Tensor, lp: Dict[str, Any],
                layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        T = q.shape[0]
        return (rms_norm(q.reshape(T, -1), lp["q_norm"][layer],
                         self.rms_eps).view(q.shape),
                rms_norm(k.reshape(T, -1), lp["k_norm"][layer],
                         self.rms_eps).view(k.shape))
