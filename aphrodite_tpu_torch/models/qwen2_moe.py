"""Qwen2-MoE (Qwen1.5-MoE-A2.7B, Qwen2-57B-A14B; counterpart of
aphrodite_tpu/models/qwen2_moe.py: Qwen2MoeForCausalLM): q|k|v bias,
Mixtral's experts under the checkpoint's ``mlp`` names, plus an
always-on shared expert (a SwiGLU MLP of its own width) blended in by
sigmoid(h @ shared_expert_gate), in f32, as in the JAX package.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.layers import silu_and_mul
from aphrodite_tpu_torch.models.mixtral import MixtralForCausalLM
from aphrodite_tpu_torch.models.qwen3_moe import (mlp_expert_mappings,
                                                  mlp_experts, moe_config)
from aphrodite_tpu_torch.quantization.qlinear import qmatmul


class Qwen2MoeForCausalLM(MixtralForCausalLM):
    attention_bias = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        moe_config(hf, 60, "qwen2-moe")
        super().__init__(model_config, device)
        self.shared_intermediate = int(
            hf.get("shared_expert_intermediate_size", 0))
        self.renormalize = bool(hf.get("norm_topk_prob", False))

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        L, H, Fs = self.num_layers, self.hidden_size, self.shared_intermediate
        shapes["layers"].update(shared_gate=(L, H, Fs), shared_up=(L, H, Fs),
                                shared_down=(L, Fs, H),
                                shared_expert_gate=(L, H, 1))
        return shapes

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        se = "model.layers.{i}.mlp.shared_expert"
        return mlp_experts(super().hf_param_mappings()) + [
            (se + ".gate_proj.weight", "layers.shared_gate", True),
            (se + ".up_proj.weight", "layers.shared_up", True),
            (se + ".down_proj.weight", "layers.shared_down", True),
            ("model.layers.{i}.mlp.shared_expert_gate.weight",
             "layers.shared_expert_gate", True),
        ]

    def hf_expert_mappings(self) -> List[Tuple[str, str, bool]]:
        return mlp_expert_mappings()

    def mlp(self, lp: Dict[str, Any], h: torch.Tensor,
            layer: int) -> torch.Tensor:
        sparse = super().mlp(lp, h, layer)
        gate = qmatmul(h, lp["shared_gate"], layer)
        up = qmatmul(h, lp["shared_up"], layer)
        act = silu_and_mul(gate.to(self.dtype), up.to(self.dtype))
        shared = qmatmul(act, lp["shared_down"], layer).float()
        blend = torch.sigmoid(
            qmatmul(h, lp["shared_expert_gate"], layer).float())
        return sparse + (blend * shared).to(sparse.dtype)
