"""Phi-1, Phi-1.5 and Phi-2 (counterpart of aphrodite_tpu/models/phi.py:
PhiForCausalLM): partial rotary (``partial_rotary_factor``, 0.5 where the
config names none: common/config.py), a parallel residual from one
LayerNorm (attention and MLP both read it), biases on q|k|v, the output
projection, the plain MLP (the tanh form of GELU, HF's "gelu_new") and
the untied LM head, and the optional ``qk_layernorm``: one LayerNorm with
bias over head_dim, shared by the heads, on q and on k before the
rotation.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.layers import layer_norm
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM

QK_NORMS = ("q_norm", "q_norm_b", "k_norm", "k_norm_b")


class PhiForCausalLM(LlamaForCausalLM):
    attention_bias = True
    o_proj_bias = True
    norm_type = "layernorm"
    gated_mlp = False
    mlp_bias = True
    ungated_act = "gelu_tanh"
    parallel_residual = True
    single_norm = True
    lm_head_bias = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        self.qk_layernorm = bool(
            model_config.hf_config.get("qk_layernorm", False))
        super().__init__(model_config, device)

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        if self.qk_layernorm:
            for name in QK_NORMS:
                shapes["layers"][name] = (self.num_layers, self.head_dim)
        return shapes

    def qk_norm(self, q: torch.Tensor, k: torch.Tensor, lp: Dict[str, Any],
                layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.qk_layernorm:
            return q, k
        return (layer_norm(q, lp["q_norm"][layer], lp["q_norm_b"][layer],
                           self.rms_eps),
                layer_norm(k, lp["k_norm"][layer], lp["k_norm_b"][layer],
                           self.rms_eps))

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        la = "model.layers.{i}."
        maps = [
            (la + "input_layernorm.weight", "layers.input_norm", False),
            (la + "input_layernorm.bias", "layers.input_norm_b", False),
            (la + "self_attn.dense.weight", "layers.wo", True),
            (la + "self_attn.dense.bias", "layers.bo", False),
            (la + "mlp.fc1.weight", "layers.fc1", True),
            (la + "mlp.fc1.bias", "layers.fc1_b", False),
            (la + "mlp.fc2.weight", "layers.fc2", True),
            (la + "mlp.fc2.bias", "layers.fc2_b", False),
        ]
        for n in "qkv":
            maps += [(la + f"self_attn.{n}_proj.weight", f"layers.w{n}", True),
                     (la + f"self_attn.{n}_proj.bias", f"layers.b{n}", False)]
        if self.qk_layernorm:
            for n in "qk":
                maps += [(la + f"self_attn.{n}_layernorm.weight",
                          f"layers.{n}_norm", False),
                         (la + f"self_attn.{n}_layernorm.bias",
                          f"layers.{n}_norm_b", False)]
        return maps

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("model.embed_tokens.weight", "embed", False),
            ("model.final_layernorm.weight", "final_norm", False),
            ("model.final_layernorm.bias", "final_norm_b", False),
            ("lm_head.weight", "lm_head", True),
            ("lm_head.bias", "lm_head_b", False),
        ]
