"""Persimmon-8B (counterpart of aphrodite_tpu/models/persimmon.py:
PersimmonForCausalLM): partial rotary (0.5 in its config), a LayerNorm
with bias over head_dim on q and on k before the rotation
(``qk_layernorm``, on unless the config turns it off), biases on q|k|v,
the output projection and the plain MLP with squared ReLU, LayerNorms
with bias, an untied head. The checkpoint fuses q|k|v head-major, as
GPT-NeoX's; ``finalize_params`` splits it.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.bloom import finalize_head_major_qkv
from aphrodite_tpu_torch.models.layers import layer_norm
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM

QK_NORMS = ("q_ln", "q_ln_b", "k_ln", "k_ln_b")


class PersimmonForCausalLM(LlamaForCausalLM):
    attention_bias = True
    o_proj_bias = True
    norm_type = "layernorm"
    gated_mlp = False
    mlp_bias = True
    ungated_act = "relu2"
    splits_fused_tensors = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        self.qk_layernorm = bool(
            model_config.hf_config.get("qk_layernorm", True))
        super().__init__(model_config, device)

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        if self.qk_layernorm:
            for name in QK_NORMS:
                shapes["layers"][name] = (self.num_layers, self.head_dim)
        return shapes

    def dummy_ones(self, path: str) -> bool:
        """Dummy weights: the q/k LayerNorms' weights are ones, as every
        other norm's."""
        return path in ("layers.q_ln", "layers.k_ln")

    def qk_norm(self, q: torch.Tensor, k: torch.Tensor, lp: Dict[str, Any],
                layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.qk_layernorm:
            return q, k
        return (layer_norm(q, lp["q_ln"][layer], lp["q_ln_b"][layer],
                           self.rms_eps),
                layer_norm(k, lp["k_ln"][layer], lp["k_ln_b"][layer],
                           self.rms_eps))

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        la = "model.layers.{i}."
        maps = [
            (la + "input_layernorm.weight", "layers.input_norm", False),
            (la + "input_layernorm.bias", "layers.input_norm_b", False),
            (la + "post_attention_layernorm.weight", "layers.post_norm",
             False),
            (la + "post_attention_layernorm.bias", "layers.post_norm_b",
             False),
            (la + "self_attn.dense.weight", "layers.wo", True),
            (la + "self_attn.dense.bias", "layers.bo", False),
            (la + "mlp.dense_h_to_4h.weight", "layers.fc1", True),
            (la + "mlp.dense_h_to_4h.bias", "layers.fc1_b", False),
            (la + "mlp.dense_4h_to_h.weight", "layers.fc2", True),
            (la + "mlp.dense_4h_to_h.bias", "layers.fc2_b", False),
        ]
        if self.qk_layernorm:
            for n in "qk":
                maps += [(la + f"self_attn.{n}_layernorm.weight",
                          f"layers.{n}_ln", False),
                         (la + f"self_attn.{n}_layernorm.bias",
                          f"layers.{n}_ln_b", False)]
        return maps

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("model.embed_tokens.weight", "embed", False),
            ("model.final_layernorm.weight", "final_norm", False),
            ("model.final_layernorm.bias", "final_norm_b", False),
            ("lm_head.weight", "lm_head", True),
        ]

    def hf_split_mappings(self):
        H = self.hidden_size
        return [
            ("model.layers.{i}.self_attn.query_key_value.weight",
             [("layers.qkv_fused", 0, 3 * H)], True),
            ("model.layers.{i}.self_attn.query_key_value.bias",
             [("layers.qkv_fused_b", 0, 3 * H)], False),
        ]

    def finalize_params(self, params: Dict[str, Any]) -> None:
        finalize_head_major_qkv(params, self.num_heads, self.head_dim)
