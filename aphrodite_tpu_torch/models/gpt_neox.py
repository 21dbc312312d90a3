"""GPT-NeoX / Pythia (counterpart of aphrodite_tpu/models/gpt_neox.py:
GPTNeoXForCausalLM): partial rotary (``rotary_pct`` of each head, NeoX
pairing), a parallel residual with two LayerNorms (the config's
``use_parallel_residual``), biases on q|k|v, the output projection and
the plain MLP with exact GELU, and an untied ``embed_out`` head. The
checkpoint fuses q|k|v into one ``query_key_value`` tensor stored
head-major ([NH, (q|k|v), D] on its output rows, as Bloom's), which
``finalize_params`` splits.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.bloom import finalize_head_major_qkv
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class GPTNeoXForCausalLM(LlamaForCausalLM):
    attention_bias = True
    o_proj_bias = True
    norm_type = "layernorm"
    gated_mlp = False
    mlp_bias = True
    ungated_act = "gelu"
    splits_fused_tensors = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        self.parallel_residual = bool(
            model_config.hf_config.get("use_parallel_residual", True))
        super().__init__(model_config, device)

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        la = "gpt_neox.layers.{i}."
        return [
            (la + "input_layernorm.weight", "layers.input_norm", False),
            (la + "input_layernorm.bias", "layers.input_norm_b", False),
            (la + "post_attention_layernorm.weight", "layers.post_norm",
             False),
            (la + "post_attention_layernorm.bias", "layers.post_norm_b",
             False),
            (la + "attention.dense.weight", "layers.wo", True),
            (la + "attention.dense.bias", "layers.bo", False),
            (la + "mlp.dense_h_to_4h.weight", "layers.fc1", True),
            (la + "mlp.dense_h_to_4h.bias", "layers.fc1_b", False),
            (la + "mlp.dense_4h_to_h.weight", "layers.fc2", True),
            (la + "mlp.dense_4h_to_h.bias", "layers.fc2_b", False),
        ]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("gpt_neox.embed_in.weight", "embed", False),
            ("gpt_neox.final_layer_norm.weight", "final_norm", False),
            ("gpt_neox.final_layer_norm.bias", "final_norm_b", False),
            ("embed_out.weight", "lm_head", True),
        ]

    def hf_split_mappings(self):
        H = self.hidden_size
        return [
            ("gpt_neox.layers.{i}.attention.query_key_value.weight",
             [("layers.qkv_fused", 0, 3 * H)], True),
            ("gpt_neox.layers.{i}.attention.query_key_value.bias",
             [("layers.qkv_fused_b", 0, 3 * H)], False),
        ]

    def finalize_params(self, params: Dict[str, Any]) -> None:
        finalize_head_major_qkv(params, self.num_heads, self.head_dim)
