"""ChatGLM2 and ChatGLM3 (counterpart of aphrodite_tpu/models/chatglm.py:
ChatGLMForConditionalGeneration, also served as ChatGLMModel): the GLM
block on the Llama body, multi-query groups of kv heads
(``multi_query_group_num``), the GPT-J (interleaved) rotary over half of
each head with its base scaled by ``rope_ratio``, q|k|v fused with a bias
in one ``query_key_value`` tensor stored [Q; K; V], gate|up fused in
``dense_h_to_4h``, both split at load, RMSNorm (LayerNorm where the
config turns ``rmsnorm`` off), an untied head. The config's own names
(``num_layers``, ``ffn_hidden_size``, ``padded_vocab_size``,
``seq_length``, ...) are read under the Llama body's (common/config.py:
fill_family_keys).
"""

from typing import List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class ChatGLMForConditionalGeneration(LlamaForCausalLM):
    rope_style = "gptj"

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        if hf.get("apply_residual_connection_post_layernorm"):
            raise NotImplementedError(
                "chatglm apply_residual_connection_post_layernorm")
        if not hf.get("rmsnorm", True):
            self.norm_type = "layernorm"
        super().__init__(model_config, device)

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        e = "transformer.encoder.layers.{i}."
        return [
            (e + "input_layernorm.weight", "layers.input_norm", False),
            (e + "self_attention.dense.weight", "layers.wo", True),
            (e + "post_attention_layernorm.weight", "layers.post_norm",
             False),
            (e + "mlp.dense_4h_to_h.weight", "layers.down", True),
        ]

    def hf_split_mappings(self):
        q_w = self.num_heads * self.head_dim
        kv_w = self.num_kv_heads * self.head_dim
        F = self.intermediate_size
        e = "transformer.encoder.layers.{i}."
        qkv = [("layers.wq", 0, q_w), ("layers.wk", q_w, q_w + kv_w),
               ("layers.wv", q_w + kv_w, q_w + 2 * kv_w)]
        maps = [
            (e + "self_attention.query_key_value.weight", qkv, True),
            (e + "mlp.dense_h_to_4h.weight",
             [("layers.gate", 0, F), ("layers.up", F, 2 * F)], True),
        ]
        if self.attention_bias:
            maps.append((e + "self_attention.query_key_value.bias",
                         [(p.replace(".w", ".b"), a, b) for p, a, b in qkv],
                         False))
        return maps

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("transformer.embedding.word_embeddings.weight", "embed",
             False),
            ("transformer.encoder.final_layernorm.weight", "final_norm",
             False),
            ("transformer.output_layer.weight", "lm_head", True),
        ]
