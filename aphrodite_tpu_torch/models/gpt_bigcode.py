"""GPTBigCode: StarCoder, SantaCoder (counterpart of
aphrodite_tpu/models/gpt_bigcode.py: GPTBigCodeForCausalLM): GPT-2's
learned positions, LayerNorms and tanh-GELU MLP with multi-query
attention: the fused ``c_attn`` is [Q (all heads) | K | V] on its output
rows, split at load. Its weights are nn.Linear, [out, in]. The config's
``multi_query`` (default true) gives one kv head, else as many as query
heads (common/config.py: fill_family_keys); StarCoder's 48 query heads on
one kv head take the decode kernel's wide form.
"""

from typing import List, Tuple

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class GPTBigCodeForCausalLM(LlamaForCausalLM):
    attention_bias = True
    o_proj_bias = True
    norm_type = "layernorm"
    gated_mlp = False
    mlp_bias = True
    ungated_act = "gelu_tanh"
    use_rope = False
    learned_positions = True
    tie_word_embeddings_default = True
    splits_fused_tensors = True

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        h = "transformer.h.{i}."
        return [
            (h + "ln_1.weight", "layers.input_norm", False),
            (h + "ln_1.bias", "layers.input_norm_b", False),
            (h + "attn.c_proj.weight", "layers.wo", True),
            (h + "attn.c_proj.bias", "layers.bo", False),
            (h + "ln_2.weight", "layers.post_norm", False),
            (h + "ln_2.bias", "layers.post_norm_b", False),
            (h + "mlp.c_fc.weight", "layers.fc1", True),
            (h + "mlp.c_fc.bias", "layers.fc1_b", False),
            (h + "mlp.c_proj.weight", "layers.fc2", True),
            (h + "mlp.c_proj.bias", "layers.fc2_b", False),
        ]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("transformer.wte.weight", "embed", False),
            ("transformer.wpe.weight", "embed_pos", False),
            ("transformer.ln_f.weight", "final_norm", False),
            ("transformer.ln_f.bias", "final_norm_b", False),
        ]

    def hf_split_mappings(self):
        q_end = self.num_heads * self.head_dim
        k_end = q_end + self.num_kv_heads * self.head_dim
        v_end = k_end + self.num_kv_heads * self.head_dim
        return [
            ("transformer.h.{i}.attn.c_attn.weight",
             [("layers.wq", 0, q_end), ("layers.wk", q_end, k_end),
              ("layers.wv", k_end, v_end)], True),
            ("transformer.h.{i}.attn.c_attn.bias",
             [("layers.bq", 0, q_end), ("layers.bk", q_end, k_end),
              ("layers.bv", k_end, v_end)], False),
        ]
