"""GPT-2 (counterpart of aphrodite_tpu/models/gpt2.py: GPT2LMHeadModel):
learned absolute positions (``wpe``), LayerNorms with bias, biases on
q|k|v, the output projection and the plain MLP with the tanh form of GELU
(HF's "gelu_new"), and a head tied to the token embeddings. Its Conv1D
weights are stored [in, out], the port's layout, so nothing is
transposed; the fused ``c_attn`` [Q | K | V] is split at load. The
config's ``n_embd``, ``n_inner`` and ``layer_norm_epsilon`` are read under
the Llama body's names (common/config.py: fill_family_keys).
"""

from typing import List, Tuple

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class GPT2LMHeadModel(LlamaForCausalLM):
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
            (h + "attn.c_proj.weight", "layers.wo", False),
            (h + "attn.c_proj.bias", "layers.bo", False),
            (h + "ln_2.weight", "layers.post_norm", False),
            (h + "ln_2.bias", "layers.post_norm_b", False),
            (h + "mlp.c_fc.weight", "layers.fc1", False),
            (h + "mlp.c_fc.bias", "layers.fc1_b", False),
            (h + "mlp.c_proj.weight", "layers.fc2", False),
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
        H = self.hidden_size
        return [
            ("transformer.h.{i}.attn.c_attn.weight",
             [("layers.wq", 0, H), ("layers.wk", H, 2 * H),
              ("layers.wv", 2 * H, 3 * H)], False),
            ("transformer.h.{i}.attn.c_attn.bias",
             [("layers.bq", 0, H), ("layers.bk", H, 2 * H),
              ("layers.bv", 2 * H, 3 * H)], False),
        ]
