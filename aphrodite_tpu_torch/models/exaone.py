"""EXAONE (counterpart of aphrodite_tpu/models/exaone.py:
ExaoneForCausalLM; LG AI's EXAONE-3.0): the Llama arithmetic under GPT-style
names (``transformer.h.{i}.attn.attention.*``, ``mlp.c_fc_0`` the gate,
``c_fc_1`` the up projection, ``c_proj``; RMSNorms ``ln_1``, ``ln_2``,
``ln_f``). The config's ``num_layers`` and ``layer_norm_epsilon`` are read
under the Llama body's names (common/config.py: fill_family_keys).
"""

from typing import List, Tuple

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class ExaoneForCausalLM(LlamaForCausalLM):

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        p = "transformer.h.{i}."
        return [
            (p + "ln_1.weight", "layers.input_norm", False),
            (p + "attn.attention.q_proj.weight", "layers.wq", True),
            (p + "attn.attention.k_proj.weight", "layers.wk", True),
            (p + "attn.attention.v_proj.weight", "layers.wv", True),
            (p + "attn.attention.out_proj.weight", "layers.wo", True),
            (p + "ln_2.weight", "layers.post_norm", False),
            (p + "mlp.c_fc_0.weight", "layers.gate", True),
            (p + "mlp.c_fc_1.weight", "layers.up", True),
            (p + "mlp.c_proj.weight", "layers.down", True),
        ]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [("transformer.wte.weight", "embed", False),
                ("transformer.ln_f.weight", "final_norm", False)]
        if not self.tie_word_embeddings:
            maps.append(("lm_head.weight", "lm_head", True))
        return maps
