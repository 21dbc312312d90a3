"""GPT-J (counterpart of aphrodite_tpu/models/gptj.py: GPTJForCausalLM):
the GPT-J (interleaved) rotary over the config's absolute ``rotary_dim``
leading dims of each head (64 of GPT-J-6B's 256), a parallel residual
from one LayerNorm, q, k, v and the output projection without bias, the
plain MLP with bias and the tanh form of GELU, and an untied LM head with
a bias. The config's ``n_embd`` and ``n_inner`` are read as hidden_size
and intermediate_size (common/config.py: fill_family_keys).
"""

from typing import List, Tuple

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class GPTJForCausalLM(LlamaForCausalLM):
    norm_type = "layernorm"
    gated_mlp = False
    mlp_bias = True
    ungated_act = "gelu_tanh"
    parallel_residual = True
    single_norm = True
    rope_style = "gptj"
    lm_head_bias = True

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        h = "transformer.h.{i}."
        return [
            (h + "ln_1.weight", "layers.input_norm", False),
            (h + "ln_1.bias", "layers.input_norm_b", False),
            (h + "attn.q_proj.weight", "layers.wq", True),
            (h + "attn.k_proj.weight", "layers.wk", True),
            (h + "attn.v_proj.weight", "layers.wv", True),
            (h + "attn.out_proj.weight", "layers.wo", True),
            (h + "mlp.fc_in.weight", "layers.fc1", True),
            (h + "mlp.fc_in.bias", "layers.fc1_b", False),
            (h + "mlp.fc_out.weight", "layers.fc2", True),
            (h + "mlp.fc_out.bias", "layers.fc2_b", False),
        ]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("transformer.wte.weight", "embed", False),
            ("transformer.ln_f.weight", "final_norm", False),
            ("transformer.ln_f.bias", "final_norm_b", False),
            ("lm_head.weight", "lm_head", True),
            ("lm_head.bias", "lm_head_b", False),
        ]
