"""JAIS (counterpart of aphrodite_tpu/models/jais.py: JAISLMHeadModel).

The GPT-2 lineage with ALiBi positions (Bloom's slope schedule), LayerNorm
with bias, q|k|v and o-proj biases, a SwiGLU MLP with biases (``c_fc`` the
gate, ``c_fc2`` the up projection) and a tied LM head, and the muP scales:
token embeddings times ``embeddings_scale`` (or ``mup_embeddings_scale``),
logits times ``width_scale`` (or mup_output_alpha x mup_width_scale), and
with ``scale_qk_dot_by_d`` an attention scale of 1 / head_dim. Its
checkpoints store Conv1D tensors, already [in, out]: nothing is
transposed, and the fused ``c_attn`` is [Q | K | V] along its last axis.
"""

from typing import List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.layers import get_alibi_slopes
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class JAISLMHeadModel(LlamaForCausalLM):
    attention_bias = True
    o_proj_bias = True
    norm_type = "layernorm"
    mlp_bias = True
    use_rope = False
    tie_word_embeddings_default = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        hf.setdefault("hidden_size", hf.get("n_embd"))
        hf.setdefault("intermediate_size",
                      hf.get("n_inner") or 4 * int(hf["hidden_size"]))
        hf.setdefault("rms_norm_eps", hf.get("layer_norm_epsilon", 1e-5))
        if hf.get("position_embedding_type", "alibi") != "alibi":
            raise NotImplementedError("JAIS without ALiBi positions")
        if hf.get("activation_function", "swiglu") != "swiglu":
            raise NotImplementedError("JAIS without swiglu")
        # muP, set before the Llama body's __init__, which makes both
        # scales tensors on the device.
        self.embedding_multiplier = float(
            hf.get("embeddings_scale")
            or hf.get("mup_embeddings_scale", 1.0))
        ws = hf.get("width_scale")
        if ws is None:
            ws = (float(hf.get("mup_output_alpha", 1.0))
                  * float(hf.get("mup_width_scale", 1.0)))
        self.logit_scale = float(ws)
        super().__init__(model_config, device)
        self.alibi_slopes = torch.from_numpy(
            get_alibi_slopes(self.num_heads)).to(device)
        if hf.get("scale_qk_dot_by_d",
                  hf.get("mup_scale_qk_dot_by_d", False)):
            self.sm_scale = 1.0 / self.head_dim

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        # Conv1D stores [in, out]: no transpose anywhere.
        h = "transformer.h.{i}."
        return [
            (h + "ln_1.weight", "layers.input_norm", False),
            (h + "ln_1.bias", "layers.input_norm_b", False),
            (h + "attn.c_proj.weight", "layers.wo", False),
            (h + "attn.c_proj.bias", "layers.bo", False),
            (h + "ln_2.weight", "layers.post_norm", False),
            (h + "ln_2.bias", "layers.post_norm_b", False),
            (h + "mlp.c_fc.weight", "layers.gate", False),
            (h + "mlp.c_fc.bias", "layers.gate_b", False),
            (h + "mlp.c_fc2.weight", "layers.up", False),
            (h + "mlp.c_fc2.bias", "layers.up_b", False),
            (h + "mlp.c_proj.weight", "layers.down", False),
            (h + "mlp.c_proj.bias", "layers.down_b", False),
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

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [
            ("transformer.wte.weight", "embed", False),
            ("transformer.ln_f.weight", "final_norm", False),
            ("transformer.ln_f.bias", "final_norm_b", False),
        ]
        if not self.tie_word_embeddings:
            maps.append(("lm_head.weight", "lm_head", True))
        return maps
