"""GLM-4 (counterpart of aphrodite_tpu/models/glm.py: GlmForCausalLM;
glm-4-9b and its chat models): the Llama names with the GPT-J
(interleaved) rotary over the config's partial_rotary_factor (0.5) of
each head, a q|k|v bias, RMSNorm, an untied head, and gate|up fused in
one ``gate_up_proj`` tensor, split at load.
"""

from typing import List, Tuple

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class GlmForCausalLM(LlamaForCausalLM):
    attention_bias = True
    rope_style = "gptj"

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        return [m for m in super().hf_param_mappings()
                if m[1] not in ("layers.gate", "layers.up")]

    def hf_split_mappings(self):
        F = self.intermediate_size
        return [
            ("model.layers.{i}.mlp.gate_up_proj.weight",
             [("layers.gate", 0, F), ("layers.up", F, 2 * F)], True),
        ]
