"""Nemotron (counterpart of aphrodite_tpu/models/nemotron.py:
NemotronForCausalLM): LayerNorm1p (LayerNorms with bias whose weight
enters as 1 + w: ``norm_weight_offset``), the plain MLP with squared ReLU
and no bias (``up_proj``, ``down_proj``), partial rotary, an untied head.
The config's ``norm_eps`` is read as rms_norm_eps (common/config.py:
fill_family_keys).
"""

from typing import List, Tuple

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class NemotronForCausalLM(LlamaForCausalLM):
    norm_type = "layernorm"
    norm_weight_offset = 1.0
    gated_mlp = False
    ungated_act = "relu2"

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [m for m in super().hf_param_mappings()
                if not m[1].startswith("layers.fc")]
        return maps + [
            ("model.layers.{i}.mlp.up_proj.weight", "layers.fc1", True),
            ("model.layers.{i}.mlp.down_proj.weight", "layers.fc2", True),
        ]
