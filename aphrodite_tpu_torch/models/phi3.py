"""Phi-3 mini and medium (counterpart of aphrodite_tpu/models/phi3.py:
Phi3ForCausalLM).

The Llama body with fused checkpoint tensors: ``qkv_proj`` splits into
wq | wk | wv and ``gate_up_proj`` into gate | up at load
(``hf_split_mappings``, loader/weights.py), and the config's window on
every layer (Phi-3-mini-4k: 2047 keys). The 128k models scale RoPE by
"longrope" (models/layers.py: compute_rope_tables). Quantized Phi-3
checkpoints raise in the quantized loader, as every model with split
mappings does.
"""

from typing import List, Tuple

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class Phi3ForCausalLM(LlamaForCausalLM):

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        fused = {"layers.wq", "layers.wk", "layers.wv", "layers.gate",
                 "layers.up"}
        return [m for m in super().hf_param_mappings()
                if m[1] not in fused]

    def hf_split_mappings(
            self) -> List[Tuple[str, List[Tuple[str, int, int]], bool]]:
        NH, NKV, D = self.num_heads, self.num_kv_heads, self.head_dim
        F = self.intermediate_size
        q_end = NH * D
        k_end = q_end + NKV * D
        v_end = k_end + NKV * D
        return [
            ("model.layers.{i}.self_attn.qkv_proj.weight",
             [("layers.wq", 0, q_end), ("layers.wk", q_end, k_end),
              ("layers.wv", k_end, v_end)], True),
            ("model.layers.{i}.mlp.gate_up_proj.weight",
             [("layers.gate", 0, F), ("layers.up", F, 2 * F)], True),
        ]
