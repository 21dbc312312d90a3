"""OLMo2 (counterpart of aphrodite_tpu/models/olmo2.py: Olmo2ForCausalLM;
OLMo-2-1124-7B and 13B): the Llama topology with RMSNorm on each block's
output before its residual add and none before the block (the Llama
body's ``branch_norms``: ``input_norm`` holds the checkpoint's
post_attention_layernorm and ``post_norm`` its post_feedforward_layernorm,
as in the JAX package), and q and k RMS-normalized over the whole
projection (``q_norm`` [L, QH * D], ``k_norm`` [L, KV * D]) before RoPE.
The body's ``qk_norm`` hook sees q and k already split into heads; a
norm over the flattened heads is the norm over the projection, as the
reshape is a view.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.models.layers import rms_norm
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class Olmo2ForCausalLM(LlamaForCausalLM):
    branch_norms = True

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        L, D = self.num_layers, self.head_dim
        shapes["layers"]["q_norm"] = (L, self.num_heads * D)
        shapes["layers"]["k_norm"] = (L, self.num_kv_heads * D)
        return shapes

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        la = "model.layers.{i}."
        maps = [m for m in super().hf_param_mappings()
                if m[0] not in (la + "input_layernorm.weight",
                                la + "post_attention_layernorm.weight")]
        return maps + [
            (la + "post_attention_layernorm.weight", "layers.input_norm",
             False),
            (la + "post_feedforward_layernorm.weight", "layers.post_norm",
             False),
            (la + "self_attn.q_norm.weight", "layers.q_norm", False),
            (la + "self_attn.k_norm.weight", "layers.k_norm", False),
        ]

    def qk_norm(self, q: torch.Tensor, k: torch.Tensor, lp: Dict[str, Any],
                layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return (rms_norm(q.flatten(1), lp["q_norm"][layer],
                         self.rms_eps).view(q.shape),
                rms_norm(k.flatten(1), lp["k_norm"][layer],
                         self.rms_eps).view(k.shape))
