"""Cohere Command-R and Command-R+ (counterpart of
aphrodite_tpu/models/cohere.py: CohereForCausalLM): the GPT-J
(interleaved) rotary, LayerNorms without bias, a parallel residual from
one LayerNorm (attention and the gated SiLU MLP both read it), a tied
head with the config's ``logit_scale``, and Command-R+'s ``use_qk_norm``:
a LayerNorm without bias over head_dim on each head of q and of k before
the rotation, with weights per head ([L, QH, D] and [L, KV, D]). The port
has no tensor parallelism, so the kv-head padding of the JAX model's
k_norm has no counterpart.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.layers import layer_norm
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class CohereForCausalLM(LlamaForCausalLM):
    norm_type = "layernorm"
    norm_bias = False
    parallel_residual = True
    single_norm = True
    rope_style = "gptj"
    tie_word_embeddings_default = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        self.use_qk_norm = bool(hf.get("use_qk_norm", False))
        self.logit_scale = float(hf.get("logit_scale", 1.0))
        super().__init__(model_config, device)

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        if self.use_qk_norm:
            L, D = self.num_layers, self.head_dim
            shapes["layers"]["q_norm"] = (L, self.num_heads, D)
            shapes["layers"]["k_norm"] = (L, self.num_kv_heads, D)
        return shapes

    def qk_norm(self, q: torch.Tensor, k: torch.Tensor, lp: Dict[str, Any],
                layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.use_qk_norm:
            return q, k
        return (layer_norm(q, lp["q_norm"][layer], eps=self.rms_eps),
                layer_norm(k, lp["k_norm"][layer], eps=self.rms_eps))

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        # Llama's names without post_attention_layernorm (one norm feeds
        # both branches).
        maps = [m for m in super().hf_param_mappings()
                if "post_attention_layernorm" not in m[0]]
        if self.use_qk_norm:
            maps += [("model.layers.{i}.self_attn.q_norm.weight",
                      "layers.q_norm", False),
                     ("model.layers.{i}.self_attn.k_norm.weight",
                      "layers.k_norm", False)]
        return maps
