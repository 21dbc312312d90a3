"""Gemma, Gemma2 and Gemma3 (counterpart of aphrodite_tpu/models/gemma.py).

- Gemma: the Llama body with (1 + w) RMSNorm weights, token embeddings
  times sqrt(hidden) in the model dtype, a GeGLU MLP (the tanh form) and
  a tied LM head.
- Gemma2 adds sandwich norms (``post_attn_norm`` after attention,
  ``post_norm`` before the MLP, ``post_ff_norm`` after it), the attention
  scale query_pre_attn_scalar ** -0.5, the attention and final-logit soft
  caps, and local (sliding-window) layers beside global ones: those of
  the config's ``layer_types`` marked "sliding_attention", else the even
  layers. The JAX package picks a layer's attention with a ``lax.cond``
  on a scanned flag; here each layer's window is a Python value
  (``layer_windows``), which the decode window's CUDA graph captures as
  it stands.
- Gemma3 (text): Gemma2's layout without soft caps, the local layers
  rotated by their own table (``rope_local_base_freq``, no scaling), and
  a (1 + w) RMSNorm of q and k over head_dim through the ``qk_norm``
  hook.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.layers import compute_rope_tables, rms_norm
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class GemmaForCausalLM(LlamaForCausalLM):
    tie_word_embeddings_default = True
    norm_weight_offset = 1.0
    scale_embeddings = True
    hidden_act = "gelu_tanh"


class Gemma2ForCausalLM(GemmaForCausalLM):

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        super().__init__(model_config, device)
        hf = model_config.hf_config
        self.logit_softcap = float(hf.get("final_logit_softcapping") or 0.0)
        self.attn_softcap = float(hf.get("attn_logit_softcapping") or 0.0)
        qs = hf.get("query_pre_attn_scalar")
        if qs:
            self.sm_scale = float(qs)**-0.5
        window = hf.get("sliding_window", 4096)
        self.sliding_window = None  # per layer, not global
        self.local_layers = self._local_layer_mask()
        self.layer_windows = [window if local else None
                              for local in self.local_layers]

    def _local_layer_mask(self) -> List[bool]:
        layer_types = self.config.hf_config.get("layer_types")
        if layer_types:
            return [t == "sliding_attention" for t in layer_types]
        return [i % 2 == 0 for i in range(self.num_layers)]

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        L, H = self.num_layers, self.hidden_size
        shapes["layers"]["post_attn_norm"] = (L, H)
        shapes["layers"]["post_ff_norm"] = (L, H)
        return shapes

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        # HF Gemma2 names: post_attention_layernorm is the norm after the
        # attention block; pre/post_feedforward_layernorm wrap the MLP.
        la = "model.layers.{i}."
        maps = [m for m in super().hf_param_mappings()
                if m[0] != la + "post_attention_layernorm.weight"]
        return maps + [
            (la + "post_attention_layernorm.weight", "layers.post_attn_norm",
             False),
            (la + "pre_feedforward_layernorm.weight", "layers.post_norm",
             False),
            (la + "post_feedforward_layernorm.weight", "layers.post_ff_norm",
             False),
        ]


class Gemma3ForCausalLM(Gemma2ForCausalLM):

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        super().__init__(model_config, device)
        hf = model_config.hf_config
        self.logit_softcap = 0.0
        self.attn_softcap = 0.0
        # Local layers: their own base and no scaling; the global table
        # keeps rope_theta and any rope_scaling.
        self._cos_local, self._sin_local = compute_rope_tables(
            self.head_dim, self.max_position,
            base=float(hf.get("rope_local_base_freq", 10000.0)),
            rope_scaling=None, device=device)
        self.local_rope_layers = self.local_layers

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        L, D = self.num_layers, self.head_dim
        shapes["layers"]["q_norm"] = (L, D)
        shapes["layers"]["k_norm"] = (L, D)
        return shapes

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        return super().hf_param_mappings() + [
            ("model.layers.{i}.self_attn.q_norm.weight", "layers.q_norm",
             False),
            ("model.layers.{i}.self_attn.k_norm.weight", "layers.k_norm",
             False),
        ]

    def qk_norm(self, q: torch.Tensor, k: torch.Tensor, lp: Dict[str, Any],
                layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return (rms_norm(q, lp["q_norm"][layer] + 1.0, self.rms_eps),
                rms_norm(k, lp["k_norm"][layer] + 1.0, self.rms_eps))
