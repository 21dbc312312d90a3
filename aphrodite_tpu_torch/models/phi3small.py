"""Phi-3-Small (counterpart of aphrodite_tpu/models/phi3small.py:
Phi3SmallForCausalLM).

The Llama body with LayerNorm (and bias) everywhere, q|k|v, o-proj and
MLP biases, a tied LM head and muP scales: embeddings times
``mup_embedding_multiplier``, attention scale ``mup_attn_multiplier /
head_dim`` (not head_dim ** -0.5), logits over ``mup_width_multiplier``.
Attention is blocksparse (local blocks plus a vertical stride with a phase
per query head, handed to both attention kernels) except on every
``dense_attention_every_n_layers``-th layer. The MLP is gegelu: the fused
``up_proj`` interleaves its gelu (even) and linear (odd) output columns,
split at load; out = quick_gelu(min(g, limit)) * (clip(u, +-limit) + 1),
in f32. Tokens of ``dummy_token_indices`` get the mask value as logits.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.ops.decode_attention import MASK_VALUE


class Phi3SmallForCausalLM(LlamaForCausalLM):
    attention_bias = True
    o_proj_bias = True
    mlp_bias = True
    norm_type = "layernorm"
    tie_word_embeddings_default = True
    splits_fused_tensors = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        # Key aliases the Llama body reads.
        hf.setdefault("rms_norm_eps", hf.get("layer_norm_epsilon", 1e-5))
        hf.setdefault("rope_theta", hf.get("rope_embedding_base", 1e6))
        pos_scale = float(hf.get("rope_position_scale") or 1.0)
        rs = hf.get("rope_scaling")
        if rs is None:
            if pos_scale != 1.0:
                hf["rope_scaling"] = {"type": "linear", "factor": pos_scale}
        elif "factor" not in rs:
            rs["factor"] = pos_scale
        # Before the Llama body's __init__, which makes them tensors.
        self.embedding_multiplier = float(
            hf.get("mup_embedding_multiplier") or 1.0)
        self.logit_scale = 1.0 / float(hf.get("mup_width_multiplier") or 1.0)
        super().__init__(model_config, device)

        if hf.get("mup_use_scaling"):
            self.sm_scale = float(hf["mup_attn_multiplier"]) / self.head_dim
        self.gegelu_limit = hf.get("gegelu_limit")
        self.dummy_token_ids = [int(i) for i in
                                hf.get("dummy_token_indices") or []]
        # On the model's device once: indexing with the list in the
        # forward would copy it from the host, which a captured CUDA graph
        # cannot hold.
        self._dummy_index = torch.tensor(self.dummy_token_ids,
                                         dtype=torch.long, device=device)

        block = int(hf.get("blocksparse_block_size", 64))
        local = int(hf.get("blocksparse_num_local_blocks", 16))
        vert = int(hf.get("blocksparse_vert_stride", 8))
        homo = bool(hf.get("blocksparse_homo_head_pattern", False))
        step = 0 if homo else max(1, vert // self.num_heads)
        self.blocksparse_params = (block, local, vert)
        self.bs_head_offsets = (torch.arange(self.num_heads, dtype=torch.int32,
                                             device=device) * step)
        dense_every = hf.get("dense_attention_every_n_layers")
        if dense_every:
            self.bs_layer_mask = [(i + 1) % int(dense_every) != 0
                                  for i in range(self.num_layers)]

    # ---- loading ---------------------------------------------------------

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        la = "model.layers.{i}."
        return [
            (la + "input_layernorm.weight", "layers.input_norm", False),
            (la + "input_layernorm.bias", "layers.input_norm_b", False),
            (la + "post_attention_layernorm.weight", "layers.post_norm",
             False),
            (la + "post_attention_layernorm.bias", "layers.post_norm_b",
             False),
            (la + "self_attn.query_key_value.weight", "layers.qkv_fused",
             True),
            (la + "self_attn.query_key_value.bias", "layers.qkv_fused_b",
             False),
            (la + "self_attn.dense.weight", "layers.wo", True),
            (la + "self_attn.dense.bias", "layers.bo", False),
            (la + "mlp.up_proj.weight", "layers.gate_up_fused", True),
            (la + "mlp.up_proj.bias", "layers.gate_up_fused_b", False),
            (la + "mlp.down_proj.weight", "layers.down", True),
            (la + "mlp.down_proj.bias", "layers.down_b", False),
        ]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("model.embed_tokens.weight", "embed", False),
            ("model.final_layernorm.weight", "final_norm", False),
            ("model.final_layernorm.bias", "final_norm_b", False),
        ]

    def finalize_params(self, params: Dict[str, Any]) -> None:
        """Split the head-major query_key_value ([KV, g + 2, D] groups on
        the output axis: g query heads, then K, then V) into wq|wk|wv and
        their biases, and de-interleave up_proj (even columns gelu ->
        gate, odd columns linear -> up), byte for byte as the JAX
        package."""
        lay = params["layers"]
        if "qkv_fused" in lay:
            NH, KV, D = self.num_heads, self.num_kv_heads, self.head_dim
            g = NH // KV
            w = lay.pop("qkv_fused")  # [L, H, KV * (g + 2) * D]
            L, H = w.shape[0], w.shape[1]
            w = w.reshape(L, H, KV, g + 2, D)
            lay["wq"] = w[:, :, :, :g].reshape(L, H, NH * D).contiguous()
            lay["wk"] = w[:, :, :, g].reshape(L, H, KV * D).contiguous()
            lay["wv"] = w[:, :, :, g + 1].reshape(L, H, KV * D).contiguous()
            b = lay.pop("qkv_fused_b").reshape(L, KV, g + 2, D)
            lay["bq"] = b[:, :, :g].reshape(L, NH * D).contiguous()
            lay["bk"] = b[:, :, g].reshape(L, KV * D).contiguous()
            lay["bv"] = b[:, :, g + 1].reshape(L, KV * D).contiguous()
        if "gate_up_fused" in lay:
            w = lay.pop("gate_up_fused")  # [L, H, 2F], interleaved
            lay["gate"] = w[..., 0::2].contiguous()
            lay["up"] = w[..., 1::2].contiguous()
            b = lay.pop("gate_up_fused_b")
            lay["gate_b"] = b[..., 0::2].contiguous()
            lay["up_b"] = b[..., 1::2].contiguous()

    # ---- forward pieces --------------------------------------------------

    def mlp(self, lp: Dict[str, Any], h: torch.Tensor,
            layer: int) -> torch.Tensor:
        """gegelu in f32: min(g, limit), clip(u, +-limit), then
        g * sigmoid(1.702 g) * (u + 1), cast to the model dtype before
        the down projection."""
        g = self._linear(lp, h, ("gate",), ("gate_b",), layer).float()
        u = self._linear(lp, h, ("up",), ("up_b",), layer).float()
        if self.gegelu_limit is not None:
            limit = float(self.gegelu_limit)
            g = torch.clamp(g, max=limit)
            u = torch.clamp(u, -limit, limit)
        act = (g * torch.sigmoid(1.702 * g)) * (u + 1.0)
        return self._linear(lp, act.to(self.dtype), ("down",), ("down_b",),
                            layer)

    def compute_logits(self, params: Dict[str, Any],
                       hidden: torch.Tensor) -> torch.Tensor:
        logits = super().compute_logits(params, hidden)
        if self.dummy_token_ids:
            logits.index_fill_(1, self._dummy_index, MASK_VALUE)
        return logits
