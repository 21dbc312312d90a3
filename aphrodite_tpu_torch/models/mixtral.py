"""Mixtral (counterpart of aphrodite_tpu/models/mixtral.py:
MixtralForCausalLM), and the MoE body the other MoE models build on.

Attention is Llama's. The MLP is a top-k routed mixture of SwiGLU
experts (ops/moe.py): the router [L, H, E] and the expert stacks w1
(gate) and w3 (up) [L, E, H, F] and w2 (down) [L, E, F, H], read from
the checkpoint per (layer, expert) through ``hf_expert_mappings``.
``quantizable_weights`` are the attention projections (gptq, int8 and fp8
quantize those at load); ``expert_weights`` are the expert stacks, which
experts_int8 quantizes to {q int8, scale f32} and the MLP dequantizes one
layer at a time.

The grouped product takes its capacity form in pure-decode steps (the
batch has no ``cu_q_lens``: the decode windows, whose CUDA graphs read
no host value) and in steps of at most ops/moe.py's CAPACITY_MAX_T
tokens, its loop form in the other eager steps. ``forward`` notes which
before the layers run; it is fixed by the batch's static shape.
"""

from typing import Any, Dict, List, Optional, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.ops.moe import (CAPACITY_MAX_T, apply_experts,
                                         router_logits, topk_routing)


def layer_experts(w, layer: int):
    """One layer of a layer-stacked expert stack or experts_int8
    container (views, nothing copied)."""
    if isinstance(w, dict):
        return {k: v[layer] for k, v in w.items()}
    return w[layer]


class MixtralForCausalLM(LlamaForCausalLM):
    # Top-k weights renormalized to sum 1 (Mixtral); the Qwen MoE models
    # and OLMoE read norm_topk_prob.
    renormalize: bool = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        super().__init__(model_config, device)
        hf = model_config.hf_config
        self.num_experts = int(hf.get("num_local_experts", 8))
        self.top_k = int(hf.get("num_experts_per_tok", 2))
        self.experts_quantized = model_config.quantization == "experts_int8"
        # Whether the forward under way is a pure-decode step.
        self._decode_step = False

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        L, H, F, E = (self.num_layers, self.hidden_size,
                      self.intermediate_size, self.num_experts)
        layers = shapes["layers"]
        for k in ("gate", "up", "down"):
            layers.pop(k)
        layers["router"] = (L, H, E)
        layers["w1"] = (L, E, H, F)
        layers["w3"] = (L, E, H, F)
        layers["w2"] = (L, E, F, H)
        return shapes

    def quantizable_weights(self) -> List[str]:
        return ["layers.wq", "layers.wk", "layers.wv", "layers.wo"]

    def expert_weights(self) -> List[str]:
        return ["layers.w1", "layers.w3", "layers.w2"]

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [m for m in super().hf_param_mappings()
                if m[1] not in ("layers.gate", "layers.up", "layers.down")]
        maps.append(("model.layers.{i}.block_sparse_moe.gate.weight",
                     "layers.router", True))
        return maps

    def hf_expert_mappings(self) -> List[Tuple[str, str, bool]]:
        p = "model.layers.{i}.block_sparse_moe.experts.{e}"
        return [(f"{p}.w1.weight", "layers.w1", True),
                (f"{p}.w3.weight", "layers.w3", True),
                (f"{p}.w2.weight", "layers.w2", True)]

    def mlp_workspace_bytes(self, max_tokens: int, max_seqs: int) -> int:
        """The grouped product's buffers at the largest decode bucket
        (capacity form: E rows a token) or the largest step (loop form:
        k rows a token), and with experts_int8 one layer's three stacks
        dequantized plus the f32 product of one."""
        E, H, F, k = (self.num_experts, self.hidden_size,
                      self.intermediate_size, self.top_k)
        item = self.dtype.itemsize
        capacity = (E * max(max_seqs, CAPACITY_MAX_T)
                    * (H * (item + 8) + F * (12 + item)))
        loop = max_tokens * k * (H * (item + 12) + F * (12 + item))
        experts = E * H * F * (3 * item + 4) if self.experts_quantized else 0
        return max(capacity, loop) + experts

    def forward(self, params: Dict[str, Any], kv_cache: torch.Tensor,
                batch: ForwardBatch,
                kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        self._decode_step = batch.cu_q_lens is None
        return super().forward(params, kv_cache, batch, kv_scales)

    def route(self, router: torch.Tensor,
              h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights f32[T, k], expert_ids i32[T, k]) of the tokens h [T, H]
        under one layer's router [H, E]: softmax, top k, renormalized
        with ``renormalize``."""
        return topk_routing(router_logits(h, router), self.top_k,
                            self.renormalize)

    def mlp(self, lp: Dict[str, Any], h: torch.Tensor,
            layer: int) -> torch.Tensor:
        weights, ids = self.route(lp["router"][layer], h)
        return apply_experts(h, *(layer_experts(lp[n], layer)
                                  for n in ("w1", "w3", "w2")),
                             weights, ids, decode=self._decode_step)
