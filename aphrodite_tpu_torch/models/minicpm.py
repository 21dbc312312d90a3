"""MiniCPM (counterpart of aphrodite_tpu/models/minicpm.py:
MiniCPMForCausalLM, MiniCPM3ForCausalLM).

MiniCPM (1.2B, 2.4B and the MoE 8x2B) is the Llama body with muP scales:
embeddings times ``scale_emb`` (``embedding_multiplier``), both residual
branches times scale_depth / sqrt(L) (``residual_multiplier``) and the
logits times dim_model_base / hidden (``logit_scale``). Its MoE variant
(``num_experts`` > 0, the registry's ``minicpm_class``) takes Mixtral's
softmax top-k routing, renormalized, over experts named
``mlp.experts.{e}.w1/w2/w3`` with the router ``mlp.gate``.

MiniCPM3 (4B) is the DeepSeek body's multi-head latent attention on the
dense stack (models/deepseek.py) with the same muP scales, and NeoX
pairing for its rotary unless the config sets ``rope_interleave``.
"""

import math
from typing import List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.deepseek import DeepseekV3ForCausalLM
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.models.mixtral import MixtralForCausalLM


def set_mup_scales(model, model_config: ModelConfig) -> None:
    """The muP scales of MiniCPM's config on ``model``, before the body's
    __init__ makes its scale tensors from them."""
    hf = model_config.hf_config
    model.embedding_multiplier = float(hf.get("scale_emb", 1.0))
    model.residual_multiplier = (float(hf.get("scale_depth", 1.0))
                                 / math.sqrt(model_config.get_num_layers()))
    base = float(hf.get("dim_model_base")
                 or model_config.get_hidden_size())
    model.logit_scale = base / model_config.get_hidden_size()


class MiniCPMForCausalLM(LlamaForCausalLM):

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        set_mup_scales(self, model_config)
        super().__init__(model_config, device)


class MiniCPMMoEForCausalLM(MixtralForCausalLM):
    """MiniCPM's MoE variant (MiniCPM-MoE-8x2B): the Mixtral MLP on the
    muP-scaled body, its experts and router under MiniCPM's names."""

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        set_mup_scales(self, model_config)
        super().__init__(model_config, device)
        hf = model_config.hf_config
        self.num_experts = int(hf["num_experts"])
        self.top_k = int(hf.get("num_experts_per_tok") or 0)

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [m for m in LlamaForCausalLM.hf_param_mappings(self)
                if m[1] not in ("layers.gate", "layers.up", "layers.down")]
        maps.append(("model.layers.{i}.mlp.gate.weight", "layers.router",
                     True))
        return maps

    def hf_expert_mappings(self) -> List[Tuple[str, str, bool]]:
        p = "model.layers.{i}.mlp.experts.{e}"
        return [(f"{p}.w1.weight", "layers.w1", True),
                (f"{p}.w3.weight", "layers.w3", True),
                (f"{p}.w2.weight", "layers.w2", True)]


def minicpm_class(hf_config) -> type:
    """MiniCPMForCausalLM's class for a config: the MoE variant where it
    names experts, as the JAX class switches on ``num_experts``."""
    if int(hf_config.get("num_experts") or 0):
        return MiniCPMMoEForCausalLM
    return MiniCPMForCausalLM


class MiniCPM3ForCausalLM(DeepseekV3ForCausalLM):
    """MiniCPM3-4B: multi-head latent attention with low-rank q and kv
    projections, every layer a dense SwiGLU MLP, the muP scales, and NeoX
    rotary pairing unless the config sets ``rope_interleave`` (DeepSeek's
    default is the interleaved one)."""

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        set_mup_scales(self, model_config)
        super().__init__(model_config, device)
        if "rope_interleave" not in model_config.hf_config:
            self.rope_interleave = False
