"""Qwen3-MoE (counterpart of aphrodite_tpu/models/qwen3_moe.py:
Qwen3MoeForCausalLM): Qwen3's per-head q/k RMSNorm with Mixtral's
experts (models/mixtral.py), under the checkpoint's ``mlp`` names. The
router's softmax over all experts is renormalized over the top k only
with ``norm_topk_prob``. Configs that mix dense and sparse layers
(``mlp_only_layers``, ``decoder_sparse_step`` other than 1) raise, as in
the JAX package.
"""

from typing import List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.mixtral import MixtralForCausalLM
from aphrodite_tpu_torch.models.qwen3 import Qwen3ForCausalLM


def moe_config(hf, default_experts: int, family: str) -> None:
    """The JAX package's rewrites of a Qwen-style MoE config, in place: the
    experts' width from moe_intermediate_size, their count from
    num_experts; dense/sparse layer mixing raises."""
    if hf.get("mlp_only_layers") or \
            int(hf.get("decoder_sparse_step", 1) or 1) != 1:
        raise NotImplementedError(
            f"{family} dense/sparse layer mixing not supported yet")
    hf["intermediate_size"] = int(
        hf.get("moe_intermediate_size") or hf["intermediate_size"])
    hf.setdefault("num_local_experts", hf.get("num_experts",
                                              default_experts))


def mlp_experts(maps: List[Tuple[str, str, bool]]
                ) -> List[Tuple[str, str, bool]]:
    """Mixtral's mappings with the router read from ``mlp.gate``."""
    return [("model.layers.{i}.mlp.gate.weight" if path == "layers.router"
             else template, path, transpose)
            for template, path, transpose in maps]


def mlp_expert_mappings() -> List[Tuple[str, str, bool]]:
    p = "model.layers.{i}.mlp.experts.{e}"
    return [(f"{p}.gate_proj.weight", "layers.w1", True),
            (f"{p}.up_proj.weight", "layers.w3", True),
            (f"{p}.down_proj.weight", "layers.w2", True)]


class Qwen3MoeForCausalLM(Qwen3ForCausalLM, MixtralForCausalLM):

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        moe_config(hf, 8, "qwen3-moe")
        super().__init__(model_config, device)
        self.renormalize = bool(hf.get("norm_topk_prob", False))

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        return mlp_experts(super().hf_param_mappings())

    def hf_expert_mappings(self) -> List[Tuple[str, str, bool]]:
        return mlp_expert_mappings()
