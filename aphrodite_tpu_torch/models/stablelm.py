"""StableLM (counterpart of aphrodite_tpu/models/stablelm.py:
StableLmForCausalLM; StableLM-3B-4e1t, Zephyr, StableLM-2): the Llama
names and gated SiLU MLP with LayerNorms that carry a bias, partial
rotary, the q|k|v bias of ``use_qkv_bias`` and, where the config sets
``use_parallel_residual``, a parallel residual with two norms. The
Epoch configs' own keys (``norm_eps``, ``rope_pct``, ``use_qkv_bias``) are
read under the Llama body's names (common/config.py:
fill_family_keys). Also served as StableLMEpochForCausalLM and
StablelmForCausalLM.
"""

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class StableLmForCausalLM(LlamaForCausalLM):
    norm_type = "layernorm"

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        if model_config.hf_config.get("use_parallel_residual"):
            self.parallel_residual = True
        super().__init__(model_config, device)
