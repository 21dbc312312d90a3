"""Baichuan / Baichuan2 (counterpart of aphrodite_tpu/models/baichuan.py).

The Llama topology with q|k|v fused into one ``W_pack`` tensor in the
checkpoint, split at load (``hf_split_mappings``). ``BaiChuanForCausalLM``
(Baichuan-7B, Baichuan2-7B) keeps rotary positions; ``BaichuanForCausalLM``
(Baichuan-13B, Baichuan2-13B) uses ALiBi unless hidden == 4096: no rotary
tables, and Bloom's slope schedule (models/layers.py: get_alibi_slopes)
handed to both attention kernels. Baichuan2 checkpoints (a 125,696-token
vocabulary) L2-normalize each row of the LM head at load (NormHead).
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.layers import get_alibi_slopes
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM

# Baichuan2's vocabulary; Baichuan1 has 64,000 tokens.
_BAICHUAN2_VOCAB = 125696


class BaiChuanForCausalLM(LlamaForCausalLM):
    """Baichuan-7B (and Baichuan2-7B): rotary positions."""

    position_embedding = "ROPE"

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        alibi = self.position_embedding == "ALIBI"
        if alibi:
            self.use_rope = False
        super().__init__(model_config, device)
        if alibi:
            self.alibi_slopes = torch.from_numpy(
                get_alibi_slopes(self.num_heads)).to(device)

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        skip = {"layers.wq", "layers.wk", "layers.wv"}
        return [m for m in super().hf_param_mappings() if m[1] not in skip]

    def hf_split_mappings(self):
        # W_pack is [Q all | K all | V all] along its output rows.
        q = self.num_heads * self.head_dim
        k = self.num_kv_heads * self.head_dim
        return [("model.layers.{i}.self_attn.W_pack.weight",
                 [("layers.wq", 0, q), ("layers.wk", q, q + k),
                  ("layers.wv", q + k, q + 2 * k)], True)]

    def finalize_params(self, params: Dict[str, Any]) -> None:
        if self.vocab_size == _BAICHUAN2_VOCAB and "lm_head" in params:
            # Baichuan2 NormHead: each vocab row over its L2 norm. The
            # head is stored [H, V], so the norm runs along axis 0. numpy
            # on the JAX package's memory order (the transposed view of
            # the checkpoint's [V, H]), so the sums and the bytes are its.
            head = np.asfortranarray(params["lm_head"].float().numpy())
            norm = np.linalg.norm(head, axis=0, keepdims=True)
            params["lm_head"] = torch.from_numpy(
                head / np.maximum(norm, 1e-12)).contiguous()


class BaichuanForCausalLM(BaiChuanForCausalLM):
    """Baichuan-13B and Baichuan2-7B/13B: ALiBi unless hidden == 4096."""

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hidden = model_config.get_hidden_size()
        self.position_embedding = "ROPE" if hidden == 4096 else "ALIBI"
        super().__init__(model_config, device)
