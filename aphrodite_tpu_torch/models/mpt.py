"""MPT (counterpart of aphrodite_tpu/models/mpt.py: MPTForCausalLM).

ALiBi attention with MPT's own slope schedule (``get_mpt_alibi_slopes``:
exponents spaced by alibi_bias_max over the head count rounded up to a
power of 2, the remainder interleaved), LayerNorms and Linears without
bias (``no_bias``), the contiguous fused ``Wqkv`` ([Q; K; V] along its
output rows, split at load), the plain MLP with exact GELU, and a tied LM
head. The config names its sizes d_model, n_heads and n_layers, and the
MLP width as expansion_ratio x d_model. clip_qkv and qk_ln are not read,
as in the JAX package (off in every released MPT checkpoint).
"""

import math
from typing import List, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


def get_mpt_alibi_slopes(num_heads: int,
                         alibi_bias_max: int = 8) -> np.ndarray:
    """MPT's ALiBi slopes: f32[num_heads], the same bytes as the JAX
    package's (a copy of aphrodite_tpu/models/mpt.py:
    get_mpt_alibi_slopes)."""
    n_p2 = 2 ** math.ceil(math.log2(num_heads))
    base = np.arange(1, n_p2 + 1, dtype=np.float64) * (
        alibi_bias_max / n_p2)
    slopes = 1.0 / np.power(2.0, base)
    if n_p2 != num_heads:
        slopes = np.concatenate([slopes[1::2], slopes[0::2]])[:num_heads]
    return slopes.astype(np.float32)


class MPTForCausalLM(LlamaForCausalLM):
    norm_type = "layernorm"
    norm_bias = False
    gated_mlp = False
    ungated_act = "gelu"
    use_rope = False
    tie_word_embeddings_default = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        ratio = hf.get("expansion_ratio", 4)
        hf.setdefault("intermediate_size",
                      int(ratio * int(hf.get("d_model")
                                      or hf["hidden_size"])))
        hf.setdefault("rms_norm_eps", hf.get("layer_norm_epsilon", 1e-5))
        super().__init__(model_config, device)
        attn_cfg = hf.get("attn_config") or {}
        if attn_cfg.get("alibi", True):
            self.alibi_slopes = torch.from_numpy(get_mpt_alibi_slopes(
                self.num_heads, int(attn_cfg.get("alibi_bias_max", 8)))
            ).to(device)

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        b = "transformer.blocks.{i}."
        return [
            (b + "norm_1.weight", "layers.input_norm", False),
            (b + "attn.out_proj.weight", "layers.wo", True),
            (b + "norm_2.weight", "layers.post_norm", False),
            (b + "ffn.up_proj.weight", "layers.fc1", True),
            (b + "ffn.down_proj.weight", "layers.fc2", True),
        ]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("transformer.wte.weight", "embed", False),
            ("transformer.norm_f.weight", "final_norm", False),
        ]

    def hf_split_mappings(self):
        H = self.hidden_size
        return [
            ("transformer.blocks.{i}.attn.Wqkv.weight",
             [("layers.wq", 0, H), ("layers.wk", H, 2 * H),
              ("layers.wv", 2 * H, 3 * H)], True),
        ]
