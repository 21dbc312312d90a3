"""BLOOM (counterpart of aphrodite_tpu/models/bloom.py: BloomForCausalLM).

ALiBi attention (no rotary tables; Bloom's slope schedule,
models/layers.py: get_alibi_slopes, handed to both attention kernels),
LayerNorm with bias everywhere and on the token embeddings
(``embedding_norm``), q|k|v and o-proj biases, the plain MLP with biases
and the tanh form of GELU, and a tied LM head. The checkpoint fuses q|k|v
into one ``query_key_value`` tensor, head-major ([NH, (q|k|v), D] along
its output rows, not [Q; K; V]), which ``finalize_params`` splits.
BloomConfig names its sizes n_head and n_layer and gives no
intermediate_size (4 x hidden).
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.layers import get_alibi_slopes
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM

def split_head_major_qkv(w: torch.Tensor, num_heads: int,
                         head_dim: int) -> Tuple[torch.Tensor, ...]:
    """q, k and v of a fused [..., NH * 3 * D] tensor stored head-major
    ([NH, (q|k|v), D] on its last axis), each [..., NH * D] and
    contiguous."""
    lead = w.shape[:-1]
    w = w.reshape(*lead, num_heads, 3, head_dim)
    return tuple(w[..., i, :].reshape(*lead, num_heads * head_dim)
                 .contiguous() for i in range(3))


def finalize_head_major_qkv(params: Dict[str, Any], num_heads: int,
                            head_dim: int) -> None:
    """The head-major fused q|k|v of a loaded tree (``qkv_fused`` and its
    bias ``qkv_fused_b``) split in place into wq, wk, wv (bq, bk, bv):
    Bloom's, GPT-NeoX's and Persimmon's ``finalize_params``."""
    lay = params["layers"]
    if "qkv_fused" not in lay:
        return
    lay["wq"], lay["wk"], lay["wv"] = split_head_major_qkv(
        lay.pop("qkv_fused"), num_heads, head_dim)
    lay["bq"], lay["bk"], lay["bv"] = split_head_major_qkv(
        lay.pop("qkv_fused_b"), num_heads, head_dim)


class BloomForCausalLM(LlamaForCausalLM):
    attention_bias = True
    o_proj_bias = True
    norm_type = "layernorm"
    gated_mlp = False
    mlp_bias = True
    use_rope = False
    embedding_norm = True
    tie_word_embeddings_default = True
    splits_fused_tensors = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        hf.setdefault("num_attention_heads", hf.get("n_head"))
        hf.setdefault("intermediate_size", 4 * int(hf["hidden_size"]))
        hf.setdefault("rms_norm_eps", hf.get("layer_norm_epsilon", 1e-5))
        super().__init__(model_config, device)
        self.alibi_slopes = torch.from_numpy(
            get_alibi_slopes(self.num_heads)).to(device)

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        h = "transformer.h.{i}."
        return [
            (h + "input_layernorm.weight", "layers.input_norm", False),
            (h + "input_layernorm.bias", "layers.input_norm_b", False),
            (h + "self_attention.dense.weight", "layers.wo", True),
            (h + "self_attention.dense.bias", "layers.bo", False),
            (h + "post_attention_layernorm.weight", "layers.post_norm",
             False),
            (h + "post_attention_layernorm.bias", "layers.post_norm_b",
             False),
            (h + "mlp.dense_h_to_4h.weight", "layers.fc1", True),
            (h + "mlp.dense_h_to_4h.bias", "layers.fc1_b", False),
            (h + "mlp.dense_4h_to_h.weight", "layers.fc2", True),
            (h + "mlp.dense_4h_to_h.bias", "layers.fc2_b", False),
        ]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("transformer.word_embeddings.weight", "embed", False),
            ("transformer.word_embeddings_layernorm.weight", "embed_norm",
             False),
            ("transformer.word_embeddings_layernorm.bias", "embed_norm_b",
             False),
            ("transformer.ln_f.weight", "final_norm", False),
            ("transformer.ln_f.bias", "final_norm_b", False),
        ]

    def hf_split_mappings(self):
        H = self.hidden_size
        return [
            ("transformer.h.{i}.self_attention.query_key_value.weight",
             [("layers.qkv_fused", 0, 3 * H)], True),
            ("transformer.h.{i}.self_attention.query_key_value.bias",
             [("layers.qkv_fused_b", 0, 3 * H)], False),
        ]

    def finalize_params(self, params: Dict[str, Any]) -> None:
        finalize_head_major_qkv(params, self.num_heads, self.head_dim)
