"""Falcon (counterpart of aphrodite_tpu/models/falcon.py:
FalconForCausalLM, which also serves RWForCausalLM): three decoder
styles behind one class, each a choice of the Llama body's hooks, with
LayerNorm, the plain MLP with exact GELU and a tied LM head.

- 7B: multi-query (one kv head: Falcon-7B's 71 query heads share it, a
  QH/KV the attention kernels take above 16 in forms of their own), a
  parallel residual from ONE input LayerNorm (``single_norm``), the fused
  query_key_value stored [Q (all heads) | K | V].
- 40B / 180B (``new_decoder_architecture``): grouped-query, a parallel
  residual with separate ``ln_attn`` / ``ln_mlp``, the fused tensor stored
  per kv group [q_1 .. q_g | k | v].
- RW (legacy): multi-head, sequential residual, the fused tensor
  head-interleaved as in Bloom (NeoX style), optional ALiBi with Bloom's
  slope schedule.

The fused tensor is loaded whole and split in ``finalize_params``. The
``bias`` flag of a config is not read, as in the JAX package: no bias
tensor has a mapping, so a checkpoint's biases are skipped.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.bloom import split_head_major_qkv
from aphrodite_tpu_torch.models.layers import get_alibi_slopes
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class FalconForCausalLM(LlamaForCausalLM):
    norm_type = "layernorm"
    gated_mlp = False
    ungated_act = "gelu"
    tie_word_embeddings_default = True
    splits_fused_tensors = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        heads = int(hf.get("num_attention_heads") or hf.get("n_head"))
        self.new_arch = bool(hf.get("new_decoder_architecture"))
        if self.new_arch:
            kv = int(hf.get("num_kv_heads") or heads)
        elif hf.get("multi_query", True):
            kv = 1
        else:
            kv = heads
        hf.setdefault("num_key_value_heads", kv)
        hf.setdefault("intermediate_size", 4 * int(hf["hidden_size"]))
        hf.setdefault("rms_norm_eps", hf.get("layer_norm_epsilon", 1e-5))
        self.parallel_residual = self.new_arch or bool(
            hf.get("parallel_attn", True))
        self.single_norm = self.parallel_residual and not self.new_arch
        alibi = bool(hf.get("alibi"))
        if alibi:
            self.use_rope = False
        super().__init__(model_config, device)
        if alibi:
            self.alibi_slopes = torch.from_numpy(
                get_alibi_slopes(heads)).to(device)

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        h = "transformer.h.{i}."
        ln_in = "ln_attn" if self.new_arch else "input_layernorm"
        maps = [
            (h + ln_in + ".weight", "layers.input_norm", False),
            (h + ln_in + ".bias", "layers.input_norm_b", False),
            (h + "self_attention.dense.weight", "layers.wo", True),
            (h + "mlp.dense_h_to_4h.weight", "layers.fc1", True),
            (h + "mlp.dense_4h_to_h.weight", "layers.fc2", True),
        ]
        if not self.single_norm:
            ln_post = ("ln_mlp" if self.new_arch
                       else "post_attention_layernorm")
            maps += [
                (h + ln_post + ".weight", "layers.post_norm", False),
                (h + ln_post + ".bias", "layers.post_norm_b", False),
            ]
        return maps

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        return [
            ("transformer.word_embeddings.weight", "embed", False),
            ("transformer.ln_f.weight", "final_norm", False),
            ("transformer.ln_f.bias", "final_norm_b", False),
        ]

    def hf_split_mappings(self):
        NH, KV, D = self.num_heads, self.num_kv_heads, self.head_dim
        if self.new_arch:
            width = KV * (NH // KV + 2) * D
        else:
            width = (NH + 2) * D if KV == 1 else 3 * NH * D
        return [
            ("transformer.h.{i}.self_attention.query_key_value.weight",
             [("layers.qkv_fused", 0, width)], True),
        ]

    def finalize_params(self, params: Dict[str, Any]) -> None:
        """The fused query_key_value [L, H, width] split into wq, wk, wv by
        the decoder style's layout."""
        lay = params["layers"]
        if "qkv_fused" not in lay:
            return
        NH, KV, D = self.num_heads, self.num_kv_heads, self.head_dim
        w = lay.pop("qkv_fused")
        L, H = w.shape[0], w.shape[1]
        if self.new_arch:
            g = NH // KV
            w = w.reshape(L, H, KV, g + 2, D)
            wq = w[:, :, :, :g, :].reshape(L, H, NH * D)
            wk = w[:, :, :, g, :].reshape(L, H, KV * D)
            wv = w[:, :, :, g + 1, :].reshape(L, H, KV * D)
        elif KV == 1:
            wq = w[..., :NH * D]
            wk = w[..., NH * D:(NH + 1) * D]
            wv = w[..., (NH + 1) * D:]
        else:  # legacy MHA: head-interleaved, as Bloom's
            wq, wk, wv = split_head_major_qkv(w, NH, D)
        lay["wq"], lay["wk"], lay["wv"] = (
            t.contiguous() for t in (wq, wk, wv))
