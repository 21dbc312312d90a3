"""InternLM2 / InternLM2.5 (counterpart of
aphrodite_tpu/models/internlm2.py: InternLM2ForCausalLM): the Llama
arithmetic under its own names (``attention_norm``, ``ffn_norm``,
``feed_forward.w1`` the gate, ``w3`` the up projection, ``w2``,
``tok_embeddings``, ``output``). q, k and v come fused in one grouped
``attention.wqkv``: per kv head, its q_per_kv query heads, then its K,
then its V ([KV, q_per_kv + 2, D] on the output rows); ``finalize_params``
takes them apart.
"""

from typing import Any, Dict, List, Tuple

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class InternLM2ForCausalLM(LlamaForCausalLM):
    splits_fused_tensors = True

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        p = "model.layers.{i}."
        return [
            (p + "attention_norm.weight", "layers.input_norm", False),
            (p + "attention.wo.weight", "layers.wo", True),
            (p + "ffn_norm.weight", "layers.post_norm", False),
            (p + "feed_forward.w1.weight", "layers.gate", True),
            (p + "feed_forward.w3.weight", "layers.up", True),
            (p + "feed_forward.w2.weight", "layers.down", True),
        ]

    def hf_split_mappings(self):
        width = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        return [("model.layers.{i}.attention.wqkv.weight",
                 [("layers.qkv_fused", 0, width)], True)]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [("model.tok_embeddings.weight", "embed", False),
                ("model.norm.weight", "final_norm", False)]
        if not self.tie_word_embeddings:
            maps.append(("output.weight", "lm_head", True))
        return maps

    def finalize_params(self, params: Dict[str, Any]) -> None:
        lay = params["layers"]
        if "qkv_fused" not in lay:
            return
        NH, KV, D = self.num_heads, self.num_kv_heads, self.head_dim
        g = NH // KV
        w = lay.pop("qkv_fused")  # [L, H, (NH + 2 KV) D]
        L, H = w.shape[0], w.shape[1]
        w = w.reshape(L, H, KV, g + 2, D)
        lay["wq"] = w[:, :, :, :g].reshape(L, H, NH * D).contiguous()
        lay["wk"] = w[:, :, :, g].reshape(L, H, KV * D).contiguous()
        lay["wv"] = w[:, :, :, g + 1].reshape(L, H, KV * D).contiguous()
