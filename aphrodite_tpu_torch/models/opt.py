"""OPT (counterpart of aphrodite_tpu/models/opt.py: OPTForCausalLM):
learned absolute positions with OPT's offset of 2 (the table keeps two
rows before position 0), LayerNorms with bias, biases everywhere, a ReLU
MLP and a head tied to the token embeddings. OPT-350m's quirks as there:
``do_layer_norm_before`` false puts each LayerNorm after its residual add
and drops the final norm (the Llama body's ``postnorm_residual`` and
``skip_final_norm``), and a ``word_embed_proj_dim`` other than hidden folds
``project_in`` into the embedding table and ``project_out`` into an untied
head at load (plain products, so the fold is exact in f32); the raw
tensors stay in the tree, as there. The config's ``ffn_dim`` is read as
intermediate_size (common/config.py: fill_family_keys).
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class OPTForCausalLM(LlamaForCausalLM):
    attention_bias = True
    o_proj_bias = True
    norm_type = "layernorm"
    gated_mlp = False
    mlp_bias = True
    ungated_act = "relu"
    use_rope = False
    learned_positions = True
    pos_offset = 2
    tie_word_embeddings_default = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        self.postnorm_residual = not hf.get("do_layer_norm_before", True)
        self.skip_final_norm = self.postnorm_residual
        self.word_dim = int(hf.get("word_embed_proj_dim",
                                   hf["hidden_size"]))
        self.has_word_proj = self.word_dim != int(hf["hidden_size"])
        super().__init__(model_config, device)
        if self.has_word_proj:
            # The head is project_out folded into the embeddings, no
            # longer the table itself.
            self.tie_word_embeddings = False

    def param_shapes(self) -> Dict[str, Any]:
        shapes = super().param_shapes()
        if self.has_word_proj:
            V, H, W = self.vocab_size, self.hidden_size, self.word_dim
            shapes.update(embed=(V, H), lm_head=(H, V), embed_raw=(V, W),
                          proj_in=(W, H), proj_out=(H, W))
        return shapes

    def finalize_params(self, params: Dict[str, Any]) -> None:
        if not self.has_word_proj or "embed_raw" not in params:
            return
        raw = params["embed_raw"].float()
        params["embed"] = (raw @ params["proj_in"].float()).contiguous()
        params["lm_head"] = (params["proj_out"].float() @ raw.t()).contiguous()

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        d = "model.decoder.layers.{i}."
        maps = [
            (d + "self_attn_layer_norm.weight", "layers.input_norm", False),
            (d + "self_attn_layer_norm.bias", "layers.input_norm_b", False),
            (d + "final_layer_norm.weight", "layers.post_norm", False),
            (d + "final_layer_norm.bias", "layers.post_norm_b", False),
            (d + "self_attn.out_proj.weight", "layers.wo", True),
            (d + "self_attn.out_proj.bias", "layers.bo", False),
            (d + "fc1.weight", "layers.fc1", True),
            (d + "fc1.bias", "layers.fc1_b", False),
            (d + "fc2.weight", "layers.fc2", True),
            (d + "fc2.bias", "layers.fc2_b", False),
        ]
        for n in "qkv":
            maps += [(d + f"self_attn.{n}_proj.weight", f"layers.w{n}", True),
                     (d + f"self_attn.{n}_proj.bias", f"layers.b{n}", False)]
        return maps

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        d = "model.decoder."
        maps = [(d + "embed_positions.weight", "embed_pos", False)]
        if self.has_word_proj:
            maps += [(d + "embed_tokens.weight", "embed_raw", False),
                     (d + "project_in.weight", "proj_in", True),
                     (d + "project_out.weight", "proj_out", True)]
        else:
            maps.append((d + "embed_tokens.weight", "embed", False))
        if not self.skip_final_norm:
            maps += [(d + "final_layer_norm.weight", "final_norm", False),
                     (d + "final_layer_norm.bias", "final_norm_b", False)]
        return maps
