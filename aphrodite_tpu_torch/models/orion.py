"""Orion (counterpart of aphrodite_tpu/models/orion.py: OrionForCausalLM;
OrionStarAI Orion-14B): the Llama topology and names with LayerNorms that
carry a bias, at the config's ``rms_norm_eps``.
"""

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class OrionForCausalLM(LlamaForCausalLM):
    norm_type = "layernorm"
