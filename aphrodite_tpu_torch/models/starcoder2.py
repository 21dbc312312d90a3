"""StarCoder2 (counterpart of aphrodite_tpu/models/starcoder2.py:
Starcoder2ForCausalLM): the Llama names and rotary with biases on q|k|v,
the output projection and the plain MLP (``c_fc``, ``c_proj``, tanh-GELU),
LayerNorms with bias, the config's sliding window, and a head tied by
default.
"""

from aphrodite_tpu_torch.models.llama import LlamaForCausalLM


class Starcoder2ForCausalLM(LlamaForCausalLM):
    attention_bias = True
    o_proj_bias = True
    norm_type = "layernorm"
    gated_mlp = False
    mlp_bias = True
    tie_word_embeddings_default = True
