"""Llama causal LM, dense and int4 weights (counterpart of
aphrodite_tpu/models/llama.py: LlamaForCausalLM).

The parameters keep the JAX package's layout: a plain dict of tensors,
matmul weights stored [in, out], per-layer weights stacked on a leading
[L] axis, q|k|v fused into ``wqkv`` and gate|up into ``w13`` at load
(``fuse_projections``). The JAX forward is one ``lax.scan`` over the
stacked layers; here it is a Python loop that indexes them. Every
projection goes through ``qmatmul`` (quantization/qlinear.py): a plain
tensor is ``torch.matmul``, as XLA computes it in the JAX package, and a
packed int4 container is the hand-written kernel of ops/quant_matmul.py.
Attention is ops/attention.py, which holds the two attention kernels.
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.models.layers import (apply_rope,
                                               compute_rope_tables, rms_norm,
                                               silu_and_mul)
from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
from aphrodite_tpu_torch.ops.kv_cache import write_kv
from aphrodite_tpu_torch.quantization.qlinear import qmatmul

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class LlamaForCausalLM:
    """Functional Llama over a params dict; see ``param_shapes``."""

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        self.config = model_config
        hf = model_config.hf_config
        self.hidden_size = model_config.get_hidden_size()
        self.num_layers = model_config.get_num_layers()
        self.num_heads = model_config.get_num_attention_heads()
        self.num_kv_heads = model_config.get_total_num_kv_heads()
        self.head_dim = model_config.get_head_size()
        self.intermediate_size = int(hf["intermediate_size"])
        self.vocab_size = model_config.get_vocab_size()
        self.rms_eps = float(hf.get("rms_norm_eps", 1e-6))
        self.rope_theta = float(hf.get("rope_theta", 10000.0))
        self.max_position = model_config.max_model_len
        self.tie_word_embeddings = bool(hf.get("tie_word_embeddings", False))
        self.sliding_window = model_config.get_sliding_window()
        self.dtype = _DTYPES[model_config.dtype]
        self.sm_scale = self.head_dim**-0.5
        for key in ("attention_bias", "mlp_bias"):
            if hf.get(key):
                raise NotImplementedError(
                    f"{key} Llama variants are not ported yet")
        if float(hf.get("partial_rotary_factor") or 1.0) != 1.0:
            raise NotImplementedError("partial rotary is not ported yet")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"q heads ({self.num_heads}) must be a multiple of kv "
                f"heads ({self.num_kv_heads})")
        self._cos, self._sin = compute_rope_tables(
            self.head_dim, self.max_position, base=self.rope_theta,
            rope_scaling=hf.get("rope_scaling"), device=device)

    # ------------------------------------------------------------------
    # Params
    # ------------------------------------------------------------------

    def param_shapes(self) -> Dict[str, Any]:
        H, L = self.hidden_size, self.num_layers
        NH, NKV, D = self.num_heads, self.num_kv_heads, self.head_dim
        F, V = self.intermediate_size, self.vocab_size
        shapes = {
            "embed": (V, H),
            "final_norm": (H,),
            "layers": {
                "input_norm": (L, H),
                "wq": (L, H, NH * D),
                "wk": (L, H, NKV * D),
                "wv": (L, H, NKV * D),
                "wo": (L, NH * D, H),
                "post_norm": (L, H),
                "gate": (L, H, F),
                "up": (L, H, F),
                "down": (L, F, H),
            },
        }
        if not self.tie_word_embeddings:
            shapes["lm_head"] = (H, V)
        return shapes

    def fuse_projections(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Concatenate wq|wk|wv -> wqkv and gate|up -> w13 along the
        output axis (all share their input): 4 matmuls per layer, not 7.
        Same layout as the JAX package's fuse_projections. Quantized
        containers fuse member by member, and only when all parts are of
        one kind with one K and one group size; otherwise the parts stay
        apart and the forward multiplies each."""
        lp = params["layers"]

        def kind(w):
            if not isinstance(w, dict):
                return ("dense", w.shape[-2], 0)
            if "q4p" in w:
                rows = w["q4p"].shape[-2]
                return ("q4p", rows, 2 * rows // w["scale"].shape[-2])
            if "q4" in w:
                rows = w["q4"].shape[-2]
                return ("q4", rows, rows // w["scale"].shape[-2])
            raise NotImplementedError(
                "int8 and fp8 weight containers are not ported yet")

        def fuse(names, out):
            if out in lp or len({kind(lp[n]) for n in names}) != 1:
                return
            ws = [lp.pop(n) for n in names]
            if isinstance(ws[0], dict):
                lp[out] = {k: torch.cat([w[k] for w in ws], dim=-1)
                           for k in ws[0]}
            else:
                lp[out] = torch.cat(ws, dim=-1)

        fuse(("wq", "wk", "wv"), "wqkv")
        fuse(("gate", "up"), "w13")
        return params

    def quantizable_weights(self) -> List[str]:
        """Param paths eligible for weight quantization (the Linear
        layers; embeddings, norms and lm_head stay full precision)."""
        return ["layers.wq", "layers.wk", "layers.wv", "layers.wo",
                "layers.gate", "layers.up", "layers.down"]

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        """(hf_template, our_path, transpose) for per-layer weights.

        HF stores Linear weights [out, in]; ours are [in, out] (transpose).
        """
        return [
            ("model.layers.{i}.input_layernorm.weight",
             "layers.input_norm", False),
            ("model.layers.{i}.self_attn.q_proj.weight", "layers.wq", True),
            ("model.layers.{i}.self_attn.k_proj.weight", "layers.wk", True),
            ("model.layers.{i}.self_attn.v_proj.weight", "layers.wv", True),
            ("model.layers.{i}.self_attn.o_proj.weight", "layers.wo", True),
            ("model.layers.{i}.post_attention_layernorm.weight",
             "layers.post_norm", False),
            ("model.layers.{i}.mlp.gate_proj.weight", "layers.gate", True),
            ("model.layers.{i}.mlp.up_proj.weight", "layers.up", True),
            ("model.layers.{i}.mlp.down_proj.weight", "layers.down", True),
        ]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [
            ("model.embed_tokens.weight", "embed", False),
            ("model.norm.weight", "final_norm", False),
        ]
        if not self.tie_word_embeddings:
            maps.append(("lm_head.weight", "lm_head", True))
        return maps

    @property
    def kv_cache_shape_suffix(self) -> Tuple[int, int]:
        return (2 * self.num_kv_heads, self.head_dim)

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def forward(self, params: Dict[str, Any], kv_cache: torch.Tensor,
                batch: ForwardBatch) -> torch.Tensor:
        """Run the decoder over the batch; writes the new tokens' K/V into
        kv_cache [L, num_pages, page_size, 2*KV, D] in place and returns
        the final-normed hidden states [T, H]."""
        NH, NKV, D = self.num_heads, self.num_kv_heads, self.head_dim
        lp = params["layers"]

        def proj(h, names, layer):
            """h @ the fused weight names[0], or, where the parts could
            not be fused, the concatenation of h @ each part. A quantized
            product comes back in f32 and is cast to the model dtype, so
            the layer goes on in the dtype the dense path holds."""
            if names[0] in lp:
                return qmatmul(h, lp[names[0]], layer).to(self.dtype)
            return torch.cat([qmatmul(h, lp[n], layer) for n in names[1:]],
                             dim=-1).to(self.dtype)

        x = params["embed"][batch.token_ids].to(self.dtype)
        cos = self._cos[batch.positions]
        sin = self._sin[batch.positions]
        for layer in range(self.num_layers):
            h = rms_norm(x, lp["input_norm"][layer], self.rms_eps)
            qkv = proj(h, ("wqkv", "wq", "wk", "wv"), layer)
            q = qkv[:, :NH * D].reshape(-1, NH, D)
            k = qkv[:, NH * D:(NH + NKV) * D].reshape(-1, NKV, D)
            v = qkv[:, (NH + NKV) * D:].reshape(-1, NKV, D)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            pages = write_kv(kv_cache[layer], k, v, batch.slot_mapping)
            attn = ragged_paged_attention(
                q, pages, batch.kv_lens, batch.page_indices,
                batch.cu_q_lens, batch.num_seqs, sm_scale=self.sm_scale,
                sliding_window=self.sliding_window)
            x = x + proj(attn.reshape(-1, NH * D), ("wo",), layer)
            h = rms_norm(x, lp["post_norm"][layer], self.rms_eps)
            g13 = proj(h, ("w13", "gate", "up"), layer)
            F = g13.shape[-1] // 2
            x = x + proj(silu_and_mul(g13[:, :F], g13[:, F:]), ("down",),
                         layer)
        return rms_norm(x, params["final_norm"], self.rms_eps)

    def compute_logits(self, params: Dict[str, Any],
                       hidden: torch.Tensor) -> torch.Tensor:
        """hidden [S, H] -> logits [S, V] in f32. bf16 operands are
        multiplied with f32 accumulation into an f32 result, never
        rounded to bf16, as jnp.dot(..., preferred_element_type=f32) in
        the JAX package."""
        head = (params["embed"][:self.vocab_size].t()
                if self.tie_word_embeddings else params["lm_head"])
        if hidden.dtype == torch.float32:
            return torch.matmul(hidden, head)
        if hidden.device.type == "cuda":
            return torch.mm(hidden, head, out_dtype=torch.float32)
        # The CPU has no mixed-dtype mm; a product of two bf16 values is
        # exact in f32, so upcasting first gives the same sums.
        return torch.matmul(hidden.float(), head.float())
