"""Llama causal LM, dense and quantized weights (counterpart of
aphrodite_tpu/models/llama.py: LlamaForCausalLM).

The parameters keep the JAX package's layout: a plain dict of tensors,
matmul weights stored [in, out], per-layer weights stacked on a leading
[L] axis, q|k|v fused into ``wqkv`` and gate|up into ``w13`` at load
(``fuse_projections``). The JAX forward is one ``lax.scan`` over the
stacked layers; here it is a Python loop that indexes them. Every
projection goes through ``qmatmul`` (quantization/qlinear.py): a plain
tensor is ``torch.matmul``, as XLA computes it in the JAX package, and a
quantized container one of the products of ops/quant_matmul.py.
Attention is ops/attention.py, which holds the two attention kernels.

Hooks serve the subclasses, as in the JAX package:
- position encoding: ``use_rope`` (False: no rotary tables, no rotation)
  and ``alibi_slopes`` (an f32[QH] tensor on the model's device, handed to
  both attention kernels, or None); the rotation covers ``rotary_dim``
  leading dims of each head (the config's ``rotary_pct``, else
  ``partial_rotary_factor``, of head_dim, or its absolute ``rotary_dim``:
  GPT-NeoX, Phi, StableLM, GPT-J), the rest pass through, and
  ``rope_style`` pairs the rotated dims "neox" (rotate-half) or "gptj"
  (interleaved: GPT-J, Cohere, GLM, ChatGLM);
- blocksparse attention: ``blocksparse_params`` (block size, local blocks,
  vertical stride), ``bs_head_offsets`` (each query head's vertical phase,
  an i32[QH] tensor on the model's device) and ``bs_layer_mask`` (one bool
  per layer, False for a dense layer; None: every layer sparse);
- bias terms: ``attention_bias`` (q|k|v, fused into ``bqkv`` with the
  weights), ``o_proj_bias`` (``bo``) and ``mlp_bias`` (``gate_b``,
  ``up_b``, fused into ``b13``, and ``down_b``);
- ``norm_type`` "rms" or "layernorm" (with ``input_norm_b``,
  ``post_norm_b`` and ``final_norm_b`` where ``norm_bias``; MPT's
  LayerNorms have none), ``embedding_multiplier`` (applied in the model
  dtype), ``logit_scale`` (f32, after the f32 product) and
  ``tie_word_embeddings_default``;
- ``embedding_norm``: a norm of the token embeddings before the first
  layer (``embed_norm``, ``embed_norm_b``; Bloom);
- ``gated_mlp`` False: the plain two-matmul MLP, ``fc1`` (with ``fc1_b``
  under ``mlp_bias``), ``ungated_act`` ("gelu_tanh", exact "gelu",
  "relu" or "relu2", in f32, rounded to the model dtype), ``fc2`` (and
  ``fc2_b``); ``fc1`` is fused with nothing;
- ``parallel_residual``: x + attn(norm1(x)) + mlp(norm2(x)) in one step
  (Falcon), with ``single_norm`` feeding the MLP the same norm1 output
  (no ``post_norm`` params at all);
- ``mlp(lp, h, layer)``, which a subclass may replace; ``gate`` and
  ``up`` then stay apart at load (an MoE subclass has neither: its
  experts come from ``hf_expert_mappings``, stacked [L, E, ...], and
  ``expert_weights`` names them for experts_int8);
- ``lm_head_bias`` (``lm_head_b``, added to the f32 logits);
- ``qk_norm(q, k, lp, layer)``: a per-head normalization of q [T, QH, D]
  and k [T, KV, D] after the reshape to heads and before RoPE (identity
  here; Qwen3 normalizes over head_dim, Phi, Persimmon and Cohere take a
  LayerNorm);
- Gemma's: ``norm_weight_offset`` (either norm by offset + w, the sum
  in the weight's dtype; Nemotron's LayerNorm1p too),
  ``scale_embeddings`` (sqrt(hidden) in the model dtype, before
  ``embedding_multiplier``), ``hidden_act`` "silu" or "gelu_tanh"
  (GeGLU), ``attn_softcap`` (both attention kernels' soft cap) and
  ``logit_softcap`` (tanh(l / c) * c on the f32 logits), 0.0 meaning off;
- per layer: ``layer_windows`` (each layer's sliding window; None: the
  model's ``sliding_window`` on every layer; Gemma2 alternates local and
  global layers) and ``local_rope_layers`` (the layers that rotate by
  ``_cos_local`` / ``_sin_local``, Gemma3's local table; None: every
  layer by ``_cos`` / ``_sin``); each is a Python choice, so the decode
  window's CUDA graph captures it as it stands;
- Gemma2's sandwich norms: with ``post_attn_norm`` and ``post_ff_norm``
  in the layer params, each block's output is normalized before its
  residual add.
Every hook is a Python choice made at init, so the decode window's CUDA
graph captures the forward as it stands.
"""

from typing import Any, Dict, List, Optional, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.models.layers import (apply_rope,
                                               compute_rope_tables,
                                               gelu_and_mul, layer_norm,
                                               rms_norm, silu_and_mul,
                                               ungated_activation)
from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
from aphrodite_tpu_torch.ops.kv_cache import write_kv
from aphrodite_tpu_torch.quantization.qlinear import qmatmul

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class LlamaForCausalLM:
    """Functional Llama over a params dict; see ``param_shapes``."""

    # Rotary positions; a subclass with ALiBi sets it False before
    # __init__ and fills alibi_slopes after.
    use_rope: bool = True
    # The pairing of the rotated dims: "neox" (rotate-half) or "gptj"
    # (interleaved).
    rope_style: str = "neox"
    # Bias terms (q|k|v bias may also come from the config's
    # "attention_bias", as in the JAX package).
    attention_bias: bool = False
    o_proj_bias: bool = False
    mlp_bias: bool = False
    # "rms" or "layernorm" (mean-centred, with bias where norm_bias).
    norm_type: str = "rms"
    norm_bias: bool = True
    # A norm of the token embeddings before the first layer (Bloom).
    embedding_norm: bool = False
    # The plain two-matmul MLP (fc1, ungated_act, fc2) instead of the gated
    # one; ungated_act: "gelu_tanh", "gelu" (exact), "relu" or "relu2".
    gated_mlp: bool = True
    ungated_act: str = "gelu_tanh"
    # x + attn(norm1(x)) + mlp(norm2(x)) in one step; single_norm: the MLP
    # takes norm1(x) too (no post_norm params).
    parallel_residual: bool = False
    single_norm: bool = False
    tie_word_embeddings_default: bool = False
    lm_head_bias: bool = False
    # muP-style scales (1.0 and None: off).
    embedding_multiplier: float = 1.0
    logit_scale: Optional[float] = None
    # Gemma: RMSNorm by (offset + w), embeddings times sqrt(hidden), the
    # MLP's activation ("silu" or "gelu_tanh"), soft caps (0.0: off).
    norm_weight_offset: float = 0.0
    scale_embeddings: bool = False
    hidden_act: str = "silu"
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    # Set by a subclass whose finalize_params splits fused checkpoint
    # tensors: its quantized checkpoints are not loaded.
    splits_fused_tensors: bool = False

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
        tie = hf.get("tie_word_embeddings")
        self.tie_word_embeddings = bool(
            self.tie_word_embeddings_default if tie is None else tie)
        # The config's mlp_bias is not read, as in the JAX package.
        self.attention_bias = bool(
            hf.get("attention_bias", self.attention_bias))
        self.sliding_window = model_config.get_sliding_window()
        self.dtype = _DTYPES[model_config.dtype]
        self.sm_scale = self.head_dim**-0.5
        # Partial rotary, in the JAX package's precedence: GPT-NeoX's
        # rotary_pct, then partial_rotary_factor, then an absolute
        # rotary_dim (GPT-J).
        pct = float(hf.get("rotary_pct")
                    or hf.get("partial_rotary_factor") or 1.0)
        self.rotary_dim = max(2, int(self.head_dim * pct))
        if hf.get("rotary_dim"):
            self.rotary_dim = int(hf["rotary_dim"])
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"q heads ({self.num_heads}) must be a multiple of kv "
                f"heads ({self.num_kv_heads})")
        self.alibi_slopes: Optional[torch.Tensor] = None
        self.blocksparse_params: Optional[Tuple[int, int, int]] = None
        self.bs_head_offsets: Optional[torch.Tensor] = None
        self.bs_layer_mask: Optional[List[bool]] = None
        # Per layer (a subclass with local layers sets them): the sliding
        # windows, and the layers rotated by a local table of their own.
        self.layer_windows: Optional[List[Optional[int]]] = None
        self.local_rope_layers: Optional[List[bool]] = None
        self._cos_local: Optional[torch.Tensor] = None
        self._sin_local: Optional[torch.Tensor] = None
        if self.use_rope:
            self._cos, self._sin = compute_rope_tables(
                self.rotary_dim, self.max_position, base=self.rope_theta,
                rope_scaling=hf.get("rope_scaling"), device=device)
        # The muP scales as tensors made once, on the model's device: a
        # tensor made from a Python number in the forward is a copy from
        # the host, which a captured CUDA graph cannot hold. A subclass
        # sets both scales before calling this __init__.
        self._embedding_scale = (
            torch.tensor(self.embedding_multiplier, dtype=self.dtype,
                         device=device)
            if self.embedding_multiplier != 1.0 else None)
        self._logit_scale = (
            torch.tensor(self.logit_scale, dtype=torch.float32, device=device)
            if self.logit_scale else None)
        self._hidden_scale = (
            torch.tensor(self.hidden_size**0.5, dtype=self.dtype,
                         device=device)
            if self.scale_embeddings else None)

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
            },
        }
        lay = shapes["layers"]
        if self.gated_mlp:
            lay.update(gate=(L, H, F), up=(L, H, F), down=(L, F, H))
            if self.mlp_bias:
                lay.update(gate_b=(L, F), up_b=(L, F), down_b=(L, H))
        else:
            lay.update(fc1=(L, H, F), fc2=(L, F, H))
            if self.mlp_bias:
                lay.update(fc1_b=(L, F), fc2_b=(L, H))
        if self.attention_bias:
            lay.update(bq=(L, NH * D), bk=(L, NKV * D), bv=(L, NKV * D))
        if self.o_proj_bias:
            lay["bo"] = (L, H)
        layernorm_bias = self.norm_type == "layernorm" and self.norm_bias
        if layernorm_bias:
            lay.update(input_norm_b=(L, H), post_norm_b=(L, H))
            shapes["final_norm_b"] = (H,)
        if self.embedding_norm:
            shapes["embed_norm"] = (H,)
            if layernorm_bias:
                shapes["embed_norm_b"] = (H,)
        if not self.tie_word_embeddings:
            shapes["lm_head"] = (H, V)
            if self.lm_head_bias:
                shapes["lm_head_b"] = (V,)
        if self.single_norm:
            lay.pop("post_norm")
            lay.pop("post_norm_b", None)
        return shapes

    def fuse_projections(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Concatenate wq|wk|wv -> wqkv and gate|up -> w13 along the
        output axis (all share their input): 4 matmuls per layer, not 7,
        and their biases with them (bqkv, b13). Same layout and rules as
        the JAX package's fuse_projections: a subclass with its own
        ``mlp`` keeps gate and up apart, and the plain MLP's fc1 is fused
        with nothing. Quantized containers fuse member
        by member, and only when all parts are of one kind with one K and
        one group size; otherwise the parts stay apart and the forward
        multiplies each."""
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
            return ("q", w["q"].shape[-2], 0)

        def fuse(names, out, biases, bias_out):
            if out in lp or len({kind(lp[n]) for n in names}) != 1:
                return
            ws = [lp.pop(n) for n in names]
            if isinstance(ws[0], dict):
                lp[out] = {k: torch.cat([w[k] for w in ws], dim=-1)
                           for k in ws[0]}
            else:
                lp[out] = torch.cat(ws, dim=-1)
            if biases[0] in lp:
                lp[bias_out] = torch.cat([lp.pop(b) for b in biases], dim=-1)

        fuse(("wq", "wk", "wv"), "wqkv", ("bq", "bk", "bv"), "bqkv")
        if self.gated_mlp and type(self).mlp is LlamaForCausalLM.mlp:
            fuse(("gate", "up"), "w13", ("gate_b", "up_b"), "b13")
        return params

    def quantizable_weights(self) -> List[str]:
        """Param paths eligible for weight quantization (the Linear
        layers; embeddings, norms and lm_head stay full precision)."""
        attn = ["layers.wq", "layers.wk", "layers.wv", "layers.wo"]
        if self.gated_mlp:
            return attn + ["layers.gate", "layers.up", "layers.down"]
        return attn + ["layers.fc1", "layers.fc2"]

    def expert_weights(self) -> List[str]:
        """Param paths of MoE expert stacks (experts_int8 quantizes these
        only); a dense model has none."""
        return []

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        """(hf_template, our_path, transpose) for per-layer weights.

        HF stores Linear weights [out, in]; ours are [in, out] (transpose).
        The bias terms are the JAX package's: o_proj, LayerNorm and q|k|v
        biases by their flags, and the plain MLP's; MLP biases of a gated
        MLP have no mapping here (a subclass maps its own).
        """
        la = "model.layers.{i}."
        maps = [
            (la + "input_layernorm.weight", "layers.input_norm", False),
            (la + "self_attn.q_proj.weight", "layers.wq", True),
            (la + "self_attn.k_proj.weight", "layers.wk", True),
            (la + "self_attn.v_proj.weight", "layers.wv", True),
            (la + "self_attn.o_proj.weight", "layers.wo", True),
            (la + "post_attention_layernorm.weight", "layers.post_norm",
             False),
        ]
        if self.gated_mlp:
            maps += [(la + "mlp.gate_proj.weight", "layers.gate", True),
                     (la + "mlp.up_proj.weight", "layers.up", True),
                     (la + "mlp.down_proj.weight", "layers.down", True)]
        else:
            maps += [(la + "mlp.c_fc.weight", "layers.fc1", True),
                     (la + "mlp.c_proj.weight", "layers.fc2", True)]
            if self.mlp_bias:
                maps += [(la + "mlp.c_fc.bias", "layers.fc1_b", False),
                         (la + "mlp.c_proj.bias", "layers.fc2_b", False)]
        if self.o_proj_bias:
            maps.append((la + "self_attn.o_proj.bias", "layers.bo", False))
        if self.norm_type == "layernorm" and self.norm_bias:
            maps += [(la + "input_layernorm.bias", "layers.input_norm_b",
                      False),
                     (la + "post_attention_layernorm.bias",
                      "layers.post_norm_b", False)]
        if self.attention_bias:
            maps += [(la + f"self_attn.{n}_proj.bias", f"layers.b{n}", False)
                     for n in "qkv"]
        return maps

    def hf_split_mappings(
            self) -> List[Tuple[str, List[Tuple[str, int, int]], bool]]:
        """(hf_template, [(our_path, start, end)], transpose) for fused
        per-layer tensors split along the output dim; Llama has none."""
        return []

    def mlp_workspace_bytes(self, max_tokens: int, max_seqs: int) -> int:
        """Device memory an MLP needs beyond the activations the runner
        counts (MoE: the grouped product's buffers and one layer's
        dequantized experts); none for a dense model."""
        return 0

    def hf_expert_mappings(self) -> List[Tuple[str, str, bool]]:
        """(hf_template with {i} and {e}, our_path, transpose) for
        per-(layer, expert) tensors, stacked [L, E, ...]; a dense model has
        none."""
        return []

    def finalize_params(self, params: Dict[str, Any]) -> None:
        """Post-process a params tree loaded from an HF checkpoint, in
        place; Llama needs nothing."""

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [
            ("model.embed_tokens.weight", "embed", False),
            ("model.norm.weight", "final_norm", False),
        ]
        if self.norm_type == "layernorm" and self.norm_bias:
            maps.append(("model.norm.bias", "final_norm_b", False))
        if not self.tie_word_embeddings:
            maps.append(("lm_head.weight", "lm_head", True))
        return maps

    @property
    def kv_cache_shape_suffix(self) -> Tuple[int, int]:
        return (2 * self.num_kv_heads, self.head_dim)

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def forward(
        self, params: Dict[str, Any], kv_cache: torch.Tensor,
        batch: ForwardBatch,
        kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Run the decoder over the batch; writes the new tokens' K/V into
        kv_cache [L, num_pages, page_size, 2*KV, D] in place and returns
        the final-normed hidden states [T, H].

        kv_scales: per-layer (k_scale[L], v_scale[L]) f32 tensors for a
        narrow cache type. The cache stores value / scale; neither scale
        enters an attention kernel: k_scale folds into q
        (q . (s * K) == (s * q) . K) and v_scale into the attention
        output, each rounded to the model dtype first, as in the JAX
        package."""
        NH, NKV, D = self.num_heads, self.num_kv_heads, self.head_dim
        lp = params["layers"]
        k_scales, v_scales = kv_scales if kv_scales is not None else (None,
                                                                      None)
        x = params["embed"][batch.token_ids].to(self.dtype)
        if self._hidden_scale is not None:
            x = x * self._hidden_scale
        if self._embedding_scale is not None:
            x = x * self._embedding_scale
        if self.embedding_norm:
            x = self._norm(x, params["embed_norm"], params.get("embed_norm_b"))
        if self.use_rope:
            neox = self.rope_style == "neox"
            rope = (self._cos[batch.positions], self._sin[batch.positions])
            if self.local_rope_layers is not None:
                rope_local = (self._cos_local[batch.positions],
                              self._sin_local[batch.positions])
        sandwich = "post_attn_norm" in lp
        for layer in range(self.num_layers):
            h = self._norm(x, lp["input_norm"][layer],
                           self._layer_bias(lp, "input_norm_b", layer))
            qkv = self._linear(lp, h, ("wqkv", "wq", "wk", "wv"),
                               ("bqkv", "bq", "bk", "bv"),
                               layer).to(self.dtype)
            q = qkv[:, :NH * D].reshape(-1, NH, D)
            k = qkv[:, NH * D:(NH + NKV) * D].reshape(-1, NKV, D)
            v = qkv[:, (NH + NKV) * D:].reshape(-1, NKV, D)
            q, k = self.qk_norm(q, k, lp, layer)
            if self.use_rope:
                cos, sin = (rope_local if self.local_rope_layers is not None
                            and self.local_rope_layers[layer] else rope)
                q = apply_rope(q, cos, sin, neox)
                k = apply_rope(k, cos, sin, neox)
            else:
                # The attention kernels read q contiguous; where there is
                # a rotation, it makes the copy.
                q = q.contiguous()
            k_scale = None if k_scales is None else k_scales[layer]
            v_scale = None if v_scales is None else v_scales[layer]
            pages = write_kv(kv_cache[layer], k, v, batch.slot_mapping,
                             k_scale, v_scale)
            if k_scale is not None:
                q = q * k_scale.to(q.dtype)
            attn = ragged_paged_attention(
                q, pages, batch.kv_lens, batch.page_indices,
                batch.cu_q_lens, batch.num_seqs, sm_scale=self.sm_scale,
                sliding_window=(self.sliding_window
                                if self.layer_windows is None
                                else self.layer_windows[layer]),
                soft_cap=self.attn_softcap or None,
                alibi_slopes=self.alibi_slopes,
                blocksparse=self.blocksparse_params,
                bs_head_offsets=self.bs_head_offsets,
                bs_on=(self.bs_layer_mask is None
                       or self.bs_layer_mask[layer]))
            if v_scale is not None:
                attn = attn * v_scale.to(attn.dtype)
            o = self._linear(lp, attn.reshape(-1, NH * D), ("wo",), ("bo",),
                             layer).to(self.dtype)
            if self.parallel_residual:
                # One step: x + attn(norm1(x)) + mlp(norm2(x)), or with
                # single_norm the MLP on norm1(x) too.
                h2 = h if self.single_norm else self._norm(
                    x, lp["post_norm"][layer],
                    self._layer_bias(lp, "post_norm_b", layer))
                x = x + o + self.mlp(lp, h2, layer).to(self.dtype)
                continue
            if sandwich:
                o = self._norm(o, lp["post_attn_norm"][layer])
            x = x + o
            h = self._norm(x, lp["post_norm"][layer],
                           self._layer_bias(lp, "post_norm_b", layer))
            ff = self.mlp(lp, h, layer).to(self.dtype)
            if sandwich:
                ff = self._norm(ff, lp["post_ff_norm"][layer])
            x = x + ff
        return self._norm(x, params["final_norm"], params.get("final_norm_b"))

    def qk_norm(self, q: torch.Tensor, k: torch.Tensor, lp: Dict[str, Any],
                layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-head query/key normalization hook: identity for Llama
        (Qwen3 overrides it with an RMSNorm over head_dim)."""
        return q, k

    @staticmethod
    def _layer_bias(lp: Dict[str, Any], name: str,
                    layer: int) -> Optional[torch.Tensor]:
        return lp[name][layer] if name in lp else None

    def _norm(self, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_weight_offset:
            weight = weight + self.norm_weight_offset
        if self.norm_type == "layernorm":
            return layer_norm(x, weight, bias, self.rms_eps)
        return rms_norm(x, weight, self.rms_eps)

    def _linear(self, lp: Dict[str, Any], h: torch.Tensor,
                names: Tuple[str, ...], biases: Tuple[str, ...],
                layer: int) -> torch.Tensor:
        """h @ the fused weight names[0] plus its bias biases[0], or, where
        the parts could not be fused, the concatenation of h @ each part
        plus its bias. Not cast: a quantized product comes back in f32, and
        its bias is added there, as in the JAX package; the caller casts
        to the model dtype."""
        if names[0] in lp:
            pairs = [(names[0], biases[0])]
        else:
            pairs = list(zip(names[1:], biases[1:]))
        parts = []
        for name, bias in pairs:
            y = qmatmul(h, lp[name], layer)
            if bias in lp:
                y = y + lp[bias][layer]
            parts.append(y)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def mlp(self, lp: Dict[str, Any], h: torch.Tensor,
            layer: int) -> torch.Tensor:
        """The gated SiLU (or, with hidden_act "gelu_tanh", GeGLU) MLP of
        one layer (gate and up in the model dtype, as the JAX package
        casts them), or without ``gated_mlp`` fc1, ``ungated_act`` (in
        f32, rounded to the model dtype) and fc2."""
        if not self.gated_mlp:
            up = self._linear(lp, h, ("fc1",), ("fc1_b",), layer)
            act = ungated_activation(up, self.ungated_act).to(self.dtype)
            return self._linear(lp, act, ("fc2",), ("fc2_b",), layer)
        g13 = self._linear(lp, h, ("w13", "gate", "up"),
                           ("b13", "gate_b", "up_b"), layer).to(self.dtype)
        F = g13.shape[-1] // 2
        act = gelu_and_mul if self.hidden_act == "gelu_tanh" else silu_and_mul
        return self._linear(lp, act(g13[:, :F], g13[:, F:]), ("down",),
                            ("down_b",), layer)

    def compute_logits(self, params: Dict[str, Any],
                       hidden: torch.Tensor) -> torch.Tensor:
        """hidden [S, H] -> logits [S, V] in f32. bf16 operands are
        multiplied with f32 accumulation into an f32 result, never
        rounded to bf16, as jnp.dot(..., preferred_element_type=f32) in
        the JAX package."""
        head = (params["embed"][:self.vocab_size].t()
                if self.tie_word_embeddings else params["lm_head"])
        if hidden.dtype == torch.float32:
            logits = torch.matmul(hidden, head)
        elif hidden.device.type == "cuda":
            logits = torch.mm(hidden, head, out_dtype=torch.float32)
        else:
            # The CPU has no mixed-dtype mm; a product of two bf16 values
            # is exact in f32, so upcasting first gives the same sums.
            logits = torch.matmul(hidden.float(), head.float())
        if "lm_head_b" in params:
            logits = logits + params["lm_head_b"].float()
        if self._logit_scale is not None:
            logits = logits * self._logit_scale
        if self.logit_softcap:
            cap = self.logit_softcap
            logits = cap * torch.tanh(logits / cap)
        return logits
