"""BART and mBART encoder-decoders (counterpart of
aphrodite_tpu/models/bart.py: BartForConditionalGeneration,
MBartForConditionalGeneration).

The parameters keep the JAX package's layout: the shared embedding
(encoder, decoder and LM head), final_logits_bias (``logits_bias``),
learned positions for each stack (read at position + 2, BART's offset),
the embedding LayerNorms, and the stacked [L, ...] "encoder" and
"decoder" trees, matmul weights [in, out] with their biases. BART is
post-norm (residual, then LayerNorm); mBART is pre-norm with a final
LayerNorm on each stack. Projections run in the model dtype, residuals and
LayerNorms in f32, as in the JAX model.

The encoder (``encode_and_write_cross``) runs once per sequence, at its
first prefill chunk, and writes every decoder layer's cross K/V into the
sequence's cross pages. Decoder self-attention is the port's
``ragged_paged_attention`` with q scaled before it (sm_scale 1): the ragged
kernel in prefill and mixed steps, the decode kernel in pure-decode ones,
both at QH/KV 1 and head_dim 64 for the published models.
Cross-attention is the dense masked read of models/encoder_decoder.py, in
f32. A narrow KV cache is written by a plain cast of each value, as in the
JAX package (its per-layer scales are not read for this model).
"""

import math
from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.encoder_decoder import (cross_attention,
                                                        sequence_of_tokens)
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.models.layers import layer_norm
from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
from aphrodite_tpu_torch.ops.decode_attention import MASK_VALUE
from aphrodite_tpu_torch.ops.kv_cache import write_kv

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class BartForConditionalGeneration:
    is_encoder_decoder = True
    # mBART: LayerNorm before attention and FFN, and a final LayerNorm on
    # both stacks.
    pre_norm = False

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        self.config = model_config
        hf = model_config.hf_config
        D = model_config.get_hidden_size()
        self.hidden_size = D
        self.enc_layers = model_config.get_num_encoder_layers()
        self.num_layers = model_config.get_num_decoder_layers()
        self.num_heads = int(hf.get("decoder_attention_heads", 16))
        self.enc_heads = int(hf.get("encoder_attention_heads",
                                    self.num_heads))
        self.num_kv_heads = self.num_heads
        self.head_dim = D // self.num_heads
        self.enc_ffn = int(hf.get("encoder_ffn_dim", 4 * D))
        self.dec_ffn = int(hf.get("decoder_ffn_dim", 4 * D))
        self.vocab_size = model_config.get_vocab_size()
        self.max_position = int(hf.get("max_position_embeddings", 1024))
        self.scale_embedding = bool(hf.get("scale_embedding", False))
        self.decoder_start_token_id = int(hf.get("decoder_start_token_id", 2))
        self.dtype = _DTYPES[model_config.dtype]
        self.sm_scale = self.head_dim**-0.5
        self.pos_offset = 2  # BartLearnedPositionalEmbedding
        # The embedding scale as a tensor in the model dtype, made once.
        self._embed_scale = (torch.tensor(math.sqrt(D), dtype=self.dtype,
                                          device=device)
                             if self.scale_embedding else None)

    # ---- cache geometry ------------------------------------------------

    @property
    def kv_cache_shape_suffix(self) -> Tuple[int, int]:
        return (2 * self.num_heads, self.head_dim)

    @property
    def cross_kv_cache_shape_suffix(self) -> Tuple[int, int]:
        return (2 * self.num_heads, self.head_dim)

    # ---- params --------------------------------------------------------

    def param_shapes(self) -> Dict[str, Any]:
        D, V = self.hidden_size, self.vocab_size
        Le, Ld = self.enc_layers, self.num_layers
        P2 = self.max_position + self.pos_offset

        def block(L, F, cross):
            names = ["", "c"] if cross else [""]
            shapes = {}
            for c in names:
                for w in "qkvo":
                    shapes[f"{c}w{w}"] = (L, D, D)
                    shapes[f"{c}b{w}"] = (L, D)
            shapes.update(ln1=(L, D), ln1_b=(L, D), fc1=(L, D, F),
                          fc1_b=(L, F), fc2=(L, F, D), fc2_b=(L, D),
                          ln2=(L, D), ln2_b=(L, D))
            if cross:
                shapes.update(cln=(L, D), cln_b=(L, D))
            return shapes

        shapes = {"embed": (V, D), "logits_bias": (V,),
                  "enc_pos": (P2, D), "dec_pos": (P2, D),
                  "enc_ln_emb": (D,), "enc_ln_emb_b": (D,),
                  "dec_ln_emb": (D,), "dec_ln_emb_b": (D,),
                  "encoder": block(Le, self.enc_ffn, False),
                  "decoder": block(Ld, self.dec_ffn, True)}
        if self.pre_norm:
            for stack in ("enc", "dec"):
                shapes[f"{stack}_final_ln"] = (D,)
                shapes[f"{stack}_final_ln_b"] = (D,)
        return shapes

    def dummy_ones(self, path: str) -> bool:
        """Whether dummy weights hold ones at `path` (the LayerNorm
        weights)."""
        name = path.rsplit(".", 1)[-1]
        return name in ("ln1", "ln2", "cln") or name.endswith(
            ("_ln", "_ln_emb"))

    def fuse_projections(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Nothing is fused: the JAX model keeps every projection apart."""
        return params

    def quantizable_weights(self) -> List[str]:
        raise NotImplementedError(
            "quantized weights of encoder-decoder models are not ported "
            "(the JAX package has none either)")

    def expert_weights(self) -> List[str]:
        return []

    def mlp_workspace_bytes(self, max_tokens: int, max_seqs: int) -> int:
        return 0

    @staticmethod
    def _layer_mappings(prefix: str, stack: str, cross: bool):
        attn = [("self_attn", "")] + ([("encoder_attn", "c")] if cross
                                      else [])
        maps = []
        for module, c in attn:
            for hf, w in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                          ("out_proj", "o")):
                maps += [(f"{prefix}{module}.{hf}.weight", f"{stack}.{c}w{w}",
                          True),
                         (f"{prefix}{module}.{hf}.bias", f"{stack}.{c}b{w}",
                          False)]
            ln = "ln1" if module == "self_attn" else "cln"
            maps += [(f"{prefix}{module}_layer_norm.weight", f"{stack}.{ln}",
                      False),
                     (f"{prefix}{module}_layer_norm.bias",
                      f"{stack}.{ln}_b", False)]
        for n in ("fc1", "fc2"):
            maps += [(f"{prefix}{n}.weight", f"{stack}.{n}", True),
                     (f"{prefix}{n}.bias", f"{stack}.{n}_b", False)]
        maps += [(f"{prefix}final_layer_norm.weight", f"{stack}.ln2", False),
                 (f"{prefix}final_layer_norm.bias", f"{stack}.ln2_b", False)]
        return maps

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        return self._layer_mappings("model.decoder.layers.{i}.", "decoder",
                                    True)

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [
            ("model.shared.weight", "embed", False),
            ("model.encoder.embed_tokens.weight", "embed", False),
            ("model.decoder.embed_tokens.weight", "embed", False),
            ("final_logits_bias", "logits_bias", False),
            ("model.encoder.embed_positions.weight", "enc_pos", False),
            ("model.decoder.embed_positions.weight", "dec_pos", False),
        ]
        for stack in ("encoder", "decoder"):
            s = stack[:3]
            maps += [(f"model.{stack}.layernorm_embedding.weight",
                      f"{s}_ln_emb", False),
                     (f"model.{stack}.layernorm_embedding.bias",
                      f"{s}_ln_emb_b", False)]
        if self.pre_norm:
            for stack in ("encoder", "decoder"):
                s = stack[:3]
                maps += [(f"model.{stack}.layer_norm.weight",
                          f"{s}_final_ln", False),
                         (f"model.{stack}.layer_norm.bias",
                          f"{s}_final_ln_b", False)]
        return maps

    def hf_aux_mappings(self) -> List[Tuple[str, str, bool, int]]:
        """(hf_template, our_path, transpose, count): the encoder stack,
        whose layer count is its own."""
        return [(t, p, tr, self.enc_layers) for t, p, tr in
                self._layer_mappings("model.encoder.layers.{i}.", "encoder",
                                     False)]

    def hf_split_mappings(self) -> list:
        return []

    def hf_expert_mappings(self) -> list:
        return []

    def finalize_params(self, params: Dict[str, Any]) -> None:
        """final_logits_bias, a buffer that checkpoints may leave out
        (zeros then) or store [1, V] (flattened)."""
        if "logits_bias" not in params:
            params["logits_bias"] = torch.zeros((self.vocab_size,))
        params["logits_bias"] = params["logits_bias"].reshape(-1)

    # ---- shared pieces -------------------------------------------------

    def _embed(self, params, tokens, positions, table, ln):
        x = params["embed"][tokens].to(self.dtype)
        if self._embed_scale is not None:
            x = x * self._embed_scale
        x = x + params[table][positions.long() + self.pos_offset].to(
            self.dtype)
        return layer_norm(x, params[ln], params[ln + "_b"])

    @staticmethod
    def _proj(lp, w, layer, h):
        """h @ lp[w] + its bias (w's name with its first "w" made "b": wq
        and bq, cwk and cbk) of one layer, in the model dtype."""
        return h @ lp[w][layer] + lp[w.replace("w", "b", 1)][layer]

    def _ffn(self, lp, layer, h):
        a = torch.nn.functional.gelu(
            (h @ lp["fc1"][layer] + lp["fc1_b"][layer]).float()).to(h.dtype)
        return a @ lp["fc2"][layer] + lp["fc2_b"][layer]

    def _ln(self, lp, name, layer, x32):
        return layer_norm(x32, lp[name][layer], lp[name + "_b"][layer])

    def _block(self, lp, layer, x, attn, cross=None):
        """One layer (post- or pre-norm) around its self-attention
        ``attn(h)`` and, in the decoder, its cross-attention
        ``cross(h)``; residuals in f32, the result in the model dtype."""
        dt = self.dtype
        x32 = x.float()
        if self.pre_norm:
            x32 = x32 + attn(self._ln(lp, "ln1", layer, x32).to(dt)).float()
            if cross is not None:
                x32 = x32 + cross(self._ln(lp, "cln", layer,
                                           x32).to(dt)).float()
            h = self._ffn(lp, layer, self._ln(lp, "ln2", layer, x32).to(dt))
            return (x32 + h.float()).to(dt)
        x32 = self._ln(lp, "ln1", layer, x32 + attn(x).float())
        if cross is not None:
            x32 = self._ln(lp, "cln", layer, x32 + cross(x32.to(dt)).float())
        h = self._ffn(lp, layer, x32.to(dt))
        return self._ln(lp, "ln2", layer, x32 + h.float()).to(dt)

    def _final(self, params, stack, x):
        if not self.pre_norm:
            return x
        return layer_norm(x.float(), params[f"{stack}_final_ln"],
                          params[f"{stack}_final_ln_b"]).to(self.dtype)

    # ---- encoder -------------------------------------------------------

    def encode_and_write_cross(self, params: Dict[str, Any],
                               cross_kv: torch.Tensor, tokens: torch.Tensor,
                               positions: torch.Tensor,
                               slot_mapping: torch.Tensor,
                               enc_len: int) -> None:
        """The encoder over one sequence's tokens [E] (padded; the first
        enc_len are real) at positions [E], then every decoder layer's
        cross K/V of its output, written at slot_mapping [E] (padding rows
        at trash slots) into cross_kv [L, P + 1, page_size, 2H, D], in
        place."""
        lp = params["encoder"]
        H = self.enc_heads
        x = self._embed(params, tokens, positions, "enc_pos", "enc_ln_emb")
        E = x.shape[0]
        key_ok = torch.arange(E, device=x.device) < enc_len

        def heads(t):
            return t.reshape(E, H, -1).float()

        for layer in range(self.enc_layers):
            def attn(h):
                q = heads(self._proj(lp, "wq", layer, h) * self.sm_scale)
                k = heads(self._proj(lp, "wk", layer, h))
                v = heads(self._proj(lp, "wv", layer, h))
                scores = torch.einsum("qhd,khd->hqk", q, k)
                scores = torch.where(key_ok[None, None, :], scores,
                                     MASK_VALUE)
                o = torch.einsum("hqk,khd->qhd",
                                 torch.softmax(scores, dim=-1), v)
                return self._proj(lp, "wo", layer,
                                  o.reshape(E, -1).to(self.dtype))

            x = self._block(lp, layer, x, attn)
        x = self._final(params, "enc", x)
        dec = params["decoder"]
        shape = (E, self.num_heads, self.head_dim)
        for layer in range(self.num_layers):
            write_kv(cross_kv[layer],
                     self._proj(dec, "cwk", layer, x).reshape(shape),
                     self._proj(dec, "cwv", layer, x).reshape(shape),
                     slot_mapping)

    # ---- decoder -------------------------------------------------------

    def forward(self, params: Dict[str, Any], kv_cache: torch.Tensor,
                batch: ForwardBatch, kv_scales=None,
                cross_kv: torch.Tensor = None) -> torch.Tensor:
        """The decoder over the batch: writes the new tokens' K/V into
        kv_cache in place, reads the sequences' encoder K/V from cross_kv
        and returns the hidden states [T, H] in the model dtype. kv_scales
        are not read (see the module's docstring)."""
        lp = params["decoder"]
        T, H, Dh = batch.token_ids.shape[0], self.num_heads, self.head_dim
        x = self._embed(params, batch.token_ids, batch.positions, "dec_pos",
                        "dec_ln_emb")
        seq_of = sequence_of_tokens(batch)
        for layer in range(self.num_layers):
            def attn(h):
                q = (self._proj(lp, "wq", layer, h)
                     * self.sm_scale).reshape(T, H, Dh)
                pages = write_kv(
                    kv_cache[layer],
                    self._proj(lp, "wk", layer, h).reshape(T, H, Dh),
                    self._proj(lp, "wv", layer, h).reshape(T, H, Dh),
                    batch.slot_mapping)
                o = ragged_paged_attention(
                    q, pages, batch.kv_lens, batch.page_indices,
                    batch.cu_q_lens, batch.num_seqs, sm_scale=1.0)
                return self._proj(lp, "wo", layer, o.reshape(T, -1))

            def cross(h):
                q = (self._proj(lp, "cwq", layer, h)
                     * self.sm_scale).reshape(T, H, Dh).float()
                o = cross_attention(q, cross_kv[layer], batch, seq_of)
                return self._proj(lp, "cwo", layer,
                                  o.reshape(T, -1).to(self.dtype))

            x = self._block(lp, layer, x, attn, cross)
        return self._final(params, "dec", x)

    def compute_logits(self, params: Dict[str, Any],
                       hidden: torch.Tensor) -> torch.Tensor:
        """hidden [S, H] -> f32 logits [S, V]: the shared embedding as the
        head, plus final_logits_bias."""
        return (hidden.float() @ params["embed"].float().t()
                + params["logits_bias"].float())


class MBartForConditionalGeneration(BartForConditionalGeneration):
    """mBART: BART's weights and layout, pre-norm, with a final LayerNorm
    on both stacks. A language code to start the decoder is the caller's
    (decoder_prompt_token_ids=[eos, lang_code])."""

    pre_norm = True
