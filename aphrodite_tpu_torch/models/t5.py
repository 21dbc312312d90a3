"""T5 / Flan-T5 encoder-decoder (counterpart of aphrodite_tpu/models/t5.py:
T5ForConditionalGeneration).

The parameters keep the JAX package's layout: embed, the two bias tables
enc_rel_bias and dec_rel_bias [NB, H] (each stack's first block's, shared
by all its layers), the final norms, and the stacked [L, ...] "encoder"
and "decoder" trees, matmul weights [in, out]. T5's own: pre-norm RMSNorm
blocks without mean or biases, unscaled attention (the scaling lives in
the initialisation), relative-position bucket biases (bidirectional in the
encoder, causal in the decoder's self-attention, none in
cross-attention), gated-gelu (tanh GELU) or relu FFNs, and the
d_model**-0.5 scaling of the hidden state when the head is tied to the
embedding. Every matmul and norm runs in f32 on the weights cast to f32,
as the JAX package's (``lp.astype(f32)``).

The encoder (``encode_and_write_cross``) runs once per sequence, at its
first prefill chunk, and writes every decoder layer's cross K/V into the
sequence's cross pages. Decoder self-attention:
- pure-decode steps go to ``paged_decode_attention`` with the decoder's
  bias table (``rel_bias``), sm_scale 1 and q rounded to bf16: the JAX
  package's kernel branch, which it takes on a TPU with bf16 pages only;
  here it is taken on every device and every page type the kernel takes
  (on the card the Hopper kernel, on the CPU its plain version);
- prefill and mixed steps take the dense causal attention with the bias,
  one sequence at a time (``ref_ragged_paged_attention``: the JAX
  package's dense branch is XLA code, so here it is plain PyTorch).
Cross-attention is the dense masked read of models/encoder_decoder.py.
A narrow KV cache is written by a plain cast of each value, as in the JAX
package (its per-layer scales are not read for this model).
"""

from typing import Any, Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.encoder_decoder import (cross_attention,
                                                        sequence_of_tokens)
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.ops.attention import ref_ragged_paged_attention
from aphrodite_tpu_torch.ops.decode_attention import (MASK_VALUE,
                                                      paged_decode_attention,
                                                      t5_relative_bucket)
from aphrodite_tpu_torch.ops.kv_cache import write_kv

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """T5's RMSNorm in f32 (no mean, no bias): the JAX package's _rms."""
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w.float()


class T5ForConditionalGeneration:
    is_encoder_decoder = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        self.config = model_config
        hf = model_config.hf_config
        D = model_config.get_hidden_size()
        self.hidden_size = D
        self.enc_layers = model_config.get_num_encoder_layers()
        self.num_layers = model_config.get_num_decoder_layers()
        self.num_heads = int(hf.get("num_heads", 8))
        self.num_kv_heads = self.num_heads
        self.head_dim = int(hf.get("d_kv", 64))
        self.ffn = int(hf.get("d_ff", 4 * D))
        self.vocab_size = model_config.get_vocab_size()
        self.rms_eps = float(hf.get("layer_norm_epsilon", 1e-6))
        self.num_buckets = int(hf.get("relative_attention_num_buckets", 32))
        self.max_distance = int(hf.get("relative_attention_max_distance",
                                       128))
        act = str(hf.get("feed_forward_proj", "relu"))
        self.gated = act.startswith("gated-")
        self.act = act.replace("gated-", "")
        if self.act not in ("gelu", "relu"):
            # (The JAX model reads any other name as relu.)
            raise ValueError(f"unsupported T5 feed_forward_proj {act!r}")
        self.tie_word_embeddings = bool(hf.get("tie_word_embeddings", True))
        self.decoder_start_token_id = int(hf.get("decoder_start_token_id", 0))
        self.dtype = _DTYPES[model_config.dtype]
        self.max_position = model_config.max_model_len

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
        Le, Ld, F = self.enc_layers, self.num_layers, self.ffn
        ID = self.num_heads * self.head_dim

        def attn(L):
            return {"wq": (L, D, ID), "wk": (L, D, ID), "wv": (L, D, ID),
                    "wo": (L, ID, D)}

        enc = dict(attn(Le), ln1=(Le, D), ln2=(Le, D), wo_ff=(Le, F, D))
        dec = dict(attn(Ld), ln1=(Ld, D), cwq=(Ld, D, ID), cwk=(Ld, D, ID),
                   cwv=(Ld, D, ID), cwo=(Ld, ID, D), cln=(Ld, D),
                   ln2=(Ld, D), wo_ff=(Ld, F, D))
        for tree, L in ((enc, Le), (dec, Ld)):
            if self.gated:
                tree.update(wi0=(L, D, F), wi1=(L, D, F))
            else:
                tree["wi"] = (L, D, F)
        shapes = {"embed": (V, D),
                  "enc_rel_bias": (self.num_buckets, self.num_heads),
                  "dec_rel_bias": (self.num_buckets, self.num_heads),
                  "enc_final_ln": (D,), "dec_final_ln": (D,),
                  "encoder": enc, "decoder": dec}
        if not self.tie_word_embeddings:
            shapes["lm_head"] = (D, V)
        return shapes

    def dummy_ones(self, path: str) -> bool:
        """Whether dummy weights hold ones at `path` (the norms)."""
        name = path.rsplit(".", 1)[-1]
        return name in ("ln1", "ln2", "cln") or name.endswith("final_ln")

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

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        d = "decoder.block.{i}."
        maps = [
            (d + "layer.0.SelfAttention.q.weight", "decoder.wq", True),
            (d + "layer.0.SelfAttention.k.weight", "decoder.wk", True),
            (d + "layer.0.SelfAttention.v.weight", "decoder.wv", True),
            (d + "layer.0.SelfAttention.o.weight", "decoder.wo", True),
            (d + "layer.0.layer_norm.weight", "decoder.ln1", False),
            (d + "layer.1.EncDecAttention.q.weight", "decoder.cwq", True),
            (d + "layer.1.EncDecAttention.k.weight", "decoder.cwk", True),
            (d + "layer.1.EncDecAttention.v.weight", "decoder.cwv", True),
            (d + "layer.1.EncDecAttention.o.weight", "decoder.cwo", True),
            (d + "layer.1.layer_norm.weight", "decoder.cln", False),
            (d + "layer.2.DenseReluDense.wo.weight", "decoder.wo_ff", True),
            (d + "layer.2.layer_norm.weight", "decoder.ln2", False),
        ]
        return maps + self._ffn_in_mappings(d + "layer.2.", "decoder")

    def _ffn_in_mappings(self, prefix: str, stack: str):
        if self.gated:
            return [(prefix + "DenseReluDense.wi_0.weight", f"{stack}.wi0",
                     True),
                    (prefix + "DenseReluDense.wi_1.weight", f"{stack}.wi1",
                     True)]
        return [(prefix + "DenseReluDense.wi.weight", f"{stack}.wi", True)]

    def hf_global_mappings(self) -> List[Tuple[str, str, bool]]:
        maps = [
            ("shared.weight", "embed", False),
            ("encoder.embed_tokens.weight", "embed", False),
            ("encoder.final_layer_norm.weight", "enc_final_ln", False),
            ("decoder.final_layer_norm.weight", "dec_final_ln", False),
            ("encoder.block.0.layer.0.SelfAttention."
             "relative_attention_bias.weight", "enc_rel_bias", False),
            ("decoder.block.0.layer.0.SelfAttention."
             "relative_attention_bias.weight", "dec_rel_bias", False),
        ]
        if not self.tie_word_embeddings:
            maps.append(("lm_head.weight", "lm_head", True))
        return maps

    def hf_aux_mappings(self) -> List[Tuple[str, str, bool, int]]:
        """(hf_template, our_path, transpose, count): the encoder stack,
        whose layer count is its own."""
        e = "encoder.block.{i}."
        pairs = [
            (e + "layer.0.SelfAttention.q.weight", "encoder.wq", True),
            (e + "layer.0.SelfAttention.k.weight", "encoder.wk", True),
            (e + "layer.0.SelfAttention.v.weight", "encoder.wv", True),
            (e + "layer.0.SelfAttention.o.weight", "encoder.wo", True),
            (e + "layer.0.layer_norm.weight", "encoder.ln1", False),
            (e + "layer.1.DenseReluDense.wo.weight", "encoder.wo_ff", True),
            (e + "layer.1.layer_norm.weight", "encoder.ln2", False),
        ] + self._ffn_in_mappings(e + "layer.1.", "encoder")
        return [(t, p, tr, self.enc_layers) for t, p, tr in pairs]

    def hf_split_mappings(self) -> list:
        return []

    def hf_expert_mappings(self) -> list:
        return []

    def finalize_params(self, params: Dict[str, Any]) -> None:
        """Nothing to do: every tensor maps as it is stored."""

    # ---- shared pieces -------------------------------------------------

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        """"gelu" is GELU's tanh form, as in the JAX model."""
        if self.act == "relu":
            return torch.relu(x)
        return torch.nn.functional.gelu(x, approximate="tanh")

    def _ffn(self, lp: Dict[str, torch.Tensor], layer: int,
             x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = (self._act(x @ lp["wi0"][layer].float())
                 * (x @ lp["wi1"][layer].float()))
        else:
            h = self._act(x @ lp["wi"][layer].float())
        return h @ lp["wo_ff"][layer].float()

    def _heads(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (x @ w.float()).reshape(x.shape[0], self.num_heads,
                                       self.head_dim)

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
        x = params["embed"][tokens].float()
        E = x.shape[0]
        key_ok = torch.arange(E, device=x.device) < enc_len
        rel = positions[None, :] - positions[:, None]  # k - q
        bucket = t5_relative_bucket(rel, True, self.num_buckets,
                                    self.max_distance)
        bias = params["enc_rel_bias"].float()[bucket].permute(2, 0, 1)
        for layer in range(self.enc_layers):
            h = _rms(x, lp["ln1"][layer], self.rms_eps)
            q = self._heads(h, lp["wq"][layer])
            k = self._heads(h, lp["wk"][layer])
            v = self._heads(h, lp["wv"][layer])
            scores = torch.einsum("qhd,khd->hqk", q, k) + bias
            scores = torch.where(key_ok[None, None, :], scores, MASK_VALUE)
            o = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1),
                             v).reshape(E, -1)
            x = x + o @ lp["wo"][layer].float()
            x = x + self._ffn(lp, layer, _rms(x, lp["ln2"][layer],
                                               self.rms_eps))
        x = _rms(x, params["enc_final_ln"], self.rms_eps)
        dec = params["decoder"]
        for layer in range(self.num_layers):
            write_kv(cross_kv[layer], self._heads(x, dec["cwk"][layer]),
                     self._heads(x, dec["cwv"][layer]), slot_mapping)

    # ---- decoder -------------------------------------------------------

    def forward(self, params: Dict[str, Any], kv_cache: torch.Tensor,
                batch: ForwardBatch, kv_scales=None,
                cross_kv: torch.Tensor = None) -> torch.Tensor:
        """The decoder over the batch: writes the new tokens' K/V into
        kv_cache in place, reads the sequences' encoder K/V from cross_kv
        and returns the final-normed hidden states [T, H] in the model
        dtype. kv_scales are not read (see the module's docstring)."""
        lp = params["decoder"]
        T = batch.token_ids.shape[0]
        x = params["embed"][batch.token_ids].float()
        seq_of = sequence_of_tokens(batch)
        table = params["dec_rel_bias"].float().t()  # [H, NB]
        meta = (self.num_buckets, self.max_distance)
        for layer in range(self.num_layers):
            h = _rms(x, lp["ln1"][layer], self.rms_eps)
            q = self._heads(h, lp["wq"][layer])
            pages = write_kv(kv_cache[layer], self._heads(h, lp["wk"][layer]),
                             self._heads(h, lp["wv"][layer]),
                             batch.slot_mapping)
            if batch.cu_q_lens is None:
                o = paged_decode_attention(
                    q.to(torch.bfloat16), pages, batch.kv_lens,
                    batch.page_indices, batch.num_seqs, sm_scale=1.0,
                    rel_bias=table, rel_bias_meta=meta).float()
            else:
                o = ref_ragged_paged_attention(
                    q, pages, batch.kv_lens, batch.page_indices,
                    batch.cu_q_lens, batch.num_seqs, sm_scale=1.0,
                    rel_bias=table, rel_bias_meta=meta)
            x = x + o.reshape(T, -1) @ lp["wo"][layer].float()
            h = _rms(x, lp["cln"][layer], self.rms_eps)
            co = cross_attention(self._heads(h, lp["cwq"][layer]),
                                 cross_kv[layer], batch, seq_of)
            x = x + co.reshape(T, -1) @ lp["cwo"][layer].float()
            x = x + self._ffn(lp, layer, _rms(x, lp["ln2"][layer],
                                               self.rms_eps))
        return _rms(x, params["dec_final_ln"], self.rms_eps).to(self.dtype)

    def compute_logits(self, params: Dict[str, Any],
                       hidden: torch.Tensor) -> torch.Tensor:
        """hidden [S, H] -> f32 logits [S, V]; a tied head scales the
        hidden state by d_model**-0.5 first, as HF does."""
        h = hidden.float()
        if self.tie_word_embeddings:
            h = h * self.hidden_size**-0.5
            return h @ params["embed"].float().t()
        return h @ params["lm_head"].float()

