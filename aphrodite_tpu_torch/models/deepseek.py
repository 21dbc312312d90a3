"""DeepSeek's multi-head latent attention (MLA) on the dense stack
(counterpart of aphrodite_tpu/models/deepseek.py: DeepseekV3ForCausalLM,
its MLA half: ``_init_mla``, the cache geometry, the MLA parameters and
their HF names, ``attention_mla``, ``attention_mla_latent`` and the dense
layers). MiniCPM3 (models/minicpm.py) serves on it. The MoE half (routed
and shared experts, the v1/v2/v3 routers) waits for ROADMAP.md §1 item 7,
so a config that names routed experts raises here, and the registry keeps
the DeepSeek architectures waiting.

Per layer: h = RMSNorm(x); q from the low-rank pair q_a, q_a_norm, q_b
(or wq where the config has no q_lora_rank), split per head into a
qk_nope_head_dim part and a qk_rope_head_dim part that is rotated; from
kv_a one shared latent of kv_lora_rank values (RMS-normalized by
kv_a_norm) and one rope key for all heads; kv_b expands the latent into
each head's nope key and value. Two forms, by the JAX package's switch
``APHRODITE_MLA_LATENT`` (read at init, default "1"):

- latent (``attention_mla_latent``): the cache holds ONE head per token,
  K = [latent | roped k] and V = [latent], both zero-padded to head_eff =
  cdiv(kv_lora_rank + qk_rope_head_dim, 128) * 128 (MiniCPM3-4B: 288 ->
  384); the query absorbs kv_b's key half (``q_lat``, an einsum over
  kv_b, in the model dtype) and the attention output its value half
  (``attn_v``): ragged paged attention at head_dim head_eff with all
  query heads on one kv head. The cache is kv_lora_rank + rope values a
  token and layer instead of 2 x heads x qk_dim (MiniCPM3-4B: 1536 bytes
  in bf16 against 15360). Head_dim 384 is the ragged kernel's alone
  (ops/decode_attention.py ``RAGGED_ONLY_HEAD_DIMS``): a pure-decode step
  launches it over the window's static arange (``decode_cu_q_lens``), as
  the JAX package sends decode at a head_dim its decode kernel lacks to
  its ragged kernel.
- materialized (``attention_mla``): per-head K = [k_nope | roped k] and
  V zero-padded to qk_dim, QH/KV 1 at head_dim qk_dim (MiniCPM3-4B: 96),
  on both kernels as they were.

The einsums and products around the attention are torch products, as the
JAX package computes them outside any Pallas kernel. MLA weights stay in
the model dtype (``quantizable_weights`` is empty in both packages), the
projections are not fused, and a narrow cache's scales are not applied:
the JAX forward writes and reads the latent without them.
"""

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.common.utils import cdiv
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.models.layers import (apply_rope,
                                               compute_rope_tables, rms_norm,
                                               silu_and_mul)
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
from aphrodite_tpu_torch.ops.kv_cache import write_kv
from aphrodite_tpu_torch.quantization.qlinear import qmatmul


class DeepseekV3ForCausalLM(LlamaForCausalLM):
    """MLA over the dense stack: every layer a SwiGLU MLP
    (``dense_layers``)."""

    # The body's own rotary tables cover head_dim; MLA rotates only the
    # qk_rope_head_dim part, by tables of its own (``_init_mla``).
    use_rope = False
    # DeepSeek's pairing of the rotated dims; MiniCPM3 takes NeoX's.
    rope_interleave = True

    def __init__(self, model_config: ModelConfig,
                 device: torch.device = torch.device("cpu")) -> None:
        hf = model_config.hf_config
        if int(hf.get("n_routed_experts") or 0):
            raise NotImplementedError(
                f"{model_config.architecture}: the MoE half of the DeepSeek "
                "body (routed and shared experts, the v1/v2/v3 routers) is "
                "not ported to the PyTorch package yet (ROADMAP.md, module "
                "queue item 7, DeepSeek V2/V3); the JAX package "
                "(aphrodite_tpu) serves it")
        super().__init__(model_config, device)
        self._init_mla(hf, device)
        self.num_dense = self.num_layers

    def _init_mla(self, hf: Dict[str, Any], device: torch.device) -> None:
        self.q_rank = hf.get("q_lora_rank")  # None on V2-Lite
        self.kv_rank = int(hf["kv_lora_rank"])
        self.rope_dim = int(hf["qk_rope_head_dim"])
        self.nope_dim = int(hf["qk_nope_head_dim"])
        self.v_dim = int(hf["v_head_dim"])
        self.qk_dim = self.nope_dim + self.rope_dim
        self.sm_scale = self.qk_dim**-0.5
        rs = hf.get("rope_scaling") or {}
        if rs.get("type") == "yarn" and rs.get("mscale_all_dim"):
            factor = float(rs.get("factor", 1.0))
            m = float(rs["mscale_all_dim"])
            mscale = 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0
            self.sm_scale = self.sm_scale * mscale * mscale
        if "rope_interleave" in hf:
            self.rope_interleave = bool(hf["rope_interleave"])
        self.mla_latent = os.environ.get("APHRODITE_MLA_LATENT", "1") != "0"
        lat = self.kv_rank + self.rope_dim
        # Padded to whole 128s on real geometry (MiniCPM3-4B: 288 -> 384),
        # as the JAX package pads it for its kernel's tiling.
        self.head_eff = cdiv(lat, 128) * 128 if lat > 128 else lat
        self._cos, self._sin = compute_rope_tables(
            self.rope_dim, self.max_position, base=self.rope_theta,
            rope_scaling=hf.get("rope_scaling"), device=device)

    # ---- cache geometry --------------------------------------------------

    @property
    def kv_cache_shape_suffix(self) -> Tuple[int, int]:
        if self.mla_latent:
            # One shared latent head: K = [latent | roped k], V = [latent].
            return (2, self.head_eff)
        # Materialized K/V per query head at qk_dim (V zero-padded).
        return (2 * self.num_heads, self.qk_dim)

    # ---- params ----------------------------------------------------------

    def param_shapes(self) -> Dict[str, Any]:
        H, L, NH = self.hidden_size, self.num_layers, self.num_heads
        F = self.intermediate_size
        layers = {
            "input_norm": (L, H),
            "post_norm": (L, H),
            "kv_a": (L, H, self.kv_rank + self.rope_dim),
            "kv_a_norm": (L, self.kv_rank),
            "kv_b": (L, self.kv_rank, NH * (self.nope_dim + self.v_dim)),
            "wo": (L, NH * self.v_dim, H),
        }
        if self.q_rank:
            layers["q_a"] = (L, H, self.q_rank)
            layers["q_a_norm"] = (L, self.q_rank)
            layers["q_b"] = (L, self.q_rank, NH * self.qk_dim)
        else:
            layers["wq"] = (L, H, NH * self.qk_dim)
        shapes: Dict[str, Any] = {
            "embed": (self.vocab_size, H),
            "final_norm": (H,),
            "layers": layers,
            "dense_layers": {"gate": (L, H, F), "up": (L, H, F),
                             "down": (L, F, H)},
        }
        if not self.tie_word_embeddings:
            shapes["lm_head"] = (H, self.vocab_size)
        return shapes

    def fuse_projections(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Nothing to fuse: the MLA projections have different inputs, and
        the JAX package leaves the dense stack's gate and up apart."""
        return params

    def quantizable_weights(self) -> List[str]:
        return []  # the MLA low-rank projections stay full precision

    def hf_param_mappings(self) -> List[Tuple[str, str, bool]]:
        la = "model.layers.{i}."
        maps = [
            (la + "input_layernorm.weight", "layers.input_norm", False),
            (la + "post_attention_layernorm.weight", "layers.post_norm",
             False),
            (la + "self_attn.o_proj.weight", "layers.wo", True),
            (la + "self_attn.kv_a_proj_with_mqa.weight", "layers.kv_a",
             True),
            (la + "self_attn.kv_a_layernorm.weight", "layers.kv_a_norm",
             False),
            (la + "self_attn.kv_b_proj.weight", "layers.kv_b", True),
        ]
        if self.q_rank:
            maps += [
                (la + "self_attn.q_a_proj.weight", "layers.q_a", True),
                (la + "self_attn.q_a_layernorm.weight", "layers.q_a_norm",
                 False),
                (la + "self_attn.q_b_proj.weight", "layers.q_b", True),
            ]
        else:
            maps.append((la + "self_attn.q_proj.weight", "layers.wq", True))
        return maps

    def hf_aux_mappings(self) -> List[Tuple[str, str, bool, int]]:
        la = "model.layers.{i}."
        L = self.num_dense
        return [(la + "mlp.gate_proj.weight", "dense_layers.gate", True, L),
                (la + "mlp.up_proj.weight", "dense_layers.up", True, L),
                (la + "mlp.down_proj.weight", "dense_layers.down", True, L)]

    # ---- forward ---------------------------------------------------------

    def forward(self, params: Dict[str, Any], kv_cache: torch.Tensor,
                batch: ForwardBatch,
                kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """The dense stack over the batch, writing each layer's K/V (latent
        or materialized) into kv_cache [L, pages, page_size, ckv, D] in
        place; returns the final-normed hidden states [T, H]. kv_scales is
        not applied (see the module's note)."""
        del kv_scales
        lp, mp = params["layers"], params["dense_layers"]
        x = params["embed"][batch.token_ids].to(self.dtype)
        if self._embedding_scale is not None:
            x = x * self._embedding_scale
        rope = (self._cos[batch.positions], self._sin[batch.positions])
        attention = (self.attention_mla_latent if self.mla_latent
                     else self.attention_mla)
        for layer in range(self.num_layers):
            o = attention(x, lp, layer, kv_cache[layer], batch, rope)
            x = x + self._branch(o)
            h = rms_norm(x, lp["post_norm"][layer], self.rms_eps)
            act = silu_and_mul(
                qmatmul(h, mp["gate"], layer).to(self.dtype),
                qmatmul(h, mp["up"], layer).to(self.dtype))
            x = x + self._branch(qmatmul(act, mp["down"], layer))
        return rms_norm(x, params["final_norm"], self.rms_eps)

    def _branch(self, y: torch.Tensor) -> torch.Tensor:
        """A block's output in the model dtype, times the residual
        multiplier there (MiniCPM3's scale_depth / sqrt(L)), as the JAX
        forward scales it after the cast."""
        y = y.to(self.dtype)
        if self._residual_scale is not None:
            y = y * self._residual_scale[self.dtype]
        return y

    def _queries(self, x: torch.Tensor, lp: Dict[str, Any],
                 layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """h = RMSNorm(x) and q [T, QH, qk_dim] in the model dtype."""
        h = rms_norm(x, lp["input_norm"][layer], self.rms_eps)
        if self.q_rank:
            qa = rms_norm(qmatmul(h, lp["q_a"], layer).to(self.dtype),
                          lp["q_a_norm"][layer], self.rms_eps)
            q = qmatmul(qa, lp["q_b"], layer)
        else:
            q = qmatmul(h, lp["wq"], layer)
        return h, q.to(self.dtype).reshape(-1, self.num_heads, self.qk_dim)

    def _latent(self, h: torch.Tensor, lp: Dict[str, Any], layer: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The normed latent [T, r] and the unrotated rope key [T, rope]."""
        ckv = qmatmul(h, lp["kv_a"], layer).to(self.dtype)
        latent = rms_norm(ckv[:, :self.kv_rank], lp["kv_a_norm"][layer],
                          self.rms_eps)
        return latent, ckv[:, self.kv_rank:]

    def _kv_b(self, lp: Dict[str, Any], layer: int) -> torch.Tensor:
        """kv_b as [r, QH, nope + v] in the model dtype."""
        return lp["kv_b"][layer].to(self.dtype).reshape(
            self.kv_rank, self.num_heads, self.nope_dim + self.v_dim)

    def attention_mla(self, x, lp, layer, pages, batch, rope) -> torch.Tensor:
        """Materialized MLA: per-head K/V at qk_dim in the cache (V
        zero-padded), QH/KV 1; the attention block's output before its
        residual add, [T, H]."""
        NH = self.num_heads
        neox = not self.rope_interleave
        h, q = self._queries(x, lp, layer)
        latent, k_rot = self._latent(h, lp, layer)
        kvb = qmatmul(latent, lp["kv_b"], layer).to(self.dtype).reshape(
            -1, NH, self.nope_dim + self.v_dim)
        q_rot = apply_rope(q[..., self.nope_dim:], *rope, neox)
        k_rot = apply_rope(k_rot[:, None, :], *rope, neox).expand(
            -1, NH, self.rope_dim)
        q = torch.cat([q[..., :self.nope_dim], q_rot], dim=-1)
        k = torch.cat([kvb[..., :self.nope_dim], k_rot], dim=-1)
        v = torch.nn.functional.pad(kvb[..., self.nope_dim:],
                                    (0, self.qk_dim - self.v_dim))
        pages = write_kv(pages, k, v, batch.slot_mapping)
        attn = ragged_paged_attention(
            q, pages, batch.kv_lens, batch.page_indices, batch.cu_q_lens,
            batch.num_seqs, sm_scale=self.sm_scale)
        attn = attn[..., :self.v_dim].reshape(-1, NH * self.v_dim)
        return qmatmul(attn, lp["wo"], layer)

    def attention_mla_latent(self, x, lp, layer, pages, batch,
                             rope) -> torch.Tensor:
        """Absorbed MLA over the latent cache: score_h(t) = (q_nope_h .
        W_k_h^T) . latent_t + q_rot_h . k_rot_t and out_h = (sum_t p_t
        latent_t) . W_v_h; kv_b never expands into per-token K/V."""
        NH = self.num_heads
        neox = not self.rope_interleave
        h, q = self._queries(x, lp, layer)
        q_rot = apply_rope(q[..., self.nope_dim:], *rope, neox)
        latent, k_rot = self._latent(h, lp, layer)
        k_rot = apply_rope(k_rot[:, None, :], *rope, neox)[:, 0]
        pad = self.head_eff - self.kv_rank - self.rope_dim
        k_w = torch.nn.functional.pad(torch.cat([latent, k_rot], dim=-1),
                                      (0, pad))[:, None, :]
        v_w = torch.nn.functional.pad(
            latent, (0, self.head_eff - self.kv_rank))[:, None, :]
        pages = write_kv(pages, k_w, v_w, batch.slot_mapping)
        kvb = self._kv_b(lp, layer)
        q_lat = torch.einsum("tnd,rnd->tnr", q[..., :self.nope_dim],
                             kvb[..., :self.nope_dim])
        q_eff = torch.nn.functional.pad(torch.cat([q_lat, q_rot], dim=-1),
                                        (0, pad))
        # A pure-decode batch at head_dim_eff 384 attends through the
        # ragged kernel over the window's arange.
        decode = ({} if batch.cu_q_lens is not None
                  else {"decode_cu_q_lens": batch.decode_cu_q_lens})
        attn = ragged_paged_attention(
            q_eff, pages, batch.kv_lens, batch.page_indices,
            batch.cu_q_lens, batch.num_seqs, sm_scale=self.sm_scale,
            **decode)
        attn_v = torch.einsum("tnr,rnd->tnd", attn[..., :self.kv_rank],
                              kvb[..., self.nope_dim:])
        return qmatmul(attn_v.reshape(-1, NH * self.v_dim), lp["wo"], layer)
