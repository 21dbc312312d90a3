"""Functional model layers (counterpart of aphrodite_tpu/models/layers.py).

Plain PyTorch on tensors: RMSNorm, LayerNorm, SiLU-and-mul, GELU-and-mul
(the tanh form), the plain MLP's activations, and rotary position
embedding with the default, linear (position interpolation), dynamic
(NTK-aware), YaRN, DeepSeek-YaRN, Llama-3 and Phi-3 LongRoPE frequency
tables, over a head's leading rotary dims (partial rotary), in the NeoX
(rotate-half) or GPT-J (interleaved) pairing. Also the ALiBi slope
schedule (a copy of aphrodite_tpu/models/bloom.py: get_alibi_slopes).
"""

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32, returned in x's dtype."""
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 (mean-centred, rsqrt(var + eps), then
    weight and bias; without a weight, neither), returned in x's dtype:
    the JAX package's arithmetic."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def silu_and_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up


def gelu_and_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """GeGLU: the tanh form of GELU on the gate, in f32, rounded to the
    gate's dtype, times up (the JAX package's gelu_and_mul with
    approximate="tanh", Gemma's ``gelu_pytorch_tanh``)."""
    return torch.nn.functional.gelu(
        gate.float(), approximate="tanh").to(gate.dtype) * up


def ungated_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The plain MLP's activation in f32 (the JAX package's ``mlp`` with
    ``gated_mlp`` off): "gelu_tanh" (Bloom, StarCoder2), exact "gelu"
    (MPT, Falcon), "relu", or "relu2" (the square of relu)."""
    xf = x.float()
    if kind == "relu":
        return torch.relu(xf)
    if kind == "relu2":
        r = torch.relu(xf)
        return r * r
    if kind in ("gelu", "gelu_tanh"):
        return torch.nn.functional.gelu(
            xf, approximate="tanh" if kind == "gelu_tanh" else "none")
    raise ValueError(f"unknown ungated MLP activation {kind!r}")


def _yarn_correction_dim(num_rotations: float, dim: int, base: float,
                         max_pos: int) -> float:
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def _yarn_ramp_mask(beta_slow: float, beta_fast: float, dim: int,
                    base: float, max_pos: int) -> np.ndarray:
    """1 - YaRN's linear ramp over the dim // 2 frequencies between the
    correction range of beta_slow and beta_fast rotations (f32, as the
    JAX package builds it): 1 keeps a frequency, 0 interpolates it."""
    low = max(math.floor(_yarn_correction_dim(beta_slow, dim, base,
                                              max_pos)), 0)
    high = min(math.ceil(_yarn_correction_dim(beta_fast, dim, base,
                                              max_pos)), dim - 1)
    if low == high:
        high += 0.001
    ramp = (np.arange(dim // 2, dtype=np.float32) - low) / (high - low)
    return 1.0 - np.clip(ramp, 0, 1)


def _yarn_mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def compute_rope_tables(
    rotary_dim: int,
    max_position: int,
    base: float = 10000.0,
    rope_scaling: Optional[Dict[str, Any]] = None,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_position, rotary_dim // 2] in f32,
    computed in float64 on the host, for the rotary_dim leading dims of a
    head (the head_dim without partial rotary). Handles no scaling
    ("default"), "linear" (positions divided by the factor), "dynamic"
    (NTK-aware: the base raised for max_position, evaluated once at the
    served length, as in the JAX package, not per sequence), "yarn" and
    "deepseek_yarn" (frequencies ramped between extrapolation and
    interpolation; both tables times 0.1 ln(factor) + 1, or DeepSeek's
    ratio of the mscale and mscale_all_dim terms), "llama3"
    frequency-band rescaling and Phi-3's "longrope" ("su"): each frequency
    divided by its short factor, or by its long one where max_position
    exceeds the scaling's original_max_position_embeddings (max_position
    when it names none, as in the JAX package), and both tables scaled by
    sqrt(1 + ln(max_position / original) / ln(original)) past it. Any
    other type raises, as the JAX function does."""
    inv_freq = 1.0 / (base**(
        np.arange(0, rotary_dim, 2, dtype=np.float64) / rotary_dim))
    positions = np.arange(max_position, dtype=np.float64)
    attn_factor = 1.0
    if rope_scaling:
        rope_type = rope_scaling.get("rope_type",
                                     rope_scaling.get("type", "default"))
        factor = float(rope_scaling.get("factor", 1.0))
        if rope_type == "linear":
            positions = positions / factor
        elif rope_type == "dynamic":
            orig_max = int(rope_scaling.get(
                "original_max_position_embeddings", max_position / factor))
            scale = max_position / orig_max
            if scale > 1.0:
                adjusted = base * (factor * scale - (factor - 1))**(
                    rotary_dim / (rotary_dim - 2))
                inv_freq = 1.0 / (adjusted**(np.arange(
                    0, rotary_dim, 2, dtype=np.float64) / rotary_dim))
        elif rope_type in ("yarn", "deepseek_yarn"):
            orig_max = int(rope_scaling.get(
                "original_max_position_embeddings", 4096))
            keep = _yarn_ramp_mask(
                float(rope_scaling.get("beta_slow", 1)),
                float(rope_scaling.get("beta_fast", 32)), rotary_dim, base,
                orig_max)
            inv_freq = inv_freq / factor * (1 - keep) + inv_freq * keep
            if rope_type == "yarn":
                attn_factor = (0.1 * math.log(factor) + 1.0
                               if factor > 1 else 1.0)
            else:
                attn_factor = (
                    _yarn_mscale(factor,
                                 float(rope_scaling.get("mscale", 1.0)))
                    / _yarn_mscale(factor, float(
                        rope_scaling.get("mscale_all_dim", 0.0))))
        elif rope_type == "llama3":
            low_freq_factor = float(rope_scaling.get("low_freq_factor", 1.0))
            high_freq_factor = float(
                rope_scaling.get("high_freq_factor", 4.0))
            orig_max = int(
                rope_scaling.get("original_max_position_embeddings", 8192))
            low_freq_wavelen = orig_max / low_freq_factor
            high_freq_wavelen = orig_max / high_freq_factor
            wavelen = 2 * math.pi / inv_freq
            smooth = ((orig_max / wavelen - low_freq_factor) /
                      (high_freq_factor - low_freq_factor))
            inv_freq = np.where(
                wavelen < high_freq_wavelen, inv_freq,
                np.where(wavelen > low_freq_wavelen, inv_freq / factor,
                         (1 - smooth) * (inv_freq / factor)
                         + smooth * inv_freq))
        elif rope_type in ("longrope", "su"):
            orig_max = int(rope_scaling.get(
                "original_max_position_embeddings", max_position))
            factors = (rope_scaling.get("long_factor")
                       if max_position > orig_max else
                       rope_scaling.get("short_factor"))
            if factors:
                inv_freq = inv_freq / np.asarray(factors, dtype=np.float64)
            scale = max_position / orig_max
            if scale > 1.0:
                attn_factor = math.sqrt(
                    1.0 + math.log(scale) / math.log(orig_max))
        elif rope_type not in ("default", None):
            raise ValueError(f"unsupported rope scaling type {rope_type!r}")
    freqs = np.einsum("p,f->pf", positions, inv_freq)
    cos = torch.tensor(np.cos(freqs) * attn_factor, dtype=torch.float32,
                       device=device)
    sin = torch.tensor(np.sin(freqs) * attn_factor, dtype=torch.float32,
                       device=device)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               neox_style: bool = True) -> torch.Tensor:
    """RoPE over the leading cos.shape[-1] * 2 dims of each head, in f32;
    the remaining dims pass through unchanged. x [T, heads, head_dim];
    cos/sin [T, rotary_dim / 2]. neox_style: the rotate-half pairing (dim
    i with i + rotary_dim / 2); else GPT-J's interleaved one (dim 2i with
    2i + 1)."""
    xf = x.float()
    rot = cos.shape[-1] * 2
    c = cos[:, None, :]
    s = sin[:, None, :]
    if neox_style:
        x1, x2 = xf[..., :rot // 2], xf[..., rot // 2:rot]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:
        x1, x2 = xf[..., 0:rot:2], xf[..., 1:rot:2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).flatten(-2)
    if rot < x.shape[-1]:
        out = torch.cat([out, xf[..., rot:]], dim=-1)
    return out.to(x.dtype)


def get_alibi_slopes(num_heads: int) -> np.ndarray:
    """HF/reference ALiBi slope schedule (geometric, with the
    non-power-of-2 head-count correction): f32[num_heads], the same bytes
    as the JAX package's."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** i for i in range(1, closest + 1)]
    if closest != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_extra = min(closest, num_heads - closest)
        slopes += [extra_base ** i for i in range(1, 2 * n_extra + 1, 2)]
    return np.asarray(slopes, dtype=np.float32)
