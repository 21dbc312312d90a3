"""The sampler (counterpart of aphrodite_tpu/sampling/sampler.py: sample).

Ported stages: greedy, temperature (with dynatemp), joint top-k/top-p,
min-p, the sampled token's logprob and rank, and top-k logprobs, in the
JAX package's default order (temperature last when ``temperature_last``)
or a request's ``sampler_priority``. Any ``SamplingFlags`` switch of a
stage not ported here raises NotImplementedError; none is ignored.

Random rows take the Gumbel-argmax of the final log-probs, with noise
drawn from a ``torch.Generator`` on the logits' device. The JAX package
draws per-row threefry streams that torch cannot reproduce, so seeded
rows match it in distribution, not token for token.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from aphrodite_tpu_torch.common.sampling_params import SamplerID
from aphrodite_tpu_torch.sampling.metadata import (SamplingFlags,
                                                   SamplingTensors)

NEG_INF = float("-inf")
_TEMPERATURE_MINIMUM = 2e-5

# Flags of stages this module does not port yet.
_UNPORTED_FLAGS = (
    "do_penalties", "do_dry", "do_no_repeat_ngram", "do_top_as", "do_tfss",
    "do_eta_cutoffs", "do_epsilon_cutoffs", "do_typical_ps", "do_quadratic",
    "do_xtc", "do_nsigmas", "do_skew", "do_min_tokens", "do_banned_tokens",
    "do_beam", "do_guided", "max_prompt_logprobs")


class SamplerOutput(NamedTuple):
    """Device results of one sampling call (all [S]-leading)."""

    sampled: Any  # i32[S] sampled token ids
    sampled_logprob: Any  # f32[S] logprob of the sampled token
    sampled_rank: Any  # i32[S] 1-based rank of the sampled token
    topk_ids: Any  # i32[S, K] (K = flags.max_logprobs; [S, 0] if disabled)
    topk_logprobs: Any  # f32[S, K]


def tensors_to_device(t: SamplingTensors,
                      device: torch.device) -> SamplingTensors:
    """The host (numpy) sampling tensors as tensors on `device` (the
    uint32 key data, which this sampler does not read, as int64)."""
    return SamplingTensors(*(torch.from_numpy(
        a.astype(np.int64) if a.dtype == np.uint32 else a).to(device)
        for a in t))


def _apply_temperatures(logits: torch.Tensor,
                        t: SamplingTensors) -> torch.Tensor:
    """Temperature + entropy-adaptive dynatemp."""
    temps = t.temperature
    dyn_mask = (t.dynatemp_min != 0) | (t.dynatemp_max != 0)
    shifted = torch.log_softmax(logits, dim=-1)
    probs = shifted.exp()
    ent = -torch.where(probs > 0, probs * shifted, 0.0).sum(dim=-1)
    num_valid = (logits > NEG_INF).sum(dim=-1).float()
    max_ent = torch.log(torch.clamp(num_valid, min=2.0))
    norm_ent = ent / max_ent
    dyn_temp = (t.dynatemp_min + (t.dynatemp_max - t.dynatemp_min) *
                norm_ent**t.dynatemp_exp)
    temps = torch.where(dyn_mask, dyn_temp, temps)
    temps = torch.where(torch.isnan(temps), _TEMPERATURE_MINIMUM, temps)
    temps = torch.clamp(temps, min=_TEMPERATURE_MINIMUM)
    # Low temperatures shift the max logit to 1 to avoid saturation.
    low = temps < 0.1
    shift = logits.max(dim=-1, keepdim=True).values - 1.0
    logits = torch.where(low[:, None], logits - shift, logits)
    return logits / temps[:, None]


def _apply_top_k_top_p(logits: torch.Tensor,
                       t: SamplingTensors) -> torch.Tensor:
    """Joint top-k + top-p in one sorted pass."""
    logits_sort, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                       stable=True)
    ranks = torch.arange(logits.shape[1], device=logits.device)[None, :]
    keep_k = ranks < t.top_k[:, None]
    probs_sort = torch.softmax(logits_sort, dim=-1)
    cum = torch.cumsum(probs_sort, dim=-1)
    # Keep tokens while the cumulative mass *before* them is < top_p.
    keep_p = (cum - probs_sort) < t.top_p[:, None]
    keep_p[:, 0] = True  # always keep the top token
    logits_sort = torch.where(keep_k & keep_p, logits_sort, NEG_INF)
    return torch.empty_like(logits).scatter_(1, sort_idx, logits_sort)


def _apply_min_p(logits: torch.Tensor, t: SamplingTensors) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    top = probs.max(dim=-1, keepdim=True).values
    return torch.where(probs < t.min_p[:, None] * top, NEG_INF, logits)


def shaped_logprobs(logits: torch.Tensor, t: SamplingTensors,
                    flags: SamplingFlags) -> torch.Tensor:
    """The post-pipeline log-distribution [S, V]."""
    unported = [f for f in _UNPORTED_FLAGS if getattr(flags, f)]
    if unported:
        raise NotImplementedError(
            f"sampler stages {unported} are not ported to the PyTorch "
            "package yet")
    stages = {
        SamplerID.TEMPERATURE: (flags.do_temperatures, _apply_temperatures),
        SamplerID.TOP_P_TOP_K: (flags.do_top_p_top_k, _apply_top_k_top_p),
        SamplerID.MIN_P: (flags.do_min_p, _apply_min_p),
    }
    if flags.priority_order is not None:
        order = [int(s) for s in flags.priority_order]
    else:
        order = [SamplerID.TEMPERATURE, SamplerID.TOP_P_TOP_K,
                 SamplerID.MIN_P]
        if flags.do_temp_last:
            order = order[1:] + order[:1]
    logits = logits.float()
    for sid in order:
        enabled, stage = stages.get(sid, (False, None))
        if enabled:
            logits = stage(logits, t)
    return torch.log_softmax(logits, dim=-1)


def sample(
    logits: torch.Tensor,  # f32[S, V]
    t: SamplingTensors,  # fields as tensors on the logits' device
    flags: SamplingFlags,
    generator: Optional[torch.Generator] = None,
) -> SamplerOutput:
    """Run the sampler pipeline and draw one token per row."""
    S, V = logits.shape
    logprobs = shaped_logprobs(logits, t, flags)
    greedy_choice = torch.argmax(logprobs, dim=-1)
    if flags.all_greedy:
        sampled = greedy_choice
    else:
        # Gumbel-argmax: G = -log(-log(U)). U == 0 gives G = -inf (that
        # token is not drawn), and U < 1 keeps G finite.
        u = torch.rand(logprobs.shape, generator=generator,
                       device=logprobs.device)
        noised = torch.where(torch.isfinite(logprobs),
                             logprobs - torch.log(-torch.log(u)), NEG_INF)
        sampled = torch.where(t.greedy_mask, greedy_choice,
                              torch.argmax(noised, dim=-1))
    sampled_lp = logprobs.gather(1, sampled[:, None])[:, 0]
    sampled_rank = (logprobs > sampled_lp[:, None]).sum(dim=-1) + 1
    if flags.max_logprobs > 0:
        topk_lp, topk_ids = torch.topk(logprobs, flags.max_logprobs, dim=-1)
    else:
        topk_lp = logprobs.new_zeros((S, 0))
        topk_ids = torch.zeros((S, 0), dtype=torch.int32,
                               device=logits.device)
    return SamplerOutput(
        sampled=sampled.int(),
        sampled_logprob=sampled_lp,
        sampled_rank=sampled_rank.int(),
        topk_ids=topk_ids.int(),
        topk_logprobs=topk_lp,
    )
