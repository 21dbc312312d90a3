"""Per-step sampling tensors.

TPU-native counterpart of the reference's ``SamplingMetadata.prepare()`` +
``SamplingTensors.from_sampling_metadata`` (aphrodite/modeling/
sampling_metadata.py): for the S sampled rows of a step, build one [S]
device array per sampler knob plus static batch-level flags. The flags are
*trace-time* booleans — each distinct flag set selects a different compiled
step program, so batches that use no advanced samplers pay nothing for them
(the reference's TPU backend simply dropped all of these,
tpu_model_runner.py:431-481; we run them in-graph).
"""

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Sequence as Seq, Tuple

import numpy as np

from aphrodite_tpu_torch.common.sampling_params import (SamplingParams,
                                                  SamplingType, _SAMPLING_EPS)

# Static caps (graph-shape constants).
MAX_DRY_BREAKERS = 16
MAX_STOP_TOKENS = 16
MAX_BANNED_TOKENS = 64


class SamplingFlags(NamedTuple):
    """Hashable trace-time switches: which sampler stages exist in the
    compiled program (reference `do_*` booleans, sampler.py:277-293)."""

    do_penalties: bool = False
    do_dry: bool = False
    do_no_repeat_ngram: bool = False
    do_temperatures: bool = False
    do_top_p_top_k: bool = False
    do_top_as: bool = False
    do_min_p: bool = False
    do_tfss: bool = False
    do_eta_cutoffs: bool = False
    do_epsilon_cutoffs: bool = False
    do_typical_ps: bool = False
    do_quadratic: bool = False
    do_xtc: bool = False
    do_nsigmas: bool = False
    do_skew: bool = False
    do_temp_last: bool = False
    do_min_tokens: bool = False
    do_banned_tokens: bool = False
    do_beam: bool = False
    # Guided decoding: a packed allow-bitmask is applied to the logits
    # (set by the runner, which owns the per-sequence FSM states).
    do_guided: bool = False
    all_greedy: bool = True
    # Number of top logprobs to return (0 = only the sampled token's).
    max_logprobs: int = 0
    # Top prompt-logprobs per prefill position (0 = disabled). Set by the
    # runner (it knows which rows are prefill chunks).
    max_prompt_logprobs: int = 0
    # User-reordered sampler stages (SamplerID ints; None = default
    # order). Like the reference, the first request's priority governs
    # the batch (sampler.py:300 uses seq_groups[0]).
    priority_order: Optional[Tuple[int, ...]] = None

    @property
    def needs_history(self) -> bool:
        return self.do_penalties or self.do_dry or self.do_no_repeat_ngram


class SamplingTensors(NamedTuple):
    """[S]-shaped device inputs for the in-graph sampler. All float arrays
    are f32; integer arrays i32. Built as host numpy and passed into jit."""

    temperature: Any  # f32[S] (1.0 for greedy rows)
    dynatemp_min: Any  # f32[S]
    dynatemp_max: Any  # f32[S]
    dynatemp_exp: Any  # f32[S]
    top_p: Any  # f32[S]
    top_k: Any  # i32[S] (vocab_size when disabled)
    top_a: Any  # f32[S]
    min_p: Any  # f32[S]
    tfs: Any  # f32[S]
    eta_cutoff: Any  # f32[S] (already scaled by 1e-4 like the reference)
    epsilon_cutoff: Any  # f32[S] (scaled by 1e-4)
    typical_p: Any  # f32[S]
    smoothing_factor: Any  # f32[S]
    smoothing_curve: Any  # f32[S]
    xtc_threshold: Any  # f32[S]
    xtc_probability: Any  # f32[S]
    nsigma: Any  # f32[S]
    skew: Any  # f32[S]
    presence_penalty: Any  # f32[S]
    frequency_penalty: Any  # f32[S]
    repetition_penalty: Any  # f32[S]
    no_repeat_ngram_size: Any  # i32[S]
    dry_multiplier: Any  # f32[S]
    dry_base: Any  # f32[S]
    dry_allowed_length: Any  # i32[S]
    dry_range: Any  # i32[S] (0 = unlimited)
    dry_breakers: Any  # i32[S, MAX_DRY_BREAKERS], padded with -1
    greedy_mask: Any  # bool[S]
    # Per-row PRNG key data (uint32[S, 2]): folds (seed, step) host-side.
    key_data: Any
    # min_tokens handling: rows still below min_tokens get their stop
    # tokens banned (reference _apply_min_tokens_penalty, sampler.py:705).
    min_tokens_mask: Any  # bool[S]
    stop_tokens: Any  # i32[S, MAX_STOP_TOKENS], padded with -1
    banned_tokens: Any  # i32[S, MAX_BANNED_TOKENS], padded with -1


@dataclass
class SamplerInputRow:
    """Host-side description of one sampled row."""

    params: SamplingParams
    # Full token history (prompt + generated), for penalties/DRY/ngram.
    token_ids: List[int]
    prompt_len: int
    generated_len: int
    seed: int  # engine-assigned when params.seed is None
    eos_token_id: Optional[int] = None


def _mix32(*vals: int) -> int:
    """Deterministic 32-bit mix of integers (splitmix-style)."""
    h = 0x9E3779B9
    for v in vals:
        v &= 0xFFFFFFFF
        h ^= v + 0x9E3779B9 + ((h << 6) & 0xFFFFFFFF) + (h >> 2)
        h &= 0xFFFFFFFF
    return h


def build_sampling_tensors(
    rows: Seq[SamplerInputRow],
    padded_size: int,
    vocab_size: int,
    history_pad: int = 0,
) -> Tuple[SamplingTensors, SamplingFlags, Optional[np.ndarray],
           Optional[np.ndarray]]:
    """Build (tensors, flags, token_history, history_prompt_lens).

    token_history is i32[S, history_pad] padded with `vocab_size` (the
    reference's padding convention, sampling_metadata.py) and only returned
    when a history-dependent sampler is active.
    """
    S = padded_size
    n = len(rows)
    assert n <= S

    def farr(fill: float) -> np.ndarray:
        return np.full((S,), fill, dtype=np.float32)

    def iarr(fill: int) -> np.ndarray:
        return np.full((S,), fill, dtype=np.int32)

    t = SamplingTensors(
        temperature=farr(1.0),
        dynatemp_min=farr(0.0),
        dynatemp_max=farr(0.0),
        dynatemp_exp=farr(1.0),
        top_p=farr(1.0),
        top_k=iarr(vocab_size),
        top_a=farr(0.0),
        min_p=farr(0.0),
        tfs=farr(1.0),
        eta_cutoff=farr(0.0),
        epsilon_cutoff=farr(0.0),
        typical_p=farr(1.0),
        smoothing_factor=farr(0.0),
        smoothing_curve=farr(1.0),
        xtc_threshold=farr(0.1),
        xtc_probability=farr(0.0),
        nsigma=farr(0.0),
        skew=farr(0.0),
        presence_penalty=farr(0.0),
        frequency_penalty=farr(0.0),
        repetition_penalty=farr(1.0),
        no_repeat_ngram_size=iarr(0),
        dry_multiplier=farr(0.0),
        dry_base=farr(1.75),
        dry_allowed_length=iarr(2),
        dry_range=iarr(0),
        dry_breakers=np.full((S, MAX_DRY_BREAKERS), -1, dtype=np.int32),
        greedy_mask=np.ones((S,), dtype=bool),
        key_data=np.zeros((S, 2), dtype=np.uint32),
        min_tokens_mask=np.zeros((S,), dtype=bool),
        stop_tokens=np.full((S, MAX_STOP_TOKENS), -1, dtype=np.int32),
        banned_tokens=np.full((S, MAX_BANNED_TOKENS), -1, dtype=np.int32),
    )

    flags = dict(
        do_penalties=False, do_dry=False, do_no_repeat_ngram=False,
        do_temperatures=False, do_top_p_top_k=False, do_top_as=False,
        do_min_p=False, do_tfss=False, do_eta_cutoffs=False,
        do_epsilon_cutoffs=False, do_typical_ps=False, do_quadratic=False,
        do_xtc=False, do_nsigmas=False, do_skew=False, do_temp_last=False,
        do_min_tokens=False, do_banned_tokens=False, do_beam=False,
        all_greedy=True, max_logprobs=0, priority_order=None,
    )

    for i, row in enumerate(rows):
        p = row.params
        greedy = p.sampling_type in (SamplingType.GREEDY,
                                     SamplingType.BEAM)
        t.greedy_mask[i] = greedy
        if p.use_beam_search:
            # Beam rows need 2*width candidate logprobs for host-side
            # expansion (reference beam search, sampler.py:1124-1273).
            flags["do_beam"] = True
            flags["max_logprobs"] = max(flags["max_logprobs"],
                                        min(2 * p.best_of, 32))
        if not greedy:
            flags["all_greedy"] = False
            t.temperature[i] = max(p.temperature, 2e-5)
            if abs(p.temperature - 1.0) > _SAMPLING_EPS:
                flags["do_temperatures"] = True
            if p.dynatemp_min > 0 or p.dynatemp_max > 0:
                flags["do_temperatures"] = True
                t.dynatemp_min[i] = p.dynatemp_min
                t.dynatemp_max[i] = p.dynatemp_max
                t.dynatemp_exp[i] = p.dynatemp_exponent
            if p.temperature_last:
                flags["do_temp_last"] = True
            t.top_p[i] = p.top_p
            t.top_k[i] = p.top_k if p.top_k > 0 else vocab_size
            if p.top_p < 1.0 - _SAMPLING_EPS or (0 < p.top_k < vocab_size):
                flags["do_top_p_top_k"] = True
            if p.top_a > 0:
                flags["do_top_as"] = True
                t.top_a[i] = p.top_a
            if p.min_p > _SAMPLING_EPS:
                flags["do_min_p"] = True
                t.min_p[i] = p.min_p
            if p.tfs < 1.0 - _SAMPLING_EPS:
                flags["do_tfss"] = True
                t.tfs[i] = p.tfs
            if p.eta_cutoff > _SAMPLING_EPS:
                flags["do_eta_cutoffs"] = True
                # Reference scales eta/epsilon by 1e-4
                # (sampling_metadata.py from_sampling_metadata).
                t.eta_cutoff[i] = p.eta_cutoff * 1e-4
            if p.epsilon_cutoff > _SAMPLING_EPS:
                flags["do_epsilon_cutoffs"] = True
                t.epsilon_cutoff[i] = p.epsilon_cutoff * 1e-4
            if p.typical_p < 1.0 - _SAMPLING_EPS:
                flags["do_typical_ps"] = True
                t.typical_p[i] = p.typical_p
            if p.smoothing_factor > _SAMPLING_EPS:
                flags["do_quadratic"] = True
                t.smoothing_factor[i] = p.smoothing_factor
                t.smoothing_curve[i] = p.smoothing_curve
            if p.xtc_probability > _SAMPLING_EPS:
                flags["do_xtc"] = True
                t.xtc_threshold[i] = p.xtc_threshold
                t.xtc_probability[i] = p.xtc_probability
            if p.nsigma > _SAMPLING_EPS:
                flags["do_nsigmas"] = True
                t.nsigma[i] = p.nsigma
            if abs(p.skew) > _SAMPLING_EPS:
                flags["do_skew"] = True
                t.skew[i] = p.skew
        # Penalties / history samplers apply to greedy rows too.
        if (abs(p.presence_penalty) >= _SAMPLING_EPS
                or abs(p.frequency_penalty) >= _SAMPLING_EPS
                or abs(p.repetition_penalty - 1.0) >= _SAMPLING_EPS):
            flags["do_penalties"] = True
            t.presence_penalty[i] = p.presence_penalty
            t.frequency_penalty[i] = p.frequency_penalty
            t.repetition_penalty[i] = p.repetition_penalty
        if p.dry_multiplier > _SAMPLING_EPS:
            flags["do_dry"] = True
            t.dry_multiplier[i] = p.dry_multiplier
            t.dry_base[i] = p.dry_base
            t.dry_allowed_length[i] = p.dry_allowed_length
            t.dry_range[i] = p.dry_range
            brk = list(p.dry_sequence_breaker_ids)[:MAX_DRY_BREAKERS]
            t.dry_breakers[i, :len(brk)] = brk
        if p.no_repeat_ngram_size > 0:
            flags["do_no_repeat_ngram"] = True
            t.no_repeat_ngram_size[i] = p.no_repeat_ngram_size
        if p.min_tokens > 0 and row.generated_len < p.min_tokens:
            stop_ids = set(p.all_stop_token_ids)
            if row.eos_token_id is not None and not p.ignore_eos:
                stop_ids.add(row.eos_token_id)
            stop_ids = sorted(stop_ids)[:MAX_STOP_TOKENS]
            if stop_ids:
                flags["do_min_tokens"] = True
                t.min_tokens_mask[i] = True
                t.stop_tokens[i, :len(stop_ids)] = stop_ids
        if p.custom_token_bans:
            bans = list(p.custom_token_bans)[:MAX_BANNED_TOKENS]
            flags["do_banned_tokens"] = True
            t.banned_tokens[i, :len(bans)] = bans
        if p.logprobs:
            flags["max_logprobs"] = max(flags["max_logprobs"],
                                        min(int(p.logprobs), 32))
        if p.sampler_priority is not None and \
                flags["priority_order"] is None:
            flags["priority_order"] = tuple(
                int(x) for x in p.sampler_priority)
        # Per-step PRNG key: mix(seed, step) so each decode step draws fresh
        # randomness while staying deterministic for a given seed. The
        # runner resolves seed precedence when it builds the row (explicit
        # request seed — offset per sibling for seeded n>1 — else the
        # fallback (reference SamplingType.RANDOM_SEED semantics).
        seed = row.seed
        t.key_data[i, 0] = _mix32(seed)
        t.key_data[i, 1] = _mix32(seed, row.generated_len + 1)

    f = SamplingFlags(**flags)

    history = None
    history_lens = None
    prompt_lens = None
    if f.needs_history:
        H = max(history_pad, 8)
        history = np.full((S, H), vocab_size, dtype=np.int32)
        history_lens = np.zeros((S,), dtype=np.int32)
        prompt_lens = np.zeros((S,), dtype=np.int32)
        for i, row in enumerate(rows):
            ids = row.token_ids[-H:] if len(row.token_ids) > H else \
                row.token_ids
            history[i, :len(ids)] = ids
            history_lens[i] = len(ids)
            # Prompt portion inside the (possibly truncated) window.
            kept_from = max(0, len(row.token_ids) - H)
            prompt_lens[i] = max(0, row.prompt_len - kept_from)
    return t, f, history, (history_lens, prompt_lens)
