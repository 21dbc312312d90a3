"""The sampler (counterpart of aphrodite_tpu/sampling/sampler.py): the full
sampling pipeline as PyTorch operations on the logits' device.

Every stage of the JAX package is here: penalties, DRY, no-repeat-ngram,
temperature with dynatemp, top-nsigma, joint top-k/top-p, top-a, min-p,
TFS, eta and epsilon cutoffs, typical-p, quadratic smoothing, XTC and
skew, with min_tokens, banned tokens and the guided allow-mask before
them, in the JAX package's default order (temperature last when
``temperature_last``) or a request's ``sampler_priority``. The
``SamplingFlags`` of a batch select the stages that run. Beam rows are
greedy rows whose top ``max_logprobs`` candidates the engine expands
(``do_beam`` adds no stage). No stage reads a value back to the host or
makes a tensor whose shape depends on the data, so a decode window with
any of the history-free stages can be captured into a CUDA graph.

The two divergences from the reference that the JAX module documents are
kept: top-nsigma's standard deviation is taken over the finite logits
only, and DRY counts the real suffix matches. The pipeline runs in f64
where a stage runs (the logprobs it returns are f32; with no stage, the
log-softmax is taken in f32): a token's fate at a stage's threshold
then does not hang on the last bits of an f32 softmax or cumulative sum,
which differ between the card and the CPU. TFS's CDF is divided by its
own total, so it ends at 1 exactly and a row at tfs 1 keeps every token
but the least likely one (the JAX package's f32 CDF can end above 1 and
drop one more); a row at top_p 1 keeps every token (the JAX package's f32
cumulative mass can reach 1 before the tail and drop tokens whose mass
is below its rounding); skew takes each token's share from the mass
before it without differencing the powered CDF, so a tiny share keeps
its relative accuracy.

Random rows take the Gumbel-argmax of the final log-probs. Each row's
noise comes from its own key (``SamplingTensors.key_data``: the seed and
the generated length, mixed on the host; a decode window advances it on
the device, worker/model_runner.py ``_fold_key_data``) through
threefry2x32, written here in int64 operations: a row's draws depend on
its key and the token index alone, not on the rows around it. The streams
are not the JAX package's bit for bit (the JAX package draws threefry
bits through jax.random's folds), so seeded rows match it in
distribution, not token for token.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from aphrodite_tpu_torch.common.sampling_params import SamplerID
from aphrodite_tpu_torch.sampling.metadata import (SamplingFlags,
                                                   SamplingTensors)

NEG_INF = float("-inf")
# Static cap of the DRY suffix-match length (the JAX package's, :38).
DRY_MAX_NGRAM = 64
# Static cap of no_repeat_ngram_size.
MAX_NGRAM_SIZE = 32
_TEMPERATURE_MINIMUM = 2e-5
# The constants the JAX package folds into a row's key: the Gumbel noise
# and XTC's coin.
GUMBEL_FOLD = 0x5A
XTC_FOLD = 0xC0

# Flags of the stages and masks that shape the distribution: with none of
# them set the log-distribution is the logits' log-softmax, taken in f32.
_SHAPING_FLAGS = (
    "do_penalties", "do_dry", "do_no_repeat_ngram", "do_temperatures",
    "do_top_p_top_k", "do_top_as", "do_min_p", "do_tfss", "do_eta_cutoffs",
    "do_epsilon_cutoffs", "do_typical_ps", "do_quadratic", "do_xtc",
    "do_nsigmas", "do_skew", "do_min_tokens", "do_banned_tokens",
    "do_guided")

_M32 = 0xFFFFFFFF
# threefry2x32's rotations and key-schedule parity (Salmon et al., SC'11).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


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
    uint32 key data as int64)."""
    return SamplingTensors(*(torch.from_numpy(
        a.astype(np.int64) if a.dtype == np.uint32 else a).to(device)
        for a in t))


# ---------------------------------------------------------------------------
# Per-row streams
# ---------------------------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """32-bit rotate left of int64 words under 2^32."""
    return ((x & ((1 << (32 - r)) - 1)) << r) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, c0: torch.Tensor,
                 c1: torch.Tensor):
    """threefry2x32 with 20 rounds on int64 tensors holding 32-bit words
    (keys and counters broadcast together): the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for i in range(20):
        x0 = (x0 + x1) & _M32
        x1 = _rotl(x1, _ROTATIONS[i % 8]) ^ x0
        if i % 4 == 3:
            j = i // 4 + 1
            x0 = (x0 + ks[j % 3]) & _M32
            x1 = (x1 + ks[(j + 1) % 3] + j) & _M32
    return x0, x1


def _fold_in(key_data: torch.Tensor, data: int):
    """Each row's key with `data` folded in: threefry of (0, data)."""
    zero = torch.zeros_like(key_data[:, 0])
    return threefry2x32(key_data[:, 0], key_data[:, 1], zero, zero + data)


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """f32 in (0, 1), exactly, from the top 23 bits of 32-bit words."""
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def row_uniforms(key_data: torch.Tensor, fold: int, n: int) -> torch.Tensor:
    """[S, n] uniforms of each row's stream under `fold`: token j's from
    word j of the threefry blocks of counters 0..ceil(n/2)-1 (the first
    words of every block, then the second words)."""
    k0, k1 = _fold_in(key_data, fold)
    half = (n + 1) // 2
    ctr = torch.arange(half, dtype=torch.int64, device=key_data.device)
    x0, x1 = threefry2x32(k0[:, None], k1[:, None], ctr[None, :], 0)
    return _uniform(torch.cat([x0, x1], dim=1)[:, :n])


# ---------------------------------------------------------------------------
# History-dependent stages (penalties, DRY, no-repeat-ngram)
# ---------------------------------------------------------------------------


def _history_masks(history: torch.Tensor, history_lens: torch.Tensor,
                   prompt_lens: torch.Tensor, vocab_size: int):
    """(prompt_mask[S,V], output_mask[S,V], output_counts[S,V])."""
    S, H = history.shape
    pos = torch.arange(H, device=history.device)[None, :]
    in_prompt = pos < prompt_lens[:, None]
    in_output = (pos >= prompt_lens[:, None]) & (pos < history_lens[:, None])
    idx = history.long()

    # Counts in V + 1 bins: the padding id V lands in the extra bin.
    def count(mask):
        counts = torch.zeros((S, vocab_size + 1), dtype=torch.int32,
                             device=history.device)
        counts.scatter_add_(1, idx, mask.int())
        return counts[:, :vocab_size]

    prompt_counts = count(in_prompt)
    output_counts = count(in_output)
    return prompt_counts > 0, output_counts > 0, output_counts


def _apply_penalties(logits, t: SamplingTensors, prompt_mask, output_mask,
                     output_counts):
    """Repetition, presence and frequency penalties."""
    seen = prompt_mask | output_mask
    rep = torch.where(seen, t.repetition_penalty[:, None], 1.0)
    logits = torch.where(logits > 0, logits / rep, logits * rep)
    logits = logits - t.frequency_penalty[:, None] * output_counts
    logits = logits - t.presence_penalty[:, None] * output_mask
    return logits


def _apply_dry(logits, t: SamplingTensors, history, history_lens,
               vocab_size: int):
    """DRY: for each candidate token, the longest suffix of the context
    that emitting it would repeat, penalized by
    multiplier * base^(match_len - allowed_length). Gathers over fixed
    [S, H, DRY_MAX_NGRAM] grids, as the JAX package's vmap writes them."""
    S, H = history.shape
    dev = history.device
    seq = history.long()
    n = history_lens.long()
    M = DRY_MAX_NGRAM
    pos = torch.arange(H, device=dev)
    rows = torch.arange(S, device=dev)
    rng = t.dry_range.long()
    # Range limit: only the last `rng` tokens participate (0 = all).
    window_start = torch.where(rng > 0, (n - rng).clamp(min=0), 0)
    valid = (pos[None, :] >= window_start[:, None]) & (pos[None, :] < n[:, None])
    breakers = t.dry_breakers.long()  # [S, B], padded with -1
    is_break = (seq[:, :, None] == breakers[:, None, :]).any(-1) & valid
    last = seq[rows, (n - 1).clamp(min=0)]
    last_is_break = (last[:, None] == breakers).any(-1)

    # max_ngram: the break-free tail's length, capped.
    tail_t = torch.arange(1, M + 2, device=dev)
    tail_pos = n[:, None] - 1 - tail_t[None, :]  # [S, M + 1]
    tail_break = (is_break.gather(1, tail_pos.clamp(min=0))
                  | (tail_pos < window_start[:, None]))
    first_break = torch.argmax(tail_break.int(), dim=1) + 1
    max_ngram = torch.where(tail_break.any(1), first_break, M + 1)
    max_ngram = max_ngram.clamp(max=M)

    # cond[s, idx, t] (t = 1..M): seq[idx - t] matches the context suffix
    # seq[n - 1 - t] and is not a break.
    tvec = torch.arange(1, M + 1, device=dev)
    back = pos[:, None] - tvec[None, :]  # [H, M]
    back_c = back.clamp(min=0).reshape(-1)
    back_ok = back[None, :, :] >= window_start[:, None, None]
    suf = (n[:, None] - 1 - tvec[None, :]).clamp(min=0)  # [S, M]
    seq_back = seq.index_select(1, back_c).view(S, H, M)
    brk_back = is_break.index_select(1, back_c).view(S, H, M)
    cond = ((seq_back == seq.gather(1, suf)[:, None, :]) & back_ok
            & ~brk_back & (tvec[None, None, :] < max_ngram[:, None, None]))
    run = torch.cumprod(cond.int(), dim=2).sum(dim=2)  # [S, H]

    is_endpoint = (seq == last[:, None]) & (pos[None, :] < n[:, None] - 1) \
        & valid
    m = torch.where(is_endpoint, run + 1, 0).int()
    nxt = seq[:, (pos + 1).clamp(max=H - 1)]
    ngram_lens = torch.zeros((S, vocab_size + 1), dtype=torch.int32,
                             device=dev)
    ngram_lens = ngram_lens.scatter_reduce(1, nxt, m, reduce="amax")
    ngram_lens = ngram_lens[:, :vocab_size]

    apply_row = ((t.dry_multiplier > 0) & ~last_is_break
                 & (max_ngram > t.dry_allowed_length))
    penalty = t.dry_multiplier[:, None] * torch.pow(
        t.dry_base[:, None],
        ngram_lens.to(logits.dtype) - t.dry_allowed_length[:, None])
    penalty = torch.where((ngram_lens > 0) & apply_row[:, None], penalty, 0.0)
    return logits - penalty


def _apply_no_repeat_ngram(logits, t: SamplingTensors, history,
                           history_lens, vocab_size: int):
    """Ban the tokens that would complete an n-gram already in the
    history (HF-style no_repeat_ngram_size)."""
    S, H = history.shape
    dev = history.device
    pos = torch.arange(H, device=dev)[None, :]  # [1, H]
    k = t.no_repeat_ngram_size.long()[:, None]  # [S, 1]
    n = history_lens.long()[:, None]
    seq = history.long()

    # match[s, idx]: history[idx : idx + k - 1] equals the (k-1)-token
    # tail history[n - k + 1 : n].
    match = torch.ones((S, H), dtype=torch.bool, device=dev)
    for tt in range(MAX_NGRAM_SIZE - 1):
        within = tt < (k - 1)
        a = seq.gather(1, (pos + tt).clamp(max=H - 1).expand(S, H))
        b = seq.gather(1, (n - (k - 1) + tt).clamp(0, H - 1))
        match &= torch.where(within, a == b, True)
    # idx must leave room for the banned token: idx + k - 1 <= n - 1.
    match &= (pos + k - 1) <= (n - 1)
    match &= (k > 0) & (n >= k)

    banned_tok = seq.gather(1, (pos + k - 1).clamp(0, H - 1))  # [S, H]
    ban = torch.zeros((S, vocab_size + 1), dtype=torch.int32, device=dev)
    ban.scatter_add_(1, banned_tok, match.int())
    return torch.where(ban[:, :vocab_size] > 0, NEG_INF, logits)


# ---------------------------------------------------------------------------
# Distribution-shaping stages
# ---------------------------------------------------------------------------


def _neg_entropy(logits):
    """(log_softmax, probs, sum p log p) of each row."""
    shifted = torch.log_softmax(logits, dim=-1)
    probs = shifted.exp()
    neg_ent = torch.where(probs > 0, probs * shifted, 0.0).sum(dim=-1)
    return shifted, probs, neg_ent


def _apply_temperatures(logits, t: SamplingTensors):
    """Temperature + entropy-adaptive dynatemp."""
    temps = t.temperature
    dyn_mask = (t.dynatemp_min != 0) | (t.dynatemp_max != 0)
    _, _, neg_ent = _neg_entropy(logits)
    num_valid = (logits > NEG_INF).sum(dim=-1).to(logits.dtype)
    max_ent = torch.log(torch.clamp(num_valid, min=2.0))
    norm_ent = -neg_ent / max_ent
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


def _sort_desc(x):
    """Descending sort, ties in index order (jnp.argsort of -x)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _unsort(sorted_vals, sort_idx):
    """Put values of sorted order back at their tokens."""
    return torch.empty_like(sorted_vals).scatter_(1, sort_idx, sorted_vals)


def _apply_top_k_top_p(logits, t: SamplingTensors):
    """Joint top-k + top-p in one sorted pass."""
    logits_sort, sort_idx = _sort_desc(logits)
    ranks = torch.arange(logits.shape[1], device=logits.device)[None, :]
    keep_k = ranks < t.top_k[:, None]
    probs_sort = torch.softmax(logits_sort, dim=-1)
    cum = torch.cumsum(probs_sort, dim=-1)
    # Keep tokens while the cumulative mass *before* them is < top_p; a
    # row at top_p 1 keeps them all (on the tail that mass is 1 give or
    # take the sum's rounding, which differs between devices).
    keep_p = ((cum - probs_sort) < t.top_p[:, None]) | (
        t.top_p[:, None] >= 1.0)
    keep_p[:, 0] = True  # always keep the top token
    logits_sort = torch.where(keep_k & keep_p, logits_sort, NEG_INF)
    return _unsort(logits_sort, sort_idx)


def _apply_min_p(logits, t: SamplingTensors):
    probs = torch.softmax(logits, dim=-1)
    top = probs.max(dim=-1, keepdim=True).values
    return torch.where(probs < t.min_p[:, None] * top, NEG_INF, logits)


def _apply_top_a(logits, t: SamplingTensors):
    probs = torch.softmax(logits, dim=-1)
    top = probs.max(dim=-1, keepdim=True).values
    threshold = top * top * t.top_a[:, None]
    return torch.where(probs < threshold, NEG_INF, logits)


def _apply_tfs(logits, t: SamplingTensors):
    """Tail-free sampling through the CDF of the curvature."""
    S = logits.shape[0]
    logits_sort, sort_idx = _sort_desc(logits)
    probs = torch.softmax(logits_sort, dim=-1)
    d2 = torch.diff(torch.diff(probs, dim=-1), dim=-1).abs()  # [S, V-2]
    denom = d2.sum(dim=-1, keepdim=True)
    norm_d2 = d2 / torch.where(denom == 0, 1.0, denom)
    # The CDF over its own total: it ends at 1 exactly, so a row with tfs
    # 1 keeps every token but the last, on every device.
    cdf = torch.cumsum(norm_d2, dim=-1)
    total = cdf[:, -1:]
    cdf = cdf / torch.where(total == 0, 1.0, total)
    drop = torch.cat([
        torch.zeros((S, 1), dtype=torch.bool, device=logits.device),
        cdf > t.tfs[:, None],
        torch.ones((S, 1), dtype=torch.bool, device=logits.device)], dim=-1)
    logits_sort = torch.where(drop, NEG_INF, logits_sort)
    return _unsort(logits_sort, sort_idx)


def _keep_argmax(remove, probs):
    """Never remove the most likely token."""
    top = torch.argmax(probs, dim=-1, keepdim=True)
    return remove.scatter(1, top, False)


def _apply_eta_cutoff(logits, t: SamplingTensors):
    _, probs, neg_ent = _neg_entropy(logits)
    eps = torch.minimum(t.eta_cutoff,
                        torch.sqrt(t.eta_cutoff) * torch.exp(neg_ent))
    remove = (probs < eps[:, None]) & (t.eta_cutoff[:, None] > 0)
    remove = _keep_argmax(remove, probs)
    return torch.where(remove, NEG_INF, logits)


def _apply_epsilon_cutoff(logits, t: SamplingTensors):
    probs = torch.softmax(logits, dim=-1)
    remove = (probs < t.epsilon_cutoff[:, None]) & (
        t.epsilon_cutoff[:, None] > 0)
    remove = _keep_argmax(remove, probs)
    return torch.where(remove, NEG_INF, logits)


def _apply_typical(logits, t: SamplingTensors):
    """Locally typical sampling."""
    shifted, probs, neg_ent = _neg_entropy(logits)
    surprisal_dev = (neg_ent[:, None] - shifted).abs()
    # Ascending deviation, ties in index order.
    _, order = torch.sort(surprisal_dev, dim=-1, stable=True)
    cum = torch.cumsum(probs.gather(1, order), dim=-1)
    remove_sorted = cum >= t.typical_p[:, None]
    remove_sorted[:, 0] = False  # keep at least one token
    remove = _unsort(remove_sorted, order)
    remove &= t.typical_p[:, None] < 1.0
    return torch.where(remove, NEG_INF, logits)


def _apply_quadratic(logits, t: SamplingTensors):
    """Quadratic / cubic smoothing."""
    factor = t.smoothing_factor[:, None]
    k = factor * (3 - t.smoothing_curve[:, None]) / 2
    s = factor * (t.smoothing_curve[:, None] - 1) / 2
    mx = logits.max(dim=-1, keepdim=True).values
    diff = logits - mx
    transformed = diff - (diff * diff) * (s * diff - k)
    transformed = torch.where(torch.isfinite(transformed), transformed, 0.0)
    return torch.where(factor != 0, logits - transformed, logits)


def _apply_xtc(logits, t: SamplingTensors):
    """Exclude top choices: with probability xtc_probability (a coin from
    the row's key folded with XTC_FOLD), drop every token whose
    probability clears the threshold except the least likely of them."""
    V = logits.shape[1]
    coin = row_uniforms(t.key_data, XTC_FOLD, 1)[:, 0]
    apply_row = coin < t.xtc_probability  # [S]
    probs = torch.softmax(logits, dim=-1)
    sorted_probs, sort_idx = _sort_desc(probs)
    # count = #{i >= 1 : p_sorted[i] >= threshold}; remove sorted ranks
    # [0, count): the top choices minus the lowest qualifying one.
    above = sorted_probs[:, 1:] >= t.xtc_threshold[:, None]
    count = above.sum(dim=-1, keepdim=True)
    ranks = torch.arange(V, device=logits.device)[None, :]
    remove = _unsort(ranks < count, sort_idx) & apply_row[:, None]
    return torch.where(remove, NEG_INF, logits)


def _apply_top_nsigma(logits, t: SamplingTensors):
    """Top-nsigma, the standard deviation over finite logits only."""
    finite = torch.isfinite(logits)
    cnt = finite.sum(dim=-1, keepdim=True).to(logits.dtype)
    safe = torch.where(finite, logits, 0.0)
    mean = safe.sum(dim=-1, keepdim=True) / cnt.clamp(min=1.0)
    var = torch.where(finite, (logits - mean)**2, 0.0).sum(
        dim=-1, keepdim=True) / (cnt - 1.0).clamp(min=1.0)
    std = torch.sqrt(var)
    mx = torch.where(finite, logits, NEG_INF).max(dim=-1,
                                                  keepdim=True).values
    threshold = mx - t.nsigma[:, None] * std
    remove = (logits < threshold) & (t.nsigma[:, None] > 0)
    return torch.where(remove, NEG_INF, logits)


def _apply_skew(probs, t: SamplingTensors):
    """Skew: raise the CDF to exp(skew) and difference it again. A token's
    share is taken as c^e * expm1(e * log1p(p / c)) from the mass c before
    it (p^e for the first token with mass), the same value as the
    difference of the powered CDF, without its cancellation: a token's
    share keeps its relative accuracy however small, and a token of zero
    mass keeps zero, so the card and the CPU keep the same tokens."""
    e = torch.exp(t.skew)[:, None]
    before = torch.cumsum(probs, dim=-1) - probs
    # Where before is 0, the share is p^e, which the where() takes.
    safe = torch.where(before > 0, before, 1.0)
    share = safe**e * torch.expm1(e * torch.log1p(probs / safe))
    return torch.where(before > 0, share, probs**e)


def _apply_token_id_bans(logits, token_ids):
    """-inf at each row's banned token ids (padding -1)."""
    V = logits.shape[1]
    ids = torch.where(token_ids >= 0, token_ids, V).long()
    padded = torch.cat([logits, logits.new_zeros((logits.shape[0], 1))],
                       dim=1)
    return padded.scatter(1, ids, NEG_INF)[:, :V]


def apply_guided_mask(logits: torch.Tensor,
                      mask_words: torch.Tensor) -> torch.Tensor:
    """Apply a packed 32-bit allow-mask [S, ceil(V/32)] (the uint32 words
    as int32 or int64) to the logits: tokens with a 0 bit are banned."""
    V = logits.shape[1]
    idx = torch.arange(V, device=logits.device)
    words = mask_words.long().index_select(1, idx // 32)
    bits = (words >> (idx % 32)[None, :]) & 1
    return torch.where(bits.bool(), logits, NEG_INF)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

_DEFAULT_ORDER = (
    SamplerID.DRY, SamplerID.PENALTIES, SamplerID.NO_REPEAT_NGRAM,
    SamplerID.TEMPERATURE, SamplerID.TOP_NSIGMA, SamplerID.TOP_P_TOP_K,
    SamplerID.TOP_A, SamplerID.MIN_P, SamplerID.TFS, SamplerID.ETA_CUTOFF,
    SamplerID.EPSILON_CUTOFF, SamplerID.TYPICAL_P, SamplerID.QUADRATIC,
    SamplerID.XTC)


def stage_order(flags: SamplingFlags):
    """The SamplerIDs in the order the batch runs them: the first
    request's ``sampler_priority``, else the default order with
    temperature last under ``temperature_last``."""
    if flags.priority_order is not None:
        return [int(s) for s in flags.priority_order]
    order = list(_DEFAULT_ORDER)
    if flags.do_temp_last:
        order.remove(SamplerID.TEMPERATURE)
        order.append(SamplerID.TEMPERATURE)
    return order


def shaped_logprobs(
    logits: torch.Tensor,  # f32[S, V]
    t: SamplingTensors,
    flags: SamplingFlags,
    history: Optional[torch.Tensor] = None,  # i32[S, H] padded with V
    history_lens: Optional[torch.Tensor] = None,  # i32[S]
    prompt_lens: Optional[torch.Tensor] = None,  # i32[S]
    guided_mask: Optional[torch.Tensor] = None,  # [S, ceil(V/32)] words
) -> torch.Tensor:
    """The post-pipeline log-distribution [S, V] (f32)."""
    return _shaped(logits, t, flags, history, history_lens, prompt_lens,
                   guided_mask).float()


def _shaped(logits, t, flags, history, history_lens, prompt_lens,
            guided_mask):
    """shaped_logprobs, in f64 where a stage runs (in f32 where none
    does)."""
    if not any(getattr(flags, f) for f in _SHAPING_FLAGS):
        return torch.log_softmax(logits.float(), dim=-1)
    V = logits.shape[1]
    logits = logits.double()
    if flags.do_guided:
        logits = apply_guided_mask(logits, guided_mask)
    if flags.do_min_tokens:
        logits = _apply_token_id_bans(
            logits, torch.where(t.min_tokens_mask[:, None], t.stop_tokens,
                                -1))
    if flags.do_banned_tokens:
        logits = _apply_token_id_bans(logits, t.banned_tokens)

    def with_t(stage):
        return lambda lg: stage(lg, t)

    stages = {
        SamplerID.DRY: (flags.do_dry, lambda lg: _apply_dry(
            lg, t, history, history_lens, V)),
        SamplerID.PENALTIES: (flags.do_penalties, lambda lg: _apply_penalties(
            lg, t, *_history_masks(history, history_lens, prompt_lens, V))),
        SamplerID.NO_REPEAT_NGRAM: (
            flags.do_no_repeat_ngram, lambda lg: _apply_no_repeat_ngram(
                lg, t, history, history_lens, V)),
        SamplerID.TEMPERATURE: (flags.do_temperatures,
                                with_t(_apply_temperatures)),
        SamplerID.TOP_NSIGMA: (flags.do_nsigmas, with_t(_apply_top_nsigma)),
        SamplerID.TOP_P_TOP_K: (flags.do_top_p_top_k,
                                with_t(_apply_top_k_top_p)),
        SamplerID.TOP_A: (flags.do_top_as, with_t(_apply_top_a)),
        SamplerID.MIN_P: (flags.do_min_p, with_t(_apply_min_p)),
        SamplerID.TFS: (flags.do_tfss, with_t(_apply_tfs)),
        SamplerID.ETA_CUTOFF: (flags.do_eta_cutoffs,
                               with_t(_apply_eta_cutoff)),
        SamplerID.EPSILON_CUTOFF: (flags.do_epsilon_cutoffs,
                                   with_t(_apply_epsilon_cutoff)),
        SamplerID.TYPICAL_P: (flags.do_typical_ps, with_t(_apply_typical)),
        SamplerID.QUADRATIC: (flags.do_quadratic, with_t(_apply_quadratic)),
        SamplerID.XTC: (flags.do_xtc, with_t(_apply_xtc)),
    }
    for sid in stage_order(flags):
        enabled, stage = stages.get(sid, (False, None))
        if enabled:
            logits = stage(logits)

    if flags.do_skew:
        probs = _apply_skew(torch.softmax(logits, dim=-1), t)
        logprobs = torch.log(probs.clamp(min=1e-38))
        return torch.where(probs > 0, logprobs, NEG_INF)
    return torch.log_softmax(logits, dim=-1)


def sample(
    logits: torch.Tensor,  # f32[S, V]
    t: SamplingTensors,  # fields as tensors on the logits' device
    flags: SamplingFlags,
    history: Optional[torch.Tensor] = None,
    history_lens: Optional[torch.Tensor] = None,
    prompt_lens: Optional[torch.Tensor] = None,
    guided_mask: Optional[torch.Tensor] = None,
) -> SamplerOutput:
    """Run the sampler pipeline and draw one token per row.

    Stage order (default): DRY -> penalties -> no-repeat-ngram ->
    temperature -> nsigma -> top-k/p -> top-a -> min-p -> tfs -> eta ->
    epsilon -> typical -> quadratic -> xtc [-> temperature if temp_last]
    -> skew -> sample."""
    S, V = logits.shape
    shaped = _shaped(logits, t, flags, history, history_lens, prompt_lens,
                     guided_mask)
    logprobs = shaped.float()
    greedy_choice = torch.argmax(shaped, dim=-1)
    if flags.all_greedy:
        sampled = greedy_choice
    else:
        # Gumbel-argmax on each row's stream, in f64: G = -log(-log(U)),
        # U in (0, 1), so G is finite.
        u = row_uniforms(t.key_data, GUMBEL_FOLD, V).double()
        noised = torch.where(torch.isfinite(shaped),
                             shaped.double() - torch.log(-torch.log(u)),
                             NEG_INF)
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


def prompt_logprobs(logits: torch.Tensor, target_ids: torch.Tensor, k: int):
    """Each row's log-softmax at its target id, the target's 1-based rank
    and the top-k: (target_lp[T], rank[T], topk_ids[T, k], topk_lp[T, k])."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    tgt_lp = lp.gather(1, target_ids.long()[:, None])[:, 0]
    topk_lp, topk_ids = torch.topk(lp, k, dim=-1)
    ranks = (lp > tgt_lp[:, None]).sum(dim=-1) + 1
    return tgt_lp, ranks.int(), topk_ids.int(), topk_lp
