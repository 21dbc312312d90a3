"""Sampling parameters — the full Aphrodite sampler surface.

Re-expresses the reference's ``aphrodite/common/sampling_params.py:90``
(fields :237-293) including the creative-writing samplers that differentiate
Aphrodite from vLLM: dynatemp, top-a, tfs, eta/epsilon cutoffs, typical-p,
quadratic (smoothing), XTC, top-nsigma, skew, DRY and no-repeat-ngram, plus
user-reorderable sampler priority (``SamplerID``, sampler.py:148-165).

Unlike the reference's CUDA path, every sampler here is applied *in-graph*
on TPU (vectorized masks over the padded batch) — the reference's TPU
backend skipped all of this (tpu_model_runner.py:431-481).
"""

import copy
from dataclasses import dataclass, field
from enum import Enum, IntEnum
from functools import cached_property
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Union

_SAMPLING_EPS = 1e-5
_MAX_TEMP = 1e-2


class SamplingType(IntEnum):
    GREEDY = 0
    RANDOM = 1
    RANDOM_SEED = 2
    BEAM = 3


class SamplerID(IntEnum):
    """Stage ids for user-controlled sampler ordering.

    Mirrors the reference's KoboldAI-compatible enum
    (modeling/layers/sampler.py:148-165).
    """

    # Mirror the order of the reference pipeline (sampler.py:240).
    DRY = 7
    PENALTIES = 6
    NO_REPEAT_NGRAM = 8
    TEMPERATURE = 5
    TOP_NSIGMA = 9
    TOP_P_TOP_K = 0
    TOP_A = 1
    MIN_P = 2
    TFS = 3
    ETA_CUTOFF = 10
    EPSILON_CUTOFF = 11
    TYPICAL_P = 4
    QUADRATIC = 12
    XTC = 13


LogitsProcessor = Callable[[List[int], Any], Any]
"""Callable (token_ids, logits) -> logits, applied on host."""


@dataclass
class SamplingParams:
    """Sampling parameters for text generation.

    Field-for-field capability match of the reference's ``SamplingParams``
    (common/sampling_params.py:237-293). Defaults follow the reference.
    """

    n: int = 1
    best_of: Optional[int] = None
    # Penalties.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    # Temperature (incl. dynatemp).
    temperature: float = 1.0
    dynatemp_min: float = 0.0
    dynatemp_max: float = 0.0
    dynatemp_exponent: float = 1.0
    temperature_last: bool = False
    # Truncation samplers.
    top_p: float = 1.0
    top_k: int = -1
    top_a: float = 0.0
    min_p: float = 0.0
    tfs: float = 1.0
    eta_cutoff: float = 0.0
    epsilon_cutoff: float = 0.0
    typical_p: float = 1.0
    # Quadratic / smoothing sampler.
    smoothing_factor: float = 0.0
    smoothing_curve: float = 1.0
    # XTC sampler.
    xtc_threshold: float = 0.1
    xtc_probability: float = 0.0
    # Top-nsigma.
    nsigma: float = 0.0
    # Skew.
    skew: float = 0.0
    # DRY (don't-repeat-yourself) sampler.
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_sequence_breaker_ids: List[int] = field(default_factory=list)
    dry_range: int = 0
    # Seed / beam.
    seed: Optional[int] = None
    use_beam_search: bool = False
    length_penalty: float = 1.0
    early_stopping: Union[bool, str] = False
    # Stopping.
    stop: Union[None, str, List[str]] = None
    stop_token_ids: Optional[List[int]] = None
    include_stop_str_in_output: bool = False
    ignore_eos: bool = False
    max_tokens: Optional[int] = 16
    min_tokens: int = 0
    # Logprobs.
    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    detokenize: bool = True
    skip_special_tokens: bool = True
    spaces_between_special_tokens: bool = True
    # Extensions.
    custom_token_bans: Optional[List[int]] = None
    logits_processors: Optional[List[LogitsProcessor]] = None
    truncate_prompt_tokens: Optional[int] = None
    sampler_priority: Optional[List[SamplerID]] = None
    # Guided decoding (reference guided_decoding/ via outlines/lmfe;
    # here a built-in regex->DFA engine, aphrodite_tpu/guided/).
    guided_regex: Optional[str] = None
    guided_json: Optional[Union[str, Dict[str, Any]]] = None
    guided_choice: Optional[List[str]] = None
    guided_grammar: Optional[str] = None
    guided_json_object: bool = False

    def __post_init__(self) -> None:
        if self.best_of is None:
            self.best_of = self.n
        if self.stop is None:
            self.stop = []
        elif isinstance(self.stop, str):
            self.stop = [self.stop]
        else:
            self.stop = list(self.stop)
        if self.stop_token_ids is None:
            self.stop_token_ids = []
        else:
            self.stop_token_ids = list(self.stop_token_ids)
        if self.seed == -1:
            self.seed = None
        self._verify_args()
        if self.use_beam_search:
            self._verify_beam_search()
        else:
            self._verify_non_beam_search()
            if self.temperature < _SAMPLING_EPS:
                # Zero (or ~zero) temperature means greedy sampling.
                self.top_p = 1.0
                self.top_k = -1
                self.min_p = 0.0
                self.top_a = 0.0

    def _verify_args(self) -> None:
        if self.n < 1:
            raise ValueError(f"n must be at least 1, got {self.n}.")
        if self.best_of < self.n:
            raise ValueError(
                f"best_of must be >= n, got n={self.n}, best_of={self.best_of}."
            )
        if not -2.0 <= self.presence_penalty <= 2.0:
            raise ValueError("presence_penalty must be in [-2, 2], got "
                             f"{self.presence_penalty}.")
        if not -2.0 <= self.frequency_penalty <= 2.0:
            raise ValueError("frequency_penalty must be in [-2, 2], got "
                             f"{self.frequency_penalty}.")
        if self.repetition_penalty <= 0.0:
            raise ValueError("repetition_penalty must be positive, got "
                             f"{self.repetition_penalty}.")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be non-negative, got {self.temperature}.")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}.")
        if self.top_k < -1 or self.top_k == 0:
            raise ValueError(
                f"top_k must be -1 (disable) or at least 1, got {self.top_k}.")
        if not 0.0 <= self.top_a <= 1.0:
            raise ValueError(f"top_a must be in [0, 1], got {self.top_a}.")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {self.min_p}.")
        if not 0.0 < self.tfs <= 1.0:
            raise ValueError(f"tfs must be in (0, 1], got {self.tfs}.")
        if self.eta_cutoff < 0.0 or self.eta_cutoff > 20.0:
            raise ValueError(
                f"eta_cutoff must be in [0, 20], got {self.eta_cutoff}.")
        if self.epsilon_cutoff < 0.0 or self.epsilon_cutoff > 1000.0:
            raise ValueError("epsilon_cutoff must be in [0, 1000], got "
                             f"{self.epsilon_cutoff}.")
        if not 0.0 < self.typical_p <= 1.0:
            raise ValueError(
                f"typical_p must be in (0, 1], got {self.typical_p}.")
        if self.smoothing_factor < 0.0:
            raise ValueError("smoothing_factor must be non-negative, got "
                             f"{self.smoothing_factor}.")
        if not 0.0 <= self.xtc_threshold <= 0.5:
            raise ValueError(
                f"xtc_threshold must be in [0, 0.5], got {self.xtc_threshold}.")
        if not 0.0 <= self.xtc_probability <= 1.0:
            raise ValueError("xtc_probability must be in [0, 1], got "
                             f"{self.xtc_probability}.")
        if self.nsigma < 0.0:
            raise ValueError(f"nsigma must be non-negative, got {self.nsigma}.")
        if self.dry_multiplier < 0.0:
            raise ValueError("dry_multiplier must be non-negative, got "
                             f"{self.dry_multiplier}.")
        if self.dry_base <= 1.0 and self.dry_multiplier > 0.0:
            raise ValueError(f"dry_base must be > 1, got {self.dry_base}.")
        if self.dry_allowed_length < 0:
            raise ValueError("dry_allowed_length must be non-negative, got "
                             f"{self.dry_allowed_length}.")
        if self.dry_range < 0:
            raise ValueError(
                f"dry_range must be non-negative, got {self.dry_range}.")
        if self.no_repeat_ngram_size < 0:
            raise ValueError("no_repeat_ngram_size must be non-negative, got "
                             f"{self.no_repeat_ngram_size}.")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(
                f"max_tokens must be at least 1, got {self.max_tokens}.")
        if self.min_tokens < 0:
            raise ValueError(
                f"min_tokens must be non-negative, got {self.min_tokens}.")
        if (self.max_tokens is not None
                and self.min_tokens > self.max_tokens):
            raise ValueError(
                f"min_tokens ({self.min_tokens}) must be <= max_tokens "
                f"({self.max_tokens}).")
        if self.logprobs is not None and self.logprobs < 0:
            raise ValueError(
                f"logprobs must be non-negative, got {self.logprobs}.")
        if self.prompt_logprobs is not None and self.prompt_logprobs < 0:
            raise ValueError("prompt_logprobs must be non-negative, got "
                             f"{self.prompt_logprobs}.")
        if (self.truncate_prompt_tokens is not None
                and self.truncate_prompt_tokens < 1):
            raise ValueError("truncate_prompt_tokens must be >= 1, got "
                             f"{self.truncate_prompt_tokens}.")
        if any(not stop_str for stop_str in self.stop):
            raise ValueError("stop cannot contain an empty string.")
        if self.sampler_priority is not None:
            self.sampler_priority = [
                SamplerID(p) if not isinstance(p, SamplerID) else p
                for p in self.sampler_priority
            ]

    def _verify_beam_search(self) -> None:
        if self.best_of == 1:
            raise ValueError(
                "best_of must be > 1 when using beam search, got "
                f"{self.best_of}.")
        if self.temperature > _SAMPLING_EPS:
            raise ValueError("temperature must be 0 when using beam search.")
        if self.top_p < 1.0 - _SAMPLING_EPS:
            raise ValueError("top_p must be 1 when using beam search.")
        if self.top_k != -1:
            raise ValueError("top_k must be -1 when using beam search.")

    def _verify_non_beam_search(self) -> None:
        if self.early_stopping is not False:
            raise ValueError(
                "early_stopping is only effective with beam search.")
        if (self.length_penalty < 1.0 - _SAMPLING_EPS
                or self.length_penalty > 1.0 + _SAMPLING_EPS):
            raise ValueError(
                "length_penalty is only effective with beam search.")

    @property
    def guided_spec(self) -> Optional[Tuple[str, str]]:
        """(kind, canonical spec string) when guided decoding is on."""
        import json as _json

        if self.guided_regex is not None:
            return ("regex", self.guided_regex)
        if self.guided_json is not None:
            spec = self.guided_json
            if not isinstance(spec, str):
                spec = _json.dumps(spec, sort_keys=True)
            return ("json", spec)
        if self.guided_choice is not None:
            return ("choice", _json.dumps(list(self.guided_choice)))
        if self.guided_grammar is not None:
            return ("grammar", self.guided_grammar)
        if self.guided_json_object:
            return ("json_object", "")
        return None

    @cached_property
    def sampling_type(self) -> SamplingType:
        if self.use_beam_search:
            return SamplingType.BEAM
        if self.temperature < _SAMPLING_EPS:
            return SamplingType.GREEDY
        if self.seed is not None:
            return SamplingType.RANDOM_SEED
        return SamplingType.RANDOM

    @property
    def all_stop_token_ids(self) -> Set[int]:
        return set(self.stop_token_ids or [])

    @property
    def chain_speculation_eligible(self) -> bool:
        """Whether a decode window for this request may be dispatched
        SPECULATIVELY before the engine confirms the request survives
        the step (cross-step window chaining,
        worker/model_runner.py:_can_chain_window). Requires:

        - history-free sampling: nothing in the pipeline reads the
          token history the speculative window has not seen (penalties,
          DRY, no-repeat-ngram, min-token EOS masking, guided FSMs,
          host logits processors, beam state);
        - chain-invariant randomness: greedy rows or rows WITHOUT an
          explicit seed. A user-set seed promises reproducible tokens,
          and the chained window samples with the previous schedule's
          sampling tensors: identical distribution, different stream.

        EOS/stop/max_tokens finishes do NOT block eligibility: a finish
        changes the next step's batch composition, the chained window's
        fingerprint misses, and the window is dropped unfetched.

        The scheduler consults the same predicate to size its lookahead
        reservation, so KV is only reserved for windows that can
        actually be speculated.
        """
        if (self.presence_penalty or self.frequency_penalty
                or self.repetition_penalty != 1.0
                or self.no_repeat_ngram_size or self.dry_multiplier
                or self.min_tokens or self.custom_token_bans
                or self.logits_processors or self.use_beam_search
                or self.guided_spec is not None):
            return False
        return self.temperature < _SAMPLING_EPS or self.seed is None

    def clone(self) -> "SamplingParams":
        """Deep copy, excluding logits processor callables (shared)."""
        lps = self.logits_processors
        self.logits_processors = None
        try:
            new = copy.deepcopy(self)
        finally:
            self.logits_processors = lps
        new.logits_processors = lps
        return new

    def update_from_generation_config(
        self,
        generation_config: Dict[str, Any],
        model_eos_token_id: Optional[int] = None,
    ) -> None:
        """Merge model generation_config defaults (reference :560)."""
        if model_eos_token_id is not None and not self.ignore_eos:
            self.stop_token_ids = list(
                set(self.stop_token_ids) | {model_eos_token_id})
        eos_ids = generation_config.get("eos_token_id")
        if eos_ids is not None and not self.ignore_eos:
            if isinstance(eos_ids, int):
                eos_ids = [eos_ids]
            self.stop_token_ids = list(set(self.stop_token_ids) | set(eos_ids))
