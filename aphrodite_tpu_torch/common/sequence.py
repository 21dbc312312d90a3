"""Request/sequence state machine.

TPU-native re-design of the reference's ``aphrodite/common/sequence.py``
(Sequence/SequenceGroup/SequenceData). Differences from the reference:

- No per-sequence torch tensors: token ids live in plain Python lists; the
  model runner owns all device state (including a persistent on-device token
  history used by the in-graph penalty/DRY samplers).
- Block tables are owned by the ``BlockManager``; sequences carry only ids.
- ``num_computed_tokens`` drives chunked prefill exactly as in the reference
  (sequence.py SequenceData stage tracking).
"""

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from aphrodite_tpu_torch.common.sampling_params import SamplingParams


class SequenceStatus(enum.IntEnum):
    WAITING = 0
    RUNNING = 1
    # Preempted-by-recompute sequences go back to WAITING; swap is
    # intentionally unsupported on TPU (SURVEY.md §7 hard-part 7: recompute
    # preemption is the reference default for single-seq groups,
    # scheduler.py:1327, and host<->HBM swap is rarely profitable on TPU).
    FINISHED_STOPPED = 2
    FINISHED_LENGTH_CAPPED = 3
    FINISHED_ABORTED = 4
    FINISHED_IGNORED = 5

    @staticmethod
    def is_finished(status: "SequenceStatus") -> bool:
        return status >= SequenceStatus.FINISHED_STOPPED

    @staticmethod
    def get_finished_reason(status: "SequenceStatus") -> Optional[str]:
        return {
            SequenceStatus.FINISHED_STOPPED: "stop",
            SequenceStatus.FINISHED_LENGTH_CAPPED: "length",
            SequenceStatus.FINISHED_ABORTED: "abort",
            SequenceStatus.FINISHED_IGNORED: "length",
        }.get(status)


class SequenceStage(enum.Enum):
    PREFILL = enum.auto()
    DECODE = enum.auto()


@dataclass
class RequestMetrics:
    """Per-request latency metrics (reference sequence.py RequestMetrics)."""

    arrival_time: float
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None
    time_in_queue: Optional[float] = None
    finished_time: Optional[float] = None
    last_token_time: float = 0.0


class Sequence:
    """One generation stream: prompt + generated tokens + status."""

    def __init__(
        self,
        seq_id: int,
        prompt_token_ids: List[int],
        block_size: int,
        eos_token_id: Optional[int] = None,
        prompt: Optional[str] = None,
    ) -> None:
        self.seq_id = seq_id
        self.prompt = prompt
        self.prompt_token_ids: List[int] = list(prompt_token_ids)
        self.output_token_ids: List[int] = []
        self.block_size = block_size
        self.eos_token_id = eos_token_id
        self.status = SequenceStatus.WAITING
        # Number of tokens whose KV is already computed and resident in the
        # paged cache. < len(prompt) during chunked prefill.
        self.num_computed_tokens = 0
        # Cumulative logprob of the generated tokens (for best_of/beam).
        self.cumulative_logprob = 0.0
        # Per-step output logprobs: list of dict[token_id -> Logprob].
        self.output_logprobs: List[Dict[int, "Logprob"]] = []
        self.prompt_logprobs: Optional[List[Optional[Dict[int, "Logprob"]]]] = None
        # Incremental detokenization state.
        self.output_text = ""
        self.read_offset = 0
        self.prefix_offset = 0
        self.tokens: Optional[List[str]] = None
        # Stop-string bookkeeping.
        self.stop_reason: Optional[Any] = None
        # Guided decoding automaton (aphrodite_tpu/guided/): set by the
        # engine when the request carries a guided spec.
        self.fsm: Optional[Any] = None
        self.fsm_state: int = 0
        # Multimodal splice spans: [(prompt_pos, features[n, H])]; image
        # features computed once at add-time (engine.add_request).
        self.mm_spans: Optional[List[Any]] = None
        # Extra entropy for prefix-cache block hashing (image placeholder
        # tokens are identical across different images).
        self.extra_hash: Optional[int] = None
        # M-RoPE (Qwen2-VL): [3, prompt_len] rope positions for the
        # prompt and the position delta for generated tokens
        # (rope_pos = seq_pos + delta); set by engine.add_request for
        # mrope models with images.
        self.mrope_table: Optional[Any] = None
        self.mrope_delta: int = 0
        # Encoder-decoder: the encoder-side prompt. The regular
        # prompt_token_ids hold the DECODER prompt (usually just
        # decoder_start_token_id); cross-attention blocks are allocated
        # by the block manager alongside the decoder blocks.
        self.encoder_token_ids: Optional[List[int]] = None
        # Encoder-side multimodal splice spans (BLIP2-T5): features
        # splice into the encoder program, not the decoder stream.
        self.encoder_mm_spans: Optional[List[Any]] = None
        # Audio-encoder models (Whisper): the raw log-mel features the
        # encoder pass consumes (encoder_token_ids is just a length
        # placeholder for cross-page allocation).
        self.encoder_audio: Optional[Any] = None
        # Sibling index within a seeded n>1 request (distinct PRNG
        # streams; see model_runner._offset_seed).
        self.seed_offset: int = 0

    # ---- token accounting -------------------------------------------------

    def get_len(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    def get_prompt_len(self) -> int:
        return len(self.prompt_token_ids)

    def get_output_len(self) -> int:
        return len(self.output_token_ids)

    def get_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    def get_last_token_id(self) -> int:
        if self.output_token_ids:
            return self.output_token_ids[-1]
        return self.prompt_token_ids[-1]

    def append_token_id(self, token_id: int, logprob: float = 0.0) -> None:
        # Note: does NOT advance num_computed_tokens — the new token's KV is
        # only computed by the *next* decode step
        # (Scheduler.mark_step_computed advances the counter).
        self.output_token_ids.append(token_id)
        self.cumulative_logprob += logprob

    def extend_token_ids(self, token_ids: List[int],
                         logprob_sum: float) -> None:
        """Bulk append for multi-step windows (engine fast path): one
        Python call per sequence instead of one per token. KV accounting
        for the intermediate tokens is the caller's job (the fused window
        computed them in-graph)."""
        self.output_token_ids.extend(token_ids)
        self.cumulative_logprob += logprob_sum

    def get_num_uncomputed_tokens(self) -> int:
        """Tokens that still need a forward pass (prompt remainder, or the
        single next-token during decode)."""
        return self.get_len() - self.num_computed_tokens

    @property
    def is_prefill(self) -> bool:
        return self.num_computed_tokens < self.get_prompt_len()

    def get_stage(self) -> SequenceStage:
        return (SequenceStage.PREFILL
                if self.is_prefill else SequenceStage.DECODE)

    # ---- block bookkeeping helpers ---------------------------------------

    def num_blocks_for_tokens(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    def hash_of_block(self, logical_idx: int) -> int:
        """Content hash for prefix caching: hash of all token ids up to and
        including this block (reference common/sequence.py:499)."""
        num_tokens = (logical_idx + 1) * self.block_size
        return hash((self.extra_hash,
                     tuple(self.get_token_ids()[:num_tokens])))

    # ---- lifecycle --------------------------------------------------------

    def is_finished(self) -> bool:
        return SequenceStatus.is_finished(self.status)

    def fork(self, new_seq_id: int) -> "Sequence":
        child = Sequence(
            seq_id=new_seq_id,
            prompt_token_ids=self.prompt_token_ids,
            block_size=self.block_size,
            eos_token_id=self.eos_token_id,
            prompt=self.prompt,
        )
        child.output_token_ids = list(self.output_token_ids)
        child.num_computed_tokens = self.num_computed_tokens
        child.cumulative_logprob = self.cumulative_logprob
        child.output_logprobs = list(self.output_logprobs)
        child.status = self.status
        child.output_text = self.output_text
        child.read_offset = self.read_offset
        child.prefix_offset = self.prefix_offset
        child.tokens = list(self.tokens) if self.tokens is not None else None
        child.fsm = self.fsm
        child.fsm_state = self.fsm_state
        child.mm_spans = self.mm_spans
        child.extra_hash = self.extra_hash
        child.encoder_token_ids = self.encoder_token_ids
        child.seed_offset = self.seed_offset
        return child

    def reset_for_recompute(self) -> None:
        """Preemption by recompute: KV is dropped, all tokens (prompt +
        already-generated output) must be prefill-ed again."""
        self.status = SequenceStatus.WAITING
        self.num_computed_tokens = 0

    def __repr__(self) -> str:
        return (f"Sequence(seq_id={self.seq_id}, status={self.status.name}, "
                f"len={self.get_len()}, computed={self.num_computed_tokens})")


@dataclass
class Logprob:
    """Log probability of one token (reference sequence.py Logprob)."""

    logprob: float
    rank: Optional[int] = None
    decoded_token: Optional[str] = None


class SequenceGroup:
    """All sequences generated from one prompt (one request)."""

    def __init__(
        self,
        request_id: str,
        seqs: List[Sequence],
        sampling_params: SamplingParams,
        arrival_time: Optional[float] = None,
        lora_request: Optional[Any] = None,
    ) -> None:
        self.request_id = request_id
        self.seqs = seqs
        self._seq_dict = {seq.seq_id: seq for seq in seqs}
        self.sampling_params = sampling_params
        self.metrics = RequestMetrics(
            arrival_time=arrival_time if arrival_time is not None else
            time.monotonic())
        self.lora_request = lora_request
        self.prompt_logprobs_done = False
        # Set when the request failed before/without generating (e.g.
        # async guided-FSM compilation error); surfaced on RequestOutput.
        self.error: Optional[str] = None

    @property
    def prompt_token_ids(self) -> List[int]:
        return self.seqs[0].prompt_token_ids

    @property
    def prompt(self) -> Optional[str]:
        return self.seqs[0].prompt

    def get_seqs(
        self, status: Optional[SequenceStatus] = None
    ) -> List[Sequence]:
        if status is None:
            return self.seqs
        return [s for s in self.seqs if s.status == status]

    def get_unfinished_seqs(self) -> List[Sequence]:
        return [s for s in self.seqs if not s.is_finished()]

    def get_finished_seqs(self) -> List[Sequence]:
        return [s for s in self.seqs if s.is_finished()]

    def num_seqs(self, status: Optional[SequenceStatus] = None) -> int:
        return len(self.get_seqs(status))

    def num_unfinished_seqs(self) -> int:
        return len(self.get_unfinished_seqs())

    def is_finished(self) -> bool:
        return all(s.is_finished() for s in self.seqs)

    def is_prefill(self) -> bool:
        return any(s.is_prefill for s in self.get_unfinished_seqs())

    def find(self, seq_id: int) -> Sequence:
        return self._seq_dict[seq_id]

    def add(self, seq: Sequence) -> None:
        if seq.seq_id in self._seq_dict:
            raise ValueError(f"sequence {seq.seq_id} already present")
        self._seq_dict[seq.seq_id] = seq
        self.seqs.append(seq)

    def remove(self, seq_id: int) -> None:
        seq = self._seq_dict.pop(seq_id)
        self.seqs.remove(seq)

    def get_max_num_running_seqs(self) -> int:
        """Upper bound of concurrently running sequences over the request's
        remaining lifetime (reference sequence.py:720)."""
        sp = self.sampling_params
        if sp.use_beam_search:
            return sp.best_of
        if sp.best_of > self.num_seqs():
            # Not yet forked: will run best_of sequences.
            return sp.best_of
        return self.num_unfinished_seqs()

    def maybe_set_first_scheduled_time(self, now: float) -> None:
        if self.metrics.first_scheduled_time is None:
            self.metrics.first_scheduled_time = now
            self.metrics.time_in_queue = now - self.metrics.arrival_time

    def maybe_set_first_token_time(self, now: float) -> None:
        if (self.metrics.first_token_time is None
                and self.seqs[0].get_output_len() >= 1):
            self.metrics.first_token_time = now

    def set_finished_time(self, now: float) -> None:
        self.metrics.finished_time = now

    def __repr__(self) -> str:
        return (f"SequenceGroup(request_id={self.request_id!r}, "
                f"num_seqs={self.num_seqs()})")


@dataclass
class ScheduledSequence:
    """One sequence's slice of work inside a scheduled step."""

    seq: Sequence
    group: SequenceGroup
    # Number of tokens to run in this step (>=1; >1 only during prefill
    # chunks, ==1 in decode).
    num_tokens: int
    # Token index range [first, first+num_tokens) into the full token list.
    first_token_idx: int
    # Device block ids backing this sequence, in order.
    block_ids: List[int]
    # Does this step produce a sampled token (i.e., is the last prompt chunk
    # or a decode step)?
    do_sample: bool
    # Encoder-decoder: device block ids backing the sequence's CROSS
    # (encoder) KV, in order; None for decoder-only models.
    cross_block_ids: Optional[List[int]] = None


@dataclass
class SchedulerOutputs:
    """What the scheduler hands to the model runner for one step."""

    scheduled: List[ScheduledSequence]
    num_prefill_tokens: int
    num_decode_tokens: int
    preempted: List[SequenceGroup] = field(default_factory=list)
    ignored: List[SequenceGroup] = field(default_factory=list)
    # Copy-on-write directives (src_block, dst_block) the runner must
    # execute on the device cache before the forward (fork divergence;
    # reference SchedulerOutputs.blocks_to_copy).
    blocks_to_copy: List[Tuple[int, int]] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.scheduled

    @property
    def num_batched_tokens(self) -> int:
        return self.num_prefill_tokens + self.num_decode_tokens
