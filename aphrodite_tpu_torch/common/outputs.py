"""User-facing request outputs (reference: aphrodite/common/outputs.py)."""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from aphrodite_tpu_torch.common.sequence import (Logprob, SequenceGroup,
                                           SequenceStatus)


@dataclass
class CompletionOutput:
    """Output of one sequence of a request."""

    index: int
    text: str
    token_ids: List[int]
    cumulative_logprob: float
    logprobs: Optional[List[Dict[int, Logprob]]] = None
    finish_reason: Optional[str] = None
    stop_reason: Optional[object] = None

    def finished(self) -> bool:
        return self.finish_reason is not None


@dataclass
class RequestOutput:
    """Output of a request: prompt echo + all completions."""

    request_id: str
    prompt: Optional[str]
    prompt_token_ids: List[int]
    outputs: List[CompletionOutput]
    finished: bool
    prompt_logprobs: Optional[List[Optional[Dict[int, Logprob]]]] = None
    metrics: Optional[object] = None
    # Request-level failure (e.g. async guided-FSM compilation error):
    # the request finished WITHOUT generating; frontends surface this as
    # an error response instead of an empty completion.
    error: Optional[str] = None

    @classmethod
    def from_seq_group(cls, seq_group: SequenceGroup) -> "RequestOutput":
        seqs = seq_group.seqs
        sp = seq_group.sampling_params
        if sp.use_beam_search or sp.best_of > sp.n:
            # Return the n best by length-penalized cumulative logprob
            # (reference beam finalization semantics).
            sorted_seqs = sorted(
                seqs,
                key=lambda s: s.cumulative_logprob /
                max(s.get_output_len(), 1)**sp.length_penalty,
                reverse=True,
            )
            top_seqs = sorted_seqs[:sp.n]
        else:
            top_seqs = seqs[:sp.n]
        outputs = [
            CompletionOutput(
                index=i,
                text=seq.output_text,
                token_ids=list(seq.output_token_ids),
                cumulative_logprob=seq.cumulative_logprob,
                logprobs=seq.output_logprobs if sp.logprobs is not None
                else None,
                finish_reason=SequenceStatus.get_finished_reason(seq.status),
                stop_reason=seq.stop_reason,
            ) for i, seq in enumerate(top_seqs)
        ]
        return cls(
            request_id=seq_group.request_id,
            prompt=seq_group.prompt,
            prompt_token_ids=list(seq_group.prompt_token_ids),
            outputs=outputs,
            finished=seq_group.is_finished(),
            prompt_logprobs=seqs[0].prompt_logprobs,
            metrics=seq_group.metrics,
            error=getattr(seq_group, "error", None),
        )


@dataclass
class EmbeddingRequestOutput:
    """Output of an embedding request (reference outputs.py)."""

    request_id: str
    prompt_token_ids: List[int]
    embedding: List[float] = field(default_factory=list)
    finished: bool = True
