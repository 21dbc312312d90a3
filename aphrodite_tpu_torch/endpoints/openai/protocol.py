"""OpenAI-compatible API schema with the full Aphrodite sampler surface
(counterpart of aphrodite_tpu/endpoints/openai/protocol.py).

Every Aphrodite sampling extension (dynatemp, top-a, tfs, eta/epsilon
cutoffs, typical-p, quadratic, XTC, nsigma, skew, DRY, no-repeat-ngram,
custom token bans, sampler priority, guided decoding) is a body field.
Beam search (``use_beam_search``, ``length_penalty``, ``early_stopping``,
with ``best_of`` as the beam width) is one too, and ``sampler_priority``
reaches the sampler: the JAX schema drops those keys (the first three as
unknown extras), though the engine of both packages serves them.
"""

import time
import uuid
from typing import Any, Dict, List, Optional, Union

from pydantic import BaseModel, ConfigDict, Field

from aphrodite_tpu_torch.common.sampling_params import SamplingParams


def random_uuid() -> str:
    return str(uuid.uuid4().hex)


class ErrorResponse(BaseModel):
    object: str = "error"
    message: str
    type: str
    param: Optional[str] = None
    code: int = 400


class ModelCard(BaseModel):
    id: str
    object: str = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "aphrodite-tpu"
    root: Optional[str] = None


class ModelList(BaseModel):
    object: str = "list"
    data: List[ModelCard] = Field(default_factory=list)


class UsageInfo(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class _SamplerMixin(BaseModel):
    """Shared sampling fields (OpenAI core + Aphrodite extensions)."""

    model_config = ConfigDict(extra="allow")

    # OpenAI core.
    max_tokens: Optional[int] = None
    temperature: Optional[float] = 1.0
    top_p: Optional[float] = 1.0
    n: Optional[int] = 1
    stream: Optional[bool] = False
    logprobs: Optional[int] = None
    presence_penalty: Optional[float] = 0.0
    frequency_penalty: Optional[float] = 0.0
    stop: Optional[Union[str, List[str]]] = None
    seed: Optional[int] = None
    user: Optional[str] = None
    # OpenAI logit_bias: {"token_id": bias in [-100, 100]} (reference
    # protocol.py logit_bias -> logits-processor synthesis).
    logit_bias: Optional[Dict[str, float]] = None
    # Aphrodite extensions (reference protocol.py:128-330).
    best_of: Optional[int] = None
    top_k: Optional[int] = -1
    min_p: Optional[float] = 0.0
    top_a: Optional[float] = 0.0
    tfs: Optional[float] = 1.0
    eta_cutoff: Optional[float] = 0.0
    epsilon_cutoff: Optional[float] = 0.0
    typical_p: Optional[float] = 1.0
    smoothing_factor: Optional[float] = 0.0
    smoothing_curve: Optional[float] = 1.0
    repetition_penalty: Optional[float] = 1.0
    no_repeat_ngram_size: Optional[int] = 0
    dynatemp_min: Optional[float] = 0.0
    dynatemp_max: Optional[float] = 0.0
    dynatemp_exponent: Optional[float] = 1.0
    temperature_last: Optional[bool] = False
    xtc_threshold: Optional[float] = 0.1
    xtc_probability: Optional[float] = 0.0
    nsigma: Optional[float] = 0.0
    skew: Optional[float] = 0.0
    dry_multiplier: Optional[float] = 0.0
    dry_base: Optional[float] = 1.75
    dry_allowed_length: Optional[int] = 2
    dry_range: Optional[int] = 0
    dry_sequence_breaker_ids: Optional[List[int]] = None
    custom_token_bans: Optional[List[int]] = None
    stop_token_ids: Optional[List[int]] = None
    include_stop_str_in_output: Optional[bool] = False
    ignore_eos: Optional[bool] = False
    min_tokens: Optional[int] = 0
    skip_special_tokens: Optional[bool] = True
    spaces_between_special_tokens: Optional[bool] = True
    truncate_prompt_tokens: Optional[int] = None
    sampler_priority: Optional[List[int]] = None
    # Beam search.
    use_beam_search: Optional[bool] = False
    length_penalty: Optional[float] = 1.0
    early_stopping: Optional[Union[bool, str]] = False
    # Guided decoding (reference protocol.py guided_* extensions).
    guided_regex: Optional[str] = None
    guided_json: Optional[Union[str, Dict[str, Any]]] = None
    guided_choice: Optional[List[str]] = None
    guided_grammar: Optional[str] = None
    response_format: Optional[Dict[str, Any]] = None

    def to_sampling_params(self, default_max_tokens: int) -> SamplingParams:
        max_tokens = self.max_tokens
        if max_tokens is None:
            max_tokens = default_max_tokens
        logits_processors = None
        if self.logit_bias:
            try:
                bias = {int(t): min(100.0, max(-100.0, float(b)))
                        for t, b in self.logit_bias.items()}
            except ValueError as e:
                raise ValueError(f"invalid logit_bias: {e}") from e

            def _bias_processor(token_ids, logits):
                for tid, b in bias.items():
                    if 0 <= tid < len(logits):
                        logits[tid] += b
                return logits

            logits_processors = [_bias_processor]
        return SamplingParams(
            logits_processors=logits_processors,
            n=self.n or 1,
            best_of=self.best_of,
            use_beam_search=self.use_beam_search or False,
            length_penalty=self.length_penalty
            if self.length_penalty is not None else 1.0,
            early_stopping=self.early_stopping or False,
            presence_penalty=self.presence_penalty or 0.0,
            frequency_penalty=self.frequency_penalty or 0.0,
            repetition_penalty=self.repetition_penalty or 1.0,
            no_repeat_ngram_size=self.no_repeat_ngram_size or 0,
            temperature=self.temperature if self.temperature is not None
            else 1.0,
            dynatemp_min=self.dynatemp_min or 0.0,
            dynatemp_max=self.dynatemp_max or 0.0,
            dynatemp_exponent=self.dynatemp_exponent or 1.0,
            temperature_last=self.temperature_last or False,
            top_p=self.top_p if self.top_p is not None else 1.0,
            top_k=self.top_k if self.top_k is not None else -1,
            top_a=self.top_a or 0.0,
            min_p=self.min_p or 0.0,
            tfs=self.tfs if self.tfs is not None else 1.0,
            eta_cutoff=self.eta_cutoff or 0.0,
            epsilon_cutoff=self.epsilon_cutoff or 0.0,
            typical_p=self.typical_p if self.typical_p is not None else 1.0,
            smoothing_factor=self.smoothing_factor or 0.0,
            smoothing_curve=self.smoothing_curve or 1.0,
            xtc_threshold=self.xtc_threshold
            if self.xtc_threshold is not None else 0.1,
            xtc_probability=self.xtc_probability or 0.0,
            nsigma=self.nsigma or 0.0,
            skew=self.skew or 0.0,
            dry_multiplier=self.dry_multiplier or 0.0,
            dry_base=self.dry_base if self.dry_base is not None else 1.75,
            dry_allowed_length=self.dry_allowed_length
            if self.dry_allowed_length is not None else 2,
            dry_sequence_breaker_ids=self.dry_sequence_breaker_ids or [],
            dry_range=self.dry_range or 0,
            seed=self.seed,
            stop=self.stop,
            stop_token_ids=self.stop_token_ids,
            include_stop_str_in_output=self.include_stop_str_in_output
            or False,
            ignore_eos=self.ignore_eos or False,
            max_tokens=max_tokens,
            min_tokens=self.min_tokens or 0,
            logprobs=self.logprobs,
            skip_special_tokens=self.skip_special_tokens
            if self.skip_special_tokens is not None else True,
            spaces_between_special_tokens=(
                self.spaces_between_special_tokens
                if self.spaces_between_special_tokens is not None else True),
            custom_token_bans=self.custom_token_bans,
            sampler_priority=self.sampler_priority,
            truncate_prompt_tokens=self.truncate_prompt_tokens,
            guided_regex=self.guided_regex,
            guided_json=self.guided_json,
            guided_choice=self.guided_choice,
            guided_grammar=self.guided_grammar,
            guided_json_object=(
                (self.response_format or {}).get("type") == "json_object"),
        )


class CompletionRequest(_SamplerMixin):
    model: Optional[str] = None
    prompt: Union[str, List[str], List[int], List[List[int]]] = ""
    echo: Optional[bool] = False
    max_tokens: Optional[int] = 16


class ChatMessage(BaseModel):
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None


class ChatCompletionRequest(_SamplerMixin):
    model: Optional[str] = None
    messages: List[ChatMessage] = Field(default_factory=list)
    add_generation_prompt: Optional[bool] = True
    chat_template: Optional[str] = None
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Optional[Union[str, Dict[str, Any]]] = None


class LogProbsPart(BaseModel):
    tokens: List[str] = Field(default_factory=list)
    token_logprobs: List[Optional[float]] = Field(default_factory=list)
    top_logprobs: Optional[List[Optional[Dict[str, float]]]] = None
    text_offset: List[int] = Field(default_factory=list)


class CompletionChoice(BaseModel):
    index: int
    text: str
    logprobs: Optional[LogProbsPart] = None
    finish_reason: Optional[str] = None
    stop_reason: Optional[Union[int, str]] = None


class CompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: f"cmpl-{random_uuid()}")
    object: str = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[CompletionChoice] = Field(default_factory=list)
    usage: UsageInfo = Field(default_factory=UsageInfo)


class ChatCompletionResponseMessage(BaseModel):
    role: str = "assistant"
    content: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None


class ChatCompletionChoice(BaseModel):
    index: int
    message: ChatCompletionResponseMessage
    logprobs: Optional[Dict[str, Any]] = None
    finish_reason: Optional[str] = None
    stop_reason: Optional[Union[int, str]] = None


class ChatCompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: f"chatcmpl-{random_uuid()}")
    object: str = "chat.completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatCompletionChoice] = Field(default_factory=list)
    usage: UsageInfo = Field(default_factory=UsageInfo)


class DeltaMessage(BaseModel):
    role: Optional[str] = None
    content: Optional[str] = None


class ChatCompletionStreamChoice(BaseModel):
    index: int
    delta: DeltaMessage
    finish_reason: Optional[str] = None


class ChatCompletionStreamResponse(BaseModel):
    id: str = Field(default_factory=lambda: f"chatcmpl-{random_uuid()}")
    object: str = "chat.completion.chunk"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatCompletionStreamChoice] = Field(default_factory=list)


class TokenizeRequest(BaseModel):
    model: Optional[str] = None
    prompt: Optional[str] = None
    messages: Optional[List[ChatMessage]] = None
    add_special_tokens: bool = True
    add_generation_prompt: bool = True


class TokenizeResponse(BaseModel):
    tokens: List[int]
    count: int
    max_model_len: int


class DetokenizeRequest(BaseModel):
    model: Optional[str] = None
    tokens: List[int] = Field(default_factory=list)


class DetokenizeResponse(BaseModel):
    prompt: str
