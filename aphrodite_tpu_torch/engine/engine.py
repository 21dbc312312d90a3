"""The synchronous engine: request intake -> schedule -> execute -> outputs
(counterpart of aphrodite_tpu/engine/engine.py, offline text path).

``add_request()`` tokenizes and enqueues; ``step()`` runs one scheduler
and device iteration and returns ``RequestOutput``s for the requests it
touched. Multi-step decode windows and lazy detokenization work as in the
JAX package. LoRA, prompt adapters, multimodal and encoder-decoder
inputs, guided decoding, beam search and metrics come with later slices.
"""

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np

from aphrodite_tpu_torch.common.config import EngineConfig
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.outputs import RequestOutput
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.sequence import (Logprob, Sequence,
                                                 SequenceGroup,
                                                 SequenceStatus)
from aphrodite_tpu_torch.engine.args import EngineArgs
from aphrodite_tpu_torch.engine.stop_checker import StopChecker
from aphrodite_tpu_torch.processing.scheduler import Scheduler
from aphrodite_tpu_torch.transformers_utils.detokenizer import (
    detokenize_incrementally)
from aphrodite_tpu_torch.transformers_utils.tokenizer import get_tokenizer
from aphrodite_tpu_torch.worker.model_runner import ModelRunner

logger = init_logger(__name__)


class AphroditeEngine:
    def __init__(self, engine_config: EngineConfig) -> None:
        self.config = engine_config
        self.model_config = engine_config.model_config
        self.scheduler_config = engine_config.scheduler_config

        if self.model_config.skip_tokenizer_init:
            self.tokenizer = None
            self.eos_token_id = None
        else:
            self.tokenizer = get_tokenizer(
                self.model_config.tokenizer,
                trust_remote_code=self.model_config.trust_remote_code)
            self.eos_token_id = self.tokenizer.eos_token_id

        self.runner = ModelRunner(engine_config)
        self.runner.load_model()
        self.runner.initialize_cache()
        self.scheduler = Scheduler(engine_config.scheduler_config,
                                   engine_config.cache_config)
        self.stop_checker = StopChecker(self.model_config.max_model_len)
        # Offline consumers (LLM.generate) read text only at finish;
        # they opt into lazy detokenization.
        self.lazy_detokenize = False

        self._seq_counter = 0
        self._groups: Dict[str, SequenceGroup] = {}
        self._generation_config = self._load_generation_config()
        # Wall time and tokens of pure-decode iterations (no prefill
        # token) and of iterations that carry prefill tokens:
        # decode_tokens / decode_s is steady-state decode throughput,
        # prefill_tokens / prefill_s the prompt throughput of steps that
        # carry prompts.
        self.phase_timings = {
            "decode_iterations": 0,
            "decode_s": 0.0,
            "decode_tokens": 0,
            "prefill_iterations": 0,
            "prefill_s": 0.0,
            "prefill_tokens": 0,
        }

    @classmethod
    def from_engine_args(cls, engine_args: EngineArgs) -> "AphroditeEngine":
        return cls(engine_args.create_engine_config())

    def _load_generation_config(self) -> Dict[str, Any]:
        path = os.path.join(self.model_config.model,
                            "generation_config.json")
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def _next_seq_id(self) -> int:
        self._seq_counter += 1
        return self._seq_counter

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------

    def add_request(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        sampling_params: Optional[SamplingParams] = None,
        prompt_token_ids: Optional[List[int]] = None,
        arrival_time: Optional[float] = None,
    ) -> None:
        if request_id in self._groups:
            raise ValueError(f"duplicate request_id {request_id!r}")
        if sampling_params is None:
            sampling_params = SamplingParams()
        if sampling_params.use_beam_search:
            raise NotImplementedError(
                "beam search is not ported to the PyTorch package yet")
        if sampling_params.guided_spec is not None:
            raise NotImplementedError(
                "guided decoding is not ported to the PyTorch package yet")
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("either prompt or prompt_token_ids required")
            prompt_token_ids = self.tokenizer.encode(prompt)
        if sampling_params.truncate_prompt_tokens is not None:
            prompt_token_ids = prompt_token_ids[
                -sampling_params.truncate_prompt_tokens:]
        sampling_params = sampling_params.clone()
        sampling_params.update_from_generation_config(
            self._generation_config, self.eos_token_id)

        # best_of sampling: sequences run independently from the first
        # token, each scheduled as its own single-seq group sharing the
        # parent group's bookkeeping.
        seqs = []
        for sub_idx in range(sampling_params.best_of):
            seq = Sequence(
                seq_id=self._next_seq_id(),
                prompt_token_ids=prompt_token_ids,
                block_size=self.config.cache_config.block_size,
                eos_token_id=self.eos_token_id,
                prompt=prompt,
            )
            seq.seed_offset = sub_idx
            seqs.append(seq)
        group = SequenceGroup(
            request_id=request_id,
            seqs=seqs,
            sampling_params=sampling_params,
            arrival_time=arrival_time,
        )
        self._groups[request_id] = group
        if len(seqs) == 1:
            self.scheduler.add_seq_group(group)
            return
        for seq in seqs:
            sub = SequenceGroup(
                request_id=request_id,
                seqs=[seq],
                sampling_params=sampling_params,
                arrival_time=arrival_time,
            )
            sub.metrics = group.metrics
            self.scheduler.add_seq_group(sub)

    def abort_request(self, request_id: Union[str, Iterable[str]]) -> None:
        ids = [request_id] if isinstance(request_id, str) else \
            list(request_id)
        self.scheduler.abort_seq_group(ids)
        for rid in ids:
            self._groups.pop(rid, None)

    def has_unfinished_requests(self) -> bool:
        return self.scheduler.has_unfinished_seqs()

    def get_phase_timings(self) -> Dict[str, Any]:
        return dict(self.phase_timings)

    # ------------------------------------------------------------------
    # The hot loop
    # ------------------------------------------------------------------

    def step(self) -> List[RequestOutput]:
        t0 = time.monotonic()
        scheduler_outputs = self.scheduler.schedule()
        if scheduler_outputs.is_empty():
            return self._make_outputs(scheduler_outputs.ignored, set())

        for ss in scheduler_outputs.scheduled:
            ss.group.maybe_set_first_scheduled_time(t0)

        result = self.runner.execute(
            scheduler_outputs,
            num_steps=self.scheduler_config.num_scheduler_steps)
        num_steps_done = result.sampled.shape[0]

        # Advance computed-token counters BEFORE appending new tokens (the
        # appended token's KV is computed by the next step — or, for
        # multi-step, was already computed on the device).
        self.scheduler.mark_step_computed(scheduler_outputs)

        touched = set()
        now = time.monotonic()
        self._tokens_appended_iter = 0
        for i, ss in enumerate(scheduler_outputs.scheduled):
            seq = ss.seq
            group = self._groups.get(ss.group.request_id)
            touched.add(ss.group.request_id)
            if not ss.do_sample:
                continue  # mid-prefill chunk: no token produced
            sp = ss.group.sampling_params
            need_inc = sp.detokenize and self.tokenizer is not None \
                and (bool(sp.stop) or not self.lazy_detokenize)
            if num_steps_done > 1 and sp.logprobs is None and not need_inc:
                self._append_window_bulk(seq, sp, result, i,
                                         num_steps_done)
            else:
                self._append_window_slow(seq, sp, result, i,
                                         num_steps_done, need_inc)
            if seq.is_finished():
                if (not need_inc and sp.detokenize
                        and self.tokenizer is not None):
                    self._decode_sequence_full(seq, sp)
                self.scheduler.free_seq(seq)
            ss.group.maybe_set_first_token_time(now)
            if group is not None:
                group.maybe_set_first_token_time(now)

        self.scheduler.free_finished_seq_groups()
        elapsed = time.monotonic() - t0
        pt = self.phase_timings
        if scheduler_outputs.num_prefill_tokens == 0:
            pt["decode_iterations"] += 1
            pt["decode_s"] += elapsed
            pt["decode_tokens"] += self._tokens_appended_iter
        else:
            pt["prefill_iterations"] += 1
            pt["prefill_s"] += elapsed
            pt["prefill_tokens"] += scheduler_outputs.num_prefill_tokens
        return self._make_outputs(scheduler_outputs.ignored, touched)

    def _append_window_bulk(self, seq, sp, result, i: int,
                            num_steps_done: int) -> None:
        """Vectorized window append for rows that need no per-token host
        work (no requested logprobs, no incremental detokenization):
        numpy finds the stop cutoff, then the tokens append in one call."""
        n = num_steps_done
        if seq.is_finished():
            return
        toks = np.asarray(result.sampled[:n, i])
        out_len = seq.get_output_len()
        counts = out_len + np.arange(1, n + 1)  # output len after token j
        eos = seq.eos_token_id
        check_eos = not sp.ignore_eos and eos is not None
        stop_ids = sp.all_stop_token_ids
        stop_mask = np.zeros((n,), bool)
        if check_eos:
            stop_mask |= toks == eos
        if stop_ids:
            stop_mask |= np.isin(toks, list(stop_ids))
        if sp.min_tokens:
            # Stop tokens are inert until min_tokens outputs exist.
            stop_mask &= counts >= sp.min_tokens
        cut, status, stop_reason = n, None, None
        hits = np.nonzero(stop_mask)[0]
        if hits.size:
            j = int(hits[0])
            cut = j + 1
            status = SequenceStatus.FINISHED_STOPPED
            tok = int(toks[j])
            if not (check_eos and tok == eos):
                stop_reason = tok
        # Length caps; at the same position a stop token wins.
        len_cut = n + 1
        if sp.max_tokens is not None and out_len + n >= sp.max_tokens:
            len_cut = sp.max_tokens - out_len
        mml_cut = (self.stop_checker.max_model_len - seq.get_prompt_len()
                   - out_len)
        if mml_cut < len_cut:
            len_cut = mml_cut
        if len_cut <= n and (len_cut < cut
                             or (len_cut == cut and status is None)):
            cut = max(len_cut, 0)
            status = SequenceStatus.FINISHED_LENGTH_CAPPED
            stop_reason = None
        if cut > 0:
            lp_sum = float(np.asarray(result.sampled_logprob[:cut, i],
                                      np.float64).sum())
            seq.extend_token_ids(toks[:cut].tolist(), lp_sum)
            seq.num_computed_tokens += cut - 1
            self._tokens_appended_iter += cut
        if status is not None:
            seq.status = status
            seq.stop_reason = stop_reason

    def _append_window_slow(self, seq, sp, result, i: int,
                            num_steps_done: int, need_inc: bool) -> None:
        """Per-token append: rows with requested logprobs or incremental
        detokenization (stop strings / streaming)."""
        for k in range(num_steps_done):
            if seq.is_finished():
                break  # later multi-step tokens are discarded
            if k > 0:
                # KV of the token appended at step k-1 was computed on
                # the device during the multi-step window.
                seq.num_computed_tokens += 1
            token_id = int(result.sampled[k, i])
            logprob_val = float(result.sampled_logprob[k, i])
            seq.append_token_id(token_id, logprob_val)
            self._tokens_appended_iter += 1
            if sp.logprobs is not None:
                entry = {
                    token_id: Logprob(
                        logprob=logprob_val,
                        rank=int(result.sampled_rank[k, i]))
                }
                for j in range(min(sp.logprobs, result.topk_ids.shape[2])):
                    entry.setdefault(
                        int(result.topk_ids[k, i, j]),
                        Logprob(logprob=float(result.topk_logprobs[k, i, j]),
                                rank=j + 1))
                seq.output_logprobs.append(entry)
            new_text = ""
            if need_inc:
                new_text = self._decode_sequence(seq, sp)
            self.stop_checker.maybe_stop_sequence(seq, new_text, sp)

    def _decode_sequence_full(self, seq: Sequence,
                              sp: SamplingParams) -> None:
        """One-shot decode of the whole output at finish (lazy mode): a
        short prompt-tail context pins the first token's leading-space
        handling so the text matches the incremental path."""
        tok = self.tokenizer
        ctx = list(seq.prompt_token_ids[-8:]) if seq.prompt_token_ids \
            else []
        kw = dict(
            skip_special_tokens=sp.skip_special_tokens,
            spaces_between_special_tokens=(
                sp.spaces_between_special_tokens))
        prefix = tok.decode(ctx, **kw) if ctx else ""
        text = tok.decode(ctx + list(seq.output_token_ids),
                          **kw)[len(prefix):]
        # The incremental path defers any text ENDING in U+FFFD
        # (incomplete trailing UTF-8), so its final text never ends with
        # one; match that.
        seq.output_text = text.rstrip("\ufffd") \
            if text.endswith("\ufffd") else text

    def _decode_sequence(self, seq: Sequence,
                         sampling_params: SamplingParams) -> str:
        new_tokens, new_text, prefix_offset, read_offset = \
            detokenize_incrementally(
                self.tokenizer,
                all_token_ids=seq.get_token_ids(),
                prev_tokens=seq.tokens,
                prefix_offset=seq.prefix_offset,
                read_offset=seq.read_offset,
                skip_special_tokens=sampling_params.skip_special_tokens,
                spaces_between_special_tokens=(
                    sampling_params.spaces_between_special_tokens),
            )
        if seq.tokens is None:
            seq.tokens = new_tokens
        else:
            seq.tokens.extend(new_tokens)
        seq.prefix_offset = prefix_offset
        seq.read_offset = read_offset
        seq.output_text += new_text
        return new_text

    def _make_outputs(self, ignored_groups, touched_ids
                      ) -> List[RequestOutput]:
        outputs: List[RequestOutput] = []
        now = time.monotonic()
        touched_ids = set(touched_ids) | {g.request_id
                                          for g in ignored_groups}
        for rid in sorted(touched_ids):
            group = self._groups.get(rid)
            if group is None:
                continue
            fin = group.is_finished()
            if fin:
                group.set_finished_time(now)
            # Offline (lazy) mode: nothing reads per-step outputs of
            # unfinished requests — skip building them.
            if fin or not self.lazy_detokenize:
                outputs.append(RequestOutput.from_seq_group(group))
            if fin:
                self._groups.pop(rid, None)
        return outputs
