"""The synchronous engine: request intake -> schedule -> execute -> outputs
(counterpart of aphrodite_tpu/engine/engine.py, text path).

``add_request()`` tokenizes and enqueues; ``step()`` runs one scheduler
and device iteration and returns ``RequestOutput``s for the requests it
touched. Multi-step decode windows, lazy detokenization, prompt
logprobs, guided decoding and beam search work as in the JAX package: a
guided request's token FSM is built on a worker thread while the request
waits outside the scheduler, and each token it appends advances its FSM
state; a beam request prefills one sequence and forks it as its beams
are chosen (``_process_beam_group``). Each step feeds the stat logger
(Prometheus when installed). ``warmup()`` captures every sequence
bucket's decode-window graphs before traffic. An encoder-decoder model
(T5, BART) takes the prompt as its encoder's input, and its decoder
starts from ``decoder_prompt_token_ids`` or the model's
decoder_start_token_id. LoRA, prompt adapters, multimodal inputs and
pooling come with later slices.
"""

import concurrent.futures
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
from aphrodite_tpu_torch.engine.metrics import StatLogger, Stats
from aphrodite_tpu_torch.engine.stop_checker import StopChecker
from aphrodite_tpu_torch.guided.token_fsm import get_token_fsm_future
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
        elif self.model_config.tokenizer.endswith(".gguf"):
            raise ValueError(
                "GGUF models need an HF tokenizer: pass tokenizer=<dir> "
                "(or skip_tokenizer_init=True for token-id-only usage)")
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
        # Guided requests whose FSM is still being built: (request_id,
        # group, seqs, groups to schedule, future).
        self._fsm_parked: List[tuple] = []
        self._generation_config = self._load_generation_config()
        self.stat_logger = StatLogger(self.model_config.model)
        # Per-phase wall time of engine iterations (schedule / execute /
        # postprocess), cumulative and of the latest iteration; and the
        # wall time and tokens of pure-decode iterations (no prefill
        # token) and of iterations that carry prefill tokens:
        # decode_tokens / decode_s is steady-state decode throughput,
        # prefill_tokens / prefill_s the prompt throughput of steps that
        # carry prompts.
        self.phase_timings = {
            "iterations": 0,
            "schedule_s": 0.0,
            "execute_s": 0.0,
            "postprocess_s": 0.0,
            "last_schedule_ms": 0.0,
            "last_execute_ms": 0.0,
            "last_postprocess_ms": 0.0,
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
        """generation_config.json of a model directory; a single-file
        checkpoint (.gguf) has none."""
        if not os.path.isdir(self.model_config.model):
            return {}
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
        decoder_prompt_token_ids: Optional[List[int]] = None,
    ) -> None:
        """Enqueue one request. For an encoder-decoder model the prompt
        feeds the encoder, and the decoder starts from
        decoder_prompt_token_ids, or from the model's
        decoder_start_token_id without them; a decoder-only model takes no
        decoder_prompt_token_ids."""
        if request_id in self._groups:
            raise ValueError(f"duplicate request_id {request_id!r}")
        if sampling_params is None:
            sampling_params = SamplingParams()
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("either prompt or prompt_token_ids required")
            prompt_token_ids = self.tokenizer.encode(prompt)
        if sampling_params.truncate_prompt_tokens is not None:
            prompt_token_ids = prompt_token_ids[
                -sampling_params.truncate_prompt_tokens:]
        model = self.runner.model
        encoder_token_ids = None
        if getattr(model, "encoder_takes_audio", False):
            raise NotImplementedError(
                "audio-encoder models are not ported to the PyTorch package "
                "yet (ROADMAP.md, module queue item 10: Whisper)")
        if getattr(model, "is_encoder_decoder", False):
            encoder_token_ids = list(prompt_token_ids)
            prompt_token_ids = (list(decoder_prompt_token_ids)
                                if decoder_prompt_token_ids
                                else [model.decoder_start_token_id])
        elif decoder_prompt_token_ids:
            raise ValueError("decoder_prompt_token_ids is only valid for "
                             "encoder-decoder models")
        sampling_params = sampling_params.clone()
        sampling_params.update_from_generation_config(
            self._generation_config, self.eos_token_id)

        fsm = None
        fsm_future = None
        guided = sampling_params.guided_spec
        if guided is not None:
            if self.tokenizer is None:
                raise ValueError("guided decoding needs a tokenizer")
            fut = get_token_fsm_future(guided[0], guided[1], self.tokenizer,
                                       self.model_config.get_vocab_size())
            if fut.done():
                # A cached spec, or a build that failed at once: resolved
                # here, so that a bad spec raises out of add_request.
                fsm = fut.result()
            else:
                # The request waits outside the scheduler until its FSM is
                # built, so the steps of other requests do not wait.
                fsm_future = fut

        # Beam search: one sequence prefills; beams fork after the first
        # sampling step (joint pruning in _process_beam_group). best_of
        # sampling: sequences run independently from the first token, each
        # scheduled as its own single-seq group sharing the parent group's
        # bookkeeping.
        num_initial = 1 if sampling_params.use_beam_search else \
            sampling_params.best_of
        seqs = []
        for sub_idx in range(num_initial):
            seq = Sequence(
                seq_id=self._next_seq_id(),
                prompt_token_ids=prompt_token_ids,
                block_size=self.config.cache_config.block_size,
                eos_token_id=self.eos_token_id,
                prompt=prompt,
            )
            if fsm is not None:
                seq.fsm = fsm
                seq.fsm_state = fsm.initial_state()
            seq.encoder_token_ids = encoder_token_ids
            seq.seed_offset = sub_idx
            seqs.append(seq)
        group = SequenceGroup(
            request_id=request_id,
            seqs=seqs,
            sampling_params=sampling_params,
            arrival_time=arrival_time,
        )
        if sampling_params.use_beam_search:
            group.completed_beams = []
        self._groups[request_id] = group
        if len(seqs) == 1:
            to_schedule = [group]
        else:
            to_schedule = []
            for seq in seqs:
                sub = SequenceGroup(
                    request_id=request_id,
                    seqs=[seq],
                    sampling_params=sampling_params,
                    arrival_time=arrival_time,
                )
                sub.metrics = group.metrics
                to_schedule.append(sub)
        if fsm_future is not None:
            self._fsm_parked.append((request_id, group, seqs, to_schedule,
                                     fsm_future))
        else:
            for g in to_schedule:
                self.scheduler.add_seq_group(g)

    def _admit_ready_fsms(self) -> List[str]:
        """Move the parked guided requests whose FSM is built into the
        scheduler, and fail those whose build raised. Returns the ids of
        the failed requests (they need an output this step). It waits
        briefly only when the engine has nothing else to run."""
        if not self._fsm_parked:
            return []
        if not self.scheduler.has_unfinished_seqs():
            concurrent.futures.wait([e[4] for e in self._fsm_parked],
                                    timeout=0.01)
        errored: List[str] = []
        still_parked = []
        for entry in self._fsm_parked:
            request_id, group, seqs, to_schedule, fut = entry
            if request_id not in self._groups:
                continue  # aborted while parked
            if not fut.done():
                still_parked.append(entry)
                continue
            try:
                fsm = fut.result()
            except Exception as e:  # noqa: BLE001
                logger.error("guided FSM build failed for request %s: %s",
                             request_id, e)
                group.error = f"guided decoding compilation failed: {e}"
                for seq in seqs:
                    seq.status = SequenceStatus.FINISHED_ABORTED
                errored.append(request_id)
                continue
            for seq in seqs:
                seq.fsm = fsm
                seq.fsm_state = fsm.initial_state()
            for g in to_schedule:
                self.scheduler.add_seq_group(g)
        self._fsm_parked = still_parked
        return errored

    def abort_request(self, request_id: Union[str, Iterable[str]]) -> None:
        ids = [request_id] if isinstance(request_id, str) else \
            list(request_id)
        self.scheduler.abort_seq_group(ids)
        for rid in ids:
            self._groups.pop(rid, None)

    def has_unfinished_requests(self) -> bool:
        return (self.scheduler.has_unfinished_seqs()
                or bool(self._fsm_parked))

    # ---- frontend-callable utilities (in-process, or over the socket
    # protocol of engine/multiproc.py) ----------------------------------

    def get_phase_timings(self) -> Dict[str, Any]:
        """The phase timings, with the decode windows' graph replays,
        captures and capture seconds summed over the runner's keys (the
        JAX engine merges its pipeline stats here)."""
        out = dict(self.phase_timings)
        stats = self.runner.graph_stats().values()
        out["graph_keys"] = len(stats)
        out["graph_replays"] = sum(g["replays"] for g in stats)
        out["graph_captures"] = sum(g["captures"] for g in stats)
        out["graph_capture_s"] = sum(g["capture_s"] for g in stats)
        return out

    def warmup(self) -> None:
        """Run synthetic waves at every sequence bucket up to max_num_seqs
        before traffic: each wave prefills at the full token budget and
        decodes through two windows, so every bucket's decode-window
        graph is warmed up and captured here (the JAX engine compiles its
        program grid the same way), not under live load. Mixed prefill
        and decode steps run too: the second half of a wave prefills
        beside the first half's decodes."""
        t0 = time.monotonic()
        nss = max(1, self.scheduler_config.num_scheduler_steps)
        vocab = self.model_config.get_vocab_size()
        budget = self.scheduler_config.max_num_batched_tokens
        rng = np.random.default_rng(0)
        waves = [s for s in self.runner.seq_buckets
                 if s <= self.scheduler_config.max_num_seqs]
        sp = SamplingParams(temperature=0.0, max_tokens=2 * nss + 2,
                            ignore_eos=True, detokenize=False)

        def add(tag, n, plen):
            for i in range(n):
                self.add_request(
                    f"__warmup_{tag}_{i}",
                    prompt_token_ids=rng.integers(
                        0, vocab, size=(max(1, plen),)).tolist(),
                    sampling_params=sp)

        for S in waves:
            plen = int(min(budget // S,
                           self.model_config.max_model_len // 2,
                           self.model_config.max_model_len
                           - 2 * nss - 3))
            if plen < 1:
                continue  # context too small for this wave's decode run
            add(f"{S}a", max(1, S // 2), plen)
            self.step()
            self.step()
            add(f"{S}b", S - max(1, S // 2), plen)
            while self.has_unfinished_requests():
                self.step()
        # Warm-up traffic would read as steady-state throughput.
        for k, v in self.phase_timings.items():
            self.phase_timings[k] = 0 if isinstance(v, int) else 0.0
        logger.info("warmup: %d sequence buckets in %.1f s", len(waves),
                    time.monotonic() - t0)

    def prometheus_metrics(self) -> bytes:
        """The Prometheus registry of the process the engine runs in, as
        text (empty without prometheus_client): what the server's /metrics
        answers, also when the engine runs in a child process."""
        try:
            import prometheus_client
        except ImportError:
            return b""
        return prometheus_client.generate_latest()

    def profile_start(self, trace_dir: str) -> None:
        """Start a torch.profiler trace of this process (host and, on the
        card, CUDA activity); ``profile_stop`` writes it to trace_dir as
        a Chrome trace."""
        if getattr(self, "_profiler", None) is not None:
            raise RuntimeError("a trace is already running")
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.runner.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()
        self._trace_dir = trace_dir

    def profile_stop(self) -> None:
        prof = getattr(self, "_profiler", None)
        if prof is None:
            raise RuntimeError("no trace is running")
        self._profiler = None
        prof.stop()
        os.makedirs(self._trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self._trace_dir, "trace.json"))

    # ------------------------------------------------------------------
    # The hot loop
    # ------------------------------------------------------------------

    def step(self) -> List[RequestOutput]:
        t0 = time.monotonic()
        fsm_errored = self._admit_ready_fsms()
        scheduler_outputs = self.scheduler.schedule()
        t_sched = time.monotonic()
        if scheduler_outputs.is_empty():
            return self._make_outputs(scheduler_outputs.ignored,
                                      set(fsm_errored))

        for ss in scheduler_outputs.scheduled:
            ss.group.maybe_set_first_scheduled_time(t0)

        result = self.runner.execute(
            scheduler_outputs,
            num_steps=self.scheduler_config.num_scheduler_steps)
        t_exec = time.monotonic()
        num_steps_done = result.sampled.shape[0]

        # Advance computed-token counters BEFORE appending new tokens (the
        # appended token's KV is computed by the next step — or, for
        # multi-step, was already computed on the device).
        self.scheduler.mark_step_computed(scheduler_outputs)
        if result.prompt is not None:
            self._process_prompt_logprobs(scheduler_outputs, result)

        touched = set()
        now = time.monotonic()
        beam_groups: Dict[int, List] = {}
        self._tokens_appended_iter = 0
        for i, ss in enumerate(scheduler_outputs.scheduled):
            seq = ss.seq
            group = self._groups.get(ss.group.request_id)
            touched.add(ss.group.request_id)
            if not ss.do_sample:
                continue  # mid-prefill chunk: no token produced
            sp = ss.group.sampling_params
            if sp.use_beam_search:
                beam_groups.setdefault(id(ss.group), []).append((i, ss))
                continue
            need_inc = sp.detokenize and self.tokenizer is not None \
                and (bool(sp.stop) or not self.lazy_detokenize)
            if (num_steps_done > 1 and seq.fsm is None
                    and sp.logprobs is None and not need_inc
                    and not sp.logits_processors):
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

        for rows in beam_groups.values():
            self._process_beam_group(rows, result)

        self.scheduler.free_finished_seq_groups()
        self._log_stats(scheduler_outputs, now)
        t_post = time.monotonic()
        elapsed = t_post - t0
        pt = self.phase_timings
        pt["iterations"] += 1
        pt["schedule_s"] += t_sched - t0
        pt["execute_s"] += t_exec - t_sched
        pt["postprocess_s"] += t_post - t_exec
        pt["last_schedule_ms"] = (t_sched - t0) * 1e3
        pt["last_execute_ms"] = (t_exec - t_sched) * 1e3
        pt["last_postprocess_ms"] = (t_post - t_exec) * 1e3
        if scheduler_outputs.num_prefill_tokens == 0:
            pt["decode_iterations"] += 1
            pt["decode_s"] += elapsed
            pt["decode_tokens"] += self._tokens_appended_iter
        else:
            pt["prefill_iterations"] += 1
            pt["prefill_s"] += elapsed
            pt["prefill_tokens"] += scheduler_outputs.num_prefill_tokens
        return self._make_outputs(scheduler_outputs.ignored,
                                  touched | set(fsm_errored))

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
        """Per-token append: rows with a guided FSM to advance, requested
        logprobs or incremental detokenization (stop strings /
        streaming)."""
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
            if seq.fsm is not None:
                seq.fsm_state = seq.fsm.next_state(seq.fsm_state, token_id)
                if seq.fsm_state < 0:
                    # The automaton left its language (only through the
                    # EOS forced at a dead end): stop here.
                    seq.status = SequenceStatus.FINISHED_STOPPED
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

    def _log_stats(self, scheduler_outputs, now: float) -> None:
        bm = self.scheduler.block_manager
        kv_usage = 1.0 - bm.get_num_free_blocks() / max(bm.num_blocks, 1)
        stats = Stats(
            now=now,
            num_running=len(self.scheduler.running),
            num_waiting=len(self.scheduler.waiting),
            kv_usage=kv_usage,
            prefix_cache_hit_rate=bm.get_prefix_cache_hit_rate(),
            num_preemptions_iter=len(scheduler_outputs.preempted),
            num_prompt_tokens_iter=scheduler_outputs.num_prefill_tokens,
            # Tokens appended (a window appends several per decode row).
            num_generation_tokens_iter=self._tokens_appended_iter,
            # Phase times lag one iteration: the current iteration's
            # postprocess is not over when the stats are cut.
            schedule_ms_iter=self.phase_timings["last_schedule_ms"],
            execute_ms_iter=self.phase_timings["last_execute_ms"],
            postprocess_ms_iter=self.phase_timings["last_postprocess_ms"],
        )
        for ss in scheduler_outputs.scheduled:
            m = ss.group.metrics
            if not ss.do_sample:
                continue
            if ss.seq.get_output_len() == 1 and m.first_scheduled_time:
                stats.time_to_first_tokens_iter.append(
                    now - m.arrival_time)
            elif ss.seq.get_output_len() > 1:
                if m.last_token_time:
                    stats.time_per_output_tokens_iter.append(
                        now - m.last_token_time)
            m.last_token_time = now
            if ss.seq.is_finished():
                stats.time_e2e_requests.append(now - m.arrival_time)
                reason = SequenceStatus.get_finished_reason(ss.seq.status)
                if reason:
                    stats.finished_reason_iter.append(reason)
        self.stat_logger.log(stats)

    def _process_prompt_logprobs(self, scheduler_outputs, result) -> None:
        """Attach each prompt token's logprobs from the pass over the
        token stream (the first prompt token's entry is None)."""
        tgt_lp, ranks, pk_ids, pk_lp = result.prompt
        off = 0
        for ss in scheduler_outputs.scheduled:
            sp = ss.group.sampling_params
            seq = ss.seq
            num_plp = sp.prompt_logprobs
            chunk_is_prefill = ss.first_token_idx < seq.get_prompt_len()
            if num_plp is None or not chunk_is_prefill:
                off += ss.num_tokens
                continue
            if seq.prompt_logprobs is None:
                seq.prompt_logprobs = [None]
            ids = seq.get_token_ids()
            for j in range(ss.num_tokens):
                tpos = ss.first_token_idx + j + 1
                if tpos >= seq.get_prompt_len():
                    break
                row = off + j
                entry = {
                    int(ids[tpos]): Logprob(logprob=float(tgt_lp[row]),
                                            rank=int(ranks[row]))
                }
                for k in range(min(num_plp, pk_ids.shape[1])):
                    entry.setdefault(
                        int(pk_ids[row, k]),
                        Logprob(logprob=float(pk_lp[row, k]), rank=k + 1))
                # A chunk may run again after a preemption: the list stays
                # aligned with the positions.
                while len(seq.prompt_logprobs) <= tpos:
                    seq.prompt_logprobs.append(None)
                seq.prompt_logprobs[tpos] = entry
            off += ss.num_tokens

    def _process_beam_group(self, rows: List, result) -> None:
        """Joint beam expansion and pruning for one request.

        Each live beam's row carries its top 2 x width candidate logprobs
        (sampling/metadata.py); the global top `width` continuations are
        kept, a beam chosen several times forks, and EOS or length-capped
        hypotheses retire. When the search is done (no live beam, or
        early_stopping, or no live beam can beat the width-th hypothesis
        under length_penalty), the best n hypotheses become the group's
        sequences."""
        group = rows[0][1].group
        sp = group.sampling_params
        width = sp.best_of
        completed = group.completed_beams

        # Candidate continuations: (new cumulative logprob, seq, token, lp).
        candidates = []
        K = result.topk_ids.shape[2]
        for i, ss in rows:
            seq = ss.seq
            for j in range(K):
                tid = int(result.topk_ids[0, i, j])
                lp = float(result.topk_logprobs[0, i, j])
                candidates.append((seq.cumulative_logprob + lp, seq, tid,
                                   lp))
        candidates.sort(key=lambda c: c[0], reverse=True)

        live_seqs = [ss.seq for _, ss in rows]
        selections: List = []  # (seq, token, lp)
        for cum, seq, tid, lp in candidates:
            if len(selections) >= width:
                break
            is_eos = (seq.eos_token_id is not None
                      and tid == seq.eos_token_id
                      and not sp.ignore_eos)
            if is_eos:
                if len(completed) < 2 * width:
                    hyp = seq.fork(self._next_seq_id())
                    hyp.append_token_id(tid, lp)
                    hyp.status = SequenceStatus.FINISHED_STOPPED
                    self._decode_beam(hyp, sp)
                    completed.append(hyp)
                continue
            selections.append((seq, tid, lp))

        # Fork the parents chosen more than once before appending.
        by_parent: Dict[int, List] = {}
        for seq, tid, lp in selections:
            by_parent.setdefault(seq.seq_id, []).append((seq, tid, lp))
        new_live: List[Sequence] = []
        for sels in by_parent.values():
            parent = sels[0][0]
            forks = [parent]
            for _ in range(len(sels) - 1):
                child = parent.fork(self._next_seq_id())
                self.scheduler.fork_seq(parent, child)
                group.add(child)
                forks.append(child)
            for target, (_, tid, lp) in zip(forks, sels):
                target.append_token_id(tid, lp)
                target.num_computed_tokens = target.get_len() - 1
                new_live.append(target)
        # Prune the live beams not chosen.
        selected_ids = {s.seq_id for s in new_live}
        for seq in live_seqs:
            if seq.seq_id not in selected_ids:
                seq.status = SequenceStatus.FINISHED_ABORTED
                self.scheduler.free_seq(seq)
                group.remove(seq.seq_id)
        # Length cap: live beams reaching max_tokens become hypotheses.
        still_live = []
        for seq in new_live:
            capped = ((sp.max_tokens is not None
                       and seq.get_output_len() >= sp.max_tokens)
                      or seq.get_len() >= self.model_config.max_model_len)
            if capped:
                self._retire_beam(seq, sp, group)
            else:
                still_live.append(seq)

        def score(s: Sequence) -> float:
            return s.cumulative_logprob / max(
                s.get_output_len(), 1)**sp.length_penalty

        done = False
        if not still_live:
            done = True
        elif len(completed) >= width:
            if sp.early_stopping is True:
                done = True
            else:
                best_live = max(score(s) for s in still_live)
                top_completed = sorted((score(s) for s in completed),
                                       reverse=True)[:width]
                done = best_live <= top_completed[-1]
        if done:
            for seq in still_live:
                # The live beams left count as hypotheses too.
                self._retire_beam(seq, sp, group)
            best = sorted(completed, key=score, reverse=True)[:sp.n]
            # The final hypotheses become the group's sequences, which
            # RequestOutput.from_seq_group reports.
            group.seqs.clear()
            group._seq_dict.clear()
            for seq in best:
                group.add(seq)

    def _retire_beam(self, seq: Sequence, sp: SamplingParams,
                     group: SequenceGroup) -> None:
        """A live beam becomes a length-capped hypothesis."""
        seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
        self._decode_beam(seq, sp)
        group.completed_beams.append(seq)
        self.scheduler.free_seq(seq)
        group.remove(seq.seq_id)

    def _decode_beam(self, seq: Sequence, sp: SamplingParams) -> None:
        """A hypothesis's text, decoded once from its output tokens."""
        if sp.detokenize and self.tokenizer is not None:
            seq.output_text = self.tokenizer.decode(
                seq.output_token_ids,
                skip_special_tokens=sp.skip_special_tokens)

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
