"""Continuous-batching scheduler.

Re-design of the reference scheduler (``aphrodite/processing/scheduler.py:295``)
around one key TPU improvement: **mixed prefill+decode steps are first-class**.
The reference's TPU backend could only run all-prefill or all-decode batches
(attention/backends/pallas.py:62-63); our ragged paged-attention path takes a
single flat token stream with per-sequence query lengths, so the scheduler
freely mixes decode tokens with (chunked) prefill tokens in one device program
— equivalent to the reference's GPU chunked-prefill policy
(``_schedule_chunked_prefill``, scheduler.py:985).

Policy: FCFS. Decodes drain first (reference default policy), then running
prefills continue, then waiting groups are admitted while token/seq budget
remains. Preemption is by recompute (scheduler.py:1308-1371), victims chosen
LIFO from the running queue.
"""

import os
import random
from collections import deque
from typing import Deque, List, Optional, Tuple

from aphrodite_tpu_torch.common.config import (CacheConfig, SchedulerConfig,
                                               chain_windows_enabled)
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.sequence import (ScheduledSequence, SchedulerOutputs,
                                           Sequence, SequenceGroup,
                                           SequenceStatus)
from aphrodite_tpu_torch.processing.block_manager import BlockManager

logger = init_logger(__name__)

# Test hook mirroring APHRODITE_TEST_ENABLE_ARTIFICIAL_PREEMPT
# (reference scheduler.py:24-25).
ENABLE_ARTIFICIAL_PREEMPT = bool(
    int(os.environ.get("APHRODITE_TPU_TEST_ENABLE_ARTIFICIAL_PREEMPT", "0")))
ARTIFICIAL_PREEMPTION_PROB = 0.5


class SchedulingBudget:
    """Token + sequence budget for one step (reference scheduler.py:44)."""

    def __init__(self, token_budget: int, max_num_seqs: int) -> None:
        self.token_budget = token_budget
        self.max_num_seqs = max_num_seqs
        self.num_batched_tokens = 0
        self.num_curr_seqs = 0

    def can_schedule(self, num_new_tokens: int, num_new_seqs: int) -> bool:
        return (self.num_batched_tokens + num_new_tokens <= self.token_budget
                and self.num_curr_seqs + num_new_seqs <= self.max_num_seqs)

    def remaining_token_budget(self) -> int:
        return self.token_budget - self.num_batched_tokens

    def add(self, num_tokens: int, num_seqs: int) -> None:
        self.num_batched_tokens += num_tokens
        self.num_curr_seqs += num_seqs


class Scheduler:
    def __init__(
        self,
        scheduler_config: SchedulerConfig,
        cache_config: CacheConfig,
    ) -> None:
        self.scheduler_config = scheduler_config
        self.cache_config = cache_config
        assert cache_config.num_device_blocks is not None, (
            "cache must be sized (memory-profiled) before scheduling")
        self.block_manager = BlockManager(
            block_size=cache_config.block_size,
            num_blocks=cache_config.num_device_blocks,
            enable_prefix_caching=cache_config.enable_prefix_caching,
        )
        self.waiting: Deque[SequenceGroup] = deque()
        self.running: Deque[SequenceGroup] = deque()
        # Extra KV slots reserved per decode for multi-step execution
        # (reference lookahead slots, SchedulerOutputs:115). With
        # cross-step window chaining (worker/model_runner.py
        # _can_chain_window) the runner dispatches ONE window beyond
        # this step speculatively, so chain-ELIGIBLE requests reserve a
        # second window's worth (the chain gate requires the capacity to
        # already exist). Requests whose sampling can never chain
        # (SamplingParams.chain_speculation_eligible False) only pay the
        # plain multi-step reservation.
        nss = scheduler_config.num_scheduler_steps
        chain = chain_windows_enabled() and nss > 1
        self.num_lookahead_slots = max(0, nss - 1)
        self.num_chain_lookahead_slots = nss if chain else 0
        self.num_cumulative_preemption = 0
        self._artificial_preempt_cnt = (ARTIFICIAL_PREEMPTION_PROB
                                        if ENABLE_ARTIFICIAL_PREEMPT else 0)
        # Prefill-delay bookkeeping (reference scheduler.py:1399).
        self.prev_time = 0.0
        self.prev_prompt = False
        self.last_prompt_latency = 0.0

    def _passed_delay(self, now: float) -> bool:
        """Whether waiting prompts may be admitted this iteration
        (reference _passed_delay): once a prompt iteration ran, hold new
        admissions until the oldest waiting request's age exceeds
        delay_factor x the last prompt iteration's latency — letting
        pure-decode iterations (and their fused multi-step windows) run
        between prompt batches instead of mixing every iteration."""
        if self.prev_prompt:
            self.last_prompt_latency = now - self.prev_time
        self.prev_time, self.prev_prompt = now, False
        if self.scheduler_config.delay_factor > 0 and self.waiting:
            earliest = min(g.metrics.arrival_time for g in self.waiting)
            return ((now - earliest) >
                    (self.scheduler_config.delay_factor
                     * self.last_prompt_latency) or not self.running)
        return True

    # ---- queue management ----------------------------------------------------

    def add_seq_group(self, seq_group: SequenceGroup) -> None:
        self.waiting.append(seq_group)

    def abort_seq_group(self, request_ids) -> List[SequenceGroup]:
        if isinstance(request_ids, str):
            request_ids = [request_ids]
        ids = set(request_ids)
        aborted: List[SequenceGroup] = []
        for queue in (self.waiting, self.running):
            remaining: List[SequenceGroup] = []
            for group in queue:
                if group.request_id in ids:
                    for seq in group.get_unfinished_seqs():
                        seq.status = SequenceStatus.FINISHED_ABORTED
                        self.block_manager.free(seq)
                    aborted.append(group)
                else:
                    remaining.append(group)
            queue.clear()
            queue.extend(remaining)
        return aborted

    def has_unfinished_seqs(self) -> bool:
        return bool(self.waiting) or bool(self.running)

    def get_num_unfinished_seq_groups(self) -> int:
        return len(self.waiting) + len(self.running)

    def free_finished_seq_groups(self) -> None:
        still_running: List[SequenceGroup] = []
        for group in self.running:
            if group.is_finished():
                continue
            still_running.append(group)
        self.running = deque(still_running)

    def free_seq(self, seq: Sequence) -> None:
        self.block_manager.free(seq)

    def fork_seq(self, parent: Sequence, child: Sequence) -> None:
        self.block_manager.fork(parent, child)

    # ---- the scheduling step ---------------------------------------------------

    def schedule(self) -> SchedulerOutputs:
        budget = SchedulingBudget(
            token_budget=self.scheduler_config.max_num_batched_tokens,
            max_num_seqs=self.scheduler_config.max_num_seqs,
        )
        scheduled: List[ScheduledSequence] = []
        preempted: List[SequenceGroup] = []
        ignored: List[SequenceGroup] = []
        blocks_to_copy: List[Tuple[int, int]] = []
        num_prefill_tokens = 0
        num_decode_tokens = 0

        # Phase 1: running groups — decodes first, then in-flight prefills
        # (chunked). Iterate FCFS; preempt LIFO on block exhaustion.
        decode_first = sorted(
            self.running,
            key=lambda g: (g.is_prefill(), g.metrics.arrival_time))
        victims: List[SequenceGroup] = []
        for group in decode_first:
            if group in victims:
                continue
            group_scheds, group_preempted = self._schedule_running_group(
                group, budget, victims, blocks_to_copy)
            victims.extend(group_preempted)
            preempted.extend(group_preempted)
            for ss in group_scheds:
                scheduled.append(ss)
                if ss.seq.is_prefill:
                    num_prefill_tokens += ss.num_tokens
                else:
                    num_decode_tokens += ss.num_tokens

        for victim in victims:
            if victim in self.running:
                self.running.remove(victim)
            self.waiting.appendleft(victim)

        # Phase 2: admit waiting groups (subject to the prefill delay).
        import time as _time

        admit_ok = self._passed_delay(_time.monotonic())
        while admit_ok and self.waiting:
            group = self.waiting[0]
            seq = group.get_seqs(SequenceStatus.WAITING)[0] \
                if group.get_seqs(SequenceStatus.WAITING) else None
            if seq is None:
                # Recompute-preempted group whose seqs are WAITING-equivalent.
                seqs = [s for s in group.get_unfinished_seqs()
                        if s.status == SequenceStatus.WAITING]
                if not seqs:
                    self.waiting.popleft()
                    continue
                seq = seqs[0]
            prompt_len = seq.get_len()
            if prompt_len > self.scheduler_config.max_model_len:
                logger.warning(
                    "request %s prompt (%d tokens) exceeds max_model_len "
                    "(%d); ignoring", group.request_id, prompt_len,
                    self.scheduler_config.max_model_len)
                for s in group.get_unfinished_seqs():
                    s.status = SequenceStatus.FINISHED_IGNORED
                ignored.append(group)
                self.waiting.popleft()
                continue

            num_new_seqs = group.get_max_num_running_seqs()
            already_allocated = self.block_manager.has_seq(seq)
            if not already_allocated:
                if not self.block_manager.can_allocate(seq):
                    break
                num_cached = 0
                # Tentatively allocate to learn the prefix-cache hit size.
                num_cached = self.block_manager.allocate(seq)
                if num_cached > seq.num_computed_tokens:
                    seq.num_computed_tokens = num_cached
            num_uncomputed = seq.get_num_uncomputed_tokens()
            num_new_tokens = num_uncomputed
            if self.scheduler_config.enable_chunked_prefill:
                num_new_tokens = min(num_new_tokens,
                                     budget.remaining_token_budget())
            # Encoder-decoder: the encoder pass runs at the first
            # prefill chunk; its tokens consume step budget too.
            enc_extra = (len(seq.encoder_token_ids)
                         if seq.encoder_token_ids
                         and seq.num_computed_tokens == 0 else 0)
            if (num_new_tokens <= 0
                    or not budget.can_schedule(num_new_tokens + enc_extra,
                                               num_new_seqs)):
                if not already_allocated:
                    # Roll back the tentative allocation; keep computed-token
                    # credit for the next attempt (blocks stay cached).
                    self.block_manager.free(seq)
                    seq.num_computed_tokens = 0
                break
            self.waiting.popleft()
            seq.status = SequenceStatus.RUNNING
            self.running.append(group)
            budget.add(num_new_tokens + enc_extra, num_new_seqs)
            scheduled.append(
                ScheduledSequence(
                    seq=seq,
                    group=group,
                    num_tokens=num_new_tokens,
                    first_token_idx=seq.num_computed_tokens,
                    block_ids=self.block_manager.get_block_table(seq),
                    do_sample=(seq.num_computed_tokens +
                               num_new_tokens >= seq.get_len()),
                    cross_block_ids=self.block_manager.
                    get_cross_block_table(seq),
                ))
            num_prefill_tokens += num_new_tokens

        if num_prefill_tokens > 0:
            self.prev_prompt = True

        return SchedulerOutputs(
            scheduled=scheduled,
            num_prefill_tokens=num_prefill_tokens,
            num_decode_tokens=num_decode_tokens,
            preempted=preempted,
            ignored=ignored,
            blocks_to_copy=blocks_to_copy,
        )

    def _schedule_running_group(
        self,
        group: SequenceGroup,
        budget: SchedulingBudget,
        already_preempted: List[SequenceGroup],
        blocks_to_copy: Optional[List[Tuple[int, int]]] = None,
    ) -> Tuple[List[ScheduledSequence], List[SequenceGroup]]:
        scheds: List[ScheduledSequence] = []
        preempted: List[SequenceGroup] = []
        running_seqs = group.get_seqs(SequenceStatus.RUNNING)
        if not running_seqs:
            return scheds, preempted
        # Artificial preemption test hook.
        if (self._artificial_preempt_cnt
                and random.random() < ARTIFICIAL_PREEMPTION_PROB):
            self._preempt(group)
            return [], [group]
        for seq in running_seqs:
            if seq.is_prefill:
                num_new = min(seq.get_num_uncomputed_tokens(),
                              budget.remaining_token_budget())
                if num_new <= 0 or not budget.can_schedule(num_new, 1):
                    return scheds, preempted
            else:
                num_new = 1
                if not budget.can_schedule(1, 1):
                    return scheds, preempted
            if seq.is_prefill:
                lookahead = 0
            else:
                lookahead = self.num_lookahead_slots
                if (self.num_chain_lookahead_slots
                        and group.sampling_params is not None
                        and group.sampling_params.
                        chain_speculation_eligible):
                    lookahead += self.num_chain_lookahead_slots
            # Never reserve beyond the model-length ceiling: the block
            # table must stay within pages_per_seq. get_len() already
            # counts a prefill chunk's tokens, so the slots past it are
            # capped too (the JAX package caps only the lookahead, and its
            # table outgrows pages_per_seq where a prompt plus its chunk
            # passes max_model_len).
            mml = self.scheduler_config.max_model_len
            lookahead = min(lookahead,
                            max(0, mml - seq.get_len() - num_new))
            slots = min(num_new + lookahead, max(0, mml - seq.get_len()))
            # Ensure block capacity (incl. lookahead), preempting LIFO.
            while not self.block_manager.can_append_slots(seq, slots):
                victim = self._pick_preemption_victim(group,
                                                      already_preempted +
                                                      preempted)
                if victim is None:
                    # Preempt ourselves.
                    self._preempt(group)
                    return [], preempted + [group]
                self._preempt(victim)
                preempted.append(victim)
            cow = self.block_manager.append_slots(seq, slots)
            if cow and blocks_to_copy is not None:
                blocks_to_copy.extend(cow)
            budget.add(num_new, 1)
            scheds.append(
                ScheduledSequence(
                    seq=seq,
                    group=group,
                    num_tokens=num_new,
                    first_token_idx=seq.num_computed_tokens,
                    block_ids=self.block_manager.get_block_table(seq),
                    do_sample=(seq.num_computed_tokens + num_new >=
                               seq.get_len()),
                    cross_block_ids=self.block_manager.
                    get_cross_block_table(seq),
                ))
        return scheds, preempted

    def _pick_preemption_victim(
        self,
        requester: SequenceGroup,
        already: List[SequenceGroup],
    ) -> Optional[SequenceGroup]:
        for group in reversed(self.running):
            if group is requester or group in already:
                continue
            if group.get_seqs(SequenceStatus.RUNNING):
                return group
        return None

    def _preempt(self, group: SequenceGroup) -> None:
        self.num_cumulative_preemption += 1
        if self.num_cumulative_preemption % 50 == 1:
            logger.warning(
                "sequence group %s preempted by recompute (total "
                "preemptions: %d); consider more KV cache memory",
                group.request_id, self.num_cumulative_preemption)
        for seq in group.get_seqs(SequenceStatus.RUNNING):
            self.block_manager.free(seq)
            seq.reset_for_recompute()

    # ---- post-step bookkeeping ---------------------------------------------

    def mark_step_computed(self, outputs: SchedulerOutputs) -> None:
        """Called by the engine after the device step ran: advance computed
        counters for prefill chunks and promote prefix-cache blocks."""
        for ss in outputs.scheduled:
            ss.seq.num_computed_tokens += ss.num_tokens
            self.block_manager.mark_computed(ss.seq)
