"""Model runner: scheduler outputs -> device work (counterpart of
aphrodite_tpu/worker/model_runner.py for the offline dense path).

The runner owns the parameters, the paged KV cache
[L, num_pages + 1, page_size, 2*KV, D] (the last page of every layer is
the trash page that padding tokens write to; its element type is the
model's, or with ``kv_cache_dtype`` an 8-bit one written through
per-layer scales). Prefill and mixed steps run one forward over the flat
token stream, eagerly, and sample with every stage the batch asks for:
the history stages (penalties, DRY, no-repeat-ngram) on the rows' token
histories, the guided allow-mask from each row's FSM state, host logits
processors between the forward and the sampler, and the prompt logprobs
of prefill chunks over the whole token stream, in chunks of
``PROMPT_LOGPROB_ROWS`` rows. Each row draws its noise from its own key:
the request's seed (or one derived from the request and sequence) mixed
with the row's generated length, so a seeded request draws the same
tokens in any batch.

Pure-decode steps run the fused decode window, the counterpart of the
JAX package's ``_get_multi_step_fn``: ``decode_window`` runs W forwards
and samples over static buffers the runner owns per sequence bucket S
(``WindowBuffers``: the device-resident carry
[token_ids | positions | step_offset], the step's page table, KV
capacity and row count, and the sampling tensors), advances the carry in
place and packs every step's outputs into one int32 buffer. On a card
each key (S, W, flags, pages_per_seq) runs it once eagerly as warm-up
(builds the kernels, sets their attributes, fills the plan caches), then
captures it into a CUDA graph (one memory pool for all of the runner's
graphs) and replays that graph for every later window; a capture that
fails raises. On the CPU the function runs eagerly every time.
``_execute_multi`` ports the JAX method of that name around it: the
carry is reused when the batch fingerprint matches, each window's
outputs go to a pinned host buffer behind a CUDA event, and when
``_can_chain_window`` allows it the next step's first window is
dispatched before this step's outputs are read. All-greedy steps with an
unchanged row set reuse the previous step's sampling tensors. Only batches
whose sampling needs no per-step host state take the window (the JAX
package's gate): no history stage, min_tokens, guided FSM or host logits
processor. Inside a window each step folds its index plus the carry's
step offset (the steps the carry has run since the sampling tensors were
built) into the rows' keys on the device (``_fold_key_data``), so a step
of a window draws what a single step at that length draws, and a replay
what the eager window draws.

Encoder-decoder models (T5, BART) run the JAX package's encoder-decoder
path: a second cache of the self cache's shape holds each sequence's
cross K/V, written once by an encoder pass at the sequence's first prefill
chunk (``_run_encoder``, padded to the history buckets) and read by every
decoder step through the batch's cross table; prefix caching is off, and
every decode step is a single eager step (no window: its graphs hold no
cross buffers), as in the JAX package. Such a step is marked as pure
decode (``cu_q_lens=None``, one token a row), so that its self-attention
takes the decode kernel; the JAX runner marks only its windows' steps so,
and runs none for these models.

Token and sequence counts are padded to the JAX package's buckets, so
the shapes stay few and fixed.
"""

import inspect
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.config import (EngineConfig,
                                               chain_windows_enabled)
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.sequence import (ScheduledSequence,
                                                 SchedulerOutputs)
from aphrodite_tpu_torch.common.utils import cdiv
from aphrodite_tpu_torch.loader.weights import (kv_scales_from_jax,
                                                load_kv_cache_scales,
                                                load_model_params)
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.models.registry import get_model_class
from aphrodite_tpu_torch.sampling.metadata import (SamplerInputRow,
                                                   SamplingFlags,
                                                   SamplingTensors,
                                                   build_sampling_tensors)
from aphrodite_tpu_torch.sampling.sampler import (SamplerOutput,
                                                  prompt_logprobs, sample,
                                                  tensors_to_device)

logger = init_logger(__name__)

_KV_DTYPES = {
    "auto": None,  # the model dtype
    "bfloat16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
}


def _buckets(max_value: int, start: int, step: int = 2) -> List[int]:
    """Geometric buckets (x`step`) from `start` up to (and including)
    max_value."""
    out = []
    b = start
    while b < max_value:
        out.append(b)
        b *= step
    out.append(max_value)
    return out


def _pad_to_bucket(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


class StepResult(NamedTuple):
    """Host-side (numpy) results for the scheduled rows of one execute,
    each with a leading step axis: [num_steps, num_rows, ...]."""

    sampled: np.ndarray  # i32[steps, num_rows]
    sampled_logprob: np.ndarray  # f32[steps, num_rows]
    sampled_rank: np.ndarray  # i32[steps, num_rows]
    topk_ids: np.ndarray  # i32[steps, num_rows, K]
    topk_logprobs: np.ndarray  # f32[steps, num_rows, K]
    # Prompt logprobs over the flat token stream (single-step prefill
    # only): (target_lp[T], rank[T], topk_ids[T, K], topk_lp[T, K]).
    prompt: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                           np.ndarray]] = None


def _upload(arrays: List[np.ndarray], device: torch.device
            ) -> List[torch.Tensor]:
    """Copy int32 host arrays to the device in one transfer."""
    flat = np.concatenate([a.reshape(-1) for a in arrays]).astype(np.int32)
    dev = torch.from_numpy(flat).to(device)
    out, off = [], 0
    for a in arrays:
        out.append(dev[off:off + a.size].view(a.shape))
        off += a.size
    return out


def _pack_step_outputs(outs: List[SamplerOutput]) -> torch.Tensor:
    """Every per-step output of a window in ONE int32 device buffer
    (floats bitcast), so the host fetches one array per window."""
    def i32(x):
        return x.contiguous().view(torch.int32)

    parts = [torch.stack([o.sampled for o in outs]).reshape(-1),
             torch.stack([o.sampled_rank for o in outs]).reshape(-1),
             i32(torch.stack([o.sampled_logprob for o in outs])).reshape(-1)]
    if outs[0].topk_ids.shape[-1]:
        parts.append(torch.stack([o.topk_ids for o in outs]).reshape(-1))
        parts.append(
            i32(torch.stack([o.topk_logprobs for o in outs])).reshape(-1))
    return torch.cat(parts)


def _unpack_step_outputs(raw: np.ndarray, W: int, S: int, K: int, n: int):
    """Split a packed window buffer back into StepResult's order (sampled,
    logprob, rank, topk_ids, topk_logprobs), each sliced to the n live
    rows."""
    ws = W * S
    sampled = raw[:ws].reshape(W, S)[:, :n]
    rank = raw[ws:2 * ws].reshape(W, S)[:, :n]
    lp = raw[2 * ws:3 * ws].view(np.float32).reshape(W, S)[:, :n]
    if K:
        wsk = ws * K
        topk_ids = raw[3 * ws:3 * ws + wsk].reshape(W, S, K)[:, :n]
        topk_lp = raw[3 * ws + wsk:3 * ws + 2 * wsk].view(
            np.float32).reshape(W, S, K)[:, :n]
    else:
        topk_ids = np.zeros((W, n, 0), np.int32)
        topk_lp = np.zeros((W, n, 0), np.float32)
    return sampled, lp, rank, topk_ids, topk_lp


class WindowBuffers:
    """The static inputs of the decode windows of one sequence bucket S,
    on the runner's device. Every window of S reads them in place, so a
    captured graph, which keeps the addresses it was captured with, sees
    what the host copied in before its replay.

    carry: i32[2S + 1] [token_ids | positions | step_offset], advanced in
    place by every window; sched: i32[S * pps + S + 1] [page table | KV
    capacity | num_seqs], copied in once per engine step; rows: i32[S + 1]
    arange, made once; tensors: the sampling tensors, made from the first
    tensors copied in."""

    def __init__(self, S: int, pages_per_seq: int,
                 device: torch.device) -> None:
        self.S = S
        self.carry = torch.zeros((2 * S + 1,), dtype=torch.int32,
                                 device=device)
        self.sched = torch.zeros((S * pages_per_seq + S + 1,),
                                 dtype=torch.int32, device=device)
        # arange(S + 1): the rows' indices, and the cu_q_lens of one token
        # a row that a head_dim the decode kernel lacks is attended over.
        self.rows = torch.arange(S + 1, dtype=torch.int32, device=device)
        self.tensors: Optional[SamplingTensors] = None
        # The device tensors last copied into ``tensors``.
        self.tensors_src: Optional[SamplingTensors] = None
        # Fingerprint of what ``carry`` holds once every window enqueued
        # on it has run (None: unknown).
        self.carry_fp = None


class WindowFetch:
    """One window's packed outputs on their way to the host: on a card a
    pinned buffer that a copy enqueued behind the window fills, and the
    event recorded after that copy; on the CPU the outputs themselves.
    The device outputs are held until the host has read the copy, so
    their memory is not reused before the copy has run."""

    def __init__(self, packed: torch.Tensor) -> None:
        self.packed = packed
        if packed.is_cuda:
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = packed, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
            self.packed = None
        return self.host.numpy()


class _WindowGraph:
    """The CUDA graph of one window key and what it did."""

    def __init__(self) -> None:
        self.graph = None
        self.packed: Optional[torch.Tensor] = None  # the graph's output
        self.warmups = 0
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.pool_bytes = 0


def _upload_into(dst: torch.Tensor, host: np.ndarray) -> None:
    """Copy an int32 host array into a device buffer. On a card the source
    is pinned first, so the copy is queued behind the work already on the
    stream and the host does not wait for it."""
    src = torch.from_numpy(host)
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class ModelRunner:
    """Owns device state and executes scheduler outputs."""

    # Decode steps per packed host fetch.
    MULTI_STEP_WINDOW = 32
    # Rows of the token stream per pass of the prompt logprobs: the f32
    # logits of a chunk are ROWS x vocabulary.
    PROMPT_LOGPROB_ROWS = 256
    # The prompt logprobs' top-k cap (the JAX runner's).
    MAX_PROMPT_LOGPROBS = 32

    def __init__(self, engine_config: EngineConfig) -> None:
        self.config = engine_config
        self.model_config = engine_config.model_config
        self.cache_config = engine_config.cache_config
        self.scheduler_config = engine_config.scheduler_config
        self.device = torch.device(engine_config.device_config.device)
        self.model = get_model_class(self.model_config)(self.model_config,
                                                        self.device)
        self.params: Optional[Dict[str, Any]] = None
        self.kv_cache: Optional[torch.Tensor] = None
        # Encoder-decoder models: the cross cache, which the encoder pass
        # writes once per sequence and decoder steps only read; decoder
        # pages never hold content another request could share.
        self.is_encdec = getattr(self.model, "is_encoder_decoder", False)
        self.cross_kv: Optional[torch.Tensor] = None
        if self.is_encdec:
            self.cache_config.enable_prefix_caching = False
        # Encoder passes run and the tokens they encoded (padding left out).
        self.encoder_passes = 0
        self.encoder_tokens = 0
        self.num_pages: Optional[int] = None
        self.block_size = self.cache_config.block_size
        self.pages_per_seq = cdiv(self.model_config.max_model_len,
                                  self.block_size)
        # Token buckets grow x2 (prefill padding is real work); sequence
        # buckets x4 (padded decode rows are cheap).
        self.token_buckets = _buckets(
            max(16, self.scheduler_config.max_num_batched_tokens), 16,
            step=2)
        self.seq_buckets = _buckets(
            max(8, self.scheduler_config.max_num_seqs), 8, step=4)
        # Token-history widths of the history stages.
        self.history_buckets = _buckets(
            max(128, self.model_config.max_model_len), 128)
        self.kv_dtype = (_KV_DTYPES[self.cache_config.cache_dtype]
                         or self.model.dtype)
        # Per-layer (k_scale[L], v_scale[L]) on the device, only for the
        # narrow cache types.
        self.kv_scales = None
        if self.kv_dtype.itemsize == 1:
            self.kv_scales = kv_scales_from_jax(
                load_kv_cache_scales(
                    self.model_config.model, self.model.num_layers,
                    self.cache_config.quantization_param_path), self.device)
        # The decode windows' static buffers by S, their graphs by key
        # (S, W, flags, pages_per_seq), the pool the graphs share and the
        # stream they are warmed up and captured on.
        self._window_buffers: Dict[int, WindowBuffers] = {}
        self._graphs: Dict[Tuple, _WindowGraph] = {}
        self._graph_pool = None
        self._capture_stream = None
        # The next step's first window, dispatched ahead (window chaining).
        self._pending_window: Optional[Dict[str, Any]] = None
        self._sampling_cache = None
        self.chained_window_hits = 0
        self.carry_hits = 0
        self.sampling_cache_hits = 0
        # Forwards run eagerly (prefill and mixed steps, and decode windows
        # run as a function: every window on the CPU, a key's warm-up on a
        # card), by their token count. A graph's replays are counted by key
        # in ``graph_stats``.
        self.eager_forwards_by_tokens: Dict[int, int] = {}

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------

    def load_model(self) -> None:
        t0 = time.monotonic()
        self.params = load_model_params(self.model, self.model_config,
                                        self.config.load_config, self.device)
        self.params = self.model.fuse_projections(self.params)
        logger.info("model loaded in %.1fs", time.monotonic() - t0)

    def _kv_page_bytes(self) -> int:
        """The bytes of one page in every layer: of the self cache, and of
        the cross cache beside it for an encoder-decoder model."""
        ckv, d = self.model.kv_cache_shape_suffix
        total = (self.model.num_layers * self.block_size * ckv * d
                 * self.kv_dtype.itemsize)
        if self.is_encdec:
            cckv, cd = self.model.cross_kv_cache_shape_suffix
            total += (self.model.num_layers * self.block_size * cckv * cd
                      * self.kv_dtype.itemsize)
        return total

    def determine_num_pages(self) -> int:
        """Size the KV cache from the card's free memory."""
        if self.cache_config.num_device_blocks_override is not None:
            return self.cache_config.num_device_blocks_override
        if self.device.type != "cuda":
            return max(
                512,
                cdiv(self.scheduler_config.max_model_len, self.block_size) *
                self.scheduler_config.max_num_seqs // 4)
        free, total = torch.cuda.mem_get_info(self.device)
        budget = int(total * self.cache_config.hbm_utilization) - (total -
                                                                   free)
        # Activation headroom for the largest token bucket: a rough bound
        # (hidden, fused qkv and gate|up activations, f32 logits).
        act_headroom = (self.token_buckets[-1] *
                        self.model_config.get_hidden_size() * 2 * 64)
        # And for a chunk of the prompt logprobs: its f32 logits, their
        # log-softmax and the top-k's temporaries.
        act_headroom += (self.PROMPT_LOGPROB_ROWS *
                         self.model_config.get_vocab_size() * 4 * 4)
        # And what an MoE layer's grouped product needs.
        act_headroom += self.model.mlp_workspace_bytes(
            self.token_buckets[-1], self.seq_buckets[-1])
        budget -= act_headroom
        page_bytes = self._kv_page_bytes()
        num = max(budget // page_bytes, 16)
        logger.info("KV cache: %d pages x %d tokens (%.2f GiB)", num,
                    self.block_size, num * page_bytes / (1 << 30))
        return int(num)

    def initialize_cache(self, num_pages: Optional[int] = None) -> None:
        if num_pages is None:
            num_pages = self.determine_num_pages()
        self.num_pages = num_pages
        self.cache_config.num_device_blocks = num_pages
        ckv, d = self.model.kv_cache_shape_suffix
        self.kv_cache = torch.zeros(
            (self.model.num_layers, num_pages + 1, self.block_size, ckv, d),
            dtype=self.kv_dtype, device=self.device)
        if self.is_encdec:
            cckv, cd = self.model.cross_kv_cache_shape_suffix
            self.cross_kv = torch.zeros(
                (self.model.num_layers, num_pages + 1, self.block_size, cckv,
                 cd), dtype=self.kv_dtype, device=self.device)

    @property
    def trash_slot_base(self) -> int:
        """Flat slot of the reserved trash page (padding writes land here)."""
        return self.num_pages * self.block_size

    # ------------------------------------------------------------------
    # Batch assembly (host)
    # ------------------------------------------------------------------

    def _run_encoder(self, ss: ScheduledSequence) -> None:
        """One encoder pass for a sequence entering its first prefill
        chunk: the encoder over its encoder prompt, padded to the history
        bucket of its length, then every decoder layer's cross K/V written
        into its cross pages (the padding rows at the trash page's slots).
        The pages are written once; decoder steps only read them."""
        enc_ids = ss.seq.encoder_token_ids
        E = len(enc_ids)
        Ep = _pad_to_bucket(E, self.history_buckets)
        bs = self.block_size
        tokens = np.zeros((Ep,), np.int32)
        tokens[:E] = enc_ids
        positions = np.arange(Ep, dtype=np.int32)
        positions[E:] = 0
        table = np.asarray(ss.cross_block_ids, np.int32)
        slots = self.trash_slot_base + np.arange(Ep, dtype=np.int32) % bs
        pos = np.arange(E)
        slots[:E] = table[pos // bs] * bs + pos % bs
        tokens_d, positions_d, slots_d = _upload([tokens, positions, slots],
                                                 self.device)
        self.model.encode_and_write_cross(self.params, self.cross_kv,
                                          tokens_d, positions_d, slots_d, E)
        self.encoder_passes += 1
        self.encoder_tokens += E

    def build_forward_batch(
        self,
        scheduled: List[ScheduledSequence],
        padded_tokens: int,
        padded_seqs: int,
    ) -> ForwardBatch:
        T, S = padded_tokens, padded_seqs
        token_ids = np.zeros((T,), np.int32)
        positions = np.zeros((T,), np.int32)
        slot_mapping = np.full((T,), self.trash_slot_base, np.int32)
        kv_lens = np.zeros((S,), np.int32)
        page_indices = np.zeros((S, self.pages_per_seq), np.int32)
        cu_q_lens = np.zeros((S + 1,), np.int32)
        logits_indices = np.zeros((S,), np.int32)
        cross = []
        if self.is_encdec:
            # The cross table's width is bucketed on the batch's longest
            # encoder prompt: the cross read gathers that many pages a row.
            max_enc = max(len(ss.seq.encoder_token_ids or [1])
                          for ss in scheduled)
            width = cdiv(_pad_to_bucket(max_enc, self.history_buckets),
                         self.block_size)
            cross_pages = np.zeros((S, width), np.int32)
            cross_lens = np.zeros((S,), np.int32)
            for i, ss in enumerate(scheduled):
                table = ss.cross_block_ids or []
                cross_pages[i, :len(table)] = table
                cross_lens[i] = len(ss.seq.encoder_token_ids or [])
            cross = [cross_pages, cross_lens]
        offset = 0
        bs = self.block_size
        for i, ss in enumerate(scheduled):
            seq = ss.seq
            first = ss.first_token_idx
            n = ss.num_tokens
            token_ids[offset:offset + n] = seq.get_token_ids()[first:first + n]
            pos = np.arange(first, first + n)
            positions[offset:offset + n] = pos
            table = np.asarray(ss.block_ids, np.int32)
            slot_mapping[offset:offset + n] = table[pos // bs] * bs + pos % bs
            kv_lens[i] = first + n
            page_indices[i, :len(table)] = table
            cu_q_lens[i + 1] = cu_q_lens[i] + n
            offset += n
            logits_indices[i] = offset - 1
        # Padding rows repeat the last cumulative value.
        cu_q_lens[len(scheduled) + 1:] = cu_q_lens[len(scheduled)]
        # Spread padding tokens over the trash page's slots.
        num_pad = T - offset
        if num_pad > 0:
            slot_mapping[offset:] = (self.trash_slot_base +
                                     np.arange(num_pad) % bs)
        num_seqs = np.asarray([len(scheduled)], np.int32)
        return ForwardBatch(*_upload(
            [token_ids, positions, slot_mapping, kv_lens, page_indices,
             cu_q_lens, num_seqs, logits_indices, *cross], self.device))

    def _sampling_inputs(self, scheduled: List[ScheduledSequence], S: int):
        """The step's sampling tensors on the device, its flags, and (for
        the history stages) the token histories, their lengths and the
        prompt lengths on the device, at the bucket of the longest row.

        Sampling-tensor cache: all-greedy batches with an unchanged row
        set reuse the previous step's device tensors, built and uploaded
        nothing (stochastic rows rebuild every step, as their keys fold
        the step in, as do the history- and min_tokens-dependent flags)."""
        greedy_ok = all(ss.group.sampling_params.temperature == 0.0
                        for ss in scheduled)
        fp = ((S, tuple((ss.seq.seq_id, id(ss.group.sampling_params),
                         ss.seq.seed_offset) for ss in scheduled))
              if greedy_ok else None)
        cached = self._sampling_cache
        if fp is not None and cached is not None and cached[0] == fp:
            self.sampling_cache_hits += 1
            return cached[1]
        rows = []
        for ss in scheduled:
            sp = ss.group.sampling_params
            seq = ss.seq
            rows.append(SamplerInputRow(
                params=sp,
                token_ids=seq.get_token_ids(),
                prompt_len=seq.get_prompt_len(),
                generated_len=seq.get_output_len(),
                seed=(_offset_seed(sp.seed, seq) if sp.seed is not None
                      else _default_seed(ss.group.request_id, seq.seq_id)),
                eos_token_id=seq.eos_token_id,
            ))
        max_hist = max((len(r.token_ids) for r in rows), default=1)
        H = _pad_to_bucket(max_hist, self.history_buckets)
        tensors, flags, history, hl = build_sampling_tensors(
            rows, S, self.model_config.get_vocab_size(), history_pad=H)
        hist = None
        if flags.needs_history:
            hist = tuple(_upload([history, hl[0], hl[1]], self.device))
        result = (tensors_to_device(tensors, self.device), flags, hist)
        if (fp is not None and not flags.needs_history
                and not flags.do_min_tokens and not flags.do_beam):
            # Keep the sampling-params objects alive so id() stays
            # unique for the cache's lifetime.
            self._sampling_cache = (
                fp, result, [ss.group.sampling_params for ss in scheduled])
        else:
            self._sampling_cache = None
        return result

    def _guided_mask(self, scheduled: List[ScheduledSequence],
                     S: int) -> torch.Tensor:
        """The rows' packed allow-masks [S, ceil(V/32)] on the device (the
        uint32 words as int32), from each sampled row's FSM state; a row at
        a dead end may emit EOS only, so that its request ends."""
        words = (self.model_config.get_vocab_size() + 31) // 32
        gm = np.full((S, words), 0xFFFFFFFF, dtype=np.uint32)
        for i, ss in enumerate(scheduled):
            seq = ss.seq
            if seq.fsm is None or not ss.do_sample:
                continue
            m = seq.fsm.allowed_mask(seq.fsm_state)
            if not m.any() and seq.eos_token_id is not None:
                m = m.copy()
                e = seq.eos_token_id
                m[e >> 5] |= np.uint32(1 << (e & 31))
            gm[i, :len(m)] = m
        return torch.from_numpy(gm.view(np.int32)).to(self.device)

    @staticmethod
    def _apply_logits_processors(
            logits: np.ndarray,
            scheduled: List[ScheduledSequence]) -> np.ndarray:
        """Apply each request's host callables to its raw logits row: a
        2-argument processor gets ``(output_token_ids, logits_row)``, a
        3-argument one ``(prompt_token_ids, output_token_ids,
        logits_row)``; rows are numpy float32, and a processor may return
        any array-like of the same shape."""
        for i, ss in enumerate(scheduled):
            lps = ss.group.sampling_params.logits_processors
            if not lps or not ss.do_sample:
                continue
            seq = ss.seq
            ids = seq.get_token_ids()
            plen = seq.get_prompt_len()
            prompt_ids, out_ids = list(ids[:plen]), list(ids[plen:])
            row = logits[i]
            try:
                for proc in lps:
                    try:
                        nargs = len(inspect.signature(proc).parameters)
                    except (ValueError, TypeError):
                        nargs = 2
                    row = (proc(prompt_ids, out_ids, row) if nargs >= 3
                           else proc(out_ids, row))
                row = np.asarray(row, dtype=logits.dtype)
                if row.shape != logits[i].shape:
                    raise ValueError(
                        f"processor returned shape {row.shape}, "
                        f"expected {logits[i].shape}")
                logits[i] = row
            except Exception as e:
                raise ValueError(
                    "logits processor failed for request "
                    f"{ss.group.request_id!r}: {e}") from e
        return logits

    def _prompt_targets(self, scheduled: List[ScheduledSequence],
                        T: int) -> np.ndarray:
        """The token that follows each token of the flat stream (0 past a
        sequence's end)."""
        tgt = np.zeros((T,), np.int32)
        off = 0
        for ss in scheduled:
            ids = ss.seq.get_token_ids()
            for j in range(ss.num_tokens):
                p = ss.first_token_idx + j + 1
                tgt[off + j] = ids[p] if p < len(ids) else 0
            off += ss.num_tokens
        return tgt

    def _prompt_logprobs(self, hidden: torch.Tensor, targets: np.ndarray,
                         k: int) -> Tuple[np.ndarray, ...]:
        """The prompt logprobs of every token of the stream that has a
        target: the target's logprob and rank and the top-k, over the LM
        head's logits of PROMPT_LOGPROB_ROWS tokens at a time."""
        tgt = torch.from_numpy(targets).to(self.device)
        parts = []
        for start in range(0, len(targets), self.PROMPT_LOGPROB_ROWS):
            end = min(start + self.PROMPT_LOGPROB_ROWS, len(targets))
            logits = self.model.compute_logits(self.params,
                                               hidden[start:end])
            parts.append(prompt_logprobs(logits, tgt[start:end], k))
        return tuple(torch.cat([p[i] for p in parts]).cpu().numpy()
                     for i in range(4))

    # ------------------------------------------------------------------
    # Execute
    # ------------------------------------------------------------------

    def _apply_block_copies(self, pairs) -> None:
        """Copy-on-write block copies, in every layer of the cache."""
        src = torch.tensor([p[0] for p in pairs], device=self.device)
        dst = torch.tensor([p[1] for p in pairs], device=self.device)
        # Pages are copied as bytes, whatever the cache's element type.
        raw = self.kv_cache.view(torch.uint8)
        raw[:, dst] = raw[:, src]

    @torch.inference_mode()
    def execute(self, outputs: SchedulerOutputs,
                num_steps: int = 1) -> StepResult:
        scheduled = outputs.scheduled
        if not scheduled:
            raise ValueError("execute() called with an empty schedule")
        if outputs.blocks_to_copy:
            self._apply_block_copies(outputs.blocks_to_copy)
        if self.is_encdec:
            for ss in scheduled:
                if ss.first_token_idx == 0 and ss.seq.encoder_token_ids:
                    self._run_encoder(ss)
        S = _pad_to_bucket(len(scheduled), self.seq_buckets)
        tensors, flags, hist = self._sampling_inputs(scheduled, S)
        guided_mask = None
        if any(ss.seq.fsm is not None for ss in scheduled):
            flags = flags._replace(do_guided=True)
            guided_mask = self._guided_mask(scheduled, S)
        # Host logits processors need the raw logits on the host each step.
        has_procs = any(ss.group.sampling_params.logits_processors
                        for ss in scheduled)
        # The fused window: a pure-decode batch of a decoder-only model
        # whose sampling reads no per-step host state (token history,
        # min_tokens, guided FSM advancement, host callables).
        if (num_steps > 1 and outputs.num_prefill_tokens == 0
                and not self.is_encdec
                and not flags.needs_history and not flags.do_min_tokens
                and not flags.do_beam and not flags.do_guided
                and not has_procs):
            return self._execute_multi(scheduled, S, tensors, flags,
                                       num_steps)
        total_tokens = sum(ss.num_tokens for ss in scheduled)
        if self.is_encdec and outputs.num_prefill_tokens == 0:
            # A pure-decode step of an encoder-decoder model, one token a
            # row: marked as such (cu_q_lens=None), as the window marks
            # its steps, so that self-attention takes the decode kernel
            # (T5's with its bias).
            T = S
            batch = self.build_forward_batch(scheduled, T, S)._replace(
                cu_q_lens=None)
        else:
            T = _pad_to_bucket(total_tokens, self.token_buckets)
            batch = self.build_forward_batch(scheduled, T, S)
        self._count_forwards(T, 1)
        cross = {"cross_kv": self.cross_kv} if self.is_encdec else {}
        hidden = self.model.forward(self.params, self.kv_cache, batch,
                                    self.kv_scales, **cross)
        logits = self.model.compute_logits(
            self.params, hidden[batch.logits_indices])
        if has_procs:
            edited = self._apply_logits_processors(
                logits.float().cpu().numpy().copy(), scheduled)
            logits = torch.from_numpy(edited).to(self.device)
        out = sample(logits, tensors, flags, *(hist or (None,) * 3),
                     guided_mask=guided_mask)
        # Prompt logprobs: a prefill chunk of a request that asks for them
        # adds the pass over the whole token stream.
        max_plp = 0
        for ss in scheduled:
            plp = ss.group.sampling_params.prompt_logprobs
            if plp is not None and ss.seq.is_prefill:
                max_plp = max(max_plp,
                              min(int(plp) or 1, self.MAX_PROMPT_LOGPROBS))
        prompt = None
        if max_plp:
            prompt = self._prompt_logprobs(
                hidden, self._prompt_targets(scheduled, total_tokens),
                max_plp)
        n = len(scheduled)
        packed = _pack_step_outputs([out]).cpu().numpy()
        return StepResult(*_unpack_step_outputs(packed, 1, S,
                                                flags.max_logprobs, n),
                          prompt=prompt)

    def _count_forwards(self, tokens: int, n: int) -> None:
        self.eager_forwards_by_tokens[tokens] = (
            self.eager_forwards_by_tokens.get(tokens, 0) + n)

    # ------------------------------------------------------------------
    # The fused decode window
    # ------------------------------------------------------------------

    def window_buffers(self, S: int) -> WindowBuffers:
        """The static buffers of the decode windows of bucket S."""
        buf = self._window_buffers.get(S)
        if buf is None:
            with torch.inference_mode():
                buf = WindowBuffers(S, self.pages_per_seq, self.device)
            self._window_buffers[S] = buf
        return buf

    @torch.inference_mode()
    def load_window_tensors(self, buf: WindowBuffers,
                            tensors: SamplingTensors) -> bool:
        """Copy device sampling tensors into the buffers' static ones,
        unless they are the ones copied last; True if they were copied."""
        if buf.tensors_src is tensors:
            return False
        if buf.tensors is None:
            buf.tensors = SamplingTensors(*(t.clone() for t in tensors))
        else:
            for dst, src in zip(buf.tensors, tensors):
                dst.copy_(src)
        buf.tensors_src = tensors
        return True

    @torch.inference_mode()
    def decode_window(self, buf: WindowBuffers, flags: SamplingFlags,
                      W: int) -> torch.Tensor:
        """W decode steps of the rows in ``buf``, the counterpart of the JAX
        package's ``multi_step``: each advances tokens, positions and slots
        on the device, routes attention through ``cu_q_lens=None`` to the
        decode kernel and samples. The carry is advanced in place; the
        result is every step's outputs packed into one int32 buffer
        (``_pack_step_outputs``). No host value of the batch is read, so
        the function can be captured: the page table, capacity and row
        count come from ``buf.sched``."""
        S, pps, bs = buf.S, self.pages_per_seq, self.block_size
        carry, sched = buf.carry, buf.sched
        page_indices = sched[:S * pps].view(S, pps)
        kv_capacity = sched[S * pps:S * pps + S]
        num_seqs = sched[S * pps + S:]
        rows = buf.rows[:S]
        valid = rows < num_seqs
        trash = self.trash_slot_base + rows % bs
        token_ids, positions = carry[:S], carry[S:2 * S]
        # The steps the carry has run since the tensors' keys were built.
        step_offset = carry[2 * S:]
        outs = []
        for i in range(W):
            pos = positions.clamp(min=0)
            page = page_indices.gather(
                1, (pos // bs).clamp(max=pps - 1)[:, None].long())[:, 0]
            slot = torch.where(valid & (pos < kv_capacity),
                               page * bs + pos % bs, trash)
            batch = ForwardBatch(
                token_ids=token_ids,
                positions=pos,
                slot_mapping=slot,
                kv_lens=torch.where(valid, pos + 1, 0).int(),
                page_indices=page_indices,
                # None marks a pure-decode batch: attention goes to the
                # decode kernel (or, at a head_dim it lacks, to the ragged
                # one over decode_cu_q_lens).
                cu_q_lens=None,
                num_seqs=num_seqs,
                logits_indices=rows,
                decode_cu_q_lens=buf.rows,
            )
            hidden = self.model.forward(self.params, self.kv_cache, batch,
                                        self.kv_scales)
            logits = self.model.compute_logits(self.params, hidden)
            # Each row's key at the length this step samples.
            tensors = buf.tensors._replace(key_data=_fold_key_data(
                buf.tensors.key_data, step_offset + i))
            out = sample(logits, tensors, flags)
            outs.append(out)
            token_ids = out.sampled
            positions = positions + 1
        carry[:S].copy_(token_ids)
        carry[S:2 * S].copy_(positions)
        carry[2 * S:].add_(W)
        return _pack_step_outputs(outs)

    @torch.inference_mode()
    def run_window(self, buf: WindowBuffers, flags: SamplingFlags,
                   W: int) -> WindowFetch:
        """One decode window of ``buf``'s rows, its outputs on their way to
        the host. On the CPU ``decode_window`` runs. On a card the first
        window of a key (S, W, flags, pages_per_seq) runs it on the capture
        stream as warm-up, the second captures it into a CUDA graph and
        every window from there on is a replay of that graph; a capture
        that fails raises."""
        if self.device.type != "cuda":
            self._count_forwards(buf.S, W)
            return WindowFetch(self.decode_window(buf, flags, W))
        key = (buf.S, W, flags, self.pages_per_seq)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _WindowGraph()
            self._count_forwards(buf.S, W)
            stream = self._side_stream()
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                packed = self.decode_window(buf, flags, W)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            g.warmups += 1
            return WindowFetch(packed)
        if g.graph is None:
            self._capture(g, key, buf, flags, W)
        g.graph.replay()
        g.replays += 1
        return WindowFetch(g.packed)

    def _side_stream(self):
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        return self._capture_stream

    def _capture(self, g: _WindowGraph, key, buf: WindowBuffers,
                 flags: SamplingFlags, W: int) -> None:
        """Capture ``decode_window`` for ``key`` into ``g``. The wrappers
        count no launch while they are captured (``ops/launches.py``). A
        replay's noise comes from the rows' keys and the carry's step
        offset, which the replay reads from the buffers, so every replay
        draws fresh noise."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        # torch.cuda.graph empties the allocator's cache as it starts; done
        # here first, the growth of the reserved memory is the capture's.
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.monotonic()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  stream=self._side_stream()):
                g.packed = self.decode_window(buf, flags, W)
        except Exception as e:
            raise RuntimeError(
                f"capturing the decode window (S {key[0]}, W {key[1]}) "
                f"failed: {e}") from e
        g.graph = graph
        g.captures += 1
        g.capture_s = time.monotonic() - t0
        g.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        logger.info("captured the decode window (S %d, W %d) in %.2f s",
                    key[0], key[1], g.capture_s)

    def reset_graphs(self) -> None:
        """Drop every captured window and the window dispatched ahead: the
        next window of each key is warmed up and captured anew. For a
        caller that swaps a kernel or a route under the runner."""
        if self._graphs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._graphs.clear()
        self._graph_pool = None
        self._pending_window = None

    def invalidate_windows(self) -> None:
        """Forget what the runner knows of its window buffers' contents
        (each carry's fingerprint) and the window dispatched ahead: for a
        caller that writes into the buffers itself."""
        for buf in self._window_buffers.values():
            buf.carry_fp = None
        self._pending_window = None

    def has_window_graph(self, buf: WindowBuffers, flags: SamplingFlags,
                         W: int) -> bool:
        """Whether the window key of ``buf``, ``flags`` and W is captured."""
        g = self._graphs.get((buf.S, W, flags, self.pages_per_seq))
        return g is not None and g.graph is not None

    def window_keys(self) -> Dict[str, Tuple[int, int, SamplingFlags]]:
        """(S, W, flags) of each window key the runner has met, by its
        name: "S<S> W<W> greedy" (or "sampled", then " #2", " #3" for
        further flag sets of that kind)."""
        keys: Dict[str, Tuple[int, int, SamplingFlags]] = {}
        for S, W, flags, _ in self._graphs:
            base = (f"S{S} W{W} "
                    + ("greedy" if flags.all_greedy else "sampled"))
            name, k = base, 1
            while name in keys:
                k += 1
                name = f"{base} #{k}"
            keys[name] = (S, W, flags)
        return keys

    def graph_stats(self) -> Dict[str, Dict[str, Any]]:
        """For each window key, by its ``window_keys`` name: warm-ups,
        captures, capture seconds, replays and the device memory its
        capture reserved."""
        stats: Dict[str, Dict[str, Any]] = {}
        for name, (S, W, flags) in self.window_keys().items():
            g = self._graphs[(S, W, flags, self.pages_per_seq)]
            stats[name] = dict(warmups=g.warmups, captures=g.captures,
                               capture_s=g.capture_s, replays=g.replays,
                               pool_bytes=g.pool_bytes)
        return stats

    def _can_chain_window(self, scheduled, flags, done: int,
                          W: int) -> bool:
        """True when the next engine step will PROBABLY schedule this
        exact batch again (capacity already covers another window) and
        its sampling is history-free + chain-invariant (the speculative
        window reuses this step's device tensors).

        EOS / stop strings / stop tokens do NOT gate chaining: a seq
        finishing changes the next step's composition, the pending
        window's fingerprint misses, and it is dropped unfetched. Only a
        CERTAIN finish (the max_tokens boundary) makes the speculation
        pointless, so that stays a gate.

        The JAX package also refuses multi-host runs; the port runs on one
        host, so that clause is left out."""
        if not chain_windows_enabled():
            return False
        if (flags.do_penalties or flags.do_dry or flags.do_no_repeat_ngram
                or flags.do_min_tokens or flags.do_banned_tokens
                or flags.do_beam or flags.do_guided):
            return False
        for ss in scheduled:
            sp = ss.group.sampling_params
            seq = ss.seq
            if not sp.chain_speculation_eligible or seq.fsm is not None:
                return False
            # Certain finish: every seq hits max_tokens at a known step.
            if (sp.max_tokens is not None
                    and len(seq.output_token_ids) + done >= sp.max_tokens):
                return False
            # Enough allocated KV capacity for the extra window (the
            # scheduler has not been asked for the extra pages yet).
            capacity = len(ss.block_ids) * self.block_size
            if seq.num_computed_tokens + done + W > capacity:
                return False
        return True

    def _execute_multi(self, scheduled: List[ScheduledSequence], S: int,
                       tensors: SamplingTensors, flags: SamplingFlags,
                       num_steps: int) -> StepResult:
        """num_steps decode steps of the same rows in windows of W, with
        one upload of the step metadata and one fetch per window."""
        pps, bs, n = self.pages_per_seq, self.block_size, len(scheduled)
        buf = self.window_buffers(S)
        sched = np.zeros((S * pps + S + 1,), np.int32)
        page_indices = sched[:S * pps].reshape(S, pps)
        for i, ss in enumerate(scheduled):
            page_indices[i, :len(ss.block_ids)] = ss.block_ids
            sched[S * pps + i] = len(ss.block_ids) * bs
        sched[S * pps + S] = n
        _upload_into(buf.sched, sched)
        fresh = self.load_window_tensors(buf, tensors)

        W = min(num_steps, self.MULTI_STEP_WINDOW)
        num_windows = cdiv(num_steps, W)
        fetches = []
        fp = (S, tuple((ss.seq.seq_id, ss.seq.num_computed_tokens)
                       for ss in scheduled))

        # Cross-step pipelining: if the previous engine step dispatched a
        # window whose predicted composition matches this schedule
        # exactly, it IS this step's first window; the device computed it
        # while the host fetched, appended and scheduled. A missed
        # prediction is dropped unfetched: its KV writes are either
        # identical to what the real windows recompute (same positions;
        # every decode step rewrites its own slot before attending) or
        # land past kv_len / in non-hashed partial pages, so they are
        # invisible.
        pending, self._pending_window = self._pending_window, None
        chained = (pending is not None and pending["fp"] == fp
                   and pending["flags"] == flags and pending["W"] == W)
        if chained:
            fetches.append(pending["fetch"])
            self.chained_window_hits += 1

        # Device-resident decode carry: buf.carry_fp is what the carry will
        # hold once the windows enqueued on it have run. After a chained
        # window that is this step's state one window on, which the taken
        # window accounts for; otherwise it must be this step's state, and
        # nothing is uploaded. Any composition change (a finish, a join, a
        # preemption, a chained window not taken, an eager step of these
        # rows) misses and rebuilds the carry from host truth, its step
        # offset 0. Tensors built this step have keys at this step's
        # lengths: on a carry that hits, the offset is set to the steps the
        # carry runs ahead of them (the chained window's).
        if chained or buf.carry_fp == fp:
            self.carry_hits += 1
            if fresh:
                _upload_into(buf.carry[2 * S:],
                             np.asarray([W if chained else 0], np.int32))
        else:
            carry = np.zeros((2 * S + 1,), np.int32)
            for i, ss in enumerate(scheduled):
                carry[i] = ss.seq.get_last_token_id()
                carry[S + i] = ss.seq.num_computed_tokens
            _upload_into(buf.carry, carry)

        for _ in range(num_windows - len(fetches)):
            fetches.append(self.run_window(buf, flags, W))
        done = num_windows * W
        fp_done = (S, tuple(
            (ss.seq.seq_id, ss.seq.num_computed_tokens + done)
            for ss in scheduled))
        buf.carry_fp = fp_done

        if self._can_chain_window(scheduled, flags, done, W):
            # Dispatch the next engine step's first window now, before
            # this step's outputs are fetched. Composition is predicted to
            # be unchanged; the fingerprint check above validates it next
            # call.
            self._pending_window = dict(
                fp=fp_done, flags=flags, W=W,
                fetch=self.run_window(buf, flags, W))
            buf.carry_fp = (S, tuple(
                (ss.seq.seq_id, ss.seq.num_computed_tokens + done + W)
                for ss in scheduled))

        K = flags.max_logprobs
        unpacked = [_unpack_step_outputs(f.numpy(), W, S, K, n)
                    for f in fetches]
        return StepResult(*(
            np.concatenate([u[i] for u in unpacked], axis=0)[:num_steps]
            for i in range(5)))

def _fold_key_data(key_data: torch.Tensor, steps) -> torch.Tensor:
    """Each row's key `steps` (an int, or a tensor on the device) tokens
    on: the host mixes the generated length into the second word
    (metadata.py ``_mix32(seed, generated_len + 1)``, whose last round XORs
    the first word with a sum that grows with the length), so adding
    `steps` to that sum gives the key the host would build that many steps
    later. A step of a window therefore draws what a single step at its
    length draws. (The JAX package XORs a hash of the window step into the
    word, which gives a window other streams than single steps.)"""
    if isinstance(steps, torch.Tensor):
        steps = steps.long()
    k0 = key_data[:, 0]
    k1 = k0 ^ (((key_data[:, 1] ^ k0) + steps) & 0xFFFFFFFF)
    return torch.stack([k0, k1], dim=1)


def _default_seed(request_id: str, seq_id: int) -> int:
    """A sequence's seed when its request sets none (the JAX runner's: a
    hash of the request and sequence, which Python salts per process)."""
    return (hash((request_id, seq_id)) ^ 0xA5A5A5) & 0x7FFFFFFF


def _offset_seed(seed: int, seq) -> int:
    """A seeded request's seed for one of its sequences: sequence 0 keeps
    the request's seed, its siblings (n > 1) draw other streams."""
    off = getattr(seq, "seed_offset", 0)
    return seed if not off else (hash((seed, off)) & 0x7FFFFFFF)
