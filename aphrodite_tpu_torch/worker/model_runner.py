"""Model runner: scheduler outputs -> device work (counterpart of
aphrodite_tpu/worker/model_runner.py for the offline dense path).

The runner owns the parameters, the paged KV cache
[L, num_pages + 1, page_size, 2*KV, D] (the last page of every layer is
the trash page that padding tokens write to; its element type is the
model's, or with ``kv_cache_dtype`` an 8-bit one written through
per-layer scales) and a ``torch.Generator`` for sampling. Prefill and
mixed steps run one forward over the flat token stream; pure-decode
steps run the multi-step window: a Python loop over steps that advances
tokens, positions and slots on the device, routes attention through
``cu_q_lens=None`` to the decode kernel, and brings each window's
results to the host in one packed fetch.

Token and sequence counts are padded to the JAX package's buckets, so
the shapes stay few and fixed, ready for CUDA-graph capture.
"""

import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from aphrodite_tpu_torch.common.config import EngineConfig
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
from aphrodite_tpu_torch.sampling.sampler import (SamplerOutput, sample,
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
    """Split a packed window buffer back into (sampled, rank, logprob,
    topk_ids, topk_logprobs), each sliced to the n live rows."""
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
    return sampled, rank, lp, topk_ids, topk_lp


class ModelRunner:
    """Owns device state and executes scheduler outputs."""

    # Decode steps per packed host fetch.
    MULTI_STEP_WINDOW = 32

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
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.model_config.seed)

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
        ckv, d = self.model.kv_cache_shape_suffix
        return (self.model.num_layers * self.block_size * ckv * d
                * self.kv_dtype.itemsize)

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

    @property
    def trash_slot_base(self) -> int:
        """Flat slot of the reserved trash page (padding writes land here)."""
        return self.num_pages * self.block_size

    # ------------------------------------------------------------------
    # Batch assembly (host)
    # ------------------------------------------------------------------

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
             cu_q_lens, num_seqs, logits_indices], self.device))

    def _sampling_inputs(self, scheduled: List[ScheduledSequence], S: int):
        rows = []
        for ss in scheduled:
            sp = ss.group.sampling_params
            if sp.logits_processors:
                raise NotImplementedError(
                    "logits processors are not ported to the PyTorch "
                    "package yet")
            if sp.prompt_logprobs is not None:
                raise NotImplementedError(
                    "prompt logprobs are not ported to the PyTorch "
                    "package yet")
            rows.append(SamplerInputRow(
                params=sp,
                token_ids=ss.seq.get_token_ids(),
                prompt_len=ss.seq.get_prompt_len(),
                generated_len=ss.seq.get_output_len(),
                seed=sp.seed if sp.seed is not None else 0,
                eos_token_id=ss.seq.eos_token_id,
            ))
        tensors, flags, _, _ = build_sampling_tensors(
            rows, S, self.model_config.get_vocab_size())
        return tensors_to_device(tensors, self.device), flags

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
        S = _pad_to_bucket(len(scheduled), self.seq_buckets)
        tensors, flags = self._sampling_inputs(scheduled, S)
        if num_steps > 1 and outputs.num_prefill_tokens == 0:
            return self._execute_multi(scheduled, S, tensors, flags,
                                       num_steps)
        total_tokens = sum(ss.num_tokens for ss in scheduled)
        T = _pad_to_bucket(total_tokens, self.token_buckets)
        batch = self.build_forward_batch(scheduled, T, S)
        hidden = self.model.forward(self.params, self.kv_cache, batch,
                                    self.kv_scales)
        logits = self.model.compute_logits(
            self.params, hidden[batch.logits_indices])
        out = sample(logits, tensors, flags, self.generator)
        n = len(scheduled)
        packed = _pack_step_outputs([out]).cpu().numpy()
        return StepResult(*_unpack_step_outputs(packed, 1, S,
                                                flags.max_logprobs, n))

    def _execute_multi(self, scheduled: List[ScheduledSequence], S: int,
                       tensors: SamplingTensors, flags: SamplingFlags,
                       num_steps: int) -> StepResult:
        """Fused decode window: num_steps decode steps of the same rows,
        with one upload of the step metadata and one fetch per window."""
        pps, bs, n = self.pages_per_seq, self.block_size, len(scheduled)
        page_indices = np.zeros((S, pps), np.int32)
        kv_capacity = np.zeros((S,), np.int32)
        token_ids = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int32)
        for i, ss in enumerate(scheduled):
            page_indices[i, :len(ss.block_ids)] = ss.block_ids
            kv_capacity[i] = len(ss.block_ids) * bs
            token_ids[i] = ss.seq.get_last_token_id()
            positions[i] = ss.seq.num_computed_tokens
        page_indices, kv_capacity, token_ids, positions, num_seqs = _upload(
            [page_indices, kv_capacity, token_ids, positions,
             np.asarray([n], np.int32)], self.device)
        rows = torch.arange(S, dtype=torch.int32, device=self.device)
        valid = rows < n
        trash = self.trash_slot_base + rows % bs

        W = min(num_steps, self.MULTI_STEP_WINDOW)
        packed = []
        for _ in range(cdiv(num_steps, W)):
            outs = []
            for _ in range(W):
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
                    # None marks a pure-decode batch: attention goes to
                    # the decode kernel.
                    cu_q_lens=None,
                    num_seqs=num_seqs,
                    logits_indices=rows,
                )
                hidden = self.model.forward(self.params, self.kv_cache,
                                            batch, self.kv_scales)
                logits = self.model.compute_logits(self.params, hidden)
                out = sample(logits, tensors, flags, self.generator)
                outs.append(out)
                token_ids = out.sampled
                positions = positions + 1
            packed.append(_pack_step_outputs(outs))
        K = flags.max_logprobs
        unpacked = [_unpack_step_outputs(p.cpu().numpy(), W, S, K, n)
                    for p in packed]
        return StepResult(*(
            np.concatenate([u[i] for u in unpacked], axis=0)[:num_steps]
            for i in range(5)))
