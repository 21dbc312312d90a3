"""Paged KV-cache block manager with prefix caching.

A single-allocator re-design of the reference's two block-manager
generations (``aphrodite/processing/block_manager_v1.py:230``,
``block_manager_v2.py:23`` and the ``block/`` package): refcounted device
blocks, content-hash prefix caching with an LRU evictor
(``evictor_v2.py:70``), and copy-on-write for sequence forks.

TPU-specific simplifications:
- No CPU swap pool: preemption is always by recompute (the reference's
  default for single-sequence groups, scheduler.py:1327). Host<->HBM KV
  swap is rarely profitable on TPU and complicates the static-shape step.
- Blocks are plain integers indexing into mesh-sharded device arrays owned
  by the model runner; the manager is pure Python bookkeeping and fully
  unit-testable without a device.
"""

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.sequence import Sequence
from aphrodite_tpu_torch.common.utils import cdiv

logger = init_logger(__name__)


@dataclass
class Block:
    block_id: int
    ref_count: int = 0
    # Content hash of (all token ids up to and including this block); only
    # set for *full* blocks of prefix-cache-enabled sequences.
    content_hash: Optional[int] = None
    num_hashed_tokens: int = 0
    # True once the KV for this block has actually been written by a model
    # step (a cache hit is only valid on computed blocks).
    computed: bool = False
    last_accessed: float = 0.0


class LRUEvictor:
    """LRU eviction of unreferenced cached blocks, tie-broken by preferring
    to evict blocks carrying fewer hashed tokens (reference evictor_v2.py:70).
    """

    def __init__(self) -> None:
        self._blocks: Dict[int, Block] = {}
        self._heap: List[Tuple[float, int, int]] = []

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, block_id: int) -> bool:
        return block_id in self._blocks

    def add(self, block: Block) -> None:
        self._blocks[block.block_id] = block
        heapq.heappush(
            self._heap,
            (block.last_accessed, -block.num_hashed_tokens, block.block_id))

    def remove(self, block_id: int) -> Block:
        return self._blocks.pop(block_id)

    def evict(self) -> Block:
        while self._heap:
            _, _, block_id = heapq.heappop(self._heap)
            block = self._blocks.pop(block_id, None)
            if block is not None:
                return block
        raise ValueError("no blocks available to evict")


@dataclass
class CacheMetrics:
    """Prefix-cache hit accounting (reference block/common.py:287)."""

    queries: int = 0
    hits: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.queries if self.queries else 0.0


class BlockManager:
    """Allocates device KV blocks to sequences."""

    def __init__(
        self,
        block_size: int,
        num_blocks: int,
        enable_prefix_caching: bool = False,
    ) -> None:
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.enable_prefix_caching = enable_prefix_caching
        self._blocks: List[Block] = [Block(i) for i in range(num_blocks)]
        self._free_ids: List[int] = list(range(num_blocks))
        # content hash -> block id, for blocks currently holding that
        # content (referenced or parked in the evictor).
        self._cached: Dict[int, int] = {}
        self._evictor = LRUEvictor()
        self.block_tables: Dict[int, List[int]] = {}
        # Encoder-decoder CROSS-attention blocks (written once by the
        # encoder pass, read-only after; never hashed/prefix-cached).
        self.cross_block_tables: Dict[int, List[int]] = {}
        self.metrics = CacheMetrics()
        self._time = 0.0

    # ---- low-level allocation ----------------------------------------------

    def get_num_free_blocks(self) -> int:
        return len(self._free_ids) + len(self._evictor)

    def _tick(self) -> float:
        self._time += 1.0
        return self._time

    def _allocate_raw_block(self) -> Block:
        if self._free_ids:
            block = self._blocks[self._free_ids.pop()]
        elif len(self._evictor):
            block = self._evictor.evict()
            if block.content_hash is not None:
                self._cached.pop(block.content_hash, None)
        else:
            raise RuntimeError("out of KV cache blocks")
        block.ref_count = 1
        block.content_hash = None
        block.num_hashed_tokens = 0
        block.computed = False
        block.last_accessed = self._tick()
        return block

    def _free_block(self, block_id: int) -> None:
        block = self._blocks[block_id]
        assert block.ref_count > 0, f"double free of block {block_id}"
        block.ref_count -= 1
        if block.ref_count == 0:
            block.last_accessed = self._tick()
            if (self.enable_prefix_caching and block.content_hash is not None
                    and block.computed
                    and self._cached.get(block.content_hash) == block_id):
                # Park in the evictor: the content stays reusable until the
                # block is recycled.
                self._evictor.add(block)
            else:
                if block.content_hash is not None:
                    if self._cached.get(block.content_hash) == block_id:
                        self._cached.pop(block.content_hash)
                    block.content_hash = None
                self._free_ids.append(block_id)

    # ---- sequence-level interface -------------------------------------------

    def can_allocate(self, seq: Sequence, num_lookahead_slots: int = 0) -> bool:
        num_needed = cdiv(seq.get_len() + num_lookahead_slots,
                          self.block_size)
        if seq.encoder_token_ids and seq.seq_id not in \
                self.cross_block_tables:
            num_needed += cdiv(len(seq.encoder_token_ids),
                               self.block_size)
        if self.enable_prefix_caching:
            # Cached full blocks do not consume new capacity, but we check
            # conservatively against the worst case.
            pass
        return self.get_num_free_blocks() >= num_needed

    def allocate(self, seq: Sequence) -> int:
        """Build the block table for a WAITING sequence.

        Returns the number of *computed* prefix tokens served from the
        prefix cache (multiple of block_size, < len(prompt)).
        """
        assert seq.seq_id not in self.block_tables, (
            f"sequence {seq.seq_id} already allocated")
        num_tokens = seq.get_len()
        num_blocks = cdiv(num_tokens, self.block_size)
        num_full_blocks = num_tokens // self.block_size
        table: List[int] = []
        num_cached_tokens = 0
        hit_streak = True
        for logical_idx in range(num_blocks):
            is_full = logical_idx < num_full_blocks
            if self.enable_prefix_caching and is_full:
                content_hash = seq.hash_of_block(logical_idx)
                self.metrics.queries += 1
                cached_id = self._cached.get(content_hash) if hit_streak \
                    else None
                if cached_id is not None and self._blocks[cached_id].computed:
                    block = self._blocks[cached_id]
                    if cached_id in self._evictor:
                        self._evictor.remove(cached_id)
                    block.ref_count += 1
                    block.last_accessed = self._tick()
                    table.append(cached_id)
                    self.metrics.hits += 1
                    num_cached_tokens += self.block_size
                    continue
                hit_streak = False
                block = self._allocate_raw_block()
                block.content_hash = content_hash
                block.num_hashed_tokens = (logical_idx + 1) * self.block_size
                # Register now; marked computed after the step that fills it.
                self._cached[content_hash] = block.block_id
                table.append(block.block_id)
            else:
                hit_streak = False
                block = self._allocate_raw_block()
                table.append(block.block_id)
        self.block_tables[seq.seq_id] = table
        if seq.encoder_token_ids and seq.seq_id not in \
                self.cross_block_tables:
            n_cross = cdiv(len(seq.encoder_token_ids), self.block_size)
            self.cross_block_tables[seq.seq_id] = [
                self._allocate_raw_block().block_id
                for _ in range(n_cross)
            ]
        # Never report the *entire* prompt as cached: the last token must be
        # recomputed to produce logits (reference model_runner.py:518).
        if num_cached_tokens >= num_tokens:
            num_cached_tokens = max(0, num_tokens - 1)
            num_cached_tokens -= num_cached_tokens % self.block_size
        return num_cached_tokens

    def _shared_tail(self, seq: Sequence) -> List[int]:
        """Indices of the blocks that the sequence's next tokens (from its
        first uncomputed one) will be written into, or reserved ahead for,
        and that a fork shares."""
        table = self.block_tables[seq.seq_id]
        first = seq.num_computed_tokens // self.block_size
        return [i for i in range(first, len(table))
                if self._blocks[table[i]].ref_count > 1]

    def can_append_slots(self, seq: Sequence, num_slots: int = 1) -> bool:
        table = self.block_tables[seq.seq_id]
        capacity = len(table) * self.block_size
        needed = max(0, cdiv(seq.get_len() + num_slots - capacity,
                             self.block_size))
        needed += len(self._shared_tail(seq))
        return needed == 0 or self.get_num_free_blocks() >= needed

    def append_slots(self, seq: Sequence,
                     num_slots: int = 1) -> List[Tuple[int, int]]:
        """Grow the block table to hold `num_slots` more tokens.

        Returns copy-on-write directives [(src_block, dst_block)] that the
        runner must execute before writing new KV (only non-empty after a
        fork shared a partial block).

        Every block a fork shares from the one that holds the sequence's
        first uncomputed token to the end of the table becomes the
        sequence's own: the first is copied when it holds computed tokens,
        the ones after (slots reserved ahead for multi-step windows) are
        fresh. The JAX package's copy unshares only the table's last
        block: after a fork of a sequence that holds slots reserved ahead,
        the beams then write their tokens into the same shared slots.
        """
        table = self.block_tables[seq.seq_id]
        cow: List[Tuple[int, int]] = []
        first = seq.num_computed_tokens // self.block_size
        for i in self._shared_tail(seq):
            new_block = self._allocate_raw_block()
            if i == first and seq.num_computed_tokens % self.block_size:
                cow.append((table[i], new_block.block_id))
            self._free_block(table[i])
            table[i] = new_block.block_id
        needed_blocks = cdiv(seq.get_len() + num_slots, self.block_size)
        while len(table) < needed_blocks:
            block = self._allocate_raw_block()
            table.append(block.block_id)
        return cow

    def free(self, seq: Sequence) -> None:
        cross = self.cross_block_tables.pop(seq.seq_id, None)
        if cross is not None:
            for block_id in reversed(cross):
                self._free_block(block_id)
        table = self.block_tables.pop(seq.seq_id, None)
        if table is None:
            return
        for block_id in reversed(table):
            self._free_block(block_id)

    def fork(self, parent: Sequence, child: Sequence) -> None:
        """Share the parent's blocks with the child (copy-on-write happens
        lazily in append_slots)."""
        table = self.block_tables[parent.seq_id]
        for block_id in table:
            self._blocks[block_id].ref_count += 1
        self.block_tables[child.seq_id] = list(table)
        cross = self.cross_block_tables.get(parent.seq_id)
        if cross is not None:
            # Cross KV is read-only after the encoder pass: siblings
            # share it for their whole lifetime (no CoW needed).
            for block_id in cross:
                self._blocks[block_id].ref_count += 1
            self.cross_block_tables[child.seq_id] = list(cross)

    def get_block_table(self, seq: Sequence) -> List[int]:
        return self.block_tables[seq.seq_id]

    def get_cross_block_table(self, seq: Sequence) -> Optional[List[int]]:
        return self.cross_block_tables.get(seq.seq_id)

    def mark_computed(self, seq: Sequence) -> None:
        """After a model step wrote KV for all tokens < num_computed_tokens,
        mark fully-covered hashed blocks as computed (prefix-cache-ready)."""
        if not self.enable_prefix_caching:
            return
        table = self.block_tables.get(seq.seq_id)
        if not table:
            return
        num_full = seq.num_computed_tokens // self.block_size
        for block_id in table[:num_full]:
            self._blocks[block_id].computed = True

    def has_seq(self, seq: Sequence) -> bool:
        return seq.seq_id in self.block_tables

    # ---- introspection (for tests/metrics) ----------------------------------

    def get_prefix_cache_hit_rate(self) -> float:
        return self.metrics.hit_rate

    def num_referenced_blocks(self) -> int:
        return sum(1 for b in self._blocks if b.ref_count > 0)
