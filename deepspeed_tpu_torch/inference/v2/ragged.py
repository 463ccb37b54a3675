"""Blocked (paged) KV cache + ragged batch bookkeeping (reference:
inference/v2/ragged/ — DSStateManager owns a pool of fixed-size KV blocks
and per-sequence page tables; the blocked allocator gates admission).

The port's copy of ``deepspeed_tpu/inference/v2/ragged.py``: host-only
Python, kept near-verbatim. The pool is one device tensor per k/v with
layout ``[L, num_blocks, block_size, H_kv, D]``; page tables and sequence
descriptors stay on the host. Left for later slices: ``KVExportState``,
``import_sequence`` and ``park`` (KV migration), ``reserve``,
``commit_device_tokens`` and ``history_tail`` (the fused decode loops),
and the blocksan hooks. ``PrefixCache`` is kept because
``DSStateManager`` references it; the port's engine keeps it off.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

PREFIX_STAT_KEYS = ("prefix_hits", "prefix_misses", "prefix_evictions",
                    "prefill_tokens_saved")

# chain seed for the root of every block-hash chain (arbitrary odd
# constant; only equality matters)
_CHAIN_ROOT = 0x9E3779B97F4A7C15


def kv_block_bytes(block_size: int, num_kv_heads: int, head_dim: int,
                   payload_itemsize: float,
                   scale_heads: int = 0) -> int:
    """Device bytes ONE block costs per layer, k+v pools together:
    payload plus (for quantized pools) the f32 per-vector scale slab."""
    payload = block_size * num_kv_heads * head_dim * payload_itemsize
    scales = block_size * scale_heads * 4
    return int(2 * (payload + scales))


@dataclass
class SequenceDescriptor:
    """reference: ragged/sequence_descriptor.py"""
    uid: int
    tokens: list[int]                    # full token history (prompt+gen)
    seen: int = 0                        # tokens already in the KV cache
    blocks: list[int] = field(default_factory=list)
    done: bool = False
    # prefix-cache chain state: hash of the chain after `published` full
    # blocks (blocks matched at admission arrive already published)
    cached_key: int = _CHAIN_ROOT
    published: int = 0

    @property
    def pending(self) -> int:
        return len(self.tokens) - self.seen


class BlockedAllocator:
    """Fixed-pool REF-COUNTED block allocator (reference:
    ragged/blocked_allocator.py). ``evict_source`` (set by
    :class:`DSStateManager` when prefix caching is on) is asked to
    surrender one cached-but-unreferenced block at a time when the free
    list runs short."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks
        self.evict_source = None        # () -> Optional[int]

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def allocate(self, n: int) -> list[int]:
        while n > len(self._free) and self.evict_source is not None:
            b = self.evict_source()
            if b is None:
                break
            self.free([b])
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: want {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, blocks) -> None:
        for b in blocks:
            self._ref[b] += 1

    def decref(self, blocks) -> list[int]:
        """Drop one reference per block; returns the blocks that reached
        refcount zero (NOT freed — the caller routes them to the free
        list or the prefix cache's LRU pool)."""
        zeros = []
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] <= 0:
                self._ref[b] = 0
                zeros.append(b)
        return zeros

    def free(self, blocks: list[int]) -> None:
        """Raw return to the free list (refcounts cleared)."""
        for b in blocks:
            self._ref[b] = 0
        self._free.extend(blocks)


class PrefixCache:
    """Hash-chained index of FULL KV blocks for automatic prefix reuse.

    Every full block is keyed by ``(parent_hash, tuple(block_tokens))``;
    blocks with refcount zero stay indexed and parked in an LRU, count
    as allocatable headroom and are evicted oldest-first only when an
    allocation needs them (or when ``max_cached_blocks`` caps the
    index)."""

    def __init__(self, block_size: int, min_match_blocks: int = 1,
                 max_cached_blocks: int = 0):
        self.block_size = block_size
        self.min_match_blocks = max(1, int(min_match_blocks))
        self.max_cached_blocks = int(max_cached_blocks)   # 0 = pool-bounded
        self.index: dict[tuple, int] = {}     # (parent, tokens) -> block
        self.block_key: dict[int, tuple] = {}
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # ref==0 blocks
        self.stats = dict.fromkeys(PREFIX_STAT_KEYS, 0)
        # where cap-evicted blocks go (set by DSStateManager to the
        # allocator's free list)
        self.free_sink = None               # (block: int) -> None

    @property
    def cached_blocks(self) -> int:
        return len(self.index)

    @property
    def evictable_blocks(self) -> int:
        return len(self.lru)

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    def match(self, tokens: list[int], limit_blocks: int) -> list[tuple]:
        """Longest cached chain over the first ``limit_blocks`` full
        blocks of ``tokens``; returns ``[(key, block), ...]`` (empty
        when shorter than ``min_match_blocks``)."""
        bs = self.block_size
        parent = _CHAIN_ROOT
        out: list[tuple] = []
        for i in range(limit_blocks):
            key = (parent, tuple(tokens[i * bs:(i + 1) * bs]))
            blk = self.index.get(key)
            if blk is None:
                break
            out.append((key, blk))
            parent = hash(key)
        if len(out) < self.min_match_blocks:
            return []
        return out

    def publish(self, parent: int, block_tokens: tuple,
                block: int) -> int:
        """Index one freshly-computed full block under its chain key;
        returns the child chain hash (first publisher wins)."""
        key = (parent, block_tokens)
        if key not in self.index:
            if (self.max_cached_blocks > 0
                    and len(self.index) >= self.max_cached_blocks):
                evicted = self.evict_one()
                if evicted is None:
                    return hash(key)
                if self.free_sink is not None:
                    self.free_sink(evicted)
            self.index[key] = block
            self.block_key[block] = key
        return hash(key)

    def release(self, block: int) -> bool:
        """A block's refcount hit zero: park it if it is indexed; returns
        False when the block is uncached and the caller should free it."""
        if block not in self.block_key:
            return False
        self.lru[block] = None
        self.lru.move_to_end(block)
        return True

    def evict_one(self) -> Optional[int]:
        """Drop the least-recently-used unreferenced cached block from
        the index; returns its id (now plain free) or None."""
        if not self.lru:
            return None
        block, _ = self.lru.popitem(last=False)
        del self.index[self.block_key.pop(block)]
        self.stats["prefix_evictions"] += 1
        return block


class DSStateManager:
    """Sequence tracking + block accounting (reference:
    ragged/ragged_manager.py:19)."""

    def __init__(self, block_size: int, num_blocks: int,
                 max_blocks_per_seq: int,
                 prefix_cache: Optional[PrefixCache] = None):
        self.block_size = block_size
        self.allocator = BlockedAllocator(num_blocks)
        self.max_blocks_per_seq = max_blocks_per_seq
        self.seqs: dict[int, SequenceDescriptor] = {}
        self.cache = prefix_cache
        if prefix_cache is not None:
            self.allocator.evict_source = prefix_cache.evict_one
            prefix_cache.free_sink = self._free_sink

    def _free_sink(self, block: int) -> None:
        self.allocator.free([block])

    @property
    def available_blocks(self) -> int:
        """Allocatable headroom: truly free blocks plus cached blocks
        with refcount zero (the allocator evicts those on demand)."""
        free = self.allocator.free_blocks
        if self.cache is not None:
            free += self.cache.evictable_blocks
        return free

    def get_or_create(self, uid: int) -> SequenceDescriptor:
        if uid not in self.seqs:
            self.seqs[uid] = SequenceDescriptor(uid=uid, tokens=[])
        return self.seqs[uid]

    def blocks_needed(self, seq: SequenceDescriptor, new_tokens: int) -> int:
        total = len(seq.tokens) + new_tokens
        need = -(-total // self.block_size)  # ceil
        return max(0, need - len(seq.blocks))

    # ------------------------------------------------------------------
    # prefix cache plumbing
    def _match_limit(self, n_tokens: int) -> int:
        """Full blocks a fresh admission of ``n_tokens`` may reuse: at
        least one token must stay pending."""
        return min(max(n_tokens - 1, 0) // self.block_size,
                   self.max_blocks_per_seq)

    def prefix_match(self, tokens) -> list[tuple]:
        """Longest cached chain a FRESH sequence with these tokens would
        reuse; pure query."""
        if self.cache is None:
            return []
        return self.cache.match([int(t) for t in tokens],
                                self._match_limit(len(tokens)))

    def admission_cost(self, tokens, full_need: int) -> int:
        """Blocks a fresh admission of ``tokens`` with a worst-case
        budget of ``full_need`` consumes from :attr:`available_blocks`."""
        hits = self.prefix_match(tokens)
        return (full_need - len(hits)
                + sum(1 for _, b in hits
                      if self.allocator.refcount(b) == 0))

    def pin_prefix(self, matches: list[tuple]) -> None:
        """Take a reference on each matched block (pulling parked ones
        out of the LRU)."""
        for _, b in matches:
            if self.allocator.refcount(b) == 0:
                self.cache.lru.pop(b, None)
            self.allocator.incref((b,))

    def unpin_prefix(self, matches: list[tuple]) -> None:
        self._release_blocks([b for _, b in matches])

    def _release_blocks(self, blocks: list[int]) -> None:
        """The one free-routing choke point: decref, then the prefix
        cache's LRU park for indexed blocks, then ``allocator.free``."""
        zeros = self.allocator.decref(blocks)
        if self.cache is not None:
            zeros = [b for b in zeros if not self.cache.release(b)]
        if zeros:
            self.allocator.free(zeros)

    def publish_full_blocks(self, seq: SequenceDescriptor) -> None:
        """Index every newly-completed full block of ``seq``. No-op with
        caching off."""
        if self.cache is None:
            return
        full = min(seq.seen // self.block_size, len(seq.blocks))
        while seq.published < full:
            i = seq.published
            toks = tuple(seq.tokens[i * self.block_size:
                                    (i + 1) * self.block_size])
            seq.cached_key = self.cache.publish(seq.cached_key, toks,
                                                seq.blocks[i])
            seq.published += 1

    # ------------------------------------------------------------------
    def can_schedule(self, uid: int, new_tokens: int) -> bool:
        """reference: engine_v2.can_schedule:184."""
        seq = self.seqs.get(uid) or SequenceDescriptor(uid=uid, tokens=[])
        need = self.blocks_needed(seq, new_tokens)
        total_blocks = len(seq.blocks) + need
        return (need <= self.available_blocks
                and total_blocks <= self.max_blocks_per_seq)

    def extend(self, uid: int, tokens: list[int],
               pinned: Optional[list[tuple]] = None) -> SequenceDescriptor:
        """Append tokens to a sequence, allocating blocks to cover them.
        A FRESH sequence first walks the prefix cache (when one is
        attached) and shares the longest cached chain of full blocks."""
        seq = self.get_or_create(uid)
        fresh = not seq.tokens and not seq.blocks and seq.seen == 0
        matches: list[tuple] = []
        own_pin = False
        if self.cache is not None and fresh:
            if pinned is not None:
                matches = pinned
            else:
                matches = self.prefix_match(tokens)
                own_pin = bool(matches)
        total_blocks = -(-(len(seq.tokens) + len(tokens))
                         // self.block_size)
        if total_blocks > self.max_blocks_per_seq:
            if pinned:
                self.unpin_prefix(pinned)
            raise RuntimeError(
                f"sequence {uid} exceeds max length "
                f"({self.max_blocks_per_seq * self.block_size} tokens)")
        if own_pin:
            self.pin_prefix(matches)
        try:
            fresh_blocks = self.allocator.allocate(
                max(0, total_blocks - len(seq.blocks) - len(matches)))
        except RuntimeError:
            if matches:
                self.unpin_prefix(matches)
            raise
        if matches:
            seq.blocks.extend(b for _, b in matches)
            seq.seen = len(matches) * self.block_size
            seq.published = len(matches)
            seq.cached_key = hash(matches[-1][0])
            self.cache.stats["prefill_tokens_saved"] += seq.seen
        if self.cache is not None and fresh:
            limit = self._match_limit(len(tokens))
            if limit > 0:
                self.cache.stats["prefix_hits"] += len(matches)
                self.cache.stats["prefix_misses"] += limit - len(matches)
        seq.blocks.extend(fresh_blocks)
        seq.tokens.extend(int(t) for t in tokens)
        return seq

    def flush(self, uid: int) -> None:
        """Release a finished sequence (reference: engine_v2.flush:242)."""
        seq = self.seqs.pop(uid, None)
        if seq is not None:
            self._release_blocks(seq.blocks)

    def block_table(self, seq: SequenceDescriptor) -> np.ndarray:
        """Padded [max_blocks_per_seq] table; unused entries point past the
        pool (readers clamp them, writers skip them)."""
        t = np.full((self.max_blocks_per_seq,),
                    self.allocator.num_blocks, np.int32)
        t[:len(seq.blocks)] = seq.blocks
        return t
