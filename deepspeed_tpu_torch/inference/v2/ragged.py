"""Blocked (paged) KV cache + ragged batch bookkeeping (reference:
inference/v2/ragged/ — DSStateManager owns a pool of fixed-size KV blocks
and per-sequence page tables; the blocked allocator gates admission).

The port's copy of ``deepspeed_tpu/inference/v2/ragged.py``: host-only
Python, kept near-verbatim. The pool is one device tensor per k/v with
layout ``[L, num_blocks, block_size, H_kv, D]``; page tables and sequence
descriptors stay on the host; a quantized pool adds one f32 scale pool
per k/v, ``[L, num_blocks, block_size, Hs]``, indexed by the same blocks.
``KVExportState`` is one sequence's KV block set on its way between
engines (disaggregated serving); its payload is CPU torch tensors and its
wire format is the JAX package's, byte for byte. Left for a later slice:
the blocksan hooks.
"""

from __future__ import annotations

import json
import struct
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

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


def quantized_block_budget(num_blocks: int, full_block_bytes: int,
                           quant_block_bytes: int) -> int:
    """Blocks the quantized pool may hold inside the device-memory budget
    of ``num_blocks`` full-precision blocks (never fewer than
    configured)."""
    return max(int(num_blocks),
               int(num_blocks) * int(full_block_bytes)
               // max(int(quant_block_bytes), 1))


# KV migration wire format (the JAX package's). The version bumps on any
# layout change, and an import refuses a mismatched version outright.
MIGRATION_WIRE_VERSION = 1

# the payload dtypes by their wire names (numpy's, as the JAX engine
# writes them: numpy has no bf16 or fp8 of its own, ml_dtypes names them)
WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16, "int8": torch.int8,
               "float8_e4m3fn": torch.float8_e4m3fn}
_WIRE_NAMES = {dt: name for name, dt in WIRE_DTYPES.items()}


@dataclass
class KVExportState:
    """One sequence's serialized KV block set, the unit of migration
    between engines: the sequence's blocks that hold written KV, gathered
    from the exporting engine's pools, one CPU tensor a pool slab keyed
    like ``InferenceEngineV2.pools`` (``k``/``v``, plus ``ks``/``vs`` scale
    slabs on quantized engines) with the block axis narrowed to this
    sequence's blocks. Quantized codes and their scales travel as stored.
    Import is position-exact: the sequence resumes with identical
    ``tokens``, ``seen`` and pool bytes, so greedy continuation is
    bit-identical to never having moved.

    ``n_generated`` splits ``tokens`` into the prompt and the generated
    suffix (the pending token last). ``handoff_id`` is the JAX blocksan's
    transit tag, carried through unread."""
    tokens: list[int]
    n_generated: int
    seen: int
    block_size: int
    kv_dtype: str
    payload: dict[str, torch.Tensor]
    handoff_id: Optional[int] = None
    source: str = ""                      # exporting engine or replica

    @property
    def prompt_tokens(self) -> list[int]:
        return self.tokens[:len(self.tokens) - self.n_generated]

    @property
    def generated_tokens(self) -> list[int]:
        return self.tokens[len(self.tokens) - self.n_generated:]

    @property
    def payload_blocks(self) -> int:
        """Blocks of KV payload travelling (the pending token's block tail
        is reserved again on import, not shipped empty)."""
        return int(next(iter(self.payload.values())).shape[1]) \
            if self.payload else 0

    @property
    def payload_bytes(self) -> int:
        """Wire bytes of the payload, scale slabs included."""
        return int(sum(a.numel() * a.element_size()
                       for a in self.payload.values()))

    def bytes_per_token(self) -> float:
        """Payload bytes a migrated KV token (block granularity: the tail
        block ships whole, as it is stored)."""
        toks = self.payload_blocks * self.block_size
        return self.payload_bytes / max(toks, 1)

    # -- wire format ---------------------------------------------------
    def to_bytes(self) -> bytes:
        """One self-describing buffer: a little-endian u32 header length,
        the JSON header (token history, layout, each array's name, shape
        and dtype), then the arrays' raw bytes in sorted-name order. The
        JAX engine's ``to_bytes`` gives the same bytes for the same
        state."""
        arrays = [(k, self.payload[k]) for k in sorted(self.payload)]
        header = json.dumps({
            "version": MIGRATION_WIRE_VERSION,
            "tokens": [int(t) for t in self.tokens],
            "n_generated": int(self.n_generated),
            "seen": int(self.seen),
            "block_size": int(self.block_size),
            "kv_dtype": self.kv_dtype,
            "source": self.source,
            "handoff_id": self.handoff_id,
            "arrays": [{"name": k, "shape": list(a.shape),
                        "dtype": _WIRE_NAMES[a.dtype]} for k, a in arrays],
        }).encode()
        parts = [struct.pack("<I", len(header)), header]
        parts += [a.detach().cpu().contiguous().reshape(-1)
                  .view(torch.uint8).numpy().tobytes() for _, a in arrays]
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "KVExportState":
        """Decode :meth:`to_bytes`'s buffer (or the JAX engine's): each
        array is copied out into a tensor of its own, so nothing keeps
        ``buf`` alive. A wire version other than this one's is refused."""
        (hlen,) = struct.unpack_from("<I", buf, 0)
        head = json.loads(bytes(buf[4:4 + hlen]).decode())
        if head["version"] != MIGRATION_WIRE_VERSION:
            raise ValueError(
                f"KV migration wire version {head['version']} != "
                f"{MIGRATION_WIRE_VERSION} — refusing a cross-version "
                "import")
        off = 4 + hlen
        payload = {}
        for spec in head["arrays"]:
            if spec["dtype"] not in WIRE_DTYPES:
                raise ValueError(
                    f"KV migration: unknown payload dtype {spec['dtype']!r}"
                    f"; the wire carries {sorted(WIRE_DTYPES)}")
            a = torch.empty(spec["shape"], dtype=WIRE_DTYPES[spec["dtype"]])
            n = a.numel() * a.element_size()
            if n:
                a.reshape(-1).view(torch.uint8).numpy()[:] = \
                    np.frombuffer(buf, np.uint8, count=n, offset=off)
            payload[spec["name"]] = a
            off += n
        return cls(tokens=head["tokens"],
                   n_generated=head["n_generated"], seen=head["seen"],
                   block_size=head["block_size"],
                   kv_dtype=head["kv_dtype"], payload=payload,
                   handoff_id=head.get("handoff_id"),
                   source=head.get("source", ""))


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

    def prefix_cache_metrics(self) -> dict:
        """Counters + occupancy gauges for serving_metrics(): zeros with
        caching off, so consumers see one stable schema."""
        if self.cache is None:
            m = dict.fromkeys(PREFIX_STAT_KEYS, 0)
            m.update(prefix_hit_rate=0.0, prefix_cached_blocks=0,
                     prefix_evictable_blocks=0)
            return m
        m = dict(self.cache.stats)
        looked = m["prefix_hits"] + m["prefix_misses"]
        m["prefix_hit_rate"] = m["prefix_hits"] / max(looked, 1)
        m["prefix_cached_blocks"] = self.cache.cached_blocks
        m["prefix_evictable_blocks"] = self.cache.evictable_blocks
        return m

    def reset_prefix_stats(self) -> None:
        if self.cache is not None:
            self.cache.reset_stats()

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

    def reserve(self, uid: int, future_tokens: int) -> int:
        """Preallocate blocks so the sequence can grow by
        ``future_tokens`` without further allocation. A fused decode
        dispatch needs it: its KV writes advance through a block table
        fixed before the dispatch, with no host in the loop, so every
        position the device may write must already map to a real block.
        Idempotent: only the missing delta is allocated. Returns the
        number of blocks newly allocated."""
        seq = self.seqs[uid]
        need = self.blocks_needed(seq, future_tokens)
        if need == 0:
            return 0
        if len(seq.blocks) + need > self.max_blocks_per_seq:
            raise RuntimeError(
                f"sequence {uid}: reserving {future_tokens} future tokens "
                f"exceeds the max length "
                f"({self.max_blocks_per_seq * self.block_size} tokens)")
        seq.blocks.extend(self.allocator.allocate(need))
        return need

    def history_tail(self, uid: int, window: int) -> np.ndarray:
        """The last ``window`` committed tokens (the pending one
        included), right-aligned in a [window] int64 row with -1 filling
        the unused leading columns: the prompt-lookup drafter's seed.
        Prefix-cache-matched prompt blocks are in ``seq.tokens`` like any
        other committed token, so a cache-hit admission seeds the window a
        cold one would."""
        row = np.full((window,), -1, np.int64)
        toks = self.seqs[uid].tokens[-window:]
        if toks:
            row[window - len(toks):] = toks
        return row

    def commit_device_tokens(self, uid: int, tokens: list[int]) -> None:
        """Append tokens a fused dispatch generated on the device. Their KV
        entries (all but the last token's) were already written there, so
        ``seen`` advances with the history: afterwards exactly the last
        generated token is pending, the next dispatch's input. Blocks must
        have been preallocated with :meth:`reserve`. The commit's length
        varies: a speculative dispatch lands 1..1 + draft_len tokens a row
        a tick, so callers pass what the row's write pointer says; the
        single pending input before the call and the reserved horizon
        are the only invariants."""
        if not tokens:
            return
        seq = self.seqs[uid]
        if seq.pending != 1:
            raise RuntimeError(
                f"sequence {uid}: commit_device_tokens expects exactly "
                f"one pending token (the dispatch input), got "
                f"{seq.pending}")
        total = len(seq.tokens) + len(tokens)
        if -(-total // self.block_size) > len(seq.blocks):
            raise RuntimeError(
                f"sequence {uid}: device wrote past its reserved blocks "
                f"({total} tokens, {len(seq.blocks)} blocks) — reserve() "
                "was not called before the fused dispatch")
        seq.tokens.extend(int(t) for t in tokens)
        seq.seen += len(tokens)
        self.publish_full_blocks(seq)

    def park(self, uid: int) -> list[int]:
        """Preemption swap-out: release a live sequence's KV blocks and
        return its full token history for the host to keep. With the
        prefix cache on, its published full blocks stay indexed (parked
        in the LRU at refcount zero), so a restore that re-admits the
        history as a fresh prompt re-pins the cached chain and recomputes
        only the unpublished tail."""
        seq = self.seqs.get(uid)
        if seq is None:
            return []
        tokens = list(seq.tokens)
        self.flush(uid)
        return tokens

    def flush(self, uid: int) -> None:
        """Release a finished sequence (reference: engine_v2.flush:242)."""
        seq = self.seqs.pop(uid, None)
        if seq is not None:
            self._release_blocks(seq.blocks)

    def import_sequence(self, uid: int, tokens: list[int], seen: int,
                        payload_blocks: int) -> SequenceDescriptor:
        """The accounting half of a KV import: allocate blocks covering
        the full migrated history (the engine scatters the payload into
        the first ``payload_blocks`` of them), rebuild the descriptor
        position-exactly, and publish the sequence's full blocks into this
        manager's prefix cache, so same-prefix traffic that follows lands
        warm here. Every check raises before any allocation."""
        uid = int(uid)
        if uid in self.seqs:
            raise RuntimeError(
                f"import_sequence: uid {uid} already live on this "
                "engine — migrated uids must be fresh")
        tokens = [int(t) for t in tokens]
        seen = int(seen)
        if not tokens or seen != len(tokens) - 1:
            raise RuntimeError(
                f"import_sequence: uid {uid} must arrive with exactly "
                f"one pending token (seen {seen}, {len(tokens)} tokens)"
                " — export happens at a dispatch boundary")
        n_total = -(-len(tokens) // self.block_size)
        if payload_blocks > n_total:
            raise RuntimeError(
                f"import_sequence: uid {uid} ships {payload_blocks} "
                f"payload blocks for a {n_total}-block history")
        if n_total > self.max_blocks_per_seq:
            raise RuntimeError(
                f"import_sequence: uid {uid} needs {n_total} blocks, "
                f"max {self.max_blocks_per_seq}")
        blocks = self.allocator.allocate(n_total)
        seq = SequenceDescriptor(uid=uid, tokens=tokens, seen=seen,
                                 blocks=blocks)
        self.seqs[uid] = seq
        # the migrated full blocks index under the chain they carried on
        # the exporter (content-keyed; the first publisher wins)
        self.publish_full_blocks(seq)
        return seq

    def block_table(self, seq: SequenceDescriptor) -> np.ndarray:
        """Padded [max_blocks_per_seq] table; unused entries point past the
        pool (readers clamp them, writers skip them)."""
        t = np.full((self.max_blocks_per_seq,),
                    self.allocator.num_blocks, np.int32)
        t[:len(seq.blocks)] = seq.blocks
        return t
