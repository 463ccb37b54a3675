"""FastGen-style inference engine (counterpart of
``deepspeed_tpu/inference/v2/engine_v2.py``; reference:
inference/v2/engine_v2.py InferenceEngineV2 — put() runs one forward over
a ragged batch of mixed prefill/decode sequences against the blocked KV
cache; query/can_schedule gate admission; flush frees a sequence's KV
blocks).

One scheduler tick is one :func:`paged.paged_forward` over every sequence
with pending tokens: prefill chunks (the SplitFuse budget) and the decode
batch ride the same pass. The JAX engine pads batch, chunk and context to
power-of-two buckets to bound XLA recompiles; PyTorch runs eagerly, so the
port drops the padding there and keeps the token grouping: a row advances
``min(pending, chunk)`` tokens per tick.

The fused decode path (``decode_fused``, ``generate_fused`` over
``serve_loop.FusedServeLoop``) runs K decode ticks a host dispatch with
sampling on the device, in chain mode or ring mode (``fused_admission``:
admission inside the loop, one host read a chain), each with or without
speculative decoding (``speculative.enabled``). It keeps the JAX engine's
batch and table-width buckets: on the card each (mode, bucket, K,
sampling setting) is one captured CUDA graph over operands at fixed
addresses (``fused_graph.py``).

Weight-only int8 (``quantize_weights``, or a ``params`` tree holding
``name_q`` / ``name_s`` pairs) loads as the v1 engine does
(``inference/engine.py`` ``load_weights``); the model dequantizes a layer
where ``paged_forward`` reads it, so inside every captured graph too, its
temporaries from the graph's pool.

KV migration (``export_request``, ``import_request``, and
``prefill_request`` for a dedicated prefill engine) moves one sequence's
KV blocks between engines at a dispatch boundary: the transport of
disaggregated serving (``deepspeed_tpu_torch.serving``). The pools are
written in place, since the captured graphs read them by address.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ...ops import sampling, threefry
from ...ops.quantization import KV_STORE_DTYPES
from ...utils.logging import log_dist
from ..config import DeepSpeedInferenceConfig
from ..engine import (INT8_DTYPE_MESSAGE, QUANTIZE_TP_MESSAGE,
                      load_weights, refuse_moe_tp, serving_model)
from ...runtime.config_utils import DeepSpeedConfigModel
from .fused_graph import CapturedLoop, FusedState, RingState
from .paged import (KERNEL_DTYPES, fused_decode_loop, fused_serve_loop,
                    fused_spec_decode_loop, fused_spec_serve_loop,
                    indexable, paged_forward)
from .ragged import (DSStateManager, KVExportState, PrefixCache,
                     SequenceDescriptor, kv_block_bytes,
                     quantized_block_budget)

# serving_metrics() schema, the JAX engine's: raw counters kept in
# serving_stats (reset zeroes exactly these); the prefix-cache counters
# ride alongside, and the ratios are appended at read time. The spec_*
# counters come from the speculative loops' device counters.
# fused_live_slots counts scheduled (row, step) slots whose row was still
# active, the occupancy numerator (one token a live slot).
SERVING_COUNTER_KEYS = (
    "host_dispatches", "fused_dispatches", "fused_steps", "fused_slots",
    "fused_slot_tokens", "fused_live_slots", "decoded_tokens",
    "spec_proposed_tokens", "spec_accepted_tokens", "spec_hit_slots")


# the grouped MoE form reads its group sizes on the host, so no graph takes
# it; the capacity form, which drops tokens, is never put in its place
GROUPED_UNCAPTURED = (
    "moe_grouped_dispatch in a fused dispatch on the card: the grouped MoE "
    "GEMMs read their group sizes on the host and a CUDA graph cannot "
    "capture them (ROADMAP Queue 2, kernel work: the routed-expert GEMMs); "
    "serve the grouped form through generate()/put(), or the "
    "capacity form (moe_grouped_dispatch off) through the fused loops")


def _bucket(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _batch_bucket(n: int) -> int:
    """Decode-batch bucket: powers of two up to 8, then multiples of 8
    (the JAX engine's, so a fused dispatch pads its batch the same way)."""
    return _bucket(n) if n <= 8 else -(-n // 8) * 8


@dataclasses.dataclass
class PrefixCacheConfig(DeepSpeedConfigModel):
    """Automatic prefix caching: full KV blocks are indexed by a hash
    chain over their tokens and shared across requests; a new prompt
    whose leading blocks match a cached chain skips their prefill."""
    enabled: bool = False
    # a match shorter than this many full blocks is ignored
    min_match_blocks: int = 1
    # cap on indexed blocks; 0 = bounded only by the pool
    max_cached_blocks: int = 0


@dataclasses.dataclass
class SpeculativeConfig(DeepSpeedConfigModel):
    """Self-drafting speculative decoding in the fused serving loops: a
    prompt-lookup (n-gram) drafter on the device proposes up to
    ``draft_len`` tokens a row a tick from the row's recent history, and
    one forward over ``1 + draft_len`` positions verifies them, committing
    1..1 + draft_len tokens. No draft model; greedy and sampled tokens
    equal spec-off decode's (targets are position-keyed, drafts only
    decide how many land a forward). ``min_ngram``: the shortest trailing
    n-gram that may match; ``history_window``: the window the drafter
    searches (per row, seeded at admission from the committed history)."""
    enabled: bool = False
    draft_len: int = 3
    min_ngram: int = 2
    history_window: int = 64

    def __post_init__(self):
        super().__post_init__()
        # the JAX block's Field(ge=...) bounds and its window validator
        for name, lo in (("draft_len", 1), ("min_ngram", 1),
                         ("history_window", 8)):
            if getattr(self, name) < lo:
                raise ValueError(
                    f"speculative.{name} {getattr(self, name)}: must be "
                    f"greater than or equal to {lo}")
        need = self.min_ngram + self.draft_len + 1
        if self.history_window < need:
            raise ValueError(
                f"speculative.history_window ({self.history_window}) must "
                f"be >= min_ngram + draft_len + 1 ({need}): the window "
                "must hold one n-gram, its full continuation and the "
                "trailing n-gram it matches against")


@dataclasses.dataclass
class KVCacheConfig(DeepSpeedConfigModel):
    """Quantized KV cache: the pools store int8 or fp8-e4m3 codes with
    one f32 scale per written (token, kv-head) vector (``granularity``
    "head") or per token ("token"), in scale pools beside them. ``dtype``
    "fp16" keeps the engine's compute dtype: the no-op rung, no scale
    pools and no growth. ``grow_pool`` sizes the allocator in quantized
    bytes: the memory of ``num_kv_blocks`` full-precision blocks holds
    about twice as many quantized ones."""
    enabled: bool = False
    dtype: str = "int8"            # "fp16" | "int8" | "fp8"
    granularity: str = "head"      # "head" | "token"
    grow_pool: bool = True

    def __post_init__(self):
        super().__post_init__()
        # the JAX block's Literal fields
        if self.dtype not in ("fp16", *KV_STORE_DTYPES):
            raise ValueError(f"kv_cache.dtype {self.dtype!r}: one of "
                             f"'fp16', 'int8', 'fp8'")
        if self.granularity not in ("head", "token"):
            raise ValueError(f"kv_cache.granularity {self.granularity!r}: "
                             f"'head' or 'token'")


@dataclasses.dataclass
class GraftsanConfig(DeepSpeedConfigModel):
    """The JAX block's fields (KV-block accounting and thread-affinity
    sanitizers); not ported yet, accepted at its defaults."""
    enabled: bool = False
    blocksan: bool = True
    thread_affinity: bool = True
    mode: str = "raise"
    journal_size: int = 512


@dataclasses.dataclass
class InferenceMeshsanConfig(DeepSpeedConfigModel):
    """The JAX block's fields (mesh-traffic sanitizer); not ported yet,
    accepted at its defaults."""
    enabled: bool = False
    mode: str = "raise"
    axes: Optional[list] = None


@dataclasses.dataclass
class InferenceNumsanConfig(DeepSpeedConfigModel):
    """The JAX block's fields (numerics sanitizer); not ported yet,
    accepted at its defaults."""
    enabled: bool = False
    mode: str = "raise"
    logits_limit: float = 1e4
    probe_interval: int = 16
    kv_scale_probe: bool = True
    saturation_ceiling: float = 0.05
    saturation_probe: bool = True


@dataclasses.dataclass
class RaggedInferenceEngineConfig(DeepSpeedInferenceConfig):
    """reference: inference/v2/config_v2.py RaggedInferenceEngineConfig —
    every field of the JAX config with its default: the ones this port
    serves with, and the switches of features it does not have yet, which
    ``_refuse_unported`` refuses away from their defaults."""
    kv_block_size: int = 64
    num_kv_blocks: int = 256
    max_ragged_sequence_count: int = 32
    max_chunk_size: int = 256             # prefill chunk (SplitFuse budget)
    # K decode ticks a host dispatch of the fused loop, its in-graph
    # sampling defaults (temperature 0.0 = greedy; top_k/top_p 0 = no
    # filter; per-call overrides win), the EOS that ends a row on the
    # device, and the dispatch chain's depth (JAX defaults)
    fused_decode_steps: int = 8
    sampling_temperature: float = 0.0
    sampling_top_k: int = 0
    sampling_top_p: float = 0.0
    eos_token_id: Optional[int] = None
    max_inflight_dispatches: int = 2
    fused_admission: bool = False
    sentinels: bool = False
    sentinel_mode: str = "raise"
    kv_cache: KVCacheConfig = dataclasses.field(
        default_factory=KVCacheConfig)
    prefix_cache: PrefixCacheConfig = dataclasses.field(
        default_factory=PrefixCacheConfig)
    speculative: SpeculativeConfig = dataclasses.field(
        default_factory=SpeculativeConfig)
    graftsan: GraftsanConfig = dataclasses.field(
        default_factory=GraftsanConfig)
    meshsan: InferenceMeshsanConfig = dataclasses.field(
        default_factory=InferenceMeshsanConfig)
    numsan: InferenceNumsanConfig = dataclasses.field(
        default_factory=InferenceNumsanConfig)

    def __post_init__(self):
        super().__post_init__()
        # the JAX field's Field(2, ge=1)
        if self.max_inflight_dispatches < 1:
            raise ValueError(
                f"max_inflight_dispatches {self.max_inflight_dispatches}: "
                f"must be greater than or equal to 1")


def _off_default(config, names) -> str | None:
    """The first of ``names`` whose value differs from its default."""
    defaults = RaggedInferenceEngineConfig()
    for name in names:
        if getattr(config, name) != getattr(defaults, name):
            return f"{name}={getattr(config, name)!r}"
    return None


def _refuse_unported(config: RaggedInferenceEngineConfig) -> None:
    """Raise on every configured feature this slice does not implement,
    naming its ROADMAP item, instead of serving something else."""
    what = _off_default(config, ("sentinels", "sentinel_mode", "graftsan",
                                 "meshsan", "numsan"))
    if what is not None:
        raise NotImplementedError(
            f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP.md, "
            f"port Queue 1: item 15, sanitizers (Slice G))")
    if config.torch_dtype == torch.int8:
        raise NotImplementedError(INT8_DTYPE_MESSAGE)
    if config.quantize_weights and config.tensor_parallel.tp_size > 1:
        raise NotImplementedError(QUANTIZE_TP_MESSAGE)
    refuse_moe_tp(config)
    unported = [
        (config.tensor_parallel.tp_size > 1, "tensor_parallel.tp_size > 1",
         "tensor-parallel serving"),
        (config.checkpoint is not None, "checkpoint", "checkpoint loading"),
    ]
    for on, what, item in unported:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to deepspeed_tpu_torch yet "
                f"(ROADMAP.md, port Queue 1: {item})")


class InferenceEngineV2:
    """reference: inference/v2/engine_v2.py:30"""

    def __init__(self, model, config: RaggedInferenceEngineConfig,
                 params: Optional[dict] = None):
        _refuse_unported(config)
        self._config = config
        self.dtype = config.torch_dtype
        c = model.config
        self.device = model.device
        if self.device.type == "cuda" and \
                self.dtype not in KERNEL_DTYPES:
            raise NotImplementedError(
                f"dtype {self.dtype} on CUDA: the paged-attention kernel "
                "takes float32, bfloat16 or float16")
        # params: given (a JAX-layout numpy tree) or drawn from the seed,
        # quantized per quantize_weights, cast to the serving dtype — what
        # the JAX v1 engine does for the v2 engine at tp=1
        load_weights(model, params, config, self.dtype, self.device)
        # an MoE model's copy with the config's dispatch form (v1's)
        self.model = serving_model(model, config)

        bs = config.kv_block_size
        # quantized KV: the pool's storage and the block budget are
        # resolved before the state manager, so the allocator is sized in
        # quantized bytes
        kvc = config.kv_cache
        self._kv_quant = bool(kvc.enabled and kvc.dtype != "fp16")
        self._kv_scale_heads = (1 if kvc.granularity == "token"
                                else c.num_kv_heads)
        full_bytes = kv_block_bytes(bs, c.num_kv_heads, c.head_dim,
                                    self.dtype.itemsize)
        nb = config.num_kv_blocks
        if self._kv_quant and kvc.grow_pool:
            nb = quantized_block_budget(
                nb, full_bytes, kv_block_bytes(
                    bs, c.num_kv_heads, c.head_dim, 1,
                    scale_heads=self._kv_scale_heads))
        self.num_kv_blocks = nb
        pc = config.prefix_cache
        self.state_manager = DSStateManager(
            block_size=bs, num_blocks=nb,
            max_blocks_per_seq=-(-c.max_seq_len // bs),
            prefix_cache=(PrefixCache(
                block_size=bs, min_match_blocks=pc.min_match_blocks,
                max_cached_blocks=pc.max_cached_blocks)
                if pc.enabled else None))
        # logits of sequences finished as a side effect of another
        # caller's drain loop, held for their owner's next tick()
        self._finished_stash: dict[int, torch.Tensor] = {}
        # zero-initialized: dead pool slots hold zeros, and zero scales
        # dequantize them to exact 0.0 (paged.py relies on nothing else
        # being there)
        pool_shape = (c.num_layers, nb, bs, c.num_kv_heads, c.head_dim)
        store = KV_STORE_DTYPES[kvc.dtype] if self._kv_quant else self.dtype
        self.pools = {n: torch.zeros(pool_shape, dtype=store,
                                     device=self.device) for n in "kv"}
        if self._kv_quant:
            scale_shape = pool_shape[:3] + (self._kv_scale_heads,)
            self.pools.update({n: torch.zeros(scale_shape,
                                              dtype=torch.float32,
                                              device=self.device)
                               for n in ("ks", "vs")})
        # serving counters behind serving_metrics(): host dispatches vs
        # decoded tokens measures how host-free the decode loop is
        self.serving_stats = dict.fromkeys(SERVING_COUNTER_KEYS, 0)
        # the fused loops: operands at fixed addresses per (batch bucket,
        # table-width bucket), chain mode and ring mode (each state holds
        # its dispatch functions, on the card captured graphs, by mode,
        # step count and sampling setting), base keys per seed, and each
        # capture's cost
        self._fused_states: dict[tuple, FusedState] = {}
        self._ring_states: dict[tuple, RingState] = {}
        self._seed_keys: dict[int, torch.Tensor] = {}
        self.graph_captures: list[dict] = []
        # SplitFuse budget, floored to a power of two as in the JAX engine
        self._chunk = 1 << (max(1, config.max_chunk_size).bit_length() - 1)
        log_dist(f"InferenceEngineV2: {nb} KV blocks x {bs} tokens "
                 f"({self.kv_pool_bytes() / 2**20:.1f} MiB, kv dtype "
                 f"{self.kv_dtype}) on {self.device}")

    # ------------------------------------------------------------------
    def _run(self, uids: list[int]) -> torch.Tensor:
        """One forward over the pending tokens of `uids` (each advances
        min(pending, chunk) tokens). Returns last-token logits
        [len(uids), V]. A model whose pad slots route (the capacity MoE
        form: capacity counts every slot of the chunk, and pads claim
        expert slots) runs JAX's padded chunk: the batch and chunk
        buckets, pad rows on seqs[0]'s table with no tokens to write."""
        mgr = self.state_manager
        seqs = [mgr.seqs[u] for u in uids]
        s = min(max(q.pending for q in seqs), self._chunk)
        rows = len(seqs)
        if self.model.routes_pads:
            s, rows = _bucket(s), _batch_bucket(rows)
        tokens = np.zeros((rows, s), np.int64)
        pos0 = np.zeros((rows,), np.int32)
        true_len = np.zeros((rows,), np.int32)
        for i, seq in enumerate(seqs):
            n = min(seq.pending, s)
            tokens[i, :n] = seq.tokens[seq.seen:seq.seen + n]
            pos0[i] = seq.seen
            true_len[i] = n
        # the block table narrowed to the live context
        live_blocks = -(-int((pos0 + true_len).max()) // mgr.block_size)
        tables = np.stack([mgr.block_table(q)[:live_blocks] for q in seqs]
                          + [mgr.block_table(seqs[0])[:live_blocks]]
                          * (rows - len(seqs)))
        self.serving_stats["host_dispatches"] += 1
        dev = self.device
        logits, self.pools = paged_forward(
            self.model, self.pools, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(tables).to(dev),
            torch.from_numpy(true_len).to(dev),
            pads=bool((true_len < s).any()))
        for i, seq in enumerate(seqs):
            seq.seen += int(true_len[i])
            mgr.publish_full_blocks(seq)
        return logits[:len(seqs)]

    # ------------------------------------------------------------------
    # reference API
    def schedule(self, batch_uids: Sequence[int],
                 batch_tokens: Sequence[Sequence[int]],
                 do_checks: bool = True) -> None:
        """Admit new tokens into the sequence state (KV blocks reserved,
        no compute) — the scheduling half of the reference's put().
        Raises before any state mutation if the batch cannot fit."""
        uids = [int(u) for u in batch_uids]
        mgr = self.state_manager
        for u, toks in zip(uids, batch_tokens):
            if len(toks) == 0:
                raise ValueError(
                    f"sequence {u}: schedule()/put() needs at least one "
                    f"token (an empty list would never finish a tick)")
        # prefix-cache pre-pinning: matched blocks are ref-bumped before
        # any check or allocation, so the admission math credits exactly
        # the blocks reuse skips, and an earlier sequence's allocation in
        # this batch cannot evict a later sequence's hit
        pins: dict[int, list] = {}
        if mgr.cache is not None:
            for u, toks in zip(uids, batch_tokens):
                seq = mgr.seqs.get(u)
                if u not in pins and (seq is None or (not seq.tokens
                                                      and not seq.blocks)):
                    m = mgr.prefix_match(toks)
                    if m:
                        mgr.pin_prefix(m)
                        pins[u] = m
        try:
            if do_checks:
                # cumulative admission over the whole batch, so a failure
                # raises before any state mutation
                need = 0
                for u, toks in zip(uids, batch_tokens):
                    seq = mgr.seqs.get(u)
                    seq_blocks = len(seq.blocks) if seq else 0
                    seq_need = mgr.blocks_needed(
                        seq or SequenceDescriptor(uid=u, tokens=[]),
                        len(toks))
                    if seq_blocks + seq_need > mgr.max_blocks_per_seq:
                        raise RuntimeError(
                            f"sequence {u} would exceed the max length "
                            f"({mgr.max_blocks_per_seq * mgr.block_size} "
                            f"tokens)")
                    need += seq_need - len(pins.get(u, ()))
                if need > mgr.available_blocks:
                    raise RuntimeError(
                        f"cannot schedule batch: needs {need} KV blocks, "
                        f"{mgr.available_blocks} allocatable — the pool "
                        "is exhausted (flush finished sequences)")
            for u, toks in zip(uids, batch_tokens):
                mgr.extend(u, list(map(int, toks)), pinned=pins.pop(u, None))
                # re-admission invalidates logits stashed when this uid
                # finished during another caller's drain
                self._finished_stash.pop(u, None)
        except BaseException:
            for m in pins.values():
                mgr.unpin_prefix(m)
            raise

    def tick(self) -> dict[int, torch.Tensor]:
        """ONE scheduler tick: a single forward over the first
        ``max_ragged_sequence_count`` sequences with pending tokens.
        Returns {uid: last-token logits} for sequences whose pending
        tokens finished this tick (including any stashed by a concurrent
        put())."""
        mgr = self.state_manager
        out = dict(self._finished_stash)
        self._finished_stash.clear()
        run_uids = [u for u, s in mgr.seqs.items() if s.pending]
        run_uids = run_uids[:self._config.max_ragged_sequence_count]
        if run_uids:
            logits = self._run(run_uids)
            out.update({u: logits[i] for i, u in enumerate(run_uids)
                        if not mgr.seqs[u].pending})
        return out

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[Sequence[int]],
            do_checks: bool = True) -> torch.Tensor:
        """schedule() + tick()-until-drained for the given sequences;
        returns last-token logits [n, V] in uid order."""
        uids = [int(u) for u in batch_uids]
        uid_set = set(uids)
        self.schedule(uids, batch_tokens, do_checks)
        mgr = self.state_manager
        final: dict[int, torch.Tensor] = {}
        while any(mgr.seqs[u].pending for u in uids):
            for u, lg in self.tick().items():
                if u in uid_set:
                    final[u] = lg
                else:
                    # a sequence someone else schedule()d finished as a
                    # side effect of our drain: keep it for their tick()
                    self._finished_stash[u] = lg
        return torch.stack([final[u] for u in uids])

    def query(self, uid: int) -> tuple[int, int]:
        """(cached_tokens, allocated_blocks) for a sequence."""
        seq = self.state_manager.seqs.get(uid)
        if seq is None:
            return (0, 0)
        return (seq.seen, len(seq.blocks))

    def can_schedule(self, uid: int, n_tokens: int) -> bool:
        return self.state_manager.can_schedule(uid, n_tokens)

    @property
    def free_blocks(self) -> int:
        """Schedulable KV-block headroom."""
        return self.state_manager.available_blocks

    # ------------------------------------------------------------------
    # KV-pool byte truth
    @property
    def kv_dtype(self) -> str:
        """Storage format of the KV payload pools (the compute dtype's
        name when quantization is off)."""
        return (self._config.kv_cache.dtype if self._kv_quant
                else str(self.dtype).removeprefix("torch."))

    def kv_pool_bytes(self) -> int:
        """Device bytes of the paged KV pools: payload plus (quantized)
        scale pools, from the live tensors."""
        return sum(t.numel() * t.element_size() for t in self.pools.values())

    def kv_bytes_per_token(self) -> float:
        """KV bytes one cached token costs across all layers (k+v, scales
        included): pool bytes over pool token capacity."""
        return (self.kv_pool_bytes()
                / (self.num_kv_blocks * self._config.kv_block_size))

    def serving_metrics(self) -> dict:
        """The JAX engine's serving metrics: the counters, the prefix
        cache's counters and gauges (zeros when it is off),
        ``dispatches_per_token`` (host dispatches per decoded token: 1.0
        per tick, ~1/K fused), ``fused_occupancy`` (the share of scheduled
        (row, step) slots whose row was still live; pad rows of the batch
        bucket are not counted), ``tokens_per_dispatch`` (tokens committed
        a scheduled slot), ``spec_acceptance_rate``, the configured
        ``max_inflight_dispatches`` and the KV pool's footprint:
        ``kv_pool_bytes``, ``kv_bytes_per_token``, ``kv_num_blocks`` and
        ``kv_dtype``."""
        st = dict(self.serving_stats)
        st.update(self.state_manager.prefix_cache_metrics())
        st["dispatches_per_token"] = (
            st["host_dispatches"] / max(st["decoded_tokens"], 1))
        st["fused_occupancy"] = (
            st["fused_live_slots"] / max(st["fused_slots"], 1))
        st["tokens_per_dispatch"] = (
            st["fused_slot_tokens"] / max(st["fused_slots"], 1))
        st["spec_acceptance_rate"] = (
            st["spec_accepted_tokens"]
            / max(st["spec_proposed_tokens"], 1))
        st["max_inflight_dispatches"] = int(
            self._config.max_inflight_dispatches)
        st["kv_pool_bytes"] = self.kv_pool_bytes()
        st["kv_bytes_per_token"] = round(self.kv_bytes_per_token(), 3)
        st["kv_num_blocks"] = int(self.num_kv_blocks)
        st["kv_dtype"] = self.kv_dtype
        return st

    def reset_serving_metrics(self) -> None:
        for k in self.serving_stats:
            self.serving_stats[k] = 0
        self.state_manager.reset_prefix_stats()

    def flush(self, uids) -> None:
        """Release finished sequences' KV blocks; accepts one uid or an
        iterable."""
        if isinstance(uids, (int, np.integer)):
            uids = [uids]
        for u in uids:
            self.state_manager.flush(int(u))
            self._finished_stash.pop(int(u), None)

    @property
    def params(self):
        """The model's parameters by JAX path; another engine built with
        ``params=engine.params`` over the same model shares them."""
        return self.model.params

    # ------------------------------------------------------------------
    # KV migration between engines: the blocks move, the prefill is not
    # recomputed. The hand-off goes through the host (pinned memory).
    def export_request(self, uid: int, *, n_generated: int = 0,
                       source: str = "") -> KVExportState:
        """Serialize one sequence's KV block set and release it here: the
        blocks holding written KV (positions < seen) are gathered from
        every pool slab (quantized codes and scales as stored), and the
        sequence is flushed (with the prefix cache on, its published full
        blocks stay warm in the LRU, as after a park). The sequence must
        stand at a dispatch boundary, exactly one pending token, which
        becomes the importing engine's first dispatch input.

        On the card the gather is one ``index_select`` a slab on the
        calling thread's current stream (the one that ran this engine's
        dispatches), copied into pinned host memory, then one event
        synchronize: the read is ordered after every dispatch that wrote
        the blocks."""
        mgr = self.state_manager
        seq = mgr.seqs.get(int(uid))
        if seq is None:
            raise RuntimeError(f"export_request: unknown uid {uid}")
        if seq.pending != 1:
            raise RuntimeError(
                f"export_request: sequence {uid} must have exactly one "
                f"pending token (a dispatch boundary), got {seq.pending}")
        bs = mgr.block_size
        n_payload = min(-(-seq.seen // bs), len(seq.blocks))
        payload = {}
        if n_payload:
            idx = torch.tensor(seq.blocks[:n_payload], dtype=torch.int64,
                               device=self.device)
            cuda = self.device.type == "cuda"
            for k, pool in self.pools.items():
                got = indexable(pool).index_select(1, idx)
                if cuda:
                    host = torch.empty(got.shape, dtype=got.dtype,
                                       pin_memory=True)
                    host.copy_(got, non_blocking=True)
                    got = host
                payload[k] = got.view(pool.dtype)
            if cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                done.synchronize()
        else:
            # nothing written yet (a one-token prompt): the layout only
            payload = {k: torch.zeros((v.shape[0], 0) + tuple(v.shape[2:]),
                                      dtype=v.dtype)
                       for k, v in self.pools.items()}
        state = KVExportState(
            tokens=list(seq.tokens), n_generated=int(n_generated),
            seen=int(seq.seen), block_size=bs, kv_dtype=self.kv_dtype,
            payload=payload, source=source or f"engine-{id(self):x}")
        self.flush(int(uid))
        return state

    def import_request(self, uid: int, state: KVExportState) -> int:
        """Admit a migrated sequence position-exactly: allocate blocks for
        its full history, write the payload into them (quantized blocks
        and scales land in their storage dtype) and publish the full-block
        chain into this engine's prefix cache. Returns the pending input
        token of the next fused dispatch. A layout mismatch, or a pool
        that cannot hold the sequence, raises before any pool is touched;
        a failure after the allocation flushes the uid.

        The pools are written in place (``index_copy_`` on the block
        axis), never rebound: every captured graph reads them by
        address."""
        mgr = self.state_manager
        if state.kv_dtype != self.kv_dtype:
            raise ValueError(
                f"import_request: migrated KV dtype "
                f"{state.kv_dtype!r} != this engine's "
                f"{self.kv_dtype!r} — migration never converts "
                "payload formats")
        if state.block_size != mgr.block_size:
            raise ValueError(
                f"import_request: migrated block size "
                f"{state.block_size} != {mgr.block_size}")
        if set(state.payload) != set(self.pools):
            raise ValueError(
                f"import_request: payload slabs "
                f"{sorted(state.payload)} != pool slabs "
                f"{sorted(self.pools)}")
        n_payload = state.payload_blocks
        for k, a in state.payload.items():
            pool = self.pools[k]
            want = (pool.shape[0],) + tuple(pool.shape[2:])
            got = (a.shape[0],) + tuple(a.shape[2:])
            if want != got:
                raise ValueError(
                    f"import_request: payload slab {k!r} shape "
                    f"{got} != pool layout {want}")
            if a.dtype != pool.dtype or a.shape[1] != n_payload:
                raise ValueError(
                    f"import_request: payload slab {k!r} holds "
                    f"{a.shape[1]} blocks of {a.dtype}, the pool "
                    f"{n_payload} blocks of {pool.dtype}")
        seq = mgr.import_sequence(int(uid), state.tokens, state.seen,
                                  n_payload)
        try:
            if n_payload:
                idx = torch.tensor(seq.blocks[:n_payload],
                                   dtype=torch.int64, device=self.device)
                for k, a in state.payload.items():
                    src = indexable(a)
                    src = src.to(self.device, non_blocking=src.is_pinned())
                    indexable(self.pools[k]).index_copy_(1, idx, src)
        except BaseException:
            self.flush(int(uid))     # no leak on a failed scatter
            raise
        return int(state.tokens[-1])

    def prefill_request(self, uid: int, prompt, *,
                        temperature: Optional[float] = None,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        seed: int = 0) -> int:
        """The producer half of disaggregated prefill: chunked prefill of
        one prompt on this engine and its first generated token, leaving
        the sequence at the dispatch-boundary state (one pending token)
        that :meth:`export_request` ships, the state the serve loop's own
        prefill reaches before its first fused dispatch. Returns the first
        token."""
        temperature, top_k, top_p, _ = self._sampling_args(
            temperature, top_k, top_p, None)
        uid = int(uid)
        self.schedule([uid], [[int(t) for t in prompt]])
        mgr = self.state_manager
        try:
            logits = None
            while mgr.seqs[uid].pending:
                logits = self._run([uid])
            tok = self.sample_first_tokens(
                {uid: logits[0]}, temperature, top_k, top_p, seed)[uid]
            mgr.extend(uid, [tok])
        except BaseException:
            self.flush(uid)
            raise
        self.serving_stats["decoded_tokens"] += 1
        return tok

    # ------------------------------------------------------------------
    # fused multi-step decode: K ticks a host dispatch, sampling and
    # termination on the device
    def sample_first_tokens(self, firsts: dict, temperature: float,
                            top_k: int, top_p: float,
                            seed: int) -> dict[int, int]:
        """Sample each uid's first generated token from its last-prompt
        logits with the same op and position keying as the fused loop, in
        one batched call (JAX calls it eagerly, so the temperature divides
        here)."""
        if not firsts:
            return {}
        uids = list(firsts)
        row_keys = threefry.fold_in(self._base_key(seed),
                                    torch.tensor(uids, dtype=torch.int64))
        keys = sampling.position_keys(
            row_keys, torch.tensor([self.state_manager.seqs[u].seen
                                    for u in uids], dtype=torch.int64))
        logits = torch.stack([firsts[u] for u in uids]).float()
        toks = sampling.sample_tokens_batched(
            logits, keys.to(logits.device), temperature=temperature,
            top_k=top_k, top_p=top_p)
        return dict(zip(uids, toks.tolist()))

    def _base_key(self, seed: int) -> torch.Tensor:
        key = self._seed_keys.get(seed)
        if key is None:
            # bounded: a server feeding a fresh seed a request must not
            # grow this forever (keys are cheap to rebuild)
            if len(self._seed_keys) >= 64:
                self._seed_keys.clear()
            key = self._seed_keys.setdefault(seed, threefry.prng_key(seed))
        return key

    def _sampling_args(self, temperature, top_k, top_p, eos_id):
        """Per-call overrides over the config's sampling defaults."""
        c = self._config
        return (float(c.sampling_temperature if temperature is None
                      else temperature),
                int(c.sampling_top_k if top_k is None else top_k),
                float(c.sampling_top_p if top_p is None else top_p),
                (c.eos_token_id if eos_id is None else int(eos_id)))

    def _fused_state(self, bb: int, kb: int, k: int) -> FusedState:
        """The fixed-address chain-mode operands of the (bb, kb) bucket,
        wide enough for ``k`` ticks, with the speculative carry when the
        config enables speculation (a state that does not fit is
        replaced, and its graphs go with it)."""
        sp = self._config.speculative
        el, hw = ((int(sp.draft_len), int(sp.history_window))
                  if sp.enabled else (0, 0))
        state = self._fused_states.get((bb, kb))
        if state is None or not state.fits(k, el, hw):
            if state is not None:
                state.release()
            state = FusedState(
                bb, kb, max(k, self._config.fused_decode_steps),
                self.model.config.vocab_size, self.device,
                ring=self._config.max_inflight_dispatches + 1,
                draft_len=el, hist_width=hw)
            self._fused_states[(bb, kb)] = state
        return state

    def _ring_state(self, bb: int, kb: int, cap: int,
                    draft_len: int) -> RingState:
        """The fixed-address ring-mode operands of the (bb, kb) bucket for
        a ring of ``cap`` columns, speculative when ``draft_len`` > 0."""
        hw = (int(self._config.speculative.history_window) if draft_len
              else 0)
        key = (bb, kb, draft_len > 0)
        state = self._ring_states.get(key)
        if state is None or not state.fits(cap, draft_len, hw):
            if state is not None:
                state.release()
            state = RingState(bb, kb, cap, self.device, draft_len=draft_len,
                              hist_width=hw)
            self._ring_states[key] = state
        return state

    def _dispatch_rows(self, uids: list[int], k: int,
                       budgets: dict[int, int], seed: int):
        """Host-side build of a fused dispatch's rows. Every uid must have
        exactly one pending token (its next input, the last sampled
        token); blocks covering ``k`` tokens (capped by the budget) are
        reserved, so the loop's KV writes land in real blocks. Returns
        (batch bucket, the operands as host arrays with full-width block
        tables, the most blocks a row holds)."""
        mgr = self.state_manager
        seqs = [mgr.seqs[u] for u in uids]
        for u, s in zip(uids, seqs):
            if s.pending != 1:
                raise RuntimeError(
                    f"fused decode: sequence {u} must have exactly one "
                    f"pending token (the dispatch input), got {s.pending}")
            mgr.reserve(u, min(k, max(int(budgets[u]), 1)))
        bb = _batch_bucket(len(seqs))
        tokens = np.zeros((bb,), np.int64)
        pos = np.zeros((bb,), np.int32)
        act = np.zeros((bb,), bool)
        rem = np.zeros((bb,), np.int32)
        for i, (u, s) in enumerate(zip(uids, seqs)):
            tokens[i] = s.tokens[-1]
            pos[i] = s.seen
            act[i] = budgets[u] > 0
            rem[i] = budgets[u]
        # pad rows carry seqs[0]'s table and write nothing (inactive)
        tables = np.stack([mgr.block_table(s) for s in seqs]
                          + [mgr.block_table(seqs[0])] * (bb - len(seqs)))
        # per-row keys: the uid folded into the base key (pad rows get
        # sentinel ids); each tick folds in the token's position
        ids = list(uids) + [(1 << 30) + i for i in range(bb - len(uids))]
        row_keys = threefry.fold_in(self._base_key(seed),
                                    torch.tensor(ids, dtype=torch.int64))
        host = dict(tokens=tokens, pos=pos, tables=tables, active=act,
                    remaining=rem, row_keys=row_keys)
        return bb, host, max(len(s.blocks) for s in seqs)

    def _table_width(self, max_blocks: int) -> int:
        """The table-width bucket over rows holding up to ``max_blocks``
        blocks (context + reserved horizon): a power of two."""
        return min(_bucket(max(max_blocks, 1)),
                   self.state_manager.max_blocks_per_seq)

    def _fused_operands(self, uids: list[int], k: int,
                        budgets: dict[int, int], seed: int,
                        hist: bool = False) -> FusedState:
        """One fused dispatch's operands (:meth:`_dispatch_rows`), loaded
        into the bucket's :class:`FusedState`; ``hist`` also loads each
        row's drafter window (:meth:`_history_rows`)."""
        bb, host, max_blocks = self._dispatch_rows(uids, k, budgets, seed)
        kb = self._table_width(max_blocks)
        host["tables"] = host["tables"][:, :kb]
        if hist:
            host["hist"] = self._history_rows(uids, bb)
        state = self._fused_state(bb, kb, k)
        state.load(**host)
        return state

    def _history_rows(self, uids: list[int], bb: int) -> np.ndarray:
        """Right-aligned recent-token rows [bb, history_window] for the
        prompt-lookup drafter, -1-filled (pad rows all -1): each uid's
        committed history with its pending token, so drafts continue from
        the next dispatch input."""
        hw = int(self._config.speculative.history_window)
        hist = np.full((bb, hw), -1, np.int64)
        for i, u in enumerate(uids):
            hist[i] = self.state_manager.history_tail(u, hw)
        return hist

    def _reserve_spec(self, uids: list[int], k: int,
                      budgets: dict[int, int]) -> None:
        """Reserve the speculative horizon: a K-tick spec dispatch may
        commit ``k * (1 + draft_len)`` tokens a row (capped by the
        budget; drafts are clamped to ``remaining - 1`` on the device, so
        KV writes never pass it)."""
        el = int(self._config.speculative.draft_len)
        for u in uids:
            self.state_manager.reserve(
                u, max(min(int(budgets[u]), k * (1 + el)), 1))

    def _spec_operands(self, uids: list[int], k: int,
                       budgets: dict[int, int], seed: int) -> FusedState:
        """:meth:`_fused_operands` with the drafter's history window, over
        the speculative horizon (:meth:`_reserve_spec`)."""
        self._reserve_spec(uids, k, budgets)
        return self._fused_operands(uids, k, budgets, seed, hist=True)

    def _fused_eager(self, state: FusedState, num_steps: int,
                     **loop_kw) -> None:
        """``num_steps`` ticks of the fused loop run eagerly over
        ``state``: the CPU's dispatch, and on the card the yardstick a
        captured graph is held against."""
        fused_decode_loop(
            self.model, self.pools, state.tokens, state.pos, state.tables,
            state.active, state.remaining, state.row_keys,
            num_steps=num_steps, out=state.out[:, :num_steps],
            steps=state.steps, logits_out=state.logits, **loop_kw)

    def _spec_eager(self, state: FusedState, num_steps: int,
                    **loop_kw) -> None:
        """``num_steps`` ticks of the speculative loop run eagerly over
        ``state`` (as :meth:`_fused_eager`)."""
        width = num_steps * (1 + state.draft_len)
        fused_spec_decode_loop(
            self.model, self.pools, state.tokens, state.pos, state.tables,
            state.active, state.remaining, state.row_keys, state.hist,
            num_steps=num_steps, draft_len=state.draft_len,
            out=state.out[:, :width + 1], out_ptr=state.out_ptr,
            steps=state.steps, spec_stats=state.spec_stats, **loop_kw)

    def _serve_eager(self, state: RingState, num_steps: int,
                     **loop_kw) -> None:
        """One ring-mode dispatch of ``num_steps`` ticks run eagerly over
        ``state`` (plain or speculative by its layout); its steps are
        added to the chain's."""
        s = state
        args = (self.model, self.pools, s.tokens, s.pos, s.tables, s.active,
                s.remaining, s.row_keys)
        if s.draft_len:
            fused_spec_serve_loop(
                *args, s.hist, s.epoch, s.stage_tokens, s.stage_pos,
                s.stage_rem, s.stage_keys, s.stage_tables, s.stage_hist,
                s.stage_valid, s.ring, s.ring_epochs, s.ring_ptr,
                s.spec_stats, num_steps=num_steps, draft_len=s.draft_len,
                steps=s.steps, **loop_kw)
        else:
            fused_serve_loop(
                *args, s.epoch, s.stage_tokens, s.stage_pos, s.stage_rem,
                s.stage_keys, s.stage_tables, s.stage_valid, s.ring,
                s.ring_epochs, s.ring_ptr, num_steps=num_steps,
                steps=s.steps, **loop_kw)
        s.chain_steps.add_(s.steps)

    def _dispatch_fn(self, mode: str, state, num_steps: int, eager,
                     result, loop_kw: dict):
        """The dispatch function of ``num_steps`` ticks of ``eager``'s
        loop over ``state`` for one setting (``loop_kw``): it runs them
        and returns ``result()``. Cached in ``state.graphs`` by mode,
        ticks and setting. On the card it replays a graph captured at its
        first call (and raises if capture or replay fails); on the CPU it
        runs the loop eagerly.

        The loops take ``num_steps`` = K, whatever the rows' budgets: a
        graph runs every tick it holds, and one a tick count would make
        an open-loop server, whose budgets take any value, capture up to
        K graphs a bucket (~0.3-1.4 s each on the card), where the JAX
        engine compiles one executable a (bucket, K). A tick with no live
        row writes nothing and is not counted; on the CPU the loop stops
        there."""
        key = (mode, num_steps, *loop_kw.values())
        fn = state.graphs.get(key)
        if fn is not None:
            return fn
        if state.device.type == "cuda":
            if getattr(self.model, "moe_serving_dispatch", False):
                raise NotImplementedError(GROUPED_UNCAPTURED)
            graph = CapturedLoop(
                state, lambda st: eager(st, num_steps, **loop_kw),
                lambda st: eager(st, 1, **loop_kw))
            self.graph_captures.append(dict(
                mode=mode, bb=state.bb, kb=state.kb, k=num_steps,
                sampling=[loop_kw[n] for n in ("temperature", "top_k",
                                               "top_p", "eos_id")],
                **graph.stats))

            def fn():
                graph.replay()
                return result()
        else:
            def fn():
                eager(state, num_steps, **loop_kw)
                return result()
        state.graphs[key] = fn
        return fn

    def _spec_kw(self) -> dict:
        return dict(min_ngram=int(self._config.speculative.min_ngram))

    def _fused_fn(self, state: FusedState, num_steps: int,
                  temperature: float, top_k: int, top_p: float,
                  eos_id: Optional[int]):
        """The dispatch function of ``num_steps`` fused decode ticks over
        ``state``'s bucket for one sampling setting; it returns their
        :class:`~.fused_graph.FusedResult` (see :meth:`_dispatch_fn`)."""
        return self._dispatch_fn(
            "decode", state, num_steps, self._fused_eager,
            lambda: state.result(num_steps),
            dict(eos_id=eos_id, temperature=temperature, top_k=top_k,
                 top_p=top_p))

    def _spec_fn(self, state: FusedState, num_steps: int,
                 temperature: float, top_k: int, top_p: float,
                 eos_id: Optional[int]):
        """:meth:`_fused_fn` for the speculative loop (JAX ``_spec_fn``):
        one graph family a (bucket, ticks, draft_len, min_ngram,
        sampling, eos); the result holds ``num_steps * (1 + draft_len)``
        output columns, the per-row pointers and the spec counters."""
        width = num_steps * (1 + state.draft_len)
        return self._dispatch_fn(
            f"spec{state.draft_len}", state, num_steps, self._spec_eager,
            lambda: state.result(width),
            dict(eos_id=eos_id, temperature=temperature, top_k=top_k,
                 top_p=top_p, **self._spec_kw()))

    def _serve_fn(self, state: RingState, num_steps: int,
                  temperature: float, top_k: int, top_p: float,
                  eos_id: Optional[int]):
        """The ring-mode dispatch function (JAX ``_serve_fn``): ``num_steps``
        ticks of ``paged.fused_serve_loop`` over ``state``; the results
        stay on the device for the chain's one read
        (:meth:`~.fused_graph.RingState.read`)."""
        return self._dispatch_fn(
            "serve", state, num_steps, self._serve_eager, lambda: None,
            dict(eos_id=eos_id, temperature=temperature, top_k=top_k,
                 top_p=top_p))

    def _spec_serve_fn(self, state: RingState, num_steps: int,
                       temperature: float, top_k: int, top_p: float,
                       eos_id: Optional[int]):
        """:meth:`_serve_fn` for ``paged.fused_spec_serve_loop`` (JAX
        ``_spec_serve_fn``)."""
        return self._dispatch_fn(
            f"spec_serve{state.draft_len}", state, num_steps,
            self._serve_eager, lambda: None,
            dict(eos_id=eos_id, temperature=temperature, top_k=top_k,
                 top_p=top_p, **self._spec_kw()))

    def decode_fused(self, batch_uids: Sequence[int],
                     k_steps: Optional[int] = None, *,
                     budgets: Optional[dict[int, int]] = None,
                     temperature: Optional[float] = None,
                     top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     eos_id: Optional[int] = None,
                     seed: int = 0) -> dict[int, list[int]]:
        """ONE fused dispatch: advance every uid up to ``min(k_steps,
        budgets[uid])`` ticks on the device, with forward, sampling, KV
        writes and EOS/budget termination in the loop. Each uid needs
        exactly one pending token (e.g. from put() and a sampled
        continuation, or a previous decode_fused). The generated tokens
        are committed; the last stays pending as the next dispatch's
        input. Returns {uid: [sampled tokens]} (a row that sampled
        ``eos_id`` includes it and stops). The dispatch runs ``k_steps``
        ticks whatever the budgets (:meth:`_dispatch_fn`). With
        ``speculative.enabled`` each tick drafts and verifies
        (``paged.fused_spec_decode_loop``) and commits 1..1 + draft_len
        tokens a row, budget-capped."""
        uids = [int(u) for u in batch_uids]
        if not uids:
            return {}
        cfg = self._config
        k = max(1, int(k_steps if k_steps is not None
                       else (cfg.fused_decode_steps or 8)))
        temperature, top_k, top_p, eos = self._sampling_args(
            temperature, top_k, top_p, eos_id)
        b = {u: int(budgets[u]) if budgets is not None else k
             for u in uids}
        st = self.serving_stats
        spec = cfg.speculative.enabled
        if spec:
            state = self._spec_operands(uids, k, b, seed)
            run = self._spec_fn(state, k, temperature, top_k, top_p, eos)
        else:
            state = self._fused_operands(uids, k, b, seed)
            run = self._fused_fn(state, k, temperature, top_k, top_p, eos)
        st["host_dispatches"] += 1
        st["fused_dispatches"] += 1
        result = run()
        toks, steps = result.read()
        if spec:
            ptrs, spec_stats = result.spec()
            self._absorb_spec_stats(spec_stats)
        mgr = self.state_manager
        res: dict[int, list[int]] = {}
        for i, u in enumerate(uids):
            row = [int(t) for t in (toks[i, :ptrs[i]] if spec else toks[i])
                   if t >= 0]
            mgr.commit_device_tokens(u, row)
            res[u] = row
            st["decoded_tokens"] += len(row)
            st["fused_slot_tokens"] += len(row)
            if not spec:
                # one token a live slot; the spec loop counts its live
                # slots on the device
                st["fused_live_slots"] += len(row)
        st["fused_steps"] += steps
        st["fused_slots"] += steps * len(uids)
        return res

    def _absorb_spec_stats(self, stats) -> None:
        """Fold a dispatch's (or a chain's) device spec counters,
        [proposed, accepted, hit slots, live slots], into
        serving_stats."""
        self.serving_stats["spec_proposed_tokens"] += int(stats[0])
        self.serving_stats["spec_accepted_tokens"] += int(stats[1])
        self.serving_stats["spec_hit_slots"] += int(stats[2])
        self.serving_stats["fused_live_slots"] += int(stats[3])

    # ------------------------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 eos_id: Optional[int] = None) -> list[list[int]]:
        """Greedy continuous batching over schedule()/tick(): admits
        prompts as KV blocks free up (each reserves its worst-case block
        budget, so live sequences never exhaust the pool mid-decode) and
        decodes all live sequences together each tick. ``eos_id`` stops a
        sequence once it emits that token (included in its output)."""
        mgr = self.state_manager
        bs = mgr.block_size
        pending = list(enumerate([list(map(int, p)) for p in prompts]))
        live: dict[int, list[int]] = {}
        reserved: dict[int, int] = {}   # uid -> worst-case block budget
        results: dict[int, list[int]] = {}
        max_live = self._config.max_ragged_sequence_count

        def admit():
            batch: list[tuple[int, list[int]]] = []
            allocated = sum(len(mgr.seqs[u].blocks) for u in live)
            headroom = (mgr.available_blocks
                        - (sum(reserved.values()) - allocated))
            while pending and len(live) + len(batch) < max_live:
                uid, prompt = pending[0]
                need = -(-(len(prompt) + max_new_tokens) // bs)
                if need > mgr.max_blocks_per_seq or \
                        need > mgr.allocator.num_blocks:
                    raise ValueError(
                        f"prompt {uid}: {len(prompt)} tokens + "
                        f"{max_new_tokens} new can never fit the KV pool "
                        f"(needs {need} blocks)")
                cost = mgr.admission_cost(prompt, need)
                if cost > headroom:
                    break
                pending.pop(0)
                headroom -= cost
                reserved[uid] = need
                batch.append((uid, prompt))
            if batch:
                self.schedule([u for u, _ in batch], [p for _, p in batch])
                for uid, _ in batch:
                    live[uid] = []

        try:
            admit()
            while live or pending:
                if not live:
                    admit()
                    if not live:  # reservation math guarantees progress
                        raise RuntimeError(
                            "continuous-batching deadlock: pending "
                            "prompts but nothing admissible")
                    continue
                finished = self.tick()
                ours = []
                for u in sorted(finished):
                    if u in live:
                        ours.append(u)
                    else:
                        # not ours (scheduled by another caller): re-stash
                        self._finished_stash[u] = finished[u]
                # one host sync per tick for every finished row's argmax
                nxt = (torch.stack([finished[u] for u in ours])
                       .argmax(dim=-1).tolist() if ours else [])
                decode_uids: list[int] = []
                for u, tok in zip(ours, nxt):
                    live[u].append(tok)
                    self.serving_stats["decoded_tokens"] += 1
                    if (len(live[u]) >= max_new_tokens
                            or (eos_id is not None and tok == eos_id)):
                        results[u] = live.pop(u)[:max_new_tokens]
                        reserved.pop(u)
                        self.flush(u)
                    else:
                        decode_uids.append(u)
                if decode_uids:
                    self.schedule(decode_uids,
                                  [[live[u][-1]] for u in decode_uids],
                                  do_checks=False)  # blocks pre-reserved
                admit()
        except BaseException:
            # an error mid-drive must not strand the already-scheduled
            # sequences' KV blocks on a shared engine
            for u in list(live):
                self.flush(u)
            raise
        return [results[i] for i in range(len(prompts))]

    # ------------------------------------------------------------------
    def generate_fused(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 32, *,
                       k_steps: Optional[int] = None,
                       temperature: Optional[float] = None,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None,
                       eos_id: Optional[int] = None,
                       seed: int = 0) -> list[list[int]]:
        """Continuous batching where the host is only an admission layer:
        every live sequence advances up to K tokens a dispatch inside the
        fused device loop (sampling, KV writes and EOS/budget termination
        there), so decode pays one host round trip per K tokens.

        Between dispatches the host admits new prompts, prefills them and
        drains finished tokens. Dispatches chain up to
        ``max_inflight_dispatches`` deep: the loop's carry stays on the
        device, so dispatch N+1 needs no host read of dispatch N, and the
        host drains the oldest while newer ones run. Greedy decode gives
        generate()'s tokens; stochastic decode is keyed by (seed, uid,
        position), so the tokens do not depend on K.

        With ``fused_admission`` the chain goes further on the device:
        waiting prompts are pre-staged and swapped into finished rows
        inside the loop, and the host reads one output ring a chain. With
        ``speculative.enabled`` each tick drafts and verifies up to
        ``draft_len`` tokens a row, in either mode.

        The scheduler is :class:`~.serve_loop.FusedServeLoop`, run
        closed-loop over a fixed prompt list."""
        from .serve_loop import FusedServeLoop
        loop = FusedServeLoop(self, k_steps=k_steps,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p, eos_id=eos_id, seed=seed,
                              strict=True)
        results: dict[int, list[int]] = {}
        for i, p in enumerate(prompts):
            loop.submit(p, max_new_tokens, uid=i)
            results[i] = []
        while loop.has_work():
            for evt in loop.step():
                results[evt.uid].extend(evt.tokens)
        return [results[i][:max_new_tokens]
                for i in range(len(prompts))]
