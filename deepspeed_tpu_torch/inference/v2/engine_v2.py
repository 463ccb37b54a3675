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
sampling on the device. It keeps the JAX engine's batch and table-width
buckets: on the card each (bucket, K, sampling setting) is one captured
CUDA graph over operands at fixed addresses (``fused_graph.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...models.convert import load_jax_params
from ...ops import sampling, threefry
from ...ops.quantization import KV_STORE_DTYPES
from ...utils.logging import log_dist
from ..config import DeepSpeedInferenceConfig
from ...runtime.config_utils import DeepSpeedConfigModel
from .fused_graph import CapturedLoop, FusedState
from .paged import KERNEL_DTYPES, fused_decode_loop, paged_forward
from .ragged import (DSStateManager, PrefixCache, SequenceDescriptor,
                     kv_block_bytes, quantized_block_budget)

# serving_metrics() schema, the JAX engine's: raw counters kept in
# serving_stats (reset zeroes exactly these); the prefix-cache counters
# ride alongside, and the ratios are appended at read time. The spec_*
# counters stay zero until speculative decoding is ported.
# fused_live_slots counts scheduled (row, step) slots whose row was still
# active, the occupancy numerator (one token a live slot).
SERVING_COUNTER_KEYS = (
    "host_dispatches", "fused_dispatches", "fused_steps", "fused_slots",
    "fused_slot_tokens", "fused_live_slots", "decoded_tokens",
    "spec_proposed_tokens", "spec_accepted_tokens", "spec_hit_slots")


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
    """Speculative decoding; not ported yet (``enabled`` raises)."""
    enabled: bool = False
    draft_len: int = 3
    min_ngram: int = 2
    history_window: int = 64


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
    unported = [
        (config.tensor_parallel.tp_size > 1, "tensor_parallel.tp_size > 1",
         "tensor-parallel serving"),
        (config.speculative.enabled, "speculative.enabled",
         "item 6, speculative decoding"),
        (config.fused_admission, "fused_admission",
         "item 6, ring mode (fused_serve_loop)"),
        (config.quantize_weights, "quantize_weights",
         "weight-only int8 serving"),
        (config.quantize_moe_experts, "quantize_moe_experts", "MoE serving"),
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
        self.model = model
        c = model.config
        self.device = next(iter(model.params.values())).device
        if self.dtype == torch.int8:
            raise NotImplementedError(
                "dtype='int8' is not a blanket cast (ROADMAP.md, port "
                "Queue 1: weight-only int8 serving)")
        if self.device.type == "cuda" and \
                self.dtype not in KERNEL_DTYPES:
            raise NotImplementedError(
                f"dtype {self.dtype} on CUDA: the paged-attention kernel "
                "takes float32, bfloat16 or float16")
        # params: given (a JAX-layout numpy tree) or drawn from the seed,
        # then cast to the serving dtype — what the JAX v1 engine does
        # for the v2 engine at tp=1
        with torch.no_grad():
            for name, p in list(model.params.items()):
                if p.dtype != self.dtype:
                    model.params[name] = nn.Parameter(p.to(self.dtype))
        if params is not None:
            load_jax_params(model, params)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            model.init_params(gen)

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
        # the fused loop: operands at fixed addresses per (batch bucket,
        # table-width bucket), dispatch functions (on the card captured
        # graphs) per bucket, step count and sampling setting, base keys
        # per seed, and each capture's cost
        self._fused_states: dict[tuple, FusedState] = {}
        self._fused_cache: dict[tuple, object] = {}
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
        [len(uids), V]."""
        mgr = self.state_manager
        seqs = [mgr.seqs[u] for u in uids]
        s = min(max(q.pending for q in seqs), self._chunk)
        tokens = np.zeros((len(seqs), s), np.int64)
        pos0 = np.zeros((len(seqs),), np.int32)
        true_len = np.zeros((len(seqs),), np.int32)
        for i, seq in enumerate(seqs):
            n = min(seq.pending, s)
            tokens[i, :n] = seq.tokens[seq.seen:seq.seen + n]
            pos0[i] = seq.seen
            true_len[i] = n
        # the block table narrowed to the live context
        live_blocks = -(-int((pos0 + true_len).max()) // mgr.block_size)
        tables = np.stack([mgr.block_table(q)[:live_blocks] for q in seqs])
        self.serving_stats["host_dispatches"] += 1
        dev = self.device
        logits, self.pools = paged_forward(
            self.model, self.pools, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(tables).to(dev),
            torch.from_numpy(true_len).to(dev))
        for i, seq in enumerate(seqs):
            seq.seen += int(true_len[i])
            mgr.publish_full_blocks(seq)
        return logits

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
        """The fixed-address operands of the (bb, kb) bucket, wide enough
        for ``k`` ticks (a wider one replaces it, with its graphs)."""
        state = self._fused_states.get((bb, kb))
        if state is None or state.max_steps < k:
            state = FusedState(
                bb, kb, max(k, self._config.fused_decode_steps),
                self.model.config.vocab_size, self.device,
                ring=self._config.max_inflight_dispatches + 1)
            self._fused_states[(bb, kb)] = state
            for key in [key for key in self._fused_cache
                        if key[:2] == (bb, kb)]:
                del self._fused_cache[key]
        return state

    def _fused_operands(self, uids: list[int], k: int,
                        budgets: dict[int, int], seed: int) -> FusedState:
        """Host-side build of one fused dispatch's operands, loaded into
        the bucket's :class:`FusedState`. Every uid must have exactly one
        pending token (its next input, the last sampled token); blocks
        covering the dispatch horizon are reserved here so the loop's KV
        writes land in real blocks."""
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
        # narrowed to the blocks held (context + reserved horizon), a
        # power-of-two width
        kb = min(_bucket(max(max(len(s.blocks) for s in seqs), 1)),
                 tables.shape[1])
        # per-row keys: the uid folded into the base key (pad rows get
        # sentinel ids); each tick folds in the token's position
        ids = list(uids) + [(1 << 30) + i for i in range(bb - len(uids))]
        row_keys = threefry.fold_in(self._base_key(seed),
                                    torch.tensor(ids, dtype=torch.int64))
        state = self._fused_state(bb, kb, k)
        state.load(tokens=tokens, pos=pos, tables=tables[:, :kb],
                   active=act, remaining=rem, row_keys=row_keys)
        return state

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

    def _fused_fn(self, state: FusedState, num_steps: int,
                  temperature: float, top_k: int, top_p: float,
                  eos_id: Optional[int]):
        """The dispatch function of ``num_steps`` ticks over ``state``'s
        bucket for one sampling setting: it runs them and returns their
        :class:`~.fused_graph.FusedResult`. Cached by (batch bucket,
        table-width bucket, ticks, temperature, top_k, top_p, eos). On the
        card it replays a graph captured at its first call (and raises if
        capture or replay fails); on the CPU it runs the loop eagerly."""
        key = (state.bb, state.kb, num_steps, temperature, top_k, top_p,
               eos_id)
        fn = self._fused_cache.get(key)
        if fn is not None:
            return fn
        loop_kw = dict(eos_id=eos_id, temperature=temperature, top_k=top_k,
                       top_p=top_p)
        if state.device.type == "cuda":
            graph = CapturedLoop(self.model, self.pools, state, num_steps,
                                 **loop_kw)
            self.graph_captures.append(dict(
                bb=state.bb, kb=state.kb, k=num_steps,
                sampling=[temperature, top_k, top_p, eos_id], **graph.stats))

            def fn():
                graph.replay()
                return state.result(num_steps)
        else:
            def fn():
                self._fused_eager(state, num_steps, **loop_kw)
                return state.result(num_steps)
        self._fused_cache[key] = fn
        return fn

    def decode_fused(self, batch_uids: Sequence[int],
                     k_steps: Optional[int] = None, *,
                     budgets: Optional[dict[int, int]] = None,
                     temperature: Optional[float] = None,
                     top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     eos_id: Optional[int] = None,
                     seed: int = 0) -> dict[int, list[int]]:
        """ONE fused dispatch: advance every uid up to ``min(k_steps,
        budgets[uid])`` tokens on the device, with forward, sampling, KV
        writes and EOS/budget termination in the loop. Each uid needs
        exactly one pending token (e.g. from put() and a sampled
        continuation, or a previous decode_fused). The generated tokens
        are committed; the last stays pending as the next dispatch's
        input. Returns {uid: [sampled tokens]} (a row that sampled
        ``eos_id`` includes it and stops). The dispatch runs
        ``min(k_steps, max budget)`` ticks, never more than a row can
        use."""
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
        state = self._fused_operands(uids, k, b, seed)
        run = self._fused_fn(state, min(k, max(max(b.values()), 1)),
                             temperature, top_k, top_p, eos)
        st["host_dispatches"] += 1
        st["fused_dispatches"] += 1
        toks, steps = run().read()
        mgr = self.state_manager
        res: dict[int, list[int]] = {}
        for i, u in enumerate(uids):
            row = [int(t) for t in toks[i] if t >= 0]
            mgr.commit_device_tokens(u, row)
            res[u] = row
            st["decoded_tokens"] += len(row)
            st["fused_slot_tokens"] += len(row)
            st["fused_live_slots"] += len(row)   # one token a live slot
        st["fused_steps"] += steps
        st["fused_slots"] += steps * len(uids)
        return res

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

        The scheduler is :class:`~.serve_loop.FusedServeLoop` in chain
        mode, run closed-loop over a fixed prompt list."""
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
