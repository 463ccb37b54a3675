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
port drops the padding and keeps the token grouping: a row advances
``min(pending, chunk)`` tokens per tick.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...models.convert import load_jax_params
from ...ops.quantization import KV_STORE_DTYPES
from ...utils.logging import log_dist
from ..config import DeepSpeedInferenceConfig
from ...runtime.config_utils import DeepSpeedConfigModel
from .paged import KERNEL_DTYPES, paged_forward
from .ragged import (DSStateManager, PrefixCache, SequenceDescriptor,
                     kv_block_bytes, quantized_block_budget)


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
    # the fused decode loops' depth and in-graph sampling (JAX defaults)
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
    for names, item in (
            (("sampling_temperature", "sampling_top_k", "sampling_top_p"),
             "item 5, sampling"),
            (("fused_decode_steps", "max_inflight_dispatches"),
             "item 6, fused decode loops"),
            (("sentinels", "sentinel_mode", "graftsan", "meshsan", "numsan"),
             "item 15, sanitizers (Slice G)")):
        what = _off_default(config, names)
        if what is not None:
            raise NotImplementedError(
                f"{what} is not ported to deepspeed_tpu_torch yet "
                f"(ROADMAP.md, port Queue 1: {item})")
    unported = [
        (config.tensor_parallel.tp_size > 1, "tensor_parallel.tp_size > 1",
         "tensor-parallel serving"),
        (config.speculative.enabled, "speculative.enabled",
         "speculative decoding"),
        (config.fused_admission, "fused_admission",
         "item 6, fused decode loops and sampling"),
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
        self.serving_stats = {"host_dispatches": 0, "decoded_tokens": 0}
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
        """The serving counters, the prefix cache's counters and gauges
        (zeros when it is off), ``dispatches_per_token`` (host dispatches
        per decoded token) and the KV pool's footprint: ``kv_pool_bytes``,
        ``kv_bytes_per_token``, ``kv_num_blocks`` and ``kv_dtype``."""
        st = dict(self.serving_stats)
        st.update(self.state_manager.prefix_cache_metrics())
        st["dispatches_per_token"] = (
            st["host_dispatches"] / max(st["decoded_tokens"], 1))
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
