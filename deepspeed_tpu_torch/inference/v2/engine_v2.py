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
from ...utils.logging import log_dist
from ..config import DeepSpeedInferenceConfig
from ...runtime.config_utils import DeepSpeedConfigModel
from .paged import paged_forward
from .ragged import DSStateManager, SequenceDescriptor, kv_block_bytes


@dataclasses.dataclass
class PrefixCacheConfig(DeepSpeedConfigModel):
    """Automatic prefix caching; not ported yet (``enabled`` raises)."""
    enabled: bool = False
    min_match_blocks: int = 1
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
    """Quantized KV cache; not ported yet (``enabled`` raises)."""
    enabled: bool = False
    dtype: str = "int8"
    granularity: str = "head"
    grow_pool: bool = True


@dataclasses.dataclass
class RaggedInferenceEngineConfig(DeepSpeedInferenceConfig):
    """reference: inference/v2/config_v2.py RaggedInferenceEngineConfig —
    the fields this slice serves with, plus the feature switches it
    refuses."""
    kv_block_size: int = 64
    num_kv_blocks: int = 256
    max_ragged_sequence_count: int = 32
    max_chunk_size: int = 256             # prefill chunk (SplitFuse budget)
    eos_token_id: Optional[int] = None
    fused_admission: bool = False
    kv_cache: KVCacheConfig = dataclasses.field(
        default_factory=KVCacheConfig)
    prefix_cache: PrefixCacheConfig = dataclasses.field(
        default_factory=PrefixCacheConfig)
    speculative: SpeculativeConfig = dataclasses.field(
        default_factory=SpeculativeConfig)


def _refuse_unported(config: RaggedInferenceEngineConfig) -> None:
    """Raise on every configured feature this slice does not implement,
    naming its ROADMAP item, instead of serving something else."""
    unported = [
        (config.tensor_parallel.tp_size > 1, "tensor_parallel.tp_size > 1",
         "tensor-parallel serving"),
        (config.kv_cache.enabled, "kv_cache.enabled", "quantized KV cache"),
        (config.prefix_cache.enabled, "prefix_cache.enabled",
         "prefix cache in the engine"),
        (config.speculative.enabled, "speculative.enabled",
         "speculative decoding"),
        (config.fused_admission, "fused_admission",
         "fused decode loops and sampling"),
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
        if self.device.type == "cuda" and self.dtype not in (
                torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"dtype {self.dtype} on CUDA: the paged-attention kernel "
                "takes float32 or bfloat16")
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
        nb = config.num_kv_blocks
        self.num_kv_blocks = nb
        self.state_manager = DSStateManager(
            block_size=bs, num_blocks=nb,
            max_blocks_per_seq=-(-c.max_seq_len // bs))
        # logits of sequences finished as a side effect of another
        # caller's drain loop, held for their owner's next tick()
        self._finished_stash: dict[int, torch.Tensor] = {}
        # zero-initialized: dead pool slots hold zeros (paged.py relies
        # on nothing else being there)
        pool_shape = (c.num_layers, nb, bs, c.num_kv_heads, c.head_dim)
        self.pools = {"k": torch.zeros(pool_shape, dtype=self.dtype,
                                       device=self.device),
                      "v": torch.zeros(pool_shape, dtype=self.dtype,
                                       device=self.device)}
        self.serving_stats = {"host_dispatches": 0, "decoded_tokens": 0}
        # SplitFuse budget, floored to a power of two as in the JAX engine
        self._chunk = 1 << (max(1, config.max_chunk_size).bit_length() - 1)
        pool_mib = kv_block_bytes(bs, c.num_kv_heads, c.head_dim,
                                  self.pools["k"].element_size()) \
            * nb * c.num_layers / 2**20
        log_dist(f"InferenceEngineV2: {nb} KV blocks x {bs} tokens "
                 f"({pool_mib:.1f} MiB, kv dtype {self.dtype}) on "
                 f"{self.device}")

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
        if do_checks:
            # cumulative admission over the whole batch, so a failure
            # raises before any state mutation
            need = 0
            for u, toks in zip(uids, batch_tokens):
                seq = mgr.seqs.get(u)
                seq_blocks = len(seq.blocks) if seq else 0
                seq_need = mgr.blocks_needed(
                    seq or SequenceDescriptor(uid=u, tokens=[]), len(toks))
                if seq_blocks + seq_need > mgr.max_blocks_per_seq:
                    raise RuntimeError(
                        f"sequence {u} would exceed the max length "
                        f"({mgr.max_blocks_per_seq * mgr.block_size} "
                        f"tokens)")
                need += seq_need
            if need > mgr.available_blocks:
                raise RuntimeError(
                    f"cannot schedule batch: needs {need} KV blocks, "
                    f"{mgr.available_blocks} allocatable — the pool "
                    "is exhausted (flush finished sequences)")
        for u, toks in zip(uids, batch_tokens):
            mgr.extend(u, list(map(int, toks)))
            # re-admission invalidates logits stashed when this uid
            # finished during another caller's drain
            self._finished_stash.pop(u, None)

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
