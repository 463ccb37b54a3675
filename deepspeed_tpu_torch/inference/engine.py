"""Inference engine v1 (counterpart of ``deepspeed_tpu/inference/engine.py``
``InferenceEngine``; reference: deepspeed/inference/engine.py
InferenceEngine:41 — checkpoint load:326, forward:579, _generate with the
sequence-length guard:608).

The model runs where its parameters live (the card unless the caller built
it with ``device="cpu"``), cast to the config's dtype. ``generate`` is a
prefill and then a decode loop over the static KV cache of
``DecoderLM.init_cache``/``decode``, whose attention is the plain
``ops.layers.cached_attention`` as in the JAX engine (XLA there, no Pallas
kernel); the norms run through the norm kernels on the card. The cache
index, the key, the next token and a step counter live on the device, so
nothing of a step is read back to the host: as JAX compiles ``generate``
into one program, the port captures the decode step (the forward, the
key's split, the draw, the token's write) as one CUDA graph and replays
it ``max_new - 1`` times after an eager prefill (:class:`GenerateState`,
``inference/graphs.py``); on the CPU the same step runs eagerly. No shape
of the step depends on the prompt's length or on ``max_new`` apart from
the cache's length, so a state and its graph serve every call of one
batch size and sampling whose prompt and new tokens fit one cache
length (:meth:`InferenceEngine.cache_bucket`: 2^k or 3 * 2^(k-1));
the engine keeps the last call's state only, and drops it (its cache and
its graph's pool) when a call needs another. Sampling follows the JAX
engine's keys (``PRNGKey(seed)``, one ``split`` before each draw) and
filters (temperature, top-k, top-p) through ``ops/threefry.py`` and
``ops/sampling.py``, with the temperature's reciprocal rounding of JAX's
compiled loop.

Weight-only int8 (``quantize_weights``, JAX :69-80): every leaf that
``linear.quantization.quantize_dense_params`` takes becomes int8 codes and
per-output-channel scales before the cast, leaf by leaf
(``models/convert.py`` ``load_serving_params``), and the model dequantizes
one layer at a time where it reads it; a ``params`` tree that already
holds ``name_q`` / ``name_s`` pairs is taken as it is. ``dtype="int8"``
raises JAX's own error: int8 serving is weight-only.

MoE (mixtral, qwen2_moe, JAX :92-142): ``quantize_moe_experts`` makes the
routed experts int8 (``moe.quantize_experts`` on the cast weights, scales
in the serving dtype, a layer at a time), and ``moe_grouped_dispatch``
serves through the grouped form (``moe_ffn_grouped``: exact top-k, no
capacity) instead of the capacity form. The flag is set on the engine's
own shallow copy of the model (:func:`serving_model`), never on the
shared instance.

``config.checkpoint`` is a ``save_16bit_model`` ``.npz`` or a training
engine's checkpoint directory (``<save_dir>`` through its ``latest``, or
``<save_dir>/<tag>``): its parameters, read a leaf at a time
(:func:`load_checkpoint_params`, which the v2 engine shares).

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP item: ``tensor_parallel.tp_size > 1`` (Slice D item 12; with
``quantize_weights``, ``quantize_moe_experts`` or ``moe_grouped_dispatch``
JAX's own refusals), a checkpoint directory of the JAX package's memory
tiers (``host_opt_rank*.npz``, Slice E).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Optional

import numpy as np
import torch

from ..models.base import ModelConfig
from ..models.convert import Deferred, load_serving_params
from ..ops import sampling, threefry
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig
from .graphs import CapturedLoop

PyTree = Any


INT8_DTYPE_MESSAGE = (
    "dtype='int8' is not a blanket cast; use "
    "quantize_moe_experts=True (routed experts) or "
    "linear.QuantizedParameter (dense weights) for "
    "weight-only int8 with scales")
QUANTIZE_TP_MESSAGE = (
    "quantize_weights is a single-replica serving path "
    "(quantized leaves bypass the tp rule tables); "
    "shard OR quantize, not both")
MOE_TP_MESSAGES = {
    "quantize_moe_experts": (
        "quantize_moe_experts is a single-replica serving path (quantized "
        "expert leaves bypass the tp rule tables); shard OR quantize, not "
        "both"),
    "moe_grouped_dispatch": (
        "moe_grouped_dispatch is a single-replica serving path (the "
        "grouped GEMM bypasses the ep/tp all-to-all dispatch); shard OR "
        "group, not both")}


def _refuse_unported(config: DeepSpeedInferenceConfig) -> None:
    if config.torch_dtype == torch.int8:
        # blanket-casting float weights to int8 would truncate them; int8
        # serving is weight-only quantization with scales (JAX's error)
        raise NotImplementedError(INT8_DTYPE_MESSAGE)
    if config.quantize_weights and config.tensor_parallel.tp_size > 1:
        raise NotImplementedError(QUANTIZE_TP_MESSAGE)
    refuse_moe_tp(config)
    if max(1, config.tensor_parallel.tp_size) > 1:
        raise NotImplementedError(
            f"tensor_parallel.tp_size {config.tensor_parallel.tp_size}: "
            "tensor-parallel serving is not ported yet (ROADMAP Slice D "
            "item 12)")


def refuse_moe_tp(config) -> None:
    """JAX's refusals of the MoE serving switches under tensor parallelism
    (raised before the port's own refusal of tp > 1)."""
    if config.tensor_parallel.tp_size > 1:
        for name, message in MOE_TP_MESSAGES.items():
            if getattr(config, name):
                raise NotImplementedError(message)


def load_weights(model, params, config, dtype, device) -> None:
    """The serving weights, as the JAX engine builds its tree: ``params``
    (a JAX-layout tree or flat mapping) or drawn from ``config.seed``;
    weight-only int8 per ``config.quantize_weights`` or a pre-quantized
    tree, leaf by leaf; the routed experts int8 per
    ``config.quantize_moe_experts``; every float leaf in the serving
    ``dtype``."""
    gen = (torch.Generator(device=device).manual_seed(config.seed)
           if params is None else None)
    load_serving_params(model, params, gen, dtype,
                        quantize=config.quantize_weights,
                        quantize_experts=config.quantize_moe_experts)


def serving_model(model, config):
    """The module an engine serves: ``model`` itself, or for an MoE model
    a shallow copy (sharing its parameters) whose ``moe_serving_dispatch``
    is ``config.moe_grouped_dispatch`` and whose training-engine dispatcher
    and telemetry are stripped, as the JAX engine binds the flag to its own
    copy so that a later engine's mode never leaks into an earlier one's."""
    if not hasattr(model, "moe_serving_dispatch"):
        return model
    module = copy.copy(model)
    module.moe_serving_dispatch = bool(config.moe_grouped_dispatch)
    module.moe_dispatcher = None
    module.moe_router_telemetry = False
    return module


def load_checkpoint_params(path: str) -> PyTree:
    """The parameters of ``path`` (reference: load_checkpoint:326): a
    save_16bit_model ``.npz`` (names are the tree's "/"-joined paths), or
    an engine checkpoint directory, ``<save_dir>`` (its ``latest`` tag) or
    ``<save_dir>/<tag>``, as a flat mapping of
    :class:`~..models.convert.Deferred` leaves, each assembled from the
    ranks' files in the compute dtype it was trained in when the loader
    reaches it (JAX reads ``state["params"]``)."""
    if path.endswith(".npz"):
        with np.load(path) as flat:
            params: dict = {}
            for name in flat.files:
                node = params
                *parents, last = name.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[last] = flat[name]
        return params
    from ..runtime.checkpoint_engine import ShardedCheckpoint, check_tag_dir
    from ..runtime.checkpointing import find_tag
    if not os.path.isdir(os.path.join(path, "state")):
        tag = find_tag(path, None)
        if tag is None:
            raise FileNotFoundError(
                f"checkpoint {path!r}: neither a .npz nor a checkpoint "
                f"directory with a 'latest' file or a state/ directory")
        path = os.path.join(path, tag)
    check_tag_dir(path)
    ckpt = ShardedCheckpoint(os.path.join(path, "state"))
    return {key[len("params/"):]: Deferred(lambda key=key: ckpt.full(key))
            for key in ckpt.keys() if key.startswith("params/")}


class GenerateState:
    """A generate call's tensors at fixed addresses on the model's device:
    the KV cache of ``model.init_cache`` (its index a 0-dim device
    tensor), the token fed to the next step ``tok`` [B], the threefry key
    ``key`` [2] (JAX's carry), the output tokens ``out`` [B, max_new]
    (``max_new`` the most new tokens a call may write) and the device step
    counter ``step_index`` (the next column of ``out``); ``graph`` its
    captured decode step (None until the first replayed call); the calls
    that fit it reuse it. :meth:`prefill` loads a call's prompt and first
    token; :meth:`step` is the decode step a graph captures."""

    def __init__(self, model, b: int, cache_len: int, max_new: int, dtype,
                 device, sampling: dict):
        self.model, self.sampling = model, sampling
        self.device = torch.device(device)
        self.cache = model.init_cache(b, cache_len, dtype=dtype)
        self.tok = torch.zeros(b, dtype=torch.int64, device=self.device)
        self.key = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.out = torch.zeros((b, max_new), dtype=torch.int64,
                               device=self.device)
        self.step_index = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        self.graph = None

    def idle_copy(self):
        """A copy over cloned tensors: a step over it (a capture's warm-up)
        leaves this state as it is."""
        idle = copy.copy(self)
        idle.cache = {n: t.clone() for n, t in self.cache.items()}
        for name in ("tok", "key", "out", "step_index"):
            setattr(idle, name, getattr(self, name).clone())
        idle.graph = None
        return idle

    def _advance(self, logits: torch.Tensor, index: torch.Tensor) -> None:
        """After a forward: the cache's new index, one ``split`` of the key
        (JAX's), the next token sampled with the split-off key and written
        at ``out[:, step]``, the step counter advanced; in place, with no
        host read."""
        self.cache["index"].copy_(index)
        key, sub = threefry.split(self.key)
        s = self.sampling
        logits = logits[:, -1, :].float()
        if s["greedy"]:
            nxt = sampling.sample_tokens(logits, greedy=True)
        else:
            # temperature 1 leaves the logits as they are (JAX divides
            # only when it is not 1); the rest as JAX's compiled loop
            nxt = sampling.sample_tokens(
                logits, sub, temperature=s["temperature"],
                top_k=s["top_k"], top_p=s["top_p"], reciprocal=True)
        self.key.copy_(key)
        self.tok.copy_(nxt)
        self.out.index_copy_(1, self.step_index.view(1), nxt[:, None])
        self.step_index.add_(1)

    def prefill(self, tokens: torch.Tensor, key: torch.Tensor) -> None:
        """A call's start: the cache cleared, the prompt's forward, the
        first token sampled from ``key``."""
        for t in (self.cache["k"], self.cache["v"], self.cache["index"],
                  self.out, self.step_index):
            t.zero_()
        self.key.copy_(key)
        logits, cache = self.model.decode(tokens, self.cache)
        self._advance(logits, cache["index"])

    def step(self) -> None:
        """One decode step: the last token's forward over the cache, then
        :meth:`_advance`."""
        logits, cache = self.model.decode(self.tok[:, None], self.cache)
        self._advance(logits, cache["index"])


class InferenceEngine:
    """reference: inference/engine.py:41"""

    def __init__(self, model, config: DeepSpeedInferenceConfig,
                 params: Optional[PyTree] = None):
        _refuse_unported(config)
        self._config = config
        self.dtype = config.torch_dtype
        self.device = model.device
        if params is None and config.checkpoint:
            params = load_checkpoint_params(config.checkpoint)
        load_weights(model, params, config, self.dtype, self.device)
        model.eval()
        self.module = serving_model(model, config)
        self.model_config: ModelConfig | None = getattr(model, "config",
                                                        None)
        self._cache_len = config.max_out_tokens
        # (key, GenerateState) of the last generate call, or None
        self._run: tuple | None = None
        self.graph_captures: list = []
        self.last_decode: dict = {}
        log_dist(f"InferenceEngine: tp=1 dtype={self.dtype} "
                 f"max_out_tokens={self._cache_len} on {self.device}")

    # ------------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        return t.to(self.device)

    @torch.no_grad()
    def forward(self, tokens, **kwargs) -> torch.Tensor:
        """Full-sequence logits (reference: forward:579)."""
        return self.module.apply(self._tokens(tokens))

    __call__ = forward

    def _check_lengths(self, prompt_len: int, max_new: int) -> int:
        cache_len = prompt_len + max_new
        # reference guard: _generate:608 rejects over-length sequences
        if cache_len > self._cache_len:
            raise ValueError(
                f"input+max_new_tokens ({cache_len}) exceeds "
                f"max_out_tokens ({self._cache_len}); raise max_out_tokens "
                "in the inference config")
        if (self.model_config is not None
                and cache_len > self.model_config.max_seq_len):
            raise ValueError(
                f"input+max_new_tokens ({cache_len}) exceeds the model "
                f"max_seq_len ({self.model_config.max_seq_len})")
        return cache_len

    def cache_bucket(self, cache_len: int) -> int:
        """The cache length a call of ``cache_len`` prompt and new tokens
        runs on: the next of 2^k and 3 * 2^(k-1) (a step reads the whole
        cache, so at most a third of it is past the call's tokens), at
        most ``max_out_tokens`` and the model's ``max_seq_len``. Positions
        past the call's are masked, so the tokens are those of a cache of
        ``cache_len``."""
        limit = self._cache_len
        if self.model_config is not None:
            limit = min(limit, self.model_config.max_seq_len)
        bucket = 1 << (cache_len - 1).bit_length()
        if cache_len <= 3 * bucket // 4:
            bucket = 3 * bucket // 4
        return min(bucket, limit)

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, do_sample: bool = False,
                 seed: int = 0, **kwargs) -> torch.Tensor:
        """Autoregressive generation (reference: _generate:608; JAX
        compiles the loop into one program): the prompt as one prefill,
        then ``max_new_tokens - 1`` decode steps, on the card each a
        replay of one CUDA graph of :meth:`GenerateState.step` (captured
        at the first call of a batch size, sampling and cache length
        after a call of another; a capture that fails raises), on the CPU
        the same step run eagerly. Greedy unless ``do_sample``; top_p enables
        nucleus sampling (composes with top_k and temperature). Returns
        [B, prompt + max_new_tokens] token ids, the prompt first."""
        return self._generate(tokens, max_new_tokens, temperature, top_k,
                              top_p, do_sample, seed, graph=True)

    @torch.no_grad()
    def _generate_eager(self, tokens, max_new_tokens: int = 32,
                        temperature: float = 1.0, top_k: int = 0,
                        top_p: float = 0.0, do_sample: bool = False,
                        seed: int = 0) -> torch.Tensor:
        """:meth:`generate` with every decode step run eagerly on the same
        state, on the card too: the yardstick its graphs are held to."""
        return self._generate(tokens, max_new_tokens, temperature, top_k,
                              top_p, do_sample, seed, graph=False)

    def _generate(self, tokens, max_new, temperature, top_k, top_p,
                  do_sample, seed, graph: bool) -> torch.Tensor:
        tokens = self._tokens(tokens)
        if tokens.dim() == 1:
            tokens = tokens[None, :]
        b, prompt_len = tokens.shape
        bucket = self.cache_bucket(self._check_lengths(prompt_len, max_new))
        key = (b, bucket, temperature, top_k, top_p, not do_sample)
        if self._run is None or self._run[0] != key:
            self._run = None            # the old cache and graph go first
            self._run = (key, GenerateState(
                self.module, b, bucket, bucket, self.dtype, self.device,
                sampling=dict(temperature=temperature, top_k=top_k,
                              top_p=top_p, greedy=not do_sample)))
        run = self._run[1]
        run.prefill(tokens, threefry.prng_key(seed, device=self.device))
        steps = max_new - 1
        self.last_decode = dict(steps=steps, events=None, graph=None,
                                captured=False)
        if steps and self.device.type == "cuda" and graph:
            if run.graph is None:
                run.graph = CapturedLoop(run, GenerateState.step,
                                         GenerateState.step)
                self.graph_captures.append(dict(
                    batch=b, cache_len=bucket, prompt_len=prompt_len,
                    max_new=max_new, greedy=not do_sample,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    **run.graph.stats))
                self.last_decode["captured"] = True
            events = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            events[0].record()
            for _ in range(steps):
                run.graph.replay()
            events[1].record()
            self.last_decode.update(events=events, graph=run.graph.stats)
        else:
            for _ in range(steps):
                run.step()
        return torch.cat([tokens, run.out[:, :max_new]], 1)

    def decode_ms_per_step(self) -> float | None:
        """The last graph-replayed :meth:`generate`'s decode steps, device
        ms a step between CUDA events around the replays (waits for them;
        None where the steps ran eagerly or there were none).
        ``last_decode`` also holds the step count, the replayed graph's
        stats (capture ms, pool MiB, launches a replay by wrapper and
        variant) and whether the call captured it."""
        events = self.last_decode.get("events")
        if not events:
            return None
        events[1].synchronize()
        return events[0].elapsed_time(events[1]) / self.last_decode["steps"]

    # --- reference-parity accessors -----------------------------------
    @property
    def config(self):
        return self._config

    def eval(self):
        return self

    def half(self):
        return self

    def to(self, *a, **k):
        return self
