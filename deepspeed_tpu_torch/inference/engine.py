"""Inference engine v1 (counterpart of ``deepspeed_tpu/inference/engine.py``
``InferenceEngine``; reference: deepspeed/inference/engine.py
InferenceEngine:41 — checkpoint load:326, forward:579, _generate with the
sequence-length guard:608).

The model runs where its parameters live (the card unless the caller built
it with ``device="cpu"``), cast to the config's dtype. ``generate`` is a
prefill and then a decode loop over the static KV cache of
``DecoderLM.init_cache``/``decode``, whose attention is the plain
``ops.layers.cached_attention`` as in the JAX engine (XLA there, no Pallas
kernel); the norms run through the norm kernels on the card. The loop is
eager: one host step a token. Sampling follows the JAX engine's keys
(``PRNGKey(seed)``, one ``split`` before each draw) and filters
(temperature, top-k, top-p) through ``ops/threefry.py`` and
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

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP item: ``tensor_parallel.tp_size > 1`` (Slice D item 12; with
``quantize_weights``, ``quantize_moe_experts`` or ``moe_grouped_dispatch``
JAX's own refusals), an orbax checkpoint directory (Slice E item 13).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Optional

import numpy as np
import torch

from ..models.base import ModelConfig
from ..models.convert import load_serving_params
from ..ops import sampling, threefry
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig

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


class InferenceEngine:
    """reference: inference/engine.py:41"""

    def __init__(self, model, config: DeepSpeedInferenceConfig,
                 params: Optional[PyTree] = None):
        _refuse_unported(config)
        self._config = config
        self.dtype = config.torch_dtype
        self.device = model.device
        if params is None and config.checkpoint:
            params = self._load_checkpoint_params(config.checkpoint)
        load_weights(model, params, config, self.dtype, self.device)
        model.eval()
        self.module = serving_model(model, config)
        self.model_config: ModelConfig | None = getattr(model, "config",
                                                        None)
        self._cache_len = config.max_out_tokens
        log_dist(f"InferenceEngine: tp=1 dtype={self.dtype} "
                 f"max_out_tokens={self._cache_len} on {self.device}")

    # ------------------------------------------------------------------
    def _load_checkpoint_params(self, path: str) -> PyTree:
        """A save_16bit_model ``.npz`` (names are the tree's "/"-joined
        paths; reference: load_checkpoint:326). An engine checkpoint
        directory (orbax) is not ported yet."""
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
        kind = "directory" if os.path.isdir(path) else "path"
        raise NotImplementedError(
            f"checkpoint {kind} {path!r}: only a .npz is read; engine "
            "checkpoint directories are not ported yet (ROADMAP Slice E "
            "item 13)")

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

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, do_sample: bool = False,
                 seed: int = 0, **kwargs) -> torch.Tensor:
        """Autoregressive generation (reference: _generate:608): the
        prompt as one prefill, then ``max_new_tokens - 1`` decode steps.
        Greedy unless ``do_sample``; top_p enables nucleus sampling
        (composes with top_k and temperature). Returns [B, prompt +
        max_new_tokens] token ids, the prompt first."""
        tokens = self._tokens(tokens)
        if tokens.dim() == 1:
            tokens = tokens[None, :]
        b, prompt_len = tokens.shape
        cache_len = self._check_lengths(prompt_len, max_new_tokens)
        model = self.module
        key = threefry.prng_key(seed, device=self.device)

        def sample(logits, key):
            key, sub = threefry.split(key)
            if not do_sample:
                return sampling.sample_tokens(logits, greedy=True), key
            # temperature 1 leaves the logits as they are (JAX divides
            # only when it is not 1); the rest as JAX's compiled loop
            return sampling.sample_tokens(
                logits, sub, temperature=temperature, top_k=top_k,
                top_p=top_p, reciprocal=True), key

        cache = model.init_cache(b, cache_len, dtype=self.dtype)
        logits, cache = model.decode(tokens, cache)                # prefill
        nxt, key = sample(logits[:, -1, :].float(), key)
        out = [nxt]
        for _ in range(max_new_tokens - 1):
            logits, cache = model.decode(nxt[:, None], cache)
            nxt, key = sample(logits[:, -1, :].float(), key)
            out.append(nxt)
        return torch.cat([tokens, torch.stack(out, 1)], 1)

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
