"""In-graph token sampling (counterpart of ``deepspeed_tpu/ops/sampling.py``;
reference: the HF sampling stack DeepSpeed's ``_generate:608`` delegates
to, and inference/v2's greedy/top-k logit post-processing).

Sampling is a device op: the fused decode loop (``inference/v2/paged.py``
``fused_decode_loop``) samples each token on the card and feeds it to the
next step, with no logits transfer and no host round trip, so a CUDA graph
can capture the whole K-step loop. Randomness comes from
:mod:`.threefry`, keyed by its inputs, never from a generator's state:
the same key draws the same token on the CPU, on the card and inside a
graph, and the JAX package's key draws it too.

Filters compose in the standard order: temperature -> top-k -> top-p ->
categorical draw. ``temperature <= 0`` (or no key) means greedy argmax.
Keys are int64 tensors ``[..., 2]`` of uint32 words (:mod:`.threefry`).

Schedule-invariant sampling keys each step by the sequence position
(:func:`position_keys`): row r sampling its token at position p consumes
the same randomness whether the engine decodes one token a dispatch or K.
"""

from __future__ import annotations

import numpy as np
import torch

from . import threefry

_NEG = -1e30           # filtered logits (drop out of the softmax)


def apply_logit_filters(logits: torch.Tensor, *, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 0.0,
                        reciprocal: bool = False) -> torch.Tensor:
    """Temperature / top-k / top-p logit warping over the last axis, in
    float32. Filtered entries become -1e30; the top-p boundary token stays
    in, as in the HF implementation the reference delegates to.

    ``reciprocal`` rounds the temperature as the JAX function does when
    it is compiled inside the fused loop: XLA turns the division by the
    constant ``max(temperature, 1e-6)`` into a product with its float32
    reciprocal (about a quarter of the quotients then differ by an ulp).
    Called eagerly, as the engine samples a request's first token, JAX
    divides; so does this function by default."""
    logits = logits.float()
    if temperature != 1.0:
        t = np.float32(max(temperature, 1e-6))
        logits = (logits * float(np.float32(1.0) / t) if reciprocal
                  else logits / float(t))
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG, logits)
    if 0.0 < top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p                      # over sorted
        kth = torch.gather(srt, -1, keep.sum(-1, keepdim=True) - 1)
        logits = torch.where(logits < kth, _NEG, logits)
    return logits


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits.float(), dim=-1)


def sample_tokens(logits: torch.Tensor, key: torch.Tensor | None = None, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, greedy: bool = False,
                  reciprocal: bool = False) -> torch.Tensor:
    """One token id per row of ``logits [..., V]`` -> int64 ``[...]``.

    ``greedy=True``, ``key=None`` or ``temperature <= 0`` -> argmax (no
    randomness consumed). Otherwise the filters, then a categorical draw
    with the one key ``[2]`` (JAX draws the whole ``[..., V]`` noise from
    it, counters over the flat index)."""
    if greedy or key is None or temperature <= 0.0:
        return _greedy(logits)
    logits = apply_logit_filters(logits, temperature=temperature,
                                 top_k=top_k, top_p=top_p,
                                 reciprocal=reciprocal)
    noise = threefry.gumbel(key, logits.numel()).reshape(logits.shape)
    return torch.argmax(noise + logits, dim=-1)


def position_keys(base_key: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Per-row keys from absolute sequence positions: ``fold_in(key,
    position)`` a row. ``base_key`` is one key ``[2]`` (shared by every
    row) or a per-row stack ``[B, 2]`` (the engine folds each row's uid
    in first, so rows at equal positions differ)."""
    return threefry.fold_in(base_key, positions)


def sample_tokens_batched(logits: torch.Tensor, keys: torch.Tensor, *,
                          temperature: float = 1.0, top_k: int = 0,
                          top_p: float = 0.0,
                          reciprocal: bool = False) -> torch.Tensor:
    """:func:`sample_tokens` with one key a row (e.g. from
    :func:`position_keys`): logits ``[B, V]``, keys ``[B, 2]`` -> int64
    ``[B]``."""
    if temperature <= 0.0:
        return _greedy(logits)
    logits = apply_logit_filters(logits, temperature=temperature,
                                 top_k=top_k, top_p=top_p,
                                 reciprocal=reciprocal)
    return threefry.categorical(keys, logits)


def sample_token_grid(logits: torch.Tensor, keys: torch.Tensor, *,
                      temperature: float = 1.0, top_k: int = 0,
                      top_p: float = 0.0,
                      reciprocal: bool = False) -> torch.Tensor:
    """:func:`sample_tokens_batched` over a ``[B, S, V]`` slot grid with
    one key a (row, slot), ``[B, S, 2]`` -> int64 ``[B, S]``: the filters
    and the draw act row by row, so the grid flattens."""
    b, s, v = logits.shape
    flat = sample_tokens_batched(
        logits.reshape(b * s, v), keys.reshape(b * s, 2),
        temperature=temperature, top_k=top_k, top_p=top_p,
        reciprocal=reciprocal)
    return flat.reshape(b, s)
