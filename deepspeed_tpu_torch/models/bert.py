"""BERT-style encoder, trainable through ``initialize`` (counterpart of
``deepspeed_tpu/models/bert.py``; reference: module_inject/containers/
bert.py and the training transformer kernel ops/transformer/transformer.py
it was built for, BERT pre-training being DeepSpeed's first headline
workload).

An ``nn.Module`` masked LM over ``ops/transformer.py``'s encoder layer:
token + learned position embeddings and their LayerNorm, the stacked
layers, and BERT's MLM head (a GELU transform, a LayerNorm and the decoder
tied to the token embedding). The parameters are one ``ParameterDict``
under the JAX tree's "/"-joined paths (``embed/tokens``, ``layers/qkv_w``
stacked ``[L, ...]``, ``mlm_head/transform_w``), so a JAX tree loads name
for name (``models/convert.py``). Every norm runs through the LayerNorm
kernel on the card; attention is the plain bidirectional product with the
padding mask as an additive bias, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops import layers as L
from ..ops import norms as N
from ..ops.transformer import (DeepSpeedTransformerConfig, init_value,
                               layer_param_spec, transformer_layer)
from ..utils.device import resolve_device
from .base import register_model

_STD = 0.02


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    norm_eps: float = 1e-12
    pre_layer_norm: bool = False     # post-LN = original BERT
    param_dtype: Any = None          # torch.float32 when None

    def __post_init__(self):
        if self.param_dtype is None:
            self.param_dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        d, f, v, nl = (self.hidden_size, self.intermediate_size,
                       self.vocab_size, self.num_layers)
        per_layer = (d * 3 * d + 3 * d) + (d * d + d) + 2 * d \
            + (d * f + f) + (f * d + d) + 2 * d
        embed = v * d + self.max_seq_len * d + 2 * d
        head = d * d + d + 2 * d + v   # transform + LN + decoder bias
        return embed + nl * per_layer + head

    def flops_per_token(self, seq_len: int, causal: bool = False) -> float:
        """Training FLOPs a token: 6N and bidirectional attention over
        the whole sequence (``causal`` kept for the API's sake)."""
        n = self.num_params()
        return 6 * n + 12 * self.num_layers * self.hidden_size * seq_len


def bert_config(size: str = "base", **overrides) -> BertConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128),
        "base": dict(hidden_size=768, num_layers=12, num_heads=12,
                     intermediate_size=3072),
        "large": dict(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096),
        # reference containers/distil_bert.py: 6-layer distilled BERT
        "distil": dict(hidden_size=768, num_layers=6, num_heads=12,
                       intermediate_size=3072),
    }
    base = dict(presets[size])
    base.update(overrides)
    return BertConfig(**base)


def _unpack_batch(batch):
    """(tokens, targets, mask or None) of ``(tokens, targets[, mask])`` or
    of ``{"input_ids", "labels"[, "attention_mask"]}``."""
    if isinstance(batch, dict):
        return (batch["input_ids"], batch["labels"],
                batch.get("attention_mask"))
    return batch[0], batch[1], (batch[2] if len(batch) > 2 else None)


@register_model("bert")
class Bert(nn.Module):
    """Masked-LM encoder: ``apply`` (MLM logits), ``loss``, ``loss_terms``
    and ``init_params``, trainable by the engine. ``device`` None means
    the card; ``dtype`` overrides ``config.param_dtype``."""

    def __init__(self, config: BertConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__()
        self.config = config or bert_config(size or "base", **overrides)
        c = self.config
        self.layer_config = DeepSpeedTransformerConfig(
            hidden_size=c.hidden_size, intermediate_size=c.intermediate_size,
            heads=c.num_heads, num_hidden_layers=c.num_layers,
            attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
            pre_layer_norm=c.pre_layer_norm, layer_norm_eps=c.norm_eps,
            training=True)
        self.device = resolve_device(device)
        dt = dtype or c.param_dtype
        self._init_spec = self._param_spec()
        self._layer_keys = list(layer_param_spec(self.layer_config))
        self.params = nn.ParameterDict({
            name: nn.Parameter(torch.empty(shape, device=self.device,
                                           dtype=dt))
            for name, (shape, _) in self._init_spec.items()})
        self._source = None

    def _param_spec(self) -> dict[str, tuple[tuple[int, ...], object]]:
        """name -> (shape, init), the JAX ``init`` tree flattened."""
        c = self.config
        d, v, nl = c.hidden_size, c.vocab_size, c.num_layers
        spec = {
            "embed/tokens": ((v, d), _STD),
            "embed/positions": ((c.max_seq_len, d), _STD),
            "embed/ln_scale": ((d,), "ones"),
            "embed/ln_bias": ((d,), "zeros"),
        }
        for name, (shape, init) in layer_param_spec(self.layer_config).items():
            spec["layers/" + name] = ((nl, *shape), init)
        spec.update({
            "mlm_head/transform_w": ((d, d), _STD),
            "mlm_head/transform_b": ((d,), "zeros"),
            "mlm_head/ln_scale": ((d,), "ones"),
            "mlm_head/ln_bias": ((d,), "zeros"),
            "mlm_head/decoder_b": ((v,), "zeros"),
        })
        return spec

    @torch.no_grad()
    def init_params(self, generator: torch.Generator | None = None) -> None:
        """The JAX init scheme (normal std 0.02, the layers' output
        projections scaled by 1/sqrt(2L), unit norm scales, zero biases)
        drawn from ``generator`` in the order of the spec."""
        for name, (shape, init) in self._init_spec.items():
            self.params[name].copy_(init_value(shape, init, self.device,
                                               generator))

    @contextlib.contextmanager
    def using_weights(self, source):
        """Run the model on ``source``'s weights (``DecoderLM.
        using_weights``'s protocol: ``source[name]`` a leaf outside the
        stacks, ``source.layer(i)`` layer i's parameters, read where the
        layer reads them), as the engine's per-layer ZeRO-3 schedule
        does."""
        prev, self._source = self._source, source
        try:
            yield
        finally:
            self._source = prev

    def _layers(self):
        """Each layer's parameters in turn: the source's, else views of the
        stacks (one ``unbind`` per stack: its backward stacks the layers'
        grads in one pass)."""
        if self._source is not None:
            return (self._source.layer(i)
                    for i in range(self.config.num_layers))
        stacks = {k: self.params["layers/" + k].unbind(0)
                  for k in self._layer_keys}
        return ({k: v[i] for k, v in stacks.items()}
                for i in range(self.config.num_layers))

    def _mask_bias(self, attention_mask):
        """[B, S] (1 real, 0 padding) -> the additive fp32 [B, 1, 1, S]
        bias, -1e30 on padding keys."""
        if attention_mask is None:
            return None
        m = torch.as_tensor(attention_mask, device=self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return torch.where(m[:, None, None, :] > 0, zero,
                           torch.full((), -1e30, device=self.device))

    def apply(self, tokens, attention_mask=None) -> torch.Tensor:
        """MLM logits [B, S, V]; ``attention_mask`` [B, S], 1 for a real
        token and 0 for padding (HF convention)."""
        c = self.config
        if tokens.shape[-1] > c.max_seq_len:
            raise ValueError(
                f"sequence length {tokens.shape[-1]} exceeds max_seq_len "
                f"{c.max_seq_len}")
        p = self.params if self._source is None else self._source
        x = p["embed/tokens"][tokens]
        x = x + p["embed/positions"][: tokens.shape[-1]][None]
        x = N.layer_norm(x, p["embed/ln_scale"], p["embed/ln_bias"],
                         c.norm_eps)
        bias = self._mask_bias(attention_mask)
        for lp in self._layers():
            x = transformer_layer(self.layer_config, lp, x,
                                  attention_mask=bias)
        x = L.gelu(x @ p["mlm_head/transform_w"] + p["mlm_head/transform_b"])
        x = N.layer_norm(x, p["mlm_head/ln_scale"], p["mlm_head/ln_bias"],
                         c.norm_eps)
        return x @ p["embed/tokens"].T + p["mlm_head/decoder_b"]

    forward = apply

    def loss(self, batch) -> torch.Tensor:
        """Masked-LM loss (fp32 mean over the valid targets): ``batch`` is
        ``(tokens, targets[, attention_mask])`` or a dict with
        ``input_ids``, ``labels`` and optionally ``attention_mask``;
        targets are -100 where no prediction is made (HF convention)."""
        nll, count = self.loss_terms(batch)
        return nll / torch.clamp(count, min=1)

    def loss_terms(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """(summed fp32 NLL, count of valid targets) of :meth:`loss`."""
        tokens, targets, mask = _unpack_batch(batch)
        return L.cross_entropy_terms(self.apply(tokens, mask), targets)

    def partition_rules(self) -> list[tuple[str, tuple]]:
        """TP rules (JAX ``partition_rules``), each spec a tuple of
        mesh-axis names (None: replicated; () replicated whole)."""
        return [
            (r"embed/tokens", ("tp", None)),
            (r"layers/(qkv_w|inter_w)", (None, None, "tp")),
            (r"layers/(attn_ow|output_w)", (None, "tp", None)),
            (r"mlm_head/transform_w", ()),
        ]
