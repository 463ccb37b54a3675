"""BERT-era transformer layer API (counterpart of
``deepspeed_tpu/ops/transformer.py``; reference:
deepspeed/ops/transformer/transformer.py — DeepSpeedTransformerConfig:34
and DeepSpeedTransformerLayer:296).

:class:`DeepSpeedTransformerLayer` is an ``nn.Module`` encoder layer over
the reference's config surface, with the JAX layer's parameter names,
shapes and init scales (``qkv_w`` ``[d, 3d]``: q, k and v in one
projection, as the reference's single QKV GEMM). Its norms run through
``ops/norms.py`` (the LayerNorm kernel on the card, its closed-form
backward); its attention is the plain bidirectional
``ops.layers.dot_product_attention`` with the additive mask, as the JAX
layer computes it outside any Pallas kernel. Pre-LN and post-LN follow
the reference's ``pre_layer_norm`` switch.

Dropout draws from an explicit ``torch.Generator`` (on the tensors'
device): its bits differ from JAX's threefry keys, its distribution is
the same. ``gelu_checkpoint`` recomputes the FFN block in the backward
(``torch.utils.checkpoint``); its dropout mask is drawn before the
checkpoint, so the recompute sees the same one.

:func:`transformer_layer` is the layer's forward over a parameter
mapping, which ``models/bert.py`` runs on each layer's slices of its
stacked ``[L, ...]`` parameters.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.device import resolve_device
from . import layers as L
from . import norms as N


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """reference: ops/transformer/transformer.py:34 (the JAX fields and
    defaults; an unknown key raises ``TypeError``)."""
    batch_size: int = 1
    hidden_size: int = 768
    intermediate_size: int = 3072
    heads: int = 12
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    num_hidden_layers: int = 12
    initializer_range: float = 0.02
    local_rank: int = -1
    seed: int = 0
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    layer_norm_eps: float = 1e-12
    stochastic_mode: bool = False
    return_tuple: bool = False
    training: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads


def layer_param_spec(c: DeepSpeedTransformerConfig
                     ) -> dict[str, tuple[tuple[int, ...], object]]:
    """name -> (shape, init) of one layer, in the JAX ``init`` order: a
    float is the std of a normal draw, "ones"/"zeros" a constant. The
    output projections' std is scaled by 1/sqrt(2 * num_hidden_layers)
    under ``adjust_init_range``."""
    d, f = c.hidden_size, c.intermediate_size
    std = c.initializer_range
    out_std = (std / (2.0 * c.num_hidden_layers) ** 0.5
               if c.adjust_init_range else std)
    return {
        "qkv_w": ((d, 3 * d), std), "qkv_b": ((3 * d,), "zeros"),
        "attn_ow": ((d, d), out_std), "attn_ob": ((d,), "zeros"),
        "attn_ln_w": ((d,), "ones"), "attn_ln_b": ((d,), "zeros"),
        "inter_w": ((d, f), std), "inter_b": ((f,), "zeros"),
        "output_w": ((f, d), out_std), "output_b": ((d,), "zeros"),
        "ln_w": ((d,), "ones"), "ln_b": ((d,), "zeros"),
    }


def init_value(shape, init, device, generator=None) -> torch.Tensor:
    """One leaf's initial value in fp32: ``init`` a float is the std of a
    normal draw from ``generator``, "ones"/"zeros" a constant."""
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    return torch.randn(shape, generator=generator, device=device) * init


def _keep_mask(x, rate: float, c: DeepSpeedTransformerConfig, generator):
    """Dropout's keep mask for ``x`` (None where dropout is off: not
    training, rate 0 or no generator, as JAX's ``key is None``)."""
    if not c.training or rate <= 0.0 or generator is None:
        return None
    return torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate


def _dropout(x, keep, rate: float):
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                             device=x.device))


def transformer_layer(c: DeepSpeedTransformerConfig, p, hidden_states,
                      attention_mask=None, generator=None):
    """One encoder layer (JAX ``DeepSpeedTransformerLayer.apply``):
    ``hidden_states`` [B, S, D], ``attention_mask`` additive [B, 1, 1, S]
    (HF/BERT convention), ``p`` the layer's parameters by name.
    Bidirectional attention. Returns [B, S, D] (a 1-tuple under
    ``return_tuple``)."""
    b, s, d = hidden_states.shape
    keep_attn = _keep_mask(hidden_states, c.attn_dropout_ratio, c, generator)
    keep_ffn = _keep_mask(hidden_states, c.hidden_dropout_ratio, c,
                          generator)

    def attn_block(x):
        qkv = x @ p["qkv_w"] + p["qkv_b"]
        q, k, v = qkv.split(d, dim=-1)
        shape = (b, s, c.heads, c.head_dim)
        a = L.dot_product_attention(q.reshape(shape), k.reshape(shape),
                                    v.reshape(shape), causal=False,
                                    bias=attention_mask)
        a = a.reshape(b, s, d) @ p["attn_ow"] + p["attn_ob"]
        return _dropout(a, keep_attn, c.attn_dropout_ratio)

    def ffn_block(x, keep):
        h = L.gelu(x @ p["inter_w"] + p["inter_b"])
        h = h @ p["output_w"] + p["output_b"]
        return _dropout(h, keep, c.hidden_dropout_ratio)

    def ffn(x):
        if c.gelu_checkpoint and torch.is_grad_enabled():
            return checkpoint(ffn_block, x, keep_ffn, use_reentrant=False)
        return ffn_block(x, keep_ffn)

    eps = c.layer_norm_eps
    x = hidden_states
    if c.pre_layer_norm:
        x = x + attn_block(N.layer_norm(x, p["attn_ln_w"], p["attn_ln_b"],
                                        eps))
        x = x + ffn(N.layer_norm(x, p["ln_w"], p["ln_b"], eps))
    else:  # post-LN (original BERT)
        x = N.layer_norm(x + attn_block(x), p["attn_ln_w"], p["attn_ln_b"],
                         eps)
        x = N.layer_norm(x + ffn(x), p["ln_w"], p["ln_b"], eps)
    return (x,) if c.return_tuple else x


class DeepSpeedTransformerLayer(nn.Module):
    """reference: ops/transformer/transformer.py:296. Parameters under
    the JAX names (``qkv_w`` ... ``ln_b``) in fp16 under ``config.fp16``,
    else fp32, drawn from ``generator`` on ``device`` (None: the card)."""

    def __init__(self, config: DeepSpeedTransformerConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        dt = torch.float16 if config.fp16 else torch.float32
        self._init_spec = layer_param_spec(config)
        self.params = nn.ParameterDict({
            name: nn.Parameter(torch.empty(shape, device=self.device,
                                           dtype=dt))
            for name, (shape, _) in self._init_spec.items()})
        self.init_params(generator)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator | None = None) -> None:
        """The JAX init scheme drawn from ``generator`` (the numbers differ
        from JAX's: tests carry JAX params across)."""
        for name, (shape, init) in self._init_spec.items():
            self.params[name].copy_(init_value(shape, init, self.device,
                                               generator))

    def forward(self, hidden_states, attention_mask=None,
                generator: torch.Generator | None = None):
        """:func:`transformer_layer` on this layer's parameters; dropout
        draws from ``generator`` (None: no dropout)."""
        return transformer_layer(self.config, self.params, hidden_states,
                                 attention_mask, generator)
