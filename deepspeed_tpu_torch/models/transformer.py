"""Decoder-only transformer as an ``nn.Module`` (counterpart of
``deepspeed_tpu/models/transformer.py`` ``DecoderLM``).

The parameters keep the JAX tree's stacked ``[L, ...]`` layout and its
``x @ w`` orientation, flattened into one ``ParameterDict`` whose keys are
the JAX tree paths joined by ``/`` (``"layers/wq"``, ``"embed/tokens"``),
so a JAX checkpoint maps onto the module name for name
(``models/convert.py``). The per-layer pieces (``_norm``, ``_qkv``,
``_attn_out``, ``_mlp``...) take the layer's parameter slices ``p`` as
their JAX counterparts do, so the paged serving forward
(``inference/v2/paged.py``) composes them the same way.

Training: :meth:`DecoderLM.loss` is the mean token cross-entropy of
:meth:`apply`, or with ``loss_chunk > 0`` the chunked cross-entropy that
never forms the [B, S, V] logits; ``attn_impl="flash"`` runs attention
through the flash-attention kernels (``ops/flash_attention.py``). Under
autograd the layers are rematerialised with ``torch.utils.checkpoint``
per ``remat_policy``, the names the JAX ``_remat_policy`` turns into a
working policy (:data:`REMAT_POLICIES`): the stock ``jax.checkpoint_policies``
names checkpoint each whole block, as the JAX layer scan does, with a
selective policy over the matmul ops for the dot policies;
``"save_attn_ffn"`` keeps JAX's named tensors (qkv, attn_out, ffn) at
segment boundaries; ``"segments"`` keeps attention outside any
checkpoint, so its backward never reruns the forward kernel.

Norms run through ``ops/norms.py``: the hand-written kernel on CUDA (one
launch per norm, re-launched wherever a checkpoint recomputes it), the
plain version on the CPU or inside ``ops.norms.plain_norms()``.

Weight-only int8 (``ops/quantization.py`` ``quantize_dense_params``):
a quantized leaf is held as its ``name_q`` (int8) and ``name_s`` pair, and
each layer's pairs are dequantized where the layer is read (JAX
``_maybe_dequant``), ``lm_head_q`` where the vocab projection is, so at
most one layer's float weights exist. :meth:`DecoderLM.using_weights`
runs the model on another source of weights (``linear.LoRAModel``'s
frozen base merged with its adapters, a layer at a time).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import layers as L
from ..ops import norms as N
from ..ops.quantization import dequantize_dense, dequantize_weight
from ..ops.flash_attention import flash_attention
from ..ops.transformer import init_value
from ..runtime.activation_checkpointing.checkpointing import (
    STOCK_POLICIES, remat)
from ..utils.device import resolve_device
from .base import ModelConfig

# every name the JAX _remat_policy turns into a working policy
REMAT_POLICIES = (*STOCK_POLICIES, "save_attn_ffn", "segments")
# jax.checkpoint_policies factories: the JAX model passes one as the policy
# itself, which fails with TypeError when its first step is traced
POLICY_FACTORIES = ("save_only_these_names", "save_any_names_but_these",
                    "save_anything_except_these_names",
                    "save_and_offload_only_these_names",
                    "save_from_both_policies",
                    "offload_dot_with_no_batch_dims")

_STD = 0.02
# set inside deferred_weights(): models built there hold meta parameters
_DEFERRED = contextvars.ContextVar("deferred_weights", default=False)


@contextlib.contextmanager
def deferred_weights():
    """Build models whose parameters are meta tensors (no storage) until a
    loader gives each its value (``models/convert.py``
    ``load_serving_params``): a weight-only int8 engine then never holds
    the float tree on the device."""
    token = _DEFERRED.set(True)
    try:
        yield
    finally:
        _DEFERRED.reset(token)


class DecoderLM(nn.Module):
    """Every dense family from one parameterized block: GPT-2 (learned
    positions, LayerNorm, GELU, biases), Llama (RoPE, RMSNorm, SwiGLU, GQA,
    no biases) and the switches of the others (ALiBi, sliding window,
    parallel residual with one or two norms, partial rotary, qkv-only
    biases, embed LayerNorm, ReLU)."""

    def __init__(self, config: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        c = config
        dev = resolve_device(device)
        dt = dtype or c.param_dtype
        check_training_options(c)
        if c.position_embedding == "rope":
            # partial rotary (rotary_pct < 1) rotates only the first
            # rot_dim channels of each head
            self._rot_dim = max(2, int(c.head_dim * c.rotary_pct) // 2 * 2)
            cos, sin = L.rotary_embedding(c.max_seq_len, self._rot_dim,
                                          c.rope_theta, device=dev)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)
        else:
            self._rot_dim = 0
        self._alibi_slopes = (L.alibi_slopes(c.num_heads, device=dev)
                              if c.position_embedding == "alibi" else None)
        if self._alibi_slopes is not None and c.attn_impl == "flash":
            raise ValueError(
                "attn_impl='flash' does not support ALiBi: the kernel has "
                "no per-head additive-bias path; use the default attention "
                "(attn_impl='reference') or rope/learned positions with "
                "flash")
        self.device = dev
        self._init_spec = self._param_spec()
        pdev = torch.device("meta") if _DEFERRED.get() else dev
        self.params = nn.ParameterDict({
            name: nn.Parameter(torch.empty(shape, device=pdev, dtype=dt))
            for name, (shape, _) in self._init_spec.items()})
        self._source = None
        self.refresh_param_names()

    def refresh_param_names(self) -> None:
        """Re-read the parameter names after a loader replaced leaves (int8
        ``name_q``/``name_s`` pairs for ``name``)."""
        self._layer_keys = [n.split("/", 1)[1] for n in self.params
                            if n.startswith("layers/")]
        self._dense_quantized = any(n.endswith("_q") for n in self.params)

    # ---------------- init ----------------
    def _param_spec(self) -> dict[str, tuple[tuple[int, ...], object]]:
        """name -> (shape, init): a float is the std of a normal init,
        "ones"/"zeros" a constant. Mirrors the JAX ``init`` tree."""
        c = self.config
        d, f, v, nl = c.hidden_size, c.intermediate_size, c.vocab_size, \
            c.num_layers
        nh, nkv, hd = c.num_heads, c.num_kv_heads, c.head_dim
        resid_std = _STD / (2 * nl) ** 0.5
        spec = {
            "embed/tokens": ((v, d), _STD),
            "layers/ln1_scale": ((nl, d), "ones"),
            "layers/wq": ((nl, d, nh * hd), _STD),
            "layers/wk": ((nl, d, nkv * hd), _STD),
            "layers/wv": ((nl, d, nkv * hd), _STD),
            "layers/wo": ((nl, nh * hd, d), resid_std),
            "layers/w_up": ((nl, d, f), _STD),
            "layers/w_down": ((nl, f, d), resid_std),
        }
        has_ln2 = not c.parallel_residual or c.parallel_dual_norm
        if has_ln2:
            spec["layers/ln2_scale"] = ((nl, d), "ones")
        if c.activation == "swiglu":
            spec["layers/w_gate"] = ((nl, d, f), _STD)
        if c.norm_type == "layernorm":
            spec["layers/ln1_bias"] = ((nl, d), "zeros")
            if has_ln2:
                spec["layers/ln2_bias"] = ((nl, d), "zeros")
        if c.use_bias or c.attn_qkv_bias:
            spec["layers/wq_b"] = ((nl, nh * hd), "zeros")
            spec["layers/wk_b"] = ((nl, nkv * hd), "zeros")
            spec["layers/wv_b"] = ((nl, nkv * hd), "zeros")
        if c.use_bias:
            spec["layers/wo_b"] = ((nl, d), "zeros")
        if c.effective_mlp_bias:
            spec["layers/w_up_b"] = ((nl, f), "zeros")
            spec["layers/w_down_b"] = ((nl, d), "zeros")
            if c.activation == "swiglu":
                spec["layers/w_gate_b"] = ((nl, f), "zeros")
        if c.position_embedding == "learned":
            spec["embed/positions"] = ((c.max_seq_len, d), _STD)
        if c.embed_layernorm:
            spec["embed/ln_scale"] = ((d,), "ones")
            spec["embed/ln_bias"] = ((d,), "zeros")
        spec["final_norm/scale"] = ((d,), "ones")
        if c.norm_type == "layernorm":
            spec["final_norm/bias"] = ((d,), "zeros")
        if not c.tie_embeddings:
            spec["lm_head"] = ((d, v), _STD)
            if c.lm_head_bias:
                spec["lm_head_b"] = ((v,), "zeros")
        return spec

    @torch.no_grad()
    def init_params(self, generator: torch.Generator | None = None) -> None:
        """Random init with the JAX package's scheme (normal std 0.02,
        residual projections scaled by 1/sqrt(2L), unit norm scales,
        zero biases), drawn from ``generator``. The numbers differ from
        the JAX init's: tests carry JAX params across instead."""
        for name in self._init_spec:
            self.params[name].copy_(self.draw(name, generator))

    @torch.no_grad()
    def draw(self, name: str, generator: torch.Generator | None = None,
             layer: int | None = None) -> torch.Tensor:
        """Leaf ``name``'s initial value in fp32 on the model's device, the
        next draw of ``generator`` (:meth:`init_params` draws the leaves in
        the order of ``_init_spec``); with ``layer``, one layer of a
        stacked leaf ([L, ...] -> [...]), for loaders that build a leaf a
        layer at a time (:attr:`layerwise_draws`)."""
        shape, init = self._init_spec[name]
        if layer is not None:
            shape = shape[1:]
        return init_value(shape, init, self.device, generator)

    # stacked leaves whose random serving values are drawn a layer at a
    # time (models/convert.py load_serving_params): none of a dense model's
    layerwise_draws: frozenset = frozenset()

    @property
    def routes_pads(self) -> bool:
        """Whether the pad slots of a serving chunk change the real tokens'
        outputs: true of a capacity-routed FFN, whose pads claim expert
        slots (the serving engines then pad as JAX pads)."""
        return False

    # ---------------- weights ----------------
    @contextlib.contextmanager
    def using_weights(self, source):
        """Run the model on ``source``'s weights instead of its own
        parameters: ``source[name]`` gives a top-level tensor
        (``"embed/tokens"``), ``name in source`` says whether there is one,
        and ``source.layer(i)`` gives layer i's parameters keyed as in JAX
        ``p`` (a mapping that may compute each weight where it is read)."""
        prev, self._source = self._source, source
        try:
            yield
        finally:
            self._source = prev

    def _tensor(self, name: str) -> torch.Tensor:
        return self.params[name] if self._source is None \
            else self._source[name]

    def _has(self, name: str) -> bool:
        return name in (self.params if self._source is None
                        else self._source)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype of the activations: the embedding's."""
        return self._tensor("embed/tokens").dtype

    def _dequantized(self, p: dict) -> dict:
        return dequantize_dense(p, self.compute_dtype) \
            if self._dense_quantized else p

    def layer_params(self, layer: int) -> dict[str, torch.Tensor]:
        """One layer's parameters keyed as in JAX ``p``: slices (views) of
        the stacks, a weight-only int8 pair dequantized."""
        if self._source is not None:
            return self._source.layer(layer)
        return self._dequantized({k: self.params["layers/" + k][layer]
                                  for k in self._layer_keys})

    # ---------------- pieces (reused by the paged forward) --------------
    def _norm(self, x, scale, bias=None):
        if self.config.norm_type == "rmsnorm":
            return N.rms_norm(x, scale, self.config.norm_eps)
        return N.layer_norm(x, scale, bias, self.config.norm_eps)

    def embed(self, tokens: torch.Tensor,
              positions: torch.Tensor | None = None) -> torch.Tensor:
        c = self.config
        if tokens.shape[-1] > c.max_seq_len:
            raise ValueError(
                f"sequence length {tokens.shape[-1]} exceeds max_seq_len "
                f"{c.max_seq_len}")
        x = self._tensor("embed/tokens")[tokens]
        if c.position_embedding == "learned":
            if positions is None:
                positions = torch.arange(tokens.shape[-1],
                                         device=tokens.device)[None, :]
            # a chunk's pad slots past a row's end may lie past the table
            # (JAX's take fills them with NaN; their rows are never read):
            # clamped, so the lookup stays in bounds on the card
            x = x + self._tensor("embed/positions")[
                positions.clamp(max=c.max_seq_len - 1)]
        if c.embed_layernorm:
            x = N.layer_norm(x, self._tensor("embed/ln_scale"),
                             self._tensor("embed/ln_bias"), c.norm_eps)
        return x

    def _qkv(self, p: dict, h: torch.Tensor,
             positions: torch.Tensor | None = None):
        """q/k/v projection (+bias, head reshape, rope)."""
        c = self.config
        b, s, _ = h.shape
        nh, nkv, hd = c.num_heads, c.num_kv_heads, c.head_dim
        q = h @ p["wq"]
        k = h @ p["wk"]
        v = h @ p["wv"]
        if c.use_bias or c.attn_qkv_bias:
            q, k, v = q + p["wq_b"], k + p["wk_b"], v + p["wv_b"]
        q = q.reshape(b, s, nh, hd)
        k = k.reshape(b, s, nkv, hd)
        v = v.reshape(b, s, nkv, hd)
        if self._rot_dim:
            r = self._rot_dim
            cos, sin = self.rope_cos, self.rope_sin
            if r < hd:   # partial rotary: rotate a prefix
                q = torch.cat([L.apply_rotary(q[..., :r], cos, sin,
                                              positions), q[..., r:]], -1)
                k = torch.cat([L.apply_rotary(k[..., :r], cos, sin,
                                              positions), k[..., r:]], -1)
            else:
                q = L.apply_rotary(q, cos, sin, positions)
                k = L.apply_rotary(k, cos, sin, positions)
        return q, k, v

    def _attn_out(self, p: dict, a: torch.Tensor) -> torch.Tensor:
        b, s = a.shape[:2]
        out = a.reshape(b, s, -1) @ p["wo"]
        if self.config.use_bias:
            out = out + p["wo_b"]
        return out

    def _mlp(self, p: dict, h: torch.Tensor):
        """Dense FFN: (out, aux), aux the router loss (None: a dense FFN
        has none; JAX's is 0). MoE subclasses override it."""
        return self._mlp_down(p, self._mlp_hidden(p, h)), None

    def _mlp_hidden(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        """The FFN's activation (JAX's checkpoint name "ffn"): the input
        of the down projection."""
        c = self.config
        mlp_bias = c.effective_mlp_bias
        if c.activation == "swiglu":
            gate = h @ p["w_gate"]
            up = h @ p["w_up"]
            if mlp_bias:
                gate = gate + p["w_gate_b"]
                up = up + p["w_up_b"]
            return L.silu(gate) * up
        up = h @ p["w_up"]
        if mlp_bias:
            up = up + p["w_up_b"]
        return torch.relu(up) if c.activation == "relu" else L.gelu(up)

    def _mlp_down(self, p: dict, m: torch.Tensor) -> torch.Tensor:
        m = m @ p["w_down"]
        if self.config.effective_mlp_bias:
            m = m + p["w_down_b"]
        return m

    def _mlp_residual(self, p: dict, x: torch.Tensor):
        h = self._norm(x, p["ln2_scale"], p.get("ln2_bias"))
        m, aux = self._mlp(p, h)
        return x + m, aux

    def _parallel_mlp_input(self, p: dict, x, h):
        """MLP input of parallel-residual blocks: GPT-NeoX norms the raw
        residual with ln2; Falcon/GPT-J share ln1's output."""
        if self.config.parallel_dual_norm:
            return self._norm(x, p["ln2_scale"], p.get("ln2_bias"))
        return h

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal attention over a contiguous sequence, as the JAX block
        picks it: ``attn_impl="flash"`` takes the flash kernels (with the
        window); otherwise the exact path, where ALiBi or the window rides
        as an additive bias."""
        c = self.config
        s = q.shape[1]
        if c.attn_impl == "flash":
            return flash_attention(q, k, v, causal=True,
                                   window=c.sliding_window)
        if self._alibi_slopes is not None:
            return L.dot_product_attention(
                q, k, v, causal=True,
                bias=L.alibi_bias(self._alibi_slopes, s))
        bias = (L.window_bias(s, c.sliding_window, device=q.device)
                if c.sliding_window is not None else None)
        return L.dot_product_attention(q, k, v, causal=True, bias=bias)

    def block(self, p: dict, x: torch.Tensor,
              positions: torch.Tensor | None = None):
        """One transformer block over a contiguous causal sequence: (x,
        aux), aux the FFN's router loss (None for a dense FFN)."""
        c = self.config
        h = self._norm(x, p["ln1_scale"], p.get("ln1_bias"))
        q, k, v = self._qkv(p, h, positions)
        a = self._attention(q, k, v)
        if c.parallel_residual:
            m, aux = self._mlp(p, self._parallel_mlp_input(p, x, h))
            return x + self._attn_out(p, a) + m, aux
        x = x + self._attn_out(p, a)
        return self._mlp_residual(p, x)

    def _block_segmented(self, p: dict, x: torch.Tensor,
                         positions: torch.Tensor | None = None):
        """Segment remat (JAX ``_block_segmented``): attention sits
        outside any checkpoint, so its saved q, k, v, o and lse serve the
        backward and the forward kernel never reruns. Around it:

        - norm + qkv projection are checkpointed: the backward recomputes
          them from the block input;
        - the residual after the output projection (JAX "resid_mid") is
          kept, and norm + MLP after it are checkpointed. JAX also keeps
          the MLP's pre-activation ("ffn_pre"), which torch's checkpoint
          cannot name, so here the backward recomputes the up projection
          as well.
        """
        c = self.config

        def seg_qkv(x):
            h = self._norm(x, p["ln1_scale"], p.get("ln1_bias"))
            return (*self._qkv(p, h, positions), h)

        q, k, v, h = checkpoint(seg_qkv, x, use_reentrant=False)
        a = self._attention(q, k, v)
        if c.parallel_residual:
            def seg_out(x, a, h):
                m, aux = self._mlp(p, self._parallel_mlp_input(p, x, h))
                return x + self._attn_out(p, a) + m, aux

            return checkpoint(seg_out, x, a, h, use_reentrant=False)
        if isinstance(p, dict):
            x = x + self._attn_out(p, a)
        else:
            # weights computed where they are read (LoRA's merge): the
            # output projection is recomputed too, so autograd keeps no
            # layer's effective weight
            x = x + checkpoint(self._attn_out, p, a, use_reentrant=False)
        return checkpoint(self._mlp_residual, p, x, use_reentrant=False)

    def _block_save_attn_ffn(self, p: dict, x: torch.Tensor,
                             positions: torch.Tensor | None = None):
        """``save_attn_ffn`` (JAX ``save_only_these_names("qkv",
        "attn_out", "ffn")`` around the block): a layer keeps its input,
        q/k/v, the attention output and the FFN activation ("ffn", the
        input of the down projection), each at a checkpoint boundary, and
        its backward recomputes the rest:

        - norm + qkv projection, checkpointed: the backward reruns the
          norm and the projections before the segment's last (torch's
          checkpoint reruns a segment in order until the last tensor its
          backward needs exists; JAX's partial evaluation drops the
          projections, whose outputs it saves);
        - attention, checkpointed on q/k/v: the backward reruns its
          forward (the O(S^2) scores; the flash forward kernel, as JAX
          reruns the custom-VJP forward rule under remat);
        - the output projection, the residual, the second norm, the up
          projection and the activation, checkpointed on the block input
          and the attention output; the down projection outside keeps
          "ffn". A routed FFN names no "ffn" (JAX's MoE FFN saves nothing
          inside), so the whole FFN is in the checkpoint.
        """
        c = self.config

        def seg_qkv(x):
            h = self._norm(x, p["ln1_scale"], p.get("ln1_bias"))
            return self._qkv(p, h, positions)

        q, k, v = checkpoint(seg_qkv, x, use_reentrant=False)
        a = checkpoint(self._attention, q, k, v, use_reentrant=False)
        if c.parallel_residual:
            def seg_ffn(x):
                h = (None if c.parallel_dual_norm else
                     self._norm(x, p["ln1_scale"], p.get("ln1_bias")))
                return self._mlp_hidden(p, self._parallel_mlp_input(p, x, h))

            m = checkpoint(seg_ffn, x, use_reentrant=False)
            return x + self._attn_out(p, a) + self._mlp_down(p, m), None
        if c.num_experts > 0:
            def seg_moe(x, a):
                return self._mlp_residual(p, x + self._attn_out(p, a))

            return checkpoint(seg_moe, x, a, use_reentrant=False)

        def seg_ffn(x, a):
            x = x + self._attn_out(p, a)
            h = self._norm(x, p["ln2_scale"], p.get("ln2_bias"))
            return x, self._mlp_hidden(p, h)

        x, m = checkpoint(seg_ffn, x, a, use_reentrant=False)
        return x + self._mlp_down(p, m), None

    def _layers(self):
        """layer -> its parameters (as :meth:`layer_params`), from views
        of every stacked parameter, one ``unbind`` per stack: its backward
        stacks the layers' grads in one pass."""
        if self._source is not None:
            return self._source.layer
        stacks = {k: self.params["layers/" + k].unbind(0)
                  for k in self._layer_keys}
        return lambda i: self._dequantized({k: v[i]
                                            for k, v in stacks.items()})

    def final_hidden(self, tokens: torch.Tensor,
                     positions: torch.Tensor | None = None,
                     return_aux: bool = False):
        """Hidden states [B, S, D] after the last block, before the final
        norm; under autograd each layer is rematerialised per
        ``remat_policy``. ``return_aux``: (x, aux), aux the layers' router
        losses summed (JAX ``_final_hidden``'s scan carry; None for a
        dense model)."""
        c = self.config
        recompute = c.remat and torch.is_grad_enabled()
        x = self.embed(tokens, positions)
        layers = self._layers()
        aux = None
        for layer in range(c.num_layers):
            p = layers(layer)
            if not recompute:
                x, layer_aux = self.block(p, x, positions)
            elif c.remat_policy == "segments":
                x, layer_aux = self._block_segmented(p, x, positions)
            elif c.remat_policy == "save_attn_ffn":
                x, layer_aux = self._block_save_attn_ffn(p, x, positions)
            else:
                x, layer_aux = remat(self.block, p, x, positions,
                                     policy=c.remat_policy)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
        return (x, aux) if return_aux else x

    def _final_norm(self, x: torch.Tensor) -> torch.Tensor:
        bias = (self._tensor("final_norm/bias")
                if self._has("final_norm/bias") else None)
        return self._norm(x, self._tensor("final_norm/scale"), bias)

    def _vocab_weight(self) -> torch.Tensor:
        """The [D, V] vocab projection (tied: the embedding's transpose;
        weight-only int8: ``lm_head_q`` dequantized)."""
        if self.config.tie_embeddings:
            return self._tensor("embed/tokens").T
        if self._has("lm_head_q"):
            return dequantize_weight(self._tensor("lm_head_q"),
                                     self._tensor("lm_head_s"),
                                     self.compute_dtype)
        return self._tensor("lm_head")

    def _vocab_bias(self) -> torch.Tensor | None:
        return self._tensor("lm_head_b") if self._has("lm_head_b") else None

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + vocab projection: logits [..., V]."""
        out = self._final_norm(x) @ self._vocab_weight()
        bias = self._vocab_bias()
        if bias is not None:
            out = out + bias
        return out

    def apply(self, tokens: torch.Tensor,
              positions: torch.Tensor | None = None,
              return_aux: bool = False):
        """Contiguous forward: logits [B, S, V] (``return_aux``: (logits,
        the summed router loss, None for a dense model))."""
        x, aux = self.final_hidden(tokens, positions, return_aux=True)
        logits = self.unembed(x)
        return (logits, aux) if return_aux else logits

    # ---------------- KV-cache decode (the v1 inference engine) ----------
    def init_cache(self, batch_size: int, max_len: int, dtype=None) -> dict:
        """Static-shape KV cache (JAX ``init_cache``; reference:
        inference_context.h KV buffer allocation): ``{"k", "v"}`` [L, B,
        S_max, H_kv, D] zeros on the model's device, and ``"index"``, the
        tokens cached so far, a 0-dim int64 tensor there too (JAX's traced
        int32 scalar): no step reads it on the host, so a CUDA graph
        captures a decode step."""
        c = self.config
        dt = dtype or self.compute_dtype
        dev = self._tensor("embed/tokens").device
        shape = (c.num_layers, batch_size, max_len, c.num_kv_heads,
                 c.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "index": torch.zeros((), dtype=torch.int64, device=dev)}

    def block_decode(self, p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, index: torch.Tensor):
        """One block over new tokens with cache read/write (JAX
        ``block_decode``). x: [B, S_new, D]; caches [B, S_max, H_kv, D],
        written IN PLACE at rows ``index + arange(S_new)`` by
        ``index_copy_`` (JAX's ``dynamic_update_slice`` returns updated
        copies); ``index`` the 0-dim device tensor of :meth:`init_cache`.
        Returns (x, k_cache, v_cache)."""
        b, s, _ = x.shape
        rows = index + torch.arange(s, device=x.device)
        positions = rows[None, :].expand(b, s)
        h = self._norm(x, p["ln1_scale"], p.get("ln1_bias"))
        q, k, v = self._qkv(p, h, positions)
        k_cache.index_copy_(1, rows, k.to(k_cache.dtype))
        v_cache.index_copy_(1, rows, v.to(v_cache.dtype))
        a = L.cached_attention(q, k_cache, v_cache, index,
                               window=self.config.sliding_window,
                               alibi_slopes=self._alibi_slopes)
        if self.config.parallel_residual:
            m, _ = self._mlp(p, self._parallel_mlp_input(p, x, h))
            return x + self._attn_out(p, a) + m, k_cache, v_cache
        x = x + self._attn_out(p, a)
        x, _ = self._mlp_residual(p, x)
        return x, k_cache, v_cache

    def decode(self, tokens: torch.Tensor, cache: dict):
        """Prefill or incremental decode (JAX ``decode``): ``tokens`` [B,
        S_new], appended at ``cache["index"]``, through every layer, the
        cache updated in place. Returns (logits [B, S_new, V], cache) with
        the index advanced (a new device tensor). Reads nothing back to
        the host."""
        index = cache["index"]
        b, s = tokens.shape
        positions = (index + torch.arange(s, device=tokens.device))[None, :] \
            .expand(b, s)
        x = self.embed(tokens, positions=positions)
        for layer in range(self.config.num_layers):
            x, _, _ = self.block_decode(self.layer_params(layer), x,
                                        cache["k"][layer], cache["v"][layer],
                                        index)
        return self.unembed(x), dict(cache, index=index + s)

    def partition_rules(self) -> list[tuple[str, tuple]]:
        """Megatron-style TP rules (JAX ``partition_rules``), each spec a
        tuple of mesh-axis names (None: replicated; () replicated
        whole)."""
        return [
            (r"embed/tokens", ("tp", None)),
            (r"embed/positions", ()),
            (r"layers/(wq|wk|wv|w_up|w_gate)$", (None, None, "tp")),
            (r"layers/(wq_b|wk_b|wv_b|w_up_b|w_gate_b)$", (None, "tp")),
            (r"layers/(wo|w_down)$", (None, "tp", None)),
            (r"layers/(wo_b|w_down_b)$", ()),
            (r"layers/ln\d_(scale|bias)", ()),
            (r"final_norm", ()),
            (r"lm_head$", (None, "tp")),
            (r"lm_head_b$", ("tp",)),
        ]

    forward = apply

    def loss(self, batch) -> torch.Tensor:
        """Mean token cross-entropy (fp32) of ``batch``: a
        ``(tokens, targets)`` pair or a dict with those keys, each [B, S],
        plus ``aux_loss_coef() * aux`` for an MoE model (JAX's loss; a
        dense model's aux term is 0 there and absent here)."""
        nll, count, aux = self.loss_parts(batch)
        loss = nll / torch.clamp(count, min=1)
        if aux is not None:
            loss = loss + self.aux_loss_coef() * aux
        return loss

    def aux_loss_coef(self) -> float:
        return getattr(self.config, "router_aux_loss_coef", 0.0)

    def loss_terms(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """The cross-entropy as (summed fp32 NLL, count of valid targets),
        -100 targets masked: a caller that splits a batch divides the sum
        by the count of the whole batch (the engine across ranks; an MoE
        model's router loss is not in these terms: :meth:`loss_parts`)."""
        nll, count, _ = self.loss_parts(batch)
        return nll, count

    def loss_parts(self, batch):
        """(summed NLL, count of valid targets, router aux or None): the
        engine across ranks adds the aux, a global quantity under global
        gating, as its share of the global loss."""
        tokens, targets = _unpack_batch(batch)
        x, aux = self.final_hidden(tokens, return_aux=True)
        if self.config.loss_chunk > 0:
            return (*self._chunked_loss(x, targets), aux)
        return (*L.cross_entropy_terms(self.unembed(x), targets), aux)

    def _chunked_loss(self, x, targets):
        """Chunked cross-entropy (JAX ``_chunked_loss``) of the last
        block's output ``x``: the final-normed hidden states are cut into
        sequence chunks of ``loss_chunk``; per chunk the vocab projection
        and the fp32 logsumexp/NLL run under
        ``torch.utils.checkpoint``, so only one [B, chunk, V] slab of
        logits lives at a time and the backward recomputes it. The loss
        is the summed NLL over the summed count of valid targets (-100
        masked), not a mean of per-chunk means; returned as the (sum,
        count) pair of :meth:`loss_terms`."""
        c = self.config
        x = self._final_norm(x)
        w = self._vocab_weight()
        bias = self._vocab_bias()
        s = x.shape[1]
        chunk = min(c.loss_chunk, s)
        if s % chunk != 0:
            raise ValueError(
                f"loss_chunk {c.loss_chunk} (effective {chunk}) must "
                f"divide sequence length {s}")
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.int64, device=x.device)
        for i in range(0, s, chunk):
            args = (x[:, i:i + chunk], targets[:, i:i + chunk], w, bias)
            part, n = (checkpoint(_chunk_nll, *args, use_reentrant=False)
                       if torch.is_grad_enabled() else _chunk_nll(*args))
            nll = nll + part
            count = count + n
        return nll, count


def check_training_options(c: ModelConfig) -> None:
    """Refuse the remat policies the JAX model cannot run either: a
    ``jax.checkpoint_policies`` factory name (TypeError, as the JAX step
    raises when it is traced) or an unknown name (ValueError; JAX raises
    AttributeError)."""
    if not c.remat or c.remat_policy in REMAT_POLICIES:
        return
    if c.remat_policy in POLICY_FACTORIES:
        raise TypeError(
            f"remat_policy {c.remat_policy!r} is a jax.checkpoint_policies "
            f"factory that takes arguments, not a policy; the JAX model "
            f"fails on it too. Use one of {REMAT_POLICIES} or remat=False")
    raise ValueError(f"unknown remat_policy {c.remat_policy!r}; use one of "
                     f"{REMAT_POLICIES} or remat=False")


def _chunk_nll(x, targets, w, bias, ignore_index: int = -100):
    """Summed NLL (fp32) and count of the valid targets of one chunk,
    with the masking contract of ``ops.layers.cross_entropy_loss``."""
    logits = (x @ w.to(x.dtype)).float()
    if bias is not None:
        logits = logits + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    true_logit = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, lse - true_logit, torch.zeros_like(lse))
    return nll.sum(), valid.sum()


def _unpack_batch(batch):
    if isinstance(batch, dict):
        return batch["tokens"], batch["targets"]
    tokens, targets = batch
    return tokens, targets
