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
per ``remat_policy``: ``"nothing_saveable"`` checkpoints each whole block,
as the JAX layer scan does; ``"segments"`` keeps attention outside any
checkpoint, so its backward never reruns the forward kernel.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import layers as L
from ..ops.flash_attention import flash_attention
from ..utils.device import resolve_device
from .base import ModelConfig

REMAT_POLICIES = ("nothing_saveable", "segments")

_STD = 0.02


class DecoderLM(nn.Module):
    """GPT-2 (learned positions, LayerNorm, GELU, biases) and Llama (RoPE,
    RMSNorm, SwiGLU, GQA, no biases) from one parameterized block."""

    def __init__(self, config: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        c = config
        dev = resolve_device(device)
        dt = dtype or c.param_dtype
        if c.num_experts > 0:
            raise NotImplementedError(
                "MoE models are not ported yet (ROADMAP: port Queue, "
                "model breadth)")
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
        self._init_spec = self._param_spec()
        self.params = nn.ParameterDict({
            name: nn.Parameter(torch.empty(shape, device=dev, dtype=dt))
            for name, (shape, _) in self._init_spec.items()})
        self._layer_keys = [n.split("/", 1)[1] for n in self._init_spec
                            if n.startswith("layers/")]

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
        for name, (shape, init) in self._init_spec.items():
            p = self.params[name]
            if init == "ones":
                p.fill_(1.0)
            elif init == "zeros":
                p.zero_()
            else:
                p.copy_(torch.randn(shape, generator=generator,
                                    device=p.device) * init)

    def layer_params(self, layer: int) -> dict[str, torch.Tensor]:
        """One layer's parameter slices (views), keyed as in JAX ``p``."""
        return {k: self.params["layers/" + k][layer]
                for k in self._layer_keys}

    # ---------------- pieces (reused by the paged forward) --------------
    def _norm(self, x, scale, bias=None):
        if self.config.norm_type == "rmsnorm":
            return L.rms_norm(x, scale, self.config.norm_eps)
        return L.layer_norm(x, scale, bias, self.config.norm_eps)

    def embed(self, tokens: torch.Tensor,
              positions: torch.Tensor | None = None) -> torch.Tensor:
        c = self.config
        if tokens.shape[-1] > c.max_seq_len:
            raise ValueError(
                f"sequence length {tokens.shape[-1]} exceeds max_seq_len "
                f"{c.max_seq_len}")
        x = self.params["embed/tokens"][tokens]
        if c.position_embedding == "learned":
            if positions is None:
                positions = torch.arange(tokens.shape[-1],
                                         device=tokens.device)[None, :]
            x = x + self.params["embed/positions"][positions]
        if c.embed_layernorm:
            x = L.layer_norm(x, self.params["embed/ln_scale"],
                             self.params["embed/ln_bias"], c.norm_eps)
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

    def _mlp(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        """Dense FFN."""
        c = self.config
        mlp_bias = c.effective_mlp_bias
        if c.activation == "swiglu":
            gate = h @ p["w_gate"]
            up = h @ p["w_up"]
            if mlp_bias:
                gate = gate + p["w_gate_b"]
                up = up + p["w_up_b"]
            m = L.silu(gate) * up
        else:
            up = h @ p["w_up"]
            if mlp_bias:
                up = up + p["w_up_b"]
            m = torch.relu(up) if c.activation == "relu" else L.gelu(up)
        m = m @ p["w_down"]
        if mlp_bias:
            m = m + p["w_down_b"]
        return m

    def _mlp_residual(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        h = self._norm(x, p["ln2_scale"], p.get("ln2_bias"))
        return x + self._mlp(p, h)

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
              positions: torch.Tensor | None = None) -> torch.Tensor:
        """One transformer block over a contiguous causal sequence."""
        c = self.config
        h = self._norm(x, p["ln1_scale"], p.get("ln1_bias"))
        q, k, v = self._qkv(p, h, positions)
        a = self._attention(q, k, v)
        if c.parallel_residual:
            m = self._mlp(p, self._parallel_mlp_input(p, x, h))
            return x + self._attn_out(p, a) + m
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
                m = self._mlp(p, self._parallel_mlp_input(p, x, h))
                return x + self._attn_out(p, a) + m

            return checkpoint(seg_out, x, a, h, use_reentrant=False)
        x = x + self._attn_out(p, a)
        return checkpoint(self._mlp_residual, p, x, use_reentrant=False)

    def _layer_stacks(self) -> dict[str, tuple[torch.Tensor, ...]]:
        """Per-layer views of every stacked parameter, one ``unbind`` per
        stack: its backward stacks the layers' grads in one pass."""
        return {k: self.params["layers/" + k].unbind(0)
                for k in self._layer_keys}

    def final_hidden(self, tokens: torch.Tensor,
                     positions: torch.Tensor | None = None) -> torch.Tensor:
        """Hidden states [B, S, D] after the last block, before the final
        norm; under autograd each layer is rematerialised per
        ``remat_policy``."""
        c = self.config
        remat = c.remat and torch.is_grad_enabled()
        x = self.embed(tokens, positions)
        stacks = self._layer_stacks()
        for layer in range(c.num_layers):
            p = {k: v[layer] for k, v in stacks.items()}
            if not remat:
                x = self.block(p, x, positions)
            elif c.remat_policy == "segments":
                x = self._block_segmented(p, x, positions)
            else:
                x = checkpoint(self.block, p, x, positions,
                               use_reentrant=False)
        return x

    def _final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self._norm(x, self.params["final_norm/scale"],
                          self.params.get("final_norm/bias"))

    def _vocab_weight(self) -> torch.Tensor:
        """The [D, V] vocab projection (tied: the embedding's transpose)."""
        if self.config.tie_embeddings:
            return self.params["embed/tokens"].T
        return self.params["lm_head"]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + vocab projection: logits [..., V]."""
        out = self._final_norm(x) @ self._vocab_weight()
        if "lm_head_b" in self.params:
            out = out + self.params["lm_head_b"]
        return out

    def apply(self, tokens: torch.Tensor,
              positions: torch.Tensor | None = None) -> torch.Tensor:
        """Contiguous forward: logits [B, S, V]."""
        return self.unembed(self.final_hidden(tokens, positions))

    forward = apply

    def loss(self, batch) -> torch.Tensor:
        """Mean token cross-entropy (fp32) of ``batch``: a
        ``(tokens, targets)`` pair or a dict with those keys, each [B, S].
        Dense models add no router loss (the JAX aux term is 0)."""
        tokens, targets = _unpack_batch(batch)
        if self.config.loss_chunk > 0:
            return self._chunked_loss(tokens, targets)
        return L.cross_entropy_loss(self.apply(tokens), targets)

    def _chunked_loss(self, tokens, targets) -> torch.Tensor:
        """Chunked cross-entropy (JAX ``_chunked_loss``): the final-normed
        hidden states are cut into sequence chunks of ``loss_chunk``; per
        chunk the vocab projection and the fp32 logsumexp/NLL run under
        ``torch.utils.checkpoint``, so only one [B, chunk, V] slab of
        logits lives at a time and the backward recomputes it. The loss
        is the summed NLL over the summed count of valid targets (-100
        masked), not a mean of per-chunk means."""
        c = self.config
        x = self._final_norm(self.final_hidden(tokens))
        w = self._vocab_weight()
        bias = self.params["lm_head_b"] if "lm_head_b" in self.params \
            else None
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
        return nll / torch.clamp(count, min=1)


def check_training_options(c: ModelConfig) -> None:
    """Refuse the training options the port does not have yet."""
    if c.remat and c.remat_policy not in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat_policy {c.remat_policy!r} is not ported yet (ROADMAP: "
            f"port Queue 1, remaining remat policies); ported: "
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
