"""Core neural-net ops as plain PyTorch functions (counterpart of
``deepspeed_tpu/ops/layers.py``). Norms and rotary compute in fp32 and
return the input dtype, as the JAX versions do."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm with fp32 statistics regardless of input dtype."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with fp32 statistics."""
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(dtype)


def gelu(x):
    """tanh-approximated GELU (the reference's gelu kernel)."""
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def rotary_embedding(seq_len: int, head_dim: int, theta: float = 10000.0,
                     device=None):
    """RoPE cos/sin tables [seq, head_dim//2], built in numpy float64 and
    cast to fp32 exactly as the JAX tables are."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(seq_len), inv_freq)
    return (torch.tensor(np.cos(freqs), dtype=torch.float32, device=device),
            torch.tensor(np.sin(freqs), dtype=torch.float32, device=device))


def apply_rotary(x, cos, sin, positions=None):
    """Half-split (not interleaved) rotary. x: [B, S, H, D]; cos/sin:
    [S_max, D//2]; positions: optional [B, S] absolute positions."""
    if positions is not None:
        cos = cos[positions][:, :, None, :]   # [B, S, 1, D//2]
        sin = sin[positions][:, :, None, :]
    else:
        s = x.shape[1]
        cos = cos[None, :s, None, :]
        sin = sin[None, :s, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def window_bias(seq_len: int, window: int, device=None):
    """Additive sliding-window mask: query i sees keys in (i - window, i]."""
    qi = torch.arange(seq_len, device=device)[:, None]
    ki = torch.arange(seq_len, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return torch.where(qi - ki < window, zero,
                       torch.full((), -1e30, device=device))[None, None]


def alibi_slopes(num_heads: int, device=None):
    """ALiBi per-head slopes: 2^(-8i/n) for power-of-two head counts,
    the paper's interleaved schedule otherwise."""
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * start ** i for i in range(n)]

    if math.log2(num_heads).is_integer():
        s = pow2(num_heads)
    else:
        closest = 2 ** int(math.floor(math.log2(num_heads)))
        s = pow2(closest) + pow2(2 * closest)[0::2][: num_heads - closest]
    return torch.tensor(s, dtype=torch.float32, device=device)


def alibi_bias(slopes, seq_len: int):
    """[H, S, S] additive bias slope_h * (k - q)."""
    pos = torch.arange(seq_len, device=slopes.device)
    rel = (pos[None, :] - pos[:, None]).float()
    return slopes[:, None, None] * rel[None]


def dot_product_attention(q, k, v, *, causal: bool = True, bias=None,
                          softmax_scale: float | None = None):
    """Plain attention: q, k, v [B, S, H, D]; k/v may have fewer heads
    (GQA, q head h reads kv head h // rep). Scores and softmax in fp32,
    output in q's dtype."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if softmax_scale is None:
        softmax_scale = 1.0 / np.sqrt(d)
    if hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * softmax_scale
    if bias is not None:
        logits = logits + bias
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~(qi >= ki), -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def cross_entropy_loss(logits, targets, *, ignore_index: int = -100,
                       z_loss: float = 0.0):
    """Mean token cross-entropy in fp32 with optional z-loss.

    logits: [..., V]; targets: [...] integer. Tokens equal to
    ``ignore_index`` are masked out of the mean."""
    logits = logits.float()
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, torch.zeros_like(targets))
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1,
                              safe_targets[..., None].long())[..., 0]
    nll = lse - true_logit
    if z_loss > 0.0:
        nll = nll + z_loss * lse.square()
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = torch.clamp(valid.sum(), min=1)
    return nll.sum() / count
