"""KV-pool quantization (counterpart of the KV half of
``deepspeed_tpu/ops/pallas/quantization.py``, :123-207).

The paged KV pool is quantized WRITE-ONCE per token vector: each written
(position, kv-head) vector of head_dim elements gets its own symmetric
f32 scale (granularity "head"), or one scale spans all kv heads of the
token (granularity "token"). A block fills one token at a time over many
ticks, and per-vector scales never make an earlier token's bytes depend on
a later one, so a cached block's bytes are a pure function of the tokens
written through it: the prefix cache shares quantized blocks as they are.

These are elementwise torch ops, as they are plain jnp in the JAX package;
the dequantize multiply also runs in-register inside the paged-attention
kernel (``csrc/paged_attention.cu``) on its pool tiles. On identical fp32
inputs they give the JAX functions' codes and scales bit for bit.
"""

from __future__ import annotations

import torch

KV_STORE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# symmetric range the per-vector absmax maps onto: int8 uses the ZeRO++
# [-127, 127] grid; fp8-e4m3 saturates at the format max (448)
KV_QMAX = {"int8": 127.0, "fp8": 448.0}


def kv_quantize(x: torch.Tensor, kv_dtype: str, scale_heads: int):
    """Quantize fresh KV vectors for the paged pool.

    ``x`` is ``[..., H, D]``; returns ``(codes [..., H, D] in the storage
    dtype, scales f32 [..., scale_heads])``, ``scale_heads`` being ``H``
    (one absmax per (token, kv-head) vector) or 1 (one across the token's
    heads)."""
    store = KV_STORE_DTYPES[kv_dtype]
    qmax = KV_QMAX[kv_dtype]
    h = x.shape[-2]
    xf = x.float()
    if scale_heads == 1:
        amax = xf.abs().amax(dim=(-2, -1), keepdim=True)[..., 0]
    elif scale_heads == h:
        amax = xf.abs().amax(dim=-1)
    else:
        raise ValueError(f"scale_heads {scale_heads}: {h} (per head) or 1")
    scale = torch.clamp(amax / qmax, min=1e-12)             # [..., Hs]
    y = xf / scale[..., :, None]
    if kv_dtype == "int8":
        codes = torch.clamp(torch.round(y), -127, 127).to(store)
    else:
        # e4m3 has no inf: clip before the cast so overflow saturates
        # instead of producing NaN payload bytes
        codes = torch.clamp(y, -qmax, qmax).to(store)
    return codes, scale


def kv_dequantize(codes: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`kv_quantize`: ``codes [..., H, D]`` times the
    broadcast per-vector ``scales [..., Hs]`` (``Hs`` is H or 1)."""
    return (codes.float() * scales[..., :, None]).to(dtype)


def kv_bytes_per_token(num_kv_heads: int, head_dim: int, kv_dtype: str,
                       scale_heads: int = 0) -> float:
    """Storage bytes one token's k+v vectors cost per layer in a format:
    "fp32"/"fp16"/"bf16" (and their long names) unquantized, int8/fp8
    with one f32 scale per ``scale_heads`` (0 = per head)."""
    elems = num_kv_heads * head_dim
    if kv_dtype in ("fp32", "float32"):
        return 2.0 * elems * 4
    if kv_dtype in ("fp16", "float16", "bf16", "bfloat16"):
        return 2.0 * elems * 2
    if kv_dtype in KV_STORE_DTYPES:
        hs = scale_heads or num_kv_heads
        return 2.0 * (elems * 1 + hs * 4)
    raise ValueError(f"unknown kv dtype {kv_dtype!r}")
