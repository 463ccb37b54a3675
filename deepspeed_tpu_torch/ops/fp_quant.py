"""Float quantization formats: fp8 (e4m3/e5m2), packed fp6, packed fp12
(counterpart of ``deepspeed_tpu/ops/fp_quant.py``; reference:
csrc/fp_quantizer/fp_quantize.{cpp,cu} and deepspeed/ops/fp_quantizer/).

- **fp8** uses ``torch.float8_e4m3fn`` / ``torch.float8_e5m2``: a block
  scale maps each block's absmax onto the format's max normal, then a
  dtype cast rounds.
- **fp6 / fp12** have no torch dtype: values round to the nearest
  representable magnitude of a sorted table (``torch.searchsorted`` over
  the midpoints), are encoded as ``sign << (bits - 1) | magnitude index``
  and bit-packed on uint8: four 6-bit codes into 3 bytes, two 12-bit codes
  into 3 bytes.

Formats follow the reference's (exp, man) splits: fp6 = e3m2 or e2m3
(``mantissa_bits``), fp8 = e4m3 or e5m2, fp12 = e4m7. These are torch ops
on any device, as the JAX functions are plain jnp (no Pallas kernel
computes them); on the same fp32 inputs they give the JAX functions'
codes and scales bit for bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def fp_magnitude_table(exp_bits: int, man_bits: int) -> np.ndarray:
    """Sorted non-negative magnitudes of a sign+exp+man minifloat
    (IEEE-style: subnormals at e_field=0, normals elsewhere, no inf/nan —
    the reference's formats saturate instead)."""
    bias = 2 ** (exp_bits - 1) - 1
    vals = []
    for e in range(2 ** exp_bits):
        for m in range(2 ** man_bits):
            if e == 0:  # subnormal
                v = (m / 2 ** man_bits) * 2.0 ** (1 - bias)
            else:
                v = (1 + m / 2 ** man_bits) * 2.0 ** (e - bias)
            vals.append(v)
    return np.asarray(sorted(set(vals)), np.float32)


_FORMATS = {  # q_bits -> {mantissa_bits: exp_bits}
    6: {2: 3, 3: 2},
    8: {3: 4, 2: 5},
    12: {7: 4},
}


def _table(q_bits: int, man_bits: int) -> np.ndarray:
    try:
        exp_bits = _FORMATS[q_bits][man_bits]
    except KeyError:
        raise ValueError(
            f"unsupported float format: q_bits={q_bits} "
            f"mantissa_bits={man_bits}; supported: "
            + ", ".join(f"{b}:{sorted(m)}" for b, m in _FORMATS.items()))
    return fp_magnitude_table(exp_bits, man_bits)


def _fp8_dtype(mantissa_bits: int) -> torch.dtype:
    return torch.float8_e4m3fn if mantissa_bits == 3 else torch.float8_e5m2


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal)."""
    return x / x.new_full((), c)


# ------------------------------------------------------------------ pack
def _pack(codes: torch.Tensor, q_bits: int) -> torch.Tensor:
    """[..., k] integer codes -> packed uint8. 6-bit: 4 codes/3 bytes;
    12-bit: 2 codes/3 bytes; 8-bit: identity."""
    if q_bits == 8:
        return codes.to(torch.uint8)
    c = codes.to(torch.int32)
    if q_bits == 6:
        c4 = c.reshape(*c.shape[:-1], -1, 4)
        b0 = (c4[..., 0] | (c4[..., 1] << 6)) & 0xFF
        b1 = ((c4[..., 1] >> 2) | (c4[..., 2] << 4)) & 0xFF
        b2 = ((c4[..., 2] >> 4) | (c4[..., 3] << 2)) & 0xFF
    elif q_bits == 12:
        c2 = c.reshape(*c.shape[:-1], -1, 2)
        b0 = c2[..., 0] & 0xFF
        b1 = ((c2[..., 0] >> 8) | ((c2[..., 1] & 0xF) << 4)) & 0xFF
        b2 = (c2[..., 1] >> 4) & 0xFF
    else:
        raise ValueError(f"q_bits {q_bits}")
    return torch.stack([b0, b1, b2], dim=-1).reshape(
        *c.shape[:-1], -1).to(torch.uint8)


def _unpack(packed: torch.Tensor, q_bits: int) -> torch.Tensor:
    if q_bits == 8:
        return packed.to(torch.int32)
    b = packed.to(torch.int32).reshape(*packed.shape[:-1], -1, 3)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    if q_bits == 6:
        out = torch.stack([b0 & 0x3F, ((b0 >> 6) | (b1 << 2)) & 0x3F,
                           ((b1 >> 4) | (b2 << 4)) & 0x3F, (b2 >> 2) & 0x3F],
                          dim=-1)
    elif q_bits == 12:
        out = torch.stack([(b0 | ((b1 & 0xF) << 8)) & 0xFFF,
                           ((b1 >> 4) | (b2 << 4)) & 0xFFF], dim=-1)
    else:
        raise ValueError(f"q_bits {q_bits}")
    return out.reshape(*packed.shape[:-1], -1)


def _encode(y: torch.Tensor, q_bits: int, table: np.ndarray) -> torch.Tensor:
    """Nearest magnitude of the table (ties to the lower, as JAX's
    searchsorted over the midpoints), with the sign bit on top."""
    mids = torch.from_numpy((table[1:] + table[:-1]) / 2).to(y.device)
    idx = torch.searchsorted(mids, y.abs().contiguous())
    sign = (y < 0).to(torch.int32)
    return (sign << (q_bits - 1)) | idx.to(torch.int32)


def _decode(c: torch.Tensor, q_bits: int, table: np.ndarray) -> torch.Tensor:
    mag_idx = (c & (2 ** (q_bits - 1) - 1)).long()
    sign = torch.where((c >> (q_bits - 1)) > 0, -1.0, 1.0)
    return sign * torch.from_numpy(table).to(c.device)[mag_idx]


# ------------------------------------------------------------ quantize
def fp_quantize(x: torch.Tensor, *, q_bits: int = 8, mantissa_bits: int = 3,
                group_size: int = 512):
    """Block-scaled float quantization of the flat ``x``, zero-padded to
    whole blocks. Returns (codes, scales):

    - q_bits=8: codes are a torch float8 tensor [nblocks, group]
    - q_bits=6/12: codes are packed uint8 [nblocks, group*q_bits/8]

    scales: f32 [nblocks, 1]; each block's absmax maps to the format max.
    """
    codes_per_3_bytes = {6: 4, 12: 2}.get(q_bits)
    if codes_per_3_bytes and group_size % codes_per_3_bytes != 0:
        raise ValueError(
            f"fp{q_bits} packs {codes_per_3_bytes} codes per 3 bytes: "
            f"group_size must be a multiple of {codes_per_3_bytes} "
            f"(got {group_size})")
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % group_size))
    blocks = flat.view(-1, group_size)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    if q_bits == 8:
        _table(8, mantissa_bits)   # validate the format before the cast
        dt = _fp8_dtype(mantissa_bits)
        scales = torch.clamp(_div(amax, float(torch.finfo(dt).max)),
                             min=1e-12)
        return (blocks / scales).to(dt), scales
    table = _table(q_bits, mantissa_bits)
    scales = torch.clamp(_div(amax, float(table[-1])), min=1e-12)
    return _pack(_encode(blocks / scales, q_bits, table), q_bits), scales


def fp_dequantize(codes: torch.Tensor, scales: torch.Tensor, *,
                  q_bits: int = 8, mantissa_bits: int = 3, shape=None,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`fp_quantize`; ``shape`` trims the block
    padding."""
    if q_bits == 8:
        x = codes.float() * scales
    else:
        table = _table(q_bits, mantissa_bits)
        x = _decode(_unpack(codes, q_bits), q_bits, table) * scales
    if shape is not None:
        n = math.prod(shape) if shape else 1
        x = x.reshape(-1)[:n].reshape(shape)
    return x.to(dtype)


# -------------------------------------------------------- pool rows
def fp_quantize_rows(x: torch.Tensor, *, q_bits: int = 8,
                     mantissa_bits: int = 3, group_size: int = 512):
    """Row-blocked :func:`fp_quantize` for pool shapes: ``x``'s leading
    dims are independent rows and each row's trailing axis is zero-padded
    to a multiple of ``group_size`` on its own, so no block straddles two
    rows (a row's bytes depend on its own contents only). Returns
    ``(codes [rows..., padded_or_packed], scales f32 [rows...,
    blocks_per_row])``."""
    lead, n = x.shape[:-1], x.shape[-1]
    if n == 0:
        raise ValueError("fp_quantize_rows needs a non-empty row axis")
    pad = (-n) % group_size
    rows = torch.nn.functional.pad(x.reshape(-1, n).float(), (0, pad))
    nb = (n + pad) // group_size
    blocks = rows.view(rows.shape[0], nb, group_size)
    amax = blocks.abs().amax(dim=-1)                      # [R, nb]
    if q_bits == 8:
        _table(8, mantissa_bits)
        dt = _fp8_dtype(mantissa_bits)
        scales = torch.clamp(_div(amax, float(torch.finfo(dt).max)),
                             min=1e-12)
        codes = (blocks / scales[..., None]).to(dt)
        return (codes.reshape(*lead, nb * group_size),
                scales.reshape(*lead, nb))
    table = _table(q_bits, mantissa_bits)
    scales = torch.clamp(_div(amax, float(table[-1])), min=1e-12)
    codes = _encode(blocks / scales[..., None], q_bits, table)
    packed = _pack(codes.reshape(-1, nb * group_size), q_bits)
    return (packed.reshape(*lead, packed.shape[-1]),
            scales.reshape(*lead, nb))


def fp_dequantize_rows(codes: torch.Tensor, scales: torch.Tensor, *,
                       row_len: int, q_bits: int = 8, mantissa_bits: int = 3,
                       dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`fp_quantize_rows`: each row trimmed back to
    ``row_len`` trailing elements."""
    lead = codes.shape[:-1]
    nb = scales.shape[-1]
    if q_bits == 8:
        vals = codes.float()
    else:
        c = _unpack(codes.reshape(-1, codes.shape[-1]), q_bits)
        vals = _decode(c, q_bits, _table(q_bits, mantissa_bits)).reshape(
            *lead, -1)
    group = vals.shape[-1] // nb
    vals = vals.reshape(*lead, nb, group) * scales[..., None]
    return vals.reshape(*lead, nb * group)[..., :row_len].to(dtype)


class FP_Quantize:
    """API-parity wrapper (reference: deepspeed/ops/fp_quantizer/quantize.py
    FP_Quantize.quantize/dequantize with q_bits 6/8/12)."""

    def __init__(self, group_size: int = 512):
        self.group_size = group_size

    def quantize(self, x, q_bits: int = 8, q_mantisa_bits: int = 3):
        return fp_quantize(x, q_bits=q_bits, mantissa_bits=q_mantisa_bits,
                           group_size=self.group_size)

    def dequantize(self, codes, scales, q_bits: int = 8,
                   q_mantisa_bits: int = 3, shape=None, dtype=torch.float32):
        return fp_dequantize(codes, scales, q_bits=q_bits,
                             mantissa_bits=q_mantisa_bits, shape=shape,
                             dtype=dtype)
