"""Block quantization (counterpart of
``deepspeed_tpu/ops/pallas/quantization.py``): the ZeRO++ wire half, the
KV-pool half, and the weight-only int8 serving half.

**The wire** (:21-120, :210-225, :257-312): symmetric int8 over
512-element blocks with one fp32 scale a block, the primitive that
brackets ZeRO++'s quantized weight all-gather (qwZ,
:func:`quantized_all_gather`) and its quantized gradient reduce-scatter
(qgZ, ``runtime/comm/coalesced_collectives.py``). :func:`quantize_int8`
and :func:`dequantize_int8` launch the hand-written kernels of
``csrc/quantize_int8.cu`` on CUDA tensors and take their plain PyTorch
versions on CPU tensors; either gives the Pallas kernels' codes and
scales bit for bit. Stochastic rounding (the gradient wire's default) is
torch ops on whatever device, as it is plain jnp in the JAX package. The
fp8 wire (``zero_quantized_dtype: "fp8"``, :func:`quantize_fp8`) is e4m3
codes (``ops/fp_quant.py``'s format) over the same blocks, torch ops as it
is plain XLA in JAX (no Pallas kernel computes it); it rounds by the cast, so
it has no stochastic mode. Its codes cross the wire as their bytes
(``uint8``), since gloo moves no float8 dtype.

**The KV pool** (:123-207) is quantized WRITE-ONCE per token vector: each
written (position, kv-head) vector of head_dim elements gets its own
symmetric f32 scale (granularity "head"), or one scale spans all kv heads
of the token (granularity "token"). A block fills one token at a time over
many ticks, and per-vector scales never make an earlier token's bytes
depend on a later one, so a cached block's bytes are a pure function of
the tokens written through it: the prefix cache shares quantized blocks as
they are. These are elementwise torch ops, as they are plain jnp in the
JAX package; the dequantize multiply also runs in-register inside the
paged-attention kernel (``csrc/paged_attention.cu``) on its pool tiles. On
identical fp32 inputs they give the JAX functions' codes and scales bit
for bit.

**Weight-only int8 serving** (JAX ``linear/quantization.py``
``quantize_dense_params`` :140, ``dequantize_dense`` :176, and
``models/transformer.py`` ``_maybe_dequant`` :133): every eligible float
leaf of a DecoderLM's flat parameters (``layers/wq``) becomes
``layers/wq_q`` (int8) + ``layers/wq_s`` (one scale per output channel
over the contraction axis, -2); the embedding is never quantized. The JAX
function runs each leaf under ``jax.jit``, where XLA compiles ``amax /
127.0`` as ``amax`` times fl(1/127); the port computes the same product.
``DecoderLM`` dequantizes one layer at a time with
:func:`dequantize_dense` (torch ops: JAX leaves this to XLA's fusion and
has no kernel for it), so at most one layer's float weights exist.
``linear/quantization.py`` exports these functions as JAX's does.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..comm import comm
from . import op_builder

QBLOCK = 512  # elements per quantization block
# XLA compiles the Pallas kernel's amax / 127.0 (a division by a constant)
# as amax times the constant's fp32 reciprocal; the port does the same on
# the wire. ``exact=True`` divides instead, as the JAX package's eager
# ``linear.quantize_param`` does for LoRA's frozen base.
INV_QMAX = float(np.float32(1) / np.float32(127))
INV_FP8_MAX = float(np.float32(1) / np.float32(448))    # the fp8 wire's
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the quantize kernel's variants (the C entry's ds_quantize_int8_variant)
QUANT_VARIANTS = {0: "ragged", 1: "bulk"}


def quantize_plan(row_len: int, aligned: bool) -> str:
    """The quantize kernel a CUDA call takes, from the row length and
    whether the input starts on a 16-byte boundary alone: "bulk" when
    every block is 512 whole elements at a 16-byte boundary (rows a
    multiple of 512 long, the input aligned: TMA bulk copies through a
    ring in shared memory), else "ragged" (a warp a block, element loads
    where a vector would leave the row or its alignment). The same table
    as the C entry's ``ds_quantize_int8_variant``."""
    return QUANT_VARIANTS[int(row_len % QBLOCK == 0 and aligned)]


def _to_blocks(rows: torch.Tensor, block: int = QBLOCK) -> torch.Tensor:
    """``rows`` ``[R, L]``, each row zero-padded to a block multiple on
    its own, as fp32 ``[R * nb, block]`` (a flat tensor is one row)."""
    x32 = rows.reshape(rows.shape[0], -1).float()
    pad = (-x32.shape[1]) % block
    if pad:
        x32 = torch.nn.functional.pad(x32, (0, pad))
    return x32.view(-1, block)


def stochastic_round(y: torch.Tensor, generator: torch.Generator | None = None,
                     u: torch.Tensor | None = None) -> torch.Tensor:
    """Unbiased round-to-integer: ``floor(y + u)``, u ~ U[0, 1) drawn from
    ``generator`` on y's device (or given as ``u``). E[result] = y, so the
    wire's quantization noise averages out over steps instead of biasing
    each block toward its own grid."""
    if u is None:
        u = torch.rand(y.shape, generator=generator, device=y.device,
                       dtype=torch.float32)
    return torch.floor(y + u)


def _quantize_rows_plain(rows: torch.Tensor, rounding: str = "nearest",
                         generator=None, exact: bool = False):
    """Plain PyTorch version of the quantize kernel: each row of ``rows``
    ``[R, L]`` zero-padded to a block multiple on its own ->
    (codes int8 ``[R * nb, QBLOCK]``, scales fp32 ``[R * nb, 1]``); the
    scale is ``amax * INV_QMAX``, or with ``exact`` ``amax / 127``."""
    blocks = _to_blocks(rows)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    # a 0-d tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal
    scale = torch.clamp(amax / amax.new_full((), 127.0) if exact
                        else amax * INV_QMAX, min=1e-12)
    y = blocks / scale
    rounded = (stochastic_round(y, generator) if rounding == "stochastic"
               else torch.round(y))
    return torch.clamp(rounded, -127, 127).to(torch.int8), scale


def _dequantize_rows_plain(q, s, rows: int, row_len: int, dtype):
    """Plain PyTorch version of the dequantize kernel: ``q * s`` in fp32,
    each of ``rows`` rows trimmed to ``row_len`` -> ``[rows, row_len]``."""
    x = q.float() * s
    return x.view(rows, -1)[:, :row_len].to(dtype)


def _quant_fn(name: str, argtypes: list):
    lib = op_builder.load("quantize_int8")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launched(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")


def _check(what: str, cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {message}")


def quantize_int8_kernel(rows: torch.Tensor, exact: bool = False):
    """Launch ``csrc/quantize_int8.cu``'s quantize on ``rows`` ``[R, L]``,
    a contiguous fp32/bf16/fp16 CUDA tensor, read in place: each row cut
    into ceil(L / 512) blocks, its tail zero-padded in registers. Returns
    (codes int8 ``[R * nb, QBLOCK]``, scales fp32 ``[R * nb, 1]``); with
    ``exact`` the scale is the quotient ``amax / 127`` (LoRA's frozen
    base), else the wire's ``amax * INV_QMAX``. Port of the Pallas kernel
    at ``deepspeed_tpu/ops/pallas/quantization.py:57``;
    :func:`quantize_plan` picks the variant from the shapes and the
    input's alignment. ``quantize_int8_kernel.launches`` counts the
    launches, ``.variant_launches`` them by variant, ``.exact_launches``
    those in the exact-division mode, and ``.variant`` names the last
    call's."""
    what = "quantize_int8_kernel"
    _check(what, rows.device.type == "cuda",
           f"unsupported device {rows.device}")
    _check(what, rows.dtype in _DTYPE_CODES, f"unsupported dtype {rows.dtype}")
    _check(what, rows.dim() == 2 and rows.is_contiguous(),
           "rows must be a contiguous 2-D tensor")
    r, length = rows.shape
    nb = r * -(-length // QBLOCK)
    q = torch.empty((nb, QBLOCK), dtype=torch.int8, device=rows.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=rows.device)
    if nb == 0:
        return q, s
    lib, fn = _quant_fn("ds_quantize_int8_mode", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    err = fn(rows.data_ptr(), _DTYPE_CODES[rows.dtype], q.data_ptr(),
             s.data_ptr(), r, length, int(exact),
             torch.cuda.current_stream(rows.device).cuda_stream)
    _launched(lib, err, "quantize_int8")
    variant = quantize_plan(length, rows.data_ptr() % 16 == 0)
    quantize_int8_kernel.launches += 1
    quantize_int8_kernel.exact_launches += int(exact)
    quantize_int8_kernel.variant = variant
    by_variant = quantize_int8_kernel.variant_launches
    by_variant[variant] = by_variant.get(variant, 0) + 1
    return q, s


quantize_int8_kernel.launches = 0
quantize_int8_kernel.exact_launches = 0
quantize_int8_kernel.variant = None
quantize_int8_kernel.variant_launches = {}


def dequantize_int8_kernel(q: torch.Tensor, s: torch.Tensor, rows: int,
                           row_len: int, dtype: torch.dtype) -> torch.Tensor:
    """Launch ``csrc/quantize_int8.cu``'s dequantize: codes ``q``
    ``[rows * nb, QBLOCK]`` and scales ``s`` ``[rows * nb, 1]`` on one
    card -> ``[rows, row_len]`` in ``dtype`` (fp32/bf16/fp16), each value
    one rounded fp32 product ``q * s`` stored in ``dtype``. Port of the
    Pallas kernel at ``quantization.py:99``;
    ``dequantize_int8_kernel.launches`` counts the launches."""
    what = "dequantize_int8_kernel"
    nb = rows * -(-row_len // QBLOCK)
    _check(what, q.device.type == "cuda", f"unsupported device {q.device}")
    _check(what, s.device == q.device, f"scales are on {s.device}")
    _check(what, dtype in _DTYPE_CODES, f"unsupported dtype {dtype}")
    _check(what, q.dtype == torch.int8 and q.is_contiguous()
           and q.shape == (nb, QBLOCK),
           f"codes must be contiguous int8 [{nb}, {QBLOCK}]")
    _check(what, s.dtype == torch.float32 and s.is_contiguous()
           and s.numel() == nb, f"scales must be {nb} contiguous fp32")
    out = torch.empty((rows, row_len), dtype=dtype, device=q.device)
    if nb == 0:
        return out
    lib, fn = _quant_fn("ds_dequantize_int8", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    err = fn(q.data_ptr(), s.data_ptr(), out.data_ptr(), _DTYPE_CODES[dtype],
             rows, row_len, torch.cuda.current_stream(q.device).cuda_stream)
    _launched(lib, err, "dequantize_int8")
    dequantize_int8_kernel.launches += 1
    return out


dequantize_int8_kernel.launches = 0


def _use_kernel(use_kernel, x: torch.Tensor) -> bool:
    """None: the kernel for CUDA tensors, the plain version for CPU ones."""
    return x.device.type == "cuda" if use_kernel is None else use_kernel


def quantize_rows(rows: torch.Tensor, use_kernel: bool | None = None,
                  rounding: str = "nearest", generator=None,
                  exact: bool = False):
    """Block-quantize each row of ``rows`` ``[R, L]`` on its own (tail
    blocks zero-padded) -> (codes ``[R * nb, QBLOCK]``, scales
    ``[R * nb, 1]``). Nearest rounding takes the kernel per
    ``use_kernel``; ``rounding="stochastic"`` (needs ``generator``) is
    torch ops, as in the JAX package. ``exact`` takes the scale as the
    quotient ``amax / 127`` (see :data:`INV_QMAX`)."""
    if rounding == "stochastic":
        if generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        return _quantize_rows_plain(rows, rounding, generator, exact)
    if rounding != "nearest":
        raise ValueError(f"rounding {rounding!r}: 'nearest' or 'stochastic'")
    if _use_kernel(use_kernel, rows):
        return quantize_int8_kernel(rows.contiguous(), exact)
    return _quantize_rows_plain(rows, exact=exact)


def dequantize_rows(q, s, rows: int, row_len: int,
                    dtype: torch.dtype = torch.float32,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` -> ``[rows, row_len]`` in
    ``dtype``."""
    if _use_kernel(use_kernel, q):
        return dequantize_int8_kernel(q, s, rows, row_len, dtype)
    return _dequantize_rows_plain(q, s, rows, row_len, dtype)


def quantize_int8(x: torch.Tensor, use_kernel: bool | None = None,
                  rounding: str = "nearest", generator=None,
                  exact: bool = False):
    """-> (q int8 ``[nblocks, QBLOCK]``, scales fp32 ``[nblocks, 1]``,
    meta): the flat tensor zero-padded to ``[nblocks, 512]``, per block
    ``scale = max(amax * INV_QMAX, 1e-12)`` (with ``exact``: ``amax /
    127``) and ``q = clip(round(x / scale), -127, 127)``. ``use_kernel``
    is the counterpart of the JAX ``use_pallas``: None takes the kernel
    for CUDA tensors and the plain version for CPU tensors.
    ``rounding="stochastic"`` (with a ``generator``) rounds ``floor(y +
    u)`` with torch ops."""
    q, s = quantize_rows(x.reshape(1, -1), use_kernel, rounding, generator,
                         exact)
    return q, s, (x.shape, x.dtype, x.numel())


def dequantize_int8(q, s, meta, use_kernel: bool | None = None
                    ) -> torch.Tensor:
    """``q * s`` trimmed to the quantized tensor's elements, in its shape
    and dtype (``meta`` from :func:`quantize_int8`)."""
    shape, dtype, n = meta
    return dequantize_rows(q, s, 1, n, dtype, use_kernel).view(shape)


def wire_bytes_per_element(wire_dtype: str, block: int = QBLOCK) -> float:
    """Wire bytes per payload element, per-block fp32 scales included: fp32
    4 exactly (no scales); bf16/f16 2 + 4/block; int8/fp8 1 + 4/block."""
    if wire_dtype in ("fp32", "f32", "none"):
        return 4.0
    if wire_dtype in ("bf16", "f16"):
        return 2.0 + 4.0 / block
    if wire_dtype in ("int8", "s8", "fp8", "f8"):
        return 1.0 + 4.0 / block
    raise ValueError(f"unknown wire dtype {wire_dtype!r}")


def quantize_fp8_rows(rows: torch.Tensor):
    """Each row of ``rows`` ``[R, L]`` fp8-e4m3 quantized on its own (tail
    blocks zero-padded; JAX ``vmap(quantize_fp8)``, ``ops/fp_quant.py``'s
    e4m3 format) -> (codes float8 ``[R * nb, QBLOCK]``, scales fp32
    ``[R * nb, 1]``): each block's absmax maps onto 448 and the cast
    rounds. The scale is ``amax * fl(1/448)``, as XLA compiles JAX's
    ``amax / 448`` inside the jitted step (an eager JAX call divides)."""
    blocks = _to_blocks(rows)
    scale = torch.clamp(blocks.abs().amax(dim=-1, keepdim=True)
                        * INV_FP8_MAX, min=1e-12)
    return (blocks / scale).to(torch.float8_e4m3fn), scale


def quantize_fp8(x: torch.Tensor):
    """The flat ``x`` fp8-quantized -> (codes float8 ``[nblocks,
    QBLOCK]``, scales fp32 ``[nblocks, 1]``, meta) (JAX
    ``quantization.py:210`` in the jitted step)."""
    q, s = quantize_fp8_rows(x.reshape(1, -1))
    return q, s, (x.shape, x.dtype, x.numel())


def dequantize_fp8(q, s, meta) -> torch.Tensor:
    """``q * s`` in fp32 trimmed to the tensor, in its shape and dtype."""
    shape, dtype, n = meta
    return _dequantize_rows_plain(q, s, 1, n, dtype).view(shape)


def wire_quantize_rows(rows: torch.Tensor, wire_dtype: str = "int8",
                       use_kernel: bool | None = None,
                       rounding: str = "nearest", generator=None):
    """The wire's quantize of each row of ``rows`` (JAX ``_quant_rows``):
    int8 (:func:`quantize_rows`) or fp8 (:func:`quantize_fp8_rows`, which
    rounds by the cast whatever ``rounding`` says)."""
    if wire_dtype == "fp8":
        return quantize_fp8_rows(rows)
    return quantize_rows(rows, use_kernel, rounding, generator)


def wire_dequantize_rows(q, s, rows: int, row_len: int,
                         dtype: torch.dtype = torch.float32,
                         use_kernel: bool | None = None) -> torch.Tensor:
    """Inverse of :func:`wire_quantize_rows`: the int8 kernel (or its
    plain version) for int8 codes, ``q * s`` in fp32 for fp8 codes."""
    if q.dtype == torch.int8:
        return dequantize_rows(q, s, rows, row_len, dtype, use_kernel)
    return _dequantize_rows_plain(q, s, rows, row_len, dtype)


def wire_view(codes: torch.Tensor) -> torch.Tensor:
    """The codes as gloo moves them: fp8 codes as their bytes (a view)."""
    return codes.view(torch.uint8) if codes.is_floating_point() else codes


def quantized_all_gather(x: torch.Tensor, dim: int = 0, group=None,
                         use_kernel: bool | None = None,
                         wire_dtype: str = "int8") -> torch.Tensor:
    """ZeRO++ qwZ: quantize this rank's shard ``x``, all-gather the int8
    (or fp8) codes and fp32 scales over ``group``, dequantize every rank's
    piece in one launch straight into x's dtype, and reassemble the pieces
    along ``dim`` (rank order). JAX: ``quantization.py:281``."""
    world = comm.get_world_size(group)
    q, s = wire_quantize_rows(x.reshape(1, -1), wire_dtype, use_kernel)
    qg = comm.all_gather(wire_view(q), group=group).view(q.dtype)
    sg = comm.all_gather(s, group=group)           # [world * nb, 1]
    pieces = wire_dequantize_rows(qg, sg, world, x.numel(), x.dtype,
                                  use_kernel)
    return comm.assemble(pieces.view(world, *x.shape), dim)


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


# ---------------------------------------------------------------------
# Weight-only int8 serving over the port's flat parameter names.


def quantizable_leaf(shape, ndim: int, path: tuple,
                     min_size: int = 1 << 16) -> bool:
    """The eligibility predicate of weight-only int8 leaves (JAX
    ``quantizable_leaf``): layer-stacked matrices (ndim >= 3; a per-layer
    [L, d] norm or bias vector is never scaled over the layer axis) or
    top-level 2-D matrices (lm_head), matrix-like trailing dims, and big
    enough to be worth scales. ``path`` is the leaf's parent names."""
    return ((ndim >= 3 or (ndim == 2 and "layers" not in path))
            and min(shape[-2], shape[-1]) >= 8
            and math.prod(shape) >= min_size)


def quantizes(name: str, leaf, min_size: int = 1 << 16) -> bool:
    """Whether :func:`quantize_dense_params` quantizes the flat leaf
    ``name`` (``"layers/wq"``): a float matrix under :func:`
    quantizable_leaf`, never under ``embed/``."""
    *path, _ = name.split("/")
    if path[:1] == ["embed"] or leaf.dim() < 2 \
            or not leaf.dtype.is_floating_point:
        return False
    return quantizable_leaf(tuple(leaf.shape), leaf.dim(), tuple(path),
                            min_size)


@torch.no_grad()
def quantize_dense_leaf(w: torch.Tensor, scale_dtype=torch.bfloat16):
    """One leaf's (int8 codes, scales over axis -2 in ``scale_dtype``): the
    JAX ``_q_leaf`` as XLA compiles it (``amax * fl(1/127)``, then
    ``round(w / s)``), a layer of a stacked leaf at a time so that the
    fp32 temporaries stay one layer's."""
    if w.dim() > 2:
        parts = [quantize_dense_leaf(w[i], scale_dtype)
                 for i in range(w.shape[0])]
        return (torch.stack([q for q, _ in parts]),
                torch.stack([s for _, s in parts]))
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) * INV_QMAX,
                    min=1e-12)
    q = torch.round(w32 / s).to(torch.int8)
    return q, s.to(scale_dtype)


def quantize_dense_params(params: dict, min_size: int = 1 << 16,
                          scale_dtype=torch.bfloat16) -> dict:
    """Weight-only int8 over flat DecoderLM parameters: every eligible
    float leaf (:func:`quantizes`) becomes ``name_q`` (int8) + ``name_s``
    (per-output-channel scale in ``scale_dtype``); the rest pass as they
    are. Leaf by leaf, on each leaf's device."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, torch.Tensor) and quantizes(name, leaf, min_size):
            out[name + "_q"], out[name + "_s"] = quantize_dense_leaf(
                leaf, scale_dtype)
        else:
            out[name] = leaf
    return out


def dequantize_weight(q: torch.Tensor, s: torch.Tensor, dtype
                      ) -> torch.Tensor:
    """JAX's ``q.astype(dtype) * s.astype(dtype)`` in one pass: the int8
    codes times the scales in ``dtype`` promote to ``dtype``, and PyTorch
    forms the product in fp32 and rounds it once. A code is exact in
    ``dtype`` and the fp32 product of the two exact, so the bits are the
    two-step result's, at 1 byte read and 2 written an element instead
    of 5 and 4."""
    return q * s.to(dtype)


def dequantize_dense(tree: dict, dtype) -> dict:
    """Dequantize one level of :func:`quantize_dense_params` (a layer's
    parameters, or the top level for the head): ``name_q`` times
    ``name_s`` in ``dtype`` (:func:`dequantize_weight`) in place of each
    pair, the rest as they are."""
    if not any(k.endswith("_q") for k in tree):
        return tree
    out = {k: v for k, v in tree.items()
           if not (k.endswith("_q") or k.endswith("_s"))}
    for k in tree:
        if k.endswith("_q"):
            out[k[:-2]] = dequantize_weight(tree[k], tree[k[:-2] + "_s"],
                                            dtype)
    return out
