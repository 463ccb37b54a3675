"""Quantized frozen parameters (counterpart of
``deepspeed_tpu/linear/quantization.py``; reference:
deepspeed/linear/quantization.py QuantizedParameter + csrc/fp_quantizer).

Two halves:

**Block-quantized parameters** (LoRA's frozen base): a
:class:`QuantizedParameter` holds codes and per-block scales of the flat
tensor, zero-padded to whole blocks, and dequantizes on use. The int
format at 8 bits and 512-element blocks (the default
:class:`QuantizationConfig`) is the block quantization of the Pallas
kernels at ``deepspeed_tpu/ops/pallas/quantization.py:57`` / ``:99``: on a
CUDA tensor :func:`quantize_param` and :meth:`QuantizedParameter.
dequantized` launch the hand-written kernels of ``csrc/quantize_int8.cu``
(the quantize in its exact-division mode: the JAX function runs eagerly,
so its scale is the IEEE quotient ``amax / 127``) and raise where the
kernel cannot take the call; on a CPU tensor they take the kernels' plain
versions. 4 and 6 bits, other block sizes and the fp formats
(``ops/fp_quant.py``) have no TPU kernel in JAX and are torch ops on any
device.

**Across ranks** a LoRAModel's frozen base is split over fsdp as JAX's
``place_frozen`` splits it (``fsdp_spec_tree``, kept here as
:func:`fsdp_split_dim`): a QuantizedParameter's ``codes`` and ``scales``
each on its own dim (:meth:`QuantizedParameter.placed`), so a rank holds
a range of blocks, or of every block's columns. ``dequantize_range``
then gathers the blocks it reads from the ranks that hold them
(:class:`FrozenSplit`), so the result is the whole parameter's bit for
bit: the codes and scales are moved, not recomputed.

**Weight-only int8 serving** (``quantize_dense_params``,
``dequantize_dense`` and their helpers) lives in ``ops/quantization.py``,
beside the other quantization ops, so that ``models/`` reads it without
importing this package; it is exported from here as JAX exports it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..comm import comm
from ..ops import quantization as Q
from ..ops.quantization import (dequantize_dense,  # noqa: F401
                                dequantize_weight, quantizable_leaf,
                                quantize_dense_leaf, quantize_dense_params,
                                quantizes)
from .config import QuantizationConfig

KERNEL_BLOCK = Q.QBLOCK       # the block the quantize kernels take
FSDP_MIN_SIZE = 2 ** 12       # JAX fsdp_spec_tree min_size


def fsdp_split_dim(shape, world: int, min_size: int = FSDP_MIN_SIZE
                   ) -> int | None:
    """The dim JAX's ``fsdp_spec_tree`` splits a leaf of ``shape`` on over
    ``world`` fsdp ranks (``deepspeed_tpu/parallel/partition.py:126``):
    none below ``min_size`` elements, else the largest dim that ``world``
    divides (the first on ties), or none."""
    if world <= 1 or math.prod(shape) < min_size:
        return None
    candidates = [d for d in range(len(shape)) if shape[d] % world == 0]
    if not candidates:
        return None
    return max(candidates, key=lambda d: shape[d])


@dataclasses.dataclass(frozen=True)
class FrozenSplit:
    """A frozen leaf split on ``dim`` into ``world`` equal chunks over the
    ranks of ``group``; this rank holds chunk ``index``."""

    dim: int
    world: int
    index: int
    group: Any = None

    def full_shape(self, shard_shape) -> tuple:
        shape = list(shard_shape)
        shape[self.dim] *= self.world
        return tuple(shape)

    def rows(self, shard: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) of dim 0 of the whole leaf, from this rank's
        ``shard`` and the others' (a collective over ``group``: every rank
        calls it with the same range). Split on dim 0, each row range a
        rank holds is broadcast from it, in rank order; split on another
        dim, the ranks' pieces of those rows are all-gathered along it."""
        if self.dim != 0:
            return comm.all_gather(shard[lo:hi], group=self.group,
                                   axis=self.dim)
        per = shard.shape[0]
        pieces = []
        for r in range(lo // per, (hi - 1) // per + 1):
            a, b = max(lo, r * per), min(hi, (r + 1) * per)
            buf = (shard[a - r * per:b - r * per].clone()
                   if r == self.index else
                   torch.empty((b - a, *shard.shape[1:]), dtype=shard.dtype,
                               device=shard.device))
            pieces.append(comm.broadcast_async(buf, r, self.group))
        out = [p.wait() for p in pieces]
        return out[0] if len(out) == 1 else torch.cat(out)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the whole leaf ``full`` (a copy of its
        own, so the whole can be freed)."""
        return full.chunk(self.world, self.dim)[self.index].clone()


def _kernel_format(q_format: str, q_bits: int, group: int) -> bool:
    """The int8 kernels' format: int codes at 8 bits, 512-value blocks."""
    return q_format == "int" and q_bits == 8 and group == KERNEL_BLOCK


@dataclasses.dataclass
class QuantizedParameter:
    """Block-quantized tensor (reference: quantization.py:27): ``codes``
    (int8 ``[nblocks, group]``, torch float8 at fp 8 bits, packed uint8 for
    fp6/fp12) and fp32 ``scales`` ``[nblocks, 1]`` of the flat tensor of
    ``shape`` and ``dtype``."""

    codes: torch.Tensor
    scales: torch.Tensor
    shape: tuple = ()
    dtype: Any = torch.float32
    q_bits: int = 8
    q_format: str = "int"
    mantissa_bits: int = 3
    # placed across ranks (:meth:`placed`): how codes and scales are split
    codes_split: FrozenSplit | None = None
    scales_split: FrozenSplit | None = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nblocks(self) -> int:
        split = self.codes_split
        if split is not None and split.dim == 0:
            return self.codes.shape[0] * split.world
        return self.codes.shape[0]

    def placed(self, world: int, index: int, group=None
               ) -> "QuantizedParameter":
        """This rank's shard over ``world`` fsdp ranks (``index`` its chunk,
        ``group`` theirs), as JAX's ``place_frozen`` splits the codes
        ``[nblocks, group]`` and the scales ``[nblocks, 1]``, each under
        :func:`fsdp_split_dim`'s rule."""
        if self.codes_split is not None or self.scales_split is not None:
            raise ValueError("the parameter is placed already")
        out = {}
        for field in ("codes", "scales"):
            full = getattr(self, field)
            dim = fsdp_split_dim(tuple(full.shape), world)
            if dim is None:
                out[field], out[field + "_split"] = full, None
            else:
                split = FrozenSplit(dim, world, index, group)
                out[field], out[field + "_split"] = split.cut(full), split
        return dataclasses.replace(self, **out)

    def _blocks(self, b0: int, b1: int):
        """Codes and scales of blocks [b0, b1), gathered where placed."""
        def rows(t, split):
            return t[b0:b1] if split is None else split.rows(t, b0, b1)
        return (rows(self.codes, self.codes_split),
                rows(self.scales, self.scales_split))

    @property
    def numel(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def group_size(self) -> int:
        width = self.codes.shape[-1]
        split = self.codes_split
        if split is not None and split.dim == self.codes.ndim - 1:
            width *= split.world
        if self.q_format == "fp" and self.q_bits != 8:
            return width * 8 // self.q_bits
        return width

    @property
    def nbytes(self) -> int:
        """The bytes this rank holds (its shard, where placed)."""
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())

    def dequantized(self) -> torch.Tensor:
        """The tensor in its shape and dtype (reference:
        QuantizedParameter.dequantized())."""
        return self.dequantize_range(0, self.numel).reshape(self.shape)

    def dequantize_range(self, start: int, stop: int,
                         dtype=None) -> torch.Tensor:
        """Flat elements [start, stop) dequantized, in ``dtype`` (the
        parameter's by default): only the blocks that hold them are
        read, so a caller takes one layer of a stacked ``[L, in, out]``
        parameter at a time. Placed across ranks, those blocks are
        gathered from the ranks that hold them (a collective: every rank
        reads the same range)."""
        dtype = dtype or self.dtype
        g = self.group_size
        b0, b1 = start // g, -(-stop // g)
        codes, scales = self._blocks(b0, b1)
        off = start - b0 * g
        if self.q_format == "fp":
            from ..ops.fp_quant import fp_dequantize
            flat = fp_dequantize(codes, scales, q_bits=self.q_bits,
                                 mantissa_bits=self.mantissa_bits,
                                 dtype=dtype).reshape(-1)
            return flat[off:off + stop - start]
        if codes.is_cuda and _kernel_format("int", self.q_bits, g):
            # the kernel writes blocks b0.. trimmed to stop
            flat = Q.dequantize_int8_kernel(codes, scales, 1, stop - b0 * g,
                                            dtype)[0]
            return flat[off:]
        flat = (codes.float() * scales).reshape(-1)[off:off + stop - start]
        return flat.to(dtype)

    def to(self, device) -> "QuantizedParameter":
        return dataclasses.replace(self, codes=self.codes.to(device),
                                   scales=self.scales.to(device))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device."""
    return x / x.new_full((), c)


def quantize_param(x: torch.Tensor,
                   cfg: QuantizationConfig | None = None
                   ) -> QuantizedParameter:
    """Block quantization per ``cfg``: int 4/6/8, or float 6/8/12
    (``q_format="fp"``), of the flat ``x`` zero-padded to whole blocks.
    The default config (int, 8 bits, 512-value blocks) launches the
    quantize kernel on a CUDA tensor (exact-division mode, as the JAX
    function's eager ``amax / 127``)."""
    cfg = cfg or QuantizationConfig()
    shape = tuple(x.shape)
    if cfg.q_format == "fp":
        from ..ops.fp_quant import fp_quantize
        codes, scales = fp_quantize(x, q_bits=cfg.q_bits,
                                    mantissa_bits=cfg.mantissa_bits,
                                    group_size=cfg.group_size)
        return QuantizedParameter(codes, scales, shape, x.dtype, cfg.q_bits,
                                  "fp", cfg.mantissa_bits)
    if cfg.q_bits not in (4, 6, 8):
        raise ValueError(f"q_bits must be 4, 6 or 8, got {cfg.q_bits}")
    if _kernel_format("int", cfg.q_bits, cfg.group_size):
        codes, scales = Q.quantize_rows(x.reshape(1, -1), exact=True)
        return QuantizedParameter(codes, scales, shape, x.dtype, cfg.q_bits)
    qmax = 2 ** (cfg.q_bits - 1) - 1
    g = cfg.group_size
    flat = x.reshape(-1).float()
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % g)).view(
        -1, g)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scales = torch.clamp(_div(amax, float(qmax)), min=1e-12)
    codes = torch.clamp(torch.round(blocks / scales), -qmax, qmax).to(
        torch.int8)
    return QuantizedParameter(codes, scales, shape, x.dtype, cfg.q_bits)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, QuantizedParameter)


def dequantize_tree(tree: Any) -> Any:
    """Replace every QuantizedParameter of a (nested) dict with its
    dequantized tensor."""
    if is_quantized(tree):
        return tree.dequantized()
    if isinstance(tree, dict):
        return {k: dequantize_tree(v) for k, v in tree.items()}
    return tree
