"""The grouped matrix product of the serving MoE's sort-by-expert form
(the port's counterpart of XLA's ``lax.ragged_dot`` in
``deepspeed_tpu/moe/sharded_moe.py`` ``moe_ffn_grouped``: no Pallas
kernel computes it in the JAX package).

``grouped_mm(x [R, K], w [E, K, N], offsets [E] int32, scales=None) ->
[R, N]``: rows ``offsets[e-1] .. offsets[e]`` of ``x`` (sorted by expert)
times ``w[e]``; ``offsets`` the groups' cumulative ends (``offsets[E-1] ==
R``, an empty group repeats the previous end), a tensor on ``x``'s device.
``w`` may be int8 codes with their per-column ``scales [E, 1, N]`` (the
``quantize_experts`` layout, scales in fp32 or x's dtype): each weight is
then ``dequantize_weight``'s value (the scale rounded to x's dtype, the
product rounded once), formed inside the kernel, so no dequantized copy of
the experts is written. On a CUDA tensor :func:`grouped_mm_kernel` launches
``csrc/grouped_gemm.cu``, which reads the offsets on the card, so no group
size comes back to the host and a CUDA graph captures the call; on a CPU
tensor the plain version runs (:func:`grouped_mm_plain`, a product per
expert). bf16, fp16 and fp32, every sum in fp32, the result in ``x``'s
dtype.

The kernel's variants (:func:`kernel_plan`, from the shapes alone):

- ``wgmma_decode`` (a few rows a group, as at a decode step): bound by
  bytes, every weight of every expert that holds a row read once. The
  operands are swapped (the weight columns are wgmma's 64 rows, the
  group's 8-32 rows its N), so each weight byte is read once a row tile
  and no tensor-core fragment is mostly zeros; an eight-stage TMA ring
  keeps the weights streaming.
- ``wgmma_prefill`` (many rows a group): bound by operations; 128 x 256
  tiles, two consumer warpgroups, a four-stage TMA ring; the row tiles of
  a column slab run side by side, so the slab comes from HBM about once,
  and a tile's results leave through shared memory in whole 16-byte
  chunks.
- ``*_int8``: int8 weights, the stage's codes converted into a 2-byte
  operand tile in shared memory (half the weight bytes of bf16).
- ``cuda_cores`` / ``cuda_cores_int8``: fp32 (exact fp32 products, no
  TF32), and bf16/fp16 where TMA cannot take the shapes (K or N not a
  multiple of 8, int8 N not of 16, x or w off a 16-byte boundary, more
  than 256 groups).

Both wgmma forms run a persistent grid of one block an SM over the list of
(group, column tile, row tile) tiles, which each block builds from the
device offsets.
"""

from __future__ import annotations

import ctypes

import torch

from . import launches, op_builder
from .quantization import dequantize_weight

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FORM_CODES = {"cuda_cores": 0, "wgmma_prefill": 1, "wgmma_decode": 2}
# the decode form serves calls whose groups hold at most this many rows on
# average (ceil(R / E)), with tiles of the first of DECODE_TILE_ROWS that
# holds twice the mean; the prefill form (128-row tiles) serves the rest.
# The switch measured on the card (PERF.md, phase 3's form sweep)
DECODE_MAX_MEAN_ROWS = 16
DECODE_TILE_ROWS = (8, 16, 32)
MAX_WGMMA_GROUPS = 256


def kernel_plan(dtype: torch.dtype, rows: int, groups: int, k: int, n: int,
                int8: bool = False, aligned: bool = True
                ) -> tuple[str, str, int]:
    """(variant, form, tile rows) of a CUDA call, as the wrapper picks
    them from x's dtype, R, E, K, N, the weight type and whether x and w
    start on 16-byte boundaries: the form "wgmma_decode" (tile rows 8, 16
    or 32), "wgmma_prefill" (128) or "cuda_cores" (0); the variant the
    form, with "_int8" for int8 weights."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"grouped_mm: unsupported dtype {dtype}")
    suffix = "_int8" if int8 else ""
    if (dtype == torch.float32 or not aligned or k % 8
            or n % (16 if int8 else 8) or groups > MAX_WGMMA_GROUPS):
        return "cuda_cores" + suffix, "cuda_cores", 0
    mean = -(-rows // groups)
    if mean > DECODE_MAX_MEAN_ROWS:
        return "wgmma_prefill" + suffix, "wgmma_prefill", 128
    tile = next((t for t in DECODE_TILE_ROWS if 2 * mean <= t),
                DECODE_TILE_ROWS[-1])
    return "wgmma_decode" + suffix, "wgmma_decode", tile


def kernel_variant(x: torch.Tensor, w: torch.Tensor,
                   scales: torch.Tensor | None = None) -> str:
    """The variant a CUDA call on these tensors takes (:func:`kernel_plan`)."""
    return kernel_plan(x.dtype, x.shape[0], w.shape[0], x.shape[1],
                       w.shape[2], scales is not None,
                       x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)[0]


def _check(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
           scales: torch.Tensor | None) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"grouped_mm: x is {x.dtype}; it takes float32, "
                         f"bfloat16 or float16 rows")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_mm: x [R, K] and w [E, K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    groups, _, n = w.shape
    if offsets.shape != (groups,) or offsets.dtype != torch.int32:
        raise ValueError(f"grouped_mm: offsets int32 [{groups}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if w.dtype == torch.int8:
        if scales is None:
            raise ValueError("grouped_mm: int8 w needs its scales [E, 1, N]")
        if (tuple(scales.shape) != (groups, 1, n)
                or scales.dtype not in _DTYPE_CODES):
            raise ValueError(f"grouped_mm: scales [{groups}, 1, {n}] in "
                             f"float32, bfloat16 or float16, got "
                             f"{scales.dtype} {tuple(scales.shape)}")
        if scales.device != x.device:
            raise ValueError("grouped_mm: scales on x's device")
    elif scales is not None:
        raise ValueError("grouped_mm: scales go with int8 w only")
    elif w.dtype != x.dtype:
        raise ValueError(f"grouped_mm: w is {w.dtype}, x {x.dtype}")
    if offsets.device != x.device or w.device != x.device:
        raise ValueError("grouped_mm: x, w and offsets on one device")


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                     scales: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version, which :func:`grouped_mm` takes for CPU
    tensors: the rows cut at the offsets (``tensor_split`` reads them in
    C++, not through a Python host read) and one product per expert, an
    empty group an empty product; int8 ``w`` dequantized an expert at a
    time (``dequantize_weight``, only the experts that hold rows). On CUDA
    tensors (the kernel's yardstick on the card) the cuts are read back to
    the host first."""
    _check(x, w, offsets, scales)
    cuts = offsets[:-1].to(torch.int64)
    if cuts.device.type != "cpu":
        cuts = cuts.cpu()
    parts = torch.tensor_split(x, cuts)
    n = w.shape[2]

    def weight(e):
        return (w[e] if scales is None
                else dequantize_weight(w[e], scales[e], x.dtype))
    return torch.cat([rows @ weight(e) if rows.shape[0]
                      else x.new_empty(0, n) for e, rows in enumerate(parts)])


def grouped_mm_kernel(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                      scales: torch.Tensor | None = None, *,
                      form: str | None = None,
                      tile_rows: int = 0) -> torch.Tensor:
    """Launch ``csrc/grouped_gemm.cu`` on CUDA tensors (the offsets read on
    the card) in the form :func:`kernel_plan` picks, or in ``form`` with
    ``tile_rows`` where a measurement asks for one ("wgmma_prefill",
    "wgmma_decode" with 8, 16 or 32, "cuda_cores"; the kernel refuses a
    wgmma form the shapes do not allow). ``grouped_mm_kernel.launches``
    counts the launches, ``.variant_launches`` them by variant, ``.variant``
    names the last; a launch inside a graph capture counts at each replay
    (``ops/launches.py``)."""
    _check(x, w, offsets, scales)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_mm_kernel: unsupported device {x.device}")
    x, w, offsets = x.contiguous(), w.contiguous(), offsets.contiguous()
    if scales is not None:
        scales = scales.contiguous()
    rows, k = x.shape
    groups, _, n = w.shape
    variant, plan, tile = kernel_plan(
        x.dtype, rows, groups, k, n, scales is not None,
        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    if form is not None:
        if form not in _FORM_CODES:
            raise ValueError(f"grouped_mm_kernel: unknown form {form}")
        plan, tile = form, tile_rows
        variant = form + ("_int8" if scales is not None else "")
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows == 0 or n == 0:
        return out
    lib = op_builder.load("grouped_gemm")
    fn = lib.ds_grouped_mm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    err = fn(x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
             None if scales is None else scales.data_ptr(), out.data_ptr(),
             _DTYPE_CODES[x.dtype],
             -1 if scales is None else _DTYPE_CODES[scales.dtype],
             rows, k, n, groups, _FORM_CODES[plan], tile,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"grouped_mm kernel launch failed ({variant}): CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")
    launches.count(grouped_mm_kernel, variant)
    return out


grouped_mm_kernel.launches = 0
grouped_mm_kernel.variant = None
grouped_mm_kernel.variant_launches = {}


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
               scales: torch.Tensor | None = None) -> torch.Tensor:
    """``x [R, K]`` (rows sorted by group) times ``w [E, K, N]`` per group
    (int8 ``w`` with its ``scales [E, 1, N]``), the groups' cumulative ends
    ``offsets [E]`` (int32, on x's device): the kernel for CUDA tensors,
    the plain version for CPU ones."""
    if x.device.type == "cpu":
        return grouped_mm_plain(x, w, offsets, scales)
    return grouped_mm_kernel(x, w, offsets, scales)


def group_offsets(sorted_ids: torch.Tensor, groups: int) -> torch.Tensor:
    """The cumulative ends [groups] (int32) of ascending group ids
    ``sorted_ids``: the count of ids at or below each group, that is the
    cumsum of a bincount. ``torch.bincount`` reads its input's extrema
    back to the host on CUDA; a search over the sorted ids reads
    nothing."""
    ids = torch.arange(groups, device=sorted_ids.device,
                       dtype=sorted_ids.dtype)
    return torch.searchsorted(sorted_ids, ids, right=True).to(torch.int32)
