"""The grouped matrix product of the serving MoE's sort-by-expert form
(the port's counterpart of XLA's ``lax.ragged_dot`` in
``deepspeed_tpu/moe/sharded_moe.py`` ``moe_ffn_grouped``: no Pallas
kernel computes it in the JAX package).

``grouped_mm(x [R, K], w [E, K, N], offsets [E] int32) -> [R, N]``: rows
``offsets[e-1] .. offsets[e]`` of ``x`` (sorted by expert) times
``w[e]``; ``offsets`` the groups' cumulative ends (``offsets[E-1] == R``,
an empty group repeats the previous end), a tensor on ``x``'s device. On
a CUDA tensor :func:`grouped_mm_kernel` launches ``csrc/grouped_gemm.cu``,
which reads the offsets on the card, so no group size comes back to the
host and a CUDA graph captures the call; on a CPU tensor the plain
version runs (:func:`grouped_mm_plain`, a product per expert). bf16, fp16
and fp32, every sum in fp32, the result in ``x``'s dtype.
"""

from __future__ import annotations

import ctypes

import torch

from . import launches, op_builder

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_variant(dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes, by dtype as ``ds_grouped_mm`` picks
    it: "tensor_cores" (bf16, fp16: WMMA fragments, fp32 accumulators) or
    "cuda_cores" (fp32: exact fp32 products)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"grouped_mm: unsupported dtype {dtype}")
    return "cuda_cores" if dtype == torch.float32 else "tensor_cores"


def _check(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_mm: x [R, K] and w [E, K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if offsets.shape != (w.shape[0],) or offsets.dtype != torch.int32:
        raise ValueError(f"grouped_mm: offsets int32 [{w.shape[0]}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if w.dtype != x.dtype:
        raise ValueError(f"grouped_mm: w is {w.dtype}, x {x.dtype}")
    if offsets.device != x.device or w.device != x.device:
        raise ValueError("grouped_mm: x, w and offsets on one device")


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, which :func:`grouped_mm` takes for CPU
    tensors: the rows cut at the offsets (``tensor_split`` reads them in
    C++, not through a Python host read) and one product per expert, an
    empty group an empty product. On CUDA tensors (the kernel's yardstick
    on the card) the cuts are read back to the host first."""
    _check(x, w, offsets)
    cuts = offsets[:-1].to(torch.int64)
    if cuts.device.type != "cpu":
        cuts = cuts.cpu()
    parts = torch.tensor_split(x, cuts)
    return torch.cat([rows @ w[e] for e, rows in enumerate(parts)])


def grouped_mm_kernel(x: torch.Tensor, w: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/grouped_gemm.cu`` on CUDA tensors (``x``, ``w``
    contiguous; the offsets read on the card). ``grouped_mm_kernel.launches``
    counts the launches, ``.variant_launches`` them by variant
    (:func:`kernel_variant`), ``.variant`` names the last; a launch inside
    a graph capture counts at each replay (``ops/launches.py``)."""
    _check(x, w, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_mm_kernel: unsupported device {x.device}")
    variant = kernel_variant(x.dtype)
    x, w, offsets = x.contiguous(), w.contiguous(), offsets.contiguous()
    rows, k = x.shape
    groups, _, n = w.shape
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows == 0 or n == 0:
        return out
    lib = op_builder.load("grouped_gemm")
    fn = lib.ds_grouped_mm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    vec = (k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0)
    err = fn(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
             _DTYPE_CODES[x.dtype], rows, k, n, groups, int(vec),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"grouped_mm kernel launch failed: CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")
    launches.count(grouped_mm_kernel, variant)
    return out


grouped_mm_kernel.launches = 0
grouped_mm_kernel.variant = None
grouped_mm_kernel.variant_launches = {}


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """``x [R, K]`` (rows sorted by group) times ``w [E, K, N]`` per group,
    the groups' cumulative ends ``offsets [E]`` (int32, on x's device):
    the kernel for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cpu":
        return grouped_mm_plain(x, w, offsets)
    return grouped_mm_kernel(x, w, offsets)


def group_offsets(sorted_ids: torch.Tensor, groups: int) -> torch.Tensor:
    """The cumulative ends [groups] (int32) of ascending group ids
    ``sorted_ids``: the count of ids at or below each group, that is the
    cumsum of a bincount. ``torch.bincount`` reads its input's extrema
    back to the host on CUDA; a search over the sorted ids reads
    nothing."""
    ids = torch.arange(groups, device=sorted_ids.device,
                       dtype=sorted_ids.dtype)
    return torch.searchsorted(sorted_ids, ids, right=True).to(torch.int32)
