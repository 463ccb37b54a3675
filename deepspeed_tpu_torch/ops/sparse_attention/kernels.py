"""Block-sparse attention that skips dead blocks (counterpart of
``deepspeed_tpu/ops/sparse_attention/kernels.py``; reference:
deepspeed/ops/sparse_attention/ matmul.py SDD/DSD/DDS + softmax.py).

Work is proportional to ``layout.sum()`` instead of nq * nk: the static
``[H, nq, nk]`` block layout compiles into per-row live-block lists
(``jmap [H, nq, L]`` + ``counts [H, nq]``) and their transpose (``imap``,
``countsT``), which the kernels of ``csrc/block_sparse_attention.cu`` walk:
a forward (o and lse) and a backward of two launches (dq, then dk/dv).
bf16 and fp16 take the tensor-core (wgmma) kernels, which walk tile
groups (:func:`tile_groups`: the blocks of a head that share a list, 64
rows a group); fp32 the CUDA-core kernels, whose products stay exact fp32
(:func:`kernel_variant`). :func:`make_block_sparse_attention` returns a
differentiable function over a ``torch.autograd.Function`` whose forward
and backward are those kernels on CUDA tensors and their plain PyTorch
versions on CPU tensors.

Semantics match the dense+mask path (``sparse_self_attention.py``
``layout_to_bias``) at block granularity, with one deliberate divergence
kept from the JAX kernel: a q row whose layout row is entirely dead
returns 0, where softmax over an all-masked row in the dense path returns
the uniform average of v. Realistic layouts (fixed, BigBird, Longformer,
sliding window) keep the diagonal live, so the case never arises there.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import op_builder

NEG_INF = -1e30
MAX_KERNEL_DIM = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the C entry points' table (ds_block_sparse_attention_variant): 1 tensor
# cores, 0 CUDA cores
VARIANTS = {1: "wgmma", 0: "cuda_cores"}
GROUP_ROWS = 64                 # rows a tile group: one warpgroup's M
GROUP_COLS = 2 + GROUP_ROWS     # a group: head, the block of its list, rows


# ------------------------------------------------------------ layout maps
def build_block_maps(layout: np.ndarray):
    """[H, nq, nk] 0/1 layout -> (jmap [H, nq, L], counts [H, nq]) with L
    the max live blocks of any row; dead slots point at block 0 (never
    read: a row walks only its ``counts`` slots)."""
    live = np.asarray(layout) != 0
    h, nq, nk = live.shape
    counts = live.sum(-1).astype(np.int32)
    L = max(1, int(counts.max()))
    # lists of the distinct rows only (a layout repeats its rows), from
    # their live (row, block) pairs in row-major order: each row's blocks
    # ascending, the i-th of row r at slot i
    rows = live.reshape(h * nq, nk)
    first, inverse = _distinct_rows(np.packbits(rows, axis=-1))
    at = np.flatnonzero(rows[first])
    row, col = at // nk, at % nk
    n = counts.reshape(-1)[first]
    lists = np.zeros((len(first), L), np.int32)
    lists[row, np.arange(at.size) - (np.cumsum(n) - n)[row]] = col
    return lists[inverse].reshape(h, nq, L), counts


def _distinct_rows(rows: np.ndarray):
    """Indices of the first of each distinct row of a 2-D uint8 array, and
    each row's index into them."""
    rows = np.ascontiguousarray(rows)
    _, first, inverse = np.unique(
        rows.view(np.dtype((np.void, rows.shape[1]))).ravel(),
        return_index=True, return_inverse=True)
    return first, inverse.reshape(-1)


def build_block_maps_T(layout: np.ndarray):
    """Transposed lists: for each kv block, the q blocks attending it."""
    return build_block_maps(layout.transpose(0, 2, 1))


def sparsity_stats(layout: np.ndarray) -> dict:
    """Executed fraction of the dense block grid: the FLOP reduction the
    kernels realise."""
    h, nq, nk = layout.shape
    live = int(layout.sum())
    return {"live_blocks": live, "total_blocks": h * nq * nk,
            "density": live / (h * nq * nk)}


def supports_kernel(layout: np.ndarray, seq_len: int, head_dim: int) -> bool:
    """The JAX package's kernel-path rule (square layout, whole blocks of
    a multiple of 8, head_dim a multiple of 8), so both packages dispatch
    the same calls to the block-skipping path. On the card the kernels
    also need head_dim <= 128, and their wrappers raise above it."""
    h, nq, nk = np.asarray(layout).shape
    if nq != nk or seq_len % nq != 0:
        return False
    block = seq_len // nq
    return block % 8 == 0 and head_dim % 8 == 0 and block >= 8


def tile_groups(layout: np.ndarray, block: int) -> np.ndarray:
    """The tile groups the tensor-core kernels walk, for a [H, nq, nk]
    layout: per head, the q blocks whose layout rows (so jmap rows) are
    identical, at most ``64 // block`` of them to a group; a block over 64
    rows is split into 64-row tiles that share its list (pass the
    transposed layout for the dk/dv groups over imap). Returns int32 [G,
    66]: the head, the block whose list the group walks, then the source
    row (in [0, S)) of each of the group's 64 rows, -1 for a pad row.
    Groups are ordered by their stream's length (live blocks x block),
    longest first, so the heaviest CTAs start first."""
    live = np.asarray(layout) != 0
    h, nq, nk = live.shape
    unit = min(block, GROUP_ROWS)             # rows of one member
    per = GROUP_ROWS // unit                  # members a group
    tiles = -(-block // GROUP_ROWS)           # 64-row tiles of a block
    # class of each (head, block): the head and the layout row
    key = np.concatenate([np.repeat(np.arange(h, dtype=">u4"), nq)
                          .view(np.uint8).reshape(h * nq, 4),
                          np.packbits(live.reshape(h * nq, nk), axis=-1)], 1)
    cls = _distinct_rows(key)[1]
    # members (block, tile) in class order; a class fills ceil(size / per)
    # groups, its members in ascending block order
    unit_cls = np.repeat(cls, tiles)
    order = np.argsort(unit_cls, kind="stable")
    hb, tile = order // tiles, order % tiles
    sizes = np.bincount(unit_cls)
    starts = np.cumsum(sizes) - sizes
    rank = np.arange(order.size) - starts[unit_cls[order]]
    n_groups = -(-sizes // per)
    group = (np.cumsum(n_groups) - n_groups)[unit_cls[order]] + rank // per
    out = np.full((int(n_groups.sum()), GROUP_COLS), -1, np.int32)
    lead = rank % per == 0
    out[group[lead], 0] = hb[lead] // nq
    out[group[lead], 1] = hb[lead] % nq
    offs = tile[:, None] * GROUP_ROWS + np.arange(unit)[None, :]
    rows = (hb % nq)[:, None] * block + offs
    cols = 2 + (rank % per)[:, None] * unit + np.arange(unit)[None, :]
    ok = offs < block
    out[np.broadcast_to(group[:, None], ok.shape)[ok], cols[ok]] = rows[ok]
    length = live.sum(-1).reshape(-1)[out[:, 0] * nq + out[:, 1]]
    return out[np.argsort(-length, kind="stable")]


def tile_fill(layout: np.ndarray, block: int) -> dict:
    """The live share of the 64 x 64 tile steps the tensor-core kernels
    issue for a layout: the live blocks' area over the groups' 64-row
    tiles times their streams' 64-entry chunks, for the forward and dq
    pass (``"forward"``, jmap groups) and the dk/dv pass (``"dkv"``, imap
    groups). 1.0 where every group's rows share every key of its
    stream; lower where a layout's rows all differ."""
    live = np.asarray(layout) != 0
    need = live.sum() * block * block / GROUP_ROWS ** 2
    fill = {}
    for name, lay in (("forward", live), ("dkv", live.transpose(0, 2, 1))):
        groups = tile_groups(lay, block)
        n = lay.sum(-1)[groups[:, 0], groups[:, 1]] * block
        steps = int((-(-n // GROUP_ROWS)).sum())
        fill[name] = float(need / steps) if steps else 1.0
    return fill


class BlockMaps(NamedTuple):
    """A layout's live-block lists and tile groups on one device (int32),
    its block size, and the layout itself (bool [H, nq, nk]) for the plain
    versions."""
    jmap: torch.Tensor
    counts: torch.Tensor
    imap: torch.Tensor
    countsT: torch.Tensor
    groups: torch.Tensor      # tile groups over jmap (forward, dq)
    groupsT: torch.Tensor     # tile groups over imap (dk/dv)
    layout: torch.Tensor
    block: int


def block_maps(layout: np.ndarray, device, block: int) -> BlockMaps:
    """Build a layout's lists and tile groups on the host and copy them to
    ``device``."""
    layout = np.asarray(layout, dtype=bool)
    layout_t = np.ascontiguousarray(layout.transpose(0, 2, 1))
    arrays = (*build_block_maps(layout), *build_block_maps(layout_t),
              tile_groups(layout, block), tile_groups(layout_t, block),
              layout)
    return BlockMaps(*(torch.from_numpy(a).to(device) for a in arrays),
                     block=block)


# --------------------------------------------------------- plain versions
def live_mask(maps: BlockMaps, h: int) -> torch.Tensor:
    """Head h's layout expanded to [S, S] (True where a key is live)."""
    blk = maps.block
    return maps.layout[h].repeat_interleave(blk, 0).repeat_interleave(blk, 1)


def block_sparse_attention_fwd_plain(q, k, v, maps: BlockMaps):
    """Plain PyTorch version of the forward kernel, one head at a time
    over the dense [S, S] scores with the layout as a mask: returns o
    ([B, H, S, D], q's dtype) and lse ([B, H, S], fp32). Dead keys get
    p = 0 exactly and a row with no live key o = 0, lse = -1e30, as the
    kernel; p is rounded to q's dtype before p v. Differentiable through
    autograd (the grads of :func:`block_sparse_attention_plain`)."""
    sc = 1.0 / math.sqrt(q.shape[-1])
    outs, lses = [], []
    for h in range(q.shape[1]):
        live = live_mask(maps, h)
        s = torch.einsum("bqd,bkd->bqk", q[:, h].float(), k[:, h].float())
        s = (s * sc).masked_fill(~live, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(live, torch.exp(s - m), 0.0)
        l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        o = torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(),
                         v[:, h].float()) / l
        outs.append(o.to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    return torch.stack(outs, 1), torch.stack(lses, 1)


def block_sparse_attention_bwd_plain(q, k, v, o, lse, do, maps: BlockMaps):
    """Plain PyTorch version of the backward kernels, one head at a time:
    p recomputed from lse and rounded to the dtype, delta = rowsum(do o),
    dv = p^T do, ds = p (do v^T - delta) rounded, dk = ds^T q sc,
    dq = ds k sc. Returns dq, dk, dv in the inputs' dtypes."""
    dt = q.dtype
    sc = 1.0 / math.sqrt(q.shape[-1])
    grads = ([], [], [])
    for h in range(q.shape[1]):
        live = live_mask(maps, h)
        qh, kh, vh, doh = (t[:, h].float() for t in (q, k, v, do))
        s = torch.einsum("bqd,bkd->bqk", qh, kh) * sc
        p = torch.where(live, torch.exp(s - lse[:, h, :, None]), 0.0)
        p = p.to(dt).float()
        delta = (doh * o[:, h].float()).sum(-1, keepdim=True)
        dv = torch.einsum("bqk,bqd->bkd", p, doh)
        dp = torch.einsum("bqd,bkd->bqk", doh, vh)
        ds = (p * (dp - delta)).to(dt).float()
        dk = torch.einsum("bqk,bqd->bkd", ds, qh) * sc
        dq = torch.einsum("bqk,bkd->bqd", ds, kh) * sc
        for acc, g, like in zip(grads, (dq, dk, dv), (q, k, v)):
            acc.append(g.to(like.dtype))
    return tuple(torch.stack(g, 1) for g in grads)


# ---------------------------------------------------------------- kernels
def kernel_variant(dtype, head_dim: int) -> str | None:
    """The kernels a CUDA call of this dtype and head dim takes: "wgmma"
    (bf16, fp16: tensor-core products over tile groups), "cuda_cores"
    (fp32: exact fp32 FMAs), or None where no kernel takes it. The same
    table as the C entry points' ``ds_block_sparse_attention_variant``."""
    if (dtype not in _KERNEL_DTYPES or head_dim <= 0 or head_dim % 8
            or head_dim > MAX_KERNEL_DIM):
        return None
    return VARIANTS[int(dtype != torch.float32)]


def _kernel():
    lib = op_builder.load("block_sparse_attention")
    if lib.ds_block_sparse_attention_fwd.argtypes is None:
        lib.ds_block_sparse_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ds_block_sparse_attention_fwd.restype = ctypes.c_int
        lib.ds_block_sparse_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ds_block_sparse_attention_bwd.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib.ds_block_sparse_attention_variant.argtypes = [ctypes.c_int] * 2
        lib.ds_block_sparse_attention_variant.restype = ctypes.c_int
        lib.ds_block_sparse_attention_smem.argtypes = [ctypes.c_int] * 3
        lib.ds_block_sparse_attention_smem.restype = ctypes.c_longlong
    return lib


def _check(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"block_sparse_attention: {message}")


def _check_inputs(tensors: dict, q, maps: BlockMaps) -> None:
    """What the kernels take: CUDA tensors of one fp32/bf16/fp16 dtype,
    contiguous and 16-byte aligned, [B, H, S, D] with D a multiple of 8 up
    to 128, the layout's lists and groups for H heads of S // block
    blocks on the same card, and at most 2^31 - 1 blocks a launch."""
    b, h, s, d = q.shape
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dtype in _KERNEL_DTYPES, f"dtype {q.dtype} (fp32, bf16 or fp16)")
    for name, t in tensors.items():
        _check(t.device == q.device, f"{name} is on {t.device}, q on "
               f"{q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
        if t.is_floating_point() and name != "lse":
            _check(t.dtype == q.dtype, f"{name} dtype {t.dtype} != q dtype "
                   f"{q.dtype}")
            _check(t.shape == q.shape, f"{name} shape {tuple(t.shape)}")
    _check(d % 8 == 0 and d <= MAX_KERNEL_DIM,
           f"head_dim {d} (a multiple of 8 up to {MAX_KERNEL_DIM})")
    blk = maps.block
    _check(blk >= 8 and blk % 8 == 0 and s % blk == 0,
           f"block {blk} (a multiple of 8 dividing S {s})")
    for name in ("jmap", "counts", "imap", "countsT", "groups", "groupsT"):
        t = getattr(maps, name)
        _check(t.device == q.device and t.dtype == torch.int32
               and t.is_contiguous(), f"{name} must be int32 on {q.device}")
    _check(maps.counts.shape == (h, s // blk),
           f"layout of {tuple(maps.counts.shape)} blocks for {h} heads of "
           f"{s // blk} blocks")
    blocks = (s // 8 * b * h if q.dtype == torch.float32 else
              max(len(maps.groups), len(maps.groupsT)) * b)
    _check(blocks < 2**31, f"{b} x {h} heads x {s} rows: {blocks} blocks "
           f"(at most 2^31 - 1)")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"block-sparse attention {what} launch failed: CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")


def _count(fn, variant: str, launches: int) -> None:
    fn.launches += launches
    fn.variant = variant
    fn.variant_launches[variant] = (fn.variant_launches.get(variant, 0)
                                    + launches)


def block_sparse_attention_fwd(q, k, v, maps: BlockMaps):
    """Forward kernel (port of ``_sparse_fwd``, kernels.py:121): returns o
    ([B, H, S, D], q's dtype) and lse ([B, H, S], fp32). CPU tensors take
    :func:`block_sparse_attention_fwd_plain`; CUDA tensors launch the
    kernel or raise. ``block_sparse_attention_fwd.launches`` counts
    launches, ``.variant_launches`` them by :func:`kernel_variant`, and
    ``.variant`` names the last launch's kernels."""
    if q.device.type == "cpu":
        return block_sparse_attention_fwd_plain(q, k, v, maps)
    _check_inputs(dict(q=q, k=k, v=v), q, maps)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _kernel()
    err = lib.ds_block_sparse_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), maps.jmap.data_ptr(), maps.counts.data_ptr(),
        maps.jmap.shape[2], maps.groups.data_ptr(), len(maps.groups),
        _KERNEL_DTYPES[q.dtype], b, h, s, d, maps.block,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "forward")
    _count(block_sparse_attention_fwd, kernel_variant(q.dtype, d), 1)
    return o, lse


block_sparse_attention_fwd.launches = 0
block_sparse_attention_fwd.variant = None
block_sparse_attention_fwd.variant_launches = {}


def block_sparse_attention_bwd(q, k, v, o, lse, do, maps: BlockMaps):
    """Backward kernels (port of ``_sparse_bwd``, kernels.py:210): returns
    dq, dk, dv in the inputs' dtype. Two launches per call (dq and delta
    over the jmap lists, then dk/dv over the imap lists);
    ``block_sparse_attention_bwd.launches`` counts each launch, ``.calls``
    each call, ``.variant`` and ``.variant_launches`` as the forward's.
    CPU tensors take :func:`block_sparse_attention_bwd_plain`; CUDA
    tensors launch or raise."""
    if q.device.type == "cpu":
        return block_sparse_attention_bwd_plain(q, k, v, o, lse, do, maps)
    _check_inputs(dict(q=q, k=k, v=v, o=o, lse=lse, do=do), q, maps)
    b, h, s, d = q.shape
    _check(lse.dtype == torch.float32 and lse.shape == (b, h, s),
           f"lse {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    lib = _kernel()
    err = lib.ds_block_sparse_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), maps.jmap.data_ptr(),
        maps.counts.data_ptr(), maps.jmap.shape[2], maps.groups.data_ptr(),
        len(maps.groups), maps.imap.data_ptr(), maps.countsT.data_ptr(),
        maps.imap.shape[2], maps.groupsT.data_ptr(), len(maps.groupsT),
        _KERNEL_DTYPES[q.dtype], b, h, s, d, maps.block,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "backward")
    _count(block_sparse_attention_bwd, kernel_variant(q.dtype, d), 2)
    block_sparse_attention_bwd.calls += 1
    return dq, dk, dv


block_sparse_attention_bwd.launches = 0
block_sparse_attention_bwd.calls = 0
block_sparse_attention_bwd.variant = None
block_sparse_attention_bwd.variant_launches = {}


class _BlockSparse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, maps):
        o, lse = block_sparse_attention_fwd(q, k, v, maps)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.maps = maps
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_attention_bwd(q, k, v, o, lse,
                                                do.contiguous(), ctx.maps)
        return dq, dk, dv, None


# ---------------------------------------------------------------- public
class BlockSparseAttention:
    """A differentiable attn(q, k, v) for one static layout: the block
    lists are built once on the host, and copied to a device once, at its
    first call there (no host-to-device copy per call)."""

    def __init__(self, layout: np.ndarray, head_dim: int):
        self.layout = np.asarray(layout, dtype=bool)
        self.head_dim = head_dim          # the scale is 1 / sqrt(head_dim)
        self._maps: dict[tuple, BlockMaps] = {}

    def maps(self, device, seq_len: int) -> BlockMaps:
        """The lists on ``device`` for sequences of ``seq_len``."""
        nq = self.layout.shape[1]
        if seq_len % nq != 0:
            raise ValueError(f"sequence {seq_len} is not {nq} whole blocks")
        key = (torch.device(device), seq_len // nq)
        if key not in self._maps:
            self._maps[key] = block_maps(self.layout, *key)
        return self._maps[key]

    def __call__(self, q, k, v):
        """q, k, v: [B, H, S, D] with H the layout's heads, S its blocks
        times the block size and D the head_dim it was built for."""
        if q.shape[-1] != self.head_dim:
            raise ValueError(f"head_dim {q.shape[-1]}, built for "
                             f"{self.head_dim}")
        return _BlockSparse.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(),
                                  self.maps(q.device, q.shape[2]))


def make_block_sparse_attention(layout: np.ndarray,
                                head_dim: int) -> BlockSparseAttention:
    """Build a differentiable attn(q, k, v) for a static layout; cache it
    per (layout, shapes) so its block lists reach the device once."""
    return BlockSparseAttention(layout, head_dim)


def block_sparse_attention(q, k, v, layout: np.ndarray):
    """q/k/v: [B, H, S, D] (reference sparse-attention layout); layout:
    static 0/1 [H, S // block, S // block]. Differentiable; the kernels on
    CUDA tensors. For repeated calls prefer make_block_sparse_attention."""
    return make_block_sparse_attention(layout, q.shape[-1])(q, k, v)


def block_sparse_attention_plain(q, k, v, layout: np.ndarray):
    """Plain PyTorch version of :func:`block_sparse_attention`: the same
    function from :func:`block_sparse_attention_fwd_plain`, differentiable
    through autograd on any device."""
    maps = block_maps(layout, q.device, q.shape[2] // layout.shape[1])
    return block_sparse_attention_fwd_plain(q, k, v, maps)[0]
