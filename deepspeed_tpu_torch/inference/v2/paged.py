"""Paged KV attention + paged model forward (counterpart of
``deepspeed_tpu/inference/v2/paged.py``; reference:
inference/v2/kernels/ragged_ops/ — blocked_flash is a paged FlashAttention
over the block table; logits_gather picks each sequence's last-token
logits).

``paged_attention_kernel`` launches the hand-written Hopper kernels
(``csrc/paged_attention.cu``; :func:`launch_plan` picks one from the
call's shapes) on CUDA tensors and its plain PyTorch version on CPU
tensors. ``gather_pages`` + ``place_in_pages`` +
``paged_attention`` are the plain reference path, as in the JAX package.
Quantized pools (int8 or fp8-e4m3 codes with per-vector f32 scales,
``ops/quantization.py``) are read by both: the kernel dequantizes each
pool tile in-register, the reference path its gathered view.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...ops import launches, op_builder
from ...ops.norms import plain_norms
from ...ops.quantization import KV_STORE_DTYPES, kv_dequantize, kv_quantize

# head dims the kernels are compiled for: the powers of two, and 80, 96 and
# 256 for the families that have them (Phi-2; Phi-3-mini and GPT-NeoX-20B;
# GPT-J-6B)
_KERNEL_DIMS = (16, 32, 64, 80, 96, 128, 256)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pool storage codes of the kernel's C entry: 0 = q's dtype (fp pools)
_POOL_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
# the C entry's table (ds_paged_attention_variant)
VARIANTS = {0: "cuda_cores", 1: "prefill_wgmma", 2: "decode_split"}
SPLIT_ROWS = 16       # (query, head) rows a kv head serves: decode split
SPLIT_KEYS = 128      # keys a split of the decode split (see split_keys)
_GRID_YZ = 65535      # a launch grid's y and z limit


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor):
    """[num_blocks, bs, H, D] pool -> contiguous [B, smax, H, D] pages
    (clamps out-of-range table slots)."""
    b, max_blocks = block_tables.shape
    bs, h, d = pool.shape[1:]
    safe = block_tables.long().clamp(max=pool.shape[0] - 1)
    return pool[safe].reshape(b, max_blocks * bs, h, d)


def gather_scales(spool: torch.Tensor, block_tables: torch.Tensor):
    """[num_blocks, bs, Hs] scale pool -> contiguous [B, smax, Hs]
    per-token scales, through the same clamped block table as the
    payload pool."""
    b, max_blocks = block_tables.shape
    bs, hs = spool.shape[1:]
    safe = block_tables.long().clamp(max=spool.shape[0] - 1)
    return spool[safe].reshape(b, max_blocks * bs, hs)


def dequantize_pages(pool: torch.Tensor, spool: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
    """Gathered fp32 view of a quantized pool: ``codes * scale`` of each
    (token, head) vector, the product the kernel forms in-register."""
    return kv_dequantize(gather_pages(pool, block_tables),
                         gather_scales(spool, block_tables))


def place_in_pages(pages: torch.Tensor, kv: torch.Tensor, pos0: torch.Tensor,
                   true_len: torch.Tensor) -> torch.Tensor:
    """Copy of the gathered page view with this chunk's fresh k/v written
    at absolute positions [pos0, pos0+true_len) (slots past the view are
    dropped)."""
    s = kv.shape[1]
    smax = pages.shape[1]
    ar = torch.arange(s, device=kv.device)
    positions = pos0.long()[:, None] + ar[None, :]
    valid = (ar[None, :] < true_len[:, None]) & (positions < smax)
    bi, si = valid.nonzero(as_tuple=True)
    out = pages.clone()
    out[bi, positions[bi, si]] = kv[bi, si].to(pages.dtype)
    return out


def paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos0: torch.Tensor, window: int | None = None,
                    alibi_slopes: torch.Tensor | None = None):
    """q: [B, S_new, H, D]; k/v: gathered pages [B, smax, H_kv, D]
    (already holding this chunk's fresh k/v); pos0 [B] tokens cached
    before this chunk. Causal over absolute positions; ``window``
    restricts lookback (Mistral SWA); ``alibi_slopes`` [H] adds Bloom's
    per-head linear position bias. (reference: blocked_flash)"""
    b, sq, hq, d = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    if hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / np.sqrt(d)
    qpos = pos0.long()[:, None] + torch.arange(sq, device=q.device)[None, :]
    kpos = torch.arange(smax, device=q.device)[None, :]
    mask = kpos[:, None, :] <= qpos[:, :, None]               # [B, S, smax]
    if window is not None:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    if alibi_slopes is not None:
        rel = (kpos[:, None, :] - qpos[:, :, None]).float()
        logits = logits + alibi_slopes[None, :, None, None] * rel[:, None]
    logits = logits.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def paged_attention_plain(q, k_new, v_new, k_pool, v_pool, block_tables,
                          pos0, true_len, *, window: int | None = None,
                          alibi_slopes=None, k_scale=None, v_scale=None):
    """Plain PyTorch version of :func:`paged_attention_kernel`: the same
    function written on tensors (exact masked softmax in fp32 over the
    row's cached keys, positions < pos0, read through the clamped block
    table, then this chunk's fresh keys, causal). Query rows >=
    true_len come back as zeros, as the kernel writes them. With
    ``k_scale``/``v_scale`` the pools hold codes, dequantized in fp32 as
    the kernel does (never rounded to q's dtype); the fresh chunk stays
    exact."""
    b, sq, hq, d = q.shape
    hkv = k_new.shape[2]
    rep = hq // hkv
    dev = q.device
    smax = block_tables.shape[1] * k_pool.shape[1]
    if k_scale is None:
        k_pages = gather_pages(k_pool, block_tables).float()
        v_pages = gather_pages(v_pool, block_tables).float()
    else:
        k_pages = dequantize_pages(k_pool, k_scale, block_tables)
        v_pages = dequantize_pages(v_pool, v_scale, block_tables)
    k = torch.cat([k_pages, k_new.float()], 1)
    v = torch.cat([v_pages, v_new.float()], 1)
    pos0 = pos0.long()
    ar_q = torch.arange(sq, device=dev)
    ar_k = torch.arange(smax + sq, device=dev)
    is_page = ar_k < smax
    kpos = torch.where(is_page[None, :], ar_k[None, :],
                       pos0[:, None] + ar_k[None, :] - smax)     # [B, K]
    key_live = torch.where(is_page[None, :], ar_k[None, :] < pos0[:, None],
                           ar_k[None, :] - smax < true_len[:, None])
    qpos = pos0[:, None] + ar_q[None, :]                          # [B, S]
    mask = key_live[:, None, :] & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        mask &= qpos[:, :, None] - kpos[:, None, :] < window
    qg = q.float().reshape(b, sq, hkv, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) * (1.0 / np.sqrt(d))
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev).reshape(hkv, rep)
        rel = (kpos[:, None, :] - qpos[:, :, None]).float()       # [B,S,K]
        s = s + slopes[None, :, :, None, None] * rel[:, None, None]
    s = s.masked_fill(~mask[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v).reshape(b, sq, hq, d)
    row_live = ar_q[None, :] < true_len[:, None]
    out = out * row_live[:, :, None, None]
    return out.to(q.dtype)


def dead_row_attention(v_new, v_pool, block_tables, pos0, *,
                       window: int | None = None, v_scale=None, rows=None):
    """The attention output of JAX's blocked-flash kernel at a query slot
    past ``true_len`` [B, Hkv, D] (fp32): the mean of V over every key
    the kernel visits for the row, all ``bs`` slots of the pages t <
    ceil(pos0 / bs) (those of the window where one is set) and the chunk's
    S fresh keys, since every score there is -1e30 and each weighs 1. The
    port's kernel writes zeros there. Nothing reads those outputs, except
    where pad slots route: a capacity MoE layer sends them to experts, so
    they may take slots from real tokens, and there they must be JAX's.

    ``rows`` [B] bool marks the rows that hold a pad slot; the others get
    a value nobody reads, and their pages are not read from memory: every
    page the pass must not visit is block 0, which the gather then reads
    from cache. Each page is summed over its slots in fp32 and the pages
    weighted by whether the row visits them."""
    b, sq, hkv, d = v_new.shape
    nb, bs = v_pool.shape[:2]
    width = block_tables.shape[1]
    t = torch.arange(width, device=v_new.device)
    pos0 = pos0.long()
    live = t[None, :] < (pos0[:, None] + bs - 1) // bs
    if window is not None:
        live &= (t[None, :] + 1) * bs > pos0[:, None] - window
    keep = live if rows is None else live & rows[:, None]
    idx = torch.where(keep, block_tables.long().clamp(0, nb - 1), 0)
    pages = (v_pool.index_select(0, idx.reshape(-1)) if v_scale is None
             else dequantize_pages(v_pool, v_scale, idx))
    sums = pages.reshape(b, width, bs, hkv, d).sum(2, dtype=torch.float32)
    total = (sums * keep[:, :, None, None].float()).sum(1) \
        + v_new.sum(1, dtype=torch.float32)
    count = live.sum(1) * bs + sq
    return total / count[:, None, None].float()


def split_keys(dtype, head_dim: int) -> int:
    """Keys a split of the decode split: ``SPLIT_KEYS``, or half of it for
    fp32 at D 256, whose staged K and V of 128 keys (256 KiB) would pass a
    block's shared memory. The C entry's ``ds_paged_attention_split_keys``
    (the kernel's ``kSplitKeys``)."""
    return SPLIT_KEYS // 2 if dtype == torch.float32 and head_dim > 128 \
        else SPLIT_KEYS


def launch_plan(q_shape, dtype, num_kv_heads: int,
                block_tables_shape, block_size: int) -> dict:
    """The kernel a CUDA call takes, from shapes alone (never from pos0's
    or true_len's values, so the wrapper reads nothing back from the card
    and a CUDA graph can capture the call): ``variant`` ("decode_split"
    when the rows = S_new * Hq / Hkv one kv head serves are at most
    ``SPLIT_ROWS``, fp32, bf16 or fp16; else "prefill_wgmma" for bf16 and
    fp16 and "cuda_cores" for fp32; None where no kernel takes the call),
    ``splits`` (the decode split's ceil(max_blocks * bs / split_keys(dtype,
    D)), else 0) and ``workspace``, the shape of its fp32 partials [B, Hkv,
    splits, rows, D + 2] (else None). The same table as the C entry's
    ``ds_paged_attention_variant`` and ``ds_paged_attention_splits``."""
    b, sq, hq, d = q_shape
    plan = {"variant": None, "splits": 0, "workspace": None}
    if (dtype not in KERNEL_DTYPES or d not in _KERNEL_DIMS
            or num_kv_heads <= 0 or hq % num_kv_heads or sq <= 0
            or b > _GRID_YZ or num_kv_heads > _GRID_YZ):
        return plan
    rows = sq * (hq // num_kv_heads)
    if rows <= SPLIT_ROWS:
        splits = -(-block_tables_shape[1] * block_size
                   // split_keys(dtype, d))
        return {"variant": "decode_split", "splits": splits,
                "workspace": (b, num_kv_heads, splits, rows, d + 2)}
    if dtype in (torch.bfloat16, torch.float16):
        plan["variant"] = "prefill_wgmma"
    elif -(-rows // 16) <= _GRID_YZ:          # 16 rows a CUDA-core block
        plan["variant"] = "cuda_cores"
    return plan


def _kernel_fn():
    lib = op_builder.load("paged_attention")
    fn = lib.ds_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib.ds_paged_attention_variant.argtypes = [ctypes.c_int] * 5
        lib.ds_paged_attention_variant.restype = ctypes.c_int
        lib.ds_paged_attention_splits.argtypes = [ctypes.c_int] * 4
        lib.ds_paged_attention_splits.restype = ctypes.c_longlong
        lib.ds_paged_attention_split_keys.argtypes = [ctypes.c_int] * 2
        lib.ds_paged_attention_split_keys.restype = ctypes.c_int
        lib.ds_paged_attention_smem.argtypes = [ctypes.c_int] * 4
        lib.ds_paged_attention_smem.restype = ctypes.c_longlong
    return lib, fn


def _check(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_kernel: {message}")


def paged_attention_kernel(q, k_new, v_new, k_pool, v_pool, block_tables,
                           pos0, true_len, *, window: int | None = None,
                           alibi_slopes=None, sanitize_pools: bool = True,
                           k_scale=None, v_scale=None):
    """Blocked-flash paged attention (the port of the Pallas kernel at
    ``deepspeed_tpu/inference/v2/paged.py:61``). Reads KV pages straight
    from the pool through the block table — no gathered
    ``[B, smax, H, D]`` copy — and folds this chunk's fresh k/v in.

    q/k_new/v_new: [B, S_new, H(q/kv), D]; pools [nb, bs, Hkv, D];
    block_tables [B, max_blocks] (entries clamped); pos0/true_len [B].
    Returns [B, S_new, Hq, D] in q's dtype; rows >= true_len are zeros.

    Quantized pools: with ``k_scale``/``v_scale`` ([nb, bs, Hs] f32, Hs =
    Hkv per head or 1 per token) the pools hold int8 or float8_e4m3fn
    codes, and each pool tile is dequantized in-register
    (``code * scale[block, slot, head % Hs]``); q/k_new/v_new stay
    fp32/bf16/fp16 and the fresh chunk is folded unquantized.

    CPU tensors take :func:`paged_attention_plain`. CUDA tensors launch
    one kernel of ``csrc/paged_attention.cu`` (fp32, bf16 or fp16, D in {16,
    32, 64, 80, 96, 128, 256}, block size a multiple of 8, contiguous int32
    tables/pos0/true_len) or raise. :func:`launch_plan` picks it from
    the shapes; ``paged_attention_kernel.launches`` counts the calls,
    ``.variant_launches`` them by variant and ``.variant`` names the
    last call's.

    * "decode_split" (at most ``SPLIT_ROWS`` rows = S_new * Hq / Hkv a
      kv head: the decode ticks). Bounded by bytes: a decode row reads
      ``2 * ctx * Hkv * D * itemsize`` bytes of KV a layer (1 byte an
      element plus 4 bytes per (token, scale head) when quantized) and
      does ~1 flop a byte. Each row's context is cut into splits of
      :func:`split_keys` keys, one thread block per (split, kv head, batch
      row), so a batch of 8 fills the card; a block issues its split's
      K and V at once, keeps them in the pool's type and serves every
      (query, head) row of the GQA group from each key on the CUDA cores,
      writing fp32 partials (m, l, o) to a workspace taken here with
      ``torch.empty``; a second kernel folds them in split order, then
      the chunk's fresh keys. Everything stays fp32.
    * "prefill_wgmma" (bf16 and fp16, more rows: prefill chunks and
      mixed ticks). ~64 flops a staged byte, so tensor cores: a block of two
      warpgroups owns 128 (query, head) rows of one kv head (64 each)
      and streams 64-key chunks (32 at D 256; the cached keys gathered
      through the block table, then the fresh ones) through a 3-stage
      cp.async ring;
      S = Q K^T and O += P V by wgmma, the online softmax in registers.
      P is rounded to q's dtype before P V, where the JAX kernel rounds p
      to v's dtype; with quantized pools the JAX kernel keeps p and the
      dequantized values in fp32, and this rounding is where the kernel
      rounds more than the reference (bf16 folds each value's scale into
      P before it is rounded; fp16 writes code x scale, rounded once to
      fp16, into the V tile, since P times a small scale would leave
      fp16's normal range). A block
      whose rows are all past true_len writes zeros without reading, so
      a mixed tick's decode rows cost one block each.
    * "cuda_cores" (fp32, more rows): exact fp32 FMAs, 16 rows a block
      over 32-key tiles.

    ``sanitize_pools`` is accepted for the JAX signature and has nothing
    to select here: every kernel zero-fills the tile slots outside the
    live range instead of reading them, so dead pool slots are never used
    whatever they hold."""
    quant = k_scale is not None
    _check(quant == (v_scale is not None),
           "k_scale and v_scale come together (quantized pools) or not at "
           "all")
    if quant:
        _check(k_pool.dtype in _POOL_CODES and v_pool.dtype == k_pool.dtype,
               f"quantized pools must be int8 or float8_e4m3fn, got "
               f"{k_pool.dtype}/{v_pool.dtype}")
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_new, v_new, k_pool, v_pool, block_tables, pos0, true_len,
            window=window, alibi_slopes=alibi_slopes, k_scale=k_scale,
            v_scale=v_scale)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    b, sq, hq, d = q.shape
    nb, bs, hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    tensors = dict(q=q, k_new=k_new, v_new=v_new, k_pool=k_pool,
                   v_pool=v_pool, block_tables=block_tables, pos0=pos0,
                   true_len=true_len)
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        _check(t.device == q.device, f"{name} is on {t.device}, q on "
               f"{q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    # the kernel reads these with 16-byte loads
    for name in ("k_new", "v_new", "k_pool", "v_pool", "k_scale", "v_scale"):
        _check(name not in tensors or tensors[name].data_ptr() % 16 == 0,
               f"{name} is not 16-byte aligned")
    _check(q.dtype in KERNEL_DTYPES, f"dtype {q.dtype} (fp32, bf16 or "
           "fp16)")
    for name in ("k_new", "v_new") + (() if quant else ("k_pool", "v_pool")):
        _check(tensors[name].dtype == q.dtype, f"{name} dtype "
               f"{tensors[name].dtype} != q dtype {q.dtype}")
    for name in ("block_tables", "pos0", "true_len"):
        _check(tensors[name].dtype == torch.int32, f"{name} must be int32")
    _check(d in _KERNEL_DIMS, f"head_dim {d}: the kernels take {_KERNEL_DIMS}"
           " (other head dims: ROADMAP Slice C item 9)")
    _check(bs % 8 == 0, f"block size {bs} (a multiple of 8)")
    _check(hkv > 0 and hq % hkv == 0, f"{hq} q heads over {hkv} kv heads")
    _check(k_new.shape == (b, sq, hkv, d) and v_new.shape == k_new.shape,
           f"k_new/v_new shape {tuple(k_new.shape)}")
    _check(k_pool.shape == (nb, bs, hkv, d) and v_pool.shape == k_pool.shape,
           f"pool shape {tuple(k_pool.shape)}")
    hs = 0
    if quant:
        hs = k_scale.shape[-1]
        _check(k_scale.shape == (nb, bs, hs) and hs in (hkv, 1)
               and v_scale.shape == k_scale.shape,
               f"scale shape {tuple(k_scale.shape)} (want [{nb}, {bs}, "
               f"{hkv} or 1])")
        _check(k_scale.dtype == torch.float32
               and v_scale.dtype == torch.float32, "scales must be float32")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == b,
           f"block_tables shape {tuple(block_tables.shape)}")
    _check(pos0.shape == (b,) and true_len.shape == (b,),
           "pos0/true_len must be [B]")
    _check(window is None or window > 0, f"window {window}")
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=q.device).contiguous()
        _check(slopes.shape == (hq,), f"alibi_slopes shape "
               f"{tuple(slopes.shape)}")
    plan = launch_plan(q.shape, q.dtype, hkv, block_tables.shape, bs)
    variant = plan["variant"]
    _check(variant is not None, f"no kernel variant takes B {b} x "
           f"{hkv} kv heads x {sq} rows (grid y/z limit {_GRID_YZ})")
    out = torch.empty_like(q)
    ws = (torch.empty(plan["workspace"], dtype=torch.float32,
                      device=q.device) if plan["workspace"] else None)
    lib, fn = _kernel_fn()
    err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None, block_tables.data_ptr(),
             pos0.data_ptr(), true_len.data_ptr(),
             None if slopes is None else slopes.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(),
             KERNEL_DTYPES[q.dtype], _POOL_CODES[k_pool.dtype] if quant
             else 0, b, sq, hq, hkv, d, nb, bs, hs,
             block_tables.shape[1], window or 0, plan["splits"],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")
    launches.count(paged_attention_kernel, variant)
    return out


paged_attention_kernel.launches = 0
paged_attention_kernel.variant = None
paged_attention_kernel.variant_launches = {}


def _write_plan(block_tables, positions, valid, block_size: int,
                num_blocks: int):
    """Where a chunk's k/v go in the pools, at a static shape (the JAX
    forward sends an invalid slot's write to block ``nb`` and drops it,
    ``deepspeed_tpu/inference/v2/paged.py:426-430``; here nothing may be
    read back to the host, so the shape of the write cannot depend on
    ``true_len``).

    ``positions``/``valid`` [B, S]. Returns ``(src, tgt, any_valid)``
    over the B * S flattened slots: slot i writes row ``src[i]`` of the
    chunk's k/v at pool row ``tgt[i]`` (block * block_size + offset). A
    valid slot writes its own value at its own place. An invalid one (a
    row past ``true_len``, an inactive or pad row) repeats the first valid
    slot's write, same value at the same place, so no order of the
    duplicate writes changes a byte; with no valid slot at all, each
    writes back the value its own (clamped) place holds. Valid slots never
    share a place: each position lies in a block of its own sequence."""
    width = block_tables.shape[1]
    pos = positions.long()
    col = (pos // block_size).clamp(0, width - 1)
    blk = torch.gather(block_tables.long(), 1, col).clamp(0, num_blocks - 1)
    slot = (blk * block_size + pos % block_size).reshape(-1)
    valid = valid.reshape(-1)
    any_valid = valid.any()
    first = torch.argmax(valid.to(torch.int32)).reshape(1)
    rows = torch.arange(valid.numel(), device=valid.device)
    src = torch.where(valid, rows, first)
    tgt = torch.where(valid | ~any_valid, slot, slot.index_select(0, first))
    return src, tgt, any_valid


def indexable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as index_select / index_copy_ / where take it: fp8 codes have
    no kernels of their own, so their bytes move as uint8."""
    if t.is_floating_point() and t.element_size() == 1:
        return t.view(torch.uint8)
    return t


def _pool_write(pool: torch.Tensor, new: torch.Tensor, plan) -> None:
    """Write ``new`` ([L, B * S, ...], every layer's chunk k, v, codes or
    scales) into ``pool`` [L, nb, bs, ...] as :func:`_write_plan` says:
    one gather of the sources, one of the slots' old values (what an
    all-invalid chunk writes back), one select and one copy a pool."""
    src, tgt, any_valid = plan
    pool, new = indexable(pool), indexable(new)
    flat = pool.view(pool.shape[0], -1, *pool.shape[3:])
    vals = torch.where(any_valid, new.index_select(1, src),
                       flat.index_select(1, tgt))
    flat.index_copy_(1, tgt, vals)


@torch.no_grad()
def paged_forward(model, pools: dict, tokens: torch.Tensor,
                  pos0: torch.Tensor, block_tables: torch.Tensor,
                  true_len: torch.Tensor, use_kernel: bool = True,
                  attention=None, all_logits: bool = False,
                  pads: bool = True):
    """Full model pass over a chunk of new tokens with paged KV.

    tokens [B, S]; pos0 [B]; block_tables [B, max_blocks]; true_len [B]
    new-token counts (slots beyond are ignored). Returns
    (last-valid-token logits [B, V], pools): the vocab projection runs
    only on each row's last pending token (logits_gather).
    ``all_logits=True`` projects every chunk position instead ([B, S,
    V]): the speculative verify needs the next-token distribution after
    each draft slot; slots at or past ``true_len`` carry logits the
    caller must not read.
    ``attention`` stands in for :func:`paged_attention_kernel` (same
    signature), for a harness that checks or times each layer's call.

    The pools (``{"k", "v"}``, [L, nb, bs, Hkv, D]) are updated IN PLACE
    after the last layer, every layer's k/v at once as the JAX forward
    scatters them after its layer scan, at the chunk's valid slots only,
    by a write of static shape that reads nothing back to the host
    (:func:`_write_plan`), so a CUDA graph can capture the pass. Writing
    after the layers is exact because attention reads pool pages only at
    positions < pos0 and takes this chunk's k/v from k_new/v_new (the
    plain path patches them into its gathered copy).

    Quantized pools: when ``pools`` also carries ``"ks"``/``"vs"``
    ([L, nb, bs, Hs] f32), ``"k"``/``"v"`` hold int8 or fp8 codes. The
    kernel dequantizes pool tiles in-register; the reference path
    (``use_kernel=False``) dequantizes its gathered view and rounds it
    to the compute dtype, as the JAX reference path does. Each fresh
    (token, head) vector is quantized once, at its pool write, with its
    own scale, so a block's bytes depend only on the tokens written
    through it; a token's own chunk attends to its exact k/v.

    Norms: the kernel of ``ops/norms.py`` on CUDA; ``use_kernel=False``
    takes their plain versions as well, so that pass is plain throughout.

    ``pads=False`` says that no slot lies past ``true_len`` (the caller
    knows it on the host), so a model whose pad slots route skips their
    attention values (:func:`dead_row_attention`).
    """
    with plain_norms(not use_kernel):
        return _paged_layers(model, pools, tokens, pos0, block_tables,
                             true_len, use_kernel, attention, all_logits,
                             pads)


def _paged_layers(model, pools, tokens, pos0, block_tables, true_len,
                  use_kernel, attention, all_logits, pads):
    b, s = tokens.shape
    dev = tokens.device
    ar = torch.arange(s, device=dev)
    positions = pos0.long()[:, None] + ar[None, :]
    x = model.embed(tokens, positions=positions)
    attend = attention or paged_attention_kernel
    alibi = model._alibi_slopes
    window = model.config.sliding_window
    bs = pools["k"].shape[2]
    quant = "ks" in pools
    if quant:
        kv_dtype = next(n for n, t in KV_STORE_DTYPES.items()
                        if t == pools["k"].dtype)
        hs = pools["ks"].shape[-1]
    # pool slots this chunk writes, at a static shape (see _write_plan)
    plan = _write_plan(block_tables, positions,
                       ar[None, :] < true_len[:, None], bs,
                       pools["k"].shape[1])
    fresh = []                  # each layer's chunk k/v, written at the end
    # pad slots that route through a capacity MoE layer get JAX's values
    routes_pads = pads and model.routes_pads
    if routes_pads:
        slot_live = ar[None, :] < true_len[:, None]
        pad_rows = true_len < s
    for layer in range(model.config.num_layers):
        p = model.layer_params(layer)
        k_pool, v_pool = pools["k"][layer], pools["v"][layer]
        k_scale = pools["ks"][layer] if quant else None
        v_scale = pools["vs"][layer] if quant else None
        h = model._norm(x, p["ln1_scale"], p.get("ln1_bias"))
        q, k, v = model._qkv(p, h, positions)
        if use_kernel and q.shape[-1] % 8 == 0 and bs % 8 == 0:
            # the engine's pools are zero-initialized, and the kernel
            # never reads dead slots anyway
            a = attend(
                q, k, v, k_pool, v_pool, block_tables, pos0, true_len,
                window=window, alibi_slopes=alibi, sanitize_pools=False,
                k_scale=k_scale, v_scale=v_scale)
        else:
            if quant:
                k_pages = dequantize_pages(k_pool, k_scale,
                                           block_tables).to(k.dtype)
                v_pages = dequantize_pages(v_pool, v_scale,
                                           block_tables).to(v.dtype)
            else:
                k_pages = gather_pages(k_pool, block_tables)
                v_pages = gather_pages(v_pool, block_tables)
            k_pages = place_in_pages(k_pages, k, pos0, true_len)
            v_pages = place_in_pages(v_pages, v, pos0, true_len)
            a = paged_attention(q, k_pages, v_pages, pos0, window=window,
                                alibi_slopes=alibi)
        if routes_pads:
            dead = dead_row_attention(
                v, v_pool, block_tables, pos0, window=window,
                v_scale=v_scale, rows=pad_rows).repeat_interleave(q.shape[2] // v.shape[2],
                                                   dim=1)
            a = torch.where(slot_live[:, :, None, None], a,
                            dead[:, None].to(a.dtype))
        fresh.append((k, v))
        if model.config.parallel_residual:
            m, _ = model._mlp(p, model._parallel_mlp_input(p, x, h))
            x = x + model._attn_out(p, a) + m
        else:
            x = x + model._attn_out(p, a)
            x, _ = model._mlp_residual(p, x)
    # in-place pool write of every layer's chunk k/v (see docstring)
    new = {n: torch.stack([kv[i] for kv in fresh]).flatten(1, 2)
           for i, n in enumerate("kv")}                    # [L, B*S, H, D]
    if quant:
        # k and v quantized together: one set of launches for both
        codes, scales = kv_quantize(torch.stack((new["k"], new["v"])),
                                    kv_dtype, hs)
        new = {"k": codes[0], "v": codes[1], "ks": scales[0],
               "vs": scales[1]}
    for n, t in new.items():
        _pool_write(pools[n], t.to(pools[n].dtype), plan)
    if all_logits:
        # speculative verify: every slot's next-token distribution
        return model.unembed(x), pools
    # logits_gather: project only each row's last valid position
    idx = (true_len.long() - 1).clamp(0, s - 1)
    x_last = x[torch.arange(b, device=dev), idx]
    logits = model.unembed(x_last[:, None, :])[:, 0]
    return logits, pools


@torch.no_grad()
def _fused_tick(model, pools, tokens, pos, block_tables, active,
                      remaining, row_keys, out_col, steps, *, eos: int,
                      temperature: float, top_k: int, top_p: float,
                      use_kernel: bool = True) -> torch.Tensor:
    """One tick of :func:`fused_decode_loop`, on its operands in place:
    forward over each row's pending token, sample its successor with the
    key of the successor's position, write it to ``out_col`` (-1 for an
    inactive row), then advance ``pos``/``remaining`` and end rows at EOS
    or budget. ``steps`` counts the tick when some row is active at its
    start. Returns the tick's logits [B, V]."""
    from ...ops import sampling
    tl = active.to(torch.int32)          # inactive rows write nothing
    steps.add_(active.any().to(steps.dtype))
    logits, _ = paged_forward(model, pools, tokens[:, None], pos,
                              block_tables, tl, use_kernel=use_kernel)
    # the sampled token's absolute index is pos + 1 (its input sits at
    # pos); keying on it makes sampling dispatch-schedule-free. The JAX
    # loop is compiled, so its temperature is a reciprocal product.
    keys = sampling.position_keys(row_keys, pos.long() + 1)
    nxt = sampling.sample_tokens_batched(
        logits, keys, temperature=temperature, top_k=top_k, top_p=top_p,
        reciprocal=True)
    out_col.copy_(torch.where(active, nxt, -1))
    pos.add_(tl)
    remaining.sub_(tl)
    tokens.copy_(torch.where(active, nxt, tokens))
    active.logical_and_((remaining > 0) & (nxt != eos))
    return logits


@torch.no_grad()
def fused_decode_loop(model, pools: dict, tokens: torch.Tensor,
                      pos: torch.Tensor, block_tables: torch.Tensor,
                      active: torch.Tensor, remaining: torch.Tensor,
                      row_keys: torch.Tensor, *, num_steps: int,
                      eos_id: int | None, temperature: float, top_k: int,
                      top_p: float, use_kernel: bool = True, out=None,
                      steps=None, logits_out=None):
    """Up to ``num_steps`` decode ticks with no host in the loop: forward
    -> in-graph sampling -> the sampled token fed back as the next tick's
    input, with KV writes, EOS/budget termination and the output buffer
    all on the device (port of the JAX ``lax.while_loop`` at
    ``deepspeed_tpu/inference/v2/paged.py:464``).

    The carry lives in the operands, which the loop updates IN PLACE:

    - ``tokens`` [B] int64: each row's last sampled token, committed to
      the history but not yet in the KV cache (tick j writes it at ``pos``
      and samples its successor);
    - ``pos`` [B] int32: tokens already cached (the write position);
    - ``active`` [B] bool: rows that still decode; a row goes inactive on
      the device when it samples ``eos_id`` or spends ``remaining``, and
      then writes no KV and emits nothing;
    - ``remaining`` [B] int32: tokens the row may still emit;
    - ``row_keys`` [B, 2]: per-row threefry keys; each tick folds in the
      sampled token's position (``ops/sampling.position_keys``).

    ``block_tables`` must already cover every position the loop can write
    (``DSStateManager.reserve``). On the card the engine captures this
    function as a CUDA graph over operands at fixed addresses
    (``inference/v2/fused_graph.py``), and a graph runs every tick it
    captured: after the last row ends, the remaining ticks change nothing
    (every write goes back unchanged, nothing is emitted) and
    ``steps_run`` counts, as JAX's exit test does, only the ticks that
    started with a row active. On the CPU the loop stops there, as
    JAX's does.

    ``out`` [B, num_steps] (filled with -1 first) and ``steps`` [] take
    the results in place when given; ``logits_out`` [B, V] receives the
    last tick's logits. Returns ``(out_tokens [B, num_steps] (-1 beyond
    each row's emits), steps_run [], tokens, pos, active, remaining,
    pools)``, the JAX loop's tuple."""
    b = tokens.shape[0]
    dev = tokens.device
    if out is None:
        out = torch.full((b, num_steps), -1, dtype=torch.int64, device=dev)
    else:
        out.fill_(-1)
    if steps is None:
        steps = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        steps.zero_()
    eos = -1 if eos_id is None else int(eos_id)
    logits = None
    for step in range(num_steps):
        if dev.type == "cpu" and not bool(active.any()):
            break                    # the CPU reads this for free
        logits = _fused_tick(
            model, pools, tokens, pos, block_tables, active, remaining,
            row_keys, out[:, step], steps, eos=eos,
            temperature=temperature, top_k=top_k, top_p=top_p,
            use_kernel=use_kernel)
    if logits_out is not None and logits is not None:
        logits_out.copy_(logits)
    return out, steps, tokens, pos, active, remaining, pools


def draft_prompt_lookup(hist: torch.Tensor, *, min_ngram: int,
                        draft_len: int):
    """Prompt-lookup (n-gram) drafter on the device (port of
    ``deepspeed_tpu/inference/v2/paged.py:555``).

    ``hist`` [B, H] is each row's recent committed history,
    right-aligned (the newest token, the pending decode input, at column
    H - 1) with -1 filling unused columns on the left. The drafter takes
    the trailing ``min_ngram`` tokens, finds their latest earlier
    occurrence in the window and proposes up to ``draft_len`` tokens
    that followed it; a match too near the window's edge to have
    ``draft_len`` followers is outranked by the latest match that has
    them (a period-1 repeat would otherwise draft one token). Static
    shapes, no host read.

    Returns ``(draft [B, draft_len], eff [B] int32)``: ``eff`` counts
    the proposed tokens that are real, 0 where no n-gram matched (the
    verify then decodes one token). Real tokens are >= 0, so the -1
    fill never matches."""
    b, h = hist.shape
    n, el = int(min_ngram), int(draft_len)
    s = h - n                                  # candidate window starts
    dev = hist.device
    tail = hist[:, h - n:]                                      # [B, n]
    widx = (torch.arange(s, device=dev)[:, None]
            + torch.arange(n, device=dev)[None, :])             # [S, n]
    win = hist[:, widx]                                         # [B, S, n]
    match = ((win == tail[:, None, :]).all(-1)
             & (win >= 0).all(-1))                              # [B, S]
    starts = torch.arange(s, device=dev)[None, :]
    none = torch.full_like(starts, -1)
    best_full = torch.where(match & (starts <= s - el), starts,
                            none).amax(-1)
    best_any = torch.where(match, starts, none).amax(-1)
    best = torch.where(best_full >= 0, best_full, best_any)     # [B]
    hit = (best >= 0) & (tail >= 0).all(-1)
    cont = best.clamp(min=0) + n            # first continuation column
    avail = (h - cont).clamp(max=el)        # tokens following the match
    didx = (cont[:, None] + torch.arange(el, device=dev)[None, :]).clamp(
        0, h - 1)
    draft = torch.gather(hist, 1, didx)                         # [B, el]
    eff = torch.where(hit, avail, torch.zeros_like(avail))
    return draft, eff.to(torch.int32)


def append_history(hist: torch.Tensor, emitted: torch.Tensor,
                   m: torch.Tensor) -> torch.Tensor:
    """Shift each row of the right-aligned window ``hist`` [B, H] left
    by ``m[b]`` and append the first ``m[b]`` columns of ``emitted``
    [B, E] at its right edge (JAX ``paged.py:604``): one gather over the
    concatenation, so the per-row advance needs no scatter. Rows with
    m = 0 come back unchanged."""
    h = hist.shape[1]
    comb = torch.cat([hist, emitted.to(hist.dtype)], 1)
    gidx = torch.arange(h, device=hist.device)[None, :] + m.long()[:, None]
    return torch.gather(comb, 1, gidx)


def _spec_tick(model, pools, tokens, pos, tables, active, remaining,
               row_keys, hist, steps, *, draft_len: int, min_ngram: int,
               eos: int, temperature: float, top_k: int, top_p: float,
               use_kernel: bool = True):
    """One speculative verify tick (JAX ``paged.py:617``), on its
    operands in place as :func:`_fused_tick` works: draft by prompt
    lookup -> one forward over [B, 1 + draft_len] with every slot's
    logits -> sample each slot with its position's key -> accept the
    leading exact matches -> commit 1..1 + draft_len tokens a row.

    The sampled targets are the tokens a plain decode would sample
    (greedy: the argmax; sampled: the position-keyed draw), so
    acceptance only decides how many land a forward: the emitted tokens
    equal spec-off decode's. Drafts are clamped to ``remaining - 1``,
    so KV writes stay inside the reserved horizon. Draft slots write
    their KV through the block table like a prefill chunk; a rejected
    slot's stale KV lies at a position the next tick's chunk writes
    again before any query can reach it (queries never look past their
    own position).

    Updates ``tokens``, ``pos``, ``remaining``, ``hist`` and ``active``
    (rows end at EOS or budget); ``steps`` counts the tick when some
    row is active at its start. Returns ``(target [B, 1 + draft_len],
    m [B] int32 committed counts, stats [4] int32 = (proposed,
    accepted, hit slots, live slots))``."""
    from ...ops import sampling
    el = int(draft_len)
    dev = tokens.device
    slots = torch.arange(1 + el, device=dev)
    steps.add_(active.any().to(steps.dtype))
    draft, eff = draft_prompt_lookup(hist, min_ngram=min_ngram,
                                     draft_len=el)
    zero = torch.zeros_like(eff)
    eff = torch.minimum(eff, (remaining - 1).clamp(min=0))
    eff = torch.where(active, eff, zero)
    inputs = torch.cat([tokens[:, None], draft.to(tokens.dtype)], 1)
    tl = torch.where(active, 1 + eff, zero)
    logits, _ = paged_forward(model, pools, inputs, pos, tables, tl,
                              use_kernel=use_kernel, all_logits=True)
    # slot j samples the token at index pos + 1 + j with that position's
    # key, the key the plain loop folds for it; the JAX loop is compiled,
    # so its temperature is a reciprocal product
    positions = pos.long()[:, None] + 1 + slots[None, :]
    keys = sampling.position_keys(row_keys[:, None, :], positions)
    target = sampling.sample_token_grid(
        logits, keys, temperature=temperature, top_k=top_k, top_p=top_p,
        reciprocal=True)                                        # [B, 1+L]
    ok = (draft == target[:, :el]) & (slots[None, :el] < eff[:, None])
    acc = torch.cumprod(ok.to(torch.int32), 1).sum(1).to(torch.int32)
    m = torch.minimum(acc + 1, remaining)   # accepted run + correction
    # EOS: emit up to and including the first eos
    is_eos = (target == eos) & (slots[None, :] < m[:, None])
    any_eos = is_eos.any(1)
    first_eos = torch.argmax(is_eos.to(torch.int32), 1).to(torch.int32)
    m = torch.where(any_eos, first_eos + 1, m)
    m = torch.where(active, m, zero)
    last = torch.gather(target, 1, (m.long() - 1).clamp(min=0)[:, None])
    tokens.copy_(torch.where(active, last[:, 0], tokens))
    pos.add_(m)
    remaining.sub_(m)
    hist.copy_(append_history(hist, target, m))
    # drafts committed: the leading accepted run, unless an EOS cut the
    # emission on an accepted draft (then every committed token was one)
    used = torch.minimum(acc, m)
    stats = torch.stack([eff.sum(), used.sum(), (eff > 0).sum(),
                         active.sum()]).to(torch.int32)
    active.logical_and_((remaining > 0) & ~any_eos)
    return target, m, stats


@torch.no_grad()
def fused_spec_decode_loop(model, pools: dict, tokens: torch.Tensor,
                           pos: torch.Tensor, block_tables: torch.Tensor,
                           active: torch.Tensor, remaining: torch.Tensor,
                           row_keys: torch.Tensor, hist: torch.Tensor, *,
                           num_steps: int, draft_len: int, min_ngram: int,
                           eos_id: int | None, temperature: float,
                           top_k: int, top_p: float, use_kernel: bool = True,
                           out=None, out_ptr=None, steps=None,
                           spec_stats=None):
    """:func:`fused_decode_loop` with speculative decoding (port of
    ``deepspeed_tpu/inference/v2/paged.py:690``): each tick drafts up to
    ``draft_len`` tokens from the row's history window ``hist`` [B, H]
    (:func:`draft_prompt_lookup`), verifies them in one forward over
    [B, 1 + draft_len] (:func:`_spec_tick`) and commits 1..1 + draft_len
    tokens a row, so ``num_steps`` ticks emit up to ``num_steps * (1 +
    draft_len)`` tokens a row for ``num_steps`` forwards.

    Rows advance by different amounts, so each row writes its output
    through its own pointer ``out_ptr``: ``out`` is [B, width + 1] with
    width = num_steps * (1 + draft_len), and column ``width`` is a
    trash column where the slots past a row's commit land (JAX drops
    them); results are read without it. The carry operands are updated
    in place, as in :func:`fused_decode_loop`; ``out`` (filled with -1),
    ``out_ptr``, ``steps`` and ``spec_stats`` are zeroed and filled when
    given. On the card a graph runs every tick it captured and
    ``steps`` counts the ticks that started with a row active; on the
    CPU the loop stops once no row is active, as JAX's does.

    Returns ``(out [B, width], out_ptr [B], steps_run, tokens, pos,
    active, remaining, hist, spec_stats [4] = (proposed, accepted, hit
    slots, live slots), pools)``, the JAX loop's tuple."""
    b = tokens.shape[0]
    dev = tokens.device
    el = int(draft_len)
    width = num_steps * (1 + el)
    if out is None:
        out = torch.full((b, width + 1), -1, dtype=torch.int64, device=dev)
    else:
        out.fill_(-1)

    def zeroed(t, shape):
        return (torch.zeros(shape, dtype=torch.int32, device=dev)
                if t is None else t.zero_())

    out_ptr = zeroed(out_ptr, (b,))
    steps = zeroed(steps, ())
    spec_stats = zeroed(spec_stats, (4,))
    eos = -1 if eos_id is None else int(eos_id)
    slots = torch.arange(1 + el, device=dev)
    for _ in range(num_steps):
        if dev.type == "cpu" and not bool(active.any()):
            break                    # the CPU reads this for free
        target, m, stats = _spec_tick(
            model, pools, tokens, pos, block_tables, active, remaining,
            row_keys, hist, steps, draft_len=el, min_ngram=min_ngram,
            eos=eos, temperature=temperature, top_k=top_k, top_p=top_p,
            use_kernel=use_kernel)
        cols = torch.where(slots[None, :] < m[:, None],
                           out_ptr.long()[:, None] + slots[None, :], width)
        out.scatter_(1, cols, target)
        out_ptr.add_(m)
        spec_stats.add_(stats)
    return (out[:, :width], out_ptr, steps, tokens, pos, active, remaining,
            hist, spec_stats, pools)


def _swap_in(swap, carry: dict, stage: dict) -> None:
    """In-graph admission: where ``swap`` [B], each carry operand takes
    its staged counterpart in place (tokens, positions, budgets, key
    rows, table rows and, with speculation, the history window)."""
    for name, t in carry.items():
        sel = swap.reshape(-1, *([1] * (t.dim() - 1)))
        t.copy_(torch.where(sel, stage[name], t))


@torch.no_grad()
def fused_serve_loop(model, pools: dict, tokens: torch.Tensor,
                     pos: torch.Tensor, block_tables: torch.Tensor,
                     active: torch.Tensor, remaining: torch.Tensor,
                     row_keys: torch.Tensor, epoch: torch.Tensor,
                     stage_tokens: torch.Tensor, stage_pos: torch.Tensor,
                     stage_rem: torch.Tensor, stage_keys: torch.Tensor,
                     stage_tables: torch.Tensor, stage_valid: torch.Tensor,
                     ring: torch.Tensor, ring_epochs: torch.Tensor,
                     ring_ptr: torch.Tensor, *, num_steps: int,
                     eos_id: int | None, temperature: float, top_k: int,
                     top_p: float, use_kernel: bool = True, steps=None):
    """:func:`fused_decode_loop` with in-graph admission and an output
    ring (ring mode; port of ``deepspeed_tpu/inference/v2/paged.py:841``).

    Each row may carry one pre-staged request, a prompt the host already
    prefilled and reserved blocks for (``stage_tokens``/``stage_pos``/
    ``stage_rem``: its pending input, position and budget; ``stage_keys``
    its key row; ``stage_tables`` its table row; ``stage_valid``: a stage
    is attached). The tick a row's occupant ends (EOS or budget), the
    staged request takes its place by an activity-mask swap of token,
    position, budget, key row and table row, so a freed row refills
    inside the loop; ``epoch`` [B] counts each row's swaps, so the host
    can attribute the ring's tokens to their occupants. ``block_tables``
    and ``row_keys`` are therefore carry here.

    Sampled tokens land in ``ring`` [B, cap] at column ``ring_ptr +
    tick`` with the occupant's epoch in ``ring_epochs``; ``ring_ptr`` []
    advances by the ticks run, so a chain of dispatches fills one ring
    that the host reads once. Every operand is updated in place; on the
    card a graph runs every tick it captured, and a tick after the last
    row ended writes -1 past the pointer. ``steps`` [] (zeroed first)
    counts the ticks that started with a row active.

    Returns ``(ring, ring_epochs, ring_ptr, tokens, pos, active,
    remaining, row_keys, block_tables, epoch, stage_valid, pools)``, the
    JAX loop's tuple."""
    b = tokens.shape[0]
    dev = tokens.device
    if steps is None:
        steps = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        steps.zero_()
    eos = -1 if eos_id is None else int(eos_id)
    col_tokens = torch.empty((b,), dtype=torch.int64, device=dev)
    carry = dict(tokens=tokens, pos=pos, remaining=remaining,
                 row_keys=row_keys, tables=block_tables)
    stage = dict(tokens=stage_tokens, pos=stage_pos, remaining=stage_rem,
                 row_keys=stage_keys, tables=stage_tables)
    for step in range(num_steps):
        if dev.type == "cpu" and not bool(active.any()):
            break                    # the CPU reads this for free
        was = active.clone()
        _fused_tick(model, pools, tokens, pos, block_tables, active,
                    remaining, row_keys, col_tokens, steps, eos=eos,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    use_kernel=use_kernel)
        col = (ring_ptr.long() + step).reshape(1)
        ring.index_copy_(1, col, col_tokens[:, None])
        ring_epochs.index_copy_(
            1, col, torch.where(was, epoch, -1)[:, None].to(
                ring_epochs.dtype))
        swap = was & ~active & stage_valid
        _swap_in(swap, carry, stage)
        epoch.add_(swap.to(epoch.dtype))
        active.logical_or_(swap)
        stage_valid.logical_and_(~swap)
    ring_ptr.add_(steps)
    return (ring, ring_epochs, ring_ptr, tokens, pos, active, remaining,
            row_keys, block_tables, epoch, stage_valid, pools)


@torch.no_grad()
def fused_spec_serve_loop(model, pools: dict, tokens: torch.Tensor,
                          pos: torch.Tensor, block_tables: torch.Tensor,
                          active: torch.Tensor, remaining: torch.Tensor,
                          row_keys: torch.Tensor, hist: torch.Tensor,
                          epoch: torch.Tensor, stage_tokens: torch.Tensor,
                          stage_pos: torch.Tensor, stage_rem: torch.Tensor,
                          stage_keys: torch.Tensor,
                          stage_tables: torch.Tensor,
                          stage_hist: torch.Tensor,
                          stage_valid: torch.Tensor, ring: torch.Tensor,
                          ring_epochs: torch.Tensor, ring_ptr: torch.Tensor,
                          spec_stats: torch.Tensor, *, num_steps: int,
                          draft_len: int, min_ngram: int,
                          eos_id: int | None, temperature: float,
                          top_k: int, top_p: float, use_kernel: bool = True,
                          steps=None):
    """:func:`fused_serve_loop` with speculative decoding (port of
    ``deepspeed_tpu/inference/v2/paged.py:756``): ``ring_ptr`` is per row
    [B] (rows commit 1..1 + draft_len tokens a tick), ``hist`` rides the
    carry and a swap replaces it with ``stage_hist`` (the staged
    request's own history), and ``spec_stats`` [4] accumulates over the
    whole chain (it is not zeroed here). ``ring`` is [B, cap + 1]: column
    ``cap`` is the trash column where the slots past a row's commit land
    (JAX drops them). ``steps`` [] (zeroed first) counts the ticks that
    started with a row active.

    Returns ``(ring, ring_epochs, ring_ptr, steps_run, tokens, pos,
    active, remaining, row_keys, block_tables, hist, epoch, stage_valid,
    spec_stats, pools)``, the JAX loop's tuple."""
    b = tokens.shape[0]
    dev = tokens.device
    el = int(draft_len)
    if steps is None:
        steps = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        steps.zero_()
    eos = -1 if eos_id is None else int(eos_id)
    slots = torch.arange(1 + el, device=dev)
    cap = ring.shape[1] - 1
    carry = dict(tokens=tokens, pos=pos, remaining=remaining,
                 row_keys=row_keys, tables=block_tables, hist=hist)
    stage = dict(tokens=stage_tokens, pos=stage_pos, remaining=stage_rem,
                 row_keys=stage_keys, tables=stage_tables, hist=stage_hist)
    for _ in range(num_steps):
        if dev.type == "cpu" and not bool(active.any()):
            break                    # the CPU reads this for free
        was = active.clone()
        target, m, stats = _spec_tick(
            model, pools, tokens, pos, block_tables, active, remaining,
            row_keys, hist, steps, draft_len=el, min_ngram=min_ngram,
            eos=eos, temperature=temperature, top_k=top_k, top_p=top_p,
            use_kernel=use_kernel)
        cols = torch.where(slots[None, :] < m[:, None],
                           ring_ptr.long()[:, None] + slots[None, :], cap)
        ring.scatter_(1, cols, target)
        ring_epochs.scatter_(1, cols, epoch[:, None].expand(b, 1 + el).to(
            ring_epochs.dtype))
        ring_ptr.add_(m)
        swap = was & ~active & stage_valid
        _swap_in(swap, carry, stage)
        epoch.add_(swap.to(epoch.dtype))
        active.logical_or_(swap)
        stage_valid.logical_and_(~swap)
        spec_stats.add_(stats)
    return (ring, ring_epochs, ring_ptr, steps, tokens, pos, active,
            remaining, row_keys, block_tables, hist, epoch, stage_valid,
            spec_stats, pools)
