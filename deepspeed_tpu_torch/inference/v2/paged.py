"""Paged KV attention + paged model forward (counterpart of
``deepspeed_tpu/inference/v2/paged.py``; reference:
inference/v2/kernels/ragged_ops/ — blocked_flash is a paged FlashAttention
over the block table; logits_gather picks each sequence's last-token
logits).

``paged_attention_kernel`` launches the hand-written Hopper kernel
(``csrc/paged_attention.cu``) on CUDA tensors and its plain PyTorch
version on CPU tensors. ``gather_pages`` + ``place_in_pages`` +
``paged_attention`` are the plain reference path, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...ops import op_builder

_KERNEL_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor):
    """[num_blocks, bs, H, D] pool -> contiguous [B, smax, H, D] pages
    (clamps out-of-range table slots)."""
    b, max_blocks = block_tables.shape
    bs, h, d = pool.shape[1:]
    safe = block_tables.long().clamp(max=pool.shape[0] - 1)
    return pool[safe].reshape(b, max_blocks * bs, h, d)


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
                          alibi_slopes=None):
    """Plain PyTorch version of :func:`paged_attention_kernel`: the same
    function written on tensors (exact masked softmax in fp32 over the
    row's cached keys, positions < pos0, read through the clamped block
    table, then this chunk's fresh keys, causal). Query rows >=
    true_len come back as zeros, as the kernel writes them."""
    b, sq, hq, d = q.shape
    hkv = k_new.shape[2]
    rep = hq // hkv
    dev = q.device
    smax = block_tables.shape[1] * k_pool.shape[1]
    k = torch.cat([gather_pages(k_pool, block_tables), k_new], 1).float()
    v = torch.cat([gather_pages(v_pool, block_tables), v_new], 1).float()
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


def _kernel_fn():
    lib = op_builder.load("paged_attention")
    fn = lib.ds_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
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

    CPU tensors take :func:`paged_attention_plain`. CUDA tensors launch
    ``csrc/paged_attention.cu`` (fp32 or bf16, D in {16, 32, 64, 128},
    block size a multiple of 8, contiguous int32 tables/pos0/true_len)
    or raise; ``paged_attention_kernel.launches`` counts the launches.

    What bounds it on an H100: bytes. A decode row reads
    ``2 * ctx * Hkv * D * itemsize`` bytes of KV per layer at 3.35 TB/s
    and does a few flops per byte, far below the card's ridge point. The
    simple design reads only the live keys (positions < pos0, trimmed by
    the window), loads each K/V element once per thread block and serves
    the GQA group's ``rep`` q heads from it; it does not yet split a long
    context across blocks or overlap the next tile's load with the fold.
    ``sanitize_pools`` is accepted for the JAX signature and has nothing
    to select here: the kernel zero-fills every tile slot outside the
    live range instead of reading it, so dead pool slots are never used
    whatever they hold. Quantized pools (``k_scale``/``v_scale``) belong
    to the quantized-KV slice."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized KV pools are not ported yet (ROADMAP: port Queue 2, "
            "paged attention int8/fp8-pool mode)")
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_new, v_new, k_pool, v_pool, block_tables, pos0, true_len,
            window=window, alibi_slopes=alibi_slopes)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    b, sq, hq, d = q.shape
    nb, bs, hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    tensors = dict(q=q, k_new=k_new, v_new=v_new, k_pool=k_pool,
                   v_pool=v_pool, block_tables=block_tables, pos0=pos0,
                   true_len=true_len)
    for name, t in tensors.items():
        _check(t.device == q.device, f"{name} is on {t.device}, q on "
               f"{q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.dtype in _KERNEL_DTYPES, f"dtype {q.dtype} (fp32 or bf16)")
    for name in ("k_new", "v_new", "k_pool", "v_pool"):
        _check(tensors[name].dtype == q.dtype, f"{name} dtype "
               f"{tensors[name].dtype} != q dtype {q.dtype}")
        _check(tensors[name].data_ptr() % 16 == 0,
               f"{name} is not 16-byte aligned")
    for name in ("block_tables", "pos0", "true_len"):
        _check(tensors[name].dtype == torch.int32, f"{name} must be int32")
    _check(d in _KERNEL_DIMS, f"head_dim {d} (one of {_KERNEL_DIMS})")
    _check(bs % 8 == 0, f"block size {bs} (a multiple of 8)")
    _check(hkv > 0 and hq % hkv == 0, f"{hq} q heads over {hkv} kv heads")
    _check(k_new.shape == (b, sq, hkv, d) and v_new.shape == k_new.shape,
           f"k_new/v_new shape {tuple(k_new.shape)}")
    _check(k_pool.shape == (nb, bs, hkv, d) and v_pool.shape == k_pool.shape,
           f"pool shape {tuple(k_pool.shape)}")
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
    out = torch.empty_like(q)
    lib, fn = _kernel_fn()
    err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
             pos0.data_ptr(), true_len.data_ptr(),
             None if slopes is None else slopes.data_ptr(), out.data_ptr(),
             _KERNEL_DTYPES[q.dtype], b, sq, hq, hkv, d, nb, bs,
             block_tables.shape[1], window or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0


@torch.no_grad()
def paged_forward(model, pools: dict, tokens: torch.Tensor,
                  pos0: torch.Tensor, block_tables: torch.Tensor,
                  true_len: torch.Tensor, use_kernel: bool = True,
                  attention=None):
    """Full model pass over a chunk of new tokens with paged KV.

    tokens [B, S]; pos0 [B]; block_tables [B, max_blocks]; true_len [B]
    new-token counts (slots beyond are ignored). Returns
    (last-valid-token logits [B, V], pools): the vocab projection runs
    only on each row's last pending token (logits_gather).
    ``attention`` stands in for :func:`paged_attention_kernel` (same
    signature), for a harness that checks or times each layer's call.

    The pools (``{"k", "v"}``, [L, nb, bs, Hkv, D]) are updated IN PLACE,
    one layer right after that layer's attention, at the chunk's valid
    slots only. The JAX forward instead scatters every layer's k/v once
    after its layer scan, to keep the pools out of the XLA scan carry; the
    two agree because attention reads pool pages only at positions
    < pos0 and takes this chunk's k/v from k_new/v_new (the plain path
    patches them into its gathered copy).
    """
    b, s = tokens.shape
    dev = tokens.device
    ar = torch.arange(s, device=dev)
    positions = pos0.long()[:, None] + ar[None, :]
    x = model.embed(tokens, positions=positions)
    attend = attention or paged_attention_kernel
    alibi = model._alibi_slopes
    window = model.config.sliding_window
    bs = pools["k"].shape[2]
    # pool slots this chunk writes: valid (row, slot) pairs only
    bi, si = (ar[None, :] < true_len[:, None]).nonzero(as_tuple=True)
    wpos = positions[bi, si]
    wblk = block_tables[bi, wpos // bs].long()
    woff = wpos % bs
    for layer in range(model.config.num_layers):
        p = model.layer_params(layer)
        k_pool, v_pool = pools["k"][layer], pools["v"][layer]
        h = model._norm(x, p["ln1_scale"], p.get("ln1_bias"))
        q, k, v = model._qkv(p, h, positions)
        if use_kernel and q.shape[-1] % 8 == 0 and bs % 8 == 0:
            # the engine's pools are zero-initialized, and the kernel
            # never reads dead slots anyway
            a = attend(
                q, k, v, k_pool, v_pool, block_tables, pos0, true_len,
                window=window, alibi_slopes=alibi, sanitize_pools=False)
        else:
            k_pages = place_in_pages(gather_pages(k_pool, block_tables), k,
                                     pos0, true_len)
            v_pages = place_in_pages(gather_pages(v_pool, block_tables), v,
                                     pos0, true_len)
            a = paged_attention(q, k_pages, v_pages, pos0, window=window,
                                alibi_slopes=alibi)
        # in-place pool write of this layer's chunk k/v (see docstring)
        k_pool.index_put_((wblk, woff), k[bi, si].to(k_pool.dtype))
        v_pool.index_put_((wblk, woff), v[bi, si].to(v_pool.dtype))
        if model.config.parallel_residual:
            m = model._mlp(p, model._parallel_mlp_input(p, x, h))
            x = x + model._attn_out(p, a) + m
        else:
            x = x + model._attn_out(p, a)
            x = model._mlp_residual(p, x)
    # logits_gather: project only each row's last valid position
    idx = (true_len.long() - 1).clamp(0, s - 1)
    x_last = x[torch.arange(b, device=dev), idx]
    logits = model.unembed(x_last[:, None, :])[:, 0]
    return logits, pools
