"""Flash attention (counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``).

``flash_attention(q, k, v, causal=, window=)`` is a ``torch.autograd.Function``
whose forward and backward are the hand-written Hopper kernels of
``csrc/flash_attention.cu`` on CUDA tensors (``flash_attention_fwd``,
``flash_attention_bwd``) and their plain PyTorch versions on CPU tensors.
bf16 and fp16 take the tensor-core (wgmma) kernels, fp32 the CUDA-core
kernels whose products stay exact fp32 (:func:`kernel_variant`).
The plain versions repeat the kernels' arithmetic: scores and sums in fp32,
p and ds rounded to the input dtype before the products that consume them,
as the TPU kernels do. The backward saves q, k, v, o and lse, so a caller
that keeps attention outside activation checkpointing never reruns the
forward kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import op_builder

NEG_INF = -1e30
# the head dims the kernels are built for: the powers of two, and the model
# families' 80 (phi "2"), 96 (phi3 "mini", gptneox "20b") and 256 (gptj
# "6b"); the C entry points' DS_FLASH_DIMS
KERNEL_DIMS = (16, 32, 64, 80, 96, 128, 256)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the C entry points' table (ds_flash_attention_variant): 1 tensor cores,
# 0 CUDA cores
VARIANTS = {1: "wgmma", 0: "cuda_cores"}


def _check(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {message}")


def _grouped(x, hkv: int):
    """[B, S, H, D] -> fp32 [B, S, Hkv, rep, D] (q head h = g*rep + r)."""
    b, s, h, d = x.shape
    return x.float().reshape(b, s, hkv, h // hkv, d)


def _mask(s: int, causal: bool, window: int | None, device):
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    mask = ki <= qi if causal else torch.ones(s, s, dtype=torch.bool,
                                              device=device)
    if window is not None:
        mask = mask & (qi - ki < window)
    return mask


def _scores(q, k, causal, window):
    """Masked scaled scores [B, Hkv, rep, S, S] in fp32."""
    hkv = k.shape[2]
    s = torch.einsum("bqgrd,bkgd->bgrqk", _grouped(q, hkv), k.float())
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    return s.masked_fill(~_mask(q.shape[1], causal, window, q.device),
                         NEG_INF)


def flash_attention_fwd_plain(q, k, v, *, causal=True, window=None):
    """Plain PyTorch version of the forward kernel: returns o ([B, S, Hq,
    D], q's dtype) and lse ([B, Hq, S], fp32)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    scores = _scores(q, k, causal, window)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(q.dtype).float(),
                     v.float()) / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l))[..., 0].reshape(b, hq, s)
    return (o.reshape(b, s, hq, d).to(q.dtype).contiguous(),
            lse.contiguous())


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True,
                              window=None):
    """Plain PyTorch version of the backward kernels: p recomputed from
    lse, delta = rowsum(do * o), dv = p^T do, ds = p (do v^T - delta),
    dk = ds^T q sc, dq = ds k sc (dk/dv summed over the GQA group)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    sc = 1.0 / math.sqrt(d)
    dt = q.dtype
    lse = lse.reshape(b, hkv, hq // hkv, s)[..., None]
    p = torch.exp(_scores(q, k, causal, window) - lse).to(dt).float()
    dog = _grouped(do, hkv)
    delta = (dog * _grouped(o, hkv)).sum(-1).permute(0, 2, 3, 1)[..., None]
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    ds = (p * (dp - delta)).to(dt).float()
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, _grouped(q, hkv)) * sc
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float()) * sc
    return (dq.reshape(b, s, hq, d).to(dt), dk.to(k.dtype), dv.to(v.dtype))


def kernel_variant(dtype, head_dim: int) -> str | None:
    """The kernels a CUDA call of this dtype and head dim takes: "wgmma"
    (bf16, fp16: tensor-core products), "cuda_cores" (fp32: exact fp32
    FMAs), or None where no kernel takes it. The same table as the C entry
    points' ``ds_flash_attention_variant``."""
    if dtype not in _KERNEL_DTYPES or head_dim not in KERNEL_DIMS:
        return None
    return VARIANTS[int(dtype != torch.float32)]


def _kernel():
    lib = op_builder.load("flash_attention")
    if lib.ds_flash_attention_fwd.argtypes is None:
        lib.ds_flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.ds_flash_attention_fwd.restype = ctypes.c_int
        lib.ds_flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.ds_flash_attention_bwd.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib.ds_flash_attention_variant.argtypes = [ctypes.c_int] * 2
        lib.ds_flash_attention_variant.restype = ctypes.c_int
        lib.ds_flash_attention_smem.argtypes = [ctypes.c_int] * 3
        lib.ds_flash_attention_smem.restype = ctypes.c_longlong
    return lib


def _check_inputs(tensors: dict, q, k) -> None:
    """What the kernels take: CUDA, fp32/bf16/fp16 alike, contiguous,
    16-byte aligned, [B, S, Hq, D] / [B, S, Hkv, D] with D in
    KERNEL_DIMS, at most 2^31 - 1 blocks of 64 query rows."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dtype in _KERNEL_DTYPES, f"dtype {q.dtype} (fp32, bf16 or "
           f"fp16)")
    for name, t in tensors.items():
        _check(t.device == q.device, f"{name} is on {t.device}, q on "
               f"{q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
        if t.is_floating_point() and name != "lse":
            _check(t.dtype == q.dtype, f"{name} dtype {t.dtype} != q dtype "
                   f"{q.dtype}")
    _check(d in KERNEL_DIMS, f"head_dim {d} (one of {KERNEL_DIMS})")
    _check(hkv > 0 and hq % hkv == 0, f"{hq} q heads over {hkv} kv heads")
    _check(k.shape == (b, s, hkv, d), f"k shape {tuple(k.shape)}")
    _check(-(-s // 64) * b * hq < 2**31, f"{b} x {hq} heads x {s} rows "
           f"(at most 2^31 - 1 tiles of 64 rows)")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"flash attention {what} launch failed: CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")


def flash_attention_fwd(q, k, v, *, causal=True, window=None):
    """Forward kernel (port of ``_flash_fwd``, flash_attention.py:88):
    returns o ([B, S, Hq, D], q's dtype) and lse ([B, Hq, S], fp32).
    CPU tensors take :func:`flash_attention_fwd_plain`; CUDA tensors launch
    the kernel or raise. ``flash_attention_fwd.launches`` counts launches,
    ``.variant_launches`` them by :func:`kernel_variant`, and ``.variant``
    names the last launch's kernels."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window)
    _check_inputs(dict(q=q, k=k, v=v), q, k)
    _check(v.shape == k.shape, f"v shape {tuple(v.shape)}")
    b, s, hq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = _kernel()
    err = lib.ds_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, s, hq, k.shape[2], d,
        int(causal), window or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "forward")
    _count(flash_attention_fwd, kernel_variant(q.dtype, d), 1)
    return o, lse


def _count(fn, variant: str, launches: int) -> None:
    fn.launches += launches
    fn.variant = variant
    fn.variant_launches[variant] = (fn.variant_launches.get(variant, 0)
                                    + launches)


flash_attention_fwd.launches = 0
flash_attention_fwd.variant = None
flash_attention_fwd.variant_launches = {}


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None):
    """Backward kernels (port of ``_flash_bwd``, flash_attention.py:226):
    returns dq, dk, dv in the inputs' dtypes. Two launches per call (dq and
    delta, then dk/dv per kv head); ``flash_attention_bwd.launches`` counts
    each launch, ``flash_attention_bwd.calls`` each call, ``.variant`` and
    ``.variant_launches`` as the forward's. CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    _check_inputs(dict(q=q, k=k, v=v, o=o, lse=lse, do=do), q, k)
    _check(v.shape == k.shape and o.shape == q.shape
           and do.shape == q.shape, "v/o/do shapes")
    b, s, hq, d = q.shape
    _check(lse.dtype == torch.float32 and lse.shape == (b, hq, s),
           f"lse {lse.dtype} {tuple(lse.shape)}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(lse)
    lib = _kernel()
    err = lib.ds_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _KERNEL_DTYPES[q.dtype], b, s, hq,
        k.shape[2], d, int(causal), window or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "backward")
    _count(flash_attention_bwd, kernel_variant(q.dtype, d), 2)
    flash_attention_bwd.calls += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.calls = 0
flash_attention_bwd.variant = None
flash_attention_bwd.variant_launches = {}


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """Drop-in attention: q [B, S, Hq, D], k/v [B, S, Hkv, D] (GQA: q head
    h reads kv head h // (Hq/Hkv), repeated k/v are never formed). Same
    function as ``ops.layers.dot_product_attention`` (with a window bias).
    ``window`` (causal only) keeps each query's last ``window`` keys."""
    hq, hkv = q.shape[2], k.shape[2]
    if window is not None and not causal:
        raise ValueError("window requires causal=True (Mistral SWA)")
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive")
    if hq % hkv != 0:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}")
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal, window)
