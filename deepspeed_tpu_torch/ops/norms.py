"""Fused RMSNorm and LayerNorm (counterpart of
``deepspeed_tpu/ops/pallas/norms.py``; reference:
csrc/transformer/normalize_kernels.cu, inference/csrc/rms_norm.cu).

The forward of each norm is one launch of a hand-written kernel
(``csrc/norms.cu``) on CUDA tensors: one pass over the rows with fp32
statistics, the output in the input's dtype. The JAX package's
``custom_vjp`` takes its backward from the jnp reference; here the
backward is the closed-form fp32 gradient in torch ops
(:class:`RMSNormFunction`, :class:`LayerNormFunction`), which save only
x, scale (and bias) and recompute the row statistics.

``use_kernel`` follows ``ops/quantization.py``: None takes the kernel for
CUDA tensors and the plain forward (``ops/layers.py``) for CPU tensors,
both under the closed-form backward; True always launches (and refuses a
CPU tensor); False is the plain version with plain autograd. Inside
``with plain_norms():`` every call that leaves ``use_kernel`` None takes
the plain version too: the model's norms sit inside ``embed``,
``_mlp_residual`` and ``unembed``, so a caller that wants a plain pass
(``paged_forward(use_kernel=False)``, a plain training run to compare
with) selects it around the whole pass. The switch is a process-wide
flag, so the backward's recomputes, which run in autograd's own thread,
see it as the forward did.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import layers as L
from . import op_builder

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_plain = False


@contextlib.contextmanager
def plain_norms(on: bool = True):
    """Within the block, norms called with ``use_kernel=None`` take their
    plain version (``on=False`` changes nothing: an enclosing block still
    holds)."""
    global _plain
    before = _plain
    _plain = before or bool(on)
    try:
        yield
    finally:
        _plain = before


def _norm_fn(name: str, argtypes: list):
    lib = op_builder.load("norms")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check_inputs(what: str, x: torch.Tensor, *params) -> None:
    def check(cond, message):
        if not cond:
            raise ValueError(f"{what}: {message}")

    check(x.device.type == "cuda", f"unsupported device {x.device}")
    check(x.dtype in _DTYPE_CODES, f"unsupported dtype {x.dtype}")
    check(x.dim() >= 1 and x.shape[-1] > 0, f"shape {tuple(x.shape)}")
    for p in params:
        check(p.device == x.device, f"a parameter is on {p.device}")
        check(p.dtype in (torch.float32, x.dtype),
              f"parameter dtype {p.dtype}: float32 or {x.dtype}")
        check(p.dtype == params[0].dtype, "scale and bias dtypes differ")
        check(tuple(p.shape) == (x.shape[-1],),
              f"parameter shape {tuple(p.shape)} != ({x.shape[-1]},)")


def _launch(name, what, x, params, eps):
    xc = x.contiguous()
    d = xc.shape[-1]
    rows = xc.numel() // d
    y = torch.empty_like(xc)
    if rows == 0:
        return y
    ps = [p.contiguous() for p in params]
    lib, fn = _norm_fn(name, [ctypes.c_void_p] * (len(ps) + 2)
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_float,
                          ctypes.c_void_p])
    err = fn(xc.data_ptr(), *[p.data_ptr() for p in ps], y.data_ptr(),
             _DTYPE_CODES[x.dtype], _DTYPE_CODES[ps[0].dtype], rows, d,
             float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")
    return y


def rms_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Launch ``csrc/norms.cu``'s RMSNorm over the rows ``x.reshape(-1,
    d)`` of a CUDA tensor (fp32/bf16/fp16, made contiguous first); scale
    ``[d]`` in fp32 or x's dtype. Port of the Pallas kernel at
    ``deepspeed_tpu/ops/pallas/norms.py:47``; ``rms_norm_kernel.launches``
    counts the launches."""
    _check_inputs("rms_norm_kernel", x, scale)
    y = _launch("ds_rms_norm", "rms_norm", x, (scale,), eps)
    rms_norm_kernel.launches += 1
    return y


rms_norm_kernel.launches = 0


def layer_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/norms.cu``'s LayerNorm (centred variance) over the
    rows of a CUDA tensor; scale and bias ``[d]`` in one dtype, fp32 or
    x's. Port of the Pallas kernel at ``norms.py:81``;
    ``layer_norm_kernel.launches`` counts the launches."""
    _check_inputs("layer_norm_kernel", x, scale, bias)
    y = _launch("ds_layer_norm", "layer_norm", x, (scale, bias), eps)
    layer_norm_kernel.launches += 1
    return y


layer_norm_kernel.launches = 0


def _reduce_to(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Sum of ``g`` over every dim but the last, in ``like``'s dtype."""
    return g.reshape(-1, g.shape[-1]).sum(0).to(like.dtype)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with the kernel's forward (its plain version for a CPU
    tensor) and the closed-form fp32 backward: with r = rsqrt(mean(x^2) +
    eps) and gs = g * scale, dx = r * (gs - x * r^2 * mean(gs * x)) and
    dscale = sum(g * x * r)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y = (rms_norm_kernel(x, scale, eps) if x.device.type == "cuda"
             else L.rms_norm(x, scale, eps))
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + ctx.eps)
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            gs = g32 * scale.float()
            dot = (gs * x32).mean(-1, keepdim=True)
            dx = (r * (gs - x32 * r.square() * dot)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = _reduce_to(g32 * x32 * r, scale)
        return dx, dscale, None


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm with the kernel's forward (its plain version for a CPU
    tensor) and the closed-form fp32 backward: with xhat = (x - mean) * r
    and gs = g * scale, dx = r * (gs - mean(gs) - xhat * mean(gs * xhat)),
    dscale = sum(g * xhat), dbias = sum(g)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y = (layer_norm_kernel(x, scale, bias, eps)
             if x.device.type == "cuda" else L.layer_norm(x, scale, bias, eps))
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        mean = x32.mean(-1, keepdim=True)
        xc = x32 - mean
        r = torch.rsqrt(xc.square().mean(-1, keepdim=True) + ctx.eps)
        xhat = xc * r
        dx = dscale = dbias = None
        if ctx.needs_input_grad[0]:
            gs = g32 * scale.float()
            dx = (r * (gs - gs.mean(-1, keepdim=True)
                       - xhat * (gs * xhat).mean(-1, keepdim=True))
                  ).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = _reduce_to(g32 * xhat, scale)
        if ctx.needs_input_grad[2]:
            dbias = _reduce_to(g32, bias)
        return dx, dscale, dbias, None


def _plain_version(use_kernel, x: torch.Tensor) -> bool:
    if use_kernel is None:
        return _plain
    if use_kernel and x.device.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA tensor, got "
                         f"{x.device}")
    return not use_kernel


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             use_kernel: bool | None = None) -> torch.Tensor:
    """RMSNorm over the last dim with fp32 statistics, in x's dtype."""
    if _plain_version(use_kernel, x):
        return L.rms_norm(x, scale, eps)
    return RMSNormFunction.apply(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5,
               use_kernel: bool | None = None) -> torch.Tensor:
    """LayerNorm over the last dim (centred variance, fp32 statistics), in
    x's dtype."""
    if _plain_version(use_kernel, x):
        return L.layer_norm(x, scale, bias, eps)
    return LayerNormFunction.apply(x, scale, bias, eps)
