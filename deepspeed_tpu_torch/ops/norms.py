"""Fused RMSNorm and LayerNorm (counterpart of
``deepspeed_tpu/ops/pallas/norms.py``; reference:
csrc/transformer/normalize_kernels.cu, inference/csrc/rms_norm.cu).

The forward of each norm is one launch of a hand-written kernel
(``csrc/norms.cu``) on CUDA tensors: one pass over the rows with fp32
statistics, the output in the input's dtype. :func:`launch_plan` names
the kernel a call takes from its shapes alone, as the C side's
``ds_norm_variant`` does: "warp_row" (a warp a row, rows in registers)
up to 1024 elements in bf16/fp16 (512 in fp32), "cta_row" (2-16 warps a
row) beyond, and "general" (the first design: a CTA a row, the row in
shared memory) for a d that is not a whole number of 16-byte vectors, a
pointer off a 16-byte boundary or a row past cta_row's register
ceiling. The JAX package's ``custom_vjp`` takes its backward from the
jnp reference; here the backward is the closed-form fp32 gradient in
torch ops (:class:`RMSNormFunction`, :class:`LayerNormFunction`), which
save only x, scale (and bias) and recompute the row statistics.

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
from . import launches, op_builder

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the C side's variant codes (ds_norm_variant)
VARIANTS = {0: "general", 1: "warp_row", 2: "cta_row"}
MAX_VECS = 4          # 16-byte vectors a thread holds of a row
ROW_WARPS = 4         # warp_row: warps (one row each) a CTA
MAX_ROW_WARPS = 16    # cta_row: warps a row, at most
GENERAL_THREADS = 512  # general: threads a CTA, at most
_GRID_CAP = 1 << 30   # general: the grid's cap (rows beyond loop)
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


def launch_plan(kind: str, rows: int, d: int, dtype, scale_dtype=None,
                aligned: bool = True, slots: int | None = None) -> dict:
    """The kernel a CUDA norm of ``kind`` ("rms"/"layer") over ``rows``
    x ``d`` elements of ``dtype`` takes (params in ``scale_dtype``: fp32
    or x's, None = x's), from the shapes alone: ``variant`` ("warp_row",
    "cta_row" or "general"), ``warps_per_row``, ``vectors_per_thread``
    (16-byte vectors of a row a thread holds; 0 for general),
    ``threads`` (a CTA), ``row_groups`` (warp_row: ceil(rows / 4) CTAs of
    4 rows; else rows) and ``grid``: min(row_groups, ``slots``), where
    ``slots`` is SMs x resident CTAs, which the C side takes from the
    occupancy query (None: row_groups, the grid's upper bound).
    ``aligned``: x, y, scale and bias all start on a 16-byte boundary.
    The same table as ``csrc/norms.cu`` ``plan_of`` (``ds_norm_variant``,
    ``ds_norm_plan``)."""
    if kind not in ("rms", "layer"):
        raise ValueError(f"launch_plan: kind {kind!r} (rms or layer)")
    scale_dtype = dtype if scale_dtype is None else scale_dtype
    if (dtype not in _DTYPE_CODES or scale_dtype not in (torch.float32, dtype)
            or d <= 0 or rows < 0):
        raise ValueError(f"launch_plan: no kernel takes {kind} {dtype} "
                         f"params {scale_dtype} d {d} rows {rows}")
    vec = 16 // (torch.finfo(dtype).bits // 8)   # elements a vector
    nvec, per_warp = d // vec, 32 * MAX_VECS
    whole = aligned and d % vec == 0
    warps = -(-nvec // per_warp)
    if whole and nvec <= per_warp:
        plan = dict(variant="warp_row", warps_per_row=1,
                    vectors_per_thread=-(-nvec // 32),
                    threads=32 * ROW_WARPS, row_groups=-(-rows // ROW_WARPS))
    elif whole and warps <= MAX_ROW_WARPS:
        plan = dict(variant="cta_row", warps_per_row=warps,
                    vectors_per_thread=-(-nvec // (32 * warps)),
                    threads=32 * warps, row_groups=rows)
    else:
        want = -(-d // vec)                    # a vector a thread
        threads = min(max(-(-want // 32) * 32, 32), GENERAL_THREADS)
        return dict(variant="general", warps_per_row=threads // 32,
                    vectors_per_thread=0, threads=threads, row_groups=rows,
                    grid=min(rows, _GRID_CAP))
    plan["grid"] = (plan["row_groups"] if slots is None
                    else min(plan["row_groups"], slots))
    return plan


def kernel_plan(kind: str, rows: int, d: int, dtype, scale_dtype=None,
                aligned: bool = True) -> dict:
    """The C side's plan of such a call (``ds_norm_plan``: the same keys
    as :func:`launch_plan`'s but ``row_groups``, the grid from the
    occupancy query on the current card). Builds the library; needs a
    card."""
    scale_dtype = dtype if scale_dtype is None else scale_dtype
    lib = op_builder.load("norms")
    if lib.ds_norm_plan.argtypes is None:
        lib.ds_norm_plan.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ds_norm_plan.restype = ctypes.c_int
        lib.ds_norm_variant.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_longlong, ctypes.c_int]
        lib.ds_norm_variant.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    err = lib.ds_norm_plan(int(kind == "layer"), _DTYPE_CODES[dtype],
                           _DTYPE_CODES[scale_dtype], d, int(aligned), rows,
                           out)
    if err != 0:
        raise RuntimeError(f"ds_norm_plan: CUDA error {err}")
    variant = lib.ds_norm_variant(int(kind == "layer"), _DTYPE_CODES[dtype],
                                  _DTYPE_CODES[scale_dtype], d, int(aligned))
    if variant != out[0]:
        raise RuntimeError(f"ds_norm_variant {variant} != ds_norm_plan's "
                           f"{out[0]}")
    return dict(variant=VARIANTS[out[0]], warps_per_row=out[1],
                vectors_per_thread=out[2], threads=out[3], grid=out[4])


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


def _launch(kind, x, params, eps, counter):
    """Launch the ``kind`` ("rms"/"layer") kernel over the rows of x and
    count the launch (none for zero rows) on ``counter``, the wrapper."""
    what = f"{kind}_norm"
    xc = x.contiguous()
    d = xc.shape[-1]
    rows = xc.numel() // d
    y = torch.empty_like(xc)
    if rows == 0:
        return y
    ps = [p.contiguous() for p in params]
    lib, fn = _norm_fn(f"ds_{what}", [ctypes.c_void_p] * (len(ps) + 2)
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_float,
                          ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    code = ctypes.c_int(-1)
    err = fn(xc.data_ptr(), *[p.data_ptr() for p in ps], y.data_ptr(),
             _DTYPE_CODES[x.dtype], _DTYPE_CODES[ps[0].dtype], rows, d,
             float(eps), torch.cuda.current_stream(x.device).cuda_stream,
             ctypes.byref(code))
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")
    variant = VARIANTS[code.value]
    launches.count(counter, variant)
    return y


def rms_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Launch ``csrc/norms.cu``'s RMSNorm over the rows ``x.reshape(-1,
    d)`` of a CUDA tensor (fp32/bf16/fp16, made contiguous first); scale
    ``[d]`` in fp32 or x's dtype. Port of the Pallas kernel at
    ``deepspeed_tpu/ops/pallas/norms.py:47``; ``rms_norm_kernel.launches``
    counts the launches (none for zero rows), ``.variant_launches`` them by
    the variant the C side launched (:func:`launch_plan` names it ahead)
    and ``.variant`` names the last one."""
    _check_inputs("rms_norm_kernel", x, scale)
    return _launch("rms", x, (scale,), eps, rms_norm_kernel)


rms_norm_kernel.launches = 0
rms_norm_kernel.variant = None
rms_norm_kernel.variant_launches = {}


def layer_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/norms.cu``'s LayerNorm (centred variance) over the
    rows of a CUDA tensor; scale and bias ``[d]`` in one dtype, fp32 or
    x's. Port of the Pallas kernel at ``norms.py:81``;
    ``layer_norm_kernel.launches`` / ``.variant_launches`` / ``.variant``
    as :func:`rms_norm_kernel`'s."""
    _check_inputs("layer_norm_kernel", x, scale, bias)
    return _launch("layer", x, (scale, bias), eps, layer_norm_kernel)


layer_norm_kernel.launches = 0
layer_norm_kernel.variant = None
layer_norm_kernel.variant_launches = {}


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
