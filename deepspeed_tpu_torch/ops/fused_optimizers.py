"""Fused Adam and fused Lion (counterparts of
``deepspeed_tpu/ops/pallas/fused_optimizers.py`` ``fused_adam`` and
``fused_lion``; reference: csrc/adam/multi_tensor_adam.cu, csrc/lion).

The optimizers work on flat fp32 buffers: the engine keeps every
parameter's fp32 master and moments as views into one buffer each and
gathers the fp32 grads into another, so one call of
:func:`fused_adam_step` or :func:`fused_lion_step` updates the whole
model. On CUDA tensors that call is one launch of the hand-written kernel
``csrc/fused_adam.cu`` or ``csrc/fused_lion.cu``; on CPU tensors it is
:func:`adam_plain` or :func:`lion_plain`, the same arithmetic on tensors.

Conventions are optax's, as in the TPU kernels: the lr comes from the
schedule at the pre-increment count (the first step uses lr(0)); Adam's
bias correction uses t = count + 1; weight decay applies to every tensor,
decoupled (AdamW, Lion) or as L2 on the gradient. The hyper-parameters
live in a small device tensor (``hp``), so a step needs no host sync.
"""

from __future__ import annotations

import ctypes

import torch

from . import op_builder

# Adam's hp: lr, b1, b2, eps, 1/(1-b1^t), 1/(1-b2^t), clip coef, apply
HP_SIZE = 8
# Lion's hp: lr, b1, b2, clip coef, apply
LION_HP_SIZE = 5
_OUT_DTYPES = {torch.bfloat16: 1, torch.float16: 2}
# the plain versions take a large flat CPU buffer in slices of this many
# values, so that their temporaries stay in cache (each op is elementwise:
# the values are the same)
CPU_SLICE = 1 << 18


def _cpu_slices(buffers):
    """The buffers' slices of CPU_SLICE values (views, updated in place),
    or None where the buffers are not large flat CPU tensors."""
    p = buffers[0]
    if p.device.type != "cpu" or p.dim() != 1 or p.numel() <= CPU_SLICE:
        return None
    return zip(*(b.split(CPU_SLICE) for b in buffers))


def adam_plain(p, g, m, v, hp, *, weight_decay: float, adamw_mode: bool,
               out=None):
    """Plain PyTorch version of :func:`fused_adam_step`: the same update
    written on tensors, in place on ``p``, ``m``, ``v`` (and ``out``)."""
    slices = _cpu_slices((p, g, m, v) + (() if out is None else (out,)))
    if slices is not None:
        for part in slices:
            adam_plain(*part[:4], hp, weight_decay=weight_decay,
                       adamw_mode=adamw_mode,
                       out=part[4] if out is not None else None)
        return
    lr, b1, b2, eps, c1, c2, coef, apply = hp.unbind(0)
    g = g * coef
    if weight_decay and not adamw_mode:
        g = g + weight_decay * p         # classic L2: decay enters moments
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    u = (m_new * c1) / (torch.sqrt(v_new * c2) + eps)
    if weight_decay and adamw_mode:
        u = u + weight_decay * p         # AdamW: decoupled decay
    keep = apply != 0
    p.copy_(torch.where(keep, p - lr * u, p))
    m.copy_(torch.where(keep, m_new, m))
    v.copy_(torch.where(keep, v_new, v))
    if out is not None:
        out.copy_(p)


def _kernel(name: str, argtypes: list):
    """The library of ``csrc/<name>.cu`` and its entry point ``ds_<name>``."""
    lib = op_builder.load(name)
    fn = getattr(lib, f"ds_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check_flat(what: str, tensors: dict, hp, hp_size: int, out) -> int:
    """What the kernels take: contiguous, 16-byte aligned 1-D fp32 buffers
    of one length on one card, ``hp`` of ``hp_size`` fp32 values there,
    ``out`` None or a bf16/fp16 buffer of that length. Returns the length."""
    def check(cond: bool, message: str) -> None:
        if not cond:
            raise ValueError(f"{what}: {message}")

    p = next(iter(tensors.values()))
    check(p.device.type == "cuda", f"unsupported device {p.device}")
    n = p.numel()
    for name, t in tensors.items():
        check(t.device == p.device, f"{name} is on {t.device}")
        check(t.dtype == torch.float32, f"{name} must be float32")
        check(t.dim() == 1 and t.numel() == n and t.is_contiguous(),
              f"{name} must be a contiguous 1-D buffer of {n} values")
        check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    check(hp.device == p.device and hp.dtype == torch.float32
          and hp.shape == (hp_size,) and hp.is_contiguous(),
          f"hp must be {hp_size} float32 values on {p.device}")
    if out is not None:
        check(out.device == p.device and out.dtype in _OUT_DTYPES
              and out.dim() == 1 and out.numel() == n
              and out.is_contiguous(),
              f"out must be a contiguous 1-D bf16/fp16 buffer of {n}")
    return n


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.ds_cuda_error_string(err).decode()})")


def fused_adam_step(p, g, m, v, hp, *, weight_decay: float,
                    adamw_mode: bool, out=None):
    """One Adam step over flat fp32 buffers ``p`` (master), ``g``, ``m``,
    ``v``, in place, with ``hp`` the 8 hyper-parameters on the device (see
    HP_SIZE); ``out``, a bf16/fp16 buffer of the same size, receives the
    new parameters in the compute dtype. Port of the Pallas kernel at
    ``deepspeed_tpu/ops/pallas/fused_optimizers.py:75``.

    CPU tensors take :func:`adam_plain`; CUDA tensors launch
    ``csrc/fused_adam.cu`` once or raise. ``fused_adam_step.launches``
    counts the launches."""
    if p.device.type == "cpu":
        return adam_plain(p, g, m, v, hp, weight_decay=weight_decay,
                          adamw_mode=adamw_mode, out=out)
    n = _check_flat("fused_adam_step", dict(p=p, g=g, m=m, v=v), hp,
                    HP_SIZE, out)
    if out is not None and out.data_ptr() % 16:
        # the kernel stores 8 copied values at a time
        raise ValueError("fused_adam_step: out is not 16-byte aligned")
    lib, fn = _kernel("fused_adam", [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p])
    err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
             hp.data_ptr(), None if out is None else out.data_ptr(),
             0 if out is None else _OUT_DTYPES[out.dtype], n,
             float(weight_decay), int(adamw_mode),
             torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, err, "fused_adam")
    fused_adam_step.launches += 1


fused_adam_step.launches = 0


class Adam:
    """Adam/AdamW over flat fp32 buffers, with optax's conventions.

    ``fused=True`` is the ``fused_kernel`` switch of the JAX package (its
    ``fused_adam``): every step is one :func:`fused_adam_step`. With
    ``fused=False`` (the JAX engine's ``optax.adamw``/``optax.adam`` path)
    the step is :func:`adam_plain` on whatever device the buffers live.
    State: ``count`` (0-d int32, applied steps), ``exp_avg``,
    ``exp_avg_sq``."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, adamw_mode=True, fused=True):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.adamw_mode = bool(adamw_mode)
        self.fused = fused

    def init(self, params: torch.Tensor) -> dict:
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params.device),
                "exp_avg": torch.zeros_like(params, dtype=torch.float32),
                "exp_avg_sq": torch.zeros_like(params, dtype=torch.float32)}

    def hyperparams(self, count, coef=None, apply=None) -> torch.Tensor:
        """The hp tensor for the step after ``count`` applied steps, built
        on count's device by device ops only (no host-to-device copy)."""
        t = count.float() + 1
        return _hyperparams(
            self.learning_rate, count, [self.b1, self.b2, self.eps], coef,
            apply, extra=(1.0 / (1.0 - self.b1 ** t),
                          1.0 / (1.0 - self.b2 ** t)))

    def step(self, state: dict, params: torch.Tensor, grads: torch.Tensor,
             *, coef=None, apply=None, out=None) -> None:
        """Update ``params`` (flat fp32) in place from ``grads``; ``coef``
        (clip coefficient) and ``apply`` (0 on an fp16 overflow step) are
        0-d device tensors or None; ``out`` gets the compute-dtype copy."""
        hp = self.hyperparams(state["count"], coef, apply)
        update = fused_adam_step if self.fused else adam_plain
        update(params, grads, state["exp_avg"], state["exp_avg_sq"], hp,
               weight_decay=self.weight_decay, adamw_mode=self.adamw_mode,
               out=out)
        state["count"] += 1 if apply is None else apply.int()


def lion_plain(p, g, m, hp, *, weight_decay: float, out=None):
    """Plain PyTorch version of :func:`fused_lion_step`: the same update
    written on tensors, in place on ``p``, ``m`` (and ``out``)."""
    slices = _cpu_slices((p, g, m) + (() if out is None else (out,)))
    if slices is not None:
        for part in slices:
            lion_plain(*part[:3], hp, weight_decay=weight_decay,
                       out=part[3] if out is not None else None)
        return
    lr, b1, b2, coef, apply = hp.unbind(0)
    g = g * coef
    u = torch.sign(b1 * m + (1 - b1) * g)
    if weight_decay:
        u = u + weight_decay * p         # decoupled, as optax.lion
    m_new = b2 * m + (1 - b2) * g
    keep = apply != 0
    p.copy_(torch.where(keep, p - lr * u, p))
    m.copy_(torch.where(keep, m_new, m))
    if out is not None:
        out.copy_(p)


def fused_lion_step(p, g, m, hp, *, weight_decay: float, out=None):
    """One Lion step over flat fp32 buffers ``p`` (master), ``g``, ``m``,
    in place, with ``hp`` the 5 hyper-parameters on the device (see
    LION_HP_SIZE); ``out``, a bf16/fp16 buffer of the same size, receives
    the new parameters in the compute dtype. Port of the Pallas kernel at
    ``deepspeed_tpu/ops/pallas/fused_optimizers.py:165``, which returns
    the delta new_p - p for the engine to add; this writes new_p, which
    differs from p + (new_p - p) by at most an ulp.

    CPU tensors take :func:`lion_plain`; CUDA tensors launch
    ``csrc/fused_lion.cu`` once or raise. ``fused_lion_step.launches``
    counts the launches."""
    if p.device.type == "cpu":
        return lion_plain(p, g, m, hp, weight_decay=weight_decay, out=out)
    n = _check_flat("fused_lion_step", dict(p=p, g=g, m=m), hp,
                    LION_HP_SIZE, out)
    lib, fn = _kernel("fused_lion", [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), hp.data_ptr(),
             None if out is None else out.data_ptr(),
             0 if out is None else _OUT_DTYPES[out.dtype], n,
             float(weight_decay),
             torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, err, "fused_lion")
    fused_lion_step.launches += 1


fused_lion_step.launches = 0


class Lion:
    """Lion over flat fp32 buffers, with optax's conventions (optax.lion:
    the sign of b1 m + (1 - b1) g, decoupled weight decay times lr,
    m <- b2 m + (1 - b2) g).

    ``fused=True`` is the ``fused_kernel`` switch of the JAX package (its
    ``fused_lion``): every step is one :func:`fused_lion_step`. With
    ``fused=False`` (the JAX engine's ``optax.lion`` path) the step is
    :func:`lion_plain` on whatever device the buffers live. State:
    ``count`` (0-d int32, applied steps), ``exp_avg``."""

    def __init__(self, learning_rate, b1=0.9, b2=0.99, weight_decay=0.0,
                 fused=True):
        self.learning_rate = learning_rate
        self.b1, self.b2 = float(b1), float(b2)
        self.weight_decay = float(weight_decay)
        self.fused = fused

    def init(self, params: torch.Tensor) -> dict:
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params.device),
                "exp_avg": torch.zeros_like(params, dtype=torch.float32)}

    def hyperparams(self, count, coef=None, apply=None) -> torch.Tensor:
        """The hp tensor for the step after ``count`` applied steps, built
        on count's device by device ops only (no host-to-device copy)."""
        return _hyperparams(self.learning_rate, count,
                            [self.b1, self.b2], coef, apply)

    def step(self, state: dict, params: torch.Tensor, grads: torch.Tensor,
             *, coef=None, apply=None, out=None) -> None:
        """Update ``params`` (flat fp32) in place from ``grads``, as
        :meth:`Adam.step`."""
        hp = self.hyperparams(state["count"], coef, apply)
        update = fused_lion_step if self.fused else lion_plain
        update(params, grads, state["exp_avg"], hp,
               weight_decay=self.weight_decay, out=out)
        state["count"] += 1 if apply is None else apply.int()


def _hyperparams(learning_rate, count, constants, coef, apply,
                 extra=()) -> torch.Tensor:
    """[lr(count), *constants, *extra, coef, apply] as one fp32 tensor on
    count's device, by device ops only."""
    t = count.float()
    const = lambda v: torch.full_like(t, v)  # noqa: E731
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    lr = lr.to(t).reshape(()) if isinstance(lr, torch.Tensor) else const(lr)
    return torch.stack(
        [lr, *map(const, constants), *extra,
         const(1.0) if coef is None else coef.float(),
         const(1.0) if apply is None else apply.float()])
