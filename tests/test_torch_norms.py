"""The port's fused norms (deepspeed_tpu_torch/ops/norms.py) against the
JAX package's on the CPU.

On CPU tensors the wrappers take the kernel's plain forward
(ops/layers.py) under the closed-form backward of RMSNormFunction /
LayerNormFunction; the CUDA kernel itself is held to that plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 3). Here the same
numpy inputs go through:

- the JAX public ops ``deepspeed_tpu.ops.pallas.norms.rms_norm`` /
  ``layer_norm`` (on the CPU their jnp reference, under their custom_vjp):
  forward at 1e-6 and the grads of x, scale and bias at 1e-5, the
  tolerances of tests/test_pallas_kernels.py:175-188, plus two fp32 ulps
  relative on the forward (FWD_RTOL): the row statistics are summed in
  another order than XLA's, so an output of |y| ~ 8 may land two
  roundings away, above 1e-6 absolute;
- the Pallas kernel bodies ``_rms_kernel`` / ``_ln_kernel`` in a
  ``pl.pallas_call`` built here with the JAX op's own BlockSpecs (blocks
  of rows, VMEM), ``interpret=True``: forward at 1e-6.

The CUDA kernels' own schedule is emulated in numpy (``_schedule``): the
row cut into the threads' 16-byte vectors as ``launch_plan`` says, each
thread's sum in order, the warp's xor butterfly, the warps' partials in
order, every add and product rounded to fp32 on its own, then the store's
rounding chain. It is held to the Pallas bodies in fp32 and, in bf16 and
fp16, to within one ulp of the plain version, as the card holds the
kernels themselves (tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from deepspeed_tpu.ops.pallas import norms as JN
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import GPT2, Llama
from deepspeed_tpu_torch.ops import layers as L
from deepspeed_tpu_torch.ops import norms as N

SHAPES = [(4, 16, 128), (3, 7, 200), (5, 64), (2, 3, 768)]
FWD_RTOL = 2.4e-7     # two fp32 ulps
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
EPS = {"rms": 1e-6, "layer": 1e-5}


def _inputs(shape, seed=0, mean=0.0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + mean).astype(np.float32)
    scale = (rng.standard_normal(d) + 1.0).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, g


def _torch_grads(fn, x, params, g):
    xs = [torch.tensor(v, requires_grad=True) for v in (x, *params)]
    y = fn(*xs)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), [v.grad.numpy() for v in xs]


def _jax_grads(fn, x, params, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x), *map(jnp.asarray, params))
    return np.asarray(y), [np.asarray(v) for v in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("shape", SHAPES)
def test_rms_norm_matches_jax(shape):
    x, scale, _, g = _inputs(shape)
    y, grads = _torch_grads(lambda x, s: N.rms_norm(x, s), x, (scale,), g)
    jy, jgrads = _jax_grads(lambda x, s: JN.rms_norm(x, s), x, (scale,), g)
    np.testing.assert_allclose(y, jy, rtol=FWD_RTOL, atol=1e-6)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_layer_norm_matches_jax(shape):
    x, scale, bias, g = _inputs(shape)
    y, grads = _torch_grads(lambda x, s, b: N.layer_norm(x, s, b), x,
                            (scale, bias), g)
    jy, jgrads = _jax_grads(lambda x, s, b: JN.layer_norm(x, s, b), x,
                            (scale, bias), g)
    np.testing.assert_allclose(y, jy, rtol=FWD_RTOL, atol=1e-6)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_layer_norm_variance_is_centred():
    """Rows with a large mean (300 against a spread of 1), as GPT-2's
    residual stream has: the centred two-pass variance stays within
    5e-4 of a float64 reference (a few fp32 ulps of the mean, 3e-5 each,
    times the scale; measured 1.8e-4), where a one-pass E[x^2] - E[x]^2
    is off by more than 1e-2 (measured 0.15)."""
    x, scale, bias, _ = _inputs((64, 768), seed=4)
    x = x / 2 + 300
    mean = x.astype(np.float64).mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    want = (x - mean) / np.sqrt(var + 1e-5) * scale + bias
    got = N.layer_norm(*map(torch.from_numpy, (x, scale, bias))).numpy()
    assert np.abs(got - want).max() <= 5e-4
    x32 = torch.from_numpy(x)
    m32 = x32.mean(-1, keepdim=True)
    one_pass = (x32.square().mean(-1, keepdim=True) - m32.square())
    naive = ((x32 - m32) * torch.rsqrt(one_pass + 1e-5) * torch.from_numpy(
        scale) + torch.from_numpy(bias)).numpy()
    assert np.abs(naive - want).max() > 1e-2


def _pallas_call(body, rows, params, eps, blk):
    n, d = rows.shape
    vec = pl.BlockSpec((d,), lambda i: (0,), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(body, eps=eps), grid=(-(-n // blk),),
        in_specs=[pl.BlockSpec((blk, d), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)] + [vec] * len(params),
        out_specs=pl.BlockSpec((blk, d), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(rows.shape, rows.dtype),
        interpret=True)(rows, *params)


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_plain_forward_matches_pallas_kernel_interpret(norm):
    """512 rows of 256 in the JAX op's blocks of 256 rows."""
    x, scale, bias, _ = _inputs((512, 256), seed=3, mean=1.5)
    if norm == "rms":
        want = _pallas_call(JN._rms_kernel, jnp.asarray(x),
                            [jnp.asarray(scale)], 1e-6, 256)
        got = N.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    else:
        want = _pallas_call(JN._ln_kernel, jnp.asarray(x),
                            [jnp.asarray(scale), jnp.asarray(bias)], 1e-5,
                            256)
        got = N.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FWD_RTOL, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_inputs_match_jax(dtype):
    """x and the params in bf16/fp16: fp32 statistics, one rounding into
    x's dtype, as JAX's reference; grads come back in each input's dtype.
    Within one step of the dtype of the JAX result."""
    x, scale, bias, g = _inputs((6, 96), seed=5)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    tx = [torch.tensor(v).to(dtype).requires_grad_() for v in
          (x, scale, bias)]
    y = N.layer_norm(*tx)
    y.backward(torch.from_numpy(g).to(dtype))
    jx = [jnp.asarray(v).astype(jdt) for v in (x, scale, bias)]
    jy, vjp = jax.vjp(JN.layer_norm, *jx)
    jg = vjp(jnp.asarray(g).astype(jdt))
    assert y.dtype == dtype and all(t.grad.dtype == dtype for t in tx)
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    want = np.asarray(jy).astype(np.float32)
    np.testing.assert_allclose(y.detach().float().numpy(), want, rtol=step,
                               atol=step)
    for t, w in zip(tx, jg):
        w = np.asarray(w).astype(np.float32)
        np.testing.assert_allclose(t.grad.float().numpy(), w,
                                   rtol=4 * step, atol=4 * step * abs(w).max())


def test_use_kernel_and_the_plain_scope():
    """None: the Function (plain forward on the CPU); False and
    plain_norms(): the plain version with plain autograd; True on a CPU
    tensor and the kernel wrappers on CPU tensors refuse. Nothing counts a
    launch on the CPU."""
    x, scale, bias, _ = _inputs((3, 32))
    x, scale, bias = map(torch.from_numpy, (x, scale, bias))
    xg = x.clone().requires_grad_()
    assert type(N.rms_norm(xg, scale).grad_fn).__name__ == \
        "RMSNormFunctionBackward"
    assert type(N.layer_norm(xg, scale, bias, use_kernel=False).grad_fn
                ).__name__ != "LayerNormFunctionBackward"
    with N.plain_norms():
        assert type(N.rms_norm(xg, scale).grad_fn).__name__ != \
            "RMSNormFunctionBackward"
        with N.plain_norms(False):    # an enclosing block still holds
            assert type(N.rms_norm(xg, scale).grad_fn).__name__ != \
                "RMSNormFunctionBackward"
    assert type(N.rms_norm(xg, scale).grad_fn).__name__ == \
        "RMSNormFunctionBackward"
    with pytest.raises(ValueError, match="CUDA"):
        N.rms_norm(x, scale, use_kernel=True)
    with pytest.raises(ValueError, match="device"):
        N.rms_norm_kernel(x, scale)
    with pytest.raises(ValueError, match="device"):
        N.layer_norm_kernel(x, scale, bias)
    assert N.rms_norm_kernel.launches == 0
    assert N.layer_norm_kernel.launches == 0
    torch.testing.assert_close(N.layer_norm(x, scale, bias),
                               L.layer_norm(x, scale, bias), rtol=0, atol=0)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_model_norms_route_through_the_functions(family, monkeypatch):
    """Every norm of a forward goes through ops/norms.py (GPT-2:
    LayerNorm, Llama: RMSNorm; 2L + 1 a forward) and under plain_norms()
    none does; loss and grads equal the plain path (1e-6: the closed-form
    backward against autograd of the same formula)."""
    model_cls = {"gpt2": GPT2, "llama": Llama}[family]
    fn = N.LayerNormFunction if family == "gpt2" else N.RMSNormFunction
    calls = []
    apply = fn.apply
    monkeypatch.setattr(fn, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 17)))
    runs = []
    for plain in (False, True):
        m = model_cls(size="tiny", device="cpu", remat=False)
        m.init_params(torch.Generator().manual_seed(0))
        calls.clear()
        with N.plain_norms(plain):
            loss = m.loss((tok[:, :-1], tok[:, 1:]))
            loss.backward()
        assert len(calls) == (0 if plain else 2 * m.config.num_layers + 1)
        runs.append((float(loss.detach()), {n: p.grad for n, p in
                                   m.params.items()}))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-6 * abs(runs[1][0])
    for name, g in runs[1][1].items():
        torch.testing.assert_close(runs[0][1][name], g, rtol=0, atol=1e-6)


def test_paged_forward_plain_pass_takes_plain_norms(monkeypatch):
    """paged_forward(use_kernel=False) is plain in its norms as well:
    with use_kernel=True the 2L + 1 norms of a pass go through the
    Function, with False none does, and the logits agree."""
    from deepspeed_tpu_torch.inference.v2.paged import paged_forward
    calls = []
    apply = N.RMSNormFunction.apply
    monkeypatch.setattr(N.RMSNormFunction, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    eng = ds.build_engine("llama", "tiny", {
        "dtype": "fp32", "kv_block_size": 8, "num_kv_blocks": 16},
        device="cpu")
    c = eng.model.config
    out = []
    for use_kernel in (True, False):
        pools = {k: torch.zeros((c.num_layers, 4, 8, c.num_kv_heads,
                                 c.head_dim)) for k in ("k", "v")}
        calls.clear()
        logits, _ = paged_forward(
            eng.model, pools, torch.arange(10)[None] % c.vocab_size,
            torch.zeros(1, dtype=torch.int32),
            torch.arange(4, dtype=torch.int32)[None],
            torch.tensor([10], dtype=torch.int32), use_kernel=use_kernel)
        assert len(calls) == (2 * c.num_layers + 1 if use_kernel else 0)
        out.append(logits)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=1e-6)


# ------------------------------------------- the CUDA kernels' schedule
SCHEDULE_DS = (64, 768, 1024, 4096, 5120, 8192)
SCHEDULE_ROWS = (1, 7, 37)
GPT2_SIZES = ("tiny", "125m", "350m", "1.3b")
LLAMA_SIZES = ("tiny", "7b", "13b", "70b", "3-8b", "3-70b")


def _schedule(kind, x, scale, bias, dtype, pdtype):
    """numpy emulation of csrc/norms.cu's warp_row / cta_row kernels over
    x [rows, d] (fp32 values of ``dtype``; params fp32 values of
    ``pdtype``): thread t of a row holds vectors t + j * threads (j <
    vectors_per_thread, while < d / V), sums its elements in order, the
    warp adds by xor butterfly (16, 8, 4, 2, 1), the warps' partials are
    added in warp order; each add and product is one fp32 rounding, as the
    kernels' __fadd_rn / __fmul_rn. rsqrtf is taken correctly rounded
    here (the card's differs by an ulp or so). Returns y in ``dtype``."""
    f32 = np.float32
    rows, d = x.shape
    plan = N.launch_plan(kind, rows, d, dtype, pdtype)
    assert plan["variant"] in ("warp_row", "cta_row"), plan
    vec = 16 // (torch.finfo(dtype).bits // 8)
    nvec, threads = d // vec, 32 * plan["warps_per_row"]
    vpt = plan["vectors_per_thread"]
    assert vpt <= N.MAX_VECS and threads * vpt >= nvec
    xv = x.astype(f32).reshape(rows, nvec, vec)

    def row_sum(term):                       # term [rows, nvec, vec]
        acc = np.zeros((rows, threads), f32)
        for j in range(vpt):
            k = np.arange(threads) + j * threads
            live, k = k < nvec, np.minimum(k, nvec - 1)
            for i in range(vec):
                acc = np.where(live, acc + term[:, k, i], acc)
        part = acc.reshape(rows, -1, 32)
        lanes = np.arange(32)
        for s in (16, 8, 4, 2, 1):
            part = part + part[:, :, lanes ^ s]
        total = np.zeros(rows, f32)
        for w in range(part.shape[1]):
            total = total + part[:, w, 0]
        return total[:, None, None]

    fd, eps = f32(d), f32(EPS[kind])
    sc = scale.astype(f32).reshape(nvec, vec)
    if kind == "rms":
        var = row_sum(xv * xv) / fd
    else:
        mean = row_sum(xv) / fd
        c = xv - mean
        var = row_sum(c * c) / fd
    rstd = (1.0 / np.sqrt((var + eps).astype(np.float64))).astype(f32)
    if kind == "rms":
        y = (xv * rstd) * sc
    else:
        y = ((xv - mean) * rstd) * sc + bias.astype(f32).reshape(nvec, vec)
    assert y.dtype == f32
    return torch.from_numpy(y.reshape(rows, d)).to(dtype)


def norm_ulps(got, ref, dtype, bias=None) -> float:
    """max |got - ref| in ``dtype``'s spacing at |ref| (or at |bias| where
    larger: a LayerNorm output that the bias add cancels to near zero),
    as tests/test_torch_cuda.py's."""
    eps = torch.finfo(dtype).eps
    mag = ref.float().abs()
    if bias is not None:
        mag = torch.maximum(mag, bias.float().abs())
    mag = mag.clamp(min=torch.finfo(dtype).tiny)
    ulp = eps * torch.exp2(torch.floor(torch.log2(mag)))
    return float(((got.float() - ref.float()).abs() / ulp).max())


@pytest.mark.parametrize("d", SCHEDULE_DS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_kernel_schedule_matches_pallas_and_plain(kind, dtype, d):
    """The warp_row / cta_row schedule at the port's model widths, 1, 7
    and 37 rows, params in fp32 and in x's dtype: fp32 against the Pallas
    body in interpret mode at 1e-6 + two ulps relative (the sums run in
    another order); bf16/fp16 within one ulp of the plain version."""
    for rows in SCHEDULE_ROWS:
        x, scale, bias, _ = _inputs((rows, d), seed=rows + d, mean=0.5)
        xq = torch.from_numpy(x).to(dtype)
        for pdtype in dict.fromkeys((torch.float32, dtype)):
            s = torch.from_numpy(scale).to(pdtype)
            b = torch.from_numpy(bias).to(pdtype)
            got = _schedule(kind, xq.float().numpy(), s.float().numpy(),
                            b.float().numpy(), dtype, pdtype)
            if dtype == torch.float32:
                body = JN._rms_kernel if kind == "rms" else JN._ln_kernel
                params = [scale] if kind == "rms" else [scale, bias]
                want = _pallas_call(body, jnp.asarray(x),
                                    [jnp.asarray(p) for p in params],
                                    EPS[kind], rows)
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=FWD_RTOL, atol=1e-6)
            else:
                ref = (L.rms_norm(xq, s) if kind == "rms"
                       else L.layer_norm(xq, s, b))
                assert norm_ulps(got, ref, dtype,
                                 b if kind == "layer" else None) <= 1.0


@pytest.mark.parametrize("d", [512, 768, 4096])
def test_kernel_schedule_variance_is_centred(d):
    """fp32 LayerNorm rows of mean 300 through the schedule (warp_row at
    512, cta_row with 2 and 8 warps at 768 and 4096) within 5e-4 of
    float64, as test_layer_norm_variance_is_centred holds the plain
    version."""
    x, scale, bias, _ = _inputs((37, d), seed=6)
    x = x / 2 + 300
    mean = x.astype(np.float64).mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    want = (x - mean) / np.sqrt(var + 1e-5) * scale + bias
    got = _schedule("layer", x, scale, bias, torch.float32, torch.float32)
    assert np.abs(got.numpy() - want).max() <= 5e-4


def test_launch_plan_is_a_function_of_the_shapes():
    """Every width of the port's model configs takes warp_row or cta_row in
    fp32, bf16 and fp16 with params in fp32 and in x's dtype; an odd d
    (201) and a misaligned start take general; d = 200 is a whole number
    of vectors in every dtype and takes warp_row. The plan holds the row
    (threads x vectors x V >= d, at most MAX_VECS vectors a thread), its
    grid is min(row groups, slots), and the same shapes give the same
    plan whatever else differs (rows only set the grid)."""
    from deepspeed_tpu_torch.models.gpt2 import gpt2_config
    from deepspeed_tpu_torch.models.llama import llama_config
    widths = {gpt2_config(s).hidden_size for s in GPT2_SIZES}
    widths |= {llama_config(s).hidden_size for s in LLAMA_SIZES}
    assert widths >= {64, 768, 1024, 2048, 4096, 5120, 8192}
    for kind in ("rms", "layer"):
        for dtype in DTYPES:
            vec = 16 // (torch.finfo(dtype).bits // 8)
            for pdtype in dict.fromkeys((torch.float32, dtype)):
                for d in sorted(widths) + [200]:
                    plan = N.launch_plan(kind, 37, d, dtype, pdtype)
                    want = "warp_row" if d <= 128 * vec else "cta_row"
                    assert plan["variant"] == want, (kind, dtype, d, plan)
                    assert (plan["threads"] // 32 if want == "cta_row"
                            else 1) == plan["warps_per_row"]
                    assert plan["vectors_per_thread"] <= N.MAX_VECS
                    assert (32 * plan["warps_per_row"]
                            * plan["vectors_per_thread"] * vec) >= d
                    for rows in (1, 7, 37, 24576):
                        again = N.launch_plan(kind, rows, d, dtype, pdtype,
                                              slots=528)
                        groups = (-(-rows // N.ROW_WARPS)
                                  if want == "warp_row" else rows)
                        assert again["grid"] == min(groups, 528)
                        assert {k: v for k, v in again.items()
                                if k not in ("grid", "row_groups")} == {
                            k: v for k, v in plan.items()
                            if k not in ("grid", "row_groups")}
                for d, aligned in ((201, True), (768, False), (4096, False)):
                    plan = N.launch_plan(kind, 37, d, dtype, pdtype, aligned)
                    assert plan["variant"] == "general"
                    assert plan["vectors_per_thread"] == 0
                    assert plan["grid"] == 37
    # the main paths' shapes, as csrc/norms.cu plan_of gives them
    for args, want in (
            (("layer", 24576, 768, torch.bfloat16), ("warp_row", 1, 3, 128)),
            (("rms", 2048, 4096, torch.bfloat16), ("cta_row", 4, 4, 128)),
            (("rms", 8, 4096, torch.bfloat16), ("cta_row", 4, 4, 128)),
            (("rms", 8, 5120, torch.bfloat16), ("cta_row", 5, 4, 160)),
            (("layer", 8, 768, torch.float32), ("cta_row", 2, 3, 64)),
            (("layer", 8, 512, torch.float32), ("warp_row", 1, 4, 128)),
            (("rms", 8, 16384, torch.bfloat16), ("cta_row", 16, 4, 512))):
        plan = N.launch_plan(*args)
        assert (plan["variant"], plan["warps_per_row"],
                plan["vectors_per_thread"], plan["threads"]) == want, args
    assert N.launch_plan("rms", 8, 32768, torch.bfloat16)["variant"] == \
        "general"                       # past the register ceiling
    with pytest.raises(ValueError):
        N.launch_plan("rms", 8, 64, torch.bfloat16, torch.float16)
    with pytest.raises(ValueError):
        N.launch_plan("batch", 8, 64, torch.float32)
