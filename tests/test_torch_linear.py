"""The port's linear/ and ops/fp_quant.py (deepspeed_tpu_torch/linear/,
deepspeed_tpu_torch/ops/fp_quant.py) against the JAX package's
(deepspeed_tpu/linear/, deepspeed_tpu/ops/fp_quant.py), fp32 on the CPU,
on the same numpy inputs.

Held bit for bit: fp_quantize / fp_dequantize and their row forms at fp6
(e3m2, e2m3), fp8 (e4m3, e5m2) and fp12 (e4m7); quantize_param's codes,
scales and dequantized() at int 4/6/8 and the fp formats (the eager JAX
quotient ``amax / qmax``, which the kernel's exact-division mode
computes); quantize_dense_params's leaves, codes and scales in fp32 and
bf16 scale dtypes (the reciprocal product of JAX's jitted ``_q_leaf``).
OptimizedLinear's forward and grads within 1e-6 relative, grads in the
adapters only; lora_transform's targets (names) for gpt2, llama and phi
tiny with the default target_mods and a target_regex, its ValueError;
fuse_lora and the merge against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import linear as jl
from deepspeed_tpu import models as jm
from deepspeed_tpu.linear import quantization as jq
from deepspeed_tpu.ops import fp_quant as jfp
from deepspeed_tpu_torch import linear as tl
from deepspeed_tpu_torch.linear import quantization as tq
from deepspeed_tpu_torch.models.convert import (flatten_tree,
                                                quantized_from_jax)
from deepspeed_tpu_torch.ops import fp_quant as tfp
from deepspeed_tpu_torch.ops import quantization as TQ

FP_FORMATS = [(6, 2), (6, 3), (8, 3), (8, 2), (12, 7)]


def _x(shape=(4, 64, 384), seed=0):
    """Blocks of very different magnitudes (the scales matter)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(
        1e-3, 3.0, shape[:-1] + (1,))).astype(np.float32)


def _np(t):
    """Codes as comparable numpy (float8 through their bytes)."""
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return t.view(torch.uint8).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if "float8" in a.dtype.name else a


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    assert (a.view(f"u{a.dtype.itemsize}") ==
            b.view(f"u{b.dtype.itemsize}")).all()


# ------------------------------------------------------------- fp formats
@pytest.mark.parametrize("q_bits,man", FP_FORMATS)
def test_fp_quantize_matches_jax_bit_for_bit(q_bits, man):
    x = _x()
    jc, js = jfp.fp_quantize(jnp.asarray(x), q_bits=q_bits,
                             mantissa_bits=man)
    tc, ts = tfp.fp_quantize(torch.from_numpy(x), q_bits=q_bits,
                             mantissa_bits=man)
    _bits_equal(_np(jc), _np(tc))
    _bits_equal(js, ts.numpy())
    jd = jfp.fp_dequantize(jc, js, q_bits=q_bits, mantissa_bits=man,
                           shape=x.shape)
    td = tfp.fp_dequantize(tc, ts, q_bits=q_bits, mantissa_bits=man,
                           shape=x.shape)
    _bits_equal(jd, td.numpy())
    q = tfp.FP_Quantize(group_size=512)
    c2, s2 = q.quantize(torch.from_numpy(x), q_bits=q_bits,
                        q_mantisa_bits=man)
    assert torch.equal(s2, ts)
    _bits_equal(q.dequantize(c2, s2, q_bits=q_bits, q_mantisa_bits=man,
                             shape=x.shape).numpy(), td.numpy())


@pytest.mark.parametrize("q_bits,man", FP_FORMATS)
def test_fp_quantize_rows_matches_jax_bit_for_bit(q_bits, man):
    x = _x((3, 5, 200), seed=1)
    jc, js = jfp.fp_quantize_rows(jnp.asarray(x), q_bits=q_bits,
                                  mantissa_bits=man, group_size=128)
    tc, ts = tfp.fp_quantize_rows(torch.from_numpy(x), q_bits=q_bits,
                                  mantissa_bits=man, group_size=128)
    _bits_equal(_np(jc), _np(tc))
    _bits_equal(js, ts.numpy())
    _bits_equal(jfp.fp_dequantize_rows(jc, js, row_len=200, q_bits=q_bits,
                                       mantissa_bits=man),
                tfp.fp_dequantize_rows(tc, ts, row_len=200, q_bits=q_bits,
                                       mantissa_bits=man).numpy())


def test_fp_formats_refuse_as_jax():
    x = torch.zeros(16)
    for kw, match in ((dict(q_bits=6, group_size=6), "multiple of 4"),
                      (dict(q_bits=12, group_size=5), "multiple of 2"),
                      (dict(q_bits=8, mantissa_bits=1), "unsupported"),
                      (dict(q_bits=10), "unsupported")):
        with pytest.raises(ValueError, match=match):
            tfp.fp_quantize(x, **kw)
        with pytest.raises(ValueError, match=match):
            jfp.fp_quantize(jnp.zeros(16), **kw)
    np.testing.assert_array_equal(jfp.fp_magnitude_table(3, 2),
                                  tfp.fp_magnitude_table(3, 2))


# --------------------------------------------------------- quantize_param
QPARAM_CONFIGS = {
    "int8": dict(), "int8_g128": dict(group_size=128),
    "int6": dict(q_bits=6), "int4": dict(q_bits=4),
    "fp6_e3m2": dict(q_format="fp", q_bits=6, mantissa_bits=2),
    "fp8_e4m3": dict(q_format="fp", q_bits=8, mantissa_bits=3),
    "fp8_e5m2": dict(q_format="fp", q_bits=8, mantissa_bits=2),
    "fp12_e4m7": dict(q_format="fp", q_bits=12, mantissa_bits=7)}


@pytest.mark.parametrize("name", list(QPARAM_CONFIGS))
def test_quantize_param_matches_jax_bit_for_bit(name):
    kw = QPARAM_CONFIGS[name]
    x = _x((4, 64, 384), seed=2)
    jp = jq.quantize_param(jnp.asarray(x), jl.QuantizationConfig(**kw))
    tp = tq.quantize_param(torch.from_numpy(x), tl.QuantizationConfig(**kw))
    _bits_equal(_np(jp.codes), _np(tp.codes))
    _bits_equal(jp.scales, tp.scales.numpy())
    _bits_equal(jp.dequantized(), tp.dequantized().numpy())
    assert tp.ndim == jp.ndim == 3 and tp.shape == jp.shape
    # a layer of the stack alone, as LoRA's forward reads it
    per = 64 * 384
    np.testing.assert_array_equal(
        tp.dequantize_range(per, 2 * per).numpy(),
        np.asarray(jp.dequantized()).reshape(-1)[per:2 * per])
    # the JAX QuantizedParameter carried across dequantizes the same
    _bits_equal(jp.dequantized(), quantized_from_jax(jp).dequantized())


def test_quantize_param_scale_is_the_eager_quotient():
    """The default config's scale is JAX's eager ``amax / 127``, which
    the plain version and the kernel's exact-division mode compute; the
    ZeRO++ wire's reciprocal product differs from it in some blocks."""
    x = _x((4, 64, 384), seed=3)
    jp = jq.quantize_param(jnp.asarray(x))
    exact = TQ.quantize_rows(torch.from_numpy(x).reshape(1, -1),
                             exact=True)
    wire = TQ.quantize_rows(torch.from_numpy(x).reshape(1, -1))
    _bits_equal(jp.scales, exact[1].numpy())
    _bits_equal(jp.codes, exact[0].numpy())
    assert not np.array_equal(np.asarray(jp.scales), wire[1].numpy())
    with pytest.raises(ValueError, match="q_bits"):
        tq.quantize_param(torch.zeros(8), tl.QuantizationConfig(q_bits=5))


def test_dequantize_tree_matches_jax():
    x = _x((32, 48), seed=4)
    jt = jl.dequantize_tree({"a": jq.quantize_param(jnp.asarray(x)),
                             "b": {"c": jnp.ones(3)}})
    tt = tl.dequantize_tree({"a": tq.quantize_param(torch.from_numpy(x)),
                             "b": {"c": torch.ones(3)}})
    _bits_equal(jt["a"], tt["a"].numpy())
    np.testing.assert_array_equal(jt["b"]["c"], tt["b"]["c"].numpy())


# --------------------------------------------------- quantize_dense_params
def _llama_tree(**kw):
    jmodel = jm.Llama(size="tiny", **kw)
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("family", ["llama", "gpt2", "phi"])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_quantize_dense_params_matches_jax(family, scale_dtype):
    """The same leaves quantized (norm and bias stacks left alone, embed
    skipped), the codes bit-equal and the scales bit-equal in the scale
    dtype; the default min_size leaves a tiny model whole, as in JAX."""
    jmodel = jm.get_model_class(family)(size="tiny")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    jout = flatten_tree(jax.tree.map(np.asarray, jq.quantize_dense_params(
        jax.tree.map(jnp.asarray, tree), min_size=1,
        scale_dtype=getattr(jnp, scale_dtype))))
    flat = {n: torch.from_numpy(np.array(v, np.float32))
            for n, v in flatten_tree(tree).items()}
    tout = tq.quantize_dense_params(flat, min_size=1,
                                    scale_dtype=getattr(torch, scale_dtype))
    assert sorted(jout) == sorted(tout)
    assert "layers/wq_q" in tout and not any(
        n.startswith("embed/") and n.endswith("_q") for n in tout)
    for n, v in jout.items():
        got = tout[n]
        if n.endswith("_q"):
            np.testing.assert_array_equal(v, got.numpy())
        elif n.endswith("_s"):
            assert str(got.dtype).endswith(scale_dtype)
            _bits_equal(np.asarray(v, np.float32), got.float().numpy())
    assert sorted(tq.quantize_dense_params(flat)) == sorted(flat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dequantize_dense_matches_jax(dtype):
    """A layer's pair dequantized in the serving dtype: JAX's
    ``q.astype(dtype) * s.astype(dtype)`` bit for bit (the port's one
    promoting product)."""
    x = _x((2, 256, 384), seed=5)
    jd_, td_ = getattr(jnp, dtype), getattr(torch, dtype)
    jt = jq.quantize_dense_params({"layers": {"wq": jnp.asarray(x)}},
                                  min_size=1, scale_dtype=jd_)
    tt = tq.quantize_dense_params({"layers/wq": torch.from_numpy(x)},
                                  min_size=1, scale_dtype=td_)
    jd = jq.dequantize_dense({k: v[1] for k, v in jt["layers"].items()},
                             jd_)
    td = tq.dequantize_dense({"wq_q": tt["layers/wq_q"][1],
                              "wq_s": tt["layers/wq_s"][1]}, td_)
    assert td["wq"].dtype == td_
    _bits_equal(np.asarray(jd["wq"]).view(f"u{td_.itemsize}"),
                td["wq"].view(getattr(torch, f"int{8 * td_.itemsize}"))
                .numpy())
    assert tq.dequantize_dense({"w": 1}, torch.float32) == {"w": 1}


# -------------------------------------------------------- OptimizedLinear
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("bias", [False, True])
def test_optimized_linear_matches_jax(quant, bias):
    """Forward and grads within 1e-6 relative on JAX's parameters (the
    base quantized on each side, codes equal), with lora_b perturbed so
    the adapter path counts; only lora_a, lora_b (and the bias) get
    grads."""
    qcfg = {None: None, "int8": {}, "int4": dict(q_bits=4)}[quant]
    jlin = jl.OptimizedLinear(64, 48, jl.LoRAConfig(lora_r=4),
                              None if qcfg is None
                              else jl.QuantizationConfig(**qcfg), bias=bias)
    params = jlin.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params["lora_b"] = jnp.asarray(
        rng.standard_normal((4, 48)).astype(np.float32) * 0.1)
    if bias:
        params["bias"] = jnp.asarray(
            rng.standard_normal(48).astype(np.float32))
    base = params["base"]
    w = np.asarray(base.dequantized() if jl.is_quantized(base) else base)
    # the JAX layer's float draw, quantized on each side
    wf = np.array(jax.random.normal(jax.random.split(
        jax.random.PRNGKey(0))[0], (64, 48), jnp.float32) / jnp.sqrt(64))
    x = rng.standard_normal((8, 64)).astype(np.float32)
    tlin = tl.OptimizedLinear(
        64, 48, tl.LoRAConfig(lora_r=4),
        None if qcfg is None else tl.QuantizationConfig(**qcfg), bias=bias,
        device="cpu", base_weight=torch.from_numpy(wf))
    if qcfg is not None:
        _bits_equal(_np(base.codes), _np(tlin.base.codes))
    np.testing.assert_array_equal(tlin.base_weight().numpy(), w)
    with torch.no_grad():
        tlin.lora_a.copy_(torch.from_numpy(np.asarray(params["lora_a"])))
        tlin.lora_b.copy_(torch.from_numpy(np.asarray(params["lora_b"])))
        if bias:
            tlin.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))

    trained = {k: v for k, v in params.items() if k != "base"}

    def jloss(p):
        return jnp.sum(jlin.apply(dict(p, base=base), jnp.asarray(x)) ** 2)

    jy = np.asarray(jlin.apply(params, jnp.asarray(x)))
    jg = jax.grad(jloss)(trained)
    ty = tlin(torch.from_numpy(x))
    (ty ** 2).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-6,
                               atol=1e-6 * np.abs(jy).max())
    for name in ("lora_a", "lora_b") + (("bias",) if bias else ()):
        want = np.asarray(jg[name])
        np.testing.assert_allclose(getattr(tlin, name).grad.numpy(), want,
                                   rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert {n for n, p in tlin.named_parameters()} == \
        {"lora_a", "lora_b"} | ({"bias"} if bias else set())


def test_optimized_linear_starts_as_its_base():
    lin = tl.OptimizedLinear(16, 8, tl.LoRAConfig(lora_r=4),
                             tl.QuantizationConfig(), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(lin(x), x @ lin.base.dequantized(),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- lora_transform
def _trees(family):
    jmodel = jm.get_model_class(family)(size="tiny")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    flat = {n: torch.from_numpy(np.array(v, np.float32))
            for n, v in flatten_tree(tree).items()}
    return jax.tree.map(jnp.asarray, tree), flat


@pytest.mark.parametrize("family", ["gpt2", "llama", "phi"])
@pytest.mark.parametrize("regex", [None, r"layers/w[qkvo]$|lm_head$"])
def test_lora_transform_targets_match_jax(family, regex):
    """The same names become adapters (whole path components: wq but not
    wq_b), with JAX's shapes; the frozen targets quantized to JAX's
    codes; the untargeted leaves as they were."""
    jtree, flat = _trees(family)
    cfg = dict(lora_r=4)
    jfrozen, jstate, _ = jl.lora_transform(
        jtree, jl.LoRAConfig(**cfg), jl.QuantizationConfig(),
        key=jax.random.PRNGKey(1), target_regex=regex)
    frozen, state, _ = tl.lora_transform(
        flat, tl.LoRAConfig(**cfg), tl.QuantizationConfig(),
        torch.Generator().manual_seed(1), target_regex=regex)
    assert sorted(state.adapters) == sorted(jstate.adapters)
    assert "layers/wq" in state.adapters and "layers/wq_b" not in \
        state.adapters
    for name, ab in state.adapters.items():
        for k in "ab":
            assert tuple(ab[k].shape) == jstate.adapters[name][k].shape
        assert not ab["b"].any()
    jflat = flatten_tree(jfrozen)
    assert sorted(jflat) == sorted(frozen)
    for name, leaf in frozen.items():
        if name in state.adapters:
            _bits_equal(jflat[name].codes, leaf.codes.numpy())
            _bits_equal(jflat[name].scales, leaf.scales.numpy())
        else:
            assert not tl.is_quantized(leaf)
            np.testing.assert_array_equal(np.asarray(jflat[name]),
                                          leaf.numpy())


def test_lora_transform_refuses_an_empty_target_set_as_jax():
    jtree, flat = _trees("llama")
    with pytest.raises(ValueError) as jerr:
        jl.lora_transform(jtree, jl.LoRAConfig(target_mods=["nope"]))
    with pytest.raises(ValueError) as terr:
        tl.lora_transform(flat, tl.LoRAConfig(target_mods=["nope"]))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jl.lora_transform(jtree, target_regex="nothing$")
    with pytest.raises(ValueError) as terr:
        tl.lora_transform(flat, target_regex="nothing$")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("quant", [False, True])
def test_merge_and_fuse_lora_match_jax(quant):
    """merge(frozen, adapters) and fuse_lora on JAX's frozen tree and
    (perturbed) adapters carried across: every effective leaf within 1e-6
    of JAX's."""
    from deepspeed_tpu_torch.models.convert import lora_from_jax
    jtree, _ = _trees("llama")
    jfrozen, jstate, jmerge = jl.lora_transform(
        jtree, jl.LoRAConfig(lora_r=4),
        jl.QuantizationConfig() if quant else None,
        key=jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    jads = {n: {"a": ab["a"], "b": jnp.asarray(rng.standard_normal(
        ab["b"].shape).astype(np.float32) * 0.01)}
        for n, ab in jstate.adapters.items()}
    frozen, ads = lora_from_jax(jfrozen, jax.tree.map(np.asarray, jads))
    want = flatten_tree(jax.tree.map(np.asarray, jmerge(jfrozen, jads)))
    got = tl.make_merge_fn(tl.LoRAConfig(lora_r=4))(frozen, ads)
    fused = tl.fuse_lora(frozen, tl.LoRAState(ads, tl.LoRAConfig(lora_r=4)))
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v, rtol=1e-6,
                                   atol=1e-6 * np.abs(v).max())
        np.testing.assert_array_equal(fused[name].numpy(),
                                      got[name].numpy())
