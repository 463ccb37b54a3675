"""The port's flash attention (deepspeed_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas flash attention, run as the JAX tests run
it on the CPU (interpret mode), on the same numpy inputs. Shapes and
tolerances are those of tests/test_pallas_kernels.py:10-78 and :191:
forward 2e-5, gradients 2e-4, bf16 3e-2. The port's CPU path is the plain
version of its CUDA kernels (same rounding points)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as T

# the module (ops.pallas re-exports a function of the same name)
J = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")


def _inputs(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def _close(got, ref, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def _grads(q, k, v, do, causal=True, window=None):
    """(out, dq, dk, dv) of the JAX and the port's flash attention for
    the loss sum(out * do)."""
    def f(q, k, v):
        return jnp.sum(J.flash_attention(q, k, v, causal=causal,
                                         window=window) * do)

    jgrads = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = T.flash_attention(*leaves, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    jout = J.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                             window=window)
    return (out, jout), [(t.grad, g) for t, g in zip(leaves, jgrads)]


@pytest.mark.parametrize("s,hq,hkv,d", [(128, 4, 4, 32), (256, 4, 2, 64)])
def test_forward_matches_jax(s, hq, hkv, d):
    q, k, v = _inputs(2, s, hq, hkv, d)
    got = T.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    _close(got, J.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=True), 2e-5)


def test_non_causal_matches_jax():
    q, k, v = _inputs(1, 128, 2, 2, 32, seed=1)
    got = T.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    _close(got, J.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=False), 2e-5)


def test_lse_matches_the_jax_forward_kernel():
    """The saved residual too: o and the log-sum-exp of ``_flash_fwd``."""
    b, s, hq, hkv, d = 1, 256, 4, 2, 32
    q, k, v = _inputs(b, s, hq, hkv, d, seed=5)
    o, lse = T.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(  # noqa
        -1, s, d)
    jo, jlse = J._flash_fwd(to_bh(q), to_bh(k), to_bh(v), causal=True,
                            sc=1.0 / np.sqrt(d), rep=hq // hkv)
    _close(o, np.asarray(jo).reshape(b, hq, s, d).transpose(0, 2, 1, 3), 2e-5)
    _close(lse, np.asarray(jlse).reshape(b, hq, s), 2e-5)


@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2), (4, 1)])
def test_grads_match_jax(hq, hkv):
    q, k, v = _inputs(1, 256, hq, hkv, 32, seed=2)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    (out, jout), grads = _grads(q, k, v, do)
    _close(out, jout, 2e-5)
    for got, ref in grads:
        assert got.shape == ref.shape
        _close(got, ref, 2e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_matches_jax(dtype):
    """bf16 at the JAX test's 3e-2; fp16, which the JAX flash path also
    takes, at the same bound."""
    q, k, v = _inputs(1, 128, 2, 2, 32, seed=3)
    jb = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)]
    tb = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    got = T.flash_attention(*tb, causal=True)
    assert got.dtype == getattr(torch, dtype)
    _close(got, J.flash_attention(*jb, causal=True), 3e-2)


def test_unaligned_seq_matches_jax():
    """S=192: the JAX wrapper takes its exact path (unaligned S), the port
    masks the ragged tile; same function."""
    q, k, v = _inputs(1, 192, 2, 2, 32, seed=4)
    do = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    (out, jout), grads = _grads(q, k, v, do)
    _close(out, jout, 2e-5)
    for got, ref in grads:
        _close(got, ref, 2e-4)


@pytest.mark.parametrize("s,w", [(256, 64), (384, 100)])
def test_sliding_window_matches_jax(s, w):
    q, k, v = _inputs(2, s, 4, 4, 64, seed=6)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    (out, jout), grads = _grads(q, k, v, do, window=w)
    _close(out, jout, 2e-5)
    for got, ref in grads:
        _close(got, ref, 2e-4)


def test_window_requires_causal_and_heads_must_group():
    q, k, v = map(torch.from_numpy, _inputs(1, 8, 3, 2, 16))
    with pytest.raises(ValueError, match="window"):
        T.flash_attention(q, k, k, causal=False, window=4)
    with pytest.raises(ValueError, match="positive"):
        T.flash_attention(k, k, k, window=0)
    with pytest.raises(ValueError, match="multiple"):
        T.flash_attention(q, k, v)


# the tiling edges of the port's tensor-core kernels (128-row q blocks of
# two 64-row warpgroups, 64-key tiles, 128-key dk/dv blocks), run here
# through the plain versions those kernels are held to on the card
EDGE_CASES = {                         # b, s, hq, hkv, d, causal, window
    "s40_below_one_tile": (2, 40, 4, 2, 32, True, None),
    "s129_one_past_a_block": (1, 129, 4, 4, 32, True, None),
    "narrow_window_crosses_tiles": (1, 256, 2, 2, 32, True, 24),
    "d16": (2, 128, 4, 2, 16, True, None),
    "gqa_rep4_full": (1, 128, 8, 2, 32, False, None),
    # the model families' head dims (phi "2", phi3 "mini", gptj "6b")
    "d80_gqa": (1, 128, 4, 2, 80, True, None),
    "d96_window": (1, 256, 2, 2, 96, True, 40),
    "d256_s129": (1, 129, 2, 1, 256, True, None),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_tiling_edges_match_jax(case):
    b, s, hq, hkv, d, causal, window = EDGE_CASES[case]
    q, k, v = _inputs(b, s, hq, hkv, d, seed=11)
    do = np.random.default_rng(12).standard_normal(q.shape).astype(
        np.float32)
    (out, jout), grads = _grads(q, k, v, do, causal=causal, window=window)
    _close(out, jout, 2e-5)
    for got, ref in grads:
        assert got.shape == ref.shape
        _close(got, ref, 2e-4)


def test_kernel_variant_table():
    """The dispatch table of the CUDA entry points: bf16 and fp16 take the
    tensor-core kernels, fp32 the exact CUDA-core ones, at every head dim
    the kernels take (the powers of two and the model families' 80, 96
    and 256); anything else takes none."""
    assert T.KERNEL_DIMS == (16, 32, 64, 80, 96, 128, 256)
    for d in T.KERNEL_DIMS:
        assert T.kernel_variant(torch.bfloat16, d) == "wgmma"
        assert T.kernel_variant(torch.float16, d) == "wgmma"
        assert T.kernel_variant(torch.float32, d) == "cuda_cores"
    assert T.kernel_variant(torch.float64, 64) is None
    assert T.kernel_variant(torch.bfloat16, 48) is None
    assert set(T.VARIANTS.values()) == {"wgmma", "cuda_cores"}
