"""The port's ZeRO++ wire quantizer (deepspeed_tpu_torch/ops/quantization.py:
quantize_int8, dequantize_int8, stochastic_round, wire_bytes_per_element,
and the per-row form qgZ uses) against the JAX package on the CPU.

The port's plain versions, which its CUDA kernels are held to bit for bit
on the card (tests/test_torch_cuda.py, chip_smoke.py), must give the
codes and scales of the JAX Pallas kernel (interpret mode, use_pallas=True)
and of the JAX plain path (compiled, as the JAX step runs it) bit for
bit, on inputs made with numpy from a
seed: sizes that are and are not multiples of 512, an all-zero block
(scale 1e-12), values exactly at x.5 of the grid (round half to even), fp32
and bf16 inputs. Dequantized values are products of the same codes and
scales, so they are equal too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import quantization as JQ
from deepspeed_tpu.runtime.comm import coalesced_collectives as JC
from deepspeed_tpu_torch.ops import quantization as TQ

SIZES = [1, 100, 512, 513, 1024, 3 * 512 + 511, 4096 + 37]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n: int, seed: int = 0) -> np.ndarray:
    """n fp32 values with an all-zero first block (when n > 1024) and a
    spread of magnitudes across blocks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x *= np.repeat(10.0 ** rng.uniform(-3, 2, -(-n // 512)), 512)[:n]
    if n > 1024:
        x[:512] = 0.0
    return x


def _half_grid() -> np.ndarray:
    """One block whose amax is 127 (scale exactly 1.0) and whose other
    values sit at x.5: nearest rounding must go to the even neighbour."""
    vals = np.arange(-63, 63, dtype=np.float32) + 0.5
    x = np.zeros(512, np.float32)
    x[0] = 127.0
    x[1:1 + vals.size] = vals
    x[200:205] = [126.5, -126.5, 0.5, -0.5, 1.5]
    return x


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    jx = jnp.asarray(x).astype(jd)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    return jx, tx


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_quantize(jx, use_pallas: bool):
    """The JAX quantizer as the JAX step runs it: compiled. XLA turns the
    kernel's ``amax / 127.0`` into a product with the fp32 reciprocal of
    127 in interpret mode and under jit alike (op-by-op dispatch divides,
    and its scales can differ from both in the last bit)."""
    fn = jax.jit(lambda v: JQ.quantize_int8(v, use_pallas=use_pallas)[:2])
    return fn(jx)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", SIZES + ["half_grid"])
def test_quantize_int8_matches_pallas_kernel_bit_for_bit(n, dtype):
    x = _half_grid() if n == "half_grid" else _inputs(n, seed=len(str(n)))
    jx, tx = _pair(x, dtype)
    q, s, meta = TQ.quantize_int8(tx)
    jmeta = (jx.shape, jx.dtype, jx.size)
    for use_pallas in (True, False):       # interpret mode, plain jnp
        jq, js = _jax_quantize(jx, use_pallas)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        jback = JQ.dequantize_int8(jq, js, jmeta, use_pallas=use_pallas)
        back = TQ.dequantize_int8(q, s, meta)
        assert back.dtype == tx.dtype and back.shape == tx.shape
        np.testing.assert_array_equal(
            _np(back), np.asarray(jback.astype(jnp.float32)))
    if n == "half_grid":
        assert float(s[0, 0]) == 1.0
        assert q[0, 200:205].tolist() == [126, -126, 0, 0, 2]
    if isinstance(n, int) and n > 1024:
        assert float(s[0, 0]) == np.float32(1e-12) and not q[0].any()


def test_quantize_rows_match_jax_quant_rows():
    """qgZ quantizes each rank's chunk on its own (rows padded apart):
    the port's one call over [world, c] gives the codes and scales of
    the JAX ``_quant_rows`` (vmap of quantize_int8, compiled)."""
    x = _inputs(3 * 1000, seed=4).reshape(3, 1000)
    jq, js = jax.jit(lambda r: JC._quant_rows(r, "int8", "nearest", None))(
        jnp.asarray(x))
    q, s = TQ.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).reshape(-1, 512))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(-1, 1))
    back = TQ.dequantize_rows(q, s, 3, 1000)
    want = (np.asarray(jq).astype(np.float32) * np.asarray(js)).reshape(
        3, -1)[:, :1000]
    np.testing.assert_array_equal(back.numpy(), want)


def test_stochastic_round_matches_jax_on_the_same_uniforms():
    """The port's stochastic_round fed the uniforms jax.random.uniform
    draws for a key gives JAX's stochastic_round(y, key) bit for bit."""
    key = jax.random.PRNGKey(7)
    y = np.random.default_rng(1).standard_normal((4, 512)).astype(
        np.float32) * 40
    u = np.array(jax.random.uniform(key, y.shape, jnp.float32))
    got = TQ.stochastic_round(torch.from_numpy(y), u=torch.from_numpy(u))
    want = np.asarray(JQ.stochastic_round(jnp.asarray(y), key))
    np.testing.assert_array_equal(got.numpy(), want)


def test_stochastic_rounding_is_unbiased():
    """floor(y + u) averages to y: over 20000 draws the mean error of each
    value is within 0.02 (the standard error is <= 0.5 / sqrt(20000),
    0.0035), while nearest rounding is off by up to 0.5."""
    y = torch.tensor([0.1, 0.5, 0.9, -0.3, 2.25, -7.75])
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([TQ.stochastic_round(y, gen) for _ in range(20000)])
    assert (draws.mean(0) - y).abs().max() < 0.02
    assert ((draws - torch.floor(y)) >= 0).all() and (draws - y < 1).all()
    q, s, _ = TQ.quantize_int8(torch.randn(1024), rounding="stochastic",
                               generator=torch.Generator().manual_seed(1))
    assert q.dtype == torch.int8 and s.shape == (2, 1)
    with pytest.raises(ValueError, match="Generator"):
        TQ.quantize_int8(torch.randn(8), rounding="stochastic")


@pytest.mark.parametrize("wire", ["fp32", "f32", "none", "bf16", "f16",
                                  "int8", "s8", "fp8", "f8"])
def test_wire_bytes_per_element_match_jax(wire):
    assert TQ.wire_bytes_per_element(wire) == JQ.wire_bytes_per_element(wire)
    assert TQ.wire_bytes_per_element(wire, 256) == \
        JQ.wire_bytes_per_element(wire, 256)


def test_kernel_wrappers_refuse_cpu_tensors():
    """use_kernel=True asks for the CUDA kernel: on a CPU tensor the
    wrappers raise instead of running the plain version."""
    with pytest.raises(ValueError, match="unsupported device"):
        TQ.quantize_int8(torch.randn(600), use_kernel=True)
    q, s, meta = TQ.quantize_int8(torch.randn(600))
    with pytest.raises(ValueError, match="unsupported device"):
        TQ.dequantize_int8(q, s, meta, use_kernel=True)
