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


# ------------------------------------- the CUDA quantize kernel's schedule
# csrc/quantize_int8.cu emulated in numpy: which blocks each CTA of the
# "bulk" variant owns, chunk by chunk, and the arithmetic of every lane
# (amax over its 16 contiguous elements, a NaN-propagating max across the
# warp, the scale; then y = x times the correctly rounded reciprocal of
# the scale, or the IEEE quotient for all 16 where any y lies within
# 2^-14 of a half-integer; y + 1.5 * 2^23, whose low byte is the code; a
# NaN or inf scale gives code 0); the "ragged" variant walks the same
# blocks a warp at a time with each row zero-padded. numpy's fp32 ops
# round to nearest even and keep subnormals, as the kernel's (built
# without fast math).
SMS = 132                      # an H100's SMs: the bulk grid's cap / 2
CHUNK_BYTES, NEAR_HALF = 16384, np.float32(0.5) - np.float32(2.0 ** -14)
ROUND = np.float32(1.5 * 2.0 ** 23)


def _emulate_codes(x: np.ndarray, scale: np.float32) -> np.ndarray:
    """codes16 over 16-value lanes (x: a multiple of 16 fp32 values):
    int8 codes."""
    if not np.isfinite(scale):
        return np.zeros(x.shape, np.int8)
    lanes = x.reshape(-1, 16)
    r = np.float32(1) / scale                      # __frcp_rn
    y = lanes * r
    f = y + ROUND
    near = np.abs(y - (f - ROUND)).max(1) > NEAR_HALF
    f[near] = lanes[near] / scale + ROUND          # the IEEE quotient
    code = (f - ROUND).reshape(x.shape)
    assert np.abs(code).max(initial=0) <= 127      # the clip never acts
    return (f.reshape(x.shape).view(np.uint32) & 0xFF).astype(
        np.uint8).view(np.int8)


def _emulate_block(x: np.ndarray):
    """One block (512 fp32 values) the way a warp takes it: lane l owns
    elements [16 l, 16 l + 16), the lanes' maxima meet in a butterfly."""
    lanes = np.abs(x.reshape(32, 16))
    amax = np.where(np.isnan(lanes).any(1), np.float32(np.nan),
                    lanes.max(1))
    for s in (16, 8, 4, 2, 1):                     # shuffle xor s
        other = amax[np.arange(32) ^ s]
        amax = np.where(np.isnan(amax) | np.isnan(other), np.float32(np.nan),
                        np.maximum(amax, other))
    assert (np.isnan(amax).all() or (amax == amax[0]).all())
    scale = np.float32(amax[0]) * np.float32(TQ.INV_QMAX)
    scale = np.float32(1e-12) if scale < np.float32(1e-12) else scale
    return _emulate_codes(x, scale), scale


def _emulate_quantize(rows: np.ndarray, variant: str):
    """[R, L] fp32 values -> (codes [R * nb, 512], scales [R * nb, 1]) by
    the variant's schedule; every block is written exactly once."""
    r, length = rows.shape
    bpr = -(-length // 512)
    padded = np.zeros((r, bpr * 512), np.float32)
    padded[:, :length] = rows
    blocks = padded.reshape(-1, 512)
    n = blocks.shape[0]
    q = np.zeros((n, 512), np.int8)
    s = np.zeros((n, 1), np.float32)
    written = np.zeros(n, np.int64)
    if variant == "bulk":
        assert length % 512 == 0
        cb = CHUNK_BYTES // (512 * rows.dtype.itemsize)  # fp32 view: bf16 x2
        grid = min(-(-n // cb), 2 * SMS)
        for cta in range(grid):
            b0, b1 = n * cta // grid, n * (cta + 1) // grid
            assert b1 - b0 >= 1
            for first in range(b0, b1, cb):        # chunk by chunk
                for b in range(first, min(first + cb, b1)):
                    q[b], s[b, 0] = _emulate_block(blocks[b])
                    written[b] += 1
    else:
        for b in range(n):                         # a warp a block
            q[b], s[b, 0] = _emulate_block(blocks[b])
            written[b] += 1
    assert (written == 1).all()
    return q, s


def _adversarial_rows() -> np.ndarray:
    """Blocks built to break a quotient: values at x.5 of the grid (round
    half to even), amax at a block's first and last element, an all-zero
    block (scale 1e-12), NaN, +inf and -inf, subnormals, and values one
    and two ulps either side of (k + 0.5) * scale."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(12 * 512).astype(np.float32)
    x[:512] = _half_grid()
    x[512:1024] = 0.0
    x[1024 + 511] = 300.0                          # amax at the block end
    x[1536] = -700.0                               # amax at the block start
    x[2048 + 17] = np.nan
    x[2560 + 3] = np.inf
    x[3072 + 400] = -np.inf
    x[3584:4096] = rng.standard_normal(512) * np.float32(1e-42)
    for i, amax in enumerate((3.0, 1e-20, 2e30)):
        blk = slice((8 + i) * 512, (9 + i) * 512)
        scale = max(np.float32(amax) * np.float32(TQ.INV_QMAX),
                    np.float32(1e-12))
        h = (np.arange(-127, 127) + np.float32(0.5)).astype(np.float32)
        near = (h * scale).astype(np.float32)
        vals = np.concatenate([np.nextafter(near, np.float32(np.inf)),
                               np.nextafter(near, -np.float32(np.inf)),
                               near])[:511]
        x[blk] = np.concatenate([[np.float32(amax)], vals])
    x[11 * 512:] = rng.standard_normal(512) * 1e-13   # scale floored
    return x


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["adversarial", "random_3000_blocks",
                                  "qgz_rows_3x1000", "misaligned_start"])
def test_kernel_schedule_matches_pallas_kernel_bit_for_bit(case, dtype):
    """The emulated kernel (bulk or ragged, as quantize_plan picks from
    the shapes and alignment) against the Pallas kernel in interpret mode:
    codes and scales bit for bit, NaN scales where the block holds NaN,
    inf where it holds inf, and code 0 in such blocks."""
    if case == "adversarial":
        x, rows, aligned = _adversarial_rows(), 1, True
    elif case == "random_3000_blocks":
        x, rows, aligned = _inputs(3000 * 512, seed=5), 1, True
    elif case == "qgz_rows_3x1000":
        x, rows, aligned = _inputs(3 * 1000, seed=6), 3, True
    else:                        # a view one element into its storage
        x, rows, aligned = _inputs(2 * 512, seed=7), 1, False
    jx, tx = _pair(x, dtype)
    xs = np.asarray(jx.astype(jnp.float32)).reshape(rows, -1)
    variant = TQ.quantize_plan(xs.shape[1], aligned)
    assert variant == ("ragged" if case in ("qgz_rows_3x1000",
                                            "misaligned_start") else "bulk")
    q, s = _emulate_quantize(xs, variant)
    if rows == 1:
        jq, js = _jax_quantize(jx, True)
    else:
        jq, js = jax.jit(lambda r: JC._quant_rows(r, "int8", "nearest",
                                                  None))(jx.reshape(rows, -1))
    np.testing.assert_array_equal(q, np.asarray(jq).reshape(-1, 512))
    np.testing.assert_array_equal(s, np.asarray(js).reshape(-1, 1))
    # the port's plain version (the card's reference) agrees as well
    pq, ps = TQ.quantize_rows(tx.reshape(rows, -1), use_kernel=False)
    np.testing.assert_array_equal(pq.numpy(), q)
    np.testing.assert_array_equal(ps.numpy(), s)
    if case == "adversarial":
        assert np.isnan(s[4, 0]) and np.isinf(s[5, 0]) and np.isinf(s[6, 0])
        assert not q[4:7].any()
        assert s[1, 0] == np.float32(1e-12) and not q[1].any()


def test_reciprocal_codes_equal_the_division_codes_near_every_half():
    """The kernel's quotient (x times the correctly rounded reciprocal,
    the IEEE division within 2^-14 of a half-integer) gives rint(x /
    scale)'s code for every x that could tell them apart: the fp32 values
    within 8 ulps of (k + 0.5) * scale for every half-integer k + 0.5 in
    [-127.5, 127.5], over 4000 scales spanning the fp32 exponents a block
    can have (1e-12 to 1e36) plus random values, each at most 127.0001
    scales (a block's amax over its scale); elsewhere no half-integer lies
    within the product's 2.5 ulps of the quotient."""
    rng = np.random.default_rng(3)
    scales = (10.0 ** rng.uniform(-12, 36, 4000)).astype(np.float32)
    scales[:3] = [np.float32(1e-12), np.float32(1.0),
                  np.float32(127.0) * np.float32(TQ.INV_QMAX)]
    h = (np.arange(-128, 128) + np.float32(0.5)).astype(np.float32)
    for scale in np.array_split(scales, 8):
        base = (h[None, :] * scale[:, None]).astype(np.float32)
        xs = [base]
        up, down = base, base
        for _ in range(8):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, -np.float32(np.inf))
            xs += [up, down]
        xs.append((rng.uniform(-127.4, 127.4, base.shape)
                   * scale[:, None]).astype(np.float32))
        x = np.concatenate(xs, axis=1)
        sc = scale[:, None]
        with np.errstate(over="ignore", invalid="ignore"):
            want = np.clip(np.rint(x / sc), -127, 127).astype(np.int8)
        keep = np.abs(x / sc) <= 127.0001      # a block's reach (amax / scale)
        for row, s_, w, k in zip(x, scale, want, keep):
            xs = row[k][:len(row[k]) // 16 * 16]
            np.testing.assert_array_equal(_emulate_codes(xs, s_),
                                          w[k][:len(xs)])
