"""The port's threefry PRNG and in-graph sampling (deepspeed_tpu_torch/ops/
threefry.py, sampling.py) against JAX's (jax.random under
``jax_threefry_partitionable``, tests/conftest.py, and
deepspeed_tpu/ops/sampling.py) on the CPU.

What is held, and how closely:
- keys, ``fold_in``, ``position_keys``, the random bits and the uniform
  floats: bit for bit (integer arithmetic, then exact float steps);
- gumbel noise, ``-log(-log(u))``: within 4 ulps of max(|g|, 1) (each log
  is within an ulp of the true value on both sides, and the inner log's
  error becomes an absolute one; measured at most 2);
- the logit filters: bit for bit, eager against the port's division and
  jitted against its reciprocal product (XLA compiles the division by
  the constant temperature as a product with its float32 reciprocal).
  Top-p sorts and sums a float32 softmax, and XLA's and PyTorch's softmax
  and cumsum differ by a few ulps (up to ~4e-7 near 1): so the inputs are
  checked to keep every row's top-p boundary more than 1e-5 from the
  threshold, where those ulps cannot move it;
- sampled tokens: equal, on inputs checked to have a top-2 margin of
  noise + logits above 1e-4 in every row (gumbel's ulps cannot flip it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sampling as jsampling
from deepspeed_tpu_torch.ops import sampling, threefry

SEEDS = [0, 1, 7, 13, 2**31 - 1, 2**31, 2**32 + 3, -1, 12345678901]


def _t(x):
    return torch.from_numpy(np.array(x))


def _logits(seed, shape=(16, 512), scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _row_keys(seed, n):
    base = jax.random.PRNGKey(seed)
    return jax.vmap(lambda u: jax.random.fold_in(base, u))(
        jnp.arange(n, dtype=jnp.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(threefry.to_numpy(threefry.prng_key(seed)),
                                  want)
    np.testing.assert_array_equal(threefry.to_numpy(threefry.from_jax(want)),
                                  want)


def test_threefry_hash_matches_jax():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, (2,), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (2, 4096), dtype=np.uint64).astype(np.uint32)
    from jax._src import prng as jprng
    want = np.asarray(jprng.threefry_2x32(jnp.asarray(k),
                                          jnp.asarray(x.reshape(-1))))
    tk = threefry.from_jax(k)
    y0, y1 = threefry.threefry2x32(tk[0], tk[1], _t(x[0].astype(np.int64)),
                                   _t(x[1].astype(np.int64)))
    got = np.concatenate([y0.numpy(), y1.numpy()]).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_fold_in_and_position_keys_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    data = np.array([0, 1, 2, 5, 77, 2**16, 2**30 + 3, 2**31 + 9,
                     2**32 - 1], np.uint32)
    want = np.stack([np.asarray(jax.random.fold_in(key, int(d)))
                     for d in data])
    got = threefry.fold_in(threefry.from_jax(np.asarray(key)),
                           _t(data.astype(np.int64)))
    np.testing.assert_array_equal(threefry.to_numpy(got), want)
    # per-row keys (uid folded in) and the single-key broadcast form
    rows = _row_keys(seed, 8)
    pos = np.random.default_rng(seed % 2**32).integers(0, 4096, 8)
    for base, tbase in ((rows, threefry.from_jax(np.asarray(rows))),
                        (key, threefry.from_jax(np.asarray(key)))):
        want = np.asarray(jsampling.position_keys(base, jnp.asarray(pos)))
        got = sampling.position_keys(tbase, _t(pos))
        np.testing.assert_array_equal(threefry.to_numpy(got), want)


@pytest.mark.parametrize("seed", [3, 13, 99])
def test_random_bits_and_uniform_match_jax_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    tk = threefry.prng_key(seed)
    n = 5000
    np.testing.assert_array_equal(
        threefry.to_numpy(threefry.random_bits(tk, n)),
        np.asarray(jax.random.bits(key, (n,), jnp.uint32)))
    u = np.asarray(jax.random.uniform(key, (n,)))
    np.testing.assert_array_equal(threefry.uniform(tk, n).numpy().view(
        np.int32), u.view(np.int32))
    # per-row keys, as the categorical draw takes them
    rows = _row_keys(seed, 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(
        k, (n,), jnp.uint32))(rows))
    got = threefry.random_bits(threefry.from_jax(np.asarray(rows)), n)
    np.testing.assert_array_equal(threefry.to_numpy(got), want)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_gumbel_within_four_ulps_of_jax(seed):
    key = jax.random.PRNGKey(seed)
    n = 100_000
    want = np.asarray(jax.jit(lambda k: jax.random.gumbel(k, (n,)))(key))
    got = threefry.gumbel(threefry.prng_key(seed), n).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    err = np.abs(got.astype(np.float64) - want) / ulp
    assert err.max() <= 4, err.max()


FILTERS = {
    "temperature": dict(temperature=0.9),
    "top_k": dict(temperature=0.9, top_k=50),
    "top_p": dict(temperature=0.9, top_p=0.9),
    "top_k_top_p": dict(temperature=0.9, top_k=50, top_p=0.9),
    "top_p_t1": dict(temperature=1.0, top_p=0.5),
    "top_p_cold": dict(temperature=0.3, top_p=0.95),
}


def _top_p_margin(x, kw):
    """Distance of every row's top-p boundary from the threshold, in the
    JAX filter's own float32 arithmetic before its top-p step."""
    if not 0.0 < kw.get("top_p", 0.0) < 1.0:
        return np.inf
    pre = np.asarray(jsampling.apply_logit_filters(
        jnp.asarray(x), temperature=kw["temperature"],
        top_k=kw.get("top_k", 0)))
    srt = -np.sort(-pre.astype(np.float64), axis=-1)
    p = np.exp(srt - srt[:, :1])
    p /= p.sum(-1, keepdims=True)
    excl = np.cumsum(p, -1) - p
    return np.abs(excl - kw["top_p"]).min()


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("jit", [False, True])
def test_logit_filters_match_jax(name, jit):
    kw = FILTERS[name]
    for seed in range(4):
        x = _logits(seed, scale=1.0 + seed)
        assert _top_p_margin(x, kw) > 1e-5
        f = lambda a: jsampling.apply_logit_filters(a, **kw)  # noqa: E731
        want = np.asarray(jax.jit(f)(x) if jit else f(jnp.asarray(x)))
        got = sampling.apply_logit_filters(_t(x), reciprocal=jit,
                                           **kw).numpy()
        np.testing.assert_array_equal(got, want)


def test_reciprocal_rounding_is_the_compiled_jax_rounding():
    """The flag matters: the two roundings differ on these inputs, and
    each side matches its JAX counterpart (eager divides, jit does not)."""
    x = _logits(11)
    eager = sampling.apply_logit_filters(_t(x), temperature=0.9).numpy()
    comp = sampling.apply_logit_filters(_t(x), temperature=0.9,
                                        reciprocal=True).numpy()
    assert (eager != comp).mean() > 0.05
    np.testing.assert_array_equal(
        np.asarray(jsampling.apply_logit_filters(jnp.asarray(x),
                                                 temperature=0.9)), eager)


def _margin(x, keys_np, kw):
    """Every row's top-2 gap of gumbel + filtered logits (JAX's)."""
    filt = np.asarray(jax.jit(lambda a: jsampling.apply_logit_filters(
        a, **kw))(x))
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (x.shape[-1],)))(jnp.asarray(keys_np)))
    top2 = np.sort(g + filt, -1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]).min()


@pytest.mark.parametrize("name", ["temperature", "top_k", "top_k_top_p",
                                  "top_p"])
def test_sample_tokens_batched_and_grid_match_jax(name):
    kw = FILTERS[name]
    for seed in range(3):
        x = _logits(100 + seed)
        rows = _row_keys(seed, 16)
        pos = np.random.default_rng(seed).integers(0, 1000, 16)
        keys = jsampling.position_keys(rows, jnp.asarray(pos))
        assert _margin(x, np.asarray(keys), kw) > 1e-4
        want = np.asarray(jax.jit(lambda a, k: jsampling.sample_tokens_batched(
            a, k, **kw))(x, keys))
        tkeys = threefry.from_jax(np.asarray(keys))
        got = sampling.sample_tokens_batched(_t(x), tkeys, reciprocal=True,
                                             **kw).numpy()
        np.testing.assert_array_equal(got, want)
        # the grid form: [4, 4, V] with one key a slot
        grid = np.asarray(jsampling.sample_token_grid(
            jnp.asarray(x.reshape(4, 4, -1)),
            jnp.asarray(keys).reshape(4, 4, 2), **kw))
        got = sampling.sample_token_grid(_t(x.reshape(4, 4, -1)),
                                         tkeys.reshape(4, 4, 2), **kw)
        np.testing.assert_array_equal(got.numpy(), grid)


@pytest.mark.parametrize("name", ["temperature", "top_k", "top_k_top_p"])
def test_sample_tokens_one_key_matches_jax(name):
    kw = FILTERS[name]
    for seed in range(3):
        x = _logits(200 + seed)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsampling.sample_tokens(jnp.asarray(x), key, **kw))
        got = sampling.sample_tokens(_t(x), threefry.prng_key(seed), **kw)
        np.testing.assert_array_equal(got.numpy(), want)


# the JAX package's own sampling cases (tests/test_inference_v2.py:235-268)
def test_sampling_op_greedy_and_filters():
    logits = torch.tensor([[0.1, 2.0, -1.0, 0.5], [3.0, -2.0, 0.0, 1.0]])
    key = threefry.prng_key(0)
    # key=None, greedy=True and the temperature<=0 sentinel all argmax
    assert sampling.sample_tokens(logits).tolist() == [1, 0]
    assert sampling.sample_tokens(logits, key, greedy=True).tolist() == [1, 0]
    assert sampling.sample_tokens(logits, key,
                                  temperature=0.0).tolist() == [1, 0]
    # top_k=1 pins the categorical to the argmax at any temperature
    assert sampling.sample_tokens(logits, key, temperature=5.0,
                                  top_k=1).tolist() == [1, 0]
    # tiny top_p keeps only the head of the distribution
    assert sampling.sample_tokens(logits, key, temperature=1.0,
                                  top_p=1e-6).tolist() == [1, 0]


def test_sampling_position_keys():
    base = threefry.prng_key(7)
    rows = threefry.fold_in(base, torch.arange(3))
    a = sampling.position_keys(rows, torch.tensor([5, 9, 2]))
    b = sampling.position_keys(rows, torch.tensor([5, 9, 2]))
    assert torch.equal(a, b)
    # same position, different rows -> different keys (uid fold-in)
    same = sampling.position_keys(rows, torch.tensor([4, 4, 4]))
    assert not torch.equal(same[0], same[1])
    # single-key broadcast form: equal positions share randomness
    c = sampling.position_keys(base, torch.tensor([5, 5]))
    assert torch.equal(c[0], c[1])


def test_from_jax_refuses_other_arrays():
    with pytest.raises(ValueError, match="uint32"):
        threefry.from_jax(np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="uint32"):
        threefry.from_jax(np.zeros(3, np.uint32))
