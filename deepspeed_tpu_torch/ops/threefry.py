"""Threefry-2x32 keys and random bits in PyTorch, bit for bit as JAX makes
them (jax 0.9 with ``jax_threefry_partitionable``, the setting the JAX
package's tests run under).

A key is an int64 tensor ``[..., 2]`` holding two uint32 words. Every
uint32 value lives in an int64 lane and is masked with ``0xFFFFFFFF``
after each add and shift, so the same code runs on CPU and CUDA tensors
and, on the card, inside a CUDA graph: the bits depend only on the key and
the counter, never on a generator's state.

The pieces and their JAX counterparts (``jax/_src/prng.py``,
``jax/_src/random.py``):

* :func:`threefry2x32` — ``threefry_2x32``'s hash, 20 rounds;
* :func:`prng_key` — ``PRNGKey(seed)`` (``threefry_seed``, 64-bit types
  off);
* :func:`fold_in` — ``_threefry_fold_in``;
* :func:`split` — ``_threefry_split_foldlike``;
* :func:`random_bits` — ``_threefry_random_bits_partitionable`` at 32
  bits: the counters are the flat index as (hi, lo), the bits
  ``bits1 ^ bits2``;
* :func:`uniform` — ``_uniform`` in float32;
* :func:`gumbel` — ``_gumbel`` in mode "low";
* :func:`categorical` — ``categorical`` (argmax of gumbel + logits).
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32 smallest normal: gumbel's uniform floor (finfo(float32).tiny)
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of the counter pair (x0, x1) under the key
    (k0, k1); all four broadcastable int64 tensors of uint32 values.
    Returns the pair of hashed words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as the JAX package makes it, with 64-bit
    types off: the seed taken as a 32-bit integer, so the key is ``[0,
    seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def from_jax(key) -> torch.Tensor:
    """A JAX raw key (uint32 ``[2]`` or a stack ``[..., 2]``, as numpy or
    anything ``np.asarray`` takes) in the port's form."""
    arr = np.asarray(key)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"a JAX threefry key is uint32 [..., 2], got "
                         f"{arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.astype(np.int64))


def to_numpy(key: torch.Tensor) -> np.ndarray:
    """The port's key as JAX's raw uint32 key data."""
    return key.cpu().numpy().astype(np.uint32)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` with data (ints or an
    integer tensor, taken as uint32) broadcast against ``key[..., 0]``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (``_threefry_split_foldlike``): ``num`` keys
    ``[..., num, 2]``, key i the hash of the counter pair (0, i)."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          idx >> 32, idx & MASK)
    return torch.stack([y0, y1], -1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words of shape ``key.shape[:-1] + (n,)``: each key's
    ``jax.random.bits(key, (n,), uint32)``, as int64."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          idx >> 32, idx & MASK)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval) ``[..., n]``, JAX's bits and
    arithmetic: 23 random mantissa bits under exponent 0, minus 1, scaled,
    shifted and floored at ``minval``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo          # rounded to float32 as in JAX
    return torch.clamp_min(floats * float(span) + float(lo), float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """float32 standard Gumbel noise ``[..., n]`` (JAX's mode "low":
    ``-log(-log(u))`` with u uniform in [tiny, 1))."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw a row of ``logits [..., V]`` (float32), with one key a
    row (``key [..., 2]``): argmax of gumbel noise plus the logits, the
    first index on a tie, as ``jax.random.categorical``."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
