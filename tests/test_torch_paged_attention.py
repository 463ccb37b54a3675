"""The port's paged attention (deepspeed_tpu_torch/inference/v2/paged.py)
against the JAX package's: the plain version of the Hopper kernel against
the Pallas ``paged_attention_kernel`` (run in interpret mode off-TPU, as
the JAX tests run it), and the plain reference path piece by piece. Same
inputs, made with numpy from a seed, go to both; fp32 at the JAX test's
own tolerance (tests/test_inference_v2.py:394)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import paged as jpaged
from deepspeed_tpu.ops.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu_torch.inference.v2 import paged as tpaged

B, HQ, HKV, D, NB, BS, MAXB = 3, 4, 2, 32, 16, 8, 5
POS0 = [13, 0, 24]
TOL = dict(atol=2e-5, rtol=2e-5)
VARIANTS = {"causal": {}, "window": {"window": 11}, "alibi": {"alibi": True}}


def _inputs(sq, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tables = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    tables[1, -1] = NB            # a padded slot past the pool: clamped
    true_len = ([sq, 0, sq] if sq == 1 else [sq, sq - 3, sq])
    return dict(q=f(B, sq, HQ, D), k_new=f(B, sq, HKV, D),
                v_new=f(B, sq, HKV, D), k_pool=f(NB, BS, HKV, D),
                v_pool=f(NB, BS, HKV, D), block_tables=tables,
                pos0=np.asarray(POS0, np.int32),
                true_len=np.asarray(true_len, np.int32))


def _kwargs(variant):
    kw = {}
    if "window" in VARIANTS[variant]:
        kw["window"] = VARIANTS[variant]["window"]
    if VARIANTS[variant].get("alibi"):
        kw["alibi_slopes"] = np.array(jax_alibi_slopes(HQ))
    return kw


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("sq", [1, 8])
def test_plain_kernel_matches_pallas_kernel(sq, variant):
    x = _inputs(sq)
    kw = _kwargs(variant)
    ref = np.asarray(jpaged.paged_attention_kernel(
        *(jnp.asarray(v) for v in x.values()), **kw))
    tkw = dict(kw)
    if "alibi_slopes" in tkw:
        tkw["alibi_slopes"] = torch.from_numpy(tkw["alibi_slopes"])
    got = tpaged.paged_attention_kernel(
        *(torch.from_numpy(v) for v in x.values()), **tkw).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    for b in range(B):
        tl = int(x["true_len"][b])
        np.testing.assert_allclose(got[b, :tl], ref[b, :tl], **TOL)
        # rows past true_len are never read; the port writes zeros there
        assert not got[b, tl:].any()


def test_gather_and_place_match_jax():
    x = _inputs(8)
    jp = jpaged.place_in_pages(
        jpaged.gather_pages(jnp.asarray(x["k_pool"]),
                            jnp.asarray(x["block_tables"])),
        jnp.asarray(x["k_new"]), jnp.asarray(x["pos0"]),
        jnp.asarray(x["true_len"]))
    tp = tpaged.place_in_pages(
        tpaged.gather_pages(torch.from_numpy(x["k_pool"]),
                            torch.from_numpy(x["block_tables"])),
        torch.from_numpy(x["k_new"]), torch.from_numpy(x["pos0"]),
        torch.from_numpy(x["true_len"]))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reference_paged_attention_matches_jax(variant):
    x = _inputs(8, seed=1)
    kw = _kwargs(variant)
    pages = {}
    for name in ("k", "v"):
        pages[name] = tpaged.place_in_pages(
            tpaged.gather_pages(torch.from_numpy(x[f"{name}_pool"]),
                                torch.from_numpy(x["block_tables"])),
            torch.from_numpy(x[f"{name}_new"]), torch.from_numpy(x["pos0"]),
            torch.from_numpy(x["true_len"]))
    ref = np.asarray(jpaged.paged_attention(
        jnp.asarray(x["q"]), jnp.asarray(pages["k"].numpy()),
        jnp.asarray(pages["v"].numpy()), jnp.asarray(x["pos0"]),
        window=kw.get("window"),
        alibi_slopes=(jnp.asarray(kw["alibi_slopes"])
                      if "alibi_slopes" in kw else None)))
    got = tpaged.paged_attention(
        torch.from_numpy(x["q"]), pages["k"], pages["v"],
        torch.from_numpy(x["pos0"]), window=kw.get("window"),
        alibi_slopes=(torch.from_numpy(kw["alibi_slopes"])
                      if "alibi_slopes" in kw else None)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_plain_kernel_matches_reference_path():
    """The two plain paths of the port agree with each other on the
    rows the engine reads."""
    x = {k: torch.from_numpy(v) for k, v in _inputs(8, seed=2).items()}
    got = tpaged.paged_attention_kernel(*x.values())
    k_pages = tpaged.place_in_pages(
        tpaged.gather_pages(x["k_pool"], x["block_tables"]), x["k_new"],
        x["pos0"], x["true_len"])
    v_pages = tpaged.place_in_pages(
        tpaged.gather_pages(x["v_pool"], x["block_tables"]), x["v_new"],
        x["pos0"], x["true_len"])
    ref = tpaged.paged_attention(x["q"], k_pages, v_pages, x["pos0"])
    for b in range(B):
        tl = int(x["true_len"][b])
        np.testing.assert_allclose(got[b, :tl].numpy(), ref[b, :tl].numpy(),
                                   **TOL)


def test_kernel_wrapper_refuses_quantized_pools():
    x = {k: torch.from_numpy(v) for k, v in _inputs(1).items()}
    scale = torch.ones(NB, BS, HKV)
    with pytest.raises(NotImplementedError, match="quantized KV"):
        tpaged.paged_attention_kernel(*x.values(), k_scale=scale,
                                      v_scale=scale)

