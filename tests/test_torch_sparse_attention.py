"""The port's block-sparse attention (deepspeed_tpu_torch/ops/sparse_attention:
sparsity configs, block lists, the kernels' plain versions and their
autograd function, SparseSelfAttention) against the JAX package on the
CPU, on the same numpy inputs. The JAX block-sparse Pallas kernels run in
interpret mode, as the JAX package's own tests run them; shapes stay at
S <= 256 to keep that fast. Tolerances are those of
tests/test_sparse_attention.py:102-142 (forward 2e-5, grads 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention import kernels as jk
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.sparse_attention import kernels as tk

CONFIGS = {
    "dense": ("DenseSparsityConfig", {}),
    "fixed": ("FixedSparsityConfig", {
        "num_local_blocks": 2, "num_global_blocks": 1,
        "different_layout_per_head": True,
        "num_different_global_patterns": 2}),
    "fixed_uni": ("FixedSparsityConfig", {
        "num_local_blocks": 3, "attention": "unidirectional"}),
    "fixed_horizontal": ("FixedSparsityConfig", {
        "num_local_blocks": 4, "horizontal_global_attention": True}),
    "variable": ("VariableSparsityConfig", {
        "num_random_blocks": 2, "local_window_blocks": [1, 2, 3],
        "global_block_indices": [0, 5], "global_block_end_indices": [2, 7],
        "different_layout_per_head": True, "seed": 7}),
    "variable_uni": ("VariableSparsityConfig", {
        "num_random_blocks": 1, "attention": "unidirectional",
        "horizontal_global_attention": False, "seed": 3}),
    "bigbird": ("BigBirdSparsityConfig", {
        "num_random_blocks": 2, "different_layout_per_head": True,
        "seed": 11}),
    "bigbird_uni": ("BigBirdSparsityConfig", {
        "attention": "unidirectional"}),
    "longformer": ("BSLongformerSparsityConfig", {
        "global_block_indices": [1, 6], "global_block_end_indices": [3, 7]}),
    "sliding": ("LocalSlidingWindowSparsityConfig", {
        "num_sliding_window_blocks": 5}),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layouts_equal_jax(name):
    """All six configs, bidirectional and unidirectional, random blocks
    drawn from the same seeded numpy generator: identical layouts."""
    cls, kw = CONFIGS[name]
    for seq in (128, 256):
        ours = getattr(tsa, cls)(num_heads=4, block=16, **kw)
        ref = getattr(jsa, cls)(num_heads=4, block=16, **kw)
        got, want = ours.make_layout(seq), ref.make_layout(seq)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="multiple of block"):
        getattr(tsa, cls)(num_heads=4, block=16, **kw).make_layout(40)


def test_block_lists_and_stats_equal_jax():
    layout = tsa.BigBirdSparsityConfig(num_heads=4, block=16,
                                       different_layout_per_head=True
                                       ).make_layout(256)
    for ours, ref in ((tk.build_block_maps, jk.build_block_maps),
                      (tk.build_block_maps_T, jk.build_block_maps_T)):
        for got, want in zip(ours(layout), ref(layout)):
            np.testing.assert_array_equal(got, want)
    assert tk.sparsity_stats(layout) == jk.sparsity_stats(layout)
    for seq, d in ((256, 32), (256, 12), (264, 32), (128, 64)):
        lay = layout if seq == 256 else np.ones((4, 16, 16), bool)
        assert tk.supports_kernel(lay, seq, d) == jk.supports_kernel(lay, seq,
                                                                     d)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax_attn(layout, q, k, v, do):
    """JAX block_sparse_attention (Pallas, interpret mode): o and the
    grads of sum(o * do)."""
    def f(q, k, v):
        return jk.block_sparse_attention(q, k, v, layout)

    o, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in (o, *vjp(jnp.asarray(do)))]


LAYOUTS = {
    "fixed": lambda: tsa.FixedSparsityConfig(num_heads=4, block=16),
    "bigbird": lambda: tsa.BigBirdSparsityConfig(num_heads=4, block=16),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plain_matches_jax_block_sparse_kernel(name):
    """B 2, H 4, S 256, D 32, fp32, on Fixed and BigBird layouts:
    block_sparse_attention_plain (autograd through the plain forward), the
    plain backward and the port's autograd function (CPU: plain versions)
    against the JAX kernel, forward 2e-5, grads 2e-4."""
    layout = LAYOUTS[name]().make_layout(256)
    q, k, v, do = _qkv((2, 4, 256, 32))
    want = _jax_attn(layout, q, k, v, do)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tk.block_sparse_attention_plain(*leaves, layout)
    o.backward(torch.from_numpy(do))
    got = [o.detach()] + [t.grad for t in leaves]
    attn = tk.make_block_sparse_attention(layout, 32)
    leaves2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o2 = attn(*leaves2)
    o2.backward(torch.from_numpy(do))
    got2 = [o2.detach()] + [t.grad for t in leaves2]
    for g, g2, w, tol in zip(got, got2, want, (2e-5, 2e-4, 2e-4, 2e-4)):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=tol)
        np.testing.assert_allclose(g2.numpy(), w, atol=tol, rtol=tol)


def test_plain_forward_and_backward_agree_with_autograd_and_lse():
    """The explicit plain backward equals autograd through the plain
    forward (fp32, 1e-5); lse is the log-sum-exp of the live scores."""
    layout = tsa.FixedSparsityConfig(num_heads=2, block=16).make_layout(128)
    q, k, v, do = (torch.from_numpy(x) for x in _qkv((2, 2, 128, 16), 4))
    maps = tk.block_maps(layout, "cpu", 16)
    o, lse = tk.block_sparse_attention_fwd_plain(q, k, v, maps)
    grads = tk.block_sparse_attention_bwd_plain(q, k, v, o, lse, do, maps)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tk.block_sparse_attention_fwd_plain(*leaves, maps)[0].backward(do)
    for g, leaf in zip(grads, leaves):
        torch.testing.assert_close(g, leaf.grad, atol=1e-5, rtol=1e-5)
    bias = tsa.layout_to_bias(layout, 16)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / 4.0 + bias[None]
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5,
                               rtol=1e-5)


def test_dead_row_returns_zero_as_in_jax():
    """A layout whose q block 1 has no live block: the JAX kernel and the
    port's plain version give o = 0 there and dq = 0 (kernels.py:21-26);
    the other rows agree at the forward and grad tolerances."""
    layout = np.eye(8, dtype=bool)[None].repeat(2, 0)
    layout[:, 1, :] = False
    layout[:, 3, 0] = True
    q, k, v, do = _qkv((1, 2, 128, 16), 2)
    want = _jax_attn(layout, q, k, v, do)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tk.make_block_sparse_attention(layout, 16)(*leaves)
    o.backward(torch.from_numpy(do))
    assert torch.all(o[:, :, 16:32] == 0)
    assert torch.all(leaves[0].grad[:, :, 16:32] == 0)
    assert np.all(want[0][:, :, 16:32] == 0)
    for g, w, tol in zip([o.detach()] + [t.grad for t in leaves], want,
                         (2e-5, 2e-4, 2e-4, 2e-4)):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=tol)


def test_sparse_self_attention_dispatch_matches_dense_fallback_and_jax():
    """With no masks SparseSelfAttention runs the block-skipping path (on
    the CPU, the kernels' plain versions: no launch) and matches its own
    dense+mask fallback (forced by an all-ones attn_mask) at 2e-5, as
    tests/test_sparse_attention.py:145-160; both match the JAX module."""
    cfg = dict(num_heads=4, block=16)
    attn = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(**cfg))
    jattn = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**cfg))
    q, k, v, _ = _qkv((2, 4, 128, 32), 1)
    tq, tk_, tv = map(torch.from_numpy, (q, k, v))
    launches = tk.block_sparse_attention_fwd.launches
    kernel_out = attn(tq, tk_, tv)
    assert tk.block_sparse_attention_fwd.launches == launches
    assert attn._kernel(128, 4, 32) is not None
    dense_out = attn(tq, tk_, tv, attn_mask=torch.ones(128, 128))
    np.testing.assert_allclose(kernel_out.numpy(), dense_out.numpy(),
                               atol=2e-5, rtol=2e-5)
    jq, jk_, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(kernel_out.numpy(),
                               np.asarray(jattn(jq, jk_, jv)),
                               atol=2e-5, rtol=2e-5)
    mask = np.ones((2, 128), np.float32)
    mask[:, -5:] = 0
    got = attn(tq, tk_, tv, key_padding_mask=torch.from_numpy(mask - 1) * 1e4)
    want = jattn(jq, jk_, jv, key_padding_mask=jnp.asarray(mask - 1) * 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_unsupported_layout_takes_the_dense_path_and_utils():
    """A head_dim that is no multiple of 8 leaves the kernel path (as in
    JAX), so the dense form runs; the pad/unpad helpers round-trip."""
    attn = tsa.SparseSelfAttention(tsa.DenseSparsityConfig(num_heads=2,
                                                           block=8))
    q, k, v, _ = _qkv((1, 2, 32, 12), 5)
    out = attn(*map(torch.from_numpy, (q, k, v)))
    assert attn._kernel(32, 2, 12) is None
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(12)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-4)
    tokens = torch.ones((2, 13), dtype=torch.int64)
    padded, pad = tsa.SparseAttentionUtils.pad_to_block_size(8, tokens)
    assert padded.shape == (2, 16) and pad == 3
    assert int(padded[0, -1]) == 0
    out = tsa.SparseAttentionUtils.unpad_sequence_output(
        pad, torch.ones((2, 16, 4)))
    assert out.shape == (2, 13, 4)
