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


@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
def test_block_lists_equal_jax_on_random_layouts(density):
    """The vectorised lists (built from a layout's distinct rows) equal
    the JAX package's loop over every row, dead rows and 0/1 int layouts
    included."""
    rng = np.random.default_rng(int(density * 100))
    for shape in ((3, 9, 9), (2, 32, 32), (1, 1, 1)):
        layout = rng.random(shape) < density
        layout[:, :2] = layout[:, 2:4] if shape[1] > 4 else layout[:, :2]
        for lay in (layout, layout.astype(np.int64)):
            for ours, ref in ((tk.build_block_maps, jk.build_block_maps),
                              (tk.build_block_maps_T,
                               jk.build_block_maps_T)):
                for got, want in zip(ours(lay), ref(lay)):
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got, want)


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


# ------------------------------------------- the tensor-core kernels' schedule
PATH_P_LAYOUT = dict(block=16, different_layout_per_head=True,
                     num_local_blocks=4, num_global_blocks=1,
                     attention="bidirectional",
                     num_different_global_patterns=4)
TILE_CASES = {name: (cls, dict(kw, block=16), 1024)
              for name, (cls, kw) in CONFIGS.items()}
TILE_CASES.update({
    "path_p": ("FixedSparsityConfig", PATH_P_LAYOUT, 1024),
    "longformer_block8": ("BSLongformerSparsityConfig", {"block": 8}, 512),
    "fixed_block48_pad_rows": ("FixedSparsityConfig", {"block": 48}, 768),
    "bigbird_block128_split": ("BigBirdSparsityConfig",
                               {"block": 128, "num_random_blocks": 1}, 2048),
})


def _layout(cls, kw, seq, heads=4):
    return getattr(tsa, cls)(num_heads=heads, **kw).make_layout(seq)


def _check_groups(groups, layout, block):
    """Every row of every head in exactly one group slot; a group's rows
    come from at most 64 // block blocks (one 64-row tile of a block over
    64), all with the group's layout row; streams longest first."""
    h, nq, _ = layout.shape
    seen = np.zeros((h, nq * block), int)
    for head, rep, *rows in groups:
        rows = np.asarray(rows)
        rows = rows[rows >= 0]
        assert 0 < rows.size <= 64
        seen[head, rows] += 1
        blocks = np.unique(rows // block)
        assert blocks.size <= max(1, 64 // block)
        assert rep in blocks
        assert (layout[head, blocks] == layout[head, rep]).all()
        if block > 64:
            assert rows.max() - rows.min() < 64
    assert (seen == 1).all()
    lengths = layout.sum(-1)[groups[:, 0], groups[:, 1]]
    assert (np.diff(lengths) <= 0).all()


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_tile_groups_cover_each_block_once(name):
    """Forward (jmap) and dk/dv (imap) tile groups of the six configs,
    Path P's layout and blocks 8, 48 (pad rows) and 128 (split tiles):
    each row in one group, members sharing their list, at most 64 //
    block of them, longest stream first; the device copies equal the
    host's."""
    cls, kw, seq = TILE_CASES[name]
    layout = _layout(cls, kw, seq)
    block = kw["block"]
    maps = tk.block_maps(layout, "cpu", block)
    for groups, lay in ((maps.groups, layout),
                        (maps.groupsT, layout.transpose(0, 2, 1))):
        assert groups.dtype == torch.int32
        assert groups.shape[1] == tk.GROUP_COLS
        np.testing.assert_array_equal(groups.numpy(),
                                      tk.tile_groups(lay, block))
        _check_groups(groups.numpy(), lay, block)


def test_path_p_tile_groups_at_full_length():
    """Path P's layout at S 4096 (12 heads): a local window's 4 q blocks
    share a list, so do a head's 64 global k blocks and a window's 3
    local k blocks: as many groups as the layout's distinct rows need,
    64 forward and 80 dk/dv a head, 98.5% of the issued 64 x 64 tile steps
    live."""
    layout = tsa.FixedSparsityConfig(num_heads=12, **PATH_P_LAYOUT
                                     ).make_layout(4096)
    maps = tk.block_maps(layout, "cpu", 16)
    for groups, lay, per_head in ((maps.groups, layout, 64),
                                  (maps.groupsT, layout.transpose(0, 2, 1),
                                   80)):
        want = sum(-(-n // 4) for hl in lay
                   for n in np.unique(hl, axis=0, return_counts=True)[1])
        assert len(groups) == want == 12 * per_head
        steps = sum(-(-int(lay[h, rep].sum()) * 16 // 64)
                    for h, rep in groups.numpy()[:, :2])
        assert steps == 13056
    fill = tk.tile_fill(layout, 16)
    assert fill == {"forward": 12864 / 13056, "dkv": 12864 / 13056}
    assert layout.sum() * 16 * 16 / (64 * 64) == 12864


def _emulate_tc_kernels(layout, block, q, k, v, do):
    """numpy emulation of the tensor-core kernels' schedule (fp32): each
    group's 64 rows gathered (pad rows zero), its stream of the list's
    rows walked in 64-entry chunks (32-entry steps for dk/dv), entries
    past the stream's end zero and masked to p = 0, online softmax in the
    forward, p from lse in the backward. Returns o, dq, dk, dv."""
    maps = tk.block_maps(layout, "cpu", block)
    jmap, counts, imap, countsT = (getattr(maps, n).numpy() for n in
                                   ("jmap", "counts", "imap", "countsT"))
    nb, nh, _, d = q.shape
    sc = np.float32(1 / np.sqrt(d))
    neg = np.float32(tk.NEG_INF)

    def stream(lists, cnts, head, rep):
        t = np.arange(cnts[head, rep] * block)
        return lists[head, rep][t // block] * block + t % block

    def chunk_of(rows, t0, size):
        out = np.full(size, -1)
        part = rows[t0:t0 + size]
        out[:len(part)] = part
        return out

    def gather(x, rows):
        out = np.zeros((len(rows), d), np.float32)
        out[rows >= 0] = x[rows[rows >= 0]]
        return out

    def pick(vec, rows):
        return np.where(rows >= 0, vec[np.maximum(rows, 0)], 0)

    o, dq, dk, dv = (np.zeros_like(q) for _ in range(4))
    lse = np.zeros(q.shape[:3], np.float32)
    for head, rep, *rows in maps.groups.numpy():
        rows, keys = np.asarray(rows), stream(jmap, counts, head, rep)
        ok = rows >= 0
        for b in range(nb):
            qg = gather(q[b, head], rows)
            m = np.full(64, neg)
            l = np.zeros(64, np.float32)
            acc = np.zeros((64, d), np.float32)
            for t0 in range(0, len(keys), 64):
                cols = chunk_of(keys, t0, 64)
                kc, vc = gather(k[b, head], cols), gather(v[b, head], cols)
                s = np.where(cols >= 0, qg @ kc.T * sc, neg)
                m_new = np.maximum(m, s.max(1))
                p = np.where(cols >= 0, np.exp(s - m_new[:, None]), 0)
                corr = np.exp(m - m_new)
                l = l * corr + p.sum(1)
                acc = acc * corr[:, None] + p @ vc
                m = m_new
            lv = np.maximum(l, np.float32(1e-30))
            o[b, head, rows[ok]] = (acc / lv[:, None])[ok]
            lse[b, head, rows[ok]] = (m + np.log(lv))[ok]
    delta = (do * o).sum(-1)
    for head, rep, *rows in maps.groups.numpy():
        rows, keys = np.asarray(rows), stream(jmap, counts, head, rep)
        ok = rows >= 0
        for b in range(nb):
            qg, dog = gather(q[b, head], rows), gather(do[b, head], rows)
            lr, dr = pick(lse[b, head], rows), pick(delta[b, head], rows)
            acc = np.zeros((64, d), np.float32)
            for t0 in range(0, len(keys), 64):
                cols = chunk_of(keys, t0, 64)
                kc, vc = gather(k[b, head], cols), gather(v[b, head], cols)
                p = np.where(cols >= 0,
                             np.exp(qg @ kc.T * sc - lr[:, None]), 0)
                acc += (p * (dog @ vc.T - dr[:, None])) @ kc
            dq[b, head, rows[ok]] = (acc * sc)[ok]
    for head, rep, *rows in maps.groupsT.numpy():
        rows, queries = np.asarray(rows), stream(imap, countsT, head, rep)
        ok = rows >= 0
        for b in range(nb):
            kg, vg = gather(k[b, head], rows), gather(v[b, head], rows)
            dk_acc, dv_acc = (np.zeros((64, d), np.float32) for _ in "kv")
            for t0 in range(0, len(queries), 32):
                cols = chunk_of(queries, t0, 32)
                qc, doc = gather(q[b, head], cols), gather(do[b, head], cols)
                lc, dc = pick(lse[b, head], cols), pick(delta[b, head], cols)
                pt = np.where(cols >= 0,
                              np.exp(kg @ qc.T * sc - lc[None, :]), 0)
                dv_acc += pt @ doc
                dk_acc += (pt * (vg @ doc.T - dc[None, :])) @ qc
            dk[b, head, rows[ok]] = (dk_acc * sc)[ok]
            dv[b, head, rows[ok]] = dv_acc[ok]
    return o, dq, dk, dv


def _dead_row_layout():
    layout = np.eye(8, dtype=bool)[None].repeat(2, 0)
    layout[:, 1, :] = False
    layout[:, 3, 0] = True
    return layout


SCHEDULE_CASES = {
    "fixed": (lambda: LAYOUTS["fixed"]().make_layout(256), (2, 4, 256, 32)),
    "bigbird": (lambda: LAYOUTS["bigbird"]().make_layout(256),
                (2, 4, 256, 32)),
    "dead_row": (_dead_row_layout, (1, 2, 128, 16)),
}


@pytest.mark.parametrize("name", list(SCHEDULE_CASES))
def test_group_schedule_matches_jax_kernel(name):
    """The tensor-core kernels' schedule (tile groups, 64-entry chunks,
    online softmax, masked entries p = 0), emulated in numpy in fp32,
    against the JAX Pallas kernels in interpret mode: o, dq, dk, dv at
    2e-5; a dead row gives o = 0 and dq = 0."""
    make, shape = SCHEDULE_CASES[name]
    layout = make()
    block = shape[2] // layout.shape[1]
    q, k, v, do = _qkv(shape, 6)
    want = _jax_attn(layout, q, k, v, do)
    got = _emulate_tc_kernels(layout, block, q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)
    if name == "dead_row":
        assert np.all(got[0][:, :, 16:32] == 0)
        assert np.all(got[1][:, :, 16:32] == 0)


def test_library_name_hashes_the_included_headers(tmp_path, monkeypatch):
    """A kernel library's name changes with its source and with every
    csrc header the source includes, and with nothing else."""
    from deepspeed_tpu_torch.ops import op_builder
    assert [p.name for p in op_builder.sources("block_sparse_attention")] \
        == ["block_sparse_attention.cu", "hopper_tiles.cuh"]
    assert [p.name for p in op_builder.sources("flash_attention")] \
        == ["flash_attention.cu", "hopper_tiles.cuh"]
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n#include <math.h>\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\nint h;\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    (tmp_path / "b.cu").write_text("int b;\n")
    monkeypatch.setattr(op_builder, "CSRC", tmp_path)
    names = [op_builder.library_path("a").name]
    (tmp_path / "g.cuh").write_text("int g2;\n")
    names.append(op_builder.library_path("a").name)
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\nint h2;\n')
    names.append(op_builder.library_path("a").name)
    assert len(set(names)) == 3
    b = op_builder.library_path("b").name
    (tmp_path / "h.cuh").write_text("int h3;\n")
    assert op_builder.library_path("b").name == b
