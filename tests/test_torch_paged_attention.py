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
from deepspeed_tpu_torch.ops import quantization as tquant

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
    """Quantized pools are taken as int8/fp8 codes with both scale pools;
    a scale pool without its pair, or scales over fp pools, raise."""
    x = {k: torch.from_numpy(v) for k, v in _inputs(1).items()}
    scale = torch.ones(NB, BS, HKV)
    with pytest.raises(ValueError, match="come together"):
        tpaged.paged_attention_kernel(*x.values(), k_scale=scale)
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        tpaged.paged_attention_kernel(*x.values(), k_scale=scale,
                                      v_scale=scale)



# ------------------------------------------- the CUDA kernels' schedules
# The tensor-core prefill kernel and the decode split + combine of
# csrc/paged_attention.cu, emulated in numpy in fp32 step by step (which
# keys each thread block stages, in which order it folds them, what it
# zero-fills), against the Pallas kernel in interpret mode at 2e-5.
# name: B, S_new, Hq, Hkv, D, bs, pos0, true_len, extras
SCHEDULE_CASES = {
    "prefill_bs8_d32_rep4": (3, 40, 8, 2, 32, 8, [13, 0, 150],
                             [40, 37, 25], {}),
    "prefill_bs16_d128_rep1": (3, 70, 2, 2, 128, 16, [0, 64, 99],
                               [70, 1, 0], {}),
    "prefill_bs64_d32_rep8_window": (3, 24, 16, 2, 32, 64, [200, 31, 129],
                                     [24, 10, 24], {"window": 50}),
    "prefill_bs16_d32_rep4_alibi": (3, 20, 8, 2, 32, 16, [77, 5, 300],
                                    [20, 20, 13], {"alibi": True}),
    "prefill_rep3_tiles_end_mid_group": (2, 30, 6, 2, 32, 8, [20, 67],
                                         [30, 29], {"window": 40}),
    "mixed_tick": (3, 256, 8, 2, 32, 16, [0, 150, 90], [256, 1, 1], {}),
    "prefill_int8_head": (2, 40, 8, 2, 32, 16, [45, 130], [40, 33],
                          {"kv": ("int8", "head")}),
    "prefill_int8_token_window_alibi": (2, 24, 8, 2, 64, 8, [100, 9],
                                        [24, 24], {"kv": ("int8", "token"),
                                                   "window": 30,
                                                   "alibi": True}),
    "decode_bs8_d32_rep4": (3, 1, 8, 2, 32, 8, [13, 0, 300], [1, 1, 0], {}),
    "decode_bs64_d128_rep8": (2, 1, 16, 2, 128, 64, [200, 129], [1, 1], {}),
    "decode_bs16_rep1_window_alibi": (3, 1, 4, 4, 32, 16, [250, 20, 128],
                                      [1, 1, 1], {"window": 100,
                                                  "alibi": True}),
    "decode_sq2_rep8_ends_mid_split": (2, 2, 16, 2, 32, 8, [130, 255],
                                       [2, 1], {"window": 200}),
    "decode_int8_head": (2, 1, 8, 2, 32, 16, [140, 7], [1, 1],
                         {"kv": ("int8", "head")}),
    "decode_int8_token_alibi": (3, 1, 8, 2, 64, 8, [300, 0, 61], [1, 1, 1],
                                {"kv": ("int8", "token"), "alibi": True}),
    # fp16 (DeepSpeed's default serving dtype): the same two kernels, P
    # rounded to fp16 in the prefill, on fp16, int8 and fp8 pools
    "fp16_prefill_bs8_d32_rep4": (3, 40, 8, 2, 32, 8, [13, 0, 150],
                                  [40, 37, 25], {"dtype": "fp16"}),
    "fp16_prefill_bs64_d128_window_alibi": (
        2, 70, 4, 2, 128, 64, [200, 31], [70, 64],
        {"dtype": "fp16", "window": 90, "alibi": True}),
    "fp16_mixed_tick": (3, 256, 8, 2, 32, 16, [0, 150, 90], [256, 1, 1],
                        {"dtype": "fp16"}),
    "fp16_prefill_int8_head": (2, 40, 8, 2, 32, 16, [45, 130], [40, 33],
                               {"dtype": "fp16", "kv": ("int8", "head")}),
    "fp16_prefill_fp8_token_window": (2, 24, 8, 2, 64, 8, [100, 9],
                                      [24, 24], {"dtype": "fp16",
                                                 "kv": ("fp8", "token"),
                                                 "window": 30}),
    "fp16_decode_bs8_d32_rep4": (3, 1, 8, 2, 32, 8, [13, 0, 300], [1, 1, 0],
                                 {"dtype": "fp16"}),
    "fp16_decode_sq2_rep8_window_alibi": (2, 2, 16, 2, 32, 8, [130, 255],
                                          [2, 1], {"dtype": "fp16",
                                                   "window": 200,
                                                   "alibi": True}),
    "fp16_decode_int8_head": (2, 1, 8, 2, 32, 16, [140, 7], [1, 1],
                              {"dtype": "fp16", "kv": ("int8", "head")}),
    "fp16_decode_fp8_token": (3, 1, 8, 2, 64, 8, [300, 0, 61], [1, 1, 1],
                              {"dtype": "fp16", "kv": ("fp8", "token")}),
    # the model families' head dims past the powers of two (Phi-2 80,
    # Phi-3-mini and GPT-NeoX-20B 96, GPT-J-6B 256): 32-key prefill
    # chunks and, in fp32, 64-key decode splits at D 256
    "prefill_d80_rep4": (2, 24, 8, 2, 80, 16, [13, 40], [24, 20], {}),
    "decode_d80_int8_head_window_alibi": (
        2, 1, 8, 2, 80, 8, [70, 9], [1, 1],
        {"kv": ("int8", "head"), "window": 30, "alibi": True}),
    "prefill_d96_fp8_token": (2, 20, 4, 2, 96, 16, [33, 0], [20, 17],
                              {"kv": ("fp8", "token")}),
    "fp16_decode_sq2_d96": (2, 2, 8, 2, 96, 16, [130, 40], [2, 1],
                            {"dtype": "fp16"}),
    "decode_d256_splits_of_64": (2, 1, 4, 2, 256, 16, [150, 60], [1, 1], {}),
    "fp16_prefill_d256_window_alibi": (2, 40, 4, 2, 256, 16, [70, 5],
                                       [40, 33], {"dtype": "fp16",
                                                  "window": 50,
                                                  "alibi": True}),
}
# fp16 cases against the Pallas kernel in fp16: both sides round the
# output to fp16 (2^-11 relative each) and round p to fp16 against other
# running maxima (the Pallas kernel a page at a time and also in decode,
# the prefill schedule a 64-key chunk at a time), and quantized pools
# round the V tile to fp16: 4 fp16 ulps at |out| ~ 1
FP16_TOL = dict(atol=2e-3, rtol=2e-3)
NEG = np.float32(-1e30)
TILE_ROWS = 128    # rows a block of the tensor-core prefill: two warpgroups


def _prefill_chunk(d):
    """Keys a chunk of the tensor-core prefill (csrc/paged_attention.cu
    ``kChunkOf``): 32 at D 256, whose Q and three stages of 64-key K and
    V tiles would pass a block's shared memory; else 64."""
    return 32 if d > 128 else 64


def _fp16(name):
    return SCHEDULE_CASES[name][-1].get("dtype") == "fp16"


def _codes_to_numpy(codes: torch.Tensor) -> np.ndarray:
    """int8 codes as they are; fp8-e4m3 codes as their bytes viewed as
    the JAX package's float8_e4m3fn numpy type."""
    if codes.dtype == torch.float8_e4m3fn:
        return codes.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    return codes.numpy()


def _schedule_inputs(name, seed=0):
    """One case's inputs (numpy: fp32 or fp16, fp or int8/fp8 pools with
    f32 scales), its window and ALiBi slopes (or None)."""
    b, sq, hq, hkv, d, bs, pos0, true_len, extra = SCHEDULE_CASES[name]
    rng = np.random.default_rng(seed)
    dt = np.float16 if _fp16(name) else np.float32
    f = lambda *s: rng.standard_normal(s).astype(dt)  # noqa: E731
    max_blocks = max(-(-(p + sq) // bs) for p in pos0) + 1
    nb = b * max_blocks + 3
    tables = rng.permutation(nb)[:b * max_blocks].reshape(b, max_blocks)
    tables[0, -1] = nb + 5         # a padded slot past the pool: clamped
    x = dict(q=f(b, sq, hq, d), k_new=f(b, sq, hkv, d),
             v_new=f(b, sq, hkv, d), k_pool=f(nb, bs, hkv, d),
             v_pool=f(nb, bs, hkv, d), block_tables=tables.astype(np.int32),
             pos0=np.asarray(pos0, np.int32),
             true_len=np.asarray(true_len, np.int32))
    if "kv" in extra:
        kv_dtype, gran = extra["kv"]
        hs = hkv if gran == "head" else 1
        for name_ in ("k", "v"):
            codes, scales = tquant.kv_quantize(
                torch.from_numpy(x[f"{name_}_pool"]), kv_dtype, hs)
            x[f"{name_}_pool"] = _codes_to_numpy(codes)
            x[f"{name_}_scale"] = scales.numpy()
    slopes = (np.array(jax_alibi_slopes(hq), np.float32)
              if extra.get("alibi") else None)
    return x, extra.get("window"), slopes


def _dead_slots_poisoned(x, window):
    """The inputs with NaN (inf in the scales) in every pool slot no row
    may read (past pos0, outside the table, older than the window of the
    row's first query) and in every k_new/v_new row past true_len."""
    y = {k: v.copy() for k, v in x.items()}
    nb, bs = x["k_pool"].shape[:2]
    live = np.zeros((nb, bs), bool)
    for b, (p0, tl) in enumerate(zip(x["pos0"], x["true_len"])):
        if tl == 0:
            continue
        lo = max(0, p0 - window + 1) if window else 0
        for kp in range(lo, min(p0, x["block_tables"].shape[1] * bs)):
            blk = min(max(x["block_tables"][b, kp // bs], 0), nb - 1)
            live[blk, kp % bs] = True
        y["k_new"][b, tl:] = np.nan
        y["v_new"][b, tl:] = np.nan
    for name in ("k_pool", "v_pool"):
        if y[name].dtype != np.int8:           # fp32, fp16, fp8 codes
            y[name][~live] = np.nan
    for name in ("k_scale", "v_scale"):
        if name in y:
            y[name][~live] = np.inf
    return y


def _pool_rows(x, name, b, g, kp):
    """Cached keys kp of batch row b, kv head g, through the clamped table:
    the pool's rows (fp32) and their scales (ones for fp pools)."""
    nb, bs = x["k_pool"].shape[:2]
    blk = np.clip(x["block_tables"][b, kp // bs], 0, nb - 1)
    rows = x[f"{name}_pool"][blk, kp % bs, g].astype(np.float32)
    if f"{name}_scale" not in x:
        return rows, np.ones(len(kp), np.float32)
    hs = x[f"{name}_scale"].shape[-1]
    return rows, x[f"{name}_scale"][blk, kp % bs, g % hs]


def _round16(a):
    """fp32 values rounded to fp16 (nearest even), back in fp32."""
    return a.astype(np.float16).astype(np.float32)


def _prefill_schedule(x, window, slopes):
    """paged_prefill_tc_kernel: a block per (b, kv head, TILE_ROWS
    flattened rows), key chunks of ``_prefill_chunk(D)`` (64; 32 at D 256:
    the cached keys the block's first query can see, then the fresh keys
    up to its last live query) with
    dead slots zero-filled, the online softmax per chunk; the key scale on
    S's columns, the value scale folded into P. fp16 inputs: P rounded to
    fp16 before P V, and a quantized pool's V tile holds code x scale
    rounded to fp16 (the scale stays out of P)."""
    q = x["q"]
    fp16 = q.dtype == np.float16
    b_, sq, hq, d = q.shape
    hkv = x["k_new"].shape[2]
    rep, rows = hq // hkv, sq * (hq // hkv)
    bs, mb = x["k_pool"].shape[1], x["block_tables"].shape[1]
    sc = np.float32(1 / np.sqrt(d))
    ck = _prefill_chunk(d)
    out = np.zeros(q.shape, np.float32)
    for b in range(b_):
        p0, nq = int(x["pos0"][b]), min(sq, int(x["true_len"][b]))
        for g in range(hkv):
            for row0 in range(0, rows, TILE_ROWS):
                if row0 >= rep * nq:
                    continue                  # all rows dead: zeros, no reads
                q_lo = row0 // rep
                q_hi = (min(row0 + TILE_ROWS, rep * nq) - 1) // rep
                page_hi = min(p0, mb * bs)
                page_lo = max(0, p0 + q_lo - window + 1) if window else 0
                fresh_lo = max(0, q_lo - window + 1) if window else 0
                chunks = ([(True, k0, page_hi)
                           for k0 in range(page_lo, page_hi, ck)]
                          + [(False, j0, q_hi + 1)
                             for j0 in range(fresh_lo, q_hi + 1, ck)])
                gr = row0 + np.arange(TILE_ROWS)
                qi, h = gr // rep, g * rep + gr % rep
                row_ok = (gr < rows) & (qi < nq)
                qt = np.zeros((TILE_ROWS, d), np.float32)
                qt[row_ok] = q[b, qi[row_ok], h[row_ok]]
                qpos = p0 + qi
                m = np.full(TILE_ROWS, NEG)
                l = np.zeros(TILE_ROWS, np.float32)
                acc = np.zeros((TILE_ROWS, d), np.float32)
                for cached, k0, end in chunks:
                    ok = k0 + np.arange(ck) < end
                    kt = np.zeros((ck, d), np.float32)
                    vt = np.zeros((ck, d), np.float32)
                    ks = np.ones(ck, np.float32)
                    vs = np.ones(ck, np.float32)
                    idx = k0 + np.arange(ck)[ok]
                    if cached:
                        kt[ok], ks[ok] = _pool_rows(x, "k", b, g, idx)
                        vt[ok], vs[ok] = _pool_rows(x, "v", b, g, idx)
                        if fp16 and "v_scale" in x:
                            vt = _round16(vt * vs[:, None])
                            vs = np.ones(ck, np.float32)
                        kpos = k0 + np.arange(ck)
                    else:
                        kt[ok], vt[ok] = x["k_new"][b, idx, g], \
                            x["v_new"][b, idx, g]
                        kpos = p0 + k0 + np.arange(ck)
                    s = (qt @ kt.T) * ks[None] * sc
                    if slopes is not None:
                        safe_h = np.where(gr < rows, h, 0)
                        s = s + np.where(gr < rows, slopes[safe_h], 0)[:, None] \
                            * (kpos[None] - qpos[:, None])
                    mask = ok[None] & (kpos[None] <= qpos[:, None])
                    if window:
                        mask &= qpos[:, None] - kpos[None] < window
                    s = np.where(mask, s, NEG)
                    m_new = np.maximum(m, s.max(1))
                    corr = np.exp(m - m_new)
                    p = np.where(mask, np.exp(s - m_new[:, None]), 0)
                    l = l * corr + p.sum(1)
                    pv = p * vs[None]
                    if fp16:
                        pv = _round16(pv)
                    acc = acc * corr[:, None] + pv @ vt
                    m = m_new
                o = acc / np.maximum(l, np.float32(1e-30))[:, None]
                keep = gr < rows
                out[b, qi[keep], h[keep]] = np.where(row_ok[keep, None],
                                                     o[keep], 0)
    return out


def _decode_schedule(x, window, slopes, plan, keys):
    """paged_decode_split_kernel + paged_decode_combine_kernel: the plan's
    splits of ``keys`` keys at fixed positions, one partial (m, l, o)
    each in the plan's workspace (an empty split: m = -1e30, l = 0, o =
    0), then per row the partials folded in split order against the
    largest m of the non-empty ones, then the fresh keys one at a time."""
    q = x["q"]
    b_, sq, hq, d = q.shape
    hkv = x["k_new"].shape[2]
    rep, rows = hq // hkv, sq * (hq // hkv)
    bs, mb = x["k_pool"].shape[1], x["block_tables"].shape[1]
    sc = np.float32(1 / np.sqrt(d))
    ws = np.zeros(plan["workspace"], np.float32)
    r = np.arange(rows)
    qi, qpos_off = r // rep, r // rep
    for b in range(b_):
        p0, nq = int(x["pos0"][b]), min(sq, int(x["true_len"][b]))
        for g in range(hkv):
            h = g * rep + r % rep
            qt = np.where((qi < nq)[:, None], q[b, np.minimum(qi, sq - 1), h],
                          0).astype(np.float32)
            qpos = p0 + qpos_off
            for s in range(plan["splits"]):
                k0 = s * keys
                lo = max(k0, p0 - window + 1 if window else 0)
                hi = min(p0, mb * bs, k0 + keys) if nq else 0
                if lo >= hi:
                    ws[b, g, s, :, d] = NEG
                    continue
                kp = np.arange(lo, hi)
                kt, ks = _pool_rows(x, "k", b, g, kp)
                vt, vs = _pool_rows(x, "v", b, g, kp)
                sco = (qt @ kt.T) * ks[None] * sc
                if slopes is not None:
                    sco = sco + slopes[h][:, None] * (kp[None] - qpos[:, None])
                mask = (qi < nq)[:, None] & np.ones(len(kp), bool)[None]
                if window:
                    mask &= qpos[:, None] - kp[None] < window
                sco = np.where(mask, sco, NEG)
                m = sco.max(1)
                p = np.where(mask, np.exp(sco - m[:, None]), 0)
                ws[b, g, s, :, :d] = (p * vs[None]) @ vt
                ws[b, g, s, :, d] = m
                ws[b, g, s, :, d + 1] = p.sum(1)
    out = np.zeros(q.shape, np.float32)
    qf, kf, vf = (x[n].astype(np.float32) for n in ("q", "k_new", "v_new"))
    for b in range(b_):
        nq = min(sq, int(x["true_len"][b]))
        for g in range(hkv):
            for row in range(rows):
                qi_, h = row // rep, g * rep + row % rep
                if qi_ >= nq:
                    continue
                part = ws[b, g, :, row]
                m_s, l_s = part[:, d], part[:, d + 1]
                m = max([NEG] + [m_s[s] for s in range(len(m_s))
                                 if l_s[s] > 0])
                l = np.float32(0)
                o = np.zeros(d, np.float32)
                for s in range(len(m_s)):
                    w = np.exp(m_s[s] - m) if l_s[s] > 0 else np.float32(0)
                    l = l + l_s[s] * w
                    o = o + w * part[s, :d]
                jlo = max(0, qi_ - window + 1) if window else 0
                for j in range(jlo, qi_ + 1):
                    sj = qf[b, qi_, h] @ kf[b, j, g] * sc
                    if slopes is not None:
                        sj = sj + slopes[h] * np.float32(j - qi_)
                    m_new = max(m, sj)
                    corr, p = np.exp(m - m_new), np.exp(sj - m_new)
                    l = l * corr + p
                    o = o * corr + p * vf[b, j, g]
                    m = m_new
                out[b, qi_, h] = o / max(l, np.float32(1e-30))
    return out


def _schedule_out(name, x, window, slopes):
    """The case through the schedule the wrapper's plan picks for it
    (fp16 cases: the output rounded to fp16, as the kernels store it;
    the decode split at the case's dtype's keys a split)."""
    q, hkv = x["q"], x["k_new"].shape[2]
    d = q.shape[-1]
    shapes = (q.shape, hkv, x["block_tables"].shape, x["k_pool"].shape[1])
    plan = tpaged.launch_plan(q.shape, torch.bfloat16, *shapes[1:])
    assert plan == tpaged.launch_plan(q.shape, torch.float32, *shapes[1:]) \
        or plan["variant"] == "prefill_wgmma" \
        or tpaged.split_keys(torch.float32, d) != tpaged.SPLIT_KEYS
    assert plan == tpaged.launch_plan(q.shape, torch.float16, *shapes[1:])
    if "decode" in name:
        assert plan["variant"] == "decode_split"
        dtype = torch.float16 if _fp16(name) else torch.float32
        plan = tpaged.launch_plan(q.shape, dtype, *shapes[1:])
        out = _decode_schedule(x, window, slopes, plan,
                               tpaged.split_keys(dtype, d))
    else:
        assert plan["variant"] == "prefill_wgmma"
        out = _prefill_schedule(x, window, slopes)
    return _round16(out) if _fp16(name) else out


@pytest.mark.parametrize("name", list(SCHEDULE_CASES))
def test_kernel_schedule_matches_pallas_kernel(name):
    """Each CUDA kernel's schedule against the Pallas kernel (interpret
    mode) on the rows < true_len at 2e-5 (fp16 cases: the Pallas kernel in
    fp16, at FP16_TOL); rows past true_len are zeros."""
    x, window, slopes = _schedule_inputs(name)
    kw = {"window": window}
    if slopes is not None:
        kw["alibi_slopes"] = jnp.asarray(slopes)
    args = [jnp.asarray(x[k]) for k in ("q", "k_new", "v_new", "k_pool",
                                         "v_pool", "block_tables", "pos0",
                                         "true_len")]
    if "k_scale" in x:
        kw.update(k_scale=jnp.asarray(x["k_scale"]),
                  v_scale=jnp.asarray(x["v_scale"]))
    ref = np.asarray(jpaged.paged_attention_kernel(*args, **kw))
    assert ref.dtype == x["q"].dtype
    got = _schedule_out(name, x, window, slopes)
    tol = FP16_TOL if _fp16(name) else TOL
    for b, tl in enumerate(x["true_len"]):
        np.testing.assert_allclose(got[b, :tl], ref[b, :tl].astype(
            np.float32), **tol)
        assert not got[b, tl:].any()


@pytest.mark.parametrize("name", list(SCHEDULE_CASES))
def test_kernel_schedule_never_reads_a_dead_slot(name):
    """NaN (inf in the scales) in every pool slot past pos0, outside the
    table or older than the window, and in every fresh row past true_len,
    leaves each schedule's output bit-identical: every tile slot outside
    the live range is zero-filled, never read."""
    x, window, slopes = _schedule_inputs(name, seed=1)
    clean = _schedule_out(name, x, window, slopes)
    poisoned = _schedule_out(name, _dead_slots_poisoned(x, window), window,
                             slopes)
    assert np.isfinite(clean).all()
    np.testing.assert_array_equal(poisoned, clean)


def test_launch_plan_is_a_function_of_shapes():
    """The wrapper's plan (variant, splits, workspace shape) takes shapes
    and the dtype only, never a tensor's values, so a CUDA graph can
    capture the call: decode ticks split each context in SPLIT_KEYS keys
    from the table's width (B 8 x 8 kv heads x 16 splits fill two waves of
    132 SMs at the serving shape), prefill chunks take the tensor-core
    kernel in bf16 and fp16 and the CUDA-core one in fp32; fp16 takes the
    same plan as bf16 at every shape, and a dtype no kernel takes (fp64)
    none."""
    import inspect
    assert list(inspect.signature(tpaged.launch_plan).parameters) == [
        "q_shape", "dtype", "num_kv_heads", "block_tables_shape",
        "block_size"]
    plan = tpaged.launch_plan
    decode = plan(torch.Size([8, 1, 32, 128]), torch.bfloat16, 8,
                  torch.Size([8, 32]), 64)
    assert decode == {"variant": "decode_split", "splits": 16,
                      "workspace": (8, 8, 16, 4, 130)}
    assert 8 * 8 * decode["splits"] >= 2 * 132
    assert plan((8, 1, 32, 128), torch.float32, 8, (8, 32), 64) == decode
    assert plan((8, 1, 32, 128), torch.float16, 8, (8, 32), 64) == decode
    assert plan((3, 2, 16, 128), torch.float32, 2, (3, 5), 8)["splits"] == 1
    assert plan((3, 2, 16, 128), torch.float32, 2, (3, 17), 8)["splits"] == 2
    for dtype, want in ((torch.bfloat16, "prefill_wgmma"),
                        (torch.float16, "prefill_wgmma"),
                        (torch.float32, "cuda_cores")):
        got = plan((8, 256, 32, 128), dtype, 8, (8, 9), 64)
        assert got == {"variant": want, "splits": 0, "workspace": None}
        # 17 rows a kv head: past the split's 16
        assert plan((1, 17, 4, 64), dtype, 4, (1, 3), 8)["variant"] == want
    assert plan((1, 16, 4, 64), torch.bfloat16, 4, (1, 3),
                8)["variant"] == "decode_split"
    for shape in ((8, 1, 32, 128), (1, 17, 4, 64), (3, 2, 16, 128),
                  (2, 256, 8, 64)):
        for table in ((8, 32), (1, 3), (3, 17)):
            assert plan(shape, torch.float16, shape[2] // 4, table, 64) == \
                plan(shape, torch.bfloat16, shape[2] // 4, table, 64)
    for bad in (dict(q_shape=(1, 1, 4, 48)), dict(dtype=torch.float64),
                dict(q_shape=(65536, 1, 4, 64)), dict(num_kv_heads=3)):
        kw = dict(q_shape=(1, 1, 4, 64), dtype=torch.bfloat16,
                  num_kv_heads=4, block_tables_shape=(1, 3), block_size=8)
        kw.update(bad)
        assert plan(**kw)["variant"] is None
    # the same shapes with other pos0 and true_len take the same plan: the
    # plan has nothing else to read
    x, *_ = _schedule_inputs("decode_bs8_d32_rep4")
    y, *_ = _schedule_inputs("decode_bs8_d32_rep4", seed=3)
    y["pos0"] = y["pos0"][::-1].copy()
    for v in (x, y):
        assert plan(v["q"].shape, torch.bfloat16, v["k_new"].shape[2],
                    v["block_tables"].shape, v["k_pool"].shape[1]) == \
            {"variant": "decode_split", "splits": 3,
             "workspace": (3, 2, 3, 4, 34)}


def test_launch_plan_split_and_chunk_follow_the_head_dim():
    """The head dims past the powers of two take the same variants; the
    decode split cuts contexts in 128 keys except fp32 at D 256 (64: its
    K and V of 128 keys would pass a block's shared memory). Other
    multiples of 8 have no kernel."""
    plan = tpaged.launch_plan
    for d in (80, 96, 256):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            keys = 64 if dtype == torch.float32 and d == 256 else 128
            assert tpaged.split_keys(dtype, d) == keys
            got = plan((8, 1, 32, d), dtype, 32, (8, 32), 64)
            assert got == {"variant": "decode_split",
                           "splits": -(-32 * 64 // keys),
                           "workspace": (8, 32, -(-32 * 64 // keys), 1,
                                         d + 2)}
            want = "cuda_cores" if dtype == torch.float32 \
                else "prefill_wgmma"
            assert plan((2, 256, 32, d), dtype, 32, (2, 9), 64) == \
                {"variant": want, "splits": 0, "workspace": None}
    # Falcon-7B's 71 q heads over 1 kv head: a decode row is 71 rows
    assert plan((8, 1, 71, 64), torch.bfloat16, 1, (8, 9),
                64)["variant"] == "prefill_wgmma"
    for d in (8, 48, 112, 192, 512):
        assert plan((1, 1, 4, d), torch.bfloat16, 4, (1, 3),
                    8)["variant"] is None
