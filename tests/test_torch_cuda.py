"""The port's CUDA kernels on the card (marker ``gpu``: these tests skip
where no card is present). On a machine with an NVIDIA H100:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

``--noconftest`` because the suite's conftest imports jax; this file
imports only torch, numpy and the port, so it runs where jax is absent.
Each kernel is held against its plain PyTorch version on the same inputs:
attention in fp32 with TF32 off at 1e-4 (summation order only), in bf16
at 3e-2 (the JAX package's bf16 kernel tolerance,
tests/test_pallas_kernels.py:67), in fp16 at 1e-2 (fp16 rounds p and ds
8x finer than bf16); fused Adam and fused Lion at 1e-6 absolute, 1e-5
relative (the JAX package's fused-optimizer tolerance, :100, :145-160);
block-sparse attention in fp32 at 1e-4, in bf16 at 3e-2 and in fp16 at
1e-2 of the largest value.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import build_engine, paged
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.fused_optimizers import (Adam, Lion,
                                                      fused_adam_step,
                                                      fused_lion_step)
from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
from deepspeed_tpu_torch.ops.layers import alibi_slopes
from deepspeed_tpu_torch.ops.quantization import kv_quantize

pytestmark = pytest.mark.gpu

B, HQ, HKV, NB, BS, MAXB = 3, 8, 2, 24, 8, 6
POS0 = [13, 0, 24]
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 1e-2}
VARIANTS = {"causal": {}, "window": {"window": 11}, "alibi": {"alibi": True}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, sq, d, seed=0):
    """One paged-attention call: a permuted block table with a padded
    slot past the pool, and a batch row with nothing to attend
    (true_len 0) in the decode case."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    tables = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    tables[1, -1] = NB
    true_len = [sq, 0, sq] if sq == 1 else [sq, sq - 3, sq]
    ints = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    return dict(q=f(B, sq, HQ, d), k_new=f(B, sq, HKV, d),
                v_new=f(B, sq, HKV, d), k_pool=f(NB, BS, HKV, d),
                v_pool=f(NB, BS, HKV, d), block_tables=ints(tables),
                pos0=ints(POS0), true_len=ints(true_len))


def _plan(x):
    return paged.launch_plan(x["q"].shape, x["q"].dtype, x["k_new"].shape[2],
                             x["block_tables"].shape, x["k_pool"].shape[1])


def _kwargs(variant, dev):
    kw = {"window": VARIANTS[variant].get("window")}
    if VARIANTS[variant].get("alibi"):
        kw["alibi_slopes"] = alibi_slopes(HQ, device=dev)
    return kw


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("sq", [1, 8, 40])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_matches_plain(cuda, dtype, d, sq, variant):
    x = _inputs(cuda, dtype, sq, d)
    kw = _kwargs(variant, cuda)
    before = paged.paged_attention_kernel.launches
    got = paged.paged_attention_kernel(*x.values(), **kw)
    torch.cuda.synchronize()
    assert paged.paged_attention_kernel.launches == before + 1
    assert paged.paged_attention_kernel.variant == _plan(x)["variant"]
    ref = paged.paged_attention_plain(*x.values(), **kw)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = _inputs(cuda, torch.float32, 8, 32)
    bad = [("head_dim", dict(x, q=x["q"].repeat(1, 1, 1, 2)[..., :48]
                                   .contiguous())),
           ("int32", dict(x, block_tables=x["block_tables"].long())),
           ("contiguous", dict(x, q=x["q"].transpose(0, 1).contiguous()
                               .transpose(0, 1))),
           ("dtype", dict(x, k_pool=x["k_pool"].to(torch.bfloat16)))]
    for match, args in bad:
        with pytest.raises(ValueError, match=match):
            paged.paged_attention_kernel(*args.values())
    # a shape no variant takes: 65536 batch rows (past a grid's y/z limit)
    wide = _inputs(cuda, torch.bfloat16, 1, 32)
    n = 65536
    wide.update(q=wide["q"][:1].expand(n, -1, -1, -1).contiguous(),
                k_new=wide["k_new"][:1].expand(n, -1, -1, -1).contiguous(),
                v_new=wide["v_new"][:1].expand(n, -1, -1, -1).contiguous(),
                block_tables=wide["block_tables"][:1].expand(n, -1)
                .contiguous(), pos0=wide["pos0"][:1].expand(n).contiguous(),
                true_len=wide["true_len"][:1].expand(n).contiguous())
    with pytest.raises(ValueError, match="no kernel variant"):
        paged.paged_attention_kernel(*wide.values())


def test_engine_on_the_card_matches_the_cpu_and_launches_every_layer(cuda):
    cfg = dict(dtype="float32", kv_block_size=8, num_kv_blocks=64,
               max_chunk_size=16)
    cpu = build_engine("llama", "tiny", cfg, device="cpu")
    gpu = build_engine("llama", "tiny", cfg, device=cuda)
    with torch.no_grad():
        for name, p in cpu.model.params.items():
            gpu.model.params[name].copy_(p)
    prompts = [np.random.default_rng(s).integers(0, 512, n).tolist()
               for s, n in ((1, 11), (2, 40))]
    before = paged.paged_attention_kernel.launches
    got = gpu.put([0, 1], prompts)
    launched = paged.paged_attention_kernel.launches - before
    ref = cpu.put([0, 1], prompts)
    torch.testing.assert_close(got.cpu(), ref, atol=2e-4, rtol=2e-4)
    dispatches = gpu.serving_stats["host_dispatches"]
    assert dispatches == 3          # 40 tokens at a 16-token budget
    assert launched == gpu.model.config.num_layers * dispatches


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_fp16_engine_on_the_card_matches_the_cpu(cuda, kv):
    """build_engine(..., {"dtype": "fp16"}) serves on the card (the fault
    this PR repairs): fp pools and int8/fp8 pools, logits against the CPU
    engine on the same weights at 1e-2 (fp16 on both sides, P rounded to
    fp16 in the prefill kernel, the plain version keeps it in fp32), every
    layer launching a decode_split or prefill_wgmma kernel, and greedy
    generate() finishing every request."""
    cfg = dict(dtype="fp16", kv_block_size=8, num_kv_blocks=64,
               max_chunk_size=16)
    if kv:
        cfg["kv_cache"] = {"enabled": True, "dtype": kv}
    cpu = build_engine("llama", "tiny", cfg, device="cpu")
    gpu = build_engine("llama", "tiny", cfg, device=cuda)
    assert gpu.dtype == torch.float16
    with torch.no_grad():
        for name, p in cpu.model.params.items():
            gpu.model.params[name].copy_(p)
    prompts = [np.random.default_rng(s).integers(0, 512, n).tolist()
               for s, n in ((1, 11), (2, 40))]
    before = dict(paged.paged_attention_kernel.variant_launches)
    got = gpu.put([0, 1], prompts)
    ref = cpu.put([0, 1], prompts)
    nxt = [[int(t)] for t in ref.float().argmax(-1)]
    got2, ref2 = gpu.put([0, 1], nxt), cpu.put([0, 1], nxt)
    launched = {k: n - before.get(k, 0) for k, n in
                paged.paged_attention_kernel.variant_launches.items()
                if n != before.get(k, 0)}
    for g_, r_ in ((got, ref), (got2, ref2)):
        assert g_.dtype == torch.float16 and torch.isfinite(g_).all()
        torch.testing.assert_close(g_.cpu().float(), r_.float(), atol=1e-2,
                                   rtol=1e-2)
    assert set(launched) == {"prefill_wgmma", "decode_split"}
    assert sum(launched.values()) == (gpu.model.config.num_layers
                                      * gpu.serving_stats["host_dispatches"])
    gpu.flush([0, 1])
    outs = gpu.generate(prompts, max_new_tokens=8)
    assert [len(o) for o in outs] == [8, 8]
    assert gpu.free_blocks == gpu.num_kv_blocks


def _quantized(x, kv_dtype, granularity):
    """The call's fp pools as int8/fp8 codes, and their f32 scales."""
    hs = HKV if granularity == "head" else 1
    kw = {}
    for pool, scale in (("k_pool", "k_scale"), ("v_pool", "v_scale")):
        x[pool], kw[scale] = kv_quantize(x[pool], kv_dtype, hs)
    return x, kw


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("sq", [1, 40])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("granularity", ["head", "token"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quantized_kernel_matches_plain(cuda, dtype, kv_dtype, granularity,
                                        d, sq, variant):
    x, scales = _quantized(_inputs(cuda, dtype, sq, d), kv_dtype,
                           granularity)
    kw = dict(_kwargs(variant, cuda), **scales)
    before = paged.paged_attention_kernel.launches
    got = paged.paged_attention_kernel(*x.values(), **kw)
    torch.cuda.synchronize()
    assert paged.paged_attention_kernel.launches == before + 1
    assert paged.paged_attention_kernel.variant == _plan(x)["variant"]
    ref = paged.paged_attention_plain(*x.values(), **kw)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_quantized_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, kw = _quantized(_inputs(cuda, torch.float32, 8, 32), "int8", "head")
    ks = kw["k_scale"]
    bad = [("come together", dict(kw, v_scale=None)),
           ("float32", dict(kw, k_scale=ks.double(), v_scale=ks.double())),
           ("scale shape", dict(kw, k_scale=ks[..., :1].repeat(1, 1, 3)
                                .contiguous(), v_scale=ks[..., :1]
                                .repeat(1, 1, 3).contiguous())),
           ("contiguous", dict(kw, k_scale=ks.transpose(0, 1).contiguous()
                               .transpose(0, 1)))]
    for match, scales in bad:
        with pytest.raises(ValueError, match=match):
            paged.paged_attention_kernel(*x.values(), **scales)
    fp = dict(x, k_pool=x["k_pool"].float(), v_pool=x["v_pool"].float())
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        paged.paged_attention_kernel(*fp.values(), **kw)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_engine_with_prefix_cache_on_the_card(cuda, kv_dtype):
    """The int8/fp8 engine with the prefix cache on: the card's logits
    against the CPU's, every layer launching the kernel, and a warm
    request reading the blocks a cold one quantized."""
    cfg = dict(dtype="float32", kv_block_size=8, num_kv_blocks=64,
               max_chunk_size=16,
               kv_cache={"enabled": True, "dtype": kv_dtype},
               prefix_cache={"enabled": True})
    cpu = build_engine("llama", "tiny", cfg, device="cpu")
    gpu = build_engine("llama", "tiny", cfg, device=cuda)
    assert gpu.num_kv_blocks == cpu.num_kv_blocks > 64
    with torch.no_grad():
        for name, p in cpu.model.params.items():
            gpu.model.params[name].copy_(p)
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 512, 24).tolist()
    prompts = [prefix + rng.integers(0, 512, n).tolist() for n in (5, 13)]
    for e in (cpu, gpu):
        e.put([0], [prefix])
        e.flush(0)
        e.reset_serving_metrics()
    before = paged.paged_attention_kernel.launches
    got = gpu.put([1, 2], prompts)
    launched = paged.paged_attention_kernel.launches - before
    ref = cpu.put([1, 2], prompts)
    torch.testing.assert_close(got.cpu(), ref, atol=2e-4, rtol=2e-4)
    assert launched == (gpu.model.config.num_layers
                        * gpu.serving_stats["host_dispatches"])
    for e in (cpu, gpu):
        m = e.serving_metrics()
        assert (m["prefix_hits"], m["prefill_tokens_saved"]) == (6, 48)
        e.flush([1, 2])
        assert e.free_blocks == e.num_kv_blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_paged_kernel_variant_by_dtype_and_shape(cuda, dtype):
    """The wrapper's plan, the C entry's table and the launches agree:
    decode rows (S_new * Hq / Hkv <= 16) take the decode split in every
    dtype with the plan's splits; more rows the tensor-core prefill in
    bf16 and fp16 and the CUDA-core kernel in fp32."""
    lib, _ = paged._kernel_fn()
    code = paged.KERNEL_DTYPES[dtype]
    for sq, hq, hkv in ((1, 8, 2), (4, 8, 2), (2, 16, 2), (5, 8, 2),
                        (1, 32, 1), (40, 8, 2), (3, 6, 6)):
        x = _inputs(cuda, dtype, 1, 32)
        x["q"] = torch.zeros(B, sq, hq, 32, dtype=dtype, device=cuda)
        x["k_new"] = torch.zeros(B, sq, hkv, 32, dtype=dtype, device=cuda)
        x["v_new"] = torch.zeros_like(x["k_new"])
        x["k_pool"] = x["k_pool"][:, :, :1].expand(-1, -1, hkv, -1) \
            .contiguous()
        x["v_pool"] = x["k_pool"].clone()
        x["true_len"] = torch.full((B,), sq, dtype=torch.int32, device=cuda)
        plan = _plan(x)
        rows = sq * hq // hkv
        want = ("decode_split" if rows <= paged.SPLIT_ROWS else
                "cuda_cores" if dtype == torch.float32 else "prefill_wgmma")
        assert plan["variant"] == want
        assert paged.VARIANTS[lib.ds_paged_attention_variant(
            code, 32, sq, hq, hkv)] == want
        assert lib.ds_paged_attention_splits(code, 32, MAXB, BS) == \
            -(-MAXB * BS // paged.SPLIT_KEYS)
        if want == "decode_split":
            assert plan["splits"] == lib.ds_paged_attention_splits(
                code, 32, MAXB, BS)
        before = dict(paged.paged_attention_kernel.variant_launches)
        paged.paged_attention_kernel(*x.values())
        torch.cuda.synchronize()
        assert paged.paged_attention_kernel.variant == want
        assert (paged.paged_attention_kernel.variant_launches[want]
                == before.get(want, 0) + 1)
    for which in (1, 2):
        size = lib.ds_paged_attention_smem(which, code, 0, 128)
        assert size > 0 if which == 2 or dtype != torch.float32 \
            else size == -1
    if dtype == torch.float16:            # the same budget as bf16's
        for which, pool, d in ((1, 0, 128), (1, 1, 64), (2, 2, 32)):
            assert lib.ds_paged_attention_smem(which, 2, pool, d) == \
                lib.ds_paged_attention_smem(which, 1, pool, d)


def _dead_poisoned(x, window):
    """The call's pools with NaN (inf in the scales) in every slot no row
    may read: past pos0, outside the table, older than the window of the
    row's first query; k_new/v_new NaN past true_len."""
    y = {k: v.clone() for k, v in x.items()}
    nb, bs = x["k_pool"].shape[:2]
    live = torch.zeros(nb, bs, dtype=torch.bool)
    tables = x["block_tables"].cpu()
    for b, (p0, tl) in enumerate(zip(x["pos0"].tolist(),
                                     x["true_len"].tolist())):
        if tl:
            lo = max(0, p0 - window + 1) if window else 0
            for kp in range(lo, min(p0, tables.shape[1] * bs)):
                blk = min(max(int(tables[b, kp // bs]), 0), nb - 1)
                live[blk, kp % bs] = True
        for name in ("k_new", "v_new"):
            y[name][b, tl:] = float("nan")
    dead = (~live).to(x["k_pool"].device)
    for name in ("k_pool", "v_pool"):
        if y[name].dtype == torch.float8_e4m3fn:       # 0x7f: e4m3 NaN
            y[name].view(torch.uint8)[dead] = 0x7F
        elif y[name].is_floating_point():
            y[name][dead] = float("nan")
    for name in ("k_scale", "v_scale"):
        if name in y:
            y[name][dead] = float("inf")
    return y


MIXED_TICK = dict(b=4, sq=96, pos0=[0, 150, 90, 33], true_len=[96, 1, 1, 0])


def _case(dev, dtype, b, sq, pos0, true_len, d=64, hq=8, hkv=2, bs=16,
          seed=0):
    rng = np.random.default_rng(seed)
    max_blocks = max(-(-(p + sq) // bs) for p in pos0) + 1
    nb = b * max_blocks + 5

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    tables = rng.permutation(nb)[:b * max_blocks].reshape(b, max_blocks)
    tables[0, -1] = nb + 3
    ints = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    return dict(q=f(b, sq, hq, d), k_new=f(b, sq, hkv, d),
                v_new=f(b, sq, hkv, d), k_pool=f(nb, bs, hkv, d),
                v_pool=f(nb, bs, hkv, d), block_tables=ints(tables),
                pos0=ints(pos0), true_len=ints(true_len))


PAGED_RERUN_CASES = {
    "decode_split": dict(b=3, sq=1, pos0=[300, 0, 129], true_len=[1, 1, 0]),
    "prefill_wgmma": dict(b=2, sq=80, pos0=[70, 0], true_len=[80, 61]),
    "mixed_tick": MIXED_TICK,
}


@pytest.mark.parametrize("pool", ["bf16", "int8_head", "fp8_token", "fp16",
                                  "fp16_int8_head", "fp16_fp8_token"])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("name", list(PAGED_RERUN_CASES))
def test_paged_kernels_rerun_bit_identical_and_never_read_dead_slots(
        cuda, name, window, pool):
    """Both new kernels, in bf16 and in fp16 (names starting fp16) over
    fp, int8 and fp8 pools: a rerun gives the same bits (no atomics), and
    NaN or inf in every dead pool slot and fresh row leaves the output
    bit-identical to the clean call's; the mixed tick (a 96-row chunk
    beside decode rows of true_len 1 and 0) against plain at the dtype's
    tolerance (bf16 3e-2, fp16 1e-2)."""
    dtype = torch.float16 if pool.startswith("fp16") else torch.bfloat16
    x = _case(cuda, dtype, **PAGED_RERUN_CASES[name])
    kw = {"window": window}
    if pool not in ("bf16", "fp16"):
        kv_dtype, gran = pool.split("_")[-2:]
        hs = x["k_pool"].shape[2] if gran == "head" else 1
        for p_, s_ in (("k_pool", "k_scale"), ("v_pool", "v_scale")):
            x[p_], kw[s_] = kv_quantize(x[p_], kv_dtype, hs)
    scales = {k: kw.pop(k) for k in ("k_scale", "v_scale") if k in kw}
    clean = paged.paged_attention_kernel(*x.values(), **kw, **scales)
    again = paged.paged_attention_kernel(*x.values(), **kw, **scales)
    want = "decode_split" if name == "decode_split" else "prefill_wgmma"
    assert paged.paged_attention_kernel.variant == want
    y = _dead_poisoned(dict(x, **scales), window)
    ys = {k: y.pop(k) for k in ("k_scale", "v_scale") if k in y}
    poisoned = paged.paged_attention_kernel(*y.values(), **kw, **ys)
    torch.cuda.synchronize()
    assert torch.isfinite(clean).all()
    assert torch.equal(clean, again)
    assert torch.equal(clean, poisoned)
    ref = paged.paged_attention_plain(*x.values(), **kw, **scales)
    torch.testing.assert_close(clean.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_paged_mixed_tick_and_context_lengths(cuda, dtype):
    """A mixed tick and contexts that end mid-split, mid-chunk and past
    several splits, with ALiBi, in every dtype against plain."""
    tol = TOL[dtype]
    for shape in (MIXED_TICK,
                  dict(b=3, sq=1, pos0=[127, 128, 1000], true_len=[1] * 3),
                  dict(b=2, sq=2, pos0=[255, 63], true_len=[2, 2])):
        x = _case(cuda, dtype, **shape, hq=16, hkv=2, d=128, bs=8, seed=2)
        kw = {"alibi_slopes": alibi_slopes(16, device=cuda)}
        got = paged.paged_attention_kernel(*x.values(), **kw)
        ref = paged.paged_attention_plain(*x.values(), **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


# the head dims of the model families past the powers of two (Phi-2 80,
# Phi-3-mini and GPT-NeoX-20B 96, GPT-J-6B 256): decode, prefill and a mixed
# tick, a window and ALiBi on the prefill
NEW_DIM_CASES = {
    "decode": dict(b=3, sq=1, pos0=[300, 0, 129], true_len=[1, 1, 0]),
    "decode_sq2_alibi": dict(b=2, sq=2, pos0=[255, 63], true_len=[2, 1]),
    "prefill_window_alibi": dict(b=2, sq=80, pos0=[70, 0],
                                 true_len=[80, 61]),
    "mixed_tick": MIXED_TICK,
}


@pytest.mark.parametrize("pool", ["fp", "int8_head", "fp8_token"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [80, 96, 256])
def test_paged_kernel_at_the_new_head_dims(cuda, d, dtype, pool):
    """D 80, 96 and 256 in every variant, dtype and pool: the kernel
    against plain at the dtype's tolerance, the variant and splits the
    plan and the C table name (fp32 at D 256 splits contexts in 64 keys),
    a bit-identical rerun, and NaN/inf in every dead slot left unread."""
    lib, _ = paged._kernel_fn()
    code = paged.KERNEL_DTYPES[dtype]
    assert lib.ds_paged_attention_split_keys(code, d) == \
        paged.split_keys(dtype, d) == (64 if dtype == torch.float32
                                       and d == 256 else 128)
    for name, shape in NEW_DIM_CASES.items():
        x = _case(cuda, dtype, **shape, d=d, hq=8, hkv=2, bs=16, seed=d)
        kw = {}
        if "window" in name:
            kw["window"] = 40
        if "alibi" in name:
            kw["alibi_slopes"] = alibi_slopes(8, device=cuda)
        scales = {}
        if pool != "fp":
            kv_dtype, gran = pool.split("_")
            hs = x["k_pool"].shape[2] if gran == "head" else 1
            for p_, s_ in (("k_pool", "k_scale"), ("v_pool", "v_scale")):
                x[p_], scales[s_] = kv_quantize(x[p_], kv_dtype, hs)
        plan = _plan(x)
        got = paged.paged_attention_kernel(*x.values(), **kw, **scales)
        again = paged.paged_attention_kernel(*x.values(), **kw, **scales)
        assert paged.paged_attention_kernel.variant == plan["variant"]
        if plan["variant"] == "decode_split":
            assert plan["splits"] == lib.ds_paged_attention_splits(
                code, d, *x["block_tables"].shape[1:], 16)
        y = _dead_poisoned(dict(x, **scales), kw.get("window"))
        ys = {k: y.pop(k) for k in ("k_scale", "v_scale") if k in y}
        poisoned = paged.paged_attention_kernel(*y.values(), **kw, **ys)
        ref = paged.paged_attention_plain(*x.values(), **kw, **scales)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, poisoned), name
        torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype], msg=name)


# families whose switches the paged path carries (window, ALiBi and an
# embedding norm, one kv head, parallel residual with one or two norms,
# partial rotary), widened to the new head dims where the preset has them
FAMILY_CASES = {"mistral": dict(sliding_window=6), "bloom": {},
                "falcon": {},
                "phi": dict(hidden_size=160, num_heads=2),       # D 80
                "gptneox": dict(hidden_size=192, num_heads=2),   # D 96
                "gptj": dict(hidden_size=512, num_heads=2)}      # D 256


@pytest.mark.parametrize("family", list(FAMILY_CASES))
def test_family_engine_on_the_card_matches_the_cpu(cuda, family):
    """build_engine for each family on the card against the CPU engine on
    the same weights (fp32, 2e-4), every layer of every dispatch on the
    kernel, and greedy generate() finishing every request."""
    cfg = dict(dtype="float32", kv_block_size=8, num_kv_blocks=64,
               max_chunk_size=16)
    over = FAMILY_CASES[family]
    cpu = build_engine(family, "tiny", cfg, device="cpu", **over)
    gpu = build_engine(family, "tiny", cfg, params=dict(cpu.model.params),
                       device=cuda, **over)
    prompts = [np.random.default_rng(s).integers(0, 512, n).tolist()
               for s, n in ((1, 11), (2, 40))]
    before = paged.paged_attention_kernel.launches
    got = gpu.put([0, 1], prompts)
    launched = paged.paged_attention_kernel.launches - before
    ref = cpu.put([0, 1], prompts)
    torch.testing.assert_close(got.cpu(), ref, atol=2e-4, rtol=2e-4)
    assert launched == (gpu.model.config.num_layers
                        * gpu.serving_stats["host_dispatches"])
    gpu.flush([0, 1])
    assert [len(o) for o in gpu.generate(prompts, max_new_tokens=6)] == \
        [6, 6]


def test_init_inference_on_the_card_matches_the_cpu(cuda):
    """The v1 engine on the card (GPT-J at D 256: partial rotary, one
    norm a layer on the norm kernel) against the CPU engine on the same
    weights: forward logits at 2e-4 and greedy tokens."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPTJ
    over = dict(hidden_size=512, num_heads=2)
    cpu = ds.init_inference(GPTJ(size="tiny", device="cpu", **over),
                            config={"dtype": "fp32", "max_out_tokens": 64})
    gpu = ds.init_inference(GPTJ(size="tiny", device=cuda, **over),
                            config={"dtype": "fp32", "max_out_tokens": 64},
                            params=dict(cpu.module.params))
    tokens = np.random.default_rng(4).integers(0, 512, (2, 9))
    torch.testing.assert_close(gpu.forward(tokens).cpu(),
                               cpu.forward(tokens), atol=2e-4, rtol=2e-4)
    assert torch.equal(gpu.generate(tokens, max_new_tokens=8).cpu(),
                       cpu.generate(tokens, max_new_tokens=8))


def test_paged_kernel_refuses_other_head_dims(cuda):
    """A head dim that is a multiple of 8 but none of the kernels' raises
    on the card, naming the dims and the ROADMAP item: no plain
    fallback."""
    for d in (8, 48, 112, 192):
        x = _case(cuda, torch.bfloat16, b=2, sq=1, pos0=[20, 3],
                  true_len=[1, 1], d=d)
        assert _plan(x)["variant"] is None
        with pytest.raises(ValueError, match="head_dim.*Slice C item 9"):
            paged.paged_attention_kernel(*x.values())


# ------------------------------------------------------- flash attention
FLASH_CASES = {                       # b, s, hq, hkv, d, causal, window
    "causal": (2, 256, 4, 4, 64, True, None),
    "full": (2, 192, 4, 4, 64, False, None),
    "gqa": (1, 256, 8, 2, 64, True, None),
    "window": (2, 320, 4, 2, 64, True, 100),
    "unaligned": (1, 1000, 2, 1, 64, True, None),
    "d32_unaligned_full": (2, 77, 4, 2, 32, False, None),
    "d128": (1, 384, 4, 2, 128, True, None),
    "d128_window": (1, 200, 2, 2, 128, True, 33),
    # the tensor-core kernels' tiling edges: 128-row q blocks of two 64-row
    # warpgroups, 64-key tiles (forward, dq), 128-key blocks (dk/dv)
    "s40_below_one_tile": (2, 40, 4, 2, 64, True, None),
    "s129_one_past_a_block": (1, 129, 4, 4, 64, True, None),
    "narrow_window_crosses_tiles": (1, 300, 4, 2, 64, True, 24),
    "d16": (2, 200, 4, 2, 16, True, None),
    "gqa_rep4_full": (1, 256, 8, 2, 64, False, None),
    # the model families' head dims: 80 (phi "2": five 16-wide atoms), 96
    # (phi3 "mini", gptneox "20b": three 32-wide atoms), 256 (gptj "6b":
    # 32-key dq stages, dk/dv blocks of 64 keys whose warpgroups split D)
    "d80": (2, 256, 4, 4, 80, True, None),
    "d80_gqa_unaligned": (1, 333, 8, 2, 80, True, None),
    "d80_full": (1, 150, 2, 2, 80, False, None),
    "d96_window": (2, 300, 4, 2, 96, True, 70),
    "d96_full_gqa": (1, 200, 4, 1, 96, False, None),
    "d256": (1, 320, 4, 4, 256, True, None),
    "d256_gqa_window": (1, 400, 4, 2, 256, True, 100),
    "d256_full_unaligned": (2, 77, 2, 1, 256, False, None),
    "d256_s129_rep4": (1, 129, 8, 2, 256, True, None),
}


def _qkv(dev, dtype, b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    return f(b, s, hq, d), f(b, s, hkv, d), f(b, s, hkv, d), f(b, s, hq, d)


def _rel(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


FLASH_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_flash_forward_matches_plain(cuda, dtype, case):
    b, s, hq, hkv, d, causal, window = FLASH_CASES[case]
    q, k, v, _ = _qkv(cuda, dtype, b, s, hq, hkv, d)
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                  window=window)
    assert o.dtype == dtype and o.shape == q.shape
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_flash_backward_matches_plain(cuda, dtype, case):
    """dq, dk, dv of the kernels against the plain backward (same rounding
    points) and, in fp32, against autograd through the plain forward;
    max|err| / max|ref| within the dtype's tolerance."""
    b, s, hq, hkv, d, causal, window = FLASH_CASES[case]
    q, k, v, do = _qkv(cuda, dtype, b, s, hq, hkv, d, seed=1)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                          window=window)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 2
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert _rel(g, r) < TOL[dtype], (name, _rel(g, r))
    if dtype == torch.float32:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, _ = fa.flash_attention_fwd_plain(*leaves, causal=causal,
                                              window=window)
        out.backward(do)
        for name, g, leaf in zip("qkv", got, leaves):
            assert _rel(g, leaf.grad) < TOL[dtype], (name, _rel(g, leaf.grad))


@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_flash_kernel_variant_by_dtype(cuda, dtype):
    """bf16 and fp16 take the tensor-core (wgmma) kernels, fp32 the exact
    CUDA-core ones: the C entry points' table, the wrapper's table and the
    launches agree."""
    want = "cuda_cores" if dtype == torch.float32 else "wgmma"
    lib = fa._kernel()
    for d in fa.KERNEL_DIMS:
        assert fa.kernel_variant(dtype, d) == want
        code = lib.ds_flash_attention_variant(fa._KERNEL_DTYPES[dtype], d)
        assert fa.VARIANTS[code] == want
        assert lib.ds_flash_attention_smem(2, fa._KERNEL_DTYPES[dtype],
                                           d) > 0
    q, k, v, do = _qkv(cuda, dtype, 1, 96, 2, 2, 64)
    fwd_before = dict(fa.flash_attention_fwd.variant_launches)
    bwd_before = dict(fa.flash_attention_bwd.variant_launches)
    o, lse = fa.flash_attention_fwd(q, k, v)
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.variant == want
    assert fa.flash_attention_bwd.variant == want
    assert (fa.flash_attention_fwd.variant_launches[want]
            == fwd_before.get(want, 0) + 1)
    assert (fa.flash_attention_bwd.variant_launches[want]
            == bwd_before.get(want, 0) + 2)


@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_flash_kernels_are_deterministic(cuda, dtype):
    """No atomics: two forward calls give the same o and lse, two backward
    calls the same dq, dk, dv, bit for bit (a remat recompute relies on
    it)."""
    q, k, v, do = _qkv(cuda, dtype, 2, 700, 8, 2, 64, seed=4)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_attention_fwd(q, k, v, window=300)
        runs.append((o, lse, *fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                     window=300)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_takes_more_than_65535_batch_times_heads(cuda, dtype):
    """B x Hq = 65540 (past the old gridDim.y limit) with a short S."""
    q, k, v, do = _qkv(cuda, dtype, 16385, 8, 4, 2, 16, seed=5)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do)
    ref = fa.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    for name, g, r in zip("qkv", got, ref):
        assert _rel(g, r) < tol, (name, _rel(g, r))


def test_flash_autograd_on_the_card_matches_the_cpu(cuda):
    q, k, v, do = _qkv("cpu", torch.float32, 2, 130, 4, 2, 32, seed=2)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True, window=50)
        out.backward(do.to(dev))
        grads.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for g, r in zip(*grads[::-1]):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, _ = _qkv(cuda, torch.float32, 1, 64, 2, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               v[..., :48].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd(q, k.half(), v)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(1, 2), k, v)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(shifted, kb, vb)


# ------------------------------------------------------------ fused Adam
@pytest.mark.parametrize("adamw_mode", [True, False])
def test_fused_adam_matches_plain(cuda, adamw_mode):
    """Several flat sizes (odd, not multiples of 4 or 128), a schedule, a
    clip coefficient, a bf16 copy, 3 steps; then an overflow step
    (apply = 0) that must change nothing."""
    rng = np.random.default_rng(0)
    sched = lambda step: 1e-2 * torch.clamp(  # noqa: E731
        step.float() + 1, max=5) / 5
    for n in (1, 3, 127, 128, 1000, 4099):
        p0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
            cuda)
        runs = []
        for fused in (True, False):
            opt = Adam(sched, weight_decay=0.05, adamw_mode=adamw_mode,
                       fused=fused)
            p = p0.to(cuda)
            state = opt.init(p)
            out = torch.empty(n, dtype=torch.bfloat16, device=cuda)
            coef = torch.tensor(0.7, device=cuda)
            before = fused_adam_step.launches
            for _ in range(3):
                opt.step(state, p, g, coef=coef, out=out)
            assert fused_adam_step.launches == before + (3 if fused else 0)
            snapshot = [p.clone(), state["exp_avg"].clone(), out.clone()]
            opt.step(state, p, g * float("nan"), coef=coef, out=out,
                     apply=torch.tensor(0.0, device=cuda))
            torch.cuda.synchronize()
            for before_t, after_t in zip(snapshot, (p, state["exp_avg"],
                                                    out)):
                assert torch.equal(before_t, after_t)
            assert int(state["count"]) == 3
            runs.append((p, state["exp_avg"], state["exp_avg_sq"], out))
        for got, ref in zip(*runs):
            torch.testing.assert_close(got.float(), ref.float(), atol=1e-6,
                                       rtol=1e-5)


ADAM_SIZES = [1, 7, 8, 9, 4096 + 5, 2 ** 20 + 5, 3 * 2 ** 20 + 3]


@pytest.mark.parametrize("copy", [None, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("adamw_mode", [True, False])
def test_fused_adam_grid_and_copies_match_plain(cuda, adamw_mode, copy):
    """The persistent-grid kernel (8 values a thread, the n % 8 tail by
    the last CTA) against adam_plain over sizes 1 .. 3 * 2^20 + 3, AdamW
    and L2, without a copy and with a bf16 or fp16 copy (the kernel's
    own new p rounded once): bit for bit (the kernel rounds every product
    and sum on its own, in adam_plain's order), and so within 1e-6 + 1e-5
    relative; then an overflow step (apply = 0) leaves every buffer
    bit-identical."""
    from deepspeed_tpu_torch.ops.fused_optimizers import adam_plain
    rng = np.random.default_rng(1)
    hp = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 10.0, 1000.0, 0.7, 1.0],
                      device=cuda)
    kw = dict(weight_decay=0.05, adamw_mode=adamw_mode)
    for n in ADAM_SIZES:
        p, g, m, v = (torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(cuda) for _ in range(4))
        v = v.abs()
        runs = []
        for step in (fused_adam_step, adam_plain):
            bufs = [t.clone() for t in (p, m, v)]
            out = (None if copy is None
                   else torch.empty(n, dtype=copy, device=cuda))
            step(bufs[0], g, bufs[1], bufs[2], hp, out=out, **kw)
            runs.append((*bufs, out))
        torch.cuda.synchronize()
        (kp, km, kv, kout), (rp, rm, rv, rout) = runs
        for got, ref in ((kp, rp), (km, rm), (kv, rv)):
            torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-5)
            assert torch.equal(got, ref)
        if copy is not None:
            assert torch.equal(kout, kp.to(copy)) and torch.equal(kout, rout)
        snapshot = [t.clone() for t in (kp, km, kv)] + (
            [] if kout is None else [kout.clone()])
        skip = hp.clone()
        skip[7] = 0.0
        fused_adam_step(kp, g * float("nan"), km, kv, skip, out=kout, **kw)
        torch.cuda.synchronize()
        for before_t, after_t in zip(snapshot, [kp, km, kv] + (
                [] if kout is None else [kout])):
            assert torch.equal(before_t, after_t)


def test_fused_adam_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p = torch.zeros(16, device=cuda)
    hp = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_adam_step(p, p.half(), p, p, hp, weight_decay=0.0,
                        adamw_mode=True)
    with pytest.raises(ValueError, match="aligned"):
        fused_adam_step(p[1:], p[1:], p[1:], p[1:], hp, weight_decay=0.0,
                        adamw_mode=True)
    with pytest.raises(ValueError, match="hp"):
        fused_adam_step(p, p, p, p, hp[:6], weight_decay=0.0,
                        adamw_mode=True)
    out = torch.empty(17, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="out is not 16-byte aligned"):
        fused_adam_step(p, p, p, p, hp, weight_decay=0.0, adamw_mode=True,
                        out=out[1:])


# ------------------------------------------------------------ the engine
def test_training_engine_on_the_card_matches_the_cpu(cuda):
    """initialize(GPT-2 tiny, flash, segments, fused Adam, fp32, clip) on
    the card against the same engine on the CPU (plain versions) from the
    same weights: 3 steps, losses at 1e-4 relative (attention and GEMM
    sums in another order), params at 1e-3 of their total change (Adam
    amplifies sign flips of near-zero grads); one forward and one backward
    call per layer per step (no forward rerun), one Adam launch per step."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 1e-3, "weight_decay": 0.01, "fused_kernel": True}},
           "gradient_clipping": 0.5, "zero_optimization": {"stage": 2}}
    engines, init = [], None
    for dev in ("cpu", cuda):
        model = GPT2(size="tiny", device=dev, remat_policy="segments",
                     attn_impl="flash")
        eng, *_ = ds.initialize(model=model, config=cfg,
                                model_parameters=init)
        if init is None:
            init = {n: t.clone() for n, t in eng.master_state_dict().items()}
        engines.append(eng)
    tok = np.random.default_rng(0).integers(0, 512, (4, 129))
    batch = (tok[:, :-1], tok[:, 1:])
    counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.calls,
              fused_adam_step.launches)
    losses = [[float(e.train_batch(batch)) for _ in range(3)]
              for e in engines]
    torch.testing.assert_close(losses[1], losses[0], atol=0, rtol=1e-4)
    layers = engines[1].model_config.num_layers
    assert (fa.flash_attention_fwd.launches - counts[0],
            fa.flash_attention_bwd.calls - counts[1],
            fused_adam_step.launches - counts[2]) == (
        3 * 2 * layers, 3 * 2 * layers, 3)
    start = torch.cat([t.reshape(-1) for t in init.values()])
    cpu, gpu = (torch.cat([t.reshape(-1).cpu() for t in
                           e.master_state_dict().values()]) for e in engines)
    assert float((gpu - cpu).norm()) <= 1e-3 * float((cpu - start).norm())


# widened tiny presets at the families' head dims: (family, hidden size,
# q heads, kv heads)
WIDE_FAMILIES = {"phi": (160, 2, None), "phi3": (192, 2, None),
                 "gptj": (512, 2, None), "mistral": (160, 2, 1)}


@pytest.mark.parametrize("family", list(WIDE_FAMILIES))
def test_family_training_on_the_card_matches_the_cpu(cuda, family):
    """initialize(<family> tiny widened to head dims 80, 96 and 256, and
    Mistral at D 80 over S 96 past its window of 32; flash, segments,
    fused Adam, fp32, clip, ZeRO 2) on the card against the same engine
    on the CPU from the same weights, as
    test_training_engine_on_the_card_matches_the_cpu: 3 steps, losses at
    1e-4 relative, params at 1e-3 of their total change, one forward and
    one backward call per layer per step, every launch on the CUDA-core
    (fp32) kernels."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_class
    hidden, heads, kv = WIDE_FAMILIES[family]
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 1e-3, "weight_decay": 0.01, "fused_kernel": True}},
           "gradient_clipping": 0.5, "zero_optimization": {"stage": 2}}
    engines, init = [], None
    for dev in ("cpu", cuda):
        model = get_model_class(family)(
            size="tiny", device=dev, remat_policy="segments",
            attn_impl="flash", hidden_size=hidden, num_heads=heads,
            num_kv_heads=kv, intermediate_size=96)
        eng, *_ = ds.initialize(model=model, config=cfg,
                                model_parameters=init)
        if init is None:
            init = {n: t.clone() for n, t in eng.master_state_dict().items()}
        engines.append(eng)
    assert engines[1].model_config.head_dim == hidden // heads
    tok = np.random.default_rng(0).integers(0, 512, (4, 97))
    batch = (tok[:, :-1], tok[:, 1:])
    counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.calls,
              dict(fa.flash_attention_bwd.variant_launches))
    losses = [[float(e.train_batch(batch)) for _ in range(3)]
              for e in engines]
    torch.testing.assert_close(losses[1], losses[0], atol=0, rtol=1e-4)
    layers = engines[1].model_config.num_layers
    assert (fa.flash_attention_fwd.launches - counts[0],
            fa.flash_attention_bwd.calls - counts[1]) == (
        3 * 2 * layers, 3 * 2 * layers)
    assert (fa.flash_attention_bwd.variant_launches["cuda_cores"]
            - counts[2].get("cuda_cores", 0)) == 3 * 2 * 2 * layers
    start = torch.cat([t.reshape(-1) for t in init.values()])
    cpu, gpu = (torch.cat([t.reshape(-1).cpu() for t in
                           e.master_state_dict().values()]) for e in engines)
    assert float((gpu - cpu).norm()) <= 1e-3 * float((cpu - start).norm())


def test_training_engine_fp16_overflow_on_the_card(cuda):
    """fp16 on the card: the loss scale grows after good steps; a step
    with a non-finite grad leaves the master, the fp16 params and the
    step counter as they were (the kernel reads apply = 0) and halves
    the scale, without the host reading anything inside the step."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    eng, opt, _, _ = ds.initialize(
        model=GPT2(size="tiny", device=cuda, attn_impl="flash",
                   remat_policy="segments"),
        config={"train_batch_size": 4, "fp16": {
            "enabled": True, "initial_scale_power": 4,
            "loss_scale_window": 2, "hysteresis": 1},
            "optimizer": {"type": "FusedAdam", "params": {
                "lr": 1e-3, "fused_kernel": True}}})
    tok = np.random.default_rng(1).integers(0, 512, (4, 65))
    batch = (tok[:, :-1], tok[:, 1:])
    for _ in range(5):
        eng.train_batch(batch)
    grown = opt.loss_scale
    assert grown > 16.0
    with torch.no_grad():
        eng.module.params["final_norm/scale"][0] = float("inf")
    master = eng._master.clone()
    params = {n: p.clone() for n, p in eng.module.params.items()}
    eng.train_batch(batch)
    assert bool(eng._last_metrics["overflow"]) and eng.overflow_steps == 1
    assert torch.equal(eng._master, master)
    assert all(torch.equal(p, params[n])
               for n, p in eng.module.params.items())
    assert opt.loss_scale == grown / 2


# ------------------------------------------------------------ fused Lion
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_fused_lion_matches_plain(cuda, wd):
    """Sizes 1 to 2^16+5, a schedule, a clip coefficient, a bf16 copy, 3
    steps on fresh grads; then an overflow step (apply = 0) that must
    change nothing. The kernel rounds each product and sum on its own, as
    the plain version's separate passes do."""
    rng = np.random.default_rng(1)
    sched = lambda step: 1e-2 * torch.clamp(  # noqa: E731
        step.float() + 1, max=5) / 5
    for n in (1, 3, 127, 128, 1000, 4099, 2 ** 16 + 5):
        p0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        grads = [torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(cuda) for _ in range(3)]
        runs = []
        for fused in (True, False):
            opt = Lion(sched, weight_decay=wd, fused=fused)
            p = p0.to(cuda)
            state = opt.init(p)
            out = torch.empty(n, dtype=torch.bfloat16, device=cuda)
            coef = torch.tensor(0.7, device=cuda)
            before = fused_lion_step.launches
            for g in grads:
                opt.step(state, p, g, coef=coef, out=out)
            assert fused_lion_step.launches == before + (3 if fused else 0)
            snapshot = [p.clone(), state["exp_avg"].clone(), out.clone()]
            opt.step(state, p, grads[0] * float("nan"), coef=coef, out=out,
                     apply=torch.tensor(0.0, device=cuda))
            torch.cuda.synchronize()
            for before_t, after_t in zip(snapshot, (p, state["exp_avg"],
                                                    out)):
                assert torch.equal(before_t, after_t)
            assert int(state["count"]) == 3
            assert torch.equal(out, p.to(torch.bfloat16))
            runs.append((p, state["exp_avg"], out))
        for got, ref in zip(*runs):
            torch.testing.assert_close(got.float(), ref.float(), atol=1e-6,
                                       rtol=1e-5)


def test_fused_lion_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p = torch.zeros(16, device=cuda)
    hp = torch.ones(5, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_lion_step(p, p.half(), p, hp, weight_decay=0.0)
    with pytest.raises(ValueError, match="aligned"):
        fused_lion_step(p[1:], p[1:], p[1:], hp, weight_decay=0.0)
    with pytest.raises(ValueError, match="hp"):
        fused_lion_step(p, p, p, torch.ones(8, device=cuda),
                        weight_decay=0.0)


# ---------------------------------------------------- block-sparse attention
class _DeadRow:
    """A block-diagonal layout (block 16) whose q block 1 sees no block
    and whose q block 3 also sees block 0."""

    def __init__(self, num_heads):
        self.num_heads = num_heads

    def make_layout(self, seq_len):
        layout = np.eye(seq_len // 16, dtype=bool)[None].repeat(
            self.num_heads, 0)
        layout[:, 1, :] = False
        layout[:, 3, 0] = True
        return layout


SPARSE_CASES = {   # config, heads, seq, head_dim, batch
    "fixed_s256": (lambda h: tsa.FixedSparsityConfig(num_heads=h, block=16),
                   4, 256, 64, 2),
    "fixed_s1024_per_head": (lambda h: tsa.FixedSparsityConfig(
        num_heads=h, block=16, different_layout_per_head=True,
        num_local_blocks=4, num_different_global_patterns=4), 4, 1024, 64, 1),
    "bigbird_d32": (lambda h: tsa.BigBirdSparsityConfig(
        num_heads=h, block=32, num_random_blocks=2), 2, 512, 32, 2),
    "block8_d24": (lambda h: tsa.BSLongformerSparsityConfig(
        num_heads=h, block=8), 2, 256, 24, 1),
    "variable_d128_block64": (lambda h: tsa.VariableSparsityConfig(
        num_heads=h, block=64, num_random_blocks=1), 2, 1024, 128, 1),
    # the tensor-core kernels' tile edges: 64-row groups of whole blocks,
    # 64-entry chunks of the stream
    "block48_pad_rows": (lambda h: tsa.FixedSparsityConfig(
        num_heads=h, block=48), 2, 768, 64, 1),
    "block128_split_tiles": (lambda h: tsa.BigBirdSparsityConfig(
        num_heads=h, block=128, num_random_blocks=1), 2, 2048, 64, 1),
    "block24_stream_ends_mid_chunk": (lambda h: tsa.FixedSparsityConfig(
        num_heads=h, block=24, num_local_blocks=3), 2, 480, 64, 2),
    "d40": (lambda h: tsa.FixedSparsityConfig(num_heads=h, block=16),
            2, 512, 40, 2),
    "dead_row": (lambda h: _DeadRow(h), 2, 128, 32, 2),
}


def _sparse_inputs(dev, dtype, b, h, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(4)]


@pytest.mark.parametrize("case", list(SPARSE_CASES))
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_block_sparse_kernels_match_plain(cuda, dtype, case):
    """Forward (o, lse) and backward (dq, dk, dv) kernels against their
    plain versions on the same inputs: max|err| / max|ref| within the
    dtype's tolerance, lse within 1e-5 relative; one forward and two
    backward launches per call. Block sizes 8 to 128 (48: pad rows in a
    tile group; 128: a block split into two tiles), head_dim 24 to 128, a
    stream that ends mid-chunk, a dead row."""
    make, h, s, d, b = SPARSE_CASES[case]
    layout = make(h).make_layout(s)
    maps = bsa.block_maps(layout, cuda, s // layout.shape[1])
    q, k, v, do = _sparse_inputs(cuda, dtype, b, h, s, d)
    counts = (bsa.block_sparse_attention_fwd.launches,
              bsa.block_sparse_attention_bwd.launches)
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, maps)
    o_ref, lse_ref = bsa.block_sparse_attention_fwd_plain(q, k, v, maps)
    grads = bsa.block_sparse_attention_bwd(q, k, v, o_ref, lse_ref, do, maps)
    refs = bsa.block_sparse_attention_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                                maps)
    torch.cuda.synchronize()
    assert (bsa.block_sparse_attention_fwd.launches - counts[0],
            bsa.block_sparse_attention_bwd.launches - counts[1]) == (1, 2)
    assert _rel(o, o_ref) < TOL[dtype], _rel(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    for name, g, r in zip("qkv", grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert _rel(g, r) < TOL[dtype], (name, _rel(g, r))


def test_block_sparse_dead_row_and_autograd_on_the_card(cuda):
    """A q block with no live block returns 0 and gets dq = 0 on the card;
    the autograd function on the card matches the same on the CPU (plain
    versions) in fp32 at 1e-4."""
    layout = np.eye(8, dtype=bool)[None].repeat(2, 0)
    layout[:, 1, :] = False
    layout[:, 3, 0] = True
    q, k, v, do = _sparse_inputs("cpu", torch.float32, 2, 2, 128, 32, 3)
    attn = bsa.make_block_sparse_attention(layout, 32)
    outs = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).clone().requires_grad_() for t in (q, k, v)]
        out = attn(*leaves)
        out.backward(do.to(dev))
        outs.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    assert torch.all(outs[1][0][:, :, 16:32] == 0)
    assert torch.all(outs[1][1][:, :, 16:32] == 0)
    for g, r in zip(outs[1], outs[0]):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


def test_sparse_self_attention_on_the_card(cuda):
    """SparseSelfAttention at S 256 and 1024 runs the kernels (one forward,
    two backward launches) and matches its dense fallback (fp32, 1e-4);
    with an attn_mask it takes the dense path and launches no kernel."""
    for s in (256, 1024):
        attn = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
            num_heads=4, block=16, num_local_blocks=4))
        q, k, v, do = _sparse_inputs(cuda, torch.float32, 2, 4, s, 64, 4)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        counts = (bsa.block_sparse_attention_fwd.launches,
                  bsa.block_sparse_attention_bwd.launches)
        out = attn(*leaves)
        out.backward(do)
        torch.cuda.synchronize()
        assert (bsa.block_sparse_attention_fwd.launches - counts[0],
                bsa.block_sparse_attention_bwd.launches - counts[1]) == (1, 2)
        dense = attn(q, k, v, attn_mask=torch.ones(s, s, device=cuda))
        torch.cuda.synchronize()
        assert (bsa.block_sparse_attention_fwd.launches - counts[0],
                bsa.block_sparse_attention_bwd.launches - counts[1]) == (1, 2)
        torch.testing.assert_close(out.detach(), dense, atol=1e-4, rtol=1e-4)


def test_block_sparse_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    layout = np.ones((2, 4, 4), bool)
    maps = bsa.block_maps(layout, cuda, 16)
    q, k, v, _ = _sparse_inputs(cuda, torch.float32, 1, 2, 64, 32)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(1, 2, 64, 160, device=cuda)
        bsa.block_sparse_attention_fwd(big, big, big, maps)
    with pytest.raises(ValueError, match="dtype"):
        bsa.block_sparse_attention_fwd(q, k.half(), v, maps)
    with pytest.raises(ValueError, match="contiguous"):
        bsa.block_sparse_attention_fwd(q.transpose(2, 3), k, v, maps)
    with pytest.raises(ValueError, match="layout"):
        bsa.block_sparse_attention_fwd(
            q, k, v, bsa.block_maps(np.ones((3, 4, 4), bool), cuda, 16))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="aligned"):
        bsa.block_sparse_attention_fwd(shifted, kb, vb, maps)
    o, lse = bsa.block_sparse_attention_fwd(qb, kb, vb, maps)
    with pytest.raises(ValueError, match="aligned"):
        bsa.block_sparse_attention_bwd(qb, kb, vb, o, lse, shifted, maps)


@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_block_sparse_kernel_variant_by_dtype(cuda, dtype):
    """bf16 and fp16 take the tensor-core (wgmma) kernels, fp32 the exact
    CUDA-core ones: the C entry points' table, the wrapper's table and the
    launches agree; a head dim no kernel takes is none in both tables."""
    want = "cuda_cores" if dtype == torch.float32 else "wgmma"
    code = bsa._KERNEL_DTYPES[dtype]
    lib = bsa._kernel()
    for d in (8, 16, 24, 40, 64, 128):
        assert bsa.kernel_variant(dtype, d) == want
        assert bsa.VARIANTS[lib.ds_block_sparse_attention_variant(code, d)] \
            == want
        for which in range(3):
            assert lib.ds_block_sparse_attention_smem(which, code, d) > 0
    for d in (0, 12, 136):
        assert bsa.kernel_variant(dtype, d) is None
        assert lib.ds_block_sparse_attention_variant(code, d) == -1
        assert lib.ds_block_sparse_attention_smem(0, code, d) == -1
    layout = tsa.FixedSparsityConfig(num_heads=2, block=16).make_layout(256)
    maps = bsa.block_maps(layout, cuda, 16)
    q, k, v, do = _sparse_inputs(cuda, dtype, 1, 2, 256, 64)
    fwd_before = dict(bsa.block_sparse_attention_fwd.variant_launches)
    bwd_before = dict(bsa.block_sparse_attention_bwd.variant_launches)
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, maps)
    bsa.block_sparse_attention_bwd(q, k, v, o, lse, do, maps)
    torch.cuda.synchronize()
    assert bsa.block_sparse_attention_fwd.variant == want
    assert bsa.block_sparse_attention_bwd.variant == want
    assert (bsa.block_sparse_attention_fwd.variant_launches[want]
            == fwd_before.get(want, 0) + 1)
    assert (bsa.block_sparse_attention_bwd.variant_launches[want]
            == bwd_before.get(want, 0) + 2)


@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_block_sparse_kernels_are_deterministic(cuda, dtype):
    """No atomics: every output row belongs to one tile group (one CTA),
    so two forward calls give the same o and lse and two backward calls
    the same dq, dk, dv, bit for bit."""
    layout = tsa.FixedSparsityConfig(
        num_heads=4, block=16, different_layout_per_head=True,
        num_local_blocks=4, num_different_global_patterns=4).make_layout(1024)
    maps = bsa.block_maps(layout, cuda, 16)
    q, k, v, do = _sparse_inputs(cuda, dtype, 2, 4, 1024, 64, seed=4)
    runs = []
    for _ in range(2):
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, maps)
        runs.append((o, lse, *bsa.block_sparse_attention_bwd(q, k, v, o, lse,
                                                             do, maps)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_takes_more_than_65535_batch_times_heads(cuda, dtype):
    """B x H = 65540 (past the old gridDim.y limit) with a short S."""
    layout = tsa.FixedSparsityConfig(num_heads=4, block=8,
                                     num_local_blocks=1).make_layout(16)
    maps = bsa.block_maps(layout, cuda, 8)
    q, k, v, do = _sparse_inputs(cuda, dtype, 16385, 4, 16, 16, seed=5)
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, maps)
    o_ref, lse_ref = bsa.block_sparse_attention_fwd_plain(q, k, v, maps)
    grads = bsa.block_sparse_attention_bwd(q, k, v, o_ref, lse_ref, do, maps)
    refs = bsa.block_sparse_attention_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                                maps)
    torch.cuda.synchronize()
    assert _rel(o, o_ref) < TOL[dtype], _rel(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    for name, g, r in zip("qkv", grads, refs):
        assert _rel(g, r) < TOL[dtype], (name, _rel(g, r))


# ------------------------------------------------------- the eager triple
def test_triple_with_fused_lion_and_loss_chunk_on_the_card(cuda):
    """engine(micro); engine.backward(loss); engine.step() with GA 2,
    fused Lion, loss_chunk and flash attention on the card against the
    same engine on the CPU (plain versions) from the same weights: 3
    steps, losses at 1e-4 relative; all but at most 1e-3 of the params
    within 1e-5 of the CPU's (Lion moves every element by lr * sign(.), so
    an element whose momentum is within rounding of 0 may step the other
    way under the card's summation order, 2 * lr apart); per step one Lion
    launch and one forward and one backward flash call per layer and
    micro-batch."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Llama
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Lion", "params": {
               "lr": 1e-3, "weight_decay": 0.01, "fused_kernel": True}},
           "gradient_clipping": 0.5, "zero_optimization": {"stage": 2}}
    engines, init = [], None
    for dev in ("cpu", cuda):
        model = Llama(size="tiny", device=dev, remat_policy="segments",
                      attn_impl="flash", loss_chunk=32)
        eng, *_ = ds.initialize(model=model, config=cfg,
                                model_parameters=init)
        if init is None:
            init = {n: t.clone() for n, t in eng.master_state_dict().items()}
        engines.append(eng)
    tok = np.random.default_rng(0).integers(0, 512, (4, 129))
    counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.calls,
              fused_lion_step.launches)
    losses = []
    for eng in engines:
        run = []
        for _ in range(3):
            for i in (0, 2):
                loss = eng((tok[i:i + 2, :-1], tok[i:i + 2, 1:]))
                eng.backward(loss)
                run.append(float(loss.detach()))
            eng.step()
        losses.append(run)
    torch.testing.assert_close(losses[1], losses[0], atol=0, rtol=1e-4)
    layers = engines[1].model_config.num_layers
    assert (fa.flash_attention_fwd.launches - counts[0],
            fa.flash_attention_bwd.calls - counts[1],
            fused_lion_step.launches - counts[2]) == (
        3 * 2 * layers, 3 * 2 * layers, 3)
    cpu, gpu = (torch.cat([t.reshape(-1).cpu() for t in
                           e.master_state_dict().values()]) for e in engines)
    assert float(((gpu - cpu).abs() > 1e-5).float().mean()) <= 1e-3


# ------------------------------------------- the ZeRO++ int8 wire kernels
QUANT_SIZES = [1, 100, 511, 512, 513, 4096 + 37, 3 * 2 ** 20 + 5]


@pytest.mark.parametrize("n", QUANT_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quantize_int8_kernels_match_plain_bit_for_bit(cuda, dtype, n):
    """csrc/quantize_int8.cu against its plain versions on the card: codes
    and scales bit for bit (fp32/bf16/fp16 input read in place, tail
    blocks zero-padded in registers, an all-zero block at scale 1e-12), and
    the dequantize into fp32/bf16/fp16 bit for bit (one rounded fp32
    product, stored once); one launch each."""
    from deepspeed_tpu_torch.ops import quantization as TQ
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=g) * torch.logspace(
        -3, 2, -(-n // 512)).repeat_interleave(512)[:n]
    if n > 1024:
        x[512:1024] = 0.0
    x = x.to(cuda, dtype)
    counts = (TQ.quantize_int8_kernel.launches,
              TQ.dequantize_int8_kernel.launches)
    q, s, meta = TQ.quantize_int8(x)
    pq, ps, _ = TQ.quantize_int8(x, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(q, pq) and torch.equal(s, ps)
    if n > 1024:
        assert float(s[1, 0]) == np.float32(1e-12) and not q[1].any()
    for out in (torch.float32, torch.bfloat16, torch.float16):
        got = TQ.dequantize_rows(q, s, 1, n, out)
        want = TQ.dequantize_rows(q, s, 1, n, out, use_kernel=False)
        assert got.dtype == out and torch.equal(got, want)
    assert TQ.dequantize_int8(q, s, meta).shape == x.shape
    assert (TQ.quantize_int8_kernel.launches - counts[0],
            TQ.dequantize_int8_kernel.launches - counts[1]) == (1, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_kernel_matches_plain(cuda, dtype):
    """qgZ's per-row form: [world, c] rows padded apart, c not a multiple
    of 512 (rows start unaligned, so the scalar path runs too)."""
    from deepspeed_tpu_torch.ops import quantization as TQ
    rows = torch.randn(4, 3 * 512 + 77, generator=torch.Generator(
        ).manual_seed(3)).to(cuda, dtype)
    q, s = TQ.quantize_rows(rows)
    pq, ps = TQ.quantize_rows(rows, use_kernel=False)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    got = TQ.dequantize_rows(q, s, 4, rows.shape[1], dtype)
    assert torch.equal(got, TQ.dequantize_rows(q, s, 4, rows.shape[1],
                                               dtype, use_kernel=False))


# rows x row_len, the element the input starts at in its storage, the
# variant quantize_plan picks: 1, 37 and 24576 blocks, several rows of
# whole blocks, qgZ rows of 1000 (ragged) and a start off 16 bytes
QUANT_VARIANT_CASES = {
    "1_block": (1, 512, 0, "bulk"),
    "37_blocks": (1, 37 * 512, 0, "bulk"),
    "24576_blocks": (1, 24576 * 512, 0, "bulk"),
    "rows_4x5_blocks": (4, 5 * 512, 0, "bulk"),
    "qgz_rows_3x1000": (3, 1000, 0, "ragged"),
    "37_blocks_misaligned": (1, 37 * 512, 1, "ragged"),
    "rows_2x24576_blocks_misaligned": (2, 24576 * 256, 3, "ragged"),
}


@pytest.mark.parametrize("case", list(QUANT_VARIANT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quantize_int8_variants_match_plain_bit_for_bit(cuda, dtype, case):
    """Each quantize variant against the plain version bit for bit, codes
    and scales; the variant launched is the host plan's and the C
    table's, counted by name; the dequantize of the codes unchanged and
    bit-equal."""
    import ctypes
    from deepspeed_tpu_torch.ops import quantization as TQ
    rows, row_len, offset, want = QUANT_VARIANT_CASES[case]
    g = torch.Generator().manual_seed(rows * row_len + offset)
    n = rows * row_len
    flat = torch.randn(n + offset, generator=g) * torch.logspace(
        -4, 3, 64)[torch.randint(0, 64, (n + offset,), generator=g)]
    flat[offset + 512:offset + 1024] = 0.0          # an all-zero block
    flat = flat.to(cuda, dtype)
    x = flat[offset:].view(rows, row_len)
    aligned = x.data_ptr() % 16 == 0
    assert TQ.quantize_plan(row_len, aligned) == want
    lib, fn = TQ._quant_fn("ds_quantize_int8_variant",
                           [ctypes.c_longlong, ctypes.c_int])
    assert TQ.QUANT_VARIANTS[fn(row_len, int(aligned))] == want
    before = dict(TQ.quantize_int8_kernel.variant_launches)
    q, s = TQ.quantize_rows(x)
    pq, ps = TQ.quantize_rows(x, use_kernel=False)
    torch.cuda.synchronize()
    assert TQ.quantize_int8_kernel.variant == want
    assert TQ.quantize_int8_kernel.variant_launches[want] == \
        before.get(want, 0) + 1
    assert torch.equal(q, pq) and torch.equal(s, ps)
    again, again_s = TQ.quantize_rows(x)
    assert torch.equal(again, q) and torch.equal(again_s, s)
    back = TQ.dequantize_rows(q, s, rows, row_len, dtype)
    assert torch.equal(back, TQ.dequantize_rows(q, s, rows, row_len, dtype,
                                                use_kernel=False))


@pytest.mark.parametrize("misaligned", [False, True])
def test_quantize_int8_nonfinite_blocks_match_the_cpu(cuda, misaligned):
    """Blocks holding NaN, inf or -inf (a gradient that overflowed): the
    scale is NaN or inf and every code of the block 0, as the plain
    version on the CPU gives (the Pallas kernel's codes, shown in
    tests/test_torch_quantize_int8.py); both variants."""
    from deepspeed_tpu_torch.ops import quantization as TQ
    x = torch.randn(8 * 512 + 1, generator=torch.Generator().manual_seed(9))
    x[1 + 5], x[1 + 512 + 7], x[1 + 1024 + 9] = (float("nan"), float("inf"),
                                                   -float("inf"))
    x[1 + 1536:1 + 2048] = float("nan")
    xc = x.to(cuda)
    q, s = TQ.quantize_rows((xc[1:] if misaligned else xc[:-1]).view(1, -1))
    assert TQ.quantize_int8_kernel.variant == ("ragged" if misaligned
                                               else "bulk")
    pq, ps = TQ.quantize_rows((x[1:] if misaligned else x[:-1]).view(1, -1),
                              use_kernel=False)
    assert torch.equal(q.cpu(), pq)
    np.testing.assert_array_equal(s.cpu().numpy(), ps.numpy())
    assert not q[:4].any()


def test_quantize_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from deepspeed_tpu_torch.ops import quantization as TQ
    with pytest.raises(ValueError, match="dtype"):
        TQ.quantize_int8_kernel(torch.zeros(2, 8, dtype=torch.float64,
                                            device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        TQ.quantize_int8_kernel(torch.zeros(8, 2, device=cuda).t())
    q, s = TQ.quantize_int8_kernel(torch.ones(1, 600, device=cuda))
    with pytest.raises(ValueError, match="codes"):
        TQ.dequantize_int8_kernel(q[:1], s, 1, 600, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        TQ.dequantize_int8_kernel(q, s, 1, 600, torch.int32)


def test_zero3_with_qwz_at_world_size_one_on_the_card(cuda):
    """At W = 1 on the card, stage 3 with qwZ and qgZ equals stage 0 bit
    for bit (nothing splits), with bf16 compute and fused Adam."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    runs = []
    tok = np.random.default_rng(0).integers(0, 512, (4, 65))
    for zero in ({"stage": 0}, {"stage": 3, "zero_quantized_weights": True,
                                "zero_quantized_gradients": True}):
        cfg = {"train_batch_size": 4, "bf16": {"enabled": True},
               "optimizer": {"type": "FusedAdam", "params": {
                   "lr": 1e-3, "fused_kernel": True}},
               "gradient_clipping": 1.0, "zero_optimization": zero}
        eng, *_ = ds.initialize(model=GPT2(size="tiny", device=cuda,
                                           attn_impl="flash"), config=cfg)
        losses = [float(eng.train_batch((tok[:, :-1], tok[:, 1:])))
                  for _ in range(3)]
        runs.append((losses, eng.master_state_dict()))
    assert runs[0][0] == runs[1][0]
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name


# the two-hop wire at GPT-2 125M's shapes over fsdp 2 x zps 2: leaf shape
# and the dim split; hop 1 quantizes [outer x inner, c] rows, hop 2 the
# [outer, c] partials (where they start off 16 bytes: the ragged variant)
TWO_HOP_CASES = {"embed_tokens": ((50304, 768), 0),
                 "layers_w_up": ((12, 768, 3072), 2)}


@pytest.mark.parametrize("case", list(TWO_HOP_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_hop_wire_kernels_match_plain_bit_for_bit(cuda, dtype, case):
    """The hierarchical qgZ's quantize and dequantize on the card at the
    two hops' shapes: hop 1's rows (JAX's moveaxis order) and hop 2's
    partials, summed from hop 1's dequantized codes, placed at a 16-byte
    boundary (bulk) and one element past it (ragged): codes, scales and
    dequantized values equal the plain versions bit for bit."""
    from deepspeed_tpu_torch.ops import quantization as TQ
    shape, dim = TWO_HOP_CASES[case]
    g = (torch.randn(shape, generator=torch.Generator().manual_seed(7))
         * 0.01).to(cuda, dtype)
    rows = g.movedim(dim, 0).reshape(4, -1)
    c = rows.shape[1]
    q, sc = TQ.quantize_rows(rows)
    pq, ps = TQ.quantize_rows(rows, use_kernel=False)
    assert torch.equal(q, pq) and torch.equal(sc, ps)
    deq = TQ.dequantize_rows(q, sc, 4, c, torch.float32)
    assert torch.equal(deq, TQ.dequantize_rows(q, sc, 4, c, torch.float32,
                                               use_kernel=False))
    partial = deq.view(2, 2, c).sum(dim=0)
    for skew, variant in ((0, "bulk"), (1, "ragged")):
        buf = torch.empty(2 * c + 4, device=cuda)
        part = buf[skew:skew + 2 * c].view(2, c)
        part.copy_(partial)
        q2, s2 = TQ.quantize_rows(part)
        assert TQ.quantize_int8_kernel.variant == variant
        pq2, ps2 = TQ.quantize_rows(part, use_kernel=False)
        assert torch.equal(q2, pq2) and torch.equal(s2, ps2)
        back = TQ.dequantize_rows(q2, s2, 2, c, torch.float32)
        assert torch.equal(back, TQ.dequantize_rows(
            q2, s2, 2, c, torch.float32, use_kernel=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp8_wire_round_trip_on_the_card(cuda, dtype):
    """The fp8 wire on CUDA tensors: codes (as bytes) and scales equal the
    CPU's bit for bit, the round trip too, and qwZ's gather at W = 1
    dequantizes the same values; torch ops, no int8 kernel launch."""
    from deepspeed_tpu_torch.ops import quantization as TQ
    x = (torch.randn(3, 5000, generator=torch.Generator().manual_seed(8))
         * torch.logspace(-4, 2, 5000)).to(dtype)
    launches = TQ.quantize_int8_kernel.launches
    q, sc, meta = TQ.quantize_fp8(x.to(cuda))
    pq, ps, pmeta = TQ.quantize_fp8(x)
    assert q.dtype == torch.float8_e4m3fn
    assert torch.equal(q.view(torch.uint8).cpu(), pq.view(torch.uint8))
    assert torch.equal(sc.cpu(), ps)
    back = TQ.dequantize_fp8(q, sc, meta)
    assert back.shape == x.shape and back.dtype == dtype
    assert torch.equal(back.cpu(), TQ.dequantize_fp8(pq, ps, pmeta))
    gathered = TQ.quantized_all_gather(x.to(cuda), 1, wire_dtype="fp8")
    assert torch.equal(gathered, back)
    assert TQ.quantize_int8_kernel.launches == launches


# ------------------------------------------------------------------ norms
NORM_DS = (64, 200, 768, 4096, 5120)
NORM_ROWS = 37                 # a multiple of no block or warp count
NORM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def norm_ulps(got, ref, dtype, bias=None) -> float:
    """max |got - ref| in units of ``dtype``'s spacing at |ref|, or at
    |bias| where that is larger: where a LayerNorm's bias add cancels the
    normalised term to near zero, two correct fp32 results that differ by
    a few 1e-7 of the terms (the row sums run in another order) are many
    spacings of the small result apart."""
    eps = torch.finfo(dtype).eps
    mag = ref.float().abs()
    if bias is not None:
        mag = torch.maximum(mag, bias.float().abs())
    mag = mag.clamp(min=torch.finfo(dtype).tiny)
    ulp = eps * torch.exp2(torch.floor(torch.log2(mag)))
    return float(((got.float() - ref.float()).abs() / ulp).max())


def _norm_inputs(dev, dtype, d, seed=0, rows=NORM_ROWS):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, d, generator=g) * 2 + 0.5).to(dev, dtype)
    scale = (torch.randn(d, generator=g) + 1).to(dev)
    bias = torch.randn(d, generator=g).to(dev)
    return x, scale, bias


@pytest.mark.parametrize("d", NORM_DS)
@pytest.mark.parametrize("dtype", NORM_DTYPES)
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_kernels_match_plain(cuda, kind, dtype, d):
    """Both norm kernels against their plain versions: fp32 at 1e-6 (plus
    two ulps relative: the row sums run in another order), bf16/fp16
    within one ulp of the plain result (taken at |bias| where that is
    larger, norm_ulps); params in fp32 and in x's dtype;
    a row-major and a transposed (non-contiguous) input. Every call
    launches the kernel once."""
    from deepspeed_tpu_torch.ops import layers as L
    from deepspeed_tpu_torch.ops import norms as N
    x, scale, bias = _norm_inputs(cuda, dtype, d)
    xt = x.t().contiguous().t()
    for pdtype in {torch.float32, dtype}:
        s, b = scale.to(pdtype), bias.to(pdtype)
        for inp in (x, xt):
            if kind == "rms":
                before = N.rms_norm_kernel.launches
                got = N.rms_norm_kernel(inp, s)
                ref = L.rms_norm(inp, s)
                assert N.rms_norm_kernel.launches == before + 1
            else:
                before = N.layer_norm_kernel.launches
                got = N.layer_norm_kernel(inp, s, b)
                ref = L.layer_norm(inp, s, b)
                assert N.layer_norm_kernel.launches == before + 1
            assert got.dtype == dtype and got.shape == inp.shape
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, rtol=2.4e-7, atol=1e-6)
            else:
                assert norm_ulps(got, ref, dtype,
                                 b if kind == "layer" else None) <= 1.0


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_functions_on_the_card(cuda, kind):
    """The autograd Functions on CUDA tensors: the kernel forward (one
    launch a call, none in backward) and the closed-form backward against
    plain autograd, fp32, grads at 1e-5; a large row mean (300) within
    the fp32 resolution of the mean; empty and 1-element rows."""
    from deepspeed_tpu_torch.ops import layers as L
    from deepspeed_tpu_torch.ops import norms as N
    x, scale, bias = _norm_inputs(cuda, torch.float32, 768, seed=1, rows=50)
    counter = N.rms_norm_kernel if kind == "rms" else N.layer_norm_kernel
    fn = ((lambda *a: N.rms_norm(a[0], a[1])) if kind == "rms" else
          (lambda *a: N.layer_norm(*a)))
    ref_fn = ((lambda *a: L.rms_norm(a[0], a[1])) if kind == "rms" else
              (lambda *a: L.layer_norm(*a)))
    g = torch.randn_like(x)
    grads = []
    for f in (fn, ref_fn):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        before = counter.launches
        f(*leaves).backward(g)
        assert counter.launches == before + (f is fn)
        grads.append([t.grad for t in leaves[:2 if kind == "rms" else 3]])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    big = (x + 300).double()
    s64, b64 = scale.double(), bias.double()
    if kind == "rms":
        want = big * torch.rsqrt(big.square().mean(-1, keepdim=True) + 1e-6)
        want = want * s64
    else:
        c = big - big.mean(-1, keepdim=True)
        want = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + 1e-5)
        want = want * s64 + b64
    got = fn(big.float(), scale, bias)
    assert float((got.double() - want).abs().max()) <= 5e-4
    for shape in ((0, 64), (5, 1)):
        e = torch.randn(shape, device=cuda)
        p = torch.ones(shape[1], device=cuda)
        torch.testing.assert_close(fn(e, p, p * 0), ref_fn(e, p, p * 0))


def test_norm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from deepspeed_tpu_torch.ops import norms as N
    x, scale, bias = _norm_inputs(cuda, torch.bfloat16, 64)
    for bad in (scale[:10], scale.cpu(), scale.to(torch.float16)):
        with pytest.raises(ValueError):
            N.rms_norm_kernel(x, bad)
    with pytest.raises(ValueError, match="dtypes differ"):
        N.layer_norm_kernel(x, scale, bias.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        N.rms_norm_kernel(x.to(torch.float64), scale.double())


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_models_run_the_norm_kernel_on_the_card(cuda, family):
    """A GPT-2/Llama forward on the card launches its norm kernel 2L + 1
    times, and none inside plain_norms(); the two forwards agree."""
    from deepspeed_tpu_torch.models import GPT2, Llama
    from deepspeed_tpu_torch.ops import norms as N
    model = (GPT2 if family == "gpt2" else Llama)(size="tiny", device=cuda)
    model.init_params(torch.Generator(device=cuda).manual_seed(0))
    counter = N.layer_norm_kernel if family == "gpt2" else N.rms_norm_kernel
    tokens = torch.arange(32, device=cuda).reshape(2, 16)
    out = []
    for plain in (False, True):
        before = counter.launches
        counter.variant_launches = {}
        with torch.no_grad(), N.plain_norms(plain):
            out.append(model.apply(tokens))
        assert counter.launches - before == (
            0 if plain else 2 * model.config.num_layers + 1)
        assert sum(counter.variant_launches.values()) == \
            counter.launches - before
        assert set(counter.variant_launches) <= NEW_NORM_VARIANTS
    torch.testing.assert_close(out[0], out[1], rtol=1e-4, atol=1e-4)


# every hidden width of the port's model configs (models/gpt2.py,
# models/llama.py)
MODEL_WIDTHS = (64, 768, 1024, 2048, 4096, 5120, 8192)
NEW_NORM_VARIANTS = {"warp_row", "cta_row"}


def _norm_run(kind, x, s, b):
    from deepspeed_tpu_torch.ops import norms as N
    counter = N.rms_norm_kernel if kind == "rms" else N.layer_norm_kernel
    before = counter.launches
    y = (N.rms_norm_kernel(x, s) if kind == "rms"
         else N.layer_norm_kernel(x, s, b))
    assert counter.launches == before + 1
    return y, counter.variant


def _assert_plain_close(kind, got, x, s, b):
    """fp32: within 1e-6 + 4 ulps of the larger of |ref| and, for
    LayerNorm, |ref - bias| (the normalised term before the bias add,
    which the add may cancel): at 24576 rows of up to 8192 the two sum
    each row in another order, so mean and rstd land a few ulps apart
    (so does the numpy emulation of the kernels' schedule against the
    plain version on the CPU at that size; 37 rows stay within
    test_norm_kernels_match_plain's 2). bf16/fp16: one ulp, norm_ulps."""
    from deepspeed_tpu_torch.ops import layers as L
    ref = L.rms_norm(x, s) if kind == "rms" else L.layer_norm(x, s, b)
    assert got.dtype == x.dtype and got.shape == x.shape
    if x.dtype == torch.float32:
        mag = ref.abs()
        if kind == "layer":
            mag = torch.maximum(mag, (ref - b.float()).abs())
        err = (got - ref).abs()
        assert bool((err <= 1e-6 + 4.8e-7 * mag).all()), float(err.max())
    else:
        assert norm_ulps(got, ref, x.dtype,
                         b if kind == "layer" else None) <= 1.0


@pytest.mark.parametrize("d", MODEL_WIDTHS)
@pytest.mark.parametrize("dtype", NORM_DTYPES)
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_row_variants_match_plain_and_the_plan(cuda, kind, dtype, d):
    """warp_row / cta_row at every model width, params in fp32 and in x's
    dtype, 1, 37 and 24576 rows: against plain (_assert_plain_close); the
    variant each launch took equals launch_plan's and the C table's
    (ds_norm_variant, ds_norm_plan: warps, vectors, threads, and the grid
    min(row groups, slots)); a rerun is bit-identical."""
    from deepspeed_tpu_torch.ops import norms as N
    g = torch.Generator(device=cuda).manual_seed(d)
    scale = torch.randn(d, generator=g, device=cuda) + 1
    bias = torch.randn(d, generator=g, device=cuda)
    for rows in (1, 37, 24576):
        x = (torch.randn(rows, d, generator=g, device=cuda) * 2
             + 0.5).to(dtype)
        for pdtype in dict.fromkeys((torch.float32, dtype)):
            slots = N.kernel_plan(kind, 1 << 40, d, dtype, pdtype)["grid"]
            s, b = scale.to(pdtype), bias.to(pdtype)
            got, variant = _norm_run(kind, x, s, b)
            plan = N.launch_plan(kind, rows, d, dtype, pdtype, slots=slots)
            c_plan = N.kernel_plan(kind, rows, d, dtype, pdtype)
            assert variant == plan["variant"] == c_plan["variant"]
            assert variant in NEW_NORM_VARIANTS
            assert {k: plan[k] for k in c_plan} == c_plan
            _assert_plain_close(kind, got, x, s, b)
            again, _ = _norm_run(kind, x, s, b)
            assert torch.equal(got, again)
            del got, again


@pytest.mark.parametrize("d", [512, 768, 4096])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_rows_keep_nan_and_inf_in_their_row(cuda, kind, d):
    """A row of NaN and a row with an inf between finite rows (fp32 at 512:
    warp_row; 768 and 4096: cta_row with 2 and 8 warps; and bf16) leave
    every other row bit-equal to a run without them."""
    from deepspeed_tpu_torch.ops import norms as N
    for dtype in (torch.float32, torch.bfloat16):
        x, scale, bias = _norm_inputs(cuda, dtype, d, seed=3, rows=37)
        bad = x.clone()
        bad[5] = float("nan")
        bad[20, d // 3] = float("inf")
        clean, v1 = _norm_run(kind, x, scale, bias)
        dirty, v2 = _norm_run(kind, bad, scale, bias)
        assert v1 == v2 and v1 in NEW_NORM_VARIANTS
        keep = [r for r in range(37) if r not in (5, 20)]
        assert torch.equal(clean[keep], dirty[keep])
        assert bool(dirty[5].isnan().all())
        assert not bool(dirty[20].isfinite().all())


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_misaligned_and_odd_rows_take_general(cuda, kind):
    """x one element past a 16-byte boundary (a view with a storage offset
    of one) and an odd d (201) take general and match plain; the same
    values aligned take the row kernels and agree with general within the
    plain bound."""
    from deepspeed_tpu_torch.ops import norms as N
    for dtype in NORM_DTYPES:
        for d in (768, 4096):
            x, scale, bias = _norm_inputs(cuda, dtype, d, seed=4, rows=37)
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
            off = buf[1:].view(37, d)
            off.copy_(x)
            assert off.is_contiguous() and off.data_ptr() % 16 != 0
            got, variant = _norm_run(kind, off, scale, bias)
            assert variant == "general" == N.launch_plan(
                kind, 37, d, dtype, torch.float32, aligned=False)["variant"]
            assert N.kernel_plan(kind, 37, d, dtype, torch.float32,
                                 aligned=False)["variant"] == "general"
            _assert_plain_close(kind, got, off, scale, bias)
            _, aligned_variant = _norm_run(kind, x, scale, bias)
            assert aligned_variant in NEW_NORM_VARIANTS
        x, scale, bias = _norm_inputs(cuda, dtype, 201, seed=5, rows=37)
        got, variant = _norm_run(kind, x, scale, bias)
        assert variant == "general"
        _assert_plain_close(kind, got, x, scale, bias)


@pytest.mark.parametrize("d", [512, 768, 4096])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_function_grads_through_the_row_kernels(cuda, kind, d):
    """The autograd Functions with a row kernel's forward (fp32: warp_row
    at 512, cta_row at 768 and 4096) against plain autograd: output at the
    plain bound, grads at 1e-5, as test_norm_functions_on_the_card."""
    from deepspeed_tpu_torch.ops import layers as L
    from deepspeed_tpu_torch.ops import norms as N
    x, scale, bias = _norm_inputs(cuda, torch.float32, d, seed=6, rows=50)
    counter = N.rms_norm_kernel if kind == "rms" else N.layer_norm_kernel
    g = torch.randn_like(x)
    outs, grads = [], []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        before = counter.launches
        with N.plain_norms(plain):
            y = (N.rms_norm(leaves[0], leaves[1]) if kind == "rms"
                 else N.layer_norm(*leaves))
        y.backward(g)
        assert counter.launches == before + (not plain)
        if not plain:
            assert counter.variant in NEW_NORM_VARIANTS
        outs.append(y.detach())
        grads.append([t.grad for t in leaves[:2 if kind == "rms" else 3]])
    torch.testing.assert_close(outs[0], outs[1], rtol=2.4e-7, atol=1e-6)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# the fused decode loop as CUDA graphs (inference/v2/fused_graph.py)
# ---------------------------------------------------------------------

FUSED_CFG = dict(dtype="float32", kv_block_size=8, num_kv_blocks=64,
                 max_chunk_size=16)
FUSED_PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [6, 7, 8, 9, 10, 11]]
FUSED_SAMPLING = dict(temperature=0.9, top_k=50, top_p=0.9)


def _fused_engines(cuda, n=1, **over):
    """A CPU engine and ``n`` card engines on its (seeded) weights."""
    cfg = dict(FUSED_CFG, **over)
    cpu = build_engine("llama", "tiny", cfg, device="cpu")
    gpus = [build_engine("llama", "tiny", cfg, device=cuda)
            for _ in range(n)]
    with torch.no_grad():
        for gpu in gpus:
            for name, p in cpu.model.params.items():
                gpu.model.params[name].copy_(p)
    return cpu, gpus


def _at_dispatch_state(engine, uids, prompts):
    logits = engine.put(uids, prompts)
    for u, t in zip(uids, logits.float().argmax(-1).tolist()):
        engine.state_manager.extend(u, [t])


def test_fused_graph_replay_matches_eager_bit_for_bit(cuda):
    """One captured dispatch against the same ticks run eagerly on the
    same operands and pools (sampling on, a budget that ends a row inside
    the dispatch, a pad row): tokens, steps, carry, pools and the last
    tick's logits equal bit for bit."""
    _, (gpu,) = _fused_engines(cuda)
    uids = [0, 1, 2]
    _at_dispatch_state(gpu, uids, FUSED_PROMPTS)
    state = gpu._fused_operands(uids, 5, {0: 5, 1: 2, 2: 5}, 13)
    ops0 = {n: t.clone() for n, t in state.operands().items()}
    pools0 = {n: t.clone() for n, t in gpu.pools.items()}
    fn = gpu._fused_fn(state, 5, *FUSED_SAMPLING.values(), None)
    toks_g, steps_g = fn().read()
    graph = {n: t.clone() for n, t in state.operands().items()}
    logits_g = state.logits.clone()
    pools_g = {n: t.clone() for n, t in gpu.pools.items()}
    for n, t in gpu.pools.items():
        t.copy_(pools0[n])
    for n, t in state.operands().items():
        t.copy_(ops0[n])
    gpu._fused_eager(state, 5, eos_id=None, **FUSED_SAMPLING)
    torch.cuda.synchronize()
    assert (toks_g == state.out[:, :5].cpu().numpy()).all()
    assert steps_g == int(state.steps) == 5
    assert (toks_g[1, 2:] == -1).all() and (toks_g[3] == -1).all()
    for n, t in state.operands().items():
        assert torch.equal(t, graph[n]), n
    for n, t in gpu.pools.items():
        assert torch.equal(t, pools_g[n]), n
    assert torch.equal(state.logits, logits_g)


def test_fused_launch_counts_include_replays(cuda):
    """A wrapper counts its launches in Python, so only at capture; the
    engine adds a graph's counts at each replay: paged launches
    L x ticks, all decode_split, norms (2L + 1) x ticks."""
    from deepspeed_tpu_torch.ops import norms as N
    _, (gpu,) = _fused_engines(cuda)
    layers = gpu.model.config.num_layers
    _at_dispatch_state(gpu, [0, 1], FUSED_PROMPTS[:2])
    state = gpu._fused_operands([0, 1], 3, {0: 12, 1: 12}, 0)
    before = (paged.paged_attention_kernel.launches,
              dict(paged.paged_attention_kernel.variant_launches),
              N.rms_norm_kernel.launches)
    fn = gpu._fused_fn(state, 3, 0.0, 0, 0.0, None)
    # the capture's warm-up tick launches eagerly; the capture counts none
    warm = (paged.paged_attention_kernel.launches - before[0],
            N.rms_norm_kernel.launches - before[2])
    assert warm == (layers, 2 * layers + 1)
    for _ in range(3):
        fn().read()
    paged_n = paged.paged_attention_kernel.launches - before[0] - warm[0]
    assert paged_n == 3 * 3 * layers
    by = paged.paged_attention_kernel.variant_launches
    assert by["decode_split"] - before[1].get("decode_split", 0) \
        == paged_n + warm[0]
    assert set(by) - set(before[1]) <= {"decode_split"}
    assert N.rms_norm_kernel.launches - before[2] - warm[1] \
        == 3 * 3 * (2 * layers + 1)
    assert gpu.graph_captures[-1]["launches_per_replay"][
        "paged_attention_kernel"] == 3 * layers


def test_threefry_on_the_card_matches_the_cpu(cuda):
    """Keys, bits and uniforms bit for bit (integer arithmetic); gumbel
    noise within 4 ulps of max(|g|, 1) (each side's log within an ulp)."""
    from deepspeed_tpu_torch.ops import threefry
    keys = threefry.fold_in(threefry.prng_key(13), torch.arange(8))
    pos = torch.arange(8) * 977 + 5
    for f in (lambda k, p: threefry.fold_in(k, p),
              lambda k, p: threefry.random_bits(threefry.fold_in(k, p),
                                                4099),
              lambda k, p: threefry.uniform(threefry.fold_in(k, p), 4099)):
        assert torch.equal(f(keys, pos), f(keys.to(cuda), pos.to(cuda)).cpu())
    g_cpu = threefry.gumbel(keys, 4099).double()
    g_gpu = threefry.gumbel(keys.to(cuda), 4099).cpu().double()
    ulp = torch.from_numpy(np.spacing(np.maximum(
        g_cpu.abs().numpy(), 1).astype(np.float32))).double()
    assert ((g_gpu - g_cpu).abs() / ulp).max() <= 4


def test_chained_dispatch_equals_two_separate_dispatches(cuda):
    """Two dispatches chained on the carry (both in flight, no host read
    between them: max_inflight_dispatches 2) give the tokens of two
    decode_fused calls, each built from the host state, sampling on."""
    _, (a, b) = _fused_engines(cuda, n=2)
    uids = [0, 1, 2]
    for e in (a, b):
        _at_dispatch_state(e, uids, FUSED_PROMPTS)
    budgets = {u: 8 for u in uids}
    for u in uids:             # both dispatches' blocks, as admission does
        a.state_manager.reserve(u, 8)
    state = a._fused_operands(uids, 4, budgets, 13)
    fn = a._fused_fn(state, 4, *FUSED_SAMPLING.values(), None)
    first, second = fn(), fn()
    chained = np.concatenate([first.read()[0], second.read()[0]], 1)
    sep = [b.decode_fused(uids, 4, seed=13, **FUSED_SAMPLING)
           for _ in range(2)]
    for i, u in enumerate(uids):
        assert chained[i].tolist() == sep[0][u] + sep[1][u]


def test_fused_generate_on_the_card_matches_per_tick_and_cpu(cuda):
    """generate_fused on the card (graphs) gives the per-tick generate()'s
    greedy tokens and the CPU engine's fused tokens, greedy and sampled,
    with the JAX gate of <= 0.25 dispatches a token; k 2 and k 4 sample
    the same tokens."""
    cpu, (gpu,) = _fused_engines(cuda)
    ref = gpu.generate(FUSED_PROMPTS, max_new_tokens=10)
    gpu.reset_serving_metrics()
    got = gpu.generate_fused(FUSED_PROMPTS, max_new_tokens=10, k_steps=3)
    assert got == ref == cpu.generate_fused(FUSED_PROMPTS, 10, k_steps=3)
    assert gpu.serving_metrics()["dispatches_per_token"] <= 0.25
    kw = dict(max_new_tokens=8, seed=13, **FUSED_SAMPLING)
    a = gpu.generate_fused(FUSED_PROMPTS, k_steps=2, **kw)
    assert a == gpu.generate_fused(FUSED_PROMPTS, k_steps=4, **kw)
    assert a == cpu.generate_fused(FUSED_PROMPTS, k_steps=2, **kw)
    assert gpu.free_blocks == FUSED_CFG["num_kv_blocks"]


# ---------------------------------------------------------------------
# speculative decoding and ring mode as CUDA graphs
# ---------------------------------------------------------------------

# the verify forward's shape on Llama-3-8B: S_new = 1 + draft_len (3) a
# row, rows = 4 x 32 / 8 = 16 (decode_split), true_len ragged in one call;
# contexts mid-block, empty and past several 128-key splits
VERIFY = dict(b=8, sq=4, hq=32, hkv=8, d=128, bs=64,
              pos0=[37, 0, 200, 129, 63, 1000, 511, 64],
              true_len=[4, 1, 3, 0, 2, 4, 1, 4])
SPEC_CFG = {"enabled": True, "draft_len": 3, "min_ngram": 2,
            "history_window": 64}
# the tiny llama's greedy continuation of [1, 2, 3] * 6 repeats itself
# (see _looping), so drafts land
SPEC_PROMPTS = [[1, 2, 3] * 6, [9, 8, 7], [6, 7, 8, 9, 10, 11]]


@pytest.mark.parametrize("pool", ["fp", "int8_head", "fp8_token"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_paged_kernel_at_the_verify_shape(cuda, dtype, pool):
    """The paged kernel at the speculative verify's shape (B 8, S_new 4,
    Hq 32, Hkv 8, D 128, true_len [4, 1, 3, 0, 2, 4, 1, 4]): decode_split,
    causal inside the fresh chunk, rows past true_len zero, a rerun bit
    for bit, against plain at the dtype's tolerance over fp, int8 and fp8
    pools."""
    x = _case(cuda, dtype, **VERIFY)
    assert _plan(x)["variant"] == "decode_split"
    scales = {}
    if pool != "fp":
        kv_dtype, gran = pool.split("_")
        hs = x["k_pool"].shape[2] if gran == "head" else 1
        for p_, s_ in (("k_pool", "k_scale"), ("v_pool", "v_scale")):
            x[p_], scales[s_] = kv_quantize(x[p_], kv_dtype, hs)
    got = paged.paged_attention_kernel(*x.values(), **scales)
    again = paged.paged_attention_kernel(*x.values(), **scales)
    assert paged.paged_attention_kernel.variant == "decode_split"
    ref = paged.paged_attention_plain(*x.values(), **scales)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for b, n in enumerate(VERIFY["true_len"]):
        assert not got[b, n:].any()
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _looping(engine, prompts, n=14):
    """``prompts`` followed by their first ``n`` greedy tokens: the tiny
    model's continuation then repeats what the history holds, so drafts
    land from the first tick."""
    gen = engine.generate(prompts, max_new_tokens=n)
    return [p + g for p, g in zip(prompts, gen)]


@pytest.mark.parametrize("sampled", [False, True])
def test_spec_graph_replay_matches_eager_bit_for_bit(cuda, sampled):
    """One captured speculative dispatch against the same ticks run
    eagerly on the same operands and pools (a budget that ends a row
    inside the dispatch, a pad row): tokens, pointers, steps, spec
    counters, carry, history and pools equal bit for bit."""
    cpu, (gpu,) = _fused_engines(cuda, speculative=SPEC_CFG)
    uids = [0, 1, 2]
    _at_dispatch_state(gpu, uids, _looping(cpu, SPEC_PROMPTS))
    sampling = (tuple(FUSED_SAMPLING.values()) if sampled
                else (0.0, 0, 0.0))
    state = gpu._spec_operands(uids, 4, {0: 16, 1: 3, 2: 16}, 13)
    before = {n: t.clone() for n, t in state.tensors().items()}
    pools0 = {n: t.clone() for n, t in gpu.pools.items()}
    result = gpu._spec_fn(state, 4, *sampling, None)()
    toks_g, steps_g = result.read()
    ptr_g, stats_g = result.spec()
    graph = {n: t.clone() for n, t in state.tensors().items()}
    pools_g = {n: t.clone() for n, t in gpu.pools.items()}
    for src, dst in ((pools0, gpu.pools), (before, state.tensors())):
        for n, t in dst.items():
            t.copy_(src[n])
    gpu._spec_eager(state, 4, eos_id=None, min_ngram=2,
                    **dict(zip(("temperature", "top_k", "top_p"), sampling)))
    torch.cuda.synchronize()
    width = 4 * 4
    assert (toks_g == state.out[:, :width].cpu().numpy()).all()
    assert steps_g == int(state.steps) == 4
    assert (ptr_g == state.out_ptr.cpu().numpy()).all() and ptr_g[1] == 3
    assert (stats_g == state.spec_stats.cpu().numpy()).all()
    assert (toks_g[3] == -1).all() and ptr_g[3] == 0
    if not sampled:
        assert stats_g[1] > 0 and ptr_g[0] > 4       # drafts landed
    for n, t in state.tensors().items():
        ref = graph[n][:, :width] if n == "out" else graph[n]
        got = t[:, :width] if n == "out" else t
        assert torch.equal(got, ref), n
    for n, t in gpu.pools.items():
        assert torch.equal(t, pools_g[n]), n


def _ring_chain_state(engine, cpu, spec: bool):
    """A ring-mode chain's state on ``engine``: rows 0 and 1 live (budgets
    2 and 9), uid 2 staged for row 0 and uid 3 for row 1."""
    from deepspeed_tpu_torch.inference.v2.serve_loop import (FusedServeLoop,
                                                             ServeRequest)
    prompts = _looping(cpu, SPEC_PROMPTS[:2]) + [[4, 5, 4, 5], [6, 7]]
    budgets = {0: 2, 1: 9, 2: 9, 3: 4}
    _at_dispatch_state(engine, list(budgets), prompts)
    for u, n in budgets.items():
        engine.state_manager.reserve(u, n)
    loop = FusedServeLoop(engine, k_steps=6)
    if not spec:
        loop.set_draft_len(0)
        loop._apply_pending_draft()
    loop.staged = {u: ServeRequest(uid=u, prompt=prompts[u],
                                   max_new_tokens=budgets[u])
                   for u in (2, 3)}
    return loop, loop._serve_operands([0, 1], {0: 2, 1: 9}, {0: 2, 1: 3})


@pytest.mark.parametrize("spec", [False, True])
def test_ring_graph_replay_matches_eager_bit_for_bit(cuda, spec):
    """One captured ring-mode dispatch (plain and speculative) against
    the same ticks run eagerly: the ring and its epochs (the trash column
    aside), pointers, steps, every carry and stage operand and the pools
    equal bit for bit; row 0's staged request took the row on the
    device (epoch 1), and the chain's one read says so."""
    cpu, (gpu,) = _fused_engines(cuda, fused_admission=True,
                                 max_ragged_sequence_count=2,
                                 speculative=SPEC_CFG)
    loop, state = _ring_chain_state(gpu, cpu, spec)
    before = {n: t.clone() for n, t in state.tensors().items()}
    pools0 = {n: t.clone() for n, t in gpu.pools.items()}
    loop.fn(state, 6, *FUSED_SAMPLING.values(), None)()
    graph = {n: t.clone() for n, t in state.tensors().items()}
    pools_g = {n: t.clone() for n, t in gpu.pools.items()}
    for src, dst in ((pools0, gpu.pools), (before, state.tensors())):
        for n, t in dst.items():
            t.copy_(src[n])
    kw = dict(eos_id=None, **FUSED_SAMPLING)
    if spec:
        kw["min_ngram"] = 2
    gpu._serve_eager(state, 6, **kw)
    torch.cuda.synchronize()
    for n, t in state.tensors().items():
        if n in ("ring", "ring_epochs"):
            t, graph[n] = t[:, :-1], graph[n][:, :-1]
        assert torch.equal(t, graph[n]), n
    for n, t in gpu.pools.items():
        assert torch.equal(t, pools_g[n]), n
    rd = state.read()
    assert rd["epoch"][0] == 1 and (rd["ring_epochs"][0] == 1).any()
    assert int(rd["chain_steps"]) == 6 and state.reads == 1


def test_spec_launch_counts_include_replays(cuda):
    """A spec graph's replays add their launches: paged L x ticks, all
    decode_split at the verify shape; norms (2L + 1) x ticks."""
    from deepspeed_tpu_torch.ops import norms as N
    cpu, (gpu,) = _fused_engines(cuda, speculative=SPEC_CFG)
    layers = gpu.model.config.num_layers
    _at_dispatch_state(gpu, [0, 1], _looping(cpu, SPEC_PROMPTS[:2]))
    state = gpu._spec_operands([0, 1], 3, {0: 40, 1: 40}, 0)
    fn = gpu._spec_fn(state, 3, 0.0, 0, 0.0, None)
    before = (paged.paged_attention_kernel.launches,
              dict(paged.paged_attention_kernel.variant_launches),
              N.rms_norm_kernel.launches)
    for _ in range(2):
        fn().read()
    by = paged.paged_attention_kernel.variant_launches
    assert paged.paged_attention_kernel.launches - before[0] == 2 * 3 * layers
    assert by["decode_split"] - before[1].get("decode_split", 0) \
        == 2 * 3 * layers
    assert N.rms_norm_kernel.launches - before[2] == 2 * 3 * (2 * layers + 1)
    cap = gpu.graph_captures[-1]
    assert cap["mode"] == "spec3" and cap["launches_by_variant"][
        "paged_attention_kernel"] == {"decode_split": 3 * layers}


def test_spec_and_ring_on_the_card_match_per_tick_and_the_cpu(cuda):
    """fp32: spec chain, ring and spec ring generate_fused on the card
    give the per-tick generate()'s greedy tokens and the CPU engines';
    sampled spec chain tokens equal the CPU's and plain chain's."""
    cpu, _ = _fused_engines(cuda)
    prompts = _looping(cpu, SPEC_PROMPTS)
    ref = cpu.generate(prompts, max_new_tokens=12)
    for over in (dict(speculative=SPEC_CFG), dict(fused_admission=True),
                 dict(fused_admission=True, speculative=SPEC_CFG)):
        cpu_m, (gpu,) = _fused_engines(cuda, **over)
        got = gpu.generate_fused(prompts, max_new_tokens=12, k_steps=3)
        assert got == ref == cpu_m.generate_fused(prompts, 12, k_steps=3)
        assert gpu.free_blocks == FUSED_CFG["num_kv_blocks"]
    kw = dict(max_new_tokens=8, seed=13, **FUSED_SAMPLING)
    cpu_s, (gpu,) = _fused_engines(cuda, speculative=SPEC_CFG)
    a = gpu.generate_fused(prompts, k_steps=2, **kw)
    assert a == cpu_s.generate_fused(prompts, k_steps=4, **kw)
    assert a == cpu.generate_fused(prompts, k_steps=2, **kw)


# ---------------------------------------------------------------------
# KV migration and the serving front end on the card
# ---------------------------------------------------------------------

MIGRATE_KV = {"bf16": ("bfloat16", {}), "fp16": ("float16", {}),
              "int8": ("bfloat16", {"enabled": True, "dtype": "int8",
                                    "grow_pool": False}),
              "fp8": ("bfloat16", {"enabled": True, "dtype": "fp8",
                                   "granularity": "token",
                                   "grow_pool": False})}
MIGRATE_PROMPT = list(range(3, 40))


def _migration_pair(cuda, pool):
    """Two card engines of one config over one model (the second shares
    the first's weights)."""
    from deepspeed_tpu_torch.inference.v2 import (
        InferenceEngineV2, RaggedInferenceEngineConfig)
    dtype, kv = MIGRATE_KV[pool]
    cfg = dict(FUSED_CFG, dtype=dtype, kv_cache=kv or {"enabled": False})
    a = build_engine("llama", "tiny", cfg, device=cuda)
    b = InferenceEngineV2(a.model, RaggedInferenceEngineConfig.from_dict(
        cfg), params=a.params)
    return a, b


def _serve_imported(engine, state, n):
    """The imported sequence continued alone by the serve loop (the
    loop generate_fused runs, so the same dispatch schedule)."""
    from deepspeed_tpu_torch.inference.v2.serve_loop import FusedServeLoop
    loop = FusedServeLoop(engine, strict=True)
    uid = loop.submit_imported(state, n, emit_carried=True)
    out = []
    while loop.has_work():
        for evt in loop.step():
            if evt.uid == uid:
                out.extend(evt.tokens)
    return out


@pytest.mark.parametrize("pool", list(MIGRATE_KV))
def test_kv_export_import_on_the_card(cuda, pool):
    """Export from card pools through pinned memory and import into
    another engine's: the importer's gathered blocks equal the payload bit
    for bit, its slabs keep their addresses, bytes a token equal
    kv_bytes_per_token, and the continuation equals the never-moved run
    token for token (one request alone: the same shapes, so the same
    kernels and GEMMs, bf16 too)."""
    a, b = _migration_pair(cuda, pool)
    ref = a.generate_fused([MIGRATE_PROMPT], max_new_tokens=12)[0]
    t0 = a.prefill_request(5, MIGRATE_PROMPT)
    st = a.export_request(5, n_generated=1)
    assert t0 == ref[0]
    assert all(t.device.type == "cpu" and t.is_pinned()
               for t in st.payload.values())
    assert st.bytes_per_token() == pytest.approx(a.kv_bytes_per_token())
    ptrs = {k: v.data_ptr() for k, v in b.pools.items()}
    assert b.import_request(5, st) == t0
    assert {k: v.data_ptr() for k, v in b.pools.items()} == ptrs
    blocks = torch.tensor(b.state_manager.seqs[5].blocks[:st.payload_blocks],
                          device=cuda)
    for k, v in b.pools.items():
        got = paged.indexable(v).index_select(1, blocks).cpu()
        assert torch.equal(got, paged.indexable(st.payload[k])), k
    b.flush(5)
    out = _serve_imported(b, st, 12)
    assert out == ref
    assert a.free_blocks == b.free_blocks == FUSED_CFG["num_kv_blocks"]


def test_import_into_a_captured_graph_decodes_the_imported_row(cuda):
    """The importer captures its bb = 1 graph first (a request of the same
    length), then imports and decodes through that graph: a pool rebound
    by the import would leave the graph reading the old tensor."""
    a, b = _migration_pair(cuda, "bf16")
    ref = a.generate_fused([MIGRATE_PROMPT], max_new_tokens=12)[0]
    warm = [t + 1 for t in MIGRATE_PROMPT]
    b.generate_fused([warm], max_new_tokens=12)
    graphs = len(b.graph_captures)
    a.prefill_request(6, MIGRATE_PROMPT)
    out = _serve_imported(b, a.export_request(6, n_generated=1), 12)
    assert out == ref
    assert len(b.graph_captures) == graphs      # replayed, not recaptured


def test_async_server_on_the_card_matches_generate_fused(cuda):
    """The async server's worker thread replays the engine's graphs on
    its own thread: the fp32 (TF32 off) streams equal generate_fused."""
    import asyncio
    from deepspeed_tpu_torch.serving import (AsyncInferenceServer,
                                             ServingConfig)
    _, (gpu,) = _fused_engines(cuda)
    ref = gpu.generate_fused(FUSED_PROMPTS, max_new_tokens=10, k_steps=3)

    async def main():
        async with AsyncInferenceServer(gpu, ServingConfig(k_steps=3)) as s:
            hs = [await s.submit(p, max_new_tokens=10)
                  for p in FUSED_PROMPTS]
            return [await h.tokens() for h in hs]

    assert asyncio.run(main()) == ref
    assert gpu.free_blocks == FUSED_CFG["num_kv_blocks"]


def test_prefill_engine_handoff_on_the_card_matches_colocated(cuda):
    """A PrefillEngine on a thread of its own prefills and exports on the
    card; the router imports into the decode replica, whose stream equals
    the co-located generate_fused in fp32 (TF32 off)."""
    import asyncio
    from deepspeed_tpu_torch.serving import (AsyncInferenceServer,
                                             InferenceRouter, PrefillEngine,
                                             ServingConfig)
    _, (pre, dec) = _fused_engines(cuda, n=2)
    refs = [dec.generate_fused([p], max_new_tokens=10, k_steps=3)[0]
            for p in FUSED_PROMPTS]

    async def main():
        router = InferenceRouter(
            [AsyncInferenceServer(dec, ServingConfig(k_steps=3))],
            {"disaggregation": {"enabled": True}},
            prefill=PrefillEngine(pre))
        async with router:
            hs = [await router.submit(p, max_new_tokens=10)
                  for p in FUSED_PROMPTS]
            return [await h.tokens() for h in hs], router.metrics()

    outs, m = asyncio.run(main())
    assert outs == refs
    assert m["prefill_handoffs"] == 3 and m["replicas"]["replica0"][
        "imports"] == 3
    assert pre.free_blocks == dec.free_blocks == FUSED_CFG["num_kv_blocks"]


# ------------------------------- linear/: weight-only int8 and LoRA
@pytest.mark.parametrize("case", list(QUANT_VARIANT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quantize_int8_exact_mode_matches_plain_bit_for_bit(cuda, dtype,
                                                            case):
    """The exact-division mode (scale = amax / 127, LoRA's frozen base) of
    each quantize variant against the plain version bit for bit, on the
    card and on the CPU; counted as exact; the wire's mode on the same
    input stays the reciprocal product (a block whose absmax makes the
    two differ is planted)."""
    from deepspeed_tpu_torch.ops import quantization as TQ
    rows, row_len, offset, want = QUANT_VARIANT_CASES[case]
    g = torch.Generator().manual_seed(rows * row_len + offset + 1)
    n = rows * row_len
    flat = torch.randn(n + offset, generator=g) * torch.logspace(
        -4, 3, 64)[torch.randint(0, 64, (n + offset,), generator=g)]
    # the first block's absmax one where fl(amax / 127) != amax * fl(1 /
    # 127), exact in every dtype (a 7-bit fraction times 2^14)
    inv = np.float32(1) / np.float32(127)
    c = next(np.float32(1 + i / 128) for i in range(128)
             if np.float32(1 + i / 128) / np.float32(127)
             != np.float32(1 + i / 128) * inv)
    flat[offset] = float(c) * 2.0 ** 14
    x = flat.to(dtype)[offset:].view(rows, row_len)
    xc = flat.to(cuda, dtype)[offset:].view(rows, row_len)
    exact = TQ.quantize_int8_kernel.exact_launches
    q, s = TQ.quantize_rows(xc, exact=True)
    assert TQ.quantize_int8_kernel.variant == want
    assert TQ.quantize_int8_kernel.exact_launches == exact + 1
    pq, ps = TQ.quantize_rows(xc, use_kernel=False, exact=True)
    cq, cs = TQ.quantize_rows(x, exact=True)
    torch.cuda.synchronize()
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)
    wq, ws = TQ.quantize_rows(xc)
    assert torch.equal(ws.cpu(), TQ.quantize_rows(x)[1])
    assert float(ws[0, 0]) != float(s[0, 0])


def test_quantize_param_on_the_card_launches_the_kernels(cuda):
    """quantize_param's default config on a CUDA tensor: one exact-mode
    quantize launch, codes and scales equal to the CPU's (the JAX eager
    quotient); dequantized() and a layer's dequantize_range one dequantize
    launch each, equal to the CPU's; 4 bits stays torch ops (no launch),
    equal to the CPU's; a dtype the kernel does not take raises."""
    from deepspeed_tpu_torch.linear import QuantizationConfig, quantize_param
    from deepspeed_tpu_torch.ops import quantization as TQ
    w = torch.randn(3, 64, 96, generator=torch.Generator().manual_seed(5))
    counts = (TQ.quantize_int8_kernel.launches,
              TQ.quantize_int8_kernel.exact_launches,
              TQ.dequantize_int8_kernel.launches)
    qp = quantize_param(w.to(cuda))
    ref = quantize_param(w)
    assert torch.equal(qp.codes.cpu(), ref.codes)
    assert torch.equal(qp.scales.cpu(), ref.scales)
    assert torch.equal(qp.dequantized().cpu(), ref.dequantized())
    per = 64 * 96
    assert torch.equal(qp.dequantize_range(per, 2 * per).cpu(),
                       ref.dequantize_range(per, 2 * per))
    assert (TQ.quantize_int8_kernel.launches - counts[0],
            TQ.quantize_int8_kernel.exact_launches - counts[1],
            TQ.dequantize_int8_kernel.launches - counts[2]) == (1, 1, 2)
    q4 = quantize_param(w.to(cuda), QuantizationConfig(q_bits=4))
    assert TQ.quantize_int8_kernel.launches - counts[0] == 1
    assert torch.equal(q4.dequantized().cpu(), quantize_param(
        w, QuantizationConfig(q_bits=4)).dequantized())
    with pytest.raises(ValueError, match="dtype"):
        quantize_param(w.to(cuda, torch.float64))


INT8_MODEL = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
                  intermediate_size=512)


def test_int8_engine_on_the_card_matches_the_cpu_and_its_graphs(cuda):
    """Weight-only int8 (quantize_weights) in fp32: the card's engine on
    the CPU engine's float weights quantizes them to the same codes and
    scales, generate() and generate_fused (captured graphs, each layer's
    dequant inside them, its temporaries from the graph's pool) give the
    CPU's tokens; one captured dispatch against the same ticks run
    eagerly, bit for bit."""
    cfg = dict(FUSED_CFG, quantize_weights=True)
    tree = {n: p.detach().clone() for n, p in build_engine(
        "llama", "tiny", dict(FUSED_CFG), device="cpu",
        **INT8_MODEL).model.params.items()}
    cpu = build_engine("llama", "tiny", cfg, params=tree, device="cpu",
                       **INT8_MODEL)
    gpu = build_engine("llama", "tiny", cfg, params=tree, device=cuda,
                       **INT8_MODEL)
    quantized = [n for n in cpu.model.params if n.endswith("_q")]
    assert "layers/wq_q" in quantized and "lm_head_q" in quantized
    for n, p in cpu.model.params.items():
        assert torch.equal(gpu.model.params[n].cpu(), p), n
    ref = cpu.generate(FUSED_PROMPTS, max_new_tokens=10)
    assert gpu.generate(FUSED_PROMPTS, max_new_tokens=10) == ref
    first = len(gpu.graph_captures)
    assert gpu.generate_fused(FUSED_PROMPTS, max_new_tokens=10,
                              k_steps=3) == ref
    assert len(gpu.graph_captures) > first
    assert all(g["pool_mib"] > 0 for g in gpu.graph_captures[first:])
    uids = [0, 1]
    _at_dispatch_state(gpu, uids, FUSED_PROMPTS[:2])
    state = gpu._fused_operands(uids, 4, {0: 4, 1: 4}, 13)
    ops0 = {n: t.clone() for n, t in state.operands().items()}
    pools0 = {n: t.clone() for n, t in gpu.pools.items()}
    fn = gpu._fused_fn(state, 4, 0.0, 0, 0.0, None)
    toks_g, _ = fn().read()
    logits_g = state.logits.clone()
    for n, t in gpu.pools.items():
        t.copy_(pools0[n])
    for n, t in state.operands().items():
        t.copy_(ops0[n])
    gpu._fused_eager(state, 4, eos_id=None, temperature=0.0, top_k=0,
                     top_p=0.0)
    torch.cuda.synchronize()
    assert (toks_g == state.out[:, :4].cpu().numpy()).all()
    assert torch.equal(state.logits, logits_g)


def test_lora_training_on_the_card_matches_the_cpu(cuda):
    """LoRAModel over llama tiny (int8 base, segments remat, flash) in fp32
    through initialize / train_batch: the card's run from the CPU's base
    and adapters gives the CPU's losses (1e-5 relative) and adapters (1e-4
    of their change); the steps launch the dequantize kernel 14 times a
    layer (7 targets, forward and recomputed), no quantize; the frozen
    codes unchanged."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.linear import (LoRAConfig, LoRAModel,
                                            QuantizationConfig)
    from deepspeed_tpu_torch.models import Llama
    from deepspeed_tpu_torch.ops import quantization as TQ
    cfg = {"train_batch_size": 4, "optimizer": {
        "type": "FusedAdam", "params": {"lr": 1e-3, "fused_kernel": True}},
        "gradient_clipping": 1.0, "steps_per_print": 1000}
    kw = dict(remat_policy="segments", attn_impl="flash")
    cpu_model = LoRAModel(Llama(size="tiny", device="cpu", **kw),
                          LoRAConfig(lora_r=8), QuantizationConfig())
    frozen = {n: leaf.to(cuda) for n, leaf in cpu_model.frozen.items()}
    adapters = {n: {k: v.detach().to(cuda) for k, v in ab.items()}
                for n, ab in cpu_model.adapters().items()}
    gpu_model = LoRAModel(Llama(size="tiny", device=cuda, **kw),
                          LoRAConfig(lora_r=8), frozen=frozen,
                          adapters=adapters)
    engines = [ds.initialize(model=m, config=cfg)[0]
               for m in (cpu_model, gpu_model)]
    start = {n: t.clone() for n, t in
             engines[0].master_state_dict().items()}
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, 512,
                                                             (4, 65)))
    before = TQ.dequantize_int8_kernel.launches
    quant = TQ.quantize_int8_kernel.launches
    for step in range(3):
        batch = (tok[:, :-1], tok[:, 1:])
        losses = [float(e.train_batch(batch)) for e in engines]
        assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]), step
    layers = gpu_model.config.num_layers
    assert TQ.dequantize_int8_kernel.launches - before == 3 * 14 * layers
    assert TQ.quantize_int8_kernel.launches == quant
    cpu_p, gpu_p = (e.master_state_dict() for e in engines)
    err = sum(float((gpu_p[n].cpu() - cpu_p[n]).pow(2).sum())
              for n in cpu_p) ** 0.5
    moved = sum(float((cpu_p[n] - start[n]).pow(2).sum())
                for n in cpu_p) ** 0.5
    assert err <= 1e-4 * moved, (err, moved)
    for n, leaf in gpu_model.frozen.items():
        if hasattr(leaf, "codes"):
            assert torch.equal(leaf.codes.cpu(), cpu_model.frozen[n].codes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_dense_int8_on_the_card_matches_the_cpu(cuda, dtype):
    """quantize_dense_params's leaf on the card: codes and scales equal to
    the CPU's (the reciprocal-product scale, an IEEE quotient for the
    codes); the one-pass dequant (int8 times the scale in the serving
    dtype) bit-equal to the two-step product and to the CPU's."""
    from deepspeed_tpu_torch.linear.quantization import (
        dequantize_weight, quantize_dense_leaf)
    w = torch.randn(2, 256, 384, generator=torch.Generator().manual_seed(8))
    w = w * torch.logspace(-2, 1, 384)
    q, s = quantize_dense_leaf(w.to(cuda), dtype)
    cq, cs = quantize_dense_leaf(w, dtype)
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)
    got = dequantize_weight(q, s, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, q.to(dtype) * s.to(dtype))
    assert torch.equal(got.cpu(), dequantize_weight(cq, cs, dtype))


# ------------------------------------------------------- BERT, HF loading
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bert_layer_norm_on_the_card(cuda, dtype):
    """BERT's LayerNorm at BERT-large's training rows ([64 x 128, 1024]),
    eps 1e-12 used as given: the kernel against its plain version at
    _assert_plain_close's bounds (fp32 cta_row, bf16 warp_row, the
    variants phase 23a's path takes), and the autograd Function's
    closed-form backward against plain autograd (fp32, 1e-5 of the
    largest grad)."""
    from deepspeed_tpu_torch.ops import layers as L
    from deepspeed_tpu_torch.ops import norms as N
    g = torch.Generator(device=cuda).manual_seed(12)
    x = (torch.randn(8192, 1024, generator=g, device=cuda) * 2
         + 0.5).to(dtype)
    s = (torch.randn(1024, generator=g, device=cuda) + 1).to(dtype)
    b = torch.randn(1024, generator=g, device=cuda).to(dtype)
    before = N.layer_norm_kernel.launches
    got = N.layer_norm_kernel(x, s, b, eps=1e-12)
    assert N.layer_norm_kernel.launches == before + 1
    assert N.layer_norm_kernel.variant == (
        "cta_row" if dtype == torch.float32 else "warp_row")
    ref = L.layer_norm(x, s, b, 1e-12)
    if dtype == torch.float32:
        mag = torch.maximum(ref.abs(), (ref - b).abs())
        assert bool(((got - ref).abs() <= 1e-6 + 4.8e-7 * mag).all())
    else:
        assert norm_ulps(got, ref, dtype, b) <= 1.0
    if dtype == torch.float32:
        xs = [x.clone().requires_grad_() for _ in range(2)]
        ps = [(s.clone().requires_grad_(), b.clone().requires_grad_())
              for _ in range(2)]
        cot = torch.randn(8192, 1024, generator=g, device=cuda)
        (N.layer_norm(xs[0], *ps[0], 1e-12) * cot).sum().backward()
        (L.layer_norm(xs[1], *ps[1], 1e-12) * cot).sum().backward()
        for got_g, ref_g in ((xs[0].grad, xs[1].grad),
                             (ps[0][0].grad, ps[1][0].grad),
                             (ps[0][1].grad, ps[1][1].grad)):
            err = float((got_g - ref_g).abs().max())
            assert err <= 1e-5 * float(ref_g.abs().max()), err


def test_bert_training_on_the_card_matches_the_cpu(cuda):
    """Bert tiny, fp32 (TF32 off), fused Adam, 3 train_batch steps on
    (tokens, targets, mask) with a padded row, the card against the CPU
    from the same weights: each loss within 1e-5 relative, the params
    within 1e-4 of the norm of their change; every norm a LayerNorm
    kernel launch (2L + 2 a step)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Bert
    from deepspeed_tpu_torch.ops import norms as N
    cfg = {"train_batch_size": 4, "optimizer": {
        "type": "FusedAdam", "params": {"lr": 1e-3, "fused_kernel": True}},
        "gradient_clipping": 1.0, "steps_per_print": 1000}
    cpu = Bert(size="tiny", device="cpu")
    cpu.init_params(torch.Generator().manual_seed(0))
    init = {n: p.detach().clone() for n, p in cpu.params.items()}
    engines = [ds.initialize(model=m, config=cfg, model_parameters=init)[0]
               for m in (cpu, Bert(size="tiny", device=cuda))]
    rng = np.random.default_rng(4)
    tok = rng.integers(0, 512, (4, 64))
    tgt = np.where(rng.random((4, 64)) < 0.15, tok, -100)
    mask = np.ones((4, 64), np.int64)
    mask[3, 40:] = 0
    before = N.layer_norm_kernel.launches
    for step in range(3):
        losses = [float(e.train_batch((tok, tgt, mask))) for e in engines]
        assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]), step
    assert N.layer_norm_kernel.launches - before == 3 * (2 * 2 + 2)
    cpu_p, gpu_p = (e.master_state_dict() for e in engines)
    err = sum(float((gpu_p[n].cpu() - cpu_p[n]).pow(2).sum())
              for n in cpu_p) ** 0.5
    moved = sum(float((cpu_p[n] - init[n]).pow(2).sum())
                for n in cpu_p) ** 0.5
    assert err <= 1e-4 * moved, (err, moved)


def _write_tiny_llama_dir(path, tree, cfg):
    """A Llama HF checkpoint directory from a JAX-layout tree, written
    with the port's own safetensors writer (the card's machine has no
    safetensors package)."""
    import json
    from deepspeed_tpu_torch.checkpoint.huggingface import save_safetensors
    lay = tree["layers"]
    names = {"ln1_scale": "input_layernorm.weight",
             "ln2_scale": "post_attention_layernorm.weight",
             "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
             "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
             "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
             "w_down": "mlp.down_proj.weight"}
    out = {"model.embed_tokens.weight": tree["embed"]["tokens"],
           "model.norm.weight": tree["final_norm"]["scale"],
           "lm_head.weight": tree["lm_head"].T.contiguous()}
    for i in range(cfg.num_layers):
        for ours, hf in names.items():
            t = lay[ours][i]
            out[f"model.layers.{i}.{hf}"] = (t.T.contiguous() if t.ndim == 2
                                             else t.clone())
    save_safetensors(out, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": False}))


def test_module_given_to_initialize_moves_to_the_card(cuda):
    """An nn.Module built on the CPU and given to initialize trains on
    the card, as the reference engine moves its module: the engine and
    the module's parameters on cuda, the loss falling over 3 steps."""
    import deepspeed_tpu_torch as ds
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Embedding(64, 16),
                                 torch.nn.Linear(16, 64))
    engine, *_ = ds.initialize(model=module, config={
        "train_batch_size": 4,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    assert engine.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in module.parameters())
    tok = np.random.default_rng(0).integers(0, 64, (4, 16))
    losses = [float(engine.train_batch((tok[:, :-1], tok[:, 1:])))
              for _ in range(3)]
    assert losses[-1] < losses[0], losses


def test_hf_directory_round_trip_on_the_card(cuda, tmp_path):
    """A tiny Llama written as an HF directory and read back on the card:
    build_hf_engine's and init_inference's parameters bit-equal to the
    engines built from the tree, the same greedy tokens, and the card's
    v2 tokens equal to the CPU's from the same directory (fp32)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.inference.v2 import build_hf_engine
    from deepspeed_tpu_torch.models import Llama
    from deepspeed_tpu_torch.models.convert import materialize
    src = Llama(size="tiny", device="cpu")
    src.init_params(torch.Generator().manual_seed(3))
    tree: dict = {}
    for name, p in src.params.items():
        node = tree
        *parents, last = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = p.detach().clone()
    _write_tiny_llama_dir(tmp_path, tree, src.config)
    ecfg = {"dtype": "float32", "kv_block_size": 8, "num_kv_blocks": 64}
    prompts = [[1, 2, 3, 4, 5], list(range(7, 40))]
    hf = build_hf_engine(str(tmp_path), dict(ecfg), device=cuda)
    ref = build_engine("llama", "tiny", dict(ecfg), params=materialize(tree),
                       device=cuda)
    for name, p in ref.model.params.items():
        assert torch.equal(hf.model.params[name], p), name
    got = hf.generate(prompts, max_new_tokens=6)
    assert got == ref.generate(prompts, max_new_tokens=6)
    cpu = build_hf_engine(str(tmp_path), dict(ecfg), device="cpu")
    assert got == cpu.generate(prompts, max_new_tokens=6)
    v1 = ds.init_inference(str(tmp_path), dtype="fp32", max_out_tokens=64,
                           device=cuda)
    v1_ref = ds.init_inference(Llama(size="tiny", device=cuda),
                               dtype="fp32", max_out_tokens=64,
                               params=materialize(tree))
    toks = np.asarray([prompts[0]])
    assert torch.equal(v1.generate(toks, max_new_tokens=6),
                       v1_ref.generate(toks, max_new_tokens=6))


def _moe_tree(family, seed=4):
    """A tiny MoE family's fp32 weights drawn on the CPU (every leaf
    perturbed from its init, so the routers drop tokens)."""
    from deepspeed_tpu_torch.models import get_model_class
    src = get_model_class(family)(size="tiny", device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return {n: src.draw(n, gen) + 0.05 * torch.randn(
            p.shape, generator=gen) for n, p in src.params.items()}


@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe"])
def test_moe_families_on_the_card_match_the_cpu(cuda, family):
    """The tiny MoE families in fp32 on the card against the CPU from the
    same weights: build_engine's first prefill logits at 1e-4 of their
    largest and its greedy tokens through generate() and generate_fused
    (captured graphs of the capacity and the grouped form), the grouped
    form, the int8 experts (their codes and scales bit-equal) and both (the
    grouped GEMM reading the codes); initialize (flash, segments, fused Adam, clip) for 3 steps,
    losses at 1e-4 relative, as the dense families' training test."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_class
    tree = _moe_tree(family)
    ecfg = {"dtype": "float32", "kv_block_size": 8, "num_kv_blocks": 64,
            "max_chunk_size": 32}
    prompts = [list(range(3, 14)), list(range(40, 60)), [5, 6, 7]]
    for over in ({}, {"moe_grouped_dispatch": True},
                 {"quantize_moe_experts": True},
                 {"quantize_moe_experts": True,
                  "moe_grouped_dispatch": True}):
        runs = []
        for dev in ("cpu", cuda):
            eng = build_engine(family, "tiny", dict(ecfg, **over),
                               params=tree, device=dev)
            logits = eng.put([7], [prompts[1]])[0].float().cpu()
            eng.flush(7)
            runs.append((logits, eng.generate(prompts, max_new_tokens=6),
                         None if "quantize_moe_experts" in over
                         else eng.generate_fused(
                             prompts, max_new_tokens=6, k_steps=3),
                         {n: t.cpu() for n, t in eng.model.params.items()
                          if n.startswith("layers/experts/")}))
        (lc, tc, fc, ec), (lg, tg, fg, eg) = runs
        assert float((lg - lc).abs().max() / lc.abs().max()) < 1e-4, over
        assert tg == tc and fg == fc, over
        # the int8 experts' codes and scales bit for bit (JAX's amax / 127)
        assert all(torch.equal(eg[n], t) for n, t in ec.items()), over
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 1e-3, "weight_decay": 0.01, "fused_kernel": True}},
           "gradient_clipping": 0.5, "zero_optimization": {"stage": 2}}
    tok = np.random.default_rng(0).integers(0, 512, (4, 65))
    batch = (tok[:, :-1], tok[:, 1:])
    losses = []
    for dev in ("cpu", cuda):
        model = get_model_class(family)(size="tiny", device=dev,
                                        remat_policy="segments",
                                        attn_impl="flash")
        eng, *_ = ds.initialize(model=model, config=cfg, model_parameters={
            n: t.clone() for n, t in tree.items()})
        losses.append([float(eng.train_batch(batch)) for _ in range(3)])
    torch.testing.assert_close(losses[1], losses[0], atol=0, rtol=1e-4)
    assert losses[1][-1] < losses[1][0]


@pytest.mark.parametrize("k", [2, 4])
def test_moe_ffn_on_the_card_matches_the_einsum_form(cuda, k):
    """The index-form moe_ffn on the card in bf16, router columns tied in
    pairs (their logits equal, the lower expert first), against the plain
    one-hot einsum form of JAX's moe_ffn written from top_k_gating's
    tables on the same inputs: the same routing (dispatch tables equal),
    the outputs at bf16's 3e-2 of their largest, and a CUDA graph of the
    call replaying it bit for bit."""
    from deepspeed_tpu_torch.moe import sharded_moe as sm
    gen = torch.Generator().manual_seed(k)
    n, d, e, f = 512, 256, 16, 512
    x = torch.randn(2, n // 2, d, generator=gen).to(cuda, torch.bfloat16)
    gate_w = 0.05 * torch.randn(d, e, generator=gen)
    gate_w[:, 1::2] = gate_w[:, 0::2]
    gate_w = gate_w.to(cuda, torch.bfloat16)
    experts = {m: (0.05 * torch.randn(e, *sh, generator=gen)).to(
        cuda, torch.bfloat16) for m, sh in (("w_up", (d, f)),
                                            ("w_gate", (d, f)),
                                            ("w_down", (f, d)))}
    out, aux = sm.moe_ffn(x, gate_w, experts, k=k, capacity_factor=1.0)
    xt = x.reshape(n, d)
    logits = xt @ gate_w
    assert bool((logits[:, 0::2] == logits[:, 1::2]).all())
    combine, dispatch, ref_aux, metrics = sm.top_k_gating(logits, k)
    cpu_dispatch = sm.top_k_gating(logits.cpu(), k)[1]
    assert torch.equal(dispatch.cpu(), cpu_dispatch)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xt)
    ref = torch.einsum("nec,ecd->nd", combine.to(x.dtype),
                       sm._expert_ffn(expert_in, experts, "swiglu"))
    err = float((out.reshape(n, d) - ref).abs().max() / ref.abs().max())
    assert err < 3e-2, err
    assert float(metrics["drop_fraction"]) > 0
    torch.testing.assert_close(aux, ref_aux)
    static = torch.empty_like(out)
    graph = torch.cuda.CUDAGraph()
    sm.moe_ffn(x, gate_w, experts, k=k, capacity_factor=1.0)   # warm-up
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        static.copy_(sm.moe_ffn(x, gate_w, experts, k=k,
                                capacity_factor=1.0)[0])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, out)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_saved_on_the_card_loads_on_the_cpu(cuda, tmp_path,
                                                       async_save):
    """A bf16 engine on the card (flash, fused Adam, ZeRO 2) saves (sync,
    or through the async engine's pinned snapshot); an engine on the CPU
    loads the checkpoint: master, moments, params, step and loss scale
    bit for bit; a checkpoint the CPU engine writes loads back on the card
    the same way."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    cfg = {"train_batch_size": 4, "bf16": {"enabled": True},
           "optimizer": {"type": "FusedAdam",
                         "params": {"lr": 1e-3, "fused_kernel": True}},
           "zero_optimization": {"stage": 2},
           "checkpoint": {"async_save": async_save}}

    def engine(device, seed):
        m = GPT2(size="tiny", device=device, remat_policy="segments",
                 attn_impl="flash")
        return ds.initialize(model=m, config=dict(cfg, seed=seed))[0]

    def state(eng):
        out = {"master": eng._master, "step": eng._step,
               **{f"opt/{k}": v for k, v in eng.opt_state.items()},
               **{f"params/{k}": v for k, v in
                  eng.module_state_dict().items()},
               **{f"scale/{i}": t for i, t in enumerate(eng._loss_scale)}}
        return {k: v.detach().cpu().clone() for k, v in out.items()}

    tok = np.random.default_rng(0).integers(0, 512, (4, 33))
    batch = (torch.from_numpy(tok[:, :-1]).to(cuda),
             torch.from_numpy(tok[:, 1:]).to(cuda))
    card = engine(cuda, 1)
    for _ in range(2):
        card.train_batch(batch)
    card.save_checkpoint(str(tmp_path / "card"))
    card.checkpoint_engine.commit("global_step2")
    cpu = engine("cpu", 2)
    cpu.load_checkpoint(str(tmp_path / "card"))
    want, got = state(card), state(cpu)
    assert all(torch.equal(want[k], got[k]) for k in want)
    cpu.save_checkpoint(str(tmp_path / "cpu"))
    cpu.checkpoint_engine.commit("global_step2")
    back = engine(cuda, 3)
    back.load_checkpoint(str(tmp_path / "cpu"))
    got = state(back)
    assert all(torch.equal(want[k], got[k]) for k in want)


GROUPED_CASES = {      # experts, K, N, group sizes (0: an empty group)
    "decode": (8, 256, 512, [3, 0, 5, 1, 0, 2, 4, 1]),
    "prefill": (4, 512, 384, [70, 0, 200, 130]),
    "ragged_k_n": (3, 100, 90, [0, 33, 65]),        # the CUDA-core kernel
    "empty_last": (5, 64, 128, [2, 3, 64, 1, 0])}


def _grouped_inputs(dev, dtype, e, k, n, sizes, seed=0, int8=False):
    """x, w, offsets and, with ``int8``, w's codes and scales in x's dtype
    (the port's quantize_expert_leaf) in place of w."""
    from deepspeed_tpu_torch.moe.sharded_moe import quantize_expert_leaf
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    gen = torch.Generator().manual_seed(seed)
    rows = sum(sizes)
    x = torch.randn(rows, k, generator=gen).to(dev, dtype)
    w = (torch.randn(e, k, n, generator=gen) / k ** 0.5).to(dev, dtype)
    ids = torch.repeat_interleave(torch.arange(e), torch.tensor(sizes))
    scales = None
    if int8:
        w, scales = quantize_expert_leaf(w, dtype)
    return x, w, gg.group_offsets(ids.to(dev), e), scales


@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("case", list(GROUPED_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_grouped_mm_kernel_matches_plain(cuda, dtype, case, weights):
    """csrc/grouped_gemm.cu against the plain product per expert (fp32 at
    1e-5 of the largest value: summation order only, TF32 off; bf16 at
    3e-2, fp16 at 1e-2), with empty groups first, inside and last, K and
    N off TMA's 16-byte rows, float and int8 experts (the plain version
    dequantizes them first); the variant kernel_variant names, one launch
    counted a call, a rerun and a CUDA graph's replay bit for bit."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    e, k, n, sizes = GROUPED_CASES[case]
    x, w, offs, s = _grouped_inputs(cuda, dtype, e, k, n, sizes,
                                    int8=weights == "int8")
    before = gg.grouped_mm_kernel.launches
    got = gg.grouped_mm(x, w, offs, s)
    assert gg.grouped_mm_kernel.launches == before + 1
    assert gg.grouped_mm_kernel.variant == gg.kernel_variant(x, w, s)
    ref = gg.grouped_mm_plain(x, w, offs, s)
    tol = {torch.float32: 1e-5, torch.bfloat16: 3e-2,
           torch.float16: 1e-2}[dtype]
    err = float((got.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    assert got.dtype == dtype and got.shape == (sum(sizes), n)
    assert err < tol, err
    assert torch.equal(gg.grouped_mm(x, w, offs, s), got)
    static = torch.empty_like(got)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        static.copy_(gg.grouped_mm(x, w, offs, s))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, got)


def test_grouped_mm_cases_reach_every_form(cuda):
    """GROUPED_CASES in bf16 take the decode form and the prefill form,
    with float and with int8 experts, and the CUDA cores where TMA cannot
    take K and N: each variant launched at least once."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    seen = set()
    for int8 in (False, True):
        for e, k, n, sizes in GROUPED_CASES.values():
            x, w, offs, s = _grouped_inputs(cuda, torch.bfloat16, e, k, n,
                                            sizes, int8=int8)
            gg.grouped_mm(x, w, offs, s)
            seen.add(gg.grouped_mm_kernel.variant)
    torch.cuda.synchronize()
    assert seen == {"wgmma_decode", "wgmma_prefill", "wgmma_decode_int8",
                    "wgmma_prefill_int8", "cuda_cores", "cuda_cores_int8"}


V1_GRAPH_CASES = {"gpt2": ("gpt2", {}), "llama": ("llama", {}),
                  "mistral": ("mistral", dict(sliding_window=5)),
                  "bloom": ("bloom", {}),
                  "mixtral_capacity": ("mixtral", {}),
                  "mixtral_grouped": ("mixtral", {})}


@pytest.mark.parametrize("case", list(V1_GRAPH_CASES))
def test_v1_generate_graphs_match_eager_and_the_cpu(cuda, case):
    """init_inference(...).generate on the card replays one captured
    decode step a key: its greedy and sampled tokens bit-equal to the same
    step run eagerly on the card (``_generate_eager``), fp32 tokens equal
    to the CPU engine's from the same weights, the norm launches of every
    replay counted (2L + 1 a forward), and the grouped form's grouped
    GEMMs (3L a forward; fp32 takes the CUDA-core kernel); a second call
    replays the graph again to the same tokens."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_class
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    from deepspeed_tpu_torch.ops import norms as N
    family, over = V1_GRAPH_CASES[case]
    cfg = {"dtype": "float32", "max_out_tokens": 64,
           "moe_grouped_dispatch": case == "mixtral_grouped"}
    src = get_model_class(family)(size="tiny", device="cpu", **over)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        tree = {n: src.draw(n, gen) + 0.05 * torch.randn(p.shape,
                                                         generator=gen)
                for n, p in src.params.items()}
    engines = [ds.init_inference(
        get_model_class(family)(size="tiny", device=dev, **over),
        config=dict(cfg), params={n: t.clone() for n, t in tree.items()})
        for dev in ("cpu", cuda)]
    prompts = np.random.default_rng(1).integers(0, 512, (3, 9))
    c = engines[1].module.config
    norm = N.rms_norm_kernel if c.norm_type == "rmsnorm" \
        else N.layer_norm_kernel
    for kw in ({}, dict(do_sample=True, temperature=0.9, top_k=20,
                        top_p=0.9, seed=5)):
        want = engines[0].generate(prompts, max_new_tokens=7, **kw)
        norm.launches = 0
        gg.grouped_mm_kernel.launches = 0
        got = engines[1].generate(prompts, max_new_tokens=7, **kw)
        assert engines[1].last_decode["graph"] is not None
        per_forward = (1 if c.parallel_residual
                       and not c.parallel_dual_norm else 2) \
            * c.num_layers + 1 + int(c.embed_layernorm)
        # the prefill, 6 replays and, at a key's first call, the
        # capture's warm-up step (eager, over an idle copy of the state)
        forwards = 7 + int(engines[1].last_decode["captured"])
        assert norm.launches == forwards * per_forward
        assert gg.grouped_mm_kernel.launches == (
            3 * c.num_layers * forwards if case == "mixtral_grouped" else 0)
        eager = engines[1]._generate_eager(prompts, max_new_tokens=7, **kw)
        assert torch.equal(got, eager)
        assert torch.equal(got.cpu(), want), kw
        again = engines[1].generate(prompts, max_new_tokens=7, **kw)
        assert torch.equal(again, got)


def test_v1_generate_memory_stays_bounded(cuda):
    """generate() on the card over many prompt lengths, twice: the engine
    keeps one state (the last call's cache and graph), so the device
    memory allocated after a call never exceeds the first pass's most,
    and a capture happens only where the cache bucket changes."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    eng = ds.init_inference(GPT2(size="tiny", device=cuda),
                            config={"dtype": "float32",
                                    "max_out_tokens": 128})
    rng = np.random.default_rng(2)
    lengths = list(range(3, 120, 7))
    passes = []
    for _ in range(2):
        peak, buckets = 0, []
        for length in lengths:
            eng.generate(rng.integers(0, 512, (4, length)),
                         max_new_tokens=8)
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.memory_allocated(cuda))
            bucket = eng._run[1].cache["k"].shape[2]
            if not buckets or buckets[-1] != bucket:
                buckets.append(bucket)
        passes.append((peak, buckets))
    assert passes[1][0] <= passes[0][0]
    assert passes[0][1] == [12, 24, 32, 48, 64, 96, 128]
    # a capture at each bucket change, the second pass's first call too
    assert len(eng.graph_captures) == 7 + 7
