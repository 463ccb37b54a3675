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
block-sparse attention in fp32 at 1e-4 and in bf16 at 3e-2 of the
largest value.
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


def _kwargs(variant, dev):
    kw = {"window": VARIANTS[variant].get("window")}
    if VARIANTS[variant].get("alibi"):
        kw["alibi_slopes"] = alibi_slopes(HQ, device=dev)
    return kw


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("sq", [1, 8, 40])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype, d, sq, variant):
    x = _inputs(cuda, dtype, sq, d)
    kw = _kwargs(variant, cuda)
    before = paged.paged_attention_kernel.launches
    got = paged.paged_attention_kernel(*x.values(), **kw)
    torch.cuda.synchronize()
    assert paged.paged_attention_kernel.launches == before + 1
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
    backward launches per call. Block sizes 8 to 64, head_dim 24 to 128."""
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
