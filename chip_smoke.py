#!/usr/bin/env python3
"""Drive the PyTorch port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the serving and training paths, from
     csrc/, one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card (paged
     attention at the serving path's shapes; flash attention forward and
     backward and fused Adam over a spread of cases), then timed at the
     main paths' shapes beside its plain version, a PyTorch library call
     computing the same function, and the card's least time for the work
     (its bound);
  4. the serving main path at full width: build_engine("llama", "3-8b")
     with random seeded weights serves 8 requests x 32 tokens through
     generate(); every layer of every tick must launch the kernel;
  5. the serving path with the kernel against the same path with the
     plain attention: logits in fp32, every layer's attention in bf16;
  6. the training main path at full width: initialize(GPT-2 125M, bf16,
     FusedAdam with the fused kernel, ZeRO 2, clip 1.0) -> train_batch on
     24 x 1024 tokens, one warm-up step then 10 timed steps; tokens/s,
     step ms, MFU, peak memory, the loss per step (finite and falling)
     and the kernels' launches per step;
  7. the training path with the kernels against the plain path (reference
     attention, plain Adam) from the same weights, fp32 with TF32 off:
     losses, the first step's grads and the params after 3 steps; the
     same in bf16, reported without a bound;
  8. Path T, DeepSpeed's own loop at full width: GPT-2 125M with
     loss_chunk 256, Lion with the fused kernel, GA 2 (micro 12 x 1024),
     each step two engine(micro) + engine.backward(loss), then
     engine.step(); one warm-up step then 10 timed steps: tokens/s, step
     ms, MFU, peak memory, the loss per step (finite and falling) and the
     kernels' launches per step;
  9. Path T's kernels against plain and its loop against train_batch, from
     the same weights, fp32 with TF32 off: the fused-Lion path against
     lion_plain and the triple against train_batch (losses, params);
 10. Path P: SparseSelfAttention (DeepSpeed's "fixed" example layout,
     GPT-2 125M's 12 heads of 64, B 8, S 4096, bf16) forward and backward
     through the block-sparse kernels, held against the plain versions.
Phase 3 also holds fused Lion and the block-sparse kernels against their
plain versions and times them at Path T's and Path P's shapes. With
--profile it then traces a prefill tick and decode ticks of the serving
path, one train_batch step and one step of Path T (torch.profiler) and
prints where the device time goes. The last two lines are the kernels'
JSON record and {"ok": true, "device": {...}}. Without a CUDA card it
exits non-zero.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor rate
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ADAM_TOL = (1e-6, 1e-5)        # atol, rtol: the JAX fused-Adam tolerance
KERNELS = ("paged_attention", "flash_attention", "fused_adam",
           "fused_lion", "block_sparse_attention")
SOURCE = "deepspeed_tpu_torch/csrc/{}.cu"
REPLACES = {
    "paged_attention": "deepspeed_tpu/inference/v2/paged.py:61",
    "flash_attention_fwd": "deepspeed_tpu/ops/pallas/flash_attention.py:88",
    "flash_attention_bwd": "deepspeed_tpu/ops/pallas/flash_attention.py:226",
    "fused_adam": "deepspeed_tpu/ops/pallas/fused_optimizers.py:75",
    "fused_lion": "deepspeed_tpu/ops/pallas/fused_optimizers.py:165",
    "block_sparse_attention_fwd":
        "deepspeed_tpu/ops/sparse_attention/kernels.py:121",
    "block_sparse_attention_bwd":
        "deepspeed_tpu/ops/sparse_attention/kernels.py:210"}
# the training main path: bench.py headline_bench's configuration with
# the JAX package's switch to its fused-Adam kernel turned on
TRAIN_CONFIG = {
    "train_batch_size": 24,
    "optimizer": {"type": "FusedAdam",
                  "params": {"lr": 1e-4, "weight_decay": 0.01,
                             "fused_kernel": True}},
    "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
    "gradient_clipping": 1.0, "gradient_accumulation_steps": 1,
    "steps_per_print": 1000000000}
# Path T: the same model and step with DeepSpeed's forward/backward/step
# loop, Lion through the JAX package's fused_kernel switch, GA 2 and the
# chunked cross-entropy (loss_chunk, bench.py:341 and :2514)
PATH_T_CONFIG = {
    "train_batch_size": 24, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Lion",
                  "params": {"lr": 1e-4, "betas": [0.9, 0.99],
                             "weight_decay": 0.01, "fused_kernel": True}},
    "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
    "gradient_clipping": 1.0, "steps_per_print": 1000000000}
PATH_T_MODEL = dict(vocab_size=50304, remat_policy="segments",
                    attn_impl="flash", loss_chunk=256)
# Path P: SparseSelfAttention at GPT-2 125M's head layout with the values
# of the "fixed" sparse_attention example in DeepSpeed's config-json docs
PATH_P = dict(b=8, h=12, s=4096, d=64)
SPARSE_SHAPE = "B=8 H=12 S=4096 D=64 bf16, fixed layout block 16"
PATH_P_LAYOUT = dict(block=16, different_layout_per_head=True,
                     num_local_blocks=4, num_global_blocks=1,
                     attention="bidirectional",
                     num_different_global_patterns=4)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, dev, iters: int, flush=None) -> float:
    """Mean device time of fn() over iters calls after a warm-up, with
    the L2 cache flushed before each call (the main path meets each
    layer's pages cold). On the CPU (rehearsal only) a host clock."""
    import torch
    fn()
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------- phase 3
def attention_case(dev, dtype, *, b, sq, pos0, true_len, hq=32, hkv=8,
                   d=128, bs=64, nb=None, window=None, alibi=False, seed=0):
    """Inputs of one paged-attention call with a permuted block table."""
    import torch
    from deepspeed_tpu_torch.ops.layers import alibi_slopes
    rng = np.random.default_rng(seed)
    max_blocks = max(-(-(p + sq) // bs) for p in pos0)
    nb = nb or b * max_blocks + 7
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    tables = rng.permutation(nb)[:b * max_blocks].reshape(b, max_blocks)
    x = dict(q=randn(b, sq, hq, d), k_new=randn(b, sq, hkv, d),
             v_new=randn(b, sq, hkv, d), k_pool=randn(nb, bs, hkv, d),
             v_pool=randn(nb, bs, hkv, d),
             block_tables=torch.tensor(tables, dtype=torch.int32,
                                       device=dev),
             pos0=torch.tensor(pos0, dtype=torch.int32, device=dev),
             true_len=torch.tensor(true_len, dtype=torch.int32, device=dev))
    kw = {"window": window}
    if alibi:
        kw["alibi_slopes"] = alibi_slopes(hq, device=dev)
    return x, kw


def attention_bound(x, kw) -> tuple[float, str]:
    """Least time (ms) the card needs for one call on these inputs: the
    bytes it must move (each input read once: q, the chunk's k/v, the
    visible cached keys and values, the tables; the output written once)
    over the memory rate, and the multiply-adds over the tensor rate of
    the inputs' type; the larger bounds it."""
    q = x["q"]
    b, sq, hq, d = q.shape
    hkv = x["k_new"].shape[2]
    item = q.element_size()
    pos0 = x["pos0"].tolist()
    tl = x["true_len"].tolist()
    window = kw.get("window")
    keys_read = 0
    pairs = 0                    # (valid query row, visible key) pairs
    for p, t in zip(pos0, tl):
        lo = max(0, p - window + 1) if window else 0
        keys_read += max(p - lo, 0)
        for i in range(t):
            first = max(0, p + i - window + 1) if window else 0
            pairs += p + i + 1 - first
    nbytes = (2 * q.numel() + 2 * x["k_new"].numel()) * item \
        + 2 * keys_read * hkv * d * item \
        + 4 * (x["block_tables"].numel() + 2 * b)
    flops = 4 * pairs * hq * d
    rate = BF16_FLOPS if q.dtype.is_floating_point and item == 2 \
        else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_attention(x, kw):
    """scaled_dot_product_attention over the gathered pages: the
    yardstick (library_ms). The port never calls it."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.inference.v2.paged import gather_pages
    q = x["q"]
    b, sq, hq, d = q.shape
    hkv = x["k_new"].shape[2]
    rep = hq // hkv
    k = torch.cat([gather_pages(x["k_pool"], x["block_tables"]),
                   x["k_new"]], 1)
    v = torch.cat([gather_pages(x["v_pool"], x["block_tables"]),
                   x["v_new"]], 1)
    smax = k.shape[1] - sq
    pos0 = x["pos0"].long()
    ar_k = torch.arange(smax + sq, device=q.device)
    kpos = torch.where(ar_k[None] < smax, ar_k[None],
                       pos0[:, None] + ar_k[None] - smax)
    live = torch.where(ar_k[None] < smax, ar_k[None] < pos0[:, None],
                       ar_k[None] - smax < x["true_len"][:, None])
    qpos = pos0[:, None] + torch.arange(sq, device=q.device)[None]
    mask = live[:, None] & (kpos[:, None] <= qpos[:, :, None])
    if kw.get("window"):
        mask &= qpos[:, :, None] - kpos[:, None] < kw["window"]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
    mask = mask[:, None]

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    return call


def kernel_checks(dev, flush=None, iters=20):
    """Phase 3: kernel vs plain at the main path's shapes; times."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import paged
    rng = np.random.default_rng(0)
    ctx = rng.integers(100, 2001, 8)
    ctx[0], ctx[-1] = 100, 2000
    decode = dict(b=8, sq=1, pos0=ctx.tolist(), true_len=[1] * 8)
    prefill = dict(b=2, sq=256, pos0=[0, 300], true_len=[256, 200])
    cases = {"decode": decode, "prefill": prefill,
             "prefill_window": dict(prefill, window=128),
             "decode_alibi": dict(decode, alibi=True)}
    errs = {}
    record = {}
    for dtype_name, tol in TOL.items():
        dtype = getattr(torch, dtype_name)
        for name, shape in cases.items():
            x, kw = attention_case(dev, dtype, **shape)
            got = paged.paged_attention_kernel(*x.values(), **kw)
            ref = paged.paged_attention_plain(*x.values(), **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            bad = err > tol + tol * ref.float().abs()
            errs[(dtype_name, name)] = float(err.max())
            log(f"[kernel] {name:15s} {dtype_name:9s} max|err| "
                f"{float(err.max()):.3e} (tol {tol:g})")
            if bool(bad.any()):
                raise AssertionError(
                    f"paged_attention kernel disagrees with its plain "
                    f"version: {name} {dtype_name}, max|err| "
                    f"{float(err.max()):.3e} > tol {tol:g}")
            if dtype_name == "bfloat16" and name in ("decode", "prefill"):
                lib = library_attention(x, kw)
                lib_out = lib().transpose(1, 2)
                rows = x["true_len"].tolist()
                lib_err = max(float((lib_out[i, :t].float()
                                     - ref[i, :t].float()).abs().max())
                              for i, t in enumerate(rows))
                bound, bound_by = attention_bound(x, kw)
                record[name] = dict(
                    ms=time_ms(lambda: paged.paged_attention_kernel(
                        *x.values(), **kw), dev, iters, flush),
                    plain_ms=time_ms(lambda: paged.paged_attention_plain(
                        *x.values(), **kw), dev, max(iters // 4, 2), flush),
                    library_ms=time_ms(lib, dev, iters, flush),
                    bound_ms=bound, bound_by=bound_by,
                    library_max_abs_err=lib_err)
                log(f"[kernel] {name} times (ms): {json.dumps(record[name])}")
    return errs, record


# ---------------------------------------------------------------- phase 4
def serve(engine, prompts, max_new: int, dev):
    """generate() over prompts with each tick timed; returns outputs,
    wall seconds and per-tick (seconds, prefill tokens, decode rows)."""
    import torch
    mgr = engine.state_manager
    prompt_len = {i: len(p) for i, p in enumerate(prompts)}
    orig_tick = engine.tick
    ticks = []

    def timed_tick():
        run = [u for u, s in mgr.seqs.items()
               if s.pending][:engine._config.max_ragged_sequence_count]
        chunk = engine._chunk
        prefill = sum(min(mgr.seqs[u].pending, chunk) for u in run
                      if mgr.seqs[u].seen < prompt_len[u])
        decode = sum(1 for u in run if mgr.seqs[u].seen >= prompt_len[u])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_tick()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t, prefill, decode))
        return out

    engine.tick = timed_tick
    try:
        t = time.perf_counter()
        outs = engine.generate(prompts, max_new_tokens=max_new)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        del engine.tick     # back to the class's method: no reference cycle
    return outs, wall, ticks


def main_path(dev, size="3-8b", n_req=8, max_new=32, lengths=(100, 701),
              engine_over=None):
    """Phase 4: the serving main path at full width through generate()."""
    from deepspeed_tpu_torch.inference.v2 import build_engine, paged
    cfg = {"dtype": "bfloat16", "kv_block_size": 64, "num_kv_blocks": 512,
           "max_chunk_size": 256, "max_ragged_sequence_count": 8}
    cfg.update(engine_over or {})
    t = time.perf_counter()
    engine = build_engine("llama", size=size, engine_config=cfg, device=dev)
    log(f"[main] build_engine llama-{size}: "
        f"{time.perf_counter() - t:.1f} s")
    c = engine.model.config
    rng = np.random.default_rng(1)
    lens = rng.integers(lengths[0], lengths[1], n_req)
    lens[0] = lengths[1] - 1              # at least one prompt chunks
    prompts = [rng.integers(0, c.vocab_size, n).tolist() for n in lens]
    serve(engine, [prompts[0][:16]], 2, dev)          # warm-up
    paged.paged_attention_kernel.launches = 0
    engine.serving_stats["host_dispatches"] = 0
    outs, wall, ticks = serve(engine, prompts, max_new, dev)
    launches = paged.paged_attention_kernel.launches
    dispatches = engine.serving_stats["host_dispatches"]
    for o in outs:
        if len(o) != max_new or not all(0 <= t < c.vocab_size for t in o):
            raise AssertionError(f"bad generate() output {o[:8]}...")
    if launches != c.num_layers * dispatches or launches == 0:
        raise AssertionError(
            f"kernel launches {launches} != layers {c.num_layers} x "
            f"dispatches {dispatches}")
    pre = [(s, p) for s, p, _ in ticks if p > 0]
    dec = [s for s, p, d in ticks if p == 0 and d > 0]
    stats = dict(
        requests=n_req, new_tokens=max_new, prompt_tokens=int(lens.sum()),
        ticks=len(ticks), dispatches=dispatches, launches=launches,
        prefill_ticks=len(pre),
        prefill_tokens_per_s=sum(p for _, p in pre) / sum(s for s, _ in pre),
        decode_ticks=len(dec),
        decode_ms_per_tick=1e3 * sum(dec) / max(len(dec), 1),
        generate_s=wall,
        e2e_generated_tokens_per_s=n_req * max_new / wall,
        e2e_tokens_per_s=(int(lens.sum()) + n_req * max_new) / wall)
    log(f"[main] {json.dumps(stats)}")
    return engine, stats


# ---------------------------------------------------------------- phase 5
def teacher_forced_logits(model, dev, use_kernel: bool, bs: int, nb=16,
                          lens=(200, 250), attention=None, seed=2):
    """paged_forward over one prefill chunk (two rows of ``lens`` prompt
    tokens) and then two decode ticks whose input tokens are drawn in
    advance (teacher forcing: every variant sees the same inputs), on
    fresh zeroed pools. ``attention`` goes to paged_forward. Returns each
    tick's last-token logits in fp32."""
    import torch
    from deepspeed_tpu_torch.inference.v2.paged import paged_forward
    c = model.config
    dtype = next(iter(model.params.values())).dtype
    shape = (c.num_layers, nb, bs, c.num_kv_heads, c.head_dim)
    pools = {k: torch.zeros(shape, dtype=dtype, device=dev)
             for k in ("k", "v")}
    tables = torch.arange(nb, dtype=torch.int32, device=dev).reshape(2, -1)
    rng = np.random.default_rng(seed)
    prompt = np.zeros((2, max(lens)), np.int64)
    for i, n in enumerate(lens):
        prompt[i, :n] = rng.integers(0, c.vocab_size, n)
    ticks = [(prompt, [0, 0], list(lens))]
    for t in range(2):
        ticks.append((rng.integers(0, c.vocab_size, (2, 1)),
                      [n + t for n in lens], [1, 1]))
    out = []
    for tokens, pos0, true_len in ticks:
        logits, _ = paged_forward(
            model, pools, torch.tensor(tokens, device=dev),
            torch.tensor(pos0, dtype=torch.int32, device=dev), tables,
            torch.tensor(true_len, dtype=torch.int32, device=dev),
            use_kernel=use_kernel, attention=attention)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits on the main path")
        out.append(logits.float())
    return out


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| over the ticks."""
    return max(float((g - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref))


def main_path_kernel_vs_plain(engine, dev, lens=(200, 250), nb=16):
    """Phase 5: the main path with the kernel against the main path with
    the plain attention, on the engine's weights.

    * fp32 (TF32 off), the weights widened: logits of the kernel path
      against the plain reference path (``use_kernel=False``) at 1e-4,
      the fp32 kernel tolerance. Only summation order differs.
    * bf16, the engine as it serves: at every layer of every tick the
      kernel's output against its plain version on the same inputs at
      3e-2 (the bf16 kernel tolerance). The bf16 logits of the kernel
      path, of the plain version and of the reference path are reported
      against each other and against fp32, not held to a bound: with
      random weights a one-ulp difference grows through 32 bf16 layers,
      and the two plain paths differ from each other as much as the
      kernel path differs from either.
    """
    import torch
    from deepspeed_tpu_torch.inference.v2 import paged
    model = engine.model
    bs = engine.state_manager.block_size
    tol = TOL["bfloat16"]

    model32 = type(model)(model.config, device=dev, dtype=torch.float32)
    with torch.no_grad():
        for name, p in model.params.items():
            model32.params[name].copy_(p)
    kernel32 = teacher_forced_logits(model32, dev, True, bs, nb, lens)
    ref32 = teacher_forced_logits(model32, dev, False, bs, nb, lens)
    del model32
    torch.cuda.empty_cache()

    worst = {"layer_calls": 0, "max_abs_err": 0.0}

    def checked(*args, sanitize_pools=True, **kw):
        got = paged.paged_attention_kernel(
            *args, sanitize_pools=sanitize_pools, **kw)
        ref = paged.paged_attention_plain(*args, **kw).float()
        err = (got.float() - ref).abs()
        worst["layer_calls"] += 1
        worst["max_abs_err"] = max(worst["max_abs_err"], float(err.max()))
        if bool((err > tol + tol * ref.abs()).any()):
            raise AssertionError(
                f"main path layer call {worst['layer_calls']}: kernel vs "
                f"plain max|err| {float(err.max()):.3e} > tol {tol:g}")
        return got

    def plain(*args, sanitize_pools=True, **kw):
        return paged.paged_attention_plain(*args, **kw)

    kernel16 = teacher_forced_logits(model, dev, True, bs, nb, lens,
                                     attention=checked)
    plain16 = teacher_forced_logits(model, dev, True, bs, nb, lens,
                                    attention=plain)
    ref16 = teacher_forced_logits(model, dev, False, bs, nb, lens)
    rels = {"fp32_kernel_vs_reference": rel_err(kernel32, ref32),
            "bf16_layer_calls": worst["layer_calls"],
            "bf16_layer_max_abs_err": worst["max_abs_err"],
            "bf16_kernel_vs_reference": rel_err(kernel16, ref16),
            "bf16_plain_vs_reference": rel_err(plain16, ref16),
            "bf16_kernel_vs_fp32": rel_err(kernel16, ref32),
            "bf16_reference_vs_fp32": rel_err(ref16, ref32)}
    log(f"[main vs plain] max|dlogits|/max|logits|: {json.dumps(rels)}")
    if rels["fp32_kernel_vs_reference"] > TOL["float32"]:
        raise AssertionError(f"main path fp32 kernel vs plain: {rels}")
    if worst["layer_calls"] != 3 * model.config.num_layers:
        raise AssertionError(f"{worst['layer_calls']} checked layer calls")
    return rels


# ------------------------------------------------- phase 3, training kernels
FLASH_CASES = {                       # b, s, hq, hkv, d, causal, window
    "causal_d64": (2, 512, 4, 4, 64, True, None),
    "full_d64": (2, 256, 4, 4, 64, False, None),
    "gqa_d64": (1, 512, 8, 2, 64, True, None),
    "window_d64": (2, 512, 4, 2, 64, True, 200),
    "unaligned_s1000": (1, 1000, 4, 2, 64, True, None),
    "causal_d128": (1, 512, 4, 2, 128, True, None),
    "full_gqa_d128": (1, 384, 4, 1, 128, False, None),
}
MAIN_ATTENTION = dict(b=24, s=1024, hq=12, hkv=12, d=64)   # GPT-2 125M
CASES_NOTE = ("FLASH_CASES fp32+bf16: causal/full, GQA, window, S=1000, "
              "D 64/128")


def flash_inputs(dev, dtype, b, s, hq, hkv, d, seed=0):
    """q, k, v, do of one attention call, seeded."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d),
            randn(b, s, hq, d))


def flash_bound(b, s, hq, hkv, d, itemsize, backward=False):
    """Least time (ms) for one causal call: bytes (forward reads q, k, v
    and writes o, lse; backward reads q, k, v, o, do, lse and writes dq,
    dk, dv) over the memory rate, against the products over the tensor
    rate of the type (forward 2, backward 5 matmuls over the S(S+1)/2
    visible pairs); the larger bounds it."""
    qb, kvb, lse = b * s * hq * d * itemsize, b * s * hkv * d * itemsize, \
        b * hq * s * 4
    nbytes = (4 * qb + 4 * kvb + lse) if backward else (2 * qb + 2 * kvb
                                                         + lse)
    pairs = s * (s + 1) // 2
    flops = (10 if backward else 4) * b * hq * pairs * d
    rate = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_max(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def flash_checks(dev):
    """Forward and backward kernels against their plain versions (and,
    fp32, the backward against autograd through the plain forward) over
    FLASH_CASES in fp32 and bf16. Forward o within the dtype's tolerance
    (abs + rel); grads within it relative to their largest element."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as fa
    errs = {}
    for dtype_name, tol in TOL.items():
        dtype = getattr(torch, dtype_name)
        for name, (b, s, hq, hkv, d, causal, window) in FLASH_CASES.items():
            q, k, v, do = flash_inputs(dev, dtype, b, s, hq, hkv, d, seed=1)
            kw = dict(causal=causal, window=window)
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
            grads = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
            refs = fa.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                                **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs()
            fwd_bad = bool((err > tol + tol * o_ref.float().abs()).any())
            lse_err = float((lse - lse_ref).abs().max())
            rel = {f"d{n}": rel_max(g, r) for n, g, r in zip("qkv", grads,
                                                             refs)}
            if dtype_name == "float32":
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                out, _ = fa.flash_attention_fwd_plain(*leaves, **kw)
                out.backward(do)
                rel.update({f"d{n}_vs_autograd": rel_max(g, leaf.grad)
                            for n, g, leaf in zip("qkv", grads, leaves)})
            errs[(dtype_name, name)] = dict(
                fwd_max_abs_err=float(err.max()), lse_max_abs_err=lse_err,
                bwd_max_abs_err=max(float((g.float() - r.float()).abs().max())
                                    for g, r in zip(grads, refs)),
                bwd_max_rel_err=max(rel.values()))
            log(f"[kernel] flash {name:16s} {dtype_name:9s} "
                f"{json.dumps(errs[(dtype_name, name)])}")
            if fwd_bad or lse_err > 1e-4 or max(rel.values()) > tol:
                raise AssertionError(
                    f"flash attention kernels disagree with their plain "
                    f"versions: {name} {dtype_name}: "
                    f"{errs[(dtype_name, name)]} {rel} (tol {tol:g})")
    return errs


def adam_checks(dev):
    """Fused-Adam kernel against the plain version: sizes that are no
    multiple of 4 or 128, AdamW and L2, a warmup schedule, a clip
    coefficient, the bf16 copy, 3 steps; 1e-6 absolute + 1e-5 relative."""
    import torch
    from deepspeed_tpu_torch.ops.fused_optimizers import Adam
    from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule
    sched = build_schedule("WarmupLR", {"warmup_num_steps": 5}, 1e-2)
    worst = 0.0
    for n in (1, 3, 127, 128, 1000, 4099, (1 << 20) + 5):
        g = torch.Generator(device=dev).manual_seed(n)
        p0 = torch.randn(n, generator=g, device=dev)
        grad = torch.randn(n, generator=g, device=dev)
        for adamw in (True, False):
            runs = []
            for fused in (True, False):
                opt = Adam(sched, weight_decay=0.05, adamw_mode=adamw,
                           fused=fused)
                p = p0.clone()
                state = opt.init(p)
                out = torch.empty(n, dtype=torch.bfloat16, device=dev)
                coef = torch.tensor(0.6, device=dev)
                for _ in range(3):
                    opt.step(state, p, grad, coef=coef, out=out)
                runs.append((p, state["exp_avg"], state["exp_avg_sq"], out))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            for got, ref in zip(*runs):
                err = (got.float() - ref.float()).abs()
                worst = max(worst, float(err.max()))
                if bool((err > ADAM_TOL[0] + ADAM_TOL[1]
                         * ref.float().abs()).any()):
                    raise AssertionError(
                        f"fused Adam kernel disagrees with its plain "
                        f"version: n={n} adamw={adamw} max|err| "
                        f"{float(err.max()):.3e}")
    log(f"[kernel] fused_adam 7 sizes x AdamW/L2 x 3 steps: max|err| "
        f"{worst:.3e} (atol {ADAM_TOL[0]:g}, rtol {ADAM_TOL[1]:g})")
    return worst


def flash_main_check(q, k, v, do):
    """Forward and backward kernels against their plain versions on one
    set of main-path inputs (bf16): o within TOL abs + rel, lse within
    1e-4, dq/dk/dv within TOL of their largest element, as in
    flash_checks. Returns the kernel's (o, lse) and the errors."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as fa
    tol = TOL["bfloat16"]
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    err = (o.float() - o_ref.float()).abs()
    fwd_bad = bool((err > tol + tol * o_ref.float().abs()).any())
    del o_ref
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    check = dict(
        fwd_max_abs_err=float(err.max()),
        lse_max_abs_err=float((lse - lse_ref).abs().max()),
        bwd_max_abs_err=max(float((g.float() - r.float()).abs().max())
                            for g, r in zip(grads, refs)),
        bwd_max_rel_err=max(rel_max(g, r) for g, r in zip(grads, refs)))
    log(f"[kernel] flash main shape {json.dumps(MAIN_ATTENTION)} bf16 "
        f"causal, kernel vs plain: {json.dumps(check)}")
    if fwd_bad or check["lse_max_abs_err"] > 1e-4 \
            or check["bwd_max_rel_err"] > tol:
        raise AssertionError(
            f"flash attention kernels disagree with their plain versions at "
            f"the main path's shape: {check} (tol {tol:g})")
    return o, lse, check


def adam_main_check(p, grad, m, v, hp, out_dtype, **kw):
    """Fused-Adam kernel against the plain version on clones of the main
    path's buffers, one step with the compute copy: p, m, v within
    ADAM_TOL; the kernel's copy is exactly its own new p rounded; the
    copies of the two versions differ by at most one rounding step of the
    copy's type (2^-7 relative for bf16), where p's last-bit difference
    straddles a rounding boundary."""
    import torch
    from deepspeed_tpu_torch.ops.fused_optimizers import (adam_plain,
                                                          fused_adam_step)
    runs = []
    for step in (fused_adam_step, adam_plain):
        bufs = [t.clone() for t in (p, m, v)]
        out = torch.empty(p.numel(), dtype=out_dtype, device=p.device)
        step(bufs[0], grad, bufs[1], bufs[2], hp, out=out, **kw)
        runs.append((*bufs, out))
    (kp, km, kv, kout), (rp, rm, rv, rout) = runs
    check, bad = {}, []
    for name, got, ref in (("p", kp, rp), ("m", km, rm), ("v", kv, rv)):
        err = (got - ref).abs()
        check[f"{name}_max_abs_err"] = float(err.max())
        if bool((err > ADAM_TOL[0] + ADAM_TOL[1] * ref.abs()).any()):
            bad.append(name)
    if not torch.equal(kout, kp.to(out_dtype)):
        bad.append("copy is not the kernel's own p")
    err = (kout.float() - rout.float()).abs()
    check["copy_max_abs_err"] = float(err.max())
    if bool((err > ADAM_TOL[0] + 2.0**-7 * rout.float().abs()).any()):
        bad.append("copy")
    del runs, kp, km, kv, kout, rp, rm, rv, rout
    log(f"[kernel] fused_adam over {p.numel()} params, kernel vs plain: "
        f"{json.dumps(check)}")
    if bad:
        raise AssertionError(
            f"fused Adam kernel disagrees with its plain version at the "
            f"main path's size: {bad} {check}")
    return check


def train_kernel_times(dev, adam_numel: int, flush=None, iters=20):
    """Flash forward and backward at GPT-2 125M's attention shapes (bf16,
    B 24, S 1024, 12 heads of 64, causal) and fused Adam over the model's
    flat buffers: each kernel held against its plain version on these
    inputs first, then kernel, plain, library and bound times in ms."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_optimizers import (adam_plain,
                                                          fused_adam_step)
    shape = MAIN_ATTENTION
    q, k, v, do = flash_inputs(dev, torch.bfloat16, **shape, seed=2)
    o, lse, flash_check = flash_main_check(q, k, v, do)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    qt, kt, vt, dot = (t.transpose(1, 2).detach() for t in (q, k, v, do))
    leaves = [t.requires_grad_() for t in (qt, kt, vt)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_err = float((lib_out.detach().transpose(1, 2).float()
                     - o.float()).abs().max())
    rec = {}
    bound, by = flash_bound(**shape, itemsize=2)
    rec["flash_attention_fwd"] = dict(
        ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v), dev, iters,
                   flush),
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v), dev,
                         max(iters // 4, 2), flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), dev, iters, flush),
        bound_ms=bound, bound_by=by, library_max_abs_err=lib_err,
        check=flash_check)
    bound, by = flash_bound(**shape, itemsize=2, backward=True)
    rec["flash_attention_bwd"] = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), dev,
                   iters, flush),
        plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do), dev, max(iters // 4, 2), flush),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dot, retain_graph=True), dev, iters, flush),
        library_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, is_causal=True), leaves,
            dot), dev, iters, flush),
        bound_ms=bound, bound_by=by, check=flash_check)
    del lib_out, leaves
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        times = {key: x for key, x in rec[name].items() if key != "check"}
        log(f"[kernel] {name} times (ms) at B=24 S=1024 H=12 D=64 bf16 "
            f"causal: {json.dumps(times)}")

    # fused Adam over GPT-2 125M's flat buffers (+ the bf16 compute copy)
    n = adam_numel
    g = torch.Generator(device=dev).manual_seed(3)
    p, grad = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    m = torch.zeros(n, device=dev)
    vv = torch.zeros(n, device=dev)
    out = torch.empty(n, dtype=torch.bfloat16, device=dev)
    hp = torch.tensor([1e-4, 0.9, 0.999, 1e-8, 10.0, 1000.0, 1.0, 1.0],
                      device=dev)
    kw = dict(weight_decay=0.01, adamw_mode=True)
    adam_check = adam_main_check(p, grad, m, vv, hp, torch.bfloat16, **kw)
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = grad.clone()
    lib_opt = torch.optim.AdamW([lib_p], lr=1e-4, weight_decay=0.01,
                                fused=dev.type == "cuda")
    read_write = 16 + 12                  # p, g, m, v in; p, m, v out
    t_bytes = n * (read_write + 2) / HBM_BYTES_PER_S
    t_ops = 15 * n / FP32_FLOPS
    rec["fused_adam"] = dict(
        ms=time_ms(lambda: fused_adam_step(p, grad, m, vv, hp, out=out, **kw),
                   dev, iters, flush),
        plain_ms=time_ms(lambda: adam_plain(p, grad, m, vv, hp, out=out,
                                            **kw), dev, max(iters // 4, 2),
                         flush),
        library_ms=time_ms(lib_opt.step, dev, iters, flush),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_ms_without_bf16_copy=n * read_write / HBM_BYTES_PER_S * 1e3,
        numel=n)
    log(f"[kernel] fused_adam times (ms) over {n} fp32 params + bf16 copy: "
        f"{json.dumps(rec['fused_adam'])}")
    rec["fused_adam"]["check"] = adam_check
    return rec


# ------------------------------------------------ phase 6, training main path
def train_batch_of(dev, vocab, rows, seq, seed=5):
    """(tokens, targets) of random tokens, [rows, seq] each, on dev."""
    import torch
    tok = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1))
    tok = torch.from_numpy(tok).to(dev)
    return tok[:, :-1], tok[:, 1:]


def train_main_path(dev, size="125m", steps=10, seq=1024):
    """Phase 6: initialize(GPT-2 125M ...) -> train_batch, one warm-up
    step then ``steps`` timed steps on one fixed batch; each step is timed
    on the host clock up to a synchronize. Every count is set to 0 right
    before the timed steps and read right after."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_optimizers import fused_adam_step
    model = GPT2(size=size, vocab_size=50304, remat_policy="segments",
                 attn_impl="flash", device=dev)
    t = time.perf_counter()
    engine, _, _, _ = ds.initialize(model=model, config=TRAIN_CONFIG)
    c = model.config
    log(f"[train] initialize gpt2-{size} ({c.num_params()} params): "
        f"{time.perf_counter() - t:.1f} s")
    rows = engine.train_batch_size_
    batch = train_batch_of(dev, c.vocab_size, rows, seq)
    engine.train_batch(batch)                                  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_bwd.calls = 0
    fused_adam_step.launches = 0
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(engine.train_batch(batch))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_attention_bwd": fa.flash_attention_bwd.launches,
                "flash_attention_bwd_calls": fa.flash_attention_bwd.calls,
                "fused_adam": fused_adam_step.launches}
    losses = [float(x) for x in losses]
    tokens = rows * seq
    tok_s = tokens * steps / sum(step_s)
    stats = dict(
        model=f"gpt2-{size} vocab {c.vocab_size}", params=c.num_params(),
        batch=rows, seq=seq, steps=steps,
        step_ms=1e3 * sum(step_s) / steps,
        step_ms_min=1e3 * min(step_s), step_ms_max=1e3 * max(step_s),
        tokens_per_s=tok_s,
        mfu=c.flops_per_token(seq, causal=True) * tok_s / BF16_FLOPS,
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None),
        losses=losses, grad_norm=engine.get_global_grad_norm(),
        launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()})
    log(f"[train] {json.dumps(stats)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    want = {"flash_attention_fwd": c.num_layers * steps,
            "flash_attention_bwd": 2 * c.num_layers * steps,
            "flash_attention_bwd_calls": c.num_layers * steps,
            "fused_adam": steps}
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"training launches {launches} != {want} (one "
                             f"forward and one backward call per layer, "
                             f"two backward launches per call, no forward "
                             f"rerun under segments, one Adam launch)")
    return engine, batch, stats


# ------------------------------------------- phase 7, kernels against plain
def train_path_kernel_vs_plain(dev, size="125m", rows=2, seq=1024, steps=3):
    """The training path with the kernels (flash attention, fused Adam)
    against the plain path (reference attention, plain Adam) from the same
    initial weights, ``steps`` steps on one batch.

    fp32, TF32 off: the two paths differ only in the order of sums inside
    attention and in the update's rounding, so
      * the loss of every step agrees to 1e-5 relative;
      * the first step's grads to 1e-4 of their largest element;
      * the params after ``steps`` steps to 1e-3 of the norm of their total
        change: Adam's first updates are ~lr*sign(g), so a grad that is
        zero up to rounding moves an element by up to 2*lr on either
        side, which a norm tolerates and a worst-element bound would not.
    bf16: the same three numbers are reported without a bound (bf16 rounds
    at different points in the two attention paths)."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    out = {}
    for dtype in ("float32", "bfloat16"):
        runs = []
        init = None
        for kernels in (True, False):
            cfg = dict(TRAIN_CONFIG, train_batch_size=rows,
                       bf16={"enabled": dtype == "bfloat16"})
            cfg["optimizer"] = {"type": "FusedAdam", "params": dict(
                TRAIN_CONFIG["optimizer"]["params"], fused_kernel=kernels)}
            model = GPT2(size=size, vocab_size=50304,
                         remat_policy="segments", device=dev,
                         attn_impl="flash" if kernels else "reference")
            engine, _, _, _ = ds.initialize(model=model, config=cfg,
                                            model_parameters=init)
            if init is None:
                init = {n: t.clone() for n, t in
                        engine.master_state_dict().items()}
            start = engine._master.clone()
            batch = train_batch_of(dev, model.config.vocab_size, rows, seq,
                                   seed=7)
            losses, grads = [], None
            for step in range(steps):
                losses.append(float(engine.train_batch(batch)))
                if step == 0:
                    grads = engine._grads.clone()
            runs.append((losses, grads, engine._master - start))
            del engine, model
        (kl, kg, kp), (pl, pg, pp) = runs      # kp, pp: change of params
        moved = float(torch.linalg.vector_norm(pp))
        rec = dict(
            loss_kernel=kl, loss_plain=pl,
            loss_max_rel_err=max(abs(a - b) / abs(b) for a, b in zip(kl, pl)),
            grad_max_err_rel_to_max=float((kg - pg).abs().max()
                                          / pg.abs().max()),
            params_err_rel_to_change=float(torch.linalg.vector_norm(kp - pp))
            / moved, params_total_change=moved)
        out[dtype] = rec
        log(f"[train vs plain] {dtype}: {json.dumps(rec)}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    r = out["float32"]
    if (r["loss_max_rel_err"] > 1e-5 or r["grad_max_err_rel_to_max"] > 1e-4
            or r["params_err_rel_to_change"] > 1e-3):
        raise AssertionError(f"training path fp32 kernels vs plain: {r}")
    return out


# ------------------------------------------- phase 3, Path T and Path P kernels
SPARSE_CASES = {       # b, h, s, d, layout kwargs
    "fixed_s256": (2, 4, 256, 64, dict(block=16)),
    "bigbird_block32_d32": (2, 2, 512, 32, dict(block=32)),
    "block8_d24": (1, 2, 256, 24, dict(block=8)),
    "d128_block64": (1, 2, 1024, 128, dict(block=64)),
}
SPARSE_NOTE = ("SPARSE_CASES fp32+bf16: Fixed/BigBird layouts, blocks 8-64, "
               "D 24-128")


def sparse_layout(h, s, block, **kw):
    """A Fixed layout (Path P's kwargs for the main shape), or BigBird
    for block 32, for ``h`` heads over ``s`` tokens."""
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    if block == 32:
        return tsa.BigBirdSparsityConfig(num_heads=h, block=block,
                                         num_random_blocks=2).make_layout(s)
    return tsa.FixedSparsityConfig(num_heads=h, block=block,
                                   **kw).make_layout(s)


def sparse_inputs(dev, dtype, b, h, s, d, seed=0):
    """q, k, v, do of one call, [B, H, S, D], seeded."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)
            for _ in range(4)]


def sparse_compare(q, k, v, do, maps, tol):
    """Block-sparse forward and backward kernels against their plain
    versions on the same inputs: o and dq/dk/dv within ``tol`` of their
    largest element, lse within 1e-5 of its largest. Returns the kernel's
    (o, lse) and the errors; raises on disagreement."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, maps)
    o_ref, lse_ref = bsa.block_sparse_attention_fwd_plain(q, k, v, maps)
    grads = bsa.block_sparse_attention_bwd(q, k, v, o_ref, lse_ref, do, maps)
    refs = bsa.block_sparse_attention_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                                maps)
    if q.device.type == "cuda":
        torch.cuda.synchronize()
    check = dict(
        fwd_max_abs_err=float((o.float() - o_ref.float()).abs().max()),
        fwd_max_rel_err=rel_max(o, o_ref),
        lse_max_rel_err=rel_max(lse, lse_ref),
        bwd_max_abs_err=max(float((g.float() - r.float()).abs().max())
                            for g, r in zip(grads, refs)),
        bwd_max_rel_err=max(rel_max(g, r) for g, r in zip(grads, refs)))
    if (check["fwd_max_rel_err"] > tol or check["lse_max_rel_err"] > 1e-5
            or check["bwd_max_rel_err"] > tol):
        raise AssertionError(f"block-sparse kernels disagree with their "
                             f"plain versions: {check} (tol {tol:g})")
    return o, lse, check


def sparse_checks(dev):
    """Block-sparse kernels against their plain versions over
    SPARSE_CASES in fp32 and bf16, relative to the largest element."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
    errs = {}
    for dtype_name, tol in TOL.items():
        for name, (b, h, s, d, lay) in SPARSE_CASES.items():
            layout = sparse_layout(h, s, **lay)
            maps = bsa.block_maps(layout, dev, lay["block"])
            q, k, v, do = sparse_inputs(dev, getattr(torch, dtype_name), b, h,
                                        s, d, seed=1)
            errs[(dtype_name, name)] = sparse_compare(q, k, v, do, maps,
                                                      tol)[2]
            log(f"[kernel] block-sparse {name:20s} {dtype_name:9s} "
                f"{json.dumps(errs[(dtype_name, name)])}")
    return errs


def lion_checks(dev):
    """Fused-Lion kernel against the plain version: sizes that are no
    multiple of 4 or 128, with and without weight decay, a warmup
    schedule, a clip coefficient, the bf16 copy, 3 steps on fresh grads;
    1e-6 absolute + 1e-5 relative (the kernel rounds each product and sum
    on its own, as the plain version's passes do, so it is expected to
    give the same bits)."""
    import torch
    from deepspeed_tpu_torch.ops.fused_optimizers import Lion
    from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule
    sched = build_schedule("WarmupLR", {"warmup_num_steps": 5}, 1e-2)
    worst, identical = 0.0, True
    for n in (1, 3, 127, 128, 1000, 4099, (1 << 16) + 5, (1 << 20) + 5):
        g = torch.Generator(device=dev).manual_seed(n)
        p0 = torch.randn(n, generator=g, device=dev)
        grads = [torch.randn(n, generator=g, device=dev) for _ in range(3)]
        for wd in (0.0, 0.05):
            runs = []
            for fused in (True, False):
                opt = Lion(sched, weight_decay=wd, fused=fused)
                p = p0.clone()
                state = opt.init(p)
                out = torch.empty(n, dtype=torch.bfloat16, device=dev)
                coef = torch.tensor(0.6, device=dev)
                for grad in grads:
                    opt.step(state, p, grad, coef=coef, out=out)
                runs.append((p, state["exp_avg"], out))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            for got, ref in zip(*runs):
                identical &= torch.equal(got, ref)
                err = (got.float() - ref.float()).abs()
                worst = max(worst, float(err.max()))
                if bool((err > ADAM_TOL[0] + ADAM_TOL[1]
                         * ref.float().abs()).any()):
                    raise AssertionError(
                        f"fused Lion kernel disagrees with its plain "
                        f"version: n={n} wd={wd} max|err| "
                        f"{float(err.max()):.3e}")
    log(f"[kernel] fused_lion 8 sizes x wd 0/0.05 x 3 steps: max|err| "
        f"{worst:.3e} (atol {ADAM_TOL[0]:g}, rtol {ADAM_TOL[1]:g}), "
        f"bitwise equal: {identical}")
    return worst, identical


def lion_main_check(p, grad, m, hp, out_dtype, **kw):
    """Fused-Lion kernel against the plain version on clones of the main
    path's buffers, one step with the compute copy: p and m within
    ADAM_TOL, the copy exactly the kernel's own new p rounded, and whether
    all three came out bitwise equal to the plain version's."""
    import torch
    from deepspeed_tpu_torch.ops.fused_optimizers import (fused_lion_step,
                                                          lion_plain)
    runs = []
    for step in (fused_lion_step, lion_plain):
        bufs = [t.clone() for t in (p, m)]
        out = torch.empty(p.numel(), dtype=out_dtype, device=p.device)
        step(bufs[0], grad, bufs[1], hp, out=out, **kw)
        runs.append((*bufs, out))
    (kp, km, kout), (rp, rm, rout) = runs
    check, bad = {}, []
    for name, got, ref in (("p", kp, rp), ("m", km, rm)):
        err = (got - ref).abs()
        check[f"{name}_max_abs_err"] = float(err.max())
        if bool((err > ADAM_TOL[0] + ADAM_TOL[1] * ref.abs()).any()):
            bad.append(name)
    if not torch.equal(kout, kp.to(out_dtype)):
        bad.append("copy is not the kernel's own p")
    check["copy_max_abs_err"] = float((kout.float() - rout.float()).abs()
                                      .max())
    check["bitwise_equal"] = all(torch.equal(a, b) for a, b in
                                 zip(runs[0], runs[1]))
    del runs, kp, km, kout, rp, rm, rout
    log(f"[kernel] fused_lion over {p.numel()} params, kernel vs plain: "
        f"{json.dumps(check)}")
    if bad:
        raise AssertionError(
            f"fused Lion kernel disagrees with its plain version at the "
            f"main path's size: {bad} {check}")
    return check


def sparse_bound(maps, b, h, s, d, itemsize, backward=False):
    """Least time (ms) for one call on these inputs: the live blocks'
    products (forward 2: q k^T and p v; backward 5: q k^T, do v^T, p^T do,
    ds^T q, ds k) over the tensor rate of the type, against the bytes
    (forward: q, k, v and the block lists in, o and lse out; backward: q,
    k, v, o, do, lse and the lists in, dq, dk, dv out) over the memory
    rate; the larger bounds it."""
    live = int(maps.counts.sum())
    blk = maps.block
    flops = (10 if backward else 4) * b * live * blk * blk * d
    x = b * h * s * d * itemsize
    lists = 4 * sum(t.numel() for t in (maps.jmap, maps.counts) +
                    ((maps.imap, maps.countsT) if backward else ()))
    lse = b * h * s * 4
    nbytes = (8 * x + lse if backward else 4 * x + lse) + lists
    rate = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            dict(live_blocks=live, gflop=flops / 1e9, mbytes=nbytes / 1e6))


def path_kernel_times(dev, lion_numel: int, flush=None, iters=20):
    """Fused Lion over Path T's flat buffers (124,475,904 fp32 values + the
    bf16 copy) and the block-sparse forward and backward at Path P's
    shape: each held against its plain version on these inputs first,
    then kernel, plain, library and bound times in ms."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.fused_optimizers import (fused_lion_step,
                                                          lion_plain)
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
    rec = {}
    n = lion_numel
    g = torch.Generator(device=dev).manual_seed(4)
    p, grad = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    m = torch.randn(n, generator=g, device=dev) * 0.1
    out = torch.empty(n, dtype=torch.bfloat16, device=dev)
    hp = torch.tensor([1e-4, 0.9, 0.99, 0.5, 1.0], device=dev)
    kw = dict(weight_decay=0.01)
    lion_check = lion_main_check(p, grad, m, hp, torch.bfloat16, **kw)
    t_bytes = n * (12 + 8 + 2) / HBM_BYTES_PER_S    # p, g, m in; p, m, copy
    t_ops = 10 * n / FP32_FLOPS
    rec["fused_lion"] = dict(
        ms=time_ms(lambda: fused_lion_step(p, grad, m, hp, out=out, **kw),
                   dev, iters, flush),
        plain_ms=time_ms(lambda: lion_plain(p, grad, m, hp, out=out, **kw),
                         dev, max(iters // 4, 2), flush),
        library_ms=None, library="no single PyTorch call computes Lion "
                                 "(torch.optim has none)",
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_ms_without_bf16_copy=n * 20 / HBM_BYTES_PER_S * 1e3,
        numel=n, check=lion_check)
    log(f"[kernel] fused_lion times (ms) over {n} fp32 params + bf16 copy: "
        f"{json.dumps({k: v for k, v in rec['fused_lion'].items() if k != 'check'})}")
    del p, grad, m, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    shape = PATH_P
    layout = sparse_layout(shape["h"], shape["s"], **PATH_P_LAYOUT)
    maps = bsa.block_maps(layout, dev, PATH_P_LAYOUT["block"])
    q, k, v, do = sparse_inputs(dev, torch.bfloat16, **shape, seed=5)
    o, lse, sparse_check = sparse_compare(q, k, v, do, maps, TOL["bfloat16"])
    log(f"[kernel] block-sparse Path P {json.dumps(shape)} bf16, kernel vs "
        f"plain: {json.dumps(sparse_check)}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mask = torch.stack([bsa.live_mask(maps, i) for i in range(shape["h"])])[None]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    lib_err = rel_max(lib_out.detach(), o)
    for name, backward in (("block_sparse_attention_fwd", False),
                           ("block_sparse_attention_bwd", True)):
        bound, by, work = sparse_bound(maps, **shape, itemsize=2,
                                       backward=backward)
        if backward:
            times = dict(
                ms=time_ms(lambda: bsa.block_sparse_attention_bwd(
                    q, k, v, o, lse, do, maps), dev, iters, flush),
                plain_ms=time_ms(lambda: bsa.block_sparse_attention_bwd_plain(
                    q, k, v, o, lse, do, maps), dev, 2, flush),
                library_ms=time_ms(lambda: torch.autograd.grad(
                    lib_out, leaves, do, retain_graph=True), dev, iters,
                    flush))
        else:
            times = dict(
                ms=time_ms(lambda: bsa.block_sparse_attention_fwd(
                    q, k, v, maps), dev, iters, flush),
                plain_ms=time_ms(lambda: bsa.block_sparse_attention_fwd_plain(
                    q, k, v, maps), dev, 2, flush),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), dev, iters, flush))
        rec[name] = dict(times, bound_ms=bound, bound_by=by,
                         library="SDPA with the expanded layout as a "
                                 "boolean mask",
                         library_o_max_rel_err=lib_err, check=sparse_check,
                         **work)
        log(f"[kernel] {name} times (ms) at B=8 H=12 S=4096 D=64 bf16 "
            f"fixed layout: {json.dumps({k: v for k, v in rec[name].items() if k != 'check'})}")
    del lib_out, leaves, mask
    return rec


# ------------------------------------------------- phase 8, Path T at width
def triple_step(engine, batch, ga):
    """One step of DeepSpeed's loop over the batch's ga micro-batches:
    loss = engine(micro); engine.backward(loss) each; then engine.step().
    Returns the mean micro loss (a device tensor)."""
    import torch
    tokens, targets = batch
    mb = tokens.shape[0] // ga
    losses = []
    for i in range(ga):
        loss = engine((tokens[i * mb:(i + 1) * mb],
                       targets[i * mb:(i + 1) * mb]))
        engine.backward(loss)
        losses.append(loss.detach())
    if not engine.is_gradient_accumulation_boundary():
        raise AssertionError("no gradient-accumulation boundary after "
                             f"{ga} micro-batches")
    engine.step()
    return torch.stack(losses).mean()


def path_t_main(dev, size="125m", steps=10, seq=1024):
    """Phase 8: initialize(GPT-2 125M, loss_chunk 256, fused Lion, GA 2)
    -> per step two engine(micro) + engine.backward(loss), engine.step();
    one warm-up step then ``steps`` timed steps on one fixed batch, each
    timed on the host clock up to a synchronize. Every count is set to 0
    right before the timed steps and read right after."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_optimizers import (fused_adam_step,
                                                          fused_lion_step)
    model = GPT2(size=size, device=dev, **PATH_T_MODEL)
    engine, _, _, _ = ds.initialize(model=model, config=PATH_T_CONFIG)
    c = model.config
    ga = engine.gradient_accumulation_steps_
    rows = engine.train_batch_size_
    batch = train_batch_of(dev, c.vocab_size, rows, seq, seed=6)
    triple_step(engine, batch, ga)                            # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_bwd.calls = 0
    fused_adam_step.launches = 0
    fused_lion_step.launches = 0
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(triple_step(engine, batch, ga))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_attention_bwd": fa.flash_attention_bwd.launches,
                "flash_attention_bwd_calls": fa.flash_attention_bwd.calls,
                "fused_lion": fused_lion_step.launches,
                "fused_adam": fused_adam_step.launches}
    losses = [float(x) for x in losses]
    tok_s = rows * seq * steps / sum(step_s)
    stats = dict(
        model=f"gpt2-{size} vocab {c.vocab_size} loss_chunk {c.loss_chunk}",
        params=c.num_params(), batch=rows, micro_batch=rows // ga, ga=ga,
        seq=seq, steps=steps, optimizer="Lion fused_kernel",
        step_ms=1e3 * sum(step_s) / steps,
        step_ms_min=1e3 * min(step_s), step_ms_max=1e3 * max(step_s),
        tokens_per_s=tok_s,
        mfu=c.flops_per_token(seq, causal=True) * tok_s / BF16_FLOPS,
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None),
        losses=losses, grad_norm=engine.get_global_grad_norm(),
        global_steps=engine.global_steps, launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()})
    log(f"[path T] {json.dumps(stats)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Path T losses not finite and falling: "
                             f"{losses}")
    calls = c.num_layers * ga * steps
    want = {"flash_attention_fwd": calls, "flash_attention_bwd": 2 * calls,
            "flash_attention_bwd_calls": calls, "fused_lion": steps,
            "fused_adam": 0}
    if dev.type == "cuda" and launches != want:
        raise AssertionError(
            f"Path T launches {launches} != {want} (one forward and one "
            f"backward flash call per layer and micro-batch, two backward "
            f"launches per call, one Lion launch per step, no Adam)")
    return engine, batch, stats


# --------------------------------- phase 9, Path T kernels against plain
def path_t_kernel_vs_plain(dev, size="125m", rows=2, seq=1024, steps=3):
    """Three engines of Path T's configuration from the same weights, fp32
    with TF32 off, GA 2, on one batch for ``steps`` steps:

      * kernels, the triple: flash attention, fused Lion;
      * plain Lion, the triple: the same with fused_kernel off, so the
        step is lion_plain (attention stays on the flash kernels, held
        against its plain version in phase 7);
      * kernels, train_batch.

    The losses of every step agree to 1e-5 relative and the params after
    ``steps`` steps to 1e-3 of the norm of their total change. The kernel
    rounds as the plain version does and both loops run the same two
    halves, so they are expected to agree exactly."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    runs, init = {}, None
    for name, fused, loop in (("kernels_triple", True, "triple"),
                              ("plain_lion_triple", False, "triple"),
                              ("kernels_train_batch", True, "train_batch")):
        cfg = dict(PATH_T_CONFIG, train_batch_size=rows, bf16={
            "enabled": False})
        cfg["optimizer"] = {"type": "Lion", "params": dict(
            PATH_T_CONFIG["optimizer"]["params"], fused_kernel=fused)}
        model = GPT2(size=size, device=dev, **PATH_T_MODEL)
        engine, _, _, _ = ds.initialize(model=model, config=cfg,
                                        model_parameters=init)
        if init is None:
            init = {n: t.clone() for n, t in
                    engine.master_state_dict().items()}
        start = engine._master.clone()
        batch = train_batch_of(dev, model.config.vocab_size, rows, seq,
                               seed=8)
        ga = engine.gradient_accumulation_steps_
        losses = []
        for _ in range(steps):
            loss = (triple_step(engine, batch, ga) if loop == "triple"
                    else engine.train_batch(batch))
            losses.append(float(loss))
        runs[name] = (losses, engine._master - start)
        del engine, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    ref_losses, ref_change = runs["kernels_triple"]
    moved = float(torch.linalg.vector_norm(ref_change))
    out = {"params_total_change": moved}
    for name in ("plain_lion_triple", "kernels_train_batch"):
        losses, change = runs[name]
        out[name] = dict(
            losses=losses, loss_max_rel_err=max(
                abs(a - b) / abs(b) for a, b in zip(ref_losses, losses)),
            params_err_rel_to_change=float(torch.linalg.vector_norm(
                ref_change - change)) / moved,
            params_equal=bool(torch.equal(ref_change, change)))
    out["kernels_triple_losses"] = ref_losses
    log(f"[path T vs plain] fp32: {json.dumps(out)}")
    for name in ("plain_lion_triple", "kernels_train_batch"):
        r = out[name]
        if r["loss_max_rel_err"] > 1e-5 or r["params_err_rel_to_change"] > 1e-3:
            raise AssertionError(f"Path T kernels_triple vs {name}: {r}")
    return out


# ----------------------------------------------- phase 10, Path P at width
def path_p_main(dev, small=dict(b=2, h=4, s=256, d=64)):
    """SparseSelfAttention at Path P's shape (bf16), forward and backward
    through autograd as a caller runs it: a first call, which also builds
    the layout and its block lists on the host and copies them to the
    card once, then a second call, timed, with the counts set to 0 right
    before and read right after: one forward and two backward launches.
    Then the output and grads are held against the plain versions on the
    same inputs (bf16 3e-2 of the largest element, lse 1e-5), and the same
    module in fp32 at a small shape at 1e-4."""
    import torch
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
    out = {}
    for dtype_name, shape in (("bfloat16", PATH_P), ("float32", small)):
        dtype = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        attn = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
            num_heads=shape["h"], **PATH_P_LAYOUT))
        q, k, v, do = sparse_inputs(dev, dtype, **shape, seed=9)
        walls = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            bsa.block_sparse_attention_fwd.launches = 0
            bsa.block_sparse_attention_bwd.launches = 0
            t = time.perf_counter()
            o = attn(*leaves)
            o.backward(do)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        launches = {"block_sparse_attention_fwd":
                    bsa.block_sparse_attention_fwd.launches,
                    "block_sparse_attention_bwd":
                    bsa.block_sparse_attention_bwd.launches}
        fn = attn._kernel(shape["s"], shape["h"], shape["d"])
        maps = fn.maps(dev, shape["s"])
        o_ref, lse_ref = bsa.block_sparse_attention_fwd_plain(q, k, v, maps)
        refs = bsa.block_sparse_attention_bwd_plain(q, k, v, o_ref, lse_ref,
                                                    do, maps)
        _, lse = bsa.block_sparse_attention_fwd(q, k, v, maps)
        rec = dict(
            shape=shape, dtype=dtype_name, fwd_bwd_wall_ms=walls[1],
            first_call_wall_ms=walls[0],
            launches=launches, finite=bool(torch.isfinite(o).all()),
            fwd_max_abs_err=float((o.detach().float() - o_ref.float()).abs()
                                  .max()),
            fwd_max_rel_err=rel_max(o.detach(), o_ref),
            lse_max_rel_err=rel_max(lse, lse_ref),
            bwd_max_rel_err=max(rel_max(t.grad, r)
                                for t, r in zip(leaves, refs)),
            density=bsa.sparsity_stats(fn.layout)["density"])
        out[dtype_name] = rec
        log(f"[path P] {json.dumps(rec)}")
        del leaves, o, o_ref, refs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if (not rec["finite"] or rec["fwd_max_rel_err"] > tol
                or rec["lse_max_rel_err"] > 1e-5
                or rec["bwd_max_rel_err"] > tol):
            raise AssertionError(f"Path P kernels vs plain: {rec} "
                                 f"(tol {tol:g})")
        if dev.type == "cuda" and launches != {
                "block_sparse_attention_fwd": 1,
                "block_sparse_attention_bwd": 2}:
            raise AssertionError(f"Path P launches {launches} != one "
                                 f"forward and two backward")
    return out


def flat_numel(size: str) -> int:
    """Length of the engine's flat master for GPT-2 ``size`` (vocab
    50304), from a model on the meta device."""
    from deepspeed_tpu_torch.models import GPT2
    from deepspeed_tpu_torch.runtime.engine import _flat_layout
    return _flat_layout(GPT2(size=size, vocab_size=50304,
                             device="meta").params)[1]


# --------------------------------------------------------- --profile
# device kernels by kind, matched on their names in this order
PROFILE_KINDS = {
    "flash_attention": ("flash_fwd_kernel", "flash_bwd_"),
    "paged_attention": ("paged_attention_kernel",),
    "fused_adam": ("fused_adam_kernel",),
    "fused_lion": ("fused_lion_kernel",),
    "block_sparse_attention": ("bs_fwd_kernel", "bs_bwd_"),
    "gemm": ("nvjet", "gemm", "sm90_xmma", "cutlass", "cublas"),
    "reduction": ("reduce_kernel",),
    "copy": ("copy", "Memcpy", "Memset", "cat"),
    "elementwise": ("elementwise", "index", "gather", "scatter"),
}


def profile_window(name, fn, ticks):
    """torch.profiler over fn(): host wall time, device busy time (the sum
    of the kernels' and copies' spans on the card), the idle share,
    launches per tick and the kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        raise AssertionError(f"profile {name}: no device time traced")
    by_name: dict[str, list] = {}
    for e in spans:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    by_kind: dict[str, float] = {}
    for n, v in by_name.items():
        kind = next((k for k, keys in PROFILE_KINDS.items()
                     if any(key in n for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + v[0] / 1e3
    rec = {"window": name, "ticks": ticks, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / wall_us,
           "launches_per_tick": len(spans) / ticks,
           "ms_by_kind": dict(sorted(by_kind.items(),
                                     key=lambda kv: -kv[1])),
           "top_kernels": [{"name": n[:90], "ms": v[0] / 1e3, "calls": v[1],
                            "share_of_busy": v[0] / busy_us}
                           for n, v in top]}
    log(f"[profile] {json.dumps(rec)}")
    return out, rec


def profile_main_path(engine, dev, rows=8, prompt_len=256, decode_ticks=8):
    """Where a serving tick's time goes: one prefill tick (``rows``
    prompts of ``prompt_len`` tokens, one chunk each) and then
    ``decode_ticks`` decode ticks of the same rows."""
    c = engine.model.config
    rng = np.random.default_rng(3)
    uids = list(range(10_000, 10_000 + rows))

    def decode_tick(finished):
        nxt = {u: int(lg.argmax()) for u, lg in finished.items()}
        engine.schedule(list(nxt), [[t] for t in nxt.values()],
                        do_checks=False)
        return engine.tick()

    engine.schedule(uids, [rng.integers(0, c.vocab_size,
                                        prompt_len).tolist() for _ in uids])
    finished, pre = profile_window("prefill", engine.tick, 1)

    def decode():
        nonlocal finished
        for _ in range(decode_ticks):
            finished = decode_tick(finished)
        return finished

    _, dec = profile_window("decode", decode, decode_ticks)
    engine.flush(uids)
    return [pre, dec]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a prefill tick and decode ticks of the "
                         "serving path, one train_batch step and one Path T "
                         "step with torch.profiler")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.inference.v2 import paged
    from deepspeed_tpu_torch.ops import op_builder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    card = card_line()                                        # phase 1
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    build_s = op_builder.build(list(KERNELS))                 # phase 2
    log(f"[build] seconds {json.dumps(build_s)}")
    for name in KERNELS:
        ptxas = op_builder.library_path(name).with_suffix(".log")
        for line in ptxas.read_text().splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    errs, times = kernel_checks(dev, flush)                   # phase 3
    flash_errs = flash_checks(dev)
    adam_err = adam_checks(dev)
    adam_numel = flat_numel("125m")
    train_times = train_kernel_times(dev, adam_numel, flush)
    lion_err, lion_identical = lion_checks(dev)
    sparse_errs = sparse_checks(dev)
    path_times = path_kernel_times(dev, adam_numel, flush)
    del flush
    torch.cuda.empty_cache()

    engine, stats = main_path(dev)                            # phase 4
    rels = main_path_kernel_vs_plain(engine, dev)             # phase 5
    if args.profile:
        profile_main_path(engine, dev)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    if resident > 2**30:
        raise AssertionError(f"{resident / 2**30:.1f} GiB still allocated "
                             f"after the serving phases")

    trainer, batch, train = train_main_path(dev)              # phase 6
    if args.profile:
        profile_window("train_step", lambda: trainer.train_batch(batch), 1)
    del trainer
    torch.cuda.empty_cache()
    parity = train_path_kernel_vs_plain(dev)                  # phase 7
    gc.collect()
    torch.cuda.empty_cache()

    trainer, batch, path_t = path_t_main(dev)                 # phase 8
    if args.profile:
        ga = trainer.gradient_accumulation_steps_
        profile_window("path_t_step",
                       lambda: triple_step(trainer, batch, ga), 1)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    path_t_parity = path_t_kernel_vs_plain(dev)               # phase 9
    path_p = path_p_main(dev)                                 # phase 10

    def entry(name, kernel, launches, max_abs_err, t, **extra):
        return {"name": name, "route": "cuda",
                "source": SOURCE.format(kernel), "replaces": REPLACES[name],
                "launches": launches, "max_abs_err": max_abs_err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], **extra}

    def worst(key, dtype, errs=flash_errs):
        return max(e[key] for (dt, _), e in errs.items() if dt == dtype)

    dec, pre = times["decode"], times["prefill"]
    flash_main = train_times["flash_attention_fwd"]["check"]
    adam_main = train_times["fused_adam"]["check"]
    lion_main = path_times["fused_lion"]["check"]
    sparse_main = path_times["block_sparse_attention_fwd"]["check"]
    kernels = [
        entry("paged_attention", "paged_attention", stats["launches"],
              max(v for (dt, _), v in errs.items() if dt == "bfloat16"), dec,
              tol=TOL["bfloat16"],
              max_abs_err_fp32=max(v for (dt, _), v in errs.items()
                                   if dt == "float32"),
              tol_fp32=TOL["float32"],
              shape="decode B=8 Sq=1 ctx 100-2000 Hq=32 Hkv=8 D=128 bs=64 "
                    "bf16",
              prefill_ms=pre["ms"], prefill_plain_ms=pre["plain_ms"],
              prefill_bound_ms=pre["bound_ms"],
              prefill_bound_by=pre["bound_by"],
              prefill_library_ms=pre["library_ms"],
              main_path="serving",
              main_path_fp32_rel_logits_err=rels["fp32_kernel_vs_reference"],
              main_path_bf16_layer_max_abs_err=rels[
                  "bf16_layer_max_abs_err"]),
        entry("flash_attention_fwd", "flash_attention",
              train["launches"]["flash_attention_fwd"],
              flash_main["fwd_max_abs_err"],
              train_times["flash_attention_fwd"], tol=TOL["bfloat16"],
              lse_max_abs_err=flash_main["lse_max_abs_err"], lse_tol=1e-4,
              main_path="training",
              shape="B=24 S=1024 H=12 D=64 bf16 causal",
              cases_max_abs_err_bf16=worst("fwd_max_abs_err", "bfloat16"),
              cases_max_abs_err_fp32=worst("fwd_max_abs_err", "float32"),
              cases_tol_fp32=TOL["float32"], cases=CASES_NOTE),
        entry("flash_attention_bwd", "flash_attention",
              train["launches"]["flash_attention_bwd"],
              flash_main["bwd_max_abs_err"],
              train_times["flash_attention_bwd"],
              max_rel_err=flash_main["bwd_max_rel_err"],
              tol_rel=TOL["bfloat16"], launches_per_call=2,
              calls=train["launches"]["flash_attention_bwd_calls"],
              library_fwd_bwd_ms=train_times["flash_attention_bwd"][
                  "library_fwd_bwd_ms"], main_path="training",
              shape="B=24 S=1024 H=12 D=64 bf16 causal",
              cases_max_rel_err_bf16=worst("bwd_max_rel_err", "bfloat16"),
              cases_max_rel_err_fp32=worst("bwd_max_rel_err", "float32"),
              cases_tol_rel_fp32=TOL["float32"], cases=CASES_NOTE),
        entry("fused_adam", "fused_adam", train["launches"]["fused_adam"],
              max(adam_main[f"{t}_max_abs_err"] for t in "pmv"),
              train_times["fused_adam"], tol=ADAM_TOL,
              copy_max_abs_err=adam_main["copy_max_abs_err"],
              copy_tol="1e-6 + 2^-7 relative (one bf16 rounding step)",
              bound_ms_without_bf16_copy=train_times["fused_adam"][
                  "bound_ms_without_bf16_copy"], main_path="training",
              shape=f"{adam_numel} fp32 params + bf16 copy, AdamW",
              cases_max_abs_err=adam_err,
              cases="7 sizes 1..2^20+5 x AdamW/L2 x 3 steps, schedule"),
        entry("fused_lion", "fused_lion", path_t["launches"]["fused_lion"],
              max(lion_main[f"{t}_max_abs_err"] for t in "pm"),
              path_times["fused_lion"], tol=ADAM_TOL,
              library=path_times["fused_lion"]["library"],
              bitwise_equal_to_plain=lion_main["bitwise_equal"],
              copy_max_abs_err=lion_main["copy_max_abs_err"],
              bound_ms_without_bf16_copy=path_times["fused_lion"][
                  "bound_ms_without_bf16_copy"], main_path="Path T",
              shape=f"{adam_numel} fp32 params + bf16 copy, Lion wd 0.01",
              cases_max_abs_err=lion_err,
              cases_bitwise_equal=lion_identical,
              cases="8 sizes 1..2^20+5 x wd 0/0.05 x 3 steps, schedule",
              main_path_parity=path_t_parity["plain_lion_triple"]),
        entry("block_sparse_attention_fwd", "block_sparse_attention",
              path_p["bfloat16"]["launches"]["block_sparse_attention_fwd"],
              sparse_main["fwd_max_abs_err"],
              path_times["block_sparse_attention_fwd"],
              max_rel_err=sparse_main["fwd_max_rel_err"],
              tol_rel=TOL["bfloat16"],
              lse_max_rel_err=sparse_main["lse_max_rel_err"], lse_tol=1e-5,
              main_path="Path P", shape=SPARSE_SHAPE,
              live_blocks=path_times["block_sparse_attention_fwd"][
                  "live_blocks"],
              library=path_times["block_sparse_attention_fwd"]["library"],
              cases_max_rel_err_bf16=worst("fwd_max_rel_err", "bfloat16",
                                           sparse_errs),
              cases_max_rel_err_fp32=worst("fwd_max_rel_err", "float32",
                                           sparse_errs),
              cases_tol_fp32=TOL["float32"], cases=SPARSE_NOTE,
              main_path_max_rel_err=path_p["bfloat16"]["fwd_max_rel_err"],
              main_path_fp32_small_max_rel_err=path_p["float32"][
                  "fwd_max_rel_err"]),
        entry("block_sparse_attention_bwd", "block_sparse_attention",
              path_p["bfloat16"]["launches"]["block_sparse_attention_bwd"],
              sparse_main["bwd_max_abs_err"],
              path_times["block_sparse_attention_bwd"],
              max_rel_err=sparse_main["bwd_max_rel_err"],
              tol_rel=TOL["bfloat16"], launches_per_call=2,
              main_path="Path P", shape=SPARSE_SHAPE,
              library=path_times["block_sparse_attention_bwd"]["library"],
              cases_max_rel_err_bf16=worst("bwd_max_rel_err", "bfloat16",
                                           sparse_errs),
              cases_max_rel_err_fp32=worst("bwd_max_rel_err", "float32",
                                           sparse_errs),
              cases_tol_fp32=TOL["float32"], cases=SPARSE_NOTE,
              main_path_max_rel_err=path_p["bfloat16"]["bwd_max_rel_err"],
              main_path_fp32_small_max_rel_err=path_p["float32"][
                  "bwd_max_rel_err"]),
    ]
    log(f"[main] serving {json.dumps(stats)} on {card}")
    log(f"[main] training {json.dumps(train)} on {card}")
    log(f"[main] training kernels vs plain {json.dumps(parity)}")
    log(f"[main] Path T {json.dumps(path_t)} on {card}")
    log(f"[main] Path T kernels vs plain {json.dumps(path_t_parity)}")
    log(f"[main] Path P {json.dumps(path_p)} on {card}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
