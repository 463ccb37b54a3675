#!/usr/bin/env python3
"""Drive the PyTorch port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the serving path, from csrc/, with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (Llama-3-8B head layout), timed beside its plain
     version, a PyTorch library call computing the same function, and the
     card's least time for the work (its bound);
  4. the main path at full width: build_engine("llama", "3-8b") with
     random seeded weights serves 8 requests x 32 tokens through
     generate(); every layer of every tick must launch the kernel;
  5. the main path with the kernel against the main path with the plain
     attention: one prefill chunk and two teacher-forced decode ticks,
     logits compared in fp32 and every layer's attention in bf16.
With --profile it then traces a prefill tick and decode ticks of the main
path (torch.profiler) and prints where the device time goes.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor rate
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
KERNEL_SOURCE = "deepspeed_tpu_torch/csrc/paged_attention.cu"
REPLACES = "deepspeed_tpu/inference/v2/paged.py:61"


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
        engine.tick = orig_tick
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


# --------------------------------------------------------- --profile
def profile_main_path(engine, dev, rows=8, prompt_len=256, decode_ticks=8):
    """Where a tick's time goes: torch.profiler over one prefill tick
    (``rows`` prompts of ``prompt_len`` tokens, one chunk each) and then
    ``decode_ticks`` decode ticks of the same rows. Per window: host wall
    time, device busy time (the sum of the kernels' and copies' spans on
    the card), the idle share, launches per tick and the kernels by
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    c = engine.model.config
    rng = np.random.default_rng(3)
    uids = list(range(10_000, 10_000 + rows))

    def decode_tick(finished):
        nxt = {u: int(lg.argmax()) for u, lg in finished.items()}
        engine.schedule(list(nxt), [[t] for t in nxt.values()],
                        do_checks=False)
        return engine.tick()

    def window(name, fn, ticks):
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
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        rec = {"window": name, "ticks": ticks, "wall_ms": wall_us / 1e3,
               "device_busy_ms": busy_us / 1e3,
               "device_idle_share": 1 - busy_us / wall_us,
               "launches_per_tick": len(spans) / ticks,
               "top_kernels": [{"name": n[:90], "ms": v[0] / 1e3,
                                "calls": v[1],
                                "share_of_busy": v[0] / busy_us}
                               for n, v in top]}
        log(f"[profile] {json.dumps(rec)}")
        return out, rec

    engine.schedule(uids, [rng.integers(0, c.vocab_size,
                                        prompt_len).tolist() for _ in uids])
    finished, pre = window("prefill", engine.tick, 1)

    def decode():
        nonlocal finished
        for _ in range(decode_ticks):
            finished = decode_tick(finished)
        return finished

    _, dec = window("decode", decode, decode_ticks)
    engine.flush(uids)
    return [pre, dec]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a prefill tick and decode ticks of "
                         "the main path with torch.profiler")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import op_builder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    card = card_line()                                        # phase 1
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    build_s = op_builder.build(["paged_attention"])           # phase 2
    log(f"[build] seconds {json.dumps(build_s)}")
    ptxas = op_builder.library_path("paged_attention").with_suffix(".log")
    for line in ptxas.read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    errs, times = kernel_checks(dev, flush)                   # phase 3
    del flush

    engine, stats = main_path(dev)                            # phase 4
    rels = main_path_kernel_vs_plain(engine, dev)             # phase 5
    if args.profile:
        profile_main_path(engine, dev)

    bf16_err = max(v for (dt, _), v in errs.items() if dt == "bfloat16")
    fp32_err = max(v for (dt, _), v in errs.items() if dt == "float32")
    dec, pre = times["decode"], times["prefill"]
    kernel = {
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": stats["launches"],
        "max_abs_err": bf16_err, "max_err": bf16_err, "tol": TOL["bfloat16"],
        "max_abs_err_fp32": fp32_err, "tol_fp32": TOL["float32"],
        "ms": dec["ms"], "kernel_ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shape": "decode B=8 Sq=1 ctx 100-2000 Hq=32 Hkv=8 D=128 bs=64 bf16",
        "prefill_ms": pre["ms"], "prefill_plain_ms": pre["plain_ms"],
        "prefill_bound_ms": pre["bound_ms"],
        "prefill_bound_by": pre["bound_by"],
        "prefill_library_ms": pre["library_ms"],
        "prefill_shape": "B=2 Sq=256 pos0 0/300 Hq=32 Hkv=8 D=128 bf16",
        "main_path_fp32_rel_logits_err": rels["fp32_kernel_vs_reference"],
        "main_path_bf16_layer_max_abs_err": rels["bf16_layer_max_abs_err"]}
    log(f"[main] serving {json.dumps(stats)} on {card}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
