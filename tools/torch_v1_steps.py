"""The v1 engine's ``generate`` on one CUDA card, for comparing two
checkouts of the port: a model built by ``init_inference`` in bf16 from
seeded random weights serves 8 prompts of 256 tokens, 32 greedy tokens.

Per model it reports the host wall of ``generate`` (its second call; the
first builds the kernels and, where ``generate`` runs CUDA graphs,
captures its key), ms a decode step as the difference of 32 tokens' and 1
token's wall over the 31 steps (the same arithmetic for an eager loop and
for graph replays), and a ``torch.profiler`` trace of one 32-token call:
device busy ms, the idle share and kernels a step by kind.

    python3 tools/torch_v1_steps.py --root . --out v1_this.json
    python3 tools/torch_v1_steps.py --root ../parent --out v1_parent.json

``--root`` is the checkout whose ``deepspeed_tpu_torch`` is imported
(its kernels build under its own ``build/``). Models: ``gpt2-125m``
(vocab 50304) and ``gptj-6b`` by default (``--models``).
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    return out.stdout.strip()


def build(name: str):
    """The model, its weights left for the loader to draw a leaf at a
    time (``config["seed"]``)."""
    from deepspeed_tpu_torch.models import GPT2, GPTJ
    from deepspeed_tpu_torch.models.transformer import deferred_weights
    with deferred_weights():
        if name == "gpt2-125m":
            return GPT2(size="125m", vocab_size=50304)
        if name == "gptj-6b":
            return GPTJ(size="6b")
    raise ValueError(f"unknown model {name!r}")


def kind_of(kernel: str) -> str:
    for kind, keys in (("norms", ("norm_",)),
                       ("grouped_gemm", ("grouped_mm",)),
                       ("gemm", ("gemm", "nvjet", "sm90_xmma", "cutlass")),
                       ("copy", ("copy", "Memcpy", "Memset", "cat"))):
        if any(k in kernel for k in keys):
            return kind
    return "other"


def profile(fn, steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in spans) / 1e3
    by_kind: dict = {}
    for e in spans:
        k = kind_of(e.name)
        by_kind[k] = by_kind.get(k, 0) + 1
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_idle_share=1 - busy / wall_ms if wall_ms else None,
                kernels_per_token=len(spans) / steps,
                kernels_per_token_by_kind={k: n / steps
                                           for k, n in by_kind.items()})


def run_model(name: str, n_req=8, prompt_len=256, max_new=32) -> dict:
    import torch
    import deepspeed_tpu_torch as ds
    torch.manual_seed(0)
    model = build(name)
    eng = ds.init_inference(model, config={"dtype": "bf16",
                                           "max_out_tokens": 1024})
    vocab = eng.module.config.vocab_size
    prompts = np.random.default_rng(7).integers(0, vocab,
                                                (n_req, prompt_len))

    def wall(new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    wall(max_new)                       # kernels built, graphs captured
    wall(1)
    one, _ = wall(1)
    full, out = wall(max_new)
    rec = dict(model=name, requests=n_req, prompt_tokens=prompt_len,
               new_tokens=max_new, generate_s=full, prefill_s=one,
               ms_per_step=1e3 * (full - one) / (max_new - 1),
               graphs=hasattr(eng, "graph_captures"),
               tokens_in_range=bool(((out >= 0) & (out < vocab)).all()))
    if hasattr(eng, "decode_ms_per_step"):
        rec["device_ms_per_step_graph"] = eng.decode_ms_per_step()
        rec["capture_ms"] = [g["capture_ms"] for g in eng.graph_captures]
    rec["profile"] = profile(lambda: eng.generate(prompts,
                                                  max_new_tokens=max_new),
                             max_new)
    del eng, model
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--out", required=True)
    ap.add_argument("--models", default="gpt2-125m,gptj-6b")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = dict(root=root, card=card_line(), torch=torch.__version__,
               models=[run_model(m) for m in args.models.split(",")])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
