#!/usr/bin/env python3
"""Drive the PyTorch port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the serving and training paths, from
     csrc/, one nvcc per source, all started together; the attention
     and norm libraries' registers, spills and shared memory per kernel
     (a paged kernel or a warp_row / cta_row norm kernel that spills, or
     a warp_row kernel with a barrier, fails the run);
  3. each kernel against its plain PyTorch version on the card (paged
     attention at the serving path's shapes, a prefill tick of 8 x 256
     rows among them, with the variant each call takes, its TFLOP/s and
     GB/s, its share of the bound and a bit-identical rerun; flash
     attention forward and
     backward in fp32, bf16 and fp16 and fused Adam over a spread of
     cases), then timed at the main paths' shapes beside its plain
     version, a PyTorch library call computing the same function, and the
     card's least time for the work (its bound); the flash and
     block-sparse rows add the kernels' variant (bf16/fp16 on the tensor
     cores, fp32 on the CUDA cores), TFLOP/s, the share of the bound, the
     ratio to SDPA and a bit-identical rerun (flash also at phase 21's
     head dims: D 80 and 96 at 32 heads, D 256 at 16, B 4, S 2048), and
     the build prints their registers, shared memory and spills; the
     paged rows also in fp16
     (decode, prefill and tick, fp and int8 pools), the quantize rows
     with the variant each call took (bulk, and ragged on a misaligned
     start), the Adam row with its like-for-like yardsticks (the kernel
     without its copy against AdamW(fused=True), with the copy against
     that step and a bf16 copy_);
  4. the serving main path at full width: build_engine("llama", "3-8b")
     with random seeded weights serves 8 requests x 32 tokens through
     generate(); every layer of every tick must launch the kernel, every
     launch one of the new bf16 variants (prefill_wgmma, decode_split);
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
     through the block-sparse kernels (every launch the tensor-core
     variant), held against the plain versions; the first call's wall and
     its host work (layout, block lists, tile groups) reported;
 11. Path Q: the serving path of phase 4 from an int8 KV cache (per-head
     scales, the pool grown to the bf16 pool's bytes) with the prefix
     cache on: a shared 512-token system prompt served alone, then 8
     requests of it plus 100-400 tokens each, 32 greedy tokens; blocks,
     prefix hits, launches (all on the new variants) and bytes per token
     checked, the greedy agreement with phase 4's bf16 engine reported;
 12. Path Q teacher-forced on int8 and fp8 pools: the kernel against its
     plain version at every layer of every tick, bf16 (every call on a new
     variant) and fp32;
 13. Path Z, ZeRO-3 across two ranks with the ZeRO++ int8 wire: phase 6's
     model and step with zero_optimization stage 3, qwZ and qgZ
     (stochastic rounding), mesh fsdp -1, in two processes that share the
     card and talk over gloo (a file store under build/), 12 rows a rank;
     one warm-up step then 10 timed steps with the quantized wire and
     again with the exact wire: tokens/s, step ms, each rank's peak
     memory, the losses (finite and falling), the loss gap, the wire bytes
     a step of each (from the plan's shard shapes), and the quantize and
     dequantize launches a step;
 14. Path Z's kernels against plain inside the same ranks on the step's
     real data: every qwZ gather and the qgZ reduce-scatter with nearest
     rounding, kernels on and off, bit for bit;
 15. phase 6's train_batch under every remat policy the JAX model runs
     (segments, nothing_saveable, everything_saveable, dots_saveable,
     dots_with_no_batch_dims_saveable, save_attn_ffn) and remat=False,
     from the same weights, a warm-up and 3 timed steps each: step ms,
     peak memory, the losses (finite, falling, within bf16 noise of
     segments') and the norm launches a step;
 16. fp16 serving, DeepSpeed's default inference dtype: phase 4's
     Llama-3-8B and requests with {"dtype": "fp16"} (every paged launch
     decode_split or prefill_wgmma, every norm launch cta_row), its
     greedy agreement with phase 4's bf16 engine (reported), every layer
     of three teacher-forced ticks against the plain attention at 1e-2
     and the first tick's logits against the plain path's; then Path Q's
     config in fp16 (4 requests) and its layers on int8 and fp8 pools;
 17. fused serving: phase 4's engine (fused_decode_steps 8,
     max_inflight_dispatches 2) serves phase 4's requests through
     generate_fused, each K-tick dispatch one CUDA graph replay: a first
     run captures the graphs, the timed rerun must give its tokens; every
     paged launch of a replay decode_split, every norm cta_row, the
     counts equal the replays' ticks and the prefill dispatches; one
     dispatch replayed against the same ticks run eagerly, bit for bit
     (tokens, carry, pools, last logits); sampled tokens (temperature
     0.9, top_k 50, top_p 0.9, seed 13) equal at k 2 and k 8; threefry
     on the card equal to the CPU's; reported: prefill tokens/s, decode
     ms a token step beside phase 4's per tick, dispatches a token,
     occupancy, greedy agreement with phase 4, graphs, capture ms and
     pool MiB; then Path Q's engine fused (agreement with its per-tick
     run reported) and fp32 Llama-3-8B cut to 4 layers, where
     generate_fused must equal generate() token for token;
 18. speculative decoding and ring mode: phase 4's engine serves phase
     4's requests in spec chain (prompt lookup, draft_len 3, min_ngram 2,
     history window 64), ring (fused_admission: admission inside the
     graph, one host read a chain) and spec ring mode, a capturing run
     then the timed one each: the same tokens, every paged launch of a
     replay decode_split (the verify forward at S_new 4 included), every
     norm cta_row, the counts equal the replays' ticks and the prefill
     dispatches, one host read a ring chain; reported: decode ms a fused
     step and a token step beside phase 17's, tokens a dispatch, the
     acceptance rate, host reads a chain, capture ms, pool MiB and
     launches a graph, greedy agreement with phase 17; each new graph's
     replay against its eager run, bit for bit; Path Q's engine in spec
     chain mode (agreement reported); on phase 17's fp32 4-layer engine
     the three modes' greedy tokens equal to generate() and to chain mode
     under the near-tie rule (a differing token's top-2 margin below
     1e-4), and sampled spec chain equal to chain at K 2 and 8;
 19. the serving front end on phase 4's engine (K 8, depth 2): (a) KV
     export/import of a 700-token prompt to a twin engine (the same
     model, its own pools): the payload bit-equal on the importer, every
     slab at its address, bytes a token = kv_bytes_per_token, 32 greedy
     tokens continued there equal to the never-moved run; export and
     import ms against the prefill's; again on Path Q's int8 engine and
     on fp8 pools; (b) AsyncInferenceServer: the 8 requests at once, then
     16 at seeded gaps, TTFT and ITL p50/p99 from the handles' token
     times, tokens/s, every launch decode_split / prefill_wgmma and
     cta_row, a cancel that frees its blocks, a clean stop(); (c)
     InferenceRouter over two decode replicas with a PrefillEngine
     (disaggregated): Path Q's 8 requests, the router's counters, TTFT
     and ITL, the migrated bytes held to the payloads', then a replica
     killed mid-run and its requests rerouted to completion; (d) on
     phase 17's fp32 4-layer engine the server's streams equal
     generate_fused and the router's the server's, under the near-tie
     rule;
 20. model breadth, after phase 19 once every earlier engine is
     released: (a, run in phase 3) the paged-attention kernel at head
     dims 80, 96 and 256 (phi-2, phi3-mini and gptj-6b heads) on the
     decode, prefill and tick calls in fp32, bf16 and fp16 over fp, int8
     and fp8 pools, against plain, rerun bit for bit, bf16/fp16 timed;
     (b) build_engine at full width and depth, bf16, random seeded
     weights: phi "2", phi3 "mini", gptj "6b" serve phase 4's traffic
     with phase 4's launch checks (every bf16 paged launch decode_split
     or prefill_wgmma, every norm launch cta_row), then every layer of a
     prefill, a mixed and a decode tick against plain; (c) the same at
     published widths cut to 4 layers for mistral "7b" (plus a
     4500-token prompt past its window), falcon "7b" (71 q heads on 1 kv
     head: its decode rows take prefill_wgmma), bloom "7b1", opt "13b",
     gptneox "20b", internlm "7b", qwen "7b" and qwen2 "7b"; (d) each
     family at 2 layers in fp32, kernel path against plain logits at
     1e-4; (e) init_inference(GPTJ(size="6b"), bf16) on (b)'s weights:
     32 tokens from 8 prompts of 256, tokens/s, greedy agreement with
     (b)'s v2 engine (reported), ms a decode step (each step a replay
     of the captured decode step), the capture's ms, pool MiB and
     launches a replay, and at 4 layers in fp32 the v1 and v2 tokens
     equal under the near-tie rule; (f) phi "2", phi3 "mini" and
     gptj "6b" at 4 layers in fp32 through generate_fused (K 8): a
     capturing run and a rerun, both equal to that engine's generate()
     token for token, the paged launches counted from the graph replays
     as in phase 17 (every replayed tick decode_split);
 21. the dense families trained at full width: initialize(phi "2", phi3
     "mini" cut to 24 layers, gptj "6b" cut to 12; random seeded weights,
     phase 6's config: bf16, fused Adam, ZeRO 2, clip 1.0, segments,
     flash) -> train_batch on 4 x 2048 tokens, one warm-up step then 5
     timed steps each, each engine released before the next: tokens/s,
     step ms, MFU, peak memory, the loss per step (finite and falling),
     the flash launches a step by variant (every one wgmma) and the
     norm launches (row kernels); then each at 2 layers in fp32 (TF32
     off) on the card against the CPU, 3 steps: losses at 1e-4 relative,
     the first step's grads at 1e-4 of their largest, the params at 1e-3
     of their total change.
 22. linear/: (a) phase 4's engine config with quantize_weights
     (Llama-3-8B, bf16, weight-only int8, a layer dequantized where it is
     read) serves phase 4's traffic through generate() and
     generate_fused (K 8, depth 2), phase 4's and phase 17's launch
     checks; prefill tokens/s, decode ms a tick and a fused step, the
     graphs' pool MiB, the weights' bytes (at most 0.55x the bf16
     engine's), the build's peak memory and the fused tokens' agreement
     with the per-tick ones (bf16 at full depth: reported; the paths are
     held equal in fp32, b and f); (b) at 2 layers in fp32 the
     int8 engine on the card against the CPU: codes and scales bit-equal,
     logits within 1e-5 of their largest, greedy tokens equal, v1 and
     generate_fused equal to v2's generate(); (c) init_inference(GPTJ
     "6b", bf16, quantize_weights), phase 20e's traffic, its decode
     steps graph replays (ms a step, capture); (d) LoRAModel
     over Llama-3-8B (r 64, the seven projections int8 in blocks of 512
     by the quantize kernel's exact-division mode) trained with phase
     21's config and batch: step ms, MFU, peak memory, the quantize and
     dequantize launches (14 a layer a step), flash all wgmma, losses
     falling, the frozen codes unchanged; (e) at 2 layers in fp32, the
     kernel-made base bit-equal to plain in both quantize modes and the
     LoRA run on the card against the CPU at phase 21's bounds; (f) the
     trained adapters fused (fuse_lora) and served int8: the card's
     tokens equal the CPU's. Phase 3 times the quantize in both modes
     and the dequantize at a layer of the LoRA path (a [4096, 14336]
     bf16 w_up slice).
 23. BERT: (a) initialize(Bert(size="large"): 24 layers, d 1024, 16
     heads, vocab 30522; random seeded weights; phase 6's config) ->
     train_batch on 64 x 128 tokens (15% MLM targets, rows 48-63 padded
     from position 96), one warm-up step then 5 timed steps: tokens/s,
     step ms, MFU over flops_per_token(128), peak memory, the losses
     (finite and falling), the LayerNorm launches (2L + 2 a step, every
     one warp_row) and fused Adam's; (b) BERT-large's widths at 2 layers
     in fp32 on the card against the CPU (phase 21's bounds, every
     tensor held) and the encoder layer pre-LN at BERT-large's width
     (output and grads at 1e-4 of their largest);
 24. Hugging Face checkpoints: a Llama-3-8B directory (the published
     config.json, depth cut to 8 layers, ~5.6 GB of bf16 safetensors in
     shards of at most 2 GB with an index) written by the port's writer
     from a seeded tree under build/; (a) build_hf_engine with phase 4's
     engine config serves phase 4's traffic: every parameter bit-equal
     to build_engine's from the tree, the tokens equal, phase 4's launch
     checks; the load's seconds and GB/s, the host's peak RSS and the
     device's build peak; (b) init_inference(path, bf16) against the v1
     engine from the tree on 8 prompts of 256, 32 greedy tokens, equal
     (both engines' decode steps graph replays); the directory deleted;
 25. MoE (moe/, every expert on the card): (a) build_engine("qwen2_moe",
     "a2.7b") whole (24 layers, d 2048, 16 heads of 128, 60 experts top-4
     and a shared expert, 13.7 B parameters, bf16) serves phase 4's
     traffic through generate() and generate_fused (K 8): prefill
     tokens/s, decode ms a tick and a fused step, the drop fraction of
     each tick, the weights' bytes and the build's peak, phase 4's and
     phase 17's launch checks; then a twin engine with
     moe_grouped_dispatch serves 8 prompts of 24 tokens through
     generate() and generate_fused (K 8, the grouped GEMMs inside the
     graphs): the same tokens, 3L grouped_mm launches a tick on the
     tensor cores; (b) init_inference(Mixtral("8x7b") whole,
     bf16, quantize_moe_experts) on phase 20e's traffic in the capacity
     form, then moe_grouped_dispatch over the same int8 tree, each
     generate's decode steps graph replays: ms a step, the capture,
     tokens/s, bytes, peaks, the grouped form's 3L grouped_mm launches a
     forward; (c) Qwen2-MoE a2.7b cut to 4 layers trained
     with phase 21's config and batch: step ms, MFU over the active
     parameters, peak memory, falling losses, the aux loss and drop
     fraction, flash all wgmma, norms cta_row, one Adam launch a step;
     (d) both families at full width in fp32, the card against the CPU:
     the capacity form, the grouped form and the int8 experts served at 2
     layers (logits 1e-5 of their largest, greedy tokens equal,
     generate_fused equal to generate() in the capacity and the grouped
     form), Qwen2-MoE's training at 1 layer at phase 21's bounds; the CPU
     halves run on a worker thread from the build on (their trees drawn
     on the card while nvcc runs, drawn again in 25d).
 26. checkpoints (runtime/checkpointing.py, checkpoint/), on phase 6's
     GPT-2 125M, config and batch (124.5 M values of fp32 master, m and
     v and the bf16 params, ~1.74 GB a checkpoint under build/): (a) an
     engine trains 3 steps, saves, trains 3 more; an engine from another
     seed loads and trains the same 3: losses, master, moments, step and
     loss scale bit for bit; bytes, save and load seconds and GB/s, the
     host's RSS over each, flash/LayerNorm/Adam launches by variant; (b)
     the async engine: how long save blocks, a step with the write in
     flight against one without, the commit, `latest` unchanged until
     it; (c) Path T (Lion, GA 2, loss_chunk 256) resumed bit for bit, 2 +
     2 steps; (d) ds_to_universal and load_universal_checkpoint into a
     fresh engine (master, moments, step bit for bit), zero_to_fp32
     against the master bit for bit, save_16bit_model's names; (e) the
     checkpoint directory served by build_engine (v2) and init_inference
     (v1) in bf16, phase 4's traffic shape (8 requests of 100-700 tokens,
     32 greedy tokens): tokens equal the engines' built from the trained
     parameters, phase 4's launch checks, v1's decode steps graph replays
     (ms a step, capture ms a prompt length), and v1's graph against the
     same decode step run eagerly on the card, greedy and sampled (top-k
     and top-p): tokens bit-equal; (f) the card's checkpoint loaded
     by an engine on the CPU and the CPU's on the card, bit for bit; (g)
     phase 13's two ZeRO-3 qwZ/qgZ ranks saved at their last step; that
     checkpoint at W = 1 on the card: the master's sha256 equals the
     ranks' consolidated master's. The directories are removed at the
     phase's end.
Phase 3 also holds the paged-attention kernel's int8/fp8-pool mode, fused
Lion, the block-sparse kernels, the int8 block quantize/dequantize, the
RMSNorm/LayerNorm kernels and the grouped GEMM of the grouped MoE form
(bf16, fp16 and fp32 at Mixtral-8x7B's and Qwen2-MoE's expert shapes,
decode and prefill rows, one expert empty; no Pallas counterpart: XLA's
lax.ragged_dot) against their plain versions and times them at
Path Q's, Path T's, Path P's, Path Z's and the serving and training
paths' shapes (the norm rows with the variant each took, GB/s, the share
of the bound, the ratio to the library call and a bit-identical rerun).
Every model path runs its norms through the norm kernels (2L + 1
launches a forward, 2L more recomputed a training micro-batch under
remat), and each phase's launch check counts them; phases 4, 6, 8, 11,
13 and 15 fail unless every norm launch took a row kernel (warp_row or
cta_row); the plain sides of phases 5 and 7 run plain norms. Phase 17
runs right after phase 5 on phase 4's engine, phases 11-12 after it,
beside that engine; phase 17's Path Q run follows phase 12 and its fp32
check phase 16; phase 18 follows phase 17 on each engine, and phase 19
phase 18 (its int8/fp8 migrations after Path Q's phase 18, its fp32
checks in the fp32 engine after phase 18's). With --profile
it then traces a prefill tick and decode ticks of the serving path and of
Path Q, one train_batch step, one step of Path T, five Path P calls, one
fused dispatch of 8 ticks and one speculative dispatch of 8 verify ticks
(torch.profiler) and prints where the device time goes. The last two
lines are the kernels' JSON record and {"ok": true, "device": {...}}.
Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor rate
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the attention kernels (flash, block-sparse, paged) also in fp16, at
# tests/test_torch_cuda.py's 1e-2 (fp16 rounds p and ds 8x finer than bf16)
ATTN_TOL = dict(TOL, float16=1e-2)
# fp16 serving: the first tick's logits of the kernel path against the
# plain attention's, max |d| / max |logits| (bf16 drifts ~6% over 32 random
# layers, fp16's ulp is 8x finer)
FP16_LOGITS_TOL = 5e-2
ADAM_TOL = (1e-6, 1e-5)        # atol, rtol: the JAX fused-Adam tolerance
KERNELS = ("paged_attention", "flash_attention", "fused_adam",
           "fused_lion", "block_sparse_attention", "quantize_int8", "norms",
           "grouped_gemm")
SOURCE = "deepspeed_tpu_torch/csrc/{}.cu"
# the paged-attention kernels every bf16 call must take (the fp32 prefill
# stays on the CUDA-core kernel, "cuda_cores")
NEW_PAGED_VARIANTS = ("prefill_wgmma", "decode_split")
# the norm kernels every norm of a main path must take (ops/norms.py
# launch_plan; "general" is for odd widths and misaligned rows)
NEW_NORM_VARIANTS = ("warp_row", "cta_row")
REPLACES = {
    "paged_attention": "deepspeed_tpu/inference/v2/paged.py:61",
    "paged_attention_quantized": "deepspeed_tpu/inference/v2/paged.py:61",
    "paged_attention_fp16": "deepspeed_tpu/inference/v2/paged.py:61",
    "paged_attention_quantized_fp16":
        "deepspeed_tpu/inference/v2/paged.py:61",
    "flash_attention_fwd": "deepspeed_tpu/ops/pallas/flash_attention.py:88",
    "flash_attention_bwd": "deepspeed_tpu/ops/pallas/flash_attention.py:226",
    "fused_adam": "deepspeed_tpu/ops/pallas/fused_optimizers.py:75",
    "fused_lion": "deepspeed_tpu/ops/pallas/fused_optimizers.py:165",
    "block_sparse_attention_fwd":
        "deepspeed_tpu/ops/sparse_attention/kernels.py:121",
    "block_sparse_attention_bwd":
        "deepspeed_tpu/ops/sparse_attention/kernels.py:210",
    "quantize_int8": "deepspeed_tpu/ops/pallas/quantization.py:57",
    "dequantize_int8": "deepspeed_tpu/ops/pallas/quantization.py:99",
    "rms_norm": "deepspeed_tpu/ops/pallas/norms.py:47",
    "rms_norm_decode": "deepspeed_tpu/ops/pallas/norms.py:47",
    "layer_norm": "deepspeed_tpu/ops/pallas/norms.py:81",
    # no Pallas kernel: XLA's lax.ragged_dot in the grouped MoE form
    "grouped_mm": "deepspeed_tpu/moe/sharded_moe.py:170 (lax.ragged_dot, "
                  "no Pallas counterpart)"}
# what each kernel of the kernels line takes: its dtypes and its variants
# (by the dtypes that take them)
_ATTN = {"wgmma": ["bfloat16", "float16"], "cuda_cores": ["float32"]}
_PAGED = {"decode_split": ["float32", "bfloat16", "float16"],
          "prefill_wgmma": ["bfloat16", "float16"], "cuda_cores": ["float32"]}
_ALL = ["float32", "bfloat16", "float16"]
KERNEL_FORMS = {
    "paged_attention": (_ALL, _PAGED),
    "paged_attention_quantized": (_ALL, _PAGED),
    "paged_attention_fp16": (_ALL, _PAGED),
    "paged_attention_quantized_fp16": (_ALL, _PAGED),
    "flash_attention_fwd": (_ALL, _ATTN), "flash_attention_bwd": (_ALL, _ATTN),
    "block_sparse_attention_fwd": (_ALL, _ATTN),
    "block_sparse_attention_bwd": (_ALL, _ATTN),
    "fused_adam": (["float32, copy bfloat16/float16"],
                   {"fused_adam_kernel": ["float32"]}),
    "fused_lion": (["float32, copy bfloat16/float16"],
                   {"fused_lion_kernel": ["float32"]}),
    "quantize_int8": (_ALL, {"bulk": _ALL, "ragged": _ALL}),
    "dequantize_int8": (_ALL, {"dequantize_kernel": _ALL}),
    "rms_norm": (_ALL, {v: _ALL for v in ("warp_row", "cta_row", "general")}),
    "rms_norm_decode": (_ALL, {v: _ALL for v in ("warp_row", "cta_row",
                                                "general")}),
    "layer_norm": (_ALL, {v: _ALL for v in ("warp_row", "cta_row",
                                           "general")}),
    "grouped_mm": (_ALL, {"tensor_cores": ["bfloat16", "float16"],
                          "cuda_cores": ["float32"]})}
# remat policies of phase 15: every name the JAX model runs (aliases once)
# and remat off
REMAT_RUNS = ("segments", "nothing_saveable", "everything_saveable",
              "dots_saveable", "dots_with_no_batch_dims_saveable",
              "save_attn_ffn", None)
SPIN_CYCLES = 2_000_000        # ~1 ms of device spin before a timed call
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
# Path Z: the training main path's model and step under ZeRO-3 across two
# ranks with the ZeRO++ int8 wire (bench.py zeropp_bench's flags, :2762-2765,
# without the hierarchical gather, which needs a zps axis and 4 ranks)
PATH_Z_WORLD = 2
PATH_Z_CONFIG = dict(TRAIN_CONFIG, mesh={"fsdp": -1}, zero_optimization={
    "stage": 3, "zero_quantized_weights": True,
    "zero_quantized_gradients": True, "zero_quantized_dtype": "int8"})
PATH_Z_EXACT = dict(TRAIN_CONFIG, mesh={"fsdp": -1},
                    zero_optimization={"stage": 3})
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


def live_children() -> list[str]:
    """The processes this one started that are still running, read from
    /proc (Linux), as "pid command"."""
    me, found = str(os.getpid()), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode().strip()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[1] == me and fields[0] != "Z":        # ppid, state
            found.append(f"{pid} {cmd}")
    return found


def time_ms(fn, dev, iters: int, flush=None) -> float:
    """Median device time of one fn() call over iters calls after a
    warm-up, each between two CUDA events, with the L2 cache flushed
    before it (the main path meets each layer's pages cold). A spin of
    ~1 ms (``torch.cuda._sleep``) is enqueued before each start event, so
    the device is still busy while the host launches fn's kernels: the
    host's launch delay stays out of the window, and the median drops a
    call the host held up anyway. On the CPU (rehearsal only) a host
    clock."""
    import torch
    fn()
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def attention_work(x, kw) -> tuple[int, int]:
    """Bytes one call must move (each input read once: q, the chunk's
    k/v, the visible cached keys and values at the pool's itemsize and,
    quantized, their f32 scales, the tables; the output written once) and
    the flops it must do (two multiply-adds per visible (row, key, channel)
    pair), on these inputs."""
    q = x["q"]
    b, sq, hq, d = q.shape
    hkv = x["k_new"].shape[2]
    item = q.element_size()
    pool_item = x["k_pool"].element_size()
    scale_heads = kw["k_scale"].shape[-1] if kw.get("k_scale") is not None \
        else 0
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
        + 2 * keys_read * (hkv * d * pool_item + scale_heads * 4) \
        + 4 * (x["block_tables"].numel() + 2 * b)
    return nbytes, 4 * pairs * hq * d


def attention_bound(x, kw) -> tuple[float, str]:
    """Least time (ms) the card needs for one call on these inputs: the
    bytes of :func:`attention_work` over the memory rate and its flops
    over the tensor rate of the inputs' type; the larger bounds it."""
    nbytes, flops = attention_work(x, kw)
    q = x["q"]
    rate = BF16_FLOPS if q.dtype.is_floating_point and \
        q.element_size() == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_attention(x, kw):
    """scaled_dot_product_attention over the gathered pages: the
    yardstick (library_ms). The port never calls it. Quantized pools:
    the codes and scales are gathered outside the timed call, which
    dequantizes them to q's dtype, joins the fresh chunk, expands the GQA
    heads and then calls SDPA."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.inference.v2.paged import (gather_pages,
                                                        gather_scales)
    q = x["q"]
    b, sq, hq, d = q.shape
    hkv = x["k_new"].shape[2]
    rep = hq // hkv
    smax = x["block_tables"].shape[1] * x["k_pool"].shape[1]
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
    mask = mask[:, None]

    def expand(pages, new):
        return (torch.cat([pages, new], 1).transpose(1, 2)
                .repeat_interleave(rep, 1).contiguous())

    if kw.get("k_scale") is not None:
        codes = [gather_pages(x[n], x["block_tables"])
                 for n in ("k_pool", "v_pool")]
        scales = [gather_scales(kw[n], x["block_tables"])[..., None]
                  for n in ("k_scale", "v_scale")]

        def call():
            kt, vt = (expand((c.float() * sc).to(q.dtype), x[n])
                      for c, sc, n in zip(codes, scales, ("k_new", "v_new")))
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        return call
    kt = expand(gather_pages(x["k_pool"], x["block_tables"]), x["k_new"])
    vt = expand(gather_pages(x["v_pool"], x["block_tables"]), x["v_new"])

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    return call


def serving_shapes():
    """The serving path's decode (B 8, contexts 100-2000) and prefill
    (2 x 256 rows, one at pos0 300) calls."""
    rng = np.random.default_rng(0)
    ctx = rng.integers(100, 2001, 8)
    ctx[0], ctx[-1] = 100, 2000
    return (dict(b=8, sq=1, pos0=ctx.tolist(), true_len=[1] * 8),
            dict(b=2, sq=256, pos0=[0, 300], true_len=[256, 200]))


# a prefill tick of the serving path: 8 prompts of up to 700 tokens in
# chunks of 256, at their first, second and third chunk
PREFILL_TICK = dict(b=8, sq=256, pos0=[0, 256, 512, 0, 256, 512, 0, 256],
                    true_len=[256] * 8)


def verify_shape():
    """Phase 18's speculative verify call: the decode batch's contexts with
    S_new = 1 + draft_len (3) a row and true_len ragged within the call
    (1 + the drafts each row keeps; 0 for a row that ended)."""
    decode, _ = serving_shapes()
    return dict(decode, sq=4, true_len=[4, 1, 3, 0, 2, 4, 1, 4])


def time_attention(x, kw, dev, iters, flush) -> dict:
    """Kernel, plain and library ms of one call, its bound, the variant
    the call took, its TFLOP/s and GB/s over the work of
    :func:`attention_work`, its share of the bound, its ratio to the
    library call, whether a rerun gives the same bits, and the library
    output's largest difference from the plain version."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import paged
    ref = paged.paged_attention_plain(*x.values(), **kw)
    lib = library_attention(x, kw)
    lib_out = lib().transpose(1, 2)
    lib_err = max(float((lib_out[i, :t].float() - ref[i, :t].float())
                        .abs().max())
                  for i, t in enumerate(x["true_len"].tolist()) if t)
    bound, bound_by = attention_bound(x, kw)
    nbytes, flops = attention_work(x, kw)
    runs = [paged.paged_attention_kernel(*x.values(), **kw)
            for _ in range(2)]
    rec = dict(
        ms=time_ms(lambda: paged.paged_attention_kernel(*x.values(), **kw),
                   dev, iters, flush),
        plain_ms=time_ms(lambda: paged.paged_attention_plain(
            *x.values(), **kw), dev, max(iters // 4, 2), flush),
        library_ms=time_ms(lib, dev, iters, flush),
        bound_ms=bound, bound_by=bound_by, library_max_abs_err=lib_err,
        variant=paged.paged_attention_kernel.variant,
        bit_identical_rerun=bool(torch.equal(*runs)))
    rec.update(tflops=flops / rec["ms"] / 1e9,
               gb_per_s=nbytes / rec["ms"] / 1e6,
               bound_share=bound / rec["ms"],
               x_library=rec["ms"] / rec["library_ms"])
    return rec


def kernel_checks(dev, flush=None, iters=20):
    """Phase 3: kernel vs plain at the main path's shapes; times."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import paged
    decode, prefill = serving_shapes()
    cases = {"decode": decode, "prefill": prefill,
             "prefill_window": dict(prefill, window=128),
             "decode_alibi": dict(decode, alibi=True),
             "prefill_tick": PREFILL_TICK, "verify": verify_shape()}
    errs = {}
    record = {}
    for dtype_name, tol in ATTN_TOL.items():
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
            if dtype_name != "float32" and name in ("decode", "prefill",
                                                     "prefill_tick",
                                                     "verify"):
                key = name + ("_fp16" if dtype_name == "float16" else "")
                record[key] = time_attention(x, kw, dev, iters, flush)
                log(f"[kernel] {key} times (ms): {json.dumps(record[key])}")
                check_rerun(record[key], key)
    return errs, record


def check_rerun(rec: dict, name: str) -> None:
    """A timed paged call must rerun bit for bit (no atomics) on the card,
    through one of the bf16/fp16 variants of this port's design."""
    if rec["variant"] is not None and (
            not rec["bit_identical_rerun"]
            or rec["variant"] not in NEW_PAGED_VARIANTS):
        raise AssertionError(f"paged_attention {name}: variant "
                             f"{rec['variant']}, bit-identical rerun "
                             f"{rec['bit_identical_rerun']}")


# quantized-pool cases: head_dim, block size, heads, GQA, window, ALiBi,
# decode rows, prefill rows and chunks at pos0 > 0 over filled pools
QUANT_CASES = {
    "decode_d128_bs64_gqa": dict(d=128, bs=64, hq=32, hkv=8, b=4, sq=1,
                                 pos0=[100, 700, 0, 1999],
                                 true_len=[1, 1, 1, 1]),
    "prefill_d64_bs16_gqa": dict(d=64, bs=16, hq=8, hkv=2, b=2, sq=96,
                                 pos0=[0, 0], true_len=[96, 50]),
    "chunk_pos0_d32_bs8_window": dict(d=32, bs=8, hq=4, hkv=4, b=2, sq=40,
                                      pos0=[77, 130], true_len=[40, 33],
                                      window=50),
    "decode_d16_bs8_alibi": dict(d=16, bs=8, hq=4, hkv=1, b=3, sq=1,
                                 pos0=[5, 60, 200], true_len=[1, 1, 0],
                                 alibi=True),
    "chunk_pos0_d128_bs64_gqa": dict(d=128, bs=64, hq=32, hkv=8, b=2,
                                     sq=256, pos0=[300, 64],
                                     true_len=[256, 100]),
    "chunk_pos0_d64_bs16_window_alibi": dict(d=64, bs=16, hq=8, hkv=8, b=2,
                                             sq=24, pos0=[513, 31],
                                             true_len=[24, 7], window=100,
                                             alibi=True),
}
QUANT_NOTE = ("QUANT_CASES fp32+bf16 x int8/fp8 x head/token scales: D "
              "16-128, bs 8/16/64, GQA, window, ALiBi, decode, prefill, "
              "pos0 > 0")


def quantize_pools(x, kw, kv_dtype: str, granularity: str):
    """The case's fp pools as int8/fp8 codes (x) and f32 scales (kw)."""
    from deepspeed_tpu_torch.ops.quantization import kv_quantize
    hs = x["k_pool"].shape[2] if granularity == "head" else 1
    for pool, scale in (("k_pool", "k_scale"), ("v_pool", "v_scale")):
        x[pool], kw[scale] = kv_quantize(x[pool], kv_dtype, hs)
    return x, kw


def quant_checks(dev, flush=None, iters=20):
    """Phase 3, quantized pools: the kernel's int8/fp8 mode against its
    plain version over QUANT_CASES (fp32 1e-4, bf16 3e-2, fp16 1e-2,
    absolute plus relative as the fp mode); then times at the serving
    head layout (bf16 and fp16, int8 per-head pools) for decode and
    prefill."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import paged
    errs = {}
    for dtype_name, tol in ATTN_TOL.items():
        dtype = getattr(torch, dtype_name)
        for kv_dtype in ("int8", "fp8"):
            for gran in ("head", "token"):
                for name, shape in QUANT_CASES.items():
                    x, kw = quantize_pools(*attention_case(dev, dtype,
                                                           **shape),
                                           kv_dtype, gran)
                    got = paged.paged_attention_kernel(*x.values(), **kw)
                    ref = paged.paged_attention_plain(*x.values(), **kw)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    err = (got.float() - ref.float()).abs()
                    key = (dtype_name, kv_dtype, gran, name)
                    errs[key] = float(err.max())
                    if bool((err > tol + tol * ref.float().abs()).any()):
                        raise AssertionError(
                            f"paged_attention quantized mode disagrees with "
                            f"its plain version: {key}, max|err| "
                            f"{errs[key]:.3e} > tol {tol:g}")
            worst = max(v for k, v in errs.items()
                        if k[:2] == (dtype_name, kv_dtype))
            log(f"[kernel] quantized {kv_dtype} {dtype_name:9s} "
                f"{2 * len(QUANT_CASES)} cases max|err| {worst:.3e} "
                f"(tol {tol:g})")
    record = {}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float16, "_fp16")):
        for name, shape in zip(("decode", "prefill"), serving_shapes()):
            x, kw = quantize_pools(*attention_case(dev, dtype, **shape),
                                   "int8", "head")
            key = name + tag
            record[key] = time_attention(x, kw, dev, iters, flush)
            log(f"[kernel] quantized int8 {key} times (ms): "
                f"{json.dumps(record[key])}")
            check_rerun(record[key], f"int8 {key}")
    return errs, record


# ---------------------------------------------------------------- phase 4
# the serving main path's engine config (phase 4; phases 16, 20, 22 and
# 24 serve with it too)
SERVING_CONFIG = {"dtype": "bfloat16", "kv_block_size": 64,
                  "num_kv_blocks": 512, "max_chunk_size": 256,
                  "max_ragged_sequence_count": 8}


def serve(engine, prompts, max_new: int, dev):
    """generate() over prompts with each tick timed; returns outputs,
    wall seconds and per-tick (seconds, prefill tokens, decode rows, norm
    kernel launches)."""
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
        norms = norm_counter(engine.model.config)
        launched = norms.launches
        t = time.perf_counter()
        out = orig_tick()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t, prefill, decode,
                      norms.launches - launched))
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
              engine_over=None, dtype="bfloat16", family="llama",
              model_over=None, long_prompt=None):
    """Phase 4 (phase 16 with ``dtype="float16"``; phase 20 with another
    ``family``, ``model_over`` cutting its depth and a ``long_prompt``
    of that many tokens beside the requests): the serving main path at
    full width through generate(). The stats carry the greedy tokens
    under "outputs"."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import build_engine, paged
    cfg = dict(SERVING_CONFIG, dtype=dtype)
    cfg.update(engine_over or {})
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    engine = build_engine(family, size=size, engine_config=cfg, device=dev,
                          **(model_over or {}))
    build_s = time.perf_counter() - t
    build_peak = (torch.cuda.max_memory_allocated() / 2**30
                  if dev.type == "cuda" else None)
    log(f"[main] build_engine {family}-{size} {dtype}: {build_s:.1f} s")
    c = engine.model.config
    lens, prompts = serving_prompts(c.vocab_size, n_req, lengths,
                                    long_prompt)
    n_req = len(prompts)
    serve(engine, [prompts[0][:16]], 2, dev)          # warm-up
    norms = norm_counter(c)
    paged.paged_attention_kernel.launches = 0
    paged.paged_attention_kernel.variant_launches = {}
    reset_norms(norms)
    engine.serving_stats["host_dispatches"] = 0
    outs, wall, ticks = serve(engine, prompts, max_new, dev)
    launches = paged.paged_attention_kernel.launches
    by_variant = dict(paged.paged_attention_kernel.variant_launches)
    norm_launches = norms.launches
    norm_by_variant = check_norm_variants(norms, dev, "serving")
    dispatches = engine.serving_stats["host_dispatches"]
    for o in outs:
        if len(o) != max_new or not all(0 <= t < c.vocab_size for t in o):
            raise AssertionError(f"bad generate() output {o[:8]}...")
    # the plain version counts nothing: a CPU rehearsal skips this check
    if dev.type == "cuda" and (launches != c.num_layers * dispatches
                               or launches == 0):
        raise AssertionError(
            f"kernel launches {launches} != layers {c.num_layers} x "
            f"dispatches {dispatches}")
    if dev.type == "cuda" and norm_launches != norms_per_forward(c) \
            * dispatches:
        raise AssertionError(
            f"norm launches {norm_launches} != {norms_per_forward(c)} a "
            f"forward x dispatches {dispatches}")
    check_variants(by_variant, launches, dev, "serving")
    pre = [(s, p) for s, p, _, _ in ticks if p > 0]
    dec = [s for s, p, d, _ in ticks if p == 0 and d > 0]
    stats = dict(
        model=f"{family}-{size}", dtype=dtype,
        quantize_weights=bool(cfg.get("quantize_weights")),
        weight_bytes=weight_bytes(engine.model.params), build_s=build_s,
        build_peak_gib=build_peak,
        requests=n_req, new_tokens=max_new, prompt_tokens=int(lens.sum()),
        ticks=len(ticks), dispatches=dispatches, launches=launches,
        launches_by_variant=by_variant, norm_launches=norm_launches,
        norm_launches_by_variant=norm_by_variant,
        decode_norm_launches=sum(n for _, p, d, n in ticks
                                 if p == 0 and d > 0),
        prefill_ticks=len(pre),
        prefill_tokens_per_s=sum(p for _, p in pre) / sum(s for s, _ in pre),
        decode_ticks=len(dec),
        decode_ms_per_tick=1e3 * sum(dec) / max(len(dec), 1),
        generate_s=wall,
        e2e_generated_tokens_per_s=n_req * max_new / wall,
        e2e_tokens_per_s=(int(lens.sum()) + n_req * max_new) / wall)
    log(f"[main] {json.dumps(stats)}")
    stats["outputs"] = outs
    stats["prompts"] = prompts
    return engine, stats


def reset_norms(counter) -> None:
    """Set a norm kernel's launch counts to 0."""
    counter.launches = 0
    counter.variant_launches = {}


def check_norm_variants(counter, dev, what: str) -> dict:
    """Every norm launch of a main path since ``reset_norms`` took one of
    the row kernels (NEW_NORM_VARIANTS; the counts by variant add up to the
    launches). Returns the counts by variant."""
    by_variant = dict(counter.variant_launches)
    if dev.type == "cuda" and (
            sum(by_variant.values()) != counter.launches
            or set(by_variant) - set(NEW_NORM_VARIANTS)):
        raise AssertionError(f"{what}: norm launches by variant "
                             f"{by_variant}, {counter.launches} in all; "
                             f"every launch must take {NEW_NORM_VARIANTS}")
    return by_variant


def check_variants(by_variant: dict, launches: int, dev, what: str) -> None:
    """Every bf16/fp16 paged-attention launch of a main path took one of
    the port's new kernels (the counts by variant add up to the
    launches)."""
    if dev.type == "cuda" and (sum(by_variant.values()) != launches or
                               set(by_variant) - set(NEW_PAGED_VARIANTS)):
        raise AssertionError(f"{what}: paged launches by variant "
                             f"{by_variant}, {launches} in all; every "
                             f"bf16/fp16 launch must take "
                             f"{NEW_PAGED_VARIANTS}")


# ---------------------------------------------------------------- phase 5
def teacher_forced_logits(model, dev, use_kernel: bool, bs: int, nb=16,
                          lens=(200, 250), attention=None, seed=2,
                          kv_dtype=None):
    """paged_forward over one prefill chunk (two rows of ``lens`` prompt
    tokens) and then two decode ticks whose input tokens are drawn in
    advance (teacher forcing: every variant sees the same inputs), on
    fresh zeroed pools: the model's dtype, or ``kv_dtype`` ("int8",
    "fp8") codes with per-head scales, which the decode ticks read back.
    ``attention`` goes to paged_forward. Returns each tick's last-token
    logits in fp32."""
    import torch
    from deepspeed_tpu_torch.inference.v2.paged import paged_forward
    from deepspeed_tpu_torch.ops.quantization import KV_STORE_DTYPES
    c = model.config
    dtype = next(iter(model.params.values())).dtype
    shape = (c.num_layers, nb, bs, c.num_kv_heads, c.head_dim)
    store = KV_STORE_DTYPES[kv_dtype] if kv_dtype else dtype
    pools = {k: torch.zeros(shape, dtype=store, device=dev)
             for k in ("k", "v")}
    if kv_dtype:
        pools.update({k: torch.zeros(shape[:4], dtype=torch.float32,
                                     device=dev) for k in ("ks", "vs")})
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


def layer_checker(tol: float):
    """An ``attention`` for paged_forward that launches the kernel and
    holds it against its plain version on the same inputs (abs + rel
    ``tol``) at every call; the dict counts the calls and keeps the worst
    error."""
    from deepspeed_tpu_torch.inference.v2 import paged
    worst = {"layer_calls": 0, "max_abs_err": 0.0, "variants": {}}

    def checked(*args, sanitize_pools=True, **kw):
        got = paged.paged_attention_kernel(
            *args, sanitize_pools=sanitize_pools, **kw)
        if args[0].device.type == "cuda":
            v = paged.paged_attention_kernel.variant
            worst["variants"][v] = worst["variants"].get(v, 0) + 1
        ref = paged.paged_attention_plain(*args, **kw).float()
        err = (got.float() - ref).abs()
        worst["layer_calls"] += 1
        worst["max_abs_err"] = max(worst["max_abs_err"], float(err.max()))
        if bool((err > tol + tol * ref.abs()).any()):
            raise AssertionError(
                f"layer call {worst['layer_calls']}: kernel vs plain "
                f"max|err| {float(err.max()):.3e} > tol {tol:g}")
        return got

    return checked, worst


def widened(model, dev):
    """An fp32 copy of ``model`` (same weights, widened)."""
    import torch
    model32 = type(model)(model.config, device=dev, dtype=torch.float32)
    with torch.no_grad():
        for name, p in model.params.items():
            model32.params[name].copy_(p)
    return model32


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

    model32 = widened(model, dev)
    norms = norm_counter(model.config)
    norms.launches = 0
    kernel32 = teacher_forced_logits(model32, dev, True, bs, nb, lens)
    kernel_norms = norms.launches
    ref32 = teacher_forced_logits(model32, dev, False, bs, nb, lens)
    plain_norms = norms.launches - kernel_norms
    del model32
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checked, worst = layer_checker(TOL["bfloat16"])

    def plain(*args, sanitize_pools=True, **kw):
        return paged.paged_attention_plain(*args, **kw)

    kernel16 = teacher_forced_logits(model, dev, True, bs, nb, lens,
                                     attention=checked)
    plain16 = teacher_forced_logits(model, dev, True, bs, nb, lens,
                                    attention=plain)
    ref16 = teacher_forced_logits(model, dev, False, bs, nb, lens)
    check_variants(worst["variants"], worst["layer_calls"], dev,
                   "bf16 layer calls")
    rels = {"fp32_kernel_vs_reference": rel_err(kernel32, ref32),
            "bf16_layer_calls": worst["layer_calls"],
            "bf16_layer_max_abs_err": worst["max_abs_err"],
            "bf16_layer_calls_by_variant": worst["variants"],
            "bf16_kernel_vs_reference": rel_err(kernel16, ref16),
            "bf16_plain_vs_reference": rel_err(plain16, ref16),
            "bf16_kernel_vs_fp32": rel_err(kernel16, ref32),
            "bf16_reference_vs_fp32": rel_err(ref16, ref32)}
    log(f"[main vs plain] max|dlogits|/max|logits|: {json.dumps(rels)}")
    if rels["fp32_kernel_vs_reference"] > TOL["float32"]:
        raise AssertionError(f"main path fp32 kernel vs plain: {rels}")
    if worst["layer_calls"] != 3 * model.config.num_layers:
        raise AssertionError(f"{worst['layer_calls']} checked layer calls")
    want = 3 * (2 * model.config.num_layers + 1)      # three ticks
    rels["fp32_norm_launches"] = {"kernel": kernel_norms,
                                  "reference": plain_norms}
    if dev.type == "cuda" and (kernel_norms, plain_norms) != (want, 0):
        raise AssertionError(f"norm launches kernel/reference path "
                             f"{kernel_norms}/{plain_norms} != {want}/0")
    return rels


# ----------------------------------------------------------- phase 11
# Path Q: the serving path from an int8 KV cache with the prefix cache on
PATH_Q_CONFIG = {"kv_cache": {"enabled": True, "dtype": "int8",
                              "granularity": "head", "grow_pool": True},
                 "prefix_cache": {"enabled": True}}


def agreement(outs, refs) -> list[int]:
    """Per request, how many leading greedy tokens agree."""
    return [next((i for i, (a, b) in enumerate(zip(o, r)) if a != b),
                 min(len(o), len(r))) for o, r in zip(outs, refs)]


def path_q_main(dev, ref_engine, size="3-8b", n_req=8, max_new=32,
                prefix_len=512, suffix=(100, 401), engine_over=None,
                dtype="bfloat16"):
    """Phase 11: build_engine("llama", size, {..., kv_cache int8 per head
    with grow_pool, prefix_cache on}) with the same seeded weights as
    phase 4's ``ref_engine``. A shared ``prefix_len``-token system prompt
    is served alone first (the warm-up that publishes its blocks), then
    ``n_req`` requests of that prefix plus their own suffix, ``max_new``
    greedy tokens each, through generate(); the counts and the serving
    metrics are set to 0 right before and read right after. The same
    prompts then go through ``ref_engine`` (bf16 pools, no prefix cache)
    for the greedy agreement horizon, reported without a bound. Phase 16
    runs it with ``dtype="float16"`` beside phase 16's fp16 engine."""
    from deepspeed_tpu_torch.inference.v2 import build_engine, paged
    cfg = {"dtype": dtype, "kv_block_size": 64, "num_kv_blocks": 512,
           "max_chunk_size": 256, "max_ragged_sequence_count": 8,
           **PATH_Q_CONFIG}
    cfg.update(engine_over or {})
    t = time.perf_counter()
    engine = build_engine("llama", size=size, engine_config=cfg, device=dev)
    log(f"[path Q] build_engine llama-{size} {dtype} int8 KV + prefix "
        f"cache: {time.perf_counter() - t:.1f} s")
    c = engine.model.config
    bs = cfg["kv_block_size"]
    prefix, lens, prompts = path_q_prompts(c.vocab_size, n_req, prefix_len,
                                           suffix)
    serve(engine, [prefix], 2, dev)            # warm-up: publishes prefix
    norms = norm_counter(c)
    paged.paged_attention_kernel.launches = 0
    paged.paged_attention_kernel.variant_launches = {}
    reset_norms(norms)
    engine.reset_serving_metrics()
    outs, wall, ticks = serve(engine, prompts, max_new, dev)
    launches = paged.paged_attention_kernel.launches
    by_variant = dict(paged.paged_attention_kernel.variant_launches)
    norm_launches = norms.launches
    norm_by_variant = check_norm_variants(norms, dev, "Path Q")
    m = engine.serving_metrics()
    dispatches = m["host_dispatches"]
    bad = []
    for o in outs:
        if len(o) != max_new or not all(0 <= t < c.vocab_size for t in o):
            bad.append(f"bad generate() output {o[:8]}...")
    ref_bytes = ref_engine.kv_pool_bytes()
    want = {"num_kv_blocks": 992 if (size, bs, cfg["num_kv_blocks"]) ==
            ("3-8b", 64, 512) else engine.num_kv_blocks,
            "prefix_hits": n_req * (prefix_len // bs),
            "prefill_tokens_saved": n_req * (prefix_len // bs) * bs}
    got = {"num_kv_blocks": engine.num_kv_blocks,
           "prefix_hits": m["prefix_hits"],
           "prefill_tokens_saved": m["prefill_tokens_saved"]}
    if got != want:
        bad.append(f"Path Q {got} != {want}")
    if engine.kv_pool_bytes() > ref_bytes:
        bad.append(f"int8 pool {engine.kv_pool_bytes()} B > bf16 pool "
                   f"{ref_bytes} B")
    if dev.type == "cuda" and (launches != c.num_layers * dispatches
                               or launches == 0):
        bad.append(f"kernel launches {launches} != layers {c.num_layers} x "
                   f"dispatches {dispatches}")
    if dev.type == "cuda" and norm_launches != (2 * c.num_layers + 1) \
            * dispatches:
        bad.append(f"norm launches {norm_launches} != (2 x {c.num_layers} "
                   f"+ 1) x dispatches {dispatches}")
    if engine.free_blocks != engine.num_kv_blocks:
        bad.append(f"free_blocks {engine.free_blocks} != "
                   f"{engine.num_kv_blocks} after the flush")
    if bad:
        raise AssertionError("; ".join(bad))
    check_variants(by_variant, launches, dev, "Path Q")
    refs = ref_engine.generate(prompts, max_new_tokens=max_new)
    horizon = agreement(outs, refs)
    pre = [(s, p) for s, p, _, _ in ticks if p > 0]
    dec = [s for s, p, d, _ in ticks if p == 0 and d > 0]
    stats = dict(
        dtype=dtype, reference_engine_dtype=str(ref_engine.dtype),
        requests=n_req, new_tokens=max_new, prefix_tokens=prefix_len,
        suffix_tokens=int(lens.sum()), ticks=len(ticks),
        dispatches=dispatches, launches=launches,
        launches_by_variant=by_variant,
        norm_launches=norm_launches,
        norm_launches_by_variant=norm_by_variant, prefill_ticks=len(pre),
        prefill_tokens_per_s=sum(p for _, p in pre) / sum(s for s, _ in pre),
        decode_ticks=len(dec),
        decode_ms_per_tick=1e3 * sum(dec) / max(len(dec), 1),
        generate_s=wall, e2e_generated_tokens_per_s=n_req * max_new / wall,
        kv_num_blocks=engine.num_kv_blocks,
        bf16_kv_num_blocks=ref_engine.num_kv_blocks,
        resident_request_ratio=engine.num_kv_blocks
        / ref_engine.num_kv_blocks,
        kv_pool_bytes=engine.kv_pool_bytes(), bf16_kv_pool_bytes=ref_bytes,
        kv_bytes_per_token=engine.kv_bytes_per_token(),
        bf16_kv_bytes_per_token=ref_engine.kv_bytes_per_token(),
        prefix_hits=m["prefix_hits"], prefix_misses=m["prefix_misses"],
        prefill_tokens_saved=m["prefill_tokens_saved"],
        greedy_agreement_vs_bf16=horizon,
        greedy_agreement_min=min(horizon),
        greedy_agreement_mean=sum(horizon) / len(horizon))
    log(f"[path Q] {json.dumps(stats)}")
    stats["outputs"] = outs
    stats["prompts"] = prompts
    return engine, stats


# ----------------------------------------------------------- phase 12
def path_q_kernel_vs_plain(engine, dev, lens=(200, 250), nb=16,
                           widen=True):
    """Phase 12: Path Q teacher-forced as in phase 5, on int8 and on fp8
    per-head pools. At every layer of every tick the kernel's output is
    held against its plain version on the same inputs and the same
    quantized pools: the engine's dtype as it serves (bf16 3e-2, fp16
    1e-2) and, with ``widen``, fp32 (the weights widened, TF32 off) at
    1e-4. The logits of the kernel path against the reference path
    (``use_kernel=False``, which dequantizes the gathered pages) are
    reported, not held: a last-bit difference in k can flip one code in a
    later layer."""
    import torch
    model = engine.model
    bs = engine.state_manager.block_size
    calls = 3 * model.config.num_layers
    out = {}
    models = [(str(engine.dtype).split(".")[-1], model)]
    if widen:
        models.insert(0, ("float32", widened(model, dev)))
    for kv in ("int8", "fp8"):
        rec = {}
        for dtype_name, m in models:
            checked, worst = layer_checker(ATTN_TOL[dtype_name])
            kern = teacher_forced_logits(m, dev, True, bs, nb, lens,
                                         attention=checked, kv_dtype=kv)
            ref = teacher_forced_logits(m, dev, False, bs, nb, lens,
                                        kv_dtype=kv)
            if worst["layer_calls"] != calls:
                raise AssertionError(f"{worst['layer_calls']} checked layer "
                                     f"calls != {calls}")
            if dtype_name != "float32":
                check_variants(worst["variants"], calls, dev,
                               f"Path Q {kv} {dtype_name} layer calls")
            rec[dtype_name] = dict(
                layer_calls=worst["layer_calls"],
                layer_calls_by_variant=worst["variants"],
                layer_max_abs_err=worst["max_abs_err"],
                tol=ATTN_TOL[dtype_name],
                logits_kernel_vs_reference=rel_err(kern, ref))
        out[kv] = rec
        log(f"[path Q vs plain] {kv}: {json.dumps(rec)}")
    del models
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------- phase 16
def fp16_kernel_vs_plain(engine, dev, lens=(200, 250), nb=16):
    """Phase 16's check of the fp16 engine as it serves, teacher-forced as
    phase 5: at every layer of the three ticks the kernel's output against
    its plain version on the same inputs at ATTN_TOL's fp16 1e-2, every
    call on a new variant; the first (prefill) tick's logits of the kernel
    path against the path with the plain attention at FP16_LOGITS_TOL of
    max |logits|; every tick's logits against the reference path
    (``use_kernel=False``) reported. Logits must be finite."""
    from deepspeed_tpu_torch.inference.v2 import paged
    model = engine.model
    bs = engine.state_manager.block_size
    checked, worst = layer_checker(ATTN_TOL["float16"])

    def plain(*args, sanitize_pools=True, **kw):
        return paged.paged_attention_plain(*args, **kw)

    kernel = teacher_forced_logits(model, dev, True, bs, nb, lens,
                                   attention=checked)
    plain16 = teacher_forced_logits(model, dev, True, bs, nb, lens,
                                    attention=plain)
    ref = teacher_forced_logits(model, dev, False, bs, nb, lens)
    check_variants(worst["variants"], worst["layer_calls"], dev,
                   "fp16 layer calls")
    rels = {"layer_calls": worst["layer_calls"],
            "layer_max_abs_err": worst["max_abs_err"],
            "layer_tol": ATTN_TOL["float16"],
            "layer_calls_by_variant": worst["variants"],
            "first_tick_logits_kernel_vs_plain":
                rel_err(kernel[:1], plain16[:1]),
            "first_tick_logits_tol": FP16_LOGITS_TOL,
            "logits_kernel_vs_plain": rel_err(kernel, plain16),
            "logits_kernel_vs_reference": rel_err(kernel, ref),
            "logits_plain_vs_reference": rel_err(plain16, ref)}
    log(f"[fp16 vs plain] max|dlogits|/max|logits|: {json.dumps(rels)}")
    if worst["layer_calls"] != 3 * model.config.num_layers:
        raise AssertionError(f"{worst['layer_calls']} checked layer calls")
    if rels["first_tick_logits_kernel_vs_plain"] > FP16_LOGITS_TOL:
        raise AssertionError(f"fp16 first tick's logits, kernel vs plain "
                             f"attention: {rels}")
    return rels


def fp16_serving_main(dev, bf16_outputs, size="3-8b", q_requests=4,
                      max_new=32, lengths=(100, 701), engine_over=None,
                      check_lens=(200, 250), profile=False, **path_q_kw):
    """Phase 16: the serving main path in fp16 (DeepSpeed's default
    inference dtype): phase 4's model, requests and engine config with
    {"dtype": "fp16"}, every paged launch decode_split or prefill_wgmma
    and (on the card) every norm launch cta_row; the greedy agreement with
    phase 4's bf16 outputs (``bf16_outputs``), reported; the engine's
    layers and first tick against plain (:func:`fp16_kernel_vs_plain`);
    then Path Q's config in fp16 with ``q_requests`` requests, and its
    layers on int8 and fp8 pools at the fp16 tolerance. With ``profile``,
    a prefill tick and decode ticks of the fp16 engine are traced as
    phase 4's are."""
    import torch
    engine, stats = main_path(dev, size=size, max_new=max_new,
                              lengths=lengths, dtype="float16",
                              engine_over=engine_over)
    horizon = agreement(stats.pop("outputs"), bf16_outputs)
    del stats["prompts"]
    stats.update(greedy_agreement_vs_bf16=horizon,
                 greedy_agreement_min=min(horizon),
                 greedy_agreement_mean=sum(horizon) / len(horizon))
    by_norm = stats["norm_launches_by_variant"]
    if dev.type == "cuda" and set(by_norm) != {"cta_row"}:
        raise AssertionError(f"fp16 serving: norm launches by variant "
                             f"{by_norm}; every launch must take cta_row")
    rels = fp16_kernel_vs_plain(engine, dev, lens=check_lens)
    if profile:
        profile_main_path(engine, dev, label="fp16_")
    q_engine, path_q = path_q_main(dev, engine, size=size, n_req=q_requests,
                                   max_new=max_new, dtype="float16",
                                   engine_over=engine_over, **path_q_kw)
    del path_q["outputs"], path_q["prompts"]
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    q_rels = path_q_kernel_vs_plain(q_engine, dev, lens=check_lens,
                                    widen=False)
    del q_engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = dict(serving=stats, kernel_vs_plain=rels, path_q=path_q,
               path_q_kernel_vs_plain=q_rels)
    log(f"[fp16] {json.dumps(out)}")
    return out


# ----------------------------------------------------------- phase 17
# the sampling setting of phase 17's stochastic checks
FUSED_SAMPLING = dict(temperature=0.9, top_k=50, top_p=0.9)
FUSED_SEED = 13


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()


# the engine's dispatch functions: chain mode, spec chain, ring, spec ring
DISPATCH_FNS = ("_fused_fn", "_spec_fn", "_serve_fn", "_spec_serve_fn")


def count_ticks(engine) -> list:
    """Wrap the engine's dispatch functions (``DISPATCH_FNS``) so that
    every dispatch appends the ticks it runs (a graph launches every tick
    it captured) to the returned list; :func:`uncount_ticks` takes the
    wrappers off."""
    ticks: list[int] = []

    def wrap(orig):
        def counting(state, num_steps, *args):
            fn = orig(state, num_steps, *args)

            def run():
                ticks.append(num_steps)
                return fn()
            return run
        return counting

    for name in DISPATCH_FNS:
        setattr(engine, name, wrap(getattr(engine, name)))
    return ticks


def uncount_ticks(engine) -> None:
    """Back to the class's dispatch methods (no reference cycle)."""
    for name in DISPATCH_FNS:
        engine.__dict__.pop(name, None)


def serve_fused(engine, prompts, max_new: int, dev, k=None, **sampling):
    """generate_fused's closed loop over ``prompts`` (FusedServeLoop in
    the engine's mode), with its prefill timed: returns the outputs and
    the run's wall, prefill seconds and tokens, fused steps, dispatches
    and tokens, the loop's host reads and its operand builds (chains)."""
    from deepspeed_tpu_torch.inference.v2.serve_loop import FusedServeLoop
    loop = FusedServeLoop(engine, k_steps=k, strict=True, **sampling)
    mgr = engine.state_manager
    pre = {"s": 0.0, "tokens": 0}
    orig = loop._prefill
    builds = [0]
    orig_rows = engine._dispatch_rows

    def counted_rows(*args):
        builds[0] += 1
        return orig_rows(*args)

    engine._dispatch_rows = counted_rows

    def timed_prefill(ids, ev):
        pre["tokens"] += sum(mgr.seqs[u].pending for u in ids)
        sync(dev)
        t0 = time.perf_counter()
        orig(ids, ev)
        sync(dev)
        pre["s"] += time.perf_counter() - t0

    loop._prefill = timed_prefill
    results = {i: [] for i in range(len(prompts))}
    for i, prompt in enumerate(prompts):
        loop.submit(prompt, max_new, uid=i)
    st = engine.serving_stats
    steps0, disp0 = st["fused_steps"], st["fused_dispatches"]
    tok0 = st["fused_slot_tokens"]
    sync(dev)
    t = time.perf_counter()
    try:
        while loop.has_work():
            for evt in loop.step():
                results[evt.uid].extend(evt.tokens)
        sync(dev)
    finally:
        del engine._dispatch_rows
    wall = time.perf_counter() - t
    outs = [results[i][:max_new] for i in range(len(prompts))]
    return outs, dict(wall_s=wall, prefill_s=pre["s"],
                      prefill_tokens=pre["tokens"],
                      steps=st["fused_steps"] - steps0,
                      dispatches=st["fused_dispatches"] - disp0,
                      fused_tokens=st["fused_slot_tokens"] - tok0,
                      host_reads=loop.host_reads, chains=builds[0])


def at_dispatch_state(engine, prompts, uids):
    """Prefill ``prompts`` as ``uids`` (put()) and append each one's greedy
    first token: every uid then holds the one pending token a fused
    dispatch takes."""
    logits = engine.put(uids, prompts)
    for u, t in zip(uids, logits.float().argmax(-1).tolist()):
        engine.state_manager.extend(u, [t])


def fused_graph_vs_eager(engine, prompts, dev, k=8, budget=32):
    """One captured dispatch of ``k`` ticks and the same ticks run eagerly
    (``engine._fused_eager``, the same kernels) from the same operands and
    pools, sampling on: the tokens, the steps run, the carry, the pools
    and the last tick's logits must be equal bit for bit."""
    import torch
    uids = list(range(20_000, 20_000 + len(prompts)))
    at_dispatch_state(engine, prompts, uids)
    loop_kw = dict(eos_id=None, **FUSED_SAMPLING)
    state = engine._fused_operands(uids, k, {u: budget for u in uids},
                                   FUSED_SEED)
    ops0 = {n: t.clone() for n, t in state.operands().items()}
    pools0 = {n: t.clone() for n, t in engine.pools.items()}
    fn = engine._fused_fn(state, k, FUSED_SAMPLING["temperature"],
                          FUSED_SAMPLING["top_k"], FUSED_SAMPLING["top_p"],
                          None)
    toks_g, steps_g = fn().read()
    graph = dict(logits=state.logits.clone(),
                 **{n: t.clone() for n, t in state.operands().items()})
    pools_g = {n: t.clone() for n, t in engine.pools.items()}
    for n, t in engine.pools.items():
        t.copy_(pools0[n])
    for n, t in state.operands().items():
        t.copy_(ops0[n])
    engine._fused_eager(state, k, **loop_kw)
    sync(dev)
    toks_e = state.out[:, :k].cpu().numpy()
    steps_e = int(state.steps)
    bad = [n for n, t in state.operands().items()
           if not torch.equal(t, graph[n])]
    bad += [f"pool {n}" for n, t in engine.pools.items()
            if not torch.equal(t, pools_g[n])]
    logits_equal = torch.equal(state.logits, graph["logits"])
    del pools0, pools_g
    engine.flush(uids)
    rec = dict(rows=len(uids), ticks=k, tokens_equal=bool(
        (toks_g == toks_e).all()), steps=[steps_g, steps_e],
        last_logits_bit_equal=logits_equal, differing=bad,
        sampled=int((toks_g >= 0).sum()))
    if not (rec["tokens_equal"] and logits_equal and not bad
            and steps_g == steps_e == k):
        raise AssertionError(f"graph replay against eager: {rec}")
    return rec


def threefry_cuda_vs_cpu(dev) -> dict:
    """Threefry keys and bits on the card against the CPU's: fold_in over
    positions, random bits and uniforms bit for bit (integer arithmetic);
    gumbel noise within 4 ulps of max(|g|, 1) (each side's log is within
    an ulp)."""
    import torch
    from deepspeed_tpu_torch.ops import threefry
    keys = threefry.fold_in(threefry.prng_key(FUSED_SEED),
                            torch.arange(8))
    pos = torch.arange(8) * 977 + 5
    rec = {}
    for name, f in (("fold_in", lambda k, p: threefry.fold_in(k, p)),
                    ("bits", lambda k, p: threefry.random_bits(
                        threefry.fold_in(k, p), 128256)),
                    ("uniform", lambda k, p: threefry.uniform(
                        threefry.fold_in(k, p), 128256))):
        cpu, gpu = f(keys, pos), f(keys.to(dev), pos.to(dev)).cpu()
        rec[name + "_bit_equal"] = torch.equal(cpu, gpu)
    g_cpu = threefry.gumbel(keys, 128256)
    g_gpu = threefry.gumbel(keys.to(dev), 128256).cpu()
    ulp = torch.from_numpy(np.spacing(np.maximum(
        g_cpu.abs().numpy(), 1).astype(np.float32)))
    rec["gumbel_max_ulps"] = float(((g_gpu.double() - g_cpu.double()).abs()
                                    / ulp.double()).max())
    if not all(v for k, v in rec.items() if k.endswith("bit_equal")) \
            or rec["gumbel_max_ulps"] > 4:
        raise AssertionError(f"threefry on the card against the CPU: {rec}")
    return rec


def profile_fused(engine, dev, prompts, k=8,
                  modes=("greedy", "sampled")) -> dict:
    """Where a fused dispatch's time goes: ``k`` decode ticks of
    ``len(prompts)`` rows, one graph replay, traced (torch.profiler; CUDA
    events around the replay if the trace shows no device time), greedy
    and then (``modes``) sampling with ``FUSED_SAMPLING`` (the same rows
    rebuilt from the host state: the sampled replay rewrites the greedy
    one's slots)."""
    import torch
    uids = list(range(30_000, 30_000 + len(prompts)))
    at_dispatch_state(engine, prompts, uids)
    out = {}
    for name, sampling in (("greedy", (0.0, 0, 0.0)),
                           ("sampled", tuple(FUSED_SAMPLING.values()))):
        if name not in modes:
            continue
        state = engine._fused_operands(uids, k, {u: k for u in uids},
                                       FUSED_SEED)
        fn = engine._fused_fn(state, k, *sampling, None)   # captured here
        window = f"fused_decode_{name}"
        try:
            _, rec = profile_window(window, lambda: fn().read(), k)
        except AssertionError:
            sync(dev)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "ab")
            t = time.perf_counter()
            start.record()
            fn().read()
            end.record()
            end.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            busy = start.elapsed_time(end)
            rec = {"window": window, "ticks": k, "wall_ms": wall,
                   "device_ms_events": busy,
                   "device_idle_share": 1 - busy / wall,
                   "note": "no device time traced inside the graph"}
            log(f"[profile] {json.dumps(rec)}")
        out[name] = rec
    engine.flush(uids)
    return out


def fused_serving_main(engine, dev, prompts, per_tick, max_new=32, k=8,
                       profile=False, sample_requests=4, sample_new=16):
    """Phase 17: phase 4's engine (fused_decode_steps 8 and
    max_inflight_dispatches 2, the defaults) serves phase 4's requests
    through generate_fused's loop: a first run that captures the graphs,
    then the timed run, with the counts set to 0 just before it. Checks:
    every output full and the rerun's tokens equal the first run's; every
    paged launch of a graph replay decode_split and every prefill's
    prefill_wgmma, every norm cta_row, the counts equal what the replays
    and prefill dispatches ran; dispatches a token <= 0.25 (the JAX
    gate); one dispatch replayed against the same ticks run eagerly, bit
    for bit; stochastic tokens (``FUSED_SAMPLING``) equal at k 2 and k 8;
    threefry on the card equal to the CPU's. Reported: prefill tokens/s,
    decode ms a token step (the decode wall over its steps) beside phase
    4's per-tick figure, dispatches a token, occupancy, the greedy
    agreement with phase 4's tokens (``per_tick``), and each graph's
    capture ms and pool MiB."""
    from deepspeed_tpu_torch.inference.v2 import paged
    c = engine.model.config
    layers = c.num_layers
    first = len(engine.graph_captures)
    warm, warm_run = serve_fused(engine, prompts, max_new, dev, k)
    norms = norm_counter(c)
    ticks = count_ticks(engine)
    paged.paged_attention_kernel.launches = 0
    paged.paged_attention_kernel.variant_launches = {}
    reset_norms(norms)
    engine.reset_serving_metrics()
    timed_first = len(engine.graph_captures)
    try:
        outs, run = serve_fused(engine, prompts, max_new, dev, k)
    finally:
        uncount_ticks(engine)
    launches = paged.paged_attention_kernel.launches
    by_variant = dict(paged.paged_attention_kernel.variant_launches)
    norm_by_variant = dict(norms.variant_launches)
    m = engine.serving_metrics()
    prefill_dispatches = m["host_dispatches"] - m["fused_dispatches"]
    # a capture's warm-up tick launches eagerly (none in a rerun)
    graph_ticks = sum(ticks) + len(engine.graph_captures) - timed_first
    bad = []
    if outs != warm:
        bad.append("the rerun's tokens differ from the first run's")
    for o in outs:
        if len(o) != max_new or not all(0 <= t < c.vocab_size for t in o):
            bad.append(f"bad generate_fused() output {o[:8]}...")
    want = {"decode_split": layers * graph_ticks,
            "prefill_wgmma": layers * prefill_dispatches}
    if dev.type == "cuda" and (by_variant != want
                               or launches != sum(want.values())):
        bad.append(f"paged launches {launches} by variant {by_variant} != "
                   f"{want} (graph ticks {graph_ticks}, prefill dispatches "
                   f"{prefill_dispatches})")
    want_norms = (2 * layers + 1) * (graph_ticks + prefill_dispatches)
    if dev.type == "cuda" and (norms.launches != want_norms
                               or set(norm_by_variant) != {"cta_row"}):
        bad.append(f"norm launches {norms.launches} by variant "
                   f"{norm_by_variant} != {want_norms} cta_row")
    if m["dispatches_per_token"] > 0.25:
        bad.append(f"dispatches a token {m['dispatches_per_token']} > 0.25")
    if bad:
        raise AssertionError("phase 17: " + "; ".join(bad))
    captures = engine.graph_captures[first:]
    horizon = agreement(outs, per_tick["outputs"])
    decode_s = run["wall_s"] - run["prefill_s"]
    stats = dict(
        requests=len(prompts), new_tokens=max_new, k=k,
        max_inflight_dispatches=m["max_inflight_dispatches"],
        prefill_tokens=run["prefill_tokens"],
        prefill_tokens_per_s=run["prefill_tokens"] / run["prefill_s"],
        decode_steps=run["steps"], fused_dispatches=run["dispatches"],
        decode_ms_per_step=1e3 * decode_s / max(run["steps"], 1),
        per_tick_decode_ms_per_tick=per_tick["decode_ms_per_tick"],
        per_tick_prefill_tokens_per_s=per_tick["prefill_tokens_per_s"],
        generate_fused_s=run["wall_s"],
        first_run_s=warm_run["wall_s"],
        e2e_generated_tokens_per_s=len(prompts) * max_new / run["wall_s"],
        dispatches_per_token=m["dispatches_per_token"],
        fused_occupancy=m["fused_occupancy"],
        tokens_per_dispatch=m["tokens_per_dispatch"],
        launches=launches, launches_by_variant=by_variant,
        graph_ticks=graph_ticks, prefill_dispatches=prefill_dispatches,
        norm_launches=norms.launches,
        norm_launches_by_variant=norm_by_variant,
        greedy_agreement_vs_per_tick=horizon,
        greedy_agreement_mean=sum(horizon) / len(horizon),
        graphs_captured=len(captures), captures=captures,
        capture_ms_total=sum(g["capture_ms"] for g in captures),
        graph_pool_mib_total=sum(g["pool_mib"] for g in captures))
    log(f"[fused] greedy {json.dumps(stats)}")
    stats["graph_vs_eager"] = fused_graph_vs_eager(engine, prompts, dev, k)
    # stochastic: the same tokens whether a dispatch runs 2 ticks or 8
    few = [p[:200] for p in prompts[:sample_requests]]
    runs = {}
    for kk in (2, k):
        runs[kk], _ = serve_fused(engine, few, sample_new, dev, kk,
                                  seed=FUSED_SEED, **FUSED_SAMPLING)
    greedy_few = [o[:sample_new] for o in serve_fused(
        engine, few, sample_new, dev, k)[0]]
    stats["sampling"] = dict(
        FUSED_SAMPLING, seed=FUSED_SEED, requests=len(few),
        new_tokens=sample_new, k2_equals_k8=runs[2] == runs[k],
        differs_from_greedy=runs[k] != greedy_few)
    if not stats["sampling"]["k2_equals_k8"]:
        raise AssertionError(f"sampled tokens at k 2 {runs[2]} != at k {k} "
                             f"{runs[k]}")
    stats["threefry_cuda_vs_cpu"] = threefry_cuda_vs_cpu(dev)
    stats["graphs_total"] = len(engine.graph_captures)
    # the greedy dispatch traced in every run: 22a's int8 split is held
    # against it
    if dev.type == "cuda":
        stats["profile"] = profile_fused(
            engine, dev, [p[:256] for p in prompts],
            modes=("greedy", "sampled") if profile else ("greedy",))
    log(f"[fused] {json.dumps(stats)}")
    stats["outputs"] = outs          # phase 18's yardstick
    return stats


def fused_path_q(engine, dev, path_q, k=8):
    """Phase 17 on Path Q's engine (int8 per-head pools, grow_pool, the
    prefix cache): its requests through generate_fused, a first run that
    captures the graphs and the timed rerun; every output full, every
    paged launch of a replay decode_split; the tokens reported against
    the per-tick run's."""
    from deepspeed_tpu_torch.inference.v2 import paged
    warm = len(engine.graph_captures)
    serve_fused(engine, path_q["prompts"], path_q["new_tokens"], dev, k)
    captures = engine.graph_captures[warm:]
    ticks = count_ticks(engine)
    paged.paged_attention_kernel.variant_launches = {}
    engine.reset_serving_metrics()
    first = len(engine.graph_captures)
    try:
        outs, run = serve_fused(engine, path_q["prompts"], path_q[
            "new_tokens"], dev, k)
    finally:
        uncount_ticks(engine)
    by_variant = dict(paged.paged_attention_kernel.variant_launches)
    m = engine.serving_metrics()
    layers = engine.model.config.num_layers
    # the graph ticks, and each capture's eager warm-up tick
    decode_ticks = sum(ticks) + len(engine.graph_captures) - first
    if dev.type == "cuda" and (by_variant.get("decode_split") != layers
                               * decode_ticks or set(by_variant)
                               - set(NEW_PAGED_VARIANTS)):
        raise AssertionError(f"Path Q fused: paged launches {by_variant}, "
                             f"{layers} x {decode_ticks} decode ticks")
    for o in outs:
        if len(o) != path_q["new_tokens"]:
            raise AssertionError(f"Path Q fused output {o[:8]}...")
    horizon = agreement(outs, path_q["outputs"])
    stats = dict(
        requests=len(outs), launches_by_variant=by_variant,
        graph_ticks=sum(ticks), graphs_captured=len(captures),
        capture_ms_total=sum(g["capture_ms"] for g in captures),
        graph_pool_mib_total=sum(g["pool_mib"] for g in captures),
        prefix_hits=m["prefix_hits"],
        dispatches_per_token=m["dispatches_per_token"],
        fused_occupancy=m["fused_occupancy"],
        decode_ms_per_step=1e3 * (run["wall_s"] - run["prefill_s"])
        / max(run["steps"], 1),
        per_tick_decode_ms_per_tick=path_q["decode_ms_per_tick"],
        greedy_agreement_vs_per_tick=horizon,
        greedy_agreement_mean=sum(horizon) / len(horizon))
    log(f"[fused] Path Q {json.dumps(stats)}")
    return stats


def fused_fp32_parity(dev, size="3-8b", layers=4, n_req=4, max_new=16,
                      lengths=(100, 701), sample_new=16):
    """Phase 17, fp32: Llama-3-8B at full width cut to ``layers`` layers,
    fp32 (TF32 off): generate_fused must give generate()'s tokens, token
    for token. Then phase 18's checks on the same engine
    (:func:`fp32_modes_parity`) and phase 19's (:func:`front_fp32_parity`).
    Returns the three phases' records."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import build_engine
    cfg = {"dtype": "float32", "kv_block_size": 64, "num_kv_blocks": 512,
           "max_chunk_size": 256, "max_ragged_sequence_count": 8}
    engine = build_engine("llama", size=size, engine_config=cfg, device=dev,
                          num_layers=layers)
    c = engine.model.config
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, c.vocab_size, n).tolist()
               for n in rng.integers(lengths[0], lengths[1], n_req)]
    ref = engine.generate(prompts, max_new_tokens=max_new)
    got, run = serve_fused(engine, prompts, max_new, dev)
    rec = dict(layers=layers, requests=n_req, new_tokens=max_new,
               equal=got == ref, agreement=agreement(got, ref),
               decode_steps=run["steps"])
    log(f"[fused] fp32 {json.dumps(rec)}")
    if not rec["equal"]:
        raise AssertionError(f"fp32 generate_fused != generate: {rec}")
    modes = fp32_modes_parity(engine, dev, prompts, ref, got, max_new,
                              sample_new)
    front = front_fp32_parity(engine, dev, prompts, got, max_new)
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec, modes, front


# ----------------------------------------------------------- phase 18
# speculative decoding (prompt lookup, the JAX config's defaults) and the
# serving modes phase 18 drives on phase 4's engine
SPEC_CONFIG = {"enabled": True, "draft_len": 3, "min_ngram": 2,
               "history_window": 64}
FUSED_MODES = {"chain": {},
               "spec_chain": {"speculative": SPEC_CONFIG},
               "ring": {"fused_admission": True},
               "spec_ring": {"fused_admission": True,
                             "speculative": SPEC_CONFIG}}
# a greedy token may differ between two correct paths only where the
# reference's top-2 logit margin is below this (tests/test_torch_sampling)
NEAR_TIE = 1e-4


@contextlib.contextmanager
def fused_mode(engine, mode: str):
    """``engine`` serves in ``mode`` (``FUSED_MODES``) inside the block:
    its config's ``fused_admission`` and ``speculative`` switched, the
    rest kept, so one engine (its weights and pools) serves every mode; a
    FusedServeLoop built inside takes the mode."""
    import dataclasses
    from deepspeed_tpu_torch.inference.v2.engine_v2 import SpeculativeConfig
    cfg = engine._config
    over = FUSED_MODES[mode]
    engine._config = dataclasses.replace(
        cfg, fused_admission=over.get("fused_admission", False),
        speculative=SpeculativeConfig(**over.get("speculative", {})))
    try:
        yield
    finally:
        engine._config = cfg


def first_differences(engine, prompts, got, ref) -> list:
    """For each request whose tokens ``got`` part from ``ref``: the first
    differing index and the top-2 margin of the per-tick path's fp32
    logits there (teacher-forced on ``ref``'s tokens before it)."""
    diffs = []
    for i, (g, r) in enumerate(zip(got, ref)):
        j = next((j for j, (a, b) in enumerate(zip(g, r)) if a != b), None)
        if j is None:
            continue
        uid = 40_000 + i
        logits = engine.put([uid], [prompts[i] + r[:j]])[0].float()
        engine.flush(uid)
        top = logits.topk(2).values
        diffs.append(dict(request=i, index=j, got=g[j], ref=r[j],
                          top2_margin=float(top[0] - top[1])))
    return diffs


def fp32_modes_parity(engine, dev, prompts, ref, chain, max_new=16,
                      sample_new=16):
    """Phase 18, fp32 (TF32 off; Llama-3-8B at full width cut to 4 layers,
    phase 17's engine): spec chain, ring and spec ring greedy tokens held
    equal to generate()'s (``ref``) and to chain mode's (``chain``) under
    the near-tie rule (where a token differs, the per-tick path's top-2
    margin there must be below ``NEAR_TIE``); sampled tokens
    (``FUSED_SAMPLING``, ``FUSED_SEED``) held equal between spec chain and
    plain chain at K 2 and K 8."""
    out = {}
    bad = []
    for mode in ("spec_chain", "ring", "spec_ring"):
        engine.reset_serving_metrics()
        with fused_mode(engine, mode):
            got, run = serve_fused(engine, prompts, max_new, dev)
        m = engine.serving_metrics()
        rec = dict(equal_generate=got == ref, equal_chain=got == chain,
                   vs_generate=first_differences(engine, prompts, got, ref),
                   vs_chain=first_differences(engine, prompts, got, chain),
                   agreement=agreement(got, ref), decode_steps=run["steps"],
                   fused_dispatches=run["dispatches"],
                   spec_acceptance_rate=m["spec_acceptance_rate"],
                   tokens_per_dispatch=m["tokens_per_dispatch"])
        far = [d for d in rec["vs_generate"] + rec["vs_chain"]
               if d["top2_margin"] >= NEAR_TIE]
        if far:
            bad.append(f"{mode}: tokens differ past a near-tie: {far}")
        out[mode] = rec
    few = [p[:200] for p in prompts]
    sampled = {}
    for kk in (2, 8):
        plain, _ = serve_fused(engine, few, sample_new, dev, kk,
                               seed=FUSED_SEED, **FUSED_SAMPLING)
        with fused_mode(engine, "spec_chain"):
            spec, _ = serve_fused(engine, few, sample_new, dev, kk,
                                  seed=FUSED_SEED, **FUSED_SAMPLING)
        sampled[f"k{kk}"] = dict(equal=spec == plain,
                                 agreement=agreement(spec, plain))
        if spec != plain:
            bad.append(f"sampled spec chain != chain at k {kk}: "
                       f"{agreement(spec, plain)}")
    out["sampled"] = dict(FUSED_SAMPLING, seed=FUSED_SEED, requests=len(few),
                          new_tokens=sample_new, **sampled)
    log(f"[spec] fp32 {json.dumps(out)}")
    if bad:
        raise AssertionError("phase 18, fp32: " + "; ".join(bad))
    return out


def spec_graph_vs_eager(engine, prompts, dev, k=8):
    """One captured speculative dispatch of ``k`` ticks and the same ticks
    run eagerly (``engine._spec_eager``, the same kernels) from the same
    operands and pools, greedy: tokens, pointers, steps, spec counters,
    carry, history and pools equal bit for bit. Random weights never
    repeat an n-gram, so each row's drafter window gets its trailing
    2-gram planted earlier, followed by three tokens: every row drafts,
    and budgets of 1, 2, 3 and 32 clamp the drafts, so the verify chunk's
    true_len runs 1..4 across the rows of one call (the drafts are
    rejected: the targets are the model's own)."""
    import torch
    uids = list(range(21_000, 21_000 + len(prompts)))
    at_dispatch_state(engine, prompts, uids)
    budgets = dict(zip(uids, [1, 2, 3, 32] * (len(uids) // 4 + 1)))
    with fused_mode(engine, "spec_chain"):
        state = engine._spec_operands(uids, k, budgets, FUSED_SEED)
        h = state.hist
        h[:, -8:-6] = h[:, -2:]                 # the tail, planted earlier
        h[:, -6:-3] = h[:, :3].abs()            # its drafted continuation
        width = k * (1 + state.draft_len)
        before = {n: t.clone() for n, t in state.tensors().items()}
        pools0 = {n: t.clone() for n, t in engine.pools.items()}
        result = engine._spec_fn(state, k, 0.0, 0, 0.0, None)()
        toks_g, steps_g = result.read()
        ptr_g, stats_g = result.spec()
        graph = {n: t.clone() for n, t in state.tensors().items()}
        pools_g = {n: t.clone() for n, t in engine.pools.items()}
        for src, dst in ((pools0, engine.pools), (before, state.tensors())):
            for n, t in dst.items():
                t.copy_(src[n])
        del pools0, before
        engine._spec_eager(state, k, eos_id=None, temperature=0.0, top_k=0,
                           top_p=0.0, min_ngram=SPEC_CONFIG["min_ngram"])
    sync(dev)
    bad = [n for n, t in state.tensors().items()
           if not torch.equal(t[:, :width] if n == "out" else t,
                              graph[n][:, :width] if n == "out"
                              else graph[n])]
    bad += [f"pool {n}" for n, t in engine.pools.items()
            if not torch.equal(t, pools_g[n])]
    del pools_g
    engine.flush(uids)
    rec = dict(rows=len(uids), ticks=k, steps=[steps_g, int(state.steps)],
               tokens_equal=bool((toks_g == state.out[:, :width].cpu()
                                  .numpy()).all()),
               out_ptr=ptr_g.tolist(), spec_stats=stats_g.tolist(),
               differing=bad)
    if bad or not rec["tokens_equal"] or stats_g[0] == 0:
        raise AssertionError(f"spec graph replay against eager: {rec}")
    return rec


def ring_graph_vs_eager(engine, prompts, dev, spec: bool, k=8):
    """One captured ring-mode dispatch (``spec``: speculative) and the
    same ticks run eagerly, from the same operands and pools, sampling
    on: four rows live (budgets 2, 5, 9 and 32) with a request staged on
    each, so rows take their staged requests on the device. The ring and
    its epochs (the trash column aside), pointers, every carry and stage
    operand and the pools equal bit for bit."""
    import torch
    from deepspeed_tpu_torch.inference.v2.serve_loop import (FusedServeLoop,
                                                             ServeRequest)
    uids = list(range(22_000, 22_000 + 2 * 4))
    at_dispatch_state(engine, prompts[:8], uids)
    budgets = dict(zip(uids, [2, 5, 9, 32] + [16] * 4))
    for u, n in budgets.items():
        engine.state_manager.reserve(u, n)
    mode = "spec_ring" if spec else "ring"
    with fused_mode(engine, mode):
        loop = FusedServeLoop(engine, k_steps=k)
        loop.staged = {u: ServeRequest(uid=u, prompt=[], max_new_tokens=n)
                       for u, n in budgets.items() if u in uids[4:]}
        live = uids[:4]
        state = loop._serve_operands(live, {u: budgets[u] for u in live},
                                     dict(enumerate(uids[4:])))
        before = {n: t.clone() for n, t in state.tensors().items()}
        pools0 = {n: t.clone() for n, t in engine.pools.items()}
        loop.fn(state, k, *FUSED_SAMPLING.values(), None)()
        graph = {n: t.clone() for n, t in state.tensors().items()}
        pools_g = {n: t.clone() for n, t in engine.pools.items()}
        for src, dst in ((pools0, engine.pools), (before, state.tensors())):
            for n, t in dst.items():
                t.copy_(src[n])
        del pools0, before
        kw = dict(eos_id=None, **FUSED_SAMPLING)
        if spec:
            kw["min_ngram"] = SPEC_CONFIG["min_ngram"]
        engine._serve_eager(state, k, **kw)
    sync(dev)
    bad = []
    for n, t in state.tensors().items():
        g = graph[n]
        if n in ("ring", "ring_epochs"):
            t, g = t[:, :-1], g[:, :-1]
        if not torch.equal(t, g):
            bad.append(n)
    bad += [f"pool {n}" for n, t in engine.pools.items()
            if not torch.equal(t, pools_g[n])]
    del pools_g
    rd = state.read()
    engine.flush(uids)
    rec = dict(mode=mode, rows=4, staged=4, ticks=k,
               steps=int(rd["chain_steps"]), epochs=rd["epoch"].tolist(),
               ring_ptr=np.asarray(rd["ring_ptr"]).tolist(), differing=bad)
    if bad or rd["epoch"][0] != 1:
        raise AssertionError(f"ring graph replay against eager: {rec}")
    return rec


def spec_on_repeats(engine, dev, k=8, n_req=8, prompt_len=256,
                    max_new=64):
    """Reported, not held: random weights never repeat an n-gram of a
    random prompt, so phase 18's requests give the drafter nothing. Here
    each prompt is one token repeated, the input on which an untrained
    model is likeliest to repeat itself: chain and spec chain mode on the
    same requests (a capturing run, then the timed one each), with the
    acceptance, the tokens a row commits a live tick, decode ms a step and
    the ms a committed token."""
    c = engine.model.config
    rng = np.random.default_rng(18)
    prompts = [[int(t)] * prompt_len
               for t in rng.integers(0, c.vocab_size, n_req)]
    rec, outs = {}, {}
    for mode in ("chain", "spec_chain"):
        with fused_mode(engine, mode):
            serve_fused(engine, prompts, max_new, dev, k)
            engine.reset_serving_metrics()
            outs[mode], run = serve_fused(engine, prompts, max_new, dev, k)
        m = engine.serving_metrics()
        decode_s = run["wall_s"] - run["prefill_s"]
        rec[mode] = dict(
            decode_steps=run["steps"],
            decode_ms_per_step=1e3 * decode_s / max(run["steps"], 1),
            tokens_per_live_slot=m["fused_slot_tokens"]
            / max(m["fused_live_slots"], 1),
            ms_per_committed_token=1e3 * decode_s / max(run["steps"], 1)
            * m["fused_live_slots"] / max(m["fused_slot_tokens"], 1),
            tokens_per_dispatch=m["tokens_per_dispatch"],
            spec_proposed_tokens=m["spec_proposed_tokens"],
            spec_accepted_tokens=m["spec_accepted_tokens"],
            spec_acceptance_rate=m["spec_acceptance_rate"],
            first_output=outs[mode][0][:16])
    rec.update(requests=n_req, prompt_tokens=prompt_len, new_tokens=max_new,
               agreement=agreement(outs["spec_chain"], outs["chain"]))
    log(f"[spec] repeats {json.dumps(rec)}")
    return rec


def profile_spec(engine, dev, prompts, k=8) -> dict:
    """Where a speculative dispatch's time goes: ``k`` verify ticks of
    ``len(prompts)`` rows, one graph replay, traced as
    :func:`profile_fused` traces a plain one, greedy then sampled
    (``FUSED_SAMPLING``); each window with its GEMM share of the busy
    time, and the sampled window's extra busy time over the greedy one
    (the [B, 1 + draft_len] sampling grid's cost) as its sampling share."""
    uids = list(range(31_000, 31_000 + len(prompts)))
    at_dispatch_state(engine, prompts, uids)
    out = {}
    with fused_mode(engine, "spec_chain"):
        for name, sampling in (("greedy", (0.0, 0, 0.0)),
                               ("sampled", tuple(FUSED_SAMPLING.values()))):
            state = engine._spec_operands(uids, k, {u: k for u in uids},
                                          FUSED_SEED)
            fn = engine._spec_fn(state, k, *sampling, None)
            result = {}

            def run():
                res = fn()
                result["read"] = res.read()
                result["spec"] = res.spec()
            _, rec = profile_window(f"spec_decode_{name}", run, k)
            rec["gemm_share"] = (rec["ms_by_kind"].get("gemm", 0.0)
                                 / rec["device_busy_ms"])
            stats = result["spec"][1]
            rec["spec_stats"] = stats.tolist()
            out[name] = rec
    out["sampling_share"] = 1 - (out["greedy"]["device_busy_ms"]
                                 / out["sampled"]["device_busy_ms"])
    engine.flush(uids)
    log(f"[profile] spec {json.dumps({'sampling_share': out['sampling_share'], 'gemm_share': [out[n]['gemm_share'] for n in ('greedy', 'sampled')]})}")
    return out


def fused_modes_main(engine, dev, prompts, fused, max_new=32, k=8,
                     profile=False, repeats=None):
    """Phase 18: phase 4's engine serves phase 4's requests through
    generate_fused's loop in spec chain, ring and spec ring mode
    (``FUSED_MODES``): for each, a first run that captures the graphs,
    then the timed run with the counts set to 0 just before it. Checks:
    every output full and the rerun's tokens equal the first run's; every
    paged launch of a graph replay decode_split (the verify forward's
    S_new 4 included) and every prefill's prefill_wgmma, every norm
    cta_row, the counts equal what the replays and prefill dispatches
    ran, and each captured graph's own launches only decode_split and
    cta_row; ring mode reads the device once a chain. Reported: decode ms
    a fused step (the decode wall over the fused steps) beside phase 17's
    chain mode, tokens a row commits a live tick and the ms a committed
    token (the step over them), tokens a dispatch, the spec acceptance
    rate, host reads a chain, each
    graph's capture ms and pool MiB and launches a replay, and the greedy
    agreement with phase 17's tokens. Then each new graph's replay against
    its eager run, bit for bit; ``repeats`` sizes
    :func:`spec_on_repeats`."""
    from deepspeed_tpu_torch.inference.v2 import paged
    c = engine.model.config
    layers = c.num_layers
    norms = norm_counter(c)
    out = {"chain": dict(
        decode_ms_per_step=fused["decode_ms_per_step"],
        tokens_per_dispatch=fused["tokens_per_dispatch"],
        fused_dispatches=fused["fused_dispatches"], note="phase 17")}
    bad = []
    for mode in ("spec_chain", "ring", "spec_ring"):
        with fused_mode(engine, mode):
            first = len(engine.graph_captures)
            warm, _ = serve_fused(engine, prompts, max_new, dev, k)
            ticks = count_ticks(engine)
            paged.paged_attention_kernel.launches = 0
            paged.paged_attention_kernel.variant_launches = {}
            reset_norms(norms)
            engine.reset_serving_metrics()
            timed_first = len(engine.graph_captures)
            try:
                outs, run = serve_fused(engine, prompts, max_new, dev, k)
            finally:
                uncount_ticks(engine)
        captures = engine.graph_captures[first:]
        launches = paged.paged_attention_kernel.launches
        by_variant = dict(paged.paged_attention_kernel.variant_launches)
        norm_by_variant = dict(norms.variant_launches)
        m = engine.serving_metrics()
        prefill_dispatches = m["host_dispatches"] - m["fused_dispatches"]
        graph_ticks = sum(ticks) + len(engine.graph_captures) - timed_first
        if outs != warm:
            bad.append(f"{mode}: the rerun's tokens differ from the first "
                       "run's")
        for o in outs:
            if len(o) != max_new or not all(0 <= t < c.vocab_size
                                            for t in o):
                bad.append(f"{mode}: bad output {o[:8]}...")
        want = {"decode_split": layers * graph_ticks,
                "prefill_wgmma": layers * prefill_dispatches}
        if dev.type == "cuda":
            if by_variant != want or launches != sum(want.values()):
                bad.append(f"{mode}: paged launches {launches} by variant "
                           f"{by_variant} != {want}")
            want_norms = (2 * layers + 1) * (graph_ticks
                                             + prefill_dispatches)
            if norms.launches != want_norms \
                    or set(norm_by_variant) != {"cta_row"}:
                bad.append(f"{mode}: norm launches {norms.launches} by "
                           f"variant {norm_by_variant} != {want_norms} "
                           "cta_row")
            for g in captures:
                lv = g["launches_by_variant"]
                if set(lv.get("paged_attention_kernel", {})) \
                        != {"decode_split"} or set(lv.get(
                            "rms_norm_kernel", {})) != {"cta_row"}:
                    bad.append(f"{mode}: a graph's launches {lv}")
        if mode.endswith("ring") and run["host_reads"] != run["chains"]:
            bad.append(f"{mode}: {run['host_reads']} host reads over "
                       f"{run['chains']} chains")
        decode_s = run["wall_s"] - run["prefill_s"]
        horizon = agreement(outs, fused["outputs"])
        out[mode] = dict(
            decode_steps=run["steps"], fused_dispatches=run["dispatches"],
            fused_tokens=run["fused_tokens"],
            decode_ms_per_step=1e3 * decode_s / max(run["steps"], 1),
            tokens_per_live_slot=m["fused_slot_tokens"]
            / max(m["fused_live_slots"], 1),
            ms_per_committed_token=1e3 * decode_s / max(run["steps"], 1)
            * m["fused_live_slots"] / max(m["fused_slot_tokens"], 1),
            tokens_per_dispatch=m["tokens_per_dispatch"],
            tokens_per_fused_dispatch=run["fused_tokens"]
            / max(run["dispatches"], 1),
            spec_acceptance_rate=m["spec_acceptance_rate"],
            spec_proposed_tokens=m["spec_proposed_tokens"],
            spec_accepted_tokens=m["spec_accepted_tokens"],
            host_reads=run["host_reads"], chains=run["chains"],
            host_reads_per_chain=run["host_reads"] / max(run["chains"], 1),
            prefill_tokens_per_s=run["prefill_tokens"] / run["prefill_s"],
            launches=launches, launches_by_variant=by_variant,
            graph_ticks=graph_ticks, prefill_dispatches=prefill_dispatches,
            norm_launches=norms.launches,
            norm_launches_by_variant=norm_by_variant,
            graphs_captured=len(captures),
            captures=[{key: g[key] for key in (
                "mode", "bb", "kb", "k", "capture_ms", "pool_mib",
                "launches_per_replay", "launches_by_variant")}
                for g in captures],
            capture_ms_per_graph=sum(g["capture_ms"] for g in captures)
            / max(len(captures), 1),
            pool_mib_per_graph=sum(g["pool_mib"] for g in captures)
            / max(len(captures), 1),
            greedy_agreement_vs_chain=horizon,
            greedy_agreement_mean=sum(horizon) / len(horizon))
        log(f"[spec] {mode} {json.dumps(out[mode])}")
    if bad:
        raise AssertionError("phase 18: " + "; ".join(bad))
    out["repeats"] = spec_on_repeats(engine, dev, k, **(repeats or {}))
    short = [p[:256] for p in prompts]
    out["graph_vs_eager"] = {
        "spec_chain": spec_graph_vs_eager(engine, short, dev, k),
        "ring": ring_graph_vs_eager(engine, short, dev, False, k),
        "spec_ring": ring_graph_vs_eager(engine, short, dev, True, k)}
    if profile:
        out["profile"] = profile_spec(engine, dev, short, k)
    log(f"[spec] {json.dumps(out['graph_vs_eager'])}")
    return out


def spec_path_q(engine, dev, path_q, k=8):
    """Phase 18 on Path Q's engine (int8 per-head pools, grow_pool, the
    prefix cache): its requests in spec chain mode (a rejected draft
    slot's stale code and scale are written again before any query reads
    them), every paged launch of a replay decode_split; the greedy
    agreement with its per-tick run reported."""
    from deepspeed_tpu_torch.inference.v2 import paged
    with fused_mode(engine, "spec_chain"):
        serve_fused(engine, path_q["prompts"], path_q["new_tokens"], dev, k)
        ticks = count_ticks(engine)
        paged.paged_attention_kernel.variant_launches = {}
        engine.reset_serving_metrics()
        first = len(engine.graph_captures)
        try:
            outs, run = serve_fused(engine, path_q["prompts"],
                                    path_q["new_tokens"], dev, k)
        finally:
            uncount_ticks(engine)
    by_variant = dict(paged.paged_attention_kernel.variant_launches)
    layers = engine.model.config.num_layers
    decode_ticks = sum(ticks) + len(engine.graph_captures) - first
    if dev.type == "cuda" and (by_variant.get("decode_split") != layers
                               * decode_ticks or set(by_variant)
                               - set(NEW_PAGED_VARIANTS)):
        raise AssertionError(f"Path Q spec: paged launches {by_variant}, "
                             f"{layers} x {decode_ticks} decode ticks")
    m = engine.serving_metrics()
    horizon = agreement(outs, path_q["outputs"])
    stats = dict(
        requests=len(outs), launches_by_variant=by_variant,
        spec_acceptance_rate=m["spec_acceptance_rate"],
        tokens_per_dispatch=m["tokens_per_dispatch"],
        decode_ms_per_step=1e3 * (run["wall_s"] - run["prefill_s"])
        / max(run["steps"], 1),
        greedy_agreement_vs_per_tick=horizon,
        greedy_agreement_mean=sum(horizon) / len(horizon))
    log(f"[spec] Path Q {json.dumps(stats)}")
    return stats


# ----------------------------------------------------------- phase 19
# the serving front end: KV migration between engines, the async server,
# the prefix-affinity router with a disaggregated prefill engine
def twin_engine(engine, **over):
    """An engine of ``engine``'s config (``over`` replaced) over its model:
    the weights are shared, the pools (the same size) and graphs are its
    own."""
    import dataclasses
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    return InferenceEngineV2(engine.model,
                             dataclasses.replace(engine._config, **over),
                             params=engine.params)


def release_engine(engine, dev) -> None:
    """Drop an engine's graphs and pools now (a dispatch function refers
    back to its state, a cycle only the collector breaks)."""
    for states in (engine._fused_states, engine._ring_states):
        for state in states.values():
            state.release()
        states.clear()
    engine.pools.clear()
    gc.collect()
    if dev.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def reset_counts(c):
    """Set the serving kernels' launch counts to 0; returns the norm
    counter."""
    from deepspeed_tpu_torch.inference.v2 import paged
    paged.paged_attention_kernel.launches = 0
    paged.paged_attention_kernel.variant_launches = {}
    norms = norm_counter(c)
    reset_norms(norms)
    return norms


def read_counts(norms) -> dict:
    from deepspeed_tpu_torch.inference.v2 import paged
    return dict(launches=paged.paged_attention_kernel.launches,
                launches_by_variant=dict(
                    paged.paged_attention_kernel.variant_launches),
                norm_launches=norms.launches,
                norm_launches_by_variant=dict(norms.variant_launches))


def serve_imported(engine, state, max_new: int) -> list:
    """A migrated sequence continued alone through generate_fused's loop
    (FusedServeLoop, strict): its tokens, the carried first one included."""
    from deepspeed_tpu_torch.inference.v2.serve_loop import FusedServeLoop
    loop = FusedServeLoop(engine, strict=True)
    loop.submit_imported(state, max_new, emit_carried=True)
    out = []
    while loop.has_work():
        for evt in loop.step():
            out.extend(evt.tokens)
    return out


def migration_check(a, dev, prompt, label, max_new=32, rounds=3):
    """Phase 19a on ``a``'s pools: ``prompt`` prefilled on ``a``
    (prefill_request) and exported at its dispatch boundary, imported into
    a twin engine ``b`` (:func:`twin_engine`) and continued there; then
    ``rounds`` - 1 more migrations of the prompt with every token shifted
    by the round (no prefix-cache hit), each payload dropped after its
    import, so that pinned host memory is reused as in a running server:
    the last one is timed (the first pays for the pinned allocation).
    Held: b's gathered blocks equal the payload bit for bit, every pool
    slab of b keeps its address, bytes a token equal kv_bytes_per_token,
    both engines' free blocks come back, and ``max_new`` greedy tokens
    continued on b through generate_fused's loop equal the never-moved
    run's, token for token (one request alone: the same shapes, so the
    same kernels and GEMMs). The never-moved run is a's generate_fused, or
    b's before the import where the prefix cache is on (a's own run would
    publish the prompt's blocks, and the migration's prefill would reuse
    them). Reported: export and import ms on the host clock (synchronized)
    against the prefill's, the payload, and the continuation's launches by
    variant (the counts set to 0 just before it)."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import paged
    b = twin_engine(a)
    free0 = (a.free_blocks, b.free_blocks)
    ref_engine = b if a.state_manager.cache is not None else a
    ref = ref_engine.generate_fused([prompt], max_new_tokens=max_new)[0]
    bad, times = [], []
    vocab = a.model.config.vocab_size

    def migrate(r):
        uid = 190_000 + r
        sync(dev)
        t = time.perf_counter()
        t0 = a.prefill_request(uid, [(x + r) % vocab for x in prompt])
        sync(dev)
        t1 = time.perf_counter()
        st = a.export_request(uid, n_generated=1, source=label)
        t2 = time.perf_counter()
        ptrs = {k: v.data_ptr() for k, v in b.pools.items()}
        sync(dev)
        t3 = time.perf_counter()
        tok = b.import_request(uid, st)
        sync(dev)
        t4 = time.perf_counter()
        times.append((t1 - t, t2 - t1, t4 - t3))
        idx = torch.tensor(b.state_manager.seqs[uid].blocks[
            :st.payload_blocks], device=dev)
        for k, v in b.pools.items():
            got = paged.indexable(v).index_select(1, idx).cpu()
            if not torch.equal(got, paged.indexable(st.payload[k])):
                bad.append(f"{label}: slab {k} on b != the payload")
        if {k: v.data_ptr() for k, v in b.pools.items()} != ptrs:
            bad.append(f"{label}: the import moved a pool slab")
        if tok != t0 or r == 0 and t0 != ref[0]:
            bad.append(f"{label}: first tokens {tok}, {t0}, {ref[0]}")
        b.flush(uid)
        return st

    st = migrate(0)
    norms = reset_counts(a.model.config)
    out = serve_imported(b, st, max_new)
    counts = read_counts(norms)
    payload = dict(
        kv_dtype=st.kv_dtype, payload_blocks=st.payload_blocks,
        payload_bytes=st.payload_bytes, bytes_per_token=st.bytes_per_token(),
        pinned=all(t.is_pinned() for t in st.payload.values())
        if dev.type == "cuda" else None)
    del st
    for r in range(1, rounds):
        migrate(r)
    if out != ref:
        bad.append(f"{label}: continuation after the migration "
                   f"{agreement([out], [ref])} tokens agree, not {max_new}")
    if payload["bytes_per_token"] != a.kv_bytes_per_token():
        bad.append(f"{label}: {payload['bytes_per_token']} B a token on the "
                   f"wire != kv_bytes_per_token {a.kv_bytes_per_token()}")
    if (a.free_blocks, b.free_blocks) != free0:
        bad.append(f"{label}: free blocks {a.free_blocks}, {b.free_blocks} "
                   f"!= {free0} after the flushes")
    if dev.type == "cuda" and (
            set(counts["launches_by_variant"]) - set(NEW_PAGED_VARIANTS)
            or not counts["launches"]):
        bad.append(f"{label}: continuation's paged launches {counts}")
    prefill_s, export_s, import_s = times[-1]
    nbytes = payload["payload_bytes"]
    rec = dict(
        prompt_tokens=len(prompt), **payload,
        kv_bytes_per_token=a.kv_bytes_per_token(),
        prefill_ms=1e3 * prefill_s, export_ms=1e3 * export_s,
        import_ms=1e3 * import_s,
        export_gb_per_s=nbytes / export_s / 1e9,
        import_gb_per_s=nbytes / import_s / 1e9,
        rounds_ms=[{"prefill": 1e3 * p, "export": 1e3 * e,
                    "import": 1e3 * i} for p, e, i in times],
        continuation_tokens=len(out), continuation_equal=out == ref,
        never_moved_on="b" if ref_engine is b else "a",
        continuation_launches_by_variant=counts["launches_by_variant"],
        continuation_norm_launches_by_variant=counts[
            "norm_launches_by_variant"])
    release_engine(b, dev)
    log(f"[front] migration {label} {json.dumps(rec)}")
    if bad:
        raise AssertionError("phase 19a: " + "; ".join(bad))
    return rec


def latency(runs) -> dict:
    """TTFT and ITL of streamed requests, each (submit time, token
    times): p50 and p99 over the requests of the time to the first token
    and of the mean gap between tokens (as the handles yield them), ms,
    and tokens/s over the run's wall."""
    ttft = [1e3 * (times[0] - sub) for sub, times in runs]
    itl = [1e3 * (times[-1] - times[0]) / (len(times) - 1)
           for _, times in runs if len(times) > 1]
    wall = max(t[-1] for _, t in runs) - min(s for s, _ in runs)
    pct = lambda v, q: float(np.percentile(v, q))  # noqa: E731
    return dict(ttft_ms_p50=pct(ttft, 50), ttft_ms_p99=pct(ttft, 99),
                itl_ms_p50=pct(itl, 50), itl_ms_p99=pct(itl, 99),
                tokens=sum(len(t) for _, t in runs), wall_s=wall,
                tokens_per_s=sum(len(t) for _, t in runs) / wall)


async def stream_requests(front, prompts, max_new: int, arrivals=None):
    """Submit ``prompts`` to a server or router (all at once, or each at
    its ``arrivals`` offset in seconds) and stream them. Returns the
    tokens and, per request, (submit time, token times)."""
    import asyncio
    t_start = time.perf_counter()

    async def one(i, prompt):
        if arrivals is not None:
            await asyncio.sleep(max(0.0, t_start + arrivals[i]
                                    - time.perf_counter()))
        sub = time.perf_counter()
        handle = await front.submit(prompt, max_new_tokens=max_new)
        toks, times = [], []
        async for tok in handle:
            toks.append(tok)
            times.append(time.perf_counter())
        return toks, (sub, times)

    done = await asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)])
    return [d[0] for d in done], [d[1] for d in done]


def timed_calls(engine, name: str, sink: list) -> None:
    """Wrap ``engine.<name>`` so that each call's host ms lands in
    ``sink`` (an instance attribute; ``del engine.<name>`` takes it
    off)."""
    orig = getattr(engine, name)

    def timed(*args, **kw):
        t = time.perf_counter()
        out = orig(*args, **kw)
        sink.append(1e3 * (time.perf_counter() - t))
        return out

    setattr(engine, name, timed)


def capture_buckets(engine, k: int, bbs, kbs) -> dict:
    """Capture the chain-mode greedy decode graph of every (batch bucket,
    table-width bucket) in ``bbs`` x ``kbs`` that ``engine`` lacks, ahead
    of open-loop traffic, which meets buckets a closed loop does not (the
    graphs then replay from the server's worker). Returns how many were
    captured and their ms."""
    first = len(engine.graph_captures)
    sampling = engine._sampling_args(None, None, None, None)
    for bb in bbs:
        for kb in kbs:
            engine._fused_fn(engine._fused_state(bb, kb, k), k, *sampling)
    new = engine.graph_captures[first:]
    return dict(graphs=len(new),
                capture_ms=sum(g["capture_ms"] for g in new))


def path_q_prompts(vocab: int, n_req=8, prefix_len=512, suffix=(100, 401)):
    """Path Q's requests: a shared ``prefix_len``-token system prompt and
    each request's own suffix (seeded)."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, vocab, prefix_len).tolist()
    lens = rng.integers(suffix[0], suffix[1], n_req)
    return prefix, lens, [prefix + rng.integers(0, vocab, n).tolist()
                          for n in lens]


def serving_front_main(engine, dev, prompts, fused_outputs, max_new=32, k=8,
                       arrivals=16, arrival_lens=(100, 701), gap_s=0.05,
                       q_prompts=None, router_max_new=None):
    """Phase 19 b and c on phase 4's engine (chain mode, K 8, chain depth
    2). b: AsyncInferenceServer over it serves phase 4's requests, all
    submitted at once, then ``arrivals`` requests (prompts of
    ``arrival_lens`` tokens, seeded) at seeded exponential gaps of mean
    ``gap_s``, after the graphs of every bucket the traffic meets are
    captured (:func:`capture_buckets`); then one request cancelled after 3
    tokens. Held: every output full, every paged launch of the run
    decode_split or prefill_wgmma and every norm cta_row (the counts set
    to 0 just before and read just after), the cancelled request's blocks
    back, stop() clean. Reported: TTFT and ITL p50/p99
    (:func:`latency`), tokens/s, the greedy agreement with phase 17
    (``fused_outputs``), the launches, the graphs captured before and
    during the run. c: InferenceRouter over two decode replicas (this
    engine and a twin, its graphs captured first) with a PrefillEngine
    (another twin) and disaggregation on serves Path Q's 8 requests
    (``q_prompts``), ``router_max_new`` (default ``max_new``) tokens
    each, twice: the timed round, and a round in which the replica
    serving the first request to stream its second token is killed. Held: every request ends with all its tokens, at least one
    reroute, the migrated bytes equal the payloads' (blocks x block size
    x kv_bytes_per_token), every engine's blocks back. Reported: the
    router's counters, TTFT and ITL of the timed round, export ms and
    import ms a hand-off."""
    import asyncio
    from deepspeed_tpu_torch.serving import (AsyncInferenceServer,
                                             InferenceRouter, PrefillEngine,
                                             RequestCancelled, RouterConfig,
                                             ServingConfig)
    c = engine.model.config
    free0 = engine.free_blocks
    rng = np.random.default_rng(19)
    lens = rng.integers(arrival_lens[0], arrival_lens[1], arrivals)
    arriving = [rng.integers(0, c.vocab_size, n).tolist() for n in lens]
    offsets = np.cumsum(rng.exponential(gap_s, arrivals)).tolist()
    bad = []

    async def run_server():
        async with AsyncInferenceServer(engine,
                                        ServingConfig(k_steps=k)) as s:
            burst, burst_t = await stream_requests(s, prompts, max_new)
            spaced, spaced_t = await stream_requests(s, arriving, max_new,
                                                     offsets)
            h = await s.submit(prompts[1], max_new_tokens=4 * max_new)
            got, cancelled = [], False
            try:
                async for tok in h:
                    got.append(tok)
                    if len(got) == 3:
                        h.cancel()
            except RequestCancelled:
                cancelled = True
            for _ in range(1000):
                if engine.free_blocks == free0:
                    break
                await asyncio.sleep(0.01)
            freed = engine.free_blocks == free0
            m = s.metrics()
        return burst, burst_t, spaced, spaced_t, (cancelled, got, freed), m

    kbs = (4, 8, 16) if engine._config.kv_block_size == 64 else (16,)
    captured = capture_buckets(engine, k, (1, 2, 4, 8), kbs)
    graphs = len(engine.graph_captures)
    norms = reset_counts(c)
    t = time.perf_counter()
    burst, burst_t, spaced, spaced_t, cancel, m = asyncio.run(run_server())
    wall = time.perf_counter() - t
    counts = read_counts(norms)
    for o in burst + spaced:
        if len(o) != max_new or not all(0 <= x < c.vocab_size for x in o):
            bad.append(f"server output {o[:8]}... not {max_new} tokens")
    if not (cancel[0] and cancel[2] and len(cancel[1]) < 4 * max_new):
        bad.append(f"cancel: raised {cancel[0]}, {len(cancel[1])} tokens, "
                   f"blocks back {cancel[2]}")
    if engine.free_blocks != free0 or engine.state_manager.seqs:
        bad.append(f"after stop(): {engine.free_blocks} free blocks of "
                   f"{free0}, {len(engine.state_manager.seqs)} sequences")
    if dev.type == "cuda" and (
            set(counts["launches_by_variant"]) - set(NEW_PAGED_VARIANTS)
            or sum(counts["launches_by_variant"].values())
            != counts["launches"] or not counts["launches"]
            or set(counts["norm_launches_by_variant"]) != {"cta_row"}
            or counts["norm_launches"] == 0):
        bad.append(f"server launches {counts}")
    horizon = agreement(burst, fused_outputs)
    server = dict(
        requests=len(prompts), arriving=arrivals, new_tokens=max_new, k=k,
        burst=latency(burst_t), spaced=latency(spaced_t),
        arrival_gap_s_mean=gap_s, wall_s=wall, captured_before=captured,
        graphs_captured_in_run=len(engine.graph_captures) - graphs,
        greedy_agreement_vs_phase17=horizon,
        greedy_agreement_mean=sum(horizon) / len(horizon),
        cancelled_after=len(cancel[1]),
        loop_counters={key: m[key] for key in (
            "admitted", "preemptions", "cancellations", "chain_drains")},
        dispatches_per_token=m["dispatches_per_token"],
        fused_occupancy=m["fused_occupancy"], **counts)
    log(f"[front] server {json.dumps(server)}")
    if bad:
        raise AssertionError("phase 19b: " + "; ".join(bad))

    # c: the router, two decode replicas and a prefill engine
    replica1, prefill = twin_engine(engine), twin_engine(engine)
    engines = (engine, replica1, prefill)
    replica_captured = capture_buckets(replica1, k, (1, 2, 4, 8), kbs)
    frees = [e.free_blocks for e in engines]
    export_ms, import_ms = [], []
    timed_calls(prefill, "export_request", export_ms)
    for e in (engine, replica1):
        timed_calls(e, "import_request", import_ms)
    if q_prompts is None:
        q_prompts = path_q_prompts(c.vocab_size)[2]
    bs = engine._config.kv_block_size
    max_new = router_max_new or max_new

    async def run_router():
        reps = [AsyncInferenceServer(e, ServingConfig(k_steps=k))
                for e in (engine, replica1)]
        router = InferenceRouter(reps, RouterConfig(
            disaggregation={"enabled": True}), prefill=PrefillEngine(
                prefill))
        async with router:
            graphs = [len(e.graph_captures) for e in (engine, replica1)]
            first, first_t = await stream_requests(router, q_prompts,
                                                   max_new)
            graphs = [len(e.graph_captures) - n
                      for e, n in zip((engine, replica1), graphs)]
            hs = [await router.submit(p, max_new_tokens=max_new)
                  for p in q_prompts]
            outs = [[] for _ in hs]

            async def drain(i, h):
                async for tok in h:
                    outs[i].append(tok)

            tasks = [asyncio.ensure_future(drain(i, h))
                     for i, h in enumerate(hs)]
            killed = None
            while not all(t.done() for t in tasks):
                if killed is None:
                    hit = next((h.replica for i, h in enumerate(hs)
                                if h.replica and len(outs[i]) >= 2), None)
                    if hit is not None:
                        dict(router.replicas)[hit].kill()
                        killed = hit
                await asyncio.sleep(0.002)
            await asyncio.gather(*tasks)
            m = router.metrics()
        return (first, first_t, outs, killed, m, router.replica_errors,
                graphs)

    try:
        first, first_t, second, killed, rm, errors, graphs = asyncio.run(
            run_router())
    finally:
        for e in engines:
            for name in ("export_request", "import_request"):
                e.__dict__.pop(name, None)
    want_bytes = 2 * sum(-(-len(p) // bs) for p in q_prompts) * bs \
        * engine.kv_bytes_per_token()
    for o in first + second:
        if len(o) != max_new:
            bad.append(f"routed request ended with {len(o)} tokens")
    if killed is None or rm["reroutes"] < 1 or set(errors) != {killed}:
        bad.append(f"kill: killed {killed}, reroutes {rm['reroutes']}, "
                   f"replica errors {errors}")
    if rm["migrated_bytes"] != want_bytes or \
            rm["migrated_bytes"] != rm["prefill"]["exported_bytes"]:
        bad.append(f"migrated bytes {rm['migrated_bytes']} != "
                   f"{want_bytes} (exported {rm['prefill']})")
    if [e.free_blocks for e in engines] != frees:
        bad.append(f"free blocks {[e.free_blocks for e in engines]} != "
                   f"{frees} after the router stopped")
    router = dict(
        requests=len(q_prompts), rounds=2, new_tokens=max_new,
        killed=killed, replica_captured_before=replica_captured,
        graphs_captured_in_timed_round=graphs,
        prompt_tokens=[len(p) for p in q_prompts],
        latency=latency(first_t),
        counters={key: rm[key] for key in rm
                  if key not in ("replicas", "prefill")},
        replicas=rm["replicas"], prefill=rm["prefill"],
        replica_errors=errors,
        export_ms_per_handoff=float(np.mean(export_ms)),
        import_call_ms_per_handoff=float(np.mean(import_ms)),
        handoffs=len(export_ms), imports=len(import_ms),
        migrated_bytes_per_token=rm["migrated_bytes"] / sum(
            2 * -(-len(p) // bs) * bs for p in q_prompts))
    log(f"[front] router {json.dumps(router)}")
    del replica1, prefill, engines
    gc.collect()
    if dev.type == "cuda":
        import torch
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError("phase 19c: " + "; ".join(bad))
    return dict(server=server, router=router)


def front_fp32_parity(engine, dev, prompts, fused, max_new=16, k=8):
    """Phase 19d on phase 17's fp32 4-layer engine (TF32 off), under the
    near-tie rule: the async server's streams equal generate_fused's
    (``fused``), and the router's disaggregated streams (a PrefillEngine
    on a twin engine, the hand-off imported into this one) equal the
    co-located server's."""
    import asyncio
    from deepspeed_tpu_torch.serving import (AsyncInferenceServer,
                                             InferenceRouter, PrefillEngine,
                                             RouterConfig, ServingConfig)

    async def served():
        async with AsyncInferenceServer(engine,
                                        ServingConfig(k_steps=k)) as s:
            return (await stream_requests(s, prompts, max_new))[0]

    prefill = twin_engine(engine)

    async def routed():
        router = InferenceRouter(
            [AsyncInferenceServer(engine, ServingConfig(k_steps=k))],
            RouterConfig(disaggregation={"enabled": True}),
            prefill=PrefillEngine(prefill))
        async with router:
            outs = (await stream_requests(router, prompts, max_new))[0]
            return outs, router.metrics()["prefill_handoffs"]

    t = time.perf_counter()
    server = asyncio.run(served())
    router, handoffs = asyncio.run(routed())
    release_engine(prefill, dev)
    rec = dict(requests=len(prompts), new_tokens=max_new,
               server_equal_fused=server == fused,
               router_equal_server=router == server,
               server_vs_fused=first_differences(engine, prompts, server,
                                                 fused),
               router_vs_server=first_differences(engine, prompts, router,
                                                  server),
               prefill_handoffs=handoffs, seconds=time.perf_counter() - t)
    log(f"[front] fp32 {json.dumps(rec)}")
    far = [d for d in rec["server_vs_fused"] + rec["router_vs_server"]
           if d["top2_margin"] >= NEAR_TIE]
    if far or handoffs != len(prompts):
        raise AssertionError(f"phase 19d, fp32: tokens differ past a "
                             f"near-tie {far}, hand-offs {handoffs}")
    return rec


# ----------------------------------------------------------- phase 20
# model breadth: the dense families the JAX engine factory serves beyond
# GPT-2 and Llama. (b) full width and depth where a family's preset has a
# head dim past the powers of two; (c) the others at published widths,
# depth cut to BREADTH_LAYERS; (d) every one in fp32 at
# BREADTH_FP32_LAYERS, kernel path against plain
BREADTH_FULL = (("phi", "2"), ("phi3", "mini"), ("gptj", "6b"))
BREADTH_CUT = (("mistral", "7b"), ("falcon", "7b"), ("bloom", "7b1"),
               ("opt", "13b"), ("gptneox", "20b"), ("internlm", "7b"),
               ("qwen", "7b"), ("qwen2", "7b"))
BREADTH_LAYERS = 4
BREADTH_FP32_LAYERS = 2
# a prompt past Mistral-7B's 4096-token window, so the window cuts
MISTRAL_LONG_PROMPT = 4500
# phase 20a's kernel rows (run in phase 3): the head layouts of the
# presets with the new head dims, model -> (Hq, Hkv, D)
NEW_DIM_SHAPES = {"phi-2": (32, 32, 80), "phi3-mini": (32, 32, 96),
                  "gptj-6b": (16, 16, 256)}
# (e): the v1 engine's traffic, 8 prompts of 256 tokens, 32 greedy tokens
V1_PROMPTS = dict(n=8, length=256, max_new=32)


def breadth_kernel_checks(dev, flush=None, iters=20):
    """Phase 20a, run in phase 3: the paged-attention kernel at D 80, 96
    and 256 (NEW_DIM_SHAPES, bs 64) on the serving path's decode (B 8,
    contexts 100-2000), prefill (2 x 256) and tick (8 x 256) calls, in
    fp32, bf16 and fp16 over fp, int8 and fp8 (per-head) pools: each
    against its plain version (TOL, ATTN_TOL), rerun bit for bit, the
    variant the plan names (bf16/fp16 always decode_split or
    prefill_wgmma); the bf16 and fp16 fp-pool calls and the bf16 int8-pool
    calls (row 1b) timed as phase 3's rows (variant, ms, bound, share of
    the bound, SDPA on gathered pages, dequantized first for int8)."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import paged
    decode, prefill = serving_shapes()
    shapes = {"decode": decode, "prefill": prefill,
              "prefill_tick": PREFILL_TICK}
    errs, record = {}, {}
    for model, (hq, hkv, d) in NEW_DIM_SHAPES.items():
        for dtype_name, tol in ATTN_TOL.items():
            dtype = getattr(torch, dtype_name)
            for pool in ("fp", "int8", "fp8"):
                for name, shape in shapes.items():
                    x, kw = attention_case(dev, dtype, **shape, hq=hq,
                                           hkv=hkv, d=d)
                    if pool != "fp":
                        x, kw = quantize_pools(x, kw, pool, "head")
                    got = paged.paged_attention_kernel(*x.values(), **kw)
                    again = paged.paged_attention_kernel(*x.values(), **kw)
                    variant = paged.paged_attention_kernel.variant
                    plan = paged.launch_plan(x["q"].shape, dtype, hkv,
                                             x["block_tables"].shape, 64)
                    ref = paged.paged_attention_plain(*x.values(), **kw)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    err = (got.float() - ref.float()).abs()
                    key = (model, dtype_name, pool, name)
                    errs[key] = float(err.max())
                    if bool((err > tol + tol * ref.float().abs()).any()):
                        raise AssertionError(
                            f"paged_attention at {key} (D {d}) disagrees "
                            f"with its plain version: max|err| "
                            f"{errs[key]:.3e} > tol {tol:g}")
                    if dev.type == "cuda" and (
                            not torch.equal(got, again)
                            or variant != plan["variant"]
                            or dtype_name != "float32"
                            and variant not in NEW_PAGED_VARIANTS):
                        raise AssertionError(
                            f"paged_attention at {key}: variant {variant} "
                            f"(plan {plan['variant']}), bit-identical "
                            f"rerun {torch.equal(got, again)}")
                    timed = (pool == "fp" and dtype_name != "float32"
                             or pool == "int8" and dtype_name == "bfloat16")
                    if timed:
                        rkey = f"{model}_{name}" + (
                            "_fp16" if dtype_name == "float16" else
                            "_int8" if pool == "int8" else "")
                        record[rkey] = time_attention(x, kw, dev, iters,
                                                      flush)
                        check_rerun(record[rkey], rkey)
                        log(f"[kernel] D {d} {rkey} times (ms): "
                            f"{json.dumps(record[rkey])}")
            worst = max(v for k, v in errs.items()
                        if k[:2] == (model, dtype_name))
            log(f"[kernel] D {d} ({model}, Hq {hq}, Hkv {hkv}) "
                f"{dtype_name:9s} fp/int8/fp8 x decode/prefill/tick "
                f"max|err| {worst:.3e} (tol {tol:g})")
    return errs, record


def breadth_ticks(model, dev, attention, lens=(200, 250), seed=2,
                  check_first=True):
    """paged_forward over a prefill tick (row 0's ``lens[0]`` prompt
    tokens), a mixed tick (row 0 decodes one token while row 1 prefills
    ``lens[1]``) and a decode tick (both rows), teacher-forced on drawn
    tokens, on fresh zeroed pools; ``attention`` goes to paged_forward
    (the first tick's only with ``check_first``: a long prefill's plain
    version would hold [rows, keys] scores of gigabytes). Returns each
    tick's logits in fp32."""
    import torch
    from deepspeed_tpu_torch.inference.v2.paged import paged_forward
    c = model.config
    dtype = next(iter(model.params.values())).dtype
    bs = 64
    nb = 2 * -(-(max(lens) + 2) // bs)
    shape = (c.num_layers, nb, bs, c.num_kv_heads, c.head_dim)
    pools = {k: torch.zeros(shape, dtype=dtype, device=dev)
             for k in ("k", "v")}
    tables = torch.arange(nb, dtype=torch.int32, device=dev).reshape(2, -1)
    rng = np.random.default_rng(seed)
    # each tick as wide as its longest row: a pad slot's position must
    # stay inside the rotary table too
    first = np.zeros((2, lens[0]), np.int64)
    first[0] = rng.integers(0, c.vocab_size, lens[0])
    mixed = np.zeros((2, lens[1]), np.int64)
    mixed[0, 0] = rng.integers(0, c.vocab_size)
    mixed[1] = rng.integers(0, c.vocab_size, lens[1])
    ticks = [(first, [0, 0], [lens[0], 0]),
             (mixed, [lens[0], 0], [1, lens[1]]),
             (rng.integers(0, c.vocab_size, (2, 1)),
              [lens[0] + 1, lens[1]], [1, 1])]
    out = []
    for i, (tokens, pos0, true_len) in enumerate(ticks):
        logits, _ = paged_forward(
            model, pools, torch.tensor(tokens, device=dev),
            torch.tensor(pos0, dtype=torch.int32, device=dev), tables,
            torch.tensor(true_len, dtype=torch.int32, device=dev),
            attention=attention if i or check_first else None)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits on a phase 20 tick")
        out.append(logits.float())
    return out


def breadth_serving(dev, family, size, layers=None, long_prompt=None,
                    v1_prompts=None, serve_kw=None, lens=(200, 250)):
    """Phase 20b/c: one family through build_engine at its published
    width (depth cut to ``layers`` where given), bf16, random seeded
    weights, phase 4's traffic and launch checks (every layer of every
    tick launches the kernel, every launch decode_split or prefill_wgmma,
    every norm launch a row kernel); then every layer's attention of a
    prefill, a mixed and a decode tick against its plain version at the
    bf16 kernel tolerance. ``v1_prompts``: those prompts served too, 32
    greedy tokens, for phase 20e's agreement. Returns the stats and the
    engine."""
    over = {"num_layers": layers} if layers else {}
    engine, stats = main_path(dev, size=size, family=family,
                              model_over=over, long_prompt=long_prompt,
                              **(serve_kw or {}))
    stats.pop("prompts")
    stats.pop("outputs")
    checked, worst = layer_checker(TOL["bfloat16"])
    c = engine.model.config
    breadth_ticks(engine.model, dev, checked, lens=lens)
    ticks = 3
    if c.sliding_window and long_prompt:
        # row 0 decodes, then decodes beside row 1's chunk, at position
        # long_prompt - 100, past the window: keys older than it drop out
        breadth_ticks(engine.model, dev, checked, check_first=False,
                      lens=(long_prompt - 100, lens[1]))
        ticks += 2
    check_variants(worst["variants"], worst["layer_calls"], dev,
                   f"{family} layer calls")
    if worst["layer_calls"] != ticks * c.num_layers:
        raise AssertionError(f"{family}: {worst['layer_calls']} checked "
                             f"layer calls")
    stats.update(head_dim=c.head_dim, heads=f"{c.num_heads}/"
                 f"{c.num_kv_heads}", layers=c.num_layers,
                 layer_calls=worst["layer_calls"],
                 layer_max_abs_err=worst["max_abs_err"],
                 layer_calls_by_variant=worst["variants"])
    log(f"[breadth] {family}-{size}: D {c.head_dim}, heads {stats['heads']}"
        f", {c.num_layers} layers; every layer of a prefill, a mixed and a "
        f"decode tick vs plain: max|err| {worst['max_abs_err']:.3e} (tol "
        f"{TOL['bfloat16']}), by variant {json.dumps(worst['variants'])}")
    if v1_prompts is not None:
        stats["v1_prompts_outputs"] = engine.generate(
            v1_prompts, max_new_tokens=V1_PROMPTS["max_new"])
    return stats, engine


def breadth_fp32(dev, family, size, layers=BREADTH_FP32_LAYERS, nb=16,
                 lens=(200, 250)):
    """Phase 20d: the family at its published width cut to ``layers``, fp32
    with TF32 off, random seeded weights: the kernel path's teacher-forced
    logits (phase 5's ticks) against the plain path's, max |d| / max
    |logits|."""
    import torch
    from deepspeed_tpu_torch.models import get_model_class
    model = get_model_class(family)(size=size, num_layers=layers,
                                    device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model.init_params(gen)
    with torch.no_grad():
        kernel = teacher_forced_logits(model, dev, True, 64, nb, lens)
        ref = teacher_forced_logits(model, dev, False, 64, nb, lens)
    rel = rel_err(kernel, ref)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rel > TOL["float32"]:
        raise AssertionError(f"phase 20d {family}-{size} fp32 kernel vs "
                             f"plain logits: {rel:.3e} > {TOL['float32']}")
    return rel


def v1_prompts_of(vocab: int, length: int = V1_PROMPTS["length"]):
    """Phase 20e's prompts: V1_PROMPTS["n"] of ``length`` seeded tokens."""
    rng = np.random.default_rng(7)
    return rng.integers(0, vocab, (V1_PROMPTS["n"], length)).tolist()


def v1_warm(eng, prompts, max_new: int) -> None:
    """One untimed generate() that captures the graph a call of
    ``prompts`` and ``max_new`` new tokens then replays: 2 new tokens
    where their cache bucket is that call's (the same batch, sampling and
    bucket: one graph), else ``max_new``; the timed call after it holds
    no capture (:func:`v1_graph_record` ``warmed``)."""
    n = len(prompts[0])
    same = eng.cache_bucket(n + 2) == eng.cache_bucket(n + max_new)
    eng.generate(prompts, max_new_tokens=2 if same else max_new)


def v1_graph_record(eng, dev, what: str, warmed: bool = False) -> dict:
    """The v1 engine's last generate() on the card: its decode steps were
    replays of one captured graph (fails otherwise); device ms a step
    between events around the replays, the graph's capture ms (the
    warm-up step included), pool MiB, whether this call captured it, and
    its launches a replay by wrapper and by variant (norms: cta_row or
    warp_row only), and ``forwards_launched``: the prefill, the replayed
    steps and, where this call captured the graph, its warm-up step (run
    eagerly over an idle copy of the state: its launches count); with
    ``warmed``, fails if this call captured. None of it on the CPU, where
    the steps run eagerly."""
    last = eng.last_decode
    if dev.type != "cuda":
        return dict(decode_ms_per_step=None, steps=last["steps"],
                    forwards_launched=last["steps"] + 1)
    g = last["graph"]
    if g is None or last["events"] is None:
        raise AssertionError(f"{what}: generate's steps were not graph "
                             f"replays: {last}")
    if warmed and last["captured"]:
        raise AssertionError(f"{what}: the timed call captured its graph "
                             f"after v1_warm")
    norms = {w: v for w, v in g["launches_by_variant"].items()
             if "norm" in w}
    if any(set(v) - set(NEW_NORM_VARIANTS) for v in norms.values()):
        raise AssertionError(f"{what}: a replay's norms {norms}")
    return dict(decode_ms_per_step=eng.decode_ms_per_step(),
                steps=last["steps"], captured_now=last["captured"],
                forwards_launched=last["steps"] + 1 + int(last["captured"]),
                capture_ms=g["capture_ms"], graph_pool_mib=g["pool_mib"],
                launches_per_replay=g["launches_per_replay"],
                launches_by_variant_per_replay=g["launches_by_variant"])


def breadth_v1(dev, v2_outputs, params, prompts, size="6b"):
    """Phase 20e: init_inference(GPTJ(size="6b"), bf16, max_out_tokens
    1024) on phase 20b's GPT-J weights (``params``, the v2 engine's):
    32 greedy tokens from 8 prompts of 256 (a prefill, then the decode
    step's graph replayed, captured by an untimed :func:`v1_warm` first;
    norms on the kernel); tokens/s and the greedy agreement with the v2
    engine's ``v2_outputs`` (reported).
    Then GPT-J-6B cut to 4 layers in fp32: the v1 and v2 engines on one
    set of weights must give the same greedy tokens under the near-tie
    rule (a differing token's top-2 margin below NEAR_TIE)."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.inference.v2 import build_engine
    from deepspeed_tpu_torch.models import GPTJ
    eng = ds.init_inference(GPTJ(size=size, device=dev), config={
        "dtype": "bf16", "max_out_tokens": 1024}, params=params)
    c = eng.module.config
    prompt_len = len(prompts[0])
    v1_warm(eng, prompts, V1_PROMPTS["max_new"])
    norms = norm_counter(c)
    reset_norms(norms)
    sync(dev)
    t = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=V1_PROMPTS["max_new"])
    sync(dev)
    wall = time.perf_counter() - t
    new = out[:, prompt_len:].tolist()
    graph = v1_graph_record(eng, dev, "20e v1 generate", warmed=True)
    norm_by_variant = check_norm_variants(norms, dev, "v1 generate")
    forwards = V1_PROMPTS["max_new"]
    if dev.type == "cuda" and norms.launches != norms_per_forward(c) \
            * graph["forwards_launched"]:
        raise AssertionError(f"v1: {norms.launches} norm launches, want "
                             f"{norms_per_forward(c)} x {graph}")
    agree = agreement(new, v2_outputs)
    rec = dict(model=f"gptj-{size}", dtype="bfloat16",
               requests=len(prompts), prompt_tokens=prompt_len,
               new_tokens=V1_PROMPTS["max_new"], generate_s=wall,
               generated_tokens_per_s=len(prompts) * forwards / wall,
               norm_launches=norms.launches,
               norm_launches_by_variant=norm_by_variant,
               greedy_agreement_vs_v2=agree, **graph)
    del eng, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # fp32 at 4 layers: v1 against v2 on one set of weights
    cfg = {"dtype": "float32", "kv_block_size": 64, "num_kv_blocks": 64,
           "max_chunk_size": 256, "max_ragged_sequence_count": 8}
    v2 = build_engine("gptj", size=size, engine_config=cfg, device=dev,
                      num_layers=BREADTH_LAYERS)
    v1 = ds.init_inference(GPTJ(size=size, num_layers=BREADTH_LAYERS,
                                device=dev),
                           config={"dtype": "fp32", "max_out_tokens": 1024},
                           params=dict(v2.model.params))
    ref = v2.generate(prompts, max_new_tokens=16)
    got = v1.generate(prompts, max_new_tokens=16)[:, prompt_len:]
    diffs = first_differences(v2, prompts, got.tolist(), ref)
    bad = [d for d in diffs if d["top2_margin"] >= NEAR_TIE]
    rec["fp32_4_layers"] = dict(requests=len(prompts), new_tokens=16,
                                differences=diffs)
    release_engine(v2, dev)
    del v1, v2
    gc.collect()
    if bad:
        raise AssertionError(f"phase 20e fp32: v1 and v2 tokens differ "
                             f"past a near-tie: {bad}")
    log(f"[breadth] v1 init_inference: {json.dumps(rec)}")
    return rec


def breadth_fused(dev, family, size, layers=BREADTH_LAYERS, n_req=4,
                  max_new=16, lengths=(100, 701), k=8):
    """Phase 20f: the family at its published width cut to ``layers``,
    fp32 (TF32 off), random seeded weights, through generate_fused at K
    ``k`` (phase 17's loop: a run that captures the graphs, then a rerun
    with the counts set to 0 just before it): both runs must give the
    engine's per-tick generate() tokens, token for token; the paged
    launches, counted from the graph replays as in phase 17, must be
    layers x (graph ticks + prefill dispatches), every replayed tick's
    decode_split and the rest the fp32 prefill's cuda_cores."""
    from deepspeed_tpu_torch.inference.v2 import build_engine, paged
    cfg = {"dtype": "float32", "kv_block_size": 64, "num_kv_blocks": 512,
           "max_chunk_size": 256, "max_ragged_sequence_count": 8}
    engine = build_engine(family, size=size, engine_config=cfg, device=dev,
                          num_layers=layers)
    c = engine.model.config
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, c.vocab_size, n).tolist()
               for n in rng.integers(lengths[0], lengths[1], n_req)]
    ref = engine.generate(prompts, max_new_tokens=max_new)
    warm, _ = serve_fused(engine, prompts, max_new, dev, k)
    ticks = count_ticks(engine)
    paged.paged_attention_kernel.launches = 0
    paged.paged_attention_kernel.variant_launches = {}
    engine.reset_serving_metrics()
    timed_first = len(engine.graph_captures)
    try:
        got, run = serve_fused(engine, prompts, max_new, dev, k)
    finally:
        uncount_ticks(engine)
    launches = paged.paged_attention_kernel.launches
    by_variant = dict(paged.paged_attention_kernel.variant_launches)
    m = engine.serving_metrics()
    prefill_dispatches = m["host_dispatches"] - m["fused_dispatches"]
    graph_ticks = sum(ticks) + len(engine.graph_captures) - timed_first
    rec = dict(model=f"{family}-{size}", head_dim=c.head_dim, layers=layers,
               requests=n_req, new_tokens=max_new, k=k,
               equal_to_generate=got == ref and warm == ref,
               agreement=agreement(got, ref), decode_steps=run["steps"],
               graph_ticks=graph_ticks, prefill_dispatches=prefill_dispatches,
               launches=launches, launches_by_variant=by_variant,
               graphs_captured=len(engine.graph_captures))
    release_engine(engine, dev)
    del engine
    log(f"[breadth] fused fp32 {json.dumps(rec)}")
    bad = []
    if not rec["equal_to_generate"]:
        bad.append("generate_fused != generate")
    if dev.type == "cuda" and (
            launches != layers * (graph_ticks + prefill_dispatches)
            or by_variant.get("decode_split", 0) < layers * graph_ticks
            or set(by_variant) - {"decode_split", "cuda_cores"}):
        bad.append(f"paged launches {launches} by variant {by_variant} "
                   f"(graph ticks {graph_ticks}, prefill dispatches "
                   f"{prefill_dispatches}, {layers} layers)")
    if bad:
        raise AssertionError(f"phase 20f {family}-{size}: " + "; ".join(bad)
                             + f" {rec}")
    return rec


def model_breadth_main(dev, full=BREADTH_FULL, cut=BREADTH_CUT,
                       layers=BREADTH_LAYERS, long_prompt=MISTRAL_LONG_PROMPT,
                       fp32_layers=BREADTH_FP32_LAYERS, serve_kw=None,
                       lens=(200, 250), v1_len=V1_PROMPTS["length"],
                       fused_kw=None):
    """Phase 20 (b-f; a runs in phase 3): the dense families at full width
    and depth (``full``), at published widths cut to ``layers`` (``cut``;
    Mistral with a ``long_prompt`` past its window), each in fp32 at
    ``fp32_layers`` kernel against plain, the v1 engine on GPT-J's
    weights (``full``'s gptj entry), and ``full`` at ``layers`` in fp32
    through generate_fused (``fused_kw`` to :func:`breadth_fused`).
    ``serve_kw`` goes to main_path, ``lens`` are the teacher-forced rows,
    ``v1_len`` the v1 prompts' length (a CPU rehearsal at tiny size
    shrinks them). Returns the phase's record."""
    import torch
    t0 = time.perf_counter()
    rec = {"serving": {}, "fp32_rel_logits_err": {}}
    for family, size in full + cut:
        is_cut = (family, size) in cut
        gptj = family == "gptj" and not is_cut
        prompts = (v1_prompts_of(engine_vocab(family, size), v1_len)
                   if gptj else None)
        stats, engine = breadth_serving(
            dev, family, size, layers=layers if is_cut else None,
            long_prompt=long_prompt if family == "mistral" else None,
            v1_prompts=prompts, serve_kw=serve_kw, lens=lens)
        rec["serving"][f"{family}-{size}"] = stats
        if gptj:
            v2_out = stats.pop("v1_prompts_outputs")
            params = {k: v.detach() for k, v in engine.model.params.items()}
        release_engine(engine, dev)
        del engine
        if gptj:
            rec["v1"] = breadth_v1(dev, v2_out, params, prompts, size=size)
            del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for family, size in full + cut:
        rec["fp32_rel_logits_err"][f"{family}-{size}"] = breadth_fp32(
            dev, family, size, layers=fp32_layers, lens=lens)
    log(f"[breadth] fp32 kernel vs plain logits at {fp32_layers} layers: "
        f"{json.dumps(rec['fp32_rel_logits_err'])} (tol {TOL['float32']})")
    rec["fused_fp32"] = {f"{family}-{size}": breadth_fused(
        dev, family, size, layers=layers, **(fused_kw or {}))
        for family, size in full}
    rec["seconds"] = time.perf_counter() - t0
    log(f"[breadth] phase 20: {rec['seconds']:.1f} s")
    return rec


def engine_vocab(family, size) -> int:
    """The vocabulary of a family's preset."""
    from deepspeed_tpu_torch import models
    return getattr(models, f"{family}_config")(size).vocab_size


# ----------------------------------------------------------- phase 21
# the dense families trained at full width: (family, size, layers), depth
# cut only as far as the card's 80 GB force (the engine keeps ~18 B a
# parameter: fp32 master, grads, Adam m and v, the bf16 copy): phi "2"
# whole (2.78 B params), phi3 "mini" 24 of 32 layers, gptj "6b" 12 of 28
TRAIN_FAMILIES = (("phi", "2", None), ("phi3", "mini", 24),
                  ("gptj", "6b", 12))
TRAIN_FAMILY_ROWS, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS = 4, 2048, 5
# the fp32 checks, the card against the CPU (TF32 off), 3 steps each:
# (a) each family at its width cut to 2 layers, on 2 x 64 tokens at lr
# 1e-5 (at phase 6's 1e-4 these models memorise the 128 tokens in 3
# steps, the loss 11.5 -> 0.002, and the comparison measures the
# collapse); the params bound leaves out the lm_head, where Adam turns
# gradients within rounding of zero into +-lr steps of either sign
# (PERF.md §6); (b) each family's tiny preset widened to its head
# dim (WIDE_FAMILIES, vocab 512), tests/test_torch_cuda.py's engine test
# whole, every tensor under the params bound
TRAIN_FAMILY_FP32 = dict(layers=2, rows=2, seq=64, steps=3, lr=1e-5)
SIGN_FLIP_TENSORS = ("lm_head",)
WIDE_FAMILIES = {"phi": dict(hidden_size=160, num_heads=2),
                 "phi3": dict(hidden_size=192, num_heads=2),
                 "gptj": dict(hidden_size=512, num_heads=2)}
TRAIN_FAMILY_WIDE_FP32 = dict(layers=2, rows=4, seq=96, steps=3, lr=1e-3)


def train_family(dev, family, size, layers=None, rows=TRAIN_FAMILY_ROWS,
                 seq=TRAIN_FAMILY_SEQ, steps=TRAIN_FAMILY_STEPS, probe=None):
    """Phase 21: initialize(<family> ``size`` at full width, depth cut to
    ``layers`` where given, random seeded weights, flash, segments) with
    TRAIN_CONFIG (bf16, fused Adam, ZeRO 2, clip 1.0) -> train_batch on a
    fixed ``rows`` x ``seq`` batch, one warm-up step then ``steps`` timed
    steps, the counts set to 0 just before them: tokens/s, step ms, MFU,
    peak memory, the losses (finite and falling), the flash launches a
    step by variant (every one wgmma: L forward, 2L backward a step) and
    the norm launches (every one a row kernel). ``probe(engine, batch)``
    adds its figures after the timed steps. The engine is released before
    the next family."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_class
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_optimizers import fused_adam_step
    over = {"num_layers": layers} if layers else {}
    model = get_model_class(family)(size=size, remat_policy="segments",
                                    attn_impl="flash", device=dev, **over)
    c = model.config
    t = time.perf_counter()
    engine, _, _, _ = ds.initialize(model=model, config=dict(
        TRAIN_CONFIG, train_batch_size=rows))
    init_s = time.perf_counter() - t
    batch = train_batch_of(dev, c.vocab_size, rows, seq)
    engine.train_batch(batch)                                  # warm-up
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    norms = norm_counter(c)
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_fwd.variant_launches = {}
    fa.flash_attention_bwd.variant_launches = {}
    fused_adam_step.launches = 0
    reset_norms(norms)
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(engine.train_batch(batch))
        sync(dev)
        step_s.append(time.perf_counter() - t)
    norm_by_variant = check_norm_variants(norms, dev, f"{family} training")
    losses = [float(x) for x in losses]
    tok_s = rows * seq * steps / sum(step_s)
    flash = {"fwd": dict(fa.flash_attention_fwd.variant_launches),
             "bwd": dict(fa.flash_attention_bwd.variant_launches)}
    stats = dict(
        model=f"{family}-{size}", params=c.num_params(),
        layers=c.num_layers, head_dim=c.head_dim,
        heads=f"{c.num_heads}/{c.num_kv_heads}", batch=rows, seq=seq,
        steps=steps, initialize_s=init_s,
        step_ms=1e3 * sum(step_s) / steps, step_ms_min=1e3 * min(step_s),
        step_ms_max=1e3 * max(step_s), tokens_per_s=tok_s,
        mfu=c.flops_per_token(seq, causal=True) * tok_s / BF16_FLOPS,
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None),
        losses=losses, fused_adam_launches=fused_adam_step.launches,
        flash_launches_per_step={
            k: {v: n / steps for v, n in by.items()}
            for k, by in flash.items()},
        flash_launches_by_variant=flash, norm_launches=norms.launches,
        norm_launches_by_variant=norm_by_variant)
    if probe is not None:
        stats.update(probe(engine, batch))
    del engine, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[families] {json.dumps(stats)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{family}-{size} training losses not finite "
                             f"and falling: {losses}")
    want = {"fwd": {"wgmma": c.num_layers * steps},
            "bwd": {"wgmma": 2 * c.num_layers * steps}}
    if dev.type == "cuda" and (flash != want
                               or stats["fused_adam_launches"] != steps
                               or stats["norm_launches"]
                               != norm_launches_per_micro(c) * steps):
        raise AssertionError(
            f"{family}-{size} training launches: flash {flash} != {want} "
            f"(one forward and one backward call per layer, two backward "
            f"launches per call, every one wgmma), Adam "
            f"{stats['fused_adam_launches']} (want {steps}), norms "
            f"{stats['norm_launches']} (want "
            f"{norm_launches_per_micro(c) * steps})")
    return stats


# phase 21's fp32 runs: flash attention and segment remat on the
# families, and their batch (:func:`lm_batch_of`)
FAMILY_FP32_MODEL = dict(remat_policy="segments", attn_impl="flash")


def lm_batch_of(dev, vocab, rows, seq):
    """Phase 21's fp32 batch: seeded tokens and their next tokens."""
    return train_batch_of(dev, vocab, rows, seq, seed=7)


def fp32_engine_run(dev, family, size, layers, rows, seq, steps, lr,
                    init=None, over=None, model_kw=FAMILY_FP32_MODEL,
                    batch_of=lm_batch_of, host=True):
    """One side of the fp32 check: initialize(<family> ``size`` cut to
    ``layers``, ``model_kw`` and ``over`` on its config) in fp32 on
    ``dev`` with TRAIN_CONFIG at ``lr``, ``steps`` train_batch calls on
    ``batch_of(dev, vocab, rows, seq)`` from ``init`` (the master's
    tensors; None: the model's seeded draw). Returns the initial tensors,
    the losses, the first step's grads and each tensor's change, on the
    CPU (``host=False``: the grads and changes on ``dev``)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_class
    cfg = dict(TRAIN_CONFIG, train_batch_size=rows, bf16={"enabled": False},
               optimizer={"type": "FusedAdam", "params": dict(
                   TRAIN_CONFIG["optimizer"]["params"], lr=lr)})
    model = get_model_class(family)(size=size, num_layers=layers,
                                    device=dev, **{**model_kw, **(over or {})})
    batch = batch_of(dev, model.config.vocab_size, rows, seq)
    engine, _, _, _ = ds.initialize(model=model, config=cfg,
                                    model_parameters=init)
    if init is None:
        init = {n: t.detach().cpu().clone() for n, t in
                engine.master_state_dict().items()}
    losses, grads = [], None
    for step in range(steps):
        losses.append(float(engine.train_batch(batch)))
        if step == 0:
            grads = (engine._grads.detach().cpu().clone() if host
                     else engine._grads.detach().clone())
    change = {n: (t.detach().cpu() - init[n]) if host
              else t.detach() - init[n].to(dev)
              for n, t in engine.master_state_dict().items()}
    del engine, model
    gc.collect()
    return dict(init=init, losses=losses, grads=grads, change=change)


def train_family_fp32(dev, family, size, layers=2, rows=2, seq=64,
                      steps=3, lr=1e-5, over=None, cpu=None,
                      loose=SIGN_FLIP_TENSORS, **run_kw):
    """Phase 21, fp32 (TF32 off): the family cut to ``layers`` (``over``
    on its config), the engine of :func:`train_family` in fp32 on the
    card (the kernels) against the same engine on the CPU (the plain
    versions; ``cpu``: that run made beforehand, :func:`fp32_engine_run`)
    from the same weights, ``steps`` steps at ``lr`` on one batch:
    test_training_engine_on_the_card_matches_the_cpu's bounds (each loss
    within 1e-4 relative, the params after the steps within 1e-3 of the
    norm of their total change: Adam amplifies sign flips of near-zero
    grads) and phase 7's for the first step's grads (1e-4 of their
    largest element). The params bound is over every tensor but
    ``loose``, whose error is reported beside it. ``run_kw`` goes to
    both runs (``model_kw``, ``batch_of``)."""
    import torch
    args = (family, size, layers, rows, seq, steps, lr)
    if cpu is None:
        cpu = fp32_engine_run(torch.device("cpu"), *args, over=over,
                              **run_kw)
    card = fp32_engine_run(dev, *args, init=cpu["init"], over=over,
                           **run_kw)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def rel(names):
        err = sum(float((card["change"][n] - cpu["change"][n]).pow(2).sum())
                  for n in names)
        moved = sum(float(cpu["change"][n].pow(2).sum()) for n in names)
        return (err / moved) ** 0.5

    names = list(cpu["change"])
    held = [n for n in names if n not in loose]
    rec = dict(model=f"{family}-{size}", layers=layers, over=over,
               rows=rows, seq=seq, lr=lr, loss_card=card["losses"],
               loss_cpu=cpu["losses"],
               loss_max_rel_err=max(abs(a - b) / abs(b) for a, b in
                                    zip(card["losses"], cpu["losses"])),
               grad_max_err_rel_to_max=float(
                   (card["grads"] - cpu["grads"]).abs().max()
                   / cpu["grads"].abs().max()),
               params_err_rel_to_change=rel(names),
               params_err_rel_to_change_held=rel(held),
               params_held_tensors=len(held),
               params_err_by_tensor={n: rel([n]) for n in names})
    log(f"[families] fp32 card vs cpu {json.dumps(rec)}")
    if (rec["loss_max_rel_err"] > 1e-4
            or rec["grad_max_err_rel_to_max"] > 1e-4
            or rec["params_err_rel_to_change_held"] > 1e-3):
        raise AssertionError(f"fp32 {family}-{size}, card vs cpu: {rec}")
    return rec


def fp32_cpu_sides(families=TRAIN_FAMILIES, fp32=TRAIN_FAMILY_FP32):
    """The CPU halves of phase 21's full-width fp32 checks, run on a worker
    thread while phase 2's nvcc processes build (the card is not touched):
    family -> a future of :func:`fp32_engine_run`'s record. The caller
    shuts the returned executor down."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=1)
    futures = {f"{f}-{s}": pool.submit(
        fp32_engine_run, torch.device("cpu"), f, s, fp32["layers"],
        fp32["rows"], fp32["seq"], fp32["steps"], fp32["lr"])
        for f, s, _ in families}
    return pool, futures


def train_families_main(dev, families=TRAIN_FAMILIES, fp32=TRAIN_FAMILY_FP32,
                        wide=TRAIN_FAMILY_WIDE_FP32, cpu_sides=None, **kw):
    """Phase 21: :func:`train_family` for each of ``families``, then
    :func:`train_family_fp32` for each at ``fp32``'s depth, batch and lr
    (``cpu_sides``: their CPU halves, made beforehand) and for each tiny
    preset widened to its head dim (WIDE_FAMILIES) at ``wide``'s. ``kw``
    goes to train_family (a CPU rehearsal shrinks the batch)."""
    t0 = time.perf_counter()
    rec = {"train": {}, "fp32_card_vs_cpu": {}, "fp32_wide_card_vs_cpu": {}}
    for family, size, layers in families:
        rec["train"][f"{family}-{size}"] = train_family(dev, family, size,
                                                        layers, **kw)
    for family, size, _ in families:
        name = f"{family}-{size}"
        rec["fp32_card_vs_cpu"][name] = train_family_fp32(
            dev, family, size, **fp32,
            cpu=(cpu_sides or {}).pop(name, None))
        rec["fp32_wide_card_vs_cpu"][family] = train_family_fp32(
            dev, family, "tiny", over=WIDE_FAMILIES[family], loose=(),
            **wide)
    rec["reduced"] = {f"{f}-{s}": f"depth {n}" for f, s, n in families if n}
    rec["seconds"] = time.perf_counter() - t0
    log(f"[families] phase 21: {rec['seconds']:.1f} s")
    return rec


# ----------------------------------------------------------- phase 22
# linear/: weight-only int8 serving through both engines, and LoRA over a
# frozen int8 base. (a) phase 4's engine config and traffic with
# quantize_weights at full width and depth, per tick then fused; (b) the
# same engine at 2 layers in fp32, the card against the CPU (v1 and v2);
# (c) the v1 engine on GPT-J-6B, phase 20e's traffic; (d) LoRAModel over
# Llama-3-8B (LoRAConfig and QuantizationConfig defaults: r 64, alpha 16,
# the seven projections, int8 blocks of 512) trained with phase 21's
# config and batch; (e) (d) at 2 layers in fp32, the card against the
# CPU; (f) (e)'s trained adapters fused into the base and served int8.
INT8_SERVING = {"quantize_weights": True}
# the Llama of 22b and 22d-f (a CPU rehearsal narrows it)
LINEAR_MODEL = dict(size="3-8b")
LORA_ROWS, LORA_SEQ, LORA_STEPS = TRAIN_FAMILY_ROWS, TRAIN_FAMILY_SEQ, 5
# the fp32 checks at 2 layers (Llama-3-8B's widths): serving 3 requests
# of 20-90 prompt tokens and 8 greedy tokens; LoRA phase 21's fp32 rows
# and lr on 32 tokens a row, 3 steps (the CPU halves run beside the build)
INT8_FP32 = dict(layers=2, n_req=3, max_new=8, lengths=(20, 90))
LORA_FP32 = dict(TRAIN_FAMILY_FP32, seq=32)
# the LoRA path's quantize shape: one layer of Llama-3-8B's w_up stack,
# [4096, 14336] bf16 (the transform quantizes the stacks, the forward
# dequantizes them a layer at a time)
LORA_QUANT_SHAPE = (4096, 14336)


def weight_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.values())


def quant_counts_reset() -> None:
    from deepspeed_tpu_torch.ops import quantization as TQ
    TQ.quantize_int8_kernel.launches = 0
    TQ.quantize_int8_kernel.exact_launches = 0
    TQ.quantize_int8_kernel.variant_launches = {}
    TQ.dequantize_int8_kernel.launches = 0


def quant_counts() -> dict:
    from deepspeed_tpu_torch.ops import quantization as TQ
    k = TQ.quantize_int8_kernel
    return dict(quantize=k.launches, quantize_exact=k.exact_launches,
                quantize_by_variant=dict(k.variant_launches),
                dequantize=TQ.dequantize_int8_kernel.launches)


def lora_quant_times(dev, flush=None, iters=20):
    """Rows 6-7 at the LoRA path's shape (LORA_QUANT_SHAPE, bf16): the
    quantize in the exact-division mode (LoRA's base) and in the wire's
    mode, each against its plain version bit for bit (codes, scales) and
    timed beside it and its bound; the dequantize to bf16 (each layer of
    each micro-step) against plain and ``torch.mul(q, s, out=bf16)``."""
    import torch
    from deepspeed_tpu_torch.ops import quantization as TQ
    g = torch.Generator(device=dev).manual_seed(6)
    n = int(np.prod(LORA_QUANT_SHAPE))
    x = (torch.randn(n, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    rows = x.view(1, -1)
    rec = {}
    for mode, exact in (("exact", True), ("wire", False)):
        q, s = TQ.quantize_rows(rows, exact=exact)
        pq, ps = TQ.quantize_rows(rows, use_kernel=False, exact=exact)
        equal = bool(torch.equal(q, pq) and torch.equal(s, ps))
        err = max(float((q.int() - pq.int()).abs().max()),
                  float((s - ps).abs().max()))
        del pq, ps
        bound, by = quant_bound(n, 2, 1)
        rec[f"quantize_{mode}"] = dict(
            bit_equal=equal, max_abs_err=err,
            variant=(TQ.quantize_int8_kernel.variant
                     if dev.type == "cuda" else None),
            ms=time_ms(lambda: TQ.quantize_rows(rows, exact=exact), dev,
                       iters, flush),
            plain_ms=time_ms(lambda: TQ.quantize_rows(
                rows, use_kernel=False, exact=exact), dev,
                max(iters // 4, 2), flush),
            library_ms=None, bound_ms=bound, bound_by=by)
        if not equal:
            raise AssertionError(f"quantize_int8 {mode} mode at "
                                 f"{LORA_QUANT_SHAPE} differs from plain")
    # the modes' scales differ in some blocks (one ulp): reported
    qe, se = TQ.quantize_rows(rows, exact=True)
    qw, sw = TQ.quantize_rows(rows, exact=False)
    rec["scales_differing_between_modes"] = int((se != sw).sum())
    rec["codes_differing_between_modes"] = int((qe != qw).sum())
    del qw, sw
    back = TQ.dequantize_rows(qe, se, 1, n, torch.bfloat16)
    pback = TQ.dequantize_rows(qe, se, 1, n, torch.bfloat16, False)
    lib_out = torch.empty(qe.shape, dtype=torch.bfloat16, device=dev)
    torch.mul(qe, se, out=lib_out)
    bound, by = quant_bound(n, 1, 2)
    rec["dequantize"] = dict(
        bit_equal=bool(torch.equal(back, pback)),
        library_bit_equal=bool(torch.equal(lib_out.view(-1)[:n],
                                           back.view(-1))),
        max_abs_err=float((back.float() - pback.float()).abs().max()),
        ms=time_ms(lambda: TQ.dequantize_rows(qe, se, 1, n, torch.bfloat16),
                   dev, iters, flush),
        plain_ms=time_ms(lambda: TQ.dequantize_rows(
            qe, se, 1, n, torch.bfloat16, False), dev, max(iters // 4, 2),
            flush),
        library_ms=time_ms(lambda: torch.mul(qe, se, out=lib_out), dev,
                           iters, flush),
        bound_ms=bound, bound_by=by)
    if not rec["dequantize"]["bit_equal"]:
        raise AssertionError("dequantize_int8 at the LoRA shape differs "
                             "from plain")
    rec["shape"] = f"{list(LORA_QUANT_SHAPE)} bf16 (a layer of w_up)"
    log(f"[kernel] int8 block quantize at the LoRA shape: {json.dumps(rec)}")
    return rec


def int8_fused(engine, dev, prompts, per_tick, max_new=32, k=8):
    """22a's fused half: generate_fused (chain, K ``k``, depth 2) over
    ``prompts``, a capturing run then the timed run with the counts set to
    0 just before it: every replayed paged launch decode_split and every
    prefill's prefill_wgmma, every norm cta_row, the counts what the
    replays and prefill dispatches ran (phase 17's check). Reported: ms a
    fused step, the graphs' pool MiB and capture ms, the greedy agreement
    with the per-tick tokens (``per_tick``)."""
    from deepspeed_tpu_torch.inference.v2 import paged
    c = engine.model.config
    first = len(engine.graph_captures)
    warm, warm_run = serve_fused(engine, prompts, max_new, dev, k)
    norms = norm_counter(c)
    ticks = count_ticks(engine)
    paged.paged_attention_kernel.launches = 0
    paged.paged_attention_kernel.variant_launches = {}
    reset_norms(norms)
    engine.reset_serving_metrics()
    timed_first = len(engine.graph_captures)
    try:
        outs, run = serve_fused(engine, prompts, max_new, dev, k)
    finally:
        uncount_ticks(engine)
    by_variant = dict(paged.paged_attention_kernel.variant_launches)
    m = engine.serving_metrics()
    prefill_dispatches = m["host_dispatches"] - m["fused_dispatches"]
    graph_ticks = sum(ticks) + len(engine.graph_captures) - timed_first
    want = {"decode_split": c.num_layers * graph_ticks,
            "prefill_wgmma": c.num_layers * prefill_dispatches}
    want_norms = (2 * c.num_layers + 1) * (graph_ticks + prefill_dispatches)
    bad = []
    if outs != warm:
        bad.append("the rerun's tokens differ from the first run's")
    if dev.type == "cuda" and by_variant != want:
        bad.append(f"paged launches by variant {by_variant} != {want}")
    if dev.type == "cuda" and (norms.launches != want_norms or set(
            norms.variant_launches) != {"cta_row"}):
        bad.append(f"norm launches {norms.launches} "
                   f"{dict(norms.variant_launches)} != {want_norms} cta_row")
    if bad:
        raise AssertionError("phase 22a fused: " + "; ".join(bad))
    captures = engine.graph_captures[first:]
    horizon = agreement(outs, per_tick)
    decode_s = run["wall_s"] - run["prefill_s"]
    return dict(
        k=k, decode_steps=run["steps"], fused_dispatches=run["dispatches"],
        decode_ms_per_step=1e3 * decode_s / max(run["steps"], 1),
        prefill_tokens_per_s=run["prefill_tokens"] / run["prefill_s"],
        generate_fused_s=run["wall_s"], first_run_s=warm_run["wall_s"],
        launches_by_variant=by_variant, norm_launches=norms.launches,
        graphs_captured=len(captures),
        capture_ms_total=sum(g["capture_ms"] for g in captures),
        graph_pool_mib_total=sum(g["pool_mib"] for g in captures),
        graph_pool_mib=[g["pool_mib"] for g in captures],
        greedy_agreement_vs_per_tick=horizon,
        greedy_equal_to_per_tick=outs == per_tick)


def int8_dequant_times(engine, dev, iters=5) -> dict:
    """22a's dequant alone, event-timed outside any graph: every layer's
    weight pairs as ``paged_forward`` reads them (``layer_params``, each
    layer's bf16 temporaries freed before the next) and ``lm_head_q``'s,
    one tick's worth, with the bytes each moves (an int8 code read and a
    bf16 value written an element, the scales) and the rate that gives."""
    m = engine.model
    n_layers = m.config.num_layers

    def layers():
        for i in range(n_layers):
            m.layer_params(i)

    def nbytes(names):
        return sum(m.params[n].numel() * (1 + 2) + m.params[n[:-2] + "_s"]
                   .numel() * m.params[n[:-2] + "_s"].element_size()
                   for n in names)

    parts = [("layers", layers, [n for n in m.params
                                 if n.startswith("layers/")
                                 and n.endswith("_q")])]
    if "lm_head_q" in m.params:
        parts.append(("lm_head", m._vocab_weight, ["lm_head_q"]))
    rec = {}
    for part, fn, names in parts:
        ms = time_ms(fn, dev, iters)
        b = nbytes(names)
        rec[part] = dict(ms=ms, bytes=b, gb_per_s=b / ms / 1e6)
    return rec


def int8_serving_main(dev, bf16_stats, size="3-8b", **kw):
    """Phase 22a: build_engine("llama", ``size``, phase 4's config +
    quantize_weights), bf16, at full width and depth, serves phase 4's
    traffic through generate() (phase 4's launch checks: every layer of
    every tick, every paged launch prefill_wgmma or decode_split, every
    norm cta_row), then through generate_fused (:func:`int8_fused`).
    Reported beside phase 4's bf16 engine (``bf16_stats``): prefill
    tokens/s, decode ms a tick, the weights' bytes resident on the card
    (at most 0.55x the bf16 engine's) and the peak memory of the build."""
    engine, stats = main_path(dev, size=size, engine_over=dict(
        kw.pop("engine_over", {}), **INT8_SERVING), **kw)
    prompts = stats.pop("prompts")
    fused = int8_fused(engine, dev, prompts, stats["outputs"],
                       max_new=stats["new_tokens"])
    if dev.type == "cuda":
        fused["profile"] = profile_fused(engine, dev,
                                         [p[:256] for p in prompts],
                                         modes=("greedy",))["greedy"]
        fused["dequant_alone"] = int8_dequant_times(engine, dev)
    ratio = stats["weight_bytes"] / bf16_stats["weight_bytes"]
    rec = dict(per_tick={k: v for k, v in stats.items() if k != "outputs"},
               fused=fused, weight_bytes_ratio_vs_bf16=ratio,
               bf16_weight_bytes=bf16_stats["weight_bytes"],
               bf16_decode_ms_per_tick=bf16_stats["decode_ms_per_tick"],
               bf16_prefill_tokens_per_s=bf16_stats["prefill_tokens_per_s"],
               bf16_build_peak_gib=bf16_stats["build_peak_gib"],
               bf16_fused_profile=bf16_stats.get("fused_profile"),
               greedy_agreement_vs_bf16=agreement(
                   stats["outputs"], bf16_stats["outputs"]))
    release_engine(engine, dev)
    del engine
    gc.collect()
    log(f"[int8] phase 22a: {json.dumps(rec)}")
    if dev.type == "cuda" and ratio > 0.55:
        raise AssertionError(f"int8 weights {stats['weight_bytes']} B are "
                             f"{ratio:.3f}x the bf16 engine's (> 0.55)")
    return rec


def fp32_llama_tree(layers: int, seed=11) -> dict:
    """Llama-3-8B's widths cut to ``layers``: a flat fp32 tree on the CPU,
    drawn as the model's init (the weights of 22b, 22e and 22f)."""
    import torch
    from deepspeed_tpu_torch.models import Llama
    with torch.no_grad():
        m = Llama(**LINEAR_MODEL, num_layers=layers, device="meta")
        m.device = torch.device("cpu")
        gen = torch.Generator().manual_seed(seed)
        return {n: m.draw(n, gen) for n in m._init_spec}


def int8_engines(dev, tree, layers, prompts, max_new, v1=True):
    """22b's engines on ``dev``: v2 (build_engine + quantize_weights,
    fp32) greedy through generate() and generate_fused (K 4), and with
    ``v1`` the v1 engine on the same weights and the first prompt; the
    first prefill's logits of the v2 engine (put())."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.inference.v2 import build_engine
    from deepspeed_tpu_torch.models import Llama
    from deepspeed_tpu_torch.models.transformer import deferred_weights
    cfg = {"dtype": "float32", "kv_block_size": 64, "num_kv_blocks": 64,
           "max_chunk_size": 256, "max_ragged_sequence_count": 8,
           **INT8_SERVING}
    v2 = build_engine("llama", engine_config=cfg, params=tree, device=dev,
                      **LINEAR_MODEL, num_layers=layers)
    logits = v2.put([90_000], [prompts[0]])[0].float().cpu()
    v2.flush(90_000)
    out = dict(logits=logits, v2=v2.generate(prompts, max_new_tokens=max_new),
               fused=v2.generate_fused(prompts, max_new_tokens=max_new,
                                       k_steps=4),
               codes={n: p.detach().cpu() for n, p in v2.model.params.items()
                      if n.endswith("_q") or n.endswith("_s")})
    release_engine(v2, dev)
    if v1:
        with deferred_weights():       # the loader gives every leaf
            model = Llama(**LINEAR_MODEL, num_layers=layers, device=dev)
        eng = ds.init_inference(model, config={
            "dtype": "fp32", "max_out_tokens": 256, **INT8_SERVING},
            params=tree)
        out["v1"] = eng.generate([prompts[0]], max_new_tokens=max_new)[
            0, len(prompts[0]):].tolist()
        del eng, model
    gc.collect()
    return out


def int8_fp32_parity(dev, tree, cpu, fp32=INT8_FP32):
    """Phase 22b (TF32 off): the int8 engines of :func:`int8_engines` on
    the card against the same on the CPU (``cpu``, made beforehand): the
    int8 codes and scales bit-equal (the quantize is torch ops on both),
    the first prefill's logits within 1e-5 of their largest, greedy tokens
    equal, v2's generate_fused tokens and the v1 engine's (first prompt)
    equal to v2's generate()."""
    prompts = int8_prompts(fp32)
    card = int8_engines(dev, tree, fp32["layers"], prompts, fp32["max_new"])
    err = float((card["logits"] - cpu["logits"]).abs().max()
                / cpu["logits"].abs().max())
    codes_equal = all(bool((card["codes"][n] == cpu["codes"][n]).all())
                      for n in cpu["codes"])
    rec = dict(layers=fp32["layers"], requests=len(prompts),
               new_tokens=fp32["max_new"], logits_err_rel_to_max=err,
               codes_and_scales_bit_equal=codes_equal,
               tokens_card=card["v2"], tokens_cpu=cpu["v2"],
               card_equals_cpu=card["v2"] == cpu["v2"],
               fused_equals_generate=card["fused"] == card["v2"],
               v1_equals_v2=card["v1"] == card["v2"][0],
               cpu_fused_equals_generate=cpu["fused"] == cpu["v2"],
               cpu_v1_equals_v2=cpu["v1"] == cpu["v2"][0])
    log(f"[int8] phase 22b fp32: {json.dumps(rec)}")
    if err > 1e-5 or not all(rec[k] for k in (
            "codes_and_scales_bit_equal", "card_equals_cpu",
            "fused_equals_generate", "v1_equals_v2",
            "cpu_fused_equals_generate", "cpu_v1_equals_v2")):
        raise AssertionError(f"phase 22b: {rec}")
    return rec


def int8_prompts(fp32=INT8_FP32):
    from deepspeed_tpu_torch.models.llama import llama_config
    vocab = llama_config(**LINEAR_MODEL).vocab_size
    rng = np.random.default_rng(12)
    lens = rng.integers(*fp32["lengths"], fp32["n_req"])
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def int8_v1_main(dev, size="6b", length=V1_PROMPTS["length"]):
    """Phase 22c: init_inference(GPTJ(size="6b"), bf16, quantize_weights)
    with random seeded weights, phase 20e's traffic (8 prompts of 256, 32
    greedy, the decode steps graph replays of a graph :func:`v1_warm`
    captured untimed): generated tokens/s, ms a decode step, the
    capture, the int8 weights' bytes beside the bf16 tree's, the norm
    launches (every one a row kernel, 2L + 1 a forward)."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPTJ
    model = GPTJ(size=size, device=dev, dtype=torch.bfloat16)
    bf16_bytes = weight_bytes(model.params)
    eng = ds.init_inference(model, config={
        "dtype": "bf16", "max_out_tokens": 1024, **INT8_SERVING})
    c = eng.module.config
    prompts = v1_prompts_of(c.vocab_size, length)
    v1_warm(eng, prompts, V1_PROMPTS["max_new"])
    norms = norm_counter(c)
    reset_norms(norms)
    sync(dev)
    t = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=V1_PROMPTS["max_new"])
    sync(dev)
    wall = time.perf_counter() - t
    new = out[:, len(prompts[0]):]
    graph = v1_graph_record(eng, dev, "22c v1 int8 generate", warmed=True)
    norm_by_variant = check_norm_variants(norms, dev, "v1 int8 generate")
    forwards = V1_PROMPTS["max_new"]
    rec = dict(model=f"gptj-{size}", dtype="bfloat16", quantize_weights=True,
               requests=len(prompts), prompt_tokens=len(prompts[0]),
               new_tokens=forwards, generate_s=wall,
               generated_tokens_per_s=len(prompts) * forwards / wall,
               ms_per_step=1e3 * wall / forwards,
               weight_bytes=weight_bytes(eng.module.params),
               bf16_weight_bytes=bf16_bytes,
               norm_launches=norms.launches,
               norm_launches_by_variant=norm_by_variant, **graph)
    rec["weight_bytes_ratio_vs_bf16"] = rec["weight_bytes"] / bf16_bytes
    ok = bool(((new >= 0) & (new < c.vocab_size)).all())
    del eng, model, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[int8] phase 22c v1: {json.dumps(rec)}")
    if not ok or dev.type == "cuda" and norms.launches != \
            norms_per_forward(c) * graph["forwards_launched"]:
        raise AssertionError(f"phase 22c: tokens in range {ok}, norm "
                             f"launches {norms.launches}")
    return rec


def lora_model(dev, layers=None, dtype=None, frozen=None, adapters=None):
    """LoRAModel(Llama 3-8b (``layers`` cut), LoRAConfig(),
    QuantizationConfig()) with segments remat and flash: the base drawn
    from the seed, or ``frozen``/``adapters`` as given."""
    from deepspeed_tpu_torch.linear import (LoRAConfig, LoRAModel,
                                            QuantizationConfig)
    from deepspeed_tpu_torch.models import Llama
    from deepspeed_tpu_torch.models.transformer import deferred_weights
    over = {"num_layers": layers} if layers else {}
    # a given base needs no float weights of the model's own
    with (deferred_weights() if frozen is not None
          else contextlib.nullcontext()):
        base = Llama(**LINEAR_MODEL, remat_policy="segments",
                     attn_impl="flash", device=dev, dtype=dtype, **over)
    return LoRAModel(base, LoRAConfig(), QuantizationConfig(),
                     frozen=frozen, adapters=adapters)


def lora_flops_per_token(model, seq) -> dict:
    """The work a LoRA step over a frozen base does a token, beside the
    base model's training count (``flops_per_token``: 6 N + attention, N
    as it counts it). No weight gradient of the base is formed: its
    forward (2 N) and input gradients (2 N), the adapters' forward and
    both their gradients (6 N_a), and all of attention (forward and
    backward, as ``flops_per_token`` counts it) make the model work;
    ``segments`` remat reruns each layer's projections and adapters
    forward (2 N_layers + 2 N_a) besides."""
    c = model.config
    n, n_a = c.num_params(), sum(p.numel() for p in model.params.values())
    n_layers = sum(leaf.numel if isinstance(leaf.numel, int)
                   else leaf.numel() for name, leaf in model.frozen.items()
                   if name.startswith("layers/"))
    full = c.flops_per_token(seq, causal=True)
    attention = full - 6 * n
    model_work = 4 * n + 6 * n_a + attention
    return dict(base_training=full, model=model_work,
                with_recompute=model_work + 2 * n_layers + 2 * n_a)


def lora_main(dev, rows=LORA_ROWS, seq=LORA_SEQ, steps=LORA_STEPS,
              layers=None):
    """Phase 22d: LoRAModel over Llama-3-8B (bf16 base, the seven
    projections int8 in blocks of 512 by the quantize kernel's
    exact-division mode) -> initialize(TRAIN_CONFIG: bf16, fused Adam, ZeRO
    2, clip 1.0) -> train_batch on ``rows`` x ``seq`` tokens, one warm-up
    step then ``steps`` timed steps, the counts set to 0 just before them:
    step ms, tokens/s, MFU over the base model's flops_per_token and
    over the work LoRA does (:func:`lora_flops_per_token`), peak memory, the trainable count, the quantize / dequantize launches (the
    transform's and the steps': 14 a layer a micro-step under segments,
    7 forward and 7 recomputed), flash launches (every one wgmma), norm
    launches (row kernels), the losses (finite and falling), and the
    frozen codes and scales bit-identical before and after the steps."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.linear import is_quantized
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_optimizers import fused_adam_step
    quant_counts_reset()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = lora_model(dev, layers, torch.bfloat16)
    build_s = time.perf_counter() - t
    transform = quant_counts()
    build_peak = (torch.cuda.max_memory_allocated() / 2**30
                  if dev.type == "cuda" else None)
    c = model.config
    frozen_q = {n: leaf for n, leaf in model.frozen.items()
                if is_quantized(leaf)}
    before = {n: (leaf.codes.cpu(), leaf.scales.cpu())
              for n, leaf in frozen_q.items()}
    t = time.perf_counter()
    engine, _, _, _ = ds.initialize(model=model, config=dict(
        TRAIN_CONFIG, train_batch_size=rows))
    init_s = time.perf_counter() - t
    batch = train_batch_of(dev, c.vocab_size, rows, seq)
    engine.train_batch(batch)                                  # warm-up
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    norms = norm_counter(c)
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_fwd.variant_launches = {}
    fa.flash_attention_bwd.variant_launches = {}
    fused_adam_step.launches = 0
    reset_norms(norms)
    quant_counts_reset()
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(engine.train_batch(batch))
        sync(dev)
        step_s.append(time.perf_counter() - t)
    counts = quant_counts()
    norm_by_variant = check_norm_variants(norms, dev, "LoRA training")
    losses = [float(x) for x in losses]
    tok_s = rows * seq * steps / sum(step_s)
    flash = {"fwd": dict(fa.flash_attention_fwd.variant_launches),
             "bwd": dict(fa.flash_attention_bwd.variant_launches)}
    unchanged = all(torch.equal(leaf.codes.cpu(), before[n][0])
                    and torch.equal(leaf.scales.cpu(), before[n][1])
                    for n, leaf in frozen_q.items())
    trainable = sum(p.numel() for p in model.params.values())
    work = lora_flops_per_token(model, seq)
    stats = dict(
        model=f"llama-{LINEAR_MODEL['size']} LoRA r "
              f"{model.lora_state.lora_config.lora_r}",
        layers=c.num_layers, batch=rows, seq=seq, steps=steps,
        trainable_params=trainable, base_params=c.num_params(),
        frozen_bytes=sum(leaf.nbytes if is_quantized(leaf) else
                         leaf.numel() * leaf.element_size()
                         for leaf in model.frozen.values()),
        build_s=build_s,
        build_peak_gib=build_peak, initialize_s=init_s,
        transform_launches=transform,
        step_ms=1e3 * sum(step_s) / steps, step_ms_min=1e3 * min(step_s),
        step_ms_max=1e3 * max(step_s), tokens_per_s=tok_s,
        mfu=c.flops_per_token(seq, causal=True) * tok_s / BF16_FLOPS,
        lora_flops_per_token=work,
        mfu_lora_work=work["model"] * tok_s / BF16_FLOPS,
        hfu_lora_with_recompute=work["with_recompute"] * tok_s / BF16_FLOPS,
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None),
        losses=losses, quant_launches=counts,
        fused_adam_launches=fused_adam_step.launches,
        flash_launches_by_variant=flash, norm_launches=norms.launches,
        norm_launches_by_variant=norm_by_variant,
        frozen_bit_identical=unchanged)
    del engine, model, before, frozen_q
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[lora] phase 22d: {json.dumps(stats)}")
    bad = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        bad.append(f"losses not finite and falling: {losses}")
    if not unchanged:
        bad.append("the frozen codes or scales changed")
    targets = 7
    want = {"fwd": {"wgmma": c.num_layers * steps},
            "bwd": {"wgmma": 2 * c.num_layers * steps}}
    if dev.type == "cuda" and (
            flash != want or stats["fused_adam_launches"] != steps
            or norms.launches != norm_launches_per_micro(c) * steps
            or counts["dequantize"] != 2 * targets * c.num_layers * steps
            or counts["quantize"] != 0
            or transform["quantize"] != targets
            or transform["quantize_exact"] != targets):
        bad.append(f"launches: flash {flash} (want {want}), Adam "
                   f"{stats['fused_adam_launches']} (want {steps}), norms "
                   f"{norms.launches}, quantize/dequantize in the steps "
                   f"{counts} (want 0 / {2 * targets * c.num_layers * steps})"
                   f", at the transform {transform} (want {targets} exact)")
    if bad:
        raise AssertionError("phase 22d: " + "; ".join(bad))
    return stats


def lora_engine_run(dev, frozen, adapters, fp32=LORA_FP32):
    """One side of 22e: the LoRA model of ``frozen`` / ``adapters`` (moved
    to ``dev``) at fp32's depth, TRAIN_CONFIG in fp32 at fp32's lr, its
    steps on one seeded batch. Returns the losses, the first step's
    adapter grads, the adapters' change and the trained state."""
    import deepspeed_tpu_torch as ds
    frozen = {n: leaf.to(dev) for n, leaf in frozen.items()}
    adapters = {n: {k: v.to(dev) for k, v in ab.items()}
                for n, ab in adapters.items()}
    model = lora_model(dev, fp32["layers"], frozen=frozen, adapters=adapters)
    cfg = dict(TRAIN_CONFIG, train_batch_size=fp32["rows"],
               bf16={"enabled": False},
               optimizer={"type": "FusedAdam", "params": dict(
                   TRAIN_CONFIG["optimizer"]["params"], lr=fp32["lr"])})
    engine, _, _, _ = ds.initialize(model=model, config=cfg)
    init = {n: t.detach().cpu().clone()
            for n, t in engine.master_state_dict().items()}
    batch = train_batch_of(dev, model.config.vocab_size, fp32["rows"],
                           fp32["seq"], seed=7)
    losses, grads = [], None
    for step in range(fp32["steps"]):
        losses.append(float(engine.train_batch(batch)))
        if step == 0:
            grads = engine._grads.detach().cpu().clone()
    change = {n: t.detach().cpu() - init[n]
              for n, t in engine.master_state_dict().items()}
    state = model.lora_state_now()
    state.adapters = {n: {k: v.cpu() for k, v in ab.items()}
                      for n, ab in state.adapters.items()}
    del engine, model
    gc.collect()
    return dict(losses=losses, grads=grads, change=change, state=state)


def lora_cpu_side(tree, fp32=LORA_FP32):
    """22e's and 22f's CPU halves from ``tree`` (fp32, at fp32's depth):
    the base quantized by the plain versions (lora_transform, adapters
    from a seeded CPU generator), the LoRA run, then fuse_lora of its
    trained adapters and the int8 engine's greedy tokens on the fused
    weights."""
    import torch
    from deepspeed_tpu_torch.linear import (LoRAConfig, QuantizationConfig,
                                            fuse_lora, lora_transform)
    cpu = torch.device("cpu")
    frozen, state, _ = lora_transform(
        tree, LoRAConfig(), QuantizationConfig(),
        torch.Generator().manual_seed(13))
    run = lora_engine_run(cpu, frozen, state.adapters, fp32)
    fused = fuse_lora(frozen, run["state"])
    prompts = int8_prompts()
    serve = int8_engines(cpu, fused, fp32["layers"], prompts,
                         INT8_FP32["max_new"], v1=False)
    return dict(frozen=frozen, adapters=state.adapters, run=run,
                fused=fused, serve=serve)


def lora_fp32_parity(dev, tree, cpu, fp32=LORA_FP32):
    """Phase 22e (TF32 off): the kernel-made base against the plain one,
    bit for bit (the stacks of ``tree`` quantized on the card in the
    exact-division mode, and in the wire's mode against its plain
    version; each dequantized by the kernel against plain), then the LoRA
    run on the card from the CPU's base and adapters against the CPU's
    (``cpu``): phase 21's bounds (losses 1e-4 relative, the first step's
    adapter grads 1e-4 of their largest, the adapters after the steps 1e-3
    of their change). Phase 22f: the CPU's trained adapters fused into the
    base (fuse_lora) and served int8 (build_engine + quantize_weights,
    fp32) on the card: tokens equal to the CPU's, generate_fused equal to
    generate()."""
    import torch
    from deepspeed_tpu_torch.linear import (QuantizationConfig,
                                            quantize_param)
    from deepspeed_tpu_torch.ops import quantization as TQ
    bits = {}
    quant_counts_reset()
    for name, leaf in cpu["frozen"].items():
        if not hasattr(leaf, "codes"):
            continue
        w = tree[name].to(dev)
        qp = quantize_param(w, QuantizationConfig())
        codes, scales = TQ.quantize_rows(w.view(1, -1), exact=False)
        pcodes, pscales = TQ.quantize_rows(w.view(1, -1).cpu(),
                                           use_kernel=False, exact=False)
        deq = qp.dequantized().cpu()
        bits[name] = dict(
            exact_codes=bool(torch.equal(qp.codes.cpu(), leaf.codes)),
            exact_scales=bool(torch.equal(qp.scales.cpu(), leaf.scales)),
            wire_codes=bool(torch.equal(codes.cpu(), pcodes)),
            wire_scales=bool(torch.equal(scales.cpu(), pscales)),
            dequantized=bool(torch.equal(deq, leaf.dequantized())),
            scales_differing_between_modes=int(
                (pscales != leaf.scales).sum()))
        del w, qp, codes, scales, deq
    counts = quant_counts()
    card = lora_engine_run(dev, cpu["frozen"], cpu["adapters"], fp32)
    ref = cpu["run"]

    def rel(names):
        err = sum(float((card["change"][n] - ref["change"][n]).pow(2).sum())
                  for n in names)
        moved = sum(float(ref["change"][n].pow(2).sum()) for n in names)
        return (err / moved) ** 0.5

    rec = dict(layers=fp32["layers"], rows=fp32["rows"], seq=fp32["seq"],
               lr=fp32["lr"], base_bit_equal=bits, kernel_launches=counts,
               loss_card=card["losses"], loss_cpu=ref["losses"],
               loss_max_rel_err=max(abs(a - b) / abs(b) for a, b in
                                    zip(card["losses"], ref["losses"])),
               grad_max_err_rel_to_max=float(
                   (card["grads"] - ref["grads"]).abs().max()
                   / ref["grads"].abs().max()),
               adapters_err_rel_to_change=rel(list(ref["change"])))
    log(f"[lora] phase 22e fp32: {json.dumps(rec)}")
    flat_bits = [v for b in bits.values() for k, v in b.items()
                 if isinstance(v, bool)]
    if (not all(flat_bits) or rec["loss_max_rel_err"] > 1e-4
            or rec["grad_max_err_rel_to_max"] > 1e-4
            or rec["adapters_err_rel_to_change"] > 1e-3
            or dev.type == "cuda" and (counts["quantize_exact"] != len(bits)
                                       or counts["dequantize"] < len(bits))):
        raise AssertionError(f"phase 22e: {rec}")
    del card
    gc.collect()
    prompts = int8_prompts()
    served = int8_engines(dev, cpu["fused"], fp32["layers"], prompts,
                          INT8_FP32["max_new"], v1=False)
    want = cpu["serve"]
    f = dict(requests=len(prompts), new_tokens=INT8_FP32["max_new"],
             tokens_card=served["v2"], tokens_cpu=want["v2"],
             card_equals_cpu=served["v2"] == want["v2"],
             fused_equals_generate=served["fused"] == served["v2"],
             logits_err_rel_to_max=float(
                 (served["logits"] - want["logits"]).abs().max()
                 / want["logits"].abs().max()))
    log(f"[lora] phase 22f fine-tune then serve: {json.dumps(f)}")
    if not (f["card_equals_cpu"] and f["fused_equals_generate"]) \
            or f["logits_err_rel_to_max"] > 1e-5:
        raise AssertionError(f"phase 22f: {f}")
    return rec, f


def linear_cpu_sides(pool):
    """The CPU halves of phase 22's fp32 checks, queued on the worker
    ``pool`` behind phase 21's (beside phase 2's nvcc; a second thread
    slowed the build more than it saved): futures of the fp32 tree
    (Llama-3-8B's widths at 2 layers), the int8 engines' run on it (22b)
    and the LoRA run, fused and served (22e-f)."""
    import torch
    cpu = torch.device("cpu")
    tree = pool.submit(fp32_llama_tree, INT8_FP32["layers"])
    return {"tree": tree,
            "int8": pool.submit(lambda: int8_engines(
                cpu, tree.result(), INT8_FP32["layers"], int8_prompts(),
                INT8_FP32["max_new"])),
            "lora": pool.submit(lambda: lora_cpu_side(tree.result()))}


def linear_main(dev, bf16_stats, cpu_sides, **kw):
    """Phase 22 (a-f), each sub-phase fatal on failure. ``bf16_stats``:
    phase 4's record (the bf16 engine's weight bytes, decode ms, build
    peak and tokens); ``cpu_sides``: :func:`linear_cpu_sides`'s results
    (the tree, the 22b and 22e-f CPU halves). ``kw`` goes to the
    full-width sub-phases (a CPU rehearsal shrinks them)."""
    t0 = time.perf_counter()
    tree = cpu_sides["tree"]
    rec = {"serving": int8_serving_main(dev, bf16_stats,          # 22a
                                        **kw.get("serving", {}))}
    rec["fp32_serving"] = int8_fp32_parity(dev, tree,             # 22b
                                           cpu_sides["int8"])
    rec["v1"] = int8_v1_main(dev, **kw.get("v1", {}))             # 22c
    rec["lora"] = lora_main(dev, **kw.get("lora", {}))            # 22d
    rec["lora_fp32"], rec["lora_serve"] = lora_fp32_parity(      # 22e, f
        dev, tree, cpu_sides["lora"])
    rec["seconds"] = time.perf_counter() - t0
    log(f"[linear] phase 22: {rec['seconds']:.1f} s")
    return rec


# ----------------------------------------------------------- phase 23
# BERT (models/bert.py, ops/transformer.py) trained at full size: (a)
# BERT-large at phase 1 of DeepSpeed's BERT-large pre-training (S 128,
# micro-batch 64), 15% of positions as MLM targets, rows 48-63 padded
# from position 96, with TRAIN_CONFIG (bf16, FusedAdam lr 1e-4 wd 0.01
# with the fused kernel, ZeRO 2, clip 1.0; LAMB is not ported yet); (b)
# the fp32 checks, the card against the CPU (TF32 off): BERT-large's
# widths at 2 layers with phase 21's rows, lr and steps at S 128 and one
# padded row, and the encoder layer pre-LN at BERT-large's width
BERT_TRAIN = dict(size="large", rows=64, seq=128, steps=5, pad_rows=16,
                  pad_from=96)
BERT_FP32 = dict(layers=2, rows=2, seq=128, steps=3, lr=1e-5)
BERT_LAYER_FP32 = dict(rows=4, seq=128)


def mlm_batch_of(dev, vocab, rows, seq, pad_rows=0, pad_from=None, seed=5):
    """(tokens, targets, attention_mask) on dev: random tokens, 15% of the
    positions as MLM targets (-100 elsewhere), the last ``pad_rows`` rows
    padded from ``pad_from`` (mask 0 and no targets there)."""
    import torch
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (rows, seq))
    tgt = np.where(rng.random((rows, seq)) < 0.15, tok, -100)
    mask = np.ones((rows, seq), np.int64)
    if pad_rows:
        mask[rows - pad_rows:, pad_from:] = 0
        tgt[rows - pad_rows:, pad_from:] = -100
    return tuple(torch.from_numpy(a).to(dev) for a in (tok, tgt, mask))


def bert_fp32_batch(dev, vocab, rows, seq):
    """Phase 23b's batch: an MLM batch, its last row padded from 3/4 of
    the sequence."""
    return mlm_batch_of(dev, vocab, rows, seq, pad_rows=1,
                        pad_from=seq * 3 // 4, seed=7)


def bert_train_main(dev, size="large", rows=64, seq=128, steps=5,
                    pad_rows=16, pad_from=96, profile=False):
    """Phase 23a: initialize(Bert(``size``), random seeded weights,
    TRAIN_CONFIG) -> train_batch on one fixed MLM batch, one warm-up step
    then ``steps`` timed steps, the counts set to 0 just before them:
    tokens/s, step ms, MFU over flops_per_token(seq) at 989 TFLOP/s, peak
    memory, the losses (finite and falling), the LayerNorm launches a
    step by variant (2L + 2 a step, no remat; every one warp_row at
    bf16 d 1024) and fused Adam's (1 a step). ``profile``: then one more
    step under torch.profiler (:func:`profile_window`)."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Bert
    from deepspeed_tpu_torch.ops import norms as N
    from deepspeed_tpu_torch.ops.fused_optimizers import fused_adam_step
    model = Bert(size=size, device=dev)
    c = model.config
    t = time.perf_counter()
    engine, _, _, _ = ds.initialize(model=model, config=dict(
        TRAIN_CONFIG, train_batch_size=rows))
    init_s = time.perf_counter() - t
    batch = mlm_batch_of(dev, c.vocab_size, rows, seq, pad_rows, pad_from)
    engine.train_batch(batch)                                  # warm-up
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    norms = N.layer_norm_kernel
    reset_norms(norms)
    fused_adam_step.launches = 0
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(engine.train_batch(batch))
        sync(dev)
        step_s.append(time.perf_counter() - t)
    norm_by_variant = check_norm_variants(norms, dev, "BERT training")
    norm_launches, adam_launches = norms.launches, fused_adam_step.launches
    losses = [float(x) for x in losses]
    tok_s = rows * seq * steps / sum(step_s)
    per_step = 2 * c.num_layers + 2
    stats = dict(
        model=f"bert-{size}", params=c.num_params(), layers=c.num_layers,
        hidden=c.hidden_size, heads=c.num_heads, head_dim=c.head_dim,
        vocab=c.vocab_size, batch=rows, seq=seq,
        padded=f"rows {rows - pad_rows}-{rows - 1} from position "
               f"{pad_from}", mlm_targets=int((batch[1] != -100).sum()),
        steps=steps, initialize_s=init_s,
        step_ms=1e3 * sum(step_s) / steps, step_ms_min=1e3 * min(step_s),
        step_ms_max=1e3 * max(step_s), tokens_per_s=tok_s,
        flops_per_token=c.flops_per_token(seq),
        mfu=c.flops_per_token(seq) * tok_s / BF16_FLOPS,
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None),
        losses=losses, fused_adam_launches=adam_launches,
        norm_launches=norm_launches, norm_launches_per_step=per_step,
        norm_launches_by_variant=norm_by_variant)
    if profile:
        stats["profile"] = profile_window(
            "bert_step", lambda: engine.train_batch(batch), 1)[1]
    del engine, model, batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[bert] {json.dumps(stats)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bert-{size} training losses not finite and "
                             f"falling: {losses}")
    if dev.type == "cuda" and (norm_launches != per_step * steps
                               or set(norm_by_variant) != {"warp_row"}
                               or adam_launches != steps):
        raise AssertionError(
            f"bert-{size} training launches: norms {norm_launches} "
            f"{norm_by_variant} (want {per_step * steps}, every one "
            f"warp_row), Adam {stats['fused_adam_launches']} (want "
            f"{steps})")
    return stats


def bert_layer_fp32(dev, rows=4, seq=128):
    """Phase 23b: DeepSpeedTransformerLayer pre-LN at BERT-large's width
    (d 1024, 16 heads, FFN 4096) in fp32 with TF32 off, the card against
    the CPU from the same weights and inputs, the last row padded from
    3/4 of the sequence, no dropout (no generator): the output and the
    grads of the twelve parameters and of the input within 1e-4 of each
    tensor's largest element (phase 7's grads bound); 2 LayerNorm
    launches a forward."""
    import torch
    from deepspeed_tpu_torch.ops import norms as N
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    cfg = DeepSpeedTransformerConfig(
        hidden_size=1024, intermediate_size=4096, heads=16,
        num_hidden_layers=24, pre_layer_norm=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((rows, seq, 1024)).astype(np.float32)
    cot = rng.standard_normal((rows, seq, 1024)).astype(np.float32)
    mask = np.zeros((rows, 1, 1, seq), np.float32)
    mask[-1, ..., seq * 3 // 4:] = -1e30
    runs = {}
    cpu_layer = DeepSpeedTransformerLayer(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = N.layer_norm_kernel.launches
    for where in ("cpu", "card"):
        d = torch.device("cpu") if where == "cpu" else dev
        layer = (cpu_layer if where == "cpu" else
                 DeepSpeedTransformerLayer(cfg, device=d))
        if where == "card":
            layer.load_state_dict(cpu_layer.state_dict())
        xt = torch.from_numpy(x).to(d).requires_grad_()
        out = layer(xt, torch.from_numpy(mask).to(d))
        (out * torch.from_numpy(cot).to(d)).sum().backward()
        runs[where] = {"output": out.detach().cpu(), "input": xt.grad.cpu(),
                       **{n: p.grad.cpu() for n, p in layer.params.items()}}
        del layer, xt, out
    errs = {n: float((runs["card"][n] - ref).abs().max()
                     / ref.abs().max()) for n, ref in runs["cpu"].items()}
    launches = N.layer_norm_kernel.launches - before
    rec = dict(shape=f"B={rows} S={seq} d=1024 H=16 FFN=4096 pre-LN fp32",
               max_err_rel_to_max=max(errs.values()),
               err_rel_to_max=errs, norm_launches=launches)
    log(f"[bert] layer fp32 card vs cpu {json.dumps(rec)}")
    if rec["max_err_rel_to_max"] > 1e-4 or (dev.type == "cuda"
                                            and launches != 2):
        raise AssertionError(f"phase 23b layer, card vs cpu: {rec}")
    return rec


def bert_main(dev, train=BERT_TRAIN, fp32=BERT_FP32, layer=BERT_LAYER_FP32,
              profile=False):
    """Phase 23: (a) :func:`bert_train_main` (``profile``: its step
    traced); (b) :func:`train_family_fp32` on BERT at ``fp32``'s depth
    (every tensor under the params bound) and :func:`bert_layer_fp32`."""
    t0 = time.perf_counter()
    rec = {"train": bert_train_main(dev, profile=profile, **train)}
    rec["fp32_card_vs_cpu"] = train_family_fp32(
        dev, "bert", train["size"], loose=(), model_kw={},
        batch_of=bert_fp32_batch, **fp32)
    rec["layer_fp32_card_vs_cpu"] = bert_layer_fp32(dev, **layer)
    rec["seconds"] = time.perf_counter() - t0
    log(f"[bert] phase 23: {rec['seconds']:.1f} s")
    return rec


# ----------------------------------------------------------- phase 24
# Hugging Face checkpoints served: a Llama-3-8B checkpoint directory with
# the published config.json fields, depth cut to HF_LAYERS (for disk and
# time: ~5.6 GB), bf16 safetensors shards of at most HF_SHARD_BYTES with
# an index, written by the port's own writer from a seeded JAX-layout
# tree (the card's machine has no safetensors package), then (a)
# build_hf_engine with phase 4's engine config and traffic against
# build_engine from the tree; (b) init_inference(path) with phase 20e's
# v1 traffic against the v1 engine from the tree
HF_LAYERS = 8
HF_SHARD_BYTES = 2 * 10**9
HF_DIR = os.path.join(os.path.dirname(os.path.realpath(__file__)), "build",
                      "hf_llama3_8b")     # in the checkout, as op_builder's
LLAMA3_8B_HF = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                "hidden_size": 4096, "intermediate_size": 14336,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "vocab_size": 128256, "rope_theta": 500000.0,
                "rms_norm_eps": 1e-5, "max_position_embeddings": 8192,
                "tie_word_embeddings": False, "hidden_act": "silu",
                "torch_dtype": "bfloat16", "bos_token_id": 128000,
                "eos_token_id": 128001}
HF_LLAMA_LAYER = {"ln1_scale": "input_layernorm.weight",
                  "wq": "self_attn.q_proj.weight",
                  "wk": "self_attn.k_proj.weight",
                  "wv": "self_attn.v_proj.weight",
                  "wo": "self_attn.o_proj.weight",
                  "ln2_scale": "post_attention_layernorm.weight",
                  "w_gate": "mlp.gate_proj.weight",
                  "w_up": "mlp.up_proj.weight",
                  "w_down": "mlp.down_proj.weight"}


def llama_tree(dev, layers, seed=17) -> dict:
    """A seeded Llama-3-8B tree cut to ``layers``, flat name -> bf16 tensor
    on ``dev`` (the model's init scheme, drawn in fp32 leaf by leaf)."""
    import torch
    from deepspeed_tpu_torch.models import Llama
    from deepspeed_tpu_torch.models.transformer import deferred_weights
    with deferred_weights():
        model = Llama(size="3-8b", num_layers=layers, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {name: model.draw(name, gen).to(torch.bfloat16)
            for name in model._init_spec}


def hf_llama_tensors(tree: dict, layers: int) -> list:
    """(HF name, function giving the tensor) for a Llama tree, in the HF
    checkpoint's order: the [in, out] leaves transposed back to
    nn.Linear's [out, in]."""
    def get(name, i=None):
        t = tree[name] if i is None else tree[name][i]
        return t.T if t.ndim == 2 else t

    items = [("model.embed_tokens.weight",
              lambda: tree["embed/tokens"])]
    for i in range(layers):
        for ours, hf in HF_LLAMA_LAYER.items():
            items.append((f"model.layers.{i}.{hf}",
                          lambda ours=ours, i=i: get("layers/" + ours, i)))
    items += [("model.norm.weight", lambda: tree["final_norm/scale"]),
              ("lm_head.weight", lambda: get("lm_head"))]
    return items


def write_hf_checkpoint(path: str, tree: dict, layers: int,
                        shard_bytes=HF_SHARD_BYTES) -> dict:
    """config.json (LLAMA3_8B_HF at ``layers``), the shards
    (model-0000k-of-0000n.safetensors, each at most ``shard_bytes``,
    written one at a time from the card) and
    model.safetensors.index.json."""
    from deepspeed_tpu_torch.checkpoint.huggingface import save_safetensors
    t = time.perf_counter()
    items = hf_llama_tensors(tree, layers)
    shards, cur, size = [], [], 0
    for name, fn in items:
        n = fn().numel() * fn().element_size()
        if cur and size + n > shard_bytes:
            shards.append(cur)
            cur, size = [], 0
        cur.append((name, fn))
        size += n
    shards.append(cur)
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        tensors = {name: fn().contiguous().cpu() for name, fn in shard}
        total += save_safetensors(tensors, os.path.join(path, fname))
        weight_map.update({name: fname for name in tensors})
        del tensors
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(LLAMA3_8B_HF, num_hidden_layers=layers), f)
    return dict(bytes=total, shards=len(shards), tensors=len(weight_map),
                seconds=time.perf_counter() - t)


class RssPeak:
    """The process's peak resident set size over a ``with`` block, read
    from /proc/self/status every ``interval`` seconds on a thread."""

    def __init__(self, interval: float = 0.002):
        self.interval = interval

    def __enter__(self):
        import threading
        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self._rss())

    def _poll(self):
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, self._rss())

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise RuntimeError("no VmRSS in /proc/self/status")


def host_memory_gib():
    """The memory this process's host may use: its cgroup's limit where
    one is set, else the machine's total."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit = f.read().strip()
        if limit.isdigit():
            return int(limit) / 2**30
    except OSError:
        pass
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024 / 2**30
    return None


def serving_prompts(vocab, n_req=8, lengths=(100, 701), long_prompt=None):
    """Phase 4's prompts: ``n_req`` of seeded lengths in ``lengths`` (the
    first the longest, so it chunks), and a ``long_prompt`` of that many
    tokens beside them where given. Returns (lengths, prompts)."""
    rng = np.random.default_rng(1)
    lens = rng.integers(lengths[0], lengths[1], n_req)
    lens[0] = lengths[1] - 1              # at least one prompt chunks
    if long_prompt:
        lens = np.append(lens, long_prompt)
    return lens, [rng.integers(0, vocab, n).tolist() for n in lens]


def params_bit_equal(a, b) -> bool:
    """Two parameter mappings hold the same names, dtypes and bits."""
    import torch
    return set(a.keys()) == set(b.keys()) and all(
        a[n].dtype == b[n].dtype and torch.equal(a[n], b[n])
        for n in a.keys())


def hf_v2_check(dev, path, tree, layers=HF_LAYERS, max_new=32,
                engine_over=None, **prompt_kw):
    """Phase 24a: build_hf_engine(``path``, phase 4's engine config) timed
    (seconds, GB/s over the weights' bytes, the host's peak RSS over the
    load and the device's peak over what was allocated before it; the
    same load with the mappers on the host, :func:`hf_engine_host_mapped`,
    timed after it as a yardstick) against build_engine("llama", "3-8b",
    num_layers=``layers``, params=``tree``): every parameter of both
    bit-equal; phase 4's requests x
    ``max_new`` greedy tokens equal, with phase 4's launch checks on the
    HF engine (every paged launch prefill_wgmma or decode_split, L a
    dispatch; every norm cta_row, 2L + 1 a dispatch)."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import build_engine, build_hf_engine
    cfg = dict(SERVING_CONFIG, **(engine_over or {}))
    ref = build_engine("llama", "3-8b", dict(cfg), params=tree, device=dev,
                       num_layers=layers)
    sync(dev)
    resident = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        t = time.perf_counter()
        eng = build_hf_engine(path, dict(cfg), device=dev)
        sync(dev)
        load_s = time.perf_counter() - t
    nbytes = weight_bytes(eng.model.params)
    build_peak = ((torch.cuda.max_memory_allocated() - resident) / 2**30
                  if dev.type == "cuda" else None)
    equal = params_bit_equal(eng.model.params, ref.model.params)
    with RssPeak() as host_rss:        # the yardstick: mapped on the host
        t = time.perf_counter()
        host = hf_engine_host_mapped(path, cfg, dev)
        sync(dev)
        host_s = time.perf_counter() - t
    host_equal = params_bit_equal(host.model.params, ref.model.params)
    release_engine(host, dev)
    del host
    c = eng.model.config
    _, prompts = serving_prompts(c.vocab_size, **prompt_kw)
    serve(eng, [prompts[0][:16]], 2, dev)                      # warm-up
    norms = reset_counts(c)
    eng.serving_stats["host_dispatches"] = 0
    outs, wall, _ = serve(eng, prompts, max_new, dev)
    counts = read_counts(norms)
    dispatches = eng.serving_stats["host_dispatches"]
    ref_outs, _, _ = serve(ref, prompts, max_new, dev)
    rec = dict(model=f"llama-3-8b cut to {layers} layers", dtype=cfg["dtype"],
               load_s=load_s, weight_bytes=nbytes,
               load_gb_per_s=nbytes / load_s / 1e9,   # the weights' bytes
               host_peak_rss_gib=rss.peak / 2**30,
               host_rss_added_gib=(rss.peak - rss.base) / 2**30,
               device_build_peak_gib=build_peak,
               device_resident_before_gib=resident / 2**30,
               host_mapped_load_s=host_s,
               host_mapped_load_gb_per_s=nbytes / host_s / 1e9,
               host_mapped_rss_added_gib=(host_rss.peak - host_rss.base)
               / 2**30, host_mapped_params_bit_equal=host_equal,
               params_bit_equal=equal, requests=len(prompts),
               new_tokens=max_new, generate_s=wall, dispatches=dispatches,
               tokens_equal=outs == ref_outs,
               greedy_agreement=agreement(outs, ref_outs), **counts)
    for engine in (eng, ref):
        release_engine(engine, dev)
    del eng, ref
    gc.collect()
    log(f"[hf] build_hf_engine {json.dumps(rec)}")
    if not (equal and host_equal) or not rec["tokens_equal"]:
        raise AssertionError(f"phase 24a: the HF engine's parameters or "
                             f"tokens differ from build_engine's: {rec}")
    check_variants(counts["launches_by_variant"], counts["launches"], dev,
                   "HF serving")
    if dev.type == "cuda" and (
            counts["launches"] != c.num_layers * dispatches
            or counts["norm_launches"] != norms_per_forward(c) * dispatches
            or set(counts["norm_launches_by_variant"]) != {"cta_row"}):
        raise AssertionError(f"phase 24a launches: {counts}, dispatches "
                             f"{dispatches}")
    return rec


def hf_engine_host_mapped(path, cfg, dev):
    """build_hf_engine's engine, its mappers run on the host (the
    checkpoint engine on the CPU: the transposes and stacks there, each
    leaf then copied to the card)."""
    from deepspeed_tpu_torch.checkpoint.huggingface import hf_model
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    ecfg = RaggedInferenceEngineConfig.from_dict(dict(cfg))
    model, params = hf_model(path, dev, ecfg.torch_dtype, map_device="cpu")
    return InferenceEngineV2(model, ecfg, params=params)


def hf_from_pretrained_check(dev, path, tree):
    """from_pretrained(``path``) on ``dev`` timed (seconds, GB/s over the
    checkpoint's bf16 bytes, the host's added RSS and the device's peak
    over what was allocated before it): the fp32 training model, every
    parameter the tree's bf16 leaf widened, bit for bit."""
    import torch
    from deepspeed_tpu_torch.checkpoint import from_pretrained
    sync(dev)
    resident = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        t = time.perf_counter()
        model, _ = from_pretrained(path, device=dev)
        sync(dev)
        load_s = time.perf_counter() - t
    nbytes = weight_bytes(tree)
    equal = (set(model.params.keys()) == set(tree)
             and all(p.dtype == torch.float32
                     and torch.equal(p, tree[n].float())
                     for n, p in model.params.items()))
    rec = dict(load_s=load_s, checkpoint_bytes=nbytes,
               load_gb_per_s=nbytes / load_s / 1e9,
               host_rss_added_gib=(rss.peak - rss.base) / 2**30,
               device_build_peak_gib=(
                   (torch.cuda.max_memory_allocated() - resident) / 2**30
                   if dev.type == "cuda" else None),
               params_bit_equal=equal)
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[hf] from_pretrained {json.dumps(rec)}")
    if not equal:
        raise AssertionError(f"phase 24a: from_pretrained's parameters "
                             f"differ from the tree's: {rec}")
    return rec


def hf_v1_check(dev, path, tree, layers=HF_LAYERS, length=None):
    """Phase 24b: init_inference(``path``, bf16) against
    init_inference(Llama-3-8B cut to ``layers``, params=``tree``):
    parameters bit-equal, phase 20e's 8 prompts (of ``length``, default
    256) x 32 greedy tokens equal; load seconds, every norm launch a row
    kernel, 2L + 1 a forward."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Llama
    from deepspeed_tpu_torch.models.transformer import deferred_weights
    cfg = {"dtype": "bf16", "max_out_tokens": 1024}
    t = time.perf_counter()
    eng = ds.init_inference(path, config=dict(cfg), device=dev)
    sync(dev)
    load_s = time.perf_counter() - t
    with deferred_weights():
        model = Llama(size="3-8b", num_layers=layers, device=dev,
                      dtype=torch.bfloat16)
    ref = ds.init_inference(model, config=dict(cfg), params=tree)
    equal = params_bit_equal(eng.module.params, ref.module.params)
    c = eng.module.config
    prompts = v1_prompts_of(c.vocab_size,
                            **({"length": length} if length else {}))
    v1_warm(eng, prompts, V1_PROMPTS["max_new"])
    norms = norm_counter(c)
    reset_norms(norms)
    sync(dev)
    t = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=V1_PROMPTS["max_new"])
    sync(dev)
    wall = time.perf_counter() - t
    graph = v1_graph_record(eng, dev, "24b v1 from an HF directory",
                            warmed=True)
    by_variant = check_norm_variants(norms, dev, "v1 from an HF directory")
    launches = norms.launches
    ref_out = ref.generate(prompts, max_new_tokens=V1_PROMPTS["max_new"])
    rec = dict(load_s=load_s, params_bit_equal=equal,
               requests=len(prompts), prompt_tokens=len(prompts[0]),
               new_tokens=V1_PROMPTS["max_new"], generate_s=wall,
               tokens_equal=bool(torch.equal(out, ref_out)),
               norm_launches=launches, norm_launches_by_variant=by_variant,
               **graph)
    del eng, ref, model, out, ref_out
    gc.collect()
    log(f"[hf] init_inference(path) {json.dumps(rec)}")
    if not equal or not rec["tokens_equal"] or (
            dev.type == "cuda" and launches
            != norms_per_forward(c) * graph["forwards_launched"]):
        raise AssertionError(f"phase 24b: {rec}")
    return rec


def hf_main(dev, layers=HF_LAYERS, path=HF_DIR, shard_bytes=HF_SHARD_BYTES,
            v2=None, v1=None):
    """Phase 24: the seeded tree, the directory written in shards of at
    most ``shard_bytes``, (a) :func:`hf_v2_check` and
    :func:`hf_from_pretrained_check`, (b) :func:`hf_v1_check`
    (``v2``/``v1``: their keywords; a CPU rehearsal shrinks them), the
    directory deleted."""
    import torch
    t0 = time.perf_counter()
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    try:
        tree = llama_tree(dev, layers)
        rec = {"written": write_hf_checkpoint(path, tree, layers,
                                              shard_bytes)}
        log(f"[hf] checkpoint written {json.dumps(rec['written'])}")
        rec["v2"] = hf_v2_check(dev, path, tree, layers, **(v2 or {}))
        rec["from_pretrained"] = hf_from_pretrained_check(dev, path, tree)
        rec["v1"] = hf_v1_check(dev, path, tree, layers, **(v1 or {}))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    del tree
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["reduced"] = f"depth {layers} of 32 (disk and time)"
    rec["seconds"] = time.perf_counter() - t0
    log(f"[hf] phase 24: {rec['seconds']:.1f} s")
    return rec


# ----------------------------------------------------------- phase 25
# MoE on the card (moe/, all experts on one card). (a) Qwen2-MoE a2.7b
# whole (24 layers, d 2048, 16 heads of 128, 60 experts top-4 and a shared
# expert, 13.7 B parameters) through build_engine with phase 4's config
# and traffic, generate() and then generate_fused (K 8, depth 2); (b)
# Mixtral-8x7B whole through init_inference with int8 routed experts,
# phase 20e's traffic, the capacity form and then the grouped form over
# the same quantized tree; (c) Qwen2-MoE a2.7b cut to 4 layers trained
# with phase 21's config and batch; (d) both families at full width, fp32,
# the card against the CPU: serving at MOE_FP32's depth, training at
# MOE_TRAIN_FP32's.
MOE_SERVING = dict(family="qwen2_moe", size="a2.7b", model_over=None)
MOE_V1 = dict(family="mixtral", size="8x7b", model_over=None)
MOE_TRAIN = dict(family="qwen2_moe", size="a2.7b", layers=4)
MOE_FP32 = dict(families=(("qwen2_moe", "a2.7b"), ("mixtral", "8x7b")),
                layers=2, n_req=3, max_new=6, lengths=(20, 90), k=2,
                model_over=None, family_layers={"mixtral": 1})
# Mixtral-8x7B's check runs at 1 of those 2 layers: at 2 (12.4 GB of fp32
# weights, each CPU tick streaming the experts and the int8 form
# dequantizing them on the host) its serving took 75 s of 25d's 172 on
# the H100's host, the CPU half the long pole
# the training check: Qwen2-MoE at 1 layer of full width. Mixtral-8x7B's
# is left out: its CPU half at 1 layer (1.7 B fp32 values with grads,
# moments, the change and the card's results beside the serving tree) ran
# the 96 GiB host out of memory, and it would add minutes of CPU time
MOE_TRAIN_FP32 = dict(families=(("qwen2_moe", "a2.7b"),), layers=1, rows=2,
                      seq=64, steps=3, lr=1e-5)
MOE_SEED = 25


def drop_fractions(model, run) -> list:
    """``run()`` with the model's routing metrics recorded: each forward's
    drop fraction, the mean over its layers (the host reads them after)."""
    import torch
    drops = []
    model.moe_metrics_hook = lambda m: drops.append(m["drop_fraction"])
    try:
        run()
    finally:
        model.moe_metrics_hook = None
    layers = model.config.num_layers
    return torch.stack(drops).view(-1, layers).mean(1).tolist()


def moe_serving_main(dev, family="qwen2_moe", size="a2.7b", model_over=None,
                     serve_kw=None, k=8):
    """Phase 25a: :func:`main_path` (phase 4's config, traffic and launch
    checks: every paged launch decode_split or prefill_wgmma, every norm a
    row kernel) on the MoE model, the drop fraction of each tick of the
    same requests once more, then generate_fused's loop (K ``k``, the
    default depth 2): a capturing run and the timed run, with phase 17's
    launch checks (every replayed paged launch decode_split, every prefill
    launch prefill_wgmma, every norm cta_row, counts = L x graph ticks +
    prefill dispatches). Reports prefill tokens/s, decode ms a tick and a
    fused step, the weights' bytes and the build's peak."""
    import torch
    engine, stats = main_path(dev, size=size, family=family,
                              model_over=model_over, **(serve_kw or {}))
    prompts, outputs = stats.pop("prompts"), stats.pop("outputs")
    c = engine.model.config
    max_new = stats["new_tokens"]
    per_tick = drop_fractions(engine.model,
                              lambda: serve(engine, prompts, max_new, dev))
    stats.update(drop_fraction_per_tick=per_tick,
                 drop_fraction_mean=float(np.mean(per_tick)),
                 drop_fraction_max=float(np.max(per_tick)),
                 active_params=c.num_active_params(),
                 params=c.num_params())
    first = len(engine.graph_captures)
    warm, _ = serve_fused(engine, prompts, max_new, dev, k)
    norms = reset_counts(c)
    ticks = count_ticks(engine)
    engine.reset_serving_metrics()
    timed_first = len(engine.graph_captures)
    try:
        outs, run = serve_fused(engine, prompts, max_new, dev, k)
    finally:
        uncount_ticks(engine)
    counts = read_counts(norms)
    m = engine.serving_metrics()
    prefill_dispatches = m["host_dispatches"] - m["fused_dispatches"]
    graph_ticks = sum(ticks) + len(engine.graph_captures) - timed_first
    layers = c.num_layers
    want = {"decode_split": layers * graph_ticks,
            "prefill_wgmma": layers * prefill_dispatches}
    want_norms = (2 * layers + 1) * (graph_ticks + prefill_dispatches)
    bad = []
    if outs != warm:
        bad.append("the fused rerun's tokens differ from the first run's")
    if any(len(o) != max_new or not all(0 <= t < c.vocab_size for t in o)
           for o in outs):
        bad.append("a generate_fused output is short or out of range")
    if dev.type == "cuda" and (counts["launches_by_variant"] != want or
                               counts["norm_launches"] != want_norms or
                               set(counts["norm_launches_by_variant"])
                               != {"cta_row"}):
        bad.append(f"fused launches {counts} != paged {want}, norms "
                   f"{want_norms} cta_row")
    if dev.type == "cuda" and set(stats["norm_launches_by_variant"]) \
            != {"cta_row"}:
        bad.append(f"generate() norms {stats['norm_launches_by_variant']}"
                   f" not all cta_row")
    captures = engine.graph_captures[first:]
    decode_s = run["wall_s"] - run["prefill_s"]
    stats["fused"] = dict(
        k=k, max_inflight_dispatches=m["max_inflight_dispatches"],
        prefill_tokens_per_s=run["prefill_tokens"] / run["prefill_s"],
        decode_steps=run["steps"], fused_dispatches=run["dispatches"],
        decode_ms_per_step=1e3 * decode_s / max(run["steps"], 1),
        generate_fused_s=run["wall_s"],
        e2e_generated_tokens_per_s=len(prompts) * max_new / run["wall_s"],
        graph_ticks=graph_ticks, prefill_dispatches=prefill_dispatches,
        **counts, greedy_agreement_vs_generate=agreement(outs, outputs),
        graphs_captured=len(captures),
        capture_ms_total=sum(g["capture_ms"] for g in captures),
        graph_pool_mib_total=sum(g["pool_mib"] for g in captures))
    stats["fused_grouped"] = grouped_fused_check(engine, dev, max_new, k)
    if dev.type == "cuda":
        # where the time goes: a prefill tick of 8 x 256 and 8 decode
        # ticks per tick, and one fused dispatch of 8 ticks
        stats["profile"] = dict(zip(("prefill_tick", "decode_ticks"),
                                    profile_main_path(engine, dev)))
        stats["profile"]["fused_dispatch"] = profile_fused(
            engine, dev, [p[:256] for p in prompts],
            modes=("greedy",))["greedy"]
    stats["dead_rows"] = dead_row_times(
        engine, dev, max(len(p) for p in prompts) + max_new)
    release_engine(engine, dev)
    del engine
    gc.collect()
    log(f"[moe] phase 25a {family}-{size}: {json.dumps(stats)}")
    if bad:
        raise AssertionError("phase 25a: " + "; ".join(bad))
    return stats


def grouped_fused_check(engine, dev, max_new=32, k=8, n_req=8,
                        prompt_len=24) -> dict:
    """25a's grouped form in the fused loops: a twin of the capacity
    engine (the same weights, its own pools) with moe_grouped_dispatch
    serves ``n_req`` seeded prompts of ``prompt_len`` tokens (one prefill
    tick for both loops, so the ticks' shapes match) through generate()
    per tick, then generate_fused (K ``k``): a capturing run and a counted
    rerun, both giving generate()'s tokens; every replayed tick launches
    3L grouped GEMMs on the tensor cores (L x (graph ticks + prefill
    dispatches) in all) and L decode_split paged calls. Reports decode ms
    a fused step beside the capacity form's."""
    c = engine.model.config
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, c.vocab_size, prompt_len).tolist()
               for _ in range(n_req)]
    g = twin_engine(engine, moe_grouped_dispatch=True)
    gmm = grouped_mm_counter()
    per_tick, _, _ = serve(g, prompts, max_new, dev)
    first, _ = serve_fused(g, prompts, max_new, dev, k)
    norms = reset_counts(c)
    reset_norms(gmm)
    ticks = count_ticks(g)
    g.reset_serving_metrics()
    captured = len(g.graph_captures)
    try:
        outs, run = serve_fused(g, prompts, max_new, dev, k)
    finally:
        uncount_ticks(g)
    counts = read_counts(norms)
    m = g.serving_metrics()
    prefill_dispatches = m["host_dispatches"] - m["fused_dispatches"]
    graph_ticks = sum(ticks) + len(g.graph_captures) - captured
    layers = c.num_layers
    rec = dict(requests=n_req, prompt_tokens=prompt_len, new_tokens=max_new,
               k=k, tokens_equal_generate=outs == per_tick,
               capturing_run_equal=first == per_tick,
               decode_ms_per_step=1e3 * (run["wall_s"] - run["prefill_s"])
               / max(run["steps"], 1),
               graph_ticks=graph_ticks, prefill_dispatches=prefill_dispatches,
               grouped_mm_launches=gmm.launches,
               grouped_mm_launches_by_variant=dict(gmm.variant_launches),
               graphs_captured=len(g.graph_captures),
               capture_ms_total=sum(x["capture_ms"]
                                    for x in g.graph_captures), **counts)
    release_engine(g, dev)
    del g
    gc.collect()
    log(f"[moe] phase 25a grouped fused: {json.dumps(rec)}")
    want = 3 * layers * (graph_ticks + prefill_dispatches)
    bad = not (rec["tokens_equal_generate"] and rec["capturing_run_equal"])
    if dev.type == "cuda":
        bad |= (gmm.launches != want or set(gmm.variant_launches)
                != {"tensor_cores"} or counts["launches_by_variant"].get(
                    "decode_split") != layers * graph_ticks)
    if bad:
        raise AssertionError(f"phase 25a grouped fused: {rec}, want "
                             f"{want} grouped_mm launches")
    return rec


def dead_row_times(engine, dev, context: int, rows=8, iters=20) -> dict:
    """The pad pass of a capacity MoE tick (``paged.dead_row_attention``)
    at 25a's decode shapes on the engine's pool: ``rows`` rows of
    ``context`` tokens, every row holding a pad slot (its pages read) and
    none (a fused tick with every row live: no row's pages read), a tick's
    worth (one call a layer) captured in a CUDA graph as the fused loop
    runs it, the median of event-timed replays (on the CPU, rehearsal
    only, one call's host time x layers)."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import paged
    layers = engine.model.config.num_layers
    pool = engine.pools["v"][0]
    nb, bs, hkv, d = pool.shape
    width = -(-context // bs)
    tables = (torch.arange(rows * width, device=dev) % nb).reshape(
        rows, width).to(torch.int32)
    pos0 = torch.full((rows,), context, dtype=torch.int32, device=dev)
    v_new = torch.randn(rows, 1, hkv, d, dtype=pool.dtype, device=dev)
    out = dict(rows=rows, context=context, layers=layers,
               v_page_bytes_a_layer=rows * width * bs * hkv * d
               * pool.element_size())
    for name, pads in (("every_row_padded", True), ("no_row_padded", False)):
        mask = torch.full((rows,), pads, device=dev)

        def tick():
            for _ in range(layers):
                paged.dead_row_attention(v_new, pool, tables, pos0,
                                         rows=mask)
        if dev.type != "cuda":
            out[f"{name}_ms_a_tick"] = time_ms(tick, dev, 2)
            continue
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tick()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            tick()
        out[f"{name}_ms_a_tick"] = time_ms(graph.replay, dev, iters)
        del graph
    return out


def moe_v1_main(dev, family="mixtral", size="8x7b", model_over=None,
                length=V1_PROMPTS["length"]):
    """Phase 25b: init_inference(<family> ``size``, bf16,
    quantize_moe_experts) on seeded weights, built a layer at a time (no
    float expert stack exists on the card), then phase 20e's traffic (8
    prompts of ``length``, 32 greedy tokens) in the capacity form and in
    the grouped form (moe_grouped_dispatch, a second engine over the same
    int8 tree): ms a step, generated tokens/s, the capture (by an
    untimed :func:`v1_warm`; :func:`v1_graph_record`: the decode steps
    replay one graph in either form), the weights' bytes (the routed
    experts' apart) and the build's peak; every norm launch a row
    kernel, 2L + 1 a forward; the grouped form 3L grouped GEMM launches a
    forward on the tensor cores."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_class
    from deepspeed_tpu_torch.models.transformer import deferred_weights
    with deferred_weights():
        model = get_model_class(family)(size=size, device=dev,
                                        **(model_over or {}))
    c = model.config
    cfg = {"dtype": "bf16", "max_out_tokens": 1024,
           "quantize_moe_experts": True}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = ds.init_inference(model, config=cfg)
    sync(dev)
    rec = dict(model=f"{family}-{size}", layers=c.num_layers,
               params=c.num_params(), active_params=c.num_active_params(),
               build_s=time.perf_counter() - t,
               build_peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                               if dev.type == "cuda" else None),
               weight_bytes=weight_bytes(model.params),
               expert_bytes=weight_bytes({
                   n: p for n, p in model.params.items()
                   if n.startswith("layers/experts/")}))
    prompts = v1_prompts_of(c.vocab_size, length)
    forwards = V1_PROMPTS["max_new"]
    outs = {}
    gmm = grouped_mm_counter()
    for form in ("capacity", "grouped"):
        if form == "grouped":
            eng = ds.init_inference(model, config=dict(
                cfg, moe_grouped_dispatch=True), params=dict(model.params))
        v1_warm(eng, prompts, forwards)
        norms = norm_counter(c)
        reset_norms(norms)
        reset_norms(gmm)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sync(dev)
        t = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=forwards)
        sync(dev)
        wall = time.perf_counter() - t
        outs[form] = out[:, length:].tolist()
        graph = v1_graph_record(eng, dev, f"25b {form}", warmed=True)
        by_variant = check_norm_variants(norms, dev, f"25b {form}")
        rec[form] = dict(
            generate_s=wall, ms_per_step=1e3 * wall / forwards,
            generated_tokens_per_s=len(prompts) * forwards / wall,
            serve_peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                            if dev.type == "cuda" else None),
            norm_launches=norms.launches,
            norm_launches_by_variant=by_variant,
            grouped_mm_launches=gmm.launches,
            grouped_mm_launches_by_variant=dict(gmm.variant_launches),
            **graph)
        # the grouped form: three grouped GEMMs a layer a forward, every
        # one on the tensor cores; the capacity form none
        launched = graph["forwards_launched"]
        want_gmm = 3 * c.num_layers * launched if form == "grouped" else 0
        if dev.type == "cuda" and (
                norms.launches != norms_per_forward(c) * launched
                or gmm.launches != want_gmm or set(gmm.variant_launches)
                - {"tensor_cores"}):
            raise AssertionError(
                f"phase 25b {form}: {norms.launches} norm launches, want "
                f"{norms_per_forward(c)} x {launched}; grouped_mm "
                f"{dict(gmm.variant_launches)}, want {want_gmm} "
                f"tensor_cores")
        if dev.type == "cuda":
            # where a step's time goes: 4 tokens from 16-token prompts
            # (their graph captured by a first call outside the trace)
            short = [p[:16] for p in prompts]
            eng.generate(short, max_new_tokens=4)
            rec[form]["profile"] = profile_window(
                f"moe_v1_{form}", lambda: eng.generate(
                    short, max_new_tokens=4), 4)[1]
        del eng
        gc.collect()
    rec["greedy_agreement_grouped_vs_capacity"] = agreement(
        outs["grouped"], outs["capacity"])
    ok = all(0 <= t < c.vocab_size for o in outs.values() for r in o
             for t in r)
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[moe] phase 25b v1: {json.dumps(rec)}")
    if not ok:
        raise AssertionError("phase 25b: a token out of range")
    return rec


def moe_train_probe(engine, batch) -> dict:
    """Phase 25c's router figures on the trained model: the aux loss of a
    forward over ``batch`` and each layer's drop fraction."""
    import torch
    model = engine.module
    out = {}

    def forward():
        with torch.no_grad():
            out["aux"] = float(model.final_hidden(batch[0],
                                                  return_aux=True)[1])

    per_forward = drop_fractions(model, forward)
    return dict(aux_loss=out["aux"], drop_fraction=per_forward[0])


def moe_fp32_tree(family, size, layers, dev, seed=MOE_SEED,
                  model_over=None) -> dict:
    """The family's widths cut to ``layers``: a flat fp32 tree drawn from a
    seeded generator on ``dev`` (the card, fast) and moved to the CPU:
    the weights both sides of 25d serve and train from."""
    import torch
    from deepspeed_tpu_torch.models import get_model_class
    with torch.no_grad():
        m = get_model_class(family)(size=size, num_layers=layers,
                                    device="meta", **(model_over or {}))
        m.device = dev
        gen = torch.Generator(device=dev).manual_seed(seed)
        return {n: m.draw(n, gen).cpu() for n in m._init_spec}


def moe_fp32_engines(dev, family, size, tree, prompts, layers,
                     fp32=MOE_FP32):
    """25d's serving on ``dev``: build_engine fp32 over ``tree`` in the
    capacity form (the first prefill's logits, generate() and
    generate_fused's tokens), the grouped form and with int8 experts (the
    logits and generate()'s tokens). Returns them on the CPU."""
    from deepspeed_tpu_torch.inference.v2 import build_engine
    cfg = {"dtype": "float32", "kv_block_size": 64, "num_kv_blocks": 64,
           "max_chunk_size": 256, "max_ragged_sequence_count": 8}
    out = {}
    for form, over in (("capacity", {}),
                       ("grouped", {"moe_grouped_dispatch": True}),
                       ("int8_experts", {"quantize_moe_experts": True})):
        v2 = build_engine(family, size, dict(cfg, **over), params=tree,
                          device=dev, num_layers=layers,
                          **(fp32["model_over"] or {}))
        rec = dict(logits=v2.put([90_000], [prompts[0]])[0].float().cpu())
        v2.flush(90_000)
        rec["tokens"] = v2.generate(prompts, max_new_tokens=fp32["max_new"])
        if form == "int8_experts":
            rec["codes"] = {n: hashlib.sha256(
                p.detach().cpu().numpy().tobytes()).hexdigest()
                for n, p in v2.model.params.items()
                if n.endswith(("_q", "_s"))}
        if form in ("capacity", "grouped"):
            rec["fused"] = v2.generate_fused(
                prompts, max_new_tokens=fp32["max_new"], k_steps=fp32["k"])
        release_engine(v2, dev)
        del v2
        out[form] = rec
    gc.collect()
    return out


def moe_fp32_prompts(family, size, fp32=MOE_FP32) -> list:
    """25d's seeded prompts for ``family`` (its vocab)."""
    from deepspeed_tpu_torch.models import get_model_class
    vocab = get_model_class(family)(size=size, device="meta").config.vocab_size
    rng = np.random.default_rng(12)
    lens = rng.integers(*fp32["lengths"], fp32["n_req"])
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def moe_fp32_layers(family, fp32=MOE_FP32) -> int:
    return fp32.get("family_layers", {}).get(family, fp32["layers"])


def moe_train_init(tree, train=MOE_TRAIN_FP32) -> dict:
    """The training check's initial master: the tree cut to
    ``train["layers"]``, cloned (the CPU engine trains its master in
    place)."""
    return {n: (t[:train["layers"]] if n.startswith("layers/") else t)
            .clone() for n, t in tree.items()}


def moe_fp32_cpu_sides(pool, dev, fp32=MOE_FP32, train=MOE_TRAIN_FP32):
    """The CPU halves of phase 25d, queued on the worker ``pool`` behind
    phases 21's and 22's (beside phase 2's nvcc and phase 3; the run
    waits for them before phase 4): each family's fp32 tree drawn on the card now (it
    is idle before the build) and moved to the host, then futures of its
    serving (:func:`moe_fp32_engines` on the CPU) and, for ``train``'s
    families, its training (:func:`fp32_engine_run`, the record's
    ``init`` dropped: the card half draws the tree again, bit for bit).
    The trees go when their tasks have run."""
    import torch
    cpu = torch.device("cpu")
    futures = {}
    for family, size in fp32["families"]:
        layers = moe_fp32_layers(family, fp32)
        tree = moe_fp32_tree(family, size, layers, dev,
                             model_over=fp32["model_over"])
        prompts = moe_fp32_prompts(family, size, fp32)
        futures[(family, "serving")] = pool.submit(
            moe_fp32_engines, cpu, family, size, tree, prompts, layers,
            fp32)
        if (family, size) in train["families"]:
            args = (family, size, train["layers"], train["rows"],
                    train["seq"], train["steps"], train["lr"])

            def train_side(init=moe_train_init(tree, train), args=args):
                run = fp32_engine_run(cpu, *args, init=init,
                                      over=fp32["model_over"])
                run.pop("init")
                return run

            futures[(family, "train")] = pool.submit(train_side)
        del tree
    return futures


def moe_fp32_main(dev, fp32=MOE_FP32, train=MOE_TRAIN_FP32, cpu_sides=None):
    """Phase 25d (TF32 off): each family at full width, its seeded fp32 tree
    (:func:`moe_fp32_tree`), the card's half (the kernels) against the
    CPU's (``cpu_sides``: :func:`moe_fp32_cpu_sides`'s futures, run
    beside the build; None: run now, on a worker thread while the card's
    half runs): the first prefill's logits
    within 1e-5 of their largest in the capacity form, the grouped form
    and with int8 experts (their codes and scales bit-equal), and their
    greedy tokens equal; the card's generate_fused tokens (capacity and
    grouped form) equal to the CPU's and, the prompts prefilled in one
    tick, to its own generate()'s; for the families ``train`` names,
    training at train_family_fp32's bounds (losses 1e-4 relative, the
    first step's grads 1e-4 of their largest, the params 1e-3 of the norm
    of their change, lm_head reported apart)."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    rec = {}
    pool = None
    if cpu_sides is None:
        pool = ThreadPoolExecutor(max_workers=1)
        cpu_sides = moe_fp32_cpu_sides(pool, dev, fp32, train)
    for family, size in fp32["families"]:
        layers = moe_fp32_layers(family, fp32)
        tree = moe_fp32_tree(family, size, layers, dev,
                             model_over=fp32["model_over"])
        prompts = moe_fp32_prompts(family, size, fp32)
        t = time.perf_counter()
        with RssPeak(interval=0.02) as rss:
            card = dict(serving=moe_fp32_engines(dev, family, size, tree,
                                                 prompts, layers, fp32))
            card_s = time.perf_counter() - t
            cpu = dict(serving=cpu_sides.pop((family, "serving")).result())
        rec[f"host_rss_peak_gib_{family}_serving"] = rss.peak / 2**30
        rec[f"seconds_{family}_serving"] = dict(
            card=card_s, both=time.perf_counter() - t)
        if (family, size) in train["families"]:
            init = moe_train_init(tree, train)
            del tree
            gc.collect()
            t = time.perf_counter()
            with RssPeak(interval=0.02) as rss:
                card["train"] = fp32_engine_run(
                    dev, family, size, train["layers"], train["rows"],
                    train["seq"], train["steps"], train["lr"], init=init,
                    over=fp32["model_over"], host=False)
                cpu["train"] = cpu_sides.pop((family, "train")).result()
            rec[f"host_rss_peak_gib_{family}_train"] = rss.peak / 2**30
            rec[f"seconds_{family}_train"] = time.perf_counter() - t
            del init
        else:
            del tree
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        r = {"layers": layers, "requests": len(prompts),
             "new_tokens": fp32["max_new"]}
        for form, got in card["serving"].items():
            ref = cpu["serving"][form]
            r[form] = dict(
                logits_err_rel_to_max=float(
                    (got["logits"] - ref["logits"]).abs().max()
                    / ref["logits"].abs().max()),
                card_equals_cpu=got["tokens"] == ref["tokens"])
        r["int8_codes_and_scales_bit_equal"] = (
            card["serving"]["int8_experts"]["codes"]
            == cpu["serving"]["int8_experts"]["codes"])
        r["fused_card_equals_cpu"] = all(
            card["serving"][f]["fused"] == cpu["serving"][f]["fused"]
            for f in ("capacity", "grouped"))
        r["fused_equals_generate"] = all(
            card["serving"][f]["fused"] == card["serving"][f]["tokens"]
            for f in ("capacity", "grouped"))
        r["tokens"] = {f: v["tokens"] for f, v in card["serving"].items()}
        rec[f"{family}-{size}"] = r
        log(f"[moe] phase 25d {family}-{size}: {json.dumps(r)}")
        if (any(r[f]["logits_err_rel_to_max"] > 1e-5
                or not r[f]["card_equals_cpu"]
                for f in ("capacity", "grouped", "int8_experts"))
                or not r["int8_codes_and_scales_bit_equal"]
                or not r["fused_card_equals_cpu"]
                or not r["fused_equals_generate"]):
            raise AssertionError(f"phase 25d {family}-{size}: {r}")
        if "train" not in card:
            continue
        a, b = card["train"], cpu["train"]

        def rel(names):
            err = sum(float((a["change"][n] - b["change"][n].to(dev))
                            .pow(2).sum()) for n in names)
            moved = sum(float(b["change"][n].pow(2).sum()) for n in names)
            return (err / moved) ** 0.5

        names = list(b["change"])
        held = [n for n in names if n not in SIGN_FLIP_TENSORS]
        r["train"] = dict(
            layers=train["layers"], rows=train["rows"], seq=train["seq"],
            lr=train["lr"], loss_card=a["losses"], loss_cpu=b["losses"],
            loss_max_rel_err=max(abs(x - y) / abs(y) for x, y in
                                 zip(a["losses"], b["losses"])),
            grad_max_err_rel_to_max=float(
                (a["grads"] - b["grads"].to(dev)).abs().max()
                / b["grads"].abs().max()),
            params_err_rel_to_change=rel(names),
            params_err_rel_to_change_held=rel(held))
        del card, cpu, a, b
        gc.collect()
        log(f"[moe] phase 25d {family}-{size} training: "
            f"{json.dumps(r['train'])}")
        t = r["train"]
        if (t["loss_max_rel_err"] > 1e-4
                or t["grad_max_err_rel_to_max"] > 1e-4
                or t["params_err_rel_to_change_held"] > 1e-3):
            raise AssertionError(f"phase 25d {family}-{size}: {r}")
    if pool is not None:
        pool.shutdown()
    rec["reduced"] = (
        f"depth {fp32['layers']} serving ({fp32.get('family_layers')} "
        f"apart: time); training {train['layers']} layer "
        f"of {[f'{f}-{s}' for f, s in train['families']]} only (host "
        f"memory and time)")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def moe_main(dev, serving=MOE_SERVING, v1=MOE_V1, train=MOE_TRAIN,
             fp32=MOE_FP32, train_fp32=MOE_TRAIN_FP32, serve_kw=None,
             train_kw=None, v1_length=V1_PROMPTS["length"], fp32_cpu=None):
    """Phase 25 (a-d above; a CPU rehearsal shrinks every part);
    ``fp32_cpu``: 25d's CPU halves (:func:`moe_fp32_cpu_sides`)."""
    import torch
    t0 = time.perf_counter()
    rec = {"host_rss_gib_at_start": RssPeak._rss() / 2**30,
           "host_memory_gib": host_memory_gib()}
    # freed heap the earlier phases left with the C allocator goes back
    # to the system before the phase's large host tensors
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass
    rec["host_rss_gib_after_trim"] = RssPeak._rss() / 2**30
    seconds = {}

    def part(name, fn):
        t = time.perf_counter()
        with RssPeak(interval=0.02) as rss:
            rec[name] = fn()
        seconds[name] = time.perf_counter() - t
        rec[name]["host_rss_peak_gib"] = rss.peak / 2**30
    part("serving", lambda: moe_serving_main(dev, **serving,
                                             serve_kw=serve_kw))
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    part("v1", lambda: moe_v1_main(dev, **v1, length=v1_length))
    part("train", lambda: train_family(
        dev, train["family"], train["size"], train["layers"],
        probe=moe_train_probe, **(train_kw or {})))
    rec["train"]["reduced"] = f"depth {train['layers']} (memory)"
    part("fp32", lambda: moe_fp32_main(dev, fp32, train_fp32, fp32_cpu))
    rec["seconds_by_part"] = seconds
    rec["seconds"] = time.perf_counter() - t0
    log(f"[moe] phase 25: {rec['seconds']:.1f} s")
    return rec

# ------------------------------------------- phase 3: the grouped GEMM
# ops/grouped_gemm.py grouped_mm (csrc/grouped_gemm.cu), the grouped MoE
# form's expert products: no Pallas counterpart (XLA's lax.ragged_dot,
# deepspeed_tpu/moe/sharded_moe.py:170-177). Shapes: name -> (experts, K,
# N, top-k) of Mixtral-8x7B's and Qwen2-MoE a2.7b's routed experts (w_gate
# and w_up: d -> f; w_down: f -> d); rows = tokens x top-k, 8 tokens at a
# decode step, 8 x 256 at a prefill tick
GROUPED_SHAPES = {"mixtral_gate_up": (8, 4096, 14336, 2),
                  "mixtral_down": (8, 14336, 4096, 2),
                  "qwen2_moe_gate_up": (60, 2048, 1408, 4),
                  "qwen2_moe_down": (60, 1408, 2048, 4)}
GROUPED_TOKENS = {"decode": 8, "prefill": 2048}
GROUPED_EMPTY = 3      # the expert given no rows in every case
GROUPED_MAIN = ("mixtral_gate_up", "decode", "bfloat16")  # the 25b path
GROUPED_TOL = dict(TOL, float16=1e-2)


def grouped_case(dev, dtype, experts, k, n, top, tokens, seed=0):
    """One grouped_mm call: ``tokens * top`` rows sorted by a seeded
    expert id, expert GROUPED_EMPTY left empty; x ~ N(0, 1), w ~ N(0,
    1/K) in ``dtype`` on ``dev``; the offsets from the sorted ids as the
    MoE layer makes them (``group_offsets``)."""
    import torch
    from deepspeed_tpu_torch.ops.grouped_gemm import group_offsets
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, experts - 1, tokens * top)
    ids[ids >= GROUPED_EMPTY] += 1
    ids = torch.from_numpy(np.sort(ids)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(len(ids), k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(experts, k, n, generator=gen, device=dev)
         / k ** 0.5).to(dtype)
    return x, w, group_offsets(ids, experts)


def grouped_bound(x, w, offsets) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, operations) of one call: x read
    once, the weights of every expert that holds a row read once, the
    output written once; 2 R K N operations at the dtype's peak."""
    import torch
    rows, k = x.shape
    n = w.shape[2]
    sizes = torch.diff(offsets.cpu().long(), prepend=torch.zeros(1).long())
    active = int((sizes > 0).sum())
    item = x.element_size()
    nbytes = item * (rows * k + active * k * n + rows * n) + 4 * len(sizes)
    flops = 2 * rows * k * n
    rate = FP32_FLOPS if x.dtype == torch.float32 else BF16_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def grouped_library(x, w, offsets):
    """The yardstick: one ``torch._grouped_mm`` call on the same inputs
    (bf16 only: PyTorch's grouped GEMM takes no other dtype here); None
    and the reason where the installed PyTorch has none or refuses the
    inputs. Timed only, never called by the port."""
    import torch
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or x.dtype != torch.bfloat16:
        return None, ("no torch._grouped_mm" if fn is None
                      else "torch._grouped_mm is bf16 only")
    try:
        fn(x, w, offs=offsets)
        return (lambda: fn(x, w, offs=offsets)), "torch._grouped_mm"
    except RuntimeError as e:
        return None, f"torch._grouped_mm refused: {str(e)[:160]}"


def grouped_mm_checks(dev, flush=None, iters=20):
    """Phase 3's grouped GEMM: the kernel against its plain version (a
    product per expert) in bf16, fp16 and fp32 at every shape of
    GROUPED_SHAPES, decode and prefill rows, one expert empty: max
    |kernel - plain| / max |plain| within GROUPED_TOL, the variant each
    dtype takes, a rerun bit for bit; bf16 timed beside the plain
    version, ``torch._grouped_mm`` where it takes the inputs and the
    bound. Returns (max |kernel - plain| and its ratio to max |plain| by
    (dtype, shape, rows), records of the timed bf16 calls)."""
    import torch
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    errs, times = {}, {}
    for dtype_name, tol in GROUPED_TOL.items():
        dtype = getattr(torch, dtype_name)
        for name, (e, k, n, top) in GROUPED_SHAPES.items():
            for rows_name, tokens in GROUPED_TOKENS.items():
                x, w, offs = grouped_case(dev, dtype, e, k, n, top, tokens)
                got = gg.grouped_mm(x, w, offs)
                ref = gg.grouped_mm_plain(x, w, offs)
                again = gg.grouped_mm(x, w, offs)
                diff = float((got.float() - ref.float()).abs().max())
                err = diff / float(ref.float().abs().max())
                key = (dtype_name, name, rows_name)
                errs[key] = dict(max_abs_err=diff, max_rel_err=err)
                variant = gg.kernel_variant(dtype)
                log(f"[kernel] grouped_mm {name} {rows_name} {dtype_name} "
                    f"rows {x.shape[0]}: max|err| / max|plain| {err:.3e} "
                    f"(tol {tol:g}), {variant}")
                if err > tol or (dev.type == "cuda" and not torch.equal(
                        got, again)):
                    raise AssertionError(
                        f"grouped_mm kernel disagrees with its plain "
                        f"version or its rerun: {key} {err:.3e}")
                if dtype_name != "bfloat16":
                    continue
                bound, bound_by, nbytes, flops = grouped_bound(x, w, offs)
                lib, lib_note = grouped_library(x, w, offs)
                rec = dict(
                    rows=x.shape[0], experts=e, k=k, n=n, top_k=top,
                    empty_expert=GROUPED_EMPTY, variant=variant,
                    ms=time_ms(lambda: gg.grouped_mm(x, w, offs), dev,
                               iters, flush),
                    plain_ms=time_ms(lambda: gg.grouped_mm_plain(
                        x, w, offs), dev, max(iters // 4, 2), flush),
                    library_ms=(time_ms(lib, dev, iters, flush)
                                if lib else None),
                    library=lib_note, bound_ms=bound, bound_by=bound_by,
                    bit_identical_rerun=bool(torch.equal(got, again)))
                if lib:
                    rec["library_max_rel_err"] = float(
                        (lib().float() - ref.float()).abs().max()
                        / ref.float().abs().max())
                rec.update(tflops=flops / rec["ms"] / 1e9,
                           gb_per_s=nbytes / rec["ms"] / 1e6,
                           bound_share=bound / rec["ms"],
                           x_library=(rec["ms"] / rec["library_ms"]
                                      if lib else None))
                times[f"{name}_{rows_name}"] = rec
                log(f"[kernel] grouped_mm {name} {rows_name} times: "
                    f"{json.dumps(rec)}")
                del x, w, got, ref, again
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return errs, times


# ----------------------------------------------------------- phase 26
# Checkpoints on the card (runtime/checkpointing.py, checkpoint_engine.py,
# checkpoint/): the training main path's GPT-2 125M (phase 6's config,
# 24 x 1024 tokens) (a) saved and resumed bit for bit, (b) saved by the
# async engine while it trains on, (c) Path T's Lion run resumed, (d)
# converted (ds_to_universal, zero_to_fp32, save_16bit_model), (e) served
# from its directory by both inference engines, (f) moved between the
# card and the CPU; (g) Path Z's two ranks' checkpoint (written in phase
# 13) loaded at W = 1.
CKPT_STEPS = 3
CKPT_PATH_T_STEPS = 2
CKPT_SEED = 4321                 # the engines that load: another init
CKPT_ROOT = os.path.join(os.path.dirname(os.path.realpath(__file__)),
                         "build", "phase26")
PATH_Z_CKPT = os.path.join(CKPT_ROOT, "path_z")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def master_digest(master: dict) -> str:
    """sha256 over a master state dict's names and bytes, in name
    order."""
    import torch
    h = hashlib.sha256()
    for name in sorted(master):
        h.update(name.encode())
        h.update(master[name].detach().contiguous().cpu().view(-1)
                 .view(torch.uint8).numpy())
    return h.hexdigest()


def train_state(engine) -> dict:
    """Copies of everything a resume restores, on the engine's device:
    the flat master, each optimizer buffer, the step and the loss
    scale."""
    out = {"master": engine._master.clone(), "step": engine._step.clone()}
    out.update({f"opt/{k}": v.clone() for k, v in engine.opt_state.items()})
    out.update({f"loss_scale/{f}": t.clone() for f, t in
                zip(engine._loss_scale._fields, engine._loss_scale)})
    return out


def states_equal(a: dict, b: dict) -> bool:
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def train_counters():
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import norms as N
    from deepspeed_tpu_torch.ops.fused_optimizers import (fused_adam_step,
                                                          fused_lion_step)
    return fa, N.layer_norm_kernel, fused_adam_step, fused_lion_step


def reset_train_counts() -> None:
    fa, ln, adam, lion = train_counters()
    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd):
        fn.launches = 0
        fn.variant_launches = {}
    fa.flash_attention_bwd.calls = 0
    adam.launches = lion.launches = 0
    reset_norms(ln)


def read_train_counts(dev, what: str) -> dict:
    fa, ln, adam, lion = train_counters()
    return {"flash_attention_fwd": dict(fa.flash_attention_fwd
                                        .variant_launches),
            "flash_attention_bwd": dict(fa.flash_attention_bwd
                                        .variant_launches),
            "layer_norm": check_norm_variants(ln, dev, what),
            "fused_adam": adam.launches, "fused_lion": lion.launches}


def want_train_counts(c, micro_batches: int, adam: int, lion: int) -> dict:
    """The launches of ``micro_batches`` bf16 GPT-2 micro-batches under
    segments (phase 6's arithmetic): flash all wgmma, the norms warp_row."""
    layers = c.num_layers * micro_batches
    return {"flash_attention_fwd": {"wgmma": layers},
            "flash_attention_bwd": {"wgmma": 2 * layers},
            "layer_norm": {"warp_row": norm_launches_per_micro(c)
                           * micro_batches},
            "fused_adam": adam, "fused_lion": lion}


def ckpt_engine(dev, size, config, model_over, seed):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    model = GPT2(size=size, device=dev, **model_over)
    return ds.initialize(model=model, config=dict(config, seed=seed))[0]


def timed(fn, dev):
    """(fn's result, seconds to its end on the device, the host's RSS over
    it: {"peak_gib", "rise_gib"} over the RSS at its start)."""
    sync(dev)
    t = time.perf_counter()
    with RssPeak(interval=0.005) as rss:
        out = fn()
        sync(dev)
    return out, time.perf_counter() - t, {
        "peak_gib": rss.peak / 2**30,
        "rise_gib": (rss.peak - rss.base) / 2**30}


def ckpt_resume(dev, root, size, seq, steps):
    """26a: engine A trains ``steps`` steps, saves (sync), trains
    ``steps`` more; engine B, from another seed, loads A's checkpoint and
    trains the same steps: losses, master, moments, step and loss scale
    bit for bit. Returns the record, A, B and the saved state."""
    over = dict(vocab_size=50304, remat_policy="segments", attn_impl="flash")
    a = ckpt_engine(dev, size, TRAIN_CONFIG, over, 1234)
    c = a.module.config
    batches = [train_batch_of(dev, c.vocab_size, a.train_batch_size_, seq,
                              seed=26 + i) for i in range(2 * steps)]
    reset_train_counts()
    for b in batches[:steps]:
        a.train_batch(b)
    path = os.path.join(root, "main")
    free = shutil.disk_usage(os.path.dirname(root)).free
    _, save_s, save_rss = timed(lambda: a.save_checkpoint(path), dev)
    nbytes = dir_bytes(path)
    saved = train_state(a)
    ref = [float(a.train_batch(b)) for b in batches[steps:]]
    b_eng = ckpt_engine(dev, size, dict(TRAIN_CONFIG, checkpoint={
        "async_save": True}), over, CKPT_SEED)
    _, load_s, load_rss = timed(lambda: b_eng.load_checkpoint(path), dev)
    loaded_equal = states_equal(train_state(b_eng), saved)
    got = [float(b_eng.train_batch(b)) for b in batches[steps:]]
    counts = read_train_counts(dev, "26a")
    want = want_train_counts(c, 3 * steps, 3 * steps, 0)
    rec = dict(model=f"gpt2-{size} vocab {c.vocab_size}",
               params=c.num_params(), batch=a.train_batch_size_, seq=seq,
               steps=steps, disk_free_gib_before=free / 2**30,
               bytes_on_disk=nbytes, save_s=save_s,
               save_gb_per_s=nbytes / save_s / 1e9,
               save_host_rss=save_rss, load_s=load_s,
               load_gb_per_s=nbytes / load_s / 1e9,
               load_host_rss=load_rss,
               loaded_state_bit_equal=loaded_equal, losses=ref,
               resumed_losses=got,
               losses_bit_equal=got == ref,
               state_bit_equal=states_equal(train_state(b_eng),
                                            train_state(a)),
               launches=counts, launches_want=want)
    log(f"[ckpt] 26a resume: {json.dumps(rec)}")
    bad = [k for k in ("loaded_state_bit_equal", "losses_bit_equal",
                       "state_bit_equal") if not rec[k]]
    if dev.type == "cuda" and counts != want:
        bad.append(f"launches {counts} != {want}")
    if bad:
        raise AssertionError(f"phase 26a: {bad}: {rec}")
    del batches
    return rec, a, b_eng, saved


def ckpt_async(dev, engine, root, seq):
    """26b: the async engine: a first save and commit (the pinned
    buffer's allocation), a step without a write in flight, a save that
    returns once the state is on the host, a step while the write runs,
    ``latest`` unchanged until the commit, the commit."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine import \
        AsyncCheckpointEngine
    c = engine.module.config
    batch = train_batch_of(dev, c.vocab_size, engine.train_batch_size_,
                           seq, seed=40)
    path = os.path.join(root, "async")
    latest = os.path.join(path, "latest")

    def read_latest():
        with open(latest) as f:
            return f.read()

    _, first_save_s, _ = timed(lambda: engine.save_checkpoint(path), dev)
    ce = engine.checkpoint_engine
    first = f"global_step{engine.global_steps}"
    _, first_commit_s, _ = timed(lambda: ce.commit(first), dev)
    _, plain_step_s, _ = timed(lambda: engine.train_batch(batch), dev)
    tag = f"global_step{engine.global_steps}"
    _, block_s, rss = timed(lambda: engine.save_checkpoint(path), dev)
    in_flight = ce._thread is not None and ce._thread.is_alive()
    latest_after_save = read_latest()
    _, overlap_step_s, _ = timed(lambda: engine.train_batch(batch), dev)
    still_in_flight = ce._thread is not None and ce._thread.is_alive()
    latest_before_commit = read_latest()
    _, commit_s, _ = timed(lambda: ce.commit(tag), dev)
    rec = dict(engine=type(ce).__name__, first_save_s=first_save_s,
               first_commit_s=first_commit_s, save_blocking_s=block_s,
               save_host_rss=rss, step_s_without_write=plain_step_s,
               step_s_with_write_in_flight=overlap_step_s,
               write_in_flight_after_save=in_flight,
               write_in_flight_after_step=still_in_flight,
               commit_s=commit_s, latest_after_save=latest_after_save,
               latest_before_commit=latest_before_commit,
               latest_after_commit=read_latest(),
               bytes_on_disk=dir_bytes(os.path.join(path, tag)))
    log(f"[ckpt] 26b async: {json.dumps(rec)}")
    ok = (isinstance(ce, AsyncCheckpointEngine)
          and latest_after_save == latest_before_commit == first
          and rec["latest_after_commit"] == tag)
    shutil.rmtree(path)
    if not ok:
        raise AssertionError(f"phase 26b: {rec}")
    return rec


def ckpt_path_t(dev, root, size, seq, steps):
    """26c: Path T (Lion, GA 2, loss_chunk 256, the forward/backward/step
    loop) saved after ``steps`` steps and resumed by an engine from
    another seed: the next ``steps`` steps' losses and the state bit for
    bit; Lion counted."""
    a = ckpt_engine(dev, size, PATH_T_CONFIG, PATH_T_MODEL, 1234)
    c = a.module.config
    ga = a.gradient_accumulation_steps_
    batches = [train_batch_of(dev, c.vocab_size, a.train_batch_size_, seq,
                              seed=50 + i) for i in range(2 * steps)]
    reset_train_counts()
    for b in batches[:steps]:
        triple_step(a, b, ga)
    path = os.path.join(root, "path_t")
    _, save_s, _ = timed(lambda: a.save_checkpoint(path), dev)
    nbytes = dir_bytes(path)
    ref = [float(triple_step(a, b, ga)) for b in batches[steps:]]
    b_eng = ckpt_engine(dev, size, PATH_T_CONFIG, PATH_T_MODEL, CKPT_SEED)
    _, load_s, _ = timed(lambda: b_eng.load_checkpoint(path), dev)
    got = [float(triple_step(b_eng, b, ga)) for b in batches[steps:]]
    counts = read_train_counts(dev, "26c")
    want = want_train_counts(c, 3 * steps * ga, 0, 3 * steps)
    rec = dict(model=f"gpt2-{size} loss_chunk {c.loss_chunk}", ga=ga,
               optimizer="Lion fused_kernel", steps=steps,
               bytes_on_disk=nbytes, save_s=save_s, load_s=load_s,
               losses=ref, resumed_losses=got, losses_bit_equal=got == ref,
               state_bit_equal=states_equal(train_state(a),
                                            train_state(b_eng)),
               skipped_steps=b_eng.skipped_steps, launches=counts,
               launches_want=want)
    log(f"[ckpt] 26c Path T: {json.dumps(rec)}")
    del a, b_eng
    shutil.rmtree(path)
    bad = [k for k in ("losses_bit_equal", "state_bit_equal") if not rec[k]]
    if dev.type == "cuda" and counts != want:
        bad.append(f"launches {counts} != {want}")
    if bad:
        raise AssertionError(f"phase 26c: {bad}: {rec}")
    return rec


def ckpt_convert(dev, root, size, saved):
    """26d: ds_to_universal of 26a's checkpoint, then
    load_universal_checkpoint into a fresh engine: master, moments and
    step bit for bit (the loss scale is not carried, as in JAX); the
    zero_to_fp32 state dict against the saved master; save_16bit_model's
    names. Returns the record and the engine (it holds the saved
    state)."""
    import torch
    from deepspeed_tpu_torch.checkpoint import (
        ds_to_universal, flatten_with_names,
        get_fp32_state_dict_from_zero_checkpoint)
    src, uni = os.path.join(root, "main"), os.path.join(root, "universal")
    _, uni_s, uni_rss = timed(lambda: ds_to_universal(src, uni), dev)
    uni_bytes = dir_bytes(uni)
    over = dict(vocab_size=50304, remat_policy="segments", attn_impl="flash")
    eng = ckpt_engine(dev, size, dict(TRAIN_CONFIG, checkpoint={
        "load_universal": True}), over, CKPT_SEED + 1)
    _, load_s, load_rss = timed(lambda: eng.load_checkpoint(uni, tag="."),
                                dev)
    got = train_state(eng)
    moved = {k: v for k, v in saved.items() if not k.startswith(
        "loss_scale/")}
    universal_equal = states_equal({k: got[k] for k in moved}, moved)
    shutil.rmtree(uni)
    # the state dict's arrays map the files: read each into memory, as a
    # consumer of it would
    sd, fp32_s, fp32_rss = timed(lambda: {
        n: np.array(v) for n, v in
        get_fp32_state_dict_from_zero_checkpoint(src).items()}, dev)
    master = {n: v.cpu() for n, v in eng.master_state_dict().items()}
    fp32_equal = list(sd) == [n for n, _ in flatten_with_names(master)] \
        and all(torch.equal(torch.from_numpy(sd[n]), master[n]) for n in sd)
    del sd, master
    out16 = os.path.join(root, "16bit")
    _, save16_s, _ = timed(lambda: eng.save_16bit_model(out16), dev)
    with np.load(os.path.join(out16, "model_weights.npz")) as z:
        names16 = list(z.files)
    names_equal = names16 == [n for n, _ in flatten_with_names(
        eng.module_state_dict())]
    shutil.rmtree(out16)
    rec = dict(ds_to_universal_s=uni_s, universal_bytes=uni_bytes,
               ds_to_universal_gb_per_s=uni_bytes / uni_s / 1e9,
               ds_to_universal_host_rss=uni_rss,
               load_universal_s=load_s, load_universal_host_rss=load_rss,
               universal_bit_equal=universal_equal,
               zero_to_fp32_s=fp32_s, zero_to_fp32_host_rss=fp32_rss,
               zero_to_fp32_bit_equal=fp32_equal, save_16bit_s=save16_s,
               save_16bit_names_equal=names_equal,
               loss_scale_carried=False)
    log(f"[ckpt] 26d conversion: {json.dumps(rec)}")
    bad = [k for k in ("universal_bit_equal", "zero_to_fp32_bit_equal",
                       "save_16bit_names_equal") if not rec[k]]
    if bad:
        raise AssertionError(f"phase 26d: {bad}: {rec}")
    return rec, eng


def ckpt_serving(dev, root, size, params, n_req=8, max_new=32,
                 lengths=(100, 701), engine_over=None):
    """26e: 26a's checkpoint directory served by build_engine (v2, its
    engine config's ``checkpoint``) and init_inference (v1, the config's
    ``checkpoint``) in bf16: 8 requests of 100-700 prompt tokens, 32
    greedy tokens; the tokens equal the same engines' built from
    ``params`` (the trained engine's gathered parameters); the paged and
    LayerNorm launches of the checkpoint-served engines counted; v1's
    decode steps graph replays (ms a step; a capture where a prompt's
    cache bucket is not the last one's, its ms inside ``generate_s``),
    and its graph's greedy and sampled tokens bit-equal to the same step
    run eagerly (:func:`v1_graph_vs_eager`)."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.inference.v2 import build_engine
    from deepspeed_tpu_torch.models import GPT2
    from deepspeed_tpu_torch.models.transformer import deferred_weights
    path = os.path.join(root, "main")
    cfg = dict(SERVING_CONFIG, **(engine_over or {}))
    _, prompts = serving_prompts(50304, n_req, lengths)
    rec = {}
    outs = {}
    for source in ("checkpoint", "params"):
        kw = ({"engine_config": dict(cfg, checkpoint=path)}
              if source == "checkpoint"
              else {"engine_config": cfg, "params": params})
        (eng, build_s, _) = timed(lambda: build_engine(
            "gpt2", size, device=dev, vocab_size=50304, **kw), dev)
        norms = reset_counts(eng.model.config)
        outs[source], wall, _ = serve(eng, prompts, max_new, dev)
        counts = read_counts(norms)
        check_variants(counts["launches_by_variant"], counts["launches"],
                       dev, f"26e v2 from {source}")
        check_norm_variants(norms, dev, f"26e v2 from {source}")
        rec[f"v2_{source}"] = dict(build_s=build_s, generate_s=wall,
                                   **counts)
        release_engine(eng, dev)
        del eng
    rec["v2_tokens_equal"] = outs["checkpoint"] == outs["params"]
    v1 = {}
    for source in ("checkpoint", "params"):
        with deferred_weights():
            model = GPT2(size=size, vocab_size=50304, device=dev)
        config = {"dtype": "bf16", "max_out_tokens": 1024}
        kw = {}
        if source == "checkpoint":
            config["checkpoint"] = path
        else:
            kw["params"] = params
        eng, build_s, _ = timed(lambda: ds.init_inference(
            model, config=config, **kw), dev)
        norms = norm_counter(eng.module.config)
        reset_norms(norms)
        sync(dev)
        t = time.perf_counter()
        v1[source], steps_ms = [], []
        for p in prompts:
            v1[source].append(eng.generate([p], max_new_tokens=max_new)[
                0, len(p):].tolist())
            graph = v1_graph_record(eng, dev, f"26e v1 from {source}")
            steps_ms.append(graph.pop("decode_ms_per_step"))
        sync(dev)
        rec[f"v1_{source}"] = dict(
            build_s=build_s, generate_s=time.perf_counter() - t,
            decode_ms_per_step=steps_ms,
            captures=[{k: g[k] for k in ("cache_len", "prompt_len",
                                         "capture_ms")}
                      for g in eng.graph_captures],
            norm_launches=norms.launches,
            norm_launches_by_variant=check_norm_variants(
                norms, dev, f"26e v1 from {source}"), **graph)
        if source == "checkpoint":
            rec["v1_graph_vs_eager"] = v1_graph_vs_eager(
                eng, dev, [p[:min(map(len, prompts))] for p in prompts],
                max_new)
        del eng, model
    rec["v1_tokens_equal"] = v1["checkpoint"] == v1["params"]
    rec["v1_v2_agreement"] = agreement(v1["checkpoint"], outs["checkpoint"])
    rec.update(requests=n_req, prompt_lengths=[len(p) for p in prompts],
               new_tokens=max_new)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[ckpt] 26e serving: {json.dumps(rec)}")
    if not (rec["v2_tokens_equal"] and rec["v1_tokens_equal"]
            and all(rec["v1_graph_vs_eager"][m]["tokens_equal"]
                    for m in ("greedy", "sampled"))):
        raise AssertionError(f"phase 26e: {rec}")
    return rec


def v1_graph_vs_eager(eng, dev, prompts, max_new) -> dict:
    """The v1 engine's captured decode step against the same step run
    eagerly on the card (``_generate_eager``: the same state and code, no
    graph), on one batch of ``prompts``: greedy, then sampled (FUSED
    SAMPLING's temperature, top-k and top-p, seed FUSED_SEED): the tokens
    bit-equal. Also the ms a step of each (device events around the
    replays; host wall over the eager steps), and the launches of one
    eager step against a replay's."""
    import torch
    out = {}
    for mode, kw in (("greedy", {}),
                     ("sampled", dict(FUSED_SAMPLING, do_sample=True,
                                      seed=FUSED_SEED))):
        sync(dev)
        graph = eng.generate(prompts, max_new_tokens=max_new, **kw)
        sync(dev)
        rec = v1_graph_record(eng, dev, f"26e v1 {mode} graph")
        t = time.perf_counter()
        eager = eng._generate_eager(prompts, max_new_tokens=max_new, **kw)
        sync(dev)
        out[mode] = dict(
            tokens_equal=bool(torch.equal(graph, eager)),
            graph_decode_ms_per_step=rec.get("decode_ms_per_step"),
            eager_s=time.perf_counter() - t,
            capture_ms=rec.get("capture_ms"),
            launches_per_replay=rec.get("launches_per_replay"))
    log(f"[ckpt] 26e v1 graph vs eager: {json.dumps(out)}")
    return out


def ckpt_devices(dev, root, size, card_engine, saved):
    """26f: 26a's card checkpoint loaded by an engine on the CPU: the
    state bit for bit; the CPU engine's own checkpoint loaded on the card
    (into ``card_engine``) the same way."""
    cpu = ckpt_engine("cpu", size, TRAIN_CONFIG, dict(
        vocab_size=50304, remat_policy="segments", attn_impl="flash"),
        CKPT_SEED + 2)
    want = {k: v.cpu() for k, v in saved.items()}
    _, cpu_load_s, _ = timed(lambda: cpu.load_checkpoint(
        os.path.join(root, "main")), dev)
    cpu_equal = states_equal(train_state(cpu), want)
    path = os.path.join(root, "cpu")
    _, cpu_save_s, _ = timed(lambda: cpu.save_checkpoint(path), dev)
    del cpu
    gc.collect()
    _, card_load_s, _ = timed(lambda: card_engine.load_checkpoint(path),
                              dev)
    card_equal = states_equal(train_state(card_engine), saved)
    shutil.rmtree(path)
    rec = dict(card_to_cpu_load_s=cpu_load_s, card_to_cpu_bit_equal=
               cpu_equal, cpu_save_s=cpu_save_s, cpu_to_card_load_s=
               card_load_s, cpu_to_card_bit_equal=card_equal)
    log(f"[ckpt] 26f across devices: {json.dumps(rec)}")
    if not (cpu_equal and card_equal):
        raise AssertionError(f"phase 26f: {rec}")
    return rec


def ckpt_reshard(dev, engine, path_z):
    """26g: Path Z's checkpoint, written by its two ZeRO-3 ranks (qwZ/qgZ)
    at their last step, loaded at W = 1 on the card: the master's digest
    equals the digest of the consolidated master the ranks computed."""
    info = path_z["checkpoint"]
    _, load_s, rss = timed(lambda: engine.load_checkpoint(info["dir"]), dev)
    digest = master_digest(engine.master_state_dict())
    rec = dict(ranks=PATH_Z_WORLD, saved_at_world=PATH_Z_WORLD,
               loaded_at_world=engine.dp_world,
               saved_zero_stage=3, loaded_zero_stage=engine.zero_stage,
               bytes_on_disk=info["bytes"], ranks_save_s=info["save_s"],
               load_s=load_s, load_host_rss=rss,
               digest=digest, ranks_digest=info["digest"],
               master_bit_equal=digest == info["digest"],
               ranks_launches=path_z["quantized"]["launches"])
    log(f"[ckpt] 26g W = 2 -> 1: {json.dumps(rec)}")
    if not rec["master_bit_equal"]:
        raise AssertionError(f"phase 26g: {rec}")
    return rec


def checkpoint_main(dev, path_z, size="125m", seq=1024, steps=CKPT_STEPS,
                    path_t_steps=CKPT_PATH_T_STEPS, root=CKPT_ROOT,
                    serving_kw=None):
    """Phase 26 (a-g above). Every checkpoint directory is removed at the
    phase's end, whatever its outcome."""
    import torch
    t0 = time.perf_counter()
    seconds = {}
    rec = {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        return out

    try:
        os.makedirs(root, exist_ok=True)
        log(f"[ckpt] disk free before the first save: "
            f"{shutil.disk_usage(root).free / 2**30:.1f} GiB")
        rec["resume"], a, b, saved = part(
            "resume", lambda: ckpt_resume(dev, root, size, seq, steps))
        rec["async"] = part("async", lambda: ckpt_async(dev, b, root, seq))
        rec["path_t"] = part("path_t", lambda: ckpt_path_t(
            dev, root, size, seq, path_t_steps))
        gc.collect()
        rec["convert"], c = part("convert", lambda: ckpt_convert(
            dev, root, size, saved))
        params = c.gathered_params()
        rec["serving"] = part("serving", lambda: ckpt_serving(
            dev, root, size, params, **(serving_kw or {})))
        del params
        rec["devices"] = part("devices", lambda: ckpt_devices(
            dev, root, size, b, saved))
        rec["reshard"] = part("reshard", lambda: ckpt_reshard(
            dev, a, path_z))
        del a, b, c, saved
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rec["seconds_by_part"] = seconds
    rec["seconds"] = time.perf_counter() - t0
    log(f"[ckpt] phase 26: {rec['seconds']:.1f} s")
    return rec


# ------------------------------------------------------------ phase 2
# the attention kernels' mangled names: kernel, dtype, D (and the CUDA-core
# block-sparse kernels' query tile TY)
ATTENTION_KERNEL = re.compile(r"((?:flash|bs)_[a-z_]+kernel)I"
                              r"(f|13__nv_bfloat16|6__half)Li(\d+)E"
                              r"(?:Li(\d+)E)?")
KERNEL_TYPES = {"f": (0, "fp32"), "13__nv_bfloat16": (1, "bf16"),
                "6__half": (2, "fp16")}
# the paged-attention kernels: kernel, dtype, pool type (absent: the
# combine; f or a substitution S<n>_: the pool is of the dtype), D and the
# split's rows R (the CUDA-core kernel's rows a warp)
PAGED_KERNEL = re.compile(r"(paged_[a-z_]+kernel)I"
                          r"(f|13__nv_bfloat16|6__half)"
                          r"(f|S\d*_|a|13__nv_fp8_e4m3)?Li(\d+)E"
                          r"(?:Li(\d+)E)?")
POOL_TYPES = {None: (0, ""), "a": (1, " int8"),
              "13__nv_fp8_e4m3": (2, " fp8")}
# ds_paged_attention_smem's kernel codes
PAGED_SMEM = {"paged_attention_kernel": 0, "paged_prefill_tc_kernel": 1,
              "paged_decode_split_kernel": 2}


def attention_build_report(name: str) -> dict:
    """Registers, spills (ptxas, from the build log) and the dynamic shared
    memory a block asks for (the library's ``ds_<name>_smem``) of every
    kernel of the flash_attention, block_sparse_attention or
    paged_attention library, keyed "kernel dtype D" (+ " TY" for the
    CUDA-core block-sparse kernels, whose shared memory the table gives at
    TY 16 only; paged: "kernel dtype [pool] D [R]", the split's shared
    memory at R 16 only, the combine's none)."""
    from deepspeed_tpu_torch.inference.v2 import paged
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
    if name == "paged_attention":
        lib, pattern = paged._kernel_fn()[0], PAGED_KERNEL
    else:
        lib = (fa if name == "flash_attention" else bsa)._kernel()
        pattern = ATTENTION_KERNEL
    smem = getattr(lib, f"ds_{name}_smem")
    which = {"fwd": 0, "dq": 1, "dkv": 2}
    report, found = {}, None
    log_text = op_builder.library_path(name).with_suffix(".log").read_text()
    for line in log_text.splitlines():
        if "Function properties for" in line:
            found = pattern.search(line)
            continue
        if found is None:
            continue
        if name == "paged_attention":
            kernel, t, pool, d, r = found.groups()
            code, tname = KERNEL_TYPES[t]
            pcode, pname = POOL_TYPES.get(pool, (0, " fp"))
            key = f"{kernel} {tname}{pname} D{d}" + (f" R{r}" if r else "")
            split4 = kernel == "paged_decode_split_kernel" and r == "4"
            size = (smem(PAGED_SMEM[kernel], code, pcode, int(d))
                    if kernel in PAGED_SMEM and not split4 else None)
        else:
            kernel, t, d, ty = found.groups()
            code, tname = KERNEL_TYPES[t]
            key = f"{kernel} {tname} D{d}" + (f" TY{ty}" if ty else "")
            size = (smem(which[next(k for k in which if f"_{k}_" in kernel)],
                         code, int(d)) if ty in (None, "16") else None)
        rec = report.setdefault(key, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            rec.update(spill_stores=int(spill.group(1)),
                       spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            rec.update(registers=int(regs.group(1)), dynamic_smem=size)
            found = None
    return report


# the norm kernels: kernel, x's dtype, the params' (f, or a substitution:
# x's), LayerNorm, and the row kernels' cta flag and vectors a thread
NORM_KERNEL = re.compile(r"(norm_(?:rows_)?kernel)I(f|13__nv_bfloat16|6__half)"
                         r"(f|S\d*_)Lb([01])E(?:Lb([01])ELi(\d+)E)?")


def norm_build_report() -> dict:
    """Registers, spills, named barriers and static shared memory (ptxas,
    from the build log) of every kernel of the norms library, keyed
    "variant kind dtype params [vN]" (warp_row / cta_row:
    norm_rows_kernel, warp_row with no barrier; general: norm_kernel,
    whose row cache is dynamic shared memory)."""
    from deepspeed_tpu_torch.ops import op_builder
    report, found = {}, None
    log_text = op_builder.library_path("norms").with_suffix(".log").read_text()
    for line in log_text.splitlines():
        if "Function properties for" in line:
            found = NORM_KERNEL.search(line)
            continue
        if found is None:
            continue
        kernel, t, p, layer, cta, vecs = found.groups()
        tname = KERNEL_TYPES[t][1]
        variant = ("general" if kernel == "norm_kernel"
                   else "cta_row" if cta == "1" else "warp_row")
        key = (f"{variant} {'layer' if layer == '1' else 'rms'} {tname} "
               f"params {'fp32' if p == 'f' else tname}"
               + (f" v{vecs}" if vecs else ""))
        rec = report.setdefault(key, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            rec.update(spill_stores=int(spill.group(1)),
                       spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            bars = re.search(r"used (\d+) barriers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            rec.update(registers=int(regs.group(1)),
                       barriers=int(bars.group(1)) if bars else 0,
                       static_smem=int(smem.group(1)) if smem else 0)
            found = None
    return report


# ------------------------------------------------- phase 3, training kernels
FLASH_CASES = {                       # b, s, hq, hkv, d, causal, window
    "causal_d64": (2, 512, 4, 4, 64, True, None),
    "full_d64": (2, 256, 4, 4, 64, False, None),
    "gqa_d64": (1, 512, 8, 2, 64, True, None),
    "window_d64": (2, 512, 4, 2, 64, True, 200),
    "unaligned_s1000": (1, 1000, 4, 2, 64, True, None),
    "causal_d128": (1, 512, 4, 2, 128, True, None),
    "full_gqa_d128": (1, 384, 4, 1, 128, False, None),
    # the tensor-core kernels' tiling edges
    "s40": (2, 40, 4, 2, 64, True, None),
    "s129": (1, 129, 4, 4, 64, True, None),
    "narrow_window": (1, 300, 4, 2, 64, True, 24),
    "d16": (2, 200, 4, 2, 16, True, None),
    "full_d32_s77": (2, 77, 4, 2, 32, False, None),
    "full_gqa4": (1, 256, 8, 2, 64, False, None),
    # the model families' head dims: 80 (five 16-wide atoms), 96 (three of
    # 32), 256 (32-key dq stages, dk/dv blocks whose warpgroups split D)
    "causal_d80": (2, 512, 4, 4, 80, True, None),
    "gqa_d80_s1000": (1, 1000, 8, 2, 80, True, None),
    "window_d96": (2, 512, 4, 2, 96, True, 200),
    "full_gqa_d96_s77": (2, 77, 4, 1, 96, False, None),
    "causal_d256": (1, 512, 4, 4, 256, True, None),
    "gqa_window_d256": (1, 640, 8, 2, 256, True, 150),
    "full_d256_s129": (2, 129, 2, 1, 256, False, None),
}
MAIN_ATTENTION = dict(b=24, s=1024, hq=12, hkv=12, d=64)   # GPT-2 125M
# phase 3's rows at the families' head dims: model -> (Hq, Hkv, D), each
# at B 4, S 2048 (phase 21's batch)
FLASH_NEW_DIMS = {"phi-2": (32, 32, 80), "phi3-mini": (32, 32, 96),
                  "gptj-6b": (16, 16, 256)}
FLASH_NEW_DIM_BATCH = dict(b=4, s=2048)
CASES_NOTE = ("FLASH_CASES fp32+bf16+fp16, each rerun bit for bit: "
              "causal/full, GQA (rep 2-4), window (24-200), S "
              "40/77/129/1000, D 16/32/64/80/96/128/256")


def flash_inputs(dev, dtype, b, s, hq, hkv, d, seed=0):
    """q, k, v, do of one attention call, seeded."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d),
            randn(b, s, hq, d))


def flash_flops(b, s, hq, d, backward=False):
    """Operations of one causal call: forward 2, backward 5 matmuls over
    the S(S+1)/2 visible pairs."""
    return (10 if backward else 4) * b * hq * (s * (s + 1) // 2) * d


def flash_bound(b, s, hq, hkv, d, itemsize, backward=False):
    """Least time (ms) for one causal call: bytes (forward reads q, k, v
    and writes o, lse; backward reads q, k, v, o, do, lse and writes dq,
    dk, dv) over the memory rate, against flash_flops over the tensor
    rate of the type; the larger bounds it."""
    qb, kvb, lse = b * s * hq * d * itemsize, b * s * hkv * d * itemsize, \
        b * hq * s * 4
    nbytes = (4 * qb + 4 * kvb + lse) if backward else (2 * qb + 2 * kvb
                                                         + lse)
    flops = flash_flops(b, s, hq, d, backward)
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
    FLASH_CASES in fp32, bf16 and fp16. Forward o within the dtype's
    tolerance (abs + rel); grads within it relative to their largest
    element; a second forward and backward call gives the same bits."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as fa
    errs = {}
    for dtype_name, tol in ATTN_TOL.items():
        dtype = getattr(torch, dtype_name)
        for name, (b, s, hq, hkv, d, causal, window) in FLASH_CASES.items():
            q, k, v, do = flash_inputs(dev, dtype, b, s, hq, hkv, d, seed=1)
            kw = dict(causal=causal, window=window)
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
            grads = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
            again = (*fa.flash_attention_fwd(q, k, v, **kw),
                     *fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do,
                                             **kw))
            identical = all(torch.equal(a, b) for a, b in
                            zip((o, lse, *grads), again))
            del again
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
                bwd_max_rel_err=max(rel.values()),
                bit_identical_rerun=identical)
            log(f"[kernel] flash {name:16s} {dtype_name:9s} "
                f"{json.dumps(errs[(dtype_name, name)])}")
            if fwd_bad or lse_err > 1e-4 or max(rel.values()) > tol \
                    or not identical:
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


def flash_main_check(q, k, v, do, label=None):
    """Forward and backward kernels against their plain versions on one
    set of main-path inputs (bf16): o within TOL abs + rel, lse within
    1e-4, dq/dk/dv within TOL of their largest element, as in
    flash_checks; a second forward and backward call must give the same
    bits (no atomics). Returns the kernel's (o, lse) and the errors."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as fa
    tol = TOL["bfloat16"]
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    err = (o.float() - o_ref.float()).abs()
    fwd_bad = bool((err > tol + tol * o_ref.float().abs()).any())
    del o_ref
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    o2, lse2 = fa.flash_attention_fwd(q, k, v)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    identical = bool(torch.equal(o, o2) and torch.equal(lse, lse2) and all(
        torch.equal(a, b) for a, b in zip(grads, again)))
    del o2, lse2, again
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    check = dict(variant=fa.flash_attention_fwd.variant,
                 bit_identical_rerun=identical,
        fwd_max_abs_err=float(err.max()),
        lse_max_abs_err=float((lse - lse_ref).abs().max()),
        bwd_max_abs_err=max(float((g.float() - r.float()).abs().max())
                            for g, r in zip(grads, refs)),
        bwd_max_rel_err=max(rel_max(g, r) for g, r in zip(grads, refs)))
    label = label or f"main shape {json.dumps(MAIN_ATTENTION)}"
    log(f"[kernel] flash {label} bf16 causal, kernel vs plain: "
        f"{json.dumps(check)}")
    if fwd_bad or check["lse_max_abs_err"] > 1e-4 \
            or check["bwd_max_rel_err"] > tol or not identical:
        raise AssertionError(
            f"flash attention kernels disagree with their plain versions at "
            f"{label}: {check} (tol {tol:g})")
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


def flash_times(dev, shape, flush=None, iters=20, label=None):
    """Flash forward and backward at ``shape`` (bf16, causal), held
    against their plain versions on these inputs first
    (:func:`flash_main_check`), then kernel, plain, SDPA and bound times in
    ms, TFLOP/s, the share of the bound and the ratio to SDPA."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, do = flash_inputs(dev, torch.bfloat16, **shape, seed=2)
    o, lse, flash_check = flash_main_check(q, k, v, do, label)
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
    rec["flash_attention_fwd"]["variant"] = fa.flash_attention_fwd.variant
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
        bound_ms=bound, bound_by=by, check=flash_check,
        variant=fa.flash_attention_bwd.variant)
    del lib_out, leaves
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        r = rec[name]
        flops = flash_flops(shape["b"], shape["s"], shape["hq"], shape["d"],
                            backward=name.endswith("bwd"))
        r.update(tflops=flops / r["ms"] / 1e9,
                 bound_share=r["bound_ms"] / r["ms"],
                 x_library=r["ms"] / r["library_ms"])
        times = {key: x for key, x in r.items() if key != "check"}
        log(f"[kernel] {name} times (ms) at B={shape['b']} S={shape['s']} "
            f"Hq={shape['hq']} Hkv={shape['hkv']} D={shape['d']} bf16 "
            f"causal: {json.dumps(times)}")
    return rec


def flash_new_dim_times(dev, flush=None, iters=20):
    """Phase 3 at the families' head dims: :func:`flash_times` at each
    FLASH_NEW_DIMS head layout, B 4, S 2048."""
    import torch
    rec = {}
    for model, (hq, hkv, d) in FLASH_NEW_DIMS.items():
        shape = dict(FLASH_NEW_DIM_BATCH, hq=hq, hkv=hkv, d=d)
        rec[model] = dict(shape=shape, **flash_times(
            dev, shape, flush, iters, label=f"{model} {json.dumps(shape)}"))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rec


def train_kernel_times(dev, adam_numel: int, flush=None, iters=20):
    """Flash forward and backward at GPT-2 125M's attention shapes (bf16,
    B 24, S 1024, 12 heads of 64, causal) and fused Adam over the model's
    flat buffers: each kernel held against its plain version on these
    inputs first, then kernel, plain, library and bound times in ms."""
    import torch
    from deepspeed_tpu_torch.ops.fused_optimizers import (adam_plain,
                                                          fused_adam_step)
    rec = flash_times(dev, MAIN_ATTENTION, flush, iters)

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
    lib_out = torch.empty(n, dtype=torch.bfloat16, device=dev)

    def lib_step_and_copy():
        lib_opt.step()
        lib_out.copy_(lib_p.detach())

    read_write = 16 + 12                  # p, g, m, v in; p, m, v out
    t_bytes = n * (read_write + 2) / HBM_BYTES_PER_S
    t_ops = 15 * n / FP32_FLOPS
    # like for like: the kernel without its copy against AdamW(fused=True)
    # (28 B a value each), with its copy against that step followed by a
    # bf16 copy_ of the new params (the same 30 B of results, plus the
    # copy's read of p)
    rec["fused_adam"] = dict(
        ms=time_ms(lambda: fused_adam_step(p, grad, m, vv, hp, out=out, **kw),
                   dev, iters, flush),
        ms_without_copy=time_ms(lambda: fused_adam_step(p, grad, m, vv, hp,
                                                        **kw),
                                dev, iters, flush),
        plain_ms=time_ms(lambda: adam_plain(p, grad, m, vv, hp, out=out,
                                            **kw), dev, max(iters // 4, 2),
                         flush),
        library_ms=time_ms(lib_opt.step, dev, iters, flush),
        library_with_copy_ms=time_ms(lib_step_and_copy, dev, iters, flush),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_ms_without_bf16_copy=n * read_write / HBM_BYTES_PER_S * 1e3,
        numel=n)
    r = rec["fused_adam"]
    r.update(bound_share=r["bound_ms"] / r["ms"],
             bound_share_without_copy=r["bound_ms_without_bf16_copy"]
             / r["ms_without_copy"],
             x_library_without_copy=r["ms_without_copy"] / r["library_ms"],
             x_library_with_copy=r["ms"] / r["library_with_copy_ms"])
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
    norms = norm_counter(c)
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_bwd.calls = 0
    fa.flash_attention_fwd.variant_launches = {}
    fa.flash_attention_bwd.variant_launches = {}
    fused_adam_step.launches = 0
    reset_norms(norms)
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(engine.train_batch(batch))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    norm_by_variant = check_norm_variants(norms, dev, "training")
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_attention_bwd": fa.flash_attention_bwd.launches,
                "flash_attention_bwd_calls": fa.flash_attention_bwd.calls,
                "fused_adam": fused_adam_step.launches,
                "layer_norm": norms.launches}
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
        launches_per_step={k: v / steps for k, v in launches.items()},
        flash_variant_launches={
            "fwd": dict(fa.flash_attention_fwd.variant_launches),
            "bwd": dict(fa.flash_attention_bwd.variant_launches)},
        norm_launches_by_variant=norm_by_variant)
    log(f"[train] {json.dumps(stats)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    want = {"flash_attention_fwd": c.num_layers * steps,
            "flash_attention_bwd": 2 * c.num_layers * steps,
            "flash_attention_bwd_calls": c.num_layers * steps,
            "fused_adam": steps,
            "layer_norm": norm_launches_per_micro(c) * steps}
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"training launches {launches} != {want} (one "
                             f"forward and one backward call per layer, "
                             f"two backward launches per call, no forward "
                             f"rerun under segments, one Adam launch, 2L + "
                             f"1 norms a forward and 2L recomputed)")
    tensor_cores = {"fwd": {"wgmma": want["flash_attention_fwd"]},
                    "bwd": {"wgmma": want["flash_attention_bwd"]}}
    if dev.type == "cuda" and stats["flash_variant_launches"] != tensor_cores:
        raise AssertionError(f"bf16 training flash launches by variant "
                             f"{stats['flash_variant_launches']} != "
                             f"{tensor_cores}")
    return engine, batch, stats


# ------------------------------------------- phase 7, kernels against plain
def train_path_kernel_vs_plain(dev, size="125m", rows=2, seq=1024, steps=3):
    """The training path with the kernels (flash attention, fused Adam,
    the norm kernel) against the plain path (reference attention, plain
    Adam, plain norms) from the same initial weights, ``steps`` steps on
    one batch.

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
    from deepspeed_tpu_torch.ops.norms import plain_norms
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
            norms = norm_counter(model.config)
            before = norms.launches
            for step in range(steps):
                with plain_norms(not kernels):
                    losses.append(float(engine.train_batch(batch)))
                if step == 0:
                    grads = engine._grads.clone()
            if dev.type == "cuda" and (norms.launches > before) != kernels:
                raise AssertionError(
                    f"phase 7 {'kernel' if kernels else 'plain'} side: "
                    f"{norms.launches - before} norm launches")
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
    "bigbird_block32_d32": (2, 2, 512, 32, dict(kind="bigbird", block=32,
                                                num_random_blocks=2)),
    "block8_d24": (1, 2, 256, 24, dict(block=8)),
    "d128_block64": (1, 2, 1024, 128, dict(block=64)),
    # the tensor-core kernels' tile edges: 64-row groups of whole blocks
    # (pad rows at 48, two tiles a block at 128), 64-entry chunks
    "block48_pad_rows": (1, 2, 768, 64, dict(block=48)),
    "block128_split_tiles": (1, 2, 2048, 64, dict(
        kind="bigbird", block=128, num_random_blocks=1)),
    "block24_stream_ends_mid_chunk": (2, 2, 480, 64, dict(
        block=24, num_local_blocks=3)),
    "d40": (2, 2, 512, 40, dict(block=16)),
    "dead_row": (2, 2, 128, 32, dict(kind="dead_row", block=16)),
}
SPARSE_NOTE = ("SPARSE_CASES fp32+bf16+fp16: Fixed/BigBird layouts, blocks "
               "8-128 (48: pad rows, 128: split tiles), D 24-128, a stream "
               "ending mid-chunk, a dead row")


def sparse_layout(h, s, block, kind="fixed", **kw):
    """A Fixed layout (Path P's kwargs for the main shape), a BigBird one,
    or a block-diagonal one whose q block 1 sees nothing ("dead_row"), for
    ``h`` heads over ``s`` tokens."""
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    if kind == "dead_row":
        layout = np.eye(s // block, dtype=bool)[None].repeat(h, 0)
        layout[:, 1, :] = False
        layout[:, 3, 0] = True
        return layout
    config = (tsa.BigBirdSparsityConfig if kind == "bigbird"
              else tsa.FixedSparsityConfig)
    return config(num_heads=h, block=block, **kw).make_layout(s)


def sparse_inputs(dev, dtype, b, h, s, d, seed=0):
    """q, k, v, do of one call, [B, H, S, D], seeded."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)
            for _ in range(4)]


def sparse_compare(q, k, v, do, maps, tol):
    """Block-sparse forward and backward kernels against their plain
    versions on the same inputs: o and dq/dk/dv within ``tol`` of their
    largest element, lse within 1e-5 of its largest; a second forward and
    backward call must give the same bits (no atomics). Returns the
    kernel's (o, lse) and the errors; raises on disagreement."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, maps)
    o_ref, lse_ref = bsa.block_sparse_attention_fwd_plain(q, k, v, maps)
    grads = bsa.block_sparse_attention_bwd(q, k, v, o_ref, lse_ref, do, maps)
    o2, lse2 = bsa.block_sparse_attention_fwd(q, k, v, maps)
    again = bsa.block_sparse_attention_bwd(q, k, v, o_ref, lse_ref, do, maps)
    identical = bool(torch.equal(o, o2) and torch.equal(lse, lse2) and all(
        torch.equal(a, b) for a, b in zip(grads, again)))
    del o2, lse2, again
    refs = bsa.block_sparse_attention_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                                maps)
    if q.device.type == "cuda":
        torch.cuda.synchronize()
    check = dict(
        variant=bsa.block_sparse_attention_fwd.variant,
        bit_identical_rerun=identical,
        fwd_max_abs_err=float((o.float() - o_ref.float()).abs().max()),
        fwd_max_rel_err=rel_max(o, o_ref),
        lse_max_rel_err=rel_max(lse, lse_ref),
        bwd_max_abs_err=max(float((g.float() - r.float()).abs().max())
                            for g, r in zip(grads, refs)),
        bwd_max_rel_err=max(rel_max(g, r) for g, r in zip(grads, refs)))
    if (check["fwd_max_rel_err"] > tol or check["lse_max_rel_err"] > 1e-5
            or check["bwd_max_rel_err"] > tol or not identical):
        raise AssertionError(f"block-sparse kernels disagree with their "
                             f"plain versions: {check} (tol {tol:g})")
    return o, lse, check


# DeepSpeed's layouts at Path P's heads and length, for the tile groups'
# fill (a host count): Path P's, BigBird's and BSLongformer's
FILL_LAYOUTS = {"path_p_fixed_block16": ("FixedSparsityConfig", PATH_P_LAYOUT),
                "bigbird_block16": ("BigBirdSparsityConfig", dict(
                    block=16, different_layout_per_head=True)),
                "bigbird_block32": ("BigBirdSparsityConfig", dict(
                    block=32, different_layout_per_head=True)),
                "longformer_block8": ("BSLongformerSparsityConfig",
                                      dict(block=8)),
                "longformer_block16": ("BSLongformerSparsityConfig",
                                       dict(block=16))}


def sparse_fill() -> dict:
    """The live share of the tensor-core kernels' 64 x 64 tile steps
    (``kernels.tile_fill``) for FILL_LAYOUTS at 12 heads and S 4096."""
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
    fill = {}
    for name, (cls, kw) in FILL_LAYOUTS.items():
        layout = getattr(tsa, cls)(num_heads=PATH_P["h"], **kw).make_layout(
            PATH_P["s"])
        fill[name] = dict(bsa.tile_fill(layout, kw["block"]),
                          density=bsa.sparsity_stats(layout)["density"])
    log(f"[kernel] block-sparse tile fill at H {PATH_P['h']} S "
        f"{PATH_P['s']}: {json.dumps(fill)}")
    return fill


def sparse_checks(dev):
    """Block-sparse kernels against their plain versions over
    SPARSE_CASES in fp32, bf16 and fp16, relative to the largest element;
    reruns bit-identical."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
    errs = {}
    for dtype_name, tol in ATTN_TOL.items():
        for name, (b, h, s, d, lay) in SPARSE_CASES.items():
            layout = sparse_layout(h, s, **lay)
            maps = bsa.block_maps(layout, dev, lay["block"])
            q, k, v, do = sparse_inputs(dev, getattr(torch, dtype_name), b, h,
                                        s, d, seed=1)
            errs[(dtype_name, name)] = sparse_compare(q, k, v, do, maps,
                                                      tol)[2]
            log(f"[kernel] block-sparse {name:29s} {dtype_name:9s} "
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
                         variant=getattr(bsa, name).variant,
                         tflops=work["gflop"] / times["ms"],
                         bound_share=bound / times["ms"],
                         x_library=times["ms"] / times["library_ms"], **work)
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
    norms = norm_counter(c)
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention_bwd.calls = 0
    fused_adam_step.launches = 0
    fused_lion_step.launches = 0
    reset_norms(norms)
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(triple_step(engine, batch, ga))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    norm_by_variant = check_norm_variants(norms, dev, "Path T")
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_attention_bwd": fa.flash_attention_bwd.launches,
                "flash_attention_bwd_calls": fa.flash_attention_bwd.calls,
                "fused_lion": fused_lion_step.launches,
                "fused_adam": fused_adam_step.launches,
                "layer_norm": norms.launches}
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
        launches_per_step={k: v / steps for k, v in launches.items()},
        norm_launches_by_variant=norm_by_variant)
    log(f"[path T] {json.dumps(stats)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Path T losses not finite and falling: "
                             f"{losses}")
    calls = c.num_layers * ga * steps
    want = {"flash_attention_fwd": calls, "flash_attention_bwd": 2 * calls,
            "flash_attention_bwd_calls": calls, "fused_lion": steps,
            "fused_adam": 0,
            "layer_norm": norm_launches_per_micro(c) * ga * steps}
    if dev.type == "cuda" and launches != want:
        raise AssertionError(
            f"Path T launches {launches} != {want} (one forward and one "
            f"backward flash call per layer and micro-batch, two backward "
            f"launches per call, one Lion launch per step, no Adam, 4L + 1 "
            f"norms a micro-batch)")
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
def path_p_main(dev, small=dict(b=2, h=4, s=256, d=64), profile=False):
    """SparseSelfAttention at Path P's shape (bf16), forward and backward
    through autograd as a caller runs it: a first call, which also builds
    the layout, its block lists and tile groups on the host and copies
    them to the card once, then a second call, timed, with the counts set
    to 0 right before and read right after: one forward and two backward
    launches, all of the tensor-core ("wgmma") kernels in bf16 and of the
    CUDA-core ones in fp32. Then the output and grads are held against the
    plain versions on the same inputs (bf16 3e-2 of the largest element,
    lse 1e-5), and the same module in fp32 at a small shape at 1e-4. The
    host's share of a first call is timed apart: a new module's layout,
    lists and groups built and copied to the device. With ``profile``,
    five more bf16 calls are traced (torch.profiler)."""
    import torch
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as bsa
    out = {}
    for dtype_name, shape in (("bfloat16", PATH_P), ("float32", small)):
        dtype = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        def module():
            return tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
                num_heads=shape["h"], **PATH_P_LAYOUT))

        attn = module()
        q, k, v, do = sparse_inputs(dev, dtype, **shape, seed=9)
        walls = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            for fn in (bsa.block_sparse_attention_fwd,
                       bsa.block_sparse_attention_bwd):
                fn.launches = 0
                fn.variant_launches = {}
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
        by_variant = {
            "fwd": dict(bsa.block_sparse_attention_fwd.variant_launches),
            "bwd": dict(bsa.block_sparse_attention_bwd.variant_launches)}
        if profile and dtype_name == "bfloat16":
            traced = [t.clone().requires_grad_() for t in (q, k, v)]

            def calls(n=5):
                for _ in range(n):
                    attn(*traced).backward(do)

            profile_window("path_p_call", calls, 5)
            del traced
        t = time.perf_counter()
        module()._kernel(shape["s"], shape["h"], shape["d"]).maps(
            dev, shape["s"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        fn = attn._kernel(shape["s"], shape["h"], shape["d"])
        maps = fn.maps(dev, shape["s"])
        o_ref, lse_ref = bsa.block_sparse_attention_fwd_plain(q, k, v, maps)
        refs = bsa.block_sparse_attention_bwd_plain(q, k, v, o_ref, lse_ref,
                                                    do, maps)
        _, lse = bsa.block_sparse_attention_fwd(q, k, v, maps)
        rec = dict(
            shape=shape, dtype=dtype_name, fwd_bwd_wall_ms=walls[1],
            first_call_wall_ms=walls[0], first_call_host_lists_ms=host_ms,
            launches=launches, launches_by_variant=by_variant,
            finite=bool(torch.isfinite(o).all()),
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
        variant = "cuda_cores" if dtype_name == "float32" else "wgmma"
        if dev.type == "cuda" and by_variant != {"fwd": {variant: 1},
                                                 "bwd": {variant: 2}}:
            raise AssertionError(f"Path P {dtype_name} launches by variant "
                                 f"{by_variant}: not all {variant}")
    return out


def flat_numel(size: str) -> int:
    """Length of the engine's flat master for GPT-2 ``size`` (vocab
    50304), from a model on the meta device."""
    from deepspeed_tpu_torch.models import GPT2
    from deepspeed_tpu_torch.runtime.engine import _flat_layout
    params = GPT2(size=size, vocab_size=50304, device="meta").params
    return _flat_layout({n: p.shape for n, p in params.items()})[1]


# ------------------------------------------ phase 3, the ZeRO++ wire kernels
def path_z_plan(size="125m", world=PATH_Z_WORLD):
    """ZeRO-3's plan for GPT-2 ``size`` (vocab 50304) over ``world`` ranks,
    from a model on the meta device."""
    from deepspeed_tpu_torch.models import GPT2
    from deepspeed_tpu_torch.runtime.zero import ZeroShardingPlan
    params = GPT2(size=size, vocab_size=50304, device="meta").params
    return ZeroShardingPlan(3, world, {n: tuple(p.shape)
                                       for n, p in params.items()})


def quant_bound(n: int, in_bytes: int, out_bytes: int) -> tuple[float, str]:
    """The card's least time for one quantize (in_bytes a value in, 1 + 4
    / 512 out) or dequantize (1 + 4 / 512 in, out_bytes out) of n values:
    bytes over 3.35 TB/s against ~8 fp32 operations a value (abs, max,
    divide, round, clamps) over 67 TFLOP/s."""
    t_bytes = n * (in_bytes + out_bytes + 4 / 512) / HBM_BYTES_PER_S
    t_ops = 8 * n / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def zeropp_kernel_times(dev, flush=None, iters=20, size="125m"):
    """The int8 block quantize and dequantize at Path Z's shard shapes,
    bf16: the largest shard (embed/tokens split in two, [25152, 768]) and
    the rank's whole shard set as one flat tensor. Codes, scales and the
    dequantized bf16 are held to the plain versions bit for bit, then the
    kernel, plain and bound times are taken. No single PyTorch call
    computes per-512-block int8 quantization (library none), but one
    computes the dequantize: ``torch.mul(q, s, out=bf16)`` promotes int8 x
    fp32 to fp32 and rounds the product once into the bf16 output (over
    the padded blocks), the kernel's function; it is timed as the
    dequantize's library yardstick and compared with the kernel's bits."""
    import torch
    from deepspeed_tpu_torch.ops import quantization as TQ
    plan = path_z_plan(size)
    dim = plan.param_dims["embed/tokens"]
    shapes = {"largest_shard": plan.shard_shape("embed/tokens", dim),
              "shard_set": (sum(int(np.prod(plan.shard_shape(n, d)))
                                for n, d in plan.param_dims.items()),),
              "largest_shard_misaligned":
                  plan.shard_shape("embed/tokens", dim)}
    g = torch.Generator(device=dev).manual_seed(4)
    rec = {"quantize_int8": {}, "dequantize_int8": {}}
    for case, shape in shapes.items():
        # the misaligned case starts one element into its storage: the
        # quantize takes its ragged variant over the same bytes
        skew = int(case.endswith("misaligned"))
        x = (torch.randn(int(np.prod(shape)) + skew, generator=g,
                         device=dev) * 0.02).to(torch.bfloat16)[skew:]
        n = x.numel()
        rows = x.view(1, -1)
        q, sc = TQ.quantize_rows(rows, use_kernel=None)
        variant = (TQ.quantize_int8_kernel.variant if dev.type == "cuda"
                   else TQ.quantize_plan(n, x.data_ptr() % 16 == 0))
        pq, ps = TQ.quantize_rows(rows, use_kernel=False)
        back = TQ.dequantize_rows(q, sc, 1, n, torch.bfloat16, None)
        pback = TQ.dequantize_rows(q, sc, 1, n, torch.bfloat16, False)
        equal = {"codes": bool(torch.equal(q, pq)),
                 "scales": bool(torch.equal(sc, ps)),
                 "dequantized": bool(torch.equal(back, pback))}
        err = max(float((q.int() - pq.int()).abs().max()),
                  float((sc - ps).abs().max()))
        derr = float((back.float() - pback.float()).abs().max())
        del pq, ps, pback
        lib_out = torch.empty(q.numel(), dtype=torch.bfloat16,
                              device=dev).view(q.shape)

        def lib_dequant():
            return torch.mul(q, sc, out=lib_out)

        lib_dequant()
        lib_equal = bool(torch.equal(lib_out.view(-1)[:n], back.view(-1)))
        library = {"quantize_int8": (None, None),
                   "dequantize_int8": (lib_dequant, lib_equal)}
        for name, fn, plain, (bound, by), e, eq in (
                ("quantize_int8",
                 lambda: TQ.quantize_rows(rows, use_kernel=None),
                 lambda: TQ.quantize_rows(rows, use_kernel=False),
                 quant_bound(n, 2, 1), err,
                 equal["codes"] and equal["scales"]),
                ("dequantize_int8",
                 lambda: TQ.dequantize_rows(q, sc, 1, n, torch.bfloat16,
                                            None),
                 lambda: TQ.dequantize_rows(q, sc, 1, n, torch.bfloat16,
                                            False),
                 quant_bound(n, 1, 2), derr, equal["dequantized"])):
            lib, lib_eq = library[name]
            rec[name][case] = dict(
                shape=list(shape), numel=n, bit_equal=eq, max_abs_err=e,
                ms=time_ms(fn, dev, iters, flush),
                plain_ms=time_ms(plain, dev, max(iters // 4, 2), flush),
                library_ms=(time_ms(lib, dev, iters, flush)
                            if lib else None),
                library_bit_equal=lib_eq, bound_ms=bound, bound_by=by)
            r = rec[name][case]
            r.update(bound_share=bound / r["ms"],
                     gb_per_s=(n * (2 + 1 + 4 / 512)) / r["ms"] / 1e6)
        rec["quantize_int8"][case]["variant"] = variant
        # a yardstick of the memory path: PyTorch's copy of x (2 bytes read
        # and 2 written a value, a third more than the quantize's 3)
        xc = torch.empty_like(x)
        rec["quantize_int8"][case]["copy_ms"] = time_ms(
            lambda: xc.copy_(x), dev, iters, flush)
        del xc
        log(f"[kernel] int8 block quantize at {case} {list(shape)} bf16: "
            f"{json.dumps({k: v[case] for k, v in rec.items()})}")
        if not all(equal.values()):
            raise AssertionError(f"quantize_int8 kernels vs plain at {case}: "
                                 f"{equal}")
        del x, rows, q, sc, back, lib_out
    for name, r in rec.items():
        cases = [r[c] for c in shapes]
        r.update({k: r["largest_shard"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        r["library_bit_equal"] = all(c["library_bit_equal"] in (True, None)
                                     for c in cases)
        r["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    return rec


# ------------------------------ --compare-kernels: two versions, one call
def compare_kernels(other: str, dev, rounds=3, iters=20) -> dict:
    """The quantize and fused-Adam kernels of this checkout against those
    of the checkout at ``other`` (an earlier commit unpacked with ``git
    archive``), each built from its own ``csrc`` with this checkout's
    nvcc flags into ``build/compare/``, bound by the C entry points both
    versions share, and timed on the same inputs in turns (other, this,
    this, other, ``rounds`` times; each time the median of ``iters``
    event-timed calls with the L2 flushed, as phase 3): the quantize at
    Path Z's largest shard and shard set (bf16), Adam over GPT-2 125M's
    flat buffers with and without the bf16 copy, beside
    AdamW(fused=True).step and that step followed by a bf16 copy_ in the
    same turns. Codes and scales of the two quantize kernels must be
    equal bit for bit, Adam's results within ADAM_TOL. Returns each
    version's medians over the rounds and every round's times."""
    import ctypes
    import torch
    from pathlib import Path
    from deepspeed_tpu_torch.ops import op_builder
    roots = {"other": Path(other).resolve(),
             "this": Path(__file__).resolve().parent}
    names = ("quantize_int8", "fused_adam")
    nvcc = op_builder.find_nvcc()
    procs, libs = {}, {}
    for tag, root in roots.items():
        out_dir = op_builder.BUILD_DIR / "compare" / tag
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in names:
            so = out_dir / f"lib{name}.so"
            cmd = [nvcc, *op_builder.NVCC_FLAGS,
                   str(root / "deepspeed_tpu_torch" / "csrc" / f"{name}.cu"),
                   "-o", str(so)]
            procs[tag, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    for key, (proc, so) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{output}")
        libs[key] = ctypes.CDLL(str(so))
    vp, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    for (tag, name), lib in libs.items():
        fn = getattr(lib, f"ds_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([vp, i32, vp, vp, ll, ll, vp]
                       if name == "quantize_int8"
                       else [vp] * 6 + [i32, ll, f32, i32, vp])
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    plan = path_z_plan("125m")
    dim = plan.param_dims["embed/tokens"]
    g = torch.Generator(device=dev).manual_seed(4)
    quant = {}
    for case, n in (
            ("largest_shard",
             int(np.prod(plan.shard_shape("embed/tokens", dim)))),
            ("shard_set", sum(int(np.prod(plan.shard_shape(k, d)))
                              for k, d in plan.param_dims.items()))):
        x = (torch.randn(n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        nb = -(-n // 512)
        outs = {t: (torch.empty(nb * 512, dtype=torch.int8, device=dev),
                    torch.empty(nb, device=dev)) for t in roots}

        def call(tag, x=x, n=n, outs=outs):
            q, s = outs[tag]
            err = libs[tag, "quantize_int8"].ds_quantize_int8(
                x.data_ptr(), 1, q.data_ptr(), s.data_ptr(), 1, n, stream)
            if err:
                raise RuntimeError(f"quantize_int8 ({tag}): CUDA error {err}")

        for t in roots:
            call(t)
        torch.cuda.synchronize()
        if not (torch.equal(*(outs[t][0] for t in roots))
                and torch.equal(*(outs[t][1] for t in roots))):
            raise AssertionError(f"quantize_int8 {case}: the two versions' "
                                 f"codes or scales differ")
        quant[case] = (call, quant_bound(n, 2, 1)[0])
    n = flat_numel("125m")
    p0, grad = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    hp = torch.tensor([1e-4, 0.9, 0.999, 1e-8, 10.0, 1000.0, 1.0, 1.0],
                      device=dev)
    bufs = {t: [p0.clone(), torch.zeros(n, device=dev),
                torch.zeros(n, device=dev),
                torch.empty(n, dtype=torch.bfloat16, device=dev)]
            for t in roots}

    def adam(tag, copy):
        p, m, v, out = bufs[tag]
        err = libs[tag, "fused_adam"].ds_fused_adam(
            p.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(),
            hp.data_ptr(), out.data_ptr() if copy else None, 1, n, 0.01, 1,
            stream)
        if err:
            raise RuntimeError(f"fused_adam ({tag}): CUDA error {err}")

    for t in roots:
        adam(t, True)
    torch.cuda.synchronize()
    for i, name in enumerate("pmv"):
        a, b = (bufs[t][i] for t in roots)
        if bool(((a - b).abs() > ADAM_TOL[0] + ADAM_TOL[1] * b.abs()).any()):
            raise AssertionError(f"fused_adam: the two versions' {name} "
                                 f"differ past ADAM_TOL")
    lib_p = torch.nn.Parameter(p0.clone())
    lib_p.grad = grad.clone()
    lib_opt = torch.optim.AdamW([lib_p], lr=1e-4, weight_decay=0.01,
                                fused=True)
    lib_out = torch.empty(n, dtype=torch.bfloat16, device=dev)

    def lib_copy():
        lib_opt.step()
        lib_out.copy_(lib_p.detach())

    fns = {f"quantize_{case}": c for case, (c, _) in quant.items()}
    fns["adam_with_copy"] = lambda t: adam(t, True)
    fns["adam_without_copy"] = lambda t: adam(t, False)
    runs = {k: {t: [] for t in roots} for k in fns}
    library = {"adamw_fused_step": [], "adamw_fused_step_and_copy": []}
    for _ in range(rounds):
        for tag in ("other", "this", "this", "other"):
            for k, fn in fns.items():
                runs[k][tag].append(time_ms(lambda: fn(tag), dev, iters,
                                            flush))
        library["adamw_fused_step"].append(time_ms(lib_opt.step, dev, iters,
                                                   flush))
        library["adamw_fused_step_and_copy"].append(time_ms(lib_copy, dev,
                                                            iters, flush))
    bound = {f"quantize_{c}": b for c, (_, b) in quant.items()}
    bound["adam_with_copy"] = n * 30 / HBM_BYTES_PER_S * 1e3
    bound["adam_without_copy"] = n * 28 / HBM_BYTES_PER_S * 1e3
    return {"other": str(roots["other"]), "rounds": rounds,
            "numel_adam": n, "bound_ms": bound, "runs_ms": runs,
            "library_runs_ms": library,
            "median_ms": {k: {t: float(np.median(v)) for t, v in r.items()}
                          for k, r in runs.items()},
            "library_median_ms": {k: float(np.median(v))
                                  for k, v in library.items()}}


# ------------------------------------------------- phase 3, the norm kernels
NORM_DS = (64, 200, 768, 4096, 5120)
NORM_ROWS = 37                 # a multiple of no block or warp count
NORM_NOTE = ("rms/layer x fp32/bf16/fp16 x d 64/200/768/4096/5120 x 37 "
             "rows, params fp32 and in x's dtype, contiguous and "
             "transposed input; fp32 grads of the autograd Functions vs "
             "plain autograd; LayerNorm rows of mean 300 vs float64")
# the main paths' shapes: train_batch's LayerNorm (24 x 1024 rows of
# GPT-2's 768), a prefill tick's (8 x 256 rows) and a decode tick's (8
# rows) RMSNorm at Llama-3-8B's 4096, all bf16 with bf16 params
NORM_MAIN = {"layer_norm": ("layer", (24576, 768)),
             "rms_norm": ("rms", (2048, 4096)),
             "rms_norm_decode": ("rms", (8, 4096))}


def norm_ulps(got, ref, dtype, bias=None) -> float:
    """max |got - ref| in units of ``dtype``'s spacing at |ref|, or at
    |bias| where that is larger: where a LayerNorm's bias add cancels the
    normalised term to near zero, two correct fp32 results that differ by
    a few 1e-7 of the terms (the row sums run in another order) are many
    spacings of the small result apart."""
    import torch
    eps = torch.finfo(dtype).eps
    mag = ref.float().abs()
    if bias is not None:
        mag = torch.maximum(mag, bias.float().abs())
    mag = mag.clamp(min=torch.finfo(dtype).tiny)
    ulp = eps * torch.exp2(torch.floor(torch.log2(mag)))
    return float(((got.float() - ref.float()).abs() / ulp).max())


def norm_call(kind, x, scale, bias, use_kernel):
    """The norm of ``kind`` ("rms"/"layer") through the port's op (with
    ``use_kernel`` the kernel on the card; in a CPU rehearsal its plain
    forward) or its plain version."""
    from deepspeed_tpu_torch.ops import layers as L
    from deepspeed_tpu_torch.ops import norms as N
    if kind == "rms":
        return (N.rms_norm(x, scale) if use_kernel
                else L.rms_norm(x, scale))
    return (N.layer_norm(x, scale, bias) if use_kernel
            else L.layer_norm(x, scale, bias))


def norm_compare(kind, x, scale, bias) -> float:
    """The kernel against its plain version: fp32 abs error, raising past
    1e-6 + 2 ulps relative (the row sums run in another order); bf16/fp16
    the error in ulps of the plain result (at |bias| where larger,
    ``norm_ulps``), raising past 1."""
    import torch
    got = norm_call(kind, x, scale, bias, True)
    ref = norm_call(kind, x, scale, bias, False)
    if x.dtype == torch.float32:
        err = (got - ref).abs()
        if bool((err > 1e-6 + 2.4e-7 * ref.abs()).any()):
            raise AssertionError(f"{kind} norm fp32 {tuple(x.shape)}: "
                                 f"max|err| {float(err.max()):.3e}")
        return float(err.max())
    ulps = norm_ulps(got, ref, x.dtype, bias if kind == "layer" else None)
    if ulps > 1.0:
        raise AssertionError(f"{kind} norm {x.dtype} {tuple(x.shape)}: "
                             f"{ulps:.2f} ulps from plain")
    return ulps


def norm_grad_check(kind, dev) -> float:
    """The autograd Function (kernel forward, closed-form backward)
    against plain autograd, fp32, 50 rows of 768: the largest grad error,
    raising past 1e-5."""
    import torch
    from deepspeed_tpu_torch.ops import norms as N
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(50, 768, generator=g, device=dev) * 2 + 0.5
    scale = torch.randn(768, generator=g, device=dev) + 1
    bias = torch.randn(768, generator=g, device=dev)
    dy = torch.randn(50, 768, generator=g, device=dev)
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        with N.plain_norms(plain):
            y = (N.rms_norm(leaves[0], leaves[1]) if kind == "rms"
                 else N.layer_norm(*leaves))
        y.backward(dy)
        grads.append([t.grad for t in leaves[:2 if kind == "rms" else 3]])
    err = max(float((a - b).abs().max()) for a, b in zip(*grads))
    if err > 1e-5:
        raise AssertionError(f"{kind} norm grads vs plain autograd: {err}")
    return err


def norm_bytes(kind, n_rows, d) -> int:
    """Bytes one bf16 norm of n_rows x d must move: 2 B in and 2 B out an
    element plus the bf16 params."""
    return 4 * n_rows * d + 2 * (1 if kind == "rms" else 2) * d


def norm_bound(kind, n_rows, d) -> tuple[float, str]:
    """The least time for one bf16 norm of n_rows x d: ``norm_bytes`` over
    3.35 TB/s, against ~4 (RMS) or ~7 (Layer) fp32 operations an element
    over 67 TFLOP/s."""
    t_bytes = norm_bytes(kind, n_rows, d) / HBM_BYTES_PER_S
    t_ops = (4 if kind == "rms" else 7) * n_rows * d / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def norm_checks(dev, flush=None, iters=20):
    """Phase 3 for the norm kernels: every case of NORM_NOTE against the
    plain versions, then the kernels timed at NORM_MAIN's shapes beside
    their plain versions, their bounds and the library calls computing the
    same functions (``torch.nn.functional.layer_norm`` / ``rms_norm``,
    yardsticks the port never calls), each also held to its plain version
    there, with the variant it took (on the card: the C side's plan, which
    must agree), its GB/s, its share of the bound, its ratio to the
    library call and a bit-identical rerun."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import norms as N
    errs = {}
    g = torch.Generator(device=dev).manual_seed(8)
    for kind in ("rms", "layer"):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            worst = 0.0
            for d in NORM_DS:
                x = (torch.randn(NORM_ROWS, d, generator=g, device=dev) * 2
                     + 0.5).to(dtype)
                xt = x.t().contiguous().t()         # non-contiguous
                scale = torch.randn(d, generator=g, device=dev) + 1
                bias = torch.randn(d, generator=g, device=dev)
                for pdtype in {torch.float32, dtype}:
                    for inp in (x, xt):
                        worst = max(worst, norm_compare(
                            kind, inp, scale.to(pdtype), bias.to(pdtype)))
            errs[(kind, str(dtype).split(".")[1])] = worst
        errs[(kind, "grad_fp32")] = norm_grad_check(kind, dev)
    # LayerNorm rows with a large mean: the centred variance holds
    x = torch.randn(64, 768, generator=g, device=dev) + 300
    scale = torch.randn(768, generator=g, device=dev) + 1
    bias = torch.randn(768, generator=g, device=dev)
    c = x.double() - x.double().mean(-1, keepdim=True)
    want = (c * torch.rsqrt(c.square().mean(-1, keepdim=True) + 1e-5)
            * scale.double() + bias.double())
    errs[("layer", "mean300_vs_float64")] = float(
        (norm_call("layer", x, scale, bias, True).double() - want)
        .abs().max())
    if errs[("layer", "mean300_vs_float64")] > 5e-4:
        raise AssertionError(f"layer norm at mean 300: {errs}")
    log(f"[kernel] norms vs plain ({NORM_NOTE}): "
        f"{json.dumps({'/'.join(k): v for k, v in errs.items()})}")
    times = {}
    # time_ms of an empty kernel under the same flush: the share of every
    # phase-3 time that the events, the launch and the cold start take;
    # each row's copy_ms, a copy of x (the same bytes), is what a pass that
    # reads x and writes y reaches under it
    floor = (time_ms(lambda: torch.cuda._sleep(0), dev, iters, flush)
             if dev.type == "cuda" else None)
    for name, (kind, (n_rows, d)) in NORM_MAIN.items():
        x = torch.randn(n_rows, d, generator=g, device=dev).to(torch.bfloat16)
        scale = (torch.randn(d, generator=g, device=dev) + 1).to(x.dtype)
        bias = torch.randn(d, generator=g, device=dev).to(x.dtype)
        ulps = norm_compare(kind, x, scale, bias)
        ref = norm_call(kind, x, scale, bias, False)
        got = norm_call(kind, x, scale, bias, True)
        again = norm_call(kind, x, scale, bias, True)
        counter = N.rms_norm_kernel if kind == "rms" else N.layer_norm_kernel
        plan = N.launch_plan(kind, n_rows, d, x.dtype)
        if dev.type == "cuda":
            c_plan = N.kernel_plan(kind, n_rows, d, x.dtype)
            if counter.variant != plan["variant"] or c_plan["variant"] != \
                    plan["variant"] or plan["variant"] not in \
                    NEW_NORM_VARIANTS:
                raise AssertionError(f"{name}: launched {counter.variant}, "
                                     f"planned {plan}, C side {c_plan}")
            plan = c_plan
        lib = ((lambda: F.rms_norm(x, (d,), scale, 1e-6)) if kind == "rms"
               else (lambda: F.layer_norm(x, (d,), scale, bias, 1e-5)))
        bound, by = norm_bound(kind, n_rows, d)
        rec = dict(
            shape=[n_rows, d], dtype="bfloat16", variant=plan["variant"],
            plan=plan, max_ulps=ulps,
            max_abs_err=float((got.float() - ref.float()).abs().max()),
            bit_identical_rerun=bool(torch.equal(got, again)),
            library_max_ulps=norm_ulps(lib(), ref, x.dtype,
                                       bias if kind == "layer" else None),
            ms=time_ms(lambda: norm_call(kind, x, scale, bias, True), dev,
                       iters, flush),
            plain_ms=time_ms(lambda: norm_call(kind, x, scale, bias, False),
                             dev, iters, flush),
            library_ms=time_ms(lib, dev, iters, flush),
            copy_ms=time_ms(lambda: torch.empty_like(x).copy_(x), dev, iters,
                            flush),
            bound_ms=bound, bound_by=by, empty_kernel_ms=floor)
        rec.update(gb_per_s=norm_bytes(kind, n_rows, d) / rec["ms"] / 1e6,
                   bound_share=bound / rec["ms"],
                   x_library=rec["library_ms"] / rec["ms"])
        if name == "layer_norm":
            rec["closed_form_backward_ms"] = time_ms(
                norm_backward(x, scale, bias), dev, iters, flush)
        times[name] = rec
        log(f"[kernel] {name} at {[n_rows, d]} bf16: {json.dumps(rec)}")
        if not rec["bit_identical_rerun"]:
            raise AssertionError(f"{name}: a rerun differs")
        del x, ref, got, again
    return errs, times


def norm_backward(x, scale, bias):
    """A call of LayerNormFunction's closed-form backward (eager torch ops)
    on x's shape, for timing: what a fused norm backward would replace."""
    import torch
    from deepspeed_tpu_torch.ops import norms as N

    class Ctx:
        saved_tensors = (x, scale, bias)
        eps = 1e-5
        needs_input_grad = (True, True, True, False)

    g = torch.ones_like(x)
    return lambda: N.LayerNormFunction.backward(Ctx, g)


def norm_launches_per_micro(c) -> int:
    """Norm launches of one training micro-batch: the forward's
    (:func:`norms_per_forward`: 2L + 1 for GPT-2), and each layer's norms
    again in the backward under every checkpointing policy, whose
    recompute reruns them (none under remat=False or
    everything_saveable)."""
    rerun = (norms_per_layer(c) * c.num_layers
             if c.remat and c.remat_policy != "everything_saveable" else 0)
    return norms_per_forward(c) + rerun


def norms_per_layer(c) -> int:
    """ln1 and ln2, or ln1 alone where attention and the MLP share one
    input norm (Falcon, Phi-2, GPT-J)."""
    return 1 if c.parallel_residual and not c.parallel_dual_norm else 2


def norms_per_forward(c) -> int:
    """Norm launches of one forward: each layer's norms
    (:func:`norms_per_layer`), the final norm, and Bloom's embedding
    norm."""
    return norms_per_layer(c) * c.num_layers + 1 + int(c.embed_layernorm)


def grouped_mm_counter():
    """The launch counter of the grouped GEMM (the grouped MoE form)."""
    from deepspeed_tpu_torch.ops import grouped_gemm
    return grouped_gemm.grouped_mm_kernel


def norm_counter(c):
    """The launch counter of the model's norm kernel."""
    from deepspeed_tpu_torch.ops import norms as N
    return (N.rms_norm_kernel if c.norm_type == "rmsnorm"
            else N.layer_norm_kernel)


# --------------------------------------- phases 13-14, Path Z across ranks
def path_z_wire_bytes(plan, quantized: bool, dtype_bytes: int = 2) -> dict:
    """Bytes a rank puts on the wire per micro-step, reckoned from the
    plan's shard shapes as the JAX comms logger counts them
    (zeropp.py _log_wire): each gathered shard (int8 with its scales at
    1 + 4/512 bytes a value where qwZ takes it, else the compute dtype),
    each reduced full-size fp32 grad (int8 where qgZ takes it)."""
    from deepspeed_tpu_torch.ops.quantization import wire_bytes_per_element
    from deepspeed_tpu_torch.runtime.zeropp import MIN_QUANT_SIZE
    int8 = wire_bytes_per_element("int8")
    gather = reduce = 0.0
    for name, dim in plan.param_dims.items():
        full = int(np.prod(plan.shapes[name]))
        if dim is not None:
            shard = full // plan.world
            gather += shard * (int8 if quantized and shard >= MIN_QUANT_SIZE
                               else dtype_bytes)
        if plan.grad_dims[name] is not None and quantized \
                and full >= 4 * MIN_QUANT_SIZE:
            reduce += full * int8
        else:
            reduce += full * 4
    return {"gather_bytes": gather, "reduce_bytes": reduce,
            "total_bytes": gather + reduce}


def path_z_expected_launches(plan) -> dict:
    """Per micro-step of Path Z's quantized wire: one quantize and one
    dequantize per split leaf whose shard has >= 4096 values (qwZ), and
    one dequantize per split grad of >= 16384 values (qgZ; its stochastic
    rounding is torch ops)."""
    from deepspeed_tpu_torch.runtime.zeropp import MIN_QUANT_SIZE
    qwz = sum(1 for n, d in plan.param_dims.items() if d is not None
              and np.prod(plan.shapes[n]) // plan.world >= MIN_QUANT_SIZE)
    qgz = sum(1 for n, d in plan.grad_dims.items() if d is not None
              and np.prod(plan.shapes[n]) >= 4 * MIN_QUANT_SIZE)
    return {"quantize_int8": qwz, "dequantize_int8": qwz + qgz,
            "qwz_leaves": qwz, "qgz_leaves": qgz}


def path_z_run(dev, config, size, steps, seq, check, save_dir=None):
    """One rank's Path Z: initialize, a warm-up step, then ``steps`` timed
    steps (host clock up to a synchronize, the ranks started together by a
    barrier), every count set to 0 right before and read right after.
    With ``save_dir``, the ranks then save a checkpoint there and rank 0
    records the digest of the consolidated master (phase 26g loads it at
    W = 1). With ``check``, phase 14 on the step's real data."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import GPT2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import norms as N
    from deepspeed_tpu_torch.ops import quantization as TQ
    from deepspeed_tpu_torch.ops.fused_optimizers import fused_adam_step
    from deepspeed_tpu_torch.runtime.zeropp import reduce_grads
    model = GPT2(size=size, vocab_size=50304, remat_policy="segments",
                 attn_impl="flash", device=dev)
    engine, *_ = ds.initialize(model=model, config=config)
    rows = engine.train_batch_size_
    batch = train_batch_of(dev, model.config.vocab_size, rows, seq)
    engine.train_batch(batch)                                  # warm-up
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    comm.barrier()
    counters = {"quantize_int8": TQ.quantize_int8_kernel,
                "dequantize_int8": TQ.dequantize_int8_kernel,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd": fa.flash_attention_bwd,
                "fused_adam": fused_adam_step,
                "layer_norm": N.layer_norm_kernel}
    for fn in counters.values():
        fn.launches = 0
    reset_norms(N.layer_norm_kernel)
    TQ.quantize_int8_kernel.variant_launches = {}
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(engine.train_batch(batch))
        if cuda:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    launches = {k: fn.launches for k, fn in counters.items()}
    quantize_by_variant = dict(TQ.quantize_int8_kernel.variant_launches)
    norm_by_variant = check_norm_variants(N.layer_norm_kernel, dev,
                                          "Path Z rank")
    losses = [float(x) for x in losses]
    out = dict(
        step_ms=1e3 * sum(step_s) / steps, step_ms_min=1e3 * min(step_s),
        step_ms_max=1e3 * max(step_s),
        tokens_per_s=rows * seq * steps / sum(step_s),
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if cuda else None),
        losses=losses, grad_norm=engine.get_global_grad_norm(),
        launches=launches, norm_launches_by_variant=norm_by_variant,
        quantize_launches_by_variant=quantize_by_variant,
        norm_launches_per_micro=norm_launches_per_micro(model.config),
        launches_per_step={k: v / steps for k, v in launches.items()},
        shard_numel=sum(t.numel()
                        for t in engine.master_state_dict().values()))
    if save_dir is not None:
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        engine.save_checkpoint(save_dir)
        if cuda:
            torch.cuda.synchronize()
        save_s = time.perf_counter() - t
        master = engine.consolidated_master_state_dict()
        out["checkpoint"] = dict(
            dir=save_dir, tag=f"global_step{engine.global_steps}",
            save_s=save_s, bytes=dir_bytes(save_dir),
            digest=master_digest(master) if comm.get_rank() == 0 else None)
        del master
    if check:
        out["kernel_vs_plain"] = path_z_kernel_vs_plain(engine, batch,
                                                        reduce_grads)
    del engine, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def path_z_kernel_vs_plain(engine, batch, reduce_grads):
    """Phase 14: every qwZ gather with the kernels and with the plain
    versions from the rank's real shards, and one micro-batch's real
    local grads through the qgZ reduce-scatter with nearest rounding,
    kernels on and off: bit for bit (``use_kernel=None`` launches the
    kernels on the card; on the CPU, in rehearsal, both sides are
    plain)."""
    import torch
    gathered = [engine.gathered_params(use_kernel=k) for k in (None, False)]
    gather_equal = all(torch.equal(gathered[0][n], gathered[1][n])
                       for n in gathered[0])
    gather_err = max(float((gathered[0][n].float() - gathered[1][n].float())
                           .abs().max()) for n in gathered[0])
    del gathered
    engine(batch).backward()
    grads = {n: p.grad for n, p in engine.module.params.items()}
    for p in engine.module.params.values():
        p.grad = None
    engine._release()
    reduced = [reduce_grads(grads, engine.plan.grad_dims,
                            n_batch=engine.dp_world, quantize_gradients=True,
                            rounding="nearest", use_kernel=k)
               for k in (None, False)]
    reduce_equal = all(torch.equal(reduced[0][n], reduced[1][n])
                       for n in reduced[0])
    reduce_err = max(float((reduced[0][n] - reduced[1][n]).abs().max())
                     for n in reduced[0])
    return {"gather_bit_equal": gather_equal, "gather_max_abs_err":
            gather_err, "reduce_bit_equal": reduce_equal,
            "reduce_max_abs_err": reduce_err}


def path_z_rank(spec: str) -> int:
    """One Path Z rank, started by ``path_z_main`` as ``chip_smoke.py
    --path-z-rank SPEC`` (SPEC a JSON object): joins the gloo group through
    the file store, runs the quantized and the exact wire, and writes its
    results (or its traceback) as JSON to the spec's ``out`` file."""
    s = json.loads(spec)
    try:
        import ctypes
        import signal
        # die with the parent, so a killed run leaves no rank behind
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)    # PR_SET_PDEATHSIG
        import torch
        from deepspeed_tpu_torch.comm import comm
        comm.init_distributed("gloo", init_method=f"file://{s['store']}",
                              rank=s["rank"], world_size=s["world"])
        dev = torch.device(s["device"])
        out = {"rank": s["rank"]}
        for wire, config in (("quantized", PATH_Z_CONFIG),
                             ("exact", PATH_Z_EXACT)):
            out[wire] = path_z_run(
                dev, config, s["size"], s["steps"], s["seq"],
                check=wire == "quantized",
                save_dir=s["ckpt"] if wire == "quantized" else None)
        torch.distributed.destroy_process_group()
        rc = 0
    except BaseException:
        out, rc = {"rank": s["rank"], "error": traceback.format_exc()}, 1
    with open(s["out"] + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(s["out"] + ".tmp", s["out"])
    return rc


def path_z_main(dev, size="125m", steps=10, seq=1024, timeout=900,
                ckpt_dir=PATH_Z_CKPT):
    """Phases 13-14: Path Z in PATH_Z_WORLD rank processes (this script
    with ``--path-z-rank``) that share ``dev``; the quantized run's
    checkpoint goes to ``ckpt_dir`` for phase 26g. Every rank is killed when
    one fails or at ``timeout``, and all are reaped before this returns or
    raises. Fails if a rank fails or hangs, if the losses are not finite
    and falling, if a launch count is off (on the card) or if a kernel
    disagrees with its plain version."""
    from deepspeed_tpu_torch.ops import op_builder
    op_builder.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rendezvous = tempfile.mkdtemp(dir=op_builder.BUILD_DIR)
    outs = [os.path.join(rendezvous, f"rank{r}.json")
            for r in range(PATH_Z_WORLD)]
    t = time.perf_counter()
    procs = []
    try:
        try:
            for r in range(PATH_Z_WORLD):
                spec = dict(rank=r, world=PATH_Z_WORLD, device=str(dev),
                            store=os.path.join(rendezvous, "store"),
                            size=size, steps=steps, seq=seq, out=outs[r],
                            ckpt=ckpt_dir)
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--path-z-rank", json.dumps(spec)]))
            while None in [p.poll() for p in procs]:
                if any(p.returncode for p in procs):
                    break                   # a rank failed: stop the rest
                if time.perf_counter() - t > timeout:
                    raise AssertionError(f"Path Z ranks still running "
                                         f"after {timeout} s")
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results, failed = {}, []
        for r, (p, out) in enumerate(zip(procs, outs)):
            res = {}
            if os.path.exists(out):
                with open(out) as f:
                    res = json.load(f)
            if p.returncode != 0 or "error" in res:
                failed.append(f"Path Z rank {r} failed (exit code "
                              f"{p.returncode}):\n"
                              f"{res.get('error', 'no result written')}")
            results[r] = res
        if failed:
            raise AssertionError("\n".join(failed))
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)
    plan = path_z_plan(size)
    q, e = results[0]["quantized"], results[0]["exact"]
    stats = dict(
        model=f"gpt2-{size} vocab 50304", ranks=PATH_Z_WORLD, seq=seq,
        steps=steps, rows_per_rank=24 // PATH_Z_WORLD,
        wall_s=time.perf_counter() - t,
        quantized={k: v for k, v in q.items()
                   if k not in ("kernel_vs_plain", "checkpoint")},
        checkpoint=q["checkpoint"],
        exact=e,
        peak_memory_gib_per_rank={
            w: [results[r][w]["peak_memory_gib"]
                for r in range(PATH_Z_WORLD)] for w in ("quantized", "exact")},
        loss_gap=[a - b for a, b in zip(q["losses"], e["losses"])],
        loss_gap_rel_last=abs(q["losses"][-1] - e["losses"][-1])
        / e["losses"][-1],
        wire_bytes_per_step={"quantized": path_z_wire_bytes(plan, True),
                             "exact": path_z_wire_bytes(plan, False)},
        expected_launches_per_step=path_z_expected_launches(plan),
        kernel_vs_plain=[results[r]["quantized"]["kernel_vs_plain"]
                         for r in range(PATH_Z_WORLD)])
    wq = stats["wire_bytes_per_step"]
    stats["wire_reduction"] = (wq["exact"]["total_bytes"]
                               / wq["quantized"]["total_bytes"])
    log(f"[path Z] {json.dumps(stats)}")
    for wire, rec in (("quantized", q), ("exact", e)):
        losses = rec["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"Path Z {wire} losses not finite and "
                                 f"falling: {losses}")
    for r, check in enumerate(stats["kernel_vs_plain"]):
        if not (check["gather_bit_equal"] and check["reduce_bit_equal"]):
            raise AssertionError(f"Path Z rank {r} kernels vs plain: "
                                 f"{check}")
    want = dict(stats["expected_launches_per_step"],
                layer_norm=q["norm_launches_per_micro"])
    for r in range(PATH_Z_WORLD):
        for wire in ("quantized", "exact"):
            got = results[r][wire]["launches_per_step"]
            keys = (("quantize_int8", "dequantize_int8", "layer_norm")
                    if wire == "quantized" else ("layer_norm",))
            if dev.type == "cuda" and any(got[k] != want[k] for k in keys):
                raise AssertionError(f"Path Z rank {r} {wire} launches per "
                                     f"step {got} != {want}")
    return stats


# ------------------------------------------- phase 15, every remat policy
def remat_policies_main(dev, size="125m", steps=3, seq=1024):
    """Phase 15: phase 6's train_batch (GPT-2 125M, 24 x 1024 tokens,
    bf16, FusedAdam with the fused kernel, ZeRO 2, flash attention) under
    each of REMAT_RUNS (None: remat=False) from the same seeded weights,
    one warm-up step then ``steps`` timed steps on one batch: step ms
    (host clock up to a synchronize), peak memory, the loss per step, and
    the norm and flash-forward launches a step. Fails if the losses are
    not finite and falling, if a run's losses leave the segments run's by
    more than bf16 noise (5e-3 relative; the policies' fp32 parity is held
    on the CPU in tests/test_torch_remat.py), or (on the card) if the norm
    launches differ from ``norm_launches_per_micro``."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    runs, init, batch = {}, None, None
    cuda = dev.type == "cuda"
    for policy in REMAT_RUNS:
        model = GPT2(size=size, vocab_size=50304, attn_impl="flash",
                     device=dev, remat=policy is not None,
                     remat_policy=policy or "segments")
        engine, *_ = ds.initialize(model=model, config=TRAIN_CONFIG,
                                   model_parameters=init)
        c = model.config
        if init is None:
            init = {n: t.clone() for n, t in
                    engine.master_state_dict().items()}
            batch = train_batch_of(dev, c.vocab_size,
                                   engine.train_batch_size_, seq, seed=12)
        engine.train_batch(batch)                              # warm-up
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        norms = norm_counter(c)
        reset_norms(norms)
        fa.flash_attention_fwd.launches = 0
        losses, step_s = [], []
        for _ in range(steps):
            t = time.perf_counter()
            losses.append(engine.train_batch(batch))
            if cuda:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
        name = policy or "remat_off"
        norm_by_variant = check_norm_variants(norms, dev, f"remat {name}")
        runs[name] = dict(
            step_ms=1e3 * sum(step_s) / steps,
            step_ms_min=1e3 * min(step_s), step_ms_max=1e3 * max(step_s),
            peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                             if cuda else None),
            losses=[float(x) for x in losses],
            norm_launches_per_step=norms.launches / steps,
            norm_launches_by_variant=norm_by_variant,
            expected_norm_launches_per_step=norm_launches_per_micro(c),
            flash_fwd_launches_per_step=fa.flash_attention_fwd.launches
            / steps)
        log(f"[remat] {name}: {json.dumps(runs[name])}")
        del engine, model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    ref = runs["segments"]["losses"]
    for name, r in runs.items():
        losses = r["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"remat {name}: losses not finite and "
                                 f"falling: {losses}")
        if max(abs(a - b) / abs(b) for a, b in zip(losses, ref)) > 5e-3:
            raise AssertionError(f"remat {name}: losses {losses} vs "
                                 f"segments {ref}")
        if cuda and r["norm_launches_per_step"] != \
                r["expected_norm_launches_per_step"]:
            raise AssertionError(f"remat {name}: norm launches {r}")
    return runs


# --------------------------------------------------------- --profile
# device kernels by kind, matched on their names in this order
PROFILE_KINDS = {
    # the pad pass's page gathers and the pool write's (4 a forward)
    "index_select": ("indexSelect",),
    "flash_attention": ("flash_fwd_", "flash_bwd_"),
    "paged_attention": ("paged_",),
    "fused_adam": ("fused_adam_kernel",),
    "fused_lion": ("fused_lion_kernel",),
    "block_sparse_attention": ("bs_fwd_", "bs_bwd_"),
    "norms": ("norm_kernel", "norm_rows_kernel"),
    "grouped_gemm": ("grouped_mm_",),
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


def profile_main_path(engine, dev, rows=8, prompt_len=256, decode_ticks=8,
                      label=""):
    """Where a serving tick's time goes: one prefill tick (``rows``
    prompts of ``prompt_len`` tokens, one chunk each) and then
    ``decode_ticks`` decode ticks of the same rows; windows named
    ``label`` + prefill/decode."""
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
    finished, pre = profile_window(label + "prefill", engine.tick, 1)

    def decode():
        nonlocal finished
        for _ in range(decode_ticks):
            finished = decode_tick(finished)
        return finished

    _, dec = profile_window(label + "decode", decode, decode_ticks)
    engine.flush(uids)
    return [pre, dec]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a prefill tick and decode ticks of the "
                         "serving path and of Path Q, one train_batch step, "
                         "one Path T step, five Path P calls, a fused and "
                         "a speculative dispatch and one BERT-large step "
                         "with torch.profiler")
    ap.add_argument("--path-z-rank", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--compare-kernels", metavar="ROOT",
                    help="only time the quantize and fused-Adam kernels of "
                         "this checkout against those of the checkout at "
                         "ROOT, in turns in this one process, and print "
                         "the result as JSON")
    args = ap.parse_args(argv)
    if args.path_z_rank:
        return path_z_rank(args.path_z_rank)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.compare_kernels:
        dev = torch.device("cuda")
        log(card_line())
        log(json.dumps(compare_kernels(args.compare_kernels, dev)))
        return 0
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

    # phase 21's, 22's and 25d's CPU halves of their fp32 checks run
    # beside the build and phase 3, and are done before phase 4: beside
    # them every host-bound number of the serving phases reads slower
    # (PERF.md, Findings)
    cpu_pool, cpu_futures = fp32_cpu_sides()
    linear_futures = linear_cpu_sides(cpu_pool)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=1) as nvcc_pool:      # phase 2
        build = nvcc_pool.submit(op_builder.build, list(KERNELS))
        # 25d's trees are drawn on the card while nvcc runs
        moe_cpu = moe_fp32_cpu_sides(cpu_pool, dev)
        build_s = build.result()
    log(f"[build] seconds {json.dumps(build_s)}")
    for name in ("paged_attention", "flash_attention",
                 "block_sparse_attention"):
        report = attention_build_report(name)
        log(f"[build] {name} kernels: {json.dumps(report)}")
        spilled = {k: r for k, r in report.items() if r.get("spill_stores")}
        if name == "paged_attention" and spilled:
            raise AssertionError(f"paged kernels spill: {spilled}")
    # 70 norm kernels: 5 (x, params) dtype pairs x RMS/Layer x (4
    # warp_row + 2 cta_row vector counts + general); a row kernel may not
    # spill, and warp_row may not hold a barrier
    report = norm_build_report()
    log(f"[build] norms kernels: {json.dumps(report)}")
    bad = {k: r for k, r in report.items()
           if not k.startswith("general") and (
               r.get("spill_stores") or r.get("spill_loads")
               or k.startswith("warp_row") and r.get("barriers"))}
    if bad or len(report) != 70:
        raise AssertionError(f"norm row kernels that spill or (warp_row) "
                             f"hold a barrier: {bad}; the report holds "
                             f"{len(report)} kernels, not 70")
    for name in KERNELS:
        ptxas = op_builder.library_path(name).with_suffix(".log")
        for line in ptxas.read_text().splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    t = time.perf_counter()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    errs, times = kernel_checks(dev, flush)                   # phase 3
    quant_errs, quant_times = quant_checks(dev, flush)
    flash_errs = flash_checks(dev)
    adam_err = adam_checks(dev)
    adam_numel = flat_numel("125m")
    train_times = train_kernel_times(dev, adam_numel, flush)
    new_dim_times = flash_new_dim_times(dev, flush)           # phase 21's
    lion_err, lion_identical = lion_checks(dev)
    sparse_errs = sparse_checks(dev)
    fill = sparse_fill()
    path_times = path_kernel_times(dev, adam_numel, flush)
    zeropp_times = zeropp_kernel_times(dev, flush)
    lora_quant = lora_quant_times(dev, flush)                 # phase 22's
    norm_errs, norm_times = norm_checks(dev, flush)
    grouped_errs, grouped_times = grouped_mm_checks(dev, flush)
    breadth_errs, breadth_times = breadth_kernel_checks(dev, flush)  # 20a
    del flush
    torch.cuda.empty_cache()
    log(f"[build] phase 3 done {time.perf_counter() - t:.1f} s after the "
        f"build")
    # the CPU halves ran beside the build and phase 3 (its times are
    # device times behind a spin); no later phase runs beside them
    cpu_sides = {k: f.result() for k, f in cpu_futures.items()}
    log(f"[build] phase 21's CPU halves done {time.perf_counter() - t:.1f} "
        f"s after the build")
    linear_cpu = {k: f.result() for k, f in linear_futures.items()}
    del linear_futures
    log(f"[build] phase 22's CPU halves done {time.perf_counter() - t:.1f} "
        f"s after the build")
    for future in moe_cpu.values():
        future.result()
    cpu_pool.shutdown()
    log(f"[build] phase 25d's CPU halves done {time.perf_counter() - t:.1f} "
        f"s after the build")

    engine, stats = main_path(dev)                            # phase 4
    bf16_ref = {k: stats[k] for k in ("weight_bytes", "decode_ms_per_tick",
                                      "prefill_tokens_per_s",
                                      "build_peak_gib", "outputs")}
    rels = main_path_kernel_vs_plain(engine, dev)             # phase 5
    if args.profile:
        profile_main_path(engine, dev)
    prompts = stats.pop("prompts")
    fused = fused_serving_main(engine, dev, prompts, stats,   # phase 17
                               profile=args.profile)
    bf16_ref["fused_profile"] = fused["profile"]["greedy"]
    spec = fused_modes_main(engine, dev, prompts, fused,      # phase 18
                            profile=args.profile)
    t19 = time.perf_counter()
    front = serving_front_main(engine, dev, prompts,          # phase 19
                               fused["outputs"])
    front["migration"] = {"bf16": migration_check(engine, dev, prompts[0],
                                                  "bf16")}
    front["seconds"] = time.perf_counter() - t19
    migrated = prompts[0]
    del fused["outputs"], prompts
    q_engine, path_q = path_q_main(dev, engine)               # phase 11
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    q_rels = path_q_kernel_vs_plain(q_engine, dev)            # phase 12
    if args.profile:
        profile_main_path(q_engine, dev, label="path_q_")
    fused["path_q"] = fused_path_q(q_engine, dev, path_q)     # phase 17
    spec["path_q"] = spec_path_q(q_engine, dev, path_q)       # phase 18
    t19 = time.perf_counter()
    front["migration"]["int8"] = migration_check(             # phase 19
        q_engine, dev, migrated, "int8")
    from deepspeed_tpu_torch.inference.v2 import KVCacheConfig
    fp8 = twin_engine(q_engine, kv_cache=KVCacheConfig(
        enabled=True, dtype="fp8", granularity="head", grow_pool=True))
    front["migration"]["fp8"] = migration_check(fp8, dev, migrated, "fp8")
    release_engine(fp8, dev)
    front["seconds"] += time.perf_counter() - t19
    del fp8, q_engine, path_q["outputs"], path_q["prompts"], migrated
    gc.collect()
    torch.cuda.empty_cache()
    fp16 = fp16_serving_main(dev, stats.pop("outputs"),       # phase 16
                             profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    (fused["fp32_parity"], spec["fp32"],                      # 17, 18, 19
     front["fp32"]) = fused_fp32_parity(dev)
    front["seconds"] += front["fp32"]["seconds"]
    log(f"[front] phase 19: {front['seconds']:.1f} s")
    resident = torch.cuda.memory_allocated()
    log(f"[memory] after the serving phases: {resident / 2**30:.3f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB "
        f"reserved")
    if resident > 2**30:
        raise AssertionError(f"{resident / 2**30:.1f} GiB still allocated "
                             f"after the serving phases")
    breadth = model_breadth_main(dev)                         # phase 20
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    if resident > 2**30:
        raise AssertionError(f"{resident / 2**30:.1f} GiB still allocated "
                             f"after phase 20")

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
    path_p = path_p_main(dev, profile=args.profile)           # phase 10
    gc.collect()
    torch.cuda.empty_cache()
    path_z = path_z_main(dev)                                 # phases 13-14
    gc.collect()
    torch.cuda.empty_cache()
    remat = remat_policies_main(dev)                          # phase 15
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    if resident > 2**30:
        raise AssertionError(f"{resident / 2**30:.1f} GiB still allocated "
                             f"before phase 21")
    families = train_families_main(dev, cpu_sides=cpu_sides)  # phase 21
    del cpu_sides
    gc.collect()
    torch.cuda.empty_cache()
    linear = linear_main(dev, bf16_ref, linear_cpu)           # phase 22
    del linear_cpu, bf16_ref
    gc.collect()
    torch.cuda.empty_cache()
    bert = bert_main(dev, profile=args.profile)               # phase 23
    gc.collect()
    torch.cuda.empty_cache()
    hf = hf_main(dev)                                         # phase 24
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    if resident > 2**30:
        raise AssertionError(f"{resident / 2**30:.1f} GiB still allocated "
                             f"before phase 25")
    moe = moe_main(dev, fp32_cpu=moe_cpu)                     # phase 25
    del moe_cpu
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = checkpoint_main(dev, path_z)                       # phase 26

    def entry(name, kernel, launches, max_abs_err, t, **extra):
        dtypes, variants = KERNEL_FORMS[name]
        return {"name": name, "route": "cuda",
                "source": SOURCE.format(kernel), "replaces": REPLACES[name],
                "launches": launches, "max_abs_err": max_abs_err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "dtypes": dtypes,
                "variants": variants, **extra}

    def flash_extra(name, times, train):
        t = times[name]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "tflops", "bound_share", "x_library", "variant")
        return dict(variant=t["variant"], tflops=t["tflops"],
                    bound_share=t["bound_share"], x_library=t["x_library"],
                    bit_identical_rerun=t["check"]["bit_identical_rerun"],
                    main_path_launches_by_variant=train[
                        "flash_variant_launches"][name[-3:]],
                    head_dims_checked=[16, 32, 64, 80, 96, 128, 256],
                    new_dims_shapes={m: r["shape"] for m, r in
                                     new_dim_times.items()},
                    new_dims={m: {k: r[name][k] for k in keys}
                              for m, r in new_dim_times.items()},
                    new_dims_bit_identical_rerun=all(
                        r[name]["check"]["bit_identical_rerun"]
                        for r in new_dim_times.values()),
                    families_main_path="phase 21: phi-2, phi3-mini, "
                                       "gptj-6b trained",
                    families_launches_by_variant={
                        m: r["flash_launches_by_variant"][name[-3:]]
                        for m, r in families["train"].items()})

    def worst(key, dtype, errs=flash_errs):
        return max(e[key] for (dt, _), e in errs.items() if dt == dtype)

    def sparse_extra(name):
        t = path_times[name]
        return dict(variant=t["variant"], tflops=t["tflops"],
                    bound_share=t["bound_share"], x_library=t["x_library"],
                    bit_identical_rerun=t["check"]["bit_identical_rerun"],
                    main_path_launches_by_variant=path_p["bfloat16"][
                        "launches_by_variant"][name[-3:]],
                    cases_max_rel_err_fp16=worst(f"{name[-3:]}_max_rel_err",
                                                 "float16", sparse_errs),
                    cases_tol_fp16=ATTN_TOL["float16"])

    dec, pre = times["decode"], times["prefill"]
    # phase 20a's rows and phase 20's launches, beside each paged entry
    new_dims = {k: {f: t[f] for f in ("variant", "ms", "bound_ms",
                                      "bound_by", "bound_share",
                                      "plain_ms", "library_ms",
                                      "x_library")}
                for k, t in breadth_times.items()}

    def breadth_err(dtype_name, quantized):
        return max(v for (_, dt, pool, _), v in breadth_errs.items()
                   if dt == dtype_name and (pool != "fp") == quantized)

    breadth_launches = {m: r["launches_by_variant"]
                        for m, r in breadth["serving"].items()}
    new_dim_note = ("D 80/96/256 at phi-2 (32/32), phi3-mini (32/32), "
                    "gptj-6b (16/16) heads, bs 64: decode B 8 ctx "
                    "100-2000, prefill 2 x 256, tick 8 x 256")

    def paged_extra(t, prefix=""):
        keys = ("variant", "tflops", "gb_per_s", "bound_share", "x_library",
                "bit_identical_rerun")
        return {prefix + k: t[k] for k in keys}

    def paged_prefill(t, prefix="prefill_"):
        return {prefix + k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}

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
              **paged_extra(dec), **paged_prefill(pre),
              **paged_extra(pre, "prefill_"),
              prefill_shape="B=2 Sq=256 pos0 0/300 true_len 256/200",
              **paged_prefill(times["prefill_tick"], "prefill_tick_"),
              **paged_extra(times["prefill_tick"], "prefill_tick_"),
              prefill_tick_shape=f"B=8 Sq=256 pos0 {PREFILL_TICK['pos0']}",
              **paged_prefill(times["verify"], "verify_"),
              **paged_extra(times["verify"], "verify_"),
              verify_shape=f"B=8 Sq=4 true_len {verify_shape()['true_len']} "
                           "ctx 100-2000 (the spec verify, phase 18)",
              main_path="serving",
              main_path_launches_by_variant=stats["launches_by_variant"],
              fused_main_path="generate_fused, graph replays (phase 17)",
              fused_launches_by_variant=fused["launches_by_variant"],
              fused_path_q_launches_by_variant=fused["path_q"][
                  "launches_by_variant"],
              spec_main_path="spec chain, ring and spec ring graph "
                             "replays (phase 18)",
              spec_launches_by_variant={
                  m: spec[m]["launches_by_variant"]
                  for m in ("spec_chain", "ring", "spec_ring")},
              spec_path_q_launches_by_variant=spec["path_q"][
                  "launches_by_variant"],
              front_main_path="AsyncInferenceServer, and the migrated "
                              "continuations (phase 19)",
              front_launches=front["server"]["launches"],
              front_launches_by_variant=front["server"][
                  "launches_by_variant"],
              migration_launches_by_variant={
                  kv: front["migration"][kv][
                      "continuation_launches_by_variant"]
                  for kv in ("bf16", "fp8")},
              main_path_fp32_rel_logits_err=rels["fp32_kernel_vs_reference"],
              main_path_bf16_layer_max_abs_err=rels[
                  "bf16_layer_max_abs_err"],
              head_dims_checked=[128, 80, 96, 256],
              new_dims_shapes=new_dim_note,
              new_dims={k: v for k, v in new_dims.items()
                        if not k.endswith(("_fp16", "_int8"))},
              new_dims_max_abs_err=breadth_err("bfloat16", False),
              new_dims_max_abs_err_fp32=breadth_err("float32", False),
              breadth_main_path="phase 20: the dense families served",
              breadth_launches_by_variant=breadth_launches),
        entry("paged_attention_quantized", "paged_attention",
              path_q["launches"],
              max(v for k, v in quant_errs.items() if k[0] == "bfloat16"),
              quant_times["decode"], tol=TOL["bfloat16"],
              max_abs_err_fp32=max(v for k, v in quant_errs.items()
                                   if k[0] == "float32"),
              tol_fp32=TOL["float32"], cases=QUANT_NOTE,
              mode="int8/fp8 pools, f32 scales per (token, head) or token",
              shape="decode B=8 Sq=1 ctx 100-2000 Hq=32 Hkv=8 D=128 bs=64 "
                    "bf16, int8 per-head pools",
              **paged_extra(quant_times["decode"]),
              **paged_prefill(quant_times["prefill"]),
              **paged_extra(quant_times["prefill"], "prefill_"),
              library="gathered codes dequantized to bf16, then SDPA",
              main_path="Path Q",
              main_path_launches_by_variant=path_q["launches_by_variant"],
              migration_launches_by_variant=front["migration"]["int8"][
                  "continuation_launches_by_variant"],
              main_path_layer_max_abs_err={
                  kv: {dt: r["layer_max_abs_err"] for dt, r in rec.items()}
                  for kv, rec in q_rels.items()},
              head_dims_checked=[16, 32, 64, 128, 80, 96, 256],
              new_dims_shapes=new_dim_note + ", int8 per-head pools, bf16",
              new_dims={k: v for k, v in new_dims.items()
                        if k.endswith("_int8")},
              new_dims_max_abs_err=breadth_err("bfloat16", True),
              new_dims_max_abs_err_fp32=breadth_err("float32", True)),
        entry("paged_attention_fp16", "paged_attention",
              fp16["serving"]["launches"],
              max(v for (dt, _), v in errs.items() if dt == "float16"),
              times["decode_fp16"], tol=ATTN_TOL["float16"],
              shape="decode B=8 Sq=1 ctx 100-2000 Hq=32 Hkv=8 D=128 bs=64 "
                    "fp16",
              **paged_extra(times["decode_fp16"]),
              **paged_prefill(times["prefill_fp16"]),
              **paged_extra(times["prefill_fp16"], "prefill_"),
              **paged_prefill(times["prefill_tick_fp16"], "prefill_tick_"),
              **paged_extra(times["prefill_tick_fp16"], "prefill_tick_"),
              **paged_prefill(times["verify_fp16"], "verify_"),
              **paged_extra(times["verify_fp16"], "verify_"),
              main_path="serving in fp16 (phase 16)",
              main_path_launches_by_variant=fp16["serving"][
                  "launches_by_variant"],
              main_path_layer_max_abs_err=fp16["kernel_vs_plain"][
                  "layer_max_abs_err"],
              main_path_first_tick_logits_vs_plain=fp16["kernel_vs_plain"][
                  "first_tick_logits_kernel_vs_plain"],
              first_tick_logits_tol=FP16_LOGITS_TOL,
              greedy_agreement_vs_bf16=fp16["serving"][
                  "greedy_agreement_vs_bf16"],
              head_dims_checked=[128, 80, 96, 256],
              new_dims={k: v for k, v in new_dims.items()
                        if k.endswith("_fp16")},
              new_dims_max_abs_err=breadth_err("float16", False)),
        entry("paged_attention_quantized_fp16", "paged_attention",
              fp16["path_q"]["launches"],
              max(v for k, v in quant_errs.items() if k[0] == "float16"),
              quant_times["decode_fp16"], tol=ATTN_TOL["float16"],
              cases=QUANT_NOTE,
              mode="int8/fp8 pools, f32 scales per (token, head) or token; "
                   "fp16 holds code x scale in the prefill's V tile",
              shape="decode B=8 Sq=1 ctx 100-2000 Hq=32 Hkv=8 D=128 bs=64 "
                    "fp16, int8 per-head pools",
              **paged_extra(quant_times["decode_fp16"]),
              **paged_prefill(quant_times["prefill_fp16"]),
              **paged_extra(quant_times["prefill_fp16"], "prefill_"),
              library="gathered codes dequantized to fp16, then SDPA",
              main_path="Path Q in fp16 (phase 16)",
              main_path_launches_by_variant=fp16["path_q"][
                  "launches_by_variant"],
              main_path_layer_max_abs_err={
                  kv: {dt: r["layer_max_abs_err"] for dt, r in rec.items()}
                  for kv, rec in fp16["path_q_kernel_vs_plain"].items()},
              head_dims_checked=[16, 32, 64, 128, 80, 96, 256],
              new_dims_max_abs_err=breadth_err("float16", True)),
        entry("flash_attention_fwd", "flash_attention",
              train["launches"]["flash_attention_fwd"],
              flash_main["fwd_max_abs_err"],
              train_times["flash_attention_fwd"], tol=TOL["bfloat16"],
              lse_max_abs_err=flash_main["lse_max_abs_err"], lse_tol=1e-4,
              main_path="training",
              shape="B=24 S=1024 H=12 D=64 bf16 causal",
              **flash_extra("flash_attention_fwd", train_times, train),
              cases_max_abs_err_bf16=worst("fwd_max_abs_err", "bfloat16"),
              cases_max_abs_err_fp16=worst("fwd_max_abs_err", "float16"),
              cases_tol_fp16=ATTN_TOL["float16"],
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
              **flash_extra("flash_attention_bwd", train_times, train),
              cases_max_rel_err_bf16=worst("bwd_max_rel_err", "bfloat16"),
              cases_max_rel_err_fp16=worst("bwd_max_rel_err", "float16"),
              cases_tol_rel_fp16=ATTN_TOL["float16"],
              cases_max_rel_err_fp32=worst("bwd_max_rel_err", "float32"),
              cases_tol_rel_fp32=TOL["float32"], cases=CASES_NOTE),
        entry("fused_adam", "fused_adam", train["launches"]["fused_adam"],
              max(adam_main[f"{t}_max_abs_err"] for t in "pmv"),
              train_times["fused_adam"], tol=ADAM_TOL,
              **{k: train_times["fused_adam"][k] for k in (
                  "ms_without_copy", "library_with_copy_ms",
                  "bound_share", "bound_share_without_copy",
                  "x_library_without_copy", "x_library_with_copy")},
              library="torch.optim.AdamW(fused=True).step (no copy); "
                      "library_with_copy_ms: that step + a bf16 copy_",
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
                  "fwd_max_rel_err"], tile_fill=fill,
              **sparse_extra("block_sparse_attention_fwd")),
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
                  "bwd_max_rel_err"],
              **sparse_extra("block_sparse_attention_bwd")),
    ]
    library = {
        "quantize_int8": "none: no single PyTorch call computes "
                         "per-512-block int8 quantization",
        "dequantize_int8": "torch.mul(q, s, out=bf16 [nblocks, 512])"}
    for name in ("quantize_int8", "dequantize_int8"):
        rec = zeropp_times[name]
        extra = {}
        if name == "quantize_int8":
            extra = dict(
                variant=rec["largest_shard"]["variant"],
                bound_share=rec["largest_shard"]["bound_share"],
                copy_ms=rec["largest_shard"]["copy_ms"],
                ragged=rec["largest_shard_misaligned"],
                main_path_launches_by_variant=path_z["quantized"][
                    "quantize_launches_by_variant"])
        lora = linear["lora"]
        if name == "quantize_int8":
            extra.update(
                exact_mode_max_abs_err=lora_quant["quantize_exact"][
                    "max_abs_err"],
                exact_mode_lora_shape=lora_quant["quantize_exact"],
                wire_mode_lora_shape=lora_quant["quantize_wire"],
                scales_differing_between_modes=lora_quant[
                    "scales_differing_between_modes"],
                lora_transform_launches=lora["transform_launches"][
                    "quantize"],
                lora_transform_exact_launches=lora["transform_launches"][
                    "quantize_exact"],
                lora_transform_launches_by_variant=lora[
                    "transform_launches"]["quantize_by_variant"],
                lora_step_launches=lora["quant_launches"]["quantize"])
        else:
            extra.update(
                lora_shape=lora_quant["dequantize"],
                lora_launches=lora["quant_launches"]["dequantize"],
                lora_main_path="phase 22d: each layer of each target, "
                               "forward and recomputed, a micro-step")
        kernels.append(entry(
            name, "quantize_int8", path_z["quantized"]["launches"][name],
            rec["max_abs_err"], rec, tol=0,
            library=library[name],
            library_bit_equal=rec["library_bit_equal"], main_path="Path Z",
            shape="[25152, 768] bf16 (embed/tokens split in two)",
            shard_set=rec["shard_set"],
            main_path_bit_equal=path_z["kernel_vs_plain"],
            lora_shape_name=lora_quant["shape"],
            lora_fp32_base_bit_equal=linear["lora_fp32"]["base_bit_equal"],
            **extra))
    norm_tol = "1 bf16 ulp of the plain result; fp32 1e-6 + 2 ulps"

    def norm_extra(t):
        return {k: t[k] for k in ("variant", "plan", "gb_per_s",
                                  "bound_share", "x_library",
                                  "bit_identical_rerun")}

    for name, launches, tick in (
            ("rms_norm", stats["norm_launches"]
             - stats["decode_norm_launches"], "prefill and mixed ticks"),
            ("rms_norm_decode", stats["decode_norm_launches"],
             "decode ticks")):
        rec = norm_times[name]
        kernels.append(entry(
            name, "norms", launches, rec["max_abs_err"], rec,
            tol=norm_tol, max_ulps=rec["max_ulps"],
            library="torch.nn.functional.rms_norm",
            library_max_ulps=rec["library_max_ulps"],
            main_path=f"serving, {tick} (2L + 1 a forward)",
            shape=f"{rec['shape']} bf16", **norm_extra(rec),
            main_path_launches_by_variant=stats["norm_launches_by_variant"],
            serving_launches=stats["norm_launches"],
            fused_launches_by_variant=fused["norm_launches_by_variant"],
            spec_launches_by_variant={
                m: spec[m]["norm_launches_by_variant"]
                for m in ("spec_chain", "ring", "spec_ring")},
            path_q_launches=path_q["norm_launches"],
            front_launches_by_variant=front["server"][
                "norm_launches_by_variant"],
            path_q_launches_by_variant=path_q["norm_launches_by_variant"],
            cases_max_err={"/".join(k): v for k, v in norm_errs.items()
                           if k[0] == "rms"}, cases=NORM_NOTE))
    kernels.append(entry(
        "layer_norm", "norms", train["launches"]["layer_norm"],
        norm_times["layer_norm"]["max_abs_err"], norm_times["layer_norm"],
        tol=norm_tol, max_ulps=norm_times["layer_norm"]["max_ulps"],
        library="torch.nn.functional.layer_norm",
        library_max_ulps=norm_times["layer_norm"]["library_max_ulps"],
        main_path="training (4L + 1 a micro-batch under segments)",
        shape="[24576, 768] bf16 (train_batch)",
        **norm_extra(norm_times["layer_norm"]),
        main_path_launches_by_variant=train["norm_launches_by_variant"],
        path_t_launches=path_t["launches"]["layer_norm"],
        path_t_launches_by_variant=path_t["norm_launches_by_variant"],
        cases_max_err={"/".join(k): v for k, v in norm_errs.items()
                       if k[0] == "layer"}, cases=NORM_NOTE))
    # the grouped GEMM (no Pallas counterpart): its main path is 25b's
    # grouped form, its launches the graph replays' and the prefills'
    gm_shape, gm_rows, gm_dtype = GROUPED_MAIN
    gm = grouped_times[f"{gm_shape}_{gm_rows}"]
    mv1 = moe["v1"]["grouped"]
    kernels.append(entry(
        "grouped_mm", "grouped_gemm", mv1["grouped_mm_launches"],
        grouped_errs[(gm_dtype, gm_shape, gm_rows)]["max_abs_err"], gm,
        tol=GROUPED_TOL, tol_kind="max |kernel - plain| / max |plain|",
        max_rel_err=grouped_errs[(gm_dtype, gm_shape, gm_rows)][
            "max_rel_err"],
        shape=f"{gm_shape} {gm_rows}: rows {gm['rows']}, experts "
              f"{gm['experts']} (expert {GROUPED_EMPTY} empty), K "
              f"{gm['k']}, N {gm['n']}, bf16",
        library=gm["library"], variant=gm["variant"],
        tflops=gm["tflops"], gb_per_s=gm["gb_per_s"],
        bound_share=gm["bound_share"], x_library=gm["x_library"],
        bit_identical_rerun=gm["bit_identical_rerun"],
        shapes={k: {f: t[f] for f in ("rows", "experts", "k", "n", "ms",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "bound_share",
                                      "x_library")}
                for k, t in grouped_times.items()},
        cases_max_rel_err={"/".join(k): v["max_rel_err"]
                           for k, v in grouped_errs.items()},
        main_path="phase 25b: Mixtral-8x7B on v1, grouped form, graph "
                  "replays (3L a forward)",
        main_path_launches_by_variant=mv1["grouped_mm_launches_by_variant"],
        fused_main_path="phase 25a: Qwen2-MoE a2.7b grouped, "
                        "generate_fused graph replays",
        fused_launches=moe["serving"]["fused_grouped"][
            "grouped_mm_launches"],
        fused_launches_by_variant=moe["serving"]["fused_grouped"][
            "grouped_mm_launches_by_variant"]))
    # phase 22's launches beside each kernel its paths ran
    int8 = linear["serving"]
    lora = linear["lora"]
    for k in kernels:
        if k["name"] == "paged_attention":
            k.update(int8_weights_main_path="phase 22a: Llama-3-8B, "
                     "weight-only int8, generate() and generate_fused",
                     int8_weights_launches=int8["per_tick"]["launches"],
                     int8_weights_launches_by_variant=int8["per_tick"][
                         "launches_by_variant"],
                     int8_weights_fused_launches_by_variant=int8["fused"][
                         "launches_by_variant"])
        elif k["name"] in ("flash_attention_fwd", "flash_attention_bwd"):
            k.update(lora_main_path="phase 22d: LoRA over Llama-3-8B int8",
                     lora_launches_by_variant=lora[
                         "flash_launches_by_variant"][k["name"][-3:]])
        elif k["name"] == "fused_adam":
            k.update(lora_launches=lora["fused_adam_launches"])
        elif k["name"] in ("rms_norm", "rms_norm_decode"):
            k.update(int8_weights_norm_launches=int8["per_tick"][
                "norm_launches"], lora_norm_launches=lora["norm_launches"])
        elif k["name"] == "layer_norm":
            k.update(v1_int8_gptj_norm_launches=linear["v1"][
                "norm_launches"])
    # phases 23 and 24: the new paths' launches beside each kernel they ran
    bt = bert["train"]
    for k in kernels:
        if k["name"] == "paged_attention":
            k.update(hf_main_path="phase 24a: build_hf_engine, Llama-3-8B "
                     "HF directory cut to 8 layers",
                     hf_launches=hf["v2"]["launches"],
                     hf_launches_by_variant=hf["v2"]["launches_by_variant"])
        elif k["name"] == "fused_adam":
            k.update(bert_main_path="phase 23a: BERT-large training",
                     bert_launches=bt["fused_adam_launches"])
        elif k["name"] in ("rms_norm", "rms_norm_decode"):
            k.update(hf_norm_launches=hf["v2"]["norm_launches"],
                     hf_norm_launches_by_variant=hf["v2"][
                         "norm_launches_by_variant"],
                     hf_v1_norm_launches=hf["v1"]["norm_launches"],
                     hf_v1_norm_launches_by_variant=hf["v1"][
                         "norm_launches_by_variant"])
        elif k["name"] == "layer_norm":
            k.update(bert_main_path="phase 23a: BERT-large training, "
                     "post-LN, eps 1e-12, [8192, 1024] bf16 (2L + 2 a step)",
                     bert_launches=bt["norm_launches"],
                     bert_launches_by_variant=bt["norm_launches_by_variant"],
                     bert_layer_fp32_launches=bert["layer_fp32_card_vs_cpu"][
                         "norm_launches"])
    # phase 25: the MoE paths' launches beside each kernel they ran
    ms, mt = moe["serving"], moe["train"]
    for k in kernels:
        if k["name"] == "paged_attention":
            k.update(moe_main_path="phase 25a: Qwen2-MoE a2.7b, generate() "
                     "and generate_fused", moe_launches=ms["launches"],
                     moe_launches_by_variant=ms["launches_by_variant"],
                     moe_fused_launches_by_variant=ms["fused"][
                         "launches_by_variant"])
        elif k["name"] in ("flash_attention_fwd", "flash_attention_bwd"):
            k.update(moe_main_path="phase 25c: Qwen2-MoE a2.7b training, "
                     "4 layers", moe_launches_by_variant=mt[
                         "flash_launches_by_variant"][k["name"][-3:]])
        elif k["name"] == "fused_adam":
            k.update(moe_launches=mt["fused_adam_launches"])
        elif k["name"] in ("rms_norm", "rms_norm_decode"):
            k.update(moe_norm_launches=ms["norm_launches"],
                     moe_norm_launches_by_variant=ms[
                         "norm_launches_by_variant"],
                     moe_fused_norm_launches_by_variant=ms["fused"][
                         "norm_launches_by_variant"],
                     moe_train_norm_launches_by_variant=mt[
                         "norm_launches_by_variant"],
                     moe_v1_norm_launches_by_variant={
                         f: moe["v1"][f]["norm_launches_by_variant"]
                         for f in ("capacity", "grouped")})
    # phase 26: the checkpoint paths' launches beside each kernel they ran
    cr, ct, cs_ = ckpt["resume"], ckpt["path_t"], ckpt["serving"]
    for k in kernels:
        if k["name"] == "paged_attention":
            k.update(checkpoint_main_path="phase 26e: GPT-2 125M served "
                     "from its training checkpoint (build_engine)",
                     checkpoint_launches=cs_["v2_checkpoint"]["launches"],
                     checkpoint_launches_by_variant=cs_["v2_checkpoint"][
                         "launches_by_variant"])
        elif k["name"] in ("flash_attention_fwd", "flash_attention_bwd"):
            k.update(checkpoint_main_path="phase 26a: 9 train_batch steps "
                     "around a save and a resume; 26c: Path T, 6 steps",
                     checkpoint_launches_by_variant=cr["launches"][
                         k["name"]],
                     checkpoint_path_t_launches_by_variant=ct["launches"][
                         k["name"]])
        elif k["name"] == "fused_adam":
            k.update(checkpoint_launches=cr["launches"]["fused_adam"])
        elif k["name"] == "fused_lion":
            k.update(checkpoint_launches=ct["launches"]["fused_lion"])
        elif k["name"] == "layer_norm":
            k.update(checkpoint_launches_by_variant=cr["launches"][
                         "layer_norm"],
                     checkpoint_path_t_launches_by_variant=ct["launches"][
                         "layer_norm"],
                     checkpoint_serving_launches_by_variant={
                         e: cs_[e]["norm_launches_by_variant"]
                         for e in ("v2_checkpoint", "v1_checkpoint")})
        elif k["name"] in ("quantize_int8", "dequantize_int8"):
            k.update(checkpoint_main_path="phase 26g: the Path Z ranks "
                     "whose checkpoint loads at W = 1 (phase 13's run)",
                     checkpoint_launches=ckpt["reshard"]["ranks_launches"][
                         k["name"]])
    log(f"[main] serving {json.dumps(stats)} on {card}")
    log(f"[main] fused serving {json.dumps(fused)} on {card}")
    log(f"[main] spec and ring serving {json.dumps(spec)} on {card}")
    log(f"[main] serving front end {json.dumps(front)} on {card}")
    log(f"[main] fp16 serving {json.dumps(fp16)} on {card}")
    log(f"[main] Path Q {json.dumps(path_q)} on {card}")
    log(f"[main] Path Q kernels vs plain {json.dumps(q_rels)}")
    log(f"[main] training {json.dumps(train)} on {card}")
    log(f"[main] training kernels vs plain {json.dumps(parity)}")
    log(f"[main] Path T {json.dumps(path_t)} on {card}")
    log(f"[main] Path T kernels vs plain {json.dumps(path_t_parity)}")
    log(f"[main] Path P {json.dumps(path_p)} on {card}")
    log(f"[main] Path Z {json.dumps(path_z)} on {card}")
    log(f"[main] remat policies {json.dumps(remat)} on {card}")
    log(f"[main] model breadth {json.dumps(breadth)} on {card}")
    log(f"[main] flash at the families' head dims "
        f"{json.dumps(new_dim_times)} on {card}")
    log(f"[main] families trained {json.dumps(families)} on {card}")
    log(f"[main] linear/ (int8 serving, LoRA) {json.dumps(linear)} on "
        f"{card}")
    log(f"[main] BERT {json.dumps(bert)} on {card}")
    log(f"[main] HF checkpoints {json.dumps(hf)} on {card}")
    log(f"[main] MoE {json.dumps(moe)} on {card}")
    log(f"[main] checkpoints {json.dumps(ckpt)} on {card}")
    left = live_children()
    if left:
        raise AssertionError(f"processes still running: {left}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
