"""Four forms of the capacity MoE pad pass of the PyTorch port
(``deepspeed_tpu_torch/inference/v2/paged.py`` ``dead_row_attention``: the
mean of V over the pages a pad slot's row visits), timed on one CUDA card
at the Qwen2-MoE a2.7b serving cell's decode shapes (8 rows of 732 tokens,
16 KV heads of 128, 64-token blocks, bf16), every row holding a pad slot
("padded") and none ("live"): a tick's worth (24 layers) captured in a
CUDA graph, the median of 20 event-timed replays. The forms:

- ``gather_mask``: gather every row's pages, mask, sum (the first form);
- ``bag_weights``: one ``embedding_bag`` over the pool viewed [nb, bs*H*D],
  the visited pages weighted 1 (bf16 page sums);
- ``bag_padding``: ``embedding_bag`` skipping block 0 as ``padding_idx``,
  a row's visits of block 0 added apart;
- ``gather_restricted``: the pages of rows with a pad slot only, by
  ``index_select`` (the others gather block 0 from cache), each page
  summed over its slots in fp32: the port's form.

Prints one JSON line per table width and the card's name and power limit.
Run from the repo root on a machine with a card:
``python3 tools/torch_pad_pass_forms.py``.
"""
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from deepspeed_tpu_torch.inference.v2 import paged  # noqa: E402

NB, BS, HKV, D, B, CTX, LAYERS = 512, 64, 16, 128, 8, 732, 24


def forms(pool, tables, pos0, v_new, width):
    def live_mask():
        t = torch.arange(width, device=pool.device)
        return t[None, :] < (pos0.long()[:, None] + BS - 1) // BS

    def gather_mask(rows):
        live = live_mask()
        pages = paged.gather_pages(pool, tables)
        keys = live.repeat_interleave(BS, dim=1)
        total = (pages * keys[:, :, None, None].to(pages.dtype)).sum(
            1, dtype=torch.float32) + v_new.sum(1, dtype=torch.float32)
        return total / (keys.sum(1) + 1)[:, None, None].float()

    def bag_weights(rows):
        live = live_mask()
        keep = live & rows[:, None]
        idx = torch.where(keep, tables.long(), 0)
        s = F.embedding_bag(idx, pool.reshape(NB, -1), mode="sum",
                            per_sample_weights=keep.to(pool.dtype))
        total = s.view(B, BS, HKV, D).sum(1, dtype=torch.float32) \
            + v_new.sum(1, dtype=torch.float32)
        return total / (live.sum(1) * BS + 1)[:, None, None].float()

    def bag_padding(rows):
        live = live_mask()
        keep = live & rows[:, None]
        idx = torch.where(keep, tables.long(), 0)
        flat = pool.reshape(NB, -1)
        s = F.embedding_bag(idx, flat, mode="sum", padding_idx=0)
        zeros = (keep & (idx == 0)).sum(1, dtype=torch.float32)
        s = s.float() + zeros[:, None] * flat[0].float()
        total = s.view(B, BS, HKV, D).sum(1) + v_new.sum(1, dtype=torch.float32)
        return total / (live.sum(1) * BS + 1)[:, None, None].float()

    def gather_restricted(rows):
        return paged.dead_row_attention(v_new, pool, tables, pos0, rows=rows)

    return dict(gather_mask=gather_mask, bag_weights=bag_weights,
                bag_padding=bag_padding, gather_restricted=gather_restricted)


def tick_ms(fn, rows, iters=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAYERS):
            fn(rows)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[iters // 2]


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    for width in (12, 16):
        pool = torch.randn(NB, BS, HKV, D, device=dev).bfloat16()
        tables = torch.randperm(NB, device=dev)[:B * width].reshape(
            B, width).int()
        pos0 = torch.full((B,), CTX, dtype=torch.int32, device=dev)
        v_new = torch.randn(B, 1, HKV, D, device=dev).bfloat16()
        out = {"width": width}
        for pads in (True, False):
            rows = torch.full((B,), pads, device=dev)
            ref = forms(pool, tables, pos0, v_new, width)["gather_mask"](rows)
            for name, fn in forms(pool, tables, pos0, v_new, width).items():
                got = fn(rows)
                err = (float((got - ref).abs().max() / ref.abs().max())
                       if pads else None)
                ms = tick_ms(fn, rows)
                out[f"{name}/{'padded' if pads else 'live'}"] = dict(
                    ms_a_tick=ms, ms_a_layer=ms / LAYERS, rel_err=err)
        print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
