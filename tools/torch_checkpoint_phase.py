"""Phases 13 and 26 of ``chip_smoke.py`` alone on one CUDA card: every
kernel built, Path Z's two ZeRO-3 ranks (whose quantized run saves a
checkpoint at its last step), then the checkpoint phase (save, resume,
async save, Path T resume, conversion, serving from the checkpoint, card
<-> CPU, Path Z's W = 2 checkpoint at W = 1). Writes the record as JSON to
the path given (the card's name and power limit in it) and prints the
phase's seconds by part. Run from the repo root on a machine with a card:
``python3 tools/torch_checkpoint_phase.py chiprun_out/checkpoints.json``.
"""
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402


def main(out_path: str) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    t = time.perf_counter()
    cs.log(json.dumps(op_builder.build(list(cs.KERNELS))))
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    path_z = cs.path_z_main(dev)
    path_z_s = time.perf_counter() - t
    rec = cs.checkpoint_main(dev, path_z)
    with open(out_path, "w") as f:
        json.dump({"card": card, "build_s": build_s, "path_z_s": path_z_s,
                   "path_z_checkpoint": path_z["checkpoint"],
                   "phase26": rec}, f, indent=1)
    cs.log(json.dumps(rec["seconds_by_part"]))
    cs.log(f"phase 26 {rec['seconds']:.1f} s, path Z {path_z_s:.1f} s "
           f"on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
