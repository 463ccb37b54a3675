"""Offline fp32 consolidation of a sharded checkpoint (counterpart of
``deepspeed_tpu/checkpoint/zero_to_fp32.py``; reference:
deepspeed/utils/zero_to_fp32.py — get_fp32_state_dict_from_zero_checkpoint
/ convert_zero_checkpoint_to_fp32_state_dict).

Reads every rank's file of a checkpoint that ``engine.save_checkpoint``
wrote and concatenates each parameter's pieces along the split dim the
index records, on the host: no card and no ``torch.distributed``. The
fp32 master where the checkpoint has one (mixed precision), else the
parameters widened to fp32. The output is a plain ``.npz`` of
"/"-joined names, which the JAX package's reader takes too.

CLI:
    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out.npz>
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from ..runtime.checkpoint_engine import ShardedCheckpoint, check_tag_dir
from ..runtime.checkpointing import find_tag
from ..utils.logging import log_dist


def _find_tag(checkpoint_dir: str, tag: Optional[str]) -> str:
    found = find_tag(checkpoint_dir, tag)
    if found is None:
        raise FileNotFoundError(
            f"no 'latest' file in {checkpoint_dir}; pass tag")
    return found


def open_checkpoint(checkpoint_dir: str,
                    tag: Optional[str] = None) -> ShardedCheckpoint:
    """The state of the checkpoint ``tag`` (default: ``latest``) under
    ``checkpoint_dir``."""
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    path = os.path.join(checkpoint_dir, _find_tag(checkpoint_dir, tag))
    check_tag_dir(path)
    return ShardedCheckpoint(os.path.join(path, "state"))


def hp_names(ckpt: ShardedCheckpoint) -> tuple[str, list[str]]:
    """The fp32 source of truth, "master" if the checkpoint has one, else
    "params", and its parameter names."""
    src = ("master" if any(k.startswith("master/") for k in ckpt.keys())
           else "params")
    return src, [k[len(src) + 1:] for k in ckpt.keys()
                 if k.startswith(src + "/")]


def get_fp32_state_dict_from_zero_checkpoint(
        checkpoint_dir: str, tag: Optional[str] = None
) -> dict[str, np.ndarray]:
    """Return {param_name: fp32 numpy array} from a saved checkpoint
    (reference: zero_to_fp32.py same-named function)."""
    from .universal import flatten_with_names
    ckpt = open_checkpoint(checkpoint_dir, tag)
    src, names = hp_names(ckpt)
    named = flatten_with_names({n: n for n in names})
    return {name: ckpt.full(f"{src}/{name}").float().numpy()
            for name, _ in named}


def convert_zero_checkpoint_to_fp32_state_dict(
        checkpoint_dir: str, output_file: str,
        tag: Optional[str] = None) -> str:
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)) or ".",
                exist_ok=True)
    np.savez(output_file, **sd)
    log_dist(f"consolidated {len(sd)} fp32 params to {output_file}")
    return output_file


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Consolidate a deepspeed_tpu_torch checkpoint to one "
                    "fp32 .npz")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("-t", "--tag", default=None)
    args = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, args.tag)


if __name__ == "__main__":
    main()
