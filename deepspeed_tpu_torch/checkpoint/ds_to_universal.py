"""CLI for the universal-checkpoint converter (counterpart of
``deepspeed_tpu/checkpoint/ds_to_universal.py``; reference:
deepspeed/checkpoint/ds_to_universal.py main). Runs on the host: no card
and no ``torch.distributed``.

Usage:
    python -m deepspeed_tpu_torch.checkpoint.ds_to_universal \
        --input_folder ckpts/run1 --output_folder ckpts/run1_universal
"""

from __future__ import annotations

import argparse

from .universal import ds_to_universal


def parse_arguments(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_folder", required=True,
                   help="checkpoint dir written by engine.save_checkpoint")
    p.add_argument("--output_folder", required=True)
    p.add_argument("--tag", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    ds_to_universal(args.input_folder, args.output_folder, tag=args.tag)


if __name__ == "__main__":
    main()
